// Stage-1 grouped-max scan for one-matmul metrics (dot / prenormalized
// cosine) on Hopper: s = q . v (bf16 operands, f32 accumulation) + extra,
// NaN -> -inf, then the max over every run of `sub` corpus rows (and/or
// over every 128-row group). Replaces the Pallas kernels gmax_f and
// gmax_f_sub of hyperdb_tpu/ops/pallas_gmax.py.
//
// Bound on the H100: compute. A (B, d) x (d, N) product is 2*B*N*d
// operations against N*d*2 bytes of corpus, far above the card's
// ~295 operations per byte at the batches this kernel serves (b >= 512).
// Design: bf16 tensor-core mma.sync (m16n8k16) from shared-memory tiles
// fed by a two-stage cp.async pipeline; the (B, N) score matrix never
// reaches device memory — each block reduces its 128 x 128 score tile to
// 8-row maxes in registers and shared memory and writes only the
// (B, N/sub) and/or (B, N/128) maxes. Query tiles are the fastest grid
// index, so the blocks that share one corpus block run together and the
// corpus is read from device memory about once; the query block stays in
// L2. wgmma/TMA and a resident corpus block are later work.
//
// Shapes: q (b, d) bf16, v (n, d) bf16, extra (n,) f32, all contiguous and
// 16-byte aligned; n % 128 == 0, d % 8 == 0, any b >= 1 (ragged query
// tiles are masked here). Outputs are row-major per query:
// sm (b, n/sub) f32 and gm (b, n/128) f32; either may be null.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;             // queries per block
constexpr int BN = 128;             // corpus rows per block: one group
constexpr int BK = 32;              // depth per pipeline stage
constexpr int LDS = BK + 8;         // padded smem row: 80 bytes, ldmatrix without bank conflicts
constexpr int THREADS = 256;        // 8 warps: 2 along queries x 4 along corpus rows
constexpr int STAGE = (BM + BN) * LDS;           // bf16 elements per stage
constexpr int SMEM_BYTES = 2 * STAGE * 2;        // two stages
constexpr int N8 = BN / 8;                       // 8-row maxes per block row

static_assert(BM * N8 * 4 <= SMEM_BYTES, "epilogue tile must fit the stage buffers");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  // src_bytes == 0 zero-fills the 16 destination bytes (ragged rows / depth)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One (rows x BK) tile of a row-major (nrows, d) matrix into padded smem.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                          int nrows, int d, int k0, int tid) {
#pragma unroll
  for (int i = tid; i < BM * (BK / 8); i += THREADS) {
    const int r = i / (BK / 8);
    const int c = (i % (BK / 8)) * 8;
    const int gr = row0 + r;
    const int gk = k0 + c;
    const bool ok = gr < nrows && gk < d;
    const __nv_bfloat16* p = ok ? src + static_cast<size_t>(gr) * d + gk : src;
    cp_async16(smem_addr(dst + r * LDS + c), p, ok ? 16 : 0);
  }
}

template <bool EMIT_SUB, bool EMIT_GROUP>
__global__ void __launch_bounds__(THREADS)
    gmax_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ v,
                const float* __restrict__ extra, float* __restrict__ sm, float* __restrict__ gm,
                int b, int n, int d, int sub, int n_qtiles) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 1;   // 64 queries each
  const int warp_n = warp >> 1;  // 32 corpus rows each
  const int qt = static_cast<int>(blockIdx.x % n_qtiles);
  const int nb = static_cast<int>(blockIdx.x / n_qtiles);
  const int m0 = qt * BM;
  const int n0 = nb * BN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  const int kt_count = (d + BK - 1) / BK;
  load_tile(tiles, q, m0, b, d, 0, tid);
  load_tile(tiles + BM * LDS, v, n0, n, d, 0, tid);
  cp_async_commit();

  for (int kt = 0; kt < kt_count; ++kt) {
    if (kt + 1 < kt_count) {
      __nv_bfloat16* nxt = tiles + ((kt + 1) & 1) * STAGE;
      load_tile(nxt, q, m0, b, d, (kt + 1) * BK, tid);
      load_tile(nxt + BM * LDS, v, n0, n, d, (kt + 1) * BK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* sa = tiles + (kt & 1) * STAGE;
    const __nv_bfloat16* sb = sa + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4];
      uint32_t bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int row = warp_m * 64 + mt * 16 + (lane & 15);
        const int col = kk + (lane >> 4) * 8;
        ldmatrix_x4(af[mt], smem_addr(sa + row * LDS + col));
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        // bf[p] = {b0, b1} of n-tile 2p, then {b0, b1} of n-tile 2p+1
        const int row = warp_n * 32 + p * 16 + ((lane >> 4) << 3) + (lane & 7);
        const int col = kk + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(bf[p], smem_addr(sb + row * LDS + col));
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bf[nt >> 1][(nt & 1) * 2], bf[nt >> 1][(nt & 1) * 2 + 1]);
    }
    __syncthreads();  // the next stage (and the epilogue) overwrite this buffer
  }

  // Epilogue: + extra, NaN -> -inf (before any fmaxf, which would drop a
  // NaN), then 8-row maxes into smem as smax[query][8-row run].
  float* smax = reinterpret_cast<float*>(smem);
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = warp_n * 32 + nt * 8 + t4 * 2;
    const float e0 = extra[n0 + col];
    const float e1 = extra[n0 + col + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s0 = acc[mt][nt][2 * h] + e0;
        float s1 = acc[mt][nt][2 * h + 1] + e1;
        if (isnan(s0)) s0 = -INFINITY;
        if (isnan(s1)) s1 = -INFINITY;
        float m = fmaxf(s0, s1);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if (t4 == 0) smax[(warp_m * 64 + mt * 16 + h * 8 + g8) * N8 + warp_n * 4 + nt] = m;
      }
    }
  }
  __syncthreads();

  if (EMIT_SUB) {
    const int per = sub / 8;
    const int nsub = BN / sub;
    const size_t cols = static_cast<size_t>(n / sub);
    for (int i = tid; i < BM * nsub; i += THREADS) {
      const int r = i / nsub;
      const int j = i % nsub;
      if (m0 + r < b) {
        const float* row = smax + r * N8 + j * per;
        float m = row[0];
        for (int t = 1; t < per; ++t) m = fmaxf(m, row[t]);
        sm[static_cast<size_t>(m0 + r) * cols + n0 / sub + j] = m;
      }
    }
  }
  if (EMIT_GROUP) {
    const size_t cols = static_cast<size_t>(n / BN);
    for (int r = tid; r < BM; r += THREADS) {
      if (m0 + r < b) {
        const float* row = smax + r * N8;
        float m = row[0];
#pragma unroll
        for (int t = 1; t < N8; ++t) m = fmaxf(m, row[t]);
        gm[static_cast<size_t>(m0 + r) * cols + nb] = m;
      }
    }
  }
}

}  // namespace

// Launches the scan on `stream`; allocates nothing and does not
// synchronise. Returns the cudaError_t of the launch (0 on success).
extern "C" int gmax_scan(const void* q, const void* v, const void* extra, void* sm, void* gm,
                         int b, int n, int d, int sub, void* stream) {
  if (b <= 0 || n <= 0 || n % BN != 0 || d <= 0 || d % 8 != 0) return cudaErrorInvalidValue;
  if (sm != nullptr && (sub < 8 || sub > BN || BN % sub != 0)) return cudaErrorInvalidValue;
  const long long n_qtiles = (b + BM - 1) / BM;
  const long long blocks = n_qtiles * (n / BN);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* ex = static_cast<const float*>(extra);
  auto* smf = static_cast<float*>(sm);
  auto* gmf = static_cast<float*>(gm);
  const int nq = static_cast<int>(n_qtiles);
  if (sm != nullptr && gm != nullptr) {
    gmax_kernel<true, true><<<grid, THREADS, 0, s>>>(qb, vb, ex, smf, gmf, b, n, d, sub, nq);
  } else if (sm != nullptr) {
    gmax_kernel<true, false><<<grid, THREADS, 0, s>>>(qb, vb, ex, smf, gmf, b, n, d, sub, nq);
  } else if (gm != nullptr) {
    gmax_kernel<false, true><<<grid, THREADS, 0, s>>>(qb, vb, ex, smf, gmf, b, n, d, sub, nq);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
