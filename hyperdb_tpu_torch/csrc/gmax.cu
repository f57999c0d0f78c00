// Stage-1 grouped-max scans on Hopper, the mma.sync kernel of the first
// port. No route reaches it: both variants that serve the routes live in
// gmax_wgmma.cu (a resident query tile for rows of up to 1536 bytes, and
// the streaming kernel for deeper rows), and ops/gmax.py:kernel_variant
// never picks this one. It stays as the yardstick they are timed against
// ("ms_before"; gmax._launch(..., _variant="mma")) and as a second,
// independently written kernel the tests hold them to, at every depth. One
// kernel template serves the four Pallas kernels of
// hyperdb_tpu/ops/pallas_gmax.py:
//
//   KIND_F        gmax_f, gmax_f_sub: s = q . v (bf16, f32 accumulation)
//                 + extra, NaN -> -inf.
//   KIND_INT8     gmax_int8: s = float(q_i8 . v_i8) * (q_scale * v_scale)
//                 + extra, NaN -> -inf (s8 operands, exact s32 accumulation).
//   KIND_JACCARD  gmax_jaccard: inter = q . v over 0/1 bf16 rows,
//                 s = inter / (|q| + |v| - inter), NaN (0/0) -> -inf, and
//                 only then + extra.
//
// Bound on the H100: operations (2*B*N*d on tensor cores against one read of
// the corpus). Design: tensor-core mma.sync (m16n8k16 bf16, m16n8k32 s8) from
// shared-memory tiles fed by a two-stage cp.async pipeline of 64 bytes of
// depth, any depth streamed; the (B, N) score matrix never reaches device
// memory: each block reduces its 128 x 128 score tile to 8-row maxes in
// registers and shared memory and writes only the (B, N/sub) and/or
// (B, N/128) maxes. Query tiles are the fastest grid index, so the blocks
// that share one corpus block run together and the corpus is read from
// device memory about once; the query block stays in L2. The tiles are
// addressed in bytes: a 32-byte k-step holds 16 bf16 or 32 s8 values, and
// the two mma shapes place the same bytes of a row in the same registers, so
// one loader and one ldmatrix pattern feed both. What holds it to about a
// fifth of the bound at d = 384 and a quarter at d = 4480: every block
// reloads its query tile, one stage of loads is in flight behind 32 mma a
// warp, and mma.sync does not reach the tensor cores' full rate;
// gmax_wgmma.cu answers each.
//
// Shapes: q (b, d), v (n, d) of bf16 or s8, qaux (b,) f32 and vaux (n,) f32
// (scales, or popcounts; unused by KIND_F), extra (n,) f32, all contiguous
// and 16-byte aligned; n % 128 == 0, row bytes % 16 == 0 (d % 8 for bf16,
// d % 16 for s8), any b >= 1 (ragged query tiles are masked here). Outputs
// are row-major per query: sm (b, n/sub) f32 and gm (b, n/128) f32; either
// may be null.

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int KIND_F = 0;
constexpr int KIND_INT8 = 1;
constexpr int KIND_JACCARD = 2;

constexpr int BM = 128;             // queries per block
constexpr int BN = 128;             // corpus rows per block: one group
constexpr int BKB = 64;             // bytes of depth per pipeline stage: two 32-byte k-steps
constexpr int LDSB = BKB + 16;      // padded smem row: 80 bytes, ldmatrix without bank conflicts
constexpr int THREADS = 256;        // 8 warps: 2 along queries x 4 along corpus rows
constexpr int STAGE = (BM + BN) * LDSB;          // bytes per stage
constexpr int SMEM_BYTES = 2 * STAGE;            // two stages
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

__device__ __forceinline__ void mma_step(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_step(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One (128 rows x BKB bytes) tile of a row-major matrix into padded smem.
__device__ __forceinline__ void load_tile(unsigned char* dst, const unsigned char* src, int row0,
                                          int nrows, int row_bytes, int kb0, int tid) {
#pragma unroll
  for (int i = tid; i < BM * (BKB / 16); i += THREADS) {
    const int r = i / (BKB / 16);
    const int c = (i % (BKB / 16)) * 16;
    const int gr = row0 + r;
    const int gk = kb0 + c;
    const bool ok = gr < nrows && gk < row_bytes;
    const unsigned char* p = ok ? src + static_cast<size_t>(gr) * row_bytes + gk : src;
    cp_async16(smem_addr(dst + r * LDSB + c), p, ok ? 16 : 0);
  }
}

// One score from its accumulator: qa / va are the query's and the row's
// scale (int8) or popcount (jaccard), e the row's additive term. The NaN
// scrub comes before any fmaxf, which would drop a NaN.
template <int KIND, typename Acc>
__device__ __forceinline__ float score(Acc acc, float qa, float va, float e) {
  if (KIND == KIND_JACCARD) {
    const float inter = static_cast<float>(acc);
    float s = __fdiv_rn(inter, __fsub_rn(__fadd_rn(qa, va), inter));
    if (isnan(s)) s = -INFINITY;
    return __fadd_rn(s, e);
  }
  float s;
  if (KIND == KIND_INT8) {
    s = __fadd_rn(__fmul_rn(static_cast<float>(acc), __fmul_rn(qa, va)), e);
  } else {
    s = static_cast<float>(acc) + e;
  }
  return isnan(s) ? -INFINITY : s;
}

template <int KIND, bool EMIT_SUB, bool EMIT_GROUP>
__global__ void __launch_bounds__(THREADS)
    gmax_kernel(const unsigned char* __restrict__ q, const unsigned char* __restrict__ v,
                const float* __restrict__ qaux, const float* __restrict__ vaux,
                const float* __restrict__ extra, float* __restrict__ sm, float* __restrict__ gm,
                int b, int n, int row_bytes, int sub, int n_qtiles) {
  using Acc = typename std::conditional<KIND == KIND_INT8, int, float>::type;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 1;   // 64 queries each
  const int warp_n = warp >> 1;  // 32 corpus rows each
  const int qt = static_cast<int>(blockIdx.x % n_qtiles);
  const int nb = static_cast<int>(blockIdx.x / n_qtiles);
  const int m0 = qt * BM;
  const int n0 = nb * BN;

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0;

  const int kt_count = (row_bytes + BKB - 1) / BKB;
  load_tile(smem, q, m0, b, row_bytes, 0, tid);
  load_tile(smem + BM * LDSB, v, n0, n, row_bytes, 0, tid);
  cp_async_commit();

  for (int kt = 0; kt < kt_count; ++kt) {
    if (kt + 1 < kt_count) {
      unsigned char* nxt = smem + ((kt + 1) & 1) * STAGE;
      load_tile(nxt, q, m0, b, row_bytes, (kt + 1) * BKB, tid);
      load_tile(nxt + BM * LDSB, v, n0, n, row_bytes, (kt + 1) * BKB, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const unsigned char* sa = smem + (kt & 1) * STAGE;
    const unsigned char* sb = sa + BM * LDSB;
#pragma unroll
    for (int kk = 0; kk < BKB; kk += 32) {
      uint32_t af[4][4];
      uint32_t bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int row = warp_m * 64 + mt * 16 + (lane & 15);
        const int col = kk + (lane >> 4) * 16;
        ldmatrix_x4(af[mt], smem_addr(sa + row * LDSB + col));
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        // bf[p] = {b0, b1} of n-tile 2p, then {b0, b1} of n-tile 2p+1
        const int row = warp_n * 32 + p * 16 + ((lane >> 4) << 3) + (lane & 7);
        const int col = kk + ((lane >> 3) & 1) * 16;
        ldmatrix_x4(bf[p], smem_addr(sb + row * LDSB + col));
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_step(acc[mt][nt], af[mt], bf[nt >> 1][(nt & 1) * 2], bf[nt >> 1][(nt & 1) * 2 + 1]);
    }
    __syncthreads();  // the next stage (and the epilogue) overwrite this buffer
  }

  // Epilogue: each score from its accumulator, then 8-row maxes into smem
  // as smax[query][8-row run].
  float* smax = reinterpret_cast<float*>(smem);
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  float qa[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp_m * 64 + mt * 16 + h * 8 + g8;
      qa[mt][h] = (KIND != KIND_F && row < b) ? qaux[row] : 0.f;
    }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + warp_n * 32 + nt * 8 + t4 * 2;
    const float e0 = extra[col];
    const float e1 = extra[col + 1];
    const float va0 = KIND != KIND_F ? vaux[col] : 0.f;
    const float va1 = KIND != KIND_F ? vaux[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float s0 = score<KIND>(acc[mt][nt][2 * h], qa[mt][h], va0, e0);
        const float s1 = score<KIND>(acc[mt][nt][2 * h + 1], qa[mt][h], va1, e1);
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

// Launches one scan of `kind` (0 = bf16 dot, 1 = int8, 2 = jaccard) on
// `stream`; allocates nothing and does not synchronise. `qaux` / `vaux` are
// read by kinds 1 and 2 only; subgroup maxes (`sm`) exist for kind 0 only.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gmax_scan(int kind, const void* q, const void* v, const void* qaux,
                         const void* vaux, const void* extra, void* sm, void* gm, int b, int n,
                         int d, int sub, void* stream) {
  if (kind != KIND_F && kind != KIND_INT8 && kind != KIND_JACCARD) return cudaErrorInvalidValue;
  const int row_bytes = kind == KIND_INT8 ? d : 2 * d;
  if (b <= 0 || n <= 0 || n % BN != 0 || d <= 0 || row_bytes % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  if (sm != nullptr && (sub < 8 || sub > BN || BN % sub != 0)) return cudaErrorInvalidValue;
  if (kind != KIND_F && (sm != nullptr || gm == nullptr || qaux == nullptr || vaux == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const long long n_qtiles = (b + BM - 1) / BM;
  const long long blocks = n_qtiles * (n / BN);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const unsigned char*>(q);
  const auto* vb = static_cast<const unsigned char*>(v);
  const auto* qa = static_cast<const float*>(qaux);
  const auto* va = static_cast<const float*>(vaux);
  const auto* ex = static_cast<const float*>(extra);
  auto* smf = static_cast<float*>(sm);
  auto* gmf = static_cast<float*>(gm);
  const int nq = static_cast<int>(n_qtiles);
#define GMAX_LAUNCH(KIND, SUB, GROUP) \
  gmax_kernel<KIND, SUB, GROUP><<<grid, THREADS, 0, s>>>(qb, vb, qa, va, ex, smf, gmf, b, n, \
                                                         row_bytes, sub, nq)
  if (kind == KIND_INT8) {
    GMAX_LAUNCH(KIND_INT8, false, true);
  } else if (kind == KIND_JACCARD) {
    GMAX_LAUNCH(KIND_JACCARD, false, true);
  } else if (sm != nullptr && gm != nullptr) {
    GMAX_LAUNCH(KIND_F, true, true);
  } else if (sm != nullptr) {
    GMAX_LAUNCH(KIND_F, true, false);
  } else if (gm != nullptr) {
    GMAX_LAUNCH(KIND_F, false, true);
  } else {
    return cudaErrorInvalidValue;
  }
#undef GMAX_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
