// Stage-1 manhattan (L1) scans on Hopper: for every (query, 128-row group)
// the best row's distance sum_d |v - q|, without writing the (B, N)
// distances. One kernel template serves the two Pallas kernels of
// hyperdb_tpu/ops/pallas_l1.py:
//
//   KIND_L1   gmax_l1 (_l1_kernel): group MAX of extra - L1(q, v) over the
//             row-major (n, d) corpus. A corpus NaN reads as -inf and a query
//             NaN as +inf, so any NaN operand gives a distance of +inf and a
//             score of -inf. extra is the mask: 0 live, -inf masked.
//   KIND_L1T  gmax_l1t (_l1t_kernel): group MIN of L1(q, v) over a transposed
//             (d, n) corpus. Dead rows (extra = -inf) read as +inf, a corpus
//             NaN as -inf and a query NaN as the finite 1e30, so inf - inf
//             never appears; the caller negates.
//
// Bound on the H100: operations, on the CUDA cores. There is no matrix
// product here, so the tensor cores do not apply: each of the b*n*d
// elements costs two FP32 operations (subtract; add with the |x| operand
// modifier) against one read of the corpus. At b = 512, n = 2^20, d = 384
// that is 4.1e11 operations, 12.3 ms at the card's 33.5e12 FP32
// lane-operations a second, against 0.8 GB, 0.24 ms of memory time.
// Design: register tiling, as a plain f32 matrix product would do it. A
// block owns one 128-row group and 64 queries and walks the depth in
// 32-element stages; both operand tiles are converted to f32 (and scrubbed)
// once into shared memory, depth-major, so a lane's 4 rows and a warp's 8
// queries are each one or two 16-byte loads; each thread keeps a 4 x 8 tile
// of sums in registers: 64 FP32 operations for three shared-memory loads.
// The next stage's global loads are started before the current stage's
// arithmetic. A lane's 4 rows reduce in registers and the 32 lanes by warp
// shuffles, so every output is written once, with no atomics. Query tiles
// are the fastest grid index: the blocks that share a corpus group run
// together and the corpus comes from device memory about once.
// The row-major and the transposed form differ only in how the corpus tile
// is fetched (the transposed one reads 128 neighbouring rows of one depth as
// contiguous bytes and needs no transposing store) and in the epilogue.
//
// Shapes: q (b, d) f32; v (n, d) [KIND_L1] or (d, n) [KIND_L1T] of f32 or
// bf16; extra (n,) f32; out (b, n/128) f32 row-major per query; all
// contiguous and 16-byte aligned; n % 128 == 0, d % 8 == 0, any b >= 1
// (a ragged query tile is masked here).

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KIND_L1 = 0;
constexpr int KIND_L1T = 1;

constexpr int ROWS = 128;     // corpus rows per block: one group
constexpr int QT = 64;        // queries per block
constexpr int DK = 32;        // depth per shared-memory stage
constexpr int THREADS = 256;  // 8 warps: a warp owns TQ queries, a lane TR rows
constexpr int TR = 4;
constexpr int TQ = 8;
constexpr int QLOADS = QT * DK / 4 / THREADS;  // 16-byte query loads per thread and stage

static_assert(ROWS == 32 * TR && QT == (THREADS / 32) * TQ, "thread tile must cover the block");
static_assert(TR == 4 && TQ == 8, "the inner loop reads one float4 of rows and two of queries");

template <typename V>
struct Elems;  // values in one 16-byte load
template <>
struct Elems<float> {
  static constexpr int N = 4;
};
template <>
struct Elems<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[4]) {
  x[0] = __uint_as_float(raw.x);
  x[1] = __uint_as_float(raw.y);
  x[2] = __uint_as_float(raw.z);
  x[3] = __uint_as_float(raw.w);
}

// eight bf16 values: a bf16 is the high half of the f32 of the same value
__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Start one stage's global loads into registers. Depth past d reads as 0 on
// both sides (|0 - 0| adds nothing); queries past b read as 0 and are never
// written out.
template <int KIND, typename V, int VLOADS>
__device__ __forceinline__ void fetch(uint4 (&vreg)[VLOADS], float4 (&qreg)[QLOADS],
                                      const float* __restrict__ q, const V* __restrict__ v, int b,
                                      int n, int d, int m0, int n0, int k0, int tid) {
  constexpr int VE = Elems<V>::N;
#pragma unroll
  for (int j = 0; j < VLOADS; ++j) {
    const int i = tid + j * THREADS;
    const V* p;
    bool ok;
    if (KIND == KIND_L1) {
      const int r = i % ROWS;
      const int k = k0 + (i / ROWS) * VE;
      ok = k < d;
      p = v + static_cast<size_t>(n0 + r) * d + k;
    } else {
      const int k = k0 + i / (ROWS / VE);
      const int c = i % (ROWS / VE);
      ok = k < d;
      p = v + static_cast<size_t>(k) * n + n0 + c * VE;
    }
    vreg[j] = ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int j = 0; j < QLOADS; ++j) {
    const int i = tid + j * THREADS;
    const int qq = i % QT;
    const int k = k0 + (i / QT) * 4;
    const bool ok = m0 + qq < b && k < d;
    qreg[j] = ok ? __ldg(reinterpret_cast<const float4*>(q + static_cast<size_t>(m0 + qq) * d + k))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Convert, scrub and store the fetched stage into shared memory, depth-major:
// vs[k][row], qs[k][query]. Neighbouring lanes write neighbouring rows (or
// queries) of one depth, so the transposing stores meet no bank conflict.
template <int KIND, typename V, int VLOADS>
__device__ __forceinline__ void stash(float (&vs)[DK][ROWS], float (&qs)[DK][QT],
                                      const uint4 (&vreg)[VLOADS], const float4 (&qreg)[QLOADS],
                                      int tid) {
  constexpr int VE = Elems<V>::N;
  const float qnan = KIND == KIND_L1 ? INFINITY : 1e30f;
#pragma unroll
  for (int j = 0; j < VLOADS; ++j) {
    const int i = tid + j * THREADS;
    float x[VE];
    unpack(vreg[j], x);
#pragma unroll
    for (int e = 0; e < VE; ++e) x[e] = isnan(x[e]) ? -INFINITY : x[e];
    if (KIND == KIND_L1) {
      const int r = i % ROWS;
      const int c = i / ROWS;
#pragma unroll
      for (int e = 0; e < VE; ++e) vs[c * VE + e][r] = x[e];
    } else {
      const int kk = i / (ROWS / VE);
      const int c = i % (ROWS / VE);
#pragma unroll
      for (int e = 0; e < VE; e += 4) {
        *reinterpret_cast<float4*>(&vs[kk][c * VE + e]) =
            make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < QLOADS; ++j) {
    const int i = tid + j * THREADS;
    const int qq = i % QT;
    const int c = i / QT;
    const float x[4] = {qreg[j].x, qreg[j].y, qreg[j].z, qreg[j].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) qs[c * 4 + e][qq] = isnan(x[e]) ? qnan : x[e];
  }
}

template <int KIND, typename V>
__global__ void __launch_bounds__(THREADS)
    l1_kernel(const float* __restrict__ q, const V* __restrict__ v,
              const float* __restrict__ extra, float* __restrict__ out, int b, int n, int d,
              int n_qtiles) {
  constexpr int VLOADS = ROWS * DK / Elems<V>::N / THREADS;
  __shared__ __align__(16) float vs[DK][ROWS];
  __shared__ __align__(16) float qs[DK][QT];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qt = static_cast<int>(blockIdx.x % n_qtiles);
  const int nb = static_cast<int>(blockIdx.x / n_qtiles);
  const int m0 = qt * QT;
  const int n0 = nb * ROWS;

  float acc[TR][TQ];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TQ; ++j) acc[i][j] = 0.f;

  uint4 vreg[VLOADS];
  float4 qreg[QLOADS];
  const int stages = (d + DK - 1) / DK;
  fetch<KIND, V, VLOADS>(vreg, qreg, q, v, b, n, d, m0, n0, 0, tid);
  for (int s = 0; s < stages; ++s) {
    stash<KIND, V, VLOADS>(vs, qs, vreg, qreg, tid);
    __syncthreads();
    if (s + 1 < stages) fetch<KIND, V, VLOADS>(vreg, qreg, q, v, b, n, d, m0, n0, (s + 1) * DK, tid);
#pragma unroll 8
    for (int kk = 0; kk < DK; ++kk) {
      const float4 vv = *reinterpret_cast<const float4*>(&vs[kk][lane * TR]);
      const float4 qa = *reinterpret_cast<const float4*>(&qs[kk][warp * TQ]);
      const float4 qb = *reinterpret_cast<const float4*>(&qs[kk][warp * TQ + 4]);
      const float vr[TR] = {vv.x, vv.y, vv.z, vv.w};
      const float qr[TQ] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TQ; ++j) acc[i][j] += fabsf(vr[i] - qr[j]);
    }
    __syncthreads();  // the next stage overwrites both tiles
  }

  // Epilogue: a lane's 4 rows in registers, the group's 32 lanes by shuffles.
  // The scrubs leave no NaN for fmaxf / fminf to drop.
  const float4 e4 = *reinterpret_cast<const float4*>(extra + n0 + lane * TR);
  const float e[TR] = {e4.x, e4.y, e4.z, e4.w};
  const size_t cols = static_cast<size_t>(n / ROWS);
#pragma unroll
  for (int j = 0; j < TQ; ++j) {
    float m;
    if (KIND == KIND_L1) {
      m = e[0] - acc[0][j];
#pragma unroll
      for (int i = 1; i < TR; ++i) m = fmaxf(m, e[i] - acc[i][j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    } else {
      m = isinf(e[0]) ? INFINITY : acc[0][j];
#pragma unroll
      for (int i = 1; i < TR; ++i) m = fminf(m, isinf(e[i]) ? INFINITY : acc[i][j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    const int row = m0 + warp * TQ + j;
    if (lane == j && row < b) out[static_cast<size_t>(row) * cols + nb] = m;
  }
}

template <int KIND>
int launch(bool bf16, const float* q, const void* v, const float* extra, float* out, int b, int n,
           int d, cudaStream_t s) {
  const long long n_qtiles = (b + QT - 1) / QT;
  const long long blocks = n_qtiles * (n / ROWS);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  const int nq = static_cast<int>(n_qtiles);
  if (bf16) {
    l1_kernel<KIND, __nv_bfloat16><<<grid, THREADS, 0, s>>>(
        q, static_cast<const __nv_bfloat16*>(v), extra, out, b, n, d, nq);
  } else {
    l1_kernel<KIND, float><<<grid, THREADS, 0, s>>>(q, static_cast<const float*>(v), extra, out,
                                                    b, n, d, nq);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one scan of `kind` (0 = gmax_l1 over v (n, d), 1 = gmax_l1t over
// v (d, n)) on `stream`; `corpus_bf16` says whether v holds bf16 or f32
// values. Allocates nothing and does not synchronise. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int l1_scan(int kind, int corpus_bf16, const void* q, const void* v, const void* extra,
                       void* out, int b, int n, int d, void* stream) {
  if (kind != KIND_L1 && kind != KIND_L1T) return cudaErrorInvalidValue;
  if (q == nullptr || v == nullptr || extra == nullptr || out == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (b <= 0 || n <= 0 || n % ROWS != 0 || d <= 0 || d % 8 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* ef = static_cast<const float*>(extra);
  auto* of = static_cast<float*>(out);
  if (kind == KIND_L1) return launch<KIND_L1>(corpus_bf16 != 0, qf, v, ef, of, b, n, d, s);
  return launch<KIND_L1T>(corpus_bf16 != 0, qf, v, ef, of, b, n, d, s);
}
