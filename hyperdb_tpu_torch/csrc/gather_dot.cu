// Stage 3 of the grouped exact top-k routes on Hopper: the f32 inner product
// of each query with every row of each of its candidate runs, read in place
// from the bf16 plane.
//
//   out[i, j, r] = sum over t of f32(q[i, t]) * f32(rows[cidx[i, j] * width + r, t])
//
// q (b, d) bf16, rows (n, d) bf16, cidx (b, k) int64 run ids in [0, n / width),
// out (b, k, width) f32, all contiguous and 16-byte aligned; d % 8 == 0,
// n % width == 0, any b, k, width >= 1. Each bf16 x bf16 product is exact in
// f32 and the sum is an f32 sum, in a fixed order: a lane sums its own
// 8-element slices of the row in depth order, then the warp's 32 lanes
// combine by a butterfly of shuffles. No atomics and no split of a row
// across blocks, so two launches on the same inputs give the same bits.
// NaN handling and the mask term stay with the caller (ops/gmax.py _rescore).
//
// It replaces no Pallas kernel: the JAX package's stage 3 is an XLA gather
// plus an einsum with f32 output (hyperdb_tpu/ops/pallas_gmax.py:668-673 and
// 682-687). The port's plain form gathers a (b, k, width, d) copy of the runs,
// writes it again as f32 and runs a batched GEMV over that copy, so every
// candidate byte crosses device memory four times over.
//
// Bound on the H100: bytes. Two operations per element against two bytes
// read, far below the card's ~295 operations a byte. At the benchmark's
// stage-3 shapes (b = 1024 queries, k = 128 runs of width 32, d = 768 over
// two planes or d = 1536 over one) the runs come to 12.9 GB a batch, 3.85 ms
// at 3.35 TB/s. The design reads each run once, straight from the plane:
// a run is `width` consecutive rows, one contiguous span of width * d * 2
// bytes. One block of 8 warps takes one (query, run) pair, so b = 1 still
// gives k blocks and a served flush thousands; each warp sums ROWS rows of the
// run at once, and each lane keeps ROWS x STEPS 16-byte loads in flight
// (non-caching in L1: the runs are read once; L2 still serves runs that
// several queries share). Lane l reads elements [8 l, 8 l + 8) of every
// 256-element step, so the 32 lanes read 512 contiguous bytes of a row per
// load. The query's slice of a step is read once for the ROWS rows through
// the read-only cache, where the block's 8 warps share it.

#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;   // rows a warp sums together
constexpr int STEPS = 3;  // depth steps of 32 x 8 elements a lane loads together

__device__ __forceinline__ uint4 load_streaming(const uint4* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ float2 widen(uint32_t pair) {
  __nv_bfloat162 h;
  static_assert(sizeof(h) == sizeof(pair), "two bf16 values in 32 bits");
  memcpy(&h, &pair, sizeof(pair));
  return __bfloat1622float2(h);
}

__device__ __forceinline__ void widen8(const uint4& raw, float (&x)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = widen(w[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

// acc + the eight products of one 16-byte slice, in element order; each
// product is exact, so the fused multiply-add rounds only the sum
__device__ __forceinline__ float dot8(const uint4& raw, const float (&q)[8], float acc) {
  float v[8];
  widen8(raw, v);
#pragma unroll
  for (int e = 0; e < 8; ++e) acc = fmaf(q[e], v[e], acc);
  return acc;
}

__global__ void __launch_bounds__(THREADS, 3)
    gather_dot_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ rows,
                      const int64_t* __restrict__ cidx, float* __restrict__ out, int k, int width,
                      int d, int64_t runs) {
  const int64_t unit = blockIdx.x;  // the (query, run) pair unit / k, unit % k
  const int64_t run = cidx[unit];
  if (run < 0 || run >= runs) __trap();  // as an out-of-range index in a gather
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int vecs = d / 8;  // 16-byte slices a row
  const auto* qv = reinterpret_cast<const uint4*>(q + (unit / k) * d);
  const __nv_bfloat16* base = rows + run * width * static_cast<int64_t>(d);
  float* o = out + unit * width;

  for (int r0 = warp * ROWS; r0 < width; r0 += WARPS * ROWS) {
    const uint4* rv[ROWS];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      // a row past the run's end reads its last row again and is not written
      const int r = min(r0 + rr, width - 1);
      rv[rr] = reinterpret_cast<const uint4*>(base + static_cast<int64_t>(r) * d);
    }
    float acc[ROWS] = {};
    for (int v0 = lane; v0 < vecs; v0 += 32 * STEPS) {
      uint4 raw[STEPS][ROWS];
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        if (v0 + 32 * s < vecs) {
#pragma unroll
          for (int rr = 0; rr < ROWS; ++rr) raw[s][rr] = load_streaming(rv[rr] + v0 + 32 * s);
        }
      }
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        if (v0 + 32 * s < vecs) {
          float qf[8];
          widen8(__ldg(qv + v0 + 32 * s), qf);
#pragma unroll
          for (int rr = 0; rr < ROWS; ++rr) acc[rr] = dot8(raw[s][rr], qf, acc[rr]);
        }
      }
    }
    // butterfly: every lane ends with the same sum (a + b == b + a)
    float mine = 0.0f;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) acc[rr] += __shfl_xor_sync(0xffffffffu, acc[rr], m);
      if (lane == rr) mine = acc[rr];
    }
    if (lane < ROWS && r0 + lane < width) o[r0 + lane] = mine;
  }
}

}  // namespace

extern "C" int gather_dot(const void* q, const void* rows, const void* cidx, void* out, int b,
                          int k, int width, int d, long long runs, void* stream) {
  if (q == nullptr || rows == nullptr || cidx == nullptr || out == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (b <= 0 || k <= 0 || width <= 0 || d <= 0 || d % 8 != 0 || runs <= 0) {
    return cudaErrorInvalidValue;
  }
  const long long units = static_cast<long long>(b) * k;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;  // one block a (query, run) pair
  gather_dot_kernel<<<static_cast<unsigned>(units), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(rows),
      static_cast<const int64_t*>(cidx), static_cast<float*>(out), k, width, d,
      static_cast<int64_t>(runs));
  return cudaGetLastError();
}
