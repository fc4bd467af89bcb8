// Furthest point sampling, batched, for sm_90a.
//
// Replaces the Pallas TPU kernel tpu3dsad/ops/pallas/fps.py::_fps_kernel
// (launched by _fps_call_grid / _fps_call; entry furthest_point_sample).
// Semantics, equal to the plain version tpu3dsad_torch/ops/plain/fps.py:
//   * the first pick is index 0;
//   * each round updates the running min of the fp32 elementwise
//     d2 = (dx*dx + dy*dy) + dz*dz to the chosen set and picks its argmax,
//     ties to the lowest index;
//   * masked points start at -inf and are never picked (min keeps -inf);
//     an all-masked cloud picks index 0 every round, like argmax over -inf.
//
// What bounds it: the chain of M dependent rounds. Each round is a pass
// over the cloud and a block-wide argmax, and the next round needs the
// winner. At N = 20480 the cloud (x, y, z) and the running distance take
// 327 KB, more than one block's 227 KB of shared memory, so the running
// distance lives in a [B, N] fp32 scratch the wrapper allocates and the
// points are read from global memory; both stay in L1/L2 (10 MB for the
// whole batch), which is what each round actually reads.
//
// Design: one block of up to 1024 threads per cloud, each thread owning a
// strided slice of points. The TPU kernel needed two reductions per round
// (max distance, then min index among the maxima) in its 32-bit lanes; here
// one 64-bit key does both: (order-preserving bits of the distance) << 32 |
// (0xFFFFFFFF - index), reduced with warp shuffles and one shared-memory
// pass. -inf maps below +0.0, so a pad never beats a valid point.
//
// Products and sums use the _rn intrinsics so nvcc cannot contract them
// into FMAs: the plain version rounds every operation, and one ulp moves
// picks on near-ties.
//
// Left for later: at B = 32 only 32 of the 132 SMs work. A thread-block
// cluster per cloud with a distributed-shared-memory reduction would spread
// each cloud over several SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ unsigned long long pack_key(float d, int i) {
  unsigned int u = __float_as_uint(d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // total order on floats
  return (static_cast<unsigned long long>(u) << 32) |
         (0xFFFFFFFFu - static_cast<unsigned int>(i));
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    unsigned long long w = __shfl_xor_sync(0xFFFFFFFFu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

__device__ __forceinline__ float sqdist(float x, float y, float z, float lx,
                                        float ly, float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kMaxThreads)
    fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
               float* __restrict__ dist, int* __restrict__ idx, int n, int m) {
  __shared__ unsigned long long warp_best[kMaxThreads / 32];
  __shared__ int winner;

  const int b = blockIdx.x;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  float* d = dist + static_cast<size_t>(b) * n;
  int* out = idx + static_cast<size_t>(b) * m;
  const uint8_t* valid = mask ? mask + static_cast<size_t>(b) * n : nullptr;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // each thread initialises and later updates only its own slice, so the
  // scratch needs no barrier
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    d[j] = (valid == nullptr || valid[j]) ? INFINITY : -INFINITY;
  if (threadIdx.x == 0) out[0] = 0;

  int last = 0;
  for (int i = 1; i < m; ++i) {
    const float lx = p[3 * last], ly = p[3 * last + 1], lz = p[3 * last + 2];
    unsigned long long best = 0;  // below every real key
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float nd =
          fminf(d[j], sqdist(p[3 * j], p[3 * j + 1], p[3 * j + 2], lx, ly, lz));
      d[j] = nd;
      const unsigned long long key = pack_key(nd, j);
      best = key > best ? key : best;
    }
    best = warp_max(best);
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    if (warp == 0) {
      unsigned long long v = lane < nwarps ? warp_best[lane] : 0ull;
      v = warp_max(v);
      if (lane == 0) {
        winner = static_cast<int>(0xFFFFFFFFu -
                                  static_cast<unsigned int>(v & 0xFFFFFFFFull));
        out[i] = winner;
      }
    }
    __syncthreads();
    last = winner;
  }
}

}  // namespace

// xyz [B, N, 3] f32, mask [B, N] u8 or null, dist [B, N] f32 scratch,
// idx [B, M] i32. Launches on `stream`; returns cudaGetLastError().
extern "C" int tpu3dsad_fps(const float* xyz, const uint8_t* mask, float* dist,
                            int* idx, int b, int n, int m, void* stream) {
  if (b <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  int threads = ((n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  fps_kernel<<<b, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, mask, dist, idx, n, m);
  return static_cast<int>(cudaGetLastError());
}
