// Exact ball query, for sm_90a.
//
// Replaces the Pallas TPU kernel tpu3dsad/ops/pallas/ball_query.py::_kernel
// (launched by _ball_query_kernel; entries ball_query / query_and_group).
// Semantics, equal to the plain version tpu3dsad_torch/ops/plain/
// ball_query.py: for each center, the first K point indices in index order
// with fp32 d2 = (dx*dx + dy*dy) + dz*dz strictly below r2; the remaining
// slots repeat the first hit; an empty ball gives all zeros;
// cnt = min(hits, K); masked points never join a ball. r2 arrives already
// rounded to fp32 by the wrapper, as the reference compares it.
//
// What bounds it: the scan over N. A center whose ball holds fewer than K
// points (most of them at SA1: r = 0.2 in a room-sized cloud) must look at
// every point, so the work is B * M * N distance tests.
//
// Design (the lineage CUDA form, not the TPU one): one thread per center,
// a block of centers of one cloud scanning the points in index order
// through shared-memory tiles, so each point is read from global memory
// once per block and then broadcast from shared memory. A thread stops at K
// hits; the block stops as soon as every thread has stopped
// (__syncthreads_and). Hits are written straight to the output in scan
// order, which is the first-K rule with no selection pass at all. The TPU
// kernel's rank-scatter-by-matmul, q-slice gating and AABB tile skip were
// ways around having no per-lane control flow; they are not needed here.
//
// Masked points are staged as NaN: every comparison with NaN is false, so
// they can never be inside a ball, and the inner loop needs no mask test.
// Products and sums use the _rn intrinsics so nvcc cannot contract them
// into FMAs (the plain version rounds every operation).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // centers per block
constexpr int kTile = 1024;    // points per shared-memory tile (12 KB)

__global__ void __launch_bounds__(kThreads)
    ball_query_kernel(const float* __restrict__ xyz,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ centers, int* __restrict__ idx,
                      int* __restrict__ cnt, int n, int m, int k, float r2) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];

  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = c < m;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  const uint8_t* valid = mask ? mask + static_cast<size_t>(b) * n : nullptr;

  float cx = 0.f, cy = 0.f, cz = 0.f;
  int* out = nullptr;
  if (active) {
    const float* pc = centers + (static_cast<size_t>(b) * m + c) * 3;
    cx = pc[0];
    cy = pc[1];
    cz = pc[2];
    out = idx + (static_cast<size_t>(b) * m + c) * k;
  }
  int hits = 0;
  int first = 0;
  bool done = !active;

  for (int t0 = 0; t0 < n; t0 += kTile) {
    // also the barrier that lets the previous tile be overwritten
    if (__syncthreads_and(done)) break;
    const int len = min(kTile, n - t0);
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const int g = t0 + j;
      const bool ok = valid == nullptr || valid[g];
      sx[j] = ok ? p[3 * g] : NAN;
      sy[j] = ok ? p[3 * g + 1] : NAN;
      sz[j] = ok ? p[3 * g + 2] : NAN;
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < len; ++j) {
        const float dx = __fsub_rn(cx, sx[j]);
        const float dy = __fsub_rn(cy, sy[j]);
        const float dz = __fsub_rn(cz, sz[j]);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        if (d2 < r2) {
          if (hits == 0) first = t0 + j;
          out[hits] = t0 + j;
          if (++hits == k) {
            done = true;
            break;
          }
        }
      }
    }
  }

  if (active) {
    for (int s = hits; s < k; ++s) out[s] = first;  // 0 for an empty ball
    cnt[static_cast<size_t>(b) * m + c] = hits;
  }
}

}  // namespace

// xyz [B, N, 3] f32, mask [B, N] u8 or null, centers [B, M, 3] f32,
// idx [B, M, K] i32, cnt [B, M] i32. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int tpu3dsad_ball_query(const float* xyz, const uint8_t* mask,
                                   const float* centers, int* idx, int* cnt,
                                   int b, int n, int m, int k, float r2,
                                   void* stream) {
  if (b <= 0 || m <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((m + kThreads - 1) / kThreads, b);
  ball_query_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, mask, centers, idx, cnt, n, m, k, r2);
  return static_cast<int>(cudaGetLastError());
}
