// The points inside each axis-aligned box, counted per box, for sm_90a.
//
// Replaces no Pallas kernel: the reference has no Group-Free model. The
// port's Group-Free parse (eval/parse.py::parse_groupfree) keeps a box only
// where more than 5 valid input points lie in it (mmdet3d's non-empty
// filter, mmcv's points_in_boxes with the heading 0). In plain torch that
// is a [B, P, N] intermediate: 16 x 768 x 51200 booleans a request.
// Launched by box_points (ops/cuda/box_points.py) through the custom op
// tpu3dsad_torch::box_points (ops/library.py).
//
// Semantics: point q lies in the box of centre c and size s where
//   |q.x - c.x| < s.x * 0.5  and  |q.y - c.y| < s.y * 0.5  and
//   |q.z - c.z| <= s.z * 0.5,
// each difference rounded in fp32 on its own (__fsub_rn) and each half
// exact, as the plain op (ops/plain/box_points.py) writes them, so the two
// agree bit for bit. A masked point takes NaN coordinates in shared memory,
// and NaN fails every comparison, as the plain op's mask does.
//
// What bounds it: the comparisons, B P N of them. At the served shape
// (16 x 768 boxes, 51200 points) that is 629 M point-box tests of ~9 fp32
// operations each, ~85 us at 67 TFLOP/s; each CTA reads its scene's points
// and mask once (13 bytes a point), 256 MB over the 384 CTAs, ~76 us at
// 3.35 TB/s, most of it from L2.
//
// Layout: one CTA a (tile of kBoxes boxes, scene). Lane l of every warp
// holds box tile * kBoxes + l in registers; the CTA stages kChunk points
// at a time in shared memory as float4s, and warp w tests points w,
// w + kWarps, ... of each chunk against its lane's box (every lane of a
// warp reads the same point: a broadcast). The warps' counts meet in
// shared memory at the end, and warp 0 writes each box's count once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBoxes = 32;     // boxes a CTA: one a lane
constexpr int kChunk = 2048;   // points staged at a time: 32 KB

__global__ void __launch_bounds__(kThreads)
box_points_kernel(const float* __restrict__ points,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ centers,
                  const float* __restrict__ sizes, int* __restrict__ counts,
                  int n, int p) {
  __shared__ float4 staged[kChunk];
  __shared__ int partial[kWarps][kBoxes];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int box = blockIdx.x * kBoxes + lane;
  const bool real = box < p;
  // a lane past the last box tests against negative halves: never inside
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  float hx = -1.0f, hy = -1.0f, hz = -1.0f;
  if (real) {
    const long long at = (static_cast<long long>(b) * p + box) * 3;
    cx = centers[at];
    cy = centers[at + 1];
    cz = centers[at + 2];
    hx = __fmul_rn(sizes[at], 0.5f);
    hy = __fmul_rn(sizes[at + 1], 0.5f);
    hz = __fmul_rn(sizes[at + 2], 0.5f);
  }
  const float* src = points + static_cast<long long>(b) * n * 3;
  const uint8_t* valid =
      mask == nullptr ? nullptr : mask + static_cast<long long>(b) * n;
  const float nan = __int_as_float(0x7fc00000);
  int count = 0;
  for (int base = 0; base < n; base += kChunk) {
    const int len = min(kChunk, n - base);
    __syncthreads();  // the last chunk's tests are done
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float* q = src + static_cast<long long>(base + i) * 3;
      staged[i] = (valid == nullptr || valid[base + i])
                      ? make_float4(q[0], q[1], q[2], 0.0f)
                      : make_float4(nan, nan, nan, 0.0f);
    }
    __syncthreads();
#pragma unroll 4
    for (int i = warp; i < len; i += kWarps) {
      const float4 q = staged[i];
      count += (fabsf(__fsub_rn(q.x, cx)) < hx) &
               (fabsf(__fsub_rn(q.y, cy)) < hy) &
               (fabsf(__fsub_rn(q.z, cz)) <= hz);
    }
  }
  partial[warp][lane] = count;
  __syncthreads();
  if (warp == 0 && real) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += partial[w][lane];
    counts[static_cast<long long>(b) * p + box] = total;
  }
}

}  // namespace

// counts[b, j] = the valid points of scene b inside box j (the comparisons
// above) over points [b, n, 3], mask [b, n] bytes (or null: every point
// valid), centers and sizes [b, p, 3], all contiguous. Nothing is launched
// for no scene or no box; with no point every count is 0.
extern "C" int tpu3dsad_box_points(const float* points, const uint8_t* mask,
                                   const float* centers, const float* sizes,
                                   int* counts, int b, int n, int p,
                                   void* stream) {
  if (b <= 0 || p <= 0) return static_cast<int>(cudaSuccess);
  if (b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((p + kBoxes - 1) / kBoxes, b);
  box_points_kernel<<<grid, kThreads, 0, s>>>(points, mask, centers, sizes,
                                              counts, n < 0 ? 0 : n, p);
  return static_cast<int>(cudaGetLastError());
}
