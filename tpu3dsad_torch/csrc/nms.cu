// Greedy NMS walk over a precomputed IoU matrix, for sm_90a.
//
// Replaces no Pallas kernel: the reference runs the walk as an XLA
// fori_loop (tpu3dsad/ops/nms.py:81-104, _greedy_suppress), one compiled
// program. The port's plain version (ops/plain/nms.py) walks the K
// candidates in a Python loop of 4-5 launches a step, so a served request
// at K = 256 spent 1071-1328 launches in it, paced by the host. Launched by
// greedy_suppress (ops/cuda/nms.py) through the custom op
// tpu3dsad_torch::greedy_suppress (ops/library.py), for every NMS flavour:
// it takes the IoU, not the boxes.
//
// Semantics, equal bit for bit to the plain version:
//   order  = argsort(-where(valid, score, -inf)), stable: descending
//            score, ties to the lower index, invalid candidates last;
//            every NaN key after every number, -0 equal to +0, as torch's
//            sort;
//   over   = iou[order r, order j] > thresh (fp32; NaN is false), j != r;
//   walk   : r is kept if it is valid and not yet removed; a kept r
//            removes every j of its row;
//   keep   = the kept candidates at their own indices (all valid).
//
// One CTA a cloud, four phases between barriers:
//  1. Order. Each candidate's key is its sort key as an ordered 32-bit
//     integer above its index: keys are distinct, and a candidate's rank
//     is the number of keys below its own (K^2 compares a cloud, read
//     from shared memory as broadcasts). order[rank] = index.
//  2. Bitmask. Warp w takes sorted rows w, w + 32, ...: for each 64-bit
//     word of a row, lane l tests columns 64 word + l and + 32 (an IoU
//     gathered from the row, which L1 keeps) and two ballots make the
//     word. K rows of ceil(K / 64) words in shared memory: 8 KB at
//     K = 256, 128 KB at the limit K = 1024.
//  3. Walk, in warp 0. Lane l keeps word l of the removed set in a
//     register. For word w, every lane takes lane w's word and walks its
//     64 rows: a row is kept where its validity bit is set and its removed
//     bit is not, and then ORs its diagonal word into the walked word and
//     lane l its word l > w into its own. The loads do not wait on the
//     walk, so a step is a few instructions of one dependent chain.
//  4. Scatter: keep[order r] = kept r, each byte written once.
//
// What bounds it: latency. At B = 32, K = 256 it reads 8.4 MB of IoU (2.5
// us at 3.35 TB/s), spread over 32 CTAs; the walk is K serial steps of a
// few cycles each. The launch, one a call, replaces the plain version's
// 4-5 a candidate.
// All index arithmetic is 32-bit within a cloud; K <= 1024.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;  // 16 words a row: lanes 0-15 hold the walk

// Dynamic shared memory for k candidates: the bitmask, the keys and the
// kept words (64-bit), the order (int) and the validity (bytes).
size_t smem_bytes(int k) {
  const size_t words = (k + 63) / 64;
  return sizeof(uint64_t) * (k * words + k + words) + sizeof(int) * k + k;
}

// x as an unsigned integer in the order of torch's sort: every NaN alike
// and last, -0 equal to +0.
__device__ __forceinline__ uint32_t ordered(float x) {
  if (isnan(x)) return 0xFFFFFFFFu;
  if (x == 0.0f) x = 0.0f;
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads, 1)
    nms_walk_kernel(const float* __restrict__ iou,
                    const float* __restrict__ scores, long long sb,
                    long long sk, const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep, int k, float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 63) >> 6;
  uint64_t* mask = reinterpret_cast<uint64_t*>(smem);  // [k][words]
  uint64_t* keys = mask + k * words;                   // [k]
  uint64_t* kept = keys + k;                           // [words]
  int* order = reinterpret_cast<int*>(kept + words);   // [k]
  uint8_t* ok = reinterpret_cast<uint8_t*>(order + k);  // [k], by index
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  const float* cloud = iou + base * k;

  // 1. order
  for (int i = tid; i < k; i += kThreads) {
    const bool v = valid[base + i] != 0;
    ok[i] = v;
    const float s = v ? scores[blockIdx.x * sb + i * sk] : -INFINITY;
    keys[i] = (static_cast<uint64_t>(ordered(-s)) << 32) |
              static_cast<uint32_t>(i);
  }
  __syncthreads();
  for (int i = tid; i < k; i += kThreads) {
    const uint64_t mine = keys[i];
    int rank = 0;
#pragma unroll 8
    for (int j = 0; j < k; ++j) rank += keys[j] < mine;
    order[rank] = i;
  }
  __syncthreads();

  // 2. bitmask, in sorted coordinates
  for (int r = warp; r < k; r += kWarps) {
    const float* row = cloud + static_cast<size_t>(order[r]) * k;
#pragma unroll 4
    for (int w = 0; w < words; ++w) {
      const int j0 = (w << 6) + lane, j1 = j0 + 32;
      const bool p0 = j0 < k && j0 != r && row[order[j0]] > thresh;
      const bool p1 = j1 < k && j1 != r && row[order[j1]] > thresh;
      const uint32_t lo = __ballot_sync(kAll, p0);
      const uint32_t hi = __ballot_sync(kAll, p1);
      if (lane == 0) mask[r * words + w] = (static_cast<uint64_t>(hi) << 32) | lo;
    }
  }
  __syncthreads();

  // 3. the walk
  if (warp == 0) {
    uint64_t removed = 0;  // lane l < words: word l of the removed set
    for (int w = 0; w < words; ++w) {
      uint64_t cur = __shfl_sync(kAll, removed, w);
      uint64_t taken = 0;
      const int rows = min(64, k - (w << 6));
#pragma unroll 8
      for (int i = 0; i < rows; ++i) {
        const int r = (w << 6) + i;
        const uint64_t diag = mask[r * words + w];
        const uint64_t mine =
            (lane > w && lane < words) ? mask[r * words + lane] : 0ull;
        if (ok[order[r]] && !((cur >> i) & 1ull)) {
          cur |= diag;
          removed |= mine;
          taken |= 1ull << i;
        }
      }
      if (lane == 0) kept[w] = taken;
    }
  }
  __syncthreads();

  // 4. scatter back to the candidates' own indices
  for (int r = tid; r < k; r += kThreads)
    keep[base + order[r]] = static_cast<uint8_t>((kept[r >> 6] >> (r & 63)) & 1ull);
}

}  // namespace

// iou [B, K, K] f32 and valid [B, K] u8 (0 / 1), contiguous; scores
// [B, K] f32 with strides (sb, sk) in floats (the objectness column of
// the softmax is read in place); keep [B, K] u8, written whole. One
// launch of B CTAs on `stream`; returns cudaErrorInvalidValue for
// K > 1024, else the attribute's or the launch's error.
extern "C" int tpu3dsad_nms_walk(const float* iou, const float* scores,
                                 long long sb, long long sk,
                                 const uint8_t* valid, uint8_t* keep, int b,
                                 int k, float thresh, void* stream) {
  if (b <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  if (k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(k);
  const cudaError_t err = cudaFuncSetAttribute(
      nms_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_walk_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      iou, scores, sb, sk, valid, keep, k, thresh);
  return static_cast<int>(cudaGetLastError());
}
