// Row scatter-add, the backward of gather/group, for sm_90a.
//
// Replaces the Pallas TPU kernels
// tpu3dsad/ops/pallas/scatter.py::_kernel_c_lanes / _kernel_n_lanes
// (launched by scatter_rows; wired in by ops/xla/group.py::_scatter_rows).
// Semantics, equal to the plain version tpu3dsad_torch/ops/plain/scatter.py:
//   out[b, n, c] = sum over u of [idx[b, u] == n] * g[b, u, c], in fp32;
//   rows with idx < 0 or idx >= n add nothing.
// Order of the adds: every row is summed from 0.0 in increasing u, one
// fp32 add at a time, whatever its length. So the result is the same in
// every run and equal, bit for bit, to numpy's sequential np.add.at in
// float32.
//
// The TPU kernel built one-hot tiles in VMEM and summed them on the matrix
// unit (three bf16 terms of g, two lane layouts): a machine with no
// scattered stores. The earlier form here ran one thread per element of g
// with an fp32 atomicAdd into a zero-filled out: two 64-bit divisions an
// element, adds serialised on the rows that ball query's padding repeats,
// out written twice (the fill, then the atomics' read-modify-write), and a
// sum that changed from run to run.
//
// What bounds it: bytes. g is read once (B x U x C fp32: 137 MB at config
// #3's SA2 group backward, 41 us at 3.35 TB/s), idx once and out written
// once; an add per element of g is far below the card's fp32 rate. A row's
// sum in u order needs its entries in u order, and they lie anywhere in g:
// g is gathered, a row of g (0.5-1 KB) at a time. The adds of one row are
// a chain, but its loads need not be: a warp that loads its own row's
// entries has only a few in flight, and a row of 200 entries (ball query's
// padding makes such rows) then takes 200 / few round trips to memory. So
// the CTA gathers for all its rows at once, into shared memory, and each
// warp adds from there.
//
// One launch, no cluster, no scratch in global memory, no atomic. The K
// CTAs of a cloud deal its rows round robin, CTA k rows k, k + K, ...: at
// most R = 2 x warps each, K the least power of two >= n / R (so a row's
// CTA and its place there are a mask and a shift), and a slice of at
// most 288 channels. Rows in sequence are not alike: at config #3's SA2
// the first FPS picks lie in sparse parts of the scene, so the CTA of the
// R rows in sequence with the most entries would hold several times the
// mean, where rows dealt round robin keep every CTA near it (PERF.md,
// `profile_port.py --scatter`).
//  * Fill: the CTA reads the cloud's idx (L2-resident: 128 KB at SA2, read
//    by every CTA of the cloud), warp w a contiguous segment of it, and
//    keeps the entries that fall in its rows, in u order, packed as
//    (row / K) << 24 | u, in its own region of shared memory (ballot and
//    popcount). The regions, in warp order, are then copied into one
//    list: the CTA's entries in u order.
//  * Gather: the list is cut into chunks of as many rows of g as a stage
//    buffer holds (32 KB); all warps copy a chunk's rows of g into a stage
//    with cp.async (4-byte copies, lanes over channels: a row of g is not
//    16-byte aligned), three stages, so two chunks are in flight while one
//    is summed.
//  * Sum: warp w, lanes over channels, scans the chunk's entries with a
//    ballot for each of its rows and adds the hits from the stage into
//    its registers, in list order: u order.
//  * Write: the warp writes each of its rows once, zeros for an empty row.
// A region that overflows (more of its entries in the R rows than it
// holds) ends the fill at its first entry not kept: the regions before it
// and its kept prefix are summed, and the next fill starts there with
// segments as long as the part that fitted. So a row of any length is
// summed in u order by one warp.
// All index arithmetic is 32-bit; u < 2^24 (the packing).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kMaxWarps = 32;
constexpr int kRows = 2;         // rows a warp sums
constexpr int kList = 2048;      // entries of the regions, of the list
constexpr int kStage = 8192;     // floats of one stage (32 KB)
constexpr int kStages = 3;
constexpr int kScan = 16;        // loads of idx in flight a lane
constexpr int kMaxBlocks = 9;    // 32-channel blocks a warp holds
constexpr int kUBits = 24;       // u's bits in a list entry
constexpr int kUMask = (1 << kUBits) - 1;
// dynamic shared memory: the regions and the list (ints), the stages
constexpr size_t kSmemBytes =
    2 * kList * sizeof(int) + kStages * kStage * sizeof(float);

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;");
}

// Waits for all but the last kStages - 1 groups of copies.
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1));
}

// Issues the copies of entries [e0, e1) of the list (rows of g) into a
// stage, a row of `width` floats each; warp w takes every warps-th entry.
__device__ __forceinline__ void gather(float* stage, const int* list,
                                       int e0, int e1, const float* gs,
                                       long long su, int width, int warps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = e0 + warp; e < e1; e += warps) {
    const float* src = gs + (list[e] & kUMask) * su;
    float* dst = stage + (e - e0) * width;
    for (int ch = lane; ch < width; ch += 32) copy_async(dst + ch, src + ch);
  }
}

// Adds to acc, in list order, the staged rows of g of entries [e0, e1)
// whose row is lr.
template <int NB>
__device__ __forceinline__ void sum_row(float (&acc)[NB], const float* stage,
                                        const int* list, int e0, int e1,
                                        int lr, int width) {
  const int lane = threadIdx.x & 31;
  for (int base = e0; base < e1; base += 32) {
    const int e = base + lane < e1 ? list[base + lane] : -1;
    unsigned m = __ballot_sync(kAll, (e >> kUBits) == lr);
    while (m) {
      const float* s = stage + (base + __ffs(m) - 1 - e0) * width;
      m &= m - 1u;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int ch = 32 * j + lane;
        if (ch < width) acc[j] = __fadd_rn(acc[j], s[ch]);
      }
    }
  }
}

// grid (B x K, slices), K = 2^shift >= n / R, blockDim = warps x 32, R =
// kRows x warps: CTA (b, k, s) owns rows k, k + K, ... of cloud b (row
// lr K + k is its local row lr), channels [s x slice, s x slice + slice)
// of its C.
template <int NB>
__global__ void __launch_bounds__(kMaxWarps * 32)
    scatter_kernel(const float* __restrict__ g, long long sb, long long su,
                   const int* __restrict__ idx, float* __restrict__ out,
                   int u, int c, int n, int slice, int shift) {
  extern __shared__ int smem[];
  int* regions = smem;
  int* list = smem + kList;
  float* stages = reinterpret_cast<float*>(smem + 2 * kList);
  __shared__ int took[kMaxWarps], stop[kMaxWarps];
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int ctas = 1 << shift;  // K
  const int b = blockIdx.x >> shift, k0 = blockIdx.x & (ctas - 1);
  const int span = (n - k0 + ctas - 1) >> shift;  // rows of this CTA
  const int c0 = blockIdx.y * slice;
  const int width = min(slice, c - c0);
  const int cap = kList / warps;  // a region's entries
  const int chunk = min(kList, kStage / width);  // entries a stage holds
  const int* ix = idx + static_cast<size_t>(b) * u;
  const float* gs = g + b * sb + c0;

  float acc[kRows][NB];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[i][j] = 0.f;
  }

  int lo = 0, seg = (u + warps - 1) / warps;
  while (lo < u) {
    // fill: this warp's segment [s_lo, s_hi) into its region, in order
    const int s_lo = min(lo + warp * seg, u), s_hi = min(s_lo + seg, u);
    int* region = regions + warp * cap;
    int count = 0, pos = s_hi;
    bool full = false;
    for (int base = s_lo; base < s_hi && !full; base += 32 * kScan) {
      int v[kScan];
#pragma unroll
      for (int k = 0; k < kScan; ++k) {
        const int j = base + 32 * k + lane;
        v[k] = j < s_hi ? __ldg(ix + j) : -1;
      }
#pragma unroll
      for (int k = 0; k < kScan; ++k) {
        if (full) break;
        const int j = base + 32 * k + lane;
        const int r = v[k];
        const bool hit = static_cast<unsigned>(r) < static_cast<unsigned>(n)
                         && (r & (ctas - 1)) == k0;
        const unsigned m = __ballot_sync(kAll, hit);
        const int rank = count + __popc(m & below);
        if (hit && rank < cap) region[rank] = (r >> shift << kUBits) | j;
        if (count + __popc(m) > cap) {  // the region is full: stop at the
          unsigned rest = m;            // first hit it does not hold
          for (int t = count; t < cap; ++t) rest &= rest - 1u;
          pos = base + 32 * k + __ffs(rest) - 1;
          count = cap;
          full = true;
        } else {
          count += __popc(m);
        }
      }
    }
    if (lane == 0) {
      took[warp] = count;
      stop[warp] = pos;
    }
    __syncthreads();
    // the first region that stopped short ends this fill, and the next
    // starts where it stopped, with segments as long as the part that
    // fitted; where none did, the next covers the rest
    int last = warps - 1, next = min(lo + warps * seg, u);
    int next_seg = (u - next + warps - 1) / warps;
    int total = 0, mine = 0;  // entries of regions [0, last], before mine
    for (int w = 0; w < warps; ++w) {
      const int w_lo = min(lo + w * seg, u), w_hi = min(w_lo + seg, u);
      if (w == warp) mine = total;
      total += took[w];
      if (stop[w] < w_hi) {
        last = w;
        next = stop[w];
        next_seg = stop[w] - w_lo;
        break;
      }
    }
    if (warp <= last) {
      for (int t = lane; t < count; t += 32) list[mine + t] = region[t];
    }
    __syncthreads();

    // gather and sum, chunk by chunk, kStages - 1 chunks in flight
    const int chunks = (total + chunk - 1) / chunk;
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < chunks)
        gather(stages + k * kStage, list, k * chunk,
               min(k * chunk + chunk, total), gs, su, width, warps);
      commit_async();
    }
    for (int k = 0; k < chunks; ++k) {
      const int e0 = k * chunk, e1 = min(e0 + chunk, total);
      const int ahead = k + kStages - 1;
      if (ahead < chunks)
        gather(stages + (ahead % kStages) * kStage, list, ahead * chunk,
               min(ahead * chunk + chunk, total), gs, su, width, warps);
      commit_async();
      wait_async();
      __syncthreads();
      const float* stage = stages + (k % kStages) * kStage;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int lr = warp * kRows + i;
        if (lr < span) sum_row(acc[i], stage, list, e0, e1, lr, width);
      }
      __syncthreads();  // the stage is refilled
    }
    lo = next;
    seg = next_seg;
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int lr = warp * kRows + i;
    if (lr >= span) continue;
    const int r = (lr << shift) + k0;
    float* o = out + (static_cast<size_t>(b) * n + r) * c + c0;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int ch = 32 * j + lane;
      if (ch < width) o[ch] = acc[i][j];
    }
  }
}

using Kernel = void (*)(const float*, long long, long long, const int*,
                        float*, int, int, int, int, int);

constexpr Kernel kKernels[kMaxBlocks] = {
    scatter_kernel<1>, scatter_kernel<2>, scatter_kernel<3>,
    scatter_kernel<4>, scatter_kernel<5>, scatter_kernel<6>,
    scatter_kernel<7>, scatter_kernel<8>, scatter_kernel<9>};

// The instance for c channels in `slices` slices of ceil(c / slices), or
// null where a slice is wider than 32 x kMaxBlocks.
Kernel instance(int c, int slices) {
  if (c < 1 || slices < 1) return nullptr;
  const int blocks = ((c + slices - 1) / slices + 31) / 32;
  return blocks <= kMaxBlocks ? kKernels[blocks - 1] : nullptr;
}

// Sets the instance's attributes on the current device, on every call
// since they are per device: the dynamic shared memory a CTA takes, and
// all of L1 as shared memory, so that an SM holds two CTAs.
cudaError_t prepare(Kernel kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

}  // namespace

// CTAs of `warps` warps an SM holds for c channels in `slices` slices;
// -1 on error.
extern "C" int tpu3dsad_scatter_occupancy(int warps, int slices, int c) {
  const Kernel kernel = instance(c, slices);
  int ctas = -1;
  if (kernel == nullptr || warps < 1 || warps > kMaxWarps ||
      prepare(kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &ctas, kernel, warps * 32, kSmemBytes) != cudaSuccess)
    return -1;
  return ctas;
}

// g [B, U, C] f32 with strides (sb, su, 1) in floats; idx [B, U] i32;
// out [B, n, C] f32, written whole (no fill needed). The plan: `warps`
// warps a CTA (2 rows each), channels in `slices` slices of
// ceil(C / slices) <= 32 x 9. One launch on `stream`; returns
// cudaErrorInvalidValue for a malformed plan, U or n >= 2^24 or a grid
// too large, else the attributes' or the launch's error.
extern "C" int tpu3dsad_scatter_rows(const float* g, long long sb,
                                     long long su, const int* idx,
                                     float* out, int b, int u, int c, int n,
                                     int warps, int slices, void* stream) {
  if (b <= 0 || c <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const Kernel kernel = instance(c, slices);
  if (kernel == nullptr || u < 0 || u > kUMask || n > kUMask || warps < 1 ||
      warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  int shift = 0;  // K = 2^shift CTAs a cloud, at most R rows each
  while ((kRows * warps) << shift < n) ++shift;
  if ((static_cast<long long>(b) << shift) > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slice = (c + slices - 1) / slices;
  const dim3 grid(static_cast<unsigned>(b) << shift, (c + slice - 1) / slice);
  kernel<<<grid, warps * 32, kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(g, sb, su, idx, out, u, c,
                                                 n, slice, shift);
  return static_cast<int>(cudaGetLastError());
}
