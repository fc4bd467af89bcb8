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
// Left for later: at B = 32 only 32 of the 132 SMs work.
//
// The same file holds the large single-cloud FPS (fps_flat_kernel below,
// entry tpu3dsad_fps_flat), which replaces the Pallas TPU kernel
// tpu3dsad/ops/pallas/fps.py::_fps_kernel_flat (launched by _fps_call_flat /
// _fps_flat_single for B == 1, N > 65536). Same semantics as above.
//
// What bounds it: the same chain of M dependent rounds, now over one cloud
// of ~120k points (config #4: crop, then 16384 picks). One block per cloud
// would run each round's pass over all N points on one SM. Instead one
// thread-block cluster of C CTAs (16 where the card allows a non-portable
// cluster, else 8) shares the cloud: CTA r owns the contiguous slice
// [r*S, (r+1)*S), S = ceil(N / C), so a point's global index stays its key.
// Where 16 B per point fit in shared memory (x, y, z and the running
// distance; ~123 KB per CTA at N = 123k, C = 16) the slice lives there for
// the whole run; larger clouds read from global memory as B1 does.
//
// One round: each CTA updates its slice and reduces it to one partial
// 64-bit key, written to a shared slot double-buffered by round parity;
// one cluster.sync(); then every warp reads the C partials through
// distributed shared memory (map_shared_rank) and reduces them to the same
// winner, with no trip through global memory. The parity buffer makes one
// barrier per round enough: a CTA can only overwrite slot p in round i + 2
// after every CTA passed round i + 1's barrier, i.e. finished reading
// round i's slot p. A last cluster.sync() keeps every CTA resident until
// the others have read its slots.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kFlatThreads = 1024;
// static shared memory of fps_flat_kernel (warp partials, parity slots),
// rounded up; the dynamic slice must fit beside it
constexpr size_t kFlatStaticSmem = 1024;

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

__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(0xFFFFFFFFu -
                          static_cast<unsigned int>(key & 0xFFFFFFFFull));
}

// One cloud over one cluster. kShared: the slice (x, y, z, running
// distance as four planes of `slice` floats) lives in dynamic shared
// memory; else points come from xyz and distances from the [N] scratch.
template <bool kShared>
__global__ void __launch_bounds__(kFlatThreads)
    fps_flat_kernel(const float* __restrict__ xyz,
                    const uint8_t* __restrict__ mask, float* __restrict__ dist,
                    int* __restrict__ idx, int n, int m, int slice) {
  extern __shared__ float planes[];
  __shared__ unsigned long long warp_best[kFlatThreads / 32];
  __shared__ unsigned long long partial[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int lo = rank * slice;
  const int count = max(0, min(n, lo + slice) - lo);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* sx = planes;
  float* sy = planes + slice;
  float* sz = planes + 2 * slice;
  float* sd = planes + 3 * slice;
  const bool leader = rank == 0 && threadIdx.x == 0;

  // each thread initialises and later updates only its own points, so the
  // slice needs no barrier
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const int g = lo + j;
    const float d0 = (mask == nullptr || mask[g]) ? INFINITY : -INFINITY;
    if (kShared) {
      sx[j] = xyz[3 * g];
      sy[j] = xyz[3 * g + 1];
      sz[j] = xyz[3 * g + 2];
      sd[j] = d0;
    } else {
      dist[g] = d0;
    }
  }
  if (leader) idx[0] = 0;

  int last = 0;
  for (int i = 1; i < m; ++i) {
    const float lx = __ldg(xyz + 3 * last), ly = __ldg(xyz + 3 * last + 1),
                lz = __ldg(xyz + 3 * last + 2);
    unsigned long long best = 0;  // below every real key
    for (int j = threadIdx.x; j < count; j += blockDim.x) {
      float nd;
      if (kShared) {
        nd = fminf(sd[j], sqdist(sx[j], sy[j], sz[j], lx, ly, lz));
        sd[j] = nd;
      } else {
        const int g = lo + j;
        nd = fminf(dist[g],
                   sqdist(xyz[3 * g], xyz[3 * g + 1], xyz[3 * g + 2], lx, ly,
                          lz));
        dist[g] = nd;
      }
      const unsigned long long key = pack_key(nd, lo + j);
      best = key > best ? key : best;
    }
    best = warp_max(best);
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    if (warp == 0) {
      unsigned long long v = lane < nwarps ? warp_best[lane] : 0ull;
      v = warp_max(v);
      if (lane == 0) partial[i & 1] = v;
    }
    cluster.sync();
    unsigned long long v =
        lane < csize ? *cluster.map_shared_rank(&partial[i & 1], lane) : 0ull;
    last = key_index(warp_max(v));
    if (leader) idx[i] = last;
  }
  cluster.sync();
}

// Launch fps_flat_kernel over one cluster of c CTAs with `smem` bytes of
// dynamic shared memory each, if the card can place such a cluster
// (*placed says whether it could; a refusal is not an error).
template <bool kShared>
cudaError_t launch_flat(const float* xyz, const uint8_t* mask, float* dist,
                        int* idx, int n, int m, int c, size_t smem,
                        cudaStream_t stream, bool* placed) {
  auto kernel = fps_flat_kernel<kShared>;
  *placed = false;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (c > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(c, 1, 1);
  config.blockDim = dim3(kFlatThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess || clusters < 1) {
    cudaGetLastError();  // a refused size is not a fault: try a smaller one
    return cudaSuccess;
  }
  *placed = true;
  const int slice = (n + c - 1) / c;
  err = cudaLaunchKernelEx(&config, kernel, xyz, mask, dist, idx, n, m, slice);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// One cloud: xyz [N, 3] f32, mask [N] u8 or null, dist [N] f32 scratch
// (used when the slices do not fit in shared memory), idx [M] i32.
// Launches on `stream`; *cluster_out gets the cluster size used (0 if none
// could be placed, with cudaErrorInvalidConfiguration). Returns
// cudaGetLastError().
extern "C" int tpu3dsad_fps_flat(const float* xyz, const uint8_t* mask,
                                 float* dist, int* idx, int n, int m,
                                 int* cluster_out, void* stream) {
  *cluster_out = 0;
  if (n <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sizes[] = {16, 8, 4, 2, 1};
  for (int c : sizes) {
    const size_t smem = 16 * static_cast<size_t>((n + c - 1) / c);
    bool placed = false;
    if (smem + kFlatStaticSmem <= static_cast<size_t>(optin))
      err = launch_flat<true>(xyz, mask, dist, idx, n, m, c, smem, s, &placed);
    else
      err = launch_flat<false>(xyz, mask, dist, idx, n, m, c, 0, s, &placed);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (placed) {
      *cluster_out = c;
      return static_cast<int>(cudaSuccess);
    }
  }
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

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
