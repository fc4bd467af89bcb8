// Feature-space furthest point sampling (3DSSD's F-FPS) for sm_90a: FPS by
// the squared distance over each point's whole vector (xyz and its
// features, D values), launched as B thread-block clusters of C CTAs, one
// cluster per cloud. It has no TPU counterpart: the JAX package samples by
// xyz alone (csrc/fps.cu's B1 and B2).
//
// Semantics, equal to the plain version tpu3dsad_torch/ops/plain/ffps.py:
//   * the first pick is index 0;
//   * each round updates the running min of the fp32 distance
//     d2 = (...((0 + d_0^2) + d_1^2) + ...) + d_{D-1}^2, d_k = a_k - b_k,
//     summed in dimension order, to the chosen set, and picks its argmax,
//     ties to the lowest index (over xyz alone, D = 3, this is B1's
//     (dx*dx + dy*dy) + dz*dz);
//   * masked points start at -inf and are never picked; an all-masked
//     cloud picks index 0 every round.
// Every product and sum goes through the _rn intrinsics, so nvcc cannot
// contract them into FMAs: the plain version rounds each operation.
//
// Layout. The wrapper (ops/cuda/ffps.py) pads each point's D values with
// zeros to DP = 4 * dp4 floats, dp4 = ceil(D / 4) made odd. A zero pad adds
// fl(0 - 0)^2 = +0 to the sum, which leaves it bit for bit (the sum is never
// -0), so the pass reads whole float4s; an odd row stride of float4s keeps
// the 8 rows that one phase of a 128-bit shared load reads on 8 different
// bank groups.
//
// What bounds it. M - 1 dependent rounds, as in csrc/fps.cu, but here the
// pass is not small: a round reads N * DP floats of a cloud and does 3 of
// them in fp32 operations each (67 values a point over 4096 points at
// 3DSSD's second level, 131 over 512 at its third). So a cloud's points
// live in the shared memory of its cluster: CTA r owns the contiguous
// slice [r * S, (r + 1) * S), whose S * DP floats must fit a CTA (the
// wrapper refuses a cloud that no portable cluster of 8 holds); thread t
// holds the running distances of points r * S + k * T + t, k < P, in
// registers. A point's vector is read from shared memory with 128-bit
// loads, and the last pick's vector, which every thread needs, sits once in
// shared memory and is read as a broadcast.
//
// A round:
//  * the pass: each thread updates its points' distances and keeps its best
//    (ordered bits, index), the lowest index on ties;
//  * warp stage with redux.sync (max of the bits, then min of the index
//    among the lanes at that max), each warp's pair to a shared slot,
//    double-buffered by round parity; one __syncthreads;
//  * warp 0 reduces the warps' pairs and pushes the CTA's (bits, index), 8
//    bytes, into slot [parity][rank] of every CTA of the cluster with
//    st.async...mbarrier::complete_tx::bytes, which counts its bytes on
//    that CTA's barrier [parity] as it lands; thread 0 arms its barrier
//    once a round with an arrive.expect_tx of C * 8 bytes;
//  * every thread waits on its own CTA's barrier and reduces the C pairs,
//    so every CTA gets the same winner; the first dp4 threads copy its
//    vector (from global memory, where the padded points are; the cloud is
//    L2-resident) into the shared pick vector; a second __syncthreads.
// The plan (C, T, P) is chosen by the wrapper (ops/cuda/ffps.py,
// plan()) and passed as candidates in order of preference; the entry
// launches the first whose B clusters the card places in one wave
// (cudaOccupancyMaxActiveClusters: a cluster's CTAs share a GPC, and a GPC
// of the H100 holds 14 to 18 SMs, so B clusters of 8 CTAs a whole SM each
// may not fit at once where 7 do), else the first it places at all.
//
// The double buffering is csrc/fps.cu's, and safe for its reasons: round i
// uses slots and barrier [i & 1]; a CTA writes slot [p] of another in round
// i + 2 only after its own wait of round i + 1 saw that CTA's round-(i + 1)
// pair, which that CTA sends only after all its threads passed round
// i + 1's first __syncthreads, that is after they read round i's slots
// [p]. The pick vector is rewritten after a round's first __syncthreads
// (every pass of the round is done) and read after its second.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 8;  // portable clusters only
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr unsigned kNone = 0xFFFFFFFFu;  // the index of an empty pair
constexpr unsigned kPairBytes = 8;

struct Exchange {
  uint2 warp_key[2][kMaxThreads / 32];  // (bits, index) of each warp
  uint2 cta_key[2][kMaxCluster];        // (bits, index) of each CTA
  unsigned long long bar[2];            // C pairs complete a round
};

// Order-preserving bits of a float (-inf above 0, which marks no point).
__device__ __forceinline__ unsigned ordered(float d) {
  const unsigned u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned in_cta(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void push(unsigned slot, unsigned bar, uint2 k) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];"
      :: "r"(slot), "r"(k.x), "r"(k.y), "r"(bar) : "memory");
}

__device__ __forceinline__ bool phase_done(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// fl(acc + fl(fl(a - l)^2)) for the four lanes of a float4, in order.
__device__ __forceinline__ float add4(float acc, float4 a, float4 l) {
  const float dx = __fsub_rn(a.x, l.x);
  const float dy = __fsub_rn(a.y, l.y);
  const float dz = __fsub_rn(a.z, l.z);
  const float dw = __fsub_rn(a.w, l.w);
  acc = __fadd_rn(acc, __fmul_rn(dx, dx));
  acc = __fadd_rn(acc, __fmul_rn(dy, dy));
  acc = __fadd_rn(acc, __fmul_rn(dz, dz));
  return __fadd_rn(acc, __fmul_rn(dw, dw));
}

// One float4 of the pass: each of the thread's P points adds its 4 values'
// squared differences to its sum. The rows past the slice's `own` points
// read its last row instead (their sums are never used), so every load is
// unconditional and the unrolled loop can issue them ahead of the
// sums, whose order it must keep.
template <int P>
__device__ __forceinline__ void pass_chunk(float (&acc)[P],
                                           const float4* rows,
                                           const float4* pick, int q, int t,
                                           int T, int own, int dp4) {
  const float4 l = pick[q];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int at = min(k * T + t, own - 1) * dp4 + q;
    acc[k] = add4(acc[k], rows[at], l);
  }
}

// points [B, n, 4 * dp4] (float4 rows), mask [B, n] u8 or null, idx [B, m];
// slice: the points a CTA owns (C * slice >= n), staged in shared memory;
// P points a thread (T * P >= slice).
template <int P>
__global__ void __launch_bounds__(kMaxThreads)
    ffps_kernel(const float4* __restrict__ points,
                const uint8_t* __restrict__ mask, int* __restrict__ idx, int n,
                int dp4, int m, int slice) {
  extern __shared__ float4 dyn[];  // slice * dp4 rows, then pick [dp4]
  __shared__ Exchange ex;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned csize = cluster.num_blocks();
  const int b = blockIdx.x / csize;
  const float4* cloud = points + static_cast<size_t>(b) * n * dp4;
  const uint8_t* valid = mask ? mask + static_cast<size_t>(b) * n : nullptr;
  int* out = idx + static_cast<size_t>(b) * m;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = T >> 5;
  const int lo = static_cast<int>(rank) * slice;
  const int own = max(0, min(slice, n - lo));  // real points of the slice
  const bool leader = rank == 0 && t == 0;

  float4* rows = dyn;
  float4* pick = dyn + slice * dp4;
  const float4* src = cloud + static_cast<size_t>(lo) * dp4;
  for (int e = t; e < own * dp4; e += T) rows[e] = __ldg(src + e);

  float pd[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = k * T + t;
    pd[k] = (j < own && (valid == nullptr || valid[lo + j])) ? INFINITY
                                                             : -INFINITY;
  }
  for (int q = t; q < dp4; q += T) pick[q] = __ldg(cloud + q);  // point 0

  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem(&ex.bar[0])), "r"(1) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem(&ex.bar[1])), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (leader) out[0] = 0;
  cluster.sync();  // barriers armed everywhere; the slice and pick written

  for (int i = 1; i < m; ++i) {
    const int par = (i - 1) & 1;
    const unsigned phase = ((i - 1) >> 1) & 1;
    if (t == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(smem(&ex.bar[par])), "r"(csize * kPairBytes)
                   : "memory");

    // the pass (CTA-uniform: a CTA past the cloud's end has no point)
    float acc[P];
#pragma unroll
    for (int k = 0; k < P; ++k) acc[k] = 0.f;
    if (own > 0) {
#pragma unroll 4
      for (int q = 0; q < dp4; ++q)
        pass_chunk<P>(acc, rows, pick, q, t, T, own, dp4);
    }
    unsigned bu = 0, bg = kNone;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int j = k * T + t;
      if (j < own) {
        pd[k] = fminf(pd[k], acc[k]);  // a masked point keeps -inf
        const unsigned u = ordered(pd[k]);
        if (u > bu) {
          bu = u;
          bg = static_cast<unsigned>(lo + j);
        }
      }
    }

    // warp stage, then the CTA's
    const unsigned wu = __reduce_max_sync(kAll, bu);
    const unsigned wg = __reduce_min_sync(kAll, bu == wu ? bg : kNone);
    if (lane == 0) ex.warp_key[par][warp] = make_uint2(wu, wg);
    __syncthreads();
    if (warp == 0) {
      const uint2 e =
          lane < nwarps ? ex.warp_key[par][lane] : make_uint2(0u, kNone);
      const unsigned cu = __reduce_max_sync(kAll, e.x);
      const unsigned cw = __reduce_min_sync(kAll, e.x == cu ? e.y : kNone);
      if (lane < static_cast<int>(csize))
        push(in_cta(smem(&ex.cta_key[par][rank]), lane),
             in_cta(smem(&ex.bar[par]), lane), make_uint2(cu, cw));
    }

    // cluster stage: every thread reduces the C pairs
    const unsigned bar = smem(&ex.bar[par]);
    while (!phase_done(bar, phase)) {
    }
    const uint2 e = lane < static_cast<int>(csize) ? ex.cta_key[par][lane]
                                                   : make_uint2(0u, kNone);
    const unsigned gu = __reduce_max_sync(kAll, e.x);
    const unsigned win = __reduce_min_sync(kAll, e.x == gu ? e.y : kNone);
    for (int q = t; q < dp4; q += T)
      pick[q] = __ldg(cloud + static_cast<size_t>(win) * dp4 + q);
    if (leader) out[i] = static_cast<int>(win);
    __syncthreads();
  }
  cluster.sync();  // keep every CTA resident while others may push to it
}

using Kernel = void (*)(const float4*, const uint8_t*, int*, int, int, int,
                        int);

Kernel kernel_for(int points) {
  switch (points) {
    case 1: return ffps_kernel<1>;
    case 2: return ffps_kernel<2>;
    case 4: return ffps_kernel<4>;
    case 8: return ffps_kernel<8>;
    case 16: return ffps_kernel<16>;
    default: return nullptr;
  }
}

// Set the kernel's attributes for candidate (c, t) and fill the launch
// configuration of b clusters of c CTAs.
cudaError_t configure(Kernel kernel, int b, int n, int dp4, int c, int t,
                      cudaStream_t stream, cudaLaunchAttribute* attr,
                      cudaLaunchConfig_t* config) {
  const int slice = (n + c - 1) / c;
  const size_t smem_bytes =
      sizeof(float4) * (static_cast<size_t>(slice) * dp4 + dp4);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *config = {};
  config->gridDim = dim3(b * c, 1, 1);
  config->blockDim = dim3(t, 1, 1);
  config->dynamicSmemBytes = smem_bytes;
  config->stream = stream;
  config->attrs = attr;
  config->numAttrs = 1;
  return err;
}

}  // namespace

// points [B, N, 4 * dp4] f32 (zero-padded rows, dp4 odd), mask [B, N] u8 or
// null, idx [B, M] i32. plans: `count` candidates (cluster size, threads,
// points a thread) as 3 * count ints, in order of
// preference. Launches the first that the card places as B clusters in one
// wave, else the first it places at all, on `stream`; *used gets its
// position (-1 if none launched). Returns cudaErrorInvalidValue for a
// malformed candidate, cudaErrorInvalidConfiguration if none can be
// placed, else cudaGetLastError().
extern "C" int tpu3dsad_ffps(const float* points, const uint8_t* mask,
                             int* idx, int b, int n, int dp4, int m,
                             const int* plans, int count, int* used,
                             void* stream) {
  *used = -1;
  if (b <= 0 || n <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  if (dp4 < 1 || dp4 % 2 == 0 || m > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config;
  int fallback = -1;
  for (int i = 0; i < count; ++i) {
    const int* p = plans + 3 * i;
    const int c = p[0], t = p[1], points_a_thread = p[2];
    const Kernel kernel = kernel_for(points_a_thread);
    if (kernel == nullptr || c < 1 || c > kMaxCluster || t < 32 ||
        t > kMaxThreads || t % 32 != 0 ||
        static_cast<long long>(t) * points_a_thread < (n + c - 1) / c)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = configure(kernel, b, n, dp4, c, t, s, attr, &config);
    int clusters = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) {
      cudaGetLastError();  // a size the card refuses is not a fault
      continue;
    }
    if (clusters >= b) {
      *used = i;
      break;
    }
    if (clusters >= 1 && fallback < 0) fallback = i;
  }
  if (*used < 0) {
    if (fallback < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    *used = fallback;
  }
  const int* p = plans + 3 * *used;
  const Kernel kernel = kernel_for(p[2]);
  cudaError_t err = configure(kernel, b, n, dp4, p[0], p[1], s, attr, &config);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&config, kernel,
                             reinterpret_cast<const float4*>(points), mask,
                             idx, n, dp4, m, (n + p[0] - 1) / p[0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
