// Furthest point sampling for sm_90a: one kernel template for every cloud,
// launched as B thread-block clusters of C CTAs, one cluster per cloud.
//
// It replaces two Pallas TPU kernels of tpu3dsad/ops/pallas/fps.py:
//   * _fps_kernel (B1, batched clouds; launched by _fps_call /
//     _fps_call_grid, entry furthest_point_sample), through the C entry
//     tpu3dsad_fps;
//   * _fps_kernel_flat (B2, one cloud of more than 65536 points; launched
//     by _fps_call_flat / _fps_flat_single), through tpu3dsad_fps_flat.
// Semantics, equal to the plain version tpu3dsad_torch/ops/plain/fps.py:
//   * the first pick is index 0;
//   * each round updates the running min of the fp32 elementwise
//     d2 = (dx*dx + dy*dy) + dz*dz to the chosen set and picks its argmax,
//     ties to the lowest index;
//   * masked points start at -inf and are never picked (min keeps -inf);
//     an all-masked cloud picks index 0 every round, like argmax over -inf.
// Products and sums use the _rn intrinsics so nvcc cannot contract them
// into FMAs: the plain version rounds every operation, and one ulp moves
// picks on near-ties.
//
// What bounds it: the chain of M - 1 dependent rounds. A round updates the
// running distance of every point to the last pick and takes the argmax,
// and the next round needs that winner, so rounds cannot overlap. The
// bytes (xyz read once) and the operations (10 a point a round) would take
// the card a fraction of a microsecond a round; what a round costs is its
// latency: the pass over the cloud's slice, then a reduction across warps,
// CTAs and the cluster, and the winner's coordinates back to every thread.
// The design cuts each piece of that latency:
//
//  * Points live in registers. CTA r of a cluster owns the contiguous
//    slice [r*S, (r+1)*S) of its cloud, S = T*P, so a point's global index
//    stays its key; thread t holds points r*S + k*T + t, k < P (P a
//    template parameter, the loop unrolled), as x, y, z and running
//    distance in registers. A round's pass touches no memory. Points at or
//    past N are pads: -inf like masked points, at indices >= N, so a real
//    point (index 0 at least) always outranks them and a CTA with no real
//    point never wins. A copy of the slice's xyz in shared memory serves
//    only to look up the CTA winner's coordinates once a round.
//  * Warp stage with redux.sync, no 64-bit shuffles. The order is the
//    distance first, then the lowest index: __reduce_max_sync of the
//    order-preserving distance bits, then __reduce_min_sync of the index
//    among the lanes that hold that max.
//  * CTA stage: each warp writes its (bits, index) to a shared slot,
//    double-buffered by round parity; one __syncthreads; warp 0 reduces
//    the <= 32 entries the same way and looks up the winner's xyz.
//  * Cluster stage, one message and no cluster barrier: warp 0 pushes the
//    CTA's partial (bits, index, xyz: 20 bytes) into slot [parity][rank] of
//    every CTA of the cluster, lane j into CTA j, with
//    st.async.shared::cluster.mbarrier::complete_tx::bytes: the store
//    itself counts its bytes on CTA j's barrier [parity], with release
//    semantics at cluster scope, so the sender issues no fence. Thread 0 of
//    each CTA arms its barrier [parity] once a round with an
//    arrive.expect_tx of C * 20 bytes (one arrival a phase), and the phase
//    completes when all C partials have landed. Every thread waits on its
//    own CTA's barrier (try_wait.parity.acquire.cluster) and reduces the C
//    partials itself, so every CTA gets the same winner and its xyz with no
//    global load and no cluster.sync() in the round. C = 1 takes the same
//    path through its own shared memory. (A remote st.shared::cluster
//    followed by mbarrier.arrive.release.cluster computes the same and was
//    measured ~0.25 us a round slower: PERF.md.)
//
// Why parity double-buffering is safe. Round i uses slots and barrier
// [i & 1]. CTA k writes slot [p][k] of CTA j in round i + 2 only after its
// own wait in round i + 1 saw the round-(i + 1) partial of every CTA, j's
// among them; j sends that partial only after all of its threads passed
// round i + 1's __syncthreads, that is after they finished reading round
// i's slots [p] (and after they waited on round i's phase of barrier [p],
// so no barrier runs two phases ahead of its waiters). Thread 0 arms barrier
// [p] for round i + 2 after its own wait saw round i's phase complete; a
// partial that lands before the arm only takes the transaction count below
// zero, and the arm's arrival, which the phase also waits for, comes after
// it. Inside a CTA, warp w
// rewrites its warp slot [p] in round i + 2 only after round i + 1's
// __syncthreads, which warp 0 reaches after reading round i's warp slots.
// Outside the round loop: one cluster.sync() after the barriers' init
// (with fence.mbarrier_init.release.cluster), and a final one that keeps
// every CTA resident while the others may still write to it.
//
// Clouds too large for the register tiers (C*T*P < N at P = 16) take the
// memory tier, P = 0: the same stages, but the pass reads the points from
// xyz and keeps the running distance in a [B, N] scratch in global memory,
// and the CTA winner's xyz comes from xyz. No main path runs it.
//
// The plan (C, T, P) is chosen by the wrapper (ops/cuda/fps.py, plan()) and
// passed as candidates in order of preference; the entry launches the
// first whose B clusters the card places in one wave
// (cudaOccupancyMaxActiveClusters), else the first it can place at all,
// and reports which it launched.
//
// B2's pruned pass (fps_cluster_kernel_pruned<16>, the flat entry given an
// `order`). Late in a run a pick lowers the running distance of a few dozen
// of ~118k points, yet every round recomputes them all. So the flat entry
// skips, warp by warp, the pass that provably changes nothing:
//
//  * The deal (the wrapper's pre-pass, ops/cuda/fps.py::slab_order): the
//    points' Z-order keys (tpu3dsad_morton_codes; masked points last), a
//    stable sort, cut into slabs of 32 * P = 512 points, each slab's
//    original indices in ascending order, padded with n. Slab s goes to CTA
//    s mod C, warp s div C; its element e to lane e mod 32 as the thread's
//    point k = e div 32. So a warp holds a spatially compact slab, and a
//    thread's points ascend in original index with k.
//  * Keys stay the original indices. A point carries (original index << 13
//    | its slot k*T + t in the CTA's slice) in a register; every stage
//    reduces (ordered distance bits, that key), so ties go to the lowest
//    original index, as in the plain version (the thread's first k among
//    its equal maxima is its lowest index), the CTA stage looks the
//    winner's xyz up by its slot, and idx gets the original index. Pads
//    carry index n: -inf, they never outrank a real point.
//  * Each warp keeps the fp32 box of its points whose distance is not -inf
//    (fminf / fmaxf: a NaN coordinate stays out; an empty box is +inf /
//    -inf) and its last (bits, key). A round first computes, warp-uniform,
//    lb = fl(fl(gx*gx + gy*gy) + gz*gz), each g the pick's distance outside
//    the box on its axis (fl(lo - l) below it, fl(l - hi) above, 0 inside),
//    the same _rn operations in the order of sqdist. Where lb >= wmax, the
//    float of the warp's cached bits (its largest running distance), the
//    warp skips its pass and sends its cached key; else it runs the pass
//    and refreshes the cache.
//  * Why a skip is exact. Round-to-nearest is monotone and odd: for a point
//    q in the box and l below it, q - l >= lo - l >= 0, so |fl(q - l)| >=
//    fl(lo - l); above it the same with l - q >= l - hi; inside, |fl(q - l)|
//    >= 0. Squares and sums of non-negative floats keep the order, so
//    sqdist(q, l) >= lb >= wmax >= pd for every point whose pd is not -inf,
//    and fminf(pd, sqdist) is pd bit for bit (distances are never -0). A
//    point outside the box has a NaN coordinate: its sqdist is NaN, and
//    fminf keeps pd; a -inf point keeps -inf; a NaN pick makes every sqdist
//    NaN. So the skipped pass would have changed no distance and no key,
//    and the picks are the unpruned kernel's, bit for bit. A NaN lb or
//    wmax compares false: the warp runs its pass.
//  * `engaged` (a tool's counter, null on served calls) gets each warp's
//    count of rounds it ran its pass, one atomicAdd a warp at the end.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;

// The most threads a CTA of the P-point template may have: 1024 leaves a
// thread 64 registers, enough for P <= 8 (4 * P hold the points); P = 16
// takes 512 threads and 128 registers.
constexpr int max_threads(int points) { return points > 8 ? 512 : 1024; }

constexpr unsigned kAll = 0xFFFFFFFFu;   // every lane of a warp
constexpr unsigned kNone = 0xFFFFFFFFu;  // the index of an empty partial

// What CTAs exchange, in static shared memory; round parity p picks a half.
struct Exchange {
  uint2 warp_key[2][kMaxThreads / 32];  // (bits, index) of each warp
  uint4 head[2][kMaxCluster];           // (bits, index, x, y) of each CTA
  float tail[2][kMaxCluster];           // and its winner's z
  unsigned long long bar[2];            // C partials complete a round
};

// Order-preserving bits of a float (-inf below +0.0); 0 ranks below the
// bits of every float, so it marks an empty partial.
__device__ __forceinline__ unsigned ordered(float d) {
  const unsigned u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float sqdist(float x, float y, float z, float lx,
                                        float ly, float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of the same variable in CTA `rank`.
__device__ __forceinline__ unsigned in_cta(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Store one partial into another CTA's slots; each store counts its bytes
// on that CTA's barrier when it lands.
constexpr unsigned kPartialBytes = 20;
__device__ __forceinline__ void push(unsigned head, unsigned tail, unsigned bar,
                                     uint2 k, float4 w) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];"
      :: "r"(head), "r"(k.x), "r"(k.y), "r"(__float_as_uint(w.x)),
         "r"(__float_as_uint(w.y)), "r"(bar) : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];"
      :: "r"(tail), "r"(__float_as_uint(w.z)), "r"(bar) : "memory");
}

// Whether the barrier finished the phase of the given parity; the acquire
// makes the pushed slots visible.
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

// The pruned pass's point key: the original index above the point's slot
// k * T + t in its CTA's slice (T * P <= 8192 slots; n < 2^19).
constexpr int kSlotBits = 13;
constexpr unsigned kSlotMask = (1u << kSlotBits) - 1;
constexpr int kPrunedPoints = 16;  // B2's tier: a slab of 512 points a warp

// The float of ordered() bits.
__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

// How far the pick l lies outside [lo, hi] on one axis, rounded as sqdist's
// difference: fl(lo - l) below, fl(l - hi) above, 0 inside.
__device__ __forceinline__ float gap(float l, float lo, float hi) {
  return l < lo ? __fsub_rn(lo, l) : (l > hi ? __fsub_rn(l, hi) : 0.f);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kAll, v, o));
  return __shfl_sync(kAll, v, 0);  // lane 0's, bit for bit in every lane
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return __shfl_sync(kAll, v, 0);
}

// One cloud per cluster; P points a thread in registers, or P = 0 for the
// memory tier (dist is a [B, N] scratch there and unused otherwise). Prune:
// B2's pruned pass (the header's last part) for one cloud, order its slabs'
// original indices, engaged the tool's counter or null.
template <int P, bool Prune>
__device__ __forceinline__ void fps_cluster(
    const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
    float* __restrict__ dist, int* __restrict__ idx, int n, int m,
    const int* __restrict__ order, unsigned long long* __restrict__ engaged) {
  static_assert(!Prune || P > 0, "the pruned pass keeps points in registers");
  extern __shared__ float4 slice_xyz[];  // register tier: the slice's xyz
  __shared__ Exchange ex;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned csize = cluster.num_blocks();
  const int b = blockIdx.x / csize;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  const uint8_t* valid = mask ? mask + static_cast<size_t>(b) * n : nullptr;
  int* out = idx + static_cast<size_t>(b) * m;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = T >> 5;
  const int slice = P > 0 ? T * P : (n + csize - 1) / csize;
  const int lo = static_cast<int>(rank) * slice;
  const bool leader = rank == 0 && t == 0;

  float px[P > 0 ? P : 1], py[P > 0 ? P : 1], pz[P > 0 ? P : 1],
      pd[P > 0 ? P : 1];
  unsigned key[Prune ? P : 1];  // pruned pass: each point's key
  float* d = nullptr;
  if constexpr (P > 0) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int j = k * T + t;
      int g = lo + j;
      if constexpr (Prune) {  // element k * 32 + lane of slab warp * C + rank
        const int slots = (n + 32 * P - 1) / (32 * P) * (32 * P);
        const int slab = warp * static_cast<int>(csize) + rank;
        const int e = (slab * P + k) * 32 + lane;
        g = e < slots ? __ldg(order + e) : n;
        key[k] = (static_cast<unsigned>(g) << kSlotBits) |
                 static_cast<unsigned>(j);
      }
      float x = 0.f, y = 0.f, z = 0.f, d0 = -INFINITY;  // a pad
      if (g < n) {
        x = p[3 * g];
        y = p[3 * g + 1];
        z = p[3 * g + 2];
        d0 = (valid == nullptr || valid[g]) ? INFINITY : -INFINITY;
      }
      px[k] = x;
      py[k] = y;
      pz[k] = z;
      pd[k] = d0;
      slice_xyz[j] = make_float4(x, y, z, 0.f);
    }
  } else {
    // each thread initialises and later updates only its own points
    d = dist + static_cast<size_t>(b) * n;
    for (int j = t; j < slice && lo + j < n; j += T)
      d[lo + j] = (valid == nullptr || valid[lo + j]) ? INFINITY : -INFINITY;
  }

  // pruned pass: the warp's box and its (bits, key) before the first round
  float box_lo[3], box_hi[3];
  uint2 cache = make_uint2(0u, kNone);
  unsigned rounds = 0;  // rounds this warp ran its pass
  if constexpr (Prune) {
    float lx0 = INFINITY, ly0 = INFINITY, lz0 = INFINITY;
    float hx0 = -INFINITY, hy0 = -INFINITY, hz0 = -INFINITY;
    float bd = pd[0];
    unsigned bkey = key[0];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (pd[k] != -INFINITY) {
        lx0 = fminf(lx0, px[k]);
        ly0 = fminf(ly0, py[k]);
        lz0 = fminf(lz0, pz[k]);
        hx0 = fmaxf(hx0, px[k]);
        hy0 = fmaxf(hy0, py[k]);
        hz0 = fmaxf(hz0, pz[k]);
      }
      if (k > 0 && pd[k] > bd) {
        bd = pd[k];
        bkey = key[k];
      }
    }
    box_lo[0] = warp_min(lx0);
    box_lo[1] = warp_min(ly0);
    box_lo[2] = warp_min(lz0);
    box_hi[0] = warp_max(hx0);
    box_hi[1] = warp_max(hy0);
    box_hi[2] = warp_max(hz0);
    const unsigned bu = ordered(bd);
    const unsigned wu = __reduce_max_sync(kAll, bu);
    cache = make_uint2(wu, __reduce_min_sync(kAll, bu == wu ? bkey : kNone));
  }

  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem(&ex.bar[0])), "r"(1) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem(&ex.bar[1])), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (leader) out[0] = 0;
  cluster.sync();

  float lx = __ldg(p), ly = __ldg(p + 1), lz = __ldg(p + 2);
  for (int i = 1; i < m; ++i) {
    const int par = (i - 1) & 1;
    const unsigned phase = ((i - 1) >> 1) & 1;
    if (t == 0)  // arm this round's barrier for the C partials
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(smem(&ex.bar[par])), "r"(csize * kPartialBytes)
                   : "memory");

    // pruned pass: whether the pick can lower a distance of this warp's
    // slab (warp-uniform: the pick, the box and the cache are)
    bool run = true;
    if constexpr (Prune) {
      const float gx = gap(lx, box_lo[0], box_hi[0]);
      const float gy = gap(ly, box_lo[1], box_hi[1]);
      const float gz = gap(lz, box_lo[2], box_hi[2]);
      const float lb = __fadd_rn(
          __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
      run = !(lb >= unordered(cache.x));
    }

    unsigned wu, wg;
    if (run) {
      // the pass: this thread's best (bits, index), lowest index on ties
      unsigned bu = 0, bg = kNone;
      if constexpr (P > 0) {
        float bd = 0.f;
        int bk = 0;
        unsigned bkey = 0;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const float nd =
              fminf(pd[k], sqdist(px[k], py[k], pz[k], lx, ly, lz));
          pd[k] = nd;
          if (k == 0 || nd > bd) {
            bd = nd;
            if constexpr (Prune)
              bkey = key[k];
            else
              bk = k;
          }
        }
        bu = ordered(bd);
        bg = Prune ? bkey : static_cast<unsigned>(lo + bk * T + t);
      } else {
        for (int j = t; j < slice && lo + j < n; j += T) {
          const int g = lo + j;
          const float nd =
              fminf(d[g], sqdist(p[3 * g], p[3 * g + 1], p[3 * g + 2], lx, ly,
                                 lz));
          d[g] = nd;
          const unsigned u = ordered(nd);
          if (u > bu) {
            bu = u;
            bg = static_cast<unsigned>(g);
          }
        }
      }

      // warp stage
      wu = __reduce_max_sync(kAll, bu);
      wg = __reduce_min_sync(kAll, bu == wu ? bg : kNone);
      if constexpr (Prune) {
        cache = make_uint2(wu, wg);
        ++rounds;
      }
    } else {  // a skipped pass changes nothing: the cached key stands
      wu = cache.x;
      wg = cache.y;
    }
    if (lane == 0) ex.warp_key[par][warp] = make_uint2(wu, wg);
    __syncthreads();

    // CTA stage, then the push to every CTA of the cluster
    if (warp == 0) {
      const uint2 e =
          lane < nwarps ? ex.warp_key[par][lane] : make_uint2(0u, kNone);
      const unsigned cu = __reduce_max_sync(kAll, e.x);
      const unsigned cw = __reduce_min_sync(kAll, e.x == cu ? e.y : kNone);
      if (lane < static_cast<int>(csize)) {
        float4 w;
        if constexpr (Prune) {
          w = slice_xyz[cw & kSlotMask];
        } else if constexpr (P > 0) {
          w = slice_xyz[cw - lo];  // pads have slots too
        } else {
          w = cw < static_cast<unsigned>(n)
                  ? make_float4(__ldg(p + 3 * cw), __ldg(p + 3 * cw + 1),
                                __ldg(p + 3 * cw + 2), 0.f)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        push(in_cta(smem(&ex.head[par][rank]), lane),
             in_cta(smem(&ex.tail[par][rank]), lane),
             in_cta(smem(&ex.bar[par]), lane), make_uint2(cu, cw), w);
      }
    }

    // cluster stage: every thread reduces the C partials
    const unsigned bar = smem(&ex.bar[par]);
    while (!phase_done(bar, phase)) {
    }
    const bool mine = lane < static_cast<int>(csize);
    const uint2 e = mine ? make_uint2(ex.head[par][lane].x,
                                      ex.head[par][lane].y)
                         : make_uint2(0u, kNone);
    const unsigned gu = __reduce_max_sync(kAll, e.x);
    const unsigned win = __reduce_min_sync(kAll, e.x == gu ? e.y : kNone);
    const int src = __ffs(__ballot_sync(kAll, mine && e.y == win)) - 1;
    const uint4 w = ex.head[par][src];
    lx = __uint_as_float(w.z);
    ly = __uint_as_float(w.w);
    lz = ex.tail[par][src];
    if (leader) out[i] = static_cast<int>(Prune ? win >> kSlotBits : win);
  }
  if constexpr (Prune) {
    if (engaged != nullptr && lane == 0)
      atomicAdd(engaged, static_cast<unsigned long long>(rounds));
  }
  cluster.sync();
}

template <int P>
__global__ void __launch_bounds__(max_threads(P))
    fps_cluster_kernel(const float* __restrict__ xyz,
                       const uint8_t* __restrict__ mask,
                       float* __restrict__ dist, int* __restrict__ idx, int n,
                       int m) {
  fps_cluster<P, false>(xyz, mask, dist, idx, n, m, nullptr, nullptr);
}

template <int P>
__global__ void __launch_bounds__(max_threads(P))
    fps_cluster_kernel_pruned(const float* __restrict__ xyz,
                              const uint8_t* __restrict__ mask,
                              const int* __restrict__ order,
                              int* __restrict__ idx, int n, int m,
                              unsigned long long* __restrict__ engaged) {
  fps_cluster<P, true>(xyz, mask, nullptr, idx, n, m, order, engaged);
}

using Kernel = void (*)(const float*, const uint8_t*, float*, int*, int, int);
using PrunedKernel = void (*)(const float*, const uint8_t*, const int*, int*,
                              int, int, unsigned long long*);

Kernel kernel_for(int points) {
  switch (points) {
    case 0: return fps_cluster_kernel<0>;
    case 1: return fps_cluster_kernel<1>;
    case 2: return fps_cluster_kernel<2>;
    case 8: return fps_cluster_kernel<8>;
    case 16: return fps_cluster_kernel<16>;
    default: return nullptr;
  }
}

PrunedKernel pruned_for(int points) {
  return points == kPrunedPoints ? fps_cluster_kernel_pruned<kPrunedPoints>
                                 : nullptr;
}

// Set the kernel's attributes for candidate (c, t, points) and fill the
// launch configuration of b clusters of c CTAs.
template <typename K>
cudaError_t configure(K kernel, int b, int c, int t, int points,
                      cudaStream_t stream, cudaLaunchAttribute* attr,
                      cudaLaunchConfig_t* config) {
  const size_t smem_bytes = sizeof(float4) * static_cast<size_t>(points) * t;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err == cudaSuccess && c > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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

// Launch, with `args`, the kernel that pick(points) gives for the first
// candidate whose b clusters the card places in one wave, else the first
// it places at all (the entries' contract below).
template <typename K, typename... Args>
int launch(K (*pick)(int), int b, int n, bool memory_tier, const int* plans,
           int count, int* used, void* stream, Args... args) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config;
  int fallback = -1;
  for (int i = 0; i < count; ++i) {
    const int c = plans[3 * i], t = plans[3 * i + 1], points = plans[3 * i + 2];
    const K kernel = pick(points);
    if (kernel == nullptr || c < 1 || c > kMaxCluster || t < 32 ||
        t > max_threads(points) || t % 32 != 0 ||
        (points > 0 && static_cast<long long>(c) * t * points < n) ||
        (points == 0 && !memory_tier))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = configure(kernel, b, c, t, points, s, attr, &config);
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
  const int* chosen = plans + 3 * *used;
  const K kernel = pick(chosen[2]);
  cudaError_t err =
      configure(kernel, b, chosen[0], chosen[1], chosen[2], s, attr, &config);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz [B, N, 3] f32, mask [B, N] u8 or null, dist [B, N] f32 scratch (the
// memory tier only; may be null otherwise), idx [B, M] i32. plans: `count`
// candidates (cluster size, threads, points a thread; 0 = memory tier) as
// 3 * count ints, in order of preference. Launches the first that the card
// places as B clusters in one wave, else the first it places at all, on
// `stream`; *used gets its position (-1 if none launched). Returns
// cudaErrorInvalidValue for a malformed candidate,
// cudaErrorInvalidConfiguration if none can be placed, else
// cudaGetLastError().
extern "C" int tpu3dsad_fps(const float* xyz, const uint8_t* mask,
                            float* dist, int* idx, int b, int n, int m,
                            const int* plans, int count, int* used,
                            void* stream) {
  *used = -1;
  if (b <= 0 || n <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  return launch(kernel_for, b, n, dist != nullptr, plans, count, used, stream,
                xyz, mask, dist, idx, n, m);
}

// One cloud of xyz [N, 3] (B2's entry). order null: tpu3dsad_fps at B = 1.
// order [ceil(N / 512) * 512] i32, the pre-pass's slabs (the header): the
// pruned pass, every candidate at 16 points a thread; engaged, a u64 on the
// card or null, gets the warp-rounds that ran their pass.
extern "C" int tpu3dsad_fps_flat(const float* xyz, const uint8_t* mask,
                                 const int* order, float* dist, int* idx,
                                 int n, int m, const int* plans, int count,
                                 int* used, long long* engaged, void* stream) {
  if (order == nullptr)
    return tpu3dsad_fps(xyz, mask, dist, idx, 1, n, m, plans, count, used,
                        stream);
  *used = -1;
  if (n <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  return launch(pruned_for, 1, n, false, plans, count, used, stream, xyz, mask,
                order, idx, n, m,
                reinterpret_cast<unsigned long long*>(engaged));
}

// The most clusters of the pruned pass at plan (c, t, 16) that the card runs
// at once: the occupancy query by which the flat entry chooses a plan
// (cudaOccupancyMaxActiveClusters); -1 on error.
extern "C" int tpu3dsad_fps_flat_clusters(int c, int t) {
  if (c < 1 || c > kMaxCluster || t < 32 || t > max_threads(kPrunedPoints) ||
      t % 32 != 0)
    return -1;
  const PrunedKernel kernel = pruned_for(kPrunedPoints);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config;
  int clusters = -1;
  if (configure(kernel, 1, c, t, kPrunedPoints, nullptr, attr, &config) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&clusters, kernel, &config) !=
          cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return clusters;
}
