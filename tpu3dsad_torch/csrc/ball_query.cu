// Exact ball query and the sorted tier's Morton codes, for sm_90a.
//
// Replaces the Pallas TPU kernel tpu3dsad/ops/pallas/ball_query.py::_kernel
// (launched by _ball_query_kernel, with its tile skip _tile_skip; entries
// ball_query / query_and_group) through the C entry tpu3dsad_ball_query,
// and serves both of its tiers:
//   * B3, the exact tier: points and centers in the caller's order;
//   * B4, sorted_ball_query (ball_query.py:282): the same scan on Z-order
//     views, given the two sort permutations, with the map back to the
//     caller's indices and center rows done in the scan's epilogue.
// tpu3dsad_morton_codes computes B4's sort keys (_morton_codes and
// _spread_bits of the reference) in one kernel; the sorts themselves stay
// torch.sort, as the reference sorts in XLA outside its kernel.
//
// Semantics, equal to the plain version tpu3dsad_torch/ops/plain/
// ball_query.py (and, for B4, to ops/sorted.py's glue around it): for each
// center, the first K point indices in scan order with fp32
// d2 = (dx*dx + dy*dy) + dz*dz strictly below r2; the remaining slots
// repeat the first hit; an empty ball gives all zeros; cnt = min(hits, K);
// masked points never join a ball. r2 arrives already rounded to fp32 by
// the wrapper, as the reference compares it. Products and sums use the _rn
// intrinsics so nvcc cannot contract them into FMAs (the plain version
// rounds every operation).
//
// What bounds it: the scan. A center whose ball holds fewer than K points
// (most of them at SA1: r = 0.2 in a room-sized cloud) must test every
// point that could be inside, 9 fp32 operations a test. The earlier design
// ran one thread per center, 4 warps a block: 128 blocks at config #3's
// SA1 on 132 SMs, 4 resident warps an SM for a dependent chain of shared
// loads and arithmetic, every center testing every point up to its K-th
// hit. The design:
//
//  * A pre-pass (stage_kernel, one warp per 32-point tile of scan order)
//    copies the points into a scratch buffer as SoA [B, 3, T*32], masked
//    points and pads as NaN (every comparison with NaN is false, so they
//    never join a ball and the scan needs no mask test), and writes each
//    tile's box of its valid points, [B, 6, T] (lo xyz, hi xyz; an empty
//    tile gets lo = +inf, hi = -inf). In the sorted tier it reads point
//    perm[k] for slot k, so the sorted view is never materialised by torch.
//  * A warp per C centers (C = 1, 2, 4, register-blocked), lanes over
//    points. Per 32 tiles (a chunk), lane l tests tile t0 + l's box against
//    each unfinished center, and one ballot per center gives the tiles it
//    may find a hit in. Per tile, lane l tests point t*32 + l. A step takes
//    two tiles: every test, then one __any_sync; only where some lane hit
//    (rare at SA1) do the ballots follow: b = __ballot_sync(d2 < r2), a
//    hit's slot is hits + popc(b & lanes below l), written if below K;
//    hits += popc(b); the first hit is the lowest set bit of the first
//    non-zero ballot. The warp leaves once every center holds K hits: the
//    decision is the same in every lane, so no block barrier is needed,
//    and the result is exact first-K in scan order with no selection pass.
//    Config #3's SA1 runs 4096 warps of 4 centers (was 512 warps of 32
//    threads, one center each).
//  * A chunk runs in one of three forms, chosen from the ballots: dense
//    (every center needs every tile of the union: no mask), sparse (the
//    centers on the union, each test masked by its own ballot: computing a
//    test costs less than a branch around it), or the centers apart, one
//    pass each over its own tiles, where the ballots overlap so little
//    that the union costs more than C passes (config #3's synthetic rooms:
//    a floor block, then one compact block per object, so the centers of a
//    warp need different tiles). Every form gives a center its own tiles
//    in index order.
//  * The box test is exact: skip where sep2 > skip_r2, with
//    sep = max(0, lo - c, c - hi) per axis, sep2 summed in the d2 order,
//    and skip_r2 = r2 * (1 + 1e-3) >= r2 (the reference's slack). Rounded
//    subtraction, square and sum are monotone, so a point of the tile has
//    d2 >= sep2: a skipped tile holds no point with d2 < r2, and hits,
//    slots and first hits are unchanged. A center's NaN coordinate gives
//    sep = 0: such a tile is scanned, never skipped.
//  * Loads: kShared, the block's warps publish their union ballots, the
//    block stages the union of the chunk's tiles in shared memory once,
//    and each warp scans its own tiles from there (two barriers a chunk;
//    the ballots double-buffered by parity): index order, where a block's
//    centers need mostly the same tiles. Or straight from global memory
//    with __ldg, each warp on its own tiles: the Z order of the sorted
//    tier, where they need few and different ones. The plan
//    (ops/cuda/ball_query.py::plan) picks the mode, C and 16 warps a block.
//  * Sorted tier: given perm [B, N] (slot k of the view is point perm[k])
//    and perm_c [B, M] (row j of the view is center perm_c[j]), warp j
//    reads center perm_c[j] and writes its row perm_c[j] of the output
//    with point indices perm[slot]; 0 for an empty ball. That is
//    sorted.map_back's gathers, where and inverse permutation, fused.
//
// Where the time goes: on a cloud with no spatial order (config #5's
// uniform requests) almost nothing skips, and the scan is bound by
// instruction throughput: about 90 instructions a warp a step of 2 tiles
// x 4 centers by count of the source, which the measured time puts at
// roughly half the rate at which the card's schedulers dispatch them. On config #3's rooms and on the Z-order
// views most tiles skip, and a center costs a few ballots and its own
// tiles. The pre-pass and the Morton codes take microseconds; calls that
// take less than ~0.05 ms are bound by the host's launch path (PERF.md).
//
// The pre-pass and the scan are two launches of one C entry; the wrapper
// counts the pair as one ball query.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;                // points a tile: one per lane
constexpr int kChunk = kTile * kTile;    // points of the tiles one ballot covers
constexpr int kMaxWarps = 16;            // warps a block of the scan
constexpr int kStageWarps = 8;           // tiles a block of the pre-pass
constexpr int kMortonThreads = 1024;
// instructions a warp spends on one tile: its loads and address, the test
// of one center (3 sub, 3 mul, 2 add, compare, mask), and its share of a
// step's bit scan, vote and branch: the weights of the scan's choice
// between scanning a chunk's centers together or apart (measured: PERF.md)
constexpr int kLoad = 3;
constexpr int kTest = 10;
constexpr int kStep = 5;

__device__ __forceinline__ float sq_sum(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Whether the tile of box (lo, hi) may hold a point inside the ball around
// (cx, cy, cz): false only where the separation is provably too large.
__device__ __forceinline__ bool may_hit(float cx, float cy, float cz,
                                        const float (&lo)[3],
                                        const float (&hi)[3], float skip_r2) {
  const float sx = fmaxf(0.f, fmaxf(__fsub_rn(lo[0], cx), __fsub_rn(cx, hi[0])));
  const float sy = fmaxf(0.f, fmaxf(__fsub_rn(lo[1], cy), __fsub_rn(cy, hi[1])));
  const float sz = fmaxf(0.f, fmaxf(__fsub_rn(lo[2], cz), __fsub_rn(cz, hi[2])));
  return !(sq_sum(sx, sy, sz) > skip_r2);
}

// One warp per tile of scan order: stage its 32 points (NaN where masked or
// past N) and write its box.
__global__ void __launch_bounds__(kStageWarps * 32)
    stage_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
                 const int64_t* __restrict__ perm, float* __restrict__ pts,
                 float* __restrict__ box, int n, int tiles) {
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kStageWarps + (threadIdx.x >> 5);
  if (tile >= tiles) return;  // the whole warp
  const int b = blockIdx.y;
  const int np = tiles * kTile;
  const int k = tile * kTile + lane;
  float v[3] = {NAN, NAN, NAN};
  if (k < n) {
    const size_t src = static_cast<size_t>(b) * n +
                       (perm ? perm[static_cast<size_t>(b) * n + k] : k);
    if (mask == nullptr || mask[src]) {
      v[0] = xyz[3 * src];
      v[1] = xyz[3 * src + 1];
      v[2] = xyz[3 * src + 2];
    }
  }
  float* out = pts + static_cast<size_t>(b) * 3 * np;
  float* bx = box + static_cast<size_t>(b) * 6 * tiles;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    out[d * np + k] = v[d];
    float lo = fminf(v[d], INFINITY);  // fminf / fmaxf drop a NaN operand
    float hi = fmaxf(v[d], -INFINITY);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
    }
    if (lane == 0) {
      bx[d * tiles + tile] = lo;
      bx[(3 + d) * tiles + tile] = hi;
    }
  }
}

// The scan: warp w of block x serves centers (x * warps + w) * C + i, i < C,
// of cloud blockIdx.y (rows of the sorted view when perm_c is given).
template <int C, bool kShared>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ball_query_kernel(const float* __restrict__ pts,
                      const float* __restrict__ box,
                      const float* __restrict__ centers,
                      const int64_t* __restrict__ perm,
                      const int64_t* __restrict__ perm_c, int* __restrict__ idx,
                      int* __restrict__ cnt, int n, int tiles, int m, int k,
                      float r2, float skip_r2) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int np = tiles * kTile;
  const float* px = pts + static_cast<size_t>(b) * 3 * np;
  const float* bx = box + static_cast<size_t>(b) * 6 * tiles;
  const int64_t* pm = perm ? perm + static_cast<size_t>(b) * n : nullptr;
  const unsigned below = (1u << lane) - 1u;

  // a finished center holds hits >= k; a row past M starts finished
  float cx[C], cy[C], cz[C];
  int hits[C], first[C];
  int64_t row[C];
  const int j0 = (blockIdx.x * (blockDim.x >> 5) + warp) * C;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int j = j0 + i;
    row[i] = -1;
    hits[i] = k;
    first[i] = 0;
    cx[i] = cy[i] = cz[i] = 0.f;
    if (j < m) {
      const size_t s = static_cast<size_t>(b) * m + j;
      row[i] = static_cast<int64_t>(b) * m + (perm_c ? perm_c[s] : j);
      const float* c = centers + row[i] * 3;
      cx[i] = c[0];
      cy[i] = c[1];
      cz[i] = c[2];
      hits[i] = 0;
    }
  }
  auto point_id = [&](int p) {
    return pm ? static_cast<int>(pm[p]) : p;
  };
  auto finished = [&]() {
    bool done = true;
#pragma unroll
    for (int i = 0; i < C; ++i) done = done && hits[i] >= k;
    return done;
  };
  // need[i]: the tiles t0 .. t0 + 31 in which unfinished center i may find
  // a hit (one ballot of box tests each); returns their union
  unsigned need[C];
  auto needed = [&](int t0) {
    const int t = t0 + lane;
    float lo[3] = {0.f, 0.f, 0.f}, hi[3] = {0.f, 0.f, 0.f};
    if (t < tiles) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        lo[d] = __ldg(bx + d * tiles + t);
        hi[d] = __ldg(bx + (3 + d) * tiles + t);
      }
    }
    unsigned any = 0u;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      need[i] = __ballot_sync(kFull, t < tiles && hits[i] < k &&
                                         may_hit(cx[i], cy[i], cz[i], lo, hi,
                                                 skip_r2));
      any |= need[i];
    }
    return any;
  };
  // whether this lane's point p hits center i; a sparse step masks the
  // result with center i's ballot of the point's tile (bit), a dense one
  // (every center needs every tile of the union) needs no mask. Computed
  // in every case: a branch per center costs more than the test.
  auto test = [&](auto dense, int i, unsigned bit, const float (&p)[3]) {
    const bool in = sq_sum(__fsub_rn(cx[i], p[0]), __fsub_rn(cy[i], p[1]),
                           __fsub_rn(cz[i], p[2])) < r2;
    if constexpr (!decltype(dense)::value) return in && (need[i] & bit) != 0u;
    return in;
  };
  // rank and write center i's hits in tile t (in: this lane's point hits)
  auto rank = [&](int i, int t, bool in) {
    const unsigned hit = __ballot_sync(kFull, in);
    if (hit != 0u && hits[i] < k) {
      const int slot = hits[i] + __popc(hit & below);
      if (((hit >> lane) & 1u) && slot < k)
        idx[row[i] * k + slot] = point_id(t * kTile + lane);
      if (hits[i] == 0) first[i] = t * kTile + __ffs(hit) - 1;
      hits[i] += __popc(hit);
      if (hits[i] >= k) need[i] = 0u;  // finished: no further test
    }
  };
  // takes the next two tiles sa < sb of `left` (bits of a chunk; sb = -1
  // where one is left, its point NaN: it hits nothing) and loads this
  // lane's points of both: load(s, p) fills the point of the chunk's tile s
  auto take2 = [&](unsigned& left, auto load, int& sa, int& sb,
                   float (&a)[3], float (&b)[3]) {
    sa = __ffs(left) - 1;
    left &= left - 1u;
    sb = left != 0u ? __ffs(left) - 1 : -1;
    if (sb >= 0) left &= left - 1u;
    load(sa, a);
    b[0] = b[1] = b[2] = NAN;
    if (sb >= 0) load(sb, b);
  };
  // the centers together over the tiles of `left`, two a step: every test
  // of both, one vote for whether any lane hit, and only then the ballots
  // (tile a's before tile b's, so slots stay in scan order). Whether all
  // are finished.
  auto run = [&](auto dense, int t0, unsigned left, auto load) {
    bool fin = false;
    while (left != 0u && !fin) {
      int sa, sb;
      float a[3], b[3];
      take2(left, load, sa, sb, a, b);
      const unsigned bit_a = 1u << sa, bit_b = sb >= 0 ? 1u << sb : 0u;
      bool in_a[C], in_b[C];
      bool some = false;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        in_a[i] = test(dense, i, bit_a, a);
        in_b[i] = test(dense, i, bit_b, b);
        some = some || in_a[i] || in_b[i];
      }
      if (!__any_sync(kFull, some)) continue;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        rank(i, t0 + sa, in_a[i]);
        rank(i, t0 + sb, in_b[i]);
      }
      fin = finished();
    }
    return fin;
  };
  // center i alone over the tiles of its own ballot, two a step
  auto run_one = [&](int i, int t0, unsigned left, auto load) {
    while (left != 0u && hits[i] < k) {
      int sa, sb;
      float a[3], b[3];
      take2(left, load, sa, sb, a, b);
      const bool in_a = test(std::true_type{}, i, 0u, a);
      const bool in_b = test(std::true_type{}, i, 0u, b);
      if (!__any_sync(kFull, in_a || in_b)) continue;
      rank(i, t0 + sa, in_a);
      rank(i, t0 + sb, in_b);
    }
  };
  // one chunk, in the cheapest of three forms by the ballots (the same in
  // every lane): dense where every center's ballot is the union; the
  // centers one by one where their ballots overlap so little that testing
  // each on the union costs more than a pass of its own per center
  // (kLoad + kStep + kTest a tile of each center's ballot, against
  // kLoad + kStep + C * kTest a tile of the union); else sparse, all
  // centers on the union, masked
  auto chunk = [&](int t0, unsigned any, auto load) {
    bool dense = true;
    int own = 0;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      dense = dense && need[i] == any;
      own += __popc(need[i]);
    }
    if (dense) return run(std::true_type{}, t0, any, load);
    if ((kLoad + kStep + kTest) * own <
        (kLoad + kStep + C * kTest) * __popc(any)) {
#pragma unroll
      for (int i = 0; i < C; ++i) run_one(i, t0, need[i], load);
      return finished();
    }
    return run(std::false_type{}, t0, any, load);
  };

  bool done = finished();
  if constexpr (!kShared) {
    for (int t0 = 0; t0 < tiles && !done; t0 += kTile) {
      done = chunk(t0, needed(t0), [&](int s, float (&p)[3]) {
        const int q = (t0 + s) * kTile + lane;
        p[0] = __ldg(px + q);
        p[1] = __ldg(px + np + q);
        p[2] = __ldg(px + 2 * np + q);
      });
    }
  } else {
    __shared__ float sp[3][kChunk];
    __shared__ unsigned ballots[2][kMaxWarps];
    const int warps = blockDim.x >> 5;
    for (int t0 = 0, parity = 0; t0 < tiles; t0 += kTile, parity ^= 1) {
      const unsigned mine = done ? 0u : needed(t0);
      if (lane == 0) ballots[parity][warp] = mine;
      // also the barrier after which the previous tiles may be overwritten
      if (__syncthreads_and(done)) break;
      unsigned any = 0u;
      for (int w = 0; w < warps; ++w) any |= ballots[parity][w];
      if (any == 0u) continue;  // the same in every thread
      for (int e = threadIdx.x; e < kChunk; e += blockDim.x) {
        if ((any >> (e / kTile)) & 1u) {
          const int q = t0 * kTile + e;
          sp[0][e] = __ldg(px + q);
          sp[1][e] = __ldg(px + np + q);
          sp[2][e] = __ldg(px + 2 * np + q);
        }
      }
      __syncthreads();
      if (mine != 0u)
        done = chunk(t0, mine, [&](int s, float (&p)[3]) {
          p[0] = sp[0][s * kTile + lane];
          p[1] = sp[1][s * kTile + lane];
          p[2] = sp[2][s * kTile + lane];
        });
    }
  }

#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (row[i] < 0) continue;
    const int c = min(hits[i], k);
    const int pad = hits[i] > 0 ? point_id(first[i]) : 0;  // 0 if empty
    int* out = idx + row[i] * k;
    for (int s = c + lane; s < k; s += kTile) out[s] = pad;
    if (lane == 0) cnt[row[i]] = c;
  }
}

template <int C, bool kShared>
cudaError_t launch_scan(dim3 grid, int threads, cudaStream_t stream,
                        const float* pts, const float* box,
                        const float* centers, const int64_t* perm,
                        const int64_t* perm_c, int* idx, int* cnt, int n,
                        int tiles, int m, int k, float r2, float skip_r2) {
  ball_query_kernel<C, kShared><<<grid, threads, 0, stream>>>(
      pts, box, centers, perm, perm_c, idx, cnt, n, tiles, m, k, r2, skip_r2);
  return cudaGetLastError();
}

// NaN-propagating min / max: torch.amin / amax semantics.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// int32 in [0, 256): bit i moves to bit 3i.
__device__ __forceinline__ int spread_bits(int v) {
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  return (v | (v << 2)) & 0x09249249;
}

// torch.clamp((p - lo) * inv, 0, 255).to(int32); a NaN stays NaN through
// the clamp, and converts to 0 as torch's cast does on the card.
__device__ __forceinline__ int grid_cell(float p, float lo, float inv) {
  float q = __fmul_rn(__fsub_rn(p, lo), inv);
  q = q < 0.f ? 0.f : (q > 255.f ? 255.f : q);
  return static_cast<int>(q);
}

__device__ __forceinline__ int morton(const float* p, const float* lo,
                                      const float* inv) {
  return spread_bits(grid_cell(p[0], lo[0], inv[0])) |
         (spread_bits(grid_cell(p[1], lo[1], inv[1])) << 1) |
         (spread_bits(grid_cell(p[2], lo[2], inv[2])) << 2);
}

// One block per cloud: the bounding box of its valid points (an invalid
// point counts as 3e38 / -3e38, as in sorted.py's torch.where), the grid
// inv_cell = 256 / clamp_min(mx - mn, 1e-6) by a true division, then the
// codes of its points (1 << 30 where invalid) and of its centers.
__global__ void __launch_bounds__(kMortonThreads)
    morton_kernel(const float* __restrict__ xyz,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ centers, int* __restrict__ codes_x,
                  int* __restrict__ codes_c, int n, int m) {
  __shared__ float part[6][kMortonThreads / 32];
  __shared__ float grid[6];  // lo xyz, inv_cell xyz
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  const uint8_t* valid = mask ? mask + static_cast<size_t>(b) * n : nullptr;
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const bool ok = valid == nullptr || valid[k];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lo[d] = min_nan(lo[d], ok ? p[3 * k + d] : 3e38f);
      hi[d] = max_nan(hi[d], ok ? p[3 * k + d] : -3e38f);
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo[d] = min_nan(lo[d], __shfl_xor_sync(kFull, lo[d], o));
      hi[d] = max_nan(hi[d], __shfl_xor_sync(kFull, hi[d], o));
    }
    if (lane == 0) {
      part[d][warp] = lo[d];
      part[3 + d][warp] = hi[d];
    }
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    const int d = threadIdx.x;
    float mn = part[d][0], mx = part[3 + d][0];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
      mn = min_nan(mn, part[d][w]);
      mx = max_nan(mx, part[3 + d][w]);
    }
    float extent = __fsub_rn(mx, mn);
    extent = extent < 1e-6f ? 1e-6f : extent;  // clamp_min keeps a NaN
    grid[d] = mn;
    grid[3 + d] = __fdiv_rn(256.f, extent);
  }
  __syncthreads();
  const float lo_g[3] = {grid[0], grid[1], grid[2]};
  const float inv[3] = {grid[3], grid[4], grid[5]};
  int* cx = codes_x + static_cast<size_t>(b) * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    cx[k] = valid == nullptr || valid[k] ? morton(p + 3 * k, lo_g, inv)
                                         : (1 << 30);
  const float* c = centers + static_cast<size_t>(b) * m * 3;
  int* cc = codes_c + static_cast<size_t>(b) * m;
  for (int j = threadIdx.x; j < m; j += blockDim.x)
    cc[j] = morton(c + 3 * j, lo_g, inv);
}

}  // namespace

// xyz [B, N, 3] f32, mask [B, N] u8 or null, centers [B, M, 3] f32;
// perm [B, N] and perm_c [B, M] int64, both null (exact tier) or both
// given (sorted tier); scratch: B * (3 * T * 32 + 6 * T) f32, T =
// ceil(N / 32); idx [B, M, K] i32, cnt [B, M] i32; the plan: warps a block
// (1-16), centers a warp (1, 2, 4), shared (0: loads from global memory,
// 1: tiles staged in shared memory). Launches the pre-pass, then the scan,
// on `stream`; returns cudaGetLastError() of the first that fails.
extern "C" int tpu3dsad_ball_query(const float* xyz, const uint8_t* mask,
                                   const float* centers, const int64_t* perm,
                                   const int64_t* perm_c, float* scratch,
                                   int* idx, int* cnt, int b, int n, int m,
                                   int k, float r2, float skip_r2, int warps,
                                   int centers_per_warp, int shared,
                                   void* stream) {
  if (b <= 0 || m <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  if (warps < 1 || warps > kMaxWarps ||
      (centers_per_warp != 1 && centers_per_warp != 2 &&
       centers_per_warp != 4) ||
      (perm == nullptr) != (perm_c == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kTile - 1) / kTile;
  float* pts = scratch;
  float* box = scratch + static_cast<size_t>(b) * 3 * tiles * kTile;
  if (tiles > 0) {
    stage_kernel<<<dim3((tiles + kStageWarps - 1) / kStageWarps, b),
                   kStageWarps * 32, 0, s>>>(xyz, mask, perm, pts, box, n,
                                             tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rows = (m + centers_per_warp - 1) / centers_per_warp;
  const dim3 grid((rows + warps - 1) / warps, b);
  const int threads = warps * 32;
  auto scan = shared ? (centers_per_warp == 1   ? launch_scan<1, true>
                        : centers_per_warp == 2 ? launch_scan<2, true>
                                                : launch_scan<4, true>)
                     : (centers_per_warp == 1   ? launch_scan<1, false>
                        : centers_per_warp == 2 ? launch_scan<2, false>
                                                : launch_scan<4, false>);
  return static_cast<int>(scan(grid, threads, s, pts, box, centers, perm,
                               perm_c, idx, cnt, n, tiles, m, k, r2, skip_r2));
}

// xyz [B, N, 3] f32, mask [B, N] u8 or null, centers [B, M, 3] f32 ->
// codes_x [B, N] i32, codes_c [B, M] i32: the sorted tier's Z-order keys,
// one block per cloud, on `stream`; returns cudaGetLastError().
extern "C" int tpu3dsad_morton_codes(const float* xyz, const uint8_t* mask,
                                     const float* centers, int* codes_x,
                                     int* codes_c, int b, int n, int m,
                                     void* stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  morton_kernel<<<b, kMortonThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, mask, centers, codes_x, codes_c, n, m);
  return static_cast<int>(cudaGetLastError());
}
