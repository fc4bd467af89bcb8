// Oriented BEV IoU of two sets of boxes, for sm_90a.
//
// Replaces no Pallas kernel: the reference computes the IoU with XLA
// (tpu3dsad/ops/boxes.py:150, oriented_bev_iou, with _clip_edge and
// _shoelace), one fused program. The port's plain version
// (ops/plain/iou.py) is a chain of elementwise torch ops over every pair's
// 8-vertex polygon: about 20 launches a Sutherland-Hodgman step, four
// steps, each compacting its emissions by an int64 cumsum. At oriented
// NMS's shape (8 clouds of 256 boxes: 524,288 pairs) that chain took ~18
// ms a request, bound by memory and launches. Launched by
// oriented_bev_iou (ops/cuda/iou.py) through the custom op
// tpu3dsad_torch::oriented_bev_iou (ops/library.py); its output feeds the
// NMS walk (csrc/nms.cu) as a separate op.
//
// Semantics: the plain chain's arithmetic in the plain chain's order, so
// the two agree bit for bit (the card's torch sums the shoelace's 8 terms
// and the volume's 4 in the tree its reductions use, written out below):
//   subject = a's 4 top corners (x, y), n = 4, in an 8-vertex buffer;
//   for each edge e -> e + 1 of b's top face, one clip step: for every
//     vertex i < min(n, 8), s = vertex i - 1 (for i = 0 vertex n - 1, NaN
//     where n - 1 >= 8), side(p) = d0 r1 - d1 r0 (d = e1 - e0, r = p - e0),
//     inside = side >= 0; emit [the intersection s + t (v - s),
//     t = side_s / (|denom| > 1e-12 ? denom : 1e-12), if inside changes;
//     v, if v is inside], emissions past 8 dropped; n = the emissions;
//   area = 0.5 |shoelace| over the min(n, 8) vertices (a next vertex past
//     the buffer is NaN), inter = area * the z overlap (NaN-propagating
//     min and max, clamped at 0), union = (vol_a + vol_b) - inter,
//     iou = union > 1e-12 ? inter / union : 0.
// Every product, sum and quotient uses the _rn intrinsics, so nvcc cannot
// contract them into FMAs: the chain rounds every operation, and after
// oriented NMS's class shift (x out to ~200 m) one ulp of a shoelace term
// is 1e-3 m^2.
//
// What bounds it: nothing of the card's. 524,288 pairs read 196 KB of
// corners and write 2 MB of IoU (0.6 us at 3.35 TB/s), and almost every
// pair cannot overlap: the class shift puts boxes of different classes a
// scene apart, and the seeded model's proposals seldom meet. So a thread
// takes a pair and first tests whether the two footprints' axis-aligned
// bounds lie strictly apart; if so it writes 0, which is what the clip
// gives there (no vertex left, area 0). Bounds of a footprint with a NaN
// or infinite corner are NaN, so such a pair fails the test and takes the
// clip. Only the pairs left (the diagonal and the few near pairs) clip, in
// registers and local memory, a few hundred operations each.
//
// Layout: one CTA a (cloud, block of kRows rows). It stages its rows' a
// boxes and the cloud's L b boxes in shared memory as structures of
// arrays (the 4 top corners, z min and max, the volume computed as the
// chain's volume() computes it, the footprint's bounds), then walks its
// kRows x L pairs kThreads at a time, neighbouring threads on neighbouring
// columns. K, L <= 1024.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;       // rows of a CTA: 2048 pairs a CTA at L = 256
constexpr int kMaxBoxes = 1024;
// staged fields of a box, each an array over the staged boxes
enum : int {
  kX = 0,     // 4: top-face x, corners 0-3
  kY = 4,     // 4: top-face y
  kZLo = 8,   // z min and max over the 8 corners
  kZHi,
  kVol,       // 0.5 |shoelace of the top face| * (z max - z min)
  kXLo,       // the footprint's axis-aligned bounds; NaN unless finite
  kXHi,
  kYLo,
  kYHi,
  kFields
};

__device__ __forceinline__ float nan_value() { return __int_as_float(0x7fc00000); }

// torch.minimum / torch.maximum / amin / amax: NaN wins
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// the card's torch.sum over a last dim of 4 and of 8 (its warp reduction
// halves the offset: lane i takes lane i + 4, then + 2, then + 1)
__device__ __forceinline__ float tree4(const float* t) {
  return __fadd_rn(__fadd_rn(t[0], t[2]), __fadd_rn(t[1], t[3]));
}
__device__ __forceinline__ float tree8(const float* t) {
  return __fadd_rn(__fadd_rn(__fadd_rn(t[0], t[4]), __fadd_rn(t[2], t[6])),
                   __fadd_rn(__fadd_rn(t[1], t[5]), __fadd_rn(t[3], t[7])));
}

// one box's fields from its [8][3] corners into field-major f (stride n)
__device__ void stage(const float* __restrict__ c, float* f, int n, int i) {
  float x[4], y[4], t[4];
  bool finite = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = c[3 * k];
    y[k] = c[3 * k + 1];
    finite = finite && isfinite(x[k]) && isfinite(y[k]);
    f[(kX + k) * n + i] = x[k];
    f[(kY + k) * n + i] = y[k];
  }
  float zlo = c[2], zhi = c[2];
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    zlo = nan_min(zlo, c[3 * k + 2]);
    zhi = nan_max(zhi, c[3 * k + 2]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int kn = (k + 1) & 3;
    t[k] = __fsub_rn(__fmul_rn(x[k], y[kn]), __fmul_rn(x[kn], y[k]));
  }
  f[kZLo * n + i] = zlo;
  f[kZHi * n + i] = zhi;
  f[kVol * n + i] =
      __fmul_rn(__fmul_rn(0.5f, fabsf(tree4(t))), __fsub_rn(zhi, zlo));
  const float nan = nan_value();
  f[kXLo * n + i] = finite ? fminf(fminf(x[0], x[1]), fminf(x[2], x[3])) : nan;
  f[kXHi * n + i] = finite ? fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])) : nan;
  f[kYLo * n + i] = finite ? fminf(fminf(y[0], y[1]), fminf(y[2], y[3])) : nan;
  f[kYHi * n + i] = finite ? fmaxf(fmaxf(y[0], y[1]), fmaxf(y[2], y[3])) : nan;
}

// d0 r1 - d1 r0 with r = p - a: >= 0 is left of the clip edge, inside
__device__ __forceinline__ float side(float dx, float dy, float ax, float ay,
                                      float px, float py) {
  return __fsub_rn(__fmul_rn(dx, __fsub_rn(py, ay)),
                   __fmul_rn(dy, __fsub_rn(px, ax)));
}

// The chain's IoU of row box r (fields rf, stride nr) and column box c
// (cf, stride nc).
__device__ float clip_iou(const float* rf, int nr, int r, const float* cf,
                          int nc, int c) {
  const float nan = nan_value();
  float px[8], py[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    px[k] = k < 4 ? rf[(kX + k) * nr + r] : 0.0f;
    py[k] = k < 4 ? rf[(kY + k) * nr + r] : 0.0f;
  }
  int n = 4;  // emissions of the last step; may pass 8, as the chain's
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int en = (e + 1) & 3;
    const float ax = cf[(kX + e) * nc + c], ay = cf[(kY + e) * nc + c];
    const float dx = __fsub_rn(cf[(kX + en) * nc + c], ax);
    const float dy = __fsub_rn(cf[(kY + en) * nc + c], ay);
    float qx[8], qy[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) qx[k] = qy[k] = 0.0f;
    int m = 0;
    const int live = min(n, 8);
    for (int i = 0; i < live; ++i) {
      float sx = nan, sy = nan;
      if (i > 0) {
        sx = px[i - 1];
        sy = py[i - 1];
      } else if (n <= 8) {
        sx = px[n - 1];
        sy = py[n - 1];
      }
      const float ex = px[i], ey = py[i];
      const float ss = side(dx, dy, ax, ay, sx, sy);
      const float se = side(dx, dy, ax, ay, ex, ey);
      const bool in_s = ss >= 0.0f, in_e = se >= 0.0f;
      if (in_e != in_s) {
        const float denom = __fsub_rn(ss, se);
        const float t =
            __fdiv_rn(ss, fabsf(denom) > 1e-12f ? denom : 1e-12f);
        if (m < 8) {
          qx[m] = __fadd_rn(sx, __fmul_rn(t, __fsub_rn(ex, sx)));
          qy[m] = __fadd_rn(sy, __fmul_rn(t, __fsub_rn(ey, sy)));
        }
        ++m;
      }
      if (in_e) {
        if (m < 8) {
          qx[m] = ex;
          qy[m] = ey;
        }
        ++m;
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      px[k] = qx[k];
      py[k] = qy[k];
    }
    n = m;
  }

  float t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    t[i] = 0.0f;
    if (i < n) {
      const int nx = i + 1 < n ? i + 1 : 0;
      const float x1 = nx < 8 ? px[nx] : nan, y1 = nx < 8 ? py[nx] : nan;
      t[i] = __fsub_rn(__fmul_rn(px[i], y1), __fmul_rn(x1, py[i]));
    }
  }
  const float area = __fmul_rn(0.5f, fabsf(tree8(t)));
  float h = __fsub_rn(nan_min(rf[kZHi * nr + r], cf[kZHi * nc + c]),
                      nan_max(rf[kZLo * nr + r], cf[kZLo * nc + c]));
  h = (isnan(h) || h >= 0.0f) ? h : 0.0f;
  const float inter = __fmul_rn(area, h);
  const float uni =
      __fsub_rn(__fadd_rn(rf[kVol * nr + r], cf[kVol * nc + c]), inter);
  return uni > 1e-12f ? __fdiv_rn(inter, uni) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    oriented_iou_kernel(const float* __restrict__ ca,
                        const float* __restrict__ cb, float* __restrict__ iou,
                        int k, int l, int tiles) {
  extern __shared__ float smem[];
  float* rf = smem;                  // [kFields][kRows]
  float* cf = smem + kFields * kRows;  // [kFields][l]
  const int cloud = blockIdx.x / tiles;
  const int r0 = (blockIdx.x - cloud * tiles) * kRows;
  const int rows = min(kRows, k - r0);
  const float* a = ca + (static_cast<size_t>(cloud) * k + r0) * 24;
  const float* b = cb + static_cast<size_t>(cloud) * l * 24;
  for (int i = threadIdx.x; i < rows + l; i += kThreads) {
    if (i < rows)
      stage(a + i * 24, rf, kRows, i);
    else
      stage(b + (i - rows) * 24, cf, l, i - rows);
  }
  __syncthreads();

  float* out = iou + (static_cast<size_t>(cloud) * k + r0) * l;
  const int total = rows * l;
  for (int p = threadIdx.x; p < total; p += kThreads) {
    const int r = p / l, c = p - r * l;
    // strictly apart (false for NaN bounds): no vertex survives the clip
    const bool clip = !(rf[kXHi * kRows + r] < cf[kXLo * l + c] ||
                        cf[kXHi * l + c] < rf[kXLo * kRows + r] ||
                        rf[kYHi * kRows + r] < cf[kYLo * l + c] ||
                        cf[kYHi * l + c] < rf[kYLo * kRows + r]);
    out[p] = clip ? clip_iou(rf, kRows, r, cf, l, c) : 0.0f;
  }
}

}  // namespace

// corners_a [B, K, 8, 3] and corners_b [B, L, 8, 3] f32, contiguous; iou
// [B, K, L] f32, written whole. One launch of B ceil(K / 8) CTAs on
// `stream`; returns cudaErrorInvalidValue for K or L above 1024, else the
// attribute's or the launch's error.
extern "C" int tpu3dsad_oriented_iou(const float* ca, const float* cb,
                                     float* iou, int b, int k, int l,
                                     void* stream) {
  if (b <= 0 || k <= 0 || l <= 0) return static_cast<int>(cudaSuccess);
  if (k > kMaxBoxes || l > kMaxBoxes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (k + kRows - 1) / kRows;
  const size_t smem = sizeof(float) * kFields * (kRows + l);
  const cudaError_t err = cudaFuncSetAttribute(
      oriented_iou_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  oriented_iou_kernel<<<b * tiles, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      ca, cb, iou, k, l, tiles);
  return static_cast<int>(cudaGetLastError());
}
