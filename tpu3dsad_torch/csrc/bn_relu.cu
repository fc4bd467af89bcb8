// Eval-mode BatchNorm followed by ReLU over [rows, C] fp32, for sm_90a.
//
// Replaces no Pallas kernel: the reference leaves BatchNorm and ReLU to
// XLA, which fuses them into the producer's epilogue. The port ran them as
// torch's chain (nn/norm.py, then torch.relu): four broadcast passes over
// the activation, x - mean, * rsqrt(var + eps), * weight, + bias, each a
// non-vectorised elementwise kernel because the [C] operand has stride 0,
// then the ReLU pass, and two launches on the [C] vectors: 7 launches and
// 5 reads and writes of every activation a layer. Launched by bn_relu
// (ops/cuda/bn_relu.py) through the custom op tpu3dsad_torch::bn_relu
// (ops/library.py), in eval mode with no gradient recorded.
//
// Semantics: the chain's arithmetic in the chain's order, so the two agree
// bit for bit. Per channel c, inv = rsqrtf(var[c] + eps) (torch's rsqrt
// kernel calls the same function; eps is the Python float rounded to fp32,
// as torch rounds a scalar operand); per element
//   y = ((x - mean) * inv) * weight + bias,
// every operation rounded on its own (_rn intrinsics, so nvcc cannot
// contract a product and a sum into an FMA), then torch's clamp_min(y, 0):
// NaN passes as it is, otherwise fmaxf(y, 0).
//
// What bounds it: memory. An activation is read once and written once (8
// bytes an element; the chain moved 40); the per-channel vectors are read
// once a thread. At the served shapes (~2 G elements a request) that is
// ~16 GB, ~5 ms at 3.35 TB/s.
//
// Layout: rows of C floats, C / V vector columns (V = 4, a float4, where C
// % 4 == 0 and both x and y are 16-byte aligned; else V = 1). A CTA has
// tpr = min(columns, kThreads) threads across a row and rpp = kThreads /
// tpr rows a pass; its y index picks the block of tpr columns (C past
// 4 * kThreads takes more than one). Each thread keeps its V channels'
// mean, inv, weight and bias in registers and strides down the rows, four
// rows' loads issued before their stores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxBlocksX = 4096;

template <int V> struct Vec;
template <> struct Vec<1> { using type = float; };
template <> struct Vec<4> { using type = float4; };

__device__ __forceinline__ float& at(float& v, int) { return v; }
__device__ __forceinline__ float& at(float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// torch's clamp_min(v, 0) on the card: NaN passes, else max(v, 0)
__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

template <int V>
__global__ void __launch_bounds__(kThreads, 4)
bn_relu_kernel(const float* __restrict__ x, const float* __restrict__ mean,
               const float* __restrict__ var,
               const float* __restrict__ weight,
               const float* __restrict__ bias, float eps,
               float* __restrict__ y, long long rows, int cols, int tpr,
               int rpp) {
  using T = typename Vec<V>::type;
  const int col = blockIdx.y * tpr + threadIdx.x % tpr;
  if (col >= cols) return;
  float m[V], inv[V], w[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = col * V + k;
    m[k] = mean[c];
    inv[k] = rsqrtf(__fadd_rn(var[c], eps));
    w[k] = weight[c];
    b[k] = bias[c];
  }
  const T* xv = reinterpret_cast<const T*>(x);
  T* yv = reinterpret_cast<T*>(y);
  const long long stride = static_cast<long long>(gridDim.x) * rpp;
  long long r = static_cast<long long>(blockIdx.x) * rpp + threadIdx.x / tpr;

  auto apply = [&](T v) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float t = __fmul_rn(__fsub_rn(at(v, k), m[k]), inv[k]);
      at(v, k) = relu(__fadd_rn(__fmul_rn(t, w[k]), b[k]));
    }
    return v;
  };

  for (; r + (kUnroll - 1) * stride < rows; r += kUnroll * stride) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = xv[(r + u * stride) * cols + col];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      yv[(r + u * stride) * cols + col] = apply(v[u]);
  }
  for (; r < rows; r += stride) yv[r * cols + col] = apply(xv[r * cols + col]);
}

template <int V>
cudaError_t launch(const float* x, const float* mean, const float* var,
                   const float* weight, const float* bias, float eps,
                   float* y, long long rows, int c, cudaStream_t stream) {
  const int cols = c / V;
  const int tpr = cols < kThreads ? cols : kThreads;
  const int rpp = kThreads / tpr;
  const int col_blocks = (cols + tpr - 1) / tpr;
  if (col_blocks > 65535) return cudaErrorInvalidValue;
  const long long passes = (rows + rpp - 1) / rpp;
  const dim3 grid(static_cast<unsigned>(
                      passes < kMaxBlocksX ? passes : kMaxBlocksX),
                  col_blocks);
  bn_relu_kernel<V><<<grid, tpr * rpp, 0, stream>>>(
      x, mean, var, weight, bias, eps, y, rows, cols, tpr, rpp);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// y[r, c] = relu(((x[r, c] - mean[c]) * rsqrt(var[c] + eps)) * weight[c]
// + bias[c]) over rows x c contiguous floats; y must not overlap x. The
// four vectors are [c] contiguous floats. Nothing is launched for no rows
// or no channels.
extern "C" int tpu3dsad_bn_relu(const float* x, const float* mean,
                                const float* var, const float* weight,
                                const float* bias, float eps, float* y,
                                long long rows, int c, void* stream) {
  if (rows <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      (c % 4 == 0 && aligned16(x) && aligned16(y))
          ? launch<4>(x, mean, var, weight, bias, eps, y, rows, c, s)
          : launch<1>(x, mean, var, weight, bias, eps, y, rows, c, s);
  return static_cast<int>(err);
}
