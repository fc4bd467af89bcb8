// Row scatter-add, the backward of gather/group, for sm_90a.
//
// Replaces the Pallas TPU kernels
// tpu3dsad/ops/pallas/scatter.py::_kernel_c_lanes / _kernel_n_lanes
// (launched by scatter_rows; wired in by ops/xla/group.py::_scatter_rows).
// Semantics, equal to the plain version tpu3dsad_torch/ops/plain/scatter.py:
//   out[b, n, c] = sum over u of [idx[b, u] == n] * g[b, u, c], in fp32;
//   rows with idx < 0 or idx >= n add nothing.
// The wrapper zeroes `out` (torch.zeros); the kernel only adds into it.
//
// The TPU kernel built one-hot tiles in VMEM and summed them on the matrix
// unit, with a manual three-way bf16 split of g and two lane layouts (C on
// lanes for C >= 48, n on lanes below): all of that works around a machine
// with no scattered stores. Hopper has fp32 atomics in L2, so this is the
// lineage's form: one thread per (u, c), c fastest, so a warp reads 32
// neighbouring floats of g and adds them into one row of out.
//
// What bounds it: bytes. g is read once, idx once (a row's index is
// shared by its C threads through L1) and out written once; the adds are
// one per element of g. The largest launch of a config-#3 training step,
// the SA2 group backward, moves 8 x 32768 x 131 x 4 B = 137 MB of g, about
// 41 us at 3.35 TB/s.
//
// Collisions: ball-query pad slots repeat a group's first hit, so a group
// with few hits sends up to K-1 extra atomics to one address, and a point
// that many groups share takes one atomic per group. Atomics to one
// address serialise in L2. Pre-aggregating equal indices inside a warp
// before the atomic is left for later; so is any use of the order of the
// adds, which is free (the sums are not bitwise reproducible run to run).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(const float* __restrict__ g,
                        const int* __restrict__ idx, float* __restrict__ out,
                        long long total, int u, int c, int n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const long long row = i / c;  // b * u + u_i
    const int j = idx[row];
    if (j < 0 || j >= n) continue;
    const long long b = row / u;
    const long long ch = i - row * c;
    atomicAdd(out + (b * n + j) * c + ch, g[i]);
  }
}

}  // namespace

// g [B, U, C] f32, idx [B, U] i32, out [B, n, C] f32 zeroed by the caller.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int tpu3dsad_scatter_rows(const float* g, const int* idx,
                                     float* out, int b, int u, int c, int n,
                                     void* stream) {
  if (b <= 0 || u <= 0 || c <= 0 || n <= 0)
    return static_cast<int>(cudaSuccess);
  const long long total = static_cast<long long>(b) * u * c;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // grid-stride beyond
  scatter_rows_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(g, idx, out,
                                                             total, u, c, n);
  return static_cast<int>(cudaGetLastError());
}
