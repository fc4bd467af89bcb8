"""Hand-written CUDA kernels for Hopper (sources in tpu3dsad_torch/csrc).

Importing this package builds nothing: nvcc runs at the first launch
(`build.library()`). Each wrapper takes CUDA tensors only and raises on
anything else; each counts its launches in its module's `launches`.
"""

from tpu3dsad_torch.ops.cuda import ball_query, build, fps, scatter

__all__ = ["ball_query", "build", "fps", "scatter"]
