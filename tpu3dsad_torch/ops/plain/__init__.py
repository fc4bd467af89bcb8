"""Plain PyTorch versions of the point ops.

They run on any device. The ops API sends CPU tensors here; for CUDA
tensors FPS, ball query and the row scatter-add go to their hand-written
kernels unless the caller asks for the plain versions by name
(`ops.use_impl("plain")`).
"""

from tpu3dsad_torch.ops.plain.ball_query import ball_query
from tpu3dsad_torch.ops.plain.fps import furthest_point_sample
from tpu3dsad_torch.ops.plain.group import gather, group_epilogue
from tpu3dsad_torch.ops.plain.interpolate import interp_weights
from tpu3dsad_torch.ops.plain.knn import three_nn
from tpu3dsad_torch.ops.plain.scatter import scatter_rows

__all__ = [
    "ball_query",
    "furthest_point_sample",
    "gather",
    "group_epilogue",
    "interp_weights",
    "scatter_rows",
    "three_nn",
]
