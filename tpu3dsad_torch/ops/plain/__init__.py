"""Plain PyTorch versions of the point ops.

They run on any device. The ops API sends CPU tensors here; for CUDA
tensors FPS, feature FPS, ball query, the row scatter-add, the NMS walk,
the oriented BEV IoU, eval-mode BatchNorm + ReLU and the box point count
go to their hand-written kernels unless the caller asks for the plain
versions by name (`ops.use_impl("plain")`).
"""

from tpu3dsad_torch.ops.plain.ball_query import ball_query
from tpu3dsad_torch.ops.plain.box_points import box_points
from tpu3dsad_torch.ops.plain.ffps import feature_fps
from tpu3dsad_torch.ops.plain.fps import furthest_point_sample
from tpu3dsad_torch.ops.plain.group import gather, group_epilogue
from tpu3dsad_torch.ops.plain.interpolate import interp_weights
from tpu3dsad_torch.ops.plain.iou import oriented_bev_iou
from tpu3dsad_torch.ops.plain.knn import three_nn
from tpu3dsad_torch.ops.plain.nms import greedy_suppress
from tpu3dsad_torch.ops.plain.norm import bn_relu
from tpu3dsad_torch.ops.plain.scatter import scatter_rows

__all__ = [
    "ball_query",
    "bn_relu",
    "box_points",
    "feature_fps",
    "furthest_point_sample",
    "gather",
    "greedy_suppress",
    "group_epilogue",
    "interp_weights",
    "oriented_bev_iou",
    "scatter_rows",
    "three_nn",
]
