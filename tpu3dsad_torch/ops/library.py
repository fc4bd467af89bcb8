"""FPS, feature FPS, ball query, the sorted tier's Morton codes, the NMS
walk, the oriented BEV IoU and eval-mode BatchNorm + ReLU as PyTorch
custom operators (torch.library), so that an eager call and a program
exported by torch.export run the same functions:

  * tpu3dsad_torch::fps(xyz, npoint, mask?) -> idx int32 [B, npoint]: B1,
    and B2 for one cloud of more than cuda.fps.FLAT_MIN_N points;
  * tpu3dsad_torch::ffps(points, npoint, mask?) -> idx int32 [B, npoint]:
    3DSSD's feature-space FPS over [B, N, D] vectors (csrc/ffps.cu);
  * tpu3dsad_torch::ball_query(xyz, centers, radius, nsample, mask?,
    perm?, perm_c?) -> (idx int32 [B, M, K], cnt int32 [B, M]): B3, and,
    given the two Z-order permutations, the sorted tier's scan (B4);
  * tpu3dsad_torch::morton_codes(xyz, centers, mask?) -> (codes_x int32
    [B, N], codes_c int32 [B, M]): the sorted tier's keys;
  * tpu3dsad_torch::greedy_suppress(iou, scores, valid, iou_thresh) ->
    keep bool [B, K]: the greedy NMS walk over a [B, K, K] IoU matrix
    (csrc/nms.cu), for every NMS flavour of ops/nms.py;
  * tpu3dsad_torch::oriented_bev_iou(corners_a, corners_b) -> iou
    [B, K, L]: the oriented BEV IoU of [B, K, 8, 3] and [B, L, 8, 3] box
    corners (csrc/iou.cu), which oriented NMS hands to the walk;
  * tpu3dsad_torch::bn_relu(x, mean, var, weight, bias, eps) -> y
    [..., C]: eval-mode BatchNorm and ReLU of every MLP layer
    (csrc/bn_relu.cu; nn/norm.py calls it where no gradient is recorded);
  * tpu3dsad_torch::box_points(points, centers, sizes, mask?) -> counts
    int32 [B, P]: the valid points inside each axis-aligned box
    (csrc/box_points.cu), the Group-Free parse's non-empty filter.

Each op has one implementation that dispatches as the ops API does
(ops._use_kernel): on a CUDA tensor it launches the kernel through its
wrapper in ops/cuda, which counts the launch (a ball query given
permutations also counts one sorted call, ops.sorted.launches), and on a
CPU tensor, or inside ops.use_impl("plain"), it runs the plain version.
So a kernel's launches count alike in an eager program and in a loaded
one. Its fake version checks the arguments and gives the output shapes,
so torch.export traces each call as one node. A program that holds these
nodes finds them only once this module is imported (import
tpu3dsad_torch.ops).

The ops have no autograd formula: their outputs are integers or bools,
or the IoU that NMS walks, and nothing differentiates through them (the
ops API and ops/nms.py detach the inputs of the others); MaskedBatchNorm
calls bn_relu only where no gradient is recorded.
"""

from typing import Optional

import torch
from torch import Tensor

from tpu3dsad_torch.ops import plain as _plain
from tpu3dsad_torch.ops import sorted as _sorted
from tpu3dsad_torch.ops.args import (
    check_ball_query,
    check_bn_relu,
    check_box_points,
    check_ffps,
    check_fps,
    check_iou,
    check_nms,
)
from tpu3dsad_torch.ops.cuda import ball_query as _cuda_bq
from tpu3dsad_torch.ops.cuda import bn_relu as _cuda_bn_relu
from tpu3dsad_torch.ops.cuda import box_points as _cuda_box_points
from tpu3dsad_torch.ops.cuda import ffps as _cuda_ffps
from tpu3dsad_torch.ops.cuda import fps as _cuda_fps
from tpu3dsad_torch.ops.cuda import iou as _cuda_iou
from tpu3dsad_torch.ops.cuda import nms as _cuda_nms


def _kernel(t: Tensor) -> bool:
    from tpu3dsad_torch import ops  # the device dispatch and use_impl

    return ops._use_kernel(t)


@torch.library.custom_op("tpu3dsad_torch::fps", mutates_args=())
def fps(xyz: Tensor, npoint: int, mask: Optional[Tensor] = None) -> Tensor:
    if _kernel(xyz):
        return _cuda_fps.furthest_point_sample(xyz, npoint, mask=mask)
    return _plain.furthest_point_sample(xyz, npoint, mask=mask)


@fps.register_fake
def _(xyz, npoint, mask=None):
    check_fps(xyz, npoint, mask)
    return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int32)


@torch.library.custom_op("tpu3dsad_torch::ffps", mutates_args=())
def ffps(points: Tensor, npoint: int, mask: Optional[Tensor] = None) -> Tensor:
    if _kernel(points):
        return _cuda_ffps.feature_fps(points, npoint, mask=mask)
    return _plain.feature_fps(points, npoint, mask=mask)


@ffps.register_fake
def _(points, npoint, mask=None):
    check_ffps(points, npoint, mask)
    return points.new_empty((points.shape[0], npoint), dtype=torch.int32)


@torch.library.custom_op("tpu3dsad_torch::ball_query", mutates_args=())
def ball_query(xyz: Tensor, centers: Tensor, radius: float, nsample: int,
               mask: Optional[Tensor] = None, perm: Optional[Tensor] = None,
               perm_c: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
    if (perm is None) != (perm_c is None):
        raise ValueError("perm and perm_c go together")
    if _kernel(xyz):
        if perm is None:
            return _cuda_bq.ball_query(xyz, centers, radius, nsample,
                                       mask=mask)
        out = _cuda_bq.ball_query(xyz, centers, radius, nsample, mask,
                                  perm=perm, perm_c=perm_c)
        _sorted.launches += 1
        return out
    if perm is None:
        return _plain.ball_query(xyz, centers, radius, nsample, mask=mask)
    return _sorted.permuted_ball_query(xyz, centers, radius, nsample, mask,
                                       perm, perm_c)


@ball_query.register_fake
def _(xyz, centers, radius, nsample, mask=None, perm=None, perm_c=None):
    check_ball_query(xyz, centers, nsample, mask)
    B, M = centers.shape[:2]
    return (xyz.new_empty((B, M, nsample), dtype=torch.int32),
            xyz.new_empty((B, M), dtype=torch.int32))


@torch.library.custom_op("tpu3dsad_torch::morton_codes", mutates_args=())
def morton_codes(xyz: Tensor, centers: Tensor,
                 mask: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
    if _kernel(xyz):
        return _cuda_bq.morton_codes(xyz, centers, mask)
    return _sorted.z_keys(xyz, centers, mask)


@morton_codes.register_fake
def _(xyz, centers, mask=None):
    check_ball_query(xyz, centers, 1, mask)
    return (xyz.new_empty(xyz.shape[:2], dtype=torch.int32),
            xyz.new_empty(centers.shape[:2], dtype=torch.int32))


@torch.library.custom_op("tpu3dsad_torch::greedy_suppress", mutates_args=())
def greedy_suppress(iou: Tensor, scores: Tensor, valid: Tensor,
                    iou_thresh: float) -> Tensor:
    if _kernel(iou):
        return _cuda_nms.greedy_suppress(iou, scores, valid, iou_thresh)
    return _plain.greedy_suppress(iou, scores, valid, iou_thresh)


@greedy_suppress.register_fake
def _(iou, scores, valid, iou_thresh):
    check_nms(iou, scores, valid)
    return scores.new_empty(scores.shape, dtype=torch.bool)


@torch.library.custom_op("tpu3dsad_torch::oriented_bev_iou", mutates_args=())
def oriented_bev_iou(corners_a: Tensor, corners_b: Tensor) -> Tensor:
    if _kernel(corners_a):
        return _cuda_iou.oriented_bev_iou(corners_a, corners_b)
    check_iou(corners_a, corners_b)
    return _plain.oriented_bev_iou(corners_a, corners_b)


@oriented_bev_iou.register_fake
def _(corners_a, corners_b):
    check_iou(corners_a, corners_b)
    return corners_a.new_empty(corners_a.shape[:2] + corners_b.shape[1:2])


@torch.library.custom_op("tpu3dsad_torch::bn_relu", mutates_args=())
def bn_relu(x: Tensor, mean: Tensor, var: Tensor, weight: Tensor,
            bias: Tensor, eps: float) -> Tensor:
    if _kernel(x):
        return _cuda_bn_relu.bn_relu(x, mean, var, weight, bias, eps)
    return _plain.bn_relu(x, mean, var, weight, bias, eps)


@bn_relu.register_fake
def _(x, mean, var, weight, bias, eps):
    check_bn_relu(x, mean, var, weight, bias)
    dtype = x.dtype
    for v in (mean, var, weight, bias):
        dtype = torch.promote_types(dtype, v.dtype)
    return x.new_empty(x.shape, dtype=dtype)


@torch.library.custom_op("tpu3dsad_torch::box_points", mutates_args=())
def box_points(points: Tensor, centers: Tensor, sizes: Tensor,
               mask: Optional[Tensor] = None) -> Tensor:
    if _kernel(points):
        return _cuda_box_points.box_points(points, centers, sizes, mask)
    return _plain.box_points(points, centers, sizes, mask)


@box_points.register_fake
def _(points, centers, sizes, mask=None):
    check_box_points(points, centers, sizes, mask)
    return points.new_empty(centers.shape[:2], dtype=torch.int32)
