"""Detection losses (tpu3dsad/losses.py): vote, objectness, box (center,
heading, size), semantic, and the 3DSAD scale-selection loss.

Lineage weighting: vote L1 to GT (min over the vote copies and the V
candidate owners), objectness CE with the near/far zone and class weights
(0.2, 0.8), squared-distance center chamfer, heading and size cls + reg,
semantic CE, scale-selection CE; the weighted sum times 10. GT is padded to
max_boxes with gt_mask, so every reduction is a masked mean.

Minima are torch.amin, which, like jnp.min, splits the gradient evenly
among tied minima (tied vote candidates are common: unused slots copy the
primary owner).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpu3dsad_torch.ops.boxes import angle_to_bin
from tpu3dsad_torch.ops.plain.knn import pairwise_sqdist

NEAR_THRESHOLD = 0.3
FAR_THRESHOLD = 0.6
OBJECTNESS_CLS_WEIGHTS = (0.2, 0.8)


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def _ce(logits, labels):
    """Per-element softmax cross-entropy with integer labels
    (optax.softmax_cross_entropy_with_integer_labels)."""
    C = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, C), labels.reshape(-1).long(),
                           reduction="none").reshape(labels.shape)


def _take(x, idx, dim):
    """jnp.take_along_axis for an index broadcast over x's trailing axes."""
    idx = idx.long()
    idx = idx.reshape(*idx.shape, *(1,) * (x.dim() - idx.dim()))
    shape = list(x.shape)
    shape[dim] = idx.shape[dim]
    return torch.gather(x, dim, idx.expand(shape))


def huber(x, delta: float = 1.0):
    ax = x.abs()
    return torch.where(ax < delta, 0.5 * ax * ax / delta, ax - 0.5 * delta)


def vote_loss(end_points, batch):
    """L1 between the votes and their GT (seed + offset to its owner's
    center). batch["vote_targets"] is [B,N,3] or [B,N,V,3]."""
    seed_inds = end_points["seed_inds"]  # [B,S] into the input points
    vt = batch["vote_targets"]
    if vt.dim() == 3:
        vt = vt[:, :, None, :]
    gt_offset = _take(vt, seed_inds, 1)  # [B,S,V,3]
    seed_votes_gt = end_points["seed_xyz"][:, :, None, :] + gt_offset
    voting_mask = (_take(batch["vote_mask"], seed_inds, 1)
                   & end_points["seed_mask"])
    B, S = seed_inds.shape
    Fv = end_points["vote_xyz"].shape[1] // S
    votes = end_points["vote_xyz"].reshape(B, S, Fv, 1, 3)
    dist = (votes - seed_votes_gt[:, :, None]).abs().sum(-1)  # [B,S,F,V]
    return _masked_mean(dist.amin((-1, -2)), voting_mask)


def assign_proposals(end_points, batch, near=NEAR_THRESHOLD,
                     far=FAR_THRESHOLD):
    """Nearest-GT assignment of each proposal: (pos [B,P], neg [B,P],
    nearest [B,P] GT index). Comparisons only, so outside the graph."""
    with torch.no_grad():
        d2 = pairwise_sqdist(end_points["proposal_xyz"], batch["gt_centers"])
        d2 = torch.where(batch["gt_mask"][:, None, :], d2, torch.inf)
        nearest = d2.argmin(-1)
        nearest_d = d2.amin(-1).sqrt()
        has_gt = batch["gt_mask"].any(-1, keepdim=True)
        valid = end_points["proposal_mask"] & has_gt
        pos = (nearest_d < near) & valid
        neg = (nearest_d > far) & valid
    return pos, neg, nearest


def objectness_loss(end_points, pos, neg):
    ce = _ce(end_points["objectness_scores"], pos)
    # the target class's weight per element, normalised by the count of
    # supervised proposals (lineage compute_objectness_loss)
    w = (torch.where(pos, OBJECTNESS_CLS_WEIGHTS[1], 0.0)
         + torch.where(neg, OBJECTNESS_CLS_WEIGHTS[0], 0.0))
    sup = (pos | neg).to(ce.dtype)
    return (ce * w).sum() / sup.sum().clamp_min(1.0)


def center_loss(end_points, batch, pos, norm: float = 1.0):
    """Squared-distance chamfer: positives to their nearest GT, plus every
    GT to its nearest valid proposal; distances in units of `norm`."""
    BIG = 1e12  # finite sentinel: inf would NaN the masked means (inf * 0)
    d2 = pairwise_sqdist(end_points["center"], batch["gt_centers"])
    if norm != 1.0:
        d2 = d2 / (norm * norm)
    d2 = torch.where(batch["gt_mask"][:, None, :], d2, BIG)
    p2g = d2.amin(-1)
    fwd = _masked_mean(p2g * (p2g < BIG), pos)
    d2b = torch.where(end_points["proposal_mask"][:, :, None], d2, BIG)
    g2p = d2b.amin(1)
    bwd = _masked_mean(g2p * (g2p < BIG), batch["gt_mask"])
    return fwd + bwd


def box_and_sem_loss(end_points, batch, pos, nearest, mean_sizes,
                     num_heading_bins):
    """Heading / size cls + reg and semantic CE on positive proposals."""
    gt_heading = _take(batch["gt_headings"], nearest, 1).reshape(
        nearest.shape)
    gt_size = _take(batch["gt_sizes"], nearest, 1).reshape(
        *nearest.shape, 3)
    gt_cls = _take(batch["gt_classes"], nearest, 1).reshape(
        nearest.shape).long()

    NH = num_heading_bins
    hbin, hres = angle_to_bin(gt_heading, NH)
    heading_cls = _masked_mean(_ce(end_points["heading_scores"], hbin), pos)
    pred_res_norm = _take(end_points["heading_residuals_normalized"],
                          hbin[..., None], -1)[..., 0]
    heading_reg = _masked_mean(huber(pred_res_norm - hres / (np.pi / NH)),
                               pos)

    # size: template class == semantic class (lineage convention)
    size_cls = _masked_mean(_ce(end_points["size_scores"], gt_cls), pos)
    ms = torch.as_tensor(np.asarray(mean_sizes, np.float32),
                         device=gt_size.device)[gt_cls]
    gt_res_norm = (gt_size - ms) / ms
    pred_sres = _take(end_points["size_residuals_normalized"],
                      gt_cls[..., None], -2)[..., 0, :]
    size_reg = _masked_mean(huber(pred_sres - gt_res_norm).mean(-1), pos)

    sem_cls = _masked_mean(_ce(end_points["sem_cls_scores"], gt_cls), pos)
    return heading_cls, heading_reg, size_cls, size_reg, sem_cls, gt_size


def scale_selection_loss(end_points, pos, gt_size, radius_bank):
    """CE of the scale logits against the bank radius nearest half the GT
    box's mean horizontal extent."""
    bank = torch.as_tensor(radius_bank, dtype=torch.float32,
                           device=gt_size.device)
    target_r = 0.5 * gt_size[..., :2].mean(-1)
    tgt = (target_r[..., None] - bank).abs().argmin(-1)
    return _masked_mean(_ce(end_points["scale_logits"], tgt), pos)


def detection_loss(end_points, batch, mean_sizes, num_heading_bins,
                   radius_bank, near=NEAR_THRESHOLD, far=FAR_THRESHOLD,
                   center_norm: float = 1.0):
    """(total loss, metrics dict of 0-d tensors). An optional
    batch["scene_mask"] [B] removes whole scenes from every term."""
    sm = batch.get("scene_mask")
    if sm is not None:
        batch = dict(batch)
        batch["vote_mask"] = batch["vote_mask"] & sm[:, None]
        batch["gt_mask"] = batch["gt_mask"] & sm[:, None]
    v_loss = vote_loss(end_points, batch)
    pos, neg, nearest = assign_proposals(end_points, batch, near=near,
                                         far=far)
    o_loss = objectness_loss(end_points, pos, neg)
    c_loss = center_loss(end_points, batch, pos, norm=center_norm)
    h_cls, h_reg, s_cls, s_reg, sem, gt_size = box_and_sem_loss(
        end_points, batch, pos, nearest, mean_sizes, num_heading_bins)
    sc_loss = scale_selection_loss(end_points, pos, gt_size, radius_bank)

    box_loss = c_loss + 0.1 * h_cls + h_reg + 0.1 * s_cls + s_reg
    total = (v_loss + 0.5 * o_loss + box_loss + 0.1 * sem
             + 0.1 * sc_loss) * 10.0

    pred_pos = end_points["objectness_scores"].argmax(-1) == 1
    obj_acc = _masked_mean((pred_pos == pos).float(), pos | neg)
    metrics = {
        "loss": total,
        "vote_loss": v_loss,
        "objectness_loss": o_loss,
        "center_loss": c_loss,
        "heading_cls_loss": h_cls,
        "heading_reg_loss": h_reg,
        "size_cls_loss": s_cls,
        "size_reg_loss": s_reg,
        "sem_cls_loss": sem,
        "scale_sel_loss": sc_loss,
        "obj_acc": obj_acc,
        "pos_ratio": pos.float().mean(),
    }
    return total, metrics
