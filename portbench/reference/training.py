"""The plain reference of the detector's train step: the augmentation on
the card, the forward in train mode, the detection loss, the backward and
Adam, in plain PyTorch (no import of the program or of JAX).

The loss is VoteNet's (Qi et al. 2019) with the size-adaptive detector's
scale-selection term, as the program states it: vote L1 (min over the
candidate owners), objectness CE over the near / far zone with class
weights (0.2, 0.8), the squared-distance center chamfer, heading and size
classification and regression, semantic CE, scale-selection CE; the
weighted sum times 10. Adam as optax writes it: bias-corrected moments,
eps outside the root, the learning rate of the schedule's first epochs.

The augmentation draws from a torch.Generator of the seed the benchmark
gives both sides, in the program's order (flip x, flip y, angle, scale), so
both sides augment alike.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import detector as ref

AUG_PRESETS = {
    "scannet": dict(flip_x=True, flip_y=True, rot_range=np.pi / 36,
                    scale_range=None),
    "sunrgbd": dict(flip_x=True, flip_y=False, rot_range=np.pi / 6,
                    scale_range=(0.85, 1.15)),
}
OBJ_WEIGHTS = (0.2, 0.8)


def _mod(x, y: float):
    """x mod y with the sign of y (the exact fmod, plus y where the signs
    differ)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def augment(batch: dict, generator, flip_x, flip_y, rot_range,
            scale_range) -> dict:
    B = batch["points"].shape[0]
    dev = batch["points"].device

    def coin():
        return torch.rand(B, generator=generator, device=dev) < 0.5

    fx = coin() if flip_x else None
    fy = coin() if flip_y else None
    angle = (torch.rand(B, generator=generator, device=dev)
             * (2 * rot_range) - rot_range)
    scale = None
    if scale_range is not None:
        lo, hi = scale_range
        scale = torch.rand(B, generator=generator, device=dev) * (hi - lo) + lo

    pts, votes, centers = (batch["points"], batch["vote_targets"],
                           batch["gt_centers"])
    headings, sizes = batch["gt_headings"], batch["gt_sizes"]
    for ax, do in ((0, fx), (1, fy)):
        if do is None:
            continue
        sign = torch.as_tensor(np.where(np.arange(3) == ax, -1.0, 1.0),
                               dtype=torch.float32, device=dev)

        def flip(v):
            return torch.where(do.reshape((-1,) + (1,) * (v.dim() - 1)),
                               v * sign, v)

        pts, votes, centers = flip(pts), flip(votes), flip(centers)
        headings = torch.where(do[:, None],
                               (np.pi - headings) if ax == 0 else -headings,
                               headings)
    c, s = torch.cos(angle), torch.sin(angle)

    def rot(v):
        shape = (-1,) + (1,) * (v.dim() - 2)
        cc, ss = c.reshape(shape), s.reshape(shape)
        x, y = v[..., 0], v[..., 1]
        return torch.stack([cc * x - ss * y, ss * x + cc * y, v[..., 2]], -1)

    pts, votes, centers = rot(pts), rot(votes), rot(centers)
    headings = headings + angle[:, None]
    if scale is not None:
        def scaled(v):
            return v * scale.reshape((-1,) + (1,) * (v.dim() - 1))
        pts, votes, centers, sizes = map(scaled, (pts, votes, centers, sizes))
    out = dict(batch)
    out.update(points=pts, vote_targets=votes, gt_centers=centers,
               gt_headings=_mod(headings + np.pi, 2 * np.pi) - np.pi,
               gt_sizes=sizes)
    return out


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def _ce(logits, labels):
    C = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, C), labels.reshape(-1).long(),
                           reduction="none").reshape(labels.shape)


def _take(x, idx, dim):
    idx = idx.long()
    idx = idx.reshape(*idx.shape, *(1,) * (x.dim() - idx.dim()))
    shape = list(x.shape)
    shape[dim] = idx.shape[dim]
    return torch.gather(x, dim, idx.expand(shape))


def _huber(x, delta: float = 1.0):
    ax = x.abs()
    return torch.where(ax < delta, 0.5 * ax * ax / delta, ax - 0.5 * delta)


def detection_loss(ep, batch, mean_sizes, cfg: dict):
    """The total loss (module docstring) of one batch's end points."""
    # votes: min over the candidate owners
    seed_inds = ep["seed_inds"]
    vt = batch["vote_targets"]
    if vt.dim() == 3:
        vt = vt[:, :, None, :]
    gt = ep["seed_xyz"][:, :, None, :] + _take(vt, seed_inds, 1)
    vmask = _take(batch["vote_mask"], seed_inds, 1) & ep["seed_mask"]
    B, S = seed_inds.shape
    votes = ep["vote_xyz"].reshape(B, S, 1, 1, 3)
    dist = (votes - gt[:, :, None]).abs().sum(-1)
    v_loss = _masked_mean(dist.amin((-1, -2)), vmask)

    # nearest-GT assignment
    with torch.no_grad():
        d2 = ref.sqdist(ep["proposal_xyz"], batch["gt_centers"])
        d2 = torch.where(batch["gt_mask"][:, None, :], d2, torch.inf)
        nearest = d2.argmin(-1)
        nearest_d = d2.amin(-1).sqrt()
        valid = ep["proposal_mask"] & batch["gt_mask"].any(-1, keepdim=True)
        pos = (nearest_d < cfg["assign_near"]) & valid
        neg = (nearest_d > cfg["assign_far"]) & valid

    ce = _ce(ep["objectness_scores"], pos)
    w = (torch.where(pos, OBJ_WEIGHTS[1], 0.0)
         + torch.where(neg, OBJ_WEIGHTS[0], 0.0))
    o_loss = (ce * w).sum() / (pos | neg).to(ce.dtype).sum().clamp_min(1.0)

    big = 1e12
    d2 = ref.sqdist(ep["center"], batch["gt_centers"])
    norm = cfg["center_loss_norm"]
    if norm != 1.0:
        d2 = d2 / (norm * norm)
    d2 = torch.where(batch["gt_mask"][:, None, :], d2, big)
    p2g = d2.amin(-1)
    d2b = torch.where(ep["proposal_mask"][:, :, None], d2, big)
    g2p = d2b.amin(1)
    c_loss = (_masked_mean(p2g * (p2g < big), pos)
              + _masked_mean(g2p * (g2p < big), batch["gt_mask"]))

    NH = cfg["num_heading_bins"]
    gt_heading = _take(batch["gt_headings"], nearest, 1).reshape(
        nearest.shape)
    gt_size = _take(batch["gt_sizes"], nearest, 1).reshape(*nearest.shape, 3)
    gt_cls = _take(batch["gt_classes"], nearest, 1).reshape(
        nearest.shape).long()
    two_pi = 2.0 * np.pi
    width = two_pi / NH
    shifted = _mod(_mod(gt_heading, two_pi) + width / 2.0, two_pi)
    hbin = torch.floor(shifted / width).int()
    hres = shifted - (hbin.float() * width + width / 2.0)
    h_cls = _masked_mean(_ce(ep["heading_scores"], hbin), pos)
    pred_res = _take(ep["heading_residuals_normalized"], hbin[..., None],
                     -1)[..., 0]
    h_reg = _masked_mean(_huber(pred_res - hres / (np.pi / NH)), pos)
    s_cls = _masked_mean(_ce(ep["size_scores"], gt_cls), pos)
    ms = torch.as_tensor(mean_sizes, dtype=torch.float32,
                         device=gt_size.device)[gt_cls]
    pred_sres = _take(ep["size_residuals_normalized"], gt_cls[..., None],
                      -2)[..., 0, :]
    s_reg = _masked_mean(_huber(pred_sres - (gt_size - ms) / ms).mean(-1),
                         pos)
    sem = _masked_mean(_ce(ep["sem_cls_scores"], gt_cls), pos)

    bank = torch.as_tensor(cfg["cluster_radius_bank"], dtype=torch.float32,
                           device=gt_size.device)
    tgt = (0.5 * gt_size[..., :2].mean(-1)[..., None] - bank).abs().argmin(-1)
    sc_loss = _masked_mean(_ce(ep["scale_logits"], tgt), pos)

    box = c_loss + 0.1 * h_cls + h_reg + 0.1 * s_cls + s_reg
    return (v_loss + 0.5 * o_loss + box + 0.1 * sem + 0.1 * sc_loss) * 10.0


class Adam:
    """optax.adam on a list of leaves, at a constant learning rate."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: list, lr: float):
        self.params = params
        self.lr = torch.tensor(lr, dtype=torch.float32,
                               device=params[0].device)
        self.count = torch.zeros((), dtype=torch.int64,
                                 device=params[0].device)
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: list) -> None:
        self.count += 1
        t = self.count.float()
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(self.B1).add_(g, alpha=1 - self.B1)
            nu.mul_(self.B2).addcmul_(g, g, value=1 - self.B2)
            update = mu / (1 - self.B1 ** t)
            denom = (nu / (1 - self.B2 ** t)).sqrt_().add_(self.EPS)
            p.add_(update.div_(denom).mul_(-self.lr))


def follow(params: dict, cfg: dict, mean_sizes, batches: list, generator,
           matmul: str, half_batch: bool = False) -> dict:
    """Run the train step from `params` over `batches` (one dict a step,
    on the device). Returns {"loss": [steps] floats, "grad1": {leaf: the
    first step's gradient norm}, "change": {leaf: the norm of the change
    after the last step}}. half_batch takes every loss over the first half
    of each batch (a fault the comparison must catch)."""
    names = [n for n, v in params.items() if v.is_floating_point()
             and not n.endswith(("running_mean", "running_var"))]
    leaves = {n: params[n].detach().clone().requires_grad_(True)
              for n in names}
    start = {n: params[n].detach().clone() for n in names}
    opt = Adam([leaves[n] for n in names], cfg["train"]["lr"])
    aug = AUG_PRESETS[cfg["data"]["aug_preset"]]
    losses, grad1 = [], {}
    for i, batch in enumerate(batches):
        batch = augment(batch, generator, **aug)
        if half_batch:
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        with ref.precision(matmul, batch["points"].device):
            ep = ref.forward(ref.Net(leaves, train=True), cfg["model"],
                             mean_sizes, batch["points"],
                             batch["point_mask"])
            loss = detection_loss(ep, batch, mean_sizes, cfg["model"])
        grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(leaves[n]) if g is None else g.float()
                 for n, g in zip(names, grads)]
        if i == 0:
            grad1 = {n: float(g.norm()) for n, g in zip(names, grads)}
        opt.step(grads)
        losses.append(float(loss.detach()))
    change = {n: float((leaves[n].detach() - start[n]).norm())
              for n in names}
    return {"loss": losses, "grad1": grad1, "change": change}
