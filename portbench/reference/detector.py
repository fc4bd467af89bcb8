"""The plain reference of the size-adaptive detector: forward, box decode
and class-aware 3D NMS, in plain PyTorch.

It imports nothing of the program and nothing of JAX. It reads the
configuration from the benchmark's configuration file (its "model" and
"eval" sections) and the weights from a dict keyed by the program's
parameter names, which the benchmark draws from the seed and hands to both
sides. Its arithmetic follows the published PointNet++ / VoteNet
description as the program states it, op for op in the same order (exact
first-K grouping in index order, FPS seeded at index 0 with ties to the
lower index, elementwise fp32 distances, masked BatchNorm, the radius
bank blended by softmax in training and by the one-hot of its argmax in
eval), so that a sound program agrees with it to the last bit wherever
both run the same products.

`matmul` selects the precision of the MLP products: "fp32" (TF32 off),
"tf32" or "bf16" (autocast). Distances and the 3-NN cross term stay fp32
in every precision, as the program pins them.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30  # the masked max-pool's sentinel
SLAB = 1 << 28  # elements of one [B, M, N] distance slab
CORNER_SIGNS = np.array(
    [[+0.5, +0.5, +0.5], [-0.5, +0.5, +0.5], [-0.5, -0.5, +0.5],
     [+0.5, -0.5, +0.5], [+0.5, +0.5, -0.5], [-0.5, +0.5, -0.5],
     [-0.5, -0.5, -0.5], [+0.5, -0.5, -0.5]], np.float32)


@contextlib.contextmanager
def precision(matmul: str, device: torch.device):
    """The MLP products' precision for a block (module docstring)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = matmul == "tf32"
    cast = (torch.autocast(device.type, dtype=torch.bfloat16)
            if matmul == "bf16" else contextlib.nullcontext())
    try:
        with cast:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@contextlib.contextmanager
def _fp32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.autocast("cuda", enabled=False), \
                torch.autocast("cpu", enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class _Cross(torch.autograd.Function):
    """a [B,M,3] @ b [B,N,3]^T in fp32, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _fp32():
            return torch.bmm(a, b.transpose(-1, -2))

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        with _fp32():
            grad = grad.float()
            return torch.bmm(grad, b), torch.bmm(grad.transpose(-1, -2), a)


def sqdist(a, b):
    """a [B,M,3], b [B,N,3] -> [B,M,N] fp32, |a|^2 + |b|^2 - 2ab >= 0."""
    a, b = a.float(), b.float()
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True)
    d2 = a2 + b2.transpose(-1, -2) - 2.0 * _Cross.apply(a, b)
    return d2.clamp_min(0.0)


# ------------------------------------------------------------ point ops


def fps(xyz, npoint: int, mask):
    """Furthest point sampling from index 0, ties to the lower index,
    padded points never picked: idx [B, npoint] int32."""
    B, N, _ = xyz.shape
    xyz = xyz.detach().float()
    valid = mask.bool()
    dist = torch.where(valid, torch.inf, -torch.inf)
    idx = torch.zeros(B, npoint, dtype=torch.int32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        d = xyz - xyz[rows, last][:, None, :]
        dx, dy, dz = d.unbind(-1)
        d2 = dx * dx + dy * dy + dz * dz
        dist = torch.minimum(dist, torch.where(valid, d2, -torch.inf))
        last = dist.argmax(-1)
        idx[:, i] = last.int()
    return idx


def ball_query(xyz, centers, radius: float, nsample: int, mask):
    """The first nsample valid points in index order with d^2 < r^2
    (elementwise fp32), slots past the count repeating the first hit:
    (idx [B,M,K] int32, cnt [B,M] int32)."""
    B, N, _ = xyz.shape
    xyz, centers = xyz.detach().float(), centers.detach().float()
    valid = mask.bool()
    r2 = float(np.float32(float(radius) * float(radius)))
    rank = torch.arange(N, dtype=torch.int32, device=xyz.device)
    idxs, cnts = [], []
    chunk = max(1, SLAB // max(B * N, 1))
    for s in range(0, centers.shape[1], chunk):
        c = centers[:, s:s + chunk]
        dx = c[:, :, None, 0] - xyz[:, None, :, 0]
        dy = c[:, :, None, 1] - xyz[:, None, :, 1]
        dz = c[:, :, None, 2] - xyz[:, None, :, 2]
        within = ((dx * dx + dy * dy + dz * dz) < r2) & valid[:, None, :]
        score = torch.where(within, N - rank, 0)
        top = score.topk(min(nsample, N), dim=-1).values
        if top.shape[-1] < nsample:
            top = F.pad(top, (0, nsample - top.shape[-1]))
        hit = top > 0
        idx = torch.where(hit, N - top, 0)
        idxs.append(torch.where(hit, idx, idx[..., :1]).int())
        cnts.append(within.sum(-1).clamp_max(nsample).int())
    return torch.cat(idxs, 1), torch.cat(cnts, 1)


def gather(points, idx):
    """points [B,N,C], idx [B,M] -> [B,M,C]."""
    C = points.shape[-1]
    return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, C))


def group(points, idx):
    B, M, K = idx.shape
    return gather(points, idx.reshape(B, M * K)).reshape(B, M, K, -1)


def query_and_group(xyz, centers, radius, nsample, features, mask):
    """Center-relative xyz / radius, then the features: ([B,M,K,3+C],
    slot mask [B,M,K])."""
    idx, cnt = ball_query(xyz, centers, radius, nsample, mask)
    src = torch.cat([xyz, features], -1)
    grouped = group(src, idx)
    rel = (grouped[..., :3] - centers[:, :, None, :]) / radius
    slot = torch.arange(nsample, dtype=torch.int32, device=cnt.device)
    return torch.cat([rel, grouped[..., 3:]], -1), slot < cnt[:, :, None]


def masked_max(x, mask, dim):
    mask = mask.bool()
    if mask.dim() == x.dim() - 1:
        mask = mask.unsqueeze(-1)
    out = torch.where(mask, x, NEG_INF).amax(dim)
    return torch.where(mask.any(dim), out, 0.0)


# ------------------------------------------------------------ layers


class Net:
    """The weights (a dict by the program's parameter names) and the mode:
    train=True takes BatchNorm's statistics from the batch (masked), else
    from the running averages; `stats` (a dict) then gets each BatchNorm's
    (mean, variance) by name."""

    def __init__(self, params: dict, train: bool, eps: float = 1e-5,
                 stats: dict | None = None):
        self.p = params
        self.train = train
        self.eps = eps
        self.stats = stats

    def linear(self, name, x):
        return F.linear(x, self.p[name + ".weight"],
                        self.p.get(name + ".bias"))

    def bn(self, name, x, mask):
        if self.train:
            rows = x.reshape(-1, x.shape[-1])
            m = mask.reshape(-1, 1).to(x.dtype)
            cnt = m.sum().clamp_min(1.0)
            mean = (rows * m).sum(0) / cnt
            var = (m * (rows - mean) ** 2).sum(0) / cnt
            if self.stats is not None:
                self.stats[name] = (mean, var)
        else:
            mean = self.p[name + ".running_mean"]
            var = self.p[name + ".running_var"]
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.p[name + ".weight"] + self.p[name + ".bias"]

    def mlp(self, name, x, mask, layers):
        for i in range(layers):
            x = torch.relu(self.bn(f"{name}.bn_{i}",
                                   self.linear(f"{name}.dense_{i}", x), mask))
        return x


def set_abstraction(net, name, cfg, level, xyz, features, mask):
    inds = fps(xyz, cfg["sa_npoints"][level], mask)
    new_xyz = gather(xyz, inds)
    new_mask = mask.bool().gather(1, inds.long())
    grouped, gmask = query_and_group(xyz, new_xyz, cfg["sa_radii"][level],
                                     cfg["sa_nsamples"][level], features,
                                     mask)
    gmask = gmask & new_mask[:, :, None]
    h = net.mlp(f"{name}.mlp_0", grouped, gmask,
                len(cfg["sa_channels"][level]))
    return new_xyz, masked_max(h, gmask, 2), inds, new_mask


def three_nn(query, support, support_mask):
    d2 = sqdist(query, support)
    d2 = torch.where(support_mask.bool()[:, None, :], d2, torch.inf)
    d2, order = torch.sort(d2, dim=-1, stable=True)
    return d2[..., :3], order[..., :3].int()


def feature_propagation(net, name, layers, dense_xyz, dense_features,
                        sparse_xyz, sparse_features, dense_mask,
                        sparse_mask):
    d2, idx = three_nn(dense_xyz, sparse_xyz, sparse_mask)
    d2 = torch.where(torch.isfinite(d2), d2, 1e10)
    recip = 1.0 / (d2 + 1e-8)
    weight = recip / recip.sum(-1, keepdim=True)
    interp = torch.einsum("bmkc,bmk->bmc", group(sparse_features, idx),
                          weight)
    interp = torch.cat([dense_features, interp], -1)
    return net.mlp(f"{name}.mlp", interp, dense_mask, layers)


def forward(net: Net, cfg: dict, mean_sizes: np.ndarray, points, mask):
    """points [B,N,3], mask [B,N] -> the end points the loss and the parse
    read."""
    valid = mask.bool()[..., None]
    z = points[..., 2:3]
    floor = torch.where(valid, z, torch.inf).amin(1, keepdim=True)
    features = z - floor

    levels, cur = [], (points, features, mask)
    for i in range(4):
        out = set_abstraction(net, f"backbone.sa{i + 1}", cfg, i, *cur)
        levels.append(out)
        cur = (out[0], out[1], out[3])
    (_, _, i1, _), (x2, f2, i2, m2), (x3, f3, _, m3), (x4, f4, _, m4) = levels
    fp = cfg["fp_channels"]
    f3p = feature_propagation(net, "backbone.fp1", len(fp[0]), x3, f3, x4,
                              f4, m3, m4)
    seeds = feature_propagation(net, "backbone.fp2", len(fp[1]), x2, f2, x3,
                                f3p, m2, m3)
    ep = {"seed_xyz": x2, "seed_features": seeds, "seed_mask": m2,
          "seed_inds": torch.gather(i1, 1, i2.long())}

    # voting: one vote a seed (vote_factor 1)
    B, S, C = seeds.shape
    x = torch.relu(net.bn("voting.bn_0", net.linear("voting.dense_0", seeds),
                          m2))
    x = torch.relu(net.bn("voting.bn_1", net.linear("voting.dense_1", x), m2))
    out = net.linear("voting.out", x).reshape(B, S, 1, 3 + C)
    vote_xyz = (x2[:, :, None, :] + out[..., :3]).reshape(B, S, 3)
    vote_feat = (seeds[:, :, None, :] + out[..., 3:]).reshape(B, S, C)
    vote_mask = m2.bool()
    ep.update(vote_xyz=vote_xyz, vote_mask=vote_mask)

    # the size-adaptive proposal: FPS over the votes, the radius bank
    inds = fps(vote_xyz, cfg["num_proposals"], vote_mask)
    center_mask = vote_mask.gather(1, inds.long())
    centers = gather(vote_xyz, inds)
    feats = []
    for r_i, radius in enumerate(cfg["cluster_radius_bank"]):
        grouped, gmask = query_and_group(vote_xyz, centers, radius,
                                         cfg["cluster_nsample"], vote_feat,
                                         vote_mask)
        gmask = gmask & center_mask[:, :, None]
        h = net.mlp(f"proposal.scale_mlp_{r_i}", grouped, gmask, 3)
        feats.append(masked_max(h, gmask, 2))
    stacked = torch.stack(feats, 2)
    _, P, R, D = stacked.shape
    sel = net.mlp("proposal.scale_sel_mlp", stacked.reshape(B, P, R * D),
                  center_mask, 1)
    scale_logits = net.linear("proposal.scale_sel_out", sel)
    if net.train:
        blend = torch.softmax(scale_logits, -1)
    else:
        blend = F.one_hot(scale_logits.argmax(-1), R).to(stacked.dtype)
    x = torch.einsum("bprd,bpr->bpd", stacked, blend)
    for i in range(2):
        x = torch.relu(net.bn(f"proposal.head_bn_{i}",
                              net.linear(f"proposal.head_{i}", x),
                              center_mask))
    raw = net.linear("proposal.head_out", x)
    ep.update(proposal_xyz=centers, proposal_mask=center_mask,
              scale_logits=scale_logits)
    ep.update(decode(raw, centers, mean_sizes, cfg["num_heading_bins"]))
    return ep


def decode(raw, base_xyz, mean_sizes, NH: int):
    NS = len(mean_sizes)
    sizes = torch.as_tensor(mean_sizes, dtype=torch.float32,
                            device=raw.device)
    splits = [2, 3, NH, NH, NS, NS * 3]
    obj, off, hs, hr, ss, sr, sem = torch.split(
        raw, splits + [raw.shape[-1] - sum(splits)], -1)
    sr = sr.reshape(*raw.shape[:2], NS, 3)
    return {
        "objectness_scores": obj,
        "center": base_xyz + off,
        "heading_scores": hs,
        "heading_residuals_normalized": hr,
        "heading_residuals": hr * (np.pi / NH),
        "size_scores": ss,
        "size_residuals_normalized": sr,
        "size_residuals": sr * sizes,
        "sem_cls_scores": sem,
    }


# ------------------------------------------------------------ parse + NMS


def boxes(ep, mean_sizes, NH: int):
    """Argmax decode: (center, size, heading, sem_cls, obj_prob)."""
    center = ep["center"]
    sizes = torch.as_tensor(mean_sizes, dtype=torch.float32,
                            device=center.device)
    hcls = ep["heading_scores"].argmax(-1)
    hres = ep["heading_residuals"].gather(-1, hcls[..., None])[..., 0]
    angle = hcls.float() * (2.0 * np.pi / NH) + hres
    heading = torch.where(angle > np.pi, angle - 2.0 * np.pi, angle)
    scls = ep["size_scores"].argmax(-1)
    sres = ep["size_residuals"].gather(
        -2, scls[..., None, None].expand(*scls.shape, 1, 3))[..., 0, :]
    size = (sizes[scls] + sres).clamp_min(1e-4)
    sem = ep["sem_cls_scores"].argmax(-1)
    obj = torch.softmax(ep["objectness_scores"], -1)[..., 1]
    return center, size, heading, sem, obj


def corners(center, size, heading):
    signs = torch.as_tensor(CORNER_SIGNS, device=size.device)
    ext = size[..., None, :] * signs
    c, s = torch.cos(heading)[..., None], torch.sin(heading)[..., None]
    x = ext[..., 0] * c - ext[..., 1] * s
    y = ext[..., 0] * s + ext[..., 1] * c
    return torch.stack([x, y, ext[..., 2]], -1) + center[..., None, :]


def aabb_iou(bmin, bmax):
    lo = torch.maximum(bmin[..., :, None, :], bmin[..., None, :, :])
    hi = torch.minimum(bmax[..., :, None, :], bmax[..., None, :, :])
    inter = (hi - lo).clamp_min(0.0).prod(-1)
    vol = (bmax - bmin).clamp_min(0.0).prod(-1)
    union = vol[..., :, None] + vol[..., None, :] - inter
    return torch.where(union > 0.0, inter / union.clamp_min(1e-12), 0.0)


def nms(bmin, bmax, scores, valid, iou_thresh, sem_cls):
    """Greedy class-aware NMS over the K candidates in score order (a
    stable sort; boxes of other classes moved apart by class x span)."""
    span = bmax.max() - bmin.min() + 1.0
    shift = (sem_cls.to(bmin.dtype) * span)[..., None]
    iou = aabb_iou(bmin + shift, bmax + shift)
    B, K = scores.shape
    order = torch.argsort(-torch.where(valid, scores, -torch.inf), dim=-1,
                          stable=True)
    rows = torch.arange(B, device=scores.device)[:, None]
    over = iou[rows[..., None], order[:, :, None], order[:, None, :]] \
        > iou_thresh
    over &= ~torch.eye(K, dtype=torch.bool, device=scores.device)
    valid_sorted = valid.gather(1, order)
    suppressed = torch.zeros(B, K, dtype=torch.bool, device=scores.device)
    keep_sorted = torch.zeros(B, K, dtype=torch.bool, device=scores.device)
    for i in range(K):
        kept = valid_sorted[:, i] & ~suppressed[:, i]
        keep_sorted[:, i] = kept
        suppressed |= over[:, i] & kept[:, None]
    keep = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)
    return keep & valid


def parse(ep, mean_sizes, NH: int, eval_cfg: dict) -> dict:
    """The six served fields: center, size, heading, sem_cls, obj_prob,
    keep (3D axis-aligned, class-aware NMS)."""
    center, size, heading, sem, obj = boxes(ep, mean_sizes, NH)
    c = corners(center, size, heading)
    valid = ep["proposal_mask"] & (obj > eval_cfg["objectness_thresh"])
    keep = nms(c.amin(-2), c.amax(-2), obj, valid, eval_cfg["nms_iou"], sem)
    return {"center": center, "size": size, "heading": heading,
            "sem_cls": sem, "obj_prob": obj, "keep": keep}


@torch.no_grad()
def calibrate(params: dict, cfg: dict, mean_sizes, points, mask,
              matmul: str) -> dict:
    """`params` with every BatchNorm's running averages replaced by the
    statistics of one train-mode forward over (points, mask): what a
    trained model's averages are, the statistics of its data."""
    stats: dict = {}
    with precision(matmul, points.device):
        forward(Net(params, train=True, stats=stats), cfg["model"],
                mean_sizes, points, mask)
    out = dict(params)
    for name, (mean, var) in stats.items():
        out[name + ".running_mean"] = mean.float()
        out[name + ".running_var"] = var.float()
    return out


@torch.no_grad()
def serve(params, cfg: dict, mean_sizes, points, mask, matmul: str) -> dict:
    """One served batch in eval mode: the six fields, on the host."""
    with precision(matmul, points.device):
        ep = forward(Net(params, train=False), cfg["model"], mean_sizes,
                     points, mask)
        out = parse(ep, mean_sizes, cfg["model"]["num_heading_bins"],
                    cfg["eval"])
    return {k: v.float().cpu() if v.is_floating_point() else v.cpu()
            for k, v in out.items()}
