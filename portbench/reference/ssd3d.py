"""The plain reference of 3DSSD (Yang et al., CVPR 2020, arXiv:2002.10187)
at mmdetection3d's KITTI car setting, as the 3DSSD cell serves it: fusion
sampling (D-FPS and F-FPS), three MSG set-abstraction levels with an
aggregation conv each, the vote layer with its clamped offsets, candidate
generation around the votes, the head, the anchor-free decode and greedy
NMS by the oriented bird's-eye-view IoU with the first `max_output`
survivors kept, in plain PyTorch.

It imports nothing of the program and nothing of JAX. It reads the
configuration from the benchmark's configuration file (its "model" and
"eval" sections: the ssd3d_* widths, the NMS) and the weights from a dict
keyed by the program's parameter names (`shapes` lists them in the
program's order). Its arithmetic is written from the published model as
the configuration states it, op for op in one fixed order:

  * F-FPS: FPS from index 0 by the fp32 squared distance over each point's
    vector (xyz, then its features), each difference, square and sum
    rounded in dimension order (mmdet3d expands |a|^2 + |b|^2 - 2 a.b
    through a matmul, another rounding of the same distance), ties to the
    lower index; D-FPS the same over xyz (reference/detector.py's);
  * grouping: exact first-K ball query in index order
    (reference/detector.py's), xyz relative to the centre and not divided
    by the radius, then the features; an empty ball pools to 0;
  * BatchNorm with eps 1e-3, masked as the program masks it;
  * the IoU: reference/outdoor.py's, written from its definition, in
    float64.

`matmul` selects the precision of the products: "fp32" sets both of
torch's TF32 flags off, "tf32" on (the control one precision below).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference import detector, outdoor

# looked up at call time, so that a control can plant another in its place
oriented_iou = outdoor.oriented_iou


@contextlib.contextmanager
def precision(matmul: str):
    """Both of torch's TF32 flags, for a block: off for "fp32"."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = matmul == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ------------------------------------------------------------ sampling


def ffps(points, npoint: int, mask):
    """F-FPS over points [B, N, D] (module docstring): idx [B, npoint]
    int32; masked points are never picked."""
    B, N, D = points.shape
    x = points.detach().float()
    valid = mask.bool()
    dist = torch.where(valid, torch.inf, -torch.inf)
    idx = torch.zeros(B, npoint, dtype=torch.int32, device=x.device)
    rows = torch.arange(B, device=x.device)
    last = torch.zeros(B, dtype=torch.long, device=x.device)
    for i in range(1, npoint):
        diff = x - x[rows, last][:, None, :]
        sq = diff * diff
        d2 = sq[..., 0].clone()
        for k in range(1, D):
            d2 += sq[..., k]
        dist = torch.minimum(dist, torch.where(valid, d2, -torch.inf))
        last = dist.argmax(-1)
        idx[:, i] = last.int()
    return idx


def dfps(xyz, npoint: int, mask):
    return detector.fps(xyz, npoint, mask)


def sample(cfg: dict, level: int, xyz, features, mask) -> list:
    """The level's picks, (picks into the sampler's range, the range's
    start) a sampler in order (an "FS" sampler gives F-FPS's then
    D-FPS's)."""
    N = xyz.shape[1]
    out, start = [], 0
    for mode, end, m in zip(cfg["ssd3d_fps_mods"][level],
                            cfg["ssd3d_fps_ranges"][level],
                            cfg["ssd3d_npoints"][level]):
        stop = N if end == -1 else end
        part = mask[:, start:stop]
        if mode in ("F-FPS", "FS"):
            vec = torch.cat([xyz[:, start:stop], features[:, start:stop]], -1)
            out.append((ffps(vec, m, part), start))
        if mode in ("D-FPS", "FS"):
            out.append((dfps(xyz[:, start:stop], m, part), start))
        start = stop
    return out


# ------------------------------------------------------------ layers


def group_pool(net, name: str, xyz, features, mask, centers, center_mask,
               radii, nsamples, mlps) -> torch.Tensor:
    """MSG around centers [B,M,3]: per scale the first-K ball, relative xyz
    and the features, the MLP `name`.mlp_<s>, the masked max; the scales
    concatenated."""
    pooled = []
    src = torch.cat([xyz, features], -1)
    for s, (radius, k) in enumerate(zip(radii, nsamples)):
        idx, cnt = detector.ball_query(xyz, centers, radius, k, mask)
        grouped = detector.group(src, idx)
        rel = grouped[..., :3] - centers[:, :, None, :]
        x = torch.cat([rel, grouped[..., 3:]], -1)
        slot = torch.arange(k, dtype=torch.int32, device=cnt.device)
        gmask = (slot < cnt[:, :, None]) & center_mask[:, :, None]
        h = net.mlp(f"{name}.mlp_{s}", x, gmask, len(mlps[s]))
        pooled.append(detector.masked_max(h, gmask, 2))
    return torch.cat(pooled, -1)


def forward(net, cfg: dict, points, features, mask) -> dict:
    """points [B,N,3], features [B,N,C], mask [B,N] -> the end points the
    parse reads, and under "picks" every sampler's picks (into its range)
    in order."""
    xyz, feats, m = points, features, mask.bool()
    picks = []
    for level in range(len(cfg["ssd3d_npoints"])):
        parts = sample(cfg, level, xyz, feats, m)
        picks += [p for p, _ in parts]
        inds = torch.cat([p + start for p, start in parts], 1)
        centers = detector.gather(xyz, inds)
        cmask = m.gather(1, inds.long())
        name = f"sa{level + 1}"
        pooled = group_pool(net, name, xyz, feats, m, centers, cmask,
                            cfg["ssd3d_radii"][level],
                            cfg["ssd3d_nsamples"][level],
                            cfg["ssd3d_mlps"][level])
        feats = net.mlp(f"{name}.agg", pooled, cmask, 1)
        xyz, m = centers, cmask

    S = cfg["ssd3d_npoints"][-1][0]
    seed_xyz, seed_mask = xyz[:, :S], m[:, :S]
    h = net.mlp("vote", feats[:, :S], seed_mask,
                len(cfg["ssd3d_vote_channels"]))
    limit = torch.as_tensor(np.asarray(cfg["ssd3d_vote_range"], np.float32),
                            device=points.device)
    offset = net.linear("vote_out", h).clamp(min=-limit, max=limit)
    votes = seed_xyz + offset

    cand = group_pool(net, "cg", xyz, feats, m, votes, seed_mask,
                      cfg["ssd3d_cg_radii"], cfg["ssd3d_cg_nsamples"],
                      cfg["ssd3d_cg_mlps"])
    h = net.mlp("shared", cand, seed_mask, len(cfg["ssd3d_shared_channels"]))
    branch = len(cfg["ssd3d_branch_channels"])
    logits = net.linear("cls_out", net.mlp("cls", h, seed_mask, branch))
    raw = net.linear("reg_out", net.mlp("reg", h, seed_mask, branch))

    NH = cfg["num_heading_bins"]
    hres = raw[..., 6 + NH:6 + 2 * NH] * (np.pi / NH)
    hcls = raw[..., 6:6 + NH].argmax(-1)
    angle = hcls.float() * (2.0 * np.pi / NH) + hres.gather(
        -1, hcls[..., None])[..., 0]
    return {"center": votes + raw[..., :3],
            "size": (raw[..., 3:6] * 2).clamp_min(0.1),
            "heading": torch.where(angle > np.pi, angle - 2.0 * np.pi, angle),
            "logits": logits, "proposal_mask": seed_mask, "picks": picks}


# ------------------------------------------------------------ parse + NMS


def top(keep, score, k: int):
    """keep cut to its first k boxes by score (a stable sort of -score)."""
    P = keep.shape[-1]
    if k <= 0 or k >= P:
        return keep
    order = torch.argsort(-torch.where(keep, score, -torch.inf), dim=-1,
                          stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(P).expand_as(order))
    return keep & (rank < k)


def parse(ep, eval_cfg: dict, max_output: int) -> dict:
    """The six served fields (score under obj_prob: the sigmoid of the
    largest class logit; no objectness), keep by greedy NMS over the
    oriented IoU (class-aware where eval.cls_nms: other classes moved apart
    in x) cut to the first max_output by score; under "iou" the IoU the walk
    reads, under "valid" the boxes it may keep."""
    score = torch.sigmoid(ep["logits"].amax(-1))
    sem = ep["logits"].argmax(-1)
    c = detector.corners(ep["center"], ep["size"], ep["heading"])
    valid = ep["proposal_mask"] & (score > eval_cfg["objectness_thresh"])
    if eval_cfg.get("cls_nms", True):
        span = c[..., 0].max() - c[..., 0].min() + 1.0
        shift = (sem.to(c.dtype) * span)[..., None]
        c = torch.cat([c[..., :1] + shift[..., None], c[..., 1:]], -1)
    iou = oriented_iou(c, c).cpu()
    keep = outdoor.greedy(iou, score.cpu(), valid.cpu(), eval_cfg["nms_iou"])
    keep = top(keep, score.cpu(), max_output)
    return {"center": ep["center"], "size": ep["size"],
            "heading": ep["heading"], "sem_cls": sem, "obj_prob": score,
            "keep": keep.to(score.device), "iou": iou, "valid": valid}


# ------------------------------------------------------------ weights


def shapes(cfg: dict) -> dict:
    """{name: shape} of the program's floating state for this model
    configuration, in the program's order."""
    out = {}

    def mlp(prefix, ch, widths, bias=False):
        for i, w in enumerate(widths):
            out[f"{prefix}.dense_{i}.weight"] = (w, ch)
            if bias:
                out[f"{prefix}.dense_{i}.bias"] = (w,)
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                out[f"{prefix}.bn_{i}.{leaf}"] = (w,)
            ch = w
        return ch

    ch = cfg["ssd3d_point_features"]
    for level, scales in enumerate(cfg["ssd3d_mlps"]):
        widths = [mlp(f"sa{level + 1}.mlp_{s}", ch + 3, c)
                  for s, c in enumerate(scales)]
        ch = mlp(f"sa{level + 1}.agg", sum(widths),
                 (cfg["ssd3d_aggregation"][level],), bias=True)
    vote = mlp("vote", ch, cfg["ssd3d_vote_channels"])
    out["vote_out.weight"], out["vote_out.bias"] = (3, vote), (3,)
    cg = sum(mlp(f"cg.mlp_{s}", ch + 3, c, bias=True)
             for s, c in enumerate(cfg["ssd3d_cg_mlps"]))
    width = mlp("shared", cg, cfg["ssd3d_shared_channels"], bias=True)
    nc, nh = cfg["num_classes"], cfg["num_heading_bins"]
    for name, n_out in (("cls", nc), ("reg", 6 + 2 * nh)):
        last = mlp(name, width, cfg["ssd3d_branch_channels"], bias=True)
        out[f"{name}_out.weight"] = (n_out, last)
        out[f"{name}_out.bias"] = (n_out,)
    return out


# ------------------------------------------------------------ serve


@torch.no_grad()
def calibrate(params: dict, cfg: dict, points, features, mask,
              matmul: str) -> dict:
    """`params` with every BatchNorm's running averages replaced by the
    statistics of one train-mode forward over the batch."""
    stats: dict = {}
    with precision(matmul):
        forward(detector.Net(params, train=True, eps=cfg["model"]
                             ["ssd3d_bn_eps"], stats=stats), cfg["model"],
                points, features, mask)
    out = dict(params)
    for name, (mean, var) in stats.items():
        out[name + ".running_mean"] = mean.float()
        out[name + ".running_var"] = var.float()
    return out


@torch.no_grad()
def serve(params, cfg: dict, points, features, mask, matmul: str) -> dict:
    """One served batch in eval mode: the six fields, the NMS's IoU and
    valid boxes, and every sampler's picks, on the host."""
    m = cfg["model"]
    with precision(matmul):
        ep = forward(detector.Net(params, train=False, eps=m["ssd3d_bn_eps"]),
                     m, points, features, mask)
        out = parse(ep, cfg["eval"], m["ssd3d_max_output"])
    out = {k: v.float().cpu() if v.is_floating_point() else v.cpu()
           for k, v in out.items()}
    out["picks"] = [p.cpu() for p in ep["picks"]]
    return out
