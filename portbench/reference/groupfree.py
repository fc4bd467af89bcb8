"""The plain reference of Group-Free 3D (Liu et al., ICCV 2021,
arXiv:2104.00678) at mmdetection3d's ScanNet L12-O256 setting, as the
Group-Free cell serves it: the PointNet++ backbone over xyz, KPS (an
objectness head on the seeds, then the candidates of largest logit), the
proposal head, the query and key projections, the post-norm transformer
decoder with its learned position embeddings and a box head a stage, the
decode, the boxes of the last three stages, the non-empty filter (more
than 5 valid input points in a box) and greedy class-aware axis-aligned
3D NMS, in plain PyTorch float32.

It imports nothing of the program and nothing of JAX. It reads the
configuration from the benchmark's configuration file (its "model" and
"eval" sections: the backbone's widths, the groupfree_* settings, the
NMS) and the weights from a dict keyed by the program's parameter names
(`shapes` lists them in the program's order). Its arithmetic is written
from the published model, op for op:

  * the backbone: FPS, exact first-K grouping, masked BatchNorm, the
    masked max and the 3-NN interpolation of reference/detector.py, xyz
    relative to the centre and divided by the radius, no point features;
  * every Linear + BN + ReLU a Linear with bias, BatchNorm's eps 1e-5;
  * KPS: two Linear(d, d) + BN + ReLU and a Linear(d, 1) on the seeds; the
    candidates are the seeds of largest objectness logit,
    invalid seeds last, ties to the lower seed (a stable sort);
  * attention written out head by head: Q, K and V by the rows of the
    in-projection, each head's softmax(Q K^T / sqrt(dh)) V with the query
    scaled first (torch.nn.MultiheadAttention's order), padded seeds at
    -inf in the cross-attention (none where a scene has no valid seed),
    the heads concatenated, the out-projection; the position term added
    to the query, the key and the value (mmdet3d's GroupFree3DMHA);
  * LayerNorm over the channels with the biased variance, as torch's
    F.layer_norm computes it (tests/test_torch_groupfree.py holds it to
    its definition, (x - mean) / sqrt(var + eps) * weight + bias, within
    fp32 rounding): the decoder's 36 LayerNorms carry a rounding forward
    through 12 layers, so the reference rounds them as torch does;
  * the decode: centre = candidate + residual at every stage, size =
    mean[c] + res[c] * mean[c] at the argmax size class c, heading 0;
  * the point count: |x - cx| < dx / 2 and |y - cy| < dy / 2 and
    |z - cz| <= dz / 2 over the valid points, a block of boxes at a time;
  * NMS: reference/detector.py's greedy class-aware walk over the boxes
    that pass the filter, by objectness, then objectness above the
    threshold.

`matmul` selects the precision of the products: "fp32" sets both of
torch's TF32 flags off, "tf32" on (the control one precision below).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import detector

BLOCK = 1 << 26  # point-box tests of one block of the point count
LN_EPS = 1e-5  # LayerNorm's eps (mmcv's default)


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


# ------------------------------------------------------------ the backbone


def set_abstraction(net, name, xyz, features, mask, npoint, radius, k,
                    layers):
    """One SA level: FPS, the ball, xyz relative to the centre / radius
    (then the features, where there are any), the MLP, the masked max."""
    inds = detector.fps(xyz, npoint, mask)
    centers = detector.gather(xyz, inds)
    cmask = mask.bool().gather(1, inds.long())
    idx, cnt = detector.ball_query(xyz, centers, radius, k, mask)
    src = xyz if features is None else torch.cat([xyz, features], -1)
    grouped = detector.group(src, idx)
    rel = (grouped[..., :3] - centers[:, :, None, :]) / radius
    x = rel if features is None else torch.cat([rel, grouped[..., 3:]], -1)
    slot = torch.arange(k, dtype=torch.int32, device=cnt.device)
    gmask = (slot < cnt[:, :, None]) & cmask[:, :, None]
    h = net.mlp(f"{name}.mlp_0", x, gmask, layers)
    return centers, detector.masked_max(h, gmask, 2), cmask


def backbone(net, m: dict, points, mask):
    """-> the seeds: xyz [B,S,3], features [B,S,d], mask [B,S]."""
    levels, cur = [], (points, None, mask.bool())
    for i in range(4):
        cur = set_abstraction(net, f"backbone.sa{i + 1}", *cur,
                              m["sa_npoints"][i], m["sa_radii"][i],
                              m["sa_nsamples"][i], len(m["sa_channels"][i]))
        levels.append(cur)
    (x2, f2, m2), (x3, f3, m3), (x4, f4, m4) = levels[1:]
    fp = m["fp_channels"]
    f3p = detector.feature_propagation(net, "backbone.fp1", len(fp[0]), x3,
                                       f3, x4, f4, m3, m4)
    seeds = detector.feature_propagation(net, "backbone.fp2", len(fp[1]), x2,
                                         f2, x3, f3p, m2, m3)
    return x2, seeds, m2


# ------------------------------------------------------------ the layers


def head(net, name, x, mask, layers, base, mean_sizes):
    """A box head and the decode: (center, size, objectness logit, class
    logits) at the candidates `base`."""
    h = net.mlp(f"{name}.shared", x, mask, layers)
    cls = net.linear(f"{name}.cls_out", h)
    reg = net.linear(f"{name}.reg_out", h)
    NS = mean_sizes.shape[0]
    c = reg[..., 5:5 + NS].argmax(-1)
    res = reg[..., 5 + NS:5 + 4 * NS].reshape(*reg.shape[:-1], NS, 3)
    res_c = torch.gather(res * mean_sizes, 2,
                         c[..., None, None].expand(*c.shape, 1, 3))[..., 0, :]
    return (base + reg[..., :3], mean_sizes[c] + res_c, cls[..., 0],
            cls[..., 1:])


def position(net, name, x, mask):
    """PE(in): Linear + BN + ReLU, then Linear."""
    return net.linear(f"{name}.out", net.mlp(f"{name}.mlp", x, mask, 1))


def attention(net, name, query, keys, values, heads: int, padding=None):
    """Multi-head attention head by head (module docstring); padding
    [B,S] True at the keys no query sees."""
    W, b = net.p[f"{name}.in_proj.weight"], net.p[f"{name}.in_proj.bias"]
    d = W.shape[1]
    dh = d // heads
    q = F.linear(query, W[:d], b[:d])
    k = F.linear(keys, W[d:2 * d], b[d:2 * d])
    v = F.linear(values, W[2 * d:], b[2 * d:])
    outs = []
    for h in range(heads):
        part = slice(h * dh, (h + 1) * dh)
        scores = torch.bmm(q[..., part] * math.sqrt(1.0 / dh),
                           k[..., part].transpose(1, 2))
        if padding is not None:
            scores = scores.masked_fill(padding[:, None, :], -torch.inf)
        outs.append(torch.bmm(torch.softmax(scores, -1), v[..., part]))
    return net.linear(f"{name}.out_proj", torch.cat(outs, -1))


def layer_norm(net, name, x, eps: float):
    return F.layer_norm(x, x.shape[-1:], net.p[f"{name}.weight"],
                        net.p[f"{name}.bias"], eps)


def decoder_layer(net, name, q, k, qp, kp, padding, m: dict):
    """One post-norm decoder layer: self-attention, cross-attention, FFN,
    each followed by the residual's LayerNorm."""
    heads, eps = m["groupfree_heads"], LN_EPS
    u = q + qp
    q = layer_norm(net, f"{name}.norm_0",
                   q + attention(net, f"{name}.self_attn", u, u, u, heads),
                   eps)
    w = k + kp
    q = layer_norm(net, f"{name}.norm_1",
                   q + attention(net, f"{name}.cross_attn", q + qp, w, w,
                                 heads, padding), eps)
    hidden = torch.relu(net.linear(f"{name}.ffn_in", q))
    return layer_norm(net, f"{name}.norm_2",
                      q + net.linear(f"{name}.ffn_out", hidden), eps)


def forward(net, m: dict, mean_sizes, points, mask, layers=None) -> dict:
    """points [B,N,3], mask [B,N] -> the end points the parse reads: every
    stage's boxes (the proposal stage first), the KPS picks ("picks"
    [B,C]), the candidates' mask. `layers` (a control) runs the first
    `layers` decoder layers of the configuration's."""
    sizes = torch.as_tensor(mean_sizes, dtype=torch.float32,
                            device=points.device)
    seed_xyz, seeds, seed_mask = backbone(net, m, points, mask)
    h = net.mlp("kps", seeds, seed_mask, 2)
    logits = net.linear("kps_out", h)[..., 0]
    ranked = torch.where(seed_mask, logits, -torch.inf)
    picks = torch.sort(ranked, dim=-1, descending=True,
                       stable=True)[1][:, :m["groupfree_candidates"]]
    cand_xyz = detector.gather(seed_xyz, picks)
    cand = detector.gather(seeds, picks)
    cmask = seed_mask.gather(1, picks)
    hl = len(m["groupfree_head_channels"])
    box = head(net, "proposal", cand, cmask, hl, cand_xyz, sizes)
    q = net.linear("query_proj", cand)
    k = net.linear("key_proj", seeds)
    padding = ~seed_mask & seed_mask.any(-1, keepdim=True)
    boxes = [box]
    for i in range(m["groupfree_layers"] if layers is None else layers):
        qp = position(net, f"query_posembeds.{i}",
                      torch.cat([box[0], box[1]], -1), cmask)
        kp = position(net, f"key_posembeds.{i}", seed_xyz, seed_mask)
        # looked up at call time, so that a control can plant another
        q = decoder_layer(net, f"decoder_layers.{i}", q, k, qp, kp, padding,
                          m)
        box = head(net, f"prediction_heads.{i}", q, cmask, hl, cand_xyz,
                   sizes)
        boxes.append(box)
    center, size, obj, sem = (torch.stack(p, 1) for p in zip(*boxes))
    return {"center": center, "size": size, "obj": obj, "sem": sem,
            "proposal_mask": cmask, "picks": picks}


# ------------------------------------------------------------ parse + NMS


def box_points(points, mask, center, size):
    """counts [B,P] int32: the valid points in each box (module
    docstring), BLOCK point-box tests at a time."""
    B, N, _ = points.shape
    P = center.shape[1]
    valid = mask.bool()
    counts = torch.zeros(B, P, dtype=torch.int32, device=points.device)
    step = max(1, BLOCK // max(B * N, 1))
    for s in range(0, P, step):
        c = center[:, s:s + step]
        half = size[:, s:s + step] * 0.5
        inside = valid[:, None, :].expand(B, c.shape[1], N).clone()
        for axis in range(3):
            gap = (points[:, None, :, axis] - c[:, :, None, axis]).abs()
            edge = half[:, :, None, axis]
            inside &= (gap <= edge) if axis == 2 else (gap < edge)
        counts[:, s:s + step] = inside.sum(-1).int()
    return counts


def parse(ep, points, mask, m: dict, eval_cfg: dict, stages=None,
          gate: bool = True) -> dict:
    """The six served fields of the last `stages` stages (the
    configuration's groupfree_stages where None), and under "counts" each
    box's points, under "valid" the boxes the walk may keep, under
    "walked" the walk's survivors. gate=False (a control) walks every box,
    the non-empty filter left out."""
    S = m["groupfree_stages"] if stages is None else stages
    B = points.shape[0]
    center = ep["center"][:, -S:].reshape(B, -1, 3)
    size = ep["size"][:, -S:].reshape(B, -1, 3)
    obj = torch.sigmoid(ep["obj"][:, -S:].reshape(B, -1))
    sem_logits = ep["sem"][:, -S:]
    sem = torch.softmax(sem_logits.reshape(B, -1, sem_logits.shape[-1]),
                        -1).argmax(-1)
    counts = box_points(points, mask, center, size)
    valid = ep["proposal_mask"].repeat(1, S)
    if gate:
        valid = valid & (counts > m["groupfree_min_points"])
    half = size * 0.5
    lo = torch.minimum(center - half, center + half)
    hi = torch.maximum(center - half, center + half)
    walked = detector.nms(lo, hi, obj, valid, eval_cfg["nms_iou"], sem)
    return {"center": center, "size": size,
            "heading": torch.zeros_like(obj), "sem_cls": sem,
            "obj_prob": obj,
            "keep": walked & (obj > eval_cfg["objectness_thresh"]),
            "counts": counts, "valid": valid, "walked": walked}


# ------------------------------------------------------------ weights


def shapes(m: dict) -> dict:
    """{name: shape} of the program's floating state for this model
    configuration, in the program's order."""
    out = {}

    def linear(name, ch, width):
        out[f"{name}.weight"], out[f"{name}.bias"] = (width, ch), (width,)

    def norm(name, width, running=True):
        leaves = ("weight", "bias") + (("running_mean", "running_var")
                                       if running else ())
        for leaf in leaves:
            out[f"{name}.{leaf}"] = (width,)

    def mlp(prefix, ch, widths, bias):
        for i, w in enumerate(widths):
            out[f"{prefix}.dense_{i}.weight"] = (w, ch)
            if bias:
                out[f"{prefix}.dense_{i}.bias"] = (w,)
            norm(f"{prefix}.bn_{i}", w)
            ch = w
        return ch

    ch, last = 0, []
    for i, widths in enumerate(m["sa_channels"]):
        ch = mlp(f"backbone.sa{i + 1}.mlp_0", 3 + ch, widths, False)
        last.append(ch)
    fp = m["fp_channels"]
    f3 = mlp("backbone.fp1.mlp", last[2] + last[3], fp[0], False)
    d = mlp("backbone.fp2.mlp", last[1] + f3, fp[1], False)
    linear("kps_out", mlp("kps", d, (d, d), True), 1)
    nc = m["num_classes"]

    def box_head(name):
        width = mlp(f"{name}.shared", d, m["groupfree_head_channels"], True)
        linear(f"{name}.cls_out", width, 1 + nc)
        linear(f"{name}.reg_out", width, 5 + 4 * nc)

    box_head("proposal")
    linear("query_proj", d, d)
    linear("key_proj", d, d)
    L = m["groupfree_layers"]
    for i in range(L):
        name = f"decoder_layers.{i}"
        for j, attn in enumerate(("self_attn", "cross_attn")):
            linear(f"{name}.{attn}.in_proj", d, 3 * d)
            linear(f"{name}.{attn}.out_proj", d, d)
            norm(f"{name}.norm_{j}", d, running=False)
        linear(f"{name}.ffn_in", d, m["groupfree_ffn"])
        linear(f"{name}.ffn_out", m["groupfree_ffn"], d)
        norm(f"{name}.norm_2", d, running=False)
    for kind, ch in (("query_posembeds", 6), ("key_posembeds", 3)):
        for i in range(L):
            mlp(f"{kind}.{i}.mlp", ch, (d,), True)
            linear(f"{kind}.{i}.out", d, d)
    for i in range(L):
        box_head(f"prediction_heads.{i}")
    return out


# ------------------------------------------------------------ serve


@torch.no_grad()
def calibrate(params: dict, cfg: dict, mean_sizes, points, mask,
              matmul: str) -> dict:
    """`params` with every BatchNorm's running averages replaced by the
    statistics of one train-mode forward over the batch."""
    stats: dict = {}
    with precision(matmul):
        forward(detector.Net(params, train=True, stats=stats), cfg["model"],
                mean_sizes, points, mask)
    out = dict(params)
    for name, (mean, var) in stats.items():
        out[name + ".running_mean"] = mean.float()
        out[name + ".running_var"] = var.float()
    return out


@torch.no_grad()
def serve(params, cfg: dict, mean_sizes, points, mask, matmul: str, *,
          layers=None, stages=None, gate: bool = True) -> dict:
    """One served batch in eval mode: the six fields, each box's point
    count, the boxes the walk may keep, and the KPS picks, on the host.
    layers, stages and gate: the controls' faults (forward, parse)."""
    m = cfg["model"]
    with precision(matmul):
        ep = forward(detector.Net(params, train=False), m, mean_sizes,
                     points, mask, layers)
        out = parse(ep, points, mask, m, cfg["eval"], stages, gate)
    out = {k: v.float().cpu() if v.is_floating_point() else v.cpu()
           for k, v in out.items()}
    out["picks"] = ep["picks"].cpu()
    return out
