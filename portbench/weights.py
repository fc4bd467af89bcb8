"""The benchmark's weights: drawn from the seed on the device, by the
program's parameter names, and handed alike to the program and to the
plain reference."""

from __future__ import annotations

import numpy as np
import torch


def draw(names_shapes: dict, seed: int, device) -> dict:
    """Seeded weights for a state given as {name: shape}, made on the
    device in two draws: Linear weights normal with variance 2 / fan-in
    before a ReLU (1 / fan-in for the output layers), biases and
    BatchNorm's affine terms and running averages spread about their
    neutral values."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(int(np.prod(s)) for s in names_shapes.values())
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in names_shapes.items():
        n = int(np.prod(shape))
        z = normal[at:at + n].reshape(shape)
        u = uniform[at:at + n].reshape(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if len(shape) == 2:
            gain = 1.0 if name.endswith("out.weight") else 2.0
            w = z * (gain / shape[1]) ** 0.5
        elif leaf == "weight":
            w = 1.0 + 0.1 * z
        elif leaf == "running_var":
            w = 0.5 + u
        else:
            w = 0.05 * z
        out[name] = w.contiguous()
    return out


def detector_shapes(model_cfg: dict) -> dict:
    """{name: shape} of the detector's floating state, in the program's
    order, from the configuration alone."""
    out = {}

    def mlp(prefix, ch, widths):
        for i, w in enumerate(widths):
            out[f"{prefix}.dense_{i}.weight"] = (w, ch)
            bn(f"{prefix}.bn_{i}", w)
            ch = w
        return ch

    def bn(prefix, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{prefix}.{leaf}"] = (c,)

    m = model_cfg
    ch, last = 1, []
    for i, widths in enumerate(m["sa_channels"]):
        ch = mlp(f"backbone.sa{i + 1}.mlp_0", 3 + ch, widths)
        last.append(ch)
    f3 = mlp("backbone.fp1.mlp", last[2] + last[3], m["fp_channels"][0])
    seed = mlp("backbone.fp2.mlp", last[1] + f3, m["fp_channels"][1])
    d = m["seed_feat_dim"]
    out["voting.dense_0.weight"], out["voting.dense_0.bias"] = (d, seed), (d,)
    bn("voting.bn_0", d)
    out["voting.dense_1.weight"], out["voting.dense_1.bias"] = (d, d), (d,)
    bn("voting.bn_1", d)
    out["voting.out.weight"] = (3 + seed, d)
    out["voting.out.bias"] = (3 + seed,)
    feat, R = 128, len(m["cluster_radius_bank"])
    for r in range(R):
        mlp(f"proposal.scale_mlp_{r}", 3 + seed, (feat,) * 3)
    mlp("proposal.scale_sel_mlp", R * feat, (feat,))
    out["proposal.scale_sel_out.weight"] = (R, feat)
    out["proposal.scale_sel_out.bias"] = (R,)
    for i in range(2):
        out[f"proposal.head_{i}.weight"] = (feat, feat)
        out[f"proposal.head_{i}.bias"] = (feat,)
        bn(f"proposal.head_bn_{i}", feat)
    nh, nc = m["num_heading_bins"], m["num_classes"]
    oc = 2 + 3 + 2 * nh + 5 * nc
    out["proposal.head_out.weight"] = (oc, feat)
    out["proposal.head_out.bias"] = (oc,)
    return out
