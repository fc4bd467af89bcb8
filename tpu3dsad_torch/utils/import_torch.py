"""Lineage VoteNet checkpoint importer (tpu3dsad/utils/import_torch.py),
onto the port's state_dict names.

The port's modules carry the reference's flax module names, so the
lineage's names map as

  backbone_net.sa{i}.mlp_module.layer{j}.conv.weight   [out,in,1,1]
      -> backbone.sa{i}.mlp_0.dense_{j}.weight          [out,in]
  backbone_net.sa{i}.mlp_module.layer{j}.bn(.bn).{weight,bias,
      running_mean,running_var} -> backbone.sa{i}.mlp_0.bn_{j}.*
  backbone_net.fp{i}.mlp.layer{j}.*                    -> backbone.fp{i}.mlp.*
  vgen.conv{1,2}.{weight,bias} + vgen.bn{1,2}.*        -> voting.dense_{0,1}.*,
                                                          voting.bn_{0,1}.*
  vgen.conv3.{weight,bias}                             -> voting.out.*
  pnet.vote_aggregation.mlp_module.layer{j}.*          -> proposal.sa_mlp.*
  pnet.conv{1,2}.* + pnet.bn{1,2}.*                    -> proposal.head_{0,1}.*,
                                                          proposal.head_bn_{0,1}.*
  pnet.conv3.{weight,bias}                             -> proposal.head_out.*

A lineage 1x1 conv weight only loses its trailing 1s: the port's layers
are nn.Linear, [out, in] like the conv's (the reference transposes
because flax kernels are [in, out]). The pnet.* tensors need the detector
built with model.proposal_mode='lineage'; the size-adaptive head (the
radius bank) has no lineage counterpart and keeps its initial weights.

CLI:
  python -m tpu3dsad_torch.utils.import_torch ckpt=<checkpoint.tar> \\
      out=<ckpt_dir> [device=cpu] [section.key=value overrides...]

It builds the detector of the overrides in proposal_mode='lineage' (on
the card unless device=cpu), imports the weights, writes them as the
step-1 checkpoint <out>/ckpt_1.pt with a fresh optimizer (so
eval_detector evaluates it and the train entry fine-tunes from it), prints
a JSON coverage report and exits 1 where any source tensor was not
placed.
"""

from __future__ import annotations

import json
import sys
from dataclasses import replace

import numpy as np
import torch

_BN = ("weight", "bias", "running_mean", "running_var")


def _conv_weight(w) -> np.ndarray:
    """A lineage conv weight [out, in, 1(, 1)] -> an nn.Linear weight
    [out, in]."""
    w = np.asarray(w)
    while w.ndim > 2:
        if w.shape[-1] != 1:
            raise ValueError(f"not a 1x1 conv: {tuple(w.shape)}")
        w = w[..., 0]
    return w


def _rules(num_sa: int = 4, num_fp: int = 2, mlp_layers: int = 3):
    """(lineage layer prefix, port dense name, port bn name) of the
    backbone's shared MLP layers."""
    out = []
    for i in range(1, num_sa + 1):
        for j in range(mlp_layers):
            out.append((f"backbone_net.sa{i}.mlp_module.layer{j}",
                        f"backbone.sa{i}.mlp_0.dense_{j}",
                        f"backbone.sa{i}.mlp_0.bn_{j}"))
    for i in range(1, num_fp + 1):
        for j in range(mlp_layers - 1):
            out.append((f"backbone_net.fp{i}.mlp.layer{j}",
                        f"backbone.fp{i}.mlp.dense_{j}",
                        f"backbone.fp{i}.mlp.bn_{j}"))
    return out


def import_lineage_weights(state_dict: dict, target: dict
                           ) -> tuple[dict, list, list]:
    """Copy lineage weights onto a detector's state_dict.

    state_dict: flat {lineage name: array or tensor}; target: the port
    detector's state_dict, for names, shapes, dtype and device. Returns
    (new state_dict, copied source keys, skipped source keys); a tensor
    whose shape does not match its place raises a ValueError."""
    out = dict(target)
    copied = []

    def put(key, value, src):
        value = torch.as_tensor(np.asarray(value, np.float32))
        old = out[key]
        if tuple(old.shape) != tuple(value.shape):
            raise ValueError(f"{key}: {tuple(old.shape)} vs "
                             f"{tuple(value.shape)}")
        out[key] = value.to(device=old.device, dtype=old.dtype)
        copied.append(src)

    def conv(src, dst, bias=False):
        """src.weight (and src.bias where asked for and present) -> dst."""
        if f"{src}.weight" in state_dict:
            put(f"{dst}.weight", _conv_weight(state_dict[f"{src}.weight"]),
                f"{src}.weight")
        if bias and f"{src}.bias" in state_dict:
            put(f"{dst}.bias", state_dict[f"{src}.bias"], f"{src}.bias")

    def bn(prefixes, dst):
        """The first of `prefixes` that holds a BN -> dst."""
        for pre in prefixes:
            if f"{pre}.weight" in state_dict:
                for name in _BN:
                    put(f"{dst}.{name}", state_dict[f"{pre}.{name}"],
                        f"{pre}.{name}")
                return

    def shared_mlp(src, dense, norm):
        conv(f"{src}.conv", dense)
        bn((f"{src}.bn.bn", f"{src}.bn"), norm)

    for src, dense, norm in _rules():
        shared_mlp(src, dense, norm)

    # the voting module: conv1 / conv2 (+ bn1 / bn2), conv3 with its bias
    for j in range(2):
        conv(f"vgen.conv{j + 1}", f"voting.dense_{j}", bias=True)
        bn((f"vgen.bn{j + 1}",), f"voting.bn_{j}")
    if "vgen.conv3.weight" in state_dict:
        conv("vgen.conv3", "voting.out", bias=True)

    # the lineage proposal head, where the detector has one
    if "proposal.sa_mlp.dense_0.weight" in out:
        for j in range(3):
            shared_mlp(f"pnet.vote_aggregation.mlp_module.layer{j}",
                       f"proposal.sa_mlp.dense_{j}",
                       f"proposal.sa_mlp.bn_{j}")
        for j in range(2):
            conv(f"pnet.conv{j + 1}", f"proposal.head_{j}", bias=True)
            bn((f"pnet.bn{j + 1}",), f"proposal.head_bn_{j}")
        if "pnet.conv3.weight" in state_dict:
            conv("pnet.conv3", "proposal.head_out", bias=True)

    skipped = [k for k in state_dict if k not in copied]
    return out, copied, skipped


def load_torch_checkpoint(path: str) -> dict:
    """A lineage checkpoint.tar (or a bare state_dict) -> its flat model
    state_dict as numpy arrays, BatchNorm's num_batches_tracked left out
    (a counter, not a weight). Only tensors and plain containers are
    unpickled (weights_only)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    return {k: v.detach().numpy() for k, v in sd.items()
            if "num_batches_tracked" not in k}


def main(argv):
    """ckpt=<checkpoint.tar> out=<ckpt_dir> [device=cpu] [overrides...]:
    write the lineage weights as the port's step-1 checkpoint (module
    docstring)."""
    from tpu3dsad_torch import train_lib
    from tpu3dsad_torch.config import parse_cli
    from tpu3dsad_torch.train_detector import build_detector

    kv, rest = {}, []
    for a in argv:
        key = a.split("=", 1)[0]
        if key in ("ckpt", "out", "device"):
            kv[key] = a.split("=", 1)[1]
        else:
            rest.append(a)
    if "ckpt" not in kv or "out" not in kv:
        raise SystemExit(main.__doc__)
    cfg = parse_cli(rest)
    if cfg.model.proposal_mode != "lineage":
        cfg = replace(cfg, model=replace(cfg.model, proposal_mode="lineage"))

    sd = load_torch_checkpoint(kv["ckpt"])
    model = build_detector(cfg, device=kv.get("device", "cuda"))
    new_sd, copied, skipped = import_lineage_weights(sd, model.state_dict())
    model.load_state_dict(new_sd)
    optimizer = train_lib.make_optimizer(cfg.train, 100, model.parameters())
    train_lib.save_checkpoint(kv["out"], model, optimizer, step=1)
    report = {"copied": len(copied), "total_source_tensors": len(sd),
              "skipped": skipped, "out": kv["out"]}
    print(json.dumps(report), flush=True)
    if skipped:
        print("ERROR: unported lineage tensors (shape or layout differs "
              "from the configured model): fix the overrides",
              file=sys.stderr)
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
