"""Weight bridge: flax variables -> the port's state_dict.

The inverse direction of tpu3dsad/utils/import_torch.py. The port's modules
carry the flax module names (backbone.sa1.mlp_0.dense_0, voting.bn_1,
proposal.head_out, ...), so a leaf at flax path
`params/a/b/leaf` lands at torch key `a.b.<name>`:

  params       Dense kernel [in, out] -> weight [out, in]   (transposed)
  params       Dense bias / BN bias   -> bias
  params       BN scale               -> weight
  batch_stats  mean / var             -> running_mean / running_var

A leaf with no torch key, a key no leaf filled, or a shape mismatch raises.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_RENAME = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _leaves(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), v


def state_dict_from_flax(variables: Mapping,
                         template: Mapping[str, torch.Tensor]) -> dict:
    """variables: {'params': ..., 'batch_stats': ...} (numpy or jax leaves);
    template: the target module's state_dict, for keys, shapes, dtype and
    device. Returns a complete state_dict."""
    out = {}
    for col in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(col, {})):
            name = _RENAME.get((col, path[-1]))
            key = ".".join(path[:-1] + (name,)) if name else None
            if key not in template:
                raise KeyError(f"flax leaf {col}/{'/'.join(path)} has no "
                               "counterpart in the torch module")
            if key in out:
                raise KeyError(f"torch key {key} filled twice")
            value = np.array(leaf, np.float32)  # a writable copy
            if path[-1] == "kernel":
                value = value.T
            ref = template[key]
            if tuple(value.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: flax {value.shape} vs torch "
                                 f"{tuple(ref.shape)}")
            out[key] = torch.as_tensor(np.ascontiguousarray(value)).to(
                device=ref.device, dtype=ref.dtype)
    missing = sorted(set(template) - set(out))
    if missing:
        raise KeyError(f"torch keys not filled from flax: {missing}")
    return out


def load_flax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Copy flax variables into `model` in place (strict)."""
    model.load_state_dict(state_dict_from_flax(variables, model.state_dict()))
