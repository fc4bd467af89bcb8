"""Host constants (class mean sizes, the radius bank, box-corner signs) as
device tensors, copied to each device once.

A copy from pageable host memory makes the host wait for the stream, which
a CUDA-graph capture refuses, so a train step that is captured
(train_lib.make_detector_train_block) must find its constants on the card
already: the eager steps before the capture put them there. The tensors
are shared by every caller and must not be written.

The cache outlives the call that fills it, so each constant is made as a
plain tensor whatever the caller runs under: outside inference mode (an
inference tensor cannot be saved for a later backward) and outside any
tracing or fake-tensor mode (torch.export's trace would leave a fake
tensor behind; a real one enters the exported program as a constant).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes


@functools.lru_cache(maxsize=64)
def _constant(data: bytes, shape: tuple, dtype: str,
              device: torch.device) -> torch.Tensor:
    host = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
    with torch.inference_mode(False), _disable_current_modes():
        return torch.from_numpy(host.copy()).to(device)


def device_constant(values, device, dtype=np.float32) -> torch.Tensor:
    """`values` as a read-only tensor of `dtype` on `device`, one copy per
    distinct (values, dtype, device)."""
    a = np.ascontiguousarray(values, dtype)
    return _constant(a.tobytes(), a.shape, a.dtype.str, torch.device(device))
