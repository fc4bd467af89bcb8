"""tpu3dsad_torch — the PyTorch / CUDA port of tpu3dsad for NVIDIA Hopper.

A second package beside the JAX reference `tpu3dsad`, with the same module
names so each counterpart is easy to find. It imports `torch` and never
`jax`, `flax` or any module of `tpu3dsad`; its config dataclasses mirror
the reference's (`config.py`).

Layout: channels-last [B, N, C] tensors with static padded shapes and masks,
as in the reference. Plain tensor code is PyTorch; the two point kernels on
the whole-scene inference path (FPS and exact ball query) are hand-written
CUDA C++ for sm_90a under `csrc/`, built with nvcc at first use
(`ops/cuda/build.py`). CPU tensors take the kernels' plain PyTorch versions.

fp32 distance math is part of the contract, so TF32 is switched off for
matmuls and cuDNN when this package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
