"""tpu3dsad_torch — the PyTorch / CUDA port of tpu3dsad for NVIDIA Hopper.

A second package beside the JAX reference `tpu3dsad`, with the same module
names so each counterpart is easy to find. It imports `torch` and never
`jax`, `flax` or any module of `tpu3dsad`; its config dataclasses mirror
the reference's (`config.py`).

Layout: channels-last [B, N, C] tensors with static padded shapes and masks,
as in the reference. Plain tensor code is PyTorch; the point kernels of the
inference and training paths (FPS, exact ball query, and the row
scatter-add that is the gather/group backward) are hand-written CUDA C++
for sm_90a under `csrc/`, built with nvcc at first use
(`ops/cuda/build.py`). CPU tensors take the kernels' plain PyTorch
versions.

fp32 distance math is part of the contract, so TF32 is switched off for
matmuls and cuDNN when this package is imported. A training run with
train.bf16_matmul lets the MLP products run as TF32 on the card
(`train_lib.apply_runtime_config`); the distance products stay fp32 there
too (`ops/plain/knn.py`).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
