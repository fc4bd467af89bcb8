"""Parallelism over torch.distributed (tpu3dsad/parallel): a named mesh of
ranks, batch layouts over it, point-axis sharded ops, and the collectives
they use.

Data parallelism (DP) splits the batch over the mesh axis 'data': every
rank holds the whole model, runs its rows, and the step keeps the global
semantics of the reference's one SPMD program (BatchNorm statistics and
the losses' denominators over the data group, gradients summed over it;
train_lib). Context parallelism (CP) splits the point axis of one cloud
over the axis 'points' (point_sharded.py); a 2-D mesh ('data', 'points')
runs both. One process a rank: `launch.init_from_env` under torchrun,
`launch.spawn` for ranks started here.
"""

from tpu3dsad_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)

__all__ = ["make_mesh", "batch_sharding", "replicated", "shard_batch"]
