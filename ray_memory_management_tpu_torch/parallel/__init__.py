"""Parallelism strategy library: DeviceMeshes + sharding presets
(DP/FSDP/TP over DTensor; EP/SP over plain tensors). Counterpart of
``parallel/`` in the JAX package; pipeline parallelism (``pipeline.py``)
is a later slice."""

from .mesh import cpu_mesh, local_gpu_mesh, make_mesh  # noqa: F401
from .sharding import (  # noqa: F401
    batch_pspec,
    load_optimizer_state,
    make_train_step,
    param_pspecs,
    param_specs,
    shard_pytree,
)
