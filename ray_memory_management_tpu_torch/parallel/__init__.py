"""Parallelism strategy library: DeviceMeshes + sharding presets
(DP/FSDP/TP over DTensor; EP/SP/PP over plain tensors). Counterpart of
``parallel/`` in the JAX package."""

from .mesh import cpu_mesh, local_gpu_mesh, make_mesh  # noqa: F401
from .pipeline import (  # noqa: F401
    pipeline_blocks,
    pipeline_forward,
    pipeline_loss_fn,
    pipeline_schedule,
    stacked_param_pspecs,
)
from .sharding import (  # noqa: F401
    batch_pspec,
    load_optimizer_state,
    make_train_step,
    param_pspecs,
    param_specs,
    shard_pytree,
)
