"""Train library: distributed training over worker-group actors (Ray Train
analog, PyTorch on GPUs; the JAX package's train/)."""

from . import session  # noqa: F401
from .backend_executor import (  # noqa: F401
    BackendExecutor,
    ElasticResize,
    TrainingFailedError,
    placeable_world_size,
)
from .checkpoint import (  # noqa: F401
    AsyncCheckpointManager,
    Checkpoint,
    verify_checkpoint_dir,
)
from .trainer import (  # noqa: F401
    CheckpointConfig,
    ElasticConfig,
    FailureConfig,
    TorchTrainer,
    Result,
    RunConfig,
    ScalingConfig,
)
