"""Train session: the API surface visible inside a user's train loop.

Mirrors the reference's air.session (python/ray/air/session.py:12,64,221 —
report / get_checkpoint / get_world_rank / get_world_size /
get_dataset_shard) backed by the per-worker _TrainSession queue
(train/_internal/session.py:54,144,261): ``report`` enqueues results that the
driver-side BackendExecutor drains between rounds.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Optional

from .checkpoint import Checkpoint


class _TrainSession:
    def __init__(self, world_rank: int, world_size: int,
                 checkpoint: Optional[Checkpoint], dataset_shard=None,
                 trial_info: Optional[dict] = None,
                 rank_state: Optional[Dict[str, Any]] = None):
        self.world_rank = world_rank
        self.world_size = world_size
        self.queue: "queue.Queue" = queue.Queue()
        self.loaded_checkpoint = checkpoint
        self.dataset_shard = dataset_shard
        self.trial_info = trial_info or {}
        # per-rank loader state (step, rng, dataset offset) restored from
        # the sharded checkpoint on elastic resume — see get_rank_state()
        self.loaded_rank_state = rank_state
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None


_session: Optional[_TrainSession] = None
_lock = threading.Lock()


def init_session(**kwargs) -> _TrainSession:
    global _session
    with _lock:
        _session = _TrainSession(**kwargs)
        return _session


def get_session() -> _TrainSession:
    if _session is None:
        raise RuntimeError(
            "no train session: this API is only valid inside a train loop"
        )
    return _session


def shutdown_session() -> None:
    global _session
    with _lock:
        _session = None


# -- public api (air/session.py surface) --------------------------------------
def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Stream metrics (and optionally a checkpoint) to the driver."""
    s = get_session()
    s.queue.put({"metrics": dict(metrics), "checkpoint": checkpoint,
                 "rank": s.world_rank})


def get_checkpoint() -> Optional[Checkpoint]:
    return get_session().loaded_checkpoint


def get_rank_state() -> Optional[Dict[str, Any]]:
    """This rank's data-loader state (step, rng, dataset offset, ...) as
    restored from the latest sharded checkpoint, or None on a fresh start.
    The loop saves it by passing its state dict to ``report(...,
    checkpoint=...)`` on every rank — rank 0's checkpoint is the model,
    every other rank's dict rides the same durable save as a shard.

    After an ELASTIC resize the world size may differ from the one that
    wrote the state: ranks beyond the old world get None, and the loop
    re-derives its shard offsets from (step, world_size)."""
    return get_session().loaded_rank_state


def get_loader_state() -> Optional[Dict[str, Any]]:
    """Alias for :func:`get_rank_state`."""
    return get_rank_state()


def get_world_rank() -> int:
    return get_session().world_rank


def get_world_size() -> int:
    return get_session().world_size


def get_local_rank() -> int:
    return get_session().world_rank  # one worker per host-process


def get_dataset_shard(name: str = "train"):
    shard = get_session().dataset_shard
    if isinstance(shard, dict):
        return shard.get(name)
    return shard


def get_collective_group_name() -> str:
    """Name of the cross-worker collective group the BackendExecutor formed
    (usable with collective.allreduce etc. — the process-group handle of
    train/torch/config.py:54 in the reference)."""
    import os

    return os.environ.get("RMT_TRAIN_GROUP", "default")


def get_trial_name() -> str:
    return get_session().trial_info.get("name", "default")


def get_trial_id() -> str:
    return get_session().trial_info.get("id", "default")
