"""Trainers: the user-facing fit() surface.

Counterpart of ``train/trainer.py`` in the JAX package, which mirrors
the reference's trainer stack (train/base_trainer.py:328 fit,
train/data_parallel_trainer.py:52,314), re-targeted for PyTorch on GPUs:

    trainer = TorchTrainer(
        train_loop_per_worker,
        train_loop_config={...},
        scaling_config=ScalingConfig(num_workers=4, use_gpu=True,
                                     gpus_per_worker=1,
                                     collective_backend="dist"),
        run_config=RunConfig(name="run", storage_path=...),
        datasets={"train": ds},
    )
    result = trainer.fit()

``datasets`` takes anything with ``split(n)`` (one part per worker) or
any other value (every worker gets it whole); the Data library is a
later slice.

Unlike the reference, fit() does NOT detour through the Tune trial runner
(base_trainer.py:354 wraps every trainer as a Tune trainable); the tune/
library composes the other way around (Tuner runs trainers), which keeps the
single-run path dependency-free.

Preemption tolerance (the PR-6 contract): checkpoints reported from the
loop drain through an :class:`~.checkpoint.AsyncCheckpointManager`
(atomic, CRC-manifested, retention-K, optional cloud mirror) on a
background thread; with an :class:`ElasticConfig` a worker/node death
mid-run re-sizes the gang to whatever the surviving cluster can place
(bounded [min_workers, max_workers]), re-partitions chips, re-forms the
collective world, and resumes every rank from the latest DURABLE
checkpoint with per-rank loader state restored; run metadata (latest
checkpoint, step, world size) lives in the GCS kv so
``TorchTrainer(..., resume_from="auto")`` continues an interrupted run even
across head restart (sqlite-backed kv, test_gcs_persistence.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..exceptions import (ActorError, NodeDeadError, TaskError,
                          WorkerCrashedError)
from .backend_executor import (BackendExecutor, ElasticResize,
                               TrainingFailedError, placeable_world_size)
from .checkpoint import AsyncCheckpointManager, Checkpoint


@dataclasses.dataclass
class ScalingConfig:
    """air/config.py ScalingConfig analog: ``use_gpu`` leases
    ``gpus_per_worker`` cards (1 when left at 0) to every worker, as the
    ``GPU`` resource of its bundle; a worker is a process."""

    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: int = 0
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    # cross-worker gradient plane: "objstore" (object-plane collective
    # group) or "dist" (one torch.distributed world spanning all worker
    # processes — NCCL for GPU workers, gloo otherwise; a DeviceMesh over
    # it syncs gradients). "xla" is accepted as an alias of "dist".
    collective_backend: str = "objstore"

    def __post_init__(self):
        from ..collective.types import Backend

        self.collective_backend = Backend.resolve(self.collective_backend)

    def bundle(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1)
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = self.gpus_per_worker or 1
        return res


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0


@dataclasses.dataclass
class ElasticConfig:
    """Bounds for elastic re-sharding: after a worker/node death the gang
    is rebuilt at ``min(max_workers, placeable)`` as long as the cluster
    can still place at least ``min_workers`` bundles; while running below
    ``max_workers`` the executor watches capacity and triggers an upsize
    (ElasticResize — no failure budget consumed) when it grows back.

    ``max_workers=None`` means the ScalingConfig's num_workers. Elastic
    restarts get their own ``max_restarts`` budget when
    FailureConfig.max_failures is 0 (the default would otherwise forbid
    the very restarts elasticity exists for)."""

    min_workers: int = 1
    max_workers: Optional[int] = None
    max_restarts: int = 8
    # how long a failure path polls for min_workers of capacity before
    # giving up (node replacement races this; the watcher handles growth
    # AFTER the rebuild, so this stays short — dip now, recover later)
    settle_s: float = 5.0
    # watcher rate limit: capacity probe at most once per interval
    resize_check_interval_s: float = 2.0


@dataclasses.dataclass
class CheckpointConfig:
    """air CheckpointConfig analog: retention + durability mode.

    ``mode="async"`` (default) returns control to the training loop as
    soon as the shard bytes are snapshotted — the durable write drains on
    a background thread. ``mode="sync"`` blocks the report until durable
    (the bench's comparison baseline). ``storage_uri`` mirrors every
    checkpoint to a CloudStorage tier (s3:// gs:// or any registered
    scheme)."""

    num_to_keep: int = 3
    mode: str = "async"
    storage_uri: Optional[str] = None


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: str = "/tmp/rmt_runs"
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)


@dataclasses.dataclass
class Result:
    """air Result analog: final metrics + checkpoint + full history."""

    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    metrics_history: List[Dict[str, Any]]
    error: Optional[BaseException] = None
    path: Optional[str] = None


def _runtime_or_none():
    from .. import _worker_context

    try:
        return _worker_context.get_runtime()
    except Exception:  # noqa: BLE001 - no cluster: local-only run
        return None


def run_state_key(run_name: str) -> str:
    return f"train/run/{run_name}"


def _cluster_gpus(rt) -> float:
    with rt._lock:
        return sum(nm.resources.total.get("GPU") for nm in rt.nodes.values()
                   if nm.alive)


class TorchTrainer:
    """Data-parallel PyTorch trainer (DataParallelTrainer analog; the JAX
    package's JaxTrainer)."""

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[dict] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        elastic_config: Optional[ElasticConfig] = None,
        resume_from: Optional[str] = None,
    ):
        self.train_loop = train_loop_per_worker
        self.config = train_loop_config
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_checkpoint = resume_from_checkpoint
        self.elastic = elastic_config
        # "auto" → continue this run from its durable state (local run
        # dir, falling back to the GCS-kv-recorded checkpoint URI); any
        # other string → an explicit checkpoint path/URI to start from
        self.resume_from = resume_from

    # -- dataset sharding -----------------------------------------------------
    def _shards(self, n: int) -> Optional[List[Any]]:
        if not self.datasets:
            return None
        shards: List[Dict[str, Any]] = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            if hasattr(ds, "split"):
                parts = ds.split(n)
            else:
                parts = [ds] * n
            for i in range(n):
                shards[i][name] = parts[i]
        return shards

    # -- durable run state ----------------------------------------------------
    def _record_run_state(self, run_name: str,
                          info: Dict[str, Any]) -> None:
        rt = _runtime_or_none()
        if rt is None:
            return
        doc = {"run_name": run_name, "path": info.get("path"),
               "uri": info.get("uri"), "step": info.get("step"),
               "world_size": info.get("world_size")}
        try:
            rt.gcs.kv_put(run_state_key(run_name),
                          json.dumps(doc).encode())
        except Exception:  # noqa: BLE001 - bookkeeping never fails a save
            pass

    def _read_run_state(self, run_name: str) -> Optional[Dict[str, Any]]:
        rt = _runtime_or_none()
        if rt is None:
            return None
        try:
            raw = rt.gcs.kv_get(run_state_key(run_name))
        except Exception:  # noqa: BLE001
            return None
        if not raw:
            return None
        try:
            return json.loads(raw)
        except ValueError:
            return None

    def _resolve_resume(self, manager: AsyncCheckpointManager,
                        run_name: str
                        ) -> Tuple[Optional[Checkpoint], Dict[int, bytes]]:
        """Initial (checkpoint, rank_states) for this run."""
        if self.resume_from is None:
            return self.resume_checkpoint, {}
        if self.resume_from != "auto":
            return Checkpoint.from_uri(self.resume_from), {}
        rec = manager.latest()
        if rec is not None:
            return rec["checkpoint"], dict(rec["rank_states"])
        # no local checkpoints (fresh head / wiped disk): follow the
        # durable run record to the mirrored URI
        meta = self._read_run_state(run_name) or {}
        target = meta.get("uri") or meta.get("path")
        if target:
            try:
                return Checkpoint.from_uri(target), {}
            except (OSError, ValueError):
                pass  # record points at storage that no longer verifies
        return self.resume_checkpoint, {}

    # -- fit ------------------------------------------------------------------
    def fit(self) -> Result:
        """Run the loop on the worker gang to completion. A ``use_gpu``
        trainer on a cluster without a GPU raises: it never trains on the
        CPU instead."""
        from ..core import metrics_defs as mdefs

        rt = _runtime_or_none()
        if self.scaling.use_gpu and rt is not None:
            need, have = self.scaling.bundle()["GPU"], _cluster_gpus(rt)
            if have < need:
                raise RuntimeError(
                    f"use_gpu=True needs {need} GPU(s) per worker, and the "
                    f"cluster has {have}; there is no CPU fallback")
        run_name = self.run_config.name or f"run_{int(time.time())}"
        run_dir = os.path.join(self.run_config.storage_path, run_name)
        os.makedirs(run_dir, exist_ok=True)
        cc = self.run_config.checkpoint_config
        manager = AsyncCheckpointManager(
            run_dir, retain_k=cc.num_to_keep, mode=cc.mode,
            storage_uri=cc.storage_uri,
            on_durable=lambda info: self._record_run_state(run_name, info),
        )

        history: List[Dict[str, Any]] = []
        latest_ckpt, rank_states = self._resolve_resume(manager, run_name)
        latest_holder: List[Optional[Checkpoint]] = [latest_ckpt]
        pending_shards: Dict[int, bytes] = {}

        def on_report(batch: List[dict]) -> None:
            # absorb every non-zero rank's shard first: the executor
            # drains workers in rank order, so a batch can carry rank 0's
            # step-N trigger ahead of rank 1's step-N shard — the save
            # must see the freshest peer shards the batch contains
            for item in batch:
                if item["rank"] != 0 and item.get("checkpoint"):
                    pending_shards[item["rank"]] = item["checkpoint"]
            for item in batch:
                if item["rank"] != 0:
                    continue
                history.append(item["metrics"])
                if item.get("checkpoint"):
                    # rank 0 (the model shard) completes the set and
                    # triggers the durable save; peer shards persist in
                    # pending_shards across saves so every checkpoint
                    # dir carries the newest known loader state per rank
                    pending_shards[0] = item["checkpoint"]
                    step = item["metrics"].get("step", len(history))
                    manager.save(dict(pending_shards), int(step))
                    latest_holder[0] = Checkpoint.from_bytes(
                        item["checkpoint"])

        bundle = self.scaling.bundle()
        desired = self.scaling.num_workers
        elastic = self.elastic
        emin = max(1, elastic.min_workers) if elastic else desired
        emax = (elastic.max_workers or desired) if elastic else desired
        world = max(emin, min(emax, desired))

        fc = self.run_config.failure_config
        failures_left = fc.max_failures
        if elastic and fc.max_failures == 0:
            failures_left = elastic.max_restarts

        if elastic:
            # pin the demand floor so an autoscaler Monitor replaces dead
            # nodes even while no tasks are queued (sdk request_resources)
            try:
                from ..autoscaler import request_resources

                request_resources([dict(bundle)] * min(emax, desired))
            except Exception:  # noqa: BLE001
                pass

        last_probe = [0.0]

        def make_watcher(current_world: int):
            if not elastic or current_world >= emax:
                return None

            def watcher() -> Optional[int]:
                now = time.monotonic()
                if now - last_probe[0] < elastic.resize_check_interval_s:
                    return None
                last_probe[0] = now
                rt = _runtime_or_none()
                if rt is None:
                    return None
                spare = placeable_world_size(
                    bundle, emax - current_world, runtime=rt)
                if spare > 0:
                    return min(emax, current_world + spare)
                return None

            return watcher

        def resume_point() -> None:
            """Refresh (latest_holder, rank_states) from the newest
            DURABLE checkpoint — the restart contract: at most one
            checkpoint interval of progress is lost."""
            nonlocal rank_states
            manager.drain()
            rec = manager.latest()
            if rec is not None:
                latest_holder[0] = rec["checkpoint"]
                rank_states = dict(rec["rank_states"])

        error: Optional[BaseException] = None
        try:
            while True:
                executor = BackendExecutor(
                    world,
                    bundle,
                    self.scaling.placement_strategy,
                    collective_backend=self.scaling.collective_backend,
                )
                try:
                    executor.start()
                    executor.run(
                        self.train_loop, self.config, latest_holder[0],
                        self._shards(world), on_report,
                        rank_states=rank_states,
                        world_watcher=make_watcher(world),
                    )
                    error = None
                    break
                except ElasticResize as e:
                    # capacity grew back: rebuild bigger; NOT a failure
                    executor.shutdown()
                    try:
                        mdefs.train_elastic_resizes().inc(tags={
                            "direction":
                            "up" if e.target_world > world else "down"})
                    except Exception:  # noqa: BLE001
                        pass
                    world = e.target_world
                    resume_point()
                    continue
                except (TrainingFailedError, ActorError, TaskError,
                        WorkerCrashedError, NodeDeadError) as e:
                    # start() can hit a node that is dying but not yet
                    # marked dead (rebuild racing death detection) — the
                    # raw runtime failure joins the same retry path as a
                    # failure surfaced from run()
                    error = (e if isinstance(e, TrainingFailedError)
                             else TrainingFailedError(str(e)))
                    if failures_left <= 0:
                        break
                    failures_left -= 1
                    # release the dead group's leases BEFORE sizing the
                    # rebuild off available capacity
                    executor.shutdown()
                    if elastic:
                        new_world = self._await_capacity(
                            bundle, emin, min(emax, world), elastic)
                        if new_world < emin:
                            break  # cluster can no longer host the run
                        if new_world != world:
                            try:
                                mdefs.train_elastic_resizes().inc(tags={
                                    "direction": "up"
                                    if new_world > world else "down"})
                            except Exception:  # noqa: BLE001
                                pass
                        world = new_world
                    resume_point()
                    continue
                finally:
                    executor.shutdown()
        finally:
            if elastic:
                try:
                    from ..autoscaler import request_resources

                    request_resources([])
                except Exception:  # noqa: BLE001
                    pass
            manager.close()

        return Result(
            metrics=history[-1] if history else {},
            checkpoint=latest_holder[0],
            metrics_history=history,
            error=error,
            path=run_dir,
        )

    @staticmethod
    def _await_capacity(bundle: Dict[str, float], emin: int, cap: int,
                        elastic: ElasticConfig) -> int:
        """Poll briefly for at least ``emin`` placeable bundles after a
        failure (failure detection + autoscaler replacement race this);
        returns the best world ≤ cap seen before the settle deadline —
        dip now, let the watcher grow the gang back later."""
        deadline = time.monotonic() + elastic.settle_s
        best = 0
        while True:
            rt = _runtime_or_none()
            if rt is not None:
                best = placeable_world_size(bundle, cap, runtime=rt)
                if best >= cap:
                    return best
            if time.monotonic() >= deadline:
                return best
            time.sleep(0.2)
