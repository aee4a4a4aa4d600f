"""BackendExecutor + WorkerGroup: driver-side machinery behind a Trainer.

Counterpart of ``train/backend_executor.py`` in the JAX package, which
mirrors the reference's train/_internal/backend_executor.py:42 and
worker_group.py:91 — create a placement group for the gang (:137), start one
actor per worker (:178,335), run the backend's on_start hook (:127) (here:
the objstore collective group, or the ``dist`` world — the
_setup_torch_process_group of train/torch/config.py:54), ship the user
loop (:275,356-360), and drain per-worker result queues
(train/_internal/session.py:144 → get_next_results, backend_executor.py:362).

GPU mapping: each TrainWorker is an actor; ``gpus_per_worker`` cards are
leased to it (``CUDA_VISIBLE_DEVICES`` names them), and inside the loop
the user builds a DeviceMesh over the ``dist`` world with
parallel.make_mesh. With ``collective_backend="dist"`` every worker joins
one ``torch.distributed`` world (NCCL when it holds a GPU lease, gloo
otherwise), so gradients sync through NCCL collectives; with
``objstore`` data parallelism ACROSS workers rides the collective group
exposed via ``session.get_collective_group_name``.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from .. import api
from ..collective.types import Backend
from ..exceptions import (ActorError, NodeDeadError, RmtError, TaskError,
                          WorkerCrashedError)
from .checkpoint import Checkpoint


class TrainingFailedError(RmtError):
    pass


class ElasticResize(RmtError):
    """Raised out of BackendExecutor.run when the elastic world watcher
    wants a DIFFERENT world size (capacity grew back after a downsize).
    Not a failure: the trainer rebuilds the group at ``target_world`` and
    resumes from the latest checkpoint without consuming failure budget."""

    def __init__(self, target_world: int):
        super().__init__(f"elastic resize to world={target_world}")
        self.target_world = target_world


def placeable_world_size(bundle: Dict[str, Any], cap: int,
                         runtime=None) -> int:
    """How many copies of ``bundle`` the cluster can place RIGHT NOW
    (greedy first-fit over alive nodes' available resources), capped at
    ``cap``. This is the elastic trainer's sizing signal after a node
    death — rebuild the gang at whatever the surviving nodes can hold —
    and its recovery signal once the autoscaler replaces the node."""
    from .. import _worker_context
    from ..core.resources import Resources

    rt = runtime or _worker_context.get_runtime()
    req = Resources(dict(bundle) or {"CPU": 1})
    with rt._lock:
        nodes = [nm for nm in rt.nodes.values() if nm.alive]
        frees = [Resources.from_fixed(nm.resources.available.fixed())
                 for nm in nodes]
    count = 0
    while count < cap:
        for i, free in enumerate(frees):
            if req.fits_in(free):
                frees[i] = free - req
                count += 1
                break
        else:
            break
    return count


def partition_chips_for_host(devices: List[str], n_workers: int,
                             exclude: Optional[set] = None) -> List[str]:
    """Split a node's GPUs into ``n_workers`` DISJOINT contiguous slices
    covering every available one (sizes differ by at most one when the
    count does not divide evenly). ``devices`` are the node's device
    NAMES as its ``CUDA_VISIBLE_DEVICES`` gives them
    (``node_manager.visible_devices``), so a node on cards "5,2" hands
    out "5" and "2" — never the raw indices "0" and "1" that the JAX
    package partitions (its ``range(n_chips)``), which would put a
    worker on a card the node was not given. Each worker of a ``dist``
    world owns its slice outright: NCCL refuses two ranks on one device.
    ``exclude`` removes names already leased to sibling workers through
    the scheduler."""
    chips = [str(c) for c in devices
             if not exclude or str(c) not in exclude]
    if n_workers > len(chips):
        raise TrainingFailedError(
            f"{n_workers} dist-mode workers share a node with only "
            f"{len(chips)} free GPUs; use at most one worker per GPU "
            "(or one worker per node controlling all its GPUs)")
    base, extra = divmod(len(chips), n_workers)
    out, pos = [], 0
    for i in range(n_workers):
        take = base + (1 if i < extra else 0)
        out.append(",".join(str(c) for c in chips[pos:pos + take]))
        pos += take
    return out


def node_gpu_names() -> Dict[str, List[str]]:
    """{node id hex: the node's GPU device names} for every alive node,
    read from the runtime's node table: the names a local node's
    ``CUDA_VISIBLE_DEVICES`` gives (``node_manager.visible_devices``) and
    those an agent node reported when it registered."""
    from .. import _worker_context

    rt = _worker_context.get_runtime()
    with rt._lock:
        return {nid.hex(): list(nm.gpu_names)
                for nid, nm in rt.nodes.items() if nm.alive}


class _TrainWorkerImpl:
    """The per-worker actor (RayTrainWorker analog, worker_group.py:335)."""

    def __init__(self, rank: int, world_size: int, group_name: str):
        import os

        self.rank = rank
        self.world_size = world_size
        self.group_name = group_name
        os.environ["RMT_TRAIN_RANK"] = str(rank)
        os.environ["RMT_TRAIN_WORLD"] = str(world_size)
        os.environ["RMT_TRAIN_GROUP"] = group_name

    def _rmt_init_collective(self, world_size, rank, backend, group_name):
        from ..collective import init_collective_group

        init_collective_group(world_size, rank, backend, group_name)
        return True

    def _rmt_host_info(self) -> dict:
        """Where this worker runs and what chips it already leased — the
        input to the head's per-host chip partitioning."""
        import os

        return {
            "node_id": os.environ.get("RMT_NODE_ID", ""),
            # None in an unleased worker, which the pool starts with ""
            "visible_chips": os.environ.get("CUDA_VISIBLE_DEVICES") or None,
        }

    def _rmt_set_visible_chips(self, chips_csv: str) -> bool:
        """Pin this worker to a disjoint GPU subset BEFORE CUDA initializes
        (the reference's _share_cuda_visible_devices,
        train/backend_executor.py:195 + torch/config.py:108-156 — except
        that dist-mode ranks must own DISJOINT cards, so the head
        partitions rather than shares). CUDA reads the variable once, when
        it initializes: a worker whose CUDA is live raises."""
        import os
        import sys

        torch_mod = sys.modules.get("torch")
        if torch_mod is not None and torch_mod.cuda.is_initialized():
            raise RuntimeError(
                "CUDA is already initialized in this worker; its visible "
                "devices can no longer change (dist mode needs a fresh "
                "process)")
        os.environ["CUDA_VISIBLE_DEVICES"] = chips_csv
        return True

    def _rmt_pick_coordinator(self) -> str:
        """Rank-0 hook: choose the dist world's rendezvous address on THIS
        worker's host (the reference's rank-0 addr/port selection for
        torch process groups, train/torch/config.py:108-156). The host is
        ``RMT_NODE_IP`` when set, else 127.0.0.1 (every worker on one
        host); nothing outside the machine is probed."""
        from ..collective.collective import pick_address

        return pick_address()

    def _rmt_init_torch_world(self, coordinator: str, world: int,
                              rank: int) -> int:
        """Join the ``dist`` world of the worker processes:
        ``init_process_group`` at rank 0's ``coordinator`` address
        (the _setup_torch_process_group analog,
        train/torch/config.py:54), NCCL when this worker holds a GPU
        lease and gloo otherwise; a failing NCCL init raises, with no
        gloo fallback. Returns the world size the group reports."""
        import torch.distributed as dist

        from ..collective.collective import init_dist_world

        init_dist_world(world, rank, f"tcp://{coordinator}")
        return dist.get_world_size()

    def run_loop(self, loop_blob: bytes, config: Optional[dict],
                 checkpoint_blob: Optional[bytes], dataset_shard,
                 rank_state_blob: Optional[bytes] = None) -> bool:
        """Execute the user's train_loop_per_worker to completion. Runs on
        one actor thread while next_results() is served on another
        (max_concurrency=2 — the reference pairs a train thread with the
        session queue the same way)."""
        import pickle

        import cloudpickle

        from . import session as session_mod

        rank_state = (pickle.loads(rank_state_blob)
                      if rank_state_blob else None)
        # init the session before anything that can fail or block, so a
        # concurrent next_results() poll never mistakes "not started yet"
        # for "finished" (it reports None only after s.finished is set)
        s = session_mod.init_session(
            world_rank=self.rank, world_size=self.world_size,
            checkpoint=None, dataset_shard=dataset_shard,
            rank_state=rank_state,
        )
        try:
            loop = cloudpickle.loads(loop_blob)
            s.loaded_checkpoint = (
                Checkpoint.from_bytes(checkpoint_blob)
                if checkpoint_blob else None
            )
            if config is not None:
                loop(config)
            else:
                loop()
            return True
        except BaseException as e:
            s.error = e
            raise
        finally:
            s.finished.set()

    def next_results(self, timeout_s: float = 1.0) -> Optional[List[dict]]:
        """Drain queued session.report() payloads; None once the loop has
        finished and the queue is empty. Checkpoints travel as bytes."""
        import queue as queue_mod

        from . import session as session_mod

        try:
            s = session_mod.get_session()
        except RuntimeError:
            return []  # run_loop hasn't started yet — poll again
        out: List[dict] = []
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                item = s.queue.get(timeout=max(0.0, deadline -
                                               time.monotonic()))
            except queue_mod.Empty:
                break
            ckpt = item.get("checkpoint")
            item["checkpoint"] = ckpt.to_bytes() if ckpt else None
            out.append(item)
            if not s.queue.empty():
                continue
            break
        if not out and s.finished.is_set() and s.queue.empty():
            return None
        return out


class WorkerGroup:
    def __init__(self, num_workers: int, resources_per_worker: Dict[str, Any],
                 placement_strategy: str = "PACK"):
        from ..core.placement_group import placement_group

        self.num_workers = num_workers
        self.group_name = f"train_{uuid.uuid4().hex[:8]}"
        bundle = dict(resources_per_worker) or {"CPU": 1}
        self.pg = placement_group([bundle] * num_workers,
                                  strategy=placement_strategy)
        if not self.pg.wait(60):
            raise TrainingFailedError(
                f"placement group for {num_workers} workers "
                f"({bundle} each) could not be scheduled"
            )
        cls = api.remote(_TrainWorkerImpl)
        self.actors = []
        for rank in range(num_workers):
            self.actors.append(
                cls.options(
                    max_concurrency=2,
                    num_cpus=resources_per_worker.get("CPU", 1),
                    num_gpus=resources_per_worker.get("GPU", 0),
                    placement_group=self.pg,
                    placement_group_bundle_index=rank,
                ).remote(rank, num_workers, self.group_name)
            )

    def setup_collective(self) -> None:
        from ..collective import create_collective_group

        create_collective_group(
            self.actors, self.num_workers, list(range(self.num_workers)),
            backend="objstore", group_name=self.group_name,
        )

    def partition_chips(self) -> None:
        """Give dist-mode workers sharing a node DISJOINT
        CUDA_VISIBLE_DEVICES.

        Workers that leased GPUs through the scheduler (num_gpus>0)
        already hold disjoint sets; this covers the bare-CPU-request case
        where two workers on one GPU node would otherwise both see every
        card (reference analog _share_cuda_visible_devices,
        train/backend_executor.py:195). The node's GPU names come from the
        runtime's own node table (the state API is not ported yet)."""
        infos = api.get([a._rmt_host_info.remote() for a in self.actors],
                        timeout=120)
        names = node_gpu_names()
        by_node: Dict[str, List[int]] = {}
        for rank, info in enumerate(infos):
            by_node.setdefault(info["node_id"], []).append(rank)
        calls = []
        for node_id, ranks in by_node.items():
            devices = names.get(node_id, [])
            if not devices:
                continue  # CPU-only node: nothing to partition
            # workers whose scheduler lease already pinned GPUs keep
            # them; the UNLEASED siblings must still be fenced off those
            # cards, or each of them sees the whole node
            leased_chips: set = set()
            unleased: List[int] = []
            for r in ranks:
                csv = infos[r]["visible_chips"]
                if csv:
                    leased_chips.update(c.strip() for c in csv.split(","))
                else:
                    unleased.append(r)
            if not unleased:
                continue
            slices = partition_chips_for_host(devices, len(unleased),
                                              exclude=leased_chips)
            for csv, rank in zip(slices, sorted(unleased)):
                calls.append(
                    self.actors[rank]._rmt_set_visible_chips.remote(csv))
        if calls:
            api.get(calls, timeout=120)

    def setup_dist_world(self) -> int:
        """Cross-worker dist mode: every worker process joins one
        ``torch.distributed`` world, so the user loop builds ONE
        DeviceMesh over all of them — gradients sync through NCCL (gloo on
        CPU workers), never the object plane. Returns the world size."""
        self.partition_chips()
        coordinator = api.get(
            self.actors[0]._rmt_pick_coordinator.remote(), timeout=120)
        counts = api.get(
            [a._rmt_init_torch_world.remote(coordinator, self.num_workers,
                                            r)
             for r, a in enumerate(self.actors)],
            timeout=300,
        )
        if len(set(counts)) != 1 or counts[0] != self.num_workers:
            raise TrainingFailedError(
                f"workers disagree on the world size: {counts}")
        return counts[0]

    def shutdown(self) -> None:
        from ..core.placement_group import remove_placement_group

        for a in self.actors:
            try:
                api.kill(a)
            except Exception:
                pass
        try:
            from ..collective.coordinator import destroy_coordinator

            destroy_coordinator(self.group_name)
        except Exception:
            pass
        remove_placement_group(self.pg)


class BackendExecutor:
    def __init__(self, num_workers: int,
                 resources_per_worker: Optional[Dict[str, Any]] = None,
                 placement_strategy: str = "PACK",
                 use_collective: bool = True,
                 collective_backend: str = "objstore"):
        self.num_workers = num_workers
        self.resources_per_worker = resources_per_worker or {"CPU": 1}
        self.placement_strategy = placement_strategy
        # a dist world forms at every size (a DeviceMesh needs a process
        # group even for one rank); the objstore group only for several
        self.collective_backend = Backend.resolve(collective_backend)
        self.use_collective = use_collective and (
            num_workers > 1 or self.collective_backend == Backend.DIST)
        self.group: Optional[WorkerGroup] = None

    def start(self) -> None:
        self.group = WorkerGroup(
            self.num_workers, self.resources_per_worker,
            self.placement_strategy,
        )
        if self.use_collective:
            if self.collective_backend == Backend.DIST:
                self.group.setup_dist_world()
            else:
                self.group.setup_collective()

    def run(
        self,
        train_loop: Callable,
        config: Optional[dict],
        checkpoint: Optional[Checkpoint],
        dataset_shards: Optional[List[Any]] = None,
        on_report: Optional[Callable[[List[dict]], None]] = None,
        poll_interval_s: float = 0.2,
        rank_states: Optional[Dict[int, bytes]] = None,
        world_watcher: Optional[Callable[[], Optional[int]]] = None,
    ) -> None:
        """Ship the loop to every worker and drain reports until all loops
        complete. Raises TrainingFailedError on worker failure (a dead
        worker, actor, or NODE — the PR-3 agent-death plumbing surfaces
        all three as errors on the polled refs) and ElasticResize when
        ``world_watcher`` returns a different target world size.

        ``rank_states`` hands each rank its restored loader-state shard
        (session.get_rank_state()); ranks absent from the dict start
        fresh."""
        from ..serialization import dumps_function

        assert self.group is not None, "call start() first"
        loop_blob = dumps_function(train_loop)
        ckpt_blob = checkpoint.to_bytes() if checkpoint else None
        shards = dataset_shards or [None] * self.num_workers
        states = rank_states or {}
        done_refs = [
            a.run_loop.remote(loop_blob, config, ckpt_blob, shards[i],
                              states.get(i))
            for i, a in enumerate(self.group.actors)
        ]
        live = set(range(self.num_workers))
        batches: List[dict] = []

        def flush() -> None:
            # deliver everything collected this round before any error can
            # propagate — a healthy worker's checkpoint must not be lost
            # because a peer died mid-round
            if batches and on_report is not None:
                on_report(list(batches))
            batches.clear()

        try:
            while live:
                if world_watcher is not None:
                    target = world_watcher()
                    if target is not None and target != self.num_workers:
                        flush()
                        raise ElasticResize(target)
                refs = [
                    (i, self.group.actors[i].next_results.remote(0.5))
                    for i in sorted(live)
                ]
                for i, ref in refs:
                    res = api.get(ref, timeout=120)
                    if res is None:
                        live.discard(i)
                    elif res:
                        batches.extend(res)
                    else:
                        # empty batch: either the loop hasn't started or it
                        # died before init_session (e.g. a shard failed to
                        # deserialize). If run_loop already finished, a final
                        # drain is safe and prevents polling forever.
                        ready, _ = api.wait([done_refs[i]], timeout=0)
                        if ready:
                            api.get(done_refs[i])  # surfaces loop errors
                            final = api.get(
                                self.group.actors[i].next_results.remote(0.0),
                                timeout=120,
                            )
                            if final:
                                batches.extend(final)
                            live.discard(i)
                flush()
                if live:
                    time.sleep(poll_interval_s)
            # surface loop errors (worker finished exceptionally)
            api.get(done_refs, timeout=60)
        except (ActorError, TaskError, WorkerCrashedError,
                NodeDeadError) as e:
            flush()
            raise TrainingFailedError(str(e)) from e

    def shutdown(self) -> None:
        if self.group is not None:
            self.group.shutdown()
            self.group = None
