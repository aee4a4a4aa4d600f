"""Lazy execution plan: stages over distributed blocks.

The reference's ExecutionPlan (python/ray/data/_internal/plan.py:69,283)
holds input blocks plus a stage list; one-to-one stages fuse into a single
task per block, all-to-all stages (shuffle/sort/repartition) break fusion.
Same design here: ``OneToOneStage`` carries a block→block function chain
executed by ``_map_block_task`` (tasks) or a ``_BlockMapActor`` pool
(actor compute, reference data/_internal/compute.py:56,146).
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Tuple

from .. import api
from .block import BlockAccessor, BlockMetadata

# (block object ref, metadata) — metadata rides inline, blocks stay remote
BlockRef = Any
BlockList = List[Tuple[BlockRef, BlockMetadata]]


@api.remote
def _map_block_task(fns: List[Callable], block):
    """Apply a fused chain of block transforms; returns (block, metadata).
    Runs remotely: the block arrives via the shm store (zero-copy for
    tensor blocks), the result is written back to the executing node's
    store."""
    t0 = time.time()
    for fn in fns:
        block = fn(block)
    meta = BlockAccessor.for_block(block).get_metadata(
        exec_stats={"wall_s": time.time() - t0})
    return block, meta


class _BlockMapActor:
    """Warm actor applying block transforms (ActorPoolStrategy compute)."""

    def ready(self):
        return "ok"

    def apply(self, fns: List[Callable], block):
        for fn in fns:
            block = fn(block)
        meta = BlockAccessor.for_block(block).get_metadata()
        return block, meta


class ActorPoolStrategy:
    """compute= option for map_batches (reference data/_internal/compute.py:146
    ActorPoolStrategy(min_size, max_size)); ``num_gpus`` leases each
    pool actor that many cards."""

    def __init__(self, size: int = 2, max_size: Optional[int] = None,
                 num_gpus: float = 0, num_cpus: float = 1):
        self.size = size
        self.max_size = max_size or size
        self.num_gpus = num_gpus
        self.num_cpus = num_cpus


class Stage:
    name: str


class OneToOneStage(Stage):
    def __init__(self, name: str, block_fn: Callable[[Any], Any],
                 compute: Any = "tasks"):
        self.name = name
        self.block_fn = block_fn
        self.compute = compute

    def can_fuse_with(self, other: "Stage") -> bool:
        return (isinstance(other, OneToOneStage)
                and self.compute == "tasks" and other.compute == "tasks")


class AllToAllStage(Stage):
    def __init__(self, name: str,
                 fn: Callable[[BlockList], BlockList]):
        self.name = name
        self.fn = fn


class DatasetStats:
    def __init__(self):
        self.stages: List[Tuple[str, float, int]] = []  # name, wall, blocks

    def record(self, name: str, wall: float, num_blocks: int) -> None:
        self.stages.append((name, wall, num_blocks))

    def summary(self) -> str:
        lines = ["Dataset execution stats:"]
        for name, wall, nb in self.stages:
            lines.append(f"  stage {name}: {nb} blocks in {wall:.3f}s")
        return "\n".join(lines)


class ExecutionPlan:
    def __init__(self, blocks: BlockList, stages: Optional[List[Stage]] = None,
                 stats: Optional[DatasetStats] = None):
        self._in_blocks = blocks
        self._stages = list(stages or [])
        self._out_blocks: Optional[BlockList] = None
        self.stats = stats or DatasetStats()

    def with_stage(self, stage: Stage) -> "ExecutionPlan":
        # building on an executed plan chains from its output snapshot
        if self._out_blocks is not None:
            return ExecutionPlan(self._out_blocks, [stage], self.stats)
        return ExecutionPlan(self._in_blocks, self._stages + [stage],
                             self.stats)

    def has_lazy_stages(self) -> bool:
        return bool(self._stages) and self._out_blocks is None

    def execute(self) -> BlockList:
        if self._out_blocks is not None:
            return self._out_blocks
        blocks = self._in_blocks
        i = 0
        while i < len(self._stages):
            stage = self._stages[i]
            t0 = time.time()
            if isinstance(stage, OneToOneStage):
                # fuse the maximal run of fusable one-to-one stages
                fns = [stage.block_fn]
                names = [stage.name]
                while (i + 1 < len(self._stages)
                       and stage.can_fuse_with(self._stages[i + 1])):
                    i += 1
                    stage = self._stages[i]
                    fns.append(stage.block_fn)
                    names.append(stage.name)
                blocks = self._run_one_to_one(fns, blocks, stage.compute)
                self.stats.record("+".join(names), time.time() - t0,
                                  len(blocks))
            else:
                blocks = stage.fn(blocks)
                self.stats.record(stage.name, time.time() - t0, len(blocks))
            i += 1
        self._out_blocks = blocks
        return blocks

    def _run_one_to_one(self, fns: List[Callable], blocks: BlockList,
                        compute: Any) -> BlockList:
        if isinstance(compute, ActorPoolStrategy):
            return self._run_with_actors(fns, blocks, compute)
        out_refs = []
        for ref, _meta in blocks:
            block_ref, meta_ref = _map_block_task.options(
                num_returns=2).remote(fns, ref)
            out_refs.append((block_ref, meta_ref))
        return [(block_ref, api.get(meta_ref))
                for block_ref, meta_ref in out_refs]

    def _run_with_actors(self, fns: List[Callable], blocks: BlockList,
                         strategy: ActorPoolStrategy) -> BlockList:
        """Warm-actor compute: blocks round-robin over the pool; each
        actor's queue executes serially, so N actors process N blocks
        concurrently while results stay in the object store."""
        cls = api.remote(_BlockMapActor)
        opts = {"num_cpus": strategy.num_cpus}
        if strategy.num_gpus:
            opts["num_gpus"] = strategy.num_gpus
        n = min(strategy.size, max(1, len(blocks)))
        actors = [cls.options(**opts).remote() for _ in range(n)]
        api.get([a.ready.remote() for a in actors])
        try:
            out_refs = []
            for j, (ref, _meta) in enumerate(blocks):
                actor = actors[j % n]
                block_ref, meta_ref = actor.apply.options(
                    num_returns=2).remote(fns, ref)
                out_refs.append((block_ref, meta_ref))
            return [(b, api.get(m)) for b, m in out_refs]
        finally:
            for a in actors:
                api.kill(a)
