"""Object-plane collective backend: rendezvous actor + derived collectives.

Counterpart of ``collective/coordinator.py`` in the JAX package, with
torch tensors where it takes numpy arrays. Ranks meet at a named
coordinator actor — the named-actor rendezvous the reference uses to
share the NCCLUniqueID (nccl_collective_group.py:53-95) — and the data
rides the shared-memory object plane.

The coordinator implements one primitive, ``gather(seq, rank, value)``:
block until all ranks contributed, return the ordered list. Every
collective is derived client-side (allreduce = gather + local reduce;
broadcast = gather + pick root; ...). P2P send/recv uses per-destination
mailboxes. Contributions travel as CPU tensors; each result lands on the
device of the caller's input.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from .types import ReduceOp


class _CoordinatorImpl:
    """Actor class (registered lazily so the decorator binds to the running
    API). async methods: contributions from different ranks interleave on the
    actor's asyncio loop."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._rounds: Dict[int, List[Any]] = {}
        self._events: Dict[int, "asyncio.Event"] = {}
        self._mailboxes: Dict[Tuple[int, int, int], Any] = {}
        self._mail_events: Dict[Tuple[int, int, int], "asyncio.Event"] = {}

    def world(self) -> int:
        return self.world_size

    def _event(self, table, key):
        import asyncio

        ev = table.get(key)
        if ev is None:
            table[key] = ev = asyncio.Event()
        return ev

    async def gather(self, seq: int, rank: int, value) -> List[Any]:
        round_ = self._rounds.setdefault(seq, [None] * self.world_size)
        round_[rank] = (True, value)
        ev = self._event(self._events, seq)
        if all(v is not None for v in round_):
            ev.set()
        else:
            await ev.wait()
        return [v[1] for v in self._rounds[seq]]

    def retire(self, seq: int) -> None:
        """Drop a completed round (called by rank 0 of the NEXT round so slow
        readers of round N are never raced)."""
        self._rounds.pop(seq - self.world_size * 4, None)
        self._events.pop(seq - self.world_size * 4, None)

    async def put_mail(self, seq: int, src: int, dst: int, value) -> None:
        key = (seq, src, dst)
        self._mailboxes[key] = value
        self._event(self._mail_events, key).set()

    async def take_mail(self, seq: int, src: int, dst: int):
        key = (seq, src, dst)
        ev = self._event(self._mail_events, key)
        await ev.wait()
        value = self._mailboxes.pop(key)
        self._mail_events.pop(key, None)
        return value


_REDUCERS = {
    ReduceOp.SUM: lambda stack: stack.sum(dim=0),
    ReduceOp.PRODUCT: lambda stack: stack.prod(dim=0),
    ReduceOp.MIN: lambda stack: stack.amin(dim=0),
    ReduceOp.MAX: lambda stack: stack.amax(dim=0),
}


def _host(value) -> torch.Tensor:
    """A contribution as a CPU tensor (numpy arrays and numbers too)."""
    return torch.as_tensor(value).detach().cpu()


def _reduce(values: List[Any], op: str) -> torch.Tensor:
    return _REDUCERS[op](torch.stack([_host(v) for v in values]))


class ObjstoreGroup:
    """Per-rank handle to an object-plane collective group."""

    def __init__(self, coordinator_handle, world_size: int, rank: int,
                 group_name: str, precision: Optional[str] = None):
        self._coord = coordinator_handle
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        # group-level default for the reduction collectives; a per-call
        # precision= wins, and None defers to config.collective_precision
        self.precision = precision
        # collectives and p2p keep separate sequence spaces: every rank runs
        # the same ordered list of collectives (SPMD discipline), while p2p
        # ordering is per (src, dst) pair
        self._coll_seq = 0
        self._p2p_seq: Dict[Tuple[int, int], int] = {}

    def _next_coll_seq(self) -> int:
        self._coll_seq += 1
        return self._coll_seq

    def _next_p2p_seq(self, src: int, dst: int) -> int:
        key = (src, dst)
        self._p2p_seq[key] = self._p2p_seq.get(key, 0) + 1
        return self._p2p_seq[key]

    def _gather(self, value) -> List[Any]:
        from .. import api

        seq = self._next_coll_seq()
        out = api.get(self._coord.gather.remote(seq, self.rank, value),
                      timeout=120)
        if self.rank == 0:
            self._coord.retire.remote(seq)
        return out

    def _quantized_gather(self, tensor, op_name: str,
                          precision: str) -> List[torch.Tensor]:
        """Quantize this rank's contribution (core/codec.py kernels),
        gather the QUANTIZED payloads through the object plane — the
        wire carries ~2x (bf16) / ~4x (int8) fewer tensor bytes — and
        return every rank's dequantized f32 tensor for full-precision
        accumulation."""
        from ..core import codec

        payload = codec.quantize_array(
            _host(tensor).float().numpy(), precision)
        codec.count_quantized_op(op_name, precision)
        return [torch.from_numpy(codec.dequantize_array(v))
                for v in self._gather(payload)]

    def _resolve(self, precision: Optional[str]) -> str:
        from .types import resolve_precision

        return resolve_precision(precision, self.precision)

    # -- the collective surface (collective.py:258-615 in the reference) ------
    def allreduce(self, tensor, op: str = ReduceOp.SUM,
                  precision: Optional[str] = None):
        p = self._resolve(precision)
        if p != "f32":
            out = _reduce(self._quantized_gather(tensor, "allreduce", p), op)
        else:
            out = _reduce(self._gather(_host(tensor)), op)
        return out.to(_device(tensor))

    def reduce(self, tensor, root_rank: int = 0, op: str = ReduceOp.SUM,
               precision: Optional[str] = None):
        p = self._resolve(precision)
        if p != "f32":
            values = self._quantized_gather(tensor, "reduce", p)
        else:
            values = self._gather(_host(tensor))
        if self.rank == root_rank:
            return _reduce(values, op).to(_device(tensor))
        return torch.as_tensor(tensor)

    def broadcast(self, tensor, root_rank: int = 0):
        values = self._gather(
            _host(tensor) if self.rank == root_rank else None
        )
        return _host(values[root_rank]).to(_device(tensor))

    def allgather(self, tensor) -> List[torch.Tensor]:
        device = _device(tensor)
        return [_host(v).to(device) for v in self._gather(_host(tensor))]

    def reducescatter(self, tensor, op: str = ReduceOp.SUM,
                      precision: Optional[str] = None):
        p = self._resolve(precision)
        if p != "f32":
            reduced = _reduce(
                self._quantized_gather(tensor, "reducescatter", p), op)
        else:
            reduced = _reduce(self._gather(_host(tensor)), op)
        chunks = torch.tensor_split(reduced, self.world_size, dim=0)
        return chunks[self.rank].to(_device(tensor))

    def barrier(self):
        self._gather(None)

    def send(self, tensor, dst_rank: int):
        from .. import api

        seq = self._next_p2p_seq(self.rank, dst_rank)
        api.get(self._coord.put_mail.remote(
            seq, self.rank, dst_rank, _host(tensor)), timeout=120)

    def recv(self, src_rank: int):
        from .. import api

        seq = self._next_p2p_seq(src_rank, self.rank)
        return _host(api.get(
            self._coord.take_mail.remote(seq, src_rank, self.rank),
            timeout=120,
        ))


def _device(value) -> torch.device:
    return value.device if isinstance(value, torch.Tensor) \
        else torch.device("cpu")


def create_coordinator(group_name: str, world_size: int):
    """Create (or fetch) the named coordinator actor for a group; racing
    creators fall back to lookup (the reference's rank-0-creates /
    others-poll rendezvous, nccl_collective_group.py:53-95). A coordinator
    left over from a same-named group must match world_size — call
    destroy_collective_group() first to re-form a group with a different
    world (the reference has the same reuse rule for named NCCL groups)."""
    from .. import api

    name = f"__rmt_collective_{group_name}"

    def checked(handle):
        existing = api.get(handle.world.remote(), timeout=60)
        if existing != world_size:
            raise ValueError(
                f"collective group {group_name!r} already exists with "
                f"world_size={existing} (wanted {world_size}); call "
                f"destroy_collective_group({group_name!r}) first"
            )
        return handle

    try:
        return checked(api.get_actor(name))
    except ValueError as e:
        if "world_size" in str(e):
            raise
    actor_cls = api.remote(_CoordinatorImpl)
    try:
        return actor_cls.options(
            name=name, max_concurrency=max(world_size * 2, 8)
        ).remote(world_size)
    except ValueError:
        return checked(api.get_actor(name))  # lost the creation race


def destroy_coordinator(group_name: str) -> None:
    """Kill the named coordinator so the next group formation starts fresh
    (prevents stale rounds from leaking across re-inits)."""
    from .. import api

    try:
        handle = api.get_actor(f"__rmt_collective_{group_name}")
    except ValueError:
        return
    api.kill(handle)
