"""Public collective API.

Counterpart of ``collective/collective.py`` in the JAX package, which
mirrors python/ray/util/collective/collective.py — the full surface:
init_collective_group(:120), create_collective_group(:151), declare/destroy,
get_rank, get_collective_group_size, allreduce(:258), barrier(:298),
reduce(:311), broadcast(:373), allgather(:423), reducescatter(:472),
send(:531)/recv(:594). The port's backends (types.py):

  - ``dist``: ``torch.distributed`` collectives of this process as one
    rank of a process group (mesh_group.py) — NCCL in a worker that
    holds a GPU lease, gloo otherwise. ``init_collective_group`` forms
    the process group (``init_process_group`` over a ``tcp://``
    rendezvous) or joins the one this process already has.
  - ``objstore``: cross-actor collectives through the object plane with a
    named-actor rendezvous (coordinator.py), callable from any rank actor.

A GroupManager keyed by group name tracks membership per process, like the
reference's _group_mgr (collective.py:40).
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Any, Dict, List, Optional

from .types import Backend, ReduceOp


class _GroupManager:
    def __init__(self):
        self._groups: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def put(self, name: str, group) -> None:
        with self._lock:
            self._groups[name] = group

    def get(self, name: str):
        with self._lock:
            group = self._groups.get(name)
        if group is None:
            raise ValueError(
                f"collective group {name!r} is not initialized in this "
                f"process; call init_collective_group() first"
            )
        return group

    def pop(self, name: str):
        with self._lock:
            return self._groups.pop(name, None)


_group_mgr = _GroupManager()


def holds_gpu_lease() -> bool:
    """True in a process whose ``CUDA_VISIBLE_DEVICES`` names a device: a
    worker that holds a GPU lease (the pool starts workers with ``""``),
    or a process pinned to cards by its caller. Read from the variable
    only, so asking never initializes CUDA."""
    return bool((os.environ.get("CUDA_VISIBLE_DEVICES") or "").strip())


def pick_address() -> str:
    """``host:port`` for a rendezvous on this host: a free TCP port, and
    the host named by ``RMT_NODE_IP`` (a host reachable from the other
    ranks' hosts), else 127.0.0.1, which serves every rank on one host.
    Nothing is probed: the choice never leaves the machine."""
    s = socket.socket()
    try:
        s.bind(("0.0.0.0", 0))
        port = s.getsockname()[1]
    finally:
        s.close()
    host = os.environ.get("RMT_NODE_IP") or "127.0.0.1"
    return f"{host}:{port}"


def init_dist_world(world_size: int, rank: int, init_method: str,
                    device: Optional[str] = None) -> str:
    """``torch.distributed.init_process_group`` for one rank of a
    ``world_size`` world at ``init_method`` (``tcp://host:port``).
    ``device`` "cuda" takes NCCL and "cpu" gloo; None decides by the GPU
    lease (:func:`holds_gpu_lease`). A CUDA world without a card raises,
    and a failing NCCL init raises: neither falls back to gloo. Returns
    the backend's name."""
    import torch
    import torch.distributed as dist

    if device is None:
        device = "cuda" if holds_gpu_lease() else "cpu"
    if device not in ("cuda", "cpu"):
        raise ValueError(f"dist world device must be 'cuda' or 'cpu', "
                         f"got {device!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dist world on 'cuda' requested but no CUDA device is "
                "available (NCCL needs a card; there is no gloo fallback)")
        torch.cuda.set_device(torch.cuda.current_device())
    backend = "nccl" if device == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return backend


def _rendezvous(group_name: str, world_size: int, rank: int) -> str:
    """Rank 0's ``tcp://`` address, shared through the group's named
    coordinator actor (the reference's NCCLUniqueID rendezvous)."""
    if world_size == 1:
        return f"tcp://{pick_address()}"
    from .coordinator import ObjstoreGroup, create_coordinator

    coord = create_coordinator(group_name, world_size)
    meet = ObjstoreGroup(coord, world_size, rank, group_name)
    addrs = meet._gather(f"tcp://{pick_address()}" if rank == 0 else None)
    return addrs[0]


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = Backend.DIST,
    group_name: str = "default",
    device: Optional[str] = None,
    precision: Optional[str] = None,
    init_method: Optional[str] = None,
):
    """Join (rank) this process/actor into a collective group
    (reference :120).

    ``backend="dist"`` joins this process's ``torch.distributed`` world,
    or forms it when there is none: at ``init_method`` when given, else
    at an address rank 0 shares through the runtime (NCCL with a GPU
    lease or ``device="cuda"``, gloo otherwise). An existing world whose
    size or rank disagrees raises.

    ``precision`` sets the group default for the reduction collectives
    (allreduce/reduce/reducescatter): "f32" (bit-exact, the effective
    default), "bf16" or "int8" quantize each rank's contribution before
    the wire and accumulate at full precision. A per-call ``precision=``
    overrides it; None defers to config.collective_precision."""
    backend = Backend.resolve(backend)
    if backend == Backend.DIST:
        import torch.distributed as dist

        from .mesh_group import MeshCollectives

        formed = False
        if not dist.is_initialized():
            init_dist_world(
                world_size, rank,
                init_method or _rendezvous(group_name, world_size, rank),
                device)
            formed = True
        group = MeshCollectives(precision=precision)
        if world_size != group.world_size or rank != group.rank:
            raise ValueError(
                f"dist backend: asked for rank {rank} of {world_size}, but "
                f"this process is rank {group.rank} of a "
                f"{group.world_size}-rank torch.distributed world")
        group.group_name = group_name
        group._formed_world = formed
    else:
        from .coordinator import ObjstoreGroup, create_coordinator

        coord = create_coordinator(group_name, world_size)
        group = ObjstoreGroup(coord, world_size, rank, group_name,
                              precision=precision)
    _group_mgr.put(group_name, group)
    return group


def create_collective_group(
    actors: List[Any],
    world_size: int,
    ranks: List[int],
    backend: str = Backend.OBJSTORE,
    group_name: str = "default",
    precision: Optional[str] = None,
):
    """Declarative group over existing actors (reference :151): sends an
    ``init_collective_group`` call into every actor. Actor classes must
    provide the ``_rmt_init_collective`` hook — inherit
    :class:`CollectiveGroupMixin` (or define an equivalent method that calls
    ``init_collective_group`` locally). An actor without the hook fails with
    a remote AttributeError naming the missing method.

    A ``dist`` group is one process group of the actors' processes: each
    actor forms or joins its world at rank 0's address, shared through
    the group's coordinator."""
    from .. import api

    if len(actors) != len(ranks):
        raise ValueError("actors and ranks must align")
    backend = Backend.resolve(backend)
    from .coordinator import create_coordinator

    create_coordinator(group_name, world_size)  # pre-create, avoids races
    refs = []
    for actor, rank in zip(actors, ranks):
        if precision is None:
            # old positional shape: an actor class with a pre-precision
            # _rmt_init_collective hook keeps working
            refs.append(actor._rmt_init_collective.remote(
                world_size, rank, backend, group_name
            ))
        else:
            refs.append(actor._rmt_init_collective.remote(
                world_size, rank, backend, group_name, precision
            ))
    api.get(refs, timeout=120)


def destroy_collective_group(group_name: str = "default") -> None:
    """Drop the local group and kill the rendezvous coordinator (if this
    process can reach it) so re-forming the group starts from clean state.
    A ``dist`` group that formed this process's world also tears it
    down."""
    group = _group_mgr.pop(group_name)
    if group is None:
        return
    if getattr(group, "_formed_world", False):
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    from .coordinator import destroy_coordinator

    try:
        destroy_coordinator(group_name)
    except Exception:
        pass  # no runtime, driver gone or already dead


def get_rank(group_name: str = "default") -> int:
    return _group_mgr.get(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group_mgr.get(group_name).world_size


def is_group_initialized(group_name: str = "default") -> bool:
    try:
        _group_mgr.get(group_name)
        return True
    except ValueError:
        return False


# ---------------------------------------------------------------- operations
class _op_timer:
    """Times one collective op into rmt_collective_latency_seconds. These
    module functions are the single entry point for BOTH backends (dist
    and objstore), so per-op latency lands here once."""

    __slots__ = ("_op", "_t0")

    def __init__(self, op: str):
        self._op = op
        self._t0 = 0.0

    def __enter__(self):
        import time as _time

        self._t0 = _time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            import time as _time

            from ..core.metrics_defs import collective_latency_seconds

            collective_latency_seconds().observe(
                _time.monotonic() - self._t0, tags={"op": self._op})
        return False


def allreduce(tensor, group_name: str = "default", op: str = ReduceOp.SUM,
              precision: Optional[str] = None):
    """``precision="f32" | "bf16" | "int8"``: sub-f32 quantizes each
    rank's tensor before the wire (bf16 halves the moved bytes, int8 with
    block-wise scales ~quarters them) and dequantizes+accumulates at
    full f32 — EQuARX-style lossy-aware comms. Omit (None) for the group
    default; f32 stays bit-exact."""
    with _op_timer("allreduce"):
        return _group_mgr.get(group_name).allreduce(
            tensor, op, precision=precision)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: str = ReduceOp.SUM, precision: Optional[str] = None):
    with _op_timer("reduce"):
        return _group_mgr.get(group_name).reduce(
            tensor, dst_rank, op, precision=precision)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    with _op_timer("broadcast"):
        return _group_mgr.get(group_name).broadcast(tensor, src_rank)


def allgather(tensor, group_name: str = "default"):
    with _op_timer("allgather"):
        return _group_mgr.get(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = "default",
                  op: str = ReduceOp.SUM,
                  precision: Optional[str] = None):
    with _op_timer("reducescatter"):
        return _group_mgr.get(group_name).reducescatter(
            tensor, op, precision=precision)


def barrier(group_name: str = "default"):
    with _op_timer("barrier"):
        return _group_mgr.get(group_name).barrier()


def send(tensor, dst_rank: int, group_name: str = "default"):
    with _op_timer("send"):
        return _group_mgr.get(group_name).send(tensor, dst_rank)


def recv(src_rank: int, group_name: str = "default"):
    with _op_timer("recv"):
        return _group_mgr.get(group_name).recv(src_rank)


class CollectiveGroupMixin:
    """Mixin giving actor classes the conventional init hook used by
    create_collective_group."""

    def _rmt_init_collective(self, world_size: int, rank: int, backend: str,
                             group_name: str,
                             precision: Optional[str] = None) -> bool:
        init_collective_group(world_size, rank, backend, group_name,
                              precision=precision)
        return True
