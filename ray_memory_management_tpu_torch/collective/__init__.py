"""Collective communication library (ray.util.collective analog): the
``dist`` backend over ``torch.distributed`` (NCCL on the card, gloo on
the CPU) and the object-plane backend. Counterpart of ``collective/`` in
the JAX package."""

from .collective import (  # noqa: F401
    CollectiveGroupMixin,
    allgather,
    allreduce,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    is_group_initialized,
    recv,
    reduce,
    reducescatter,
    send,
)
from .mesh_group import MeshCollectives  # noqa: F401
from .types import (  # noqa: F401
    PRECISIONS, Backend, ReduceOp, resolve_precision,
)
