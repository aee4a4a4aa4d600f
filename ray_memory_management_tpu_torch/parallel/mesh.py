"""Device mesh construction: the parallelism substrate.

Counterpart of ``parallel/mesh.py`` in the JAX package: a named-axis mesh
is the single object every strategy (DP / FSDP / TP / ...) hangs off. In
PyTorch the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
one rank per process, laid out in :data:`AXIS_ORDER` (tp innermost, so
tensor-parallel ranks are neighbours, the NVLink-near ones on one host).

Unlike the JAX mesh, which one process builds over the devices it
sees, a DeviceMesh needs an initialized ``torch.distributed`` process
group whose world size is the mesh's size: every rank of the world
builds the same mesh (``init_collective_group(backend="dist")`` or
``train``'s ``dist`` world form the group).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

# canonical axis order: outer (slow) to inner (fast links); tp innermost
AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "ep", "tp")


def make_mesh(axes: Dict[str, int], device_type: str = "cuda"):
    """Build a DeviceMesh with the given {axis: size} over ``device_type``
    ("cuda" by default, "cpu" on request). Axes are laid out in
    AXIS_ORDER (unknown names go last in given order). The process group
    must be initialized with a world of exactly the mesh's size; a CUDA
    mesh without a card raises."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    names = sorted(
        axes.keys(),
        key=lambda n: AXIS_ORDER.index(n) if n in AXIS_ORDER else 99,
    )
    shape = tuple(axes[n] for n in names)
    n_dev = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {axes} needs a torch.distributed process group of "
            f"{n_dev} ranks; none is initialized")
    world = dist.get_world_size()
    if n_dev != world:
        raise ValueError(
            f"mesh {axes} needs {n_dev} ranks, the process group has "
            f"{world}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA device; none is "
                           "available (pass device_type='cpu')")
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(names))


def cpu_mesh(axes: Dict[str, int]):
    """Mesh over CPU ranks (gloo): the tests' mesh."""
    return make_mesh(axes, device_type="cpu")


def local_gpu_mesh(axes: Optional[Dict[str, int]] = None):
    """Mesh over the world's cards, one rank per card (``{"dp": world}``
    when no axes are given)."""
    import torch.distributed as dist

    if axes is None:
        axes = {"dp": dist.get_world_size() if dist.is_initialized() else 1}
    return make_mesh(axes, device_type="cuda")
