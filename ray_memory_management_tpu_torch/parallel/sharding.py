"""Sharding presets: DP / FSDP / TP (+combinations) as DTensor placements.

Counterpart of ``parallel/sharding.py`` in the JAX package, where
strategies are PartitionSpec rules over a named mesh and XLA inserts the
collectives. Here the same rules give DTensor placements (one
``Shard(d)``/``Replicate()`` per mesh dim). Where a rule shards
anything (fsdp, tp), DTensor's sharding propagation inserts the
collectives: all-gathers of fsdp-sharded parameters and reduce-scatters
of their gradients, the Megatron all-reduce pairs of tp. Where every
parameter is replicated (dp, sp), the step is DDP's: plain tensors and
one all-reduce of the gradients over the data axes, which is what XLA
makes of that layout, without DTensor's dispatch on every op. Expert
and pipeline parallelism keep that shape: the expert weights are each
rank's LOCAL shard of the ep axis and the layer-stacked leaves each
rank's LOCAL stage of the pp axis, as plain tensors (``ops/moe.py`` runs
its experts and sums the partial outputs over ep; ``parallel/pipeline.py``
runs its stage's layers), every other leaf replicated. :func:`shard_pytree`
records each local shard it cuts, so that a checkpoint gathers it whole
(:func:`gather_local_shard`).

Rules are keyed by the TransformerLM parameter names (models/gpt.py) and
written as the JAX package writes them — a spec is a tuple with a mesh
axis name (or None) per tensor dim — so :func:`param_specs` can be held
against the JAX ``PartitionSpec``s name by name; :func:`param_pspecs`
turns them into placements.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

Spec = Tuple[Optional[str], ...]

# Megatron-style TP rules for TransformerLM stacked params [L, in, out]:
# column-parallel (shard output dim), row-parallel (shard input dim)
_TP_RULES: Dict[str, Spec] = {
    "wq": (None, None, "tp"),
    "wk": (None, None, "tp"),
    "wv": (None, None, "tp"),
    "wo": (None, "tp", None),
    "w1": (None, None, "tp"),
    "w3": (None, None, "tp"),
    "w2": (None, "tp", None),
    "ln1": (None, None),
    "ln2": (None, None),
    "tok_embed": ("tp", None),   # vocab-parallel embedding
    "lm_head": (None, "tp"),
    "final_ln": (None,),
}


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, in its dim order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _maybe_add_fsdp(spec: Spec, shape, fsdp_size: int) -> Spec:
    """Layer FSDP onto a TP spec: shard the largest still-unsharded,
    divisible dimension along the fsdp axis (ZeRO-3-style parameter
    sharding)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    candidates = sorted(range(len(shape)), key=lambda i: -int(shape[i]))
    for i in candidates:
        if dims[i] is None and shape[i] % fsdp_size == 0 and shape[i] > 1:
            dims[i] = "fsdp"
            return tuple(dims)
    return tuple(dims)


def param_specs(params: Dict[str, Any], axes: Dict[str, int],
                strategy: str = "dp") -> Dict[str, Any]:
    """Spec tree (a mesh axis or None per tensor dim) for a parameter
    tree over a mesh with ``axes`` — the JAX ``param_pspecs``, rule for
    rule.

    strategy: "dp" (replicated params), "fsdp", "tp", "ep", and
    combinations ("fsdp+tp", "dp+tp", "ep+tp", ...). On a mesh with a
    ``pp`` axis the layer-stacked leaves (``layers/...``) also put their
    leading dim on pp, whatever the strategy: the JAX
    ``stacked_param_pspecs`` applied to ``params["layers"]``, as the JAX
    pipeline tests do."""
    use_tp = "tp" in strategy and "tp" in axes
    use_fsdp = "fsdp" in strategy and "fsdp" in axes
    use_ep = "ep" in strategy and "ep" in axes
    use_pp = "pp" in axes
    fsdp_size = axes.get("fsdp", 1)

    # MoE expert weights ([L, E, ...]): the expert dim shards over ep
    # (when enabled); tp stays Megatron-style WITHIN each expert. These
    # rules apply whenever the 4-D expert shape is seen.
    ep_ax = "ep" if use_ep else None
    tp_ax = "tp" if use_tp else None
    moe_rules: Dict[str, Spec] = {
        "w1": (None, ep_ax, None, tp_ax),
        "w3": (None, ep_ax, None, tp_ax),
        "w2": (None, ep_ax, tp_ax, None),
        "router": (None, None, None),  # [L, D, E]: tiny, replicated
    }

    def spec_for(path: str, leaf) -> Spec:
        shape = tuple(leaf.shape)
        name = path.split("/")[-1]
        spec: Spec = (None,) * len(shape)
        if name in moe_rules and len(moe_rules[name]) == len(shape):
            spec = moe_rules[name]
        elif use_tp and name in _TP_RULES:
            spec = _TP_RULES[name]
            if len(spec) != len(shape):  # non-stacked variant
                spec = spec[-len(shape):]
        if use_pp and path.startswith("/layers/"):
            spec = ("pp",) + tuple(spec[1:])
        if use_fsdp:
            spec = _maybe_add_fsdp(spec, shape, fsdp_size)
        return spec

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        return spec_for(path, tree)

    return walk(params)


def spec_to_placements(spec: Sequence, mesh_dim_names: Sequence[str]):
    """DTensor placements for ``spec`` over a mesh with these dim names:
    ``Shard(d)`` on the mesh dim that tensor dim ``d`` names (a tuple
    entry names several), ``Replicate()`` on every other mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    placements = [Replicate()] * len(mesh_dim_names)
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        for name in names:
            if name is not None and name in mesh_dim_names:
                placements[list(mesh_dim_names).index(name)] = Shard(d)
    return tuple(placements)


def param_pspecs(params: Dict[str, Any], mesh,
                 strategy: str = "dp") -> Dict[str, Any]:
    """Placements tree (a tuple with one ``Shard(d)``/``Replicate()`` per
    mesh dim, per leaf) for a parameter tree; the layout of
    :func:`param_specs` on ``mesh``."""
    names = tuple(mesh.mesh_dim_names)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return spec_to_placements(node, names)

    return walk(param_specs(params, mesh_axes(mesh), strategy))


def batch_pspec(mesh):
    """Shard the batch dimension over every data-ish axis present."""
    axes = tuple(a for a in ("dp", "fsdp") if a in mesh.mesh_dim_names)
    return spec_to_placements((axes,) if axes else (None,),
                              tuple(mesh.mesh_dim_names))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


DATA_AXES = ("dp", "fsdp")  # the mesh axes over which the batch is split
LOCAL_AXES = ("ep", "pp")   # the mesh axes whose shards stay plain tensors

# the local shards shard_pytree cut (and the optimizer state that trains
# them): tensor -> ((process group, tensor dim), ...) in the order cut
_LOCAL_SHARDS = None


def _mesh_all_reduce(t, mesh, op=None, dims=None):
    """All-reduce ``t`` in place over every rank of ``mesh`` (one
    collective per mesh dim), or over the mesh dims ``dims`` only."""
    import torch.distributed as dist

    for d in range(mesh.ndim) if dims is None else dims:
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM,
                        group=mesh.get_group(d))


def data_groups(mesh):
    """(process groups, ranks, index) of the mesh's data axes that split
    the batch (size > 1), in mesh order: their groups, the product of
    their sizes, and this rank's index among those data ranks, which is
    its share of the global batch's rows as :func:`batch_pspec` cuts
    them. ((), 1, 0) without any."""
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    groups, n, index = [], 1, 0
    for d, name in enumerate(names):
        if name in DATA_AXES and mesh.size(d) > 1:
            groups.append(mesh.get_group(d))
            index = index * mesh.size(d) + mesh.get_local_rank(d)
            n *= mesh.size(d)
    return tuple(groups), n, index


def _data_dims(mesh):
    """The indices of the mesh's data axes (over which the batch is
    sharded and replicated gradients are averaged)."""
    return [d for d, name in enumerate(mesh.mesh_dim_names)
            if name in DATA_AXES]


def _local_shard_dims(placements, mesh):
    """{mesh dim: tensor dim} of the ep and pp shards in ``placements``,
    or None when another mesh dim shards (a DTensor layout)."""
    out = {}
    for d, p in enumerate(placements):
        if p.is_replicate():
            continue
        if mesh.mesh_dim_names[d] not in LOCAL_AXES or not p.is_shard():
            return None
        out[d] = p.dim
    return out


def _local_shards():
    global _LOCAL_SHARDS
    if _LOCAL_SHARDS is None:
        from torch.utils.weak import WeakIdKeyDictionary

        _LOCAL_SHARDS = WeakIdKeyDictionary()
    return _LOCAL_SHARDS


def local_shard_cuts(t):
    """How :func:`shard_pytree` cut the plain tensor ``t`` from its global
    leaf: ((process group, tensor dim), ...) in the order cut, or None
    for a tensor it did not cut (a replicated or an unrelated one)."""
    return _local_shards().get(t)


def _record_cuts(t, cuts) -> None:
    if cuts:
        _local_shards()[t] = tuple(cuts)


def gather_local_shard(t):
    """The global tensor of which ``t`` is a local ep or pp shard (an
    all-gather over each axis it was cut along, in rank order), or ``t``
    itself when it is no such shard. Every rank of the shard's groups
    must call it, as every rank calls ``DTensor.full_tensor``. Raises
    when the groups are gone: a shard is never passed off as whole."""
    import torch
    import torch.distributed as dist

    cuts = local_shard_cuts(t)
    if cuts is None:
        return t
    if not dist.is_initialized():
        raise RuntimeError(
            f"a local shard of shape {tuple(t.shape)} cannot be gathered: "
            "its process group is gone")
    t = t.detach()
    for group, dim in reversed(cuts):
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        t = torch.cat(parts, dim=dim)
    return t


def _cut(x, cuts):
    """This rank's chunk of the global ``x`` along each of ``cuts``."""
    import torch.distributed as dist

    for group, dim in cuts:
        n = dist.get_world_size(group)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of a leaf of shape "
                             f"{tuple(x.shape)} does not split over {n} "
                             "ranks")
        x = x.chunk(n, dim=dim)[dist.get_rank(group)]
    return x.clone()


def _mark_optimizer_state(optimizer) -> None:
    """Record the per-parameter optimizer state of each local shard as cut
    like its parameter (Adam's moments have its shape), so that a
    checkpoint of ``optimizer.state_dict()`` gathers it whole too."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            cuts = local_shard_cuts(p)
            if cuts is None:
                continue
            for v in optimizer.state.get(p, {}).values():
                if hasattr(v, "shape") and v.shape == p.shape:
                    _record_cuts(v, cuts)


def shard_pytree(tree, mesh, specs) -> Any:
    """Place a parameter tree onto the mesh per its placements. Every
    rank passes the same full tensors; rank 0's values are what the
    shards hold. Floating-point leaves come out trainable
    (``requires_grad``), so an optimizer over them steps them.

    A tree whose every placement is ``Replicate()`` (dp, sp), or
    ``Shard`` only over the ep and pp axes (expert weights, pipeline
    stages), stays plain tensors, broadcast from rank 0, an ep- or
    pp-sharded leaf cut to this rank's chunk and recorded as such
    (:func:`local_shard_cuts`; a checkpoint gathers it):
    :func:`make_train_step` then trains it as DDP does, on local tensors
    with one all-reduce of the gradients over the data axes. Any other
    tree becomes DTensors (``distribute_tensor``). Either way the result
    may alias the input's storage, which an optimizer updates in place:
    clone the tree first to keep it."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    plain = all(_local_shard_dims(p, mesh) is not None
                for p in _leaves(specs))

    def put(x, placements):
        x = x.detach()
        if not plain:
            x = distribute_tensor(x, mesh, list(placements))
        elif mesh.size() > 1:
            for d in range(mesh.ndim):
                group = mesh.get_group(d)
                dist.broadcast(x, src=dist.get_global_rank(group, 0),
                               group=group)
            cuts = [(mesh.get_group(md), td) for md, td
                    in _local_shard_dims(placements, mesh).items()]
            if cuts:
                x = _cut(x, cuts)
                _record_cuts(x, cuts)
        if x.is_floating_point():
            x.requires_grad_(True)
        return x

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return put(node, spec)

    return walk(tree, specs)


def _fingerprint(x):
    """Two float64 sums of ``x`` (plain and position-weighted) that tell
    one rank's batch from another's."""
    import torch

    f = torch.nan_to_num(x.detach().reshape(-1).to(torch.float64))
    w = torch.arange(f.numel(), device=f.device, dtype=torch.float64)
    return torch.stack([f.sum(), (f * (w % 65521 + 1)).sum()])


def _check_same_batch(tensors, mesh) -> None:
    """Raise unless every rank of ``mesh`` passed the same full batch
    (one small all-reduce of the fingerprints' maxima and minima)."""
    import torch
    import torch.distributed as dist

    fp = torch.cat([_fingerprint(x) for x in tensors])
    both = torch.cat([fp, -fp])
    _mesh_all_reduce(both, mesh, dist.ReduceOp.MAX)
    if not torch.equal(both[:len(fp)], -both[len(fp):]):
        raise ValueError(
            "make_train_step: the ranks passed different batches. The "
            "step takes the GLOBAL batch, the same on every rank, and "
            "trains each rank on its rows of it; to pass each rank's own "
            "rows, pass DTensor.from_local(rows, mesh, batch_pspec(mesh))")


def _distribute_batch(batch, mesh, placements):
    """The batch as DTensors sharded per ``placements``: a full batch
    (checked to be the same on every rank) is cut locally, with no
    traffic; a DTensor is redistributed to ``placements``."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    items = batch if isinstance(batch, dict) else {None: batch}
    full = [v for v in items.values() if not isinstance(v, DTensor)]
    if full and mesh.size() > 1:
        _check_same_batch(full, mesh)

    def put(x):
        if isinstance(x, DTensor):
            return x.redistribute(placements=list(placements))
        return distribute_tensor(x, mesh, list(placements),
                                 src_data_rank=None)

    out = {k: put(v) for k, v in items.items()}
    return out if isinstance(batch, dict) else out[None]


def make_train_step(loss_fn, optimizer, mesh):
    """The train step over sharded parameters: ``step(params, batch)``
    runs ``loss_fn(params, batch)`` forward and backward, steps
    ``optimizer`` (a ``torch.optim`` optimizer over the leaves of
    :func:`shard_pytree`'s tree, updated in place) and returns the loss
    as a plain scalar tensor, equal on every rank.

    The batch is the global one: full tensors that must be the same on
    every rank (the step raises if they are not), or DTensors (each
    rank's own rows: ``DTensor.from_local(rows, mesh,
    batch_pspec(mesh))``). It is sharded over the data axes
    (:func:`batch_pspec`).

    DTensor parameters (fsdp, tp) run the forward and backward on
    DTensors: DTensor reduces the gradients of replicated and
    fsdp-sharded parameters over the data axes, as XLA's inserted psums
    do in the JAX step. Plain tensors the model makes on the way
    (positions, rotary tables) count as replicated. Plain parameters
    (replicated, or ep-local expert shards: dp, sp, ep) run DDP's shape
    instead: the forward and backward on this rank's rows as plain
    tensors, then one all-reduce of the gradients and of the loss over
    the data axes (none where there is no data axis: the sp, ep and pp
    ranks of one data shard compute the same loss, and ``ops/moe.py``,
    ``ops/ring_attention.py`` and ``parallel/pipeline.py`` give each of
    them the whole gradient of every replicated leaf)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    bspec = batch_pspec(mesh)
    leaves = [p for group in optimizer.param_groups for p in group["params"]]
    plain = not any(isinstance(p, DTensor) for p in leaves)
    n = mesh.size()
    shards = math.prod(size for name, size in mesh_axes(mesh).items()
                       if name in DATA_AXES)

    def local_rows(x):
        if x.shape[0] % shards:
            raise ValueError(f"make_train_step: a batch of {x.shape[0]} "
                             f"rows does not split over {shards} ranks")
        return x.to_local()

    def plain_step(params, batch):
        if n > 1:
            batch = _distribute_batch(batch, mesh, bspec)
            batch = ({k: local_rows(v) for k, v in batch.items()}
                     if isinstance(batch, dict) else local_rows(batch))
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch)
        loss.backward()
        loss = loss.detach()
        if shards > 1:
            _all_reduce_mean(
                [p.grad for p in leaves if p.grad is not None] + [loss],
                mesh)
        optimizer.step()
        _mark_optimizer_state(optimizer)
        return loss

    def step(params, batch):
        batch = _distribute_batch(batch, mesh, bspec)
        optimizer.zero_grad(set_to_none=True)
        with implicit_replication():
            loss = loss_fn(params, batch)
            loss.backward()
        optimizer.step()
        loss = loss.detach()
        return loss.full_tensor() if isinstance(loss, DTensor) else loss

    return plain_step if plain else step


def _all_reduce_mean(tensors, mesh) -> None:
    """Average ``tensors`` in place over the mesh's data axes: one flat
    all-reduce per dtype and data axis, in the same order on every
    rank."""
    import torch

    dims = _data_dims(mesh)
    n = math.prod(mesh.size(d) for d in dims)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group])
        _mesh_all_reduce(flat, mesh, dims=dims)
        flat /= n
        for t, f in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(f.view_as(t))


def load_optimizer_state(optimizer, state) -> None:
    """Load a ``torch.optim`` state dict whose tensors are full CPU tensors
    (``optimizer.state_dict()`` through ``train.Checkpoint.from_pytree``,
    which gathers DTensors and local shards) into ``optimizer`` over
    sharded parameters: each per-parameter tensor is distributed with its
    DTensor parameter's placements, or cut as its local-shard parameter
    was cut (the step counters stay as they are)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    params = [p for group in optimizer.param_groups for p in group["params"]]

    def place(p, k, v):
        if k == "step":
            return v
        if isinstance(p, DTensor) and v.shape == p.shape:
            return distribute_tensor(v.to(p.device_mesh.device_type),
                                     p.device_mesh, list(p.placements))
        cuts = local_shard_cuts(p)
        if cuts is not None and v.shape != p.shape:
            return _cut(v, cuts).to(p.device)
        return v

    loaded = {}
    for index, per_param in state["state"].items():
        p = params[int(index)]
        loaded[index] = {k: place(p, k, v) for k, v in per_param.items()}
    optimizer.load_state_dict({"state": loaded,
                               "param_groups": state["param_groups"]})
    _mark_optimizer_state(optimizer)
