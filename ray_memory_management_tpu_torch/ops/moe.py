"""Mixture-of-Experts FFN with expert parallelism (ep).

Counterpart of ``ops/moe.py`` in the JAX package, with the same shapes and
order of operations: the GShard/Switch dense-dispatch formulation over a
STATIC capacity. Routing, dispatch and combine are einsums outside any
kernel there, and stay PyTorch tensor ops here:

  - the router and its softmax in fp32; top-k gating (k = 1 Switch,
    k = 2 GShard) with GShard's cumsum positions, experts filling in
    routing-priority order one chosen expert at a time;
  - tokens dispatch in groups of about ``expert_group_size`` with a
    per-group capacity ``C = ceil(k * g / E * capacity_factor)``;
    overflow tokens get zero combine weight and ride the residual;
  - the 0/1 ``dispatch`` and the expert SwiGLU in ``cfg.dtype``; the
    Switch load-balancing aux loss ``E * sum_e f_e * p_e``.

Expert parallelism takes the place of the JAX ``with_sharding_constraint``
calls. The expert weights arrive as each rank's LOCAL shard of the expert
dim (``parallel.shard_pytree`` over a mesh with an ``ep`` axis: [E/ep, D,
F] a layer), while tokens, router and routing are replicated over the
ep group. Each rank runs its experts on their slice of ``expert_in`` and
combines their outputs into a partial ``[T, D]``; one all-reduce over the
ep group sums the partials. All-reduce and not all-to-all, because the
tokens are replicated over ep (the model outside the FFN runs on the whole
batch on every rank of the group): an all-to-all would scatter tokens
that every rank already holds, and gather expert outputs that an
all-reduce of the combined partials delivers in ``T x D`` elements, not
``E x C x G x D`` (2.5 times the tokens at top-2 and capacity 1.25). The
all-reduce's backward is the identity and the ranks' partial gradients of
the tokens and of ``combine`` are summed (``_regions``), so no gradient is
counted once per rank.

With data axes (dp, fsdp or both) in the mesh, x is this rank's rows
of the global batch, as ``parallel.make_train_step`` hands them: the
dispatch groups are the JAX package's groups of the global batch (so a
group may not straddle two ranks' rows: the function raises if it
would), and the aux loss takes the global fractions and mean
probabilities, summed over the data ranks.

The layouts whose weights are DTensors (fsdp, tp and their mixes with
ep: the JAX ``param_pspecs``, which GSPMD runs through the same
function) take the same path on each rank's local tensors: the fsdp
shards of the weights are gathered for use and their gradients
reduce-scattered, and tp splits each expert Megatron-style (w1/w3 by
columns, w2 by rows), its partial outputs summed over tp as ep's are
over ep.

A ``live`` mask [B, S] keeps tokens out of routing: masked tokens take no
capacity, get a zero output and no share of the aux loss. The serve
engine passes it for decode rows of idle slots.
"""

from __future__ import annotations

import contextlib
import math
import sys
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.sharding import DATA_AXES, data_groups
from . import _regions


def init_moe_params(n_layers: int, d_model: int, d_ff: int, n_experts: int,
                    generator: torch.Generator, device=None,
                    param_dtype: torch.dtype = torch.float32):
    """Layer-stacked MoE FFN params drawn from ``generator``: router [L, D,
    E] and per-expert SwiGLU weights w1/w3 [L, E, D, F], w2 [L, E, F, D];
    the drop-in replacement for the dense w1/w3/w2 stack."""
    L, D, F_, E = n_layers, d_model, d_ff, n_experts

    def dense(shape, fan_in):
        return torch.randn(shape, generator=generator, dtype=param_dtype,
                           device=device) * (fan_in ** -0.5)

    return {
        "router": dense((L, D, E), D),
        "w1": dense((L, E, D, F_), D),
        "w3": dense((L, E, D, F_), D),
        "w2": dense((L, E, F_, D), F_),
    }


def capacity(group_size: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    return max(1, math.ceil(group_size * top_k / n_experts
                            * capacity_factor))


def _group_size(n_tokens: int, target: int) -> int:
    """Largest divisor of ``n_tokens`` that is <= target (GShard's group
    dimension: capacity scales with tokens per group, not total tokens)."""
    g = min(n_tokens, max(1, target))
    while n_tokens % g != 0:
        g -= 1
    return g


def _argmax(remaining):
    return torch.argmax(remaining, dim=-1)


# the expert choice of each top-k round (pinned_routing replaces it)
choose = _argmax


@contextlib.contextmanager
def pinned_routing(record=None, replay=None, flips=None):
    """A scope in which each top-k round of the router appends its expert
    choices [G, g] to ``record``, or takes them from ``replay`` (one a
    round, in the order the rounds run) and appends to ``flips`` the
    count (a tensor) of tokens whose own choice differs. Two runs whose
    router inputs differ by rounding then route alike: a check comparing
    them measures their arithmetic, not the routing's discontinuity (a
    rounding-sized change can move a token to another expert)."""
    global choose
    rounds = iter(replay or ())

    def pinned(remaining):
        own = _argmax(remaining)
        if record is not None:
            record.append(own)
        if replay is None:
            return own
        chosen = next(rounds).to(own.device, own.dtype)
        if flips is not None:
            flips.append((chosen != own).sum())
        return chosen

    choose = pinned
    try:
        yield
    finally:
        choose = _argmax


def route(probs, k: int, C: int, live=None):
    """GShard top-k routing of ``probs`` [G, g, E] (fp32) into ``C`` slots
    per expert and group. Returns (combine [G, g, E, C] fp32, normalised
    over each token's kept slots; dispatch_total [G, g, E], 1 where a
    token was kept by an expert). ``live`` [G, g] masks tokens out."""
    G, g, E = probs.shape
    combine = probs.new_zeros((G, g, E, C))
    dispatch_total = probs.new_zeros((G, g, E))
    fill = probs.new_zeros((G, E))          # per-group expert fill level
    remaining = probs.detach()
    for _ in range(k):
        idx = choose(remaining)                                # [G, g]
        onehot = F.one_hot(idx, E).float()                     # [G, g, E]
        if live is not None:
            onehot = onehot * live[..., None]
        gate = (probs * onehot).sum(-1)                        # [G, g]
        pos = (onehot.cumsum(dim=1) - 1.0) + fill[:, None, :]
        pos = (pos * onehot).sum(-1)                           # [G, g]
        keep = (pos < C).float() * onehot.sum(-1)
        # a position >= C (dropped) lands in column C, which is cut off:
        # jax.nn.one_hot gives a zero row for it
        pos_oh = F.one_hot(pos.long().clamp(max=C), C + 1)[..., :C].float()
        combine = combine + (gate * keep)[..., None, None] \
            * onehot[..., None] * pos_oh[..., None, :]
        dispatch_total = dispatch_total + onehot * keep[..., None]
        fill = fill + (onehot * keep[..., None]).sum(dim=1)
        remaining = remaining * (1.0 - onehot)                 # mask chosen
    # normalise the top-k gates so each token's kept weights sum to 1
    denom = combine.sum(dim=(2, 3), keepdim=True)
    return combine / denom.clamp_min(1e-9), dispatch_total


def _ep_group(mesh, n_experts: int, local: int):
    """(ep process group, first local expert) of this rank, for expert
    weights that hold ``local`` of ``n_experts`` experts."""
    if mesh is None or "ep" not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the expert weights hold {local} of {n_experts} "
                         "experts: pass the mesh whose ep axis shards them")
    ep = mesh.size(mesh.mesh_dim_names.index("ep"))
    if local * ep != n_experts:
        raise ValueError(f"{local} local experts x ep {ep} != {n_experts}")
    return mesh.get_group("ep"), mesh.get_local_rank("ep") * local


def _is_dtensor(t) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def moe_ffn(x, layer, cfg, mesh=None, live=None):
    """MoE feed-forward: x [B, S, D] -> ([B, S, D], aux_loss scalar).

    ``layer`` holds this layer's slices: router [D, E], w1/w3 [E', D, F],
    w2 [E', F, D], with E' = E (every expert here) or this rank's E/ep
    experts of ``mesh``'s ep axis; x is this rank's rows of the global
    batch where ``mesh`` has data axes. DTensor weights (the fsdp and tp
    layouts) take a DTensor x and give DTensors back
    (:func:`_moe_ffn_dtensor`). ``live`` [B, S] (bool), if given, masks
    tokens out of routing and the aux loss."""
    if any(_is_dtensor(t) for t in (x, *layer.values())):
        return _moe_ffn_dtensor(x, layer, cfg, live)
    E = layer["router"].shape[-1]
    local = layer["w1"].shape[0]
    parts, first = (), 0
    if local != E:
        group, first = _ep_group(mesh, E, local)
        parts = (group,)
    return _moe_ffn(x, layer, cfg, data_groups(mesh), parts, first,
                    _regions.sum_over, live)


def _moe_ffn_dtensor(x, layer, cfg, live=None):
    """:func:`moe_ffn` over DTensors, as ``parallel.make_train_step`` runs
    the fsdp and tp layouts: each rank routes and runs the FFN on its rows
    of x (``Shard(0)`` over the data axes) with plain tensors. Every
    weight's fsdp shards are gathered for use, and its gradient, partial
    over the data ranks, is reduce-scattered back (DTensor's
    redistribute); its ep shards (the expert dim) and tp shards (w1/w3's
    columns, w2's rows within each expert) stay local, and the experts'
    partial outputs are summed over those axes. The aux loss takes the
    global batch, summed over the data axes with no sum of the
    gradients: DTensor adds the data ranks' partial weight gradients
    itself. Returns (out in x's row layout, aux replicated), both
    DTensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not _is_dtensor(x):
        raise ValueError("moe_ffn: DTensor expert weights take a DTensor x "
                         "(the rows of parallel.make_train_step's batch)")
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    rows = [Shard(0) if n in DATA_AXES else Replicate() for n in names]
    x_local = x.redistribute(placements=rows).to_local()

    def use(w):
        keep = [Replicate() if n in DATA_AXES else p
                for n, p in zip(names, w.placements)]
        grads = [Partial() if n in DATA_AXES else p
                 for n, p in zip(names, keep)]
        return w.redistribute(placements=keep).to_local(
            grad_placements=grads)

    local = {k: use(layer[k]) for k in ("router", "w1", "w3", "w2")}
    # the mesh dims that split the experts: ep (the expert dim) and tp
    # (within each expert)
    parts, first = [], 0
    for d, p in enumerate(layer["w1"].placements):
        if names[d] in DATA_AXES or not p.is_shard():
            continue
        parts.append(mesh.get_group(d))
        if p.dim == 0:
            first = mesh.get_local_rank(d) * local["w1"].shape[0]
    out, aux = _moe_ffn(x_local, local, cfg, data_groups(mesh),
                        tuple(parts), first, _regions.leave_partial, live)
    return (DTensor.from_local(out, mesh, rows, run_check=False),
            DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                               run_check=False))


def _moe_ffn(x, layer, cfg, data, parts, first: int, data_sum, live=None):
    """The FFN on plain tensors. x [B, S, D] is this rank's rows of the
    global batch, cut over the data axes ``data`` (:func:`data_groups`);
    the expert weights hold experts ``first`` .. ``first + E'`` of E, and
    of each the part that the process groups ``parts`` (ep, tp) split
    among their ranks: the ranks' partial outputs are summed over each
    of ``parts``, and so are the partial gradients of what enters them
    (``_regions``). ``data_sum(t, group)`` sums the aux loss's fractions
    and mean probabilities over each data group."""
    groups, n_data, _ = data
    B, S, D = x.shape
    E = layer["router"].shape[-1]
    k = cfg.expert_top_k
    T = B * S
    g = _group_size(T * n_data, cfg.expert_group_size)
    if T % g:
        raise ValueError(f"a dispatch group of {g} tokens of the global "
                         f"batch straddles this rank's {T} tokens")
    G = T // g
    C = capacity(g, E, k, cfg.expert_capacity_factor)
    dt = cfg.dtype

    xg = x.reshape(G, g, D)
    logits = torch.einsum("gtd,de->gte", xg.float(),
                          layer["router"].float())           # [G, g, E]
    probs = torch.softmax(logits, dim=-1)
    mask = None if live is None else live.reshape(G, g).float()
    combine, dispatch_total = route(probs, k, C, mask)
    dispatch = (combine > 0.0).to(dt)                        # [G, g, E, C]

    xin = xg.to(dt)
    for group in parts:
        xin = _regions.enter_partial(xin, group)
        combine = _regions.enter_partial(combine, group)
    local = layer["w1"].shape[0]
    if local != E:
        dispatch = dispatch[:, :, first:first + local]
        combine = combine[:, :, first:first + local]
    expert_in = torch.einsum("gtec,gtd->egcd", dispatch, xin)  # [E', G, C, D]
    gate_h = F.silu(torch.einsum("egcd,edf->egcf", expert_in,
                                 layer["w1"].to(dt)))
    up = torch.einsum("egcd,edf->egcf", expert_in, layer["w3"].to(dt))
    expert_out = torch.einsum("egcf,efd->egcd", gate_h * up,
                              layer["w2"].to(dt))            # [E', G, C, D]
    out = torch.einsum("gtec,egcd->gtd", combine.to(dt), expert_out)
    for group in parts:
        out = _regions.leave_partial(out, group)

    # load-balancing aux loss (Switch eq. 4): E * sum_e f_e * p_e, f_e the
    # fraction of (live) tokens dispatched to e, p_e their mean router prob
    if mask is None:
        f = dispatch_total.mean(dim=(0, 1)).detach()
        p = probs.mean(dim=(0, 1))
        for group in groups:  # over the global batch
            f, p = data_sum(f, group), data_sum(p, group)
        if groups:
            f, p = f / n_data, p / n_data
    else:
        n = mask.sum().clamp_min(1.0)
        f = dispatch_total.sum(dim=(0, 1)) / n
        p = (probs * mask[..., None]).sum(dim=(0, 1)) / n
    aux = E * (f * p).sum()
    return out.reshape(B, S, D), aux
