"""Pipeline parallelism: GPipe's microbatch schedule over the ``pp``
stages of a DeviceMesh.

Counterpart of ``parallel/pipeline.py`` in the JAX package, with its
schedule and results. There the pipeline is one SPMD program: every
device holds its stage's slice of the layer-stacked parameters, M
microbatches go through S stages in M + S - 1 steps of a ``lax.scan``,
activations move by ``ppermute``, and ``jax.grad`` through scan and
ppermute gives the reverse schedule. Here each rank of the pp axis is one
stage:

  - stage s holds layers [s·L/S, (s+1)·L/S) of the layer-stacked leaves
    as plain tensors (``shard_pytree`` cuts them on a mesh with a pp axis,
    as it cuts ep's experts);
  - at step t stage 0 takes microbatch t, stage s what stage s - 1 made at
    step t - 1, and the last stage's output at t >= S - 1 is microbatch
    t - (S - 1)'s. A rank runs only real microbatches: the JAX program
    computes the fill and flush steps on garbage and masks it out;
  - activations move one hop a step by ``batch_isend_irecv`` in the pp
    group, each rank posting its send before its receive;
  - :class:`_Pipeline`, the schedule's own autograd Function, runs the
    reverse schedule: the last stage starts from its outputs' gradients,
    each stage backpropagates a microbatch through the graph its forward
    kept for it, and sends the input's gradient to the previous stage.

The blocks' output is broadcast from the last stage to every pp rank (the
JAX ``psum``), and the embedding, final norm, head and loss run
replicated over pp. Every rank's gradient of a replicated activation is
then the whole gradient, so the broadcast's backward takes the last
stage's own and sums nothing, and the input's gradient, which stage 0
alone computes, is broadcast from it: the embedding's gradient reaches
every pp rank. Each stage's MoE aux is summed over the stages by
``_regions.leave_partial`` (its backward hands every stage the whole
gradient) and averaged over the batch axes by ``_regions.sum_over``.

With batch axes (dp), ``x`` is this rank's rows of the global batch, as
``parallel.make_train_step`` hands them, and each data shard runs its own
pipeline. :func:`pipeline_schedule` runs the same schedule and backward
over every stage's layer slices held in one process, with no P2P (the
pipeline's ``ring_schedule``): one schedule body (:func:`_sweep`), two
ways of moving activations (:class:`_Sending`, :class:`_Resident`).
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..ops import _regions


def stage_pspec(n_dims: int, axis: str = "pp"):
    """Spec putting a layer-stacked leaf's leading dim on the stages (a
    mesh axis or None per tensor dim, as ``sharding.param_specs`` writes
    specs)."""
    return (axis,) + (None,) * (n_dims - 1)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def stacked_param_pspecs(params: Any, axis: str = "pp") -> Any:
    """Spec tree placing every layer-stacked leaf on its stage."""
    return _tree_map(lambda p: stage_pspec(p.ndim, axis), params)


def _run_stage(block_fn, layers, h, with_aux: bool):
    """One stage's layers, in order, over one microbatch: (h, the sum of
    the layers' aux, fp32)."""
    n = next(_leaves(layers)).shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        layer = _tree_map(lambda w: w[i], layers)
        if with_aux:
            h, a = block_fn(h, layer)
            aux = aux + a
        else:
            h = block_fn(h, layer)
    return h, aux


def _sweep(n: int, m: int, moves, first, work) -> None:
    """GPipe's sweep of ``m`` items through ``n`` positions: item i enters
    position 0 at step i, and position p works on it at step i + p
    (``work(p, i, h)``, which returns what p hands on), on what position
    p - 1 handed on one step before (``first(i)`` at position 0).
    ``moves`` holds the positions this process runs and carries the
    hand-overs; the fill and flush steps run nothing."""
    for t in range(m + n - 1):
        for p in moves.held:
            i = t - p
            if 0 <= i < m:
                h = first(i) if p == 0 else moves.take(p)
                y = work(p, i, h)
                if p < n - 1:
                    moves.give(p, y)
        moves.flush([p for p in moves.held if 0 < p and 0 <= t + 1 - p < m])


class _Resident:
    """Every position in this process: a hop is a hand-over in memory,
    taken at the next step."""

    def __init__(self, n: int):
        self.held = range(n)
        self.inbox, self.outbox = {}, {}

    def give(self, p: int, y) -> None:
        self.outbox[p + 1] = y

    def take(self, p: int):
        return self.inbox.pop(p)

    def flush(self, receivers) -> None:
        self.inbox, self.outbox = self.outbox, {}


class _Sending:
    """This rank's position in a sweep over ``group``, whose group ranks
    in position order are ``order``: a hop is one ``batch_isend_irecv``
    per step, the sends queued in the step first, then the receive of
    what the previous position sends (a tensor like ``like``)."""

    def __init__(self, group, order, like):
        self.group = group
        self.like = (like.shape, like.dtype, like.device)
        self.p = list(order).index(dist.get_rank(group))
        self.held = (self.p,)
        self.peer = [dist.get_global_rank(group, r) for r in order]
        self.sends, self.inbox = [], None

    def give(self, p: int, y) -> None:
        self.sends.append(dist.P2POp(dist.isend, y.contiguous(),
                                     self.peer[p + 1], self.group))

    def take(self, p: int):
        h, self.inbox = self.inbox, None
        return h

    def flush(self, receivers) -> None:
        ops, self.sends = self.sends, []
        if self.p in receivers:
            shape, dtype, device = self.like
            self.inbox = torch.empty(shape, dtype=dtype, device=device)
            ops.append(dist.P2POp(dist.irecv, self.inbox,
                                  self.peer[self.p - 1], self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()


class _Plan:
    """What one process runs of a pipeline of ``n`` stages and ``m``
    microbatches: the ``stages`` it holds, whose layers are the
    Function's flat leaves, stage after stage, each stage's laid out as
    ``tree``; ``group`` is the pp group (None: every stage here)."""

    def __init__(self, block_fn, n, m, stages, tree, group, with_aux):
        self.block_fn, self.n, self.m = block_fn, n, m
        self.stages, self.tree, self.group = list(stages), tree, group
        self.with_aux = with_aux

    def layers(self, flat):
        """{stage: its layer tree} over the flat leaves."""
        k = len(flat) // len(self.stages)
        out = {}
        for j, s in enumerate(self.stages):
            it = iter(flat[j * k:(j + 1) * k])
            out[s] = _tree_map(lambda _: next(it), self.tree)
        return out

    def moves(self, forward: bool, like):
        if self.group is None:
            return _Resident(self.n)
        order = range(self.n) if forward else range(self.n - 1, -1, -1)
        return _Sending(self.group, order, like)

    def broadcast(self, t, stage: int):
        """``t`` as stage ``stage`` holds it, on every rank."""
        if self.group is not None:
            dist.broadcast(t, src=dist.get_global_rank(self.group, stage),
                           group=self.group)
        return t


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule of :class:`_Plan` ``plan`` over ``x`` [B, ...]
    and the held stages' flat layer leaves: (the blocks' output on every
    rank, the held stages' aux summed over real microbatches)."""

    @staticmethod
    def forward(ctx, plan, x, *flat):
        n, m = plan.n, plan.m
        mbs = x.detach().reshape(m, x.shape[0] // m, *x.shape[1:])
        leaves = [t.detach().requires_grad_(t.requires_grad) for t in flat]
        layers = plan.layers(leaves)
        saved, outs = {}, [None] * m
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)

        def work(s, i, h):
            nonlocal aux_sum
            h = h.detach().requires_grad_()
            with torch.enable_grad():
                y, aux = _run_stage(plan.block_fn, layers[s], h,
                                    plan.with_aux)
            saved[s, i] = (h, y, aux)
            aux_sum = aux_sum + aux.detach()
            if s == n - 1:
                outs[i] = y.detach()
            return y.detach()

        if plan.group is not None and dist.get_backend(plan.group) == "nccl":
            # NCCL wants a collective over the group before a batched P2P
            # that only some of its ranks join (the fill's first steps)
            dist.all_reduce(torch.zeros(1, device=x.device), group=plan.group)
        _sweep(n, m, plan.moves(True, mbs[0]), lambda i: mbs[i], work)
        out = torch.cat(outs) if n - 1 in plan.stages else torch.empty_like(x)
        ctx.plan, ctx.saved, ctx.leaves = plan, saved, leaves
        return plan.broadcast(out, n - 1), aux_sum

    @staticmethod
    def backward(ctx, g_out, g_aux):
        plan, saved = ctx.plan, ctx.saved
        n, m = plan.n, plan.m
        g_mbs = g_out.reshape(m, g_out.shape[0] // m, *g_out.shape[1:])
        dxs = [None] * m

        def work(p, i, g):
            s, mb = n - 1 - p, m - 1 - i
            h, y, aux = saved.pop((s, mb))
            ys, gs = [y], [g]
            if aux.requires_grad:
                ys.append(aux)
                gs.append(g_aux)
            torch.autograd.backward(ys, gs)
            if s == 0:
                dxs[mb] = h.grad
            return h.grad

        _sweep(n, m, plan.moves(False, g_mbs[0]),
               lambda i: g_mbs[m - 1 - i].contiguous(), work)
        dx = (torch.cat(dxs) if 0 in plan.stages
              else torch.empty_like(g_out))
        grads = [t.grad for t in ctx.leaves]
        ctx.saved = ctx.leaves = None
        return (None, plan.broadcast(dx, 0), *grads)


def _check_microbatches(b: int, shards: int, batch_axes, m: int) -> None:
    if b % m:
        raise ValueError(
            f"per-shard batch {b} (batch {b * shards} over {shards} "
            f"{batch_axes} shards) not divisible by {m} microbatches")


def pipeline_blocks(block_fn: Callable[[Any, Any], Any], stacked_params: Any,
                    x, mesh, axis: str = "pp", n_microbatches: int = 0,
                    batch_axes: tuple = (), with_aux: bool = False):
    """Run ``x`` through the L stacked layers pipelined over the ``axis``
    stages of ``mesh``.

    ``block_fn(x_mb, layer)`` applies ONE layer (a tree slice of
    ``stacked_params`` at a leading index) to a microbatch's activation,
    keeping its shape and dtype. ``stacked_params``: this rank's stage,
    the leaves [L/S, ...] that ``shard_pytree`` cut along pp. ``x``: [B,
    ...] activations, replicated over ``axis``; with ``batch_axes`` (e.g.
    ("dp",)) B is this rank's rows of the global batch. Returns [B, ...]
    like a plain layer loop, on every pp rank.

    ``with_aux``: ``block_fn`` returns (h, aux scalar) per layer (the MoE
    load-balancing loss), and the result is (out, aux): the aux of real
    microbatches summed over stages, averaged over the batch axes and
    divided by M·L, as the JAX function returns it."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"pipeline_blocks needs a mesh with an {axis!r} "
                         f"axis; it has {names}")
    n = mesh.size(names.index(axis))
    m = n_microbatches if n_microbatches > 0 else n
    shards = math.prod(mesh.size(names.index(a)) for a in batch_axes)
    _check_microbatches(x.shape[0], shards, batch_axes, m)
    if any(type(t).__name__ == "DTensor" for t in _leaves(stacked_params)):
        raise NotImplementedError(
            "pipeline_blocks takes plain stage tensors: shard the tree with "
            "parallel.shard_pytree over a mesh whose pp axis cuts it")
    group = mesh.get_group(axis)
    stage = dist.get_rank(group)
    plan = _Plan(block_fn, n, m, [stage], stacked_params, group, with_aux)
    out, aux = _Pipeline.apply(plan, x, *_leaves(stacked_params))
    if not with_aux:
        return out
    aux = _regions.leave_partial(aux, group)
    for a in batch_axes:
        aux = _regions.sum_over(aux, mesh.get_group(a)) / mesh.size(
            names.index(a))
    n_layers = next(_leaves(stacked_params)).shape[0] * n
    return out, aux / (m * n_layers)


def _resident_blocks(block_fn, stacked_params, x, n_stages: int,
                     n_microbatches: int = 0, with_aux: bool = False):
    """:func:`pipeline_blocks` with every stage's slice of the whole
    layer stack in this process (no mesh, no P2P)."""
    m = n_microbatches if n_microbatches > 0 else n_stages
    _check_microbatches(x.shape[0], 1, (), m)
    n_layers = next(_leaves(stacked_params)).shape[0]
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split over {n_stages} "
                         "stages")
    k = n_layers // n_stages
    flat = [w[s * k:(s + 1) * k] for s in range(n_stages)
            for w in _leaves(stacked_params)]
    plan = _Plan(block_fn, n_stages, m, range(n_stages), stacked_params,
                 None, with_aux)
    out, aux = _Pipeline.apply(plan, x, *flat)
    return (out, aux / (m * n_layers)) if with_aux else out


# ---------------------------------------------------------------- LM wiring
def _lm_forward(params, tokens, cfg, run_blocks):
    """TransformerLM forward with the block stack run by ``run_blocks(
    block_fn, layers, x)`` -> (x, aux): (logits fp32, aux)."""
    from ..models import gpt

    x = params["tok_embed"][tokens].to(cfg.dtype)

    def block(h, layer):
        h, _, moe_aux = gpt.apply_block_with_aux(h, layer, cfg)
        return h, moe_aux

    x, aux = run_blocks(block, params["layers"], x)
    x = gpt._rmsnorm(x, params["final_ln"])
    return gpt._logits(x, params["lm_head"], cfg), aux


def _lm_loss(logits, aux, batch, cfg):
    lse = torch.logsumexp(logits, dim=-1)
    take = logits.gather(-1, batch["targets"][..., None])[..., 0]
    loss = (lse - take).mean()
    if cfg.n_experts > 0:
        loss = loss + cfg.moe_aux_weight * aux
    return loss


def pipeline_forward(params, tokens, cfg, mesh, axis: str = "pp",
                     n_microbatches: int = 0, batch_axes: tuple = ()):
    """TransformerLM forward with the block stack pipelined over ``axis``:
    the embedding and head run replicated over pp (on this rank's rows
    with ``batch_axes``), the [L/S, ...] stage streams microbatches.
    Returns (logits, aux): aux is the MoE load-balancing loss (0.0 for
    dense configs)."""
    return _lm_forward(params, tokens, cfg, lambda f, layers, x: (
        pipeline_blocks(f, layers, x, mesh, axis, n_microbatches,
                        batch_axes, with_aux=True)))


def pipeline_loss_fn(params, batch, cfg, mesh, axis: str = "pp",
                     n_microbatches: int = 0, batch_axes: tuple = ()):
    """Drop-in for ``models.gpt.loss_fn`` with a pipelined block stack
    (the weighted MoE aux included for expert configs); ``params`` is
    this rank's tree from ``shard_pytree`` over a mesh with a pp axis."""
    logits, aux = pipeline_forward(params, batch["tokens"], cfg, mesh,
                                   axis, n_microbatches, batch_axes)
    return _lm_loss(logits, aux, batch, cfg)


def pipeline_schedule(params, batch, cfg, n_stages: int,
                      n_microbatches: int = 0):
    """``pipeline_loss_fn``'s loss for the WHOLE parameter tree with the
    layers cut into ``n_stages`` stages held in this process: the same
    schedule and reverse schedule (``loss.backward()`` runs it), the
    hand-overs in memory instead of P2P. Every stage's kernels run here,
    on one card."""
    logits, aux = _lm_forward(params, batch["tokens"], cfg,
                              lambda f, layers, x: _resident_blocks(
                                  f, layers, x, n_stages, n_microbatches,
                                  with_aux=True))
    return _lm_loss(logits, aux, batch, cfg)
