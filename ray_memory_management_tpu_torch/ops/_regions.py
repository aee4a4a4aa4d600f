"""Autograd collectives between replicated and rank-local computation.

The model runs replicated on every rank of a sequence-parallel (sp) or
expert-parallel (ep) group: each rank holds the whole batch and computes
the same loss. Only one piece is split over the group (each rank's query
chunk of attention, each rank's experts), so the collectives that enter
and leave that piece must not be the plain autograd collectives of
``torch.distributed.nn.functional``: the backward of their all-reduce or
all-gather sums the gradients of every rank, and every rank's gradient of
a replicated activation is already the whole gradient, so the sum counts
it ``group size`` times. The four functions here are the Megatron pairs
instead, each the other's transpose:

- :func:`enter_partial` / :func:`leave_partial`: identity forward and a
  sum of the ranks' partial gradients backward / a sum of the ranks'
  partial outputs forward and identity backward (the ep combine);
- :func:`split` / :func:`gather`: this rank's chunk along a dim forward
  and an all-gather of the chunks' gradients backward / an all-gather
  forward and this rank's chunk of the gradient backward (sp).

:func:`all_to_all` (Ulysses) is its own transpose: its backward is the
same all-to-all of the gradients. :func:`sum_over` is the plain
data-parallel sum (all-reduce forward and backward): each data rank's
loss takes the global sum, and the train step averages the ranks'
gradients, which divides the backward's sum again.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(t, group):
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


def _all_gather(t, dim: int, group):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _chunk(t, dim: int, group):
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split "
                         f"over {n} ranks")
    return t.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


def _a2a(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _EnterPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _LeavePartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.group), None, None


def enter_partial(x, group):
    """``x`` (replicated) into a computation each rank does only part
    of: the ranks' gradients of it are partial, and are summed."""
    return _EnterPartial.apply(x, group)


def leave_partial(x, group):
    """The sum over ``group`` of each rank's partial ``x``, replicated;
    its gradient is the replicated gradient, unsummed."""
    return _LeavePartial.apply(x, group)


def split(x, dim: int, group):
    """This rank's chunk of replicated ``x`` along ``dim``."""
    return _Split.apply(x, dim, group)


def gather(x, dim: int, group):
    """Every rank's chunk ``x`` concatenated along ``dim``, replicated."""
    return _Gather.apply(x, dim, group)


def all_to_all(x, group):
    """``x`` [n, ...] over a group of n ranks: slice i goes to rank i, and
    slice j of the result came from rank j."""
    return _AllToAll.apply(x, group)


def sum_over(x, group):
    """The sum of ``x`` over ``group`` (data ranks), on every rank; its
    backward sums the gradients too."""
    return _SumOver.apply(x, group)
