"""Sequence-parallel attention: ring attention and Ulysses, over the
``sp`` axis of a DeviceMesh.

Counterpart of ``ops/ring_attention.py`` in the JAX package, with its
semantics: the model outside attention sees the whole sequence on every
rank; each rank attends its own ``S/ring`` query chunk, and the output is
gathered along S. The entry into and the exit from the rank-local piece
are ``_regions.split`` and ``_regions.gather``, so a replicated loss
counts each gradient once.

Ring. Each rank keeps its query chunk and its K/V chunk; at step t the
K/V chunk resident on rank r came from rank (r - t) mod ring, and K/V
rotate one hop with ``batch_isend_irecv`` between steps. With equal
chunks a causal step's chunk is of one of three kinds: the diagonal
(t = 0), causal with offset 0; an earlier chunk, fully visible
(non-causal); a later chunk, fully masked, which is skipped (the JAX code
computes it masked to -1e30, which adds nothing). Each step attends with
the flash forward kernel and its lse (``flash_attention_fwd(...,
save_lse=True)`` on the card, the plain version on the CPU) and merges by
lse; a query chunk's first step is its diagonal, so no row starts fully
masked. The backward (:class:`_RingAttention`) rotates K/V again with
fp32 dk/dv accumulators beside them: each step's dq and dk/dv come from
the dq and dk/dv kernels with the MERGED lse and delta = rowsum(dO * O),
which make p the softmax over the whole sequence; after the last step one
more hop sends each chunk's dk/dv home.

Ulysses. An all-to-all takes the ranks from sequence-sharded to
head-sharded, the flash kernel attends the whole sequence of H/ring heads,
and an all-to-all goes back (``_regions.all_to_all``, whose backward is
the same all-to-all of the gradients). The JAX code attends with
``reference_attention`` there; the port uses its kernel on the card and
the plain version on the CPU.

:func:`ring_forward` and :func:`ring_backward` are one rank's loops;
:class:`_RingAttention` runs them over K/V chunks that rotate, and
:func:`ring_schedule` over every rank's chunks resident in one process, no
P2P: the kernel-side math of the ring, the same loop body on one card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from . import _regions
from .flash_attention import (
    flash_attention,
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_fwd,
    reference_attention,
    reference_delta,
    reference_flash_dkv,
    reference_flash_dq,
    reference_lse,
)

SKIP = None  # the kind of a fully masked step


def _sp_group(mesh, axis: str):
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"sequence-parallel attention needs a mesh with "
                         f"an {axis!r} axis")
    return mesh.get_group(axis)


def step_kind(rank: int, src: int, causal: bool):
    """What rank ``rank``'s query chunk does with the K/V chunk of rank
    ``src``: ``True`` (the diagonal: causal, offset 0), ``False`` (fully
    visible) or :data:`SKIP` (fully masked)."""
    if not causal or src < rank:
        return False
    return True if src == rank else SKIP


def attend_chunk(q, k, v, causal: bool, scale: float):
    """(o, lse) of one step over [BH, c, D] chunks: the forward kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cuda":
        return flash_attention_fwd(q, k, v, causal, scale, save_lse=True)
    return (reference_attention(q, k, v, causal, scale),
            reference_lse(q, k, causal, scale))


def merge(o_acc, lse_acc, o, lse):
    """Two softmax-normalised partial attentions over disjoint key sets,
    merged by their lse: (o fp32, lse)."""
    lse_new = torch.logaddexp(lse_acc, lse)
    return (o_acc * torch.exp(lse_acc - lse_new)
            + o.float() * torch.exp(lse - lse_new)), lse_new


def chunk_grads(q, k, v, do, lse, delta, causal: bool, scale: float):
    """(dq, dk, dv) of one step, from the merged ``lse`` and ``delta``: the
    dq and dk/dv kernels on CUDA tensors, the plain versions on CPU."""
    if q.device.type == "cuda":
        dq = flash_attention_dq(q, k, v, do, lse, delta, causal, scale)
        return (dq, *flash_attention_dkv(q, k, v, do, lse, delta, causal,
                                         scale))
    dq = reference_flash_dq(q, k, v, do, lse, delta, causal, scale)
    return (dq, *reference_flash_dkv(q, k, v, do, lse, delta, causal,
                                     scale))


def _rotate(tensors, group):
    """Send each tensor to the next rank of ``group`` and return the
    previous rank's."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    outs = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), nxt, group)
            for t in tensors]
           + [dist.P2POp(dist.irecv, o, prv, group) for o in outs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _Rotating:
    """The K/V chunks of a ring over ``group`` as this rank sees them: at
    step t the chunk of rank (r - t) mod n, brought one hop by
    :func:`_rotate`; with ``grads`` the fp32 dk/dv of each chunk travel
    with it, and :meth:`home` sends them back to the chunk's rank."""

    def __init__(self, k, v, group, grads: bool = False):
        self.group = group
        self.n, self.rank = dist.get_world_size(group), dist.get_rank(group)
        self.kv = [k, v]
        self.dkv = ([torch.zeros_like(t, dtype=torch.float32)
                     for t in (k, v)] if grads else [])

    def at(self, t: int):
        if t:
            moved = _rotate(self.kv + self.dkv, self.group)
            self.kv, self.dkv = moved[:2], moved[2:]
        return self.kv

    def add(self, t: int, dk, dv):
        self.dkv[0] += dk.float()
        self.dkv[1] += dv.float()

    def home(self):
        if self.n > 1:
            self.dkv = _rotate(self.dkv, self.group)
        return self.dkv


class _Resident:
    """Every ring rank's K/V chunks in one process, as rank ``rank`` sees
    them (step t: chunk (rank - t) mod n), with the chunks' shared fp32
    dk/dv sums ``dk``/``dv``: the ring without its P2P."""

    def __init__(self, ks, vs, rank: int, dk=None, dv=None):
        self.ks, self.vs, self.dk, self.dv = ks, vs, dk, dv
        self.n, self.rank = len(ks), rank

    def at(self, t: int):
        src = (self.rank - t) % self.n
        return self.ks[src], self.vs[src]

    def add(self, t: int, dk, dv):
        src = (self.rank - t) % self.n
        self.dk[src] += dk.float()
        self.dv[src] += dv.float()


def ring_forward(q, chunks, causal: bool, scale: float):
    """(o in q's dtype, merged lse) of one rank's query chunk ``q`` over
    the ring's K/V ``chunks`` (:class:`_Rotating` or :class:`_Resident`):
    each step's chunk attended by its kind and merged by lse."""
    o_acc = lse_acc = None
    for t in range(chunks.n):
        kc, vc = chunks.at(t)  # every step: the ring rotates on skips too
        kind = step_kind(chunks.rank, (chunks.rank - t) % chunks.n, causal)
        if kind is SKIP:
            continue
        o, lse = attend_chunk(q, kc, vc, kind, scale)
        o_acc, lse_acc = ((o.float(), lse) if o_acc is None
                          else merge(o_acc, lse_acc, o, lse))
    return o_acc.to(q.dtype), lse_acc


def ring_backward(q, do, out, lse, chunks, causal: bool, scale: float):
    """dq (q's dtype) of one rank's query chunk; each step's dk/dv go to
    ``chunks.add``. Every step's grads come from the MERGED ``lse`` and
    delta = rowsum(dO * O), which make p the softmax over the whole
    sequence."""
    delta = reference_delta(out, do)
    dq = torch.zeros_like(q, dtype=torch.float32)
    for t in range(chunks.n):
        kc, vc = chunks.at(t)
        kind = step_kind(chunks.rank, (chunks.rank - t) % chunks.n, causal)
        if kind is SKIP:
            continue
        dq_t, dk_t, dv_t = chunk_grads(q, kc, vc, do, lse, delta, kind,
                                       scale)
        dq += dq_t.float()
        chunks.add(t, dk_t, dv_t)
    return dq.to(q.dtype)


class _RingAttention(torch.autograd.Function):
    """Ring attention of this rank's [BH, c, D] chunks over ``group``."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool, scale: float):
        out, lse = ring_forward(q, _Rotating(k, v, group), causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        chunks = _Rotating(k, v, ctx.group, grads=True)
        dq = ring_backward(q, do.contiguous(), out, lse, chunks, ctx.causal,
                           ctx.scale)
        dk, dv = chunks.home()
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None


def _flat(t):
    B, H, S, D = t.shape
    return t.reshape(B * H, S, D).contiguous()


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = True,
                   scale: Optional[float] = None):
    """Attention over [B, H, S, D] tensors, whole on every rank of
    ``mesh``'s ``axis`` (S the global sequence); returns the whole [B, H,
    S, D] output on every rank, each rank having attended its S/ring
    query chunk around the ring."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    group = _sp_group(mesh, axis)
    B, H, _, D = q.shape
    q, k, v = (_regions.split(t, 2, group) for t in (q, k, v))
    c = q.shape[2]
    o = _RingAttention.apply(_flat(q), _flat(k), _flat(v), group, causal,
                             scale)
    return _regions.gather(o.reshape(B, H, c, D), 2, group)


def ulysses_attention(q, k, v, mesh, axis: str = "sp", causal: bool = True,
                      scale: Optional[float] = None):
    """Ulysses/DeepSpeed-style sequence parallelism over [B, H, S, D]
    tensors, whole on every rank: all-to-all from sequence-sharded to
    head-sharded, full-sequence attention of H/ring heads, all-to-all
    back; returns the whole output on every rank."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    group = _sp_group(mesh, axis)
    n = dist.get_world_size(group)
    B, H, S, D = q.shape
    if H % n:
        raise ValueError(f"heads {H} must divide over axis size {n}")
    hl, c = H // n, S // n

    def to_heads(t):  # [B, H, c, D] -> [B, H/n, S, D]
        t = t.reshape(B, n, hl, c, D).transpose(0, 1)
        t = _regions.all_to_all(t, group)   # [n (seq chunk), ...]
        return t.permute(1, 2, 0, 3, 4).reshape(B, hl, S, D)

    def to_seq(t):  # [B, H/n, S, D] -> [B, H, c, D]
        t = t.reshape(B, hl, n, c, D).permute(2, 0, 1, 3, 4)
        t = _regions.all_to_all(t, group)   # [n (head group), ...]
        return t.transpose(0, 1).reshape(B, H, c, D)

    q, k, v = (to_heads(_regions.split(t, 2, group)) for t in (q, k, v))
    o = flash_attention(q, k, v, causal=causal, scale=scale)
    return _regions.gather(to_seq(o), 2, group)


def ring_schedule(q, k, v, do, ring: int, causal: bool = True,
                  scale: Optional[float] = None):
    """The ring's per-chunk schedule for all ``ring`` ranks in one process,
    without P2P: each rank's :func:`ring_forward` and
    :func:`ring_backward`, as :class:`_RingAttention` runs them, over
    :class:`_Resident` chunks. [BH, S, D] inputs and ``do``; returns (o,
    dq, dk, dv) in the input dtype (the dk/dv sums in fp32, in chunk
    order)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    qs, ks, vs, dos = ([c.contiguous() for c in t.chunk(ring, dim=1)]
                       for t in (q, k, v, do))
    dk = [torch.zeros_like(t, dtype=torch.float32) for t in ks]
    dv = [torch.zeros_like(t, dtype=torch.float32) for t in vs]
    outs, dqs = [], []
    for r in range(ring):
        out, lse = ring_forward(qs[r], _Resident(ks, vs, r), causal, scale)
        dqs.append(ring_backward(qs[r], dos[r], out, lse,
                                 _Resident(ks, vs, r, dk, dv), causal,
                                 scale))
        outs.append(out)
    cat = lambda ts, like: torch.cat(ts, dim=1).to(like.dtype)  # noqa: E731
    return (torch.cat(outs, dim=1), torch.cat(dqs, dim=1), cat(dk, k),
            cat(dv, v))
