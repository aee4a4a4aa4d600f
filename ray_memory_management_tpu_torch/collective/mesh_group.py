"""dist-backend collectives: ``torch.distributed`` over a process group.

Counterpart of ``collective/mesh_group.py`` in the JAX package. There,
``MeshCollectives`` is ONE process holding every rank as shard *i* of a
stacked ``[world, ...]`` array, driven by ``shard_map`` programs over
ICI. In PyTorch one process is one rank: this class keeps the name and
the method set, but each method takes THIS rank's tensor and runs one
``torch.distributed`` collective over a process group — NCCL for CUDA
tensors, gloo for CPU tensors (the group's backend decides; a tensor on
the other kind of device raises instead of being copied across).

Results match the JAX methods row for row: rank i's result here is row
i of the JAX result. Quantized reductions (``precision="bf16"|"int8"``)
quantize this rank's tensor BEFORE the wire, all-gather the quantized
payload, and dequantize and reduce in fp32, with the JAX package's
``_dequant_stack`` math (256-element int8 blocks, absmax/127 scales,
round half to even), so both packages report the same error envelope.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .types import ReduceOp

_INT8_BLOCK = 256  # must match core/codec.py's block-wise scale grain

_STACK_REDUCERS = {
    ReduceOp.SUM: lambda s: s.sum(dim=0),
    ReduceOp.MAX: lambda s: s.amax(dim=0),
    ReduceOp.MIN: lambda s: s.amin(dim=0),
    ReduceOp.PRODUCT: lambda s: s.prod(dim=0),
}


def _dist():
    import torch.distributed as dist

    return dist


def _dist_op(op: str):
    dist = _dist()
    return {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
            ReduceOp.MIN: dist.ReduceOp.MIN}[op]


def quantize_blocks(t: torch.Tensor):
    """int8 block-wise absmax quantization of ``t`` (flattened, padded to
    256-element blocks): returns (q int8 [nblk, 256], scale f32 [nblk, 1]).
    The JAX ``_dequant_stack`` math, operation for operation."""
    flat = t.float().reshape(-1)
    pad = (-flat.numel()) % _INT8_BLOCK
    padded = torch.nn.functional.pad(flat, (0, pad)) if pad else flat
    blocks = padded.reshape(-1, _INT8_BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return q, scale


def _count_quantized(op: str, precision: str) -> None:
    from ..core.codec import count_quantized_op

    count_quantized_op(op, precision)


class MeshCollectives:
    """Collectives of this rank over the process's ``torch.distributed``
    world, which must already be initialized:
    ``init_collective_group(backend="dist")`` forms it."""

    def __init__(self, precision: Optional[str] = None):
        dist = _dist()
        if not dist.is_initialized():
            raise RuntimeError(
                "dist backend: no torch.distributed process group; call "
                "init_collective_group(backend='dist') or "
                "torch.distributed.init_process_group first")
        self.world_size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        # group-level default precision for the reduction collectives;
        # None defers to config.collective_precision, then "f32". A
        # per-call precision= always wins.
        self.precision = precision

    @property
    def device_type(self) -> str:
        """Where this group's tensors live: "cuda" for NCCL, "cpu" for
        gloo."""
        return "cuda" if self.backend == "nccl" else "cpu"

    # -- helpers --------------------------------------------------------------
    def _check(self, t: torch.Tensor) -> torch.Tensor:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"dist backend takes torch tensors, got "
                            f"{type(t).__name__}")
        if t.device.type != self.device_type:
            raise ValueError(
                f"dist group over {self.backend} takes {self.device_type} "
                f"tensors, got one on {t.device}")
        return t.contiguous()

    def _precision(self, precision):
        from .types import resolve_precision

        return resolve_precision(precision, self.precision)

    def _gather_list(self, t: torch.Tensor) -> List[torch.Tensor]:
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        _dist().all_gather(parts, t)
        return parts

    def _stack(self, t: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._gather_list(t))

    def _dequant_stack(self, t: torch.Tensor, precision: str
                       ) -> torch.Tensor:
        """Quantize this rank's tensor, all-gather the QUANTIZED payload
        (what crosses the wire: half the bytes for bf16, about a quarter
        for int8 plus scales) and return the dequantized [world, ...]
        float32 stack; the caller reduces over dim 0 in fp32."""
        if precision == "bf16":
            # bf16 travels as its bytes: every backend moves uint8
            raw = t.to(torch.bfloat16).reshape(-1).view(torch.uint8)
            halves = self._stack(raw).view(torch.bfloat16)
            return halves.float().reshape((self.world_size,) + t.shape)
        q, scale = quantize_blocks(t)
        gq, gs = self._stack(q), self._stack(scale)
        deq = (gq.float() * gs).reshape(self.world_size, -1)
        return deq[:, :t.numel()].reshape((self.world_size,) + t.shape)

    def _reduced(self, t: torch.Tensor, op: str, precision: str
                 ) -> torch.Tensor:
        """Every rank's reduction of ``t`` (allreduce's result)."""
        if precision != "f32":
            return _STACK_REDUCERS[op](self._dequant_stack(t, precision))
        if op == ReduceOp.PRODUCT:
            # gather-then-multiply: exact for zeros/negatives/ints
            return self._stack(t).prod(dim=0)
        out = t.clone()
        _dist().all_reduce(out, op=_dist_op(op))
        return out

    # -- collectives ----------------------------------------------------------
    def allreduce(self, tensor, op: str = ReduceOp.SUM,
                  precision: Optional[str] = None):
        """This rank's tensor -> the reduction over every rank.

        ``precision``: "f32" (bit-exact default) | "bf16" | "int8" —
        sub-f32 runs quantize-on-wire with f32 accumulation; the result
        dtype is float32 for quantized runs."""
        t = self._check(tensor)
        p = self._precision(precision)
        if p != "f32":
            _count_quantized("allreduce", p)
        return self._reduced(t, op, p)

    def reducescatter(self, tensor, op: str = ReduceOp.SUM,
                      precision: Optional[str] = None):
        """[world*n, ...] on every rank -> rank i holds slice i of the
        reduction along dim 0 ([n, ...])."""
        t = self._check(tensor)
        p = self._precision(precision)
        if t.shape[0] % self.world_size:
            raise ValueError(
                f"reducescatter: dim 0 ({t.shape[0]}) is not a multiple "
                f"of the world size {self.world_size}")
        n = t.shape[0] // self.world_size
        if p != "f32":
            _count_quantized("reducescatter", p)
        elif op == ReduceOp.SUM:
            out = torch.empty((n,) + t.shape[1:], dtype=t.dtype,
                              device=t.device)
            _dist().reduce_scatter_tensor(out, t)
            return out
        full = self._reduced(t, op, p)
        return full[self.rank * n:(self.rank + 1) * n].clone()

    def allgather(self, tensor):
        """This rank's tensor -> the [world, ...] stack of every rank's."""
        return self._stack(self._check(tensor))

    def broadcast(self, tensor, root: int = 0):
        """Every rank's result equals root's input."""
        out = self._check(tensor).clone()
        _dist().broadcast(out, src=root)
        return out

    def ppermute(self, tensor, perm):
        """Neighbour exchange: for each (src, dst) pair, dst receives src's
        tensor; a rank that no pair names as dst gets zeros (the
        ``lax.ppermute`` semantics). The ring-attention building block."""
        dist = _dist()
        t = self._check(tensor)
        out = torch.zeros_like(t)
        ops = []
        for src, dst in perm:
            if src == dst == self.rank:
                out = t.clone()
            elif src == self.rank:
                ops.append(dist.P2POp(dist.isend, t, dst))
            elif dst == self.rank:
                ops.append(dist.P2POp(dist.irecv, out, src))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def send_recv(self, tensor, src: int, dst: int):
        """P2P as a degenerate collective-permute (reference send/recv,
        collective.py:531,594)."""
        return self.ppermute(tensor, [(src, dst)])

    def reduce(self, tensor, root_rank: int = 0, op: str = ReduceOp.SUM,
               precision: Optional[str] = None):
        """Rooted reduce: root's result holds the reduction; other ranks
        get their input back (float32 for quantized runs), as in the
        reference's collective.reduce (util/collective/collective.py:311)."""
        dist = _dist()
        t = self._check(tensor)
        p = self._precision(precision)
        if p != "f32":
            _count_quantized("reduce", p)
            out = _STACK_REDUCERS[op](self._dequant_stack(t, p))
            return out if self.rank == root_rank else t.float()
        if op == ReduceOp.PRODUCT:
            out = self._stack(t).prod(dim=0)
            return out if self.rank == root_rank else t
        out = t.clone()
        dist.reduce(out, dst=root_rank, op=_dist_op(op))
        return out if self.rank == root_rank else t

    def barrier(self):
        device = (torch.device("cuda", torch.cuda.current_device())
                  if self.device_type == "cuda" else torch.device("cpu"))
        self.allreduce(torch.zeros(1, device=device), precision="f32")
