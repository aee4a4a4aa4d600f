"""Collective types: backends and reduce ops.

Counterpart of ``collective/types.py`` in the JAX package (the reference
enumerates NCCL and GLOO, python/ray/util/collective/types.py:29-34). The
port's two backends:

  - DIST: ``torch.distributed`` on the caller's device, NCCL for CUDA
    tensors and gloo for CPU tensors (the JAX package's XLA role: the
    collectives of one process group, one rank per process);
    ``xla`` and ``nccl`` are aliases of it, so copied user code maps one
    to one;
  - OBJSTORE: the object-plane backend with a named-actor rendezvous
    (the Gloo analog of the reference; ``gloo`` is its alias, as in the
    JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass


class Backend:
    DIST = "dist"
    OBJSTORE = "objstore"
    # the JAX package's names and the reference's resolve as before:
    # xla/nccl to the process-group backend, gloo to the object plane
    _ALIASES = {"dist": DIST, "xla": DIST, "nccl": DIST,
                "gloo": OBJSTORE, "objstore": OBJSTORE}

    @classmethod
    def resolve(cls, name: str) -> str:
        try:
            return cls._ALIASES[name.lower()]
        except KeyError:
            raise ValueError(
                f"unknown collective backend {name!r}; "
                f"use one of {sorted(set(cls._ALIASES.values()))}"
            )


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


#: wire precisions for the reduction collectives. f32 is bit-exact;
#: bf16/int8 quantize each rank's contribution BEFORE the wire and
#: dequantize+accumulate at f32 (EQuARX-style — block-wise scale factors
#: for int8). Strictly opt-in: per-call ``precision=`` > group default >
#: config.collective_precision > "f32".
PRECISIONS = ("f32", "bf16", "int8")


def resolve_precision(call_precision, group_precision):
    """The precedence chain above, shared by both backends; raises on an
    unknown precision at the call site."""
    p = call_precision if call_precision is not None else group_precision
    if p is None:
        try:
            from ..config import global_config

            p = getattr(global_config(), "collective_precision", None)
        except Exception:  # noqa: BLE001 — config import cycles in tools
            p = None
    p = p or "f32"
    if p not in PRECISIONS:
        raise ValueError(
            f"unknown collective precision {p!r} (want one of "
            f"{PRECISIONS})")
    return p


@dataclass
class AllReduceOptions:
    reduceOp: str = ReduceOp.SUM
    timeout_ms: int = 30_000


@dataclass
class BarrierOptions:
    timeout_ms: int = 30_000


@dataclass
class ReduceOptions:
    reduceOp: str = ReduceOp.SUM
    root_rank: int = 0
    timeout_ms: int = 30_000


@dataclass
class BroadcastOptions:
    root_rank: int = 0
    timeout_ms: int = 30_000


@dataclass
class AllGatherOptions:
    timeout_ms: int = 30_000


@dataclass
class ReduceScatterOptions:
    reduceOp: str = ReduceOp.SUM
    timeout_ms: int = 30_000
