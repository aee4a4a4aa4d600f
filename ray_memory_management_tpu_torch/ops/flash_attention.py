"""Flash attention: hand-written CUDA kernels for Hopper, forward and
backward, with the plain PyTorch version of each beside it.

Counterpart of ``ops/flash_attention.py`` in the JAX package. Its Pallas
``_fwd_kernel`` becomes ``csrc/flash_attention_fwd.cu``; its
``_dq_kernel`` and ``_dkv_kernel`` become the two kernels of
``csrc/flash_attention_bwd.cu``; both libraries are built by :mod:`._build`
at first use. Its ``_flash_attention`` custom_vjp becomes
:class:`_FlashAttention`. :func:`flash_attention` picks the route from
where the tensors lie: a CUDA tensor launches the kernels (or raises;
there is no fallback), a CPU tensor takes the plain versions through the
same autograd glue.

Each kernel has two designs, picked by :func:`fwd_design` and
:func:`bwd_design` by one rule. bf16 with a head dim of 64 or 128 (both
main paths) takes the ``wgmma`` kernels: their products run on the tensor
cores from TMA-fed bf16 tiles, because the SIMT kernels' fp32 FMAs were
what bounded them on the H100 (37-42x above their bounds at the training
shape). The backward's ``wgmma`` kernels split p and ds into two bf16
halves (hi = bf16(x), lo = bf16(x - hi)) and run each product that takes
them once per half: one bf16 rounding of p and ds breaks the backward's
bf16 tolerance (tests/test_torch_flash_bwd_tiled.py). fp32, the parity
route held to 1e-4, and any other head dim take the ``simt`` kernels,
fp32 FMAs on the CUDA cores.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import _build

_NEG_INF = -1e30
FWD = "flash_attention_fwd"
DQ = "flash_attention_dq"
DKV = "flash_attention_dkv"
MAX_HEAD_DIM = 128

WGMMA, SIMT = "wgmma", "simt"  # every kernel's two designs
WGMMA_HEAD_DIMS = (64, 128)

# kernel launches since the last reset_launch_count(), by kernel, and by
# design
_launches: Dict[str, int] = {FWD: 0, DQ: 0, DKV: 0}
_fwd_designs: Dict[str, int] = {WGMMA: 0, SIMT: 0}
_bwd_designs: Dict[str, Dict[str, int]] = {DQ: {WGMMA: 0, SIMT: 0},
                                           DKV: {WGMMA: 0, SIMT: 0}}


def launch_count() -> int:
    """Launches of the forward kernel since the last
    :func:`reset_launch_count` (:func:`launch_counts` has every kernel's);
    calls that took the plain version are not counted."""
    return _launches[FWD]


def launch_counts() -> Dict[str, int]:
    """Launches of every kernel since the last :func:`reset_launch_count`."""
    return dict(_launches)


def fwd_design_counts() -> Dict[str, int]:
    """Forward launches since the last :func:`reset_launch_count`, by the
    design that ran: ``{"wgmma": n, "simt": n}``."""
    return dict(_fwd_designs)


def bwd_design_counts() -> Dict[str, Dict[str, int]]:
    """Backward launches since the last :func:`reset_launch_count`, by
    kernel and the design that ran: ``{DQ: {"wgmma": n, "simt": n},
    DKV: {...}}``."""
    return {kernel: dict(counts) for kernel, counts in _bwd_designs.items()}


def reset_launch_count() -> None:
    for counts in (_launches, _fwd_designs, *_bwd_designs.values()):
        for name in counts:
            counts[name] = 0


def fwd_design(dtype: torch.dtype, head_dim: int) -> str:
    """The forward design ``rmt_flash_fwd`` launches for these inputs (the
    C function applies the same rule): ``wgmma`` for bf16 with a head dim
    of 64 or 128, ``simt`` otherwise."""
    return (WGMMA if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS
            else SIMT)


def bwd_design(dtype: torch.dtype, head_dim: int) -> str:
    """The design ``rmt_flash_bwd_dq`` and ``rmt_flash_bwd_dkv`` launch for
    these inputs, by the forward's rule (the C functions apply it too)."""
    return fwd_design(dtype, head_dim)


def _scores(q, k, causal: bool, scale: float):
    """fp32 scores ``q k^T * scale`` with the bottom-right causal mask: query
    row i sees key cols <= i + (Skv - S)."""
    S, Skv = q.shape[-2], k.shape[-2]
    s = torch.einsum("...qd,...kd->...qk", q, k).float() * scale
    if causal:
        qi = torch.arange(S, device=q.device)[:, None] + (Skv - S)
        ki = torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(ki > qi, _NEG_INF)
    return s


def reference_attention(q, k, v, causal: bool = True,
                        scale: Optional[float] = None):
    """Plain attention (the correctness oracle)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    p = torch.softmax(_scores(q, k, causal, scale), dim=-1)
    return torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v)


def reference_lse(q, k, causal: bool = True, scale: Optional[float] = None):
    """The forward kernel's saved statistic, plainly: ``logsumexp`` of the
    scaled, masked scores, as [..., S, 1] fp32."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return torch.logsumexp(_scores(q, k, causal, scale), dim=-1,
                           keepdim=True)


def _recompute(q, k, v, do, lse, delta, causal: bool, scale: float):
    """(p, ds) in fp32, recomputed from lse as the backward kernels do: the
    scale goes on after QK^T (the forward puts it on q)."""
    p = torch.exp(_scores(q.float(), k.float(), causal, scale) - lse)
    dp = torch.einsum("...qd,...kd->...qk", do.float(), v.float())
    return p, p * (dp - delta) * scale


def reference_delta(o, do):
    """delta = rowsum(dO * O) in fp32, [..., S, 1] (JAX ``_flash_bwd``)."""
    return (do.float() * o.float()).sum(dim=-1, keepdim=True)


def reference_flash_dq(q, k, v, do, lse, delta, causal: bool = True,
                       scale: Optional[float] = None):
    """The dq kernel's function, plainly: ``dq = ds k``, in q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _, ds = _recompute(q, k, v, do, lse, delta, causal, scale)
    return torch.einsum("...qk,...kd->...qd", ds, k.float()).to(q.dtype)


def reference_flash_dkv(q, k, v, do, lse, delta, causal: bool = True,
                        scale: Optional[float] = None):
    """The dk/dv kernel's function, plainly: ``dk = ds^T q``,
    ``dv = p^T dO``, in k's and v's dtypes."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    p, ds = _recompute(q, k, v, do, lse, delta, causal, scale)
    dk = torch.einsum("...qk,...qd->...kd", ds, q.float()).to(k.dtype)
    dv = torch.einsum("...qk,...qd->...kd", p, do.float()).to(v.dtype)
    return dk, dv


def reference_flash_bwd(q, k, v, o, lse, do, causal: bool = True,
                        scale: Optional[float] = None):
    """Plain PyTorch version of :func:`flash_attention_bwd`: the same
    recompute formulas, in fp32, each output rounded once to its input's
    dtype. Returns (dq, dk, dv)."""
    delta = reference_delta(o, do)
    dq = reference_flash_dq(q, k, v, do, lse, delta, causal, scale)
    return (dq, *reference_flash_dkv(q, k, v, do, lse, delta, causal, scale))


_libs: Dict[str, ctypes.CDLL] = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_BWD_SYMBOL = {DQ: "rmt_flash_bwd_dq", DKV: "rmt_flash_bwd_dkv"}
_SIGNATURES = {
    FWD: {"rmt_flash_fwd": [_P] * 5 + [_I] * 4 + [_F, _I, _I, _P],
          "rmt_flash_fwd_simt": [_P] * 5 + [_I] * 4 + [_F, _I, _I, _P]},
    "flash_attention_bwd": {
        f"{symbol}{suffix}": [_P] * n + [_I] * 4 + [_F, _I, _I, _P]
        for symbol, n in (("rmt_flash_bwd_dq", 7), ("rmt_flash_bwd_dkv", 8))
        for suffix in ("", "_simt")
    },
}


def _kernel_lib(source: str) -> ctypes.CDLL:
    """The library built from ``csrc/<source>.cu``, built and bound on
    first use."""
    lib = _libs.get(source)
    if lib is None:
        lib = _build.load(source)
        for fn, argtypes in _SIGNATURES[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.rmt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rmt_cuda_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    return lib


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(fn: str, named, q, k):
    """The checks every kernel wrapper makes; returns (BH, S, Skv, D)."""
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} is on {t.device}, not a CUDA "
                             "device")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{fn}: {name} has dtype {t.dtype}; the kernel "
                            "takes float32 or bfloat16")
        if t.dim() != 3:
            raise ValueError(f"{fn}: {name} must be [BH, S, D], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
    if len({t.dtype for _, t in named}) != 1:
        raise TypeError(f"{fn}: {', '.join(n for n, _ in named)} dtypes "
                        "differ")
    if len({t.device for _, t in named}) != 1:
        raise ValueError(f"{fn}: inputs lie on different devices")
    BH, S, D = q.shape
    Skv = k.shape[1]
    for name, t in named:
        rows = S if name in ("q", "o", "do") else Skv
        if t.shape != (BH, rows, D):
            raise ValueError(f"{fn}: shapes "
                             + ", ".join(f"{n} {tuple(x.shape)}"
                                         for n, x in named) + " disagree")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{fn}: head dim {D} > {MAX_HEAD_DIM}")
    return BH, S, Skv, D


def _raise_on(err: int, lib: ctypes.CDLL, fn: str) -> None:
    if err != 0:
        msg = lib.rmt_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} (cudaError {err})")


def _launch_fwd(symbol: str, q, k, v, causal: bool, scale: Optional[float],
                save_lse: bool):
    """Check the forward's inputs, launch ``symbol`` of the forward
    library on them, and return ``(o, lse)`` (lse None unless
    ``save_lse``) and whether it launched."""
    BH, S, Skv, D = _check("flash_attention_fwd",
                           (("q", q), ("k", k), ("v", v)), q, k)
    scale = scale if scale is not None else D ** -0.5
    o = torch.empty_like(q)
    lse = (torch.empty((BH, S, 1), dtype=torch.float32, device=q.device)
           if save_lse else None)
    if BH == 0 or S == 0:
        return o, lse, False
    if Skv == 0:
        raise ValueError("flash_attention_fwd: no keys (Skv = 0)")
    lib = _kernel_lib(FWD)
    with torch.cuda.device(q.device):  # the launch goes to the current device
        err = getattr(lib, symbol)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            BH, S, Skv, D, float(scale), int(bool(causal)),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    _raise_on(err, lib, "flash_attention_fwd")
    return o, lse, True


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None,
                        save_lse: bool = False):
    """Launch the forward kernel on [BH, S, D] / [BH, Skv, D] CUDA tensors.

    Returns ``o`` ([BH, S, D], input dtype), or ``(o, lse)`` with lse
    [BH, S, 1] fp32 when ``save_lse``. The design follows
    :func:`fwd_design`; a failed build or launch of either raises. Raises
    on anything the kernel does not take: a non-CUDA tensor, a dtype other
    than fp32/bf16, mixed dtypes or devices, a non-contiguous tensor, or
    D > 128."""
    o, lse, launched = _launch_fwd("rmt_flash_fwd", q, k, v, causal, scale,
                                   save_lse)
    if launched:
        _launches[FWD] += 1
        _fwd_designs[fwd_design(q.dtype, q.shape[-1])] += 1
    return (o, lse) if save_lse else o


def flash_attention_fwd_simt(q, k, v, causal: bool = True,
                             scale: Optional[float] = None,
                             save_lse: bool = False):
    """The forward's SIMT design whatever the dtype and head dim, to time
    it beside the wgmma design on the same inputs. No path of the port
    calls it, and its launches are not counted."""
    o, lse, _ = _launch_fwd("rmt_flash_fwd_simt", q, k, v, causal, scale,
                            save_lse)
    return (o, lse) if save_lse else o


def _check_stats(fn: str, BH: int, S: int, device, **stats) -> None:
    for name, t in stats.items():
        if (t.device != device or t.dtype != torch.float32
                or t.shape != (BH, S, 1) or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous fp32 "
                             f"[BH, S, 1] = {(BH, S, 1)} tensor on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch_bwd(kernel: str, q, k, v, do, lse, delta, causal: bool,
                scale: Optional[float], simt: bool = False):
    """Check the inputs of one backward kernel, launch it (its SIMT design
    whatever the inputs if ``simt``; such launches are not counted), and
    return its outputs: ``(dq,)`` for :data:`DQ`, ``(dk, dv)`` for
    :data:`DKV`."""
    BH, S, Skv, D = _check(kernel, (("q", q), ("k", k), ("v", v),
                                    ("do", do)), q, k)
    _check_stats(kernel, BH, S, q.device, lse=lse, delta=delta)
    scale = scale if scale is not None else D ** -0.5
    outs = ((torch.empty_like(q),) if kernel == DQ
            else (torch.empty_like(k), torch.empty_like(v)))
    if BH == 0 or S == 0 or Skv == 0:
        return tuple(t.zero_() for t in outs)
    lib = _kernel_lib("flash_attention_bwd")
    symbol = _BWD_SYMBOL[kernel] + ("_simt" if simt else "")
    with torch.cuda.device(q.device):
        err = getattr(lib, symbol)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            BH, S, Skv, D, float(scale), int(bool(causal)),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    _raise_on(err, lib, kernel)
    if not simt:
        _launches[kernel] += 1
        _bwd_designs[kernel][bwd_design(q.dtype, D)] += 1
    return outs


def flash_attention_dq(q, k, v, do, lse, delta, causal: bool = True,
                       scale: Optional[float] = None):
    """Launch the dq kernel: ``dq`` [BH, S, D] in the input dtype, from
    q, dO [BH, S, D], k, v [BH, Skv, D] and lse, delta [BH, S, 1] fp32."""
    return _launch_bwd(DQ, q, k, v, do, lse, delta, causal, scale)[0]


def flash_attention_dkv(q, k, v, do, lse, delta, causal: bool = True,
                        scale: Optional[float] = None):
    """Launch the dk/dv kernel: ``(dk, dv)`` [BH, Skv, D] in the input
    dtype, from the same inputs as :func:`flash_attention_dq`."""
    return _launch_bwd(DKV, q, k, v, do, lse, delta, causal, scale)


def flash_attention_dq_simt(q, k, v, do, lse, delta, causal: bool = True,
                            scale: Optional[float] = None):
    """The dq kernel's SIMT design whatever the dtype and head dim, to time
    it beside the wgmma design on the same inputs. No path of the port
    calls it, and its launches are not counted."""
    return _launch_bwd(DQ, q, k, v, do, lse, delta, causal, scale,
                       simt=True)[0]


def flash_attention_dkv_simt(q, k, v, do, lse, delta, causal: bool = True,
                             scale: Optional[float] = None):
    """The dk/dv kernel's SIMT design, as :func:`flash_attention_dq_simt`."""
    return _launch_bwd(DKV, q, k, v, do, lse, delta, causal, scale,
                       simt=True)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        scale: Optional[float] = None):
    """The backward pass on CUDA tensors: (dq, dk, dv) in the input dtype.

    q, o, dO are [BH, S, D], k, v [BH, Skv, D], lse [BH, S, 1] fp32 from
    ``flash_attention_fwd(..., save_lse=True)``. delta = rowsum(dO * O) is
    one elementwise pass in PyTorch (outside any kernel in JAX too); then
    the dq kernel and the dk/dv kernel launch. Raises on what the kernels
    do not take, as :func:`flash_attention_fwd` does: the two kernel
    wrappers check every input but ``o``, which only delta reads."""
    _check("flash_attention_bwd", (("o", o),), q, k)
    delta = reference_delta(o, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal, scale)
    return (dq, *flash_attention_dkv(q, k, v, do, lse, delta, causal, scale))


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX ``_flash_attention`` custom_vjp over
    [BH, S, D] inputs: the kernels on CUDA tensors, the plain versions (the
    reference forward plus lse, and :func:`reference_flash_bwd`) on CPU
    tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, save: bool):
        if q.device.type == "cuda":
            if not save:  # inference: the kernel writes no lse
                return flash_attention_fwd(q, k, v, causal, scale)
            out, lse = flash_attention_fwd(q, k, v, causal, scale,
                                           save_lse=True)
        else:
            out = reference_attention(q, k, v, causal, scale)
            lse = reference_lse(q, k, causal, scale) if save else None
        if save:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()  # the model hands back a transposed view
        bwd = (flash_attention_bwd if q.device.type == "cuda"
               else reference_flash_bwd)
        dq, dk, dv = bwd(q, k, v, out, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None,
                    use_kernel: Optional[str] = None):
    """Multi-head attention over [B, H, S, D] (or [BH, S, D]) inputs;
    differentiable.

    ``use_kernel``: None or "on" picks the route from the device — the
    CUDA kernels for CUDA tensors, the plain versions for CPU tensors, both
    through :class:`_FlashAttention` (the forward saves lse only when an
    input requires grad); "off" is autograd through
    :func:`reference_attention` (the JAX package's ``use_pallas="off"``)."""
    if use_kernel not in (None, "on", "off"):
        raise ValueError(f"use_kernel must be None, 'on' or 'off', got "
                         f"{use_kernel!r}")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if use_kernel == "off":
        return reference_attention(q, k, v, causal, scale)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if q.dim() == 4:
        B, H, S, D = q.shape
        out = _FlashAttention.apply(
            q.reshape(B * H, S, D).contiguous(),
            k.reshape(B * H, k.shape[-2], D).contiguous(),
            v.reshape(B * H, v.shape[-2], D).contiguous(),
            causal, scale, save)
        return out.reshape(q.shape)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, scale, save)
