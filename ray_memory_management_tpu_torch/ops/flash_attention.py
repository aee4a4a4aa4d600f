"""Flash attention forward: a hand-written CUDA kernel for Hopper, with the
plain PyTorch version beside it.

Counterpart of ``ops/flash_attention.py`` in the JAX package, whose
Pallas ``_fwd_kernel`` this replaces. The kernel lives in
``csrc/flash_attention_fwd.cu`` and is built by :mod:`._build` at first
use. :func:`flash_attention` picks the route from where the tensors lie:
a CPU tensor takes :func:`reference_attention`, a CUDA tensor launches
the kernel (or raises; there is no fallback). Forward only: the two
backward kernels (dq, dk/dv) belong to the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_NEG_INF = -1e30
KERNEL = "flash_attention_fwd"
MAX_HEAD_DIM = 128

_launches = 0  # kernel launches since the last reset_launch_count()


def launch_count() -> int:
    """Kernel launches made by :func:`flash_attention_fwd` since the last
    :func:`reset_launch_count` (calls that took the plain version are not
    counted)."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def reference_attention(q, k, v, causal: bool = True,
                        scale: Optional[float] = None):
    """Plain attention (the correctness oracle). The causal mask is
    bottom-right aligned: query row i sees key cols <= i + (Skv - S)."""
    S, D = q.shape[-2], q.shape[-1]
    Skv = k.shape[-2]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("...qd,...kd->...qk", q, k).float() * scale
    if causal:
        qi = torch.arange(S, device=q.device)[:, None] + (Skv - S)
        ki = torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(ki > qi, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v)


_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    """The kernel's library, built and bound on first use."""
    global _lib
    if _lib is None:
        lib = _build.load(KERNEL)
        lib.rmt_flash_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.rmt_flash_fwd.restype = ctypes.c_int
        lib.rmt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rmt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None,
                        save_lse: bool = False):
    """Launch the CUDA kernel on [BH, S, D] / [BH, Skv, D] CUDA tensors.

    Returns ``o`` ([BH, S, D], input dtype), or ``(o, lse)`` with lse
    [BH, S, 1] fp32 when ``save_lse``. Raises on anything the kernel does
    not take: a non-CUDA tensor, a dtype other than fp32/bf16, mixed
    dtypes or devices, a non-contiguous tensor, or D > 128."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_fwd: {name} is on {t.device},"
                             " not a CUDA device")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"flash_attention_fwd: {name} has dtype "
                            f"{t.dtype}; the kernel takes float32 or "
                            "bfloat16")
        if t.dim() != 3:
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             f"[BH, S, D], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} is not "
                             "contiguous")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention_fwd: q, k, v dtypes differ")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_fwd: q, k, v devices differ")
    BH, S, D = q.shape
    Skv = k.shape[1]
    if k.shape != (BH, Skv, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_fwd: head dim {D} > "
                         f"{MAX_HEAD_DIM}")
    scale = scale if scale is not None else D ** -0.5
    o = torch.empty_like(q)
    lse = (torch.empty((BH, S, 1), dtype=torch.float32, device=q.device)
           if save_lse else None)
    if BH == 0 or S == 0:
        return (o, lse) if save_lse else o
    if Skv == 0:
        raise ValueError("flash_attention_fwd: no keys (Skv = 0)")
    lib = _kernel_lib()
    with torch.cuda.device(q.device):  # the launch goes to the current device
        err = lib.rmt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            BH, S, Skv, D, float(scale), int(bool(causal)),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.rmt_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: {msg} "
                           f"(cudaError {err})")
    global _launches
    _launches += 1
    return (o, lse) if save_lse else o


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None,
                    use_kernel: Optional[str] = None):
    """Multi-head attention over [B, H, S, D] (or [BH, S, D]) inputs.

    ``use_kernel``: None or "on" picks the route from the device — the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    "off" always takes the plain version (the JAX package's
    ``use_pallas="off"``). Forward only: inputs that require grad raise
    NotImplementedError on the kernel route rather than falling back to
    autograd through the plain version."""
    if use_kernel not in (None, "on", "off"):
        raise ValueError(f"use_kernel must be None, 'on' or 'off', got "
                         f"{use_kernel!r}")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if use_kernel == "off" or q.device.type == "cpu":
        return reference_attention(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError("backward kernels: next slice")
    if q.dim() == 4:
        B, H, S, D = q.shape
        out = flash_attention_fwd(
            q.reshape(B * H, S, D).contiguous(),
            k.reshape(B * H, k.shape[-2], D).contiguous(),
            v.reshape(B * H, v.shape[-2], D).contiguous(),
            causal, scale)
        return out.reshape(q.shape)
    return flash_attention_fwd(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal, scale)
