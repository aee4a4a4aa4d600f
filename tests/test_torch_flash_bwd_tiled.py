"""The bf16 backward's new roundings, held on the CPU.

The card's bf16 backward for a head dim of 64 or 128 (the wgmma design in
``csrc/flash_attention_bwd.cu``) runs the three products that take p or ds
(dq = ds k, dk = ds^T q, dv = p^T dO) on the tensor cores, with p or ds as
a bf16 operand. One bf16 rounding of p and ds is too coarse for the
backward's bf16 tolerance, so the kernels split each into
``hi = bf16(x)`` and ``lo = bf16(x - hi)`` and run each of those products
once per half. :func:`_tiled_backward` below is a plain emulation of that
arithmetic: 64-row query and key tiles, the causal tile skip, scores in
fp32 from bf16 inputs with the scale applied after the product, the TPU
kernel's -1e30 mask, p = exp2((s - lse) log2 e), ds = p (dp - delta)
scale, p and ds split into bf16 hi + lo before the products that take
them, fp32 sums, and each output rounded once to bf16. It is used nowhere
on the port's path.

The same bf16-representable numpy inputs go through it and through the
JAX package's Pallas ``_flash_bwd`` (interpret mode on the CPU, with o and
lse from its ``_flash_fwd``), in fp32. Each output is held to the bound
``chip_smoke.py`` holds the card's bf16 backward to, ``2^-8 |ref| +
1e-3 max|ref|`` (``BWD_TOL``).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_memory_management_tpu.ops.flash_attention import (
    _flash_bwd as jax_flash_bwd,
    _flash_fwd as jax_flash_fwd,
)

BLOCK = 64
NEG_BIG = -1e30
LOG2E = 1.4426950408889634
RTOL, ATOL_OF_MAX = 2.0 ** -8, 1e-3  # chip_smoke.py BWD_TOL["bfloat16"]


def _halves(x, operand: str):
    """The bf16 operands a product takes for the fp32 tile x, as fp32:
    ``split`` gives hi and lo, ``single`` one rounding, ``fp32`` x."""
    if operand == "fp32":
        return (x,)
    hi = x.to(torch.bfloat16).float()
    if operand == "single":
        return (hi,)
    return hi, (x - hi).to(torch.bfloat16).float()


def _tiled_backward(q, k, v, do, lse, delta, causal: bool, scale: float,
                    operand: str = "split", out_dtype=torch.bfloat16):
    """The wgmma design's arithmetic on fp32 [BH, S, D] / [BH, Skv, D]
    tensors holding bf16 values, lse and delta [BH, S, 1]; returns (dq, dk,
    dv) in ``out_dtype``, as fp32. Each (q tile, key tile) pair the causal
    skip admits is visited once, in the order both kernels sum it: dq over
    key tiles, dk and dv over q tiles."""
    bh, S, D = q.shape
    Skv = k.shape[1]
    off = Skv - S
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for q0 in range(0, S, BLOCK):
        qs = slice(q0, q0 + BLOCK)
        rows = torch.arange(q0, min(q0 + BLOCK, S))[:, None]
        for k0 in range(0, Skv, BLOCK):
            if causal and k0 > q0 + BLOCK - 1 + off:
                break  # this and every later key tile is fully masked
            ks = slice(k0, k0 + BLOCK)
            cols = torch.arange(k0, min(k0 + BLOCK, Skv))[None, :]
            x = (q[:, qs] @ k[:, ks].transpose(1, 2)) * scale
            if causal:
                x = x.masked_fill(cols > rows + off, NEG_BIG)
            p = torch.exp2((x - lse[:, qs]) * LOG2E)
            dp = do[:, qs] @ v[:, ks].transpose(1, 2)
            ds = p * (dp - delta[:, qs]) * scale
            for a in _halves(ds, operand):
                dq[:, qs] += a @ k[:, ks]
                dk[:, ks] += a.transpose(1, 2) @ q[:, qs]
            for a in _halves(p, operand):
                dv[:, ks] += a.transpose(1, 2) @ do[:, qs]
    return tuple(t.to(out_dtype).float() for t in (dq, dk, dv))


@functools.lru_cache(maxsize=None)
def _case(bh, s, skv, d, causal):
    """bf16-representable inputs from a seed (fp32 tensors), o's delta and
    lse from the JAX package's Pallas forward, and its Pallas backward's
    (dq, dk, dv) on them."""
    rng = np.random.default_rng(bh * 1000 + s + skv + d + int(causal))

    def mk(n):
        x = torch.from_numpy(rng.normal(size=(bh, n, d)).astype(np.float32))
        return x.to(torch.bfloat16).float()

    q, k, v, do = mk(s), mk(skv), mk(skv), mk(s)
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
    # one JAX block per 512 rows, or the whole length where 512 does not
    # divide it (interpret mode pays per grid step)
    bq, bk = (512 if n % 512 == 0 else n for n in (s, skv))
    scale = d ** -0.5
    o, lse = jax_flash_fwd(jq, jk, jv, causal, scale, bq, bk, interpret=True)
    ref = jax_flash_bwd(jq, jk, jv, o, lse, jdo, causal, scale, bq, bk,
                        interpret=True)
    lse = torch.from_numpy(np.array(lse))
    delta = (do * torch.from_numpy(np.array(o))).sum(-1, keepdim=True)
    return (q, k, v, do, lse, delta), tuple(
        torch.from_numpy(np.array(r)) for r in ref)


def _worst_ratio(got, ref):
    """max |got - ref| / (2^-8 |ref| + 1e-3 max|ref|): at most 1 passes."""
    limit = RTOL * ref.abs() + ATOL_OF_MAX * ref.abs().max()
    return ((got - ref).abs() / limit).max().item()


CASES = [
    pytest.param(2, 1024, 1024, 64, True, id="train-shape-causal"),
    pytest.param(2, 1024, 1024, 64, False, id="noncausal"),
    pytest.param(2, 992, 1024, 64, True, id="causal-S<Skv"),
    pytest.param(2, 200, 67, 64, False, id="S>Skv"),
    pytest.param(2, 67, 67, 64, True, id="odd-67-causal"),
    pytest.param(2, 131, 131, 64, False, id="odd-131"),
    pytest.param(2, 96, 160, 128, True, id="d128-causal-S<Skv"),
]


@pytest.mark.parametrize("bh,s,skv,d,causal", CASES)
def test_split_bf16_backward_fits_the_kernel_tolerance(bh, s, skv, d,
                                                       causal):
    inputs, ref = _case(bh, s, skv, d, causal)
    got = _tiled_backward(*inputs, causal, d ** -0.5)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert _worst_ratio(g, r) <= 1.0, name


def test_the_emulation_is_the_tpu_kernels_arithmetic_without_roundings():
    # with p and ds kept fp32 and fp32 outputs it lands on the Pallas
    # kernels far inside the tolerance: the bf16 roundings are what the
    # test above holds
    inputs, ref = _case(2, 200, 67, 64, False)
    got = _tiled_backward(*inputs, False, 64 ** -0.5, operand="fp32",
                          out_dtype=torch.float32)
    for g, r in zip(got, ref):
        assert _worst_ratio(g, r) < 0.01


def test_one_bf16_rounding_of_p_and_ds_breaks_the_tolerance_the_split_keeps():
    # the training shape's causal mask at BH = 4: rounding p and ds once to
    # bf16 puts some elements past the bound; the hi + lo split keeps every
    # output under 0.8 of it (the rest is mostly the outputs' own rounding)
    inputs, ref = _case(4, 1024, 1024, 64, True)
    single = _tiled_backward(*inputs, True, 64 ** -0.5, operand="single")
    split = _tiled_backward(*inputs, True, 64 ** -0.5)
    assert max(_worst_ratio(g, r) for g, r in zip(single, ref)) > 1.0
    assert max(_worst_ratio(g, r) for g, r in zip(split, ref)) < 0.8


if __name__ == "__main__":
    # the worst error over the bound per case, split and single rounding;
    # from the repository's root:
    #   PYTHONPATH=. JAX_PLATFORMS=cpu \
    #       python tests/test_torch_flash_bwd_tiled.py
    for case in CASES + [pytest.param(4, 1024, 1024, 64, True,
                                      id="train-shape-causal-bh4")]:
        bh, s, skv, d, causal = case.values
        inputs, ref = _case(bh, s, skv, d, causal)
        worst = {op: max(_worst_ratio(g, r) for g, r in zip(
            _tiled_backward(*inputs, causal, d ** -0.5, operand=op), ref))
            for op in ("split", "single")}
        print(f"{case.id:24s} split {worst['split']:.3f} "
              f"single {worst['single']:.3f}")
