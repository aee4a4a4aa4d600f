"""The bf16 forward's one new rounding, held on the CPU.

The card's bf16 forward for a head dim of 64 or 128 (the wgmma design in
``csrc/flash_attention_fwd.cu``) makes one rounding the TPU kernel does
not: p is rounded to bf16 before P V, because the product runs on the
tensor cores with P as a bf16 operand. :func:`_tiled_forward` below
is a plain emulation of that kernel's arithmetic: 64-row query tiles and
64-key tiles, the causal tile skip, scores in fp32 from bf16 inputs with
the scale applied after the product, the TPU kernel's -1e30 mask and
-inf for tail columns, the online softmax in fp32 with exp2, l summed
from the fp32 p, p rounded to bf16 for P V, and o rounded to bf16 at the
end. It is used nowhere on the port's path.

The same bf16-representable numpy inputs go through it and through the
JAX package's ``reference_attention`` and Pallas ``_flash_fwd`` (in
interpret mode on the CPU), in fp32. The output is held at the
tolerance the card holds the kernel to, ``atol = rtol = 1e-2``
(chip_smoke.py and tests/test_torch_cuda.py), and lse at ``atol 1e-3,
rtol 1e-4``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_memory_management_tpu.ops.flash_attention import (
    _flash_fwd as jax_flash_fwd,
    reference_attention as jax_reference,
)
from _port_fixtures import one_intra_op_thread  # noqa: F401

BLOCK = 64
NEG_BIG = -1e30
LOG2E = 1.4426950408889634
TOL = dict(atol=1e-2, rtol=1e-2)
LSE_TOL = dict(atol=1e-3, rtol=1e-4)


def _tiled_forward(q, k, v, causal: bool, scale: float,
                   p_dtype=torch.bfloat16):
    """The wgmma design's arithmetic on [BH, S, D] / [BH, Skv, D] bf16
    tensors; returns (o in q's dtype, lse fp32 [BH, S]). With fp32 inputs
    and ``p_dtype=torch.float32`` it is the TPU kernel's arithmetic."""
    bh, S, D = q.shape
    Skv = k.shape[1]
    off = Skv - S
    o = torch.empty_like(q)
    lse = torch.empty((bh, S), dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    for q0 in range(0, S, BLOCK):
        rows = torch.arange(q0, min(q0 + BLOCK, S))[:, None]
        n_k = -(-Skv // BLOCK)
        if causal:
            last = q0 + BLOCK - 1 + off
            n_k = 0 if last < 0 else min(n_k, last // BLOCK + 1)
        m = torch.full((bh, len(rows), 1), NEG_BIG)
        l = torch.zeros((bh, len(rows), 1))
        acc = torch.zeros((bh, len(rows), D))
        for k0 in range(0, n_k * BLOCK, BLOCK):
            cols = torch.arange(k0, min(k0 + BLOCK, Skv))[None, :]
            s = qf[:, q0:q0 + BLOCK] @ kf[:, k0:k0 + BLOCK].transpose(1, 2)
            s = s * scale
            if causal and k0 + BLOCK - 1 > q0 + off:
                s = s.masked_fill(cols > rows + off, NEG_BIG)
            # a tail tile takes only the keys that exist, as the
            # kernel's -inf tail columns add nothing
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2((m - m_new) * LOG2E)
            p = torch.exp2((s - m_new) * LOG2E)
            l = l * alpha + p.sum(-1, keepdim=True)  # the fp32 p
            pv = p.to(p_dtype).float() @ vf[:, k0:k0 + BLOCK]
            acc = acc * alpha + pv
            m = m_new
        li = l.clamp_min(1e-30)
        o[:, q0:q0 + BLOCK] = (acc / li).to(q.dtype)
        lse[:, q0:q0 + BLOCK] = (m + torch.log(li))[..., 0]
    return o, lse


CASES = [
    pytest.param(4, 200, 200, 64, True, id="d64-causal"),
    pytest.param(4, 200, 200, 64, False, id="d64"),
    pytest.param(4, 67, 200, 64, True, id="d64-causal-S<Skv"),
    pytest.param(4, 200, 67, 64, False, id="d64-S>Skv"),
    pytest.param(2, 130, 130, 128, True, id="d128-causal"),
    pytest.param(2, 96, 160, 128, False, id="d128-S<Skv"),
]


@functools.lru_cache(maxsize=None)
def _case(bh, s, skv, d, causal):
    """bf16-representable inputs from a seed (as fp32 numpy arrays), and
    JAX's reference output, its Pallas forward's output and lse on them."""
    rng = np.random.default_rng(bh * 1000 + s + skv + d)

    def mk(n):
        x = torch.from_numpy(rng.normal(size=(bh, n, d)).astype(np.float32))
        return x.to(torch.bfloat16).float().numpy()

    q, k, v = mk(s), mk(skv), mk(skv)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    ref = np.asarray(jax_reference(jq, jk, jv, causal=causal))
    block = 32 if s % 32 == 0 and skv % 32 == 0 else 512
    kern, lse = jax_flash_fwd(jq, jk, jv, causal, d ** -0.5, block, block,
                              interpret=True)
    return (q, k, v), ref, np.asarray(kern), np.asarray(lse)[..., 0]


@pytest.mark.parametrize("bh,s,skv,d,causal", CASES)
def test_tiled_bf16_rounding_fits_the_kernel_tolerance(bh, s, skv, d,
                                                       causal):
    (q, k, v), ref, kern, kern_lse = _case(bh, s, skv, d, causal)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    o, lse = _tiled_forward(*bf, causal, d ** -0.5)
    o = o.float().numpy()
    np.testing.assert_allclose(o, ref, **TOL)
    np.testing.assert_allclose(o, kern, **TOL)
    np.testing.assert_allclose(lse.numpy(), kern_lse, **LSE_TOL)


def test_the_p_rounding_is_what_moves_the_output():
    # in fp32 with p kept fp32 the emulation is the TPU kernel's
    # arithmetic and lands on the Pallas kernel far inside the tolerance;
    # the bf16 p is what moves it, so the test above holds that rounding
    (q, k, v), _, kern, kern_lse = _case(4, 200, 200, 64, True)
    f32 = [torch.from_numpy(a) for a in (q, k, v)]
    o32, lse32 = _tiled_forward(*f32, True, 64 ** -0.5, torch.float32)
    np.testing.assert_allclose(o32.numpy(), kern, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse32.numpy(), kern_lse, atol=1e-5, rtol=0)
    o, _ = _tiled_forward(*f32, True, 64 ** -0.5, torch.bfloat16)
    assert np.abs(o.numpy() - kern).max() > 1e-4
