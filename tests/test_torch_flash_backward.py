"""PyTorch port vs JAX package: the flash attention backward.

The same numpy inputs go through the port's plain backward
(``reference_flash_bwd``) and its autograd glue on the CPU (the route a
CPU tensor takes through ``flash_attention``), and through the JAX
package's Pallas backward kernels (``_flash_bwd``, interpret mode) and
``jax.grad`` of its ``reference_attention``. Everything is fp32; the
tolerance is ``atol=5e-4, rtol=1e-3``, as tests/test_ops.py holds the
Pallas backward against autodiff (sums over up to 128 keys taken in
another order, through the recompute of p from lse). The CUDA kernels'
own cases are in tests/test_torch_cuda.py, which runs on a card.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_memory_management_tpu.ops.flash_attention import (
    _flash_bwd as jax_flash_bwd,
    _flash_fwd as jax_flash_fwd,
    reference_attention as jax_reference,
)
from ray_memory_management_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_dkv,
    flash_attention_dq,
    launch_counts,
    reference_attention,
    reference_flash_bwd,
    reference_lse,
    reset_launch_count,
)

TOL = dict(atol=5e-4, rtol=1e-3)

# (shape of q, Skv, causal, JAX block size for interpret mode): the cases
# of tests/test_ops.py — causal and not, several blocks, prefix S < Skv,
# odd length (one JAX block, ragged 64-row tiles on the card)
CASES = [
    pytest.param((2, 4, 128, 32), 128, False, 32, id="noncausal-multiblock"),
    pytest.param((2, 4, 128, 32), 128, True, 32, id="causal-multiblock"),
    pytest.param((3, 64, 32), 128, True, 32, id="prefix-S<Skv"),
    pytest.param((1, 2, 67, 16), 67, True, 512, id="odd-length-causal"),
    pytest.param((1, 2, 67, 16), 67, False, 512, id="odd-length"),
]


def _inputs(q_shape, skv, seed=0):
    rng = np.random.default_rng(seed)
    kv_shape = q_shape[:-2] + (skv, q_shape[-1])
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in (q_shape, kv_shape, kv_shape, q_shape))


def _flat(a):
    """[B, H, S, D] -> [BH, S, D] (the kernels' layout); 3-D stays."""
    return a.reshape((-1,) + a.shape[-2:])


@functools.lru_cache(maxsize=None)
def _jax_kernels(q_shape, skv, causal, block):
    """JAX's Pallas forward (lse) and backward kernels in interpret mode on
    the case's inputs (computed once per case: interpret mode is slow)."""
    q, k, v, do = (jnp.asarray(_flat(a)) for a in _inputs(q_shape, skv))
    scale = q.shape[-1] ** -0.5
    o, lse = jax_flash_fwd(q, k, v, causal, scale, block, block,
                           interpret=True)
    dq, dk, dv = jax_flash_bwd(q, k, v, o, lse, do, causal, scale, block,
                               block, interpret=True)
    return (np.array(o), np.array(lse),
            tuple(np.array(g) for g in (dq, dk, dv)))


def _jax_autodiff(q, k, v, do, causal):
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jax_reference(q_, k_, v_, causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return tuple(np.asarray(g) for g in vjp(jnp.asarray(do)))


@pytest.mark.parametrize("q_shape,skv,causal,block", CASES)
def test_plain_backward_matches_jax_kernels(q_shape, skv, causal, block):
    q, k, v, do = _inputs(q_shape, skv)
    o, lse, want = _jax_kernels(q_shape, skv, causal, block)
    t = [torch.from_numpy(_flat(a)) for a in (q, k, v)]
    # the forward statistic first: lse as the JAX kernel saved it
    np.testing.assert_allclose(
        reference_lse(*t[:2], causal).numpy(), lse, atol=1e-5, rtol=1e-5)
    got = reference_flash_bwd(*t, torch.from_numpy(o.copy()),
                              torch.from_numpy(lse.copy()),
                              torch.from_numpy(_flat(do)), causal)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("q_shape,skv,causal,block", CASES)
def test_autograd_through_flash_attention_matches_jax(q_shape, skv, causal,
                                                      block):
    q, k, v, do = _inputs(q_shape, skv)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    reset_launch_count()
    out = flash_attention(*t, causal=causal)
    got = torch.autograd.grad(out, t, torch.from_numpy(do))
    assert launch_counts() == dict.fromkeys(launch_counts(), 0)
    # the CPU route's forward is the plain forward, exactly
    torch.testing.assert_close(
        out.detach(), reference_attention(*(x.detach() for x in t), causal),
        rtol=0, atol=0)
    autodiff = _jax_autodiff(q, k, v, do, causal)
    _, _, kernels = _jax_kernels(q_shape, skv, causal, block)
    for name, g, a, kern in zip("qkv", got, autodiff, kernels):
        assert g.shape == tuple(a.shape), name
        np.testing.assert_allclose(g.numpy(), a, **TOL, err_msg=f"d{name}")
        np.testing.assert_allclose(_flat(g.numpy()), kern, **TOL,
                                   err_msg=f"d{name} vs the Pallas kernel")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_use_kernel_off_is_autograd_through_the_plain_forward(causal):
    q, k, v, do = _inputs((2, 2, 48, 16), 48, seed=2)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    reset_launch_count()
    got = torch.autograd.grad(flash_attention(*t, causal=causal,
                                              use_kernel="off"),
                              t, torch.from_numpy(do))
    want = torch.autograd.grad(reference_attention(*t, causal=causal), t,
                               torch.from_numpy(do))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for g, a in zip(got, _jax_autodiff(q, k, v, do, causal)):
        np.testing.assert_allclose(g.numpy(), a, **TOL)
    assert sum(launch_counts().values()) == 0


def test_gradients_through_a_transposed_view():
    # the model feeds [B, S, H, D] tensors transposed to [B, H, S, D]; the
    # incoming grad is then a non-contiguous view, which the glue copies
    q, k, v, do = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                   for a in _inputs((2, 3, 40, 16), 40, seed=3))
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*(x.transpose(1, 2) for x in t)).transpose(1, 2)
    got = torch.autograd.grad(out, t, torch.from_numpy(do))
    want = torch.autograd.grad(
        reference_attention(*(x.transpose(1, 2) for x in t)).transpose(1, 2),
        t, torch.from_numpy(do))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_no_grad_forward_saves_nothing():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs((2, 24, 8), 24, 4))
    out = flash_attention(q, k, v)
    assert out.grad_fn is None
    with torch.no_grad():
        assert flash_attention(q.requires_grad_(), k, v).grad_fn is None


def test_backward_wrappers_refuse_cpu_tensors():
    # the kernel wrappers launch or raise; they never fall back to the
    # plain version on their own
    q, k, v, do = (torch.from_numpy(a) for a in _inputs((2, 16, 8), 16, 5))
    lse = reference_lse(q, k)
    delta = torch.zeros_like(lse)
    reset_launch_count()
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash_attention_bwd(q, k, v, reference_attention(q, k, v), lse, do)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash_attention_dq(q, k, v, do, lse, delta)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash_attention_dkv(q, k, v, do, lse, delta)
    assert sum(launch_counts().values()) == 0
