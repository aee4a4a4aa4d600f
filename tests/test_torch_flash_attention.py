"""PyTorch port vs JAX package: flash attention.

The port's CPU route (its plain version) is held against the JAX
package's ``reference_attention`` and against its Pallas forward kernel
run in interpret mode, on the same numpy inputs, at fp32 tolerance
``atol=2e-5`` (as tests/test_ops.py holds the Pallas kernel). The CUDA
kernel's own cases are in tests/test_torch_cuda.py, which runs on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_memory_management_tpu.ops import flash_attention as jax_flash
from ray_memory_management_tpu.ops import reference_attention as jax_ref
from ray_memory_management_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_fwd,
    launch_count,
    reference_attention,
    reset_launch_count,
)
from _port_fixtures import one_intra_op_thread  # noqa: F401

ATOL = 2e-5

# (shape of q, Skv, causal, JAX block size for interpret mode)
CASES = [
    pytest.param((2, 4, 128, 32), 128, False, 32, id="noncausal"),
    pytest.param((2, 4, 128, 32), 128, True, 32, id="causal-multiblock"),
    pytest.param((1, 3, 64, 32), 128, True, 32, id="prefix-S<Skv"),
    pytest.param((1, 2, 67, 16), 67, True, 512, id="odd-length-causal"),
    pytest.param((1, 2, 67, 16), 67, False, 512, id="odd-length"),
    pytest.param((6, 48, 64), 80, True, 16, id="bh-3d-prefix"),
]


def _inputs(q_shape, skv, seed=0):
    rng = np.random.default_rng(seed)
    kv_shape = q_shape[:-2] + (skv, q_shape[-1])
    return (rng.normal(size=q_shape).astype(np.float32),
            rng.normal(size=kv_shape).astype(np.float32),
            rng.normal(size=kv_shape).astype(np.float32))


@pytest.mark.parametrize("q_shape,skv,causal,block", CASES)
def test_plain_route_matches_jax(q_shape, skv, causal, block):
    q, k, v = _inputs(q_shape, skv)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    ref = np.asarray(jax_ref(jq, jk, jv, causal=causal))
    kern = np.asarray(jax_flash(jq, jk, jv, causal=causal,
                                use_pallas="interpret", block_q=block,
                                block_k=block))
    np.testing.assert_allclose(out, ref, atol=ATOL)
    np.testing.assert_allclose(out, kern, atol=ATOL)


def test_cpu_routes_to_plain_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs((2, 2, 32, 16), 32, 1))
    reset_launch_count()
    base = reference_attention(q, k, v, causal=True)
    for use in (None, "on", "off"):
        out = flash_attention(q, k, v, causal=True, use_kernel=use)
        torch.testing.assert_close(out, base, rtol=0, atol=0)
    assert launch_count() == 0
    with pytest.raises(ValueError):
        flash_attention(q, k, v, use_kernel="interpret")


def test_kernel_wrapper_refuses_cpu_tensors():
    # the wrapper launches or raises; it never falls back to the plain
    # version on its own
    q, k, v = (torch.from_numpy(a) for a in _inputs((2, 16, 8), 16, 2))
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash_attention_fwd(q, k, v)
    assert launch_count() == 0


def test_reference_uses_bottom_right_causal_alignment():
    # with Skv > S the last query row sees every key: its output equals
    # the non-causal output, and the first row sees Skv - S + 1 keys
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 4, 8), 12, 3))
    causal = reference_attention(q, k, v, causal=True)
    full = reference_attention(q, k, v, causal=False)
    torch.testing.assert_close(causal[:, -1], full[:, -1])
    first = reference_attention(q[:, :1], k[:, :9], v[:, :9],
                                causal=False)
    torch.testing.assert_close(causal[:, :1], first)
