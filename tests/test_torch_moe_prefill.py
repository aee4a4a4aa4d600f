"""A MoE prompt padded to its prefill bucket, in both packages' serve
engines, on the CPU.

The engines pad each prompt to a bucket (``pad_multiple``) before the
prefill. In a MoE model the pads would then route with the prompt: their
expert choices fill capacity ahead of the real tokens' second choices,
and the bucket, not the prompt, sets the dispatch group and its
capacity. The JAX engine does this, so its greedy tokens leave
``generate``'s on the unpadded prompt. The port's engine prefills a MoE
prompt over its own tokens and gives ``generate``'s tokens at every
bucket tried.

``test-moe`` (4 experts, top-2) at a tight capacity factor of 0.5, fp32;
JAX ``init_params(PRNGKey(0))`` crosses into the port through numpy.
Tokens are compared for equality.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_memory_management_tpu.models import gpt as jgpt
from ray_memory_management_tpu.serve.llm import ContinuousBatcher as JEngine
from ray_memory_management_tpu_torch.models import gpt as tgpt
from ray_memory_management_tpu_torch.models.convert import params_from_jax
from ray_memory_management_tpu_torch.serve.llm import (
    ContinuousBatcher as TEngine,
)
from _port_fixtures import one_intra_op_thread  # noqa: F401

FACTOR = 0.5
NEW = 8
LENGTHS = (5, 20, 33)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jgpt.PRESETS["test-moe"], dtype=jnp.float32,
                               expert_capacity_factor=FACTOR)
    tcfg = dataclasses.replace(tgpt.PRESETS["test-moe"], dtype=torch.float32,
                               expert_capacity_factor=FACTOR)
    jp = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, jcfg, tp, tcfg


def _tokens(engine, prompt):
    try:
        return engine.submit(prompt, timeout=300)
    finally:
        engine.close()


def _prompt(n):
    return np.random.default_rng(n).integers(2, 512, size=n).tolist()


@pytest.fixture(scope="module")
def generated(models):
    """JAX ``generate``'s greedy tokens on each unpadded prompt."""
    jp, jcfg, _, _ = models
    return {n: np.asarray(jgpt.generate(jp, jcfg, jnp.asarray([_prompt(n)]),
                                        NEW))[0, n:].tolist()
            for n in LENGTHS}


def test_generate_agrees_across_packages(models, generated):
    _, _, tp, tcfg = models
    for n in LENGTHS:
        got = tgpt.generate(tp, tcfg, torch.tensor([_prompt(n)]), NEW)
        assert got[0, n:].tolist() == generated[n]


@pytest.mark.parametrize("kv_cache", ["paged", "slab"])
@pytest.mark.parametrize("pad_multiple", [16, 64])
def test_padded_moe_prefill_gives_generate_tokens(models, generated,
                                                  pad_multiple, kv_cache):
    """Every prompt is padded (5 -> 16 or 64, 20 -> 32 or 64, 33 -> 48 or
    64): the port's engine gives ``generate``'s tokens on the unpadded
    prompt."""
    _, _, tp, tcfg = models
    for n in LENGTHS:
        got = _tokens(TEngine(tp, tcfg, max_slots=1, max_new_tokens=NEW,
                              pad_multiple=pad_multiple, kv_cache=kv_cache),
                      _prompt(n))
        assert got == generated[n], (n, got, generated[n])


@pytest.mark.parametrize("pad_multiple", [16, 64])
def test_the_jax_engine_routes_its_pads(models, generated, pad_multiple):
    """The reference shares the fault: its engine's tokens leave
    ``generate``'s for at least one padded prompt."""
    jp, jcfg, _, _ = models
    off = [n for n in LENGTHS
           if _tokens(JEngine(jp, jcfg, max_slots=1, max_new_tokens=NEW,
                              pad_multiple=pad_multiple), _prompt(n))
           != generated[n]]
    assert off, "the JAX engine's pads changed no request"


def test_dense_prefill_keeps_its_bucket(models, monkeypatch):
    """A dense model still prefills the padded bucket (the kernel shapes
    the serving path is measured at); only a MoE prefill drops the pad."""
    _, _, tp, tcfg = models
    seen = []
    forward = tgpt.forward_with_cache

    def spy(params, tokens, cache, offset, cfg, *a, **kw):
        if offset == 0:
            seen.append((cfg.n_experts, tokens.shape[1]))
        return forward(params, tokens, cache, offset, cfg, *a, **kw)

    monkeypatch.setattr(tgpt, "forward_with_cache", spy)
    dense = dataclasses.replace(tcfg, n_experts=0)
    dense_params = tgpt.init_params(dense, device="cpu")
    prompt = _prompt(20)
    _tokens(TEngine(dense_params, dense, max_slots=1, max_new_tokens=NEW,
                    pad_multiple=16), prompt)
    _tokens(TEngine(tp, tcfg, max_slots=1, max_new_tokens=NEW,
                    pad_multiple=16), prompt)
    assert seen == [(0, 32), (4, 20)]
