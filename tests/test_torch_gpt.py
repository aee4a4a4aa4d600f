"""PyTorch port vs JAX package: the GPT TransformerLM.

JAX ``init_params(PRNGKey(0))`` on the ``test`` preset with fp32 compute
(plus a GQA variant with two kv heads) crosses into the port through
numpy and ``params_from_jax``; the same numpy-seeded tokens then go
through both packages on the CPU. Logits are held at
``rtol=atol=1e-4`` (fp32, sums taken in another order), greedy tokens
exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_memory_management_tpu.models import gpt as jgpt
from ray_memory_management_tpu_torch.models import gpt as tgpt
from ray_memory_management_tpu_torch.models.convert import params_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(kv_heads):
    jcfg = dataclasses.replace(jgpt.PRESETS["test"], dtype=jnp.float32,
                               n_kv_heads=kv_heads)
    tcfg = dataclasses.replace(tgpt.PRESETS["test"], dtype=torch.float32,
                               n_kv_heads=kv_heads)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=[None, 2], ids=["mha", "gqa"])
def model(request):
    jcfg, tcfg = _configs(request.param)
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _np(t):
    return t.detach().float().numpy()


def test_params_from_jax_is_leaf_for_leaf(model):
    jcfg, jparams, tcfg, tparams = model
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(jflat) == sum(1 for _ in _walk(tparams))
    for path, leaf in jflat:
        t = tparams
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def _walk(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _walk(v)
        else:
            yield v


def test_params_from_jax_carries_bf16_bits():
    a = jnp.asarray(np.random.default_rng(0).normal(size=(3, 5)),
                    jnp.bfloat16)
    t = params_from_jax({"w": np.asarray(a)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))


def test_init_params_layout_matches_jax():
    jcfg, tcfg = _configs(2)
    jp = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tgpt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert shapes == jax.tree.map(lambda t: tuple(t.shape), tp)


def test_forward_matches_jax(model):
    jcfg, jparams, tcfg, tparams = model
    toks = _tokens((2, 24), 1)
    ref = np.asarray(jgpt.forward(jparams, jnp.asarray(toks), jcfg))
    out = tgpt.forward(tparams, torch.from_numpy(toks), tcfg)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), ref, **TOL)
    ref_cfg = dataclasses.replace(tcfg, attention="ref")
    np.testing.assert_allclose(
        _np(tgpt.forward(tparams, torch.from_numpy(toks), ref_cfg)), ref,
        **TOL)


def test_cached_prefill_and_decode_match_jax(model):
    jcfg, jparams, tcfg, tparams = model
    B, S, T = 2, 16, 32
    toks = _tokens((B, S), 2)
    jcache = jgpt.init_kv_cache(jcfg, B, T)
    tcache = tgpt.init_kv_cache(tcfg, B, T, device="cpu")
    jl, jcache = jgpt.forward_with_cache(jparams, jnp.asarray(toks), jcache,
                                         0, jcfg)
    tl, tcache = tgpt.forward_with_cache(tparams, torch.from_numpy(toks),
                                         tcache, 0, tcfg)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    nxt = _tokens((B, 1), 3)
    for step in range(3):
        jl, jcache = jgpt.forward_with_cache(
            jparams, jnp.asarray(nxt), jcache, S + step, jcfg)
        tl, tcache = tgpt.forward_with_cache(
            tparams, torch.from_numpy(nxt), tcache, S + step, tcfg)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    for part in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[part]),
                                   np.asarray(jcache[part]), **TOL)


def test_cache_rows_mixed_offsets_match_jax(model):
    jcfg, jparams, tcfg, tparams = model
    B, S, T = 3, 4, 32
    shape = (tcfg.n_layers, B, tcfg.kv_heads, T, tcfg.head_dim)
    rng = np.random.default_rng(4)
    start = {p: rng.normal(size=shape).astype(np.float32) for p in "kv"}
    # the last row runs past the cache end: its write window is clamped
    offsets = np.array([0, 5, 30], np.int32)
    toks = _tokens((B, S), 5)
    jl, jcache = jgpt.forward_with_cache_rows(
        jparams, jnp.asarray(toks),
        {p: jnp.asarray(a) for p, a in start.items()},
        jnp.asarray(offsets), jcfg)
    tl, tcache = tgpt.forward_with_cache_rows(
        tparams, torch.from_numpy(toks),
        {p: torch.from_numpy(a.copy()) for p, a in start.items()},
        torch.from_numpy(offsets), tcfg)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for part in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[part]),
                                   np.asarray(jcache[part]), **TOL)


def test_greedy_generate_matches_jax(model):
    jcfg, jparams, tcfg, tparams = model
    prompt = _tokens((2, 12), 6)
    ref = np.asarray(jgpt.generate(jparams, jcfg, jnp.asarray(prompt),
                                   steps=6))
    out = tgpt.generate(tparams, tcfg, torch.from_numpy(prompt), steps=6)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_later_slices_raise():
    tp = tgpt.init_params(tgpt.PRESETS["test"], device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    for cfg in (tgpt.PRESETS["test-moe"],
                dataclasses.replace(tgpt.PRESETS["test"], attention="ring"),
                dataclasses.replace(tgpt.PRESETS["test"],
                                    attention="ulysses")):
        with pytest.raises(NotImplementedError):
            tgpt.forward(tp, toks, cfg)


def test_entry_points_refuse_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.init_params(tgpt.PRESETS["test"])
