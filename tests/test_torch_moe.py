"""PyTorch port vs JAX package: the MoE FFN (``ops/moe.py``) and the MoE
TransformerLM, on the CPU.

JAX ``init_params(PRNGKey(0))`` of the ``test-moe`` preset (4 experts,
top-2, capacity factor 1.25) crosses into the port leaf for leaf through
numpy; the same numpy-seeded inputs go through both packages.
Tolerances:

- ``moe_ffn`` in fp32: outputs to 1e-5 relative to their largest value,
  the aux loss to 1e-6 relative; the routing tensors are taken where each
  package feeds them to its einsums: ``dispatch`` (0/1) equal element for
  element, ``combine`` to 1e-6 (fp32 gate products, normalised);
- the bf16 model against JAX's bf16 model: a bf16 rounding can flip a
  token's expert, so 99 % of the logits within 5e-2 (the JAX test's rule,
  ``tests/test_models.py:226-231``);
- the serve engine's greedy tokens: equal.

Also copied: ``tests/test_models.py::TestMoE`` (4 cases, tensors for
arrays), and the finding that the JAX engine's idle slots take expert
capacity from a live request (a fault of the reference), beside the
port's engine, which routes only live rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_memory_management_tpu.models import gpt as jgpt
from ray_memory_management_tpu.ops import moe as jmoe
from ray_memory_management_tpu.serve.llm import ContinuousBatcher as JEngine
from ray_memory_management_tpu_torch.models import gpt as tgpt
from ray_memory_management_tpu_torch.models.convert import params_from_jax
from ray_memory_management_tpu_torch.ops import moe as tmoe
from ray_memory_management_tpu_torch.serve.llm import (
    ContinuousBatcher as TEngine,
)
from _port_fixtures import one_intra_op_thread  # noqa: F401

DISPATCH, COMBINE = "gtec,gtd->egcd", "gtec,egcd->gtd"


def _configs(dtype_j=jnp.float32, dtype_t=torch.float32, **kw):
    return (dataclasses.replace(jgpt.PRESETS["test-moe"], dtype=dtype_j,
                                **kw),
            dataclasses.replace(tgpt.PRESETS["test-moe"], dtype=dtype_t,
                                **kw))


@pytest.fixture(scope="module")
def params():
    jp = jgpt.init_params(jax.random.PRNGKey(0), _configs()[0])
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _record(monkeypatch, module, specs):
    """Capture the operands each package passes to its einsums named in
    ``specs`` (their routing tensors)."""
    seen = {}
    einsum = module.einsum

    def spy(spec, *ops, **kw):
        if spec in specs:
            seen[spec] = ops
        return einsum(spec, *ops, **kw)

    monkeypatch.setattr(module, "einsum", spy)
    return seen


@pytest.mark.parametrize("shape,top_k,factor", [
    ((2, 24), 2, 1.25), ((1, 13), 1, 1.0), ((2, 64), 2, 0.5),
    ((1, 257), 2, 1.25)], ids=["top2", "top1-odd", "tight", "prime-g1"])
def test_moe_ffn_matches_jax_in_fp32(params, monkeypatch, shape, top_k,
                                     factor):
    jp, tp = params
    jcfg, tcfg = _configs(expert_top_k=top_k, expert_capacity_factor=factor)
    x = np.random.default_rng(0).normal(size=shape + (64,)).astype(
        np.float32)
    jlayer = {k: v[1] for k, v in jp["layers"].items()}
    tlayer = {k: v[1] for k, v in tp["layers"].items()}
    jseen = _record(monkeypatch, jmoe.jnp, (DISPATCH, COMBINE))
    jout, jaux = jmoe.moe_ffn(jnp.asarray(x), jlayer, jcfg)
    tseen = _record(monkeypatch, tmoe.torch, (DISPATCH, COMBINE))
    tout, taux = tmoe.moe_ffn(torch.from_numpy(x), tlayer, tcfg)
    want = np.asarray(jout)
    scale = np.abs(want).max()
    np.testing.assert_allclose(tout.numpy(), want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)
    np.testing.assert_array_equal(tseen[DISPATCH][0].numpy(),
                                  np.asarray(jseen[DISPATCH][0]))
    np.testing.assert_allclose(tseen[COMBINE][0].numpy(),
                               np.asarray(jseen[COMBINE][0]), rtol=0,
                               atol=1e-6)


def test_live_mask_keeps_tokens_out_of_routing(params):
    """Masked tokens take no capacity and no aux share. Row 0 of 4 is
    live: in one group of 64 tokens at capacity factor 0.5 (16 slots an
    expert) its 16 tokens are never dropped, so its outputs and the aux
    equal row 0 routed alone as a group of 16 with the same 16 slots
    (factor 2.0); unmasked, the other rows' tokens crowd it out. The
    masked rows' outputs are zero."""
    _, tp = params
    layer = {k: v[0] for k, v in tp["layers"].items()}
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 16, 64)).astype(np.float32))
    live = torch.zeros(4, 16, dtype=torch.bool)
    live[0] = True
    tight = _configs(expert_capacity_factor=0.5)[1]
    out, aux = tmoe.moe_ffn(x, layer, tight, live=live)
    alone, aux_alone = tmoe.moe_ffn(
        x[:1], layer, _configs(expert_capacity_factor=2.0)[1])
    assert torch.all(out[1:] == 0)
    np.testing.assert_allclose(out[:1].numpy(), alone.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(aux.item(), aux_alone.item(), rtol=1e-6)
    crowded, _ = tmoe.moe_ffn(x, layer, tight)
    assert not torch.allclose(crowded[:1], alone, atol=1e-3)


# --------------------------------------------- copies of TestMoE (JAX)
class TestMoE:
    def test_moe_forward_and_loss(self):
        cfg = dataclasses.replace(tgpt.PRESETS["test-moe"], attention="ref")
        p = tgpt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        assert tuple(p["layers"]["w1"].shape) == (2, 4, 64, cfg.ff_dim)
        toks = torch.randint(0, cfg.vocab_size, (2, 16),
                             generator=torch.Generator().manual_seed(1))
        logits, aux = tgpt.forward_with_aux(p, toks, cfg)
        assert tuple(logits.shape) == (2, 16, cfg.vocab_size)
        assert torch.isfinite(logits).all()
        # balanced-ish routing: aux near its minimum (1.0 for uniform)
        assert 0.5 < aux.item() < 4.0, aux.item()

    def test_moe_trains(self):
        cfg = dataclasses.replace(tgpt.PRESETS["test-moe"], attention="ref")
        p = tgpt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = torch.randint(0, cfg.vocab_size, (4, 16),
                             generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
        leaves = [t.requires_grad_() for t in tgpt.param_leaves(p)]
        opt = torch.optim.Adam(leaves, lr=3e-3)
        losses = []
        for _ in range(6):
            opt.zero_grad()
            loss = tgpt.loss_fn(p, batch, cfg)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        assert losses[-1] < losses[0], losses

    def test_moe_capacity_drops_tokens(self):
        """A tight capacity factor still gives finite outputs (dropped
        tokens ride the residual)."""
        cfg = dataclasses.replace(tgpt.PRESETS["test-moe"], attention="ref",
                                  expert_capacity_factor=0.5,
                                  expert_top_k=1)
        p = tgpt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 32),
                             generator=torch.Generator().manual_seed(2))
        assert torch.isfinite(tgpt.forward(p, toks, cfg)).all()

    def test_moe_cached_decode_matches(self):
        """The KV-cached path routes through the same MoE FFN (bf16: 99 %
        of the logits within 5e-2, as the JAX test holds it)."""
        cfg = dataclasses.replace(tgpt.PRESETS["test-moe"], attention="ref")
        p = tgpt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        prompt = torch.randint(0, cfg.vocab_size, (1, 8),
                               generator=torch.Generator().manual_seed(3))
        cache = tgpt.init_kv_cache(cfg, 1, 8, device="cpu")
        cached, _ = tgpt.forward_with_cache(p, prompt, cache, 0, cfg)
        full = tgpt.forward(p, prompt, cfg)
        close = np.isclose(cached.numpy(), full.numpy(), rtol=5e-2,
                           atol=5e-2)
        assert close.mean() > 0.99, f"only {close.mean():.4f} close"


def test_bf16_logits_agree_with_jax_by_the_99_percent_rule(params):
    jp, tp = params
    jcfg, tcfg = _configs(jnp.bfloat16, torch.bfloat16)
    toks = np.random.default_rng(4).integers(0, 512, size=(2, 32))
    want = np.asarray(jgpt.forward(jp, jnp.asarray(toks), jcfg))
    got = tgpt.forward(tp, torch.from_numpy(toks), tcfg).numpy()
    close = np.isclose(got, want, rtol=5e-2, atol=5e-2)
    assert close.mean() > 0.99, f"only {close.mean():.4f} close"


# ------------------------------------------------------- the serve engine
def _engine_tokens(engine, prompts):
    try:
        return [engine.submit(p, timeout=300) for p in prompts]
    finally:
        engine.close()


def test_engine_matches_jax_engine_with_every_slot_live(params):
    """One slot, so every decode row is live: the port's paged engine
    gives JAX ``generate``'s greedy tokens, prompt after prompt, and so
    does the JAX engine where its prefill bucket adds no pad (the
    64-token prompt). A padded prompt routes its pads in the JAX engine
    (ROADMAP C3); the port prefills a MoE prompt without them
    (``tests/test_torch_moe_prefill.py``)."""
    jp, tp = params
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, 512, size=n).tolist() for n in (7, 64, 90)]
    want = [np.asarray(jgpt.generate(jp, jcfg, jnp.asarray([p]), 10))[
        0, len(p):].tolist() for p in prompts]
    jax_engine = _engine_tokens(
        JEngine(jp, jcfg, max_slots=1, max_new_tokens=10), prompts)
    got = _engine_tokens(TEngine(tp, tcfg, max_slots=1, max_new_tokens=10),
                         prompts)
    assert got == want
    assert jax_engine[1] == want[1]


def test_idle_slots_take_no_expert_capacity(params):
    """One request in an engine of 8 slots. The JAX engine decodes its 7
    idle rows through the MoE FFN beside it: they pick the same experts,
    fill their capacity, and the live token's second expert is dropped
    where it collides, so its greedy tokens leave ``generate``'s (a
    fault of the reference). The port's engine routes live rows only
    and gives ``generate``'s tokens (64-token prompts: no prefill pad)."""
    jp, tp = params
    jcfg, tcfg = _configs()
    differ = 0
    for seed in (0, 1, 3):
        prompt = np.random.default_rng(seed).integers(2, 512,
                                                      size=64).tolist()
        want = np.asarray(jgpt.generate(jp, jcfg, jnp.asarray([prompt]),
                                        12))[0, 64:].tolist()
        jax_engine = _engine_tokens(
            JEngine(jp, jcfg, max_slots=8, max_new_tokens=12,
                    kv_cache="slab"), [prompt])[0]
        port_engine = _engine_tokens(
            TEngine(tp, tcfg, max_slots=8, max_new_tokens=12,
                    kv_cache="slab"), [prompt])[0]
        port_generate = tgpt.generate(tp, tcfg, torch.tensor([prompt]),
                                      12)[0, 64:].tolist()
        assert port_generate == want
        assert port_engine == want, (seed, port_engine, want)
        differ += jax_engine != want
    assert differ > 0, "the JAX engine's idle rows changed no request"


def test_pinned_routing_replays_one_runs_choices_in_another():
    """``moe.pinned_routing``, which the chip checks use to compare two
    runs whose router inputs differ by rounding: a replay routes as the
    recorded run did (``dispatch`` equal), counts the tokens whose own
    choice differed, and restores the router's argmax on exit."""
    rng = np.random.default_rng(3)
    p1, p2 = (torch.softmax(torch.tensor(rng.normal(size=(2, 32, 4)),
                                         dtype=torch.float32), dim=-1)
              for _ in range(2))
    recorded, flips = [], []
    with tmoe.pinned_routing(record=recorded):
        _, d1 = tmoe.route(p1, 2, 20)
    with tmoe.pinned_routing(replay=recorded, flips=flips):
        _, d2 = tmoe.route(p2, 2, 20)
    assert tmoe.choose is tmoe._argmax
    assert len(recorded) == len(flips) == 2
    assert torch.equal(d1, d2)
    assert not torch.equal(d1, tmoe.route(p2, 2, 20)[1])
    assert int(flips[0]) == int((p2.argmax(-1) != recorded[0]).sum()) > 0
