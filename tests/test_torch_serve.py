"""PyTorch port vs JAX package: the continuous-batching serve engine.

The port's ``ContinuousBatcher`` (paged and slab KV) is fed the same
converted parameters and prompts as the JAX package's, and must return
the same greedy tokens. The rest holds the port's engine to the JAX
engine's contracts on the CPU: retire frees every KV page, pool
exhaustion backpressures without losing a request, an injected
``serve.admit`` fault fails only its own request, and ``LLMServer``
answers in both batching modes.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_memory_management_tpu.models import gpt as jgpt
from ray_memory_management_tpu.serve import llm as jllm
from ray_memory_management_tpu_torch.models import gpt as tgpt
from ray_memory_management_tpu_torch.models.convert import params_from_jax
from ray_memory_management_tpu_torch.serve import llm as tllm
from ray_memory_management_tpu_torch.serve.kv_cache import row_token_bytes
from ray_memory_management_tpu_torch.utils import faults
from _port_fixtures import one_intra_op_thread  # noqa: F401

ENGINE = dict(max_slots=3, max_new_tokens=6, pad_multiple=8,
              steps_per_iter=4, kv_page_tokens=16)
PROMPT_LENS = (3, 8, 13, 21, 5)


@pytest.fixture(scope="module")
def setup():
    base = dict(vocab_size=128, n_layers=2, n_heads=2, d_model=32,
                max_seq=128)
    jcfg = jgpt.TransformerConfig(dtype=jnp.float32, **base)
    tcfg = tgpt.TransformerConfig(dtype=torch.float32, **base)
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, 128, size=n).tolist() for n in PROMPT_LENS]
    return jcfg, jparams, tcfg, tparams, prompts


@pytest.fixture(autouse=True)
def _clean_fault_plane():
    yield
    faults.reset()


def _serve_all(engine, prompts):
    """Submit every prompt from its own thread; return results in order."""
    out = [None] * len(prompts)

    def call(i):
        try:
            out[i] = engine.submit(prompts[i], timeout=120)
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            out[i] = e

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(150)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.fixture(scope="module")
def jax_tokens(setup):
    jcfg, jparams, _, _, prompts = setup
    eng = jllm.ContinuousBatcher(jparams, jcfg, kv_cache="paged", **ENGINE)
    try:
        return [eng.submit(p, timeout=120) for p in prompts]
    finally:
        eng.close()


@pytest.mark.parametrize("kv_cache", ["paged", "slab"])
def test_engine_matches_jax_greedy_tokens(setup, jax_tokens, kv_cache):
    _, _, tcfg, tparams, prompts = setup
    eng = tllm.ContinuousBatcher(tparams, tcfg, kv_cache=kv_cache, **ENGINE)
    try:
        got = _serve_all(eng, prompts)
        # every request retired before its caller woke (engine still up)
        if kv_cache == "paged":
            assert eng.kv_pool.pages_in_use == 0
            assert eng.kv_pool.store.total_bytes() == 0
    finally:
        eng.close()
    assert got == jax_tokens
    assert all(len(t) == ENGINE["max_new_tokens"] for t in got)


def test_retire_frees_pages_and_pinned_bytes(setup):
    _, _, tcfg, tparams, _ = setup
    eng = tllm.ContinuousBatcher(tparams, tcfg, max_slots=2,
                                 max_new_tokens=4, pad_multiple=8,
                                 kv_cache="paged", kv_page_tokens=16)
    eng.close()
    eng._thread.join(30)
    assert not eng._thread.is_alive()
    p = tllm._Pending(([5, 9, 17, 3], 4))
    need = eng._need_tokens(p)
    assert eng.kv_pool.reserve(0, need)
    eng._slot_cap[0] = need
    eng._admit(p, 0)
    assert eng.kv_pool.pages_in_use == eng.kv_pool.pages_for(need)
    row_bytes = eng.kv_pool.token_bytes * need
    assert eng.kv_pool.store.total_bytes() == row_bytes
    eng._retire(0)
    assert eng.kv_pool.pages_in_use == 0
    assert eng.kv_pool.store.total_bytes() == 0
    assert p.event.is_set() and len(p.result) == 1


def test_pool_exhaustion_backpressures_without_loss(setup, jax_tokens):
    _, _, tcfg, tparams, prompts = setup
    # two 16-token pages: one long request's lifetime at a time
    pool_bytes = 2 * ENGINE["kv_page_tokens"] * row_token_bytes(tcfg)
    eng = tllm.ContinuousBatcher(tparams, tcfg, kv_cache="paged",
                                 kv_pool_bytes=pool_bytes, **ENGINE)
    try:
        got = _serve_all(eng, prompts)
        assert eng.kv_pool.pages_in_use == 0
    finally:
        eng.close()
    assert got == jax_tokens
    assert eng.kv_backpressure > 0


def test_impossible_fit_fails_fast(setup):
    _, _, tcfg, tparams, _ = setup
    eng = tllm.ContinuousBatcher(tparams, tcfg, kv_cache="paged",
                                 kv_pool_bytes=1, **ENGINE)
    try:
        with pytest.raises(RuntimeError, match="pool capacity"):
            eng.submit(list(range(2, 40)), timeout=60)
    finally:
        eng.close()


def test_injected_admit_fault_fails_only_its_request(setup, jax_tokens):
    _, _, tcfg, tparams, prompts = setup
    faults.configure("serve.admit:error:max=1")
    eng = tllm.ContinuousBatcher(tparams, tcfg, kv_cache="paged", **ENGINE)
    try:
        with pytest.raises(faults.FaultInjected, match="serve.admit"):
            eng.submit(prompts[0], timeout=60)
        assert eng.submit(prompts[1], timeout=60) == jax_tokens[1]
        assert eng.kv_pool.pages_in_use == 0
    finally:
        eng.close()


@pytest.mark.parametrize("batching", ["continuous", "barrier"])
def test_llm_server_answers_on_cpu(batching):
    srv = tllm.LLMServer(preset="test", max_batch_size=2, max_new_tokens=4,
                         pad_multiple=16, batching=batching, device="cpu")
    try:
        requests = [{"tokens": [5, 6, 7]}, {"text": "hello"}, "hi there"]
        out = [None] * len(requests)

        def call(i):
            out[i] = srv(requests[i])

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        stats = srv.stats()
    finally:
        srv.close()
    assert [r["prompt_len"] for r in out] == [3, 5, 8]
    for r in out:
        assert len(r["tokens"]) == 4
        assert all(0 <= t < srv.cfg.vocab_size for t in r["tokens"])
    assert stats["generated_tokens"] == 12
    if batching == "continuous":
        assert stats["kv"]["pages_in_use"] == 0


def test_llm_server_sampling_uses_its_generator():
    srv = tllm.LLMServer(preset="test", max_batch_size=1, max_new_tokens=4,
                         pad_multiple=16, temperature=1.0, device="cpu")
    try:
        toks = srv({"tokens": [3, 4, 5]})["tokens"]
    finally:
        srv.close()
    assert len(toks) == 4 and all(0 <= t < 512 for t in toks)


def test_device_store_follows_the_jax_store():
    from ray_memory_management_tpu.core.device_store import (
        DeviceObjectStore as JaxStore)
    from ray_memory_management_tpu_torch.core.device_store import (
        DeviceObjectStore)

    a = np.arange(12, dtype=np.float32)
    ops = [("put", b"a", a), ("put", b"b", a[:4]), ("pin", b"a"),
           ("pin", b"z"), ("get", b"a"), ("put", b"b", a[:6]),
           ("take", b"b"), ("take", b"b"), ("contains", b"b"),
           ("unpin", b"a"), ("get", b"a"), ("delete", b"a"),
           ("contains", b"a"), ("get", b"a")]
    stores = [(JaxStore(capacity_bytes=-1), jnp.asarray),
              (DeviceObjectStore(capacity_bytes=-1), torch.from_numpy)]
    trails = []
    for store, wrap in stores:
        trail = []
        for name, oid, *arg in ops:
            out = getattr(store, name)(oid, *(wrap(x) for x in arg))
            if out is not None and hasattr(out, "shape"):
                out = np.asarray(out).tolist()
            trail.append((name, out, store.total_bytes(), store.stats()))
        trails.append(trail)
    assert trails[0] == trails[1]
    # a bounded tier demotes as the JAX store does: the same LRU victims
    # (recency kept by get, pinned entries skipped) through the demoter
    bounded = []
    for store_cls, wrap in ((JaxStore, jnp.asarray),
                            (DeviceObjectStore, torch.from_numpy)):
        demoted = []
        store = store_cls(capacity_bytes=48,
                          on_demote=lambda oid, arr: demoted.append(
                              (oid, np.asarray(arr).tolist())) or True)
        trail = [store.put(b"a", wrap(a[:4])), store.put(b"b", wrap(a[4:8])),
                 store.put(b"c", wrap(a[8:12])), store.get(b"a") is not None,
                 store.pin(b"b"), store.put(b"d", wrap(a[:4])),
                 store.put(b"e", wrap(a[4:8]))]
        bounded.append((trail, demoted, store.total_bytes(), store.stats()))
    assert bounded[0] == bounded[1]
    assert [oid for oid, _ in bounded[1][1]] == [b"c", b"a"]


def test_engine_under_contended_submits(setup):
    """More caller threads than cores, a tiny switch interval: every
    request still gets exactly its own greedy tokens and every page comes
    back (a lost update in the queue or the page pool would break one)."""
    import sys

    _, _, tcfg, tparams, _ = setup
    rng = np.random.default_rng(11)
    prompts = [rng.integers(2, 128, size=int(n)).tolist()
               for n in rng.integers(1, 40, size=24)]
    eng = tllm.ContinuousBatcher(tparams, tcfg, kv_cache="paged", **ENGINE)
    try:
        want = [eng.submit(p, timeout=60) for p in prompts[:4]]
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            got = _serve_all(eng, prompts)
        finally:
            sys.setswitchinterval(old)
        assert eng.kv_pool.pages_in_use == 0
        assert eng.kv_pool.store.total_bytes() == 0
    finally:
        eng.close()
    assert all(isinstance(t, list) and len(t) == ENGINE["max_new_tokens"]
               for t in got)
    assert got[:4] == want
