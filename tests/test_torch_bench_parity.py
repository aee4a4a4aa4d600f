"""The port's harnesses against the JAX package's on the CPU.

- the pure helpers give the JAX package's answers on the same inputs:
  ``serve_bench._percentile``, ``pod_bench._pcts``,
  ``scale_bench._median_row`` and ``vs_scale_baseline``,
  ``microbenchmark.vs_baseline``, ``geomean`` and ``BASELINE``,
  ``transfer_bench._build_corpora`` (byte for byte) and ``_sig``;
- serve_bench's capacity suite at ``mini=True``: both engines run, the
  suite's burst of 8 requests let through together on each side, and
  the paged and slab slot counts are equal;
- the barrier batch of serve_bench's continuous-vs-barrier suite: on the
  suite's model shape, in fp32, with the JAX weights carried across by
  ``models/convert.py``, its greedy tokens equal JAX ``generate``'s on
  the same padded batch, token for token.
"""

import dataclasses
import itertools
import math
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_memory_management_tpu.utils import microbenchmark as j_micro
from ray_memory_management_tpu.utils import pod_bench as j_pod
from ray_memory_management_tpu.utils import scale_bench as j_scale
from ray_memory_management_tpu.utils import serve_bench as j_serve
from ray_memory_management_tpu.utils import transfer_bench as j_transfer
from ray_memory_management_tpu_torch.utils import microbenchmark as t_micro
from ray_memory_management_tpu_torch.utils import pod_bench as t_pod
from ray_memory_management_tpu_torch.utils import scale_bench as t_scale
from ray_memory_management_tpu_torch.utils import serve_bench as t_serve
from ray_memory_management_tpu_torch.utils import transfer_bench as t_transfer
from _port_fixtures import one_intra_op_thread  # noqa: F401


def _samples(seed, n):
    return np.random.default_rng(seed).exponential(40.0, n).tolist()


@pytest.mark.parametrize("n", [0, 1, 2, 7, 100, 101])
def test_percentile_and_pcts_match_jax(n):
    xs = _samples(n, n)
    for p in (0, 50, 90, 99, 100):
        assert t_serve._percentile(xs, p) == j_serve._percentile(xs, p)
    if n:
        assert t_pod._pcts(xs) == j_pod._pcts(xs)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_median_row_and_scale_baseline_match_jax(n):
    rates = _samples(10 + n, n)
    assert t_scale._median_row(rates) == j_scale._median_row(rates)
    assert t_scale.SCALE_BASELINE == j_scale.SCALE_BASELINE
    results = {k: 3.0 * (i + 1) for i, k in
               enumerate(list(j_scale.SCALE_BASELINE) + ["other"])}
    assert (t_scale.vs_scale_baseline(results)
            == j_scale.vs_scale_baseline(results))


def test_microbenchmark_baseline_and_ratios_match_jax():
    assert t_micro.BASELINE == j_micro.BASELINE
    rng = np.random.default_rng(3)
    results = {k: float(v) * rng.uniform(0.1, 3.0)
               for k, v in j_micro.BASELINE.items()}
    results["not_a_baseline_row"] = 5.0
    ratios = t_micro.vs_baseline(results)
    assert ratios == j_micro.vs_baseline(results)
    assert t_micro.geomean(ratios) == j_micro.geomean(ratios)
    assert t_micro.geomean({}) == j_micro.geomean({}) == 0.0


@pytest.mark.parametrize("nbytes", [4096, 1 << 20])
def test_build_corpora_is_byte_equal_to_jax(nbytes):
    got, want = (t_transfer._build_corpora(nbytes),
                 j_transfer._build_corpora(nbytes))
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name


def test_sig_matches_jax():
    for x in (0.0, 1.0, 123456.789, 2.3456e-6, 9.9996, -0.00123, math.pi):
        for digits in (1, 3, 5):
            assert t_transfer._sig(x, digits) == j_transfer._sig(x, digits)


def _gated_submit(submit, n):
    """``ContinuousBatcher.submit`` whose calls after the first (the
    suite's warm-up) wait until ``n`` have arrived: both engines see the
    suite's burst arrive together, whatever the host's load does to
    thread start-up."""
    barrier = threading.Barrier(n)
    calls = itertools.count()

    def gated(self, *args, **kwargs):
        if next(calls):
            barrier.wait(timeout=120)
        return submit(self, *args, **kwargs)

    return gated


def test_capacity_suite_slots_match_jax(monkeypatch):
    from ray_memory_management_tpu.serve import llm as j_llm
    from ray_memory_management_tpu_torch.serve import llm as t_llm

    burst = 8  # the suite's mini burst: as many requests as paged slots
    for mod in (j_llm, t_llm):
        monkeypatch.setattr(
            mod.ContinuousBatcher, "submit",
            _gated_submit(mod.ContinuousBatcher.submit, burst))
    got = t_serve._capacity_suite(True, torch.device("cpu"))
    want = j_serve._capacity_suite(True)
    assert set(got) == set(want)
    assert got["slab_slots"] == want["slab_slots"]
    assert got["paged_slots"] == want["paged_slots"]
    assert got["capacity_budget_mb"] == want["capacity_budget_mb"]
    assert got["paged_slots_ratio"] >= 1.5


@pytest.mark.parametrize("n_items", [1, 3, 4, 6])
def test_barrier_batch_greedy_tokens_match_jax(n_items):
    from ray_memory_management_tpu.models import gpt as jgpt
    from ray_memory_management_tpu_torch.models import gpt as tgpt
    from ray_memory_management_tpu_torch.models.convert import (
        params_from_jax)

    jcfg = jgpt.TransformerConfig(**t_serve.BENCH_CONFIG, dtype=jnp.float32)
    tcfg = dataclasses.replace(tgpt.TransformerConfig(**t_serve.BENCH_CONFIG),
                               dtype=torch.float32)
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    steps, bucket = 16, 8
    prompts = [[2 + (i % 40), 5, 7, 2, 9, 4, 6, 8][:5 + i % 4]
               for i in range(n_items)]
    got = t_serve.barrier_generate(tparams, tcfg, prompts, steps)

    # the JAX suite's batch function, on the same padded batch
    arr = np.ones((4, bucket), np.int32)
    for i, p in enumerate(prompts[:4]):
        arr[i, :len(p)] = p[:bucket]
    out = np.asarray(jgpt.generate(jparams, jcfg, jnp.asarray(arr),
                                   steps=steps, temperature=0.0,
                                   key=jax.random.PRNGKey(7)))
    want = [out[min(i, 3), bucket:bucket + steps].tolist()
            for i in range(n_items)]
    assert got == want
