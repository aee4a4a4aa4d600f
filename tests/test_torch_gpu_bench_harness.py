"""The port's ``gpu_bench`` harnesses (the flash, serving and all-reduce
benches) and the ``rmt-torch microbenchmark`` verb, on the CPU.

- one iteration of ``flash_attention_bench``'s loop on the port's plain
  path (``flash_bench_step``: the loss Σ o², its three gradients, the q
  update and the running Σ dv) against the JAX bench's loop body through
  its Pallas kernels in interpret mode, at BH = 2, S = 128, D = 64, fp32,
  causal, to 1e-4 of each tensor's largest magnitude;
- ``flash_attention_bench``, ``llm_serving_bench`` and
  ``allreduce_busbw`` run with ``device="cpu"`` and return their keys;
  without a card, called without ``device="cpu"``, each raises (decided
  in the test, never at import);
- ``rmt-torch microbenchmark --scale 0.01`` prints one row for each name
  of ``BASELINE``;
- the new harness modules import in a fresh interpreter without JAX or
  the JAX package ever loading.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_memory_management_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from ray_memory_management_tpu_torch.utils import gpu_bench
from _port_fixtures import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESSES = ("microbenchmark", "serve_bench", "device_bench",
             "transfer_bench", "locality_bench", "tracing_bench",
             "logging_bench", "profile_bench", "health_bench",
             "train_elastic_bench", "job_plane_bench", "scale_bench",
             "pod_bench", "gpu_bench")


def _jax_loop_body(q, k, v, acc):
    """The JAX bench's fori_loop body (``utils/tpu_bench.py``
    ``flash_attention_bench``), with the kernels in interpret mode."""
    def loss(q_, k_, v_):
        o = jax_flash_attention(q_, k_, v_, use_pallas="interpret")
        return jnp.sum(o.astype(jnp.float32) ** 2)

    value, (dq, dk, dv) = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        q, k, v)
    return (q + 1e-6 * dq.astype(q.dtype),
            acc + jnp.sum(dv.astype(jnp.float32)), value, dq, dk, dv)


def test_flash_bench_loop_body_matches_jax():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 128, 64)).astype(np.float32)
               for _ in range(3))
    acc = np.float32(0.25)
    want = _jax_loop_body(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(acc))
    got = gpu_bench.flash_bench_step(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(acc))
    names = ("q_next", "acc", "loss", "dq", "dk", "dv")
    for name, g, w in zip(names, got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name


def test_flash_bench_ref_route_matches_flash_route():
    q, k, v = gpu_bench.flash_bench_inputs(2, 64, 32, "cpu", torch.float32)
    acc = torch.zeros(())
    flash = gpu_bench.flash_bench_step(q, k, v, acc, "flash")
    ref = gpu_bench.flash_bench_step(q, k, v, acc, "ref")
    for g, w in zip(flash, ref):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


def test_flash_attention_bench_returns_its_keys():
    out = gpu_bench.flash_attention_bench(device="cpu", seq_lens=(64,),
                                          head_dim=64, iters=1)
    assert list(out) == [64]
    assert set(out[64]) == {"flash_ms", "ref_ms", "speedup"}
    assert all(v > 0 for v in out[64].values())


def test_llm_serving_bench_serves_every_budget_on_the_cpu():
    seen = {}

    def on_mode(mode, handle, budgets, replies):
        seen[mode] = (list(budgets), [list(r) for r in replies])

    out = gpu_bench.llm_serving_bench(device="cpu", preset="test",
                                      n_requests=4, max_new_tokens=8,
                                      on_mode=on_mode)
    for key in ("decode_tokens_per_s", "decode_tokens_per_s_barrier",
                "requests_per_s", "decode_steps", "continuous_vs_barrier"):
        assert key in out, key
        assert out[key] > 0, key
    budgets, replies = seen["continuous"]
    assert budgets == [8, 2, 8, 2]
    assert [len(r) for r in replies] == budgets
    # the barrier pays the deployment's whole budget for every request
    assert [len(r) for r in seen["barrier"][1]] == [8] * 4
    vocab = 512  # the test preset's
    assert all(0 <= t < vocab for _, rs in seen.values() for r in rs
               for t in r)


def test_allreduce_busbw_is_none_on_the_cpu():
    assert gpu_bench.allreduce_busbw(device="cpu") is None


@pytest.mark.parametrize("call", [
    lambda: gpu_bench.flash_attention_bench(seq_lens=(64,), head_dim=64,
                                            iters=1),
    lambda: gpu_bench.llm_serving_bench(preset="test", n_requests=1),
    lambda: gpu_bench.allreduce_busbw(),
], ids=["flash", "serving", "allreduce"])
def test_entry_points_raise_without_a_card(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_cli_microbenchmark_prints_the_baseline_rows():
    from ray_memory_management_tpu_torch.utils.microbenchmark import BASELINE

    proc = subprocess.run(
        [sys.executable, "-m", "ray_memory_management_tpu_torch.scripts.cli",
         "microbenchmark", "--scale", "0.01"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = [ln.split(": ", 1) for ln in proc.stdout.splitlines()
            if ": " in ln]
    names = [name for name, _ in rows if name in BASELINE]
    assert names == list(BASELINE)
    for name, value in rows:
        if name in BASELINE:
            rate, unit = value.rsplit(" ", 1)
            assert float(rate.replace(",", "")) > 0, name
            assert unit == ("GB/s" if "gigabytes" in name else "ops/s")


def test_harness_modules_import_without_jax():
    code = (
        "import sys\n"
        + "".join(f"import ray_memory_management_tpu_torch.utils.{m}\n"
                  for m in HARNESSES)
        + "import ray_memory_management_tpu_torch.scripts.cli\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'ray_memory_management_tpu' "
        "or m.startswith('ray_memory_management_tpu.'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
