"""Tune against the JAX package: the same search spaces, seeds and
result streams give the same suggestions and the same stop decisions
(the port's ``tune/search.py`` and ``tune/schedulers.py`` draw from
``random`` and numpy as the JAX package's do), compared exactly. And a
GPU trial on a node whose GPUs have no card behind them fails, its error
in ``ResultGrid.errors``.
"""

import types

import numpy as np
import pytest

from ray_memory_management_tpu import tune as jtune
from ray_memory_management_tpu_torch import tune as ttune
from _port_fixtures import one_intra_op_thread  # noqa: F401

PACKAGES = {"jax": jtune, "torch": ttune}


def _space(t):
    return {"lr": t.loguniform(1e-5, 1e-1), "wd": t.uniform(0.0, 0.3),
            "layers": t.randint(2, 9), "drop": t.quniform(0.0, 0.5, 0.1),
            "act": t.choice(["gelu", "relu", "silu"]),
            "opt": {"beta": t.grid_search([0.9, 0.95]),
                    "warmup": t.choice([0, 100, 1000])}}


def _objective(cfg):
    return ((np.log10(cfg["lr"]) + 3.0) ** 2 + (cfg["wd"] - 0.1) ** 2
            + 0.01 * cfg["layers"] + (cfg["act"] == "relu"))


def test_variant_generator_gives_the_same_variants():
    got = {k: t.BasicVariantGenerator(_space(t), 5, seed=7).variants()
           for k, t in PACKAGES.items()}
    assert len(got["torch"]) == 10
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("searcher", ["random", "tpe"])
def test_searchers_suggest_alike_on_the_same_results(searcher):
    def run(t):
        space = {k: v for k, v in _space(t).items() if k != "opt"}
        if searcher == "random":
            s = t.search.RandomSearch(space, metric="loss", mode="min",
                                      seed=11)
        else:
            s = t.search.TPESearch(space, metric="loss", mode="min", seed=11,
                                   n_initial_points=6)
        out = []
        for i in range(24):
            cfg = s.suggest(f"t{i}")
            out.append(cfg)
            s.on_trial_complete(f"t{i}", {"loss": _objective(cfg)})
        return out

    want, got = run(jtune), run(ttune)
    assert got == want
    assert len({c["lr"] for c in got}) == 24


def _stream(seed=3, trials=6, steps=12):
    """Interleaved results of ``trials`` trials, in the order a runner
    would see them: (trial id, result)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.5, 4.0, size=trials)
    out = []
    for it in range(1, steps + 1):
        for i in rng.permutation(trials):
            loss = float(base[i] * 0.8 ** it + rng.normal(0, 0.05))
            out.append((f"trial{i}", {"loss": loss,
                                      "training_iteration": it}))
    return out


@pytest.mark.parametrize("scheduler", ["asha", "median"])
def test_schedulers_stop_alike_on_the_same_stream(scheduler):
    def run(t):
        if scheduler == "asha":
            s = t.ASHAScheduler(metric="loss", mode="min", max_t=12,
                                grace_period=1, reduction_factor=2)
        else:
            s = t.MedianStoppingRule(metric="loss", mode="min",
                                     grace_period=3, min_samples_required=2)
        stopped, decisions = set(), []
        for tid, result in _stream():
            if tid in stopped:
                continue
            d = s.on_trial_result(None, types.SimpleNamespace(id=tid),
                                  result)
            decisions.append((tid, result["training_iteration"], d))
            if d == "STOP":
                stopped.add(tid)
        return decisions

    want, got = run(jtune), run(ttune)
    assert got == want
    early = {tid for tid, it, d in got if d == "STOP" and it < 12}
    assert 0 < len(early) < 6


@pytest.fixture
def rmt_named_gpus(monkeypatch):
    """A node whose CUDA_VISIBLE_DEVICES names card "5": one GPU counted,
    no card behind it."""
    import ray_memory_management_tpu_torch as rmt

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5")
    rt = rmt.init(num_cpus=2)
    yield rt
    rmt.shutdown()


def test_gpu_trial_without_a_card_reports_its_error(rmt_named_gpus):
    """``resources_per_trial={"GPU": 1}`` leases the trial actor GPU "5";
    ``runtime_smoke.tune_trial`` finds no card there and raises: the
    trial ends in error and the error reaches ``ResultGrid.errors``; no
    trial ran on the CPU in its place. A CPU trial that reports ends
    TERMINATED."""
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    grid = ttune.Tuner(
        runtime_smoke.tune_trial,
        param_space={"lr": 3e-4, "batch": 2, "seq": 16, "steps": 1,
                     "preset": "test"},
        resources_per_trial={"CPU": 1, "GPU": 1},
        tune_config=ttune.TuneConfig(metric="loss", mode="min",
                                     max_concurrent_trials=1),
    ).fit()
    assert len(grid.errors) == 1
    assert "CUDA" in grid.errors[0]
    assert [r.status for r in grid] == ["ERROR"]
    assert not any("loss" in r.metrics for r in grid)

    # a trial that reports and returns ends TERMINATED
    def reports(config):
        from ray_memory_management_tpu_torch.train import session

        session.report({"loss": config["lr"]})

    grid = ttune.Tuner(
        reports, param_space={"lr": 3e-4},
        tune_config=ttune.TuneConfig(metric="loss", mode="min"),
    ).fit()
    assert not grid.errors
    assert [r.status for r in grid] == ["TERMINATED"]
    assert grid.get_best_result().metrics["loss"] == 3e-4
