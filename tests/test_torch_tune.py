"""Tune-equivalent tests: search spaces, trial runner, ASHA, PBT.

Mirrors the reference's tune test strategy (python/ray/tune/tests/
test_tune_restore.py, test_trial_scheduler.py style): function + class
trainables driven end-to-end on an in-process cluster.

The PyTorch port's copy of ``tests/test_tune.py``: the same cases run
against ``ray_memory_management_tpu_torch``, with its own fixture (the
shared conftest starts the JAX package's runtime).
``test_tuner_runs_jax_trainer`` becomes ``test_tuner_runs_torch_trainer``
(a one-worker CPU ``TorchTrainer`` under the Tuner), and the cases
share one runtime.
"""

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import tune
from ray_memory_management_tpu_torch.train import session
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def rmt_start_regular():
    """One runtime for the module's cases (no case needs a fresh one;
    each case's own init and shutdown spawn a new set of workers)."""
    rt = rmt.init(num_cpus=4, ignore_reinit_error=True)
    yield rt
    rmt.shutdown()


def test_grid_and_sample_variants():
    space = {
        "lr": tune.grid_search([0.1, 0.01]),
        "wd": tune.choice([1, 2]),
        "nested": {"depth": tune.grid_search([2, 4])},
    }
    variants = tune.BasicVariantGenerator(space, num_samples=2,
                                          seed=0).variants()
    assert len(variants) == 2 * 2 * 2  # num_samples x grid(lr) x grid(depth)
    lrs = {v["lr"] for v in variants}
    depths = {v["nested"]["depth"] for v in variants}
    assert lrs == {0.1, 0.01}
    assert depths == {2, 4}
    assert all(v["wd"] in (1, 2) for v in variants)


def test_sample_domains_deterministic_seed():
    space = {"a": tune.uniform(0, 1), "b": tune.randint(0, 10),
             "c": tune.loguniform(1e-4, 1e-1), "d": tune.quniform(0, 1, 0.25)}
    v1 = tune.BasicVariantGenerator(space, 3, seed=42).variants()
    v2 = tune.BasicVariantGenerator(space, 3, seed=42).variants()
    assert v1 == v2
    assert all(0 <= v["a"] <= 1 for v in v1)
    assert all(v["d"] in (0.0, 0.25, 0.5, 0.75, 1.0) for v in v1)


class _Quadratic(tune.Trainable):
    """loss = (x - 3)^2 shrinking each iteration."""

    def setup(self, config):
        self.x = config.get("x", 0.0)
        self.value = (self.x - 3.0) ** 2

    def step(self):
        self.value *= 0.5
        return {"loss": self.value}

    def save_checkpoint(self, d):
        with open(f"{d}/state.txt", "w") as f:
            f.write(str(self.value))

    def load_checkpoint(self, d):
        with open(f"{d}/state.txt") as f:
            self.value = float(f.read())


def test_tuner_class_trainable_grid(rmt_start_regular):
    tuner = tune.Tuner(
        _Quadratic,
        param_space={"x": tune.grid_search([0.0, 2.0, 5.0])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_iterations=3),
    )
    grid = tuner.fit()
    assert len(grid) == 3
    assert not grid.errors
    best = grid.get_best_result()
    assert best.config["x"] == 2.0  # closest to 3
    assert len(best.metrics_history) == 3


def test_tuner_function_trainable(rmt_start_regular):
    def train_fn(config):
        acc = 0.0
        for _ in range(4):
            acc += config["lr"]
            session.report({"acc": acc})

    tuner = tune.Tuner(
        train_fn,
        param_space={"lr": tune.grid_search([0.1, 0.3])},
        tune_config=tune.TuneConfig(metric="acc", mode="max"),
    )
    grid = tuner.fit()
    assert not grid.errors
    best = grid.get_best_result()
    assert best.config["lr"] == 0.3
    assert best.metrics["acc"] == pytest.approx(1.2)


def test_tuner_cloud_checkpoint_sync(rmt_start_regular, tmp_path):
    """Trial checkpoints sync to a gs://-style upload_dir through the
    external-storage registry (the reference's tune/syncer.py upload_dir
    contract), and a FRESH Syncer with no local state recovers the blob
    from the deterministic key layout alone."""
    from ray_memory_management_tpu_torch.core.external_storage import (
        FileSystemStorage, register_storage_scheme,
    )

    # a gs://-shaped URI served by a local fake: the registry maps the
    # scheme to a filesystem-backed store rooted at tmp_path
    root = tmp_path / "bucket"

    class _FakeCloud(FileSystemStorage):
        def __init__(self, uri):
            assert uri.startswith("mockgs://")
            super().__init__(str(root / uri[len("mockgs://"):]))

        def spill(self, object_id, data):
            super().spill(object_id, data)
            # cloud-shaped URL (the deterministic <base>/<hex> layout)
            return f"{self._uri}/{object_id.hex()}"

        def restore(self, object_id, url):
            import os as _os

            return super().restore(
                object_id,
                _os.path.join(self.directory, url.rsplit("/", 1)[-1]))

        def delete(self, url):
            import os as _os

            super().delete(
                _os.path.join(self.directory, url.rsplit("/", 1)[-1]))

    def factory(uri):
        s = _FakeCloud(uri)
        s._uri = uri.rstrip("/")
        return s

    register_storage_scheme("mockgs", factory)

    tuner = tune.Tuner(
        _Quadratic,
        param_space={"x": tune.grid_search([0.0, 2.0])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_iterations=2),
        name="sync_exp",
        upload_dir="mockgs://bucket/ckpts",
    )
    grid = tuner.fit()
    assert not grid.errors

    # recovery path: a new Syncer (fresh process analog) finds and
    # restores every trial's checkpoint without any local manifest
    syncer = tune.Syncer("mockgs://bucket/ckpts", "sync_exp")
    for r in grid:
        meta = syncer.meta(r.trial_id)
        assert meta is not None and meta["iteration"] == 2
        blob = syncer.download(r.trial_id)
        assert blob == r.checkpoint_blob and blob
    # delete removes both the blob and the pointer
    syncer.delete(grid[0].trial_id)
    assert syncer.meta(grid[0].trial_id) is None
    assert syncer.download(grid[0].trial_id) is None
    assert syncer.trials_synced([r.trial_id for r in grid]) == \
        [grid[1].trial_id]


def test_tuner_trial_error_surfaces(rmt_start_regular):
    def bad_fn(config):
        if config["boom"]:
            raise ValueError("exploded")
        session.report({"ok": 1})

    grid = tune.Tuner(
        bad_fn,
        param_space={"boom": tune.grid_search([False, True])},
        tune_config=tune.TuneConfig(metric="ok", mode="max"),
    ).fit()
    assert len(grid.errors) == 1
    assert "exploded" in grid.errors[0]
    assert grid.get_best_result().config["boom"] is False


def test_asha_stops_bad_trials(rmt_start_regular):
    asha = tune.ASHAScheduler(metric="loss", mode="min", max_t=16,
                              grace_period=2, reduction_factor=2)
    tuner = tune.Tuner(
        _Quadratic,
        param_space={"x": tune.grid_search([3.0, 100.0, 200.0, 400.0])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    scheduler=asha, max_iterations=16,
                                    max_concurrent_trials=2),
    )
    grid = tuner.fit()
    assert not grid.errors
    iters = {r.config["x"]: len(r.metrics_history) for r in grid}
    # the best trial (x=3, loss=0) must survive to max_t; at least one of
    # the far-off trials must have been halted early at a rung
    assert iters[3.0] == 16
    assert min(iters[x] for x in (100.0, 200.0, 400.0)) < 16


def test_median_stopping_halts_below_median(rmt_start_regular):
    """Trials whose running-average falls under the cohort median stop
    after the grace period; the best trial runs to completion
    (schedulers.py MedianStoppingRule; the reference's Vizier rule)."""
    rule = tune.MedianStoppingRule(metric="loss", mode="min",
                                   grace_period=3, min_samples_required=2)
    tuner = tune.Tuner(
        _Quadratic,
        param_space={"x": tune.grid_search([1.0, 50.0, 100.0, 400.0])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    scheduler=rule, max_iterations=12,
                                    max_concurrent_trials=2),
    )
    grid = tuner.fit()
    assert not grid.errors
    iters = {r.config["x"]: len(r.metrics_history) for r in grid}
    assert iters[1.0] == 12  # the best trial is never median-stopped
    # the worst trials fall under the running median and halt early
    assert min(iters[x] for x in (100.0, 400.0)) < 12


def test_pbt_exploits_and_perturbs(rmt_start_regular, tmp_path):
    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_mutations={"rate": tune.uniform(0.5, 2.0)},
        quantile_fraction=0.5, seed=1,
    )
    pace_dir = str(tmp_path)

    class _Grower(tune.Trainable):
        """Trials pace each other through files so neither can finish before
        the other reports (exploit needs both trials' scores recorded)."""

        def setup(self, config):
            self.total = 0.0
            self.steps = 0

        def step(self):
            import os
            import time as _t

            me = f"{self.config['rate']}"
            self.steps += 1
            with open(f"{pace_dir}/{me}.{self.steps}", "w"):
                pass
            deadline = _t.monotonic() + 30
            # wait for the peer to reach the previous step
            want = self.steps - 1
            while want > 0 and _t.monotonic() < deadline:
                peers = [f for f in os.listdir(pace_dir)
                         if not f.startswith(me) and
                         int(f.rsplit(".", 1)[1]) >= want]
                if peers:
                    break
                _t.sleep(0.01)
            self.total += self.config.get("rate", 0.0)
            return {"score": self.total}

        def save_checkpoint(self, d):
            with open(f"{d}/t.txt", "w") as f:
                f.write(str(self.total))

        def load_checkpoint(self, d):
            with open(f"{d}/t.txt") as f:
                self.total = float(f.read())

        def reset_config(self, new_config):
            return True

    tuner = tune.Tuner(
        _Grower,
        param_space={"rate": tune.grid_search([0.01, 1.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=pbt, max_iterations=12),
    )
    grid = tuner.fit()
    assert not grid.errors
    scores = sorted(r.metrics["score"] for r in grid)
    # the weak trial must have cloned the strong trial's state at least once:
    # without exploit its score would be 12*0.01 = 0.12
    assert scores[0] > 1.0


def test_tuner_runs_torch_trainer(rmt_start_regular, tmp_path):
    from ray_memory_management_tpu_torch.train import (RunConfig,
                                                       ScalingConfig,
                                                       TorchTrainer)

    def loop(config):
        session.report({"loss": (config["lr"] - 0.2) ** 2})

    trainer = TorchTrainer(
        loop, train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path)),
    )
    grid = tune.Tuner(
        trainer,
        param_space={"lr": tune.grid_search([0.1, 0.2])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=1),
    ).fit()
    assert not grid.errors
    assert grid.get_best_result().config["lr"] == 0.2


class TestTPE:
    """Model-based search (TPESearch, the in-repo TPE — the reference's
    hyperopt integration, tune/search/hyperopt/)."""

    def test_tpe_beats_random_on_quadratic(self):
        """Pure searcher loop: minimizing (x-0.7)^2 + (y+2)^2 over a box,
        TPE's best-of-N should land much closer to the optimum than
        random search with the same budget and seed."""
        from ray_memory_management_tpu_torch.tune.search import (
            RandomSearch, TPESearch, uniform,
        )

        space = {"x": uniform(0.0, 1.0), "y": uniform(-5.0, 5.0)}

        def run(searcher, n=60):
            best = float("inf")
            for i in range(n):
                cfg = searcher.suggest(f"t{i}")
                loss = (cfg["x"] - 0.7) ** 2 + (cfg["y"] + 2.0) ** 2
                searcher.on_trial_complete(f"t{i}", {"loss": loss})
                best = min(best, loss)
            return best

        import statistics

        tpe = [run(TPESearch(space, metric="loss", mode="min",
                             seed=s, n_initial_points=10))
               for s in range(5)]
        rand = [run(RandomSearch(space, metric="loss", mode="min",
                                 seed=s)) for s in range(5)]
        # medians over seeds: single-seed comparisons flip on luck
        assert statistics.median(tpe) < 0.02, tpe
        assert statistics.median(tpe) < statistics.median(rand), \
            (tpe, rand)

    def test_tpe_mode_max_and_choice(self):
        from ray_memory_management_tpu_torch.tune.search import (
            TPESearch, choice, uniform,
        )

        space = {"x": uniform(-1.0, 1.0), "arch": choice(["a", "b", "c"])}
        s = TPESearch(space, metric="score", mode="max", seed=0,
                      n_initial_points=8)
        for i in range(50):
            cfg = s.suggest(f"t{i}")
            score = -(cfg["x"] - 0.5) ** 2 + (1.0 if cfg["arch"] == "b"
                                              else 0.0)
            s.on_trial_complete(f"t{i}", {"score": score})
        # late suggestions should concentrate on the good category
        late = [s.suggest(f"probe{i}") for i in range(20)]
        assert sum(1 for c in late if c["arch"] == "b") >= 10

    def test_tuner_feeds_searcher(self, rmt_start_regular):
        """The Tuner loop must report completions back to the searcher
        between waves — without that, model-based search degenerates to
        random."""
        from ray_memory_management_tpu_torch.tune import TuneConfig, Tuner
        from ray_memory_management_tpu_torch.tune.search import (
            TPESearch, uniform,
        )

        def objective(config):
            from ray_memory_management_tpu_torch.train import session

            session.report(
                {"loss": (config["x"] - 0.25) ** 2})

        searcher = TPESearch({"x": uniform(0.0, 1.0)}, metric="loss",
                             mode="min", seed=1, n_initial_points=4)
        results = Tuner(
            objective,
            tune_config=TuneConfig(metric="loss", mode="min",
                                   num_samples=12, search_alg=searcher,
                                   max_concurrent_trials=2),
        ).fit()
        assert len(results._results) == 12
        # the searcher actually received observations
        assert len(searcher._obs) >= 10
        best = results.get_best_result("loss", "min")
        assert best.metrics["loss"] < 0.05
