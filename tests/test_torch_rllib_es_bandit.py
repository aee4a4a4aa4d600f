"""ES, ARS and the contextual bandits in the PyTorch port.

The port's copy of ``tests/test_rllib.py``'s ``TestES`` and
``TestBandits`` (the learner on the CPU: ``device="cpu"``), the ES and
ARS steps against the JAX package's given one eps table (the one JAX's
seeds give), the learner's rebuilt eps bit-equal to the worker's, and
LinUCB's and LinTS's select and update against JAX's over a run of
steps. Tolerances: ``tests/_rl_parity.py``.
"""

import numpy as np
import pytest
import torch

import ray_memory_management_tpu_torch as rmt
from _port_fixtures import one_intra_op_thread  # noqa: F401
from _rl_parity import assert_close, t

DIM, NSEEDS = 37, 16


@pytest.fixture(scope="module")
def rmt_start_regular():
    rt = rmt.init(num_cpus=4, ignore_reinit_error=True)
    yield rt
    rmt.shutdown()


def test_es_and_ars_steps_match_jax():
    import jax
    import jax.numpy as jnp

    from ray_memory_management_tpu.rllib.ars import make_ars_update as jars
    from ray_memory_management_tpu.rllib.es import make_es_update as jes
    from ray_memory_management_tpu_torch.models.convert import (
        flat_params_from_jax)
    from ray_memory_management_tpu_torch.rllib.ars import make_ars_update
    from ray_memory_management_tpu_torch.rllib.es import make_es_update

    rng = np.random.default_rng(0)
    theta = rng.normal(size=DIM).astype(np.float32)
    seeds = rng.integers(0, 1 << 31, NSEEDS)
    # the eps table JAX's learner rebuilds from these seeds
    eps = np.stack([np.asarray(jax.random.normal(
        jax.random.PRNGKey(int(s)), (DIM,), dtype=jnp.float32))
        for s in seeds])
    weights = rng.uniform(-1, 1, NSEEDS).astype(np.float32)
    want = jes(0.03, 0.1, 0.005)(jnp.asarray(theta), jnp.asarray(seeds),
                                 jnp.asarray(weights))
    got = make_es_update(0.03, 0.1, 0.005)(
        t(flat_params_from_jax(theta)), t(eps), t(weights))
    assert_close(got, np.asarray(want))

    pos = rng.normal(50, 10, NSEEDS).astype(np.float32)
    neg = rng.normal(50, 10, NSEEDS).astype(np.float32)
    std = np.float32(np.std(np.concatenate([pos, neg])))
    want = jars(0.3, 0.5)(jnp.asarray(theta), jnp.asarray(seeds),
                          jnp.asarray(pos), jnp.asarray(neg),
                          jnp.float32(std))
    got = make_ars_update(0.3, 0.5)(t(theta), t(eps), t(pos), t(neg),
                                    float(std))
    assert_close(got, np.asarray(want))


@pytest.mark.parametrize("mode", ["ucb", "ts"])
def test_bandit_select_and_update_match_jax(mode):
    """Fifty steps of select and rank-1 update: the same arm at every
    step (Thompson's per-arm draws given), the same stacked state."""
    import jax
    import jax.numpy as jnp

    from ray_memory_management_tpu.rllib.bandit import (
        make_bandit_programs as jprograms)
    from ray_memory_management_tpu_torch.rllib.bandit import (
        make_bandit_programs)

    K, D = 5, 8
    jinit, jselect, jupdate = jprograms(K, D, 0.5, 1.0, mode)
    init, select, update = make_bandit_programs(K, D, 0.5, 1.0, mode)
    jstate, state = jinit(), init("cpu")
    rng = np.random.default_rng(1)
    theta = rng.normal(size=(K, D))
    key = jax.random.PRNGKey(2)
    for _ in range(50):
        ctx = rng.normal(size=D).astype(np.float32)
        ctx /= np.linalg.norm(ctx)
        key, sub = jax.random.split(key)
        noise = np.asarray(jax.random.normal(sub, (K,)))
        arm = int(jselect(jstate, jnp.asarray(ctx), sub))
        assert int(select(state, t(ctx), t(noise))) == arm
        reward = np.float32(theta[arm] @ ctx + 0.1 * rng.normal())
        jstate = jupdate(jstate, jnp.asarray(ctx), arm, reward)
        update(state, t(ctx), arm, float(reward))
    for k in ("A", "b"):
        assert_close(state[k], np.asarray(jstate[k]))


class TestES:
    def test_learns_cartpole_gradient_free(self):
        """Evolution strategies improves CartPole with no gradients
        through the policy — antithetic seed-derived perturbations,
        centered-rank weighting (es.py; the reference's
        tuned_examples/es contract, CI-scaled)."""
        from ray_memory_management_tpu_torch.rllib import ESConfig

        algo = (ESConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 200})
                .rollouts(num_rollout_workers=0)
                .training(lr=0.03, sigma=0.1, episodes_per_batch=64)
                .resources(device="cpu")
                .debugging(seed=3)
                .build())
        best = 0.0
        result = {}
        for _ in range(25):
            result = algo.train()
            best = max(best, result["fitness_mean"])
            if best > 120:
                break
        assert best > 60, (best, result)
        a = algo.compute_single_action(
            np.array([0.01, 0.0, 0.02, 0.0], np.float32))
        assert a in (0, 1)
        # save/restore round-trips the flat parameter vector
        blob = algo.save()
        theta = algo.theta.copy()
        algo.stop()
        algo2 = (ESConfig()
                 .environment("CartPole",
                              env_config={"max_episode_steps": 200})
                 .rollouts(num_rollout_workers=0)
                 .resources(device="cpu")
                 .debugging(seed=3)
                 .build())
        algo2.restore(blob)
        np.testing.assert_allclose(algo2.theta, theta)
        algo2.stop()

    def test_ars_learns_cartpole_with_linear_policy(self):
        """ARS improves CartPole with a LINEAR policy — top-k direction
        selection, return-std step scaling, and the running observation
        filter (ars.py; the reference's rllib/algorithms/ars contract,
        CI-scaled)."""
        from ray_memory_management_tpu_torch.rllib import ARSConfig

        algo = (ARSConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 200})
                .rollouts(num_rollout_workers=0)
                .training(lr=0.3, sigma=0.5, num_directions=32,
                          top_directions=16)
                .resources(device="cpu")
                .debugging(seed=5)
                .build())
        best = 0.0
        result = {}
        for _ in range(25):
            result = algo.train()
            best = max(best, result["fitness_mean"])
            if best > 120:
                break
        assert best > 60, (best, result)
        assert result["filter_count"] > 0  # the obs filter accumulated
        a = algo.compute_single_action(
            np.array([0.01, 0.0, 0.02, 0.0], np.float32))
        assert a in (0, 1)
        # save/restore round-trips theta AND the observation filter
        blob = algo.save()
        theta = algo.theta.copy()
        count = algo.filter.count
        algo.stop()
        from ray_memory_management_tpu_torch.rllib import ARSConfig as C2

        algo2 = (C2()
                 .environment("CartPole",
                              env_config={"max_episode_steps": 200})
                 .rollouts(num_rollout_workers=0)
                 .resources(device="cpu")
                 .debugging(seed=5)
                 .build())
        algo2.restore(blob)
        np.testing.assert_allclose(algo2.theta, theta)
        assert algo2.filter.count == count
        algo2.stop()

    def test_ars_filter_delta_merge(self):
        """Worker filter increments fold into the master filter exactly
        (the MeanStdFilter delta-sync invariant)."""
        from ray_memory_management_tpu_torch.rllib.ars import _ObsFilter

        master = _ObsFilter(3)
        obs = np.arange(12, dtype=np.float64).reshape(4, 3)
        master.merge({"count": 4.0, "sum": obs.sum(0),
                      "sumsq": (obs * obs).sum(0)})
        snap = master.snapshot()
        np.testing.assert_allclose(snap["mean"], obs.mean(0), rtol=1e-6)
        np.testing.assert_allclose(snap["std"], obs.std(0), rtol=1e-5)

    def test_seed_reconstruction_matches_worker(self):
        """The learner's rebuilt perturbation equals the worker's, bit
        for bit — the invariant replacing the shared noise table."""
        from ray_memory_management_tpu_torch.rllib.es import (
            _perturbation, make_es_update, perturbations)

        dim = 37
        eps_worker = _perturbation(1234, dim).numpy()
        eps_learner = perturbations([1234, 99], dim, "cpu")
        np.testing.assert_array_equal(eps_learner[0].numpy(), eps_worker)
        np.testing.assert_array_equal(eps_learner[1].numpy(),
                                      _perturbation(99, dim).numpy())
        # a single-seed update moves theta exactly along eps
        update = make_es_update(lr=1.0, sigma=1.0, l2=0.0)
        out = update(torch.zeros(dim), eps_learner[:1], torch.ones(1))
        np.testing.assert_allclose(out.numpy(), eps_worker, rtol=1e-6)

    def test_remote_workers_shard_seeds(self, rmt_start_regular):
        from ray_memory_management_tpu_torch.rllib import ESConfig

        algo = (ESConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 50})
                .rollouts(num_rollout_workers=2)
                .training(episodes_per_batch=8)
                .resources(device="cpu")
                .debugging(seed=0)
                .build())
        r = algo.train()
        assert r["episodes_this_iter"] == 8
        assert r["timesteps_total"] > 0  # env steps counted (Tune keys on it)
        algo.stop()


class TestBandits:
    def test_linucb_sublinear_regret(self):
        """LinUCB's per-step regret collapses as the per-arm posteriors
        sharpen (bandit.py; the reference's BanditLinUCB contract —
        tuned_examples/bandit). Also: the whole state round-trips."""
        from ray_memory_management_tpu_torch.rllib import BanditLinUCBConfig

        algo = (BanditLinUCBConfig()
                .environment("LinearBandit",
                             env_config={"num_arms": 5, "context_dim": 8,
                                         "noise": 0.05, "seed": 7})
                .training(alpha=1.0, steps_per_iter=200)
                .resources(device="cpu")
                .debugging(seed=0)
                .build())
        first = algo.train()["regret_mean"]
        last = {}
        for _ in range(4):
            last = algo.train()
        assert last["regret_mean"] < 0.5 * first, (first, last)
        assert last["regret_mean"] < 0.1, last
        blob = algo.save()
        algo.stop()

        algo2 = (BanditLinUCBConfig()
                 .environment("LinearBandit",
                              env_config={"num_arms": 5, "context_dim": 8,
                                          "noise": 0.05, "seed": 7})
                 .resources(device="cpu")
                 .debugging(seed=0)
                 .build())
        algo2.restore(blob)
        assert np.allclose(algo2.get_weights()["A"],
                           algo.get_weights()["A"])
        algo2.stop()

    def test_lints_learns(self):
        """Thompson sampling reaches the same sublinear-regret regime
        through posterior draws instead of a UCB bonus."""
        from ray_memory_management_tpu_torch.rllib import BanditLinTSConfig

        algo = (BanditLinTSConfig()
                .environment("LinearBandit",
                             env_config={"num_arms": 4, "context_dim": 6,
                                         "noise": 0.05, "seed": 3})
                .training(alpha=0.5, steps_per_iter=200)
                .resources(device="cpu")
                .debugging(seed=1)
                .build())
        first = algo.train()["regret_mean"]
        last = {}
        for _ in range(4):
            last = algo.train()
        assert last["regret_mean"] < 0.5 * first, (first, last)
        algo.stop()
