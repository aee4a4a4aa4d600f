"""RLlib's core in the PyTorch port: env, GAE, replay, PPO, PG/A2C, Tune.

The port's copy of ``tests/test_rllib.py``'s ``TestEnv``, ``TestGAE``,
``TestReplay``, ``TestPPO``, ``TestPG`` and ``TestTuneIntegration``
(the learner on the CPU: ``device="cpu"``), and the parity of the
port's actor-critic, action sampling, GAE and PG/A2C/PPO updates with
the JAX package's, on the same numpy-seeded inputs, with weights and
Adam moments carried across by ``models.convert``. The slice as a
whole: both PPO learners fed the same recorded batch through
``training_step``, and a JAX checkpoint restored into the port's PPO.

Tolerance of every parity check of params, Adam moments and outputs, in
fp32: each element within ``1e-5 * max|leaf| + 1e-6`` of the JAX value
(``max|leaf|`` over the JAX leaf); an update's reported statistics within
1e-4 of their own size.
"""

import numpy as np
import pytest
import torch

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.models.convert import (
    adam_state_from_optax, rl_params_from_jax,
)
from ray_memory_management_tpu_torch.rllib import (
    CartPole, PPOConfig, PrioritizedReplayBuffer, ReplayBuffer, make_env,
    register_env,
)
from ray_memory_management_tpu_torch.rllib import models as tm
from ray_memory_management_tpu_torch.rllib import sample_batch as sb
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def rmt_start_regular():
    """One runtime for the module's cases that need one (each case's
    algorithm starts and kills its own rollout actors)."""
    rt = rmt.init(num_cpus=4, ignore_reinit_error=True)
    yield rt
    rmt.shutdown()


# ------------------------------------------------------------- helpers
# the statistics an update reports are means over the minibatch whose
# terms can cancel (mean Q, a loss), so they are held relative to their
# own size
STAT_TOL = dict(rel=1e-4, abs=1e-6)


def _jax_leaves(tree):
    import jax

    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def assert_tree_close(port_tree, jax_tree):
    """Each element within 1e-5 * max|leaf| + 1e-6 of the JAX value."""
    got = [t.detach().cpu().numpy() for t in tm.tree_leaves(port_tree)]
    want = _jax_leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        tol = 1e-5 * float(np.abs(w).max()) + 1e-6
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def assert_close(got, want):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    tol = 1e-5 * float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def port_learner(jax_params, jax_opt_state, lr):
    """The JAX learner's params and optax Adam state as the port's
    trainable tree and ``torch.optim.Adam``."""
    from ray_memory_management_tpu.rllib.models import params_to_numpy

    params = tm.tree_map(lambda t: t.requires_grad_(True), rl_params_from_jax(
        params_to_numpy(jax_params), "cpu"))
    opt = tm.make_adam(params, lr)
    tm.load_adam_state(opt, adam_state_from_optax(
        params_to_numpy(jax_opt_state)))
    return params, opt


def _ppo_batches(n_batches, n, obs_dim=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        out.append(dict(
            obs=rng.normal(size=(n, obs_dim)).astype(np.float32),
            actions=rng.integers(0, 2, n).astype(np.int32),
            old_logp=np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
            advantages=rng.normal(size=n).astype(np.float32),
            targets=rng.normal(size=n).astype(np.float32)))
    return out


PPO_ARGS = ("obs", "actions", "old_logp", "advantages", "targets")
LR = 1e-2  # large enough that three steps move every leaf visibly


# ------------------------------------------------------- JAX references
@pytest.fixture(scope="module")
def jax_updates():
    """For PG, A2C and PPO: the JAX params and Adam state after one warm
    update (the starting point carried across), the three updates after
    it, and the batches they consumed. Computed once per module."""
    import jax
    import optax

    from ray_memory_management_tpu.rllib.models import ac_init
    from ray_memory_management_tpu.rllib.pg import make_pg_update
    from ray_memory_management_tpu.rllib.ppo import make_ppo_update

    makers = {
        "ppo": lambda opt: make_ppo_update(opt, 0.2, 0.5, 0.01),
        "pg": lambda opt: make_pg_update(opt, 0.5, 0.01),
        "a2c": lambda opt: make_pg_update(opt, 1.0, 0.01),
    }
    batches = _ppo_batches(4, 64)
    out = {}
    for name, make in makers.items():
        opt = optax.adam(LR)
        params = ac_init(jax.random.key(3), 4, 2, (32, 32))
        state = opt.init(params)
        update = make(opt)
        params, state, _ = update(params, state,
                                  *(batches[0][k] for k in PPO_ARGS))
        start = (params, state)
        steps = []
        for b in batches[1:]:
            params, state, stats = update(params, state,
                                          *(b[k] for k in PPO_ARGS))
            steps.append((params, float(stats["total_loss"])))
        out[name] = dict(start=start, steps=steps, final_state=state)
    return out, batches


# ---------------------------------------------------------------- parity
def test_ac_apply_and_sample_actions_match_jax():
    import jax
    import jax.numpy as jnp

    from ray_memory_management_tpu.rllib.models import (
        ac_apply, ac_init, params_to_numpy)

    jparams = ac_init(jax.random.key(0), 4, 3, (64, 64))
    params = rl_params_from_jax(params_to_numpy(jparams), "cpu")
    obs = np.random.default_rng(1).normal(size=(256, 4)).astype(np.float32)
    jl, jv = ac_apply(jparams, jnp.asarray(obs))
    logits, values = tm.ac_apply(params, torch.from_numpy(obs))
    assert_close(logits, jl)
    assert_close(values, jv)

    # logp and value of the port's draws, against JAX's log-softmax at
    # the same actions
    actions, logp, v = tm.sample_actions(params, obs, tm.make_generator(7))
    jlogp_all = np.asarray(jax.nn.log_softmax(jl))
    assert_close(logp, jlogp_all[np.arange(256), actions.numpy()])
    assert_close(v, jv)

    # the draw's frequencies at a fixed seed follow the softmax
    one = np.repeat(obs[:1], 20000, axis=0)
    a, _, _ = tm.sample_actions(params, one, tm.make_generator(11))
    freq = np.bincount(a.numpy(), minlength=3) / len(a)
    np.testing.assert_allclose(freq, np.exp(jlogp_all[0]), atol=0.02)


def test_compute_gae_bit_equal():
    from ray_memory_management_tpu.rllib import sample_batch as jsb

    rng = np.random.default_rng(2)
    n = 300
    rewards = rng.normal(size=n).astype(np.float32)
    values = rng.normal(size=n).astype(np.float32)
    dones = (rng.uniform(size=n) < 0.05).astype(np.float32)
    got = sb.compute_gae(rewards, values, dones, 0.7, gamma=0.99, lam=0.95)
    want = jsb.compute_gae(rewards, values, dones, 0.7, gamma=0.99,
                           lam=0.95)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["ppo", "pg", "a2c"])
def test_three_updates_match_jax(jax_updates, name):
    """Three consecutive updates from the JAX learner's converted params
    and Adam state; each step's params and loss, then the moments."""
    from ray_memory_management_tpu_torch.rllib.pg import make_pg_update
    from ray_memory_management_tpu_torch.rllib.ppo import make_ppo_update

    ref, batches = jax_updates
    ref = ref[name]
    params, opt = port_learner(*ref["start"], LR)
    update = {
        "ppo": lambda: make_ppo_update(opt, 0.2, 0.5, 0.01),
        "pg": lambda: make_pg_update(opt, 0.5, 0.01),
        "a2c": lambda: make_pg_update(opt, 1.0, 0.01),
    }[name]()
    for b, (jparams, jloss) in zip(batches[1:], ref["steps"]):
        stats = update(params, *(torch.from_numpy(b[k]) for k in PPO_ARGS))
        assert_tree_close(params, jparams)
        assert float(stats["total_loss"]) == pytest.approx(jloss, **STAT_TOL)
    adam = ref["final_state"][0]
    state = opt.state_dict()["state"]
    for i, (mu, nu) in enumerate(zip(_jax_leaves(adam.mu),
                                     _jax_leaves(adam.nu))):
        assert_close(state[i]["exp_avg"], mu)
        assert_close(state[i]["exp_avg_sq"], nu)
        assert int(state[i]["step"]) == int(adam.count)


def _recorded_fragments(n_frag, frag_len, seed=5):
    """Fragments recorded from a CPU rollout of the port's worker."""
    from ray_memory_management_tpu_torch.rllib.rollout_worker import (
        RolloutWorker)

    w = RolloutWorker("CartPole", {"max_episode_steps": 50}, (32, 32),
                      seed=seed)
    return [w.sample(frag_len) for _ in range(n_frag)]


def test_ppo_training_step_matches_jax_on_recorded_batch():
    """The slice as a whole: the JAX and port PPO learners start from the
    same weights, get the same recorded fragments through
    ``training_step`` and draw the same minibatch order (both seed
    numpy's generator with the config's seed)."""
    from ray_memory_management_tpu.rllib import PPOConfig as JPPOConfig

    frags = _recorded_fragments(4, 64)

    def cfg(config_cls):
        return (config_cls()
                .environment("CartPole",
                             env_config={"max_episode_steps": 50})
                .rollouts(num_rollout_workers=0, rollout_fragment_length=64)
                .training(train_batch_size=256, lr=3e-3, num_sgd_iter=2,
                          sgd_minibatch_size=64, model={
                              "fcnet_hiddens": [32, 32]})
                .debugging(seed=4))

    jalgo = cfg(JPPOConfig).build()
    algo = cfg(PPOConfig).resources(device="cpu").build()
    algo.set_weights(jalgo.get_weights())
    for a in (jalgo, algo):
        it = iter(frags)
        a.local_worker.sample = lambda n, it=it: next(it)
    jr = jalgo.training_step()
    r = algo.training_step()
    assert r["num_env_steps_sampled"] == jr["num_env_steps_sampled"] == 256
    assert_tree_close(algo.params, jalgo.params)
    for k in ("policy_loss", "vf_loss", "entropy", "total_loss"):
        assert r[k] == pytest.approx(jr[k], **STAT_TOL), k
    jalgo.stop()
    algo.stop()


def test_jax_checkpoint_restores_into_port(tmp_path):
    """A JAX PPO checkpoint (weights, optax Adam state) restores into the
    port's PPO: the same weights, the same greedy actions, and Adam
    moments equal to optax's."""
    from ray_memory_management_tpu.rllib import PPOConfig as JPPOConfig

    def cfg(config_cls):
        return (config_cls()
                .environment("CartPole",
                             env_config={"max_episode_steps": 100})
                .rollouts(num_rollout_workers=0,
                          rollout_fragment_length=100)
                .training(train_batch_size=200)
                .debugging(seed=2))

    jalgo = cfg(JPPOConfig).build()
    jalgo.train()
    blob = jalgo.save()
    algo = cfg(PPOConfig).resources(device="cpu").build()
    algo.restore(blob)
    assert algo.iteration == 1
    assert_tree_close(algo.params, jalgo.params)
    obs = np.random.default_rng(9).normal(
        scale=0.3, size=(64, 4)).astype(np.float32)
    assert [algo.compute_single_action(o) for o in obs] == \
        [jalgo.compute_single_action(o) for o in obs]
    adam = jalgo.opt_state[0]
    state = algo.optimizer.state_dict()["state"]
    for i, mu in enumerate(_jax_leaves(adam.mu)):
        assert_close(state[i]["exp_avg"], mu)
        assert int(state[i]["step"]) == int(adam.count)
    jalgo.stop()
    algo.stop()


def test_learner_needs_a_card_or_cpu():
    """No fallback: without a card and without ``device="cpu"`` the
    learner raises; the weights a worker receives are numpy."""
    cfg = (PPOConfig()
           .environment("CartPole", env_config={"max_episode_steps": 20})
           .rollouts(num_rollout_workers=0, rollout_fragment_length=20)
           .training(train_batch_size=20))
    with pytest.raises(RuntimeError, match="CUDA"):
        cfg.build()
    algo = cfg.resources(device="cpu").build()
    weights = algo.get_weights()
    assert all(isinstance(x, np.ndarray) for x in tm.tree_leaves(weights))
    algo.stop()


# -------------------------------------------- copies of the reference's
class TestEnv:
    def test_cartpole_contract(self):
        env = CartPole(max_episode_steps=50)
        obs = env.reset(seed=3)
        assert obs.shape == (4,) and obs.dtype == np.float32
        total = 0
        for _ in range(60):
            obs, r, term, trunc, _ = env.step(1)
            total += r
            if term or trunc:
                break
        assert term or trunc
        assert total <= 50

    def test_register_env(self):
        register_env("TinyPole", lambda: CartPole(max_episode_steps=10))
        env = make_env("TinyPole")
        assert env.max_episode_steps == 10

    def test_unknown_env(self):
        with pytest.raises(ValueError):
            make_env("NoSuchEnv")


class TestGAE:
    def test_hand_computed(self):
        rewards = np.array([1.0, 1.0, 1.0], dtype=np.float32)
        values = np.array([0.5, 0.5, 0.5], dtype=np.float32)
        dones = np.array([0.0, 0.0, 1.0], dtype=np.float32)
        adv, targets = sb.compute_gae(
            rewards, values, dones, last_value=9.9, gamma=0.9, lam=1.0)
        # terminal step ignores the bootstrap
        assert adv[2] == pytest.approx(1.0 - 0.5)
        # lam=1: discounted monte-carlo returns minus values
        ret1 = 1.0 + 0.9 * 1.0 + 0.81 * 1.0
        assert targets[0] == pytest.approx(ret1)

    def test_bootstrap_mid_episode(self):
        rewards = np.array([0.0], dtype=np.float32)
        values = np.array([0.0], dtype=np.float32)
        dones = np.array([0.0], dtype=np.float32)
        adv, targets = sb.compute_gae(
            rewards, values, dones, last_value=2.0, gamma=0.5, lam=0.9)
        assert targets[0] == pytest.approx(1.0)  # 0 + 0.5 * 2.0


class TestReplay:
    def test_ring_overwrite(self):
        buf = ReplayBuffer(capacity=8, seed=0)
        buf.add_batch({"x": np.arange(6)})
        assert len(buf) == 6
        buf.add_batch({"x": np.arange(6, 12)})
        assert len(buf) == 8
        sample = buf.sample(32)
        assert set(np.unique(sample["x"])) <= set(range(4, 12))

    def test_prioritized(self):
        buf = PrioritizedReplayBuffer(capacity=16, alpha=1.0, seed=0)
        buf.add_batch({"x": np.arange(8)})
        buf.update_priorities(np.array([3]), np.array([100.0]))
        sample = buf.sample(256, beta=1.0)
        # element 3 dominates the distribution
        frac = float(np.mean(sample["x"] == 3))
        assert frac > 0.5
        assert sample["_weights"].max() == pytest.approx(1.0)


class TestPPO:
    def test_donated_learner_step_compiles(self):
        """The bench path (utils/gpu_bench.rl_learner_bench) asks for
        donated learner state; a torch optimizer updates in place either
        way, so the donated update must match the undonated one."""
        from ray_memory_management_tpu_torch.rllib.ppo import make_ppo_update

        params = tm.tree_map(lambda t: t.requires_grad_(True),
                             tm.ac_init(tm.make_generator(0), obs_dim=4,
                                        num_actions=2))
        params2 = tm.tree_map(
            lambda t: t.detach().clone().requires_grad_(True), params)
        opt, opt2 = tm.make_adam(params, 1e-3), tm.make_adam(params2, 1e-3)
        n = 32
        g = tm.make_generator(1)
        obs = torch.randn(n, 4, generator=g)
        actions = torch.zeros(n, dtype=torch.int32)
        old_logp = torch.full((n,), -0.69)
        adv = torch.randn(n, generator=g)
        targets = torch.randn(n, generator=g)

        upd = make_ppo_update(opt, 0.2, 0.5, 0.01, donate=False)
        upd_don = make_ppo_update(opt2, 0.2, 0.5, 0.01, donate=True)
        st1 = upd(params, obs, actions, old_logp, adv, targets)
        st2 = upd_don(params2, obs, actions, old_logp, adv, targets)
        for a, b in zip(tm.tree_leaves(params), tm.tree_leaves(params2)):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), rtol=1e-5)
        assert float(st2["total_loss"]) == pytest.approx(
            float(st1["total_loss"]), rel=1e-5)

    def test_rl_learner_bench_smoke(self):
        """The bench row itself (tiny sizes, CPU learner): full stack
        init -> rollout -> learner updates -> stats shape."""
        from ray_memory_management_tpu_torch.utils.gpu_bench import (
            rl_learner_bench,
        )

        r = rl_learner_bench(n_workers=0, iters=1, train_batch=256,
                             fragment=128, num_sgd_iter=2, minibatch=128,
                             device="cpu")
        assert r["env_steps_per_s"] > 0
        assert r["learner_env_steps_per_s"] >= r["env_steps_per_s"]
        assert r["learner_ms"] > 0
        assert r["algo"] == "ppo"

    def test_learns_cartpole(self):
        algo = (PPOConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 200})
                .rollouts(num_rollout_workers=0,
                          rollout_fragment_length=400)
                .training(train_batch_size=1600, lr=3e-3, num_sgd_iter=8,
                          sgd_minibatch_size=256)
                .resources(device="cpu")
                .debugging(seed=1)
                .build())
        first = None
        result = {}
        for _ in range(8):
            result = algo.train()
            if first is None:
                first = result["episode_reward_mean"]
        assert result["episode_reward_mean"] > max(2 * first, 50)
        assert result["training_iteration"] == 8
        assert result["timesteps_total"] >= 8 * 1600
        algo.stop()

    def test_remote_workers(self, rmt_start_regular):
        algo = (PPOConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 100})
                .rollouts(num_rollout_workers=2,
                          rollout_fragment_length=100)
                .training(train_batch_size=400)
                .resources(device="cpu")
                .debugging(seed=0)
                .build())
        r = algo.train()
        assert r["num_env_steps_sampled"] >= 400
        assert r["episodes_total"] > 0
        algo.stop()

    def test_checkpoint_roundtrip(self):
        cfg = (PPOConfig()
               .environment("CartPole",
                            env_config={"max_episode_steps": 100})
               .rollouts(num_rollout_workers=0,
                         rollout_fragment_length=100)
               .training(train_batch_size=200)
               .resources(device="cpu")
               .debugging(seed=2))
        algo = cfg.build()
        algo.train()
        blob = algo.save()
        obs = np.array([0.01, 0.0, 0.02, 0.0], dtype=np.float32)
        action_before = algo.compute_single_action(obs)
        w_before = algo.get_weights()
        algo2 = cfg.build()
        algo2.restore(blob)
        assert algo2.compute_single_action(obs) == action_before
        w_after = algo2.get_weights()
        np.testing.assert_allclose(
            w_before["pi"][0]["w"], w_after["pi"][0]["w"])
        assert algo2.iteration == 1
        algo.stop()
        algo2.stop()


class TestTuneIntegration:
    def test_algorithm_is_trainable(self, rmt_start_regular):
        """Algorithms drop into the Tuner (the reference runs all RLlib
        training through Tune)."""
        from ray_memory_management_tpu_torch.rllib import PPO
        from ray_memory_management_tpu_torch.tune import TuneConfig, Tuner

        results = Tuner(
            PPO,
            param_space={
                "env_spec": "CartPole",
                "env_config": {"max_episode_steps": 50},
                "num_rollout_workers": 0,
                "rollout_fragment_length": 100,
                "train_batch_size": 200,
                "lr": 1e-3,
                "seed": 0,
                "hidden": (16,),
                "device": "cpu",
            },
            tune_config=TuneConfig(metric="episode_reward_mean",
                                   mode="max", num_samples=1,
                                   max_iterations=2),
        ).fit()
        best = results.get_best_result("episode_reward_mean", "max")
        assert best.metrics["training_iteration"] == 2


class TestPG:
    def test_learns_cartpole(self):
        """Plain REINFORCE with a value baseline improves CartPole —
        single pass per batch, no ratio/clip (pg.py; the reference's
        pg_tf_policy.py:31 loss)."""
        from ray_memory_management_tpu_torch.rllib import PGConfig

        algo = (PGConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 200})
                .rollouts(num_rollout_workers=0,
                          rollout_fragment_length=400)
                .training(train_batch_size=1600, lr=1e-3,
                          entropy_coeff=0.02)
                .resources(device="cpu")
                .debugging(seed=1)
                .build())
        assert algo.num_sgd_iter == 1  # PG: no trust region, one pass
        first = None
        best = 0.0
        result = {}
        for _ in range(15):
            result = algo.train()
            if first is None:
                first = result["episode_reward_mean"]
            best = max(best, result["episode_reward_mean"])
            if best > 100:
                break
        assert best > max(1.5 * first, 50), (first, best, result)
        algo.stop()

    def test_a2c_preset(self):
        from ray_memory_management_tpu_torch.rllib import A2CConfig

        algo = (A2CConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 100})
                .rollouts(num_rollout_workers=0,
                          rollout_fragment_length=200)
                .training(train_batch_size=400)
                .resources(device="cpu")
                .debugging(seed=0)
                .build())
        r = algo.train()
        assert r["num_env_steps_sampled"] >= 400
        assert "vf_loss" in r
        algo.stop()
