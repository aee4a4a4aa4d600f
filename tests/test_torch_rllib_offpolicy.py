"""IMPALA, APPO and DQN in the PyTorch port.

The port's copy of ``tests/test_rllib.py``'s ``TestIMPALA``, ``TestDQN``
and ``TestAPPO`` (the learner on the CPU: ``device="cpu"``; the
IMPALA V-trace case drives the port's update instead of a jitted one),
and the parity of ``vtrace`` and of three consecutive IMPALA, APPO and
DQN updates (DQN with its target net) with the JAX package's, from the
JAX learner's params and Adam state carried across by
``models.convert``, on numpy-seeded fragments.

Tolerance of every parity check of params, Adam moments and outputs, in
fp32: each element within ``1e-5 * max|leaf| + 1e-6`` of the JAX value;
an update's reported statistics within 1e-4 of their own size.
"""

import numpy as np
import pytest
import torch

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.models.convert import (
    adam_state_from_optax, rl_params_from_jax,
)
from ray_memory_management_tpu_torch.rllib import IMPALAConfig
from ray_memory_management_tpu_torch.rllib import models as tm
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def rmt_start_regular():
    """One runtime for the module's cases that need one (each case's
    algorithm starts and kills its own rollout actors)."""
    rt = rmt.init(num_cpus=4, ignore_reinit_error=True)
    yield rt
    rmt.shutdown()


# the statistics an update reports are means over the minibatch whose
# terms can cancel (mean Q, a loss), so they are held relative to their
# own size
STAT_TOL = dict(rel=1e-4, abs=1e-6)


def _jax_leaves(tree):
    import jax

    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def assert_close(got, want):
    """Each element within 1e-5 * max|want| + 1e-6 of the JAX value."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    tol = 1e-5 * float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def assert_tree_close(port_tree, jax_tree):
    got = tm.tree_leaves(port_tree)
    want = _jax_leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert_close(g, w)


def port_learner(jax_params, jax_opt_state, lr):
    from ray_memory_management_tpu.rllib.models import params_to_numpy

    params = tm.tree_map(lambda t: t.requires_grad_(True), rl_params_from_jax(
        params_to_numpy(jax_params), "cpu"))
    opt = tm.make_adam(params, lr)
    tm.load_adam_state(opt, adam_state_from_optax(
        params_to_numpy(jax_opt_state)))
    return params, opt


T = 200  # one fragment: V-trace's loop runs over all of it
LR = 1e-2


def _fragments(n, obs_dim=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append(dict(
            obs=rng.normal(size=(T, obs_dim)).astype(np.float32),
            actions=rng.integers(0, 2, T).astype(np.int32),
            behavior_logp=np.log(rng.uniform(0.2, 0.8, T)).astype(
                np.float32),
            rewards=rng.normal(size=T).astype(np.float32),
            dones=(rng.uniform(size=T) < 0.05).astype(np.float32),
            bootstrap=np.float32(rng.normal())))
    return out


FRAG_ARGS = ("obs", "actions", "behavior_logp", "rewards", "dones",
             "bootstrap")


def _transitions(n, batch=64, obs_dim=4, seed=1):
    rng = np.random.default_rng(seed)
    return [dict(
        obs=rng.normal(size=(batch, obs_dim)).astype(np.float32),
        actions=rng.integers(0, 2, batch).astype(np.int32),
        rewards=rng.normal(size=batch).astype(np.float32),
        next_obs=rng.normal(size=(batch, obs_dim)).astype(np.float32),
        dones=(rng.uniform(size=batch) < 0.1).astype(np.float32))
        for _ in range(n)]


DQN_ARGS = ("obs", "actions", "rewards", "next_obs", "dones")


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX side, once per module: V-trace on one fragment, and for
    IMPALA, APPO and DQN the state after one warm update and the three
    updates after it."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_memory_management_tpu.rllib.appo import make_appo_update
    from ray_memory_management_tpu.rllib.dqn import make_dqn_update, q_init
    from ray_memory_management_tpu.rllib.impala import (
        make_impala_update, vtrace)
    from ray_memory_management_tpu.rllib.models import ac_init

    frags = _fragments(4)
    trans = _transitions(4)
    f = frags[0]
    values = np.random.default_rng(4).normal(size=T).astype(np.float32)
    target_logp = np.log(np.random.default_rng(5).uniform(
        0.2, 0.8, T)).astype(np.float32)
    vs, pg_adv = vtrace(jnp.asarray(target_logp), f["behavior_logp"],
                        f["rewards"], jnp.asarray(values), f["dones"],
                        f["bootstrap"], gamma=0.99)
    out = {"vtrace": dict(inputs=(target_logp, values),
                          vs=np.asarray(vs), pg_adv=np.asarray(pg_adv))}

    def run(update, params, state, batches, args, extra=()):
        params, state, _ = update(params, *extra, state,
                                  *(batches[0][k] for k in args))
        start = (params, state)
        steps = []
        for b in batches[1:]:
            params, state, stats = update(params, *extra, state,
                                          *(b[k] for k in args))
            steps.append((params, {k: float(v) for k, v in stats.items()}))
        return dict(start=start, steps=steps, final_state=state)

    for name, make in (
            ("impala", lambda o: make_impala_update(o, 0.99, 0.5, 0.01)),
            ("appo", lambda o: make_appo_update(o, 0.99, 0.5, 0.01, 0.3))):
        opt = optax.adam(LR)
        params = ac_init(jax.random.key(6), 4, 2, (32, 32))
        out[name] = run(make(opt), params, opt.init(params), frags,
                        FRAG_ARGS)
    opt = optax.adam(LR)
    params = q_init(jax.random.key(7), 4, 2, (32, 32))
    target = q_init(jax.random.key(8), 4, 2, (32, 32))
    out["dqn"] = run(make_dqn_update(opt, 0.99), params, opt.init(params),
                     trans, DQN_ARGS, extra=(target,))
    out["dqn"]["target"] = target
    return out, frags, trans


def test_vtrace_matches_jax(jax_refs):
    from ray_memory_management_tpu_torch.rllib.impala import vtrace

    ref, frags, _ = jax_refs
    f = frags[0]
    target_logp, values = ref["vtrace"]["inputs"]
    t = {k: torch.from_numpy(np.asarray(f[k])) for k in FRAG_ARGS}
    vs, pg_adv = vtrace(torch.from_numpy(target_logp), t["behavior_logp"],
                        t["rewards"], torch.from_numpy(values), t["dones"],
                        t["bootstrap"], gamma=0.99)
    assert not vs.requires_grad and not pg_adv.requires_grad
    assert_close(vs, ref["vtrace"]["vs"])
    assert_close(pg_adv, ref["vtrace"]["pg_adv"])


def _check_steps(ref, params, opt, steps_fn):
    for (jparams, jstats), stats in zip(ref["steps"], steps_fn()):
        assert_tree_close(params, jparams)
        for k, v in jstats.items():
            assert float(stats[k]) == pytest.approx(v, **STAT_TOL), k
    adam = ref["final_state"][0]
    state = opt.state_dict()["state"]
    for i, (mu, nu) in enumerate(zip(_jax_leaves(adam.mu),
                                     _jax_leaves(adam.nu))):
        assert_close(state[i]["exp_avg"], mu)
        assert_close(state[i]["exp_avg_sq"], nu)
        assert int(state[i]["step"]) == int(adam.count)


@pytest.mark.parametrize("name", ["impala", "appo"])
def test_three_vtrace_updates_match_jax(jax_refs, name):
    from ray_memory_management_tpu_torch.rllib.appo import make_appo_update
    from ray_memory_management_tpu_torch.rllib.impala import (
        make_impala_update)

    ref, frags, _ = jax_refs
    ref = ref[name]
    params, opt = port_learner(*ref["start"], LR)
    update = (make_impala_update(opt, 0.99, 0.5, 0.01) if name == "impala"
              else make_appo_update(opt, 0.99, 0.5, 0.01, 0.3))

    def steps():
        for f in frags[1:]:
            yield update(params, *(torch.from_numpy(np.asarray(f[k]))
                                   for k in FRAG_ARGS))

    _check_steps(ref, params, opt, steps)


def test_three_dqn_updates_match_jax(jax_refs):
    from ray_memory_management_tpu.rllib.models import params_to_numpy
    from ray_memory_management_tpu_torch.rllib.dqn import make_dqn_update

    ref, _, trans = jax_refs
    ref = ref["dqn"]
    params, opt = port_learner(*ref["start"], LR)
    target = rl_params_from_jax(params_to_numpy(ref["target"]), "cpu")
    update = make_dqn_update(opt, 0.99)

    def steps():
        for b in trans[1:]:
            yield update(params, target,
                         *(torch.from_numpy(b[k]) for k in DQN_ARGS))

    _check_steps(ref, params, opt, steps)
    # the target net is read, never trained
    assert_tree_close(target, ref["target"])


class TestIMPALA:
    def test_learns_async(self, rmt_start_regular):
        algo = (IMPALAConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 200})
                .rollouts(num_rollout_workers=2,
                          rollout_fragment_length=200)
                .training(train_batch_size=1600, lr=1e-3)
                .resources(device="cpu")
                .debugging(seed=1)
                .build())
        first = None
        result = {}
        for _ in range(7):
            result = algo.train()
            if first is None:
                first = result["episode_reward_mean"]
        assert result["episode_reward_mean"] > 1.5 * first
        algo.stop()

    def test_vtrace_on_policy_matches_returns(self):
        """On-policy with no clipping active, V-trace targets equal
        discounted returns (rho = c = 1)."""
        from ray_memory_management_tpu_torch.rllib.impala import (
            make_impala_update,
        )

        # run the update with identical inputs; a finite loss and a
        # param change prove the scan path is wired
        params = tm.tree_map(lambda t: t.requires_grad_(True),
                             tm.ac_init(tm.make_generator(0), 4, 2, (8,)))
        before = params["pi"][0]["w"].detach().clone()
        opt = tm.make_adam(params, 1e-2)
        update = make_impala_update(opt, gamma=0.9, vf_coeff=0.5,
                                    entropy_coeff=0.0)
        obs = torch.randn(5, 4, generator=tm.make_generator(1))
        actions = torch.zeros(5, dtype=torch.int32)
        logp = torch.log(torch.full((5,), 0.5))
        rewards = torch.ones(5)
        dones = torch.zeros(5)
        stats = update(params, obs, actions, logp, rewards, dones,
                       torch.tensor(0.0))
        assert np.isfinite(float(stats["total_loss"]))
        assert not np.allclose(params["pi"][0]["w"].detach().numpy(),
                               before.numpy())


class TestDQN:
    def test_learns_cartpole(self):
        """Off-policy learning regression: double-DQN with replay + target
        net reaches the reward threshold (the reference's
        tuned_examples/dqn/cartpole-dqn.yaml contract, CI-scaled)."""
        from ray_memory_management_tpu_torch.rllib import DQNConfig

        algo = (DQNConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 200})
                .rollouts(num_rollout_workers=0,
                          rollout_fragment_length=200)
                .training(lr=1e-3, train_batch_size=128,
                          learning_starts=400,
                          target_network_update_freq=100,
                          updates_per_step=64,
                          epsilon_timesteps=4000,
                          replay_buffer_capacity=20_000)
                .resources(device="cpu")
                .debugging(seed=1)
                .build())
        first = None
        result = {}
        for _ in range(40):
            result = algo.train()
            if first is None:
                first = result["episode_reward_mean"]
            if (result["episode_reward_mean"] or 0) > 100:
                break
        assert result["episode_reward_mean"] > max(1.5 * (first or 9), 60), \
            result["episode_reward_mean"]
        assert result["replay_size"] > 500
        assert result["num_updates"] > 0
        algo.stop()

    def test_remote_workers_and_checkpoint(self, rmt_start_regular,
                                           tmp_path):
        from ray_memory_management_tpu_torch.rllib import DQNConfig

        cfg = (DQNConfig()
               .environment("CartPole",
                            env_config={"max_episode_steps": 100})
               .rollouts(num_rollout_workers=2,
                         rollout_fragment_length=50)
               .training(learning_starts=100, updates_per_step=4)
               .resources(device="cpu")
               .debugging(seed=0))
        algo = cfg.build()
        r = algo.train()
        assert r["num_env_steps_sampled"] >= 100
        # the schedule pins epsilon exactly: eps_initial + frac * span
        expected_eps = 1.0 + min(
            1.0, (r["timesteps_total"] - r["num_env_steps_sampled"])
            / 10_000) * (0.02 - 1.0)
        assert r["epsilon"] == pytest.approx(expected_eps)
        ckpt = str(tmp_path / "dqn")
        import os as _os
        _os.makedirs(ckpt, exist_ok=True)
        algo.save_checkpoint(ckpt)
        algo.stop()

        algo2 = cfg.build()
        algo2.load_checkpoint(ckpt)
        a = algo2.compute_single_action(np.zeros(4, np.float32))
        assert a in (0, 1)
        assert algo2._updates_done == r["num_updates"]
        algo2.stop()


class TestAPPO:
    def test_learns_async(self, rmt_start_regular):
        """Async PPO: IMPALA's overlap with the clipped surrogate —
        learning regression mirrors IMPALA's (appo.py)."""
        from ray_memory_management_tpu_torch.rllib import APPOConfig

        algo = (APPOConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 200})
                .rollouts(num_rollout_workers=2,
                          rollout_fragment_length=200)
                .training(train_batch_size=1600, lr=1e-3,
                          clip_param=0.3)
                .resources(device="cpu")
                .debugging(seed=1)
                .build())
        first = None
        result = {}
        for _ in range(7):
            result = algo.train()
            if first is None:
                first = result["episode_reward_mean"]
        assert result["episode_reward_mean"] > 1.5 * first
        # the surrogate really ran against the behavior policy
        assert "mean_is_ratio" in result
        assert 0.2 < result["mean_is_ratio"] < 5.0
        algo.stop()
