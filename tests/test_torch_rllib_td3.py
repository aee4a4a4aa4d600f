"""TD3 and DDPG in the PyTorch port.

The port's copy of ``tests/test_rllib.py``'s ``TestTD3`` (the learner on
the CPU: ``device="cpu"``), and three consecutive TD3 and DDPG updates
against the JAX package's from its params and its two optax states
carried across by ``models.convert`` (the target-smoothing draws JAX's
keys give, injected; the delayed actor step on the host's schedule).
Tolerances: ``tests/_rl_parity.py``.
"""

import numpy as np
import pytest

from ray_memory_management_tpu_torch.rllib import models as tm
from _port_fixtures import one_intra_op_thread  # noqa: F401
from _rl_parity import (
    assert_adam_close, assert_stats_close, assert_tree_close,
    port_adam, port_tree, t, to_numpy,
)

# lr: TD3's default and the learning tests' setting
B, OBS, ACT, BOUND, LR = 64, 3, 1, 2.0, 1e-3
BATCH_ARGS = ("obs", "act", "rew", "next_obs", "done")


def _transitions(n, seed=1):
    rng = np.random.default_rng(seed)
    return [dict(
        obs=rng.normal(size=(B, OBS)).astype(np.float32),
        act=rng.uniform(-BOUND, BOUND, (B, ACT)).astype(np.float32),
        rew=rng.normal(size=B).astype(np.float32),
        next_obs=rng.normal(size=(B, OBS)).astype(np.float32),
        done=(rng.uniform(size=B) < 0.1).astype(np.float32))
        for _ in range(n)]


def _port_batch(b):
    return tuple(t(b[k]) for k in BATCH_ARGS)


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX side, once per module: for TD3 and DDPG the state after
    one warm update, the three updates after it and the draws each
    took."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_memory_management_tpu.rllib.td3 import (
        make_td3_update, td3_init)

    trans = _transitions(4)
    out = {}

    def batch_of(b):
        return tuple(jnp.asarray(b[k]) for k in BATCH_ARGS)

    keys = [jax.random.key(100 + i) for i in range(4)]
    for name, twin, smooth, delays in (
            ("td3", True, 0.2, [True, False, True, False]),
            ("ddpg", False, 0.0, [True] * 4)):
        opts = [optax.adam(LR) for _ in range(2)]
        update = make_td3_update(opts[0], opts[1], 0.99, 0.005, BOUND,
                                 twin, smooth, 0.5)
        params = td3_init(jax.random.key(6), OBS, ACT, (32, 32), twin)
        target = td3_init(jax.random.key(8), OBS, ACT, (32, 32), twin)
        states = (opts[0].init(params["pi"]), opts[1].init(params))
        params, target, states, _ = update(
            params, target, states, batch_of(trans[0]), keys[0],
            jnp.asarray(delays[0]))
        rec = dict(start=to_numpy((params, target, states)), steps=[],
                   noise=[], delays=delays[1:])
        for b, k, d in zip(trans[1:], keys[1:], delays[1:]):
            rec["noise"].append(np.asarray(jax.random.normal(k, (B, ACT))))
            params, target, states, stats = update(
                params, target, states, batch_of(b), k, jnp.asarray(d))
            rec["steps"].append(to_numpy(
                (params, target, {k_: float(v) for k_, v in stats.items()})))
        rec["final_states"] = to_numpy(states)
        out[name] = rec
    return out, trans


@pytest.mark.parametrize("name", ["td3", "ddpg"])
def test_three_td3_updates_match_jax(jax_refs, name):
    from ray_memory_management_tpu_torch.rllib.td3 import (
        critic_keys, make_td3_update)

    ref, trans = jax_refs
    ref = ref[name]
    twin = name == "td3"
    jparams, jtarget, jstates = ref["start"]
    params = port_tree(jparams)
    target = port_tree(jtarget, grad=False)
    critics = critic_keys(twin)
    pi_opt = port_adam(params["pi"], jstates[0], LR)
    q_opt = port_adam({k: params[k] for k in critics}, jstates[1], LR,
                      critics)
    update = make_td3_update(pi_opt, q_opt, 0.99, 0.005, BOUND, twin,
                             0.2 if twin else 0.0, 0.5)
    for b, noise, d, (wp, wt, wstats) in zip(trans[1:], ref["noise"],
                                             ref["delays"], ref["steps"]):
        stats = update(params, target, _port_batch(b), d, t(noise))
        assert_tree_close(params, wp)
        assert_tree_close(target, wt)
        assert_stats_close(stats, wstats)
    assert_adam_close(pi_opt, ref["final_states"][0])
    assert_adam_close(q_opt, ref["final_states"][1], critics)


def _moments(algo):
    return [float(v.sum()) for opt in algo.opt_states
            for s in tm.adam_state_to_cpu(opt)["state"].values()
            for k, v in sorted(s.items()) if k != "step"]


class TestTD3:
    def test_learns_pendulum(self):
        """Deterministic-policy learning regression: twin-Q TD3 with
        delayed policy updates and target smoothing clears the
        random-policy plateau on pendulum swing-up (the reference's
        tuned_examples/td3/pendulum-td3.yaml contract, CI-scaled)."""
        from ray_memory_management_tpu_torch.rllib import TD3Config

        algo = (TD3Config()
                .environment("Pendulum",
                             env_config={"max_episode_steps": 200})
                .rollouts(num_rollout_workers=0,
                          rollout_fragment_length=200)
                .training(lr=1e-3, train_batch_size=128,
                          learning_starts=500, random_steps=500,
                          updates_per_step=200, tau=0.005,
                          explore_sigma=0.1)
                .resources(device="cpu")
                .debugging(seed=1)
                .build())
        result = {}
        for _ in range(80):
            result = algo.train()
            rm = result.get("episode_reward_mean")
            if rm is not None and rm > -700:
                break
        assert result["episode_reward_mean"] > -900, result
        assert result["num_updates"] > 1000
        # the actor updated on the delayed schedule, not every step
        a = algo.compute_single_action(
            np.array([1.0, 0.0, 0.0], np.float32))
        assert a.shape == (1,) and abs(float(a[0])) <= 2.0
        algo.stop()

    def test_ddpg_preset_and_checkpoint(self):
        """DDPGConfig is TD3 with the deltas off (single critic, delay 1,
        no smoothing); save/restore preserves target nets and Adam
        moments so training resumes exactly."""
        from ray_memory_management_tpu_torch.rllib import DDPGConfig

        def build():
            return (DDPGConfig()
                    .environment("Pendulum",
                                 env_config={"max_episode_steps": 50})
                    .rollouts(num_rollout_workers=0,
                              rollout_fragment_length=64)
                    .training(train_batch_size=32, learning_starts=64,
                              random_steps=64, updates_per_step=4)
                    .resources(device="cpu")
                    .debugging(seed=3)
                    .build())

        algo = build()
        assert "q2" not in algo.params  # single critic
        assert algo.policy_delay == 1
        for _ in range(3):
            algo.train()
        blob = algo.save()
        updates = algo._updates_done
        moments = _moments(algo)
        algo.stop()

        algo2 = build()
        algo2.restore(blob)
        assert algo2._updates_done == updates
        np.testing.assert_allclose(_moments(algo2), moments, rtol=1e-6)
        algo2.train()
        assert algo2._updates_done > updates
        algo2.stop()


