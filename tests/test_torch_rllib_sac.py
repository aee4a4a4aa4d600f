"""SAC in the PyTorch port.

The port's copy of ``tests/test_rllib.py``'s ``TestSAC`` and
``TestConnectors::test_connectors_rejected_by_dqn_sac`` (the learner on
the CPU: ``device="cpu"``), SAC's ``pi_sample`` log-probability at given
draws, three consecutive SAC updates against the JAX package's from its
params and its three optax states carried across by ``models.convert``
(the draws JAX's keys give, injected), and a JAX SAC checkpoint restored
into the port. Tolerances: ``tests/_rl_parity.py``.
"""

import numpy as np
import pytest
import torch

from ray_memory_management_tpu_torch.rllib import models as tm
from _port_fixtures import one_intra_op_thread  # noqa: F401
from _rl_parity import (
    assert_adam_close, assert_close, assert_stats_close, assert_tree_close,
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
    """The JAX side, once per module: SAC's pi_sample at one key, the
    state after one warm update, the three updates after it and the
    draws each took."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_memory_management_tpu.rllib.sac import (
        make_sac_update, pi_sample, sac_init)

    trans = _transitions(4)
    out = {}
    params = sac_init(jax.random.key(6), OBS, ACT, (32, 32))
    key = jax.random.key(11)
    a, logp = pi_sample(params, jnp.asarray(trans[0]["obs"]), key, BOUND)
    out["pi_sample"] = dict(
        params=params, eps=np.asarray(jax.random.normal(key, (B, ACT))),
        a=np.asarray(a), logp=np.asarray(logp))

    # SAC: three optimizers, a target net apart from the online one
    opts = [optax.adam(LR) for _ in range(3)]
    update = make_sac_update(*opts, 0.99, 0.005, -1.0, BOUND)
    target = sac_init(jax.random.key(8), OBS, ACT, (32, 32))
    log_alpha = jnp.asarray(np.log(0.5), jnp.float32)
    states = (opts[0].init(params["pi"]), opts[1].init(params),
              opts[2].init(log_alpha))

    def batch_of(b):
        return tuple(jnp.asarray(b[k]) for k in BATCH_ARGS)

    keys = [jax.random.key(100 + i) for i in range(4)]
    params, target, log_alpha, states, _ = update(
        params, target, log_alpha, states, batch_of(trans[0]), keys[0])
    sac = dict(start=to_numpy((params, target, log_alpha, states)),
               steps=[], noise=[])
    for b, k in zip(trans[1:], keys[1:]):
        k1, k2 = jax.random.split(k)
        sac["noise"].append(tuple(
            np.asarray(jax.random.normal(kk, (B, ACT))) for kk in (k1, k2)))
        params, target, log_alpha, states, stats = update(
            params, target, log_alpha, states, batch_of(b), k)
        sac["steps"].append(to_numpy(
            (params, target, log_alpha,
             {k_: float(v) for k_, v in stats.items()})))
    sac["final_states"] = to_numpy(states)
    out["sac"] = sac
    return out, trans


def test_pi_sample_matches_jax(jax_refs):
    from ray_memory_management_tpu_torch.rllib.sac import pi_sample

    ref, trans = jax_refs
    r = ref["pi_sample"]
    params = port_tree(r["params"], grad=False)
    a, logp = pi_sample(params, t(trans[0]["obs"]), t(r["eps"]), BOUND)
    assert_close(a, r["a"])
    assert_close(logp, r["logp"])


def test_three_sac_updates_match_jax(jax_refs):
    from ray_memory_management_tpu_torch.rllib.sac import (
        CRITICS, make_sac_update)

    ref, trans = jax_refs
    ref = ref["sac"]
    jparams, jtarget, jlog_alpha, jstates = ref["start"]
    params = port_tree(jparams)
    target = port_tree(jtarget, grad=False)
    log_alpha = torch.tensor(float(jlog_alpha), requires_grad=True)
    pi_opt = port_adam(params["pi"], jstates[0], LR)
    q_opt = port_adam({k: params[k] for k in CRITICS}, jstates[1], LR,
                      CRITICS)
    a_opt = port_adam([log_alpha], jstates[2], LR)
    update = make_sac_update(pi_opt, q_opt, a_opt, 0.99, 0.005, -1.0, BOUND)
    for b, noise, (wp, wt, wa, wstats) in zip(trans[1:], ref["noise"],
                                              ref["steps"]):
        stats = update(params, target, log_alpha, _port_batch(b),
                       tuple(t(n) for n in noise))
        assert_tree_close(params, wp)
        assert_tree_close(target, wt)
        assert_close(log_alpha, wa)
        assert_stats_close(stats, wstats)
    fs = ref["final_states"]
    assert_adam_close(pi_opt, fs[0])
    assert_adam_close(q_opt, fs[1], CRITICS)
    assert_adam_close(a_opt, fs[2])


def test_jax_sac_checkpoint_restores_into_port():
    """A JAX SAC checkpoint (weights, target nets, the three optax
    states, log_alpha) restores into the port's SAC, which trains on."""
    from ray_memory_management_tpu.rllib import SACConfig as JSACConfig
    from ray_memory_management_tpu_torch.rllib import SACConfig
    from ray_memory_management_tpu_torch.rllib.sac import CRITICS

    def cfg(config_cls):
        return (config_cls()
                .environment("Pendulum",
                             env_config={"max_episode_steps": 50})
                .rollouts(num_rollout_workers=0,
                          rollout_fragment_length=64)
                .training(train_batch_size=32, learning_starts=64,
                          random_steps=64, updates_per_step=4)
                .debugging(seed=3))

    jalgo = cfg(JSACConfig).build()
    for _ in range(2):
        jalgo.train()
    blob = jalgo.save()
    algo = cfg(SACConfig).resources(device="cpu").build()
    algo.restore(blob)
    assert algo._updates_done == jalgo._updates_done
    assert_tree_close(algo.params, jalgo.params)
    assert_tree_close(algo.target_params, jalgo.target_params)
    assert abs(float(algo.log_alpha.detach())
               - float(jalgo.log_alpha)) < 1e-6
    pi_s, q_s, a_s = jalgo.opt_states
    assert_adam_close(algo._pi_opt, pi_s)
    assert_adam_close(algo._q_opt, q_s, CRITICS)
    assert_adam_close(algo._a_opt, a_s)
    obs = np.array([1.0, 0.0, 0.0], np.float32)
    assert_close(algo.compute_single_action(obs),
                 jalgo.compute_single_action(obs))
    algo.train()
    assert algo._updates_done > jalgo._updates_done
    jalgo.stop()
    algo.stop()


def _moments(algo):
    return [float(v.sum()) for opt in algo.opt_states
            for s in tm.adam_state_to_cpu(opt)["state"].values()
            for k, v in sorted(s.items()) if k != "step"]


class TestSAC:
    def test_learns_pendulum(self):
        """Continuous-control learning regression: twin-Q SAC with
        entropy auto-tuning improves pendulum swing-up well past the
        random-policy plateau (~-1200..-1400 per 200-step episode; the
        reference's tuned_examples/sac/pendulum-sac.yaml contract,
        CI-scaled)."""
        from ray_memory_management_tpu_torch.rllib import SACConfig

        algo = (SACConfig()
                .environment("Pendulum",
                             env_config={"max_episode_steps": 200})
                .rollouts(num_rollout_workers=0,
                          rollout_fragment_length=200)
                .training(lr=1e-3, train_batch_size=128,
                          learning_starts=500, random_steps=500,
                          updates_per_step=200, tau=0.005)
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
        # entropy auto-tuning drove alpha off its 1.0 init
        assert 0 < result["alpha"] < 0.9
        # the deterministic (mean) policy emits in-range actions
        a = algo.compute_single_action(
            np.array([1.0, 0.0, 0.0], np.float32))
        assert a.shape == (1,) and abs(float(a[0])) <= 2.0
        algo.stop()

    def test_checkpoint_roundtrip(self, tmp_path):
        """save/restore preserves learner state (target nets, temperature,
        optimizer progress) — the Trainable save/restore contract."""
        from ray_memory_management_tpu_torch.rllib import SACConfig

        def build():
            return (SACConfig()
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
        for _ in range(3):
            algo.train()
        blob = algo.save()
        updates = algo._updates_done
        alpha = float(algo.log_alpha.detach())
        moments = _moments(algo)
        algo.stop()

        algo2 = build()
        algo2.restore(blob)
        assert algo2._updates_done == updates
        assert abs(float(algo2.log_alpha.detach()) - alpha) < 1e-6
        # Adam moments really restored (not re-init'd to zeros)
        moments2 = _moments(algo2)
        assert len(moments2) == len(moments)
        np.testing.assert_allclose(moments2, moments, rtol=1e-6)
        algo2.train()  # must keep training from the restored state
        assert algo2._updates_done > updates
        algo2.stop()


class TestConnectors:
    def test_connectors_rejected_by_dqn_sac(self):
        from ray_memory_management_tpu_torch.rllib import (
            DQNConfig, SACConfig)

        for cfg in (DQNConfig().environment("CartPole"),
                    SACConfig().environment("Pendulum")):
            cfg.connectors([("obs_norm", {})]).resources(device="cpu")
            with pytest.raises(ValueError, match="connectors"):
                cfg.build()
