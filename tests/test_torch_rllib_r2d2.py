"""R2D2 in the PyTorch port.

The port's copy of ``tests/test_rllib.py``'s ``TestR2D2`` (the learner
on the CPU: ``device="cpu"``), and three consecutive R2D2 updates with
burn-in — one batched LSTM over the ``[B, T]`` sequences against JAX's
vmap over them — from the JAX params and optax state carried across by
``models.convert``. Tolerances: ``tests/_rl_parity.py``.
"""

import numpy as np
import pytest
import torch

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.rllib import models as tm
from _port_fixtures import one_intra_op_thread  # noqa: F401
from _rl_parity import (
    assert_adam_close, assert_close, assert_stats_close, assert_tree_close,
    port_adam, port_tree, t, to_numpy,
)

LR, NSEQ, T, OBS, ACTS, H, BURN = 1e-3, 8, 12, 3, 2, 16, 4


@pytest.fixture(scope="module")
def rmt_start_regular():
    rt = rmt.init(num_cpus=4, ignore_reinit_error=True)
    yield rt
    rmt.shutdown()


def _sequences(n, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(NSEQ, T, OBS)).astype(np.float32),
             rng.integers(0, ACTS, (NSEQ, T)).astype(np.int32),
             rng.normal(size=(NSEQ, T)).astype(np.float32),
             (rng.uniform(size=(NSEQ, T)) < 0.1).astype(np.float32),
             rng.normal(scale=0.3, size=(NSEQ, H)).astype(np.float32),
             rng.normal(scale=0.3, size=(NSEQ, H)).astype(np.float32),
             rng.normal(size=(NSEQ, OBS)).astype(np.float32))
            for _ in range(n)]


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX side, once per module: the state after one warm update and
    the three updates after it."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_memory_management_tpu.rllib.r2d2 import (
        lstm_q_init, make_r2d2_update)

    opt = optax.adam(LR)
    update = make_r2d2_update(opt, 0.99, BURN)
    params = lstm_q_init(jax.random.key(1), OBS, ACTS, 8, H)
    target = lstm_q_init(jax.random.key(2), OBS, ACTS, 8, H)
    seqs = _sequences(4)
    state = opt.init(params)
    params, state, _ = update(params, target, state,
                              tuple(map(jnp.asarray, seqs[0])))
    out = dict(start=to_numpy((params, state)), target=to_numpy(target),
               steps=[])
    for b in seqs[1:]:
        params, state, stats = update(params, target, state,
                                      tuple(map(jnp.asarray, b)))
        out["steps"].append(to_numpy(
            (params, state, {k: float(v) for k, v in stats.items()})))
    return out, seqs


def _port_cols(b):
    cols = [t(x) for x in b]
    cols[1] = cols[1].long()
    return cols


def test_three_r2d2_updates_match_jax(jax_refs):
    from ray_memory_management_tpu_torch.rllib.r2d2 import make_r2d2_update

    ref, seqs = jax_refs
    params = port_tree(ref["start"][0])
    target = port_tree(ref["target"], grad=False)
    opt = port_adam(params, ref["start"][1], LR)
    update = make_r2d2_update(opt, 0.99, BURN)
    for b, (wp, ws, wstats) in zip(seqs[1:], ref["steps"]):
        stats = update(params, target, *_port_cols(b))
        assert_tree_close(params, wp)
        assert_stats_close(stats, wstats)
    assert_adam_close(opt, ref["steps"][-1][1])
    assert_tree_close(target, ref["target"])


def test_lstm_q_seq_matches_jax(jax_refs):
    """The batched unroll against JAX's scan vmapped over sequences."""
    import jax
    import jax.numpy as jnp

    from ray_memory_management_tpu.rllib.r2d2 import lstm_q_seq as jseq
    from ray_memory_management_tpu_torch.rllib.r2d2 import lstm_q_seq

    ref, seqs = jax_refs
    obs, _, _, dones, h0, c0, _ = seqs[0]
    jparams = ref["target"]
    q, (h, c) = jax.vmap(lambda o, d, a, b: jseq(jparams, o, d, a, b))(
        *map(jnp.asarray, (obs, dones, h0, c0)))
    pq, (ph, pc) = lstm_q_seq(port_tree(jparams, grad=False), t(obs),
                              t(dones), t(h0), t(c0))
    for got, want in ((pq, q), (ph, h), (pc, c)):
        assert_close(got, np.asarray(want))


class TestR2D2:
    def test_learns_memory_cue_offpolicy(self):
        """Recurrent Q-learning from sequence replay with burn-in solves
        the same memory-cue POMDP RecurrentPPO does — off-policy, from
        stale stored sequences (r2d2.py; Kapturowski et al. 2019)."""
        from ray_memory_management_tpu_torch.rllib import (
            R2D2Config, register_env)

        class MemoryCue:
            observation_dim = 2
            num_actions = 2

            def __init__(self, length: int = 8):
                self.length = length
                self._rng = np.random.default_rng(0)
                self._cue = 1
                self._t = 0

            def reset(self, seed=None):
                if seed is not None:
                    self._rng = np.random.default_rng(seed)
                self._cue = int(self._rng.integers(2))
                self._t = 0
                return np.array([1.0, 2.0 * self._cue - 1.0], np.float32)

            def step(self, action):
                self._t += 1
                reward = float(action == self._cue) if self._t > 1 else 0.0
                done = self._t >= self.length
                return (np.zeros(2, np.float32), reward, done, False, {})

        register_env("MemoryCueR2D2", lambda **kw: MemoryCue(**kw))
        algo = (R2D2Config()
                .environment("MemoryCueR2D2", env_config={"length": 8})
                .rollouts(num_rollout_workers=0)
                .training(lr=2e-3, seq_len=16, burn_in=2,
                          seqs_per_step=12, train_batch_seqs=16,
                          updates_per_step=16, target_update_freq=50,
                          lstm_dim=16, embed_dim=16,
                          epsilon_timesteps=4000)
                .resources(device="cpu")
                .debugging(seed=2)
                .build())
        best = 0.0
        result = {}
        for _ in range(30):
            result = algo.train()
            rm = result.get("episode_reward_mean")
            if rm is not None:
                best = max(best, rm)
            if best > 6.5:
                break
        # max return 7.0; memoryless chance ~3.5
        assert best > 5.0, (best, result)
        # the remembered cue must steer the greedy action
        _, state_pos = algo.compute_single_action(
            np.array([1.0, 1.0], np.float32))
        a_pos, _ = algo.compute_single_action(
            np.zeros(2, np.float32), state_pos)
        _, state_neg = algo.compute_single_action(
            np.array([1.0, -1.0], np.float32))
        a_neg, _ = algo.compute_single_action(
            np.zeros(2, np.float32), state_neg)
        assert a_pos == 1 and a_neg == 0
        algo.stop()

    def test_burn_in_warms_without_gradient(self):
        """No gradient may flow through the burn-in unroll: the shipped
        update's step must EQUAL one computed by warming the state
        outside autodiff entirely and differentiating only the tail
        (r2d2_tf_policy.py:113). If the burn-in kept its graph, the two
        would diverge."""
        from ray_memory_management_tpu_torch.rllib.r2d2 import (
            lstm_q_init, lstm_q_seq, make_r2d2_update)

        burn_in = 3
        init = lstm_q_init(tm.make_generator(0), 2, 2, 8, 8)

        def fresh():
            params = tm.trainable(tm.detached_copy(init), "cpu")
            # SGD: the step IS the gradient, scaled
            return params, torch.optim.SGD(tm.tree_leaves(params), lr=1e-2)

        N, T_ = 2, 10
        obs = torch.randn(N, T_, 2, generator=tm.make_generator(1))
        batch = (obs, torch.zeros(N, T_, dtype=torch.long),
                 torch.ones(N, T_), torch.zeros(N, T_), torch.zeros(N, 8),
                 torch.zeros(N, 8),
                 torch.randn(N, 2, generator=tm.make_generator(2)))
        params, opt = fresh()
        update = make_r2d2_update(opt, gamma=0.9, burn_in=burn_in)
        stats = update(params, tm.detached_copy(init), *batch)
        assert np.isfinite(float(stats["td_loss"]))

        # reference step: warm states OUTSIDE autodiff (no gradient can
        # possibly flow), then run the same update with burn_in=0 on the
        # tail only
        with torch.no_grad():
            _, (bh, bc) = lstm_q_seq(init, obs[:, :burn_in],
                                     torch.zeros(N, burn_in),
                                     torch.zeros(N, 8), torch.zeros(N, 8))
        ref, opt0 = fresh()
        update0 = make_r2d2_update(opt0, gamma=0.9, burn_in=0)
        update0(ref, tm.detached_copy(init), obs[:, burn_in:],
                batch[1][:, burn_in:], batch[2][:, burn_in:],
                batch[3][:, burn_in:], bh, bc, batch[6])
        for a, b in zip(tm.tree_leaves(params), tm.tree_leaves(ref)):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(),
                                       rtol=1e-5, atol=1e-6)

    def test_remote_sequence_collection(self, rmt_start_regular):
        from ray_memory_management_tpu_torch.rllib import R2D2Config

        algo = (R2D2Config()
                .environment("CartPole",
                             env_config={"max_episode_steps": 50})
                .rollouts(num_rollout_workers=2)
                .training(seq_len=10, burn_in=2, seqs_per_step=4,
                          learning_starts_seqs=4, train_batch_seqs=4,
                          updates_per_step=2, lstm_dim=8, embed_dim=8)
                .resources(device="cpu")
                .debugging(seed=0)
                .build())
        r = algo.train()
        assert r["num_env_steps_sampled"] >= 40
        assert r["replay_seqs"] >= 4
        algo.stop()
