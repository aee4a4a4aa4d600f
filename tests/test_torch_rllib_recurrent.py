"""Recurrent (LSTM) PPO in the PyTorch port.

The port's copy of ``tests/test_rllib.py``'s ``TestRecurrentPPO`` (the
learner on the CPU: ``device="cpu"``; the unroll case drives the
port's functions on torch tensors), and the parity of ``_cell``,
``lstm_ac_seq`` across done resets and three consecutive recurrent-PPO
sequence updates with the JAX package's, from the JAX learner's params
and Adam state carried across by ``models.convert``, on numpy-seeded
sequences.

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
from ray_memory_management_tpu_torch.rllib import models as tm
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def rmt_start_regular():
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


N, T, D, E, H = 6, 40, 3, 16, 16
LR = 1e-2
SEQ_ARGS = ("obs", "actions", "old_logp", "advantages", "targets", "dones",
            "h0", "c0")


def _sequences(n_batches, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(
        obs=rng.normal(size=(N, T, D)).astype(np.float32),
        actions=rng.integers(0, 2, (N, T)).astype(np.int32),
        old_logp=np.log(rng.uniform(0.2, 0.8, (N, T))).astype(np.float32),
        advantages=rng.normal(size=(N, T)).astype(np.float32),
        targets=rng.normal(size=(N, T)).astype(np.float32),
        dones=(rng.uniform(size=(N, T)) < 0.08).astype(np.float32),
        h0=rng.normal(scale=0.5, size=(N, H)).astype(np.float32),
        c0=rng.normal(scale=0.5, size=(N, H)).astype(np.float32))
        for _ in range(n_batches)]


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX side, once per module: one cell step, one unroll per
    sequence (vmapped), and the recurrent-PPO state after one warm update
    with the three updates after it."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_memory_management_tpu.rllib.recurrent import (
        _cell, lstm_ac_init, lstm_ac_seq, make_recurrent_ppo_update)

    params = lstm_ac_init(jax.random.key(2), D, 2, E, H)
    seqs = _sequences(4)
    s = seqs[0]
    x = np.random.default_rng(3).normal(size=(N, E)).astype(np.float32)
    cell = _cell(params["lstm"], jnp.asarray(x), jnp.asarray(s["h0"]),
                 jnp.asarray(s["c0"]))
    unroll = jax.vmap(lambda o, d, h, c: lstm_ac_seq(params, o, d, h, c))(
        s["obs"], s["dones"], s["h0"], s["c0"])
    opt = optax.adam(LR)
    update = make_recurrent_ppo_update(opt, 0.2, 0.5, 0.01)
    p, state, _ = update(params, opt.init(params),
                         *(seqs[0][k] for k in SEQ_ARGS))
    start = (p, state)
    steps = []
    for b in seqs[1:]:
        p, state, stats = update(p, state, *(b[k] for k in SEQ_ARGS))
        steps.append((p, float(stats["total_loss"])))
    return dict(params=params, x=x, cell=cell, unroll=unroll, start=start,
                steps=steps, final_state=state), seqs


def test_cell_matches_jax(jax_refs):
    from ray_memory_management_tpu.rllib.models import params_to_numpy
    from ray_memory_management_tpu_torch.rllib.recurrent import _cell

    ref, seqs = jax_refs
    params = rl_params_from_jax(params_to_numpy(ref["params"]), "cpu")
    h, c = _cell(params["lstm"], torch.from_numpy(ref["x"]),
                 torch.from_numpy(seqs[0]["h0"]),
                 torch.from_numpy(seqs[0]["c0"]))
    assert_close(h, ref["cell"][0])
    assert_close(c, ref["cell"][1])


def test_lstm_ac_seq_matches_jax_across_dones(jax_refs):
    from ray_memory_management_tpu.rllib.models import params_to_numpy
    from ray_memory_management_tpu_torch.rllib.recurrent import lstm_ac_seq

    ref, seqs = jax_refs
    s = seqs[0]
    assert s["dones"].sum() > 0  # resets happen inside the sequences
    params = rl_params_from_jax(params_to_numpy(ref["params"]), "cpu")
    with torch.no_grad():
        logits, values = lstm_ac_seq(
            params, *(torch.from_numpy(s[k])
                      for k in ("obs", "dones", "h0", "c0")))
    assert_close(logits, ref["unroll"][0])
    assert_close(values, ref["unroll"][1])
    # one sequence at a time gives the same outputs as the batch
    with torch.no_grad():
        one, _ = lstm_ac_seq(params, *(torch.from_numpy(s[k][2])
                                       for k in ("obs", "dones", "h0",
                                                 "c0")))
    assert_close(one, ref["unroll"][0][2])


def test_three_recurrent_ppo_updates_match_jax(jax_refs):
    from ray_memory_management_tpu.rllib.models import params_to_numpy
    from ray_memory_management_tpu_torch.rllib.recurrent import (
        make_recurrent_ppo_update)

    ref, seqs = jax_refs
    jparams, jstate = ref["start"]
    params = tm.tree_map(lambda t: t.requires_grad_(True), rl_params_from_jax(
        params_to_numpy(jparams), "cpu"))
    opt = tm.make_adam(params, LR)
    tm.load_adam_state(opt, adam_state_from_optax(params_to_numpy(jstate)))
    update = make_recurrent_ppo_update(opt, 0.2, 0.5, 0.01)
    for b, (jp, jloss) in zip(seqs[1:], ref["steps"]):
        stats = update(params, *(torch.from_numpy(b[k]) for k in SEQ_ARGS))
        assert_tree_close(params, jp)
        assert float(stats["total_loss"]) == pytest.approx(jloss, **STAT_TOL)
    adam = ref["final_state"][0]
    state = opt.state_dict()["state"]
    for i, mu in enumerate(_jax_leaves(adam.mu)):
        assert_close(state[i]["exp_avg"], mu)
        assert int(state[i]["step"]) == int(adam.count)


class TestRecurrentPPO:
    def test_scan_matches_stepwise(self):
        """The learner's unroll (with done resets) reproduces the
        rollout's step-by-step path exactly — the invariant that makes
        fragments valid training sequences (recurrent.py)."""
        from ray_memory_management_tpu_torch.rllib.recurrent import (
            lstm_ac_init, lstm_ac_seq, lstm_ac_step, lstm_zero_state)

        params = lstm_ac_init(tm.make_generator(0), 4, 2, 16, 16)
        T = 12
        obs = torch.randn(T, 4, generator=tm.make_generator(1)).numpy()
        dones = np.zeros(T, np.float32)
        dones[4] = 1.0  # episode boundary mid-fragment
        h, c = map(torch.from_numpy, lstm_zero_state(16))
        step_logits = []
        with torch.no_grad():
            for t in range(T):
                logits, _, h, c = lstm_ac_step(
                    params, torch.from_numpy(obs[t]), h, c)
                step_logits.append(logits.numpy())
                if dones[t]:
                    h, c = map(torch.from_numpy, lstm_zero_state(16))
            seq_logits, _ = lstm_ac_seq(
                params, torch.from_numpy(obs), torch.from_numpy(dones),
                *map(torch.from_numpy, lstm_zero_state(16)))
        np.testing.assert_allclose(np.stack(step_logits),
                                   seq_logits.numpy(), rtol=2e-5,
                                   atol=2e-5)

    def test_learns_memory_cue_task(self):
        """A POMDP where memory is the WHOLE task: a cue appears only at
        t=0 and the policy is rewarded each later step for acting on it.
        At decision time the observation is identical for both cues, so
        a feedforward policy caps at chance (~half the max return) while
        the LSTM carries the cue forward (the reference's use_lstm
        contract on partially observable tasks)."""
        from ray_memory_management_tpu_torch.rllib import (RecurrentPPOConfig,
                                                     register_env)

        class MemoryCue:
            """obs [cue_active, cue_value]; reward 1 per step for
            matching the remembered cue after it disappears."""

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

        register_env("MemoryCue", lambda **kw: MemoryCue(**kw))
        algo = (RecurrentPPOConfig()
                .environment("MemoryCue", env_config={"length": 8})
                .rollouts(num_rollout_workers=0,
                          rollout_fragment_length=200)
                .training(train_batch_size=1200, lr=3e-3, num_sgd_iter=8,
                          sgd_minibatch_seqs=3, lstm_dim=16,
                          embed_dim=16)
                .resources(device="cpu")
                .debugging(seed=1)
                .build())
        best = 0.0
        result = {}
        for _ in range(15):
            result = algo.train()
            best = max(best, result["episode_reward_mean"])
            if best > 6.5:
                break
        # max return 7.0 (rewards at t=2..8); memoryless chance ~3.5
        assert best > 5.0, (best, result)
        # recurrent inference API: the cue must steer later actions
        a0, state = algo.compute_single_action(
            np.array([1.0, 1.0], np.float32))
        a_pos, _ = algo.compute_single_action(
            np.zeros(2, np.float32), state)
        _, state_neg = algo.compute_single_action(
            np.array([1.0, -1.0], np.float32))
        a_neg, _ = algo.compute_single_action(
            np.zeros(2, np.float32), state_neg)
        assert a_pos == 1 and a_neg == 0  # memory drives the action
        algo.stop()

    def test_remote_recurrent_workers(self, rmt_start_regular):
        from ray_memory_management_tpu_torch.rllib import RecurrentPPOConfig

        algo = (RecurrentPPOConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 50})
                .rollouts(num_rollout_workers=2,
                          rollout_fragment_length=100)
                .training(train_batch_size=400, lstm_dim=16,
                          embed_dim=16)
                .resources(device="cpu")
                .debugging(seed=0)
                .build())
        r = algo.train()
        assert r["num_env_steps_sampled"] >= 400
        assert r["num_sequences"] >= 4
        algo.stop()
