"""MBPETS and AlphaZero in the PyTorch port.

The CEM planner against the JAX package's at ``TestMBPETS``'s settings
(horizon 25, population 256, 5 rounds, an ensemble of 4 MLPs of
128 x 128) given the normals JAX's key schedule draws, three ensemble
updates, a few MBPETS iterations on the CPU and the save/restore
round-trip of the stacked ensemble (the second half of
``TestMBPETS::test_model_based_planning_improves_pendulum``, whose
learning half is ``test_torch_rllib_mbpets_learning.py``), a JAX MBPETS
checkpoint restored into the port; the port's copy of ``TestAlphaZero``
(``device="cpu"``), three AlphaZero updates and one batched leaf
evaluation against JAX's. Tolerances: ``tests/_rl_parity.py``.
"""

import numpy as np
import pytest

from ray_memory_management_tpu_torch.rllib import models as tm
from _port_fixtures import one_intra_op_thread  # noqa: F401
from _rl_parity import (
    assert_adam_close, assert_close, assert_stats_close, assert_tree_close,
    port_adam, port_tree, t, to_numpy,
)

LR = 1e-3
E, OBS, ACT, HID, B = 4, 3, 1, (128, 128), 256
HORIZON, POP, ELITES, ROUNDS, BOUND = 25, 256, 16, 5, 2.0


def _model_batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, OBS)).astype(np.float32),
             rng.uniform(-BOUND, BOUND, (B, ACT)).astype(np.float32),
             rng.normal(scale=0.1, size=(B, OBS)).astype(np.float32),
             rng.normal(-5, 2, B).astype(np.float32))
            for _ in range(n)]


def _az_batches(n, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pi = rng.uniform(size=(64, 9)).astype(np.float32)
        out.append((rng.integers(-1, 2, (64, 9)).astype(np.float32),
                    pi / pi.sum(-1, keepdims=True),
                    rng.choice([-1.0, 0.0, 1.0], 64).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX side, once per module: three ensemble updates after a
    warm one, one CEM plan from the trained ensemble with the normals of
    its key schedule, and three AlphaZero updates plus a leaf
    evaluation."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_memory_management_tpu.rllib.alphazero import make_az_update
    from ray_memory_management_tpu.rllib.mbrl import (
        make_cem_planner, make_model_update, mb_init)
    from ray_memory_management_tpu.rllib.models import mlp_apply, mlp_init

    out = {}

    def run(name, step, state, batches):
        state = step(state, batches[0])[0]
        rec = dict(start=to_numpy(state), steps=[])
        for b in batches[1:]:
            state, stats = step(state, b)
            rec["steps"].append(to_numpy(
                (state, {k: float(v) for k, v in stats.items()})))
        out[name] = rec
        return state

    opt = optax.adam(LR)
    update = make_model_update(opt)
    params = mb_init(jax.random.key(3), E, OBS, ACT, HID)

    def model_step(state, b):
        p, s, loss = update(*state, *map(jnp.asarray, b))
        return (p, s), {"loss": loss}

    params, _ = run("model", model_step, (params, opt.init(params)),
                    _model_batches(4))

    plan = make_cem_planner(HORIZON, POP, ELITES, ROUNDS, ACT, BOUND, 0.99,
                            1.0)
    obs0 = np.array([0.3, -0.9, 0.5], np.float32)
    init_mean = np.random.default_rng(4).uniform(
        -1, 1, (HORIZON, ACT)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    mean = plan(params, jnp.asarray(obs0), key, jnp.asarray(init_mean))
    noise = []
    for _ in range(ROUNDS):  # the fori_loop's key schedule
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, (POP, HORIZON, ACT))))
    out["plan"] = dict(params=to_numpy(params), obs0=obs0,
                       init_mean=init_mean, noise=np.stack(noise),
                       mean=np.asarray(mean))

    opt = optax.adam(LR)
    update = make_az_update(opt, 1e-4)
    k1, k2 = jax.random.split(jax.random.key(6))
    params = {"torso_pi": mlp_init(k1, [9, 32, 9]),
              "torso_v": mlp_init(k2, [9, 32, 1])}

    def az_step(state, b):
        p, s, stats = update(*state, *map(jnp.asarray, b))
        return (p, s), stats

    params, _ = run("az", az_step, (params, opt.init(params)),
                    _az_batches(4))
    leaves = _az_batches(1, seed=7)[0][0]
    o = jnp.asarray(leaves)
    out["eval"] = dict(
        params=to_numpy(params), obs=leaves,
        priors=np.asarray(jax.nn.softmax(mlp_apply(params["torso_pi"], o))),
        values=np.asarray(jnp.tanh(mlp_apply(params["torso_v"], o))[..., 0]))
    return out


def test_three_ensemble_updates_match_jax(jax_refs):
    from ray_memory_management_tpu_torch.rllib.mbrl import make_model_update

    ref = jax_refs["model"]
    params = port_tree(ref["start"][0])
    assert tuple(params[0]["w"].shape) == (E, OBS + ACT, HID[0])
    opt = port_adam(params, ref["start"][1], LR)
    update = make_model_update(opt)
    for b, (wstate, wstats) in zip(_model_batches(4)[1:], ref["steps"]):
        loss = update(params, *(t(x) for x in b))
        assert_tree_close(params, wstate[0])
        assert_stats_close({"loss": loss}, wstats)
    assert_adam_close(opt, ref["steps"][-1][0][1])


def test_cem_plan_matches_jax(jax_refs):
    """One MPC plan at the reference case's settings: with JAX's normals
    the port keeps the same elites every round, so the refined mean
    agrees within the rule."""
    from ray_memory_management_tpu_torch.rllib.mbrl import make_cem_planner

    ref = jax_refs["plan"]
    plan = make_cem_planner(HORIZON, POP, ELITES, ROUNDS, ACT, BOUND, 0.99,
                            1.0)
    mean = plan(port_tree(ref["params"], grad=False), t(ref["obs0"]),
                t(ref["init_mean"]), noise=t(ref["noise"]))
    assert tuple(mean.shape) == (HORIZON, ACT)
    assert_close(mean, ref["mean"])


def test_three_az_updates_and_leaf_evaluation_match_jax(jax_refs):
    from ray_memory_management_tpu_torch.rllib import AlphaZeroConfig
    from ray_memory_management_tpu_torch.rllib.alphazero import (
        make_az_update)

    ref = jax_refs["az"]
    params = port_tree(ref["start"][0])
    opt = port_adam(params, ref["start"][1], LR)
    update = make_az_update(opt, 1e-4)
    for b, (wstate, wstats) in zip(_az_batches(4)[1:], ref["steps"]):
        stats = update(params, *(t(x) for x in b))
        assert_tree_close(params, wstate[0])
        assert_stats_close(stats, wstats)
    assert_adam_close(opt, ref["steps"][-1][0][1])

    # the batched leaf evaluation MCTS calls once a wave
    ev = jax_refs["eval"]
    algo = (AlphaZeroConfig().training(model={"fcnet_hiddens": [32]})
            .resources(device="cpu").build())
    algo.set_weights(ev["params"])
    priors, values = algo._evaluate(ev["obs"])
    assert isinstance(priors, np.ndarray) and isinstance(values, np.ndarray)
    assert algo.evaluations == 1
    assert_close(priors, ev["priors"])
    assert_close(values, ev["values"])
    algo.stop()


def _stacked_equal(a, b):
    for x, y in zip(tm.tree_leaves(a), tm.tree_leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y))


def test_mbpets_iterations_and_ensemble_roundtrip():
    """A few MBPETS iterations on the CPU (random warm-up, then CEM
    planning through the model), and the save/restore round-trip of the
    stacked ensemble into an algorithm built at the defaults."""
    from ray_memory_management_tpu_torch.rllib import MBPETSConfig

    algo = (MBPETSConfig()
            .environment("Pendulum", env_config={"max_episode_steps": 100})
            .training(lr=1e-3, horizon=8, population=64, cem_iters=3,
                      model_updates_per_iter=20, train_batch_size=64)
            .resources(device="cpu")
            .debugging(seed=3)
            .build())
    algo.random_steps = 100
    for _ in range(2):  # 200 env steps an iteration
        r = algo.train()
    assert r["num_updates"] == 40 and np.isfinite(r["model_loss"])
    assert algo.plans_done == 300  # every step after the warm-up planned
    assert np.isfinite(r["episode_reward_mean"])
    a = algo.compute_single_action(np.array([1.0, 0.0, 0.0], np.float32))
    assert a.shape == (1,) and abs(float(a[0])) <= 2.0

    blob = algo.save()
    before = algo.get_weights()
    algo.stop()
    algo2 = (MBPETSConfig()
             .environment("Pendulum", env_config={"max_episode_steps": 100})
             .resources(device="cpu")
             .debugging(seed=3)
             .build())
    algo2.restore(blob)
    _stacked_equal(before, algo2.get_weights())
    assert algo2._updates_done == 40
    algo2.stop()


def test_jax_mbpets_checkpoint_restores_into_port():
    from ray_memory_management_tpu.rllib import MBPETSConfig as JConfig
    from ray_memory_management_tpu_torch.rllib import MBPETSConfig

    def cfg(config_cls):
        return (config_cls()
                .environment("Pendulum",
                             env_config={"max_episode_steps": 50})
                .training(horizon=4, population=16, cem_iters=2,
                          model_updates_per_iter=4, train_batch_size=64)
                .debugging(seed=3))

    jalgo = cfg(JConfig).build()  # 200 random steps, then 4 updates
    jalgo.train()
    blob = jalgo.save()
    algo = cfg(MBPETSConfig).resources(device="cpu").build()
    algo.restore(blob)
    assert_tree_close(algo.params, jalgo.params)
    assert algo._updates_done == jalgo._updates_done == 4
    algo.train()  # plans with the restored ensemble and trains on
    assert algo._updates_done == 8
    jalgo.stop()
    algo.stop()


class TestAlphaZero:
    def test_mcts_finds_forced_win_without_learning(self):
        """PUCT search alone (uniform priors, zero values) must
        concentrate visits on the winning move of a tactics position —
        the search half of AlphaZero, isolated from the network
        (alphazero.py BatchedMCTS; reference mcts.py)."""
        from ray_memory_management_tpu_torch.rllib.alphazero import (
            BatchedMCTS, TicTacToe)

        def uniform_eval(obs):
            B_ = obs.shape[0]
            return (np.full((B_, 9), 1.0 / 9, np.float64), np.zeros(B_))

        g = TicTacToe()
        for mv in (0, 3, 1, 4):  # X holds 0,1: the winning move is 2
            g.step(mv)
        mcts = BatchedMCTS(uniform_eval, n_sims=200,
                           rng=np.random.default_rng(0))
        pi = mcts.search_batch([g], add_noise=False)[0]
        assert int(pi.argmax()) == 2
        assert pi[2] > 0.6  # visits concentrate, not a lucky argmax

    def test_self_play_learns_tictactoe(self):
        """MCTS-guided self-play + the AlphaZero loss beats a random
        opponent decisively after a short run (the reference's
        alpha_zero learning contract, CI-scaled: measured 58W/0L/2D in
        60 games at these settings; thresholds leave slack)."""
        from ray_memory_management_tpu_torch.rllib import (
            AlphaZeroConfig, TicTacToe)

        algo = (AlphaZeroConfig()
                .training(lr=3e-3, num_simulations=32, games_per_iter=32,
                          num_sgd_iter=10)
                .resources(device="cpu")
                .debugging(seed=1)
                .build())
        first_loss = None
        for _ in range(10):
            r = algo.train()
            if first_loss is None:
                first_loss = r["policy_loss"]
        assert r["policy_loss"] < first_loss  # the policy head converges

        rng = np.random.default_rng(42)
        wins = losses = 0
        for _ in range(60):
            g = TicTacToe()
            while g.outcome() is None:
                if g.player == 1:
                    a = algo.compute_single_action(g, greedy_sims=24)
                else:
                    a = int(rng.choice(np.flatnonzero(g.legal())))
                g.step(a)
            out = g.outcome()
            wins += out == 1
            losses += out == -1
        assert wins >= 45 and losses <= 6, (wins, losses)

        # save/restore round-trips the two heads
        blob = algo.save()
        before = algo.get_weights()
        algo.stop()
        algo2 = AlphaZeroConfig().resources(device="cpu").debugging(
            seed=1).build()
        algo2.restore(blob)
        _stacked_equal(before, algo2.get_weights())
        algo2.stop()
