"""The offline family in the PyTorch port: dataset IO and OPE, BC, MARWIL
and CQL.

The port's copy of ``tests/test_rllib.py``'s ``TestOfflineRL``,
``TestMARWIL`` and ``TestCQL`` (the learner on the CPU:
``device="cpu"``), a dataset the JAX package wrote read by the port and
the reverse, and three consecutive BC, MARWIL and CQL updates against
the JAX package's on minibatches of a JAX-written dataset, from its
params and optax state carried across by ``models.convert``.
Tolerances: ``tests/_rl_parity.py``.
"""

import os

import numpy as np
import pytest
import torch

from ray_memory_management_tpu_torch.rllib import sample_batch as sb
from _port_fixtures import one_intra_op_thread  # noqa: F401
from _rl_parity import (
    assert_adam_close, assert_close, assert_stats_close, assert_tree_close,
    port_adam, port_tree, t, to_numpy,
)

LR, MB = 1e-3, 128


def _expert(obs):
    a = 1 if obs[2] + 0.3 * obs[3] > 0 else 0  # push toward lean
    return a, -0.05  # near-deterministic behavior logp


@pytest.fixture(scope="module")
def jax_dataset(tmp_path_factory):
    """A mixed expert/random CartPole recording written by the JAX
    package (two writers in one directory)."""
    from ray_memory_management_tpu.rllib import collect_dataset

    path = str(tmp_path_factory.mktemp("jax_written") / "d")
    collect_dataset("CartPole", path, num_steps=400, policy=_expert,
                    env_config={"max_episode_steps": 100}, seed=0,
                    shard_size=150)
    collect_dataset("CartPole", path, num_steps=600,
                    env_config={"max_episode_steps": 100}, seed=1)
    return path


def _same_data(a, b):
    assert sorted(a.data) == sorted(b.data)
    for k in a.data:
        assert a.data[k].dtype == b.data[k].dtype, k
        np.testing.assert_array_equal(a.data[k], b.data[k])
    np.testing.assert_array_equal(a.recording_starts, b.recording_starts)


def test_jax_written_dataset_reads_in_port(jax_dataset):
    from ray_memory_management_tpu.rllib.offline import (
        DatasetReader as JReader)
    from ray_memory_management_tpu_torch.rllib import DatasetReader

    _same_data(DatasetReader(jax_dataset), JReader(jax_dataset))


def test_port_written_dataset_reads_in_jax(tmp_path):
    """The port's shards are the JAX format: JAX's reader loads them to
    the same arrays, and the two writers make the same columns (the
    terminal flag apart from the episode boundary) from the same run."""
    from ray_memory_management_tpu.rllib import (
        collect_dataset as jcollect)
    from ray_memory_management_tpu.rllib.offline import (
        DatasetReader as JReader)
    from ray_memory_management_tpu_torch.rllib import (
        DatasetReader, collect_dataset)
    from ray_memory_management_tpu_torch.rllib.offline import TERMINATED

    kw = dict(num_steps=500, policy=_expert,
              env_config={"max_episode_steps": 60}, seed=2,
              shard_size=200)
    port = collect_dataset("CartPole", str(tmp_path / "p"), **kw)
    ref = jcollect("CartPole", str(tmp_path / "j"), **kw)
    assert len(os.listdir(port)) == 3
    _same_data(JReader(port), DatasetReader(port))
    _same_data(DatasetReader(port), JReader(ref))
    r = DatasetReader(port)
    assert r.data[TERMINATED].sum() < r.data[sb.DONES].sum()


@pytest.fixture(scope="module")
def jax_refs(jax_dataset):
    """The JAX side, once per module: for BC, MARWIL and CQL the state
    after one warm update on the dataset's minibatches, and the three
    updates after it."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_memory_management_tpu.rllib import BCConfig as JBCConfig
    from ray_memory_management_tpu.rllib.cql import (
        derive_next_obs, make_cql_update)
    from ray_memory_management_tpu.rllib.dqn import q_init
    from ray_memory_management_tpu.rllib.marwil import (
        episode_returns, make_marwil_update)
    from ray_memory_management_tpu.rllib.models import mlp_init
    from ray_memory_management_tpu.rllib.offline import DatasetReader

    reader = DatasetReader(jax_dataset)
    data = derive_next_obs(reader.data, reader.recording_starts)
    returns, valid = episode_returns(
        reader.data[sb.REWARDS], reader.data[sb.DONES], 0.99,
        reader.recording_starts)
    rng = np.random.default_rng(3)
    idx = [rng.integers(0, len(returns), MB) for _ in range(4)]
    cidx = [rng.integers(0, len(data[sb.OBS]), MB) for _ in range(4)]
    batches = {
        "bc": [(reader.data[sb.OBS][i],
                reader.data[sb.ACTIONS][i].astype(np.int32)) for i in idx],
        "marwil": [(reader.data[sb.OBS][i],
                    reader.data[sb.ACTIONS][i].astype(np.int32),
                    returns[i], valid[i]) for i in idx],
        "cql": [tuple(data[k][i] for k in (sb.OBS, sb.ACTIONS, sb.REWARDS,
                                           "next_obs", "terminated"))
                for i in cidx],
    }
    out = {}

    def run(step, state, name):
        state = step(state, batches[name][0])[0]
        rec = dict(start=to_numpy(state), steps=[])
        for b in batches[name][1:]:
            state, stats = step(state, b)
            rec["steps"].append(to_numpy(
                (state, {k: float(v) for k, v in stats.items()})))
        out[name] = rec

    # BC: the JAX algorithm's own jitted update
    jbc = (JBCConfig().environment("CartPole")
           .offline_data(input_path=jax_dataset)
           .training(lr=LR, model={"fcnet_hiddens": [32, 32]})
           .debugging(seed=4).build())

    def bc_step(state, b):
        p, s, loss, acc = jbc._update(*state, *map(jnp.asarray, b))
        return (p, s), {"loss": loss, "acc": acc}

    run(bc_step, (jbc.params, jbc.opt_state), "bc")
    jbc.stop()

    opt = optax.adam(LR)
    update = make_marwil_update(opt, 1.0, 1.0, 1e-2)
    k1, k2 = jax.random.split(jax.random.key(5))
    params = {"pi": mlp_init(k1, [4, 32, 32, 2]),
              "vf": mlp_init(k2, [4, 32, 32, 1])}

    def marwil_step(state, b):
        p, s, c, stats = update(*state, *map(jnp.asarray, b))
        return (p, s, c), stats

    run(marwil_step, (params, opt.init(params), jnp.float32(1.0)),
        "marwil")

    opt = optax.adam(LR)
    update = make_cql_update(opt, 0.99, 1.0)
    params = q_init(jax.random.key(6), 4, 2, (32, 32))
    target = q_init(jax.random.key(7), 4, 2, (32, 32))

    def cql_step(state, b):
        p, s, stats = update(state[0], target, state[1],
                             *map(jnp.asarray, b))
        return (p, s), stats

    run(cql_step, (params, opt.init(params)), "cql")
    out["cql"]["target"] = to_numpy(target)
    return out, batches


def test_three_bc_updates_match_jax(jax_refs):
    from ray_memory_management_tpu_torch.rllib.offline import make_bc_update

    ref, batches = jax_refs
    ref = ref["bc"]
    params = port_tree(ref["start"][0])
    opt = port_adam(params, ref["start"][1], LR)
    update = make_bc_update(opt)
    for b, (wstate, wstats) in zip(batches["bc"][1:], ref["steps"]):
        stats = update(params, t(b[0]), t(b[1], torch.int64))
        assert_tree_close(params, wstate[0])
        assert_stats_close(stats, wstats)
    assert_adam_close(opt, ref["steps"][-1][0][1])


def test_three_marwil_updates_match_jax(jax_refs):
    from ray_memory_management_tpu_torch.rllib.marwil import (
        make_marwil_update)

    ref, batches = jax_refs
    ref = ref["marwil"]
    params = port_tree(ref["start"][0])
    opt = port_adam(params, ref["start"][1], LR)
    c_sq = torch.tensor(float(ref["start"][2]))
    update = make_marwil_update(opt, 1.0, 1.0, 1e-2)
    for b, (wstate, wstats) in zip(batches["marwil"][1:], ref["steps"]):
        c_sq, stats = update(params, c_sq, t(b[0]), t(b[1], torch.int64),
                             t(b[2]), t(b[3]))
        assert_tree_close(params, wstate[0])
        assert_close(c_sq, wstate[2])
        assert_stats_close(stats, wstats)
    assert_adam_close(opt, ref["steps"][-1][0][1])


def test_three_cql_updates_match_jax(jax_refs):
    from ray_memory_management_tpu_torch.rllib.cql import make_cql_update

    ref, batches = jax_refs
    ref = ref["cql"]
    params = port_tree(ref["start"][0])
    target = port_tree(ref["target"], grad=False)
    opt = port_adam(params, ref["start"][1], LR)
    update = make_cql_update(opt, 0.99, 1.0)
    for b, (wstate, wstats) in zip(batches["cql"][1:], ref["steps"]):
        stats = update(params, target, t(b[0]), t(b[1], torch.int64),
                       *(t(x) for x in b[2:]))
        assert_tree_close(params, wstate[0])
        assert_stats_close(stats, wstats)
    assert_adam_close(opt, ref["steps"][-1][0][1])
    assert_tree_close(target, ref["target"])


class TestOfflineRL:
    """Offline stack: dataset IO, behavior cloning, and importance-
    sampling off-policy evaluation (rllib/offline/ json_writer.py:31,
    json_reader.py:198, estimators/importance_sampling.py)."""

    def test_bc_clones_expert_from_dataset(self, tmp_path):
        """Record a scripted 'expert' (CartPole pole-direction policy),
        clone it with BC, and verify both imitation accuracy and that the
        cloned policy performs like the expert — all without any env
        interaction during training."""
        from ray_memory_management_tpu_torch.rllib import (
            BCConfig, collect_dataset)
        from ray_memory_management_tpu_torch.rllib.offline import (
            DatasetReader)

        path = collect_dataset(
            "CartPole", str(tmp_path / "data"), num_steps=4000,
            policy=_expert, env_config={"max_episode_steps": 200}, seed=0,
            shard_size=1500)
        reader = DatasetReader(path)
        assert reader.num_samples == 4000
        assert len(os.listdir(tmp_path / "data")) >= 3  # really sharded

        algo = (BCConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 200})
                .offline_data(input_path=path)
                .training(lr=1e-3, train_batch_size=256,
                          updates_per_step=100, eval_episodes=2)
                .resources(device="cpu")
                .debugging(seed=0)
                .build())
        result = {}
        for _ in range(8):
            result = algo.train()
            if result["action_match"] > 0.95:
                break
        assert result["action_match"] > 0.9, result
        # the scripted expert balances for ~200 steps; the clone should
        # get most of the way there (random policy scores ~20)
        assert result["episode_reward_mean"] > 100, result

        # save/restore round-trips (the Tune Trainable contract — BC has
        # no rollout workers, so restore must not try to sync weights)
        blob = algo.save()
        obs = np.array([0.01, 0.0, 0.05, 0.1], np.float32)
        action = algo.compute_single_action(obs)
        algo.stop()
        algo2 = (BCConfig()
                 .environment("CartPole",
                              env_config={"max_episode_steps": 200})
                 .offline_data(input_path=path)
                 .resources(device="cpu")
                 .debugging(seed=0)
                 .build())
        algo2.restore(blob)
        assert algo2.compute_single_action(obs) == action
        algo2.stop()

    def test_dataset_writer_shards_and_reader_episodes(self, tmp_path):
        from ray_memory_management_tpu_torch.rllib import (
            DatasetReader,
            DatasetWriter,
        )

        w = DatasetWriter(str(tmp_path / "d"), shard_size=100)
        for i in range(3):
            n = 120
            w.write({
                sb.OBS: np.full((n, 2), i, np.float32),
                sb.ACTIONS: np.zeros(n, np.int32),
                sb.REWARDS: np.ones(n, np.float32),
                sb.DONES: np.asarray(([0.0] * 59 + [1.0]) * 2, np.float32),
            })
        w.close()
        r = DatasetReader(str(tmp_path / "d"))
        assert r.num_samples == 360
        eps = list(r.iter_episodes())
        assert len(eps) == 6 and all(
            sb.batch_size(e) == 60 for e in eps)
        mb = r.sample(32)
        assert sb.batch_size(mb) == 32

        # a truncated trailing fragment is NOT an episode by default
        w2 = DatasetWriter(str(tmp_path / "d2"))
        w2.write({sb.OBS: np.zeros((10, 2), np.float32),
                  sb.ACTIONS: np.zeros(10, np.int32),
                  sb.REWARDS: np.ones(10, np.float32),
                  sb.DONES: np.asarray([0, 0, 0, 1] + [0] * 6,
                                       np.float32)})
        w2.close()
        r2 = DatasetReader(str(tmp_path / "d2"))
        assert len(list(r2.iter_episodes())) == 1
        assert len(list(r2.iter_episodes(include_partial=True))) == 2

    def test_importance_sampling_ope(self, tmp_path):
        """Sanity contract of the IS/WIS estimators: evaluating the
        behavior policy itself must reproduce the behavior return, and a
        policy weighted toward better episodes must score higher."""
        from ray_memory_management_tpu_torch.rllib import (
            collect_dataset,
            importance_sampling_estimate,
        )
        from ray_memory_management_tpu_torch.rllib.offline import (
            DatasetReader)

        path = collect_dataset(
            "CartPole", str(tmp_path / "d"), num_steps=2000,
            env_config={"max_episode_steps": 100}, seed=1)
        reader = DatasetReader(path)

        # target == behavior (uniform random): ratios are exactly 1
        n_act = 2
        uniform = lambda obs, acts: np.full(len(acts), -np.log(n_act))
        est = importance_sampling_estimate(reader, uniform, gamma=1.0)
        assert abs(est["wis_estimate"] - est["behavior_mean_return"]) < 1e-6
        assert est["episodes"] > 5
        assert est["effective_sample_size"] > est["episodes"] * 0.99


def _mixed_quality_dataset(tmp_path, expert_steps: int = 1250,
                           random_steps: int = 3750):
    """Mostly-random CartPole transitions with an expert minority — the
    regime where advantage weighting (MARWIL) and conservatism (CQL)
    matter and plain BC is dragged toward the (bad) majority policy."""
    from ray_memory_management_tpu_torch.rllib import collect_dataset
    from ray_memory_management_tpu_torch.rllib.offline import DatasetReader

    path = str(tmp_path / "mixed")
    collect_dataset("CartPole", path, num_steps=expert_steps,
                    policy=_expert,
                    env_config={"max_episode_steps": 200}, seed=0)
    collect_dataset("CartPole", path, num_steps=random_steps, policy=None,
                    env_config={"max_episode_steps": 200}, seed=1)
    # both recordings must land (a second same-directory writer used to
    # overwrite the first's shards)
    assert DatasetReader(path).num_samples == expert_steps + random_steps
    return path


class TestMARWIL:
    def test_beats_bc_on_mixed_data(self, tmp_path):
        """Advantage re-weighting follows the expert half of a mixed
        dataset where plain cloning imitates the average policy
        (marwil.py's Wang et al. 2018 contract; the reference's
        tuned_examples/marwil/cartpole-marwil.yaml, CI-scaled).
        beta=0 must degenerate to BC exactly (uniform weights)."""
        from ray_memory_management_tpu_torch.rllib import (
            BCConfig, MARWILConfig)

        path = _mixed_quality_dataset(tmp_path)

        def run(config):
            algo = (config
                    .environment("CartPole",
                                 env_config={"max_episode_steps": 500})
                    .offline_data(input_path=path)
                    .training(lr=1e-3, train_batch_size=256,
                              updates_per_step=100, eval_episodes=3)
                    .resources(device="cpu")
                    .debugging(seed=0)
                    .build())
            result = {}
            for _ in range(8):
                result = algo.train()
            algo.stop()
            return result

        marwil = run(MARWILConfig())
        bc = run(BCConfig())
        # the re-weighted clone should clearly outperform the average-
        # policy clone on mixed data
        assert marwil["episode_reward_mean"] > 120, marwil
        assert (marwil["episode_reward_mean"]
                > bc["episode_reward_mean"] + 30), (marwil, bc)
        # weights really spread (expert rows upweighted vs random rows)
        assert marwil["mean_weight"] > 0

    def test_beta_zero_weights_are_uniform(self, tmp_path):
        from ray_memory_management_tpu_torch.rllib import MARWILConfig

        path = _mixed_quality_dataset(tmp_path, expert_steps=300,
                                      random_steps=300)
        algo = (MARWILConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 50})
                .offline_data(input_path=path)
                .training(beta=0.0, train_batch_size=128,
                          updates_per_step=8, eval_episodes=1)
                .resources(device="cpu")
                .debugging(seed=0)
                .build())
        result = algo.train()
        # exp(0 * adv / c) == 1 for every row
        assert abs(result["mean_weight"] - 1.0) < 1e-5, result
        algo.stop()


class TestCQL:
    def test_learns_cartpole_offline(self, tmp_path):
        """Conservative Q-learning reaches the reward threshold from a
        fixed mixed-quality dataset with no environment interaction
        (cql.py; the reference's CQL contract on offline data). The
        conservative penalty must be active (positive logsumexp gap)."""
        from ray_memory_management_tpu_torch.rllib import CQLConfig

        path = _mixed_quality_dataset(tmp_path)
        algo = (CQLConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 500})
                .offline_data(input_path=path)
                .training(lr=5e-4, gamma=0.99, cql_alpha=1.0,
                          train_batch_size=256, updates_per_step=150,
                          target_update_freq=100, eval_episodes=3)
                .resources(device="cpu")
                .debugging(seed=0)
                .build())
        result = {}
        best = 0.0
        for _ in range(10):
            result = algo.train()
            best = max(best, result["episode_reward_mean"])
            if best > 150:
                break
        assert best > 120, (best, result)
        assert result["cql_penalty"] > 0, result
        # checkpoint round-trip preserves the target net + Adam moments
        blob = algo.save()
        algo.stop()
        algo2 = (CQLConfig()
                 .environment("CartPole",
                              env_config={"max_episode_steps": 500})
                 .offline_data(input_path=path)
                 .training(train_batch_size=256, updates_per_step=1)
                 .resources(device="cpu")
                 .debugging(seed=0)
                 .build())
        algo2.restore(blob)
        assert algo2._updates_done == algo._updates_done
        algo2.stop()

    def test_boundary_semantics_across_recordings(self, tmp_path):
        """Appended recordings are independent streams: returns must not
        accumulate across the boundary, a recording's truncated tail is
        invalid, TD successors never cross recordings, and the reader
        keeps the column intersection of mixed-schema shards."""
        from ray_memory_management_tpu_torch.rllib.collector import NEXT_OBS
        from ray_memory_management_tpu_torch.rllib.cql import (
            derive_next_obs)
        from ray_memory_management_tpu_torch.rllib.marwil import (
            episode_returns)
        from ray_memory_management_tpu_torch.rllib.offline import (
            DatasetReader, DatasetWriter)

        # recording A rows 0-2 (episode 0-1, truncated tail 2); B rows 3-5
        rewards = np.ones(6, np.float32)
        dones = np.array([0, 1, 0, 0, 1, 0], np.float32)
        starts = np.array([0, 3])
        returns, valid = episode_returns(rewards, dones, 1.0, starts)
        assert valid.tolist() == [1, 1, 0, 1, 1, 0]
        assert returns[0] == 2  # stops at A's own episode end
        assert returns[2] == 1  # tail: no bleed into B's returns
        assert returns[3] == 2

        obs = np.arange(6, dtype=np.float32)[:, None]
        data = {sb.OBS: obs, sb.DONES: dones,
                sb.ACTIONS: np.zeros(6, np.int32), sb.REWARDS: rewards}
        out = derive_next_obs(data, starts)
        # both truncated tails (rows 2 and 5) dropped, episodes intact
        assert len(out[sb.OBS]) == 4
        np.testing.assert_allclose(out[NEXT_OBS][0], obs[1])

        # reader: two writers, one legacy (no next_obs) — intersection
        w1 = DatasetWriter(str(tmp_path / "d"))
        w1.write({sb.OBS: obs[:3], sb.ACTIONS: np.zeros(3, np.int32),
                  sb.REWARDS: rewards[:3], sb.DONES: dones[:3],
                  NEXT_OBS: obs[:3]})
        w1.close()
        w2 = DatasetWriter(str(tmp_path / "d"))
        w2.write({sb.OBS: obs[3:], sb.ACTIONS: np.zeros(3, np.int32),
                  sb.REWARDS: rewards[3:], sb.DONES: dones[3:]})
        w2.close()
        r = DatasetReader(str(tmp_path / "d"))
        assert r.num_samples == 6
        assert len(r.recording_starts) == 2
        assert NEXT_OBS not in r.data  # intersection, never a ragged col
        # iter_episodes: exactly the two complete episodes, no merged
        # cross-recording fragment
        eps = list(r.iter_episodes())
        assert len(eps) == 2
        assert all(sb.batch_size(e) == 2 for e in eps)

    def test_derive_next_obs_for_legacy_datasets(self, tmp_path):
        """Datasets recorded before the next_obs column can still feed
        CQL: successors are back-filled from the time order and the
        truncated tail row is dropped."""
        from ray_memory_management_tpu_torch.rllib.collector import NEXT_OBS
        from ray_memory_management_tpu_torch.rllib.cql import (
            derive_next_obs)

        obs = np.arange(10, dtype=np.float32)[:, None]
        dones = np.zeros(10, np.float32)
        dones[4] = 1.0  # one completed episode, then a truncated tail
        data = {sb.OBS: obs, sb.DONES: dones,
                sb.ACTIONS: np.zeros(10, np.int32),
                sb.REWARDS: np.ones(10, np.float32)}
        out = derive_next_obs(data)
        assert len(out[sb.OBS]) == 9  # non-terminal tail row dropped
        # within-episode successor: next_obs[t] == obs[t+1]
        np.testing.assert_allclose(out[NEXT_OBS][0], obs[1])
        np.testing.assert_allclose(out[NEXT_OBS][7], obs[8])
