"""RLlib's multi-agent and connector paths in the PyTorch port.

The port's copy of ``tests/test_rllib.py``'s ``TestMultiAgent`` and
``TestConnectors`` (the learner on the CPU: ``device="cpu"``).
``test_connectors_rejected_by_dqn_sac`` is not copied: SAC is not
ported yet. The cases share one runtime.
"""

import numpy as np
import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.rllib import sample_batch as sb
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def rmt_start_regular():
    """One runtime for the module's cases that need one (each case's
    algorithm starts and kills its own rollout actors)."""
    rt = rmt.init(num_cpus=4, ignore_reinit_error=True)
    yield rt
    rmt.shutdown()


class TestMultiAgent:
    def test_env_contract(self):
        """Dict obs/rewards/dones keyed by agent id, __all__ signalling
        (multi_agent.py; the reference's MultiAgentEnv contract,
        rllib/env/multi_agent_env.py:23)."""
        from ray_memory_management_tpu_torch.rllib import MultiCartPole
        from ray_memory_management_tpu_torch.rllib.multi_agent import ALL_DONE

        env = MultiCartPole(n_agents=3, max_episode_steps=20)
        obs = env.reset(seed=0)
        assert set(obs) == {"agent_0", "agent_1", "agent_2"}
        obs, rew, term, trunc, _ = env.step(
            {aid: 0 for aid in env.agent_ids})
        assert set(rew) <= set(env.agent_ids)
        assert ALL_DONE in term and ALL_DONE in trunc
        # run to the time limit: __all__ truncation fires
        for _ in range(25):
            live = [a for a in obs]
            if not live:
                break
            obs, rew, term, trunc, _ = env.step({a: 0 for a in live})
            if term[ALL_DONE] or trunc[ALL_DONE]:
                break
        assert term[ALL_DONE] or trunc[ALL_DONE]

    def test_fragment_contract(self):
        """Shared-policy fragments stay flat-fragment valid: every
        segment ends done=1 and the bootstrap is exactly 0, so GAE and
        V-trace consumers need no changes."""
        from ray_memory_management_tpu_torch.rllib.multi_agent import (
            MultiAgentRolloutWorker)

        w = MultiAgentRolloutWorker(
            "MultiCartPole", {"n_agents": 2, "max_episode_steps": 20},
            (16,), seed=0)
        batch = w.sample(120)
        n = len(batch[sb.ACTIONS])
        assert n >= 120  # agent transitions, may overshoot one env step
        assert batch[sb.BOOTSTRAP][0] == 0.0
        # the batch ends at a segment boundary by construction
        assert batch[sb.DONES][-1] == 1.0
        assert len(batch[sb.ADVANTAGES]) == n
        stats = w.episode_stats()
        assert stats["episodes"] > 0

    def test_shared_policy_ppo_learns(self):
        """PPO trains the shared policy over a MultiAgentEnv with no
        learner changes — reward (summed over agents) improves."""
        from ray_memory_management_tpu_torch.rllib import PPOConfig

        algo = (PPOConfig()
                .environment("MultiCartPole",
                             env_config={"n_agents": 2,
                                         "max_episode_steps": 200})
                .rollouts(num_rollout_workers=0,
                          rollout_fragment_length=400)
                .training(train_batch_size=1600, lr=3e-3, num_sgd_iter=8,
                          sgd_minibatch_size=256)
                .resources(device="cpu")
                .debugging(seed=1)
                .build())
        first = None
        best = 0.0
        result = {}
        for _ in range(10):
            result = algo.train()
            if first is None:
                first = result["episode_reward_mean"]
            best = max(best, result["episode_reward_mean"])
            if best > 200:
                break
        # two agents, so a mediocre shared policy already sums ~40;
        # learning should clearly beat the start
        assert best > max(1.5 * first, 100), (first, best)
        algo.stop()

    def test_remote_multi_agent_workers(self, rmt_start_regular):
        from ray_memory_management_tpu_torch.rllib import IMPALAConfig

        algo = (IMPALAConfig()
                .environment("MultiCartPole",
                             env_config={"n_agents": 2,
                                         "max_episode_steps": 50})
                .rollouts(num_rollout_workers=2,
                          rollout_fragment_length=100)
                .training(train_batch_size=400)
                .resources(device="cpu")
                .debugging(seed=0)
                .build())
        r = algo.train()
        assert r["num_env_steps_sampled"] >= 400
        algo.stop()


class TestConnectors:
    """Env->policy transform pipeline (the reference's connector
    framework, rllib/connectors/): unit contracts per transform, state
    round-trip, and an end-to-end PPO run through a pipeline."""

    def test_obs_normalizer_stats(self):
        from ray_memory_management_tpu_torch.rllib import ObsNormalizer

        norm = ObsNormalizer()
        rng = np.random.default_rng(0)
        outs = [norm.observe(rng.normal(5.0, 2.0, 3).astype(np.float32))
                for _ in range(2000)]
        tail = np.stack(outs[500:])
        assert abs(float(tail.mean())) < 0.2
        assert 0.7 < float(tail.std()) < 1.3

        # state round-trips into a fresh instance
        norm2 = ObsNormalizer()
        norm2.set_state(norm.state())
        x = np.ones(3, np.float32)
        np.testing.assert_allclose(norm2.observe(x), norm.observe(x),
                                   rtol=1e-5)

    def test_frame_stack_and_clip(self):
        from ray_memory_management_tpu_torch.rllib import ClipReward, FrameStack
        from ray_memory_management_tpu_torch.rllib.connectors import (
            ConnectorPipeline,
        )

        fs = FrameStack(k=3)
        assert fs.obs_dim(2) == 6
        first = fs.on_reset(np.array([1.0, 2.0], np.float32))
        np.testing.assert_allclose(first, [1, 2, 1, 2, 1, 2])
        second = fs.observe(np.array([3.0, 4.0], np.float32))
        np.testing.assert_allclose(second, [1, 2, 1, 2, 3, 4])

        clip = ClipReward(limit=1.0)
        assert clip.reward(7.5) == 1.0 and clip.reward(-3.0) == -1.0

        pipe = ConnectorPipeline([("frame_stack", {"k": 2}),
                                  ("clip_reward", {"limit": 2.0})])
        assert pipe.obs_dim(4) == 8
        assert pipe.reward(9.0) == 2.0
        st = pipe.state()
        pipe2 = ConnectorPipeline([("frame_stack", {"k": 2}),
                                   ("clip_reward", {"limit": 2.0})])
        pipe2.set_state(st)

    def test_ppo_trains_through_pipeline(self):
        """PPO with obs-norm + frame-stack: the model is sized for the
        widened observation and learning still happens."""
        from ray_memory_management_tpu_torch.rllib import PPOConfig

        algo = (PPOConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 200})
                .rollouts(num_rollout_workers=0,
                          rollout_fragment_length=400)
                .training(train_batch_size=1600, lr=3e-3, num_sgd_iter=8,
                          sgd_minibatch_size=256)
                .connectors([("obs_norm", {}), ("frame_stack", {"k": 2})])
                .resources(device="cpu")
                .debugging(seed=1)
                .build())
        assert algo.obs_dim == 8  # 4-dim cartpole obs stacked twice
        first = None
        result = {}
        for _ in range(8):
            result = algo.train()
            if first is None:
                first = result["episode_reward_mean"]
        assert result["episode_reward_mean"] > max(1.5 * first, 40), result
        algo.stop()

    def test_unknown_connector_rejected(self):
        from ray_memory_management_tpu_torch.rllib.connectors import (
            build_pipeline,
        )

        with pytest.raises(ValueError, match="unknown connector"):
            build_pipeline([("nope", {})])

    def test_connector_state_rides_checkpoints(self):
        """Running obs-norm statistics travel with the weights: a
        restored policy must see the SAME normalization it trained with
        (a cold normalizer would feed it wildly different inputs)."""
        from ray_memory_management_tpu_torch.rllib import PPOConfig

        cfg = (PPOConfig()
               .environment("CartPole",
                            env_config={"max_episode_steps": 100})
               .rollouts(num_rollout_workers=0,
                         rollout_fragment_length=200)
               .training(train_batch_size=400)
               .connectors([("obs_norm", {})])
               .resources(device="cpu")
               .debugging(seed=2))
        algo = cfg.build()
        algo.train()
        count_before = algo._infer_pipeline.stages[0]._count
        assert count_before > 0
        obs = np.array([0.01, 0.2, 0.02, -0.1], np.float32)
        action_before = algo.compute_single_action(obs)
        blob = algo.save()
        algo.stop()

        algo2 = cfg.build()
        # nearly cold: only the worker's initial env reset passed through
        assert algo2._infer_pipeline.stages[0]._count <= 1
        algo2.restore(blob)
        assert algo2._infer_pipeline.stages[0]._count == count_before
        assert algo2.compute_single_action(obs) == action_before
        algo2.stop()
