"""MBPETS's learning case in the PyTorch port.

The port's copy of ``tests/test_rllib.py``'s
``TestMBPETS::test_model_based_planning_improves_pendulum`` (the planner
and ensemble on the CPU: ``device="cpu"``), at its settings: 22
iterations of 200 Pendulum steps, 3,200 of them planned by CEM with 5
rounds over a horizon of 25, a population of 256 and an ensemble of 4
MLPs of 128 x 128. On one intra-op thread a plan takes about 130 ms here,
so the case runs for minutes: it is marked ``slow`` and stays out of the
tier-1 run, and ``chip_smoke.py`` holds the same rule with the planner on
the card (phase 16 (c)). Its save/restore half also runs in tier-1, in
``test_torch_rllib_mbrl_az.py``.
"""

import numpy as np
import pytest

from _port_fixtures import one_intra_op_thread  # noqa: F401


class TestMBPETS:
    @pytest.mark.slow
    def test_model_based_planning_improves_pendulum(self):
        """The model-based family (mbrl.py; reference Dreamer/MBMPO
        class): a learned dynamics ensemble + CEM planning must clearly
        beat the random-policy baseline (~-650/ep at these settings).
        Also pins the disagreement penalty's reason for existing:
        without it CEM exploits out-of-distribution model optimism and
        DEGRADES below random."""
        from ray_memory_management_tpu_torch.rllib import MBPETSConfig

        algo = (MBPETSConfig()
                .environment("Pendulum",
                             env_config={"max_episode_steps": 100})
                .training(lr=1e-3, horizon=25, population=256,
                          cem_iters=5, model_updates_per_iter=100,
                          random_steps=1200)
                .resources(device="cpu")
                .debugging(seed=3)
                .build())
        first = None
        for _ in range(22):
            r = algo.train()
            if first is None and not np.isnan(r["episode_reward_mean"]):
                first = r["episode_reward_mean"]
        assert r["model_loss"] < 0.05  # the dynamics model converged
        assert r["episode_reward_mean"] > first + 100, (
            first, r["episode_reward_mean"])
        assert r["episode_reward_mean"] > -560  # beats random (~-650)

        # save/restore round-trips the stacked ensemble
        blob = algo.save()
        before = algo.get_weights()
        algo.stop()
        from ray_memory_management_tpu_torch.rllib import MBPETSConfig as C2
        from ray_memory_management_tpu_torch.rllib.models import tree_leaves

        algo2 = (C2()
                 .environment("Pendulum",
                              env_config={"max_episode_steps": 100})
                 .resources(device="cpu")
                 .debugging(seed=3)
                 .build())
        algo2.restore(blob)
        for a, b in zip(tree_leaves(before),
                        tree_leaves(algo2.get_weights())):
            np.testing.assert_allclose(a, b)
        algo2.stop()
