"""RLlib-slim: RL algorithms with CPU rollout actors + a torch learner.

The reference's RLlib (python/ray/rllib/ — Algorithm/AlgorithmConfig,
rollout workers, PG/A2C, PPO, IMPALA, APPO, DQN, recurrent PPO, replay
buffers): the learner runs on the card (``device`` in the config, or
``AlgorithmConfig.resources(device=...)``; ``"cpu"`` to run without
one), rollouts are CPU actors, and weights broadcast as numpy through
the object store.
"""

from .algorithm import Algorithm, AlgorithmConfig  # noqa: F401
from .appo import APPO, APPOConfig  # noqa: F401
from .connectors import (  # noqa: F401
    ClipReward,
    Connector,
    ConnectorPipeline,
    FrameStack,
    ObsNormalizer,
    register_connector,
)
from .dqn import DQN, DQNConfig  # noqa: F401
from .env import (  # noqa: F401
    CartPole,
    Env,
    Pendulum,
    make_env,
    register_env,
)
from .impala import IMPALA, IMPALAConfig  # noqa: F401
from .multi_agent import (  # noqa: F401
    MultiAgentEnv,
    MultiAgentRolloutWorker,
    MultiCartPole,
)
from .pg import A2CConfig, PG, PGConfig  # noqa: F401
from .ppo import PPO, PPOConfig  # noqa: F401
from .recurrent import (  # noqa: F401
    RecurrentPPO,
    RecurrentPPOConfig,
    RecurrentRolloutWorker,
)
from .replay import PrioritizedReplayBuffer, ReplayBuffer  # noqa: F401
from .rollout_worker import RolloutWorker, WorkerSet  # noqa: F401
