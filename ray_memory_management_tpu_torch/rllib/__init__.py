"""RLlib-slim: RL algorithms with CPU rollout actors + a torch learner.

The reference's RLlib (python/ray/rllib/ — Algorithm/AlgorithmConfig,
rollout workers, PG/A2C, PPO, IMPALA, APPO, DQN, recurrent PPO and R2D2,
SAC, TD3/DDPG, the offline family (BC, CQL, MARWIL, dataset IO and
off-policy evaluation), QMIX, MADDPG, SlateQ, MBPETS, AlphaZero, ES/ARS,
contextual bandits, replay buffers): the learner runs on the card
(``device`` in the config, or ``AlgorithmConfig.resources(device=...)``;
``"cpu"`` to run without one), rollouts are CPU actors, and weights
broadcast as numpy through the object store.
"""

from .algorithm import Algorithm, AlgorithmConfig  # noqa: F401
from .connectors import (  # noqa: F401
    ClipReward,
    Connector,
    ConnectorPipeline,
    FrameStack,
    ObsNormalizer,
    register_connector,
)
from .alphazero import AlphaZero, AlphaZeroConfig, TicTacToe  # noqa: F401
from .appo import APPO, APPOConfig  # noqa: F401
from .ars import ARS, ARSConfig  # noqa: F401
from .bandit import (  # noqa: F401
    BanditLinTS,
    BanditLinTSConfig,
    BanditLinUCB,
    BanditLinUCBConfig,
    LinearDiscreteBandit,
)
from .cql import CQL, CQLConfig  # noqa: F401
from .dqn import DQN, DQNConfig  # noqa: F401
from .marwil import MARWIL, MARWILConfig  # noqa: F401
from .mbrl import MBPETS, MBPETSConfig  # noqa: F401
from .multi_agent import (  # noqa: F401
    MultiAgentEnv,
    MultiAgentRolloutWorker,
    MultiCartPole,
)
from .es import ES, ESConfig  # noqa: F401
from .env import (  # noqa: F401
    CartPole,
    Env,
    Pendulum,
    make_env,
    register_env,
)
from .impala import IMPALA, IMPALAConfig  # noqa: F401
from .maddpg import MADDPG, MADDPGConfig, Rendezvous  # noqa: F401
from .qmix import QMix, QMixConfig, TwoStepCoop  # noqa: F401
from .offline import (  # noqa: F401
    BC,
    BCConfig,
    DatasetReader,
    DatasetWriter,
    collect_dataset,
    importance_sampling_estimate,
)
from .pg import A2CConfig, PG, PGConfig  # noqa: F401
from .ppo import PPO, PPOConfig  # noqa: F401
from .r2d2 import R2D2, R2D2Config  # noqa: F401
from .recurrent import (  # noqa: F401
    RecurrentPPO,
    RecurrentPPOConfig,
    RecurrentRolloutWorker,
)
from .replay import PrioritizedReplayBuffer, ReplayBuffer  # noqa: F401
from .sac import SAC, SACConfig  # noqa: F401
from .slateq import InterestEvolution, SlateQ, SlateQConfig  # noqa: F401
from .td3 import TD3, DDPGConfig, TD3Config  # noqa: F401
from .rollout_worker import RolloutWorker, WorkerSet  # noqa: F401
