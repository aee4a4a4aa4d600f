"""QMIX: cooperative multi-agent Q-learning with monotonic value
factorization.

The reference's QMIX (rllib/algorithms/qmix/qmix.py — replay-trained
joint Q; rllib/algorithms/qmix/qmix_policy.py:141 QMixLoss: per-agent
double-Q values fed through a state-conditioned monotonic mixing
network, Rashid et al. 2018). The whole update — every agent's Q
forward in ONE matmul (agents stack into the batch axis), hypernetwork
mixer, double-Q target mix, Huber TD loss, Adam — runs on the learner's
device; epsilon-greedy rollouts run on CPU.

The mixer enforces dQ_tot/dQ_i >= 0 by taking ``abs`` of hypernetwork-
generated mixing weights (qmix_policy.py's QMixer.forward), so the
argmax over each agent's own Q is the argmax of Q_tot — decentralized
execution stays greedy-consistent with the centralized critic.

``TwoStepCoop`` is the paper's two-step coordination game (QMIX §7.1):
greedy independent learners settle for the safe 7-reward branch; value
factorization with a state-conditioned mixer finds the coordinated
8-reward branch. The suite's learning-regression test requires passing
the 7.0 plateau.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import api
from ..utils.device import resolve_device
from . import sample_batch as sb
from .algorithm import Algorithm, AlgorithmConfig
from .dqn import huber_loss
from .env import register_env
from .models import (
    adam_state_to_cpu, apply_update, copy_into, detached_copy,
    load_adam_state, make_adam, make_generator, mlp_apply, mlp_init,
    params_from_numpy, params_to_numpy, trainable,
)
from .multi_agent import MultiAgentEnv
from .ppo import stats_to_floats
from .replay import ReplayBuffer

STATE = "state"
NEXT_STATE = "next_state"
NEXT_OBS = "next_obs"


class TwoStepCoop(MultiAgentEnv):
    """The QMIX paper's two-step cooperative game. Step 1: agent_0's
    action picks the branch (0 -> safe state 2A, 1 -> risky state 2B).
    Step 2: 2A pays 7 whatever the joint action; 2B pays the matrix
    [[0, 1], [1, 8]] — both agents must pick action 1 for the 8.
    Observations: one-hot state (3) + one-hot agent id (N)."""

    N_STATES = 3  # 0 = first step, 1 = 2A, 2 = 2B

    def __init__(self, n_agents: int = 2, **_):
        self.n_agents = n_agents
        self.agent_ids = [f"agent_{i}" for i in range(n_agents)]
        self.observation_dim = self.N_STATES + n_agents
        self.num_actions = 2
        self._state = 0

    def state(self) -> np.ndarray:
        s = np.zeros(self.N_STATES, np.float32)
        s[self._state] = 1.0
        return s

    def _obs(self) -> Dict[str, np.ndarray]:
        out = {}
        for i, aid in enumerate(self.agent_ids):
            o = np.zeros(self.observation_dim, np.float32)
            o[self._state] = 1.0
            o[self.N_STATES + i] = 1.0
            out[aid] = o
        return out

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        self._state = 0
        return self._obs()

    def step(self, actions: Dict[str, Any]):
        acts = [int(actions[aid]) for aid in self.agent_ids]
        if self._state == 0:
            self._state = 1 if acts[0] == 0 else 2
            reward, done = 0.0, False
        elif self._state == 1:
            reward, done = 7.0, True
        else:
            reward = float([[0.0, 1.0], [1.0, 8.0]][acts[0]][acts[1]])
            done = True
        obs = self._obs()
        rewards = {aid: reward for aid in self.agent_ids}
        dones = {aid: done for aid in self.agent_ids}
        dones["__all__"] = done
        truncs = {aid: False for aid in self.agent_ids}
        truncs["__all__"] = False
        return obs, rewards, dones, truncs, {}


register_env("TwoStepCoop", lambda **kw: TwoStepCoop(**kw))


# ---------------------------------------------------------------- networks
def qmix_init(generator: torch.Generator, obs_dim: int, num_actions: int,
              n_agents: int, state_dim: int, hidden=(64,),
              mixing_dim: int = 32):
    """Shared per-agent Q net + hypernetwork mixer params."""
    return {
        "agent": mlp_init(generator, [obs_dim, *hidden, num_actions]),
        # hypernetworks: linear maps from the global state to the mixing
        # weights (abs applied at use — monotonicity), plus a 2-layer
        # state bias for the output (qmix_policy.py QMixer.V)
        "hyper_w1": mlp_init(generator, [state_dim, n_agents * mixing_dim]),
        "hyper_b1": mlp_init(generator, [state_dim, mixing_dim]),
        "hyper_w2": mlp_init(generator, [state_dim, mixing_dim]),
        "hyper_b2": mlp_init(generator, [state_dim, mixing_dim, 1]),
    }


def agent_q(params, obs):
    """Per-agent Q-values; obs may be (..., obs_dim) — agents fold into
    the batch axis so the device sees one matmul."""
    return mlp_apply(params["agent"], obs)


def mix(params, state, qs, n_agents: int, mixing_dim: int):
    """Monotonic mixer: Q_tot(state, q_1..q_N). qs: (B, N) -> (B,)."""
    B = qs.shape[0]
    w1 = torch.abs(mlp_apply(params["hyper_w1"], state)).reshape(
        B, n_agents, mixing_dim)
    b1 = mlp_apply(params["hyper_b1"], state)
    h = F.elu(torch.einsum("bn,bnm->bm", qs, w1) + b1)
    w2 = torch.abs(mlp_apply(params["hyper_w2"], state))
    b2 = mlp_apply(params["hyper_b2"], state)[:, 0]
    return torch.einsum("bm,bm->b", h, w2) + b2


QMIX_COLUMNS = (STATE, sb.OBS, sb.ACTIONS, sb.REWARDS, NEXT_STATE, NEXT_OBS,
                sb.DONES)


def make_qmix_update(optimizer, gamma: float, n_agents: int,
                     mixing_dim: int):
    """``update(params, target_params, state, obs, actions, rewards,
    next_state, next_obs, dones) -> stats``: one Adam step in place."""

    def update(params, target_params, state, obs, actions, rewards,
               next_state, next_obs, dones):
        B = actions.shape[0]
        # (B, N, D) -> (B*N, D): every agent's forward in one matmul
        flat = obs.reshape(B * n_agents, -1)
        q = agent_q(params, flat).reshape(B, n_agents, -1)
        q_taken = torch.gather(q, -1, actions.long()[..., None])[..., 0]
        q_tot = mix(params, state, q_taken, n_agents, mixing_dim)

        # double-Q per agent: online net argmaxes, target net scores
        with torch.no_grad():
            nflat = next_obs.reshape(B * n_agents, -1)
            next_a = torch.argmax(
                agent_q(params, nflat).reshape(B, n_agents, -1), dim=-1)
            nq_target = agent_q(target_params, nflat).reshape(
                B, n_agents, -1)
            next_q = torch.gather(nq_target, -1, next_a[..., None])[..., 0]
            next_tot = mix(target_params, next_state, next_q, n_agents,
                           mixing_dim)
            td_target = rewards + gamma * (1.0 - dones) * next_tot
        loss = huber_loss(q_tot, td_target).mean()
        apply_update(optimizer, loss)
        return {
            "mean_q_tot": q_tot.detach().mean(),
            "mean_td_error": torch.abs(q_tot.detach() - td_target).mean(),
            "loss": loss.detach(),
        }

    return update


# ---------------------------------------------------------------- rollouts
class QMixRolloutWorker:
    """Epsilon-greedy joint-transition collector over a cooperative
    MultiAgentEnv. Emits columnar joint transitions: state (S,),
    obs/next_obs (N, D), actions (N,), team reward, done — the joint
    replay schema QMIX trains on (qmix.py's EpisodeReplayBuffer,
    collapsed to transitions for the feed-forward mixer)."""

    def __init__(self, env_spec, env_config: Optional[dict], hidden,
                 seed: int):
        from .env import make_env
        from .rollout_worker import pin_rollout_threads

        pin_rollout_threads()
        self.env = make_env(env_spec, env_config)
        if not isinstance(self.env, MultiAgentEnv):
            raise ValueError("QMIX requires a MultiAgentEnv")
        self.n_agents = len(self.env.agent_ids)
        self.rng = np.random.default_rng(seed)
        self.params = qmix_init(
            make_generator(0), self.env.observation_dim,
            self.env.num_actions, self.n_agents,
            len(self.env.state()), hidden)
        self._epsilon = 1.0
        self._obs = self.env.reset(seed=seed)
        self.episode_rewards: List[float] = []
        self._ep_reward = 0.0
        self.episode_lengths: List[int] = []
        self._ep_len = 0

    def ready(self) -> str:
        return "ok"

    def set_weights(self, weights) -> None:
        self.params = params_from_numpy(weights)

    def get_weights(self):
        return params_to_numpy(self.params)

    def _stack_obs(self) -> np.ndarray:
        return np.stack([self._obs[a] for a in self.env.agent_ids])

    def _select_actions(self) -> np.ndarray:
        with torch.no_grad():
            q = agent_q(self.params,
                        torch.from_numpy(self._stack_obs())).numpy()
        acts = q.argmax(axis=-1)
        explore = self.rng.random(self.n_agents) < self._epsilon
        rand = self.rng.integers(self.env.num_actions, size=self.n_agents)
        return np.where(explore, rand, acts).astype(np.int32)
    def sample(self, num_steps: int, epsilon: float) -> Dict[str, np.ndarray]:
        self._epsilon = epsilon
        N, D = self.n_agents, self.env.observation_dim
        S = len(self.env.state())
        cols = {
            STATE: np.zeros((num_steps, S), np.float32),
            sb.OBS: np.zeros((num_steps, N, D), np.float32),
            sb.ACTIONS: np.zeros((num_steps, N), np.int32),
            sb.REWARDS: np.zeros(num_steps, np.float32),
            NEXT_STATE: np.zeros((num_steps, S), np.float32),
            NEXT_OBS: np.zeros((num_steps, N, D), np.float32),
            sb.DONES: np.zeros(num_steps, np.float32),
        }
        for t in range(num_steps):
            cols[STATE][t] = self.env.state()
            cols[sb.OBS][t] = self._stack_obs()
            acts = self._select_actions()
            cols[sb.ACTIONS][t] = acts
            obs, rewards, dones, truncs, _ = self.env.step(
                {a: int(acts[i])
                 for i, a in enumerate(self.env.agent_ids)})
            self._obs = obs
            # team reward: cooperative tasks share one scalar (the
            # reference sums per-agent rewards into the mixer target)
            r = float(sum(rewards.values())) / self.n_agents
            done = bool(dones.get("__all__")) or bool(
                truncs.get("__all__"))
            cols[sb.REWARDS][t] = r
            cols[NEXT_STATE][t] = self.env.state()
            cols[NEXT_OBS][t] = self._stack_obs()
            cols[sb.DONES][t] = float(done)
            self._ep_reward += r
            self._ep_len += 1
            if done:
                self.episode_rewards.append(self._ep_reward)
                self.episode_lengths.append(self._ep_len)
                self._ep_reward, self._ep_len = 0.0, 0
                self._obs = self.env.reset(
                    seed=int(self.rng.integers(1 << 31)))
        return cols

    def episode_stats(self, window: int = 100) -> Dict[str, Any]:
        return sb.episode_stats_summary(
            self.episode_rewards, self.episode_lengths, window)

    def stop(self) -> str:
        return "stopped"


class _QMixWorkerSet:
    def __init__(self, env_spec, env_config, hidden, num_workers: int,
                 seed: int):
        cls = api.remote(QMixRolloutWorker)
        self.remote_workers = [
            cls.options(num_cpus=1).remote(
                env_spec, env_config, hidden, seed + 1000 * (i + 1))
            for i in range(num_workers)
        ]
        api.get([w.ready.remote() for w in self.remote_workers])

    def sample(self, num_steps: int, epsilon: float = 0.0) -> List:
        return [w.sample.remote(num_steps, epsilon)
                for w in self.remote_workers]

    def set_weights(self, weights) -> List:
        return [w.set_weights.remote(weights)
                for w in self.remote_workers]

    def stats(self) -> List[Dict[str, Any]]:
        return api.get(
            [w.episode_stats.remote() for w in self.remote_workers])

    def stop(self) -> None:
        for w in self.remote_workers:
            try:
                api.get(w.stop.remote(), timeout=5)
            except Exception:  # noqa: BLE001
                pass
            api.kill(w)


class QMix(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        from .env import make_env

        self.cfg = config
        self.device = resolve_device(config.get("device"))
        if config.get("connectors"):
            raise ValueError("connectors are not supported by QMIX's "
                             "joint-transition collectors")
        seed = config.get("seed", 0)
        self.np_rng = np.random.default_rng(seed)
        probe = make_env(config["env_spec"], config.get("env_config"))
        if not isinstance(probe, MultiAgentEnv):
            raise ValueError("QMIX requires a MultiAgentEnv")
        self.n_agents = len(probe.agent_ids)
        self.obs_dim = probe.observation_dim
        self.num_actions = probe.num_actions
        self.state_dim = len(probe.state())
        hidden = config.get("hidden", (64,))
        self.mixing_dim = config.get("mixing_embed_dim", 32)
        self.params = trainable(qmix_init(
            make_generator(seed), self.obs_dim, self.num_actions,
            self.n_agents, self.state_dim, hidden, self.mixing_dim),
            self.device)
        self.target_params = detached_copy(self.params)
        self.gamma = config.get("gamma", 0.99)
        self.optimizer = make_adam(self.params, config.get("lr", 5e-4))
        self._update = make_qmix_update(
            self.optimizer, self.gamma, self.n_agents, self.mixing_dim)
        self.replay = ReplayBuffer(
            config.get("replay_buffer_capacity", 20_000), seed=seed)
        self.learning_starts = config.get("learning_starts", 256)
        self.train_batch_size = config.get("train_batch_size", 64)
        self.target_update_freq = config.get(
            "target_network_update_freq", 100)
        self.updates_per_step = config.get("updates_per_step", 16)
        self.eps_initial = config.get("epsilon_initial", 1.0)
        self.eps_final = config.get("epsilon_final", 0.05)
        self.eps_timesteps = config.get("epsilon_timesteps", 3_000)
        self._updates_done = 0
        self._timesteps_total = 0
        self._iteration = 0

        n_workers = config.get("num_rollout_workers", 0)
        self.workers = None
        self.local_worker = None
        if n_workers > 0:
            self.workers = _QMixWorkerSet(
                config["env_spec"], config.get("env_config"), hidden,
                n_workers, seed)
        else:
            self.local_worker = QMixRolloutWorker(
                config["env_spec"], config.get("env_config"), hidden,
                seed)

    def _epsilon(self) -> float:
        frac = min(1.0, self._timesteps_total / max(1, self.eps_timesteps))
        return self.eps_initial + frac * (self.eps_final - self.eps_initial)

    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        fragment = self.cfg.get("rollout_fragment_length", 64)
        eps = self._epsilon()
        self._sync_weights()
        if self.workers is not None:
            batches = api.get(self.workers.sample(fragment, eps))
        else:
            batches = [self.local_worker.sample(fragment, eps)]
        n = 0
        for b in batches:
            self.replay.add_batch(b)
            n += len(b[sb.ACTIONS])
        self._timesteps_total += n
        sample_time = time.time() - t0

        stats: Dict[str, Any] = {}
        t1 = time.time()
        if len(self.replay) >= self.learning_starts:
            for _ in range(self.updates_per_step):
                stats = self.learn_on_minibatch(
                    self.replay.sample(self.train_batch_size))
        out = stats_to_floats(stats)
        learn_time = time.time() - t1
        out.update({
            "num_env_steps_sampled": n,
            "replay_size": len(self.replay),
            "epsilon": eps,
            "num_updates": self._updates_done,
            "sample_time_s": sample_time,
            "learn_time_s": learn_time,
        })
        return out

    def learn_on_minibatch(self, mb: Dict[str, np.ndarray]
                           ) -> Dict[str, Any]:
        stats = self._update(
            self.params, self.target_params,
            *(torch.as_tensor(mb[k], device=self.device)
              for k in QMIX_COLUMNS))
        self._updates_done += 1
        if self._updates_done % self.target_update_freq == 0:
            copy_into(self.target_params, self.params)
        return stats

    def compute_actions(self, obs_by_agent: Dict[str, np.ndarray]
                        ) -> Dict[str, int]:
        """Greedy decentralized execution: each agent argmaxes its own
        Q — monotonic mixing guarantees this also argmaxes Q_tot."""
        ids = sorted(obs_by_agent)
        x = torch.as_tensor(np.stack([obs_by_agent[a] for a in ids]),
                            device=self.device)
        with torch.no_grad():
            acts = torch.argmax(agent_q(self.params, x), dim=-1).tolist()
        return {a: int(acts[i]) for i, a in enumerate(ids)}

    def _save_extra_state(self):
        return {
            "opt_state": adam_state_to_cpu(self.optimizer),
            "target_params": params_to_numpy(self.target_params),
            "updates_done": self._updates_done,
        }

    def _load_extra_state(self, state) -> None:
        if not state:
            return
        if "opt_state" in state:
            load_adam_state(self.optimizer, state["opt_state"])
        if "target_params" in state:
            copy_into(self.target_params, state["target_params"])
        self._updates_done = state.get("updates_done", 0)


class QMixConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(QMix)
        self.extra.update({
            "replay_buffer_capacity": 20_000, "learning_starts": 256,
            "target_network_update_freq": 100, "updates_per_step": 16,
            "epsilon_initial": 1.0, "epsilon_final": 0.05,
            "epsilon_timesteps": 3_000, "mixing_embed_dim": 32,
            "hidden": (64,),
        })

    def training(self, *, replay_buffer_capacity=None, learning_starts=None,
                 target_network_update_freq=None, updates_per_step=None,
                 epsilon_initial=None, epsilon_final=None,
                 epsilon_timesteps=None, mixing_embed_dim=None,
                 **kwargs) -> "QMixConfig":
        super().training(**kwargs)
        for k, v in (
                ("replay_buffer_capacity", replay_buffer_capacity),
                ("learning_starts", learning_starts),
                ("target_network_update_freq", target_network_update_freq),
                ("updates_per_step", updates_per_step),
                ("epsilon_initial", epsilon_initial),
                ("epsilon_final", epsilon_final),
                ("epsilon_timesteps", epsilon_timesteps),
                ("mixing_embed_dim", mixing_embed_dim)):
            if v is not None:
                self.extra[k] = v
        return self
