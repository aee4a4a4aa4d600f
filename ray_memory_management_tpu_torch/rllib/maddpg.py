"""MADDPG: multi-agent DDPG with centralized critics (Lowe et al. 2017).

The reference's rllib/algorithms/maddpg/maddpg.py: each agent i trains a
deterministic actor mu_i(o_i) plus a CENTRALIZED critic
Q_i(o_1..o_N, a_1..a_N) that sees every agent's observation and action —
the critic is only needed at training time, so execution stays fully
decentralized. Off-policy over a joint replay buffer; in the actor step
agent i's own action is replaced by mu_i(o_i) while the other agents'
actions come from the batch (the MADDPG gradient).

The reference keeps N independent policy graphs and loops over them;
here the N (homogeneous-shaped) agents' parameters are STACKED along a
leading axis and every per-agent computation — target actions, critic TD
steps, actor gradients, polyak syncs — is a batched matmul over that
axis, so the whole N-agent update runs on the learner's device as one
program whose batch dimension covers agents x minibatch.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .algorithm import Algorithm, AlgorithmConfig
from .env import register_env
from .models import (
    copy_into, detached_copy, make_adam, make_generator, params_to_numpy,
    polyak_, stacked_mlp_apply, stacked_mlp_init, step_on, trainable,
    tree_leaves,
)
from .multi_agent import MultiAgentEnv
from .ppo import stats_to_floats
from .replay import ReplayBuffer


class Rendezvous(MultiAgentEnv):
    """Continuous cooperative rendezvous: N point agents on the [-1,1]^2
    plane apply velocity actions and share the reward
    ``-mean pairwise distance`` (+ a success bonus when gathered) — the
    cooperative-navigation shape of the MADDPG paper's particle envs
    (reference rllib: the MPE simple_spread family), reduced to its
    learning-signal core."""

    def __init__(self, n_agents: int = 2, max_episode_steps: int = 50,
                 gather_radius: float = 0.1):
        self.agent_ids = [f"agent_{i}" for i in range(n_agents)]
        self.n_agents = n_agents
        self.observation_dim = 2 * n_agents  # own pos first, then others
        self.action_dim = 2
        self.action_bound = 1.0
        self.max_episode_steps = max_episode_steps
        self.gather_radius = gather_radius
        self._pos = np.zeros((n_agents, 2), np.float32)
        self._t = 0
        self._rng = np.random.default_rng(0)

    def _obs(self) -> Dict[str, np.ndarray]:
        out = {}
        for i, aid in enumerate(self.agent_ids):
            others = np.delete(self._pos, i, axis=0).ravel()
            out[aid] = np.concatenate([self._pos[i], others]).astype(
                np.float32)
        return out

    def _mean_pairwise(self) -> float:
        d = self._pos[:, None, :] - self._pos[None, :, :]
        dist = np.sqrt((d * d).sum(-1) + 1e-12)
        n = self.n_agents
        return float(dist.sum() / (n * (n - 1))) if n > 1 else 0.0

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._pos = self._rng.uniform(-1, 1, (self.n_agents, 2)).astype(
            np.float32)
        self._t = 0
        return self._obs()

    def step(self, actions: Dict[str, Any]):
        self._t += 1
        for i, aid in enumerate(self.agent_ids):
            a = np.clip(np.asarray(actions[aid], np.float32), -1.0, 1.0)
            self._pos[i] = np.clip(self._pos[i] + 0.1 * a, -1.0, 1.0)
        spread = self._mean_pairwise()
        gathered = spread < self.gather_radius
        r = -spread + (5.0 if gathered else 0.0)
        rewards = {aid: r for aid in self.agent_ids}
        term = bool(gathered)
        trunc = self._t >= self.max_episode_steps
        terms = {aid: term for aid in self.agent_ids}
        truncs = {aid: trunc for aid in self.agent_ids}
        terms["__all__"] = term
        truncs["__all__"] = trunc
        return self._obs(), rewards, terms, truncs, {}


register_env("Rendezvous", Rendezvous)


def maddpg_init(generator: torch.Generator, n_agents: int, obs_dim: int,
                act_dim: int, hidden=(64, 64)):
    """Per-agent actor + centralized critic, STACKED along agent axis 0
    (every leaf is [N, ...])."""
    joint = n_agents * (obs_dim + act_dim)
    return {"pi": stacked_mlp_init(generator, n_agents,
                                   [obs_dim, *hidden, act_dim]),
            "q": stacked_mlp_init(generator, n_agents,
                                  [joint, *hidden, 1])}


def actions_of(pi_stacked, obs_nb, bound: float):
    """Each agent's deterministic action on its own observations:
    obs [N, B, d_o] -> [N, B, d_a]."""
    return bound * torch.tanh(stacked_mlp_apply(pi_stacked, obs_nb))


def q_of(q_stacked, joint):
    """Each agent's critic on the joint input ([B, joint], shared, or
    [N, B, joint], one per agent) -> [N, B]."""
    return stacked_mlp_apply(q_stacked, joint)[..., 0]


def joint_actions(act, mine):
    """Agent i's joint action for its actor step: the batch's actions
    [B, N, d_a] with COLUMN i replaced by mu_i(o_i) (``mine`` [N, B, d_a]
    from the actors), for every i at once -> [N, B, N * d_a]. The one-hot
    masking keeps agent i's gradient on agent i's own actor."""
    B, N, d_a = act.shape
    eye = torch.eye(N, dtype=act.dtype, device=act.device)[:, None, :, None]
    batch_a = act[None]                                  # [1, B, N, d_a]
    mine = mine.transpose(0, 1)[None]                    # [1, B, N, d_a]
    joints = batch_a * (1.0 - eye) + mine * eye          # [N, B, N, d_a]
    return joints.reshape(N, B, N * d_a)


def make_maddpg_update(pi_opt, q_opt, gamma: float, tau: float,
                       bound: float):
    """``update(params, target_params, obs, act, rew, next_obs, done) ->
    stats``: the critics' step, then the actors' on the updated critics,
    then polyak, in place."""

    def update(params, target_params, obs, act, rew, nxt, done):
        # obs/nxt [B, N, d_o], act [B, N, d_a], rew [B, N], done [B]
        B = obs.shape[0]
        with torch.no_grad():
            tgt_act = actions_of(target_params["pi"], nxt.transpose(0, 1),
                                 bound)                  # [N, B, d_a]
            tgt_joint = torch.cat(
                [nxt.reshape(B, -1),
                 tgt_act.transpose(0, 1).reshape(B, -1)], -1)
            tq = q_of(target_params["q"], tgt_joint)     # [N, B]
            target = rew.transpose(0, 1) + gamma * (1.0 - done)[None, :] \
                * tq
        joint = torch.cat([obs.reshape(B, -1), act.reshape(B, -1)], -1)
        q = q_of(params["q"], joint)                     # [N, B]
        c_loss = torch.mean((q - target) ** 2)
        step_on(q_opt, c_loss, tree_leaves(params["q"]))

        mine = actions_of(params["pi"], obs.transpose(0, 1), bound)
        joints = joint_actions(act, mine)                # [N, B, N*d_a]
        N = joints.shape[0]
        full = torch.cat([obs.reshape(B, -1)[None].expand(N, B, -1),
                          joints], -1)                   # [N, B, joint]
        a_loss = -torch.mean(q_of(params["q"], full))
        step_on(pi_opt, a_loss, tree_leaves(params["pi"]))

        polyak_(target_params, params, tau)
        return {"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach(),
                "mean_q": q.detach().mean()}

    return update


MADDPG_COLUMNS = ("obs", "act", "rew", "next_obs", "done")


class MADDPG(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        from .env import make_env

        self.cfg = config
        self.device = resolve_device(config.get("device"))
        seed = config.get("seed", 0)
        self.env = make_env(config["env_spec"], config.get("env_config"))
        if not isinstance(self.env, MultiAgentEnv):
            raise ValueError("MADDPG trains multi-agent envs; use "
                             "TD3/DDPG for single-agent control")
        self.n_agents = len(self.env.agent_ids)
        self.obs_dim = self.env.observation_dim
        self.act_dim = int(getattr(self.env, "action_dim", 1))
        self.bound = float(getattr(self.env, "action_bound", 1.0))
        hidden = config.get("hidden", (64, 64))
        self.params = trainable(maddpg_init(
            make_generator(seed), self.n_agents, self.obs_dim,
            self.act_dim, hidden), self.device)
        self.target_params = detached_copy(self.params)
        self.pi_opt = make_adam(self.params["pi"], config.get("lr", 1e-3))
        self.q_opt = make_adam(self.params["q"], config.get("lr", 1e-3))
        self._update = make_maddpg_update(
            self.pi_opt, self.q_opt, config.get("gamma", 0.95),
            config.get("tau", 0.01), self.bound)
        self.buffer = ReplayBuffer(config.get("buffer_size", 100_000))
        self.batch_size = config.get("train_batch_size", 256)
        self.sigma = config.get("exploration_sigma", 0.3)
        self.random_steps = config.get("random_steps", 500)
        self.updates_per_step = config.get("updates_per_iter", 20)
        self.rollout_steps = config.get("rollout_fragment_length", 200)
        self._rng = np.random.default_rng(seed)
        self._obs = self.env.reset(seed=seed)
        self._ep_reward = 0.0
        self._ep_len = 0
        self.episode_rewards: list = []
        self._steps_sampled = 0
        self._timesteps_total = 0  # algorithm.step's progress counter
        self._updates_done = 0
        self.workers = None        # local rollouts only (base contract)
        self.local_worker = None

    @property
    def opt_states(self):
        """The two optimizers (actors, critics), in the JAX learner's
        order."""
        return (self.pi_opt, self.q_opt)

    # ------------------------------------------------------------ rollouts
    def _act(self, obs_dict, explore: bool = True) -> Dict[str, np.ndarray]:
        obs_nb = torch.as_tensor(
            np.stack([obs_dict[a] for a in self.env.agent_ids])[:, None],
            device=self.device)
        with torch.no_grad():
            acts = actions_of(self.params["pi"], obs_nb,
                              self.bound)[:, 0].cpu().numpy()  # [N, d_a]
        if explore:
            if self._steps_sampled < self.random_steps:
                acts = self._rng.uniform(
                    -self.bound, self.bound, acts.shape).astype(np.float32)
            else:
                acts = np.clip(
                    acts + self.sigma * self._rng.standard_normal(
                        acts.shape).astype(np.float32),
                    -self.bound, self.bound)
        return {aid: acts[i] for i, aid in enumerate(self.env.agent_ids)}

    def _rollout(self, num_steps: int) -> None:
        ids = self.env.agent_ids
        cols = {"obs": [], "act": [], "rew": [], "next_obs": [], "done": []}
        for _ in range(num_steps):
            acts = self._act(self._obs)
            nxt, rew, terms, truncs, _ = self.env.step(acts)
            done = bool(terms.get("__all__"))
            trunc = bool(truncs.get("__all__"))
            cols["obs"].append(np.stack([self._obs[a] for a in ids]))
            cols["act"].append(np.stack(
                [np.asarray(acts[a], np.float32) for a in ids]))
            cols["rew"].append(
                np.asarray([rew[a] for a in ids], np.float32))
            cols["next_obs"].append(np.stack([nxt[a] for a in ids]))
            # truncation bootstraps (done=0), true terminals don't —
            # the same rule the single-agent collectors apply
            cols["done"].append(
                np.float32(1.0 if done and not trunc else 0.0))
            self._ep_reward += float(np.mean([rew[a] for a in ids]))
            self._ep_len += 1
            self._steps_sampled += 1
            self._timesteps_total += 1
            if done or trunc:
                self.episode_rewards.append(self._ep_reward)
                self._obs = self.env.reset(
                    seed=int(self._rng.integers(1 << 31)))
                self._ep_reward, self._ep_len = 0.0, 0
            else:
                self._obs = nxt
        self.buffer.add_batch({k: np.stack(v) for k, v in cols.items()})

    # ------------------------------------------------------------ training
    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        self._rollout(self.rollout_steps)
        stats = {}
        if len(self.buffer) >= self.batch_size:
            for _ in range(self.updates_per_step):
                stats = self.learn_on_minibatch(
                    self.buffer.sample(self.batch_size))
        recent = self.episode_rewards[-20:]
        return {
            "episode_reward_mean": float(np.mean(recent)) if recent
            else float("nan"),
            "episodes_total": len(self.episode_rewards),
            "timesteps_total": self._steps_sampled,
            "num_updates": self._updates_done,
            **stats_to_floats(stats),
            "time_this_iter_s": time.time() - t0,
        }

    def learn_on_minibatch(self, cols: Dict[str, np.ndarray]
                           ) -> Dict[str, Any]:
        stats = self._update(
            self.params, self.target_params,
            *(torch.as_tensor(cols[k], device=self.device)
              for k in MADDPG_COLUMNS))
        self._updates_done += 1
        return stats

    def _episode_metrics(self) -> Dict[str, Any]:
        recent = self.episode_rewards[-100:]
        return {
            "episode_reward_mean": float(np.mean(recent)) if recent
            else None,
            "episode_len_mean": None,
            "episodes_total": len(self.episode_rewards),
        }

    def compute_actions(self, obs_dict) -> Dict[str, np.ndarray]:
        """Decentralized execution: actors only, no critic."""
        return self._act(obs_dict, explore=False)

    def _sync_weights(self) -> None:
        pass  # local rollouts

    def _save_extra_state(self):
        return {"params": params_to_numpy(self.params),
                "target": params_to_numpy(self.target_params),
                "steps": self._steps_sampled,
                "updates": self._updates_done}

    def _load_extra_state(self, state) -> None:
        if not state:
            return
        copy_into(self.params, state["params"])
        copy_into(self.target_params, state["target"])
        # the optimizers start afresh, as the JAX learner's do on restore
        for opt in self.opt_states:
            opt.state.clear()
        self._steps_sampled = state.get("steps", 0)
        self._updates_done = state.get("updates", 0)


class MADDPGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(MADDPG)
        self.extra.update({
            "tau": 0.01, "exploration_sigma": 0.3, "random_steps": 500,
            "updates_per_iter": 20, "buffer_size": 100_000,
            "rollout_fragment_length": 200,
        })

    def training(self, *, tau=None, exploration_sigma=None,
                 random_steps=None, updates_per_iter=None,
                 buffer_size=None, **kwargs) -> "MADDPGConfig":
        super().training(**kwargs)
        for k, v in (("tau", tau),
                     ("exploration_sigma", exploration_sigma),
                     ("random_steps", random_steps),
                     ("updates_per_iter", updates_per_iter),
                     ("buffer_size", buffer_size)):
            if v is not None:
                self.extra[k] = v
        return self
