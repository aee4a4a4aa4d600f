"""R2D2: recurrent replay distributed DQN.

The reference's R2D2 (rllib/algorithms/r2d2/r2d2.py — DQN over LSTM
models with sequence replay; r2d2_tf_policy.py:113 the burn-in: the
first ``burn_in`` steps of each stored sequence warm the recurrent state
WITHOUT gradient before the TD loss applies to the remainder; stored
initial states per sequence per Kapturowski et al. 2019). Composition
here: the LSTM trunk is recurrent.py's (one cell between an embedding
and a Q head), sequences are fixed-length fragments with their initial
(h, c) recorded at collection, and the whole update — burn-in unroll,
online/target unrolls, double-Q TD over the post-burn-in tail, Adam —
runs on the learner's device as ONE batched LSTM over the [B, T]
sequence batch (a loop over time; the embedding, the cell's input
projection and the Q head run once over all steps).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import api
from ..utils.device import resolve_device
from . import sample_batch as sb
from .algorithm import Algorithm, AlgorithmConfig
from .dqn import huber_loss
from .env import make_env
from .models import (
    adam_state_to_cpu, apply_update, copy_into, detached_copy,
    load_adam_state, make_adam, make_generator, mlp_apply, mlp_init,
    params_from_numpy, params_to_numpy, trainable,
)
from .ppo import stats_to_floats
from .recurrent import _cell, lstm_unroll, lstm_zero_state
from .rollout_worker import WorkerSet, pin_rollout_threads

H0 = "lstm_h0"
C0 = "lstm_c0"
NEXT_OBS_LAST = "next_obs_last"  # successor of each sequence's last step


def lstm_q_init(generator: torch.Generator, obs_dim: int, num_actions: int,
                embed_dim: int = 64, lstm_dim: int = 64) -> Dict[str, Any]:
    scale = float(1.0 / np.sqrt(embed_dim + lstm_dim))
    embed = mlp_init(generator, [obs_dim, embed_dim])
    w = torch.randn(embed_dim + lstm_dim, 4 * lstm_dim,
                    generator=generator) * scale
    b = torch.zeros(4 * lstm_dim)
    b[lstm_dim:2 * lstm_dim] = 1.0
    return {
        "embed": embed,
        "lstm": {"w": w, "b": b},
        "q": mlp_init(generator, [lstm_dim, num_actions]),
    }


def lstm_q_step(params, obs, h, c):
    x = torch.tanh(mlp_apply(params["embed"], obs))
    h, c = _cell(params["lstm"], x, h, c)
    return mlp_apply(params["q"], h), h, c


def lstm_q_seq(params, obs_seq, dones, h0, c0):
    """Q-values along sequences obs [..., T, D], resetting the state after
    done steps (matching collection). Returns (q [..., T, A], (hT, cT))
    with the final state after its reset mask, as the JAX scan's carry."""
    hs, state = lstm_unroll(params, obs_seq, dones, h0, c0)
    return mlp_apply(params["q"], hs), state


class SequenceReplayBuffer:
    """Ring buffer of fixed-length sequences (obs/actions/rewards/dones
    plus the recorded initial LSTM state and each sequence's final
    successor observation) — the reference's replay of length-m
    sequences with stored states (r2d2.py's zero_init_states=False
    path)."""

    def __init__(self, capacity_seqs: int, seed: int = 0):
        self.capacity = capacity_seqs
        self._data: List[Dict[str, np.ndarray]] = []
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def add(self, seq: Dict[str, np.ndarray]) -> None:
        if len(self._data) < self.capacity:
            self._data.append(seq)
        else:
            self._data[self._next] = seq
        self._next = (self._next + 1) % self.capacity

    def sample(self, n: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, len(self._data), size=n)
        return {
            k: np.stack([self._data[i][k] for i in idx])
            for k in self._data[0]
        }

    def __len__(self) -> int:
        return len(self._data)


class R2D2RolloutWorker:
    """Epsilon-greedy collector over the recurrent Q-network: carries
    (h, c) across steps, resets at episode ends, and emits fixed-length
    sequences with their initial state and final successor."""

    def __init__(self, env_spec, env_config: Optional[dict],
                 hidden, seed: int, gamma: float = 0.99,
                 lam: float = 0.95, connectors=None,
                 embed_dim: int = 64, lstm_dim: int = 64):
        if connectors:
            raise ValueError(
                "connectors are not supported with recurrent policies yet")
        del hidden, gamma, lam  # WorkerSet calling convention; unused here
        pin_rollout_threads()
        self.env = make_env(env_spec, env_config)
        self.obs_dim = self.env.observation_dim
        self.lstm_dim = lstm_dim
        self.rng = np.random.default_rng(seed)
        self.params = lstm_q_init(
            make_generator(0), self.obs_dim, self.env.num_actions,
            embed_dim, lstm_dim)
        self._obs = self.env.reset(seed=seed)
        self._h, self._c = lstm_zero_state(lstm_dim)
        self._episode_reward = 0.0
        self._episode_len = 0
        self.episode_rewards: List[float] = []
        self.episode_lengths: List[int] = []

    def ready(self) -> str:
        return "ok"

    def set_weights(self, weights) -> None:
        self.params = params_from_numpy(weights)

    @torch.no_grad()
    def _q_step(self, obs, h, c):
        q, h, c = lstm_q_step(
            self.params, torch.from_numpy(np.asarray(obs, np.float32)),
            torch.from_numpy(np.asarray(h)), torch.from_numpy(np.asarray(c)))
        return q.numpy(), h.numpy(), c.numpy()

    def sample(self, seq_len: int, epsilon: float) -> Dict[str, np.ndarray]:
        obs_buf = np.zeros((seq_len, self.obs_dim), np.float32)
        act_buf = np.zeros(seq_len, np.int32)
        rew_buf = np.zeros(seq_len, np.float32)
        done_buf = np.zeros(seq_len, np.float32)  # episode boundary
        h0, c0 = np.asarray(self._h), np.asarray(self._c)

        for t in range(seq_len):
            q, h, c = self._q_step(self._obs, self._h, self._c)
            if self.rng.random() < epsilon:
                a = int(self.rng.integers(self.env.num_actions))
            else:
                a = int(q.argmax())
            obs_buf[t] = self._obs
            act_buf[t] = a
            next_obs, reward, terminated, truncated, _ = self.env.step(a)
            rew_buf[t] = reward
            done_buf[t] = float(terminated or truncated)
            self._episode_reward += reward
            self._episode_len += 1
            self._h, self._c = h, c
            if terminated or truncated:
                self.episode_rewards.append(self._episode_reward)
                self.episode_lengths.append(self._episode_len)
                self._episode_reward = 0.0
                self._episode_len = 0
                next_obs = self.env.reset(
                    seed=int(self.rng.integers(1 << 31)))
                self._h, self._c = lstm_zero_state(self.lstm_dim)
            self._obs = next_obs
        return {
            sb.OBS: obs_buf, sb.ACTIONS: act_buf, sb.REWARDS: rew_buf,
            sb.DONES: done_buf,
            H0: h0, C0: c0,
            NEXT_OBS_LAST: np.asarray(self._obs, np.float32),
        }

    def episode_stats(self, window: int = 100) -> Dict[str, Any]:
        return sb.episode_stats_summary(
            self.episode_rewards, self.episode_lengths, window)


R2D2_COLUMNS = (sb.OBS, sb.ACTIONS, sb.REWARDS, sb.DONES, H0, C0,
                NEXT_OBS_LAST)


def make_r2d2_update(optimizer, gamma: float, burn_in: int):
    """``update(params, target_params, obs, actions, rewards, dones, h0,
    c0, next_last) -> stats`` over a batch of sequences (obs [B, T, D],
    h0/c0 [B, H], next_last [B, D]): one Adam step in place."""

    def update(params, target_params, obs, actions, rewards, dones, h0, c0,
               next_last):
        # burn-in: warm the state with NO gradient (the stored h0 is
        # stale relative to current params; r2d2_tf_policy.py:113). The
        # ONLINE tail warms through the online net; the TARGET tail warms
        # through the TARGET net — otherwise every Adam step would shift
        # the target's recurrent state and the TD target would move
        # between target syncs.
        if burn_in > 0:
            with torch.no_grad():
                _, (bh, bc) = lstm_q_seq(params, obs[:, :burn_in],
                                         dones[:, :burn_in], h0, c0)
                _, (tbh, tbc) = lstm_q_seq(target_params, obs[:, :burn_in],
                                           dones[:, :burn_in], h0, c0)
            obs_t, dones_t = obs[:, burn_in:], dones[:, burn_in:]
        else:
            bh, bc, tbh, tbc = h0, c0, h0, c0
            obs_t, dones_t = obs, dones
        q_online, (hT, cT) = lstm_q_seq(params, obs_t, dones_t, bh, bc)
        with torch.no_grad():
            q_target, (tT, tC) = lstm_q_seq(target_params, obs_t, dones_t,
                                            tbh, tbc)
            # successor Q-values: shift by one inside the tail, with the
            # recorded final successor evaluated from the final states
            q_next_last_online, _, _ = lstm_q_step(params, next_last,
                                                   hT, cT)
            q_next_last_target, _, _ = lstm_q_step(target_params,
                                                   next_last, tT, tC)
            next_online = torch.cat(
                [q_online[:, 1:], q_next_last_online[:, None]], dim=1)
            next_target = torch.cat(
                [q_target[:, 1:], q_next_last_target[:, None]], dim=1)
            # bootstrap mask: EVERY episode boundary — the shifted
            # successor after a boundary is the NEXT episode's first
            # state under a reset LSTM, which must never leak into this
            # episode's target (true terminals exact; truncations
            # under-bootstrap, the classic DQN bias)
            next_a = torch.argmax(next_online, dim=-1)
            next_q = torch.gather(next_target, -1, next_a[..., None])[..., 0]
            target = rewards[:, burn_in:] + gamma * (1.0 - dones_t) * next_q
        q_taken = torch.gather(q_online, -1,
                               actions[:, burn_in:].long()[..., None])[..., 0]
        loss = huber_loss(q_taken, target).mean()
        apply_update(optimizer, loss)
        return {"td_loss": loss.detach(), "mean_q": q_taken.detach().mean()}

    return update


class R2D2(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        self.cfg = config
        self.device = resolve_device(config.get("device"))
        if config.get("connectors"):
            raise ValueError(
                "connectors are not supported with recurrent policies yet")
        seed = config.get("seed", 0)
        probe_env = make_env(config["env_spec"], config.get("env_config"))
        embed_dim = config.get("embed_dim", 64)
        self.lstm_dim = config.get("lstm_dim", 64)
        self.params = trainable(lstm_q_init(
            make_generator(seed), probe_env.observation_dim,
            probe_env.num_actions, embed_dim, self.lstm_dim), self.device)
        self.target_params = detached_copy(self.params)
        self.optimizer = make_adam(self.params, config.get("lr", 1e-3))
        self.seq_len = config.get("seq_len", 20)
        self.burn_in = config.get("burn_in", 4)
        if self.burn_in >= self.seq_len:
            raise ValueError("burn_in must be < seq_len")
        self._update = make_r2d2_update(
            self.optimizer, config.get("gamma", 0.99), self.burn_in)
        self.replay = SequenceReplayBuffer(
            config.get("replay_capacity_seqs", 2000), seed=seed)
        self.learning_starts_seqs = config.get("learning_starts_seqs", 20)
        self.seqs_per_step = config.get("seqs_per_step", 8)
        self.train_batch_seqs = config.get("train_batch_seqs", 16)
        self.updates_per_step = config.get("updates_per_step", 8)
        self.target_update_freq = config.get("target_update_freq", 100)
        # same exploration config surface as DQN (dqn.py)
        self.eps_initial = config.get("epsilon_initial", 1.0)
        self.eps_final = config.get("epsilon_final", 0.05)
        self.eps_timesteps = config.get("epsilon_timesteps", 20_000)
        self._updates_done = 0
        self._timesteps_total = 0

        n_workers = config.get("num_rollout_workers", 0)
        self.workers = None
        self.local_worker = None
        worker_kwargs = dict(embed_dim=embed_dim, lstm_dim=self.lstm_dim)
        if n_workers > 0:
            self.workers = WorkerSet(
                config["env_spec"], config.get("env_config"), None,
                n_workers, seed, worker_cls=R2D2RolloutWorker,
                worker_kwargs=worker_kwargs)
        else:
            self.local_worker = R2D2RolloutWorker(
                config["env_spec"], config.get("env_config"), None, seed,
                **worker_kwargs)

    def _epsilon(self) -> float:
        frac = min(1.0, self._timesteps_total / max(1, self.eps_timesteps))
        return self.eps_initial + frac * (self.eps_final
                                          - self.eps_initial)

    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        eps = self._epsilon()
        seqs: List[Dict[str, np.ndarray]] = []
        if self.workers is not None:
            ws = self.workers.remote_workers
            self.workers.set_weights(self.get_weights())
            while len(seqs) < self.seqs_per_step:
                seqs.extend(api.get([
                    w.sample.remote(self.seq_len, eps) for w in ws]))
        else:
            self.local_worker.set_weights(self.get_weights())
            while len(seqs) < self.seqs_per_step:
                seqs.append(self.local_worker.sample(self.seq_len, eps))
        for s in seqs:
            self.replay.add(s)
            self._timesteps_total += self.seq_len
        sample_time = time.time() - t0

        stats: Dict[str, Any] = {}
        t1 = time.time()
        if len(self.replay) >= self.learning_starts_seqs:
            for _ in range(self.updates_per_step):
                stats = self.learn_on_minibatch(
                    self.replay.sample(self.train_batch_seqs))
        out = stats_to_floats(stats)
        learn_time = time.time() - t1
        out.update({
            "num_env_steps_sampled": len(seqs) * self.seq_len,
            "replay_seqs": len(self.replay),
            "num_updates": self._updates_done,
            "epsilon": eps,
            "sample_time_s": sample_time,
            "learn_time_s": learn_time,
        })
        return out

    def learn_on_minibatch(self, mb: Dict[str, np.ndarray]
                           ) -> Dict[str, Any]:
        """One TD update over a batch of sequences, then the target sync
        every ``target_update_freq`` updates."""
        stats = self._update(
            self.params, self.target_params,
            *(torch.as_tensor(mb[k], device=self.device)
              for k in R2D2_COLUMNS))
        self._updates_done += 1
        if self._updates_done % self.target_update_freq == 0:
            copy_into(self.target_params, self.params)
        return stats

    def compute_single_action(self, obs: np.ndarray,
                              state: Optional[tuple] = None):
        if state is None:
            state = lstm_zero_state(self.lstm_dim)
        h, c = (torch.as_tensor(np.asarray(s, np.float32),
                                device=self.device) for s in state)
        with torch.no_grad():
            q, h, c = lstm_q_step(
                self.params, torch.as_tensor(np.asarray(obs, np.float32),
                                             device=self.device), h, c)
        return int(torch.argmax(q)), (h.cpu().numpy(), c.cpu().numpy())

    def _sync_weights(self) -> None:
        pass  # weights ship inside training_step

    def _save_extra_state(self):
        return {
            "target_params": params_to_numpy(self.target_params),
            "opt_state": adam_state_to_cpu(self.optimizer),
            "updates_done": self._updates_done,
            "timesteps": self._timesteps_total,
        }

    def _load_extra_state(self, state) -> None:
        if not state:
            return
        if "target_params" in state:
            copy_into(self.target_params, state["target_params"])
        if "opt_state" in state:
            load_adam_state(self.optimizer, state["opt_state"])
        self._updates_done = state.get("updates_done", 0)
        self._timesteps_total = state.get("timesteps", 0)


class R2D2Config(AlgorithmConfig):
    def __init__(self):
        super().__init__(R2D2)
        self.num_rollout_workers = 0
        self.extra.update({
            "seq_len": 20, "burn_in": 4, "replay_capacity_seqs": 2000,
            "learning_starts_seqs": 20, "seqs_per_step": 8,
            "train_batch_seqs": 16, "updates_per_step": 8,
            "target_update_freq": 100, "embed_dim": 64, "lstm_dim": 64,
            "epsilon_initial": 1.0, "epsilon_final": 0.05,
            "epsilon_timesteps": 20_000,
        })

    def training(self, *, seq_len=None, burn_in=None,
                 replay_capacity_seqs=None, learning_starts_seqs=None,
                 seqs_per_step=None, train_batch_seqs=None,
                 updates_per_step=None, target_update_freq=None,
                 embed_dim=None, lstm_dim=None, epsilon_initial=None,
                 epsilon_final=None, epsilon_timesteps=None,
                 **kwargs) -> "R2D2Config":
        super().training(**kwargs)
        for k, v in (
                ("seq_len", seq_len), ("burn_in", burn_in),
                ("replay_capacity_seqs", replay_capacity_seqs),
                ("learning_starts_seqs", learning_starts_seqs),
                ("seqs_per_step", seqs_per_step),
                ("train_batch_seqs", train_batch_seqs),
                ("updates_per_step", updates_per_step),
                ("target_update_freq", target_update_freq),
                ("embed_dim", embed_dim), ("lstm_dim", lstm_dim),
                ("epsilon_initial", epsilon_initial),
                ("epsilon_final", epsilon_final),
                ("epsilon_timesteps", epsilon_timesteps)):
            if v is not None:
                self.extra[k] = v
        return self
