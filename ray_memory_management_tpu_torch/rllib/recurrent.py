"""Recurrent (LSTM) policies with truncated-BPTT PPO.

The reference's ``use_lstm`` model option (rllib/models/catalog.py wraps
any model in an LSTM; rllib/policy/rnn_sequencing.py chops batches into
max_seq_len sequences with per-sequence initial states and pads them;
appo/ppo train over those sequences). Here the recurrent path is its own
compact stack:

- one LSTM cell between an embedding MLP and the policy/value heads
  (lstm_ac_* in this module);
- the rollout worker carries (h, c) across env steps, RESETS it at
  episode boundaries, and records the state at each fragment's start —
  so a fragment plus its initial state replays exactly;
- the learner treats each fragment as one sequence: a loop over time
  re-resets the state at recorded done flags (identical to how the
  rollout ran), batched over the sequences, so fragments ARE the
  reference's max_seq_len sequences without any re-chopping or padding
  (every fragment has the same length by construction). The embedding,
  the cell's input projection and the heads run once over all steps;
  only the recurrent half of the cell runs per step (on the card, a few
  small kernels per step);
- PPO's clipped surrogate applies to the flattened [N*T] outputs, and
  minibatches are drawn as SUBSETS OF SEQUENCES (never scattered
  timesteps, which would sever the recurrence being trained).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import api
from ..utils.device import resolve_device
from . import sample_batch as sb
from .algorithm import AlgorithmConfig
from .env import make_env
from .models import (
    apply_update, entropy_of, logp_of, make_adam, make_generator, mlp_apply,
    mlp_init, normalize, params_from_numpy, params_to_numpy,
)
from .ppo import PPO, epoch_indices, stats_to_floats
from .rollout_worker import WorkerSet, pin_rollout_threads

H0 = "lstm_h0"
C0 = "lstm_c0"


# ------------------------------------------------------------------ model
def lstm_ac_init(generator: torch.Generator, obs_dim: int,
                 num_actions: int, embed_dim: int = 64,
                 lstm_dim: int = 64) -> Dict[str, Any]:
    scale = float(1.0 / np.sqrt(embed_dim + lstm_dim))
    embed = mlp_init(generator, [obs_dim, embed_dim])
    w = torch.randn(embed_dim + lstm_dim, 4 * lstm_dim,
                    generator=generator) * scale
    b = torch.zeros(4 * lstm_dim)
    # forget-gate bias starts at +1 (standard trick: remember by default
    # early in training)
    b[lstm_dim:2 * lstm_dim] = 1.0
    return {
        "embed": embed,
        "lstm": {"w": w, "b": b},
        "pi": mlp_init(generator, [lstm_dim, num_actions]),
        "vf": mlp_init(generator, [lstm_dim, 1]),
    }


def lstm_zero_state(lstm_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    z = np.zeros(lstm_dim, np.float32)
    return z.copy(), z.copy()


def _gates(z, c):
    """The cell's update from its pre-activations z [..., 4H] (gate order
    [i, f, g, o])."""
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def _cell(params, x, h, c):
    """Standard LSTM cell; gate order [i, f, g, o]."""
    z = torch.cat([x, h], dim=-1) @ params["w"] + params["b"]
    return _gates(z, c)


def lstm_ac_step(params, obs, h, c):
    """One step: obs [D] (or [B, D]) -> (logits, value, h', c')."""
    x = torch.tanh(mlp_apply(params["embed"], obs))
    h, c = _cell(params["lstm"], x, h, c)
    logits = mlp_apply(params["pi"], h)
    value = mlp_apply(params["vf"], h)[..., 0]
    return logits, value, h, c


def lstm_ac_seq(params, obs_seq, dones, h0, c0):
    """Unroll over sequences obs [..., T, D] with dones [..., T] and
    initial states [..., H]; the state RESETS after any step flagged
    done, replaying exactly what the rollout worker did. Returns (logits
    [..., T, A], values [..., T]).

    The embedding and the input half of the cell's product run once for
    all steps; the loop carries only ``h @ w_h``: the same sums as
    ``_cell``'s ``[x, h] @ w`` split in two."""
    lstm = params["lstm"]
    embed_dim = lstm["w"].shape[0] - h0.shape[-1]
    x = torch.tanh(mlp_apply(params["embed"], obs_seq))
    zx = x @ lstm["w"][:embed_dim] + lstm["b"]           # [..., T, 4H]
    w_h = lstm["w"][embed_dim:]
    keep = 1.0 - dones
    h, c = h0, c0
    hs = []
    for t in range(obs_seq.shape[-2]):
        h, c = _gates(zx[..., t, :] + h @ w_h, c)
        hs.append(h)
        mask = keep[..., t, None]
        h, c = h * mask, c * mask
    hs = torch.stack(hs, dim=-2)                         # [..., T, H]
    logits = mlp_apply(params["pi"], hs)
    values = mlp_apply(params["vf"], hs)[..., 0]
    return logits, values


# ---------------------------------------------------------------- rollout
class RecurrentRolloutWorker:
    """RolloutWorker with an LSTM policy: carries (h, c) across steps,
    resets at episode ends, and records each fragment's initial state so
    the learner can replay the recurrence (rnn_sequencing.py's
    state_in columns)."""

    def __init__(self, env_spec, env_config: Optional[dict],
                 hidden, seed: int, gamma: float = 0.99,
                 lam: float = 0.95, connectors=None,
                 embed_dim: int = 64, lstm_dim: int = 64):
        if connectors:
            raise ValueError(
                "connectors are not supported with recurrent policies yet")
        pin_rollout_threads()
        del hidden  # recurrent net is embed->lstm->heads, not an MLP stack
        self.env = make_env(env_spec, env_config)
        self.gamma = gamma
        self.lam = lam
        self.obs_dim = self.env.observation_dim
        self.lstm_dim = lstm_dim
        self.rng = np.random.default_rng(seed)
        self._gen = make_generator(seed)
        self.params = lstm_ac_init(
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

    def get_weights(self):
        return params_to_numpy(self.params)

    @torch.no_grad()
    def _policy_step(self, obs, h, c):
        """-> (action, logp, value, h', c'): a categorical draw from the
        step's policy; the state stays a numpy pair between steps."""
        logits, value, h, c = lstm_ac_step(
            self.params, torch.from_numpy(np.asarray(obs, np.float32)),
            torch.from_numpy(np.asarray(h)), torch.from_numpy(np.asarray(c)))
        logp_all = torch.log_softmax(logits, dim=-1)
        action = int(torch.multinomial(torch.exp(logp_all), 1,
                                       generator=self._gen)[0])
        return (action, float(logp_all[action]), float(value), h.numpy(),
                c.numpy())

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        obs_buf = np.zeros((num_steps, self.obs_dim), np.float32)
        act_buf = np.zeros(num_steps, np.int32)
        rew_buf = np.zeros(num_steps, np.float32)
        done_buf = np.zeros(num_steps, np.float32)
        logp_buf = np.zeros(num_steps, np.float32)
        val_buf = np.zeros(num_steps, np.float32)
        h0, c0 = np.asarray(self._h), np.asarray(self._c)

        for t in range(num_steps):
            a, logp_buf[t], val_buf[t], h, c = self._policy_step(
                self._obs, self._h, self._c)
            obs_buf[t] = self._obs
            act_buf[t] = a
            next_obs, reward, terminated, truncated, _ = self.env.step(a)
            rew_buf[t] = reward
            done_buf[t] = float(terminated)
            self._episode_reward += reward
            self._episode_len += 1
            self._h, self._c = h, c
            if truncated and not terminated:
                # the single-agent truncation rule: fold V(s_next) into
                # the reward (evaluated with the CURRENT memory) and cut
                v_next = self._policy_step(next_obs, self._h, self._c)[2]
                rew_buf[t] += self.gamma * v_next
                done_buf[t] = 1.0
            if terminated or truncated:
                self.episode_rewards.append(self._episode_reward)
                self.episode_lengths.append(self._episode_len)
                self._episode_reward = 0.0
                self._episode_len = 0
                next_obs = self.env.reset(
                    seed=int(self.rng.integers(1 << 31)))
                self._h, self._c = lstm_zero_state(self.lstm_dim)
            self._obs = next_obs

        bootstrap = self._policy_step(self._obs, self._h, self._c)[2]
        adv, targets = sb.compute_gae(
            rew_buf, val_buf, done_buf, bootstrap,
            gamma=self.gamma, lam=self.lam)
        return {
            sb.OBS: obs_buf, sb.ACTIONS: act_buf, sb.REWARDS: rew_buf,
            sb.DONES: done_buf, sb.LOGP: logp_buf, sb.VALUES: val_buf,
            sb.ADVANTAGES: adv, sb.TARGETS: targets,
            sb.BOOTSTRAP: np.array([bootstrap], np.float32),
            H0: h0[None, :], C0: c0[None, :],  # [1, lstm_dim] per fragment
        }

    def get_connector_state(self):
        return None

    def set_connector_state(self, state) -> None:
        pass

    def episode_stats(self, window: int = 100) -> Dict[str, Any]:
        return sb.episode_stats_summary(
            self.episode_rewards, self.episode_lengths, window)


# ---------------------------------------------------------------- learner
def make_recurrent_ppo_update(optimizer: torch.optim.Optimizer,
                              clip_param: float, vf_coeff: float,
                              entropy_coeff: float):
    """``update(params, obs, actions, old_logp, advantages, targets, dones,
    h0, c0) -> stats`` over a minibatch of sequences (obs [N, T, D]): one
    Adam step in place."""

    def update(params, obs, actions, old_logp, advantages, targets, dones,
               h0, c0):
        # unroll each sequence with its recorded initial state, resetting
        # at done flags exactly as collection did
        logits, values = lstm_ac_seq(params, obs, dones, h0, c0)
        logp, logp_all = logp_of(logits, actions)         # [N, T]
        ratio = torch.exp(logp - old_logp)
        adv = normalize(advantages)
        surrogate = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv)
        pg_loss = -surrogate.mean()
        vf_loss = torch.square(values - targets).mean()
        entropy = entropy_of(logp_all)
        total = pg_loss + vf_coeff * vf_loss - entropy_coeff * entropy
        apply_update(optimizer, total)
        return {"policy_loss": pg_loss.detach(), "vf_loss": vf_loss.detach(),
                "entropy": entropy.detach(),
                "kl": (old_logp - logp).mean().detach(),
                "total_loss": total.detach()}

    return update


SEQ_COLUMNS = (sb.OBS, sb.ACTIONS, sb.LOGP, sb.ADVANTAGES, sb.TARGETS,
               sb.DONES)


class RecurrentPPO(PPO):
    """PPO over LSTM policies: fragments are the training sequences.

    Inherits PPO's config surface; overrides the model (lstm_ac), the
    rollout workers (RecurrentRolloutWorker), and the SGD loop (sequence
    minibatches through the unrolled update)."""

    def setup(self, config: Dict[str, Any]) -> None:
        if config.get("connectors"):
            raise ValueError(
                "connectors are not supported with recurrent policies yet")
        self.cfg = config
        self.device = resolve_device(config.get("device"))
        seed = config.get("seed", 0)
        self.np_rng = np.random.default_rng(seed)
        probe_env = make_env(config["env_spec"], config.get("env_config"))
        self.obs_dim = probe_env.observation_dim
        self.num_actions = probe_env.num_actions
        embed_dim = config.get("embed_dim", 64)
        self.lstm_dim = config.get("lstm_dim", 64)
        self.params = self._to_learner(lstm_ac_init(
            make_generator(seed), self.obs_dim, self.num_actions,
            embed_dim, self.lstm_dim))
        self._connector_specs = None
        gamma = config.get("gamma", 0.99)
        lam = config.get("lambda_", 0.95)
        self.workers = None
        self.local_worker = None
        worker_args = dict(embed_dim=embed_dim, lstm_dim=self.lstm_dim)
        if config.get("num_rollout_workers", 0) > 0:
            self.workers = WorkerSet(
                config["env_spec"], config.get("env_config"), None,
                config["num_rollout_workers"], seed, gamma, lam,
                connectors=None, worker_cls=RecurrentRolloutWorker,
                worker_kwargs=worker_args)
        else:
            self.local_worker = RecurrentRolloutWorker(
                config["env_spec"], config.get("env_config"), None, seed,
                gamma, lam, None, **worker_args)
        self._timesteps_total = 0

        self.clip_param = config.get("clip_param", 0.2)
        self.vf_coeff = config.get("vf_loss_coeff", 0.5)
        self.entropy_coeff = config.get("entropy_coeff", 0.01)
        self.num_sgd_iter = config.get("num_sgd_iter", 6)
        # minibatches are SEQUENCES per epoch, not timesteps
        self.sgd_minibatch_seqs = config.get("sgd_minibatch_seqs", 8)
        self.optimizer = make_adam(self.params, config.get("lr", 5e-4))
        self._update = make_recurrent_ppo_update(
            self.optimizer, self.clip_param, self.vf_coeff,
            self.entropy_coeff)

    def sample_fragments(self) -> List[Dict[str, np.ndarray]]:
        """Broadcast the weights and gather whole fragments (the training
        sequences) until they hold ``train_batch_size`` steps."""
        fragment = self.cfg.get("rollout_fragment_length", 200)
        target = self.cfg.get("train_batch_size", 4000)
        batches: List[Dict[str, np.ndarray]] = []
        if self.workers is not None:
            self._sync_weights()
            while sum(len(b[sb.ACTIONS]) for b in batches) < target:
                batches.extend(api.get(self.workers.sample(fragment)))
        else:
            self.local_worker.set_weights(self.get_weights())
            while sum(len(b[sb.ACTIONS]) for b in batches) < target:
                batches.append(self.local_worker.sample(fragment))
        return batches

    def learn_on_sequences(self, batches: List[Dict[str, np.ndarray]]
                           ) -> Dict[str, Any]:
        """Stack fragments into [N, T, ...] sequences on the learner's
        device and run the sequence-minibatch epochs."""
        seq = {k: torch.as_tensor(np.stack([b[k] for b in batches]),
                                  device=self.device)
               for k in SEQ_COLUMNS}
        h0 = torch.as_tensor(np.concatenate([b[H0] for b in batches]),
                             device=self.device)
        c0 = torch.as_tensor(np.concatenate([b[C0] for b in batches]),
                             device=self.device)
        N = len(batches)
        stats: Dict[str, Any] = {}
        mb = min(self.sgd_minibatch_seqs, N)
        for _epoch in range(self.num_sgd_iter):
            # sb.minibatch_indices drops the ragged tail, matching PPO
            for idx in epoch_indices(N, mb, self.np_rng, self.device):
                stats = self._update(
                    self.params, *(seq[k][idx] for k in SEQ_COLUMNS),
                    h0[idx], c0[idx])
        return stats

    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        batches = self.sample_fragments()
        n = sum(len(b[sb.ACTIONS]) for b in batches)
        self._timesteps_total += n
        sample_time = time.time() - t0

        t1 = time.time()
        out = stats_to_floats(self.learn_on_sequences(batches))
        learn_time = time.time() - t1
        out.update({
            "num_env_steps_sampled": n,
            "num_sequences": len(batches),
            "sample_time_s": sample_time,
            "learn_time_s": learn_time,
        })
        return out

    def compute_single_action(self, obs: np.ndarray,
                              state: Optional[tuple] = None):
        """Recurrent inference: returns (action, new_state); pass the
        state back on the next call (None = episode start)."""
        if state is None:
            state = lstm_zero_state(self.lstm_dim)
        h, c = (torch.as_tensor(np.asarray(v, np.float32),
                                device=self.device) for v in state)
        with torch.no_grad():
            logits, _, h, c = lstm_ac_step(
                self.params, torch.as_tensor(np.asarray(obs, np.float32),
                                             device=self.device), h, c)
        action = int(torch.argmax(logits))
        return action, (h.cpu().numpy(), c.cpu().numpy())


class RecurrentPPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(RecurrentPPO)
        self.extra.update({"clip_param": 0.2, "vf_loss_coeff": 0.5,
                           "entropy_coeff": 0.01, "num_sgd_iter": 6,
                           "sgd_minibatch_seqs": 8, "embed_dim": 64,
                           "lstm_dim": 64})

    def training(self, *, clip_param=None, vf_loss_coeff=None,
                 entropy_coeff=None, num_sgd_iter=None,
                 sgd_minibatch_seqs=None, embed_dim=None, lstm_dim=None,
                 **kwargs) -> "RecurrentPPOConfig":
        super().training(**kwargs)
        for k, v in (("clip_param", clip_param),
                     ("vf_loss_coeff", vf_loss_coeff),
                     ("entropy_coeff", entropy_coeff),
                     ("num_sgd_iter", num_sgd_iter),
                     ("sgd_minibatch_seqs", sgd_minibatch_seqs),
                     ("embed_dim", embed_dim), ("lstm_dim", lstm_dim)):
            if v is not None:
                self.extra[k] = v
        return self
