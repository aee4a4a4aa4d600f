"""PPO: clipped-surrogate policy optimization with a torch learner.

The reference's PPO (rllib/algorithms/ppo/ppo.py:289,401): synchronous
sampling from rollout workers, GAE postprocessing (done worker-side here),
then ``num_sgd_iter`` epochs of minibatch SGD on the learner's device
(the card unless the config says ``device="cpu"``); rollouts stay on CPU
actors. The batch crosses to the device once per training step and each
epoch's minibatch indices once per epoch; a minibatch step (forward,
backward, Adam) never waits on the host.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from .. import api
from . import sample_batch as sb
from .algorithm import Algorithm, AlgorithmConfig
from .models import (
    ac_apply, adam_state_to_cpu, apply_update, entropy_of, load_adam_state,
    logp_of, make_adam, normalize,
)


def make_ppo_update(optimizer: torch.optim.Optimizer, clip_param: float,
                    vf_coeff: float, entropy_coeff: float,
                    donate: bool = False):
    """Build the minibatch update ``update(params, obs, actions, old_logp,
    advantages, targets) -> stats``: one Adam step of ``optimizer``, which
    must hold ``params``' leaves, in place.

    ``donate`` is the JAX learner's buffer donation; a torch optimizer
    always updates in place, so both settings give the same step.
    """
    del donate

    def update(params, obs, actions, old_logp, advantages, targets):
        logits, values = ac_apply(params, obs)
        logp, logp_all = logp_of(logits, actions)
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
        return {
            "policy_loss": pg_loss.detach(), "vf_loss": vf_loss.detach(),
            "entropy": entropy.detach(),
            "kl": (old_logp - logp).mean().detach(),
            "total_loss": total.detach(),
        }

    return update


def to_device(batch: Dict[str, np.ndarray], keys, device) -> Dict[str, Any]:
    """The named columns of a numpy batch as tensors on ``device`` (owned
    copies: a batch from the object store is read-only)."""
    return {k: torch.tensor(batch[k], device=device) for k in keys}


def epoch_indices(n: int, mb: int, rng: np.random.Generator, device):
    """One epoch's minibatch indices (``sb.minibatch_indices``' order) as
    one [M, mb] tensor on ``device``: a single copy per epoch."""
    idx = list(sb.minibatch_indices(n, mb, rng))
    return torch.as_tensor(np.stack(idx), device=device)


def stats_to_floats(stats: Dict[str, Any]) -> Dict[str, float]:
    return {k: float(v) for k, v in stats.items()}


PPO_COLUMNS = (sb.OBS, sb.ACTIONS, sb.LOGP, sb.ADVANTAGES, sb.TARGETS)


class PPO(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        self.clip_param = config.get("clip_param", 0.2)
        self.vf_coeff = config.get("vf_loss_coeff", 0.5)
        self.entropy_coeff = config.get("entropy_coeff", 0.01)
        self.num_sgd_iter = config.get("num_sgd_iter", 6)
        self.sgd_minibatch_size = config.get("sgd_minibatch_size", 128)
        self.optimizer = make_adam(self.params, config.get("lr", 5e-4))
        self._update = make_ppo_update(
            self.optimizer, self.clip_param, self.vf_coeff,
            self.entropy_coeff,
            donate=config.get("donate_learner_state", False))

    def sample_batch(self) -> Dict[str, np.ndarray]:
        """Broadcast the current weights and sample synchronously until
        the batch holds ``train_batch_size`` steps."""
        fragment = self.cfg.get("rollout_fragment_length", 200)
        target = self.cfg.get("train_batch_size", 4000)
        batches = []
        if self.workers is not None:
            self._sync_weights()
            while sum(sb.batch_size(b) for b in batches) < target:
                refs = self.workers.sample(fragment)
                batches.extend(api.get(refs))
        else:
            self.local_worker.set_weights(self.get_weights())
            while sum(sb.batch_size(b) for b in batches) < target:
                batches.append(self.local_worker.sample(fragment))
        return sb.concat_batches(batches)

    def learn_on_batch(self, batch: Dict[str, np.ndarray]
                       ) -> Dict[str, Any]:
        """``num_sgd_iter`` epochs of minibatch SGD on the learner's
        device; returns the last minibatch's stats (device tensors)."""
        n = sb.batch_size(batch)
        cols = to_device(batch, PPO_COLUMNS, self.device)
        stats: Dict[str, Any] = {}
        mb = min(self.sgd_minibatch_size, n)
        for _epoch in range(self.num_sgd_iter):
            for i in epoch_indices(n, mb, self.np_rng, self.device):
                stats = self._update(
                    self.params, *(cols[k][i] for k in PPO_COLUMNS))
        return stats

    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        # 1. broadcast current weights, sample synchronously
        batch = self.sample_batch()
        n = sb.batch_size(batch)
        self._timesteps_total += n
        sample_time = time.time() - t0

        # 2. minibatch SGD epochs on the learner device
        t1 = time.time()
        out = stats_to_floats(self.learn_on_batch(batch))
        learn_time = time.time() - t1
        out.update({
            "num_env_steps_sampled": n,
            "sample_time_s": sample_time,
            "learn_time_s": learn_time,
            "steps_per_s": n / max(sample_time + learn_time, 1e-9),
        })
        return out

    def _save_extra_state(self):
        return {"opt_state": adam_state_to_cpu(self.optimizer)}

    def _load_extra_state(self, state) -> None:
        if state and "opt_state" in state:
            load_adam_state(self.optimizer, state["opt_state"])


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(PPO)
        self.extra.update({
            "clip_param": 0.2, "vf_loss_coeff": 0.5, "entropy_coeff": 0.01,
            "num_sgd_iter": 6, "sgd_minibatch_size": 128,
        })

    def training(self, *, clip_param=None, vf_loss_coeff=None,
                 entropy_coeff=None, num_sgd_iter=None,
                 sgd_minibatch_size=None, **kwargs) -> "PPOConfig":
        super().training(**kwargs)
        for k, v in (("clip_param", clip_param),
                     ("vf_loss_coeff", vf_loss_coeff),
                     ("entropy_coeff", entropy_coeff),
                     ("num_sgd_iter", num_sgd_iter),
                     ("sgd_minibatch_size", sgd_minibatch_size)):
            if v is not None:
                self.extra[k] = v
        return self
