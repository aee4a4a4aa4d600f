"""IMPALA: asynchronous sampling with V-trace off-policy correction.

The reference's IMPALA (rllib/algorithms/impala/impala.py:350-388 wires
async sample requests into learner threads; V-trace from the paper).
Workers sample continuously; the learner consumes fragments as they
arrive (api.wait on in-flight refs), corrects the off-policyness with
V-trace, applies one SGD step per fragment, and immediately re-arms the
worker with fresh weights — sampling and learning overlap instead of the
PPO sync barrier.
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
    ac_apply, apply_update, entropy_of, logp_of, make_adam,
)
from .ppo import stats_to_floats, to_device


@torch.no_grad()
def vtrace(target_logp, behavior_logp, rewards, values, dones,
           bootstrap_value, *, gamma: float, rho_clip: float = 1.0,
           c_clip: float = 1.0):
    """V-trace targets (Espeholt et al. 2018) via a reverse loop over the
    fragment. Returns (vs, pg_adv), both outside the autograd graph —
    shared by IMPALA's plain policy gradient and APPO's clipped surrogate
    (appo.py). ``bootstrap_value`` is a 0-d tensor on the inputs'
    device. On the card the loop launches a few small kernels per step."""
    target_logp, values = target_logp.detach(), values.detach()
    bootstrap = torch.as_tensor(bootstrap_value, dtype=values.dtype,
                                device=values.device).reshape(1)
    rho = torch.exp(target_logp - behavior_logp)
    clipped_rho = torch.clamp(rho, max=rho_clip)
    cs = torch.clamp(rho, max=c_clip)
    discounts = gamma * (1.0 - dones)
    next_values = torch.cat([values[1:], bootstrap])
    deltas = clipped_rho * (rewards + discounts * next_values - values)

    decay = discounts * cs
    vs_minus_v = torch.empty_like(deltas)
    acc = torch.zeros((), dtype=deltas.dtype, device=deltas.device)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + decay[t] * acc
        vs_minus_v[t] = acc
    vs = values + vs_minus_v
    next_vs = torch.cat([vs[1:], bootstrap])
    pg_adv = clipped_rho * (rewards + discounts * next_vs - values)
    return vs, pg_adv


def make_impala_update(optimizer: torch.optim.Optimizer, gamma: float,
                       vf_coeff: float, entropy_coeff: float,
                       rho_clip: float = 1.0, c_clip: float = 1.0):
    """``update(params, obs, actions, behavior_logp, rewards, dones,
    bootstrap_value) -> stats``: one Adam step in place."""

    def update(params, obs, actions, behavior_logp, rewards, dones,
               bootstrap_value):
        logits, values = ac_apply(params, obs)
        target_logp, logp_all = logp_of(logits, actions)
        vs, pg_adv = vtrace(target_logp, behavior_logp, rewards, values,
                            dones, bootstrap_value, gamma=gamma,
                            rho_clip=rho_clip, c_clip=c_clip)
        pg_loss = -(target_logp * pg_adv).mean()
        vf_loss = torch.square(values - vs).mean()
        entropy = entropy_of(logp_all)
        total = pg_loss + vf_coeff * vf_loss - entropy_coeff * entropy
        apply_update(optimizer, total)
        return {"policy_loss": pg_loss.detach(), "vf_loss": vf_loss.detach(),
                "entropy": entropy.detach(), "total_loss": total.detach()}

    return update


IMPALA_COLUMNS = (sb.OBS, sb.ACTIONS, sb.LOGP, sb.REWARDS, sb.DONES)


class IMPALA(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        if config.get("num_rollout_workers", 0) < 1:
            config = dict(config)
            config["num_rollout_workers"] = 1  # async needs remote samplers
        super().setup(config)
        self.optimizer = make_adam(self.params, config.get("lr", 5e-4))
        self._update = make_impala_update(
            self.optimizer, config.get("gamma", 0.99),
            config.get("vf_loss_coeff", 0.5),
            config.get("entropy_coeff", 0.01))
        self._inflight: Dict[Any, Any] = {}  # sample ref -> worker

    def _arm(self, worker) -> None:
        """Send fresh weights then request the next fragment."""
        worker.set_weights.remote(api.put(self.get_weights()))
        ref = worker.sample.remote(
            self.cfg.get("rollout_fragment_length", 200))
        self._inflight[ref] = worker

    def learn_on_fragment(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, Any]:
        """One update on one fragment, on the learner's device."""
        cols = to_device(batch, IMPALA_COLUMNS, self.device)
        # V(s_T) computed by the worker after the fragment's last step
        bootstrap = torch.as_tensor(batch[sb.BOOTSTRAP][0],
                                    device=self.device)
        return self._update(self.params,
                            *(cols[k] for k in IMPALA_COLUMNS), bootstrap)

    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        target = self.cfg.get("train_batch_size", 4000)
        processed = 0
        stats: Dict[str, Any] = {}
        if not self._inflight:
            for w in self.workers.remote_workers:
                self._arm(w)
        while processed < target:
            ready, _ = api.wait(
                list(self._inflight), num_returns=1, timeout=60)
            if not ready:
                raise TimeoutError("no sample fragments arriving")
            ref = ready[0]
            worker = self._inflight.pop(ref)
            batch = api.get(ref)
            self._arm(worker)  # overlap: next fragment samples while we learn
            n = sb.batch_size(batch)
            processed += n
            self._timesteps_total += n
            stats = self.learn_on_fragment(batch)
        out = stats_to_floats(stats)
        wall = time.time() - t0
        out.update({
            "num_env_steps_sampled": processed,
            "steps_per_s": processed / max(wall, 1e-9),
        })
        return out

    def cleanup(self) -> None:
        self._inflight.clear()
        super().cleanup()


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(IMPALA)
        self.num_rollout_workers = 2
        self.extra.update({"vf_loss_coeff": 0.5, "entropy_coeff": 0.01})
