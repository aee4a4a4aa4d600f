"""APPO: asynchronous PPO on the IMPALA architecture.

The reference's APPO (rllib/algorithms/appo/appo.py — IMPALA's async
sampling loop with PPO's clipped surrogate objective;
appo_tf_policy.py:120 the loss: importance ratio against the BEHAVIOR
policy that sampled the fragment, clipped PPO-style, with V-trace
advantages/targets correcting the off-policyness). Sampling never blocks
on the learner (IMPALA's overlap), but each gradient step is
trust-region-bounded like PPO — the middle ground between the two.

Implementation: everything is inherited from IMPALA (arming loop,
fragment consumption, bootstrap handling); only the update differs,
swapping V-trace's plain policy-gradient term for the clipped surrogate
on the same V-trace advantages.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .algorithm import AlgorithmConfig
from .impala import IMPALA, vtrace
from .models import ac_apply, apply_update, entropy_of, logp_of


def make_appo_update(optimizer: torch.optim.Optimizer, gamma: float,
                     vf_coeff: float, entropy_coeff: float,
                     clip_param: float, rho_clip: float = 1.0,
                     c_clip: float = 1.0):
    def update(params, obs, actions, behavior_logp, rewards, dones,
               bootstrap_value):
        logits, values = ac_apply(params, obs)
        target_logp, logp_all = logp_of(logits, actions)
        vs, pg_adv = vtrace(target_logp, behavior_logp, rewards, values,
                            dones, bootstrap_value, gamma=gamma,
                            rho_clip=rho_clip, c_clip=c_clip)
        # PPO clipped surrogate with the ratio against the SAMPLING
        # policy (appo_tf_policy.py's is_ratio * clip scheme)
        ratio = torch.exp(target_logp - behavior_logp)
        surr = torch.minimum(
            ratio * pg_adv,
            torch.clamp(ratio, 1.0 - clip_param, 1.0 + clip_param) * pg_adv)
        pg_loss = -surr.mean()
        vf_loss = torch.square(values - vs).mean()
        entropy = entropy_of(logp_all)
        total = pg_loss + vf_coeff * vf_loss - entropy_coeff * entropy
        apply_update(optimizer, total)
        return {"policy_loss": pg_loss.detach(), "vf_loss": vf_loss.detach(),
                "entropy": entropy.detach(),
                "mean_is_ratio": ratio.mean().detach(),
                "total_loss": total.detach()}

    return update


class APPO(IMPALA):
    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        # swap the plain V-trace policy gradient for the clipped
        # surrogate; everything else (arming, fragment loop) is IMPALA's
        self._update = make_appo_update(
            self.optimizer, config.get("gamma", 0.99),
            config.get("vf_loss_coeff", 0.5),
            config.get("entropy_coeff", 0.01),
            config.get("clip_param", 0.3))


class APPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(APPO)
        self.num_rollout_workers = 2
        self.extra.update({"vf_loss_coeff": 0.5, "entropy_coeff": 0.01,
                           "clip_param": 0.3})

    def training(self, *, clip_param=None, vf_loss_coeff=None,
                 entropy_coeff=None, **kwargs) -> "APPOConfig":
        super().training(**kwargs)
        for k, v in (("clip_param", clip_param),
                     ("vf_loss_coeff", vf_loss_coeff),
                     ("entropy_coeff", entropy_coeff)):
            if v is not None:
                self.extra[k] = v
        return self
