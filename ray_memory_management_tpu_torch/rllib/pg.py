"""PG: vanilla policy gradient (REINFORCE), the simplest on-policy member.

The reference's PG (rllib/algorithms/pg/pg_tf_policy.py:31 — loss is just
-mean(logp(a|s) * advantage), one pass over each batch, no ratio, no
clipping). Everything else — rollout workers, GAE postprocessing, the
sync sample/learn loop — is PPO's machinery unchanged, so PG here is PPO
with the surrogate swapped for the plain score-function estimator and a
single SGD pass per batch (re-stepping a policy-gradient loss on stale
logps is exactly what PPO's clip exists to make safe; PG doesn't have it).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .algorithm import AlgorithmConfig
from .models import ac_apply, apply_update, entropy_of, logp_of, normalize
from .ppo import PPO


def make_pg_update(optimizer: torch.optim.Optimizer, vf_coeff: float,
                   entropy_coeff: float):
    def update(params, obs, actions, old_logp, advantages, targets):
        # old_logp accepted (PPO's calling convention) but unused: PG has
        # no importance ratio
        del old_logp
        logits, values = ac_apply(params, obs)
        logp, logp_all = logp_of(logits, actions)
        pg_loss = -(logp * normalize(advantages)).mean()
        vf_loss = torch.square(values - targets).mean()
        entropy = entropy_of(logp_all)
        total = pg_loss + vf_coeff * vf_loss - entropy_coeff * entropy
        apply_update(optimizer, total)
        return {"policy_loss": pg_loss.detach(), "vf_loss": vf_loss.detach(),
                "entropy": entropy.detach(), "total_loss": total.detach()}

    return update


class PG(PPO):
    def setup(self, config: Dict[str, Any]) -> None:
        config = dict(config)
        # one pass per batch: PG has no trust region making re-steps safe
        config.setdefault("num_sgd_iter", 1)
        super().setup(config)
        self._update = make_pg_update(
            self.optimizer, self.vf_coeff, self.entropy_coeff)


class PGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(PG)
        self.extra.update({"vf_loss_coeff": 0.5, "entropy_coeff": 0.01,
                           "num_sgd_iter": 1})

    def training(self, *, vf_loss_coeff=None, entropy_coeff=None,
                 num_sgd_iter=None, sgd_minibatch_size=None,
                 **kwargs) -> "PGConfig":
        super().training(**kwargs)
        for k, v in (("vf_loss_coeff", vf_loss_coeff),
                     ("entropy_coeff", entropy_coeff),
                     ("num_sgd_iter", num_sgd_iter),
                     ("sgd_minibatch_size", sgd_minibatch_size)):
            if v is not None:
                self.extra[k] = v
        return self


class A2CConfig(PGConfig):
    """A2C is PG with the learned value baseline emphasized and larger
    synchronous batches (the reference keeps A2C as its own algorithm,
    rllib/algorithms/a2c/a2c.py — sync parallel rollouts + advantage
    actor-critic loss; that is exactly this estimator with GAE
    advantages, so the preset only retunes coefficients)."""

    def __init__(self):
        super().__init__()
        self.extra.update({"vf_loss_coeff": 1.0, "entropy_coeff": 0.01})
