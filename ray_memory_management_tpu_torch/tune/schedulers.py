"""Trial schedulers: FIFO, ASHA (async successive halving), PBT.

Mirrors the reference's tune/schedulers/ — the TrialScheduler
CONTINUE/PAUSE/STOP decision contract (trial_scheduler.py), ASHA rung logic
(async_hyperband.py: rungs at ``grace_period * reduction_factor**k``, cutoff
at the top ``1/reduction_factor`` quantile of completed rung results), and
PopulationBasedTraining exploit/explore (pbt.py: bottom-quantile trials clone
the state of top-quantile trials and perturb hyperparameters by 1.2x/0.8x or
a resample).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def __init__(self, metric: str = "loss", mode: str = "min"):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode

    def _score(self, result: Dict[str, Any]) -> Optional[float]:
        v = result.get(self.metric)
        if v is None:
            return None
        return -float(v) if self.mode == "min" else float(v)

    def on_trial_result(self, runner, trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, runner, trial,
                          result: Optional[Dict[str, Any]]) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion (tune default)."""


class ASHAScheduler(TrialScheduler):
    """Async successive halving (tune/schedulers/async_hyperband.py)."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4, time_attr: str =
                 "training_iteration"):
        super().__init__(metric, mode)
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        # rung milestones: grace, grace*rf, grace*rf^2, ... < max_t
        self.milestones: List[int] = []
        t = grace_period
        while t < max_t:
            self.milestones.append(t)
            t *= reduction_factor
        # recorded scores per rung
        self.rungs: Dict[int, List[float]] = {m: [] for m in self.milestones}

    def on_trial_result(self, runner, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        score = self._score(result)
        if score is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        decision = CONTINUE
        for m in self.milestones:
            if t == m:
                rung = self.rungs[m]
                rung.append(score)
                k = max(1, len(rung) // self.rf)
                cutoff = sorted(rung, reverse=True)[k - 1]
                if score < cutoff:
                    decision = STOP
        return decision


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running-average score falls below the median
    of all trials' running averages at the same point in training
    (tune/schedulers/median_stopping_rule.py — the Google Vizier rule).
    Gentler than ASHA: no rungs, every trial gets ``grace_period`` and
    the cut tracks the cohort continuously."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 grace_period: int = 5, min_samples_required: int = 3,
                 time_attr: str = "training_iteration"):
        super().__init__(metric, mode)
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self.time_attr = time_attr
        # per-trial score history (in canonical higher-is-better space)
        self._history: Dict[str, List[float]] = {}

    def _running_mean(self, tid: str, upto: int) -> float:
        # truncate at the decision step: a finished trial's converged tail
        # must not raise the bar on a younger trial being judged at t
        h = self._history[tid][:upto]
        return sum(h) / len(h)

    def on_trial_result(self, runner, trial, result: Dict[str, Any]) -> str:
        import statistics

        t = result.get(self.time_attr, 0)
        score = self._score(result)
        if score is None:
            return CONTINUE
        self._history.setdefault(trial.id, []).append(score)
        if t < self.grace_period:
            return CONTINUE
        n_own = len(self._history[trial.id])
        means = [self._running_mean(tid, n_own)
                 for tid in self._history if tid != trial.id]
        if len(means) < self.min_samples:
            return CONTINUE  # not enough cohort evidence to cut anyone
        if self._running_mean(trial.id, n_own) < statistics.median(means):
            return STOP
        return CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (tune/schedulers/pbt.py): every ``perturbation_interval``
    iterations, trials in the bottom quantile clone a top-quantile trial's
    checkpoint and run with perturbed hyperparameters. The runner performs the
    actual exploit via the ``exploit`` callback it passes in."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None,
                 time_attr: str = "training_iteration"):
        super().__init__(metric, mode)
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self.time_attr = time_attr
        self.rng = random.Random(seed)
        self.last_scores: Dict[str, float] = {}
        self.last_perturb: Dict[str, int] = {}

    def explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """Perturb mutated keys: 1.2x / 0.8x, or resample (pbt.py:explore)."""
        from .search import Domain

        new = dict(config)
        for key, spec in self.mutations.items():
            if key not in new:
                continue
            if self.rng.random() < self.resample_p:
                if isinstance(spec, Domain):
                    new[key] = spec.sample(self.rng)
                elif isinstance(spec, list):
                    new[key] = self.rng.choice(spec)
                elif callable(spec):
                    new[key] = spec()
            elif isinstance(new[key], (int, float)):
                factor = 1.2 if self.rng.random() > 0.5 else 0.8
                new[key] = type(new[key])(new[key] * factor)
            elif isinstance(spec, list):
                new[key] = self.rng.choice(spec)
        return new

    def on_trial_result(self, runner, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        score = self._score(result)
        if score is not None:
            self.last_scores[trial.id] = score
        if t - self.last_perturb.get(trial.id, 0) < self.interval:
            return CONTINUE
        self.last_perturb[trial.id] = t
        scores = sorted(self.last_scores.values())
        n = len(scores)
        if n < 2 or score is None:
            return CONTINUE
        k = max(1, int(n * self.quantile))
        lower_cut = scores[k - 1]
        upper_cut = scores[n - k]
        if score <= lower_cut:
            # exploit: pick a random top-quantile trial to clone
            top = [tid for tid, s in self.last_scores.items()
                   if s >= upper_cut and tid != trial.id]
            if top:
                runner.request_exploit(trial, self.rng.choice(top),
                                       self.explore(trial.config))
        return CONTINUE
