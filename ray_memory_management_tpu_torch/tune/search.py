"""Search spaces and search algorithms.

Mirrors the reference's tune search layer (python/ray/tune/search/):
sample-space primitives (tune/search/sample.py — uniform/loguniform/choice/
randint/grid_search), `BasicVariantGenerator` (tune/search/basic_variant.py)
which crosses grid axes and samples stochastic axes, and the `Searcher`
suggest/on_trial_complete contract (tune/search/searcher.py) used by advanced
algorithms. This build keeps the same surface but is dependency-free.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Dict, List, Optional


class Domain:
    """A sampleable hyperparameter domain."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class QUniform(Domain):
    def __init__(self, low: float, high: float, q: float):
        self.low, self.high, self.q = low, high, q

    def sample(self, rng):
        v = rng.uniform(self.low, self.high)
        return round(round(v / self.q) * self.q, 10)


class LogUniform(Domain):
    def __init__(self, low: float, high: float):
        import math

        self.log_low, self.log_high = math.log(low), math.log(high)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self.log_low, self.log_high))


class RandInt(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class Choice(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Function(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        return self.fn(None)


class GridSearch:
    """Marker for exhaustive axes (tune/search/sample.py grid_search)."""

    def __init__(self, values):
        self.values = list(values)


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def quniform(low: float, high: float, q: float) -> QUniform:
    return QUniform(low, high, q)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def choice(categories) -> Choice:
    return Choice(categories)


def sample_from(fn: Callable) -> Function:
    return Function(fn)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


def _split_space(space: Dict[str, Any]):
    """Partition a (possibly nested) param space into grid axes and the
    sampled/constant remainder. Returns (grid_paths, template) where
    grid_paths is [(key_path, values)]."""
    grid: List = []

    def walk(node, path):
        if isinstance(node, GridSearch):
            grid.append((path, node.values))
            return None
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return node

    template = walk(space, ())
    return grid, template


def _materialize(node, rng: random.Random):
    if isinstance(node, Domain):
        return node.sample(rng)
    if isinstance(node, dict):
        return {k: _materialize(v, rng) for k, v in node.items()}
    return node


def _set_path(cfg: dict, path, value):
    cur = cfg
    for key in path[:-1]:
        cur = cur.setdefault(key, {})
    cur[path[-1]] = value


class BasicVariantGenerator:
    """Cross-product of grid axes x ``num_samples`` random draws
    (tune/search/basic_variant.py semantics: num_samples multiplies the
    grid)."""

    def __init__(self, space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self.space = space
        self.num_samples = num_samples
        self.rng = random.Random(seed)

    def variants(self) -> List[Dict[str, Any]]:
        grid_axes, _ = _split_space(self.space)
        out: List[Dict[str, Any]] = []
        grid_combos: List[List] = (
            [list(combo) for combo in
             itertools.product(*[vals for _, vals in grid_axes])]
            if grid_axes else [[]]
        )
        for _ in range(self.num_samples):
            for combo in grid_combos:
                _, template = _split_space(self.space)
                cfg = _materialize(template, self.rng)
                if not isinstance(cfg, dict):
                    cfg = {}
                for (path, _vals), value in zip(grid_axes, combo):
                    _set_path(cfg, path, value)
                out.append(cfg)
        return out


class Searcher:
    """suggest/on_trial_complete contract (tune/search/searcher.py)."""

    def __init__(self, metric: str = "loss", mode: str = "min"):
        self.metric = metric
        self.mode = mode

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        pass


class RandomSearch(Searcher):
    """Pure random sampling searcher over a Domain space."""

    def __init__(self, space: Dict[str, Any], metric: str = "loss",
                 mode: str = "min", seed: Optional[int] = None):
        super().__init__(metric, mode)
        self.space = space
        self.rng = random.Random(seed)

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        _, template = _split_space(self.space)
        return _materialize(template, self.rng)


class TPESearch(Searcher):
    """Tree-structured Parzen Estimator (Bergstra et al. 2011) — the
    algorithm behind the reference's hyperopt integration
    (tune/search/hyperopt/hyperopt_search.py), implemented in-repo.

    After ``n_initial_points`` random trials, completed observations
    split into a good fraction (best ``gamma`` quantile by the metric)
    and the rest; for each dimension, candidates are drawn from a kernel
    density over the GOOD values and ranked by the density ratio
    l(x)/g(x) (hyperopt's factorized per-dimension form). Numeric
    domains (uniform / loguniform / quniform / randint) get Gaussian
    kernels (log-space for loguniform); Choice domains get smoothed
    category frequencies. Other domains fall back to random sampling.

    Model-based search needs results fed back: the Tuner runs searcher
    trials in waves and calls on_trial_complete between waves."""

    def __init__(self, space: Dict[str, Any], metric: str = "loss",
                 mode: str = "min", seed: Optional[int] = None,
                 n_initial_points: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24):
        super().__init__(metric, mode)
        grid_axes, _ = _split_space(space)
        if grid_axes:
            raise ValueError(
                "TPESearch does not support grid_search axes (they would "
                "silently materialize as None); use plain Domains, or "
                "keep grid axes on the BasicVariantGenerator path")
        self.space = space
        self.rng = random.Random(seed)
        self.n_initial_points = n_initial_points
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._suggested: Dict[str, Dict[str, Any]] = {}
        self._obs: List = []  # (score, flat_config)

    # -- observation feed -----------------------------------------------------
    def on_trial_complete(self, trial_id, result=None,
                          error: bool = False) -> None:
        cfg = self._suggested.pop(trial_id, None)
        if error or cfg is None or not result \
                or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "max":
            score = -score
        self._obs.append((score, cfg))

    # -- suggestion -----------------------------------------------------------
    def suggest(self, trial_id: str) -> Dict[str, Any]:
        _, template = _split_space(self.space)
        if len(self._obs) < self.n_initial_points \
                or not isinstance(template, dict):
            cfg = _materialize(template, self.rng)
        else:
            ranked = sorted(self._obs, key=lambda t: t[0])
            n_good = max(1, int(len(ranked) * self.gamma))
            good = [c for _, c in ranked[:n_good]]
            bad = [c for _, c in ranked[n_good:]] or good
            cfg = {k: self._suggest_dim(k, v, good, bad)
                   for k, v in template.items()}
        self._suggested[trial_id] = cfg
        return cfg

    def _suggest_dim(self, key, domain, good, bad):
        import math

        if isinstance(domain, Choice):
            # l(x): smoothed category counts among good observations
            weights = []
            for cat in domain.categories:
                g = sum(1 for c in good if c.get(key) == cat) + 1.0
                b = sum(1 for c in bad if c.get(key) == cat) + 1.0
                weights.append(g / b)
            return self.rng.choices(domain.categories, weights)[0]
        if isinstance(domain, (Uniform, QUniform, RandInt, LogUniform)):
            log = isinstance(domain, LogUniform)
            if log:
                lo, hi = domain.log_low, domain.log_high
            elif isinstance(domain, RandInt):
                # randrange semantics: high is EXCLUSIVE — the largest
                # valid integer is high - 1, and a clamped candidate must
                # never round outside the declared domain
                lo, hi = domain.low, domain.high - 1
            else:
                lo, hi = domain.low, domain.high

            def val(c):
                v = float(c.get(key))
                return math.log(v) if log else v

            gvals = [val(c) for c in good if c.get(key) is not None]
            bvals = [val(c) for c in bad if c.get(key) is not None]
            if not gvals:
                return domain.sample(self.rng)
            # bandwidth follows the empirical spread of the GOOD set
            # (self-tightening as the search concentrates), floored at a
            # small fraction of the range so the kernel never collapses
            if len(gvals) > 1:
                mean = sum(gvals) / len(gvals)
                spread = (sum((v - mean) ** 2 for v in gvals)
                          / len(gvals)) ** 0.5
            else:
                spread = (hi - lo) / 4.0
            sigma = max(spread, (hi - lo) * 1e-3, 1e-12)

            # both densities carry a uniform prior component (weight 1):
            # in unexplored regions the ratio tends to 1, so exploration
            # survives even when the good set has collapsed into a narrow
            # (possibly wrong) cluster — the standard TPE prior smoothing
            prior = 1.0 / max(hi - lo, 1e-12)
            norm = 1.0 / (sigma * math.sqrt(2 * math.pi))

            def density(x, centers):
                k = sum(math.exp(-0.5 * ((x - m) / sigma) ** 2)
                        for m in centers) * norm
                return (k + prior) / (len(centers) + 1)

            best_x, best_ratio = None, -1.0
            for i in range(self.n_candidates):
                if i % 4 == 3:  # a quarter of candidates probe uniformly
                    x = self.rng.uniform(lo, hi)
                else:
                    x = min(max(self.rng.gauss(self.rng.choice(gvals),
                                               sigma), lo), hi)
                ratio = density(x, gvals) / (density(x, bvals) + 1e-300)
                if ratio > best_ratio:
                    best_x, best_ratio = x, ratio
            x = math.exp(best_x) if log else best_x
            if isinstance(domain, QUniform):
                # mirror QUniform.sample exactly (incl. the float-noise
                # rounding) so model-phase values compare equal to
                # random-phase ones
                x = round(round(x / domain.q) * domain.q, 10)
            if isinstance(domain, RandInt):
                x = int(round(x))
            return x
        return _materialize(domain, self.rng)  # nested/unsupported: random
