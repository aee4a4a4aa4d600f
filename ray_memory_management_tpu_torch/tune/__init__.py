"""Tune-equivalent: hyperparameter search over trial actors.

Reference surface: python/ray/tune (Tuner tune/tuner.py:32, TrialRunner
tune/execution/trial_runner.py:236, Trainable tune/trainable/trainable.py:65,
search spaces tune/search/sample.py, schedulers tune/schedulers/).
"""

from .search import (
    BasicVariantGenerator,
    RandomSearch,
    TPESearch,
    Searcher,
    choice,
    grid_search,
    loguniform,
    quniform,
    randint,
    sample_from,
    uniform,
)
from .schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from .syncer import Syncer
from .trainable import FunctionTrainable, Trainable, wrap_function
from .tuner import ResultGrid, TrialResult, TuneConfig, Tuner

__all__ = [
    "Tuner", "TuneConfig", "ResultGrid", "TrialResult",
    "Trainable", "FunctionTrainable", "wrap_function",
    "TrialScheduler", "FIFOScheduler", "ASHAScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "Searcher", "RandomSearch", "TPESearch", "BasicVariantGenerator",
    "uniform", "quniform", "loguniform", "randint", "choice",
    "grid_search", "sample_from",
]
