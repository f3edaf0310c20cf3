"""ray_tpu_torch.tune: hyperparameter search (the counterpart of
``ray_tpu/tune``, with the same ``__all__``).  Trials are the port's
tasks; intermediate reports and early-stop signals flow through the
driver's ``_control`` store.
"""

from .search import choice, grid_search, loguniform, randint, uniform
from .searchers import (BasicVariantSearcher, ConcurrencyLimiter, Repeater,
                        Searcher, TPESearcher)
from .tuner import (ResultGrid, TrialResult, TuneConfig, Tuner,
                    get_checkpoint, report, TuneStopException)
from .schedulers import (ASHAScheduler, FIFOScheduler, HyperBandScheduler,
                         MedianStoppingRule, PopulationBasedTraining)

__all__ = [
    "Tuner", "TuneConfig", "ResultGrid", "TrialResult", "report",
    "get_checkpoint", "TuneStopException",
    "grid_search", "choice", "uniform", "loguniform", "randint",
    "Searcher", "BasicVariantSearcher", "TPESearcher",
    "ConcurrencyLimiter", "Repeater",
    "ASHAScheduler", "FIFOScheduler", "MedianStoppingRule",
    "HyperBandScheduler", "PopulationBasedTraining",
]
