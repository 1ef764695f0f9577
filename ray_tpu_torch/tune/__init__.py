"""ray_tpu_torch.tune: hyperparameter search and experiment orchestration.

Mirrors the reference's Ray Tune surface (reference: python/ray/tune/):
Tuner/TuneConfig/ResultGrid, search domains (uniform/loguniform/randint/
choice/grid_search/sample_from), schedulers (ASHA, median stopping, PBT),
and `tune.report` via the shared train session.

The port's copy of ``ray_tpu/tune`` on the port's runtime,
``train.session``, ``train.storage`` and ``_private.fileio``; nothing in
it loads torch.  A trial asks for cards the runtime's way: a plain
trainable through ``TuneConfig(trial_resources={"CPU": 1, "GPU": 0.5})``
(the runner actor's ``GPU`` lease), a ``JaxTrainer.as_trainable()`` trial
through its gang's ``ScalingConfig(use_gpu=True, gpus_per_worker=...)``
(the trial itself holds no CPU).  ROADMAP §C has the choices.
"""

from ray_tpu_torch.train.session import get_checkpoint, get_context, report

from .schedulers import (AsyncHyperBandScheduler, FIFOScheduler,
                         HyperBandScheduler, MedianStoppingRule, PB2,
                         PopulationBasedTraining, TrialScheduler)
from .search import (BasicVariantGenerator, BayesOptSearch, Categorical,
                     ConcurrencyLimiter,
                     Domain, Float, Integer, Repeater, Searcher,
                     SearcherWrapper, TPESearch,
                     choice, generate_variants, grid_search, loguniform,
                     randint, sample_from, uniform)
from .trial import Trial
from .tune_controller import Callback, JsonLoggerCallback, TuneController
from .tuner import ResultGrid, TuneConfig, Tuner, run

ASHAScheduler = AsyncHyperBandScheduler

__all__ = [
    "ASHAScheduler", "AsyncHyperBandScheduler", "BasicVariantGenerator",
    "BayesOptSearch",
    "Callback", "Categorical", "ConcurrencyLimiter", "Domain",
    "FIFOScheduler", "Float", "HyperBandScheduler", "Integer",
    "JsonLoggerCallback", "MedianStoppingRule", "PB2",
    "PopulationBasedTraining", "Repeater", "ResultGrid", "Searcher",
    "SearcherWrapper", "TPESearch", "Trial", "TrialScheduler",
    "TuneConfig", "TuneController",
    "Tuner", "choice", "generate_variants", "get_checkpoint", "get_context",
    "grid_search", "loguniform", "randint", "report", "run", "sample_from",
    "uniform",
]
