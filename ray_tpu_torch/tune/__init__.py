"""ray_tpu_torch.tune — hyperparameter sweep library. Ported from
``ray_tpu/tune``: search spaces, searchers (basic variant, TPE, GP,
define-by-run), schedulers (FIFO, ASHA, HyperBand, median stopping, PBT,
PB2), ``Tuner``/``ResultGrid``/``run``, and the storage half (URI parsing,
storage backends, ``Syncer``), through which the workflow storage and the
spill backend also do their byte I/O.

Parity surface: reference python/ray/tune — Tuner (tuner.py:53),
TrialRunner/TuneController (execution/trial_runner.py:1179), search spaces
(grid_search/choice/uniform/...), searchers (basic variant, native TPE for
the hyperopt role, GP-UCB for the bayesopt role, define-by-run for the
optuna role), schedulers (FIFO, ASHA schedulers/async_hyperband.py,
HyperBand hyperband.py, median stopping, PBT pbt.py, PB2 pb2.py),
ResultGrid, storage sync (syncer.py).
"""

from ray_tpu_torch.tune.search import (BasicVariantSearcher,
                                       DefineByRunSearcher, GPSearcher,
                                       Searcher, TPESearcher, TrialHandle)
from ray_tpu_torch.tune.search_space import (choice, grid_search, loguniform,
                                             randint, randn, sample_from,
                                             uniform)
from ray_tpu_torch.tune.schedulers import (AsyncHyperBandScheduler,
                                           FIFOScheduler, HyperBandScheduler,
                                           MedianStoppingRule, PB2,
                                           PopulationBasedTraining)
from ray_tpu_torch.tune.syncer import (StorageBackend, Syncer, backend_for,
                                       is_uri, local_cache_dir, parse_uri)
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner, run

ASHAScheduler = AsyncHyperBandScheduler

__all__ = ["Tuner", "TuneConfig", "ResultGrid", "run", "grid_search",
           "Searcher", "BasicVariantSearcher", "TPESearcher", "GPSearcher",
           "DefineByRunSearcher", "TrialHandle",
           "choice", "uniform", "loguniform", "randint", "randn",
           "sample_from", "FIFOScheduler", "AsyncHyperBandScheduler",
           "ASHAScheduler", "HyperBandScheduler", "MedianStoppingRule",
           "PopulationBasedTraining", "PB2", "Syncer",
           "parse_uri", "is_uri", "StorageBackend", "backend_for",
           "local_cache_dir"]
