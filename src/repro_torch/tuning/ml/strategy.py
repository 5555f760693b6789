"""``strategy="ml"`` — learned config prediction as a first-class strategy.

Ranks every valid candidate with the trained forest and returns the argmin
in **zero objective evaluations** — the ML twin of the analytical
methodology's zero-evaluation online answer, but learned from offline
measurements instead of derived from architectural rules.

Fallback ladder (the registry's resolution order):

  1. **ml** — a model artifact exists, has a forest for this op, and the
     per-tree disagreement at the winning candidate is below the
     confidence gate;
  2. **analytical** — no artifact / no forest for the op / low confidence:
     defer to the expert model (one objective evaluation, same contract as
     the registered ``analytical`` strategy);
  3. **default** — the analytical path itself degrades to the generic
     space-wide argmax of the guideline score, which always produces a
     valid config.

``TuneResult.stopped_by`` records which rung answered ("ml",
"ml-defer-analytical", "ml-fallback:no-model",
"ml-fallback:no-forest:<op>", "ml-fallback:low-confidence"), so callers
and tests can assert the ladder.

The *choice* is always evaluation-free (``choose`` never touches an
objective).  ``tune`` then measures the single chosen config so that
``TuneResult.best_time`` — and anything persisted to the TuningDB by
``TunerSession.tune`` — is a real time in seconds, never a unitless
predicted score.  ``evaluations`` stays 0, matching the ``analytical``
strategy's convention: it counts *search* evaluations, and the ranking
consumed none.

The PyTorch port's own copy of ``repro.tuning.ml.strategy``.  The artifact
path comes from the port's own ``$REPRO_TORCH_ML_MODEL`` (default
``artifacts/ml_model_torch.npz`` at the repository root), so a process
that runs both packages never loads the other package's artifact by
accident.  The analytical fallback is a tuning decision, not a device
fallback: the config it picks still runs its kernel on the card.
"""
from __future__ import annotations

import os
import threading
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.analytical import AnalyticalTuner
from repro_torch.core.bayesian import TuneResult
from repro_torch.core.objective import Objective
from repro_torch.core.space import SearchSpace
from repro_torch.tuning.ml.features import FEATURE_NAMES, featurize_batch
from repro_torch.tuning.ml.forest import ModelArtifactError, ModelBundle

ANA_RANK_COL = FEATURE_NAMES.index("ana_rank_pct")

# repo-relative artifact location used when $REPRO_TORCH_ML_MODEL is unset
DEFAULT_MODEL_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                                  "..", "artifacts", "ml_model_torch.npz")


def default_model_path() -> str:
    """Artifact path honoring $REPRO_TORCH_ML_MODEL *at call time* (a process
    that retargets the env var after import gets the new artifact from
    every entry point, not just ``default_strategy``)."""
    return os.path.abspath(os.environ.get("REPRO_TORCH_ML_MODEL",
                                          DEFAULT_MODEL_PATH))

# per-tree std (log-slowdown units) above which the forest's answer is
# considered a guess; exp(0.4) ~ 1.5x disagreement between trees
DEFAULT_MAX_STD = 0.4

# If the analytical suggestion is predicted within this log-slowdown of the
# learned optimum (~2%), defer to it: near the top the forest's residual
# error exceeds the true config-to-config gaps, and the expert ordering is
# the more reliable discriminator in that band (and the more explainable
# choice). Outside the band, the learned ranking overrides the expert.
DEFAULT_DEFER_EPS = 0.02


class MLStrategy:
    """Learned candidate ranking with graceful analytical fallback."""

    name = "ml"

    def __init__(self, model: Optional[ModelBundle] = None, *,
                 model_path: Optional[str] = None,
                 max_std: float = DEFAULT_MAX_STD,
                 defer_eps: float = DEFAULT_DEFER_EPS):
        self._model = model
        self._model_path = os.path.abspath(model_path) if model_path else None
        self.max_std = max_std
        self.defer_eps = defer_eps
        self._load_attempted = model is not None
        self._analytical = AnalyticalTuner()

    @property
    def model_path(self) -> str:
        return self._model_path or default_model_path()

    # -- model loading -------------------------------------------------------

    @property
    def model(self) -> Optional[ModelBundle]:
        if not self._load_attempted:
            self._load_attempted = True
            try:
                self._model = ModelBundle.load(self.model_path)
            except ModelArtifactError:
                self._model = None
        return self._model

    # -- prediction ----------------------------------------------------------

    def predict(self, space: SearchSpace, cfgs,
                X: Optional[np.ndarray] = None
                ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(mean, per-tree std) of log-slowdown; None when un-modeled.

        Pass ``X`` (rows from :func:`featurize_batch` over the same
        ``cfgs``) to reuse an already-computed feature matrix.
        """
        bundle = self.model
        if bundle is None:
            return None
        forest = bundle.forest_for(space.workload.op)
        if forest is None:
            return None
        if X is None:
            X = featurize_batch(space, cfgs)
        return forest.predict(X)

    def _analytical_index(self, space: SearchSpace, cfgs,
                          X: Optional[np.ndarray]) -> int:
        """Index of the analytical suggestion among ``cfgs``.

        With a feature matrix in hand the answer is free: the candidate
        whose ``ana_rank_pct`` is 1.0 is exactly the guideline's argmax.
        """
        if X is not None and len(X):
            return int(np.argmax(X[:, ANA_RANK_COL]))
        return cfgs.index(self._analytical.suggest(space))

    def choose(self, space: SearchSpace, cfgs,
               X: Optional[np.ndarray] = None,
               pred: Optional[Tuple[np.ndarray, np.ndarray]] = None
               ) -> Tuple[int, str]:
        """(index of the chosen candidate, which rung chose it).

        The deployed decision rule — evaluation-free, fallbacks included —
        shared with ``evaluate_model`` so the reported accuracy is the
        accuracy of what actually ships: predicted-argmin, except the
        analytical suggestion wins when its prediction sits within
        ``defer_eps`` of the learned optimum, and the analytical choice
        answers outright when no model/forest exists or the per-tree
        disagreement exceeds ``max_std``.
        """
        if not cfgs:
            raise ValueError(f"empty search space for {space.workload.key}")
        if self.model is None:
            return self._analytical_index(space, cfgs, X), \
                "ml-fallback:no-model"
        if self.model.forest_for(space.workload.op) is None:
            return self._analytical_index(space, cfgs, X), \
                f"ml-fallback:no-forest:{space.workload.op}"
        if X is None:
            X = featurize_batch(space, cfgs)
        mean, std = pred if pred is not None else self.predict(space, cfgs, X)
        best = int(np.argmin(mean))
        ana = self._analytical_index(space, cfgs, X)
        if float(std[best]) > self.max_std:
            return ana, "ml-fallback:low-confidence"
        if float(mean[ana]) <= float(mean[best]) + self.defer_eps:
            return ana, "ml-defer-analytical"
        return best, "ml"

    # -- strategy entry point (registry signature) ---------------------------

    def tune(self, space: SearchSpace, objective: Objective, *,
             seed: int = 0, max_evals: int = 0) -> TuneResult:
        cfgs = space.enumerate_valid()
        chosen, rung = self.choose(space, cfgs)
        # one real measurement of the winner so best_time (and whatever the
        # session persists) is seconds, not a relative predicted score;
        # evaluations stays 0 — the search consumed none (same convention
        # as the analytical strategy)
        m = objective(space, cfgs[chosen])
        cfg = dict(cfgs[chosen])
        return TuneResult(cfg, m.time_s, 0, [(cfg, m.time_s)], rung)

    __call__ = tune


# ---------------------------------------------------------------------------
# Default (process-wide) strategy — what strategy="ml" resolves to
# ---------------------------------------------------------------------------
# Cached per (path, mtime, size) so a retrained artifact is picked up
# without restarting, while steady-state calls skip the disk entirely.

_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Tuple[Optional[Tuple], Optional[MLStrategy]] = (None, None)


def _artifact_token(path: str) -> Optional[Tuple]:
    try:
        st = os.stat(path)
        return (path, st.st_mtime_ns, st.st_size)
    except OSError:
        return (path,)


def default_strategy() -> MLStrategy:
    global _DEFAULT
    path = default_model_path()
    token = _artifact_token(path)
    with _DEFAULT_LOCK:
        cached_token, cached = _DEFAULT
        if cached is not None and cached_token == token:
            return cached
        strategy = MLStrategy(model_path=path)
        _DEFAULT = (token, strategy)
        return strategy
