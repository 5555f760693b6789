"""TunerSession — the single config-resolution pipeline.

One object owns everything the paper's deployment story needs:

  * the persistent :class:`~repro_torch.tuning.db.TuningDB` (offline winners),
  * the platform spec,
  * the resolution :class:`~repro_torch.core.policy.Policy` (latency /
    energy / edp / memory_cap) — which metric axis resolve/tune optimize;
    winners are keyed per policy in the DB,
  * the search strategies (bayesian / exhaustive / random / analytical /
    ml / online / transfer),
  * an in-memory LRU of fully resolved (normalized) configs, so the online
    hot path does not re-run the analytical model or re-fit dicts on every
    kernel call,
  * a memo of analytical suggestions per workload key (a DB miss consults
    the model once, not once per request).

Resolution order for ``resolve(wl)``:

  active ``overrides()``  >  explicit ``config=`` argument  >  LRU cache
  >  TuningDB entry  >  memoized analytical suggestion

(an explicit ``config`` replaces the DB/analytical base entirely; override
fragments then merge on top of whatever base was chosen) followed by the
op's registered normalizer, which fits the raw knobs to
the actual launch geometry. The process-wide default session is what the
kernel entry points use.

The PyTorch port's own copy of ``repro.tuning.session``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

from repro_torch.core.analytical import AnalyticalTuner
from repro_torch.core.bayesian import BayesianTuner, TuneResult
from repro_torch.core.exhaustive import ExhaustiveSearch, RandomSearch
from repro_torch.core.objective import CachedObjective, CostModelObjective, Objective
from repro_torch.core.policy import Policy, PolicyObjective, get_policy
from repro_torch.core.space import Config, Workload, build_space
from repro_torch.hw.profiles import HardwareProfile, active_profile, get_profile
from repro_torch.tuning.db import TuningDB
from repro_torch.tuning.overrides import active_overrides
from repro_torch.tuning.registry import normalizer_for

# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------
# A strategy maps (space, objective, seed, max_evals, **sweep_kwargs) ->
# TuneResult. Every strategy accepts (and may ignore) the sweep plumbing
# kwargs — journal_dir / prune / top_k / policy — so the session can
# forward them uniformly.

Strategy = Callable[..., TuneResult]


def _bayesian(space, objective, *, seed: int = 0, max_evals: int = 64,
              **_sweep) -> TuneResult:
    return BayesianTuner(seed=seed, max_evals=max_evals).tune(space, objective)


def _exhaustive(space, objective, *, seed: int = 0, max_evals: int = 0,
                journal_dir=None, prune=None, top_k=None,
                policy=None) -> TuneResult:
    if policy is None and isinstance(objective, PolicyObjective):
        # sweep the raw objective and pick from its front under the policy,
        # as tune() does: a sweep of the wrapper would rank by raw time_s
        # (its batch columns are the raw metrics) and report seconds where
        # the caller scores policy scalars
        objective, policy = objective.inner, objective.policy
    return ExhaustiveSearch(journal_dir=journal_dir, prune=prune,
                            top_k=top_k, policy=policy).tune(space, objective)


def _random(space, objective, *, seed: int = 0, max_evals: int = 64,
            **_sweep) -> TuneResult:
    return RandomSearch(max_evals=max_evals, seed=seed).tune(space, objective)


def _analytical(space, objective, *, seed: int = 0, max_evals: int = 0,
                **_sweep) -> TuneResult:
    cfg = AnalyticalTuner().suggest(space)
    m = objective(space, cfg)
    return TuneResult(cfg, m.time_s, 0, [(cfg, m.time_s)], "analytical")


def _online(space, objective, *, seed: int = 0, max_evals: int = 16,
            **_sweep) -> TuneResult:
    # lazy import (online pulls in the sweep journal stack). Simulates
    # in-traffic tuning against the objective: analytical prior, trial /
    # guard-band / rollback state machine, max_evals as the measurement
    # budget (see repro_torch.tuning.online).
    from repro_torch.tuning.online import online_search
    return online_search(space, objective, seed=seed, budget=max_evals)


def _ml(space, objective, *, seed: int = 0, max_evals: int = 0,
        **_sweep) -> TuneResult:
    # lazy import: the forest/feature stack only loads when strategy="ml" is
    # actually used. Resolution ladder: ml -> analytical -> default (see
    # repro_torch.tuning.ml.strategy — the fallback is inside MLStrategy, so
    # this always returns a config even with no model artifact on disk).
    from repro_torch.tuning.ml.strategy import default_strategy
    return default_strategy().tune(space, objective, seed=seed,
                                   max_evals=max_evals)


def _transfer(space, objective, *, seed: int = 0, max_evals: int = 64,
              journal_dir=None, **_sweep) -> TuneResult:
    # lazy import (the transfer stack pulls in the journal reader). Warm
    # start from OTHER devices' sweep journals in journal_dir, reweighted by
    # profile distance; falls back to cold Bayesian with no journals.
    from repro_torch.core.transfer import transfer_strategy
    return transfer_strategy(space, objective, seed=seed,
                             max_evals=max_evals, journal_dir=journal_dir)


_STRATEGIES: Dict[str, Strategy] = {
    "bayesian": _bayesian,
    "exhaustive": _exhaustive,
    "random": _random,
    "analytical": _analytical,
    "ml": _ml,
    "online": _online,
    "transfer": _transfer,
}


def register_strategy(name: str, strategy: Strategy) -> None:
    _STRATEGIES[name] = strategy


def get_strategy(name: str) -> Strategy:
    try:
        return _STRATEGIES[name]
    except KeyError:
        raise ValueError(f"unknown tuning method {name!r}; registered: "
                         f"{', '.join(strategies())}") from None


def strategies() -> Tuple[str, ...]:
    return tuple(sorted(_STRATEGIES))


# ---------------------------------------------------------------------------
# TunerSession
# ---------------------------------------------------------------------------

def _dims_token(dims: Optional[Mapping[str, int]]) -> Optional[Tuple]:
    return tuple(sorted(dims.items())) if dims else None


class TunerSession:
    """Owns the DB + caches; the one public way to resolve tuned configs."""

    def __init__(self, db: Optional[TuningDB] = None, *,
                 db_path: Optional[str] = None, platform: Optional[str] = None,
                 spec: Optional[HardwareProfile] = None,
                 cache_size: int = 2048, sweep_dir: Optional[str] = None,
                 policy: Union[str, Policy] = "latency"):
        # profile resolution: an explicit spec wins; else a platform naming a
        # registered profile; else the process-wide active profile. The DB
        # platform defaults to the profile name, so entries tuned for one
        # device are keyed apart from every other device's.
        if spec is None:
            try:
                spec = get_profile(platform) if platform is not None \
                    else active_profile()
            except ValueError:
                # a platform label that is not a registered profile (custom
                # DB namespaces) keys the DB but models as the active device
                spec = active_profile()
        self.spec = spec
        # the session's resolution policy: which axis of the metric vector
        # resolve()/tune() optimize by default (see repro_torch.core.policy);
        # "latency" reproduces the scalar-era behavior exactly
        self.policy = get_policy(policy, spec)
        if platform is None:
            platform = spec.name
        self.db = db if db is not None else TuningDB(path=db_path,
                                                     platform=platform)
        self.platform = self.db.platform
        self.sweep_dir = sweep_dir   # journal directory for exhaustive sweeps
        self.cache_size = max(int(cache_size), 1)
        self._analytical = AnalyticalTuner()
        self._lock = threading.RLock()
        self._resolved: "OrderedDict[Tuple, Config]" = OrderedDict()
        self._suggested: Dict[str, Config] = {}
        self.hits = 0
        self.misses = 0

    # -- online path ---------------------------------------------------------

    def resolve(self, wl: Workload, *, config: Optional[Mapping[str, int]] = None,
                dims: Optional[Mapping[str, int]] = None) -> Config:
        """Launch-ready config for ``wl``: resolved, overridden, normalized."""
        wl = wl.canonical()
        ov = active_overrides(wl.op)
        cache_key = (wl.key, _dims_token(dims), self.policy.key)
        if config is None and ov is None:
            with self._lock:
                cached = self._resolved.get(cache_key)
                if cached is not None:
                    self._resolved.move_to_end(cache_key)
                    self.hits += 1
                    return dict(cached)
                self.misses += 1
        base = dict(config) if config is not None else self.resolve_raw(wl)
        if ov:
            base.update(ov)
        resolved = normalizer_for(wl.op)(base, wl, dims)
        if config is None and ov is None:
            with self._lock:
                self._resolved[cache_key] = dict(resolved)
                self._resolved.move_to_end(cache_key)
                while len(self._resolved) > self.cache_size:
                    self._resolved.popitem(last=False)
        return resolved

    def resolve_raw(self, wl: Workload) -> Config:
        """Pre-normalization config: DB hit (under the session policy),
        else memoized analytical."""
        wl = wl.canonical()
        cfg = self.db.lookup(wl, policy=self.policy.key)
        if cfg is not None:
            return cfg
        return dict(self.suggest(wl))

    def suggest(self, wl: Workload) -> Config:
        """Analytical (zero-evaluation) suggestion, memoized per workload."""
        wl = wl.canonical()
        with self._lock:
            cached = self._suggested.get(wl.key)
        if cached is not None:
            return dict(cached)
        cfg = self._analytical.suggest(build_space(wl, self.spec))
        with self._lock:
            self._suggested.setdefault(wl.key, dict(cfg))
        return cfg

    def lookup(self, wl: Workload,
               policy: Union[str, Policy, None] = None) -> Optional[Config]:
        pol = self.policy if policy is None else get_policy(policy, self.spec)
        return self.db.lookup(wl.canonical(), policy=pol.key)

    # -- offline path --------------------------------------------------------

    def tune(self, wl: Workload, method: str = "bayesian",
             objective: Optional[Objective] = None, *, seed: int = 0,
             max_evals: int = 64, store: bool = True,
             prune: Optional[str] = None, top_k: Optional[int] = None,
             policy: Union[str, Policy, None] = None) -> TuneResult:
        """Run an offline search; persist the winner; invalidate the caches.

        Exhaustive searches journal to ``self.sweep_dir`` (when set), so
        interrupted sweeps resume, and honour ``prune``/``top_k``
        (analytical-dominance pruning); other strategies ignore both.

        ``policy`` (default: the session's) decides what the search
        minimizes.  Exhaustive sweeps stay keyed by the raw objective and
        pick the winner from the Pareto front — one journal serves every
        policy; every other strategy searches through a
        :class:`~repro_torch.core.policy.PolicyObjective` wrapper.  Winners are
        stored under policy-namespaced DB keys (latency keys unchanged).
        """
        wl = wl.canonical()
        pol = self.policy if policy is None else get_policy(policy, self.spec)
        strategy = get_strategy(method)
        space = build_space(wl, self.spec)
        cached = CachedObjective(objective or CostModelObjective(self.spec))
        search_obj: Objective = cached
        if pol.name != "latency" and method != "exhaustive":
            search_obj = PolicyObjective(cached, pol)
        extra = {"journal_dir": self.sweep_dir, "prune": prune,
                 "top_k": top_k,
                 "policy": pol if pol.name != "latency" else None}
        result = strategy(space, search_obj, seed=seed, max_evals=max_evals,
                          **extra)
        if store:
            # a pruned sweep's winner is NOT a guaranteed optimum; don't
            # store it under the method name dataset_from_db trusts for
            # label-0.0 ("this is the group best") training rows
            stored_method = f"{method}-pruned" \
                if result.stopped_by == "pruned" else method
            # the winner's metric vector (a cache hit for any measured
            # winner). Under a non-latency policy result.best_time is the
            # policy scalar — the DB's time_s must stay real seconds.
            m = cached(space, result.best_config)
            time_s = result.best_time if pol.name == "latency" \
                else (m.time_s if m.valid else result.best_time)
            self.db.store(wl, result.best_config, time_s,
                          stored_method, result.evaluations,
                          metrics=dict(m.metrics) if m.valid else None,
                          policy=pol.key)
            self.invalidate(wl)
        return result

    # -- cache management ----------------------------------------------------

    def invalidate(self, wl: Workload) -> None:
        wl = wl.canonical()
        with self._lock:
            for key in [k for k in self._resolved if k[0] == wl.key]:
                del self._resolved[key]

    def clear_cache(self) -> None:
        with self._lock:
            self._resolved.clear()
            self._suggested.clear()
            self.hits = self.misses = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "resolved": len(self._resolved),
                    "suggested": len(self._suggested),
                    "db_entries": len(self.db)}


# ---------------------------------------------------------------------------
# Default (process-wide) session
# ---------------------------------------------------------------------------

_DEFAULT: Optional[TunerSession] = None
_DEFAULT_LOCK = threading.Lock()


def default_session() -> TunerSession:
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = TunerSession()
    return _DEFAULT


def set_default_session(session: Optional[TunerSession]) -> Optional[TunerSession]:
    """Swap the process-wide session; returns the previous one."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        previous, _DEFAULT = _DEFAULT, session
    return previous
