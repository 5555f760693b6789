"""repro_torch.tuning — the public API for every tuned kernel of the port.

Offline -> online lifecycle, as in the JAX package:

    session = TunerSession(db_path="artifacts/tuning_db_torch.json")
    session.tune(wl, method="bayesian")       # offline: populate the DB
    cfg = session.resolve(wl)                 # online: cached, normalized

    TunerSession(policy="energy")             # resolve/tune under a policy
    session.tune(wl, method="transfer")       # warm start from other devices

    with overrides(scan={"radix": 4}):        # scoped experiments
        prefix_sum(x)

    tuner = OnlineTuner(wl, session)          # in traffic: trials, rollback
    attach(engine, tuner)                     # on a repro_torch.serve engine

Kernel families declare themselves once via ``@tuned_kernel`` (search
space, kernel wrapper, reference impl, config normalizer); the session is
the only component that turns a Workload into launch kwargs.

Module-level ``resolve``/``tune``/``suggest`` delegate to the process-wide
default session.
"""
from __future__ import annotations

from typing import Mapping, Optional

from repro_torch.core.bayesian import TuneResult
from repro_torch.core.policy import (Policy, PolicyObjective, get_policy,
                                     pareto_front, policies,
                                     policy_scalar_cols)
from repro_torch.core.space import (Config, Workload, build_space, fit_block,
                                    normalize_config)
from repro_torch.tuning.db import DEFAULT_DB_PATH, SCHEMA_VERSION, TuningDB
from repro_torch.tuning.dispatch import kernel_path, resolve_device
from repro_torch.tuning.overrides import (active_overrides, overrides,
                                          overrides_active)
from repro_torch.tuning.registry import (KernelSpec, get_kernel,
                                         normalizer_for, registered_kernels,
                                         tuned_kernel)
from repro_torch.tuning.session import (TunerSession, default_session,
                                        get_strategy, register_strategy,
                                        set_default_session, strategies)
from repro_torch.tuning.sweep import (SweepJournal, SweepResult, config_key,
                                      journal_path, prune_candidates,
                                      run_sweep)

# The online-tuning stack (repro_torch.tuning.online) loads on first use,
# as in the JAX package: PEP 562 keeps `from repro_torch.tuning import
# OnlineTuner` working while importing this package (as every kernel entry
# point and the serve engine do) does not import it.
_ONLINE_EXPORTS = frozenset((
    "OnlineTuner", "OnlineWallClockObjective", "ReplayTrace", "StepTimer",
    "TraceRecorder", "aggregate_fleet", "attach", "fleet_prior",
    "measurements_to_incumbent", "online_search", "promote_fleet_winner",
    "replay", "replay_candidates", "warm_tuner"))


def __getattr__(name: str):
    if name in _ONLINE_EXPORTS:
        from repro_torch.tuning import online
        return getattr(online, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def resolve(wl: Workload, *, config: Optional[Mapping[str, int]] = None,
            dims: Optional[Mapping[str, int]] = None) -> Config:
    """Resolve a launch-ready config through the default session."""
    return default_session().resolve(wl, config=config, dims=dims)


def tune(wl: Workload, method: str = "bayesian", **kw) -> TuneResult:
    """Offline-tune through the default session (persists the winner)."""
    return default_session().tune(wl, method=method, **kw)


def suggest(wl: Workload) -> Config:
    """Zero-evaluation analytical suggestion via the default session."""
    return default_session().suggest(wl)


__all__ = [
    "Config", "DEFAULT_DB_PATH", "KernelSpec", "Policy", "PolicyObjective",
    "SCHEMA_VERSION", "SweepJournal", "SweepResult", "TuneResult",
    "TunerSession", "TuningDB", "Workload", "active_overrides",
    "build_space", "config_key", "default_session", "fit_block",
    "get_kernel", "get_policy", "get_strategy", "journal_path",
    "kernel_path", "normalize_config", "normalizer_for", "overrides",
    "overrides_active", "pareto_front", "policies", "policy_scalar_cols",
    "prune_candidates", "register_strategy", "registered_kernels",
    "resolve", "resolve_device", "run_sweep", "set_default_session",
    "strategies", "suggest", "tune", "tuned_kernel",
    *sorted(_ONLINE_EXPORTS),
]
