"""repro_torch.tuning — the public API for every tuned kernel of the port.

Offline -> online lifecycle, as in the JAX package:

    session = TunerSession(db_path="artifacts/tuning_db_torch.json")
    session.tune(wl, method="bayesian")       # offline: populate the DB
    cfg = session.resolve(wl)                 # online: cached, normalized

    with overrides(scan={"radix": 4}):        # scoped experiments
        prefix_sum(x)

    tuner = OnlineTuner(wl, session)          # in traffic: trials, rollback
    attach(engine, tuner)                     # on a repro_torch.serve engine
"""
from __future__ import annotations

from repro_torch.core.bayesian import TuneResult
from repro_torch.core.space import Config, Workload, build_space
from repro_torch.tuning.db import DEFAULT_DB_PATH, SCHEMA_VERSION, TuningDB
from repro_torch.tuning.dispatch import kernel_path, resolve_device
from repro_torch.tuning.overrides import active_overrides, overrides
from repro_torch.tuning.registry import (KernelSpec, normalizer_for,
                                         tuned_kernel)
from repro_torch.tuning.session import (TunerSession, default_session,
                                        get_strategy,
                                        set_default_session, strategies)
from repro_torch.tuning.sweep import SweepJournal, SweepResult, run_sweep

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


__all__ = [
    "Config", "DEFAULT_DB_PATH", "KernelSpec", "SCHEMA_VERSION",
    "SweepJournal", "SweepResult", "TuneResult", "TunerSession", "TuningDB",
    "Workload", "active_overrides", "build_space", "default_session",
    "get_strategy", "kernel_path", "normalizer_for",
    "overrides", "resolve_device", "run_sweep",
    "set_default_session", "strategies", "tuned_kernel",
    *sorted(_ONLINE_EXPORTS),
]
