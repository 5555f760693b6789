"""repro_torch.tuning — the public API for every tuned kernel of the port.

Offline -> online lifecycle, as in the JAX package:

    session = TunerSession(db_path="artifacts/tuning_db_torch.json")
    session.tune(wl, method="bayesian")       # offline: populate the DB
    cfg = session.resolve(wl)                 # online: cached, normalized

    with overrides(scan={"radix": 4}):        # scoped experiments
        prefix_sum(x)
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

__all__ = [
    "Config", "DEFAULT_DB_PATH", "KernelSpec", "SCHEMA_VERSION",
    "SweepJournal", "SweepResult", "TuneResult", "TunerSession", "TuningDB",
    "Workload", "active_overrides", "build_space", "default_session",
    "get_strategy", "kernel_path", "normalizer_for",
    "overrides", "resolve_device", "run_sweep",
    "set_default_session", "strategies", "tuned_kernel",
]
