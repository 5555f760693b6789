"""Synthetic multi-tenant serving traces (seeded, reproducible).

The serving benchmark's load generator: a handful of tenant classes with
different prompt/output length profiles and Poisson arrival rates, drawn
from one seeded ``numpy`` Generator so the same seed always produces the
same request stream — the determinism contract every gated benchmark in
this repo follows.

A trace is a flat list of :class:`TraceRequest` ordered by arrival tick.
``chip_smoke.py``'s ``[serve]`` phase replays the same trace through the
:class:`~repro_torch.serve.engine.ServeEngine` and the
:class:`~repro_torch.serve.reference.ReferenceEngine`.

The PyTorch port's own copy of ``repro.serve.trace`` (numpy only, the
same draws for the same seed).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant class: arrival rate + prompt/output length ranges."""

    name: str
    rate: float                    # mean arrivals per tick (Poisson)
    prompt_len: Tuple[int, int]    # inclusive [lo, hi]
    max_new: Tuple[int, int]       # inclusive [lo, hi]

    def __post_init__(self):
        if self.rate < 0:
            raise ValueError(f"rate must be >= 0, got {self.rate}")
        for lo, hi in (self.prompt_len, self.max_new):
            if not 1 <= lo <= hi:
                raise ValueError(
                    f"bad range [{lo}, {hi}] for tenant {self.name!r}")


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One request of a synthetic trace, in arrival order."""

    tenant: str
    arrival: int                   # tick the request arrives at
    prompt: np.ndarray             # (len,) int32
    max_new_tokens: int


def default_tenants() -> List[TenantSpec]:
    """The benchmark's mixed workload: chatty interactive traffic, a
    prompt-heavy analytics tenant, and a trickle of background jobs."""
    return [
        TenantSpec("interactive", rate=0.6, prompt_len=(6, 16),
                   max_new=(6, 12)),
        TenantSpec("analytics", rate=0.4, prompt_len=(40, 64),
                   max_new=(4, 8)),
        TenantSpec("background", rate=0.2, prompt_len=(20, 32),
                   max_new=(2, 4)),
    ]


def synthetic_trace(tenants: Sequence[TenantSpec], *, horizon: int,
                    vocab: int, seed: int = 0) -> List[TraceRequest]:
    """Draw a multi-tenant request stream over ``horizon`` arrival ticks.

    Per tick, each tenant contributes ``Poisson(rate)`` requests with
    prompt tokens uniform over ``[0, vocab)`` and lengths uniform over
    the tenant's ranges.  Fully determined by ``seed``.
    """
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    if vocab < 1:
        raise ValueError(f"vocab must be >= 1, got {vocab}")
    rng = np.random.default_rng(seed)
    out: List[TraceRequest] = []
    for tick in range(horizon):
        for spec in tenants:
            for _ in range(int(rng.poisson(spec.rate))):
                plen = int(rng.integers(spec.prompt_len[0],
                                        spec.prompt_len[1] + 1))
                new = int(rng.integers(spec.max_new[0],
                                       spec.max_new[1] + 1))
                prompt = rng.integers(0, vocab, size=plen,
                                      dtype=np.int64).astype(np.int32)
                out.append(TraceRequest(spec.name, tick, prompt, new))
    return out


def trace_summary(trace: Sequence[TraceRequest]) -> dict:
    """Aggregate shape of a trace (benchmark reporting rows)."""
    if not trace:
        return {"requests": 0, "prompt_tokens": 0, "decode_tokens": 0}
    return {
        "requests": len(trace),
        "prompt_tokens": int(sum(len(r.prompt) for r in trace)),
        "decode_tokens": int(sum(r.max_new_tokens for r in trace)),
        "tenants": sorted({r.tenant for r in trace}),
    }
