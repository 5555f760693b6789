"""Objective functions mapping (workload, config) -> a metric vector.

Mirrors the paper's measurement protocol:
  - repeated executions, median taken;
  - invalid configurations or configurations exceeding a timeout are clamped
    to a large penalty value (paper §IV-B);
  - the objective is a black box to the ML-based search.

A :class:`Measurement` carries a **metric vector** (``time_s`` always; the
cost model adds ``energy_j`` and ``peak_vmem_bytes``), with ``time_s`` the
scalar-compatible primary field.

The PyTorch port's own copy of ``repro.core.objective``, for the scan,
tridiag, FFT, SSD, RG-LRU, attention and matmul ops.  The cost-model arithmetic is the
JAX package's, verbatim, so both packages model identical times.

  * ``WallClockObjective`` — times a runner's thunk on a torch device.  On
    a CUDA device the timed region ends in ``torch.cuda.synchronize()``, so
    it measures the kernels and not the host's enqueue.  A runner that
    raises (a kernel that fails to build or launch) is counted and the
    exception propagates: a broken kernel never reads as a slow config.
  * ``CostModelObjective(profile)`` — a deterministic timing + energy model
    for one hardware profile, the offline-tuning "device".
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.core.space import Config, SearchSpace, Workload
from repro_torch.hw.profiles import (
    HardwareProfile,
    active_profile,
    dma_efficiency,
    dma_efficiency_arr,
    effective_element_bytes,
    ilp_factor,
    ilp_factor_arr,
    lane_utilization,
    lane_utilization_arr,
    sublane_utilization,
    sublane_utilization_arr,
)

PENALTY_TIME = 60.0  # seconds — the paper's 1-minute clamp

# canonical metric names (the vector axes every layer agrees on)
METRIC_TIME = "time_s"
METRIC_ENERGY = "energy_j"
METRIC_PEAK_VMEM = "peak_vmem_bytes"

# per-metric penalty clamps for invalid/failed measurements: each value is
# far beyond anything a real config can produce, so an invalid config loses
# on EVERY metric
METRIC_PENALTIES: Dict[str, float] = {
    METRIC_TIME: PENALTY_TIME,
    METRIC_ENERGY: 1e6,          # joules; worst real config is ~1e4
    METRIC_PEAK_VMEM: float(2**40),
}

# bump when the serialized Measurement layout changes
MEASUREMENT_VERSION = 1

# the serialized layout ``Measurement.to_dict`` emits, fingerprinted by
# ``repro_torch.analysis`` against MEASUREMENT_VERSION: journals, DB entries
# and traces all persist this dict, so reshaping it without a version bump
# silently corrupts every consumer's migration path
MEASUREMENT_FIELDS = ("version", "time_s", "valid", "metrics", "meta")


def metric_penalty(name: str) -> float:
    """The penalty clamp for one metric (PENALTY_TIME for unknown names)."""
    return METRIC_PENALTIES.get(name, PENALTY_TIME)


@dataclasses.dataclass
class Measurement:
    """One evaluation: a metric vector with ``time_s`` as the primary axis.

    ``time_s`` stays a plain field for scalar compatibility — everything
    that predates vector objectives keeps reading it.  ``metrics`` is the
    canonical vector; ``__post_init__`` guarantees it always contains
    ``time_s`` (mirrored from the field), so ``Measurement(t, True)`` and
    fully vector-valued constructions behave identically downstream.
    """

    time_s: float
    valid: bool
    meta: Dict[str, float] = dataclasses.field(default_factory=dict)
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        # time_s is authoritative: the metrics vector always mirrors it
        self.metrics = dict(self.metrics)
        self.metrics[METRIC_TIME] = self.time_s

    def metric(self, name: str, default: Optional[float] = None) -> Optional[float]:
        return self.metrics.get(name, default)

    @property
    def energy_j(self) -> Optional[float]:
        """Modeled/measured joules; None for time-only objectives."""
        return self.metrics.get(METRIC_ENERGY)

    @property
    def peak_vmem_bytes(self) -> Optional[float]:
        """Peak on-chip working set; None for time-only objectives."""
        return self.metrics.get(METRIC_PEAK_VMEM)

    # -- versioned serialization (journals, DB entries, traces) -------------

    def to_dict(self) -> Dict:
        return {"version": MEASUREMENT_VERSION, "time_s": self.time_s,
                "valid": self.valid, "metrics": dict(self.metrics),
                "meta": dict(self.meta)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "Measurement":
        """Inverse of ``to_dict``; version-0 dicts (no ``metrics``) load as
        time-only vectors."""
        metrics = dict(d.get("metrics") or {})
        time_s = float(d.get("time_s", metrics.get(METRIC_TIME, PENALTY_TIME)))
        return cls(time_s, bool(d.get("valid", True)),
                   meta=dict(d.get("meta") or {}), metrics=metrics)


class Objective:
    """Black-box objective: lower is better (on every metric)."""

    def __call__(self, space: SearchSpace, cfg: Config) -> Measurement:
        raise NotImplementedError

    def metric_names(self) -> Tuple[str, ...]:
        """The metric axes this objective emits; ``time_s`` always first."""
        return (METRIC_TIME,)

    def batch_eval(self, space: SearchSpace, cfgs: Sequence[Config], *,
                   assume_valid: bool = False) -> np.ndarray:
        """Evaluate a whole candidate set; returns penalty-clamped times (s).

        The default walks ``__call__`` config by config; objectives with a
        closed-form model override this with a vectorized fast path (the
        sweep engine feeds it thousands of candidates at once).
        ``assume_valid`` lets callers that enumerated the space skip the
        per-config validity re-check.
        """
        out = np.empty(len(cfgs), dtype=np.float64)
        for i, cfg in enumerate(cfgs):
            m = self(space, cfg)
            out[i] = m.time_s if m.valid else PENALTY_TIME
        return out

    def batch_eval_metrics(self, space: SearchSpace, cfgs: Sequence[Config],
                           *, assume_valid: bool = False
                           ) -> Dict[str, np.ndarray]:
        """Vector form of ``batch_eval``: one array per metric name.

        Invalid/failed configs are clamped to each metric's penalty value
        (``metric_penalty``), so they lose on every axis.  Time-only
        objectives delegate to ``batch_eval`` — subclasses that override
        only the scalar fast path keep it for free.
        """
        names = self.metric_names()
        if names == (METRIC_TIME,):
            return {METRIC_TIME: self.batch_eval(space, cfgs,
                                                 assume_valid=assume_valid)}
        cols = {n: np.empty(len(cfgs), dtype=np.float64) for n in names}
        for i, cfg in enumerate(cfgs):
            m = self(space, cfg)
            for n in names:
                cols[n][i] = (m.metric(n, metric_penalty(n)) if m.valid
                              else metric_penalty(n))
        return cols

    def signature(self) -> str:
        """Stable identity used to key sweep journals (see tuning/sweep.py).

        Two objectives with the same signature must assign the same metric
        vector to the same (workload, config); override when parameters
        change that.
        """
        return type(self).__name__


class RunnerError(RuntimeError):
    """A wall-clock runner raised: the config did not run, it was not slow."""


class WallClockObjective(Objective):
    """Times ``runner(workload, config) -> callable()`` on ``device``.

    The runner builds the launch for the config; the returned thunk is
    executed ``warmup`` times, then ``reps`` timed times, and the median is
    reported.  On a CUDA device every timed call ends in
    ``torch.cuda.synchronize()``.  Invalid configs and runs slower than
    ``timeout_s`` yield the penalty clamp (counted in ``slow``); a runner
    exception is counted in ``failures`` and re-raised as
    :class:`RunnerError`.
    """

    def __init__(self, runner: Callable[[Workload, Config], Callable[[], None]],
                 reps: int = 5, warmup: int = 1, timeout_s: float = PENALTY_TIME,
                 device: str = "cuda"):
        self.runner = runner
        self.reps = reps
        self.warmup = warmup
        self.timeout_s = timeout_s
        self.device = torch.device(device)
        self.failures = 0
        self.slow = 0

    def signature(self) -> str:
        # the runner decides what is measured: journals keyed by a bare
        # class name would happily resume another kernel's times
        runner_id = f"{getattr(self.runner, '__module__', '?')}." \
                    f"{getattr(self.runner, '__qualname__', repr(self.runner))}"
        return (f"wallclock:{runner_id}:reps={self.reps}"
                f":warmup={self.warmup}:timeout={self.timeout_s}"
                f":device={self.device.type}")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, space: SearchSpace, cfg: Config) -> Measurement:
        if not space.is_valid(cfg):
            return Measurement(PENALTY_TIME, False)
        try:
            thunk = self.runner(space.workload, cfg)
            for _ in range(self.warmup):
                thunk()
            self._sync()
            times = []
            for _ in range(self.reps):
                t0 = time.perf_counter()
                thunk()
                self._sync()
                dt = time.perf_counter() - t0
                times.append(dt)
                if dt > self.timeout_s:
                    self.slow += 1
                    return Measurement(PENALTY_TIME, False)
        except Exception as e:
            self.failures += 1
            raise RunnerError(f"runner failed on {space.workload.key} "
                              f"{cfg}: {e!r}") from e
        times.sort()
        return Measurement(times[len(times) // 2], True)


def _flops_and_passes(wl: Workload, cfg: Config) -> Dict[str, float]:
    """Operation-specific work model for the cost objective."""
    n = wl.n
    tile_n = cfg.get("tile_n", n)
    r = cfg.get("radix", 2)
    out: Dict[str, float] = {}
    def mixed(tile: int, radix: int) -> float:
        # ragged final circuit level when radix^k != tile: extra low-radix
        # step + sync (paper's WM jagged-performance observation)
        k = round(math.log(max(tile, 2), radix)) if radix > 1 else 1
        return 0.0 if radix**k == tile else 1.0

    if wl.op in ("scan", "ssd", "rglru"):
        steps = math.ceil(math.log(max(tile_n, 2), r))
        # Kogge-Stone does N work per step; Ladner-Fischer ~2N total but more
        # steps of structure; model KS-like: n ops/step, radix-r node = r-1 adds
        out["flops"] = steps * n * (r - 1) / max(r / 2, 1)
        base_passes = math.ceil(math.log(max(n, 2), r) / math.log(max(tile_n, 2), r)) if tile_n < n else 1
        fuse = cfg.get("fuse", 0)
        if wl.op == "ssd":
            # chain passes: intra + (linrec + apply, or the fused
            # state-apply launch) — fuse=1 saves one HBM pass
            out["passes"] = (3.0 - fuse) if tile_n < n else 1.0
        elif wl.op == "rglru":
            # gate link: a separate XLA pass unless folded into the scan
            # kernel's first stage (fuse=1)
            out["passes"] = base_passes + (1.0 - fuse)
        else:
            out["passes"] = base_passes
        out["steps"] = steps
        out["mixed_radix"] = mixed(tile_n, r)
    elif wl.op == "tridiag":
        steps = math.ceil(math.log2(max(n, 2))) if wl.variant in ("cr", "pcr") else math.ceil(math.log(max(n, 2), r))
        per_step = 14 if wl.variant == "pcr" else 9  # PCR full-width; CR halves
        work_n = n if wl.variant == "pcr" else 2 * n
        out["flops"] = steps * work_n * per_step / max(math.log2(r), 1)
        out["passes"] = 1
        out["steps"] = steps
        out["mixed_radix"] = mixed(tile_n, r) if wl.variant == "wm" else 0.0
    elif wl.op in ("fft", "large_fft"):
        # radix-r Stockham: log_r(N) stages, each stage ~5N flops equivalent
        stages_total = math.log(max(n, 2), r)
        out["flops"] = 5.0 * n * math.log2(max(n, 2))  # canonical 5NlogN
        s = math.log(max(tile_n, 2), r)
        out["passes"] = max(1, math.ceil(stages_total / max(s, 1)))
        out["steps"] = math.ceil(stages_total)
        # mixed-radix penalty (paper Fig 5 jagged line): if r^k != tile_n an
        # extra lower-radix step is required
        k = round(math.log(tile_n, r))
        out["mixed_radix"] = 0.0 if r ** k == tile_n else 1.0
    elif wl.op == "attention":
        head_dim = 128
        out["flops"] = 4.0 * n * head_dim  # per q-row, per kv token: 2 matmuls
        out["passes"] = 1
        out["steps"] = max(n // cfg.get("block_k", 128), 1)
    elif wl.op == "matmul":
        out["flops"] = 2.0 * n * n  # per row of M
        out["passes"] = 1
        out["steps"] = max(n // cfg.get("block_k", 128), 1)
    else:
        raise NotImplementedError(
            f"no cost model for op={wl.op!r} in the PyTorch port yet")
    out.setdefault("mixed_radix", 0.0)
    return out


def _knob(cfgs: Sequence[Config], name: str, default) -> np.ndarray:
    return np.array([c.get(name, default) for c in cfgs], dtype=np.float64)


class _KnobCols:
    """One-pass knob extraction for a homogeneous candidate set.

    Configs coming out of ``enumerate_valid`` (and journal replays of them)
    all share one key order, so the whole knob table is a single
    ``np.array`` of ``c.values()`` — the per-knob ``dict.get`` loops were
    75% of the batched evaluation cost. Heterogeneous sets fall back to the
    per-knob path transparently.
    """

    def __init__(self, cfgs: Sequence[Config]):
        import itertools
        import operator

        self.cfgs = cfgs
        self.cols: Dict[str, np.ndarray] = {}
        if not cfgs:
            return
        names = tuple(cfgs[0].keys())
        k = len(names)
        if k < 2:
            return
        # itemgetter extracts BY NAME, so differing key orders cannot be
        # mis-columned; a config missing a knob raises KeyError (fall back
        # to per-knob gets), and the length sum rules out extra knobs that
        # the table would otherwise silently answer with defaults
        if sum(map(len, cfgs)) != len(cfgs) * k:
            return
        getter = operator.itemgetter(*names)
        try:
            mat = np.fromiter(
                itertools.chain.from_iterable(map(getter, cfgs)),
                dtype=np.float64, count=len(cfgs) * k).reshape(len(cfgs), k)
        except KeyError:
            return
        self.cols = {nm: mat[:, j] for j, nm in enumerate(names)}

    def get(self, name: str, default) -> np.ndarray:
        col = self.cols.get(name)
        if col is not None:
            return col
        if self.cols:   # homogeneous set without this knob: broadcast default
            return np.full(len(self.cfgs), float(default))
        return _knob(self.cfgs, name, default)


def _mixed_radix_arr(tile: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Vectorized mixed() from _flops_and_passes: 1.0 when radix^k != tile."""
    k = np.where(r > 1,
                 np.rint(np.log(np.maximum(tile, 2)) / np.log(np.maximum(r, 2))),
                 1.0)
    return np.where(np.power(r, k) == tile, 0.0, 1.0)


def _batch_work(wl: Workload, cfgs: Sequence[Config],
                cols: Optional[_KnobCols] = None) -> Dict[str, np.ndarray]:
    """Vectorized `_flops_and_passes`: arrays over the candidate axis.

    Element-for-element identical to the scalar model (same formulas, same
    double-precision ops), so batched sweeps and per-config evaluation
    produce the same times.
    """
    cols = cols or _KnobCols(cfgs)
    n = wl.n
    tile_n = cols.get("tile_n", n)
    r = cols.get("radix", 2)
    out: Dict[str, np.ndarray] = {}
    ones = np.ones(len(cfgs), dtype=np.float64)

    if wl.op in ("scan", "ssd", "rglru"):
        log_r = np.log(np.maximum(r, 2))
        log_tile = np.log(np.maximum(tile_n, 2))
        steps = np.ceil(log_tile / log_r)
        out["flops"] = steps * n * (r - 1) / np.maximum(r / 2, 1)
        base_passes = np.where(
            tile_n < n,
            np.ceil(np.log(max(n, 2)) / log_r / (log_tile / log_r)), 1.0)
        fuse = cols.get("fuse", 0)
        if wl.op == "ssd":
            out["passes"] = np.where(tile_n < n, 3.0 - fuse, 1.0)
        elif wl.op == "rglru":
            out["passes"] = base_passes + (1.0 - fuse)
        else:
            out["passes"] = base_passes
        out["steps"] = steps
        out["mixed_radix"] = _mixed_radix_arr(tile_n, r)
    elif wl.op == "tridiag":
        if wl.variant in ("cr", "pcr"):
            steps = float(math.ceil(math.log2(max(n, 2)))) * ones
        else:
            steps = np.ceil(np.log(max(n, 2)) / np.log(np.maximum(r, 2)))
        per_step = 14 if wl.variant == "pcr" else 9
        work_n = n if wl.variant == "pcr" else 2 * n
        out["flops"] = steps * work_n * per_step / np.maximum(np.log2(r), 1)
        out["passes"] = ones.copy()
        out["steps"] = steps
        out["mixed_radix"] = (_mixed_radix_arr(tile_n, r)
                              if wl.variant == "wm" else 0.0 * ones)
    elif wl.op in ("fft", "large_fft"):
        log_r = np.log(np.maximum(r, 2))
        stages_total = np.log(max(n, 2)) / log_r
        out["flops"] = 5.0 * n * math.log2(max(n, 2)) * ones
        s = np.log(np.maximum(tile_n, 2)) / log_r
        out["passes"] = np.maximum(1, np.ceil(stages_total / np.maximum(s, 1)))
        out["steps"] = np.ceil(stages_total)
        k = np.rint(np.log(tile_n) / np.log(r))
        out["mixed_radix"] = np.where(np.power(r, k) == tile_n, 0.0, 1.0)
    elif wl.op == "attention":
        head_dim = 128
        out["flops"] = 4.0 * n * head_dim * ones
        out["passes"] = ones.copy()
        out["steps"] = np.maximum(np.floor(n / cols.get("block_k", 128)), 1)
    elif wl.op == "matmul":
        out["flops"] = 2.0 * n * n * ones
        out["passes"] = ones.copy()
        out["steps"] = np.maximum(np.floor(n / cols.get("block_k", 128)), 1)
    else:
        raise NotImplementedError(
            f"no cost model for op={wl.op!r} in the PyTorch port yet")
    out.setdefault("mixed_radix", 0.0 * ones)
    return out


class CostModelObjective(Objective):
    """Deterministic timing model for a hardware profile (+ optional jitter).

    t = passes * [ launch + max(t_compute, t_memory)/overlap + steps*sync ]

    with: t_memory from bytes moved through the DMA ramp; t_compute from
    vector-unit issue with lane/sublane utilization and ILP factors (matrix
    unit for matmul/attention); overlap in (0.5,1] grows with grid depth
    (needs >=2 programs in flight to double-buffer). Every architectural
    constant comes from the :class:`~repro_torch.hw.profiles.HardwareProfile`, so
    the same model retargets by swapping the profile — the paper's
    portability mechanism. Under ``tpu_v5e`` the latency arithmetic is
    bit-identical to the historical ``TPUCostModelObjective``.

    Beyond ``time_s`` the model emits two more metric axes from the same
    intermediates:

    * ``energy_j``  — ``idle_w * t + peak_compute_w * t_comp
      + hbm_pj_per_byte * 1e-12 * bytes`` (static draw for the kernel's
      duration, dynamic draw while compute units are busy, per-byte memory
      access energy).  Energy is derived *from* the latency terms, never
      fed back into them.
    * ``peak_vmem_bytes`` — the double-buffered block working set.
    """

    def __init__(self, profile: Optional[HardwareProfile] = None,
                 noise: float = 0.0):
        self.spec = profile if profile is not None else active_profile()
        self.noise = noise

    @property
    def profile(self) -> HardwareProfile:
        """Canonical name for the hardware profile (``spec`` predates it)."""
        return self.spec

    def metric_names(self) -> Tuple[str, ...]:
        return (METRIC_TIME, METRIC_ENERGY, METRIC_PEAK_VMEM)

    def _jitter(self, wl: Workload, cfg: Config) -> float:
        if not self.noise:
            return 1.0
        key = f"{wl.key}|{sorted(cfg.items())}".encode()
        h = int.from_bytes(hashlib.sha256(key).digest()[:8], "big")
        u = (h / 2**64) * 2.0 - 1.0  # [-1, 1)
        return 1.0 + self.noise * u

    def __call__(self, space: SearchSpace, cfg: Config) -> Measurement:
        if not space.is_valid(cfg):
            return Measurement(PENALTY_TIME, False)
        wl, spec = space.workload, self.spec
        # tridiag: 4 coefficients per equation; fft: interleaved complex
        eb = effective_element_bytes(wl.op, wl.dtype)

        work = _flops_and_passes(wl, cfg)
        batch = max(wl.batch, 1)
        rows = cfg.get("rows_per_program", 1)
        tile_n = cfg.get("tile_n", wl.n)

        if wl.op == "attention":
            block_q, block_k = cfg["block_q"], cfg["block_k"]
            grid = max(batch, 1) * max(wl.n // block_q, 1)
            block_bytes = (block_q + 2 * block_k) * 128 * eb
            total_bytes = batch * wl.n * 128 * eb * 3
            total_flops = batch * wl.n * work["flops"]
            trailing = block_k
        elif wl.op == "matmul":
            bm, bn, bk = cfg["block_m"], cfg["block_n"], cfg["block_k"]
            grid = max(batch // bm, 1) * max(wl.n // bn, 1)
            block_bytes = (bm * bk + bk * bn) * eb
            total_bytes = (batch * wl.n + wl.n * wl.n) * eb
            total_flops = batch * work["flops"]
            trailing = bn
        else:
            grid = max(batch // rows, 1) * max(wl.n // tile_n, 1)
            block_bytes = rows * tile_n * eb
            total_bytes = 2.0 * batch * wl.n * eb * work["passes"]
            total_flops = batch * work["flops"]
            trailing = min(tile_n, spec.lane_count * 8) if not cfg.get("in_register") else tile_n

        # --- memory term ---
        t_mem = total_bytes / (spec.hbm_bandwidth * dma_efficiency(int(block_bytes), spec))
        # --- compute term (VPU for prefix ops; MXU for matmul/attention) ---
        if wl.op in ("matmul", "attention"):
            peak = spec.peak_bf16_flops if wl.dtype == "bfloat16" else spec.peak_f32_flops
            mxu_util = min(trailing / spec.mxu_dim, 1.0)
            t_comp = total_flops / (peak * max(mxu_util, 1e-3))
        else:
            util = lane_utilization(trailing, spec)
            sub = sublane_utilization(rows * max(tile_n // spec.lane_count, 1), spec)
            eff = max(util * max(sub, 0.25)
                      * ilp_factor(cfg.get("unroll", 1), spec), 1e-3)
            t_comp = total_flops / (spec.peak_vpu_flops * eff)
            if cfg.get("in_register"):
                t_comp *= 0.8   # no scratch roundtrip between steps
            else:
                t_comp *= 1.0 + 0.05 * work["steps"]  # scratch traffic per step

        # --- overlap: need >=2 programs in flight (occupancy premise) ---
        overlap = 1.0 if grid >= 4 else (0.85 if grid >= 2 else 0.55)
        t_body = max(t_comp, t_mem) / overlap + (1.0 - overlap) * min(t_comp, t_mem) * 0.1
        passes = work["passes"]
        t = passes * (spec.kernel_launch_s + t_body / passes + work["steps"] / passes * spec.pass_sync_s)
        t *= 1.0 + 0.25 * work.get("mixed_radix", 0.0)
        t *= self._jitter(wl, cfg)
        # energy/memory axes, derived from the latency intermediates (the
        # latency value above is already final — nothing below feeds back)
        energy = (spec.idle_w * t + spec.peak_compute_w * t_comp
                  + spec.hbm_pj_per_byte * 1e-12 * total_bytes)
        peak_vmem = 2.0 * block_bytes   # double-buffered working set
        return Measurement(
            t, True,
            meta={"t_comp": t_comp, "t_mem": t_mem, "grid": grid,
                  "passes": passes, "flops": total_flops, "bytes": total_bytes},
            metrics={METRIC_ENERGY: energy, METRIC_PEAK_VMEM: peak_vmem},
        )

    def signature(self) -> str:
        # the historical "tpu_cost:tpu_v5e:..." form is kept for tpu_v5e so
        # pre-profile sweep journals stay resumable; other profiles get
        # their own namespace — a journal measured on one profile can never
        # satisfy the signature check under another
        prefix = "tpu_cost" if self.spec.name == "tpu_v5e" else "cost"
        return f"{prefix}:{self.spec.name}:noise={self.noise}"

    def batch_eval(self, space: SearchSpace, cfgs: Sequence[Config], *,
                   assume_valid: bool = False) -> np.ndarray:
        """Vectorized fast path: the time column of ``batch_eval_metrics``."""
        return self.batch_eval_metrics(space, cfgs,
                                       assume_valid=assume_valid)[METRIC_TIME]

    def batch_eval_metrics(self, space: SearchSpace, cfgs: Sequence[Config],
                           *, assume_valid: bool = False
                           ) -> Dict[str, np.ndarray]:
        """Vectorized fast path: the whole candidate set in array ops.

        Mirrors ``__call__`` branch for branch; the only per-config Python
        left is knob extraction (and the sha256 jitter when noise is on).
        The time column is computed first and independently — the energy
        and memory columns are derived afterwards, so the latency numbers
        are bit-identical to the pre-vector implementation.
        """
        if not len(cfgs):
            return {n: np.empty(0, dtype=np.float64)
                    for n in self.metric_names()}
        wl, spec = space.workload, self.spec
        eb = effective_element_bytes(wl.op, wl.dtype)
        cols = _KnobCols(cfgs)
        work = _batch_work(wl, cfgs, cols)
        batch = max(wl.batch, 1)
        rows = cols.get("rows_per_program", 1)
        tile_n = cols.get("tile_n", wl.n)
        in_reg = cols.get("in_register", 0)

        if wl.op == "attention":
            block_q = cols.get("block_q", 128)
            block_k = cols.get("block_k", 128)
            grid = max(batch, 1) * np.maximum(np.floor(wl.n / block_q), 1)
            block_bytes = (block_q + 2 * block_k) * 128 * eb
            total_bytes = batch * wl.n * 128 * eb * 3.0 + 0.0 * grid
            total_flops = batch * wl.n * work["flops"]
            trailing = block_k
        elif wl.op == "matmul":
            bm = cols.get("block_m", 128)
            bn = cols.get("block_n", 128)
            bk = cols.get("block_k", 128)
            grid = np.maximum(np.floor(batch / bm), 1) \
                * np.maximum(np.floor(wl.n / bn), 1)
            block_bytes = (bm * bk + bk * bn) * eb
            total_bytes = (batch * wl.n + wl.n * wl.n) * eb + 0.0 * grid
            total_flops = batch * work["flops"]
            trailing = bn
        else:
            grid = np.maximum(np.floor(batch / rows), 1) \
                * np.maximum(np.floor(wl.n / tile_n), 1)
            block_bytes = rows * tile_n * eb
            total_bytes = 2.0 * batch * wl.n * eb * work["passes"]
            total_flops = batch * work["flops"]
            trailing = np.where(in_reg, tile_n,
                                np.minimum(tile_n, spec.lane_count * 8))

        with np.errstate(all="ignore"):
            t_mem = total_bytes / (spec.hbm_bandwidth
                                   * dma_efficiency_arr(block_bytes, spec))
            if wl.op in ("matmul", "attention"):
                peak = spec.peak_bf16_flops if wl.dtype == "bfloat16" \
                    else spec.peak_f32_flops
                mxu_util = np.minimum(trailing / spec.mxu_dim, 1.0)
                t_comp = total_flops / (peak * np.maximum(mxu_util, 1e-3))
            else:
                util = lane_utilization_arr(trailing, spec)
                sub = sublane_utilization_arr(
                    rows * np.maximum(np.floor(tile_n / spec.lane_count), 1),
                    spec)
                eff = np.maximum(util * np.maximum(sub, 0.25)
                                 * ilp_factor_arr(cols.get("unroll", 1), spec),
                                 1e-3)
                t_comp = total_flops / (spec.peak_vpu_flops * eff)
                t_comp = np.where(in_reg, t_comp * 0.8,
                                  t_comp * (1.0 + 0.05 * work["steps"]))

            overlap = np.where(grid >= 4, 1.0, np.where(grid >= 2, 0.85, 0.55))
            t_body = np.maximum(t_comp, t_mem) / overlap \
                + (1.0 - overlap) * np.minimum(t_comp, t_mem) * 0.1
            passes = work["passes"]
            t = passes * (spec.kernel_launch_s + t_body / passes
                          + work["steps"] / passes * spec.pass_sync_s)
            t = t * (1.0 + 0.25 * work["mixed_radix"])
            if self.noise:
                t = t * np.array([self._jitter(wl, c) for c in cfgs])
            # derived metric columns — same expressions as the scalar path,
            # computed after (and never feeding into) the time column
            energy = (spec.idle_w * t + spec.peak_compute_w * t_comp
                      + spec.hbm_pj_per_byte * 1e-12 * total_bytes)
            peak_vmem = 2.0 * block_bytes * np.ones_like(t)

        t = np.nan_to_num(t, nan=PENALTY_TIME, posinf=PENALTY_TIME,
                          neginf=PENALTY_TIME)
        if not assume_valid:
            valid = np.fromiter((space.is_valid(c) for c in cfgs),
                                dtype=bool, count=len(cfgs))
            t = np.where(valid, t, PENALTY_TIME)
        # the exact penalty clamp marks a failed/invalid row (the batched
        # protocol's convention); such rows lose on every metric axis
        pen_e, pen_v = metric_penalty(METRIC_ENERGY), metric_penalty(METRIC_PEAK_VMEM)
        bad = t == PENALTY_TIME
        energy = np.nan_to_num(energy, nan=pen_e, posinf=pen_e, neginf=pen_e)
        return {METRIC_TIME: t,
                METRIC_ENERGY: np.where(bad, pen_e, energy),
                METRIC_PEAK_VMEM: np.where(bad, pen_v, peak_vmem)}


class CachedObjective(Objective):
    """Memoizes measurements — searches may revisit configs."""

    def __init__(self, inner: Objective):
        self.inner = inner
        self.cache: Dict[str, Measurement] = {}
        self.evaluations = 0   # counts *unique* real evaluations (paper Fig 4)

    @property
    def spec(self) -> Optional[HardwareProfile]:
        """The inner objective's hardware profile, when it models one
        (journal headers record it; wallclock objectives have none)."""
        return getattr(self.inner, "spec", None)

    def __call__(self, space: SearchSpace, cfg: Config) -> Measurement:
        key = f"{space.workload.key}|{tuple(sorted(cfg.items()))}"
        if key not in self.cache:
            self.cache[key] = self.inner(space, cfg)
            self.evaluations += 1
        return self.cache[key]

    def signature(self) -> str:
        return self.inner.signature()

    def metric_names(self) -> Tuple[str, ...]:
        return self.inner.metric_names()

    def seed(self, space: SearchSpace, history: Sequence[tuple],
             metrics: Optional[Sequence[Mapping[str, float]]] = None) -> None:
        """Pre-load (config, time) pairs as cached measurements.

        Used by consumers that obtained times outside this cache — e.g. a
        journal-resumed sweep — and need later scalar calls to answer from
        those exact numbers instead of re-measuring (`evaluations` is not
        incremented; nothing fresh was run).  ``metrics``, when given, is a
        parallel sequence of metric vectors (journal version 3 records
        them); without it the seeded entries are time-only vectors.
        """
        wl_key = space.workload.key
        for i, (cfg, t) in enumerate(history):
            key = f"{wl_key}|{tuple(sorted(cfg.items()))}"
            if key not in self.cache:
                t = float(t)
                vec = dict(metrics[i]) if metrics is not None else {}
                self.cache[key] = Measurement(t, t != PENALTY_TIME,
                                              metrics=vec)

    def batch_eval(self, space: SearchSpace, cfgs: Sequence[Config], *,
                   assume_valid: bool = False) -> np.ndarray:
        wl_key = space.workload.key
        keys = [f"{wl_key}|{tuple(sorted(c.items()))}" for c in cfgs]
        fresh = [i for i, k in enumerate(keys) if k not in self.cache]
        if fresh:
            times = self.inner.batch_eval(
                space, [cfgs[i] for i in fresh], assume_valid=assume_valid)
            for i, t in zip(fresh, times):
                t = float(t)
                # in the times-array protocol the exact penalty clamp marks
                # a failed/invalid measurement (batch_eval never clamps a
                # valid config — a genuinely valid one may model slower than
                # 60 s and must stay valid). assume_valid skips the SPACE
                # validity re-check only; it cannot vouch for measurement
                # validity (wallclock timeouts, OOM penalties).
                self.cache[keys[i]] = Measurement(t, t != PENALTY_TIME)
            self.evaluations += len(fresh)
        out = np.empty(len(cfgs), dtype=np.float64)
        for i, k in enumerate(keys):
            m = self.cache[k]
            out[i] = m.time_s if m.valid else PENALTY_TIME
        return out

    def batch_eval_metrics(self, space: SearchSpace, cfgs: Sequence[Config],
                           *, assume_valid: bool = False
                           ) -> Dict[str, np.ndarray]:
        names = self.metric_names()
        wl_key = space.workload.key
        keys = [f"{wl_key}|{tuple(sorted(c.items()))}" for c in cfgs]
        # a cached VALID entry missing a requested metric (seeded from a
        # pre-vector journal, or cached through the times-only protocol)
        # is re-run to fill the vector — but its cached time stays
        # authoritative, so seeded sweep times are never re-measured away
        missing = []
        for i, k in enumerate(keys):
            m = self.cache.get(k)
            if m is None or (m.valid
                             and any(n not in m.metrics for n in names)):
                missing.append(i)
        if missing:
            cols = self.inner.batch_eval_metrics(
                space, [cfgs[i] for i in missing], assume_valid=assume_valid)
            for j, i in enumerate(missing):
                t = float(cols[METRIC_TIME][j])
                vec = {n: float(cols[n][j]) for n in names}
                prev = self.cache.get(keys[i])
                if prev is None:
                    self.cache[keys[i]] = Measurement(t, t != PENALTY_TIME,
                                                      metrics=vec)
                    self.evaluations += 1
                else:   # upgrade: keep the seeded time, adopt fresh metrics
                    vec.update(prev.metrics)
                    self.cache[keys[i]] = Measurement(prev.time_s, prev.valid,
                                                      meta=prev.meta,
                                                      metrics=vec)
        out = {n: np.empty(len(cfgs), dtype=np.float64) for n in names}
        for i, k in enumerate(keys):
            m = self.cache[k]
            for n in names:
                out[n][i] = (m.metric(n, metric_penalty(n)) if m.valid
                             else metric_penalty(n))
        return out
