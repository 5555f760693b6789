"""Policies — how a session turns a metric vector into "better".

Vector objectives (``repro_torch.core.objective``) answer *what happened*:
``time_s``, ``energy_j``, ``peak_vmem_bytes`` per config.  A
:class:`Policy` answers *what to optimize*: it scalarizes the vector into
the lower-is-better number every search strategy, journal consumer, and
DB ranking already speaks.  Four policies ship (the embedded-deployment
axes from the paper's setting):

* ``latency``    — minimize ``time_s`` (the historical behavior, and the
  default everywhere: with it, nothing in the stack changes numerically);
* ``energy``     — minimize ``energy_j`` (modeled joules; falls back to
  ``time_s`` for objectives that emit no energy axis, e.g. wallclock);
* ``edp``        — minimize the energy-delay product ``energy_j * time_s``
  (the classic balanced metric for embedded parts);
* ``memory_cap`` — minimize ``time_s`` subject to
  ``peak_vmem_bytes <= cap`` (over-cap configs are penalty-clamped; the
  cap defaults to the profile's ``vmem_budget``).

:class:`PolicyObjective` adapts any vector objective to the scalar
protocol under a policy, so Bayesian/random/ML/online searches tune for
energy without knowing energy exists.  ``pareto_front`` computes the
non-dominated set over metric columns — the sweep engine journals one
front per (workload, objective) and every policy picks its winner from
the same measurements (see ``repro_torch.tuning.sweep``).

The PyTorch port's own copy of ``repro.core.policy``: the scalars, the
Pareto front and the keys are the same numpy arithmetic, so both packages
pick the same winner under the same policy and key it the same way.  A
bare ``memory_cap`` takes the active profile's ``vmem_budget`` — ``h100``
in the port — so callers comparing the packages pass the profile.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.objective import (METRIC_ENERGY, METRIC_PEAK_VMEM,
                                        METRIC_TIME, Measurement, Objective,
                                        PENALTY_TIME, metric_penalty)
from repro_torch.core.space import Config, SearchSpace
from repro_torch.hw.profiles import HardwareProfile, active_profile

POLICY_NAMES = ("latency", "energy", "edp", "memory_cap")


@dataclasses.dataclass(frozen=True)
class Policy:
    """One scalarization of the metric vector; frozen, hashable, keyable."""

    name: str                       # one of POLICY_NAMES
    cap_bytes: Optional[float] = None   # memory_cap's budget, else None

    @property
    def key(self) -> str:
        """Stable identity for DB keys and journal/objective signatures."""
        if self.name == "memory_cap" and self.cap_bytes is not None:
            return f"memory_cap[{int(self.cap_bytes)}]"
        return self.name

    @property
    def prune_safe(self) -> bool:
        """Whether analytical-dominance pruning may precede this policy.

        The pruning model ranks candidates by *latency*; keeping its top-k
        and then optimizing a different axis would silently search the
        wrong subset.  Only ``latency`` itself is safe.
        """
        return self.name == "latency"

    # -- scalarization -------------------------------------------------------
    # Scalar and column forms mirror each other element-for-element (same
    # double-precision expressions), so per-config and batched policy
    # evaluation agree to floating-point identity — the same contract the
    # objectives keep between __call__ and batch_eval.

    def scalarize(self, metrics: Mapping[str, float]) -> float:
        """Lower-is-better scalar for one metric vector.

        Missing axes fall back to ``time_s`` (a time-only measurement under
        the ``energy`` policy ranks by time); an over-cap ``memory_cap``
        vector returns ``inf`` — callers clamp non-finite scalars to the
        penalty (see :class:`PolicyObjective`).
        """
        t = float(metrics[METRIC_TIME])
        if self.name == "latency":
            return t
        if self.name == "energy":
            return self._axis(metrics, METRIC_ENERGY, t)
        if self.name == "edp":
            return t * self._axis(metrics, METRIC_ENERGY, t)
        if self.name == "memory_cap":
            vmem = self._axis(metrics, METRIC_PEAK_VMEM, 0.0)
            cap = self.cap_bytes if self.cap_bytes is not None else math.inf
            return t if vmem <= cap else math.inf
        raise ValueError(f"unknown policy {self.name!r}")

    def scalarize_cols(self, cols: Mapping[str, np.ndarray]) -> np.ndarray:
        """Column form of ``scalarize`` (NaN axes fall back per-row)."""
        t = np.asarray(cols[METRIC_TIME], dtype=np.float64)
        if self.name == "latency":
            return t
        if self.name == "energy":
            return self._axis_col(cols, METRIC_ENERGY, t)
        if self.name == "edp":
            return t * self._axis_col(cols, METRIC_ENERGY, t)
        if self.name == "memory_cap":
            vmem = self._axis_col(cols, METRIC_PEAK_VMEM, np.zeros_like(t))
            cap = self.cap_bytes if self.cap_bytes is not None else math.inf
            return np.where(vmem <= cap, t, np.inf)
        raise ValueError(f"unknown policy {self.name!r}")

    @staticmethod
    def _axis(metrics: Mapping[str, float], name: str, fallback: float) -> float:
        v = metrics.get(name)
        return fallback if v is None or (isinstance(v, float) and math.isnan(v)) \
            else float(v)

    @staticmethod
    def _axis_col(cols: Mapping[str, np.ndarray], name: str,
                  fallback: np.ndarray) -> np.ndarray:
        v = cols.get(name)
        if v is None:
            return fallback
        v = np.asarray(v, dtype=np.float64)
        return np.where(np.isnan(v), fallback, v)


def get_policy(policy: Union[str, Policy, None],
               profile: Optional[HardwareProfile] = None) -> Policy:
    """Resolve a policy name (or pass a Policy through).

    ``memory_cap`` needs a byte budget: an explicit ``memory_cap:<bytes>``
    suffix wins, else the profile's ``vmem_budget`` (the active profile
    when none is given) — so the cap is always concrete.  A policy's own
    ``key`` (``memory_cap[<bytes>]``) resolves back to it, which is how a
    ``SweepResult`` (it records the key) rebuilds the policy it was picked
    by; the JAX package's ``get_policy`` refuses that form, so its
    exhaustive sweeps under an explicit cap fail in ``as_tune_result``.
    """
    if policy is None:
        return Policy("latency")
    if isinstance(policy, Policy):
        return policy
    name = str(policy)
    cap: Optional[float] = None
    if ":" in name:
        name, _, cap_s = name.partition(":")
        cap = float(cap_s)
    elif name.endswith("]") and "[" in name:
        name, _, cap_s = name[:-1].partition("[")
        cap = float(cap_s)
    if name not in POLICY_NAMES:
        raise ValueError(f"unknown policy {name!r}; known: "
                         f"{', '.join(POLICY_NAMES)}")
    if name == "memory_cap" and cap is None:
        prof = profile if profile is not None else active_profile()
        cap = float(prof.vmem_budget)
    return Policy(name, cap if name == "memory_cap" else None)


def policies() -> Tuple[str, ...]:
    return POLICY_NAMES


def policy_scalar_cols(policy: Policy,
                       cols: Mapping[str, np.ndarray]) -> np.ndarray:
    """Penalty-clamped policy scalars for metric columns.

    Rows the batched protocol marks failed (``time_s`` at the exact
    penalty clamp) and rows whose scalar is non-finite (over-cap under
    ``memory_cap``) come back as ``PENALTY_TIME`` — matching what the
    scalar :class:`PolicyObjective` path reports for them.
    """
    s = policy.scalarize_cols(cols)
    t = np.asarray(cols[METRIC_TIME], dtype=np.float64)
    return np.where(np.isfinite(s) & (t != PENALTY_TIME), s, PENALTY_TIME)


# ---------------------------------------------------------------------------
# Pareto front
# ---------------------------------------------------------------------------

def pareto_mask(cols: Mapping[str, np.ndarray],
                names: Optional[Sequence[str]] = None) -> np.ndarray:
    """Boolean mask of the non-dominated rows (all metrics lower-is-better).

    A row is dominated when another row is <= on every axis and < on at
    least one.  Ties on every axis keep both rows (duplicate configs on
    the front are real alternatives).  Failed rows (penalty-clamped time)
    are excluded up front — they lose on every axis by construction.
    """
    names = tuple(names) if names is not None else tuple(cols)
    t = np.asarray(cols[METRIC_TIME], dtype=np.float64)
    mat = np.stack([np.asarray(cols[n], dtype=np.float64) for n in names],
                   axis=1)
    keep = t != PENALTY_TIME
    for i in np.flatnonzero(keep):
        if not keep[i]:
            continue
        le = np.all(mat <= mat[i], axis=1)
        lt = np.any(mat < mat[i], axis=1)
        if np.any(le & lt & keep):
            keep[i] = False
        else:
            # i dominates these rows; dropping them now shrinks later scans
            keep &= ~(np.all(mat >= mat[i], axis=1)
                      & np.any(mat > mat[i], axis=1))
    return keep


def pareto_front(cols: Mapping[str, np.ndarray], cfgs: Sequence[Config],
                 names: Optional[Sequence[str]] = None
                 ) -> Tuple[Tuple[Config, Dict[str, float]], ...]:
    """(config, metric-vector) tuples for the non-dominated set."""
    names = tuple(names) if names is not None else tuple(cols)
    mask = pareto_mask(cols, names)
    return tuple((cfgs[i], {n: float(cols[n][i]) for n in names})
                 for i in np.flatnonzero(mask))


# ---------------------------------------------------------------------------
# PolicyObjective
# ---------------------------------------------------------------------------

class PolicyObjective(Objective):
    """A vector objective scalarized under a policy.

    The adapter that lets every existing search strategy optimize any
    policy: ``__call__`` returns a Measurement whose ``time_s`` IS the
    policy scalar (the full metric vector rides along in ``metrics``), and
    ``batch_eval`` scalarizes the inner ``batch_eval_metrics`` columns.
    Under ``latency`` the scalar equals the measured time exactly, so
    wrapping is a numeric no-op.

    The signature appends ``|policy=<key>`` — a journal of policy scalars
    can never be resumed as raw times (or vice versa).
    """

    def __init__(self, inner: Objective, policy: Union[str, Policy]):
        self.inner = inner
        self.policy = get_policy(policy, getattr(inner, "spec", None))

    @property
    def spec(self) -> Optional[HardwareProfile]:
        return getattr(self.inner, "spec", None)

    def metric_names(self) -> Tuple[str, ...]:
        return self.inner.metric_names()

    def __call__(self, space: SearchSpace, cfg: Config) -> Measurement:
        m = self.inner(space, cfg)
        if not m.valid:
            return Measurement(PENALTY_TIME, False, meta=dict(m.meta))
        s = self.policy.scalarize(m.metrics)
        if not math.isfinite(s):    # e.g. over the memory_cap budget
            return Measurement(PENALTY_TIME, False, meta=dict(m.meta),
                               metrics=dict(m.metrics))
        out = Measurement(s, True, meta=dict(m.meta), metrics=dict(m.metrics))
        # __post_init__ mirrors time_s (the policy scalar) into the vector;
        # restore the real seconds so the metric axes stay truthful
        out.metrics[METRIC_TIME] = m.time_s
        return out

    def batch_eval(self, space: SearchSpace, cfgs: Sequence[Config], *,
                   assume_valid: bool = False) -> np.ndarray:
        cols = self.inner.batch_eval_metrics(space, cfgs,
                                             assume_valid=assume_valid)
        return policy_scalar_cols(self.policy, cols)

    def batch_eval_metrics(self, space: SearchSpace, cfgs: Sequence[Config],
                           *, assume_valid: bool = False
                           ) -> Dict[str, np.ndarray]:
        cols = self.inner.batch_eval_metrics(space, cfgs,
                                             assume_valid=assume_valid)
        # mirror __call__: a config the policy rejects outright (non-finite
        # scalar, e.g. over the memory_cap budget) is a failed measurement —
        # it reports the penalty on EVERY axis, not its raw numbers
        s = self.policy.scalarize_cols(cols)
        bad = ~np.isfinite(s)
        if np.any(bad):
            cols = {n: np.where(bad, metric_penalty(n), v)
                    for n, v in cols.items()}
        return cols

    def signature(self) -> str:
        return f"{self.inner.signature()}|policy={self.policy.key}"
