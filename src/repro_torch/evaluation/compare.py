"""Methodology comparison against the exhaustive optimum (paper Table II).

For every workload the exhaustive sweep supplies the ground-truth optimum;
each methodology (analytical / ml / online / bayesian / random / transfer)
is then scored on the SAME cached objective, so every reported time is a
time the sweep actually measured.  That construction makes the report a bug detector:
performance efficiency is ``best_time / achieved_time`` and can only
exceed 1.0 — "a methodology beat exhaustive search" — if the sweep, the
cache, or a strategy mishandled the objective.  ``check_report`` turns any
such violation (equivalently Phi > 1) into a failure.

Emitted metrics per (op, methodology) and overall:

  * **Phi** — the harmonic-mean performance-portability metric
    (``repro_torch.core.metrics``), computed raw (no clamping) so violations
    surface;
  * **mean/max slowdown** — achieved time / optimum;
  * **evaluation counts** — what each methodology paid for its answer
    (the paper's Fig-4 axis).

``policies`` extends the table to the multi-objective setting: for every
non-latency policy (``energy``, ``edp``, ``memory_cap`` — see
:mod:`repro_torch.core.policy`) the full sweep's metric vectors define
the policy optimum, each method re-runs on a
:class:`~repro_torch.core.policy.PolicyObjective` wrapper of the SAME
cache, and a per-(method, policy) Phi lands in ``report["per_policy"]`` —
any cell above 1 is a violation exactly like the latency gate.

The PyTorch port's own copy of ``repro.evaluation.compare``.  With a
``WallClockObjective`` factory the same report is the paper's comparison
on measured times; ``compare_methods_matrix`` scores each profile on its
own cost model.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.core.exhaustive import ExhaustiveSearch
from repro_torch.core.objective import (CachedObjective, CostModelObjective,
                                        Objective)
from repro_torch.core.policy import (PolicyObjective, get_policy,
                                     policy_scalar_cols)
from repro_torch.core.space import Workload, build_space
from repro_torch.hw.profiles import HardwareProfile, get_profile
from repro_torch.tuning.session import get_strategy

DEFAULT_METHODS = ("exhaustive", "analytical", "ml", "online", "bayesian",
                   "random")

# device-matrix default: tpu_v5e first so its journals exist when the
# transfer strategy runs on the other devices
DEFAULT_MATRIX_PROFILES = ("tpu_v5e", "gpu_sm", "cpu_interpret")
DEFAULT_MATRIX_METHODS = ("analytical", "bayesian", "transfer")

# efficiencies this far above 1.0 are fp-noise, beyond it a violation
EFFICIENCY_EPS = 1e-9


def evals_to_optimum(history: Sequence[tuple], best_time: float) -> Optional[int]:
    """Evaluations spent until the search first measured the optimum.

    1-based index of the first history entry within fp-noise of
    ``best_time`` (the exhaustive optimum); None when the search never
    reached it — the matrix's evaluations-to-Phi<=1 cell.
    """
    for i, (_, t) in enumerate(history):
        if t <= best_time * (1.0 + EFFICIENCY_EPS):
            return i + 1
    return None


def _phi_raw(efficiencies: Sequence[float]) -> float:
    """Harmonic mean WITHOUT the (0, 1] range check of metrics.phi — a
    Phi > 1 here is exactly the signal check_report exists to catch."""
    return len(efficiencies) / sum(1.0 / max(e, 1e-12) for e in efficiencies)


def compare_methods(workloads: Iterable[Workload],
                    methods: Sequence[str] = DEFAULT_METHODS,
                    objective_factory: Optional[Callable[[], Objective]] = None,
                    *, seed: int = 0, max_evals: int = 20,
                    journal_dir: Optional[str] = None,
                    profile: Optional[HardwareProfile] = None,
                    policies: Sequence[str] = ("latency",)) -> Dict:
    """Run every methodology against the exhaustive optimum.

    One ``CachedObjective`` per workload is shared by the sweep and every
    strategy, so all methods are scored on identical measurements (and the
    non-exhaustive strategies' repeat visits are cache hits, not new
    evaluations — their ``evaluations`` field still reports what each
    method would have paid standalone).

    ``profile`` bounds the spaces and (absent an explicit factory) the
    cost model by that device; default is the process-wide active profile.

    ``policies`` adds per-policy scoring: the base table is always the
    latency one; each non-latency entry re-runs every method on a
    :class:`~repro_torch.core.policy.PolicyObjective` over the same cache and
    scores it against that policy's scalarized optimum (the min over the
    exhaustive sweep's metric vectors).
    """
    rows: List[Dict] = []
    policy_keys: List[str] = []
    for wl in workloads:
        wl = wl.canonical()
        space = build_space(wl, profile)
        obj = CachedObjective(objective_factory() if objective_factory
                              else CostModelObjective(profile))
        ex = ExhaustiveSearch(journal_dir=journal_dir).tune(space, obj)
        # journal-resumed configs never went through `obj` — seed the shared
        # cache with the sweep's times so every strategy reads the exact
        # measurements the optimum came from (re-measuring on a drifted
        # host would let a method "beat" exhaustive and trip the Phi gate)
        obj.seed(space, ex.history)
        row = {"workload": wl.key, "op": wl.op, "n": wl.n,
               "profile": space.spec.name,
               "space_size": len(ex.history),
               "best_time_s": ex.best_time,
               "exhaustive_evaluations": ex.evaluations,
               "methods": {}}
        for name in methods:
            res = get_strategy(name)(space, obj, seed=seed,
                                     max_evals=max_evals,
                                     journal_dir=journal_dir)
            eff = ex.best_time / res.best_time
            row["methods"][name] = {
                "time_s": res.best_time,
                "slowdown": res.best_time / ex.best_time,
                "efficiency": eff,
                "evaluations": res.evaluations,
                "evals_to_optimum": evals_to_optimum(res.history,
                                                     ex.best_time),
                "stopped_by": res.stopped_by,
                "config": dict(res.best_config),
            }
        pols = [get_policy(p, space.spec) for p in policies]
        if not policy_keys:
            policy_keys = [p.key for p in pols]
        extra = [p for p in pols if p.name != "latency"]
        if extra:
            hist_cfgs = [c for c, _ in ex.history]
            cols = obj.batch_eval_metrics(space, hist_cfgs,
                                          assume_valid=True)
            row["policies"] = {}
        for pol in extra:
            scal = policy_scalar_cols(pol, cols)
            best_i = int(np.argmin(scal))
            pol_best = float(scal[best_i])
            cell = {"best_scalar": pol_best,
                    "best_config": dict(hist_cfgs[best_i]),
                    "methods": {}}
            pobj = PolicyObjective(obj, pol)
            for name in methods:
                res = get_strategy(name)(space, pobj, seed=seed,
                                         max_evals=max_evals,
                                         journal_dir=journal_dir)
                if not np.isfinite(pol_best) and not np.isfinite(res.best_time):
                    # a cap no config satisfies: optimum and method are
                    # equally impossible, not a violation
                    eff = slow = 1.0
                else:
                    eff = pol_best / res.best_time
                    slow = res.best_time / pol_best
                cell["methods"][name] = {
                    "scalar": res.best_time,
                    "slowdown": slow,
                    "efficiency": eff,
                    "evaluations": res.evaluations,
                    "stopped_by": res.stopped_by,
                    "config": dict(res.best_config),
                }
            row["policies"][pol.key] = cell
        rows.append(row)

    report = {"methods": list(methods), "workloads": rows,
              "profile": rows[0]["profile"] if rows else None,
              "policies": policy_keys,
              "per_op": {}, "overall": {}, "per_policy": {},
              "violations": []}

    ops = sorted({r["op"] for r in rows})
    for name in methods:
        for op in ops:
            sub = [r for r in rows if r["op"] == op]
            effs = [r["methods"][name]["efficiency"] for r in sub]
            slows = [r["methods"][name]["slowdown"] for r in sub]
            report["per_op"].setdefault(op, {})[name] = {
                "phi": _phi_raw(effs),
                "mean_slowdown": sum(slows) / len(slows),
                "mean_evaluations": (sum(r["methods"][name]["evaluations"]
                                         for r in sub) / len(sub)),
                "n": len(sub),
            }
        effs = [r["methods"][name]["efficiency"] for r in rows]
        slows = [r["methods"][name]["slowdown"] for r in rows]
        reached = [r["methods"][name]["evals_to_optimum"] for r in rows
                   if r["methods"][name]["evals_to_optimum"] is not None]
        report["overall"][name] = {
            "phi": _phi_raw(effs),
            "mean_slowdown": sum(slows) / len(slows),
            "max_slowdown": max(slows),
            "total_evaluations": sum(r["methods"][name]["evaluations"]
                                     for r in rows),
            # evaluations-to-Phi<=1: how fast the method finds the optimum
            # when it does, and on what fraction of workloads it does at all
            "mean_evals_to_optimum": (sum(reached) / len(reached)
                                      if reached else None),
            "optimum_rate": len(reached) / len(rows),
            "n": len(rows),
        }
        for r in rows:
            if r["methods"][name]["efficiency"] > 1.0 + EFFICIENCY_EPS:
                report["violations"].append(
                    f"{name} beat exhaustive on {r['workload']}: "
                    f"efficiency={r['methods'][name]['efficiency']:.6f}")
    for pol_key in policy_keys:
        if pol_key == "latency":
            # the base table IS the latency policy; mirror it so the
            # per-(method, policy) gate sees a uniform structure
            report["per_policy"]["latency"] = {
                name: {"phi": report["overall"][name]["phi"],
                       "mean_slowdown":
                           report["overall"][name]["mean_slowdown"],
                       "total_evaluations":
                           report["overall"][name]["total_evaluations"],
                       "n": len(rows)}
                for name in methods}
            continue
        per: Dict[str, Dict] = {}
        for name in methods:
            cells = [r["policies"][pol_key]["methods"][name] for r in rows]
            effs = [c["efficiency"] for c in cells]
            slows = [c["slowdown"] for c in cells]
            per[name] = {
                "phi": _phi_raw(effs),
                "mean_slowdown": sum(slows) / len(slows),
                "total_evaluations": sum(c["evaluations"] for c in cells),
                "n": len(cells),
            }
            for r in rows:
                c = r["policies"][pol_key]["methods"][name]
                if c["efficiency"] > 1.0 + EFFICIENCY_EPS:
                    report["violations"].append(
                        f"[policy={pol_key}] {name} beat the {pol_key} "
                        f"optimum on {r['workload']}: "
                        f"efficiency={c['efficiency']:.6f}")
        report["per_policy"][pol_key] = per
    report["exhaustive_total_evaluations"] = sum(
        r["exhaustive_evaluations"] for r in rows)
    return report


def check_report(report: Dict) -> List[str]:
    """Failure strings; empty when the report is sane.

    Exhaustive search being beaten (efficiency or Phi above 1) is never a
    better methodology — it is a correctness bug in the sweep/objective
    stack, which is why the CLI fails on it.
    """
    failures = list(report.get("violations", ()))
    for name, agg in report.get("overall", {}).items():
        if agg["phi"] > 1.0 + EFFICIENCY_EPS:
            failures.append(f"overall Phi({name})={agg['phi']:.6f} > 1: "
                            f"exhaustive search was beaten")
    for pol_key, per in report.get("per_policy", {}).items():
        if pol_key == "latency":
            continue    # mirrors `overall`, already checked above
        for name, agg in per.items():
            if agg["phi"] > 1.0 + EFFICIENCY_EPS:
                failures.append(
                    f"Phi({name}, policy={pol_key})={agg['phi']:.6f} > 1: "
                    f"the {pol_key} optimum was beaten")
    return failures


# ---------------------------------------------------------------------------
# Per-(device, method) matrix (the portability story, quantified)
# ---------------------------------------------------------------------------

def compare_methods_matrix(workloads: Iterable[Workload],
                           methods: Sequence[str] = DEFAULT_MATRIX_METHODS,
                           profiles: Sequence[str] = DEFAULT_MATRIX_PROFILES,
                           *, seed: int = 0, max_evals: int = 20,
                           journal_dir: Optional[str] = None,
                           policies: Sequence[str] = ("latency",)) -> Dict:
    """``compare_methods`` once per hardware profile, shared journal dir.

    Profiles run in order; every sweep journals into the same directory, so
    by the time device k runs, ``strategy="transfer"`` finds devices
    0..k-1's journals and warm-starts from them (on the first device it is
    a cold Bayesian search — its baseline). The result is the per-(device,
    method) matrix of Phi / evaluations-to-optimum the paper's portability
    claim needs.
    """
    wls = [wl.canonical() for wl in workloads]
    matrix: Dict[str, Dict] = {}
    for name in profiles:
        prof = get_profile(name)
        matrix[name] = compare_methods(
            wls, methods, seed=seed, max_evals=max_evals,
            journal_dir=journal_dir, profile=prof, policies=policies)
    return {"profiles": list(profiles), "methods": list(methods),
            "reports": matrix}


def check_matrix(matrix_report: Dict) -> List[str]:
    """Failure strings over every (device, method) cell; empty when sane.

    Phi > 1 in ANY cell means a methodology "beat" that device's exhaustive
    sweep — a correctness bug somewhere in the profile-threaded stack.
    """
    failures: List[str] = []
    for prof, report in matrix_report.get("reports", {}).items():
        for msg in check_report(report):
            failures.append(f"[{prof}] {msg}")
    return failures


def format_matrix(matrix_report: Dict) -> str:
    """Per-(device, method) table: Phi, mean slowdown, evals-to-optimum."""
    lines = []
    header = f"{'device':<14} {'method':<11} {'Phi':>6} {'mean_slow':>9} " \
             f"{'evals_to_opt':>12} {'opt_rate':>8}"
    lines.append(header)
    lines.append("-" * len(header))
    for prof in matrix_report["profiles"]:
        overall = matrix_report["reports"][prof]["overall"]
        for name in matrix_report["methods"]:
            agg = overall[name]
            eto = agg.get("mean_evals_to_optimum")
            eto_s = f"{eto:12.1f}" if eto is not None else f"{'-':>12}"
            lines.append(f"{prof:<14} {name:<11} {agg['phi']:6.3f} "
                         f"{agg['mean_slowdown']:9.3f} {eto_s} "
                         f"{agg['optimum_rate']:8.2f}")
    return "\n".join(lines)


def format_report(report: Dict) -> str:
    """Human-readable per-op + overall table (the Table-II layout)."""
    lines = []
    header = f"{'op':<10} {'method':<11} {'Phi':>6} {'mean_slow':>9} " \
             f"{'mean_evals':>10}"
    lines.append(header)
    for op, per in sorted(report["per_op"].items()):
        for name in report["methods"]:
            agg = per[name]
            lines.append(f"{op:<10} {name:<11} {agg['phi']:6.3f} "
                         f"{agg['mean_slowdown']:9.3f} "
                         f"{agg['mean_evaluations']:10.1f}")
    lines.append("-" * len(header))
    for name in report["methods"]:
        agg = report["overall"][name]
        lines.append(f"{'OVERALL':<10} {name:<11} {agg['phi']:6.3f} "
                     f"{agg['mean_slowdown']:9.3f} "
                     f"{agg['total_evaluations']:10d}")
    extra = [k for k in report.get("policies", ()) if k != "latency"]
    if extra:
        lines.append("-" * len(header))
        for pol_key in extra:
            for name in report["methods"]:
                agg = report["per_policy"][pol_key][name]
                lines.append(f"{pol_key:<10} {name:<11} {agg['phi']:6.3f} "
                             f"{agg['mean_slowdown']:9.3f} "
                             f"{agg['total_evaluations']:10d}")
    return "\n".join(lines)
