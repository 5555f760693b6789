"""Methodology comparison against the exhaustive optimum (paper Table II).

For every workload the exhaustive sweep supplies the ground-truth optimum;
each methodology (analytical / ml / bayesian / random) is then scored on
the SAME cached objective, so every reported time is a time the sweep
actually measured.  That construction makes the report a bug detector:
performance efficiency is ``best_time / achieved_time`` and can only
exceed 1.0 — "a methodology beat exhaustive search" — if the sweep, the
cache, or a strategy mishandled the objective.  ``check_report`` turns any
such violation (equivalently Phi > 1) into a failure.

Emitted metrics per (op, methodology) and overall: Phi (the harmonic-mean
performance-portability metric, computed raw so violations surface),
mean/max slowdown against the optimum, and evaluation counts.

The PyTorch port's own copy of ``repro.evaluation.compare``, for the
latency policy.  With a ``WallClockObjective`` factory the same report is
the paper's comparison on measured times.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence

from repro_torch.core.exhaustive import ExhaustiveSearch
from repro_torch.core.objective import (CachedObjective, CostModelObjective,
                                  Objective)
from repro_torch.core.space import Workload, build_space
from repro_torch.hw.profiles import HardwareProfile
from repro_torch.tuning.session import get_strategy

# JAX's order; its "online" strategy is not ported yet
DEFAULT_METHODS = ("exhaustive", "analytical", "ml", "bayesian", "random")

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
                    profile: Optional[HardwareProfile] = None) -> Dict:
    """Run every methodology against the exhaustive optimum (latency).

    One ``CachedObjective`` per workload is shared by the sweep and every
    strategy, so all methods are scored on identical measurements (and the
    non-exhaustive strategies' repeat visits are cache hits, not new
    evaluations — their ``evaluations`` field still reports what each
    method would have paid standalone).

    ``profile`` bounds the spaces and (absent an explicit factory) the
    cost model by that device; default is the process-wide active profile.
    """
    rows: List[Dict] = []
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
        rows.append(row)

    report = {"methods": list(methods), "workloads": rows,
              "profile": rows[0]["profile"] if rows else None,
              "per_op": {}, "overall": {}, "violations": []}

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
    return failures


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
    return "\n".join(lines)
