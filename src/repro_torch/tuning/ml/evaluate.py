"""Model-quality report: the paper's Table-style evaluation for strategy="ml".

For each held-out workload the report compares what the deployed decision
rule (``MLStrategy.choose`` — learned ranking, analytical defer, fallback
ladder and all) picks against the exhaustive optimum on the offline
objective:

  * **top-1 match** — the chosen config achieves the optimum's time within
    a tie tolerance (exact config equality is too strict: spaces contain
    distinct configs with identical modeled times);
  * **slowdown** — time(chosen) / time(true best), >= 1.0;
  * **ml_rate** — the fraction of workloads answered by the learned rungs
    ("ml" / "ml-defer-analytical") rather than a fallback.  Without this,
    a regression that drives every prediction into low-confidence would
    sail through the accuracy floors on the analytical fallback's answers;
  * **rank_corr** — Spearman correlation between the forest's predicted
    ranking and the true time ranking over each workload's candidates.
    This measures the learned model *itself*: a degenerate forest (e.g. a
    featurization bug flattening predictions) makes every workload defer
    to the analytical suggestion — ml_rate stays 1.0 and top-1 stays at
    the expert's level — but its rank correlation collapses toward 0.

The aggregate floors (``min_top1``, ``max_mean_slowdown``, ``min_ml_rate``,
``min_rank_corr``) are what ``eval-model``'s flags pin,
regression-gating the learned strategy like code.

The PyTorch port's own copy of ``repro.tuning.ml.evaluate``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.core.objective import CostModelObjective, Objective
from repro_torch.core.space import Workload, build_space
from repro_torch.tuning.ml.dataset import suite_workloads, sweep_workload
from repro_torch.tuning.ml.forest import ModelBundle
from repro_torch.tuning.ml.strategy import MLStrategy

TIE_TOL = 1e-3     # relative time slack under which two configs count equal

ML_RUNGS = ("ml", "ml-defer-analytical")


def _rank(v: np.ndarray) -> np.ndarray:
    """Average ranks, scipy-style: exact ties share their mean rank, so the
    correlation cannot be deflated (or inflated) by whatever enumeration
    order tied-time candidates happen to appear in."""
    order = np.argsort(v, kind="stable")
    ranks = np.empty(len(v))
    ranks[order] = np.arange(len(v))
    _, inv = np.unique(v, return_inverse=True)
    sums = np.bincount(inv, weights=ranks)
    counts = np.bincount(inv)
    return (sums / counts)[inv]


def spearman(pred: np.ndarray, truth: np.ndarray) -> float:
    """Rank correlation of the forest's ordering vs the true ordering."""
    if len(pred) < 2:
        return 1.0
    rp, rt = _rank(np.asarray(pred)), _rank(np.asarray(truth))
    if rp.std() == 0 or rt.std() == 0:
        return 0.0
    return float(np.corrcoef(rp, rt)[0, 1])


def evaluate_model(bundle: ModelBundle,
                   workloads: Optional[Iterable[Workload]] = None,
                   objective: Optional[Objective] = None) -> Dict:
    """Per-workload + aggregate accuracy of the deployed decision rule."""
    workloads = list(workloads) if workloads is not None \
        else suite_workloads("holdout")
    objective = objective or CostModelObjective()
    strategy = MLStrategy(model=bundle)
    rows: List[Dict] = []
    for wl in workloads:
        wl = wl.canonical()
        cfgs, X, times = sweep_workload(wl, objective)
        space = build_space(wl)
        pred = strategy.predict(space, cfgs, X)        # one forest pass
        pick, rung = strategy.choose(space, cfgs, X, pred=pred)
        best = int(np.argmin(times))
        slowdown = float(times[pick] / times[best])
        rows.append({
            "workload": wl.key, "op": wl.op, "n": wl.n,
            "candidates": len(cfgs),
            "rung": rung,
            "chosen_config": dict(cfgs[pick]),
            "best_config": dict(cfgs[best]),
            "slowdown": slowdown,
            "top1": bool(slowdown <= 1.0 + TIE_TOL),
            "rank_corr": spearman(pred[0], times) if pred is not None
            else None,
        })

    report: Dict = {"workloads": rows, "n_scored": len(rows)}
    if rows:
        slowdowns = np.array([r["slowdown"] for r in rows])
        rungs: Dict[str, int] = {}
        for r in rows:
            rungs[r["rung"]] = rungs.get(r["rung"], 0) + 1
        corrs = [r["rank_corr"] for r in rows if r["rank_corr"] is not None]
        report.update({
            "top1_rate": float(np.mean([r["top1"] for r in rows])),
            "mean_slowdown": float(slowdowns.mean()),
            "max_slowdown": float(slowdowns.max()),
            "rungs": rungs,
            "ml_rate": float(np.mean([r["rung"] in ML_RUNGS for r in rows])),
            "mean_rank_corr": float(np.mean(corrs)) if corrs else 0.0,
        })
        per_op: Dict[str, Dict] = {}
        for op in sorted({r["op"] for r in rows}):
            sub = [r for r in rows if r["op"] == op]
            sd = np.array([r["slowdown"] for r in sub])
            per_op[op] = {"n": len(sub),
                          "top1_rate": float(np.mean([r["top1"] for r in sub])),
                          "mean_slowdown": float(sd.mean()),
                          "max_slowdown": float(sd.max())}
        report["per_op"] = per_op
    return report


def check_floors(report: Dict, *, min_top1: Optional[float] = None,
                 max_mean_slowdown: Optional[float] = None,
                 min_ml_rate: Optional[float] = None,
                 min_rank_corr: Optional[float] = None) -> List[str]:
    """Floor violations as human-readable strings (empty == gate passes)."""
    failures = []
    if report.get("n_scored", 0) == 0:
        return ["no workloads were scored"]
    if min_top1 is not None and report["top1_rate"] < min_top1:
        failures.append(f"top-1 match rate {report['top1_rate']:.3f} "
                        f"< floor {min_top1:.3f}")
    if max_mean_slowdown is not None \
            and report["mean_slowdown"] > max_mean_slowdown:
        failures.append(f"mean slowdown {report['mean_slowdown']:.3f}x "
                        f"> ceiling {max_mean_slowdown:.3f}x")
    if min_ml_rate is not None and report["ml_rate"] < min_ml_rate:
        failures.append(f"learned-rung rate {report['ml_rate']:.3f} "
                        f"< floor {min_ml_rate:.3f} "
                        f"(rungs: {report['rungs']})")
    if min_rank_corr is not None \
            and report["mean_rank_corr"] < min_rank_corr:
        failures.append(f"mean rank correlation "
                        f"{report['mean_rank_corr']:.3f} "
                        f"< floor {min_rank_corr:.3f}")
    return failures
