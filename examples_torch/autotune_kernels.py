"""The full paper workflow: exhaustive vs analytical vs Bayesian tuning on
every prefix-op family, with Table-II-style Phi reporting — driven through
the `repro_torch.tuning` API (strategy registry + TunerSession).

    PYTHONPATH=src python examples_torch/autotune_kernels.py
    PYTHONPATH=src python examples_torch/autotune_kernels.py --device cpu

The counterpart of ``examples/autotune_kernels.py``.  Every method scores
configs on the active hardware profile's cost model
(``$REPRO_TORCH_HW_PROFILE``, ``h100`` by default), with the paper's 2%
run-to-run jitter; ``--device`` only says where the session's DB is meant
to serve (the cost model runs on the host either way).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Callable, Dict, List, Optional

from repro_torch.core import (AnalyticalTuner, CachedObjective,
                              CostModelObjective, Workload, build_space)
from repro_torch.core.metrics import phi
from repro_torch.tuning import TunerSession, get_strategy, resolve_device

CASES = [("scan", "lf", [128, 256, 512, 1024]),
         ("scan", "ks", [128, 256, 512, 1024]),
         ("tridiag", "wm", [64, 128, 256, 512]),
         ("tridiag", "pcr", [64, 128, 256, 512]),
         ("fft", "stockham", [64, 256, 1024, 4096])]
NOISE = 0.02                # cost-model jitter ~ the paper's run-to-run 2%


def tune_all_methods(wl: Workload, seed: int = 0) -> Dict[str, Dict]:
    """Run exhaustive + analytical + BO on the device model via the
    strategy registry; returns per-method {config, time_s, evals,
    efficiency}.  The example's own copy of ``benchmarks/common.py``'s
    function, which the port does not import.  Raises, naming the
    workload, where the active profile admits no config."""
    space = build_space(wl)
    if not space.enumerate_valid():
        raise ValueError(f"{wl.key}: the {space.spec.name} space admits no "
                         f"config")
    obj = CachedObjective(CostModelObjective(noise=NOISE))
    ex = get_strategy("exhaustive")(space, obj, seed=seed)
    ana_cfg = AnalyticalTuner().suggest(space)
    t_ana = obj(space, ana_cfg).time_s
    bo = get_strategy("bayesian")(
        space, CachedObjective(CostModelObjective(noise=NOISE)), seed=seed)
    return {
        "exhaustive": {"config": ex.best_config, "time_s": ex.best_time,
                       "evals": ex.evaluations, "efficiency": 1.0},
        "analytical": {"config": ana_cfg, "time_s": t_ana, "evals": 0,
                       "efficiency": min(ex.best_time / t_ana, 1.0)},
        "bayesian": {"config": bo.best_config, "time_s": bo.best_time,
                     "evals": bo.evaluations,
                     "efficiency": min(ex.best_time / bo.best_time, 1.0)},
    }


def run(device: str = "cuda", cases=CASES,
        log: Callable[[str], None] = print) -> Dict:
    """Tune every case; returns the Phi table by case, every size's
    methods and the warm resolve."""
    resolve_device(device)
    # winners land in a session-owned DB: the offline half of the paper's
    # flow
    session = TunerSession(db_path=os.path.join(
        tempfile.mkdtemp(prefix="autotune_"), "db.json"))
    log(f"{'op':22s} {'PHI_analytical':>15s} {'PHI_bayesian':>13s} "
        f"{'BO evals':>9s}")
    table, runs = {}, {}
    for op, variant, sizes in cases:
        effs = {"analytical": [], "bayesian": []}
        evals = []
        for n in sizes:
            wl = Workload(op=op, n=n, batch=max(2**26 // n, 1),
                          variant=variant)
            res = tune_all_methods(wl)
            runs[wl.key] = res
            session.db.store(wl, res["bayesian"]["config"],
                             res["bayesian"]["time_s"], "bayesian",
                             res["bayesian"]["evals"])
            effs["analytical"].append(res["analytical"]["efficiency"])
            effs["bayesian"].append(res["bayesian"]["efficiency"])
            evals.append(res["bayesian"]["evals"])
        row = {"analytical": phi(effs["analytical"]),
               "bayesian": phi(effs["bayesian"]), "evals": evals}
        table[f"{op}-{variant}"] = row
        log(f"{op+'-'+variant:22s} {row['analytical']:15.4f} "
            f"{row['bayesian']:13.4f} {str(evals):>9s}")

    # online half: every stored workload resolves instantly from the session
    warm = session.resolve(Workload(op="scan", n=1024, batch=2**26 // 1024,
                                    variant="ks"))
    log(f"\nwarm online resolve (DB-backed): {warm}")
    stats = session.stats()
    log(f"session stats: {stats}")
    return {"phi": table, "runs": runs, "warm": warm, "stats": stats}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
