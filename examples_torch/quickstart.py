"""Quickstart: tune a kernel offline, use it online — the paper's flow,
through the `repro_torch.tuning` session API, on the card.

    PYTHONPATH=src python examples_torch/quickstart.py                # the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu   # plain versions

The counterpart of ``examples/quickstart.py``.  The device model is the
active hardware profile (``$REPRO_TORCH_HW_PROFILE``, ``h100`` by
default).  The DB is a fresh temporary file unless ``--db`` names one.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import Workload
from repro_torch.kernels.scan.ops import prefix_sum
from repro_torch.kernels.scan.ref import scan_add_ref
from repro_torch.tuning import TunerSession, overrides, resolve_device


def run(device: str = "cuda", db: Optional[str] = None,
        log: Callable[[str], None] = print) -> Dict:
    """The example's five steps; returns what each produced."""
    dev = resolve_device(device)
    if db is None:
        db = os.path.join(tempfile.mkdtemp(prefix="quickstart_"), "db.json")
    session = TunerSession(db_path=db)

    # 1. offline: Bayesian-optimization search on the active profile's
    #    device model
    wl = Workload(op="scan", n=1024, batch=65536, variant="ks")
    result = session.tune(wl, method="bayesian")
    log(f"offline BO: best={result.best_config} "
        f"t={result.best_time*1e6:.1f}us evals={result.evaluations}")

    # 2. online: resolve() reads the DB (or falls back to the zero-evaluation
    #    analytical model for unseen workloads) and caches the resolved config
    cfg = session.resolve(wl)
    log(f"online config: {cfg}")

    # 3. run the tuned kernel (the CUDA kernel on the card; its plain
    #    version on the CPU)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 1024))
                         .astype(np.float32)).to(dev)
    y = prefix_sum(x, config=cfg)
    err = float(torch.max(torch.abs(y - scan_add_ref(x))))
    log(f"tuned scan matches oracle: max_err={err:.2e}")

    # 4. an unseen workload: analytical answer, no evaluations needed
    wl2 = Workload(op="scan", n=2048, batch=32768, variant="ks")
    cold = session.resolve(wl2)
    log(f"online (analytical, cold): {cold}")

    # 5. scoped experiments: force knobs without touching the DB
    with overrides(scan={"radix": 4}):
        y4 = prefix_sum(x)
    err4 = float(torch.max(torch.abs(y4 - scan_add_ref(x))))
    log(f"override radix=4 matches: {err4:.2e}")
    return {"result": result, "config": cfg, "cold": cold,
            "x": x, "y": y, "y4": y4, "max_err": err, "max_err_radix4": err4}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--db", default=None,
                    help="the tuning DB's path (default: a fresh temporary "
                         "file)")
    args = ap.parse_args(argv)
    run(args.device, args.db)
    return 0


if __name__ == "__main__":
    sys.exit(main())
