"""Batched serving example: continuous batching over mixed-length requests,
with an OnlineTuner trialing kernel configs against the live decode steps.

    PYTHONPATH=src python examples_torch/serve_lm.py                # the card
    PYTHONPATH=src python examples_torch/serve_lm.py --device cpu

The counterpart of ``examples/serve_lm.py``: the reduced qwen1.5-0.5b with
weights drawn by ``Model.init`` from a generator seeded with 0.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.space import Workload
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeEngine
from repro_torch.tuning import (OnlineTuner, TunerSession, attach,
                                resolve_device)

ARCH = "qwen1.5-0.5b"


def requests(vocab: int):
    """The example's ten prompts (and their token budget)."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, size=int(rng.integers(4, 20))), 8)
            for _ in range(10)]


def run(device: str = "cuda", model: Optional[Model] = None,
        log: Callable[[str], None] = print) -> Dict:
    """Serve the ten requests; ``model`` (the reduced arch) replaces the
    seeded draw.  Returns the finished requests, the seconds and the
    tuner's summary."""
    dev = resolve_device(device)
    cfg = get_arch(ARCH).reduced()
    if model is None:
        model = Model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    engine = ServeEngine(model, max_batch=4, max_len=128)

    # online tuning: wall-clock-time every decode step, shadow-trial
    # candidate attention configs under a strict measurement budget, roll
    # back slowdowns
    session = TunerSession(
        db_path=os.path.join(tempfile.mkdtemp(prefix="serve_lm_"), "db.json"))
    tuner = OnlineTuner(Workload(op="attention", n=128, batch=4,
                                 variant="flash"),
                        session, budget=16, guard_band=0.25)
    attach(engine, tuner)

    for prompt, new in requests(cfg.vocab):
        engine.submit(prompt, max_new_tokens=new)
    t0 = time.perf_counter()
    done = engine.run()
    dt = time.perf_counter() - t0
    tokens = sum(len(r.output) for r in done)
    log(f"[serve_lm] {len(done)} requests / {tokens} tokens in {dt:.2f}s "
        f"({tokens/dt:.1f} tok/s, continuous batching over 4 slots)")
    for r in done[:3]:
        log(f"  req {r.rid}: {len(r.prompt)}-token prompt -> {r.output}")

    s = tuner.summary()
    log(f"[serve_lm] online tuner: {s['state']} after {s['steps']} steps, "
        f"{s['measured']}/{s['budget']} trial measurements, "
        f"{s['promotions']} promotion(s)")
    return {"done": done, "seconds": dt, "tokens": tokens, "tuner": s,
            "model": model}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
