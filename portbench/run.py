"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout: it puts the checkout's ``src`` on
``sys.path`` and drives ``repro_torch`` on the card.  Without CUDA, or with
fewer cards than the cell asks for, it exits with code 2 and prints no
result; likewise (code 3) if the process holds ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` once the window has closed.  The
kernel library builds into ``src/repro_torch/_build/<hash>/`` on a first
run and loads from there afterwards; Triton's and torch's extension caches
are kept at fixed paths inside the checkout (``.portbench_cache/``), and
so is the bytecode of every module the run imports (torch's too): where
the machine sets ``PYTHONDONTWRITEBYTECODE`` and its packages ship no
``__pycache__``, each run would otherwise compile torch's sources anew.

Standard output's last line is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number that decides ``correct``
beside its limit, which also close standard error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ENTERED = time.time()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")


def keep_bytecode() -> None:
    """Read and write compiled bytecode under the checkout's cache, so
    that only a checkout's first run compiles what it imports."""
    sys.pycache_prefix = os.path.join(CACHE, "pyc")
    sys.dont_write_bytecode = False


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    # the default session as a user gets it: the checkout's (absent) DB
    # under the port's default profile
    for var in ("REPRO_TORCH_TUNING_DB", "REPRO_TORCH_HW_PROFILE"):
        os.environ.pop(var, None)
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)

    import torch
    from portbench import harness, timing
    started = timing.process_start()
    imported = time.time()
    bench = harness.Benchmark(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        harness.log(f"[portbench] {args.workload} needs {cell['chips']} "
                    f"CUDA device(s); this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    harness.log(f"[portbench] set-up: interpreter {ENTERED - started:.3f} s, "
                f"torch imported {imported - ENTERED:.3f} s, CUDA checked "
                f"{time.time() - imported:.3f} s")
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace),
                              timing.Device(torch.device("cuda", 0)),
                              started)
    leaked = harness.forbidden_modules()
    if leaked:
        harness.log(f"[portbench] the process holds {leaked}: the port's "
                    f"run may not load JAX or the JAX package")
        return 3
    harness.log(f"[portbench] card: {harness.card_line()}")
    for name, c in result["checks"].items():
        harness.log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    keep_bytecode()
    sys.exit(main())
