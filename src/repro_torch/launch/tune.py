"""Offline tuning CLI of the port: the paper's loop on the prefix-sum scan,
the tridiagonal solvers, the FFT, the SSD op, the RG-LRU, flash attention
and the tiled matmul.

Tune one workload per size and persist the winner in a TuningDB:

  PYTHONPATH=src python -m repro_torch.launch.tune --op scan --variant ks \\
      --sizes 1024,4096 --method bayesian --db artifacts/tuning_db_torch.json

Score every methodology against the exhaustive optimum (paper Table II):

  PYTHONPATH=src python -m repro_torch.launch.tune compare-methods \\
      --op tridiag --variant pcr --sizes 256,1024 \\
      --methods exhaustive,analytical,bayesian,random

  PYTHONPATH=src python -m repro_torch.launch.tune compare-methods \\
      --op fft --variant stockham --sizes 1024,4096

  PYTHONPATH=src python -m repro_torch.launch.tune compare-methods \\
      --op ssd --variant chunked --sizes 1024,2048      # 8 x 24 heads
  PYTHONPATH=src python -m repro_torch.launch.tune compare-methods \\
      --op rglru --sizes 2048 --batch 4096               # one sequence
  PYTHONPATH=src python -m repro_torch.launch.tune compare-methods \\
      --op attention --variant flash --sizes 2048 --dtype bfloat16
  PYTHONPATH=src python -m repro_torch.launch.tune compare-methods \\
      --op matmul --variant tiled --sizes 2816 --dtype bfloat16

Both run on the card (``--device cuda``, the default) and time each
candidate config with a ``WallClockObjective`` whose thunk calls the op's
entry point (``prefix_sum``, ``solve`` on a diagonally dominant system,
``fft`` on complex64 rows, ``ssd`` on mamba2-130m's head layout,
``rglru`` on one sequence of ``batch`` channels, ``attention`` on
``batch`` causal rows of head_dim 64, or ``matmul`` of ``batch`` rows of
K = 1024 by an n-column b) on device-resident input
and ends in ``torch.cuda.synchronize()``.  ``--device cpu`` runs the
kernels' plain versions on the CPU instead (small sizes only);
``--objective cost`` scores configs on the ``h100`` cost model rather than
measuring them.  The batch defaults to the paper's 2^26 / n problems per
invocation (for ssd, 8 sequences x 24 heads; for attention, 4 sequences x
16 heads; for matmul, 8192 rows).  ``--variant`` defaults to ks (rglru
takes none).  A
runner failure (a kernel that does not build or launch) aborts the run
with a non-zero exit; ``compare-methods`` also exits non-zero when any
method beats the exhaustive sweep (Phi > 1 is a bug, not a result).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core import CostModelObjective, WallClockObjective, Workload
from repro_torch.core.objective import Objective
from repro_torch.core.space import Config
from repro_torch.tuning import TunerSession, resolve_device, strategies

TOTAL_ELEMS = 2 ** 26   # paper: batch = 2^26 / N problems per invocation

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_scan_runner(device: torch.device, seed: int = 0
                     ) -> Callable[[Workload, Config], Callable[[], None]]:
    """A ``WallClockObjective`` runner: for each workload, one seeded input
    on ``device`` (made once and reused), and a thunk that runs the public
    ``prefix_sum`` entry point with the candidate config."""
    from repro_torch.kernels.scan.ops import prefix_sum

    inputs: Dict[str, torch.Tensor] = {}

    def run(wl: Workload, cfg: Config) -> Callable[[], None]:
        x = inputs.get(wl.key)
        if x is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            x = torch.randn(wl.batch, wl.n, generator=gen, device=device,
                            dtype=torch.float32).to(_DTYPES[wl.dtype])
            inputs[wl.key] = x
        return lambda: prefix_sum(x, variant=wl.variant, config=cfg)

    return run


def make_tridiag_runner(device: torch.device, seed: int = 0
                        ) -> Callable[[Workload, Config], Callable[[], None]]:
    """A ``WallClockObjective`` runner: for each workload, one seeded
    diagonally dominant system on ``device`` (made once and reused), and a
    thunk that runs the public ``solve`` entry point with the candidate
    config."""
    from repro_torch.kernels.tridiag.ops import solve
    from repro_torch.kernels.tridiag.ref import random_system

    systems: Dict[str, tuple] = {}

    def run(wl: Workload, cfg: Config) -> Callable[[], None]:
        system = systems.get(wl.key)
        if system is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            system = tuple(v.to(_DTYPES[wl.dtype]) for v in
                           random_system(gen, wl.batch, wl.n, device=device))
            systems[wl.key] = system
        return lambda: solve(*system, variant=wl.variant, config=cfg)

    return run


def make_fft_runner(device: torch.device, seed: int = 0
                    ) -> Callable[[Workload, Config], Callable[[], None]]:
    """A ``WallClockObjective`` runner: for each workload, one seeded
    complex64 input on ``device`` (made once and reused), and a thunk that
    runs the public ``fft`` entry point with the candidate config."""
    from repro_torch.kernels.fft.ops import fft

    inputs: Dict[str, torch.Tensor] = {}

    def run(wl: Workload, cfg: Config) -> Callable[[], None]:
        x = inputs.get(wl.key)
        if x is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            x = torch.randn(wl.batch, wl.n, generator=gen, device=device,
                            dtype=torch.complex64)
            inputs[wl.key] = x
        return lambda: fft(x, config=cfg)

    return run


# the Mamba-2 block's SSD widths (mamba2-130m: 24 heads of 64, state 128)
SSD_HEADS, SSD_HEAD_DIM, SSD_STATE = 24, 64, 128


def make_ssd_runner(device: torch.device, seed: int = 0
                    ) -> Callable[[Workload, Config], Callable[[], None]]:
    """A ``WallClockObjective`` runner: for each workload (n = L, batch =
    B x SSD_HEADS), one seeded (x, a, b, c) at mamba2-130m's head width
    and state on ``device`` (made once and reused; a in [0.85, 0.999), as
    the tests draw it), and a thunk that runs the public ``ssd`` entry
    point with the candidate config."""
    from repro_torch.kernels.ssd.ops import ssd

    inputs: Dict[str, tuple] = {}

    def run(wl: Workload, cfg: Config) -> Callable[[], None]:
        args = inputs.get(wl.key)
        if args is None:
            heads, head_dim, state = SSD_HEADS, SSD_HEAD_DIM, SSD_STATE
            if wl.batch % heads:
                raise ValueError(f"ssd runner: batch {wl.batch} is not a "
                                 f"multiple of {heads} heads")
            B, L = wl.batch // heads, wl.n
            gen = torch.Generator(device=device).manual_seed(seed)
            dt = _DTYPES[wl.dtype]
            x = torch.randn(B, L, heads, head_dim, generator=gen,
                            device=device)
            a = torch.rand(B, L, heads, generator=gen, device=device) \
                * 0.149 + 0.85
            b = torch.randn(B, L, state, generator=gen, device=device) * 0.3
            c = torch.randn(B, L, state, generator=gen, device=device) * 0.3
            args = tuple(v.to(dt) for v in (x, a, b, c))
            inputs[wl.key] = args
        return lambda: ssd(*args, config=cfg)

    return run


def make_rglru_runner(device: torch.device, seed: int = 0
                      ) -> Callable[[Workload, Config], Callable[[], None]]:
    """A ``WallClockObjective`` runner: for each workload (n = L, batch =
    the channels D of one sequence), one seeded (a, u) of shape (1, L, D)
    on ``device`` (a in [0.8, 0.99)), and a thunk that runs the public
    ``rglru`` entry point with the candidate config."""
    from repro_torch.kernels.rglru.ops import rglru

    inputs: Dict[str, tuple] = {}

    def run(wl: Workload, cfg: Config) -> Callable[[], None]:
        args = inputs.get(wl.key)
        if args is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            dt = _DTYPES[wl.dtype]
            a = torch.rand(1, wl.n, wl.batch, generator=gen,
                           device=device) * 0.19 + 0.8
            u = torch.randn(1, wl.n, wl.batch, generator=gen, device=device)
            args = (a.to(dt), u.to(dt))
            inputs[wl.key] = args
        return lambda: rglru(*args, config=cfg)

    return run


# a qwen1.5-0.5b attention layer: 16 heads of 64 (4 sequences -> 64 rows)
ATTN_HEADS, ATTN_HEAD_DIM = 16, 64
# qwen1.5-0.5b's d_model: the K of its MLP up-projection
MATMUL_K = 1024


def make_attention_runner(device: torch.device, seed: int = 0
                          ) -> Callable[[Workload, Config], Callable[[], None]]:
    """A ``WallClockObjective`` runner: for each workload (n = L, batch =
    the flattened B x heads rows), one seeded causal self-attention input
    (q, k, v of shape (batch, n, ATTN_HEAD_DIM)) on ``device`` (made once
    and reused), and a thunk that runs the public ``attention`` entry point
    with the candidate config."""
    from repro_torch.kernels.attention.ops import attention

    inputs: Dict[str, tuple] = {}

    def run(wl: Workload, cfg: Config) -> Callable[[], None]:
        args = inputs.get(wl.key)
        if args is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            args = tuple(torch.randn(wl.batch, wl.n, ATTN_HEAD_DIM,
                                     generator=gen, device=device
                                     ).to(_DTYPES[wl.dtype])
                         for _ in range(3))
            inputs[wl.key] = args
        return lambda: attention(*args, causal=True, config=cfg)

    return run


def make_matmul_runner(device: torch.device, seed: int = 0
                       ) -> Callable[[Workload, Config], Callable[[], None]]:
    """A ``WallClockObjective`` runner: for each workload (batch = M rows,
    n = N columns), one seeded a (M, MATMUL_K) and b (MATMUL_K, N) on
    ``device`` (made once and reused), and a thunk that runs the public
    ``matmul`` entry point with the candidate config."""
    from repro_torch.kernels.matmul.ops import matmul

    inputs: Dict[str, tuple] = {}

    def run(wl: Workload, cfg: Config) -> Callable[[], None]:
        args = inputs.get(wl.key)
        if args is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            dt = _DTYPES[wl.dtype]
            args = (torch.randn(wl.batch, MATMUL_K, generator=gen,
                                device=device).to(dt),
                    torch.randn(MATMUL_K, wl.n, generator=gen,
                                device=device).to(dt))
            inputs[wl.key] = args
        return lambda: matmul(*args, config=cfg)

    return run


# op -> (runner factory, the variants its entry point takes)
_OPS = {"scan": (make_scan_runner, ("ks", "lf", "linrec")),
        "tridiag": (make_tridiag_runner, ("pcr", "cr", "lf", "wm", "thomas")),
        "fft": (make_fft_runner, ("stockham",)),
        "ssd": (make_ssd_runner, ("chunked",)),
        "rglru": (make_rglru_runner, ("",)),
        "attention": (make_attention_runner, ("flash",)),
        "matmul": (make_matmul_runner, ("tiled",))}


def _workloads(args) -> List[Workload]:
    if args.op not in _OPS:
        raise SystemExit(f"--op {args.op}: only "
                         f"{', '.join(repr(op) for op in _OPS)} are ported "
                         f"so far (see ROADMAP.md)")
    if args.variant is None:
        # ks, as before; an op without variants (rglru) takes none
        args.variant = "" if _OPS[args.op][1] == ("",) else "ks"
    if args.variant not in _OPS[args.op][1]:
        raise SystemExit(f"--variant {args.variant}: --op {args.op} takes "
                         f"{', '.join(_OPS[args.op][1])}")
    sizes = [int(s) for s in args.sizes.split(",") if s]
    if not sizes:
        raise SystemExit("--sizes: give at least one problem size")

    def batch(n: int) -> int:
        # problems per invocation: 2^26 / n rows for the paper's ops, the
        # mamba2-130m prefill's 8 sequences x 24 heads for ssd, qwen's 4
        # sequences x 16 heads for attention, 4 x 2048 token rows for matmul
        if args.batch:
            return args.batch
        if args.op == "ssd":
            return 8 * SSD_HEADS
        if args.op == "attention":
            return 4 * ATTN_HEADS
        if args.op == "matmul":
            return 4 * 2048
        return max(TOTAL_ELEMS // n, 1)

    return [Workload(op=args.op, n=n, batch=batch(n), dtype=args.dtype,
                     variant=args.variant) for n in sizes]


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--op", default="scan")
    ap.add_argument("--variant", default=None)
    ap.add_argument("--sizes", default="1024")
    ap.add_argument("--batch", type=int, default=0,
                    help="problems per invocation (default 2^26 / n; for "
                         "ssd 8 sequences x 24 heads, for attention 4 x 16 "
                         "heads, for matmul 8192 rows)")
    ap.add_argument("--dtype", default="float32", choices=sorted(_DTYPES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the kernels) or cpu (their plain "
                         "versions)")
    ap.add_argument("--objective", default="wallclock",
                    choices=("wallclock", "cost"),
                    help="measure on --device, or score on the h100 cost "
                         "model")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)


def _objective_factory(args, device: torch.device,
                       made: List[Objective]) -> Callable[[], Objective]:
    runner = _OPS[args.op][0](device, args.seed)

    def factory() -> Objective:
        obj = CostModelObjective() if args.objective == "cost" \
            else WallClockObjective(runner, reps=args.reps,
                                    device=str(device))
        made.append(obj)
        return obj

    return factory


def compare_methods_main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="tune compare-methods",
                                 description="Score every methodology "
                                             "against the exhaustive optimum")
    _add_common(ap)
    ap.add_argument("--methods", default="exhaustive,analytical,bayesian,"
                                         "random")
    ap.add_argument("--max-evals", type=int, default=20)
    ap.add_argument("--journal-dir", default=None,
                    help="checkpoint/resume the exhaustive sweeps here")
    ap.add_argument("--json", default=None, help="write the report here")
    args = ap.parse_args(argv)

    from repro_torch.evaluation import (check_report, compare_methods,
                                        format_report)

    device = resolve_device(args.device)
    workloads = _workloads(args)
    methods = tuple(m for m in args.methods.split(",") if m)
    made: List[Objective] = []
    report = compare_methods(
        workloads, methods,
        objective_factory=_objective_factory(args, device, made),
        seed=args.seed, max_evals=args.max_evals,
        journal_dir=args.journal_dir)
    failures = sum(getattr(o, "failures", 0) for o in made)
    report["device"] = {"type": device.type, "objective": args.objective,
                        "name": torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"}
    report["runner_failures"] = failures
    print(format_report(report))
    for row in report["workloads"]:
        print(f"[compare-methods] {row['workload']}: sweep "
              f"{row['space_size']} configs, optimum "
              f"{row['best_time_s'] * 1e3:.4f} ms")
    print(f"[compare-methods] runner failures: {failures}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f"[compare-methods] report written to {args.json}")
    problems = check_report(report)
    for p in problems:
        print(f"[compare-methods] FAIL: {p}", file=sys.stderr)
    return 1 if problems or failures else 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "compare-methods":
        return compare_methods_main(argv[1:])

    ap = argparse.ArgumentParser(prog="tune")
    _add_common(ap)
    ap.add_argument("--method", default="bayesian",
                    choices=list(strategies()))
    ap.add_argument("--max-evals", type=int, default=64)
    ap.add_argument("--db", default=None,
                    help="path to the tuning DB (default: the session DB)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    workloads = _workloads(args)
    session = TunerSession(db_path=args.db)
    factory = _objective_factory(args, device, [])
    for wl in workloads:
        res = session.tune(wl, method=args.method, objective=factory(),
                           seed=args.seed, max_evals=args.max_evals)
        print(f"[tune] {wl.key}: {res.best_config} "
              f"t={res.best_time * 1e6:.1f}us evals={res.evaluations}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
