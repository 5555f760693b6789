"""Offline tuning CLI of the port: the paper's loop on the prefix-sum scan,
the linear recurrence, the tridiagonal solvers, the FFT, the SSD op, the
RG-LRU, flash attention and the tiled matmul, and its ML-based methodology.

Tune one workload per size and persist the winner in a TuningDB:

  PYTHONPATH=src python -m repro_torch.launch.tune --op scan --variant ks \\
      --sizes 1024,4096 --method bayesian --db artifacts/tuning_db_torch.json
  PYTHONPATH=src python -m repro_torch.launch.tune --paper-suite \\
      --method analytical --db artifacts/tuning_db_torch.json

``--paper-suite`` tunes every workload of ``configs/paper_ops.PREFIX_OPS``
(2^26 / n problems each) on the active profile's cost model with 2% noise,
as the JAX package's ``tune_suite`` does; it measures nothing, so it
ignores ``--device``, ``--op`` and ``--sizes``.

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
entry point (``prefix_sum``, or ``linear_recurrence`` for --variant linrec;
``solve`` on a diagonally dominant system,
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
``--methods`` defaults to exhaustive, analytical, ml, online, bayesian and
random (``transfer`` is registered too);
``--model`` names the artifact ``ml`` reads (``$REPRO_TORCH_ML_MODEL``).
``--policy energy|edp|memory_cap[:bytes]`` tunes (and stores) under that
policy; ``compare-methods --policies latency,energy,edp,memory_cap``
scores every method per policy on the sweep's metric vectors, and any
(method, policy) Phi > 1 fails.

Cross-device transfer, two commands: the device matrix scores each profile
on its own cost model on the host and journals every sweep, then the card
measures, and its ``transfer`` row warm-starts from the other profiles'
journals (weighted by ``exp(-profile_distance)``):

  PYTHONPATH=src python -m repro_torch.launch.tune compare-methods \
      --device-matrix --objective cost --profiles tpu_v5e,gpu_sm \
      --op scan --sizes 1024,4096 --journal-dir artifacts/transfer
  PYTHONPATH=src python -m repro_torch.launch.tune compare-methods \
      --methods analytical,bayesian,transfer --journal-dir artifacts/transfer \
      --op scan --sizes 1024,4096

``--device-matrix`` needs ``--objective cost`` (one card measures one
device) and refuses otherwise.

The ML-based methodology (the paper's offline-train / online-predict flow):

  PYTHONPATH=src python -m repro_torch.launch.tune train-model \\
      --out artifacts/ml_model_torch.npz --journal-dir artifacts/ml_train
  PYTHONPATH=src python -m repro_torch.launch.tune eval-model \\
      --model artifacts/ml_model_torch.npz --journal-dir artifacts/ml_holdout

``train-model`` sweeps every config of the suite's train sizes (the
``repro_torch.tuning.ml`` ``SUITE``), trains one forest per op family and
saves the artifact; ``eval-model`` scores the artifact's choices on the
held-out sizes (top-1, slowdown, the rungs that answered, rank
correlation) and exits non-zero when a ``--min-*`` / ``--max-slowdown``
floor is violated.  On the card they measure ``card_workloads`` (the
suite at sizes the card holds); ``--device cpu --objective cost`` sweeps
``SUITE`` on the cost model of the active profile (``h100`` unless
``$REPRO_TORCH_HW_PROFILE`` says otherwise), as the JAX package's
commands do with theirs.

Online tuning replay (the deployment mode's deterministic test bench):

  PYTHONPATH=src python -m repro_torch.launch.tune online-replay \\
      --trace artifacts/serve_trace.jsonl [--db tuning_db.json] [--budget 32]

replays a recorded (config, step latency) trace — e.g. from
``repro_torch.launch.serve --record-trace`` — through the OnlineTuner
state machine (``online_replay``): same trace + same knobs -> same
trials, same rollbacks, same winner.  With ``--db`` the promoted winner
persists exactly as it would in production.  It measures nothing, so it
takes no ``--device``.

Static analysis (zero-execution):

  PYTHONPATH=src python -m repro_torch.launch.tune lint [--json REPORT] \\
      [--baseline tests/fixtures/analysis_baseline_torch.json] \\
      [--no-invariants] [--root src/repro_torch]

runs the full :mod:`repro_torch.analysis` pass — the repo-convention AST
lint over ``src/repro_torch``, the contract fingerprints against
``tests/fixtures/analysis_fingerprints_torch.json``, and the plan / space
invariants for every op x profile of the port — and exits 1 while any
finding is not suppressed by the baseline.  ``--write-fingerprints``
refreshes the pinned contract fixture after a deliberate, version-bumped
schema change.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.paper_ops import PREFIX_OPS, TOTAL_ELEMS
from repro_torch.core import CostModelObjective, WallClockObjective, Workload
from repro_torch.core.objective import METRIC_TIME, CachedObjective, Objective
from repro_torch.core.space import Config, build_space
from repro_torch.evaluation.compare import DEFAULT_METHODS
from repro_torch.tuning import (SweepJournal, TunerSession, default_session,
                                resolve_device, run_sweep, strategies)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _latest(make: Callable[[Workload], Any]) -> Callable[[Workload], Any]:
    """``make(wl)``, kept until another workload is asked for: a runner that
    sweeps many workloads holds one workload's input at a time."""
    held: Dict[str, Any] = {}

    def get(wl: Workload) -> Any:
        if wl.key not in held:
            held.clear()
            held[wl.key] = make(wl)
        return held[wl.key]

    return get


def make_scan_runner(device: torch.device, seed: int = 0
                     ) -> Callable[[Workload, Config], Callable[[], None]]:
    """A ``WallClockObjective`` runner: for each workload, one seeded input
    on ``device`` (made once and reused while the workload's configs run),
    and a thunk that runs the public entry point with the candidate config:
    ``linear_recurrence`` on (a, b), a in [0.8, 0.99), for variant linrec,
    else ``prefix_sum``."""
    from repro_torch.kernels.scan.ops import linear_recurrence, prefix_sum

    def make(wl: Workload) -> tuple:
        gen = torch.Generator(device=device).manual_seed(seed)
        dt = _DTYPES[wl.dtype]
        if wl.variant == "linrec":
            a = torch.rand(wl.batch, wl.n, generator=gen,
                           device=device) * 0.19 + 0.8
            b = torch.randn(wl.batch, wl.n, generator=gen, device=device)
            return a.to(dt), b.to(dt)
        return (torch.randn(wl.batch, wl.n, generator=gen, device=device,
                            dtype=torch.float32).to(dt),)

    inputs = _latest(make)

    def run(wl: Workload, cfg: Config) -> Callable[[], None]:
        args = inputs(wl)
        if wl.variant == "linrec":
            return lambda: linear_recurrence(*args, config=cfg)
        return lambda: prefix_sum(*args, variant=wl.variant, config=cfg)

    return run


def make_tridiag_runner(device: torch.device, seed: int = 0
                        ) -> Callable[[Workload, Config], Callable[[], None]]:
    """A ``WallClockObjective`` runner: for each workload, one seeded
    diagonally dominant system on ``device`` (made once and reused), and a
    thunk that runs the public ``solve`` entry point with the candidate
    config."""
    from repro_torch.kernels.tridiag.ops import solve
    from repro_torch.kernels.tridiag.ref import random_system

    def make(wl: Workload) -> tuple:
        gen = torch.Generator(device=device).manual_seed(seed)
        return tuple(v.to(_DTYPES[wl.dtype]) for v in
                     random_system(gen, wl.batch, wl.n, device=device))

    systems = _latest(make)

    def run(wl: Workload, cfg: Config) -> Callable[[], None]:
        system = systems(wl)
        return lambda: solve(*system, variant=wl.variant, config=cfg)

    return run


def make_fft_runner(device: torch.device, seed: int = 0
                    ) -> Callable[[Workload, Config], Callable[[], None]]:
    """A ``WallClockObjective`` runner: for each workload, one seeded
    complex64 input on ``device`` (made once and reused), and a thunk that
    runs the public ``fft`` entry point with the candidate config."""
    from repro_torch.kernels.fft.ops import fft

    def make(wl: Workload) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(seed)
        return torch.randn(wl.batch, wl.n, generator=gen, device=device,
                           dtype=torch.complex64)

    inputs = _latest(make)

    def run(wl: Workload, cfg: Config) -> Callable[[], None]:
        x = inputs(wl)
        return lambda: fft(x, config=cfg)

    return run


# the Mamba-2 block's SSD widths (mamba2-130m: 24 heads of 64, state 128)
SSD_HEADS, SSD_HEAD_DIM, SSD_STATE = 24, 64, 128
# the mamba2-130m prefill's rows: 8 sequences x 24 heads
SSD_ROWS = 8 * SSD_HEADS


def make_ssd_runner(device: torch.device, seed: int = 0
                    ) -> Callable[[Workload, Config], Callable[[], None]]:
    """A ``WallClockObjective`` runner: for each workload (n = L, batch =
    B x SSD_HEADS), one seeded (x, a, b, c) at mamba2-130m's head width
    and state on ``device`` (made once and reused; a in [0.85, 0.999), as
    the tests draw it), and a thunk that runs the public ``ssd`` entry
    point with the candidate config."""
    from repro_torch.kernels.ssd.ops import ssd

    def make(wl: Workload) -> tuple:
        heads, head_dim, state = SSD_HEADS, SSD_HEAD_DIM, SSD_STATE
        if wl.batch % heads:
            raise ValueError(f"ssd runner: batch {wl.batch} is not a "
                             f"multiple of {heads} heads")
        B, L = wl.batch // heads, wl.n
        gen = torch.Generator(device=device).manual_seed(seed)
        dt = _DTYPES[wl.dtype]
        x = torch.randn(B, L, heads, head_dim, generator=gen, device=device)
        a = torch.rand(B, L, heads, generator=gen, device=device) \
            * 0.149 + 0.85
        b = torch.randn(B, L, state, generator=gen, device=device) * 0.3
        c = torch.randn(B, L, state, generator=gen, device=device) * 0.3
        return tuple(v.to(dt) for v in (x, a, b, c))

    inputs = _latest(make)

    def run(wl: Workload, cfg: Config) -> Callable[[], None]:
        args = inputs(wl)
        return lambda: ssd(*args, config=cfg)

    return run


def make_rglru_runner(device: torch.device, seed: int = 0
                      ) -> Callable[[Workload, Config], Callable[[], None]]:
    """A ``WallClockObjective`` runner: for each workload (n = L, batch =
    the channels D of one sequence), one seeded (a, u) of shape (1, L, D)
    on ``device`` (a in [0.8, 0.99)), and a thunk that runs the public
    ``rglru`` entry point with the candidate config."""
    from repro_torch.kernels.rglru.ops import rglru

    def make(wl: Workload) -> tuple:
        gen = torch.Generator(device=device).manual_seed(seed)
        dt = _DTYPES[wl.dtype]
        a = torch.rand(1, wl.n, wl.batch, generator=gen,
                       device=device) * 0.19 + 0.8
        u = torch.randn(1, wl.n, wl.batch, generator=gen, device=device)
        return a.to(dt), u.to(dt)

    inputs = _latest(make)

    def run(wl: Workload, cfg: Config) -> Callable[[], None]:
        args = inputs(wl)
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

    def make(wl: Workload) -> tuple:
        gen = torch.Generator(device=device).manual_seed(seed)
        return tuple(torch.randn(wl.batch, wl.n, ATTN_HEAD_DIM,
                                 generator=gen, device=device
                                 ).to(_DTYPES[wl.dtype]) for _ in range(3))

    inputs = _latest(make)

    def run(wl: Workload, cfg: Config) -> Callable[[], None]:
        args = inputs(wl)
        return lambda: attention(*args, causal=True, config=cfg)

    return run


def make_matmul_runner(device: torch.device, seed: int = 0
                       ) -> Callable[[Workload, Config], Callable[[], None]]:
    """A ``WallClockObjective`` runner: for each workload (batch = M rows,
    n = N columns), one seeded a (M, MATMUL_K) and b (MATMUL_K, N) on
    ``device`` (made once and reused), and a thunk that runs the public
    ``matmul`` entry point with the candidate config."""
    from repro_torch.kernels.matmul.ops import matmul

    def make(wl: Workload) -> tuple:
        gen = torch.Generator(device=device).manual_seed(seed)
        dt = _DTYPES[wl.dtype]
        return (torch.randn(wl.batch, MATMUL_K, generator=gen,
                            device=device).to(dt),
                torch.randn(MATMUL_K, wl.n, generator=gen,
                            device=device).to(dt))

    inputs = _latest(make)

    def run(wl: Workload, cfg: Config) -> Callable[[], None]:
        args = inputs(wl)
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


# ---------------------------------------------------------------------------
# The ML methodology's suite on the card
# ---------------------------------------------------------------------------

# SUITE's "" variants as the runners' entry points name them
_CARD_VARIANTS = {"ssd": "chunked", "matmul": "tiled"}
# the type each framework kernel runs in the models (the tensor cores)
_CARD_DTYPES = {"attention": "bfloat16", "matmul": "bfloat16"}


def card_workloads(split: str = "train",
                   ops: Optional[List[str]] = None) -> List[Workload]:
    """``SUITE``'s split as the card measures it.

    The sizes and the train / holdout split are ``SUITE``'s; the paper's
    2^26 / n problems stay for scan, tridiag, fft, large_fft and rglru.
    ssd runs at the mamba2-130m prefill's ``SSD_ROWS`` (2^26 / n rows of 24
    heads of 64 would not fit), variant chunked; attention (flash) and
    matmul (tiled) keep ``SUITE``'s rows in bf16, the type the models run
    them in.  A large_fft size at or below the active profile's resident
    cap is left out: ``fft`` runs it in one launch, so every four-step
    config would time the same plan.
    """
    from repro_torch.core.multikernel import max_resident_tile
    from repro_torch.tuning.ml import suite_workloads

    out = []
    for wl in suite_workloads(split, ops=ops):
        if wl.op == "large_fft" and wl.n <= max_resident_tile(
                Workload(op="fft", n=wl.n, batch=wl.batch,
                         variant="stockham")):
            continue
        out.append(dataclasses.replace(
            wl, batch=SSD_ROWS if wl.op == "ssd" else wl.batch,
            variant=_CARD_VARIANTS.get(wl.op, wl.variant),
            dtype=_CARD_DTYPES.get(wl.op, wl.dtype)))
    return out


def make_suite_runner(device: torch.device, seed: int = 0
                      ) -> Callable[[Workload, Config], Callable[[], None]]:
    """One ``WallClockObjective`` runner for every op of the suite: it hands
    each workload to its op's runner (large_fft to ``fft``'s) and drops the
    previous op's runner, and its input, when the op changes."""
    factories = {op: make for op, (make, _) in _OPS.items()}
    factories["large_fft"] = factories["fft"]
    current: Dict[str, Callable] = {}

    def run(wl: Workload, cfg: Config) -> Callable[[], None]:
        if wl.op not in current:
            current.clear()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            current[wl.op] = factories[wl.op](device, seed)
        return current[wl.op](wl, cfg)

    return run


def sweep_into(objective: CachedObjective, workloads: List[Workload],
               journal_dir: str) -> None:
    """Sweep every workload into its journal under ``journal_dir``, resuming
    what is there, and seed ``objective`` with each journaled metric
    vector, so whatever reads these workloads through it next measures no
    config a second time."""
    for wl in workloads:
        wl = wl.canonical()
        space = build_space(wl)
        journal = SweepJournal.for_workload(journal_dir, wl, objective)
        run_sweep(space, objective, journal=journal)
        entries = journal.metric_entries()
        objective.seed(space, [(cfg, vec[METRIC_TIME]) for cfg, vec in entries],
                       [vec for _, vec in entries])


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
            return SSD_ROWS
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
    _add_measure(ap)


def _add_measure(ap: argparse.ArgumentParser) -> None:
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
    runner = make_suite_runner(device, args.seed)

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
    ap.add_argument("--methods", default=",".join(DEFAULT_METHODS))
    ap.add_argument("--model", default=None,
                    help="ML model artifact for strategy='ml' (sets "
                         "$REPRO_TORCH_ML_MODEL; default: the session "
                         "default)")
    ap.add_argument("--max-evals", type=int, default=20)
    ap.add_argument("--journal-dir", default=None,
                    help="checkpoint/resume the exhaustive sweeps here")
    ap.add_argument("--json", default=None, help="write the report here")
    ap.add_argument("--split", default=None, choices=("train", "holdout"),
                    help="score the ML suite's split instead of --op / "
                         "--sizes (SUITE on the cost model, card_workloads "
                         "on the card)")
    ap.add_argument("--ops", default=None,
                    help="comma list of the suite's ops for --split "
                         "(default: all)")
    ap.add_argument("--policies", default="latency",
                    help="comma list of tuning policies to score per method "
                         "(latency, energy, edp, memory_cap[:bytes]); any "
                         "(method, policy) Phi > 1 fails")
    ap.add_argument("--device-matrix", action="store_true",
                    help="run the comparison once per hardware profile, each "
                         "on its own cost model (--objective cost), and gate "
                         "every (device, method) cell on Phi <= 1; the "
                         "methods default to analytical, bayesian, transfer "
                         "unless --methods is given")
    ap.add_argument("--profiles", default=None,
                    help="comma list of hardware profiles for --device-matrix "
                         "(default: tpu_v5e,gpu_sm,cpu_interpret; order "
                         "matters — earlier devices' journals seed "
                         "strategy='transfer' on later ones)")
    args = ap.parse_args(argv)

    from repro_torch.evaluation import (check_report, compare_methods,
                                        format_report)

    if args.model:
        os.environ["REPRO_TORCH_ML_MODEL"] = os.path.abspath(args.model)
    policies = tuple(p for p in args.policies.split(",") if p)
    if args.device_matrix:
        if args.objective != "cost":
            ap.error("--device-matrix scores every profile on its own cost "
                     "model: pass --objective cost (a card measures one "
                     "device; compare-methods --methods ...,transfer "
                     "--journal-dir D on the card reads the matrix's "
                     "journals)")
        return _device_matrix(args, argv, policies)
    device = resolve_device(args.device)
    try:
        workloads = _suite(args, args.split) if args.split \
            else _workloads(args)
    except ValueError as e:
        ap.error(str(e))
    methods = tuple(m for m in args.methods.split(",") if m)
    made: List[Objective] = []
    report = compare_methods(
        workloads, methods,
        objective_factory=_objective_factory(args, device, made),
        seed=args.seed, max_evals=args.max_evals,
        journal_dir=args.journal_dir, policies=policies)
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


def _device_matrix(args, argv: List[str], policies) -> int:
    """``compare-methods --device-matrix``: ``compare_methods_matrix`` over
    ``--profiles``, each on its own cost model, journals shared in
    ``--journal-dir`` (a temporary directory by default) so
    ``strategy="transfer"`` on later profiles warm-starts from earlier
    ones."""
    import tempfile

    from repro_torch.evaluation import (check_matrix, compare_methods_matrix,
                                        format_matrix)
    from repro_torch.evaluation.compare import (DEFAULT_MATRIX_METHODS,
                                                DEFAULT_MATRIX_PROFILES)

    explicit_methods = any(a == "--methods" or a.startswith("--methods=")
                           for a in argv)
    methods = tuple(m for m in args.methods.split(",") if m) \
        if explicit_methods else DEFAULT_MATRIX_METHODS
    profiles = tuple(p for p in args.profiles.split(",") if p) \
        if args.profiles else DEFAULT_MATRIX_PROFILES
    workloads = _suite(args, args.split) if args.split else _workloads(args)
    journal_dir = args.journal_dir or tempfile.mkdtemp(
        prefix="repro_torch_matrix_journals_")
    print(f"[compare-methods] device matrix: {len(workloads)} workloads x "
          f"{len(methods)} methodologies x {len(profiles)} profiles, "
          f"journals in {journal_dir}", flush=True)
    matrix = compare_methods_matrix(
        workloads, methods, profiles, seed=args.seed,
        max_evals=args.max_evals, journal_dir=journal_dir, policies=policies)
    print(format_matrix(matrix))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(matrix, f, indent=1, sort_keys=True)
        print(f"[compare-methods] matrix report written to {args.json}")
    failures = check_matrix(matrix)
    for failure in failures:
        print(f"[compare-methods] FAIL: {failure}", file=sys.stderr)
    return 1 if failures else 0


# ---------------------------------------------------------------------------
# ML model subcommands
# ---------------------------------------------------------------------------

def _suite(args, split: str) -> List[Workload]:
    """The cost model sweeps ``SUITE`` as it stands, as the JAX package's
    train-model does; measured times come from ``card_workloads``."""
    from repro_torch.tuning.ml import suite_workloads
    ops = [s for s in args.ops.split(",") if s] if args.ops else None
    pick = suite_workloads if args.objective == "cost" else card_workloads
    return pick(split, ops=ops)


def _suite_objective(args, device: torch.device) -> Objective:
    if args.objective == "cost":
        return CostModelObjective()
    return WallClockObjective(make_suite_runner(device, args.seed),
                              reps=args.reps, device=str(device))


def train_model_main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="tune train-model",
                                 description="Train the ML config predictor")
    ap.add_argument("--out", required=True, help="model artifact (.npz) path")
    ap.add_argument("--ops", default=None,
                    help="comma list of ops (default: the full suite)")
    ap.add_argument("--db", default=None,
                    help="TuningDB: sweep winners are stored here and "
                         "existing records join the training set")
    ap.add_argument("--trees", type=int, default=48)
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--journal-dir", default=None,
                    help="checkpoint the exhaustive sweeps as JSONL journals "
                         "here; an interrupted train-model rerun resumes "
                         "instead of re-evaluating")
    _add_measure(ap)
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.tuning.db import TuningDB
    from repro_torch.tuning.ml import (build_dataset, dataset_from_db, merge,
                                       train_bundle)
    from repro_torch.tuning.ml.dataset import POOLED_OPS

    device = resolve_device(args.device)
    try:
        workloads = _suite(args, "train")
    except ValueError as e:
        ap.error(str(e))
    objective = _suite_objective(args, device)
    print(f"[train-model] sweeping {len(workloads)} workloads ...", flush=True)

    prior = None
    on_sweep = None
    if args.db:
        db = TuningDB(path=args.db)
        prior = dataset_from_db(db)

        def on_sweep(wl, cfgs, times):   # persist each winner
            i = int(np.argmin(times))
            db.store(wl, cfgs[i], float(times[i]), "exhaustive", len(cfgs))

    ds = build_dataset(workloads, objective, on_sweep=on_sweep,
                       journal_dir=args.journal_dir)
    if prior is not None and len(prior):
        print(f"[train-model] +{len(prior)} rows from TuningDB {args.db}",
              flush=True)
        ds = merge(ds, prior)

    print(f"[train-model] {len(ds)} rows; training "
          f"(trees={args.trees}, depth={args.depth}, seed={args.seed})",
          flush=True)
    bundle = train_bundle(ds.by_op(), n_trees=args.trees,
                          max_depth=args.depth, seed=args.seed,
                          meta={"aliases": POOLED_OPS})
    path = bundle.save(args.out)
    for op, rows in sorted(bundle.meta["train_rows"].items()):
        print(f"[train-model]   {op}: {rows} rows")
    print(f"[train-model] saved {path}")
    return 0


def eval_model_main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="tune eval-model",
                                 description="Evaluate the ML config "
                                             "predictor on held-out sizes")
    ap.add_argument("--model", required=True, help="model artifact (.npz)")
    ap.add_argument("--ops", default=None,
                    help="comma list of ops (default: the full holdout suite)")
    ap.add_argument("--min-top1", type=float, default=None,
                    help="fail when top-1 match rate drops below this floor")
    ap.add_argument("--max-slowdown", type=float, default=None,
                    help="fail when mean slowdown exceeds this ceiling")
    ap.add_argument("--min-ml-rate", type=float, default=None,
                    help="fail when the fraction of workloads answered by "
                         "the learned rungs (vs fallbacks) drops below this")
    ap.add_argument("--min-rank-corr", type=float, default=None,
                    help="fail when the forest's mean predicted-vs-true "
                         "rank correlation drops below this (catches a "
                         "degenerate model hiding behind analytical defers)")
    ap.add_argument("--journal-dir", default=None,
                    help="sweep the holdout sizes into journals here "
                         "(resuming what is there) before scoring")
    ap.add_argument("--json", default=None, help="write the full report here")
    _add_measure(ap)
    args = ap.parse_args(argv)

    from repro_torch.tuning.ml import (ModelBundle, check_floors,
                                       evaluate_model)

    device = resolve_device(args.device)
    bundle = ModelBundle.load(args.model)
    try:
        workloads = _suite(args, "holdout")
    except ValueError as e:
        ap.error(str(e))
    objective = CachedObjective(_suite_objective(args, device))
    if args.journal_dir:
        sweep_into(objective, workloads, args.journal_dir)
    report = evaluate_model(bundle, workloads, objective)

    print(f"[eval-model] {report['n_scored']} holdout workloads scored; "
          f"rungs: {report.get('rungs', {})}")
    for op, r in sorted(report.get("per_op", {}).items()):
        print(f"[eval-model]   {op:<10} top1={r['top1_rate']:5.1%}  "
              f"mean={r['mean_slowdown']:.3f}x  max={r['max_slowdown']:.3f}x  "
              f"(n={r['n']})")
    if report["n_scored"]:
        print(f"[eval-model] overall    top1={report['top1_rate']:5.1%}  "
              f"mean={report['mean_slowdown']:.3f}x  "
              f"max={report['max_slowdown']:.3f}x  "
              f"ml_rate={report['ml_rate']:5.1%}  "
              f"rank_corr={report['mean_rank_corr']:.3f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f"[eval-model] report written to {args.json}")

    failures = check_floors(report, min_top1=args.min_top1,
                            max_mean_slowdown=args.max_slowdown,
                            min_ml_rate=args.min_ml_rate,
                            min_rank_corr=args.min_rank_corr)
    for failure in failures:
        print(f"[eval-model] FAIL: {failure}", file=sys.stderr)
    return 1 if failures else 0


def online_replay_main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="tune online-replay",
                                 description="Replay a recorded serving "
                                             "trace through the OnlineTuner")
    ap.add_argument("--trace", required=True,
                    help="JSONL trace from launch.serve --record-trace")
    ap.add_argument("--db", default=None,
                    help="TuningDB to persist the promoted winner into "
                         "(default: replay only, nothing stored)")
    ap.add_argument("--journal-dir", default=None,
                    help="journal trial EWMAs here (sweep-journal format)")
    ap.add_argument("--budget", type=int, default=32)
    ap.add_argument("--guard-band", type=float, default=0.25)
    ap.add_argument("--min-samples", type=int, default=3)
    ap.add_argument("--samples-per-trial", type=int, default=8)
    ap.add_argument("--json", default=None, help="write the summary here")
    args = ap.parse_args(argv)
    s, res = online_replay(args.trace, db=args.db,
                           journal_dir=args.journal_dir, budget=args.budget,
                           guard_band=args.guard_band,
                           min_samples=args.min_samples,
                           samples_per_trial=args.samples_per_trial)
    for t in s["trials"]:
        ewma = f"{t['ewma_s']*1e3:.3f}ms" if t["ewma_s"] else "-"
        print(f"[online-replay]   {t['config']} -> {t['state']} "
              f"(samples={t['samples']}, ewma={ewma})")
    print(f"[online-replay] winner {res.best_config} "
          f"ewma={res.best_time*1e3:.3f}ms"
          + (f" (persisted to {args.db})" if args.db and s["promotions"]
             else ""))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(s, f, indent=1, sort_keys=True)
        print(f"[online-replay] summary written to {args.json}")
    return 0


def online_replay(trace_path: str, *, db: Optional[str] = None,
                  journal_dir: Optional[str] = None, budget: int = 32,
                  guard_band: float = 0.25, min_samples: int = 3,
                  samples_per_trial: int = 8):
    """Replay a recorded (config, step latency) trace — e.g. from
    ``repro_torch.launch.serve --record-trace`` — through the OnlineTuner
    state machine: same trace + same knobs -> same trials, same
    rollbacks, same winner.  With ``db`` the promoted winner persists as
    it would in production.  Returns the tuner's summary and result."""
    from repro_torch.core.analytical import AnalyticalTuner
    from repro_torch.tuning.online import (OnlineTuner, ReplayTrace, replay,
                                           replay_candidates)
    from repro_torch.tuning.sweep import config_key

    trace = ReplayTrace.load(trace_path)
    wl = trace.workload.canonical()
    session = TunerSession(db_path=db) if db else None
    store = session is not None

    prior = session.resolve_raw(wl) if session is not None \
        else AnalyticalTuner().suggest(build_space(wl))
    if config_key(prior) not in trace.times:
        # the trace never measured the configured prior (e.g. a DB-less
        # replay of someone else's traffic): start from the config the
        # traffic actually ran, so the baseline is a real measurement
        first = next(iter(trace.configs))
        print(f"[online-replay] prior not in trace; using recorded config "
              f"{trace.configs[first]} as incumbent")
        prior = trace.configs[first]
    # trial only configs the trace can answer for — every recorded config
    # stays in the queue (expert-ranked, never truncated: the trace's
    # measured winner may rank poorly analytically and must still run)
    candidates = replay_candidates(build_space(wl), trace, prior)

    tuner = OnlineTuner(wl, session, prior=prior, candidates=candidates,
                        budget=budget, guard_band=guard_band,
                        min_samples=min_samples,
                        samples_per_trial=samples_per_trial,
                        journal_dir=journal_dir, store=store,
                        source=trace.source)
    res = replay(tuner, trace)
    s = tuner.summary()
    print(f"[online-replay] {wl.key}: {trace.steps()} recorded steps, "
          f"{len(candidates)} candidates")
    print(f"[online-replay] stopped_by={res.stopped_by} "
          f"measured={s['measured']}/{s['budget']} "
          f"promotions={s['promotions']}")
    return s, res


def lint_main(argv: List[str]) -> int:
    from repro_torch.analysis import (apply_baseline, default_fixture_path,
                                      load_baseline, report_dict, run_lint,
                                      write_fingerprints)
    ap = argparse.ArgumentParser(
        prog="tune lint",
        description="zero-execution static analysis of the port: AST "
                    "conventions, contract fingerprints, plan/space "
                    "invariants")
    ap.add_argument("--json", default=None,
                    help="write the full machine-readable report here")
    ap.add_argument("--baseline", default=None,
                    help="suppression file (default: "
                         "tests/fixtures/analysis_baseline_torch.json when "
                         "present)")
    ap.add_argument("--write-fingerprints", action="store_true",
                    help="refresh the pinned contract fixture from the "
                         "live tree (after a deliberate, version-bumped "
                         "schema change)")
    ap.add_argument("--no-invariants", action="store_true",
                    help="skip the op x profile semantic sweep (fast "
                         "pre-commit mode)")
    ap.add_argument("--root", default=None,
                    help="package root to AST-lint (default: the "
                         "installed repro_torch package)")
    args = ap.parse_args(argv)

    fixture = default_fixture_path()
    if args.write_fingerprints:
        write_fingerprints(fixture)
        print(f"[lint] fingerprints written to {fixture}")

    findings = run_lint(pkg_root=args.root, fingerprint_path=fixture,
                        invariants=not args.no_invariants)
    baseline = args.baseline
    if baseline is None:
        cand = os.path.join(os.path.dirname(fixture),
                            "analysis_baseline_torch.json")
        baseline = cand if os.path.exists(cand) else None
    fresh, suppressed = apply_baseline(findings, load_baseline(baseline))
    for f in fresh:
        print(f.render())
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report_dict(fresh, suppressed), fh, indent=1,
                      sort_keys=True)
        print(f"[lint] report written to {args.json}")
    print(f"[lint] {len(fresh)} finding(s), {len(suppressed)} baselined")
    return 1 if fresh else 0


def tune_suite(method: str, noise: float = 0.02, verbose: bool = True,
               session: Optional[TunerSession] = None, seed: int = 0) -> None:
    """Tune every workload of the paper's suite (``PREFIX_OPS``, 2^26 / n
    problems each) on the active profile's cost model, as the JAX
    package's ``tune_suite`` does, persisting each winner."""
    session = session or default_session()
    for op, spec in PREFIX_OPS.items():
        for variant in spec["variants"]:
            for n in spec["sizes"]:
                wl = Workload(op=op, n=n, batch=max(TOTAL_ELEMS // n, 1),
                              variant=variant)
                res = session.tune(wl, method=method, seed=seed,
                                   objective=CostModelObjective(noise=noise))
                if verbose:
                    print(f"[tune] {wl.key}: {res.best_config} "
                          f"t={res.best_time*1e6:.1f}us "
                          f"evals={res.evaluations}", flush=True)


_COMMANDS = {"compare-methods": compare_methods_main,
             "train-model": train_model_main,
             "eval-model": eval_model_main,
             "online-replay": online_replay_main,
             "lint": lint_main}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] in _COMMANDS:
        return _COMMANDS[argv[0]](argv[1:])

    ap = argparse.ArgumentParser(prog="tune")
    _add_common(ap)
    ap.add_argument("--method", default="bayesian",
                    choices=list(strategies()))
    ap.add_argument("--max-evals", type=int, default=64)
    ap.add_argument("--policy", default="latency",
                    help="tuning policy: latency (default), energy, edp, or "
                         "memory_cap[:bytes]; the winner is stored under it")
    ap.add_argument("--db", default=None,
                    help="path to the tuning DB (default: the session DB)")
    ap.add_argument("--paper-suite", action="store_true",
                    help="tune every PREFIX_OPS workload on the cost model "
                         "(no --device, --op or --sizes)")
    args = ap.parse_args(argv)

    session = TunerSession(db_path=args.db, policy=args.policy)
    if args.paper_suite:
        tune_suite(args.method, session=session, seed=args.seed)
        return 0
    device = resolve_device(args.device)
    workloads = _workloads(args)
    factory = _objective_factory(args, device, [])
    for wl in workloads:
        res = session.tune(wl, method=args.method, objective=factory(),
                           seed=args.seed, max_evals=args.max_evals)
        if session.policy.name == "latency":
            score = f"t={res.best_time * 1e6:.1f}us"
        else:   # best_time is the policy scalar, not seconds
            score = f"{session.policy.key}={res.best_time:.6g}"
        print(f"[tune] {wl.key}: {res.best_config} {score} "
              f"evals={res.evaluations}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
