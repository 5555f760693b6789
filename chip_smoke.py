#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # the whole check, one card
    python3 chip_smoke.py --quick    # build + kernel checks only

Phases, each of which fails the run (non-zero exit, no result line):

1. build  — compile ``src/repro_torch/csrc`` with nvcc for sm_90a;
2. card   — print the card's name and power limit (nvidia-smi) and hold
            the ``h100`` profile's SM count and memory against the card;
3. kernels against their plain versions on the card — ``scan_add`` over
   f32 and bf16, fused and multi-tile, every radix and unroll, ragged and
   large prime fan-in stages, every admitted config of one paper
   workload's ``scan_space``; ``apply_add`` — at the tests' tolerances;
4. the main path at the paper's size — ``prefix_sum`` on 2^26 f32
   elements (256 MiB in, 256 MiB out), fused at n = 128, 1024, 4096 and
   multipass at n = 2^22, resolved through the default session under
   ``h100``, held against ``torch.cumsum`` in float64, with the launch
   list equal to the plan's and every kernel's launch count non-zero;
5. the paper's loop on the card — ``compare_methods`` for scan ks at
   n = 1024 and 4096 on measured times (``WallClockObjective``):
   exhaustive / analytical / bayesian / random, the Phi table, the sweep
   sizes and the runner failures, which must be 0;
6. the ``kernels`` line: per kernel its launches on the main path, its
   error against the plain version, its time, the plain version's and the
   library call's, and its bound (bytes over the card's memory rate).

The last line is ``{"ok": true, "device": {...}}``.  The script imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# the tests' shared tolerances (tests/conftest.py DTYPE_TOL): rtol, and an
# atol relative to the reference's magnitude (prefix sums accumulate)
DTYPE_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}
TOTAL_ELEMS = 2 ** 26      # paper: batch = 2^26 / n problems per call
F32_PEAK = 67e12           # H100 SXM f32 outside the tensor cores (FLOP/s)


def log(msg: str) -> None:
    print(msg, flush=True)


def max_err(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max())


def check_close(got, ref, dtype: str, what: str) -> float:
    """Assert the DTYPE_TOL bound the tests use; returns the max error."""
    import torch
    rtol, atol_rel = DTYPE_TOL[dtype]
    g, r = got.double(), ref.double()
    atol = atol_rel * max(float(r.abs().max()), 1.0)
    bad = (g - r).abs() > atol + rtol * r.abs()
    err = max_err(got, ref)
    if bool(torch.any(bad)) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside "
                             f"{dtype} tolerance (max abs err {err:.3e})")
    return err


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path = build.build_library(force=True)
    lib = build.load_library()
    seconds = time.perf_counter() - t0
    log(f"[build] {os.path.relpath(path, ROOT)} in {seconds:.2f} s "
        f"(nvcc {build.BUILD_INFO['seconds']:.2f} s)")
    for line in str(build.BUILD_INFO.get("log", "")).splitlines():
        if "registers" in line or "spill" in line.lower():
            log(f"[build]   {line.strip()}")
    return lib, seconds


def phase_card():
    import torch
    from repro_torch.hw.profiles import get_profile
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else f"nvidia-smi failed: {smi.stderr.strip()}"
    props = torch.cuda.get_device_properties(0)
    h100 = get_profile("h100")
    log(f"[card] {torch.cuda.get_device_name(0)}: {props.multi_processor_count}"
        f" SMs, {props.total_memory / 2**30:.1f} GiB; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    if props.multi_processor_count != h100.sm_count:
        log(f"[card] MISMATCH: h100 profile has {h100.sm_count} SMs, the card "
            f"{props.multi_processor_count}")
    if abs(props.total_memory - h100.hbm_bytes) > 0.05 * h100.hbm_bytes:
        log(f"[card] MISMATCH: h100 profile has {h100.hbm_bytes / 2**30:.1f} "
            f"GiB, the card {props.total_memory / 2**30:.1f} GiB")
    return card


def phase_kernels(dev, quick: bool):
    """Every kernel against its plain version on the card."""
    import torch
    from repro_torch.core.space import Workload, scan_space
    from repro_torch.hw.profiles import get_profile
    from repro_torch.kernels.blocks.driver import apply_add, apply_add_plain
    from repro_torch.kernels.blocks.plan import stage_radices
    from repro_torch.kernels.scan.kernel import (_launch, scan_add,
                                                 scan_add_plain)

    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def one(batch, n, rows, tile_n, stages, unroll, dtype):
        x = torch.randn(batch, n, generator=gen, device=dev).to(dtypes[dtype])
        got = _launch(x, rows, tile_n, tuple(stages), unroll)
        ref = scan_add_plain(x, rows_per_program=rows, tile_n=tile_n,
                             stages=stages, unroll=unroll)
        torch.cuda.synchronize()
        what = (f"scan_add {dtype} ({batch},{n}) rows={rows} tile={tile_n} "
                f"stages={tuple(stages)} unroll={unroll}")
        check_close(got, ref, dtype, what)
        return got, ref

    cases = 0
    # fused (one tile) and multi-tile, both dtypes, every radix x unroll
    for dtype in dtypes:
        for batch, n, rows, tile_n in ((64, 4096, 4, 4096), (64, 4096, 8, 128),
                                       (16, 1024, 2, 256), (6, 96, 3, 96)):
            for radix in (2, 4, 8):
                for unroll in (1, 2, 4, 8):
                    one(batch, n, rows, tile_n, stage_radices(tile_n, radix),
                        unroll, dtype)
                    cases += 1
    # the largest tiles (32 elements a thread), large prime fan-in stages
    # (106 = 2 * 53, 1018 = 2 * 509), odd rows counts
    for batch, n, rows, tile_n, stages, unroll, dtype in (
            (4, 16384, 1, 16384, stage_radices(16384, 4), 2, "float32"),
            (2, 65536, 1, 32768, stage_radices(32768, 8), 8, "bfloat16"),
            (256, 128, 256, 128, stage_radices(128, 2), 1, "float32"),
            (5, 212, 5, 106, (2, 53), 1, "float32"),
            (5, 212, 1, 106, (2, 53), 4, "float32"),
            (3, 1018, 3, 1018, (2, 509), 2, "float32"),
            (7, 768, 7, 768, stage_radices(768, 8), 2, "bfloat16")):
        one(batch, n, rows, tile_n, stages, unroll, dtype)
        cases += 1
    # a non-contiguous input (a column slice) through the public wrapper
    xs = torch.randn(64, 2048, generator=gen, device=dev)[:, 512:1536]
    kw = dict(rows_per_program=4, tile_n=1024,
              stages=stage_radices(1024, 4), unroll=2)
    check_close(scan_add(xs, **kw), scan_add_plain(xs, **kw), "float32",
                "scan_add on a column slice")
    cases += 1
    log(f"[kernels] scan_add: {cases} shape/stage/unroll cases match the "
        f"plain version")

    # every admitted config of one paper workload's space
    wl = Workload(op="scan", n=1024, batch=TOTAL_ELEMS // 1024, variant="ks")
    space = scan_space(wl, get_profile("h100"))
    cfgs = space.enumerate_valid()
    if quick:
        cfgs = cfgs[::16]
    x = torch.randn(wl.batch, wl.n, generator=gen, device=dev)
    plain = {}
    worst = 0.0
    for cfg in cfgs:
        stages = stage_radices(cfg["tile_n"], cfg["radix"])
        key = (cfg["tile_n"], stages, cfg["unroll"] > 1)
        if key not in plain:
            plain[key] = scan_add_plain(x, rows_per_program=1,
                                        tile_n=cfg["tile_n"], stages=stages,
                                        unroll=cfg["unroll"])
        got = _launch(x, cfg["rows_per_program"], cfg["tile_n"], stages,
                      cfg["unroll"])
        worst = max(worst, check_close(got, plain[key], "float32",
                                       f"scan_space config {cfg}"))
        del got
    torch.cuda.synchronize()
    log(f"[kernels] scan_space({wl.key}, h100): all {len(cfgs)} admitted "
        f"configs launch and match the plain version (max abs err "
        f"{worst:.3e})")
    del x, plain

    # apply_add (multipass launch 3), both output types
    for rows_n, length, rows, out in ((4096, 16384, 8, torch.float32),
                                      (4096, 16384, 1, torch.bfloat16),
                                      (96, 100, 3, torch.float32)):
        y = torch.randn(rows_n, length, generator=gen, device=dev)
        e = torch.randn(rows_n, 1, generator=gen, device=dev) * 100
        got = apply_add(y, e, rows=rows, out_dtype=out)
        ref = apply_add_plain(y, e, rows=rows, out_dtype=out)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"apply_add ({rows_n},{length}) rows={rows} "
                                 f"{out}: max abs err {max_err(got, ref)}")
    log("[kernels] apply_add: f32 and bf16 outputs equal the plain version")


def reset_counts():
    from repro_torch.kernels.blocks.driver import apply_add
    from repro_torch.kernels.scan.kernel import scan_add
    scan_add.launches = 0
    apply_add.launches = 0


def read_counts():
    from repro_torch.kernels.blocks.driver import apply_add
    from repro_torch.kernels.scan.kernel import scan_add
    return {"scan_add": scan_add.launches, "apply_add": apply_add.launches}


def main_path_cases():
    return [(128, TOTAL_ELEMS // 128), (1024, TOTAL_ELEMS // 1024),
            (4096, TOTAL_ELEMS // 4096), (2 ** 22, 16)]


def phase_main_path(dev):
    """prefix_sum at the paper's size, through the default session."""
    import torch
    from repro_torch.core.space import Workload
    from repro_torch.kernels.blocks.driver import capture_launches
    from repro_torch.kernels.blocks.plan import plan_for
    from repro_torch.kernels.scan.ops import _plan_workload, prefix_sum
    from repro_torch.tuning import default_session

    gen = torch.Generator(device=dev).manual_seed(1)
    inputs, outputs, runs = {}, {}, []
    for n, batch in main_path_cases():
        inputs[n] = torch.randn(batch, n, generator=gen, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    for n, batch in main_path_cases():
        with capture_launches() as launched:
            outputs[n] = prefix_sum(inputs[n])
        wl = Workload(op="scan", n=n, batch=batch, variant="ks")
        cfg = default_session().resolve(wl)
        plan = plan_for(_plan_workload(wl, linrec=False), cfg)
        runs.append((n, batch, cfg, plan, list(launched)))
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[main] launches on the main path: {counts}")
    for name, count in counts.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
    for n, batch, cfg, plan, launched in runs:
        if tuple(launched) != plan.launches:
            raise AssertionError(f"n={n}: launched {launched} != plan "
                                 f"{plan.launches}")
        want = "multipass" if n == 2 ** 22 else "fused"
        if plan.kind != want:
            raise AssertionError(f"n={n}: plan is {plan.kind}, expected {want}")
        y = outputs[n]
        if y.shape != (batch, n) or y.dtype != torch.float32:
            raise AssertionError(f"n={n}: output {tuple(y.shape)} {y.dtype}")
        err = check_close(y, torch.cumsum(inputs[n].double(), dim=-1),
                          "float32", f"prefix_sum n={n}")
        log(f"[main] n={n} batch={batch}: {plan.kind}, {len(plan.launches)} "
            f"launch(es), config {cfg}, max abs err vs float64 cumsum "
            f"{err:.3e}")
    return inputs, runs, counts


def phase_loop(dev):
    """compare_methods on measured times (the paper's Table II)."""
    from repro_torch.core import Workload
    from repro_torch.core.objective import WallClockObjective
    from repro_torch.evaluation import check_report, compare_methods, format_report
    from repro_torch.launch.tune import make_scan_runner

    runner = make_scan_runner(dev, seed=2)
    made = []

    def factory():
        obj = WallClockObjective(runner, reps=5, warmup=1, device="cuda")
        made.append(obj)
        return obj

    wls = [Workload(op="scan", n=n, batch=TOTAL_ELEMS // n, variant="ks")
           for n in (1024, 4096)]
    reset_counts()
    t0 = time.perf_counter()
    report = compare_methods(wls, ("exhaustive", "analytical", "bayesian",
                                   "random"), objective_factory=factory,
                             seed=0, max_evals=20)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    failures = sum(o.failures for o in made)
    log(f"[loop] compare_methods on the card in {seconds:.1f} s; launches "
        f"{counts}")
    for line in format_report(report).splitlines():
        log(f"[loop] {line}")
    for row in report["workloads"]:
        cfgs = {m: row["methods"][m]["config"] for m in row["methods"]}
        log(f"[loop] {row['workload']}: sweep {row['space_size']} configs, "
            f"optimum {row['best_time_s'] * 1e3:.4f} ms; configs {cfgs}")
    log(f"[loop] runner failures: {failures}")
    problems = check_report(report)
    if problems or failures:
        raise AssertionError(f"compare_methods: {problems}, runner "
                             f"failures {failures}")
    if counts["scan_add"] == 0:
        raise AssertionError("the loop never launched scan_add")
    log("[loop] phi " + json.dumps(
        {name: agg["phi"] for name, agg in report["overall"].items()}))
    return report


def phase_numbers(dev, inputs, runs, counts, bandwidth: float):
    """Times, bounds and errors per kernel at the main path's shapes."""
    import torch
    from repro_torch.kernels.blocks.driver import apply_add, apply_add_plain
    from repro_torch.kernels.scan.kernel import (_launch, scan_add,
                                                 scan_add_plain)
    from repro_torch.kernels.scan.ops import prefix_sum

    shapes = []
    scan_entry = None
    apply_entry = None
    for n, batch, cfg, plan, _ in runs:
        x = inputs[n]
        nbytes = 2 * x.numel() * x.element_size()
        row = {"n": n, "batch": batch, "kind": plan.kind, "config": cfg,
               "launches": len(plan.launches),
               "prefix_sum_ms": time_ms(lambda: prefix_sum(x), 10),
               "cumsum_ms": time_ms(lambda: torch.cumsum(x, dim=-1), 10),
               "bound_ms": nbytes / bandwidth * 1e3}
        if plan.kind == "fused":
            kw = dict(rows=plan.rows, tile_n=plan.tile_n, stages=plan.stages,
                      unroll=cfg["unroll"])
            got = _launch(x, kw["rows"], kw["tile_n"], kw["stages"],
                          kw["unroll"])
            ref = scan_add_plain(x, rows_per_program=plan.rows,
                                 tile_n=plan.tile_n, stages=plan.stages,
                                 unroll=cfg["unroll"])
            row["scan_add_ms"] = time_ms(
                lambda: _launch(x, kw["rows"], kw["tile_n"], kw["stages"],
                                kw["unroll"]), 10)
            row["plain_ms"] = time_ms(
                lambda: scan_add_plain(x, rows_per_program=plan.rows,
                                       tile_n=plan.tile_n, stages=plan.stages,
                                       unroll=cfg["unroll"]), 3, warmup=1)
            row["max_abs_err"] = max_err(got, ref)
            if n == 1024:
                scan_entry = {
                    "name": "scan_add", "route": "cuda",
                    "source": "src/repro_torch/csrc/scan.cu",
                    "replaces": "src/repro/kernels/scan/kernel.py:97",
                    "launches": counts["scan_add"],
                    "max_abs_err": row["max_abs_err"],
                    "ms": row["scan_add_ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": "bytes",
                    "library_ms": row["cumsum_ms"],
                    "shape": [batch, n], "dtype": "float32",
                    "config": {k: cfg[k] for k in sorted(cfg)}}
                # the function's least work: n - 1 adds per row, f32
                ops_ms = batch * (n - 1) / F32_PEAK * 1e3
                if ops_ms > scan_entry["bound_ms"]:
                    scan_entry.update(bound_ms=ops_ms, bound_by="operations")
            del got, ref
        else:
            l1, l2, l3 = plan.launches
            p, length = plan.seq_tiles, plan.tile_n
            y = torch.randn(batch * p, length, device=dev)
            e = torch.randn(batch * p, 1, device=dev)
            rows = l3.block_shape[0]
            got = apply_add(y, e, rows=rows)
            ref = apply_add_plain(y, e, rows=rows)
            ab = 2 * y.numel() * 4 + e.numel() * 4
            row["apply_add_ms"] = time_ms(lambda: apply_add(y, e, rows=rows),
                                          10)
            row["apply_plain_ms"] = time_ms(
                lambda: apply_add_plain(y, e, rows=rows), 10)
            row["add_ms"] = time_ms(lambda: torch.add(y, e), 10)
            xc = x.reshape(batch * p, length)
            row["chunk_scan_ms"] = time_ms(
                lambda: _launch(xc, l1.block_shape[0], length, l1.stages,
                                cfg["unroll"]), 10)
            apply_entry = {
                "name": "apply_add", "route": "cuda",
                "source": "src/repro_torch/csrc/scan.cu",
                "replaces": "src/repro/kernels/blocks/driver.py:133",
                "launches": counts["apply_add"],
                "max_abs_err": max_err(got, ref),
                "ms": row["apply_add_ms"], "plain_ms": row["apply_plain_ms"],
                "bound_ms": ab / bandwidth * 1e3, "bound_by": "bytes",
                "library_ms": row["add_ms"],
                "shape": [batch * p, length], "dtype": "float32",
                "config": {"rows": rows}}
            del y, e, got, ref
        shapes.append(row)
        log(f"[numbers] {json.dumps(row, sort_keys=True)}")
    return [scan_entry, apply_entry], shapes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}: run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    _, build_s = phase_build()
    card = phase_card()
    t0 = time.perf_counter()
    phase_kernels(dev, args.quick)
    log(f"[kernels] {time.perf_counter() - t0:.1f} s")
    if not args.quick:
        from repro_torch.hw.profiles import get_profile
        t0 = time.perf_counter()
        inputs, runs, counts = phase_main_path(dev)
        log(f"[main] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        entries, _ = phase_numbers(dev, inputs, runs, counts,
                                   get_profile("h100").hbm_bandwidth)
        log(f"[numbers] {time.perf_counter() - t0:.1f} s")
        del inputs
        torch.cuda.empty_cache()
        phase_loop(dev)
        log(json.dumps({"kernels": entries}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all (build "
        f"{build_s:.1f} s)")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
