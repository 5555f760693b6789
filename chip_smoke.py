#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # the whole check, one card
    python3 chip_smoke.py --quick    # build, kernel checks, 9a and 9b only

Phases, each of which fails the run (non-zero exit, no result line):

1. build  — compile ``src/repro_torch/csrc`` with nvcc for sm_90a;
2. card   — print the card's name and power limit (nvidia-smi) and hold
            the ``h100`` profile's SM count and memory against the card;
3. kernels against their plain versions on the card — ``scan_add`` over
   f32 and bf16, fused and multi-tile, every radix and unroll, ragged and
   large prime fan-in stages, every admitted config of one paper
   workload's ``scan_space``, on the route its plan picks (the warp
   kernel, or the block kernel for ragged and prime stages), with the
   elements not bit-equal to ``scan_add_plain`` counted (the run fails
   unless there are none); ``apply_add`` — at the tests' tolerances;
4. the main path at the paper's size — ``prefix_sum`` on 2^26 f32
   elements (256 MiB in, 256 MiB out), fused at n = 128, 1024, 4096 and
   multipass at n = 2^22, resolved through the default session under
   ``h100``, held against ``torch.cumsum`` in float64, with the launch
   list equal to the plan's, every kernel's launch count non-zero, and
   every ``scan_add`` launch on the warp kernel; the warp kernel's time at
   the paper's shapes beside the block kernel's (the earlier design) on the
   same inputs, a sweep of radix x rows x unroll at (65536, 1024) on both,
   and ``torch.profiler``'s device time of both at n = 128, 1024, 4096;
5. the linear recurrence and the tridiagonal solvers: ``scan_linrec``,
   ``scan_linrec_prod`` and ``pcr`` against their plain versions (f32 and
   bf16, ragged, prime, short and non-power-of-two shapes, staged pieces,
   the RG-LRU gate on and off, every admitted config of the paper
   workload's linrec space at n = 1024 and PCR space at n = 256 and
   1024 under ``h100``), on the route the plan picks (the warp kernels,
   or the block kernels for ragged, prime and odd shapes) and on the
   block kernel's record, with the elements not bit-equal counted (the
   run fails unless there are none); ``apply_linrec`` at the tests'
   tolerance; the Thomas kernel (``thomas``) on each of its routes
   (lane, wide, long), forced, against ``thomas_ref`` on the card, f32
   and bf16, n = 1 ... 1024, batches 1 ... 4096, ragged rows on the long
   route and rows beyond the fast divide's range, every element
   bit-equal; then, at 2^26 f32 equations a call, ``solve`` for
   pcr / cr / lf / wm at n = 256 and 1024 (residual, and a float64
   Thomas solve of sampled rows), ``solve(variant="thomas")`` at n = 256,
   1024, 2^16 and 2^22 on its kernel, each call on the new route
   ``thomas_route`` picks (residual, and float64 Thomas of sampled rows,
   one at 2^22), ``solve(variant="lf")`` above
   ``LF_MULTIPASS_MIN`` on a fused and a multipass linrec plan, and
   ``linear_recurrence``
   fused and multipass against float64 references, each call's launch
   list equal to its plans', every kernel's launch count non-zero and
   every linrec and pcr launch on the warp kernels; the warp kernels'
   times beside the block kernels' on the same inputs, both pcr routes
   over the admitted n = 256 and 1024 configs and the one-warp geometry,
   the warp PCR kernel's issue floor from its SASS and the card's clock
   (``[issue]``), and ``torch.profiler``'s device time of the entry
   points and the block kernels (``[trace] pcr``);
   cuSPARSE's ``gtsv2StridedBatch`` (bound with ctypes from the CUDA
   toolkit's ``libcusparse.so`` in a child process, never by the port)
   held once against ``pcr``'s solution and timed beside it at n = 1024
   and 256, for kernel 7's ``library_ms``, and against the Thomas
   kernel's at its four sizes, for its ``library_ms``; the Thomas kernel's
   time at each size on its route, bit-equal to the lane kernel's result,
   beside the lane kernel's time and every other route's on the same
   planes, its bound (bytes, or its chain of 2n steps a system at the
   card's clock), ``chain_floor_ms`` (the chain probe's step time x 2n)
   and the route's own traffic;
6. the FFT: ``fft_stockham`` against ``fft_plain`` on the card over every
   admitted config of ``fft_space`` at n = 1024 and 8192 under ``h100``
   and the ragged and prime stage sequences, inverse on and off, at the
   complex64 tolerance and with the elements not bit-equal counted (the
   run fails unless there are none); then, at 2^26 complex64 elements a call, ``fft``
   at n = 256 ... 8192 (one fused launch) and at 2^16, 2^20 and 2^23 (the
   four-step driver), calls at 2^23 forced to m = 3 (tile_n = 256) and
   m = 2 (tile_n = 4096), and ``ifft`` round trips, each held against a complex128 ``torch.fft.fft``
   at 1e-4 relative, with the launch list equal to the plan's and the
   kernel's launch count non-zero, every launch on the pow2 kernel or the
   four-step pass kernel; each four-step pass (``fft_pass``) at 2^16, 2^20
   and 2^23 (m = 3 and m = 2), forward and inverse, held against its plain
   twin ``fft_pass_plain`` on the same input at the complex64 tolerance,
   and where the four-step time goes (each pass timed); the pow2 kernel's
   time beside the generic kernel's (the earlier design) on the same
   inputs;
7. the SSD chain: ``ssd_intra``, ``ssd_state_apply`` and
   ``ssd_apply_entry`` against their plain versions (chunk 64 ... 2048,
   nc = 1, 3 and 16, (S, P) = (8, 16), (16, 8) and (128, 64), a strong
   decay, f32 and bf16, at the tests' SSD tolerance, DTYPE_TOL x 10),
   each on both routes (the tiled kernels and the earlier block kernels),
   with the elements not bit-equal counted (the run fails unless there are none); the
   Mamba-2 block (``SSDBlock``) at mamba2-130m's width on 8 x 2048 tokens
   with the session's config, and one decode step; the ``ssd`` op at the
   block's shapes with chunk 128 and 256, fuse 0 and 1, and an odd chunk
   count — each SSD output against a float64 sequential ``ssd_ref`` of
   sampled heads, each launch list against ``plan_for_chain``, the launch
   counts read around the block and around the whole SSD path, every
   launch of kernels 8, 9 and 10 on the tiled kernels; the three timed on
   both routes over chunk 128 ... 2048 (9 and 10 where nc > 1), beside
   their bounds, ``torch.profiler``'s device time by kernel at chunk 128
   and 2048 (``[trace] ssd``), the port's torch ``ssd_chunked_ref`` at
   chunk 128 (the op's ``composed_ms``) and kernel 10's function in torch
   calls (``entry_composed``: its ``composed_ms``), both never called by
   the port;
8. the RG-LRU: ``rglru`` at recurrentgemma-9b's width (2 x 2048 x 4096)
   with the gate in the kernel (fuse = 1) and in torch (fuse = 0), and a
   multipass call at 2^22 x 16, against a float64 sequential recurrence;
9. flash attention and the tiled matmul, each with two kernels chosen by
   type (bf16: the tensor-core kernel, wgmma and TMA; f32: the CUDA-core
   kernel), the route counters checked: ``flash_attention`` against
   ``flash_attention_plain`` over every config of the h100 attention
   space at n = 2048 (bf16 and f32) and over head dims 16 ... 256, causal
   and full, a 2048 window at L = 4096, Lq < Lk, block_k 4 (Lk = 1500),
   f32 and bf16 — bf16 at FLASH_BF16_TOL, f32 at DTYPE_TOL; ``matmul_tiled``
   against ``matmul_plain`` over the h100 matmul space at (8192, 1024) @
   (1024, 2816), f32 at DTYPE_TOL, bf16 within one bf16 ulp plus
   MATMUL_BF16_ATOL; per path the max error and the elements that are not
   bit-equal;
9a. static analysis (``[analysis]``): the port's ``run_lint()`` — the AST
   lint over ``src/repro_torch``, the contract fingerprints against
   ``tests/fixtures/analysis_fingerprints_torch.json`` and the plan /
   space invariants over every op x profile — in the card's process, its
   seconds printed; its findings must be exactly the seven h100
   ``invariant.no-feasible-config`` findings (ANALYSIS_FINDINGS), none
   baselined;
9b. the differential table (``[differential]``): every registered entry
   point must have a row of ``repro_torch.evaluation.differential``
   (the JAX package's ``tests/conftest.py`` table, whose odd and prime
   shapes the other phases never pick, and one bf16 matmul at a prime
   N); each (entry, dtype, shape) through the public entry point on CUDA
   tensors with config=None, resolved under h100, held against the same
   entry point on CPU tensors given the configs the card's call
   resolved, at DTYPE_TOL x the row's scale, fused rows also fuse 1
   against fuse 0 on the card; each case launching kernels (as many as
   its launch list where ``capture_launches`` records one; none for the three
   solvers that reach no kernel in either package), the bf16 matmuls on
   the "ragged" route; per entry its configs, max error and launches by
   route, and the kernels the table reaches;
10. the dense path: qwen1.5-0.5b's ``Model`` at full width (24 layers,
   bf16, random weights at the JAX init's scales, ``use_pallas``):
   ``forward`` on 4 x 2048 tokens with one flash launch per layer, all on
   the tensor cores, its logits against the same weights on the plain-op
   path, a 63-token ``prefill`` and 8 greedy ``decode_step``s against the
   forward, the forward's time split into the flash kernel and the rest,
   and one forward under ``torch.profiler``: the five kernels with the
   most device time and the device's idle share; one full-depth
   mamba2-130m ``Model.forward`` on 8 x 2048 tokens, every ``ssd_intra``
   launch on the tiled kernel, its time split into those launches and
   the rest;
11. the model families (``[models]``): every other arch of the registry
   through the port's ``Model`` at full width in bf16, random weights at
   the JAX init's scales, ``use_pallas`` on, one after another (each freed
   before the next): gemma-2b, minitron-4b and granite-34b (its first 44
   of 88 layers) on 2 x 2048 tokens, recurrentgemma-9b (12 of 36 layers)
   on 1 x 4096 (its 2048 window binds), qwen2-moe-a2.7b on 2 x 2048,
   qwen3-moe-30b-a3b on 1 x 2048, llama-3.2-vision-90b (5 of 20 groups)
   on 1 x 2048 over a 1 x 1601 patch memory and whisper-large-v3
   encoding 2 x 1500 frames
   and decoding 2 x 448 tokens.  Per arch: the flash launches equal its
   attention layers (encoder and cross-attention included), all on the
   tensor cores, and recurrentgemma's linrec launch list equals its rec
   layers times the plan's, all on the warp kernel; the logits against
   the plain-op path (DENSE_LOGITS_TOL; the moe archs with the flash
   path's expert choices replayed, and the tokens whose own choice
   differed counted); 8 teacher-forced decode steps against the forward
   (DECODE_TOL) after a 63-token prefill, or a 2112-token one that wraps
   recurrentgemma's ring buffer, or from position 0 with the memory (vlm,
   audio), the moe archs' only timed (a forward and a decode drop
   different pairs at capacity factor 1.25; the aux and the dropped share
   printed); the forward's time split into flash, linrec and the rest,
   the f32 unembedding's time, peak memory; one RecurrentBlock at full
   width in f32 and bf16 against its arithmetic in float64; a
   ``torch.profiler`` trace of the recurrentgemma forward; kernel 11 at
   the new shapes (Lk = 1601 at block_k 1, L = 1500 at blocks of 4, 448,
   the 2048 window, head dim 256) against its plain version and timed
   beside ``scaled_dot_product_attention``;
12. the multipass ``prefix_sum`` and ``linear_recurrence`` at 2^22 x 16
   forced to tile_n 128, rows 2, whose carry-scan tile (2, 32768) is
   walked in staged pieces, against float64, launch lists equal to the
   plans'; ``matmul`` at (8192, 1024) @ (1024, 2816) bf16 against
   float64;
13. the paper's loop on the card — ``compare_methods`` for scan ks at
   n = 1024 and 4096, tridiag pcr at n = 256 and 1024, fft stockham at
   n = 1024 and 4096, ssd chunked at n = 1024 (8 x 24 rows), attention
   flash at n = 2048 (64 rows of head dim 64, bf16) and matmul tiled at
   n = 2816 (M = 8192, K = 1024, bf16) on measured times
   (``WallClockObjective``): exhaustive / analytical / online / bayesian
   / random, the Phi table, each method's evaluations, the sweep sizes
   and the runner failures, which must be 0;
14. the paper's ML-based methodology on the card (``[ml]``): every config of
   ``launch.tune.card_workloads`` (the ``repro_torch.tuning.ml`` ``SUITE``'s
   train and holdout sizes: 2^26 / n problems for scan, tridiag, fft,
   large_fft and rglru, ssd at 8 x 24 rows, attention and matmul in bf16;
   large_fft sizes that ``fft`` runs in one launch left out) timed once
   into journals under ``artifacts/ml_card``; a forest per op family trained
   from the train journals and saved there (``$REPRO_TORCH_ML_MODEL``);
   on the held-out sizes ``evaluate_model`` (top-1, slowdowns, rank
   correlation, the rungs that answered) and ``compare_methods`` for
   exhaustive / analytical / ml / bayesian / random on the same times.
   It fails on Phi > 1, a runner failure, a ``no-model`` or ``no-forest``
   rung, a config measured twice, or a family (scan_add, scan_linrec, pcr,
   fft_stockham, ssd_intra, flash_attention, matmul) its sweeps did not
   launch; the held-out accuracy has no floor;
15. serving (``[serve]``): qwen1.5-0.5b at full width and depth (bf16
   weights at the JAX init's scales, f32 cache) on the JAX serving
   benchmark's multi-tenant trace (``synthetic_trace(default_tenants(),
   seed=0)`` over 28 of its 40 ticks: 35 requests) through
   ``ServeEngine`` (8 lanes, 128 positions, chunk 16, admit threshold 4,
   after ``warmup()``) and ``ReferenceEngine``: greedy tokens and finish reasons of every request
   equal (a difference fails with the first request, position and top-2
   logit margin), ``prefill_calls`` at most ceil((len - 1) / 16) summed,
   ``host_transfers`` at most the engine's steps; tokens/s of both, peak
   memory, the twelve kernels' launch counts over the engine's run (the
   decode path reaches none, as in JAX), ten steady-state decode steps
   under ``torch.profiler``; the engine again with an ``OnlineTuner``
   attached in traffic (attention at n = 256, batch 8, budget 24, on a
   temporary DB) and a ``TraceRecorder``: the same tokens, decode-step
   median and p90 from its step listener, its trace replayed twice
   through ``launch.tune.online_replay`` to the same fates;
   mamba2-130m at full width through the engine on the trace's first 16
   requests (its vocabulary), each request's tokens equal to a
   one-request ``ReferenceEngine`` run at the engine's 8 lanes;
16. portability (``[portability]``), on phase 13's workloads in a fresh
   temporary journal directory: ``compare_methods_matrix`` over tpu_v5e,
   gpu_sm and h100, each on its own cost model, under the latency,
   energy, edp and memory_cap policies (``check_matrix`` empty); then
   ``compare_methods`` on the card with phase 13's wall-clock objectives
   for exhaustive / analytical / transfer / bayesian / random, where
   ``transfer`` warm-starts from the tpu_v5e and gpu_sm journals (every
   workload must find one: the foreign histories and their
   exp(-profile_distance) weights are printed); ``ExhaustiveSearch
   (prune="analytical")`` at top_k 8, 16 and 64 on the same measurements
   (k evaluations and ``stopped_by`` "pruned" where the space is larger),
   and ``prune=`` under the energy policy refused; a ``memory_cap``
   session (half the latency winner's modeled peak) tuned exhaustively
   on the h100 cost model and installed as the default session, whose
   ``prefix_sum`` must launch the capped plan within DTYPE_TOL while the
   latency session resolves its own winner; and, where the h100 model's
   energy winner differs from its latency winner, the card's energy
   counter (NVML ``nvmlDeviceGetTotalEnergyConsumption``, ctypes on the
   NVML library ``libnvidia-ml.so.1``) around a second of back-to-back calls
   of each, printed in mJ and ms a call beside the model's (not gated);
17. training (``[train]``): ``run_training`` on qwen1.5-0.5b at full width
   and depth (24 layers, bf16 parameters, remat "full", the plain-op
   attention: neither package has a backward for the flash kernel) for 20
   steps of AdamW on the synthetic corpus, 8 x 512 tokens a step: the
   losses finite and the mean of the last three below the first three's;
   the median step, tokens/s and peak memory; one step under
   ``torch.profiler`` (top five kernels, idle share); three steps each of
   Adafactor, two micro steps, int8 error feedback and remat "none" beside
   it; a restart at full width (a checkpoint every 4 steps, a failure
   injected at step 6: the second run resumes at 4 and ends at 8, the bf16
   params it restored bit-equal to those the first run saved); one reduced
   f32 train step on the card against the CPU (loss and grad norm at
   DTYPE_TOL); the packing's prefix sum on the card (``scan_add``
   launched, offsets bit-equal to the plain version's); and the gradient
   guard: a backward through each of the thirteen kernels, and a train step
   of qwen with ``use_pallas`` and of mamba2-130m at full width, must
   raise the guard's error naming a kernel, with no gradient left behind;
18. the dry-run (``[dryrun]``): ``launch.roofline.analyze_cell`` on the
   card machine's host for qwen1.5-0.5b ``train_4k`` and mamba2-130m
   ``prefill_32k`` on the (16, 16) production mesh over a fake world of
   256 ranks, under the ``h100`` profile (status ok, finite positive
   terms, all-gathers and reduce-scatters counted in the train cell);
   then the dry-run held to the card: qwen1.5-0.5b at full width and
   depth (bf16) prefilling 8 x 2048 tokens, placed on ``make_host_mesh()``
   (the (1, 1) mesh of this card) on fake tensors, against the same
   prefill run for real: the predicted argument bytes equal the
   parameters' and tokens' bytes on the card, and the predicted dot FLOPs
   equal ``FlopCounterMode``'s count of the plain run, exactly; the flash
   run (``use_pallas``: kernel 11, its launches counted) within 2e-2 of
   max |logits| of the plain run's last-position logits; printed without
   a gate, the predicted against the measured peak memory and each run's
   median time against the roofline bound;
19. the examples (``[examples]``): ``examples_torch/``'s five scripts
   through their ``main`` in this process, on the card, at their defaults
   (train_lm at the 100M preset, 200 steps of 8 x 128 tokens): quickstart's tuned and radix-4 scans within DTYPE_TOL of a
   float64 cumsum with ``scan_add`` launched; autotune_kernels' Phi <= 1
   in every row, no runner failure; serve_lm's ten requests equal to a
   ``ReferenceEngine`` on the same model; train_lm's loss finite and
   falling, its checkpoint restored equal; fault_tolerant_train dead at
   17, resumed from 10, finished at 29; each example's seconds and
   launches, the 100M run's median step, tokens/s and peak memory;
20. the ``kernels`` line: per kernel (all twelve, the Thomas kernel,
   which ports no Pallas kernel, and the four-step pass kernel
   ``fft_pass``, whose launches ``fft_stockham``'s no longer count) its
   launches on the main
   paths (by route for ``scan_add``, ``scan_linrec``, ``scan_linrec_prod``,
   ``pcr``, ``thomas``, ``fft_stockham`` and the three SSD kernels, with the earlier
   kernel's time beside theirs; by path for the kernels that run on
   several, kernels 2, 3, 5 and 11 also by model arch; kernels 8–10 also
   by chunk length and with the tuning loop's
   launches by route; every kernel with its launches in the ``[ml]``
   sweeps, ``launches_ml``, in the ``[portability]`` phase,
   ``launches_portability``, in the differential table,
   ``launches_differential``, on the train path, ``launches_train``, and
   in the examples, ``launches_examples``),
   its error
   against the plain version, its time, the plain version's and the
   library call's (null where no one PyTorch call
   computes the function; ``scaled_dot_product_attention`` and
   ``torch.matmul`` for kernels 11 and 12, timed as yardsticks and never
   called by the port), and its bound (bytes over the card's memory
   rate, or operations over its rate for the type — f32 67 TFLOP/s, bf16
   989 TFLOP/s on the tensor cores — whichever is larger); kernels 11 and
   12 with their route per type and launches per route, timed in turns
   (the ``[turns]`` line) against their yardsticks and against the
   CUDA-core kernel on the same bf16 inputs.

The build phase prints each source's nvcc time, each SSD kernel's
registers and spills from ``-Xptxas -v`` (``[ptxas]``) and counts, per
scan, linrec, PCR, FFT and SSD kernel, the local-memory instructions (LDL
/ STL) and calls in the library's SASS (``cuobjdump``; for the SSD
kernels also the FFMA, LDS and BAR of their FFMA-heavy loop blocks).
The last line is ``{"ok": true, "device": {...}}``.  The script imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# the tests' shared tolerances (tests/conftest.py DTYPE_TOL): rtol, and an
# atol relative to the reference's magnitude (prefix sums accumulate)
DTYPE_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2),
             "complex64": (1e-4, 1e-4)}
TOTAL_ELEMS = None         # the paper's 2^26 / n problems a call: load_port
F32_PEAK = 67e12           # H100 SXM f32 outside the tensor cores (FLOP/s)
FFT_DEEP = (2 ** 23, 8)    # the FFT size driven at both four-step depths
FFT_TRIPS = (1024, 2 ** 20)  # ifft(fft(x)): one fused, one four-step


def log(msg: str) -> None:
    print(msg, flush=True)


def load_port():
    """Put the checkout's ``src`` on the path, read the paper's problem
    size from the port's ``configs/paper_ops.py`` and take the launch
    counters' readers and route tables from ``repro_torch.telemetry``
    (which imports the kernel modules, and with them torch: the cuSPARSE
    child calls it after loading its libraries)."""
    global TOTAL_ELEMS, LAUNCH_ROUTES, NEWEST_ROUTE, launch_counts, \
        launch_wrappers, reset_launch_counts
    sys.path.insert(0, SRC)
    from repro_torch.configs.paper_ops import TOTAL_ELEMS
    from repro_torch.telemetry import (LAUNCH_ROUTES, NEWEST_ROUTE,
                                       launch_counts, launch_wrappers,
                                       reset_launch_counts)


def max_err(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max())


def check_close(got, ref, dtype: str, what: str, scale: float = 1.0) -> float:
    """Assert the DTYPE_TOL bound the tests use (``scale`` loosens both, as
    the tests' x50 for solvers held against Thomas); returns the max
    error."""
    import torch
    rtol, atol_rel = (scale * t for t in DTYPE_TOL[dtype])
    g, r = got.double(), ref.double()
    atol = atol_rel * max(float(r.abs().max()), 1.0)
    bad = (g - r).abs() > atol + rtol * r.abs()
    err = max_err(got, ref)
    if bool(torch.any(bad)) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside "
                             f"{dtype} tolerance (max abs err {err:.3e})")
    return err


def check_complex(got, ref, what: str) -> float:
    """The complex64 tolerance the tests use: max |got - ref| relative to
    max |ref| below DTYPE_TOL["complex64"]; returns that relative error."""
    import torch
    g, r = got.to(torch.complex128), ref.to(torch.complex128)
    err = float((g - r).abs().max() / max(float(r.abs().max()), 1e-30))
    if not (err < DTYPE_TOL["complex64"][0]) \
            or not bool(torch.isfinite(torch.view_as_real(g)).all()):
        raise AssertionError(f"{what}: relative error {err:.3e} outside the "
                             f"complex64 tolerance")
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
        f"(nvcc {build.BUILD_INFO['seconds']:.2f} s; by call "
        f"{json.dumps(build.BUILD_INFO['source_seconds'])})")
    for line in str(build.BUILD_INFO.get("log", "")).splitlines():
        if "registers" in line or "spill" in line.lower():
            log(f"[build]   {line.strip()}")
    ssd = {}
    for name, v in ptxas_counts(str(build.BUILD_INFO.get("log", ""))).items():
        m = re.search(r"(ssd_[a-z_]*kernel)(I\w*?E)E*v", name)
        if m:   # e.g. ssd_apply_entry_tiled_kernelIfLi128E
            ssd[m.group(1) + m.group(2)] = v
    log(f"[ptxas] SSD kernels: {json.dumps(ssd, sort_keys=True)}")
    log(f"[sass] {json.dumps(sass_counts(path), sort_keys=True)}")
    return lib, seconds


def ptxas_counts(text):
    """Registers and stack / spill bytes per kernel (mangled name) from
    the build's ``-Xptxas -v`` output."""
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry function '" in line:
            cur = out.setdefault(line.split("'")[1], {})
        elif cur is not None and "spill stores" in line:
            for n, what in re.findall(
                    r"(\d+) bytes (stack frame|spill stores|spill loads)",
                    line):
                cur[what.replace(" ", "_")] = int(n)
        elif cur is not None and re.search(r"Used \d+ registers", line):
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
    return out


@functools.lru_cache(maxsize=None)
def sass_functions(path):
    """``cuobjdump -sass`` of the built library (beside the nvcc the build
    used), by function: each a list of basic blocks, each a list of
    opcodes (predicates dropped).  A block ends at a label and after a
    branch, call, return or exit."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {out.stderr.strip()[:500]}")
    funcs, blocks = {}, None
    for line in out.stdout.splitlines():
        text = line.strip()
        if "Function : " in line:
            blocks = funcs.setdefault(line.split("Function : ", 1)[1].strip(),
                                      [[]])
        elif blocks is None:
            continue
        elif text.startswith(".L") and text.endswith(":"):
            blocks.append([])
        elif "/*" in line and ";" in line:
            op = [w for w in line.split("*/", 1)[1].split(";")[0].split()
                  if not w.startswith("@")]
            if op:
                blocks[-1].append(op[0])
                if op[0].split(".")[0] in ("BRA", "BRX", "CALL", "RET",
                                           "EXIT"):
                    blocks.append([])
    return {name: [b for b in blks if b] for name, blks in funcs.items()}


def sass_counts(path):
    """Per scan, linrec, PCR, FFT and SSD kernel of the built library: its SASS
    instructions, local-memory loads and stores (LDL / STL: spills and
    stack arrays) and calls; for the SSD kernels also the mix of their
    FFMA-heavy basic blocks (the unrolled loops: instructions, FFMA, LDS,
    BAR)."""
    counts = {}
    for name, blocks in sass_functions(path).items():
        if not any(k in name for k in ("scan_add_kernel", "scan_warp",
                                       "linrec_kernel", "linrec_warp",
                                       "pcr_kernel", "pcr_warp",
                                       "fft_kernel", "fft_pow2", "ssd_")):
            continue
        ops = [op for block in blocks for op in block]
        counts[name] = {"instructions": len(ops)}
        for key in ("LDL", "STL", "CALL"):
            counts[name][key] = sum(op.startswith(key) for op in ops)
        if "ssd_" in name:
            # [instructions, FFMA, LDS, BAR] of each block of 64 FFMA or
            # more
            counts[name]["ffma_blocks"] = sorted(
                [len(b), sum(op.split(".")[0] == "FFMA" for op in b),
                 sum(op.startswith("LDS") for op in b),
                 sum(op.startswith("BAR") for op in b)] for b in blocks
                if sum(op.split(".")[0] == "FFMA" for op in b) >= 64)
    return counts


def pcr_issue_floor(equations, n, unroll):
    """The least time the card could take to issue the warp PCR kernel's
    level work at this shape: every equation and level at the cost of the
    kernel's cheapest branch-free level body (kNear's), counted in its
    SASS (a basic block with two MUFU.RCP an equation and no FCHK or CALL:
    a kNear or kTiny body), over the card's SMs x 4 warp instructions a
    clock at its maximum SM clock (nvidia-smi).  A floor for this code,
    not for PCR: the votes, the loads, the transposes and the dearer
    divide paths are left out."""
    import torch
    from repro_torch.kernels import build
    elems = 1 << max(unroll - 1, 0).bit_length()
    tag = f"pcr_warp_kernelIfLi{elems}E"
    funcs = sass_functions(build.BUILD_INFO["path"])
    blocks = [b for name, blks in funcs.items() if tag in name for b in blks]
    bodies = sorted(len(b) for b in blocks
                    if sum(op.startswith("MUFU.RCP") for op in b) == 2 * elems
                    and not any(op.startswith(("FCHK", "CALL")) for op in b))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    mhz = float(smi.stdout.split()[0]) if smi.returncode == 0 else None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"kernel": f"pcr_warp_kernel<float, {elems}>", "n": n,
           "equations": equations, "levels": math.ceil(math.log2(n)),
           "branch_free_level_bodies": bodies, "sm_clock_mhz": mhz,
           "sms": sms,
           "issue_floor_ms": None}
    if bodies and mhz:
        per_eq_level = bodies[0] / (32 * elems)
        out["instructions_per_equation_level"] = per_eq_level
        out["issue_floor_ms"] = (equations * out["levels"] * per_eq_level
                                 / (sms * 4 * mhz * 1e6) * 1e3)
    log(f"[issue] {json.dumps(out)}")
    return out


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
                                                 scan_add_plain, scan_route)

    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    unequal = {"warp": 0, "block": 0}
    routed = {"warp": 0, "block": 0}

    def count(got, ref, rows, tile_n, stages):
        route = scan_route(rows, tile_n, stages)
        routed[route] += 1
        unequal[route] += int((got != ref).sum())

    def one(batch, n, rows, tile_n, stages, unroll, dtype):
        x = torch.randn(batch, n, generator=gen, device=dev).to(dtypes[dtype])
        got = _launch(x, rows, tile_n, tuple(stages), unroll)
        ref = scan_add_plain(x, rows_per_program=rows, tile_n=tile_n,
                             stages=stages, unroll=unroll)
        torch.cuda.synchronize()
        what = (f"scan_add {dtype} ({batch},{n}) rows={rows} tile={tile_n} "
                f"stages={tuple(stages)} unroll={unroll}")
        check_close(got, ref, dtype, what)
        count(got, ref, rows, tile_n, tuple(stages))
        return got, ref

    cases = 0
    # fused (one tile) and multi-tile, both dtypes, every radix x unroll
    for dtype in dtypes:
        for batch, n, rows, tile_n in ((64, 4096, 4, 4096), (64, 4096, 8, 128),
                                       (16, 1024, 2, 256), (6, 96, 3, 96),
                                       (64, 1024, 8, 1024), (8, 8192, 1, 2048),
                                       (4, 32768, 1, 32768), (64, 256, 4, 32)):
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
    got, ref = scan_add(xs, **kw), scan_add_plain(xs, **kw)
    check_close(got, ref, "float32", "scan_add on a column slice")
    count(got, ref, 4, 1024, kw["stages"])
    cases += 1
    log(f"[kernels] scan_add: {cases} shape/stage/unroll cases match the "
        f"plain version (by route {routed}); elements not bit-equal to "
        f"scan_add_plain: {unequal}")

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
        count(got, plain[key], cfg["rows_per_program"], cfg["tile_n"],
              stages)
        del got
    torch.cuda.synchronize()
    log(f"[kernels] scan_space({wl.key}, h100): all {len(cfgs)} admitted "
        f"configs launch and match the plain version (max abs err "
        f"{worst:.3e})")
    del x, plain
    log(f"[kernels] scan_add: {sum(routed.values())} launches checked (by "
        f"route {routed}), elements not bit-equal to scan_add_plain "
        f"{unequal}")
    if any(unequal.values()):
        raise AssertionError(f"scan_add is not bit-equal to scan_add_plain: "
                             f"{unequal} elements differ")

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


def require_launched(counts, names, what):
    for name in names:
        if counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on {what}")


def require_new_routes(counts, what):
    """Every launch of a routed kernel on this path took its new route."""
    for name, route in NEWEST_ROUTE.items():
        if counts[f"{name}.{route}"] != counts[name]:
            raise AssertionError(f"{what}: {name} took an earlier kernel: "
                                 f"{counts}")


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
    reset_launch_counts()
    for n, batch in main_path_cases():
        with capture_launches() as launched:
            outputs[n] = prefix_sum(inputs[n])
        wl = Workload(op="scan", n=n, batch=batch, variant="ks")
        cfg = default_session().resolve(wl)
        plan = plan_for(_plan_workload(wl, linrec=False), cfg)
        runs.append((n, batch, cfg, plan, list(launched)))
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[main] launches on the prefix-sum path: {counts}")
    require_launched(counts, ("scan_add", "scan_add.warp", "apply_add"),
                     "the prefix-sum path")
    require_new_routes(counts, "the prefix-sum path")
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


# the [loop] phase's methods: ml is scored in [ml], on its own suite
LOOP_METHODS = ("exhaustive", "analytical", "online", "bayesian", "random")


def loop_factory(dev, made):
    """The [loop] phase's wall-clock objectives, each appended to ``made``:
    the suite runner on its own inputs (seed 2), reps 5, warmup 1."""
    from repro_torch.core.objective import WallClockObjective
    from repro_torch.launch.tune import make_suite_runner

    runner = make_suite_runner(dev, seed=2)

    def factory():
        obj = WallClockObjective(runner, reps=5, warmup=1, device="cuda")
        made.append(obj)
        return obj

    return factory


def loop_workloads():
    """The [loop] phase's workloads: the paper's ops at 2^26 / n problems,
    ssd at the mamba2-130m prefill's rows, one qwen layer's attention and
    MLP up-projection in bf16."""
    from repro_torch.core import Workload
    from repro_torch.launch.tune import ATTN_HEADS, SSD_HEADS

    wls = [Workload(op="scan", n=n, batch=TOTAL_ELEMS // n, variant="ks")
           for n in (1024, 4096)]
    wls += [Workload(op="tridiag", n=n, batch=TOTAL_ELEMS // n,
                     variant="pcr") for n in (256, 1024)]
    wls += [Workload(op="fft", n=n, batch=TOTAL_ELEMS // n,
                     variant="stockham") for n in (1024, 4096)]
    # ssd at the mamba2-130m prefill's rows (8 sequences x 24 heads)
    wls += [Workload(op="ssd", n=n, batch=SSD_BATCH * SSD_HEADS,
                     variant="chunked") for n in SSD_LOOP_SIZES]
    # one qwen layer's attention (4 x 16 heads of 2048) and its MLP
    # up-projection (M = 8192 token rows, K = 1024, N = 2816), bf16
    wls += [Workload(op="attention", n=DENSE_LEN,
                     batch=DENSE_BATCH * ATTN_HEADS, dtype="bfloat16",
                     variant="flash"),
            Workload(op="matmul", n=MATMUL_SHAPE[2], batch=MATMUL_SHAPE[0],
                     dtype="bfloat16", variant="tiled")]
    return wls


def phase_loop(dev):
    """compare_methods on measured times (the paper's Table II)."""
    from repro_torch.evaluation import check_report, compare_methods, format_report

    made = []
    reset_launch_counts()
    t0 = time.perf_counter()
    report = compare_methods(loop_workloads(), LOOP_METHODS,
                             objective_factory=loop_factory(dev, made),
                             seed=0, max_evals=20)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
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
    require_launched(counts, ("scan_add", "scan_add.warp", "pcr", "pcr.warp",
                              "scan_linrec", "scan_linrec.warp",
                              "fft_stockham", "fft_stockham.pow2",
                              "ssd_intra", "flash_attention", "matmul"),
                     "the tuning loop")
    require_new_routes(counts, "the tuning loop")
    log("[loop] phi " + json.dumps(
        {op: {name: agg["phi"] for name, agg in per.items()}
         for op, per in report["per_op"].items()}))
    log("[loop] overall " + json.dumps(
        {name: {"phi": agg["phi"], "evaluations": agg["total_evaluations"],
                "optimum_rate": agg["optimum_rate"]}
         for name, agg in report["overall"].items()}))
    log("[loop] online " + json.dumps(
        {row["workload"]: {k: row["methods"]["online"][k]
                           for k in ("evaluations", "stopped_by",
                                     "efficiency")}
         for row in report["workloads"]}))
    return report, counts


ML_SEED = 3                 # the [ml] sweeps' inputs
ML_METHODS = ("exhaustive", "analytical", "ml", "bayesian", "random")
# a kernel of each family the card suite sweeps
ML_KERNELS = ("scan_add", "scan_linrec", "pcr", "fft_stockham", "ssd_intra",
              "flash_attention", "matmul")
ML_BAD_RUNGS = ("ml-fallback:no-model", "ml-fallback:no-forest")


def phase_ml(dev):
    """The paper's ML-based methodology on measured times: every config of
    the card suite's train and holdout sizes timed once
    (``WallClockObjective``, reps 3, warmup 1) into journals under
    ``artifacts/ml_card`` (gitignored); one forest per op family (48
    trees, depth 12, seed 0) trained from the train journals and saved
    there; the held-out sizes scored by
    ``evaluate_model`` and by ``compare_methods`` against exhaustive /
    analytical / bayesian / random on the same times.  Fails on Phi > 1,
    a runner failure, a ``no-model`` or ``no-forest`` rung, a family whose
    kernels the sweeps did not launch, or a config measured twice."""
    import shutil

    import torch
    from repro_torch.core.objective import CachedObjective, WallClockObjective
    from repro_torch.core.space import build_space
    from repro_torch.evaluation import (check_report, compare_methods,
                                        format_report)
    from repro_torch.launch.tune import (card_workloads, make_suite_runner,
                                         sweep_into)
    from repro_torch.tuning.ml import (dataset_from_journal_dir,
                                       evaluate_model, train_bundle)
    from repro_torch.tuning.ml.dataset import POOLED_OPS

    root = os.path.join(ROOT, "artifacts", "ml_card")
    shutil.rmtree(root, ignore_errors=True)
    train_dir = os.path.join(root, "train")
    hold_dir = os.path.join(root, "holdout")
    train, hold = card_workloads("train"), card_workloads("holdout")
    sizes = {split: sum(len(build_space(w).enumerate_valid()) for w in wls)
             for split, wls in (("train", train), ("holdout", hold))}
    inner = WallClockObjective(make_suite_runner(dev, seed=ML_SEED), reps=3,
                               warmup=1, device="cuda")
    measured = CachedObjective(inner)
    t0 = time.perf_counter()
    reset_launch_counts()
    sweep_into(measured, train, train_dir)
    t_train = time.perf_counter() - t0
    sweep_into(measured, hold, hold_dir)
    torch.cuda.synchronize()
    counts = launch_counts()
    t_sweeps = time.perf_counter() - t0
    swept = measured.evaluations
    log(f"[ml] card suite: {len(train)} train workloads ({sizes['train']} "
        f"configs), {len(hold)} holdout ({sizes['holdout']}); swept once in "
        f"{t_sweeps:.1f} s (train {t_train:.1f} s); {swept} measurements; "
        f"launches {counts}")

    t0 = time.perf_counter()
    ds = dataset_from_journal_dir(train_dir, objective=inner)
    bundle = train_bundle(ds.by_op(), n_trees=48, max_depth=12, seed=0,
                          meta={"aliases": POOLED_OPS})
    path = bundle.save(os.path.join(root, "ml_model_torch.npz"))
    os.environ["REPRO_TORCH_ML_MODEL"] = path
    t_fit = time.perf_counter() - t0
    log(f"[ml] trained on {len(ds)} rows of {len(ds.keys)} train journals "
        f"in {t_fit:.1f} s: rows {bundle.meta['train_rows']}; {path}")

    t0 = time.perf_counter()
    ev = evaluate_model(bundle, hold, objective=measured)
    report = compare_methods(hold, ML_METHODS, objective_factory=lambda:
                             measured, seed=0, max_evals=20,
                             journal_dir=hold_dir)
    t_score = time.perf_counter() - t0
    for op, r in sorted(ev["per_op"].items()):
        rows = [w for w in ev["workloads"] if w["op"] == op]
        rungs = {}
        for w in rows:
            rungs[w["rung"]] = rungs.get(w["rung"], 0) + 1
        corr = [w["rank_corr"] for w in rows if w["rank_corr"] is not None]
        log(f"[ml] eval {op}: top1 {r['top1_rate']:.3f}, mean slowdown "
            f"{r['mean_slowdown']:.4f}, max {r['max_slowdown']:.4f}, rank "
            f"corr {sum(corr) / len(corr) if corr else float('nan'):.3f}, "
            f"rungs {rungs} (n={r['n']})")
    log(f"[ml] eval overall: top1 {ev['top1_rate']:.3f}, mean slowdown "
        f"{ev['mean_slowdown']:.4f}, max {ev['max_slowdown']:.4f}, ml_rate "
        f"{ev['ml_rate']:.3f}, rank corr {ev['mean_rank_corr']:.3f}, rungs "
        f"{ev['rungs']}")
    for w in ev["workloads"]:
        log(f"[ml] {w['workload']}: {w['candidates']} configs, rung "
            f"{w['rung']}, slowdown {w['slowdown']:.4f}, chosen "
            f"{w['chosen_config']}, best {w['best_config']}")
    for line in format_report(report).splitlines():
        log(f"[ml] {line}")
    for row in report["workloads"]:
        picks = {m: [row["methods"][m]["config"],
                     row["methods"][m]["time_s"] * 1e3]
                 for m in row["methods"]}
        log(f"[ml] compare {row['workload']}: optimum "
            f"{row['best_time_s'] * 1e3:.4f} ms; ml's rung "
            f"{row['methods']['ml']['stopped_by']}; config, ms by method "
            f"{json.dumps(picks, sort_keys=True)}")
    log("[ml] phi " + json.dumps(
        {op: {name: agg["phi"] for name, agg in per.items()}
         for op, per in report["per_op"].items()}
        | {"overall": {name: agg["phi"]
                       for name, agg in report["overall"].items()}}))
    log(f"[ml] runner failures: {inner.failures}; {t_sweeps + t_fit + t_score:.1f} "
        f"s (sweeps {t_sweeps:.1f}, training {t_fit:.1f}, scoring "
        f"{t_score:.1f})")

    problems = check_report(report)
    bad = [f"{w['workload']}: {w['rung']}" for w in ev["workloads"]
           if w["rung"].startswith(ML_BAD_RUNGS)]
    bad += [f"compare {row['workload']}: {row['methods']['ml']['stopped_by']}"
            for row in report["workloads"]
            if row["methods"]["ml"]["stopped_by"].startswith(ML_BAD_RUNGS)]
    if problems or inner.failures or bad:
        raise AssertionError(f"[ml]: {problems}, runner failures "
                             f"{inner.failures}, rungs {bad}")
    if measured.evaluations != swept:
        raise AssertionError(f"[ml]: {measured.evaluations - swept} configs "
                             f"measured a second time")
    require_launched(counts, ML_KERNELS, "the [ml] sweeps")
    return counts


def phase_numbers(dev, inputs, runs, counts, bandwidth: float):
    """Times, bounds and errors per kernel at the main path's shapes."""
    import torch
    from repro_torch.kernels.blocks.driver import apply_add, apply_add_plain
    from repro_torch.kernels.blocks.plan import stage_radices
    from repro_torch.kernels.scan.kernel import (_launch, scan_add_block,
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
            # the block kernel (the earlier design) on the same inputs
            row["scan_add_block_ms"] = time_ms(
                lambda: _launch(x, kw["rows"], kw["tile_n"], kw["stages"],
                                kw["unroll"], route="block"), 10)
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
                    "launches_by_route": {r: counts[f"scan_add.{r}"]
                                          for r in LAUNCH_ROUTES["scan_add"]},
                    "max_abs_err": row["max_abs_err"],
                    "unequal_elements": int((got != ref).sum()),
                    "ms": row["scan_add_ms"],
                    "block_ms": row["scan_add_block_ms"],
                    "plain_ms": row["plain_ms"],
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
            row["chunk_scan_block_ms"] = time_ms(
                lambda: _launch(xc, l1.block_shape[0], length, l1.stages,
                                cfg["unroll"], route="block"), 10)
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
    # both kernels over radix x rows x unroll at the n = 1024 shape
    x = inputs[1024]
    sweep = {}
    for radix in (2, 4, 8):
        stages = stage_radices(1024, radix)
        for r in (1, 8, 64):
            for unroll in (1, 8):
                for route in ("warp", "block"):
                    sweep[f"{route} radix {radix} rows {r} unroll {unroll}"] \
                        = time_ms(lambda: _launch(x, r, 1024, stages, unroll,
                                                  route=route), 5)
    log(f"[numbers] scan_add ms at {list(x.shape)}: {json.dumps(sweep)}")
    scan_trace(runs, inputs)
    return [scan_entry, apply_entry], shapes


def scan_trace(runs, inputs):
    """torch.profiler's device time of one prefix_sum call at each fused
    main-path shape, on the warp kernel (the entry point) and on the block
    kernel (the same plan forced to the block route)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.scan.kernel import scan_add_block
    from repro_torch.kernels.scan.ops import prefix_sum

    fused = [(n, plan, cfg) for n, _, cfg, plan, _ in runs
             if plan.kind == "fused"]
    for n, plan, cfg in fused:          # warm both up outside the trace
        prefix_sum(inputs[n])
        scan_add_block(inputs[n], rows_per_program=plan.rows,
                       tile_n=plan.tile_n, stages=plan.stages,
                       unroll=cfg["unroll"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for n, plan, cfg in fused:
            prefix_sum(inputs[n])
            scan_add_block(inputs[n], rows_per_program=plan.rows,
                           tile_n=plan.tile_n, stages=plan.stages,
                           unroll=cfg["unroll"])
        torch.cuda.synchronize()
    device = {}
    for evt in prof.key_averages():
        t = getattr(evt, "device_time_total", None)
        if t is None:
            t = getattr(evt, "cuda_time_total", 0.0)
        if t and "scan" in evt.key:
            device[evt.key[:80]] = {"device_ms": t / 1e3,
                                    "calls": evt.count}
    log(f"[trace] scan kernels at n = {[n for n, _, _ in fused]}: "
        f"{json.dumps(device, sort_keys=True)}")


def linrec_inputs(gen, dev, batch, n, dtype=None, slow=False):
    """a in [0.8, 0.99) (a stable recurrence, as the tests draw it), or,
    with ``slow``, in [0.9999, 1) (prefix products near 1 over 32768
    columns, so a wrong neighbour at any stride would show in h); b
    standard normal."""
    import torch
    lo, width = (0.9999, 1e-4) if slow else (0.8, 0.19)
    a = torch.rand(batch, n, generator=gen, device=dev) * width + lo
    b = torch.randn(batch, n, generator=gen, device=dev)
    if dtype is not None:
        a, b = a.to(dtype), b.to(dtype)
    return a, b


def laplacian_system(gen, dev, batch, n):
    """A perturbed 1-D Laplacian (a = c ~ -1, b ~ 2, d standard normal):
    its off-diagonals keep their size at every PCR level, where those of a
    strongly diagonally dominant system underflow to 0 after a few."""
    import torch
    a = -1.0 - 0.01 * torch.rand(batch, n, generator=gen, device=dev)
    c = -1.0 - 0.01 * torch.rand(batch, n, generator=gen, device=dev)
    b = 2.03 + 0.01 * torch.rand(batch, n, generator=gen, device=dev)
    d = torch.randn(batch, n, generator=gen, device=dev)
    a[:, 0] = 0.0
    c[:, -1] = 0.0
    return a, b, c, d


def linrec_block(a, b, rows, tile_n, stages, gate=False, products=False):
    """The block linrec kernel (the earlier design) on CUDA tensors
    whatever the route: its record beside the warp kernel.  h, or (h,
    products) with ``products``; counts no launch."""
    from repro_torch.kernels.scan import kernel as scan_kernel
    out = scan_kernel._launch_linrec(
        a.contiguous(), b.contiguous(), rows, tile_n,
        tuple(int(r) for r in stages), gate, products, route="block")
    return out if products else out[0]


def pcr_block(planes, rows, unroll):
    """The block PCR kernel's record, as :func:`linrec_block` (``unroll``
    capped at its 16 equations a thread: the knob changes no result)."""
    from repro_torch.kernels.tridiag import kernel as pcr_kernel
    return pcr_kernel._launch(tuple(v.contiguous() for v in planes), rows,
                              min(unroll, 16), route="block")


def phase_linrec_kernels(dev, quick: bool):
    """scan_linrec, scan_linrec_prod, apply_linrec and pcr against their
    plain versions on the card.  The routed launches (the warp kernels,
    or the block kernels for ragged, prime and odd shapes) and the block
    kernels' records on the same inputs must equal the plain versions bit
    for bit; apply_linrec is held to DTYPE_TOL (its error printed is
    expected to be 0)."""
    import torch
    from repro_torch.core.space import Workload, scan_space, tridiag_space
    from repro_torch.hw.profiles import get_profile
    from repro_torch.kernels.blocks.driver import (apply_linrec,
                                                   apply_linrec_plain)
    from repro_torch.kernels.blocks.plan import stage_radices
    from repro_torch.kernels.scan.kernel import (linrec_route, scan_linrec,
                                                 scan_linrec_plain,
                                                 scan_linrec_prod,
                                                 scan_linrec_prod_plain,
                                                 staged_piece)
    from repro_torch.kernels.tridiag.kernel import (pcr, pcr_plain,
                                                    pcr_route)
    from repro_torch.kernels.tridiag.ref import random_system

    gen = torch.Generator(device=dev).manual_seed(3)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    h100 = get_profile("h100")
    worst = {"scan_linrec": 0.0, "scan_linrec_prod": 0.0,
             "apply_linrec": 0.0, "pcr": 0.0}
    # per kernel: launches checked by route, and elements not bit-equal to
    # the plain version on the routed launch and on the block record
    checked = {k: {"warp": 0, "block": 0}
               for k in ("scan_linrec", "scan_linrec_prod", "pcr")}
    unequal = {k: {"warp": 0, "block": 0, "block record": 0}
               for k in ("scan_linrec", "scan_linrec_prod", "pcr")}

    def hold(name, route, got, ref, block, dtype, what):
        worst[name] = max(worst[name], check_close(got, ref, dtype, what))
        checked[name][route] += 1
        unequal[name][route] += int((got != ref).sum())
        unequal[name]["block record"] += int((block != ref).sum())

    def linrec(batch, n, rows, tile_n, stages, dtype, gate, ab=None,
               ref=None, slow=False):
        a, b = ab or linrec_inputs(gen, dev, batch, n, dtypes[dtype], slow)
        kw = dict(rows_per_program=rows, tile_n=tile_n, stages=stages,
                  gate=gate)
        got = scan_linrec(a, b, **kw)
        block = linrec_block(a, b, rows, tile_n, stages, gate)
        ref = scan_linrec_plain(a, b, **kw) if ref is None else ref
        torch.cuda.synchronize()
        hold("scan_linrec", linrec_route(rows, tile_n, stages), got, ref,
             block, dtype, f"scan_linrec {dtype} ({a.shape[0]},{a.shape[1]}) "
             f"rows={rows} tile={tile_n} stages={tuple(stages)} gate={gate}")

    def prod(batch, n, rows, stages, dtype, gate, slow=False):
        a, b = linrec_inputs(gen, dev, batch, n, dtypes[dtype], slow)
        kw = dict(rows_per_program=rows, stages=stages, gate=gate)
        got = scan_linrec_prod(a, b, **kw)
        block = linrec_block(a, b, rows, n, stages, gate, products=True)
        ref = scan_linrec_prod_plain(a, b, **kw)
        torch.cuda.synchronize()
        what = (f"scan_linrec_prod {dtype} ({batch},{n}) rows={rows} "
                f"stages={tuple(stages)} gate={gate}")
        route = linrec_route(rows, n, stages, products=True)
        for i, part in enumerate(("h", "p")):
            hold("scan_linrec_prod", route, got[i], ref[i], block[i], dtype,
                 f"{what} {part}")

    cases = 0
    for dtype in dtypes:
        for gate in (False, True):
            for batch, n, rows, tile_n in ((64, 4096, 4, 4096),
                                           (64, 4096, 8, 128),
                                           (16, 1024, 2, 256), (6, 96, 3, 96),
                                           (64, 1024, 8, 1024),
                                           (48, 64, 8, 16), (40, 64, 5, 4)):
                for radix in (2, 4, 8):
                    linrec(batch, n, rows, tile_n,
                           stage_radices(tile_n, radix), dtype, gate)
                    cases += 1
            # the largest tiles (32768 elements: the warp kernel's planes in
            # the global scratch), staged pieces, prime fan-ins, odd rows
            for batch, n, rows, tile_n, stages in (
                    (4, 16384, 1, 16384, stage_radices(16384, 4)),
                    (2, 65536, 1, 32768, stage_radices(32768, 8)),
                    (4, 32768, 2, 16384, stage_radices(16384, 2)),
                    (16, 32768, 16, 32768, stage_radices(32768, 8)),
                    (8, 8192, 8, 8192, stage_radices(8192, 4)),
                    (5, 212, 5, 106, (2, 53)),
                    (3, 1018, 3, 1018, (2, 509)),
                    (7, 768, 7, 768, stage_radices(768, 8))):
                linrec(batch, n, rows, tile_n, stages, dtype, gate)
                cases += 1
            for batch, n, rows, stages in (
                    (1024, 4096, 1, stage_radices(4096, 8)),
                    (512, 2048, 4, stage_radices(2048, 2)),
                    (96, 100, 3, stage_radices(100, 4)),
                    (7, 106, 7, (2, 53)),
                    (2, 32768, 1, stage_radices(32768, 4)),
                    (64, 16, 8, stage_radices(16, 4)),
                    (24, 1024, 3, stage_radices(1024, 8))):
                prod(batch, n, rows, stages, dtype, gate)
                cases += 1
        # a near 1: every stage's neighbours show in h
        for batch, n, rows, tile_n, radix in (
                (64, 1024, 8, 1024, 4), (16, 4096, 4, 4096, 8),
                (8, 8192, 2, 2048, 2), (2, 65536, 1, 32768, 8),
                (16, 32768, 16, 32768, 8), (48, 64, 8, 16, 4)):
            linrec(batch, n, rows, tile_n, stage_radices(tile_n, radix),
                   dtype, False, slow=True)
            cases += 1
        for batch, n, rows, radix in ((1024, 4096, 1, 8), (2, 32768, 1, 4)):
            prod(batch, n, rows, stage_radices(n, radix), dtype, True,
                 slow=True)
            cases += 1
    log(f"[kernels] scan_linrec / scan_linrec_prod: {cases} shape/stage/gate "
        f"cases within tolerance (max abs err {worst['scan_linrec']:.3e} / "
        f"{worst['scan_linrec_prod']:.3e})")

    # every admitted config of the paper workload's linrec space, per type
    for dtype in dtypes:
        wl = Workload(op="scan", n=1024, batch=TOTAL_ELEMS // 1024,
                      dtype=dtype, variant="linrec")
        cfgs = scan_space(wl, h100).enumerate_valid()
        if quick:
            cfgs = cfgs[::16]
        a, b = linrec_inputs(gen, dev, wl.batch, wl.n, dtypes[dtype])
        plain = {}
        for cfg in cfgs:
            stages = stage_radices(cfg["tile_n"], cfg["radix"])
            rows = cfg["rows_per_program"]
            # the plain version walks the same staged pieces as the kernels
            key = staged_piece(rows, cfg["tile_n"], stages)
            if key not in plain:
                plain[key] = scan_linrec_plain(a, b, rows_per_program=rows,
                                               tile_n=cfg["tile_n"],
                                               stages=stages)
            linrec(wl.batch, wl.n, rows, cfg["tile_n"], stages, dtype, False,
                   ab=(a, b), ref=plain[key])
        torch.cuda.synchronize()
        log(f"[kernels] scan_space({wl.key}, h100): all {len(cfgs)} admitted "
            f"configs launch and equal the plain version")
        del a, b, plain

    # apply_linrec (multipass launch 3), both output types
    for rows_n, length, rows, out in ((4096, 16384, 8, torch.float32),
                                      (4096, 16384, 1, torch.bfloat16),
                                      (96, 100, 3, torch.float32)):
        h = torch.randn(rows_n, length, generator=gen, device=dev)
        pr = torch.rand(rows_n, length, generator=gen, device=dev)
        e = torch.randn(rows_n, 1, generator=gen, device=dev) * 100
        got = apply_linrec(h, pr, e, rows=rows, out_dtype=out)
        ref = apply_linrec_plain(h, pr, e, rows=rows, out_dtype=out)
        torch.cuda.synchronize()
        worst["apply_linrec"] = max(worst["apply_linrec"], check_close(
            got, ref, "float32" if out == torch.float32 else "bfloat16",
            f"apply_linrec ({rows_n},{length}) rows={rows} {out}"))
    log(f"[kernels] apply_linrec: f32 and bf16 outputs within tolerance (max "
        f"abs err {worst['apply_linrec']:.3e})")

    # pcr: odd, prime and non-power-of-two n, n = 1, the largest systems;
    # on the warp kernel E = 1 ... 32 equations a lane, 1 ... 32 warps a
    # system
    def solve_pcr(planes, rows, unroll, dtype, ref=None):
        got = pcr(*planes, rows_per_program=rows, unroll=unroll)
        block = pcr_block(planes, rows, unroll)
        if ref is None:
            ref = pcr_plain(*planes, rows_per_program=rows, unroll=unroll)
        torch.cuda.synchronize()
        batch, n = planes[0].shape
        hold("pcr", pcr_route(rows, n, unroll), got, ref, block, dtype,
             f"pcr {dtype} ({batch},{n}) rows={rows} unroll={unroll}")

    cases = 0
    for dtype in dtypes:
        for batch, n, rows, unroll in ((64, 1024, 4, 1), (64, 1024, 1, 4),
                                       (6, 96, 3, 2), (10, 100, 5, 1),
                                       (8, 1, 2, 1), (3, 7, 3, 4),
                                       (4, 8192, 1, 1), (2, 16384, 1, 2),
                                       (1024, 256, 16, 2), (96, 32, 3, 1),
                                       (64, 64, 8, 2), (48, 128, 6, 4),
                                       (40, 512, 5, 1), (16, 1024, 2, 32),
                                       (16, 1024, 4, 16), (64, 256, 8, 8),
                                       (32, 512, 4, 3)):
            planes = [v.to(dtypes[dtype])
                      for v in random_system(gen, batch, n)]
            solve_pcr(planes, rows, unroll, dtype)
            cases += 1
        # off-diagonals that keep their size: every level's neighbours show
        for batch, n, rows, unroll in ((64, 1024, 4, 4), (1024, 256, 16, 4),
                                       (96, 32, 3, 1), (40, 512, 5, 2),
                                       (64, 64, 8, 2), (6, 96, 3, 2)):
            planes = [v.to(dtypes[dtype])
                      for v in laplacian_system(gen, dev, batch, n)]
            solve_pcr(planes, rows, unroll, dtype)
            cases += 1
        # every divide path of the warp kernel's three kinds of level:
        # divisors out of the fast range (x 2^30), signed zeros and
        # subnormal off-diagonals, over shared, lane and chain levels
        for n, unroll in ((256, 1), (1024, 1), (256, 8), (1024, 32)):
            a, b, c, d = random_system(gen, 256, n)
            pick = torch.rand(a.shape, generator=gen, device=dev) < 0.2
            for planes in ((a, b, c, d),
                           tuple(v * 2.0 ** 30 for v in (a, b, c, d)),
                           (torch.where(pick, -0.0 * torch.sign(a), a), b,
                            torch.where(pick.roll(1, 1), 0.0 * c, c), d),
                           (torch.where(pick, a * 2.0 ** -140, a), b,
                            torch.where(pick.roll(3, 1), c * 2.0 ** -130, c),
                            d)):
                solve_pcr([v.to(dtypes[dtype]) for v in planes], 4, unroll,
                          dtype)
                cases += 1
    for dtype in dtypes:
        for n in (256, 1024):
            wl = Workload(op="tridiag", n=n, batch=TOTAL_ELEMS // n,
                          dtype=dtype, variant="pcr")
            cfgs = tridiag_space(wl, h100).enumerate_valid()
            planes = [v.to(dtypes[dtype])
                      for v in random_system(gen, wl.batch, wl.n)]
            ref = pcr_plain(*planes, rows_per_program=1)
            for cfg in cfgs:
                solve_pcr(planes, cfg["rows_per_program"], cfg["unroll"],
                          dtype, ref=ref)
            cases += len(cfgs)
            log(f"[kernels] tridiag_space({wl.key}, h100): all {len(cfgs)} "
                f"admitted configs launch and equal the plain version")
            del planes, ref
    log(f"[kernels] pcr: {cases} cases within tolerance (max abs err "
        f"{worst['pcr']:.3e})")
    pcr_divide_check(dev, quick)
    log(f"[kernels] linrec / pcr launches checked by route "
        f"{json.dumps(checked)}; elements not bit-equal to the plain "
        f"versions {json.dumps(unequal)}")
    if any(v for per in unequal.values() for v in per.values()):
        raise AssertionError(f"a linrec or pcr kernel is not bit-equal to "
                             f"its plain version: {unequal}")
    return worst, unequal


def pcr_divide_check(dev, quick: bool):
    """The warp PCR kernel's branch-free divides against __fdiv_rn on the
    card (``repro_pcr_divide_check``): random operands across and beyond
    the ranges each path admits (zeros, subnormals, signs), quotients next
    to a rounding tie of the float grid and of the subnormal grid, each
    also moved by up to two ulps.  Fails if any admitted pair differs."""
    import ctypes
    import torch
    from repro_torch.kernels.build import check, load_library

    gen = torch.Generator(device=dev).manual_seed(17)
    n = 2 ** 24 if quick else 2 ** 26

    def bits(lo, hi):
        """Floats of random sign and mantissa, exponents lo ... hi (-127:
        zero and subnormals)."""
        m = torch.randint(0, 1 << 23, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        e = torch.randint(127 + lo, 127 + hi + 1, (n,), generator=gen,
                          device=dev, dtype=torch.int32)
        sign = torch.randint(0, 2, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        return ((sign << 31) | (e << 23) | m).view(torch.float32)

    def nudge(v):
        step = torch.randint(-2, 3, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        return (v.view(torch.int32) + step).view(torch.float32)

    def tie(y, q):
        """x with x / y next to the midpoint above q (float64 product,
        rounded once to f32)."""
        up = (q.view(torch.int32) + 1).view(torch.float32)
        return (y.double() * (q.double() + up.double()) / 2).float()

    lib = load_library()
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    kinds = 0
    for _ in range(1 if quick else 2):
        y = bits(-30, 30)
        q = bits(-100, 100)
        sub = torch.randint(0, 1 << 22, (n,), generator=gen, device=dev,
                            dtype=torch.int32).view(torch.float32)
        for x in (bits(-127, 100), tie(y, q), nudge(tie(y, q)),
                  tie(y, sub), nudge(tie(y, sub))):
            stream = torch.cuda.current_stream(dev).cuda_stream
            check(lib.repro_pcr_divide_check(
                x.data_ptr(), y.data_ptr(), ctypes.c_longlong(n),
                counts.data_ptr(), stream), "pcr divide check")
            kinds += 1
    torch.cuda.synchronize()
    near, tiny, near_bad, tiny_bad = (int(v) for v in counts.tolist())
    log(f"[kernels] pcr divides vs __fdiv_rn: {kinds} x {n} pairs; the "
        f"fast-path sequence admitted {near}, {near_bad} differ; the scaled "
        f"path admitted {tiny}, {tiny_bad} differ")
    if near_bad or tiny_bad:
        raise AssertionError(f"the warp PCR kernel's divides differ from "
                             f"__fdiv_rn: {near_bad} / {tiny_bad}")


THOMAS_SIZES = (256, 1024, 2 ** 16, 2 ** 22)   # solve(variant="thomas")


def tridiag_path_cases():
    """(variant, n, batch): 2^26 equations a call."""
    out = [(v, n, TOTAL_ELEMS // n) for n in (256, 1024)
           for v in ("pcr", "cr", "lf", "wm")]
    # LF above LF_MULTIPASS_MIN: a fused and a multipass linrec plan
    out += [("lf", 2 ** 16, 1024), ("lf", 2 ** 22, 16)]
    # Thomas on its kernel at the paper's sizes
    return out + [("thomas", n, TOTAL_ELEMS // n) for n in THOMAS_SIZES]


def linrec_path_cases():
    return [(1024, TOTAL_ELEMS // 1024), (2 ** 22, 16)]


def linrec_f64_sequential(a, b):
    """h_t = a_t h_{t-1} + b_t in float64 on the CPU, one step at a time
    (Python floats: a few seconds for a row of 2^22 steps)."""
    import torch
    rows = []
    for ar, br in zip(a.double().cpu().tolist(), b.double().cpu().tolist()):
        h, out = 0.0, []
        for at, bt in zip(ar, br):
            h = at * h + bt
            out.append(h)
        rows.append(out)
    return torch.tensor(rows, dtype=torch.float64)


def thomas_f64_sequential(a, b, c, d):
    """The Thomas algorithm in float64 on the CPU, one step at a time
    (Python floats: a fraction of a second for a row of 2^16, a few
    seconds for a row of 2^22)."""
    import torch
    rows = []
    for ar, br, cr, dr in zip(*(v.double().cpu().tolist()
                                for v in (a, b, c, d))):
        cps, dps, cp, dp = [], [], 0.0, 0.0
        for ai, bi, ci, di in zip(ar, br, cr, dr):
            denom = bi - ai * cp
            cp, dp = ci / denom, (di - ai * dp) / denom
            cps.append(cp)
            dps.append(dp)
        x, out = 0.0, [0.0] * len(cps)
        for i in reversed(range(len(cps))):
            x = dps[i] - cps[i] * x
            out[i] = x
        rows.append(out)
    return torch.tensor(rows, dtype=torch.float64)


def thomas_out_of_range_rows(planes):
    """The planes with row i's a, b, c scaled by 2^e and d by 2^h, e and h
    cycling through exponents beyond the routes' fast divide (divisors
    past 2^+-24, dividends past 2^+-96), and signed zeros in d: the lanes
    that meet them replay their tile or segment with __fdiv_rn."""
    import torch
    a, b, c, d = (v.clone() for v in planes)
    rows = torch.arange(a.shape[0], device=a.device)
    # (e, h) pairs keep x finite: |h - e| <= 100
    e = torch.tensor([0, 30, -30, 60, -60, 100, -100, 0],
                     device=a.device)[rows % 8].to(torch.float32)
    h = torch.tensor([97, 0, 0, 120, -120, 30, -30, -100],
                     device=a.device)[rows % 8].to(torch.float32)
    f, g = torch.exp2(e)[:, None], torch.exp2(h)[:, None]
    a, b, c = (v.float().mul(f).to(v.dtype) for v in (a, b, c))
    d = d.float().mul(g).to(d.dtype)
    d[:, 1::5] = 0.0
    d[:, 3::7] = -0.0
    return a, b, c, d


def thomas_kernel_check(dev):
    """Each route of the Thomas kernel, forced, against ``thomas_ref`` on
    the card, f32 and bf16: the lane kernel and the long route over n = 1
    ... 1024 (ragged tiles at 31, 33, 97) and batches 1 ... 4096 (ragged
    warps at 3, 33), the wide route where n is a multiple of 8 (with c'
    and d' through the scratch pair, and on chip where they fit), and the
    long route's ragged rows, n = 1, 33, 97, 4097 at batch 1, 3, 16, and
    rows whose divides leave the fast divide's range
    (``thomas_out_of_range_rows``: the replay with __fdiv_rn): every
    element bit-equal (compared as integers), or the run fails.
    Launches made to compare are not counted.  Returns the cases by route
    and the elements compared."""
    import torch
    from repro_torch.kernels.tridiag import kernel as tk
    from repro_torch.kernels.tridiag.ref import random_system, thomas_ref
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    gen = torch.Generator(device=dev).manual_seed(28)
    cases = {r: 0 for r in tk.THOMAS_ROUTES}
    elems = 0

    def hold(planes, ref, route, resident=None):
        nonlocal elems
        got = tk._launch_thomas(tuple(planes), route=route,
                                resident=resident)
        unequal = int((got.view(bits[ref.dtype])
                       != ref.view(bits[ref.dtype])).sum())
        if unequal or got.shape != ref.shape:
            raise AssertionError(
                f"thomas route {route} (resident {resident}) {ref.dtype} "
                f"{list(ref.shape)}: {unequal} elements not bit-equal to "
                f"thomas_ref")
        cases[route] += 1
        elems += got.numel()

    # (n, batch, kind): the grid every route takes, the long route's
    # ragged rows, rows beyond the fast divide's range
    cases_nb = ([(n, batch, "grid")
                 for n in (1, 2, 3, 8, 31, 33, 97, 256, 1024)
                 for batch in (1, 3, 32, 33, 4096)]
                + [(n, batch, "ragged") for n in (1, 33, 97, 4097)
                   for batch in (1, 3, 16)]
                + [(256, 64, "scaled"), (1024, 33, "scaled"),
                   (4096, 5, "scaled")])
    for dtype in (torch.float32, torch.bfloat16):
        for n, batch, kind in cases_nb:
            planes = [v.to(dtype) for v in random_system(gen, batch, n)]
            if kind == "scaled":
                planes = thomas_out_of_range_rows(planes)
            ref = thomas_ref(*planes)
            hold(planes, ref, "long")
            if kind == "ragged":
                continue
            hold(planes, ref, "lane")
            if n % tk.THOMAS_WIDE_ALIGN == 0:
                hold(planes, ref, "wide", resident=False)
                if tk.thomas_wide_smem(n, ref.element_size(),
                                       True) <= tk.SMEM_MAX:
                    hold(planes, ref, "wide", resident=True)
    torch.cuda.synchronize()
    log(f"[kernels] thomas: {json.dumps(cases)} cases by route (f32 and "
        f"bf16, n = 1 ... 1024 at batch 1 ... 4096, the long route also at "
        f"n = 1, 33, 97, 4097 and batch 1, 3, 16, and rows out of the fast "
        f"divide's range), {elems} elements, all "
        f"bit-equal to thomas_ref")
    return {"cases": cases, "elements": elems, "unequal_elements": 0}


def phase_tridiag_path(dev):
    """solve and linear_recurrence at the paper's size, through the default
    session."""
    import torch
    from repro_torch.core.space import Workload
    from repro_torch.kernels.blocks.driver import capture_launches
    from repro_torch.kernels.blocks.plan import plan_for
    from repro_torch.kernels.scan.ops import _plan_workload, linear_recurrence
    from repro_torch.kernels.tridiag import kernel as thomas_kernel
    from repro_torch.kernels.tridiag.ops import LF_MULTIPASS_MIN, solve
    from repro_torch.kernels.tridiag.ref import random_system, residual
    from repro_torch.tuning import default_session

    gen = torch.Generator(device=dev).manual_seed(4)
    systems = {}
    for _, n, batch in tridiag_path_cases():
        if n not in systems:
            systems[n] = random_system(gen, batch, n)
    recs = {n: linrec_inputs(gen, dev, batch, n)
            for n, batch in linrec_path_cases()}
    torch.cuda.synchronize()
    session = default_session()
    reset_launch_counts()
    solved, recurred = [], []
    for variant, n, batch in tridiag_path_cases():
        before = launch_counts()
        with capture_launches() as launched:
            x = solve(*systems[n], variant=variant)
        after = launch_counts()
        taken = [r for r in LAUNCH_ROUTES["thomas"]
                 if after[f"thomas.{r}"] > before[f"thomas.{r}"]]
        solved.append((variant, n, batch, x, list(launched), taken))
    for n, batch in linrec_path_cases():
        with capture_launches() as launched:
            h = linear_recurrence(*recs[n])
        recurred.append((n, batch, h, list(launched)))
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[main] launches on the tridiagonal / linrec path: {counts}")
    require_launched(counts, ("scan_linrec", "scan_linrec.warp",
                              "scan_linrec_prod", "scan_linrec_prod.warp",
                              "apply_linrec", "pcr", "pcr.warp", "thomas"),
                     "the tridiagonal / linrec path")
    require_new_routes(counts, "the tridiagonal / linrec path")

    plans = {}
    thomas = {}
    sms = thomas_kernel.sm_count(dev)
    for variant, n, batch, x, launched, taken in solved:
        wl = Workload(op="tridiag", n=n, batch=batch, variant=variant)
        if variant == "lf" and n > LF_MULTIPASS_MIN:
            lwl = Workload(op="scan", n=n, batch=batch, variant="linrec")
            plan = plan_for(lwl, session.resolve(lwl))
            want = plan.launches * 2       # the forward and back sweeps
            detail = f"linrec plan {plan.kind}, config {session.resolve(lwl)}"
        elif variant == "thomas":
            # no config to resolve (solve asks for none, and the h100
            # space admits none at 2^16 and 2^22); the plan, as JAX's,
            # launches nothing through the driver: the kernel is counted
            plan = plan_for(wl, {})
            want = plan.launches
            route = thomas_kernel.thomas_route(batch, n, sms)
            if taken != [route] or route == "lane":
                raise AssertionError(f"solve thomas n={n}: launched the "
                                     f"routes {taken}, not the new route "
                                     f"{route!r} thomas_route picks")
            detail = (f"the Thomas kernel, route {route} (plan: no driver "
                      f"launch)")
        elif taken:
            raise AssertionError(f"solve {variant} n={n} launched the "
                                 f"Thomas kernel ({taken})")
        else:
            cfg = session.resolve(wl)
            plan = plan_for(wl, cfg)
            want = plan.launches
            detail = f"plan {plan.kind}, config {cfg}"
        plans[(variant, n)] = plan
        if tuple(launched) != want:
            raise AssertionError(f"solve {variant} n={n}: launched "
                                 f"{launched} != plan {want}")
        a, b, c, d = systems[n]
        if x.shape != (batch, n) or x.dtype != torch.float32:
            raise AssertionError(f"solve {variant} n={n}: output "
                                 f"{tuple(x.shape)} {x.dtype}")
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"solve {variant} n={n}: non-finite output")
        res = float(residual(a, b, c, d, x))
        # the tests' x50 scale on the f32 tolerance, against |d|
        bound = 50 * DTYPE_TOL["float32"][1] * max(float(d.abs().max()), 1.0)
        if res > bound:
            raise AssertionError(f"solve {variant} n={n}: residual {res:.3e} "
                                 f"> {bound:.3e}")
        line = (f"[main] solve {variant} n={n} batch={batch}: {detail}, "
                f"{len(launched)} launch(es), residual {res:.3e}")
        if n <= 1024 or variant == "thomas":
            # sampled rows: 64 up to n = 1024, 2 at 2^16, 1 at 2^22
            rows = 64 if n <= 1024 else 2 if n <= 2 ** 16 else 1
            if n not in thomas:
                thomas[n] = thomas_f64_sequential(*(v[:rows]
                                                    for v in systems[n]))
            err = check_close(x[:rows].cpu(), thomas[n], "float32",
                              f"solve {variant} n={n} vs float64 Thomas",
                              scale=50.0)
            line += (f", max abs err vs float64 Thomas of {rows} "
                     f"row{'s' if rows > 1 else ''} {err:.3e}")
        log(line)

    for n, batch, h, launched in recurred:
        wl = Workload(op="scan", n=n, batch=batch, variant="linrec")
        cfg = session.resolve(wl)
        plan = plan_for(_plan_workload(wl, linrec=True), cfg)
        plans[("linrec", n)] = plan
        if tuple(launched) != plan.launches:
            raise AssertionError(f"linear_recurrence n={n}: launched "
                                 f"{launched} != plan {plan.launches}")
        a, b = recs[n]
        rows = slice(0, 2)
        err = check_close(h[rows].cpu(), linrec_f64_sequential(a[rows],
                                                               b[rows]),
                          "float32", f"linear_recurrence n={n} vs float64 "
                                     f"sequential")
        log(f"[main] linear_recurrence n={n} batch={batch}: {plan.kind}, "
            f"{len(plan.launches)} launch(es), config {cfg}, max abs err vs "
            f"a float64 sequential recurrence of 2 rows {err:.3e}")
    return systems, recs, plans, counts


def cusparse_library():
    """The CUDA toolkit's libcusparse.so beside the nvcc the build uses,
    after the toolkit's own libnvJitLink.so.12 (loaded first, global:
    PyTorch's wheels bring an older one, which this libcusparse cannot
    link against, so this must run before torch is imported).  Raises
    when either does not load."""
    import ctypes
    import glob
    nvcc = None
    for cand in (os.environ.get("CUDACXX"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            nvcc = cand
            break
    if nvcc is None:
        from shutil import which
        nvcc = which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit for cuSPARSE")
    root = os.path.dirname(os.path.dirname(os.path.realpath(nvcc)))
    libdirs = [os.path.join(root, "lib64")] + sorted(
        glob.glob(os.path.join(root, "targets", "*", "lib")))
    for name in ("libnvJitLink.so.12", "libcusparse.so.12"):
        found = [os.path.join(d, name) for d in libdirs
                 if os.path.exists(os.path.join(d, name))]
        if not found:
            raise RuntimeError(f"no {name} under {root}")
        lib = ctypes.CDLL(found[0], mode=ctypes.RTLD_GLOBAL)
    return lib, found[0]


class CusparseGtsv:
    """cuSPARSE's batched tridiagonal solver ``gtsv2StridedBatch`` (the
    paper's yardstick for PCR), bound with ctypes from the CUDA toolkit
    (:func:`cusparse_library`).  Timed here as kernel 7's ``library_ms``;
    the port never calls it."""

    def __init__(self, lib, path):
        import ctypes
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.cusparseCreate.argtypes = [ctypes.POINTER(vp)]
        lib.cusparseSetStream.argtypes = [vp, vp]
        lib.cusparseDestroy.argtypes = [vp]
        lib.cusparseSgtsv2StridedBatch_bufferSizeExt.argtypes = [
            vp, i32, vp, vp, vp, vp, i32, i32, ctypes.POINTER(ctypes.c_size_t)]
        lib.cusparseSgtsv2StridedBatch.argtypes = [vp, i32, vp, vp, vp, vp,
                                                   i32, i32, vp]
        for fn in (lib.cusparseCreate, lib.cusparseSetStream,
                   lib.cusparseDestroy,
                   lib.cusparseSgtsv2StridedBatch_bufferSizeExt,
                   lib.cusparseSgtsv2StridedBatch):
            fn.restype = i32
        self.lib, self.ctypes, self.path = lib, ctypes, path
        self.handle = vp()
        self._check(lib.cusparseCreate(ctypes.byref(self.handle)), "Create")

    def _check(self, status, what):
        if status != 0:
            raise RuntimeError(f"cusparse{what} failed: status {status}")

    def solver(self, a, b, c, d):
        """A call that solves the (batch, n) f32 systems in place in x (a
        copy of d), and x; a[:, 0] and c[:, -1] must be 0, as the
        library asks."""
        import torch
        batch, n = a.shape
        x = d.clone()
        size = self.ctypes.c_size_t()
        stream = torch.cuda.current_stream(a.device).cuda_stream
        self._check(self.lib.cusparseSetStream(self.handle, stream),
                    "SetStream")
        self._check(self.lib.cusparseSgtsv2StridedBatch_bufferSizeExt(
            self.handle, n, a.data_ptr(), b.data_ptr(), c.data_ptr(),
            x.data_ptr(), batch, n, self.ctypes.byref(size)),
            "Sgtsv2StridedBatch_bufferSizeExt")
        buf = torch.empty(max(size.value, 1), dtype=torch.uint8,
                          device=a.device)

        def call():
            self._check(self.lib.cusparseSgtsv2StridedBatch(
                self.handle, n, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                x.data_ptr(), batch, n, buf.data_ptr()),
                "Sgtsv2StridedBatch")
        return call, x

    def close(self):
        self._check(self.lib.cusparseDestroy(self.handle), "Destroy")


def cusparse_probe(lib, path, cases):
    """In a process of its own (``--cusparse``, started by
    :func:`phase_cusparse`, with the toolkit's libraries loaded before
    torch): per (n, pcr config) of ``cases["pcr"]``, diagonally dominant
    systems of 2^26 equations from a seed, gtsv2StridedBatch's solution
    once against pcr's at DTYPE_TOL f32, then its time (repeated solves in
    place: the work of a call does not depend on x); the same against the
    Thomas kernel at each n of ``cases["thomas"]``, its time beside.
    Prints one JSON line."""
    import torch
    sys.path.insert(0, SRC)
    from repro_torch.kernels.tridiag.kernel import pcr, thomas
    from repro_torch.kernels.tridiag.ref import random_system
    dev = torch.device("cuda", 0)
    gtsv = CusparseGtsv(lib, path)
    gen = torch.Generator(device=dev).manual_seed(27)
    out, by_thomas = {}, {}
    try:
        for n in cases["thomas"]:
            a, b, c, d = random_system(gen, TOTAL_ELEMS // n, n)
            call, x = gtsv.solver(a, b, c, d)
            call()
            want = thomas(a, b, c, d)
            torch.cuda.synchronize()
            err = check_close(x, want, "float32",
                              f"cusparse gtsv2StridedBatch n={n} vs thomas")
            reps = 1 if n >= 2 ** 22 else 5
            by_thomas[str(n)] = {
                "ms": time_ms(call, reps, warmup=1),
                "thomas_ms": time_ms(lambda: thomas(a, b, c, d), reps,
                                     warmup=1),
                "max_abs_err_vs_thomas": err, "shape": list(a.shape)}
            del a, b, c, d, x, want
        for n, cfg in cases["pcr"]:
            a, b, c, d = random_system(gen, TOTAL_ELEMS // n, n)
            call, x = gtsv.solver(a, b, c, d)
            call()
            want = pcr(a, b, c, d, **cfg)
            torch.cuda.synchronize()
            err = check_close(x, want, "float32",
                              f"cusparse gtsv2StridedBatch n={n} vs pcr")
            out[str(n)] = {"ms": time_ms(call, 10),
                           "pcr_ms": time_ms(lambda: pcr(a, b, c, d, **cfg),
                                             10),
                           "max_abs_err_vs_pcr": err,
                           "shape": list(a.shape), "pcr_config": cfg}
            del a, b, c, d, x, want
    finally:
        gtsv.close()
    print(json.dumps({"library": os.path.basename(path), "n": out,
                      "thomas": by_thomas}), flush=True)


def phase_cusparse(cfgs):
    """cuSPARSE gtsv2StridedBatch beside pcr at the pcr main-path shapes
    and beside the Thomas kernel at THOMAS_SIZES, in a child process (its
    libraries clash with PyTorch's once torch is loaded); fails when the
    child does.  Returns the pcr sizes' records and the Thomas sizes'."""
    cases = json.dumps({"pcr": [[n, cfgs[n]] for n in sorted(cfgs)],
                        "thomas": list(THOMAS_SIZES)})
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--cusparse", cases], capture_output=True,
                           text=True, timeout=600)
    if child.returncode != 0:
        raise RuntimeError(f"the cuSPARSE phase failed "
                           f"({child.returncode}):\n{child.stdout[-2000:]}"
                           f"\n{child.stderr[-4000:]}")
    result = json.loads(child.stdout.strip().splitlines()[-1])
    log(f"[cusparse] {json.dumps(result, sort_keys=True)}")
    return ({int(n): v for n, v in result["n"].items()},
            {int(n): v for n, v in result["thomas"].items()})


def phase_tridiag_numbers(dev, systems, recs, plans, counts, errs,
                          bandwidth: float):
    """Times, bounds and errors of the four kernels at their main-path
    shapes (kernels 2, 3 and 7 beside their block kernels on the same
    inputs), both pcr routes over the admitted configs at n = 256 and
    1024 and the warp kernel at one warp a system, the warp PCR kernel's
    issue floor, solve end to end per variant, and the profiler's device
    time by kernel."""
    import torch
    from repro_torch.core.space import Workload, tridiag_space
    from repro_torch.hw.profiles import get_profile
    from repro_torch.kernels.blocks.driver import (apply_linrec,
                                                   apply_linrec_plain)
    from repro_torch.kernels.scan.kernel import (scan_linrec,
                                                 scan_linrec_plain,
                                                 scan_linrec_prod,
                                                 scan_linrec_prod_plain)
    from repro_torch.kernels.scan.ops import linear_recurrence
    from repro_torch.kernels.tridiag import kernel as pcr_kernel
    from repro_torch.kernels.tridiag.kernel import (pcr, pcr_plain,
                                                    pcr_steps)
    from repro_torch.kernels.tridiag.ops import solve
    from repro_torch.tuning import default_session

    worst, _ = errs

    def bound(nbytes, flops):
        by_bytes, by_ops = nbytes / bandwidth * 1e3, flops / F32_PEAK * 1e3
        return (by_bytes, "bytes") if by_bytes >= by_ops \
            else (by_ops, "operations")

    def entry(name, source, replaces, fn, plain, nbytes, flops, shape,
              config, library=None, block=None):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        b_ms, b_by = bound(nbytes, flops)
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": counts[name],
               "max_abs_err": max(max_err(g, r) for g, r in zip(got, ref)),
               "ms": time_ms(fn, 10), "plain_ms": time_ms(plain, 3, warmup=1),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None if library is None else time_ms(library,
                                                                  10),
               "shape": list(shape), "dtype": "float32", "config": config,
               "flops": flops, "check_max_abs_err": worst[name]}
        if block is not None:
            # the block kernel (the earlier design) on the same inputs
            blk = block()
            torch.cuda.synchronize()
            out.update(
                launches_by_route={r: counts[f"{name}.{r}"]
                                   for r in LAUNCH_ROUTES[name]},
                unequal_elements=sum(int((g != r).sum())
                                     for g, r in zip(got, ref)),
                block_unequal_elements=sum(int((g != r).sum())
                                           for g, r in zip(blk, ref)),
                block_ms=time_ms(block, 10))
        del got, ref
        log(f"[numbers] {json.dumps(out, sort_keys=True)}")
        return out

    entries = []
    (n_fused, _), (n_multi, _) = linrec_path_cases()
    # kernel 2 at linear_recurrence's fused main-path call
    plan = plans[("linrec", n_fused)]
    a, b = recs[n_fused]
    kw = dict(rows_per_program=plan.rows, tile_n=plan.tile_n,
              stages=plan.stages)
    entries.append(entry(
        "scan_linrec", "src/repro_torch/csrc/linrec.cu",
        "src/repro/kernels/scan/kernel.py:125",
        lambda: (scan_linrec(a, b, **kw),),
        lambda: (scan_linrec_plain(a, b, **kw),),
        3 * a.numel() * 4, 2 * a.numel(), a.shape,
        {"rows": plan.rows, "tile_n": plan.tile_n,
         "stages": list(plan.stages)},
        block=lambda: (linrec_block(a, b, plan.rows, plan.tile_n,
                                    plan.stages),)))
    # kernels 3 and 5 at the multipass main-path call (n = 2^22, batch 16)
    plan = plans[("linrec", n_multi)]
    l1, _, l3 = plan.launches
    a, b = (v.reshape(-1, plan.tile_n) for v in recs[n_multi])
    kw = dict(rows_per_program=l1.block_shape[0], stages=l1.stages)
    entries.append(entry(
        "scan_linrec_prod", "src/repro_torch/csrc/linrec.cu",
        "src/repro/kernels/scan/kernel.py:159",
        lambda: scan_linrec_prod(a, b, **kw),
        lambda: scan_linrec_prod_plain(a, b, **kw),
        4 * a.numel() * 4, 3 * a.numel(), a.shape,
        {"rows": l1.block_shape[0], "stages": list(l1.stages)},
        block=lambda: linrec_block(a, b, l1.block_shape[0], plan.tile_n,
                                   l1.stages, products=True)))
    h, p = scan_linrec_prod(a, b, **kw)
    e = torch.randn(h.shape[0], 1, device=dev)
    rows = l3.block_shape[0]
    entries.append(entry(
        "apply_linrec", "src/repro_torch/csrc/linrec.cu",
        "src/repro/kernels/blocks/driver.py:149",
        lambda: (apply_linrec(h, p, e, rows=rows),),
        lambda: (apply_linrec_plain(h, p, e, rows=rows),),
        3 * h.numel() * 4 + e.numel() * 4, 2 * h.numel(), h.shape,
        {"rows": rows}, library=lambda: torch.addcmul(h, p, e)))
    del a, b, h, p, e
    # kernel 7 at solve(variant="pcr")'s n = 1024 call
    cfgs = {}
    for v, n, batch in tridiag_path_cases():
        if v == "pcr":
            cfgs[n] = default_session().resolve(
                Workload(op="tridiag", n=n, batch=batch, variant="pcr"))
    gtsv, gtsv_thomas = phase_cusparse(cfgs)
    planes = systems[max(cfgs)]
    batch, n = planes[0].shape
    cfg = cfgs[n]
    # per level and equation: 2 divides, 6 multiplies, 4 adds; then x = d/b
    flops = planes[0].numel() * (12 * pcr_steps(n) + 1)
    entries.append(entry(
        "pcr", "src/repro_torch/csrc/tridiag.cu",
        "src/repro/kernels/tridiag/kernel.py:47",
        lambda: (pcr(*planes, **cfg),), lambda: (pcr_plain(*planes, **cfg),),
        5 * planes[0].numel() * 4, flops, planes[0].shape, cfg,
        block=lambda: (pcr_block(planes, cfg["rows_per_program"],
                                 cfg["unroll"]),)))
    # library_ms: cuSPARSE gtsv2StridedBatch at the same shape
    entries[-1].update(library_ms=gtsv[n]["ms"],
                       library="cusparseSgtsv2StridedBatch",
                       library_ms_by_n={str(k): v["ms"]
                                        for k, v in gtsv.items()})
    log(f"[numbers] pcr library_ms (cuSPARSE) {entries[-1]['library_ms']}")
    for m in sorted(cfgs):
        pcr_issue_floor(TOTAL_ELEMS, m, cfgs[m]["unroll"])
    entries.append(thomas_entry(systems, counts, bandwidth, gtsv_thomas))
    # both pcr routes over the admitted configs at each main-path shape,
    # and the warp kernel at one warp a system (unroll n / 32)
    for m in sorted(cfgs):
        system = tuple(v.contiguous() for v in systems[m])
        space = tridiag_space(Workload(op="tridiag", n=m,
                                       batch=system[0].shape[0],
                                       variant="pcr"), get_profile("h100"))
        runs = [(c["rows_per_program"], c["unroll"], route)
                for c in space.enumerate_valid()
                for route in ("warp", "block")]
        runs.append((cfgs[m]["rows_per_program"], m // 32, "warp"))
        sweep = {f"{route} rows {r} unroll {u}": time_ms(
                     lambda: pcr_kernel._launch(system, r, u, route=route), 5)
                 for r, u, route in runs}
        log(f"[numbers] pcr ms at {list(system[0].shape)}: "
            f"{json.dumps(sweep)}")

    ends = []
    for variant, n, batch in tridiag_path_cases():
        system = systems[n]
        ms = time_ms(lambda: solve(*system, variant=variant), 3, warmup=1)
        ends.append({"variant": variant, "n": n, "batch": batch,
                     "solve_ms": ms})
        log(f"[numbers] solve {variant} n={n} batch={batch}: {ms:.4f} ms a "
            f"call ({n * batch} equations)")
    for n, batch in linrec_path_cases():
        a, b = recs[n]
        ms = time_ms(lambda: linear_recurrence(a, b), 10)
        log(f"[numbers] linear_recurrence n={n} batch={batch}: {ms:.4f} ms "
            f"a call")
    tridiag_trace(systems, recs, plans, cfgs)
    return entries, ends


def thomas_traffic_planes(route: str, n: int, itemsize: int,
                          resident: bool) -> float:
    """Planes of (batch, n) a route moves: a, b, c, d in and x out, and c'
    and d' out and back through scratch, except the wide route's last tile
    of them (kept on chip) and all of them where it keeps them resident."""
    if route != "wide":
        return 9.0
    if resident:
        return 5.0
    from repro_torch.kernels.tridiag.kernel import thomas_tile_row_bytes
    cols = min(n, thomas_tile_row_bytes(False) // itemsize)
    return 5.0 + 4.0 * (n - cols) / n


def thomas_chain_probe(steps: int = 1 << 20, ieee: bool = False) -> float:
    """Milliseconds of one lane (``repro_thomas_chain_probe``) running
    ``steps`` forward and ``steps`` backward f32 Thomas steps with the
    routes' op sequence, all in registers (``ieee``: __fdiv_rn for every
    divide):
    ms / (2 steps) is a floor of one step of this op sequence, not of the
    function.  Fails unless c', d' and x are finite and every fast divide
    was exact."""
    import torch
    from repro_torch.kernels.build import check, load_library

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(29)
    a = torch.rand(8, generator=gen) * 0.9 + 0.1
    c = torch.rand(8, generator=gen) * 0.9 + 0.1
    b = a + c + torch.rand(8, generator=gen) + 1.0
    d = torch.randn(8, generator=gen)
    inp = torch.cat([a, b, c, d]).to(dev)
    out = torch.empty(4, device=dev)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(2):                       # the first call warms up
        start.record()
        code = lib.repro_thomas_chain_probe(inp.data_ptr(), out.data_ptr(),
                                            int(ieee), steps, stream)
        end.record()
        check(code, "thomas chain probe")
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()) or float(out[3]) != 1.0:
        raise AssertionError(f"thomas chain probe: c', d', x, exact = "
                             f"{out.tolist()}")
    return start.elapsed_time(end)


def thomas_entry(systems, counts, bandwidth: float, gtsv):
    """The Thomas kernel at each of THOMAS_SIZES on solve's main-path
    systems, on the route thomas_route picks: its result bit-equal, as
    integers, to the lane kernel's (the earlier kernel: thomas_ref takes
    minutes there); its time beside the lane kernel's (``lane_ms``) and
    every other route's that takes the shape (``ms_by_route``), all on the
    same planes; its bound, cuSPARSE's time on the same kind of systems
    (``gtsv``, from the child).  The entry's own numbers at n = 1024, where
    thomas_ref (its plain version) is timed too and every element must be
    bit-equal to it.  Bound: the larger of the bytes the function needs
    (a, b, c, d in, x out: five planes, as pcr's) over the memory rate,
    and the chain of 2n dependent steps a system at one step a clock of
    the card's maximum SM clock (nvidia-smi).  Beside it:
    ``chain_floor_ms``, 2n steps at the time a step of this op sequence
    takes one lane in registers (:func:`thomas_chain_probe`: a floor of
    this op sequence, not of the function), and ``traffic_ms``, the planes
    the chosen route moves (c' and d' out and back, where it does)."""
    import torch
    from repro_torch.kernels.tridiag import kernel as tk
    from repro_torch.kernels.tridiag.ref import thomas_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    mhz = float(smi.stdout.split()[0])
    dev = systems[THOMAS_SIZES[0]][0].device
    sms = tk.sm_count(dev)
    probe_steps = 1 << 20
    probe = {"routes' divide": thomas_chain_probe(probe_steps),
             "__fdiv_rn": thomas_chain_probe(probe_steps, ieee=True)}
    step_ns = probe["routes' divide"] * 1e6 / (2 * probe_steps)
    log(f"[numbers] thomas chain probe: ms for {probe_steps} forward and "
        f"{probe_steps} backward f32 steps of one lane, by divide: "
        f"{json.dumps(probe)}; {step_ns:.4f} ns a step with the routes' "
        f"divide ({step_ns * mhz * 1e-3:.2f} clocks at {mhz:.0f} MHz)")
    by_n = {}
    for n in THOMAS_SIZES:
        planes = tuple(v.contiguous() for v in systems[n])
        batch = planes[0].shape[0]
        elems = planes[0].numel()
        route = tk.thomas_route(batch, n, sms)
        resident = tk.thomas_resident(n, 4) if route == "wide" else None
        got = tk._launch_thomas(planes, route=route)
        lane = tk._launch_thomas(planes, route="lane")
        torch.cuda.synchronize()
        unequal = int((got.view(torch.int32) != lane.view(torch.int32)).sum())
        if unequal:
            raise AssertionError(f"thomas n={n}: route {route} differs from "
                                 f"the lane kernel in {unequal} elements")
        del got, lane
        reps = 1 if n >= 2 ** 22 else 5
        runs = {"long": None, "lane": None}
        if n % tk.THOMAS_WIDE_ALIGN == 0 and n < 2 ** 22:
            runs["wide scratch"] = False
            if tk.thomas_wide_smem(n, 4, True) <= tk.SMEM_MAX:
                runs["wide resident"] = True
        ms_by_route = {
            name: time_ms(lambda: tk._launch_thomas(
                planes, route=name.split()[0], resident=res), reps, warmup=1)
            for name, res in runs.items()}
        chosen = route if route != "wide" else \
            f"wide {'resident' if resident else 'scratch'}"
        by_bytes = 5 * elems * 4 / bandwidth * 1e3
        by_chain = 2 * n / (mhz * 1e6) * 1e3
        by_n[n] = {"shape": list(planes[0].shape), "route": route,
                   "resident": resident,
                   "long_rows": tk.thomas_long_rows(batch, sms),
                   "ms": ms_by_route[chosen], "lane_ms": ms_by_route["lane"],
                   "ms_by_route": ms_by_route,
                   "unequal_vs_lane": unequal,
                   "bound_ms": max(by_bytes, by_chain),
                   "bound_by": "bytes" if by_bytes >= by_chain
                   else "operations",
                   "bytes_ms": by_bytes, "chain_ms": by_chain,
                   "chain_floor_ms": 2 * n * step_ns * 1e-6,
                   "traffic_ms": thomas_traffic_planes(
                       route, n, 4, bool(resident)) * elems * 4
                   / bandwidth * 1e3,
                   "library_ms": gtsv[n]["ms"],
                   "library_thomas_ms_same_process": gtsv[n]["thomas_ms"]}
        log(f"[numbers] thomas n={n} batch={batch}: "
            f"{json.dumps(by_n[n], sort_keys=True)}")
    n = 1024
    planes = tuple(v.contiguous() for v in systems[n])
    route = by_n[n]["route"]
    got = tk._launch_thomas(planes, route=route)
    ref = thomas_ref(*planes)
    torch.cuda.synchronize()
    unequal = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
    if unequal:
        raise AssertionError(f"thomas at {list(got.shape)}: {unequal} "
                             f"elements not bit-equal to thomas_ref")
    out = {"name": "thomas", "route": "cuda",
           "source": "src/repro_torch/csrc/tridiag.cu",
           "replaces": "src/repro/kernels/tridiag/ref.py:12 (thomas_ref: "
                       "an XLA lax.scan, not a Pallas kernel)",
           "launches": counts["thomas"],
           "launches_by_route": {r: counts[f"thomas.{r}"]
                                 for r in tk.THOMAS_ROUTES},
           "max_abs_err": max_err(got, ref),
           "unequal_elements": unequal, "kernel_route": route,
           "ms": by_n[n]["ms"], "lane_ms": by_n[n]["lane_ms"],
           "plain_ms": time_ms(lambda: thomas_ref(*planes), 1, warmup=1),
           "bound_ms": by_n[n]["bound_ms"], "bound_by": by_n[n]["bound_by"],
           "chain_floor_ms": by_n[n]["chain_floor_ms"],
           "traffic_ms": by_n[n]["traffic_ms"],
           "library_ms": by_n[n]["library_ms"],
           "library": "cusparseSgtsv2StridedBatch",
           "shape": by_n[n]["shape"], "dtype": "float32",
           "sm_clock_mhz": mhz, "chain_probe_ms": probe,
           "chain_step_ns": step_ns,
           "by_n": {str(k): v for k, v in by_n.items()}}
    del got, ref
    log(f"[numbers] {json.dumps(out, sort_keys=True)}")
    return out


def tridiag_trace(systems, recs, plans, pcr_cfgs):
    """torch.profiler's device time, by kernel, of one solve(variant="pcr")
    at n = 256 and 1024 and one linear_recurrence at each linrec main-path
    shape (the entry points, on the routes their plans pick), and of the
    block kernels on the same plans (the earlier designs' records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.scan.ops import linear_recurrence
    from repro_torch.kernels.tridiag.ops import solve

    calls = []
    for n in sorted(pcr_cfgs):
        calls += [lambda n=n: solve(*systems[n], variant="pcr"),
                  lambda n=n: pcr_block(systems[n],
                                        pcr_cfgs[n]["rows_per_program"],
                                        pcr_cfgs[n]["unroll"])]
    for n, _ in linrec_path_cases():
        plan = plans[("linrec", n)]
        calls.append(lambda n=n: linear_recurrence(*recs[n]))
        if plan.kind == "fused":
            calls.append(lambda n=n, p=plan: linrec_block(
                *recs[n], p.rows, p.tile_n, p.stages))
        else:
            l1 = plan.launches[0]
            calls.append(lambda n=n, p=plan, l1=l1: linrec_block(
                *(v.reshape(-1, p.tile_n) for v in recs[n]),
                l1.block_shape[0], p.tile_n, l1.stages, products=True))
    for fn in calls:                   # warm up outside the trace
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the trace can lose the first kernels of its window: open it
        # with a spin of about a millisecond
        torch.cuda._sleep(2_000_000)
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    device = {}
    for evt in prof.key_averages():
        t = getattr(evt, "device_time_total", None)
        if t is None:
            t = getattr(evt, "cuda_time_total", 0.0)
        if t and ("pcr" in evt.key or "linrec" in evt.key):
            device[evt.key[:80]] = {"device_ms": t / 1e3, "calls": evt.count}
    log(f"[trace] pcr at n = {sorted(pcr_cfgs)} and linrec at n = "
        f"{[n for n, _ in linrec_path_cases()]}, each on its route and on "
        f"the block kernel: {json.dumps(device, sort_keys=True)}")


def fft_stage_cases():
    """(batch, n, rows, radix, unroll): the ragged and prime stage
    sequences ((8, 6, 2) at 96, (2, 53) at 106, (8, 5, 5, 5) at 1000, the
    16-point columns of a four-step call), the largest resident rows and
    a block that holds more rows than shared memory (the kernel loops over
    row groups)."""
    return [(6, 96, 3, 8, 1), (7, 96, 7, 8, 2), (5, 106, 5, 2, 1),
            (5, 106, 1, 16, 4), (4, 1000, 2, 8, 1), (7, 1000, 7, 16, 2),
            (4096, 16, 64, 16, 1), (512, 2048, 4, 4, 4),
            (4, 8192, 1, 16, 1), (8, 8192, 1, 2, 2), (3, 1, 3, 2, 1),
            (64, 4096, 32, 8, 1)]


def phase_fft_kernels(dev, quick: bool):
    """fft_stockham against fft_plain on the card: every admitted config of
    the paper workloads' fft_space under h100 (n = 1024 and 8192), and the
    ragged / prime stage sequences, inverse on and off."""
    import torch
    from repro_torch.core.space import Workload, fft_space
    from repro_torch.hw.profiles import get_profile
    from repro_torch.kernels.blocks.plan import stage_radices
    from repro_torch.kernels.fft.kernel import (fft_plain, fft_route,
                                                fft_stockham)

    gen = torch.Generator(device=dev).manual_seed(6)
    worst = 0.0
    cases = 0
    unequal = {"pow2": 0, "generic": 0}

    def count(got, ref, n, stages):
        unequal[fft_route(n, stages)] += int((got != ref).sum())
    for batch, n, rows, radix, unroll in fft_stage_cases():
        x = torch.randn(batch, n, generator=gen, device=dev,
                        dtype=torch.complex64)
        for inverse in (False, True):
            kw = dict(rows_per_program=rows, stages=stage_radices(n, radix),
                      inverse=inverse)
            got = fft_stockham(x, unroll=unroll, **kw)
            ref = fft_plain(x, **kw)
            torch.cuda.synchronize()
            worst = max(worst, check_complex(
                got, ref, f"fft_stockham ({batch},{n}) rows={rows} "
                          f"stages={kw['stages']} unroll={unroll} "
                          f"inverse={inverse}"))
            count(got, ref, n, kw["stages"])
            cases += 1
    log(f"[kernels] fft_stockham: {cases} shape/stage/direction cases within "
        f"tolerance (max relative err {worst:.3e})")

    h100 = get_profile("h100")
    for n in (1024, 8192):
        wl = Workload(op="fft", n=n, batch=TOTAL_ELEMS // n,
                      variant="stockham")
        cfgs = fft_space(wl, h100).enumerate_valid()
        if quick:
            cfgs = cfgs[::8]
        for inverse in (False, True):
            x = torch.randn(wl.batch, n, generator=gen, device=dev,
                            dtype=torch.complex64)
            plain = {}
            for cfg in cfgs:
                stages = stage_radices(n, cfg["radix"])
                if stages not in plain:
                    plain[stages] = fft_plain(x, rows_per_program=1,
                                              stages=stages, inverse=inverse)
                got = fft_stockham(x, rows_per_program=cfg["rows_per_program"],
                                   stages=stages, inverse=inverse,
                                   unroll=cfg["unroll"])
                worst = max(worst, check_complex(
                    got, plain[stages], f"fft_space({wl.key}) config {cfg} "
                                        f"inverse={inverse}"))
                count(got, plain[stages], n, stages)
                del got
            torch.cuda.synchronize()
            del x, plain
        log(f"[kernels] fft_space({wl.key}, h100): all {len(cfgs)} admitted "
            f"configs launch and match the plain version, forward and "
            f"inverse")
    log(f"[kernels] fft_stockham: max relative err against fft_plain "
        f"{worst:.3e}; elements not bit-equal to fft_plain, by route "
        f"{unequal}")
    if any(unequal.values()):
        raise AssertionError(f"fft_stockham is not bit-equal to fft_plain: "
                             f"{unequal} elements differ")
    return worst


def fft_path_cases():
    """(n, batch): 2^26 complex64 elements a call; fused up to 8192 (the
    h100 resident cap), four-step above."""
    return [(n, TOTAL_ELEMS // n)
            for n in (256, 1024, 4096, 8192, 2 ** 16, 2 ** 20, 2 ** 23)]


def phase_fft_path(dev):
    """fft / ifft at the paper's size, through the default session."""
    import torch
    from repro_torch.core.multikernel import max_resident_tile
    from repro_torch.core.space import Workload
    from repro_torch.kernels.blocks.driver import capture_launches
    from repro_torch.kernels.fft.ops import fft, fft_plan, ifft
    from repro_torch.tuning import default_session

    cap = max_resident_tile(Workload(op="fft", n=TOTAL_ELEMS, batch=1))

    def resolved(n, batch, cfg=None):
        """The config fft resolves (its op: fft up to the cap, large_fft
        above)."""
        op = "fft" if n <= cap else "large_fft"
        return default_session().resolve(
            Workload(op=op, n=n, batch=batch, variant="stockham"), config=cfg)

    gen = torch.Generator(device=dev).manual_seed(5)
    inputs = {n: torch.randn(batch, n, generator=gen, device=dev,
                             dtype=torch.complex64)
              for n, batch in dict([*fft_path_cases(), FFT_DEEP]).items()}

    # both depths at 2^23, whatever the session resolves there: tile_n =
    # 256 (n2 = 32768 > the cap: the column side recurses, m = 3) and
    # tile_n = 4096 (n2 = 2048: m = 2)
    calls = [(f"fft n={n}", n, batch, None) for n, batch in fft_path_cases()]
    deep, deep_batch = FFT_DEEP
    for m, tile in ((3, 256), (2, 4096)):
        calls.append((f"fft n={deep} m={m}", deep, deep_batch,
                      dict(resolved(deep, deep_batch), tile_n=tile)))
    torch.cuda.synchronize()
    reset_launch_counts()
    outputs = []
    for name, n, batch, cfg in calls:
        with capture_launches() as launched:
            y = fft(inputs[n], config=cfg)
        outputs.append((name, n, batch, cfg, y, list(launched)))
    trips = []
    for n in FFT_TRIPS:
        with capture_launches() as launched:
            back = ifft(fft(inputs[n]))
        trips.append((n, back, list(launched)))
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[main] launches on the FFT path: {counts}")
    require_launched(counts, ("fft_stockham", "fft_stockham.pow2",
                              "fft_pass"), "the FFT path")
    require_new_routes(counts, "the FFT path")

    runs = []
    for name, n, batch, cfg, y, launched in outputs:
        plan = fft_plan(batch, n, cfg)
        cfg = resolved(n, batch, cfg)
        if tuple(launched) != plan.launches:
            raise AssertionError(f"{name}: launched {launched} != plan "
                                 f"{plan.launches}")
        if n <= cap:
            want = 1
        elif " m=" in name:
            want = int(name[-1])
        else:       # m = 3 where the column side exceeds the cap
            want = 3 if plan.children[0].kind == "multipass" else 2
        if len(plan.launches) != want:
            raise AssertionError(f"{name}: {len(plan.launches)} launches, "
                                 f"expected {want}")
        if y.shape != (batch, n) or y.dtype != torch.complex64:
            raise AssertionError(f"{name}: output {tuple(y.shape)} {y.dtype}")
        ref = torch.fft.fft(inputs[n].to(torch.complex128))
        err = check_complex(y, ref, f"{name} vs complex128 torch.fft.fft")
        del ref
        children = [c.n for c in plan.children]
        log(f"[main] {name} batch={batch}: {plan.kind}, "
            f"{len(plan.launches)} launch(es), config {cfg}"
            f"{f', n2 x n1 = {children}' if children else ''}, "
            f"stages {[l.stages for l in plan.launches]}, max relative err "
            f"vs complex128 {err:.3e}")
        runs.append({"call": name, "n": n, "batch": batch, "config": cfg,
                     "plan": plan, "err": err})
    del outputs
    for n, back, launched in trips:
        batch = inputs[n].shape[0]
        plan = fft_plan(batch, n)
        if tuple(launched) != plan.launches * 2:
            raise AssertionError(f"ifft(fft(x)) n={n}: launched {launched} "
                                 f"!= twice the plan {plan.launches}")
        err = check_complex(back, inputs[n], f"ifft(fft(x)) n={n}")
        log(f"[main] ifft(fft(x)) n={n} batch={batch}: "
            f"{len(launched)} launches, max relative err vs x {err:.3e}")
    del trips
    return inputs, runs, counts


def phase_fft_numbers(dev, inputs, runs, counts, err, bandwidth: float):
    """fft per call against torch.fft.fft (cuFFT); each four-step pass,
    forward and inverse, against its plain twin on the same input, and
    where the four-step time goes (each pass: the column passes, the last
    with the twiddle, then the row pass with the transposed store); kernel
    6's entry at the n = 1024 main-path call and the pass kernel's at the
    2^20 call."""
    import torch
    from repro_torch.kernels.blocks.driver import four_step_passes
    from repro_torch.kernels.blocks.plan import stage_radices
    from repro_torch.kernels.fft.kernel import (fft_generic, fft_pass,
                                                fft_pass_plain, fft_plain,
                                                fft_stockham, pass_problems)
    from repro_torch.kernels.fft.ops import fft

    rows, pass_errs = [], []
    for run in runs:
        x, plan, cfg = inputs[run["n"]], run["plan"], run["config"]
        forced = cfg if " m=" in run["call"] else None
        row = {"call": run["call"], "n": run["n"], "batch": run["batch"],
               "kind": plan.kind, "launches": len(plan.launches),
               "config": cfg, "err_vs_complex128": run["err"],
               "fft_ms": time_ms(lambda: fft(x, config=forced), 5),
               "torch_fft_ms": time_ms(lambda: torch.fft.fft(x), 5)}
        if plan.kind == "multipass":
            row.update(pass_ms=[], pass_tiles=[], pass_err_vs_plain=[])
            for inverse in (False, True):
                z = x
                for i, (sub, layout) in enumerate(four_step_passes(plan)):
                    kw = dict(stages=sub.stages, inverse=inverse,
                              unroll=int(sub.ilp))
                    got = fft_pass(z, layout, **kw)
                    e = check_complex(
                        got, fft_pass_plain(z, layout, **kw),
                        f"{run['call']} {'inverse ' if inverse else ''}"
                        f"pass {i} vs fft_pass_plain")
                    row["pass_err_vs_plain"].append(e)
                    pass_errs.append(e)
                    if not inverse:
                        row["pass_ms"].append(time_ms(
                            lambda: fft_pass(z, layout, **kw), 5))
                        row["pass_tiles"].append(
                            pass_problems(layout, sub.stages))
                    z = got
                del z, got
        rows.append(row)
        log(f"[numbers] {json.dumps(row, sort_keys=True, default=str)}")

    # the pass kernel's entry at the 2^20 main-path call (2^26 points a
    # pass, as at every four-step call of the path)
    run = next(r for r in runs if r["call"] == f"fft n={2 ** 20}")
    row = next(r for r in rows if r["call"] == run["call"])
    x, plan = inputs[run["n"]], run["plan"]
    sub, layout = four_step_passes(plan)[0]
    kw = dict(stages=sub.stages, unroll=int(sub.ilp))
    nbytes = 2 * x.numel() * x.element_size()
    pass_entry = {
        "name": "fft_pass", "route": "cuda",
        "source": "src/repro_torch/csrc/fft.cu",
        # the four-step's column and row launches of fft_pallas
        "replaces": "src/repro/kernels/fft/kernel.py:53",
        "launches": counts["fft_pass"],
        "max_rel_err_vs_plain": max(pass_errs),
        "ms": sum(row["pass_ms"]) / len(row["pass_ms"]),
        "ms_by_pass": row["pass_ms"],
        "ms_by_call": {r["call"]: r["pass_ms"] for r in rows
                       if "pass_ms" in r},
        "plain_ms": time_ms(lambda: fft_pass_plain(x, layout, **kw), 3,
                            warmup=1),
        "bound_ms": nbytes / bandwidth * 1e3, "bound_by": "bytes",
        # one whole transform, which the plan does in len(ms_by_pass)
        # passes
        "library_ms": row["torch_fft_ms"],
        "shape": list(x.shape), "dtype": "complex64",
        "config": {"passes": plan.passes, "tiles": row["pass_tiles"],
                   "stages": [list(l.stages) for l in plan.launches]},
        "check_max_rel_err": run["err"]}
    log(f"[numbers] {json.dumps(pass_entry, sort_keys=True)}")

    run = next(r for r in runs if r["n"] == 1024)
    x, plan = inputs[1024], run["plan"]
    kw = dict(rows_per_program=plan.rows, stages=plan.stages)
    got = fft_stockham(x, unroll=int(plan.ilp), **kw)
    ref = fft_plain(x, **kw)
    torch.cuda.synchronize()
    batch, n = x.shape
    nbytes = 2 * x.numel() * x.element_size()
    flops = 5.0 * n * math.log2(n) * batch
    by_bytes, by_ops = nbytes / bandwidth * 1e3, flops / F32_PEAK * 1e3
    entry = {"name": "fft_stockham", "route": "cuda",
             "source": "src/repro_torch/csrc/fft.cu",
             "replaces": "src/repro/kernels/fft/kernel.py:53",
             # the four-step's passes count as fft_pass's launches
             "launches": counts["fft_stockham"],
             "launches_by_route": {r: counts[f"fft_stockham.{r}"]
                                   for r in LAUNCH_ROUTES["fft_stockham"]},
             "max_abs_err": float((got - ref).abs().max()),
             "unequal_elements": int((got != ref).sum()),
             "ms": time_ms(lambda: fft_stockham(x, unroll=int(plan.ilp), **kw),
                           10),
             # the generic kernel (the earlier design) on the same inputs
             "generic_ms": time_ms(lambda: fft_generic(
                 x, unroll=int(plan.ilp), **kw), 10),
             "plain_ms": time_ms(lambda: fft_plain(x, **kw), 3, warmup=1),
             "bound_ms": max(by_bytes, by_ops),
             "bound_by": "bytes" if by_bytes >= by_ops else "operations",
             "library_ms": time_ms(lambda: torch.fft.fft(x), 10),
             "shape": [batch, n], "dtype": "complex64",
             "config": {"rows": plan.rows, "stages": list(plan.stages),
                        "unroll": int(plan.ilp)},
             "flops": flops, "check_max_rel_err": err}
    del got, ref
    log(f"[numbers] {json.dumps(entry, sort_keys=True)}")
    # the kernel over the space's radix x rows at this shape (unroll 1)
    sweep = {}
    for radix in (2, 4, 8, 16):
        for r in (1, 2, 4, 8):
            for name, fn in (("pow2", fft_stockham), ("generic", fft_generic)):
                sweep[f"{name} radix {radix} rows {r}"] = time_ms(
                    lambda: fn(x, rows_per_program=r,
                               stages=stage_radices(n, radix)), 5)
    log(f"[numbers] fft_stockham ms at ({batch}, {n}): "
        f"{json.dumps(sweep)}")
    return [entry, pass_entry], rows


# ---------------------------------------------------------------------------
# The SSD chain, the Mamba-2 block and the RG-LRU op
# ---------------------------------------------------------------------------

# mamba2-130m's prefill on the card: 8 sequences of 2048 tokens, 24 heads
SSD_BATCH, SSD_LEN = 8, 2048
SSD_HEADS_SAMPLED = (0, 11, 23)   # heads held against float64 ssd_ref
# recurrentgemma-9b's lru_width (src/repro/configs/recurrentgemma_9b.py)
RGLRU_WIDTH = 4096
SSD_LOOP_SIZES = (1024,)          # compare_methods on ssd
RGLRU_LONG = (1, 2 ** 22, 16)     # the multipass call, as linrec's


def ssd_kernel_cases():
    """(BH, G, L, P, S, chunk, dtype, strong): chunk 64 ... 2048, nc = 1,
    3 and 16, (S, P) = (8, 16), (16, 8) and (128, 64), shared b / c (G <
    BH), a strong decay (a x 0.01), a chunk that is no multiple of the
    tiled kernels' 16-row warps and 128-row panels (Q = 100: both
    routes), ragged tiles (P = 70, S = 130, Q = 100: the block route
    alone), f32 and bf16."""
    return [(4, 2, 1024, 16, 8, 64, "float32", False),
            (6, 3, 384, 8, 16, 128, "bfloat16", False),
            (4, 2, 256, 64, 128, 256, "float32", False),
            (2, 1, 2048, 64, 128, 2048, "float32", False),
            (4, 2, 2048, 64, 128, 128, "float32", True),
            (4, 2, 768, 64, 128, 256, "bfloat16", True),
            (2, 1, 3072, 64, 128, 1024, "float32", False),
            (2, 1, 6144, 64, 128, 2048, "bfloat16", False),
            (2, 1, 300, 8, 16, 100, "float32", True),
            (2, 1, 300, 70, 130, 100, "float32", False)]


def ssd_inputs(gen, dev, BH, G, L, P, S, dtype, strong):
    """x normal, a in [0.85, 0.999) (x 0.01 for a strong decay), b and c
    normal x 0.3, as the tests draw them, in ``dtype``."""
    import torch
    x = torch.randn(BH, L, P, generator=gen, device=dev)
    a = torch.rand(BH, L, generator=gen, device=dev) * 0.149 + 0.85
    if strong:
        a = a * 0.01
    b = torch.randn(G, L, S, generator=gen, device=dev) * 0.3
    c = torch.randn(G, L, S, generator=gen, device=dev) * 0.3
    return tuple(v.to(dtype) for v in (x, a, b, c))


def phase_ssd_kernels(dev, quick: bool):
    """ssd_intra, ssd_state_apply and ssd_apply_entry against their plain
    versions on the card, each on both routes (the tiled kernel wherever
    its route function takes the shape, and the block kernel forced), at
    the tests' SSD tolerance (DTYPE_TOL x 10).  The plain
    versions keep the kernels' order (and emulate their fused
    multiply-adds exactly): the run fails unless every element of every
    output is bit-equal to the plain version's."""
    import torch
    from repro_torch.kernels.ssd.kernel import (ssd_apply_entry,
                                                ssd_apply_entry_plain,
                                                ssd_apply_entry_route,
                                                ssd_intra, ssd_intra_plain,
                                                ssd_intra_route,
                                                ssd_state_apply,
                                                ssd_state_apply_plain,
                                                ssd_state_apply_route)

    gen = torch.Generator(device=dev).manual_seed(9)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst = {"ssd_intra": 0.0, "ssd_state_apply": 0.0, "ssd_apply_entry": 0.0}
    unequal = {"ssd_intra.tiled": 0, "ssd_intra.block": 0,
               "ssd_state_apply.tiled": 0, "ssd_state_apply.block": 0,
               "ssd_apply_entry.tiled": 0, "ssd_apply_entry.block": 0}
    launched = dict.fromkeys(unequal, 0)
    cases = ssd_kernel_cases()[:3] if quick else ssd_kernel_cases()
    for BH, G, L, P, S, chunk, dtype, strong in cases:
        x, a, b, c = ssd_inputs(gen, dev, BH, G, L, P, S, dtypes[dtype],
                                strong)
        what = (f"BH={BH} G={G} L={L} P={P} S={S} chunk={chunk} {dtype}"
                f"{' strong' if strong else ''}")
        want = ssd_intra_plain(x, a, b, c, chunk=chunk)
        routes = {"block", ssd_intra_route(P, S, chunk)}
        for route in sorted(routes):
            got = ssd_intra(x, a, b, c, chunk=chunk, route=route)
            torch.cuda.synchronize()
            for name, g, w in zip(("y", "a_chunk", "state"), got, want):
                worst["ssd_intra"] = max(worst["ssd_intra"], check_close(
                    g, w, dtype if name == "y" else "float32",
                    f"ssd_intra ({route}) {name} {what}", scale=10.0))
                unequal[f"ssd_intra.{route}"] += int((g != w).sum())
            launched[f"ssd_intra.{route}"] += 1
        y, ac, st = want
        if L // chunk > 1:
            args = (y, a, c, ac, st)
            w = ssd_state_apply_plain(*args, chunk=chunk)
            for route in sorted({"block", ssd_state_apply_route(P, S,
                                                                chunk)}):
                g = ssd_state_apply(*args, chunk=chunk, route=route)
                torch.cuda.synchronize()
                worst["ssd_state_apply"] = max(
                    worst["ssd_state_apply"], check_close(
                        g, w, dtype, f"ssd_state_apply ({route}) {what}",
                        scale=10.0))
                unequal[f"ssd_state_apply.{route}"] += int((g != w).sum())
                launched[f"ssd_state_apply.{route}"] += 1
            w = ssd_apply_entry_plain(y, a, c, st, chunk=chunk)
            for r in sorted({"block", ssd_apply_entry_route(P, S, chunk)}):
                g = ssd_apply_entry(y, a, c, st, chunk=chunk, route=r)
                torch.cuda.synchronize()
                worst["ssd_apply_entry"] = max(
                    worst["ssd_apply_entry"], check_close(
                        g, w, dtype, f"ssd_apply_entry ({r}) {what}",
                        scale=10.0))
                unequal[f"ssd_apply_entry.{r}"] += int((g != w).sum())
                launched[f"ssd_apply_entry.{r}"] += 1
        log(f"[kernels] ssd {what}: within tolerance on routes "
            f"{sorted(routes)}")
    log(f"[kernels] ssd kernels: {len(cases)} cases within tolerance; max "
        f"abs err {json.dumps(worst)}; launches by kernel and route "
        f"{json.dumps(launched)}; elements not bit-equal to the plain "
        f"version {json.dumps(unequal)}")
    if any(unequal.values()):
        raise AssertionError(f"ssd kernels: elements not bit-equal to the "
                             f"plain versions {unequal}")
    if not (launched["ssd_intra.tiled"] and launched["ssd_state_apply.tiled"]
            and launched["ssd_apply_entry.tiled"]):
        raise AssertionError(f"ssd kernels: a tiled kernel was not checked "
                             f"{launched}")
    return worst


def phase_ssd_path(dev):
    """The Mamba-2 block at mamba2-130m's width (8 x 2048 tokens, the
    session's config under h100), one decode step, then the ssd op at the
    block's shapes with explicit chunks 128 / 256 and fuse 0 / 1 and an
    odd chunk count; each SSD output held against a float64 sequential
    scan of sampled heads, each launch list against its chain plan."""
    import torch
    from repro_torch.configs.mamba2_130m import CONFIG
    from repro_torch.core.space import Workload
    from repro_torch.kernels.blocks.driver import capture_launches
    from repro_torch.kernels.blocks.plan import plan_for_chain
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.kernels.ssd.ref import ssd_ref
    from repro_torch.models.ssm import SSDBlock, init_ssd_cache
    from repro_torch.tuning import default_session

    cfg = CONFIG
    gen = torch.Generator(device=dev).manual_seed(10)
    block = SSDBlock.init(cfg, gen, device=dev)
    x = torch.randn(SSD_BATCH, SSD_LEN, cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    S, P = cfg.ssm_state, cfg.ssm_head_dim
    wl = Workload(op="ssd", n=SSD_LEN, batch=SSD_BATCH * H,
                  variant="chunked")
    resolved = default_session().resolve(wl)
    heads = list(SSD_HEADS_SAMPLED)

    def chain_of(c, L=SSD_LEN):
        w = Workload(op="ssd", n=L, batch=SSD_BATCH * H, variant="chunked")
        return plan_for_chain(w, {"tile_n": c["chunk"], "radix": c["radix"],
                                  "fuse": c["fuse"]}, dims=(S, P))

    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_launch_counts()
        with capture_launches() as launched:
            out, _ = block(x)
            cache = init_ssd_cache(cfg, SSD_BATCH, device=dev)
            step, new = block(x[:, :1], cache=cache)
        torch.cuda.synchronize()
        block_counts = launch_counts()
        log(f"[ssd] launches on the Mamba-2 block's path: {block_counts}")
        require_launched(block_counts, ("ssd_intra",), "the Mamba-2 block")
        require_new_routes(block_counts, "the Mamba-2 block")
        want = chain_of(resolved).launches
        if tuple(launched) != want:
            raise AssertionError(f"SSDBlock: launched {list(launched)} != "
                                 f"chain {want}")
        for name, t, shape in (("prefill", out, x.shape),
                               ("decode", step, (SSD_BATCH, 1, cfg.d_model)),
                               ("decode state", new["state"],
                                (SSD_BATCH, H, S, P))):
            if tuple(t.shape) != tuple(shape) \
                    or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"SSDBlock {name}: {tuple(t.shape)} "
                                     f"finite={bool(torch.isfinite(t).all())}")
        # the SSD core at the block's own inputs (the same bf16 projections)
        xh, a, b, c, _, _ = block.ssd_inputs(x)
        args = (xh.float(), a, b.float(), c.float())
        ref = ssd_ref(args[0][:, :, heads].double(),
                      args[1][:, :, heads].double(), args[2].double(),
                      args[3].double())
        y = ssd(*args)
        err = check_close(y[:, :, heads], ref, "float32",
                          "SSDBlock's ssd vs float64 ssd_ref", scale=10.0)
        log(f"[ssd] SSDBlock mamba2-130m (d_model {cfg.d_model}, {H} heads "
            f"x {P}, state {S}) on {SSD_BATCH} x {SSD_LEN} tokens: config "
            f"{resolved}, {len(want)} launch(es) {[l.name for l in want]}; "
            f"ssd vs float64 ssd_ref on heads {heads}: max abs err "
            f"{err:.3e} (max |ref| {float(ref.abs().max()):.3e}); decode "
            f"step finite")

        # the op at the block's shapes, explicit configs, and an odd nc
        calls = [({"chunk": ch, "radix": 2, "fuse": fu}, SSD_LEN)
                 for ch in (128, 256) for fu in (0, 1)]
        calls += [({"chunk": 128, "radix": 2, "fuse": fu}, 384)
                  for fu in (0, 1)]
        runs = []
        for c, L in calls:
            part = tuple(v[:, :L] for v in args)
            with capture_launches() as launched:
                yo = ssd(*part, config={"tile_n": c["chunk"],
                                        "radix": c["radix"],
                                        "fuse": c["fuse"]})
            runs.append((c, L, part, yo, list(launched)))
        torch.cuda.synchronize()
        counts = launch_counts()
        log(f"[ssd] launches on the SSD path (block, then the op): {counts}")
        require_launched(counts, ("ssd_intra", "ssd_state_apply",
                                  "ssd_apply_entry", "scan_linrec",
                                  "scan_linrec.warp"), "the SSD path")
        require_new_routes(counts, "the SSD path")
        refs = {SSD_LEN: ref}
        ops = []
        for c, L, part, yo, launched in runs:
            want = chain_of(c, L).launches
            if tuple(launched) != want:
                raise AssertionError(f"ssd {c} L={L}: launched {launched} "
                                     f"!= chain {want}")
            if L not in refs:
                refs[L] = ssd_ref(part[0][:, :, heads].double(),
                                  part[1][:, :, heads].double(),
                                  part[2].double(), part[3].double())
            err = check_close(yo[:, :, heads], refs[L], "float32",
                              f"ssd {c} L={L} vs float64 ssd_ref",
                              scale=10.0)
            ops.append({"config": c, "L": L, "launches":
                        [l.name for l in launched], "err": err})
            log(f"[ssd] ssd {c} L={L}: {[l.name for l in launched]}, max "
                f"abs err vs float64 {err:.3e} (max |ref| "
                f"{float(refs[L].abs().max()):.3e})")
    return {"block": block, "x": x, "args": args, "resolved": resolved,
            "ops": ops, "block_counts": block_counts, "counts": counts}


def ssd_bounds(BH, G, L, P, S, chunk, bandwidth: float):
    """The least time the card could take for kernels 8, 9 and 10 at these
    f32 shapes: each function's bytes (inputs read once, outputs written
    once; b and c per sequence, as the kernels read them) over the memory
    rate, and its operations over the f32 rate; the larger, and which."""
    f4, nc = 4, L // chunk
    x_bytes = BH * L * P * f4
    a_bytes = BH * L * f4
    bc_bytes = 2 * G * L * S * f4
    st_bytes = BH * nc * S * P * f4
    pairs = chunk * (chunk + 1) // 2            # s <= t in a chunk
    # intra: per (row, chunk) the causal pairs' S-dot, decay multiply and
    # P-term (2S + 2 + 2P), the state's S x P x Q fma and b x decay
    intra_flops = BH * nc * (pairs * (2 * S + 2 + 2 * P)
                             + 2 * chunk * S * P + chunk * S)
    # apply: the Q x P x S dot, the decay multiply and the add; the fused
    # kernel also the S x P carry fma per chunk
    apply_flops = BH * nc * (2 * chunk * S * P + 2 * chunk * P)
    work = {"ssd_intra": (2 * x_bytes + a_bytes + bc_bytes + st_bytes
                          + BH * nc * f4, intra_flops),
            "ssd_state_apply": (2 * x_bytes + a_bytes + bc_bytes // 2
                                + st_bytes + BH * nc * f4,
                                apply_flops + BH * nc * 2 * S * P),
            "ssd_apply_entry": (2 * x_bytes + a_bytes + bc_bytes // 2
                                + st_bytes, apply_flops)}
    out = {}
    for name, (nbytes, flops) in work.items():
        by_bytes = nbytes / bandwidth * 1e3
        by_ops = flops / F32_PEAK * 1e3
        out[name] = {"bytes": nbytes, "flops": flops,
                     "bound_ms": max(by_bytes, by_ops),
                     "bound_by": "bytes" if by_bytes >= by_ops
                     else "operations"}
    return out


def entry_composed(y, a, c, entry, chunk):
    """Kernel 10's function as plain PyTorch calls: exp(cumsum(log a)) a
    chunk, ``torch.bmm`` (TF32 off) of c against the entry states, and the
    add.  A yardstick, timed only: the port never calls it."""
    import torch
    BH, L, P = y.shape
    G, _, S = c.shape
    nc = L // chunk
    la = torch.cumsum(torch.log(torch.clamp_min(a, 1e-30))
                      .view(BH, nc, chunk), -1)
    rows = c.view(G, 1, nc, chunk, S).expand(G, BH // G, nc, chunk, S)
    dots = torch.bmm(rows.reshape(BH * nc, chunk, S),
                     entry.view(BH * nc, S, P))
    return y + dots.view(BH, L, P) * torch.exp(la).view(BH, L, 1)


def phase_ssd_numbers(dev, run, errs, bandwidth: float):
    """Times at the block's shapes: the block, the op at the resolved and
    the forced configs and the port's torch ``ssd_chunked_ref`` (the op's
    ``composed_ms``, a yardstick the port never calls), kernels 8, 9 and
    10 over the chunk lengths on both routes, their device time by kernel (``[trace] ssd``), and the
    kernels line's entries for kernels 8, 9 and 10 at chunk 128 (kernel
    10 with ``entry_composed``'s time as its ``composed_ms``)."""
    import torch
    from repro_torch.kernels.ssd.kernel import (ssd_apply_entry,
                                                ssd_apply_entry_plain,
                                                ssd_intra, ssd_intra_plain,
                                                ssd_state_apply,
                                                ssd_state_apply_plain)
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    block, x, args = run["block"], run["x"], run["args"]
    B, L, H, P = args[0].shape
    S = args[2].shape[-1]
    BH = B * H
    with torch.inference_mode():
        times = {"block_prefill_ms": time_ms(lambda: block(x), 5),
                 "ssd_resolved_ms": time_ms(lambda: ssd(*args), 5),
                 "resolved": run["resolved"],
                 "composed_ms": time_ms(
                     lambda: ssd_chunked_ref(*args, chunk=128), 3),
                 "composed": "ssd_chunked_ref, chunk 128, f32 einsums, "
                             "TF32 off"}
        for op in run["ops"]:
            if op["L"] != L:
                continue
            c = op["config"]
            cfg = {"tile_n": c["chunk"], "radix": c["radix"],
                   "fuse": c["fuse"]}
            times[f"ssd_chunk{c['chunk']}_fuse{c['fuse']}_ms"] = time_ms(
                lambda: ssd(*args, config=cfg), 5)
        xbh = args[0].permute(0, 2, 1, 3).reshape(BH, L, P)
        abh = args[1].permute(0, 2, 1).reshape(BH, L)
        b, c = args[2], args[3]
        chunks = [ch for ch in (128, 256, 512, 1024, 2048) if ch <= L]
        by_chunk = {"ssd_intra": {}, "ssd_state_apply": {},
                    "ssd_apply_entry": {}}
        for chunk in chunks:
            bounds = ssd_bounds(BH, B, L, P, S, chunk, bandwidth)
            row = {"bound_ms": bounds["ssd_intra"]["bound_ms"]}
            for route in ("tiled", "block"):
                row[f"{route}_ms"] = time_ms(
                    lambda: ssd_intra(xbh, abh, b, c, chunk=chunk,
                                      route=route), 5)
            by_chunk["ssd_intra"][chunk] = row
            if L // chunk > 1:
                y, ac, st = ssd_intra(xbh, abh, b, c, chunk=chunk)
                row = {"bound_ms": bounds["ssd_state_apply"]["bound_ms"]}
                for route in ("tiled", "block"):
                    row[f"{route}_ms"] = time_ms(
                        lambda: ssd_state_apply(y, abh, c, ac, st,
                                                chunk=chunk, route=route), 5)
                by_chunk["ssd_state_apply"][chunk] = row
                row = {"bound_ms": bounds["ssd_apply_entry"]["bound_ms"]}
                for route in ("tiled", "block"):
                    row[f"{route}_ms"] = time_ms(
                        lambda: ssd_apply_entry(y, abh, c, st, chunk=chunk,
                                                route=route), 5)
                by_chunk["ssd_apply_entry"][chunk] = row
                del y, ac, st
        times["by_chunk"] = by_chunk
        log(f"[numbers] ssd at ({B}, {L}, {H}, {P}), state {S}: "
            f"{json.dumps(times, sort_keys=True)}")

        chunk = 128
        y, ac, st = ssd_intra(xbh, abh, b, c, chunk=chunk)
        ssd_trace({
            f"ssd_intra chunk {ch} ({route})":
                (lambda ch=ch, route=route: ssd_intra(xbh, abh, b, c,
                                                      chunk=ch, route=route))
            for ch in (128, L) for route in ("tiled", "block")} | {
            f"ssd_state_apply chunk {chunk} ({route})":
                (lambda route=route: ssd_state_apply(y, abh, c, ac, st,
                                                     chunk=chunk,
                                                     route=route))
            for route in ("tiled", "block")} | {
            f"ssd_apply_entry chunk {chunk} ({route})":
                (lambda route=route: ssd_apply_entry(y, abh, c, st,
                                                     chunk=chunk,
                                                     route=route))
            for route in ("tiled", "block")},
            f"BH {BH}, L {L}, P {P}, S {S}, f32")
        bounds = ssd_bounds(BH, B, L, P, S, chunk, bandwidth)

        def entry(name, replaces, fn, plain, block_fn=None, composed=None):
            got, want = fn(), plain()
            torch.cuda.synchronize()
            if not isinstance(got, tuple):
                got, want = (got,), (want,)
            per = [{"max_abs_err": max_err(g, w),
                    "not_bit_equal": int((g != w).sum()),
                    "elements": g.numel(), "max_abs": float(w.abs().max())}
                   for g, w in zip(got, want)]
            log(f"[numbers] {name} against its plain version at the "
                f"block's shape, per output: " + json.dumps(per))
            if any(p["not_bit_equal"] for p in per):
                raise AssertionError(f"{name}: not bit-equal to its plain "
                                     f"version at the block's shape")
            out = {"name": name, "route": "cuda",
                   "source": "src/repro_torch/csrc/ssd.cu",
                   "replaces": replaces, "launches": run["counts"][name],
                   "max_abs_err": max(p["max_abs_err"] for p in per),
                   "ms": time_ms(fn, 10),
                   "plain_ms": time_ms(plain, 2, warmup=1),
                   "bound_ms": bounds[name]["bound_ms"],
                   "bound_by": bounds[name]["bound_by"],
                   "library_ms": None,
                   "shape": [BH, L, P, S], "dtype": "float32",
                   "config": {"chunk": chunk},
                   "bytes": bounds[name]["bytes"],
                   "flops": bounds[name]["flops"],
                   "check_max_abs_err": errs[name]}
            if block_fn is not None:
                out["launches_by_route"] = {
                    r: run["counts"][f"{name}.{r}"]
                    for r in LAUNCH_ROUTES[name]}
                out["block_ms"] = time_ms(block_fn, 10)
                rows = by_chunk[name]
                out["ms_by_chunk"] = {ch: r["tiled_ms"]
                                      for ch, r in rows.items()}
                out["block_ms_by_chunk"] = {ch: r["block_ms"]
                                            for ch, r in rows.items()}
                out["bound_ms_by_chunk"] = {ch: r["bound_ms"]
                                            for ch, r in rows.items()}
            if composed is not None:
                out["composed"], comp = composed
                out["composed_ms"] = time_ms(comp, 10)
                out["composed_max_abs_err"] = max_err(comp(), want[0])
            log(f"[numbers] {json.dumps(out, sort_keys=True)}")
            return out

        entries = [
            entry("ssd_intra", "src/repro/kernels/ssd/kernel.py:74",
                  lambda: ssd_intra(xbh, abh, b, c, chunk=chunk),
                  lambda: ssd_intra_plain(xbh, abh, b, c, chunk=chunk),
                  lambda: ssd_intra(xbh, abh, b, c, chunk=chunk,
                                    route="block")),
            entry("ssd_state_apply", "src/repro/kernels/ssd/kernel.py:136",
                  lambda: ssd_state_apply(y, abh, c, ac, st, chunk=chunk),
                  lambda: ssd_state_apply_plain(y, abh, c, ac, st,
                                                chunk=chunk),
                  lambda: ssd_state_apply(y, abh, c, ac, st, chunk=chunk,
                                          route="block")),
            entry("ssd_apply_entry", "src/repro/kernels/ssd/kernel.py:169",
                  lambda: ssd_apply_entry(y, abh, c, st, chunk=chunk),
                  lambda: ssd_apply_entry_plain(y, abh, c, st, chunk=chunk),
                  lambda: ssd_apply_entry(y, abh, c, st, chunk=chunk,
                                          route="block"),
                  ("exp(cumsum(log a)), torch.bmm (TF32 off), add",
                   lambda: entry_composed(y, abh, c, st, chunk)))]
    return entries, times


def ssd_trace(calls, what: str, reps: int = 3):
    """torch.profiler's device time of each labelled SSD call, by kernel:
    per launch, launches per call, and each kernel's share of the call's
    device time.  One profiler window per label (the labels share kernel
    names), opened with a spin of about a millisecond (a window can lose
    its first kernels), after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(2_000_000)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = {}
        for evt in prof.key_averages():
            t = getattr(evt, "device_time_total", None)
            if t is None:
                t = getattr(evt, "cuda_time_total", 0.0)
            if t and "ssd" in evt.key and evt.count:
                per[evt.key[:80]] = {"ms_per_launch": t / 1e3 / evt.count,
                                     "launches_per_call": evt.count / reps,
                                     "ms_per_call": t / 1e3 / reps}
        total = sum(v["ms_per_call"] for v in per.values())
        for v in per.values():
            v["share"] = v["ms_per_call"] / total if total else None
        out[label] = per
    log(f"[trace] ssd at {what}, device time by kernel: "
        f"{json.dumps(out, sort_keys=True)}")
    return out


def rglru_f64_sequential(a, u):
    """h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 0)) u_t in float64, one step
    after another (Python floats on the CPU), for (rows, L) tensors."""
    import torch
    a64 = a.double().cpu()
    b64 = torch.sqrt(torch.clamp_min(1.0 - a64 * a64, 0.0)) * u.double().cpu()
    return linrec_f64_sequential(a64, b64)


def phase_rglru_path(dev):
    """rglru at recurrentgemma-9b's width (B = 2, L = 2048, D = 4096) with
    the session's config (fuse = 1: the gate in scan_linrec) and forced to
    fuse = 0 (the gate in torch), and one multipass call at B = 1, L =
    2^22, D = 16 (the gate in scan_linrec_prod), held against a float64
    sequential recurrence of sampled channels."""
    import torch
    from repro_torch.core.space import Workload
    from repro_torch.kernels.blocks.driver import capture_launches
    from repro_torch.kernels.blocks.plan import plan_for_chain
    from repro_torch.kernels.rglru.ops import rglru
    from repro_torch.tuning import default_session

    gen = torch.Generator(device=dev).manual_seed(11)
    shapes = {"wide": (2, 2048, RGLRU_WIDTH), "long": RGLRU_LONG}
    inputs = {k: (torch.rand(*s, generator=gen, device=dev) * 0.19 + 0.8,
                  torch.randn(*s, generator=gen, device=dev))
              for k, s in shapes.items()}
    calls = []
    for key, (B, L, D) in shapes.items():
        wl = Workload(op="rglru", n=L, batch=B * D)
        cfg = default_session().resolve(wl)
        calls.append((key, wl, cfg))
        if key == "wide":
            calls.append((key, wl, dict(cfg, fuse=1 - cfg["fuse"])))
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = []
    for key, wl, cfg in calls:
        with capture_launches() as launched:
            h = rglru(*inputs[key], config=cfg)
        outs.append((key, wl, cfg, h, list(launched)))
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[rglru] launches on the RG-LRU path: {counts}")
    require_launched(counts, ("scan_linrec", "scan_linrec.warp",
                              "scan_linrec_prod", "scan_linrec_prod.warp",
                              "apply_linrec"), "the RG-LRU path")
    require_new_routes(counts, "the RG-LRU path")
    runs = []
    for key, wl, cfg, h, launched in outs:
        chain = plan_for_chain(wl, cfg)
        if tuple(launched) != chain.launches:
            raise AssertionError(f"rglru {wl.key} {cfg}: launched "
                                 f"{launched} != chain {chain.launches}")
        a, u = inputs[key]
        B, L, D = a.shape
        chans = (0, D - 1) if L <= 2 ** 16 else (0,)
        ref = rglru_f64_sequential(a[:1, :, chans].permute(0, 2, 1)
                                   .reshape(-1, L),
                                   u[:1, :, chans].permute(0, 2, 1)
                                   .reshape(-1, L))
        got = h[:1, :, chans].permute(0, 2, 1).reshape(-1, L).cpu()
        err = check_close(got, ref, "float32", f"rglru {wl.key} {cfg} vs "
                          f"float64 sequential")
        log(f"[rglru] {wl.key}: {chain.plan.kind}, config {cfg}, "
            f"{len(launched)} launch(es), gate "
            f"{'in the kernel' if cfg['fuse'] else 'in torch'}, max abs err "
            f"vs float64 of channels {chans} {err:.3e}")
        runs.append({"key": key, "wl": wl, "cfg": cfg, "plan": chain.plan,
                     "err": err})
    times = {}
    for run in runs:
        args = inputs[run["key"]]
        cfg = run["cfg"]
        times[f"{run['wl'].key} fuse={cfg['fuse']}"] = time_ms(
            lambda: rglru(*args, config=cfg), 5)
    log(f"[numbers] rglru ms: {json.dumps(times)}")
    return counts, runs, times


# ---------------------------------------------------------------------------
# Flash attention (kernel 11), the dense model, the tiled matmul (kernel 12)
# ---------------------------------------------------------------------------

BF16_PEAK = 989e12          # H100 SXM dense bf16 tensor-core rate (FLOP/s)
DENSE_BATCH, DENSE_LEN = 4, 2048   # qwen1.5-0.5b forward: 4 x 2048 tokens
PROMPT, DECODE_STEPS = 64, 8       # prefill a 64-token prompt, 8 decodes
MAMBA_BATCH = 8                    # mamba2-130m forward: 8 x 2048 tokens
MATMUL_SHAPE = (8192, 1024, 2816)  # qwen's MLP up-projection, 4 x 2048 rows
# the flash path's logits against the plain-op path's (bf16 compute, 24
# layers): max |diff| over max |logits|.  Both round every projection,
# norm and residual to bf16; they differ in the attention core (f32 scores
# and one rounding of the output in the kernel, bf16 scores and
# probabilities in the plain path), and 24 layers carry those differences
# on, so the bound is the bf16 tolerance, not the f32 one.
DENSE_LOGITS_TOL = 2e-2
# decode after prefill against the forward: JAX's test_decode_matches_forward
DECODE_TOL = 2e-2
# kernel 11 against its plain version in bf16, element by element: |got -
# want| <= atol + rtol |want|.  Both compute in f32 and round the output
# once, so they may differ by one bf16 ulp (at most 2^-7 |want|); DTYPE_TOL's
# 2e-2 of max |want| (about 3 here, the first query row is v[0]) would pass
# errors as large as a typical output (about 0.05 over 1000 causal keys).
FLASH_BF16_TOL = (4e-3, 8e-3)
# kernel 12 in bf16 against its plain version, element by element: |got -
# want| <= one bf16 ulp of |want| + MATMUL_BF16_ATOL max |want|.  Both add
# the same k-blocks in f32 and round the output once, so they may round to
# neighbouring bf16 values (the ulp); the tensor cores sum a k-block's
# products in their own order, which can move an output near 0 by more
# than its own ulp (phase_matmul_kernels prints the largest such excess as
# a fraction of max |want|), and the term bounds that.  DTYPE_TOL's bf16
# bound is 2e-2 |want| + 2e-2 max |want|.
MATMUL_BF16_ATOL = 1e-3


def check_flash(got, want, dtype: str, what: str) -> float:
    """Hold kernel 11 to its plain version: FLASH_BF16_TOL in bf16,
    DTYPE_TOL in f32; returns the max error."""
    import torch
    if dtype != "bfloat16":
        return check_close(got, want, dtype, what)
    atol, rtol = FLASH_BF16_TOL
    g, r = got.double(), want.double()
    bad = (g - r).abs() > atol + rtol * r.abs()
    err = max_err(got, want)
    if bool(torch.any(bad)) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside "
                             f"|diff| <= {atol} + {rtol} |want| (max abs err "
                             f"{err:.3e})")
    return err


def attention_kernel_cases():
    """(BH, Lq, Lk, head_dim, block_q, block_k, causal, window, dtype)
    beside the h100 space sweep: every head dim the kernel takes, causal
    and full, recurrentgemma's 2048 window at L = 4096, queries in the last
    slots (Lq < Lk), whisper's 1500-long memory (block_k 4), f32."""
    cases = [(4, 1024, 1024, d, 128, 128, causal, None, "bfloat16")
             for d in (16, 64, 128, 256) for causal in (True, False)]
    return cases + [
        (2, 4096, 4096, 256, 256, 512, True, 2048, "bfloat16"),
        (8, 512, 2048, 64, 128, 256, True, None, "float32"),
        (8, 512, 2048, 128, 256, 128, True, 1024, "bfloat16"),
        (8, 64, 1500, 64, 64, 4, False, None, "bfloat16"),
        (4, 1024, 1024, 64, 256, 256, True, None, "float32"),
        (4, 1024, 1024, 256, 64, 1024, False, None, "float32")]


def path_stats(stats, path, err, got, want, **maxima):
    """Fold one case's max error, count of elements that are not bit-equal
    to the plain version, and any other maxima into ``stats[path]``."""
    entry = stats.setdefault(path, {"cases": 0, "max_abs_err": 0.0,
                                    "not_bit_equal": 0})
    entry["cases"] += 1
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["not_bit_equal"] += int((got != want).sum())
    for key, value in maxima.items():
        entry[key] = max(entry.get(key, 0.0), value)


def require_routes(fn, name, before, want):
    """The route counters of ``fn`` grew by ``want`` ({route: launches})
    since ``before``."""
    got = {route: getattr(fn, f"launches_{route}") - before[route]
           for route in want}
    if got != want:
        raise AssertionError(f"{name}: launches by route {got}, expected "
                             f"{want}")


def phase_attention_kernels(dev, quick: bool):
    """flash_attention against flash_attention_plain on the card: every
    config of the h100 attention space at n = 2048 (8 rows of 2048, head
    dim 64, causal) in bf16 (the tensor-core kernel) and in f32 (the
    CUDA-core kernel), then attention_kernel_cases(); bf16 held to
    FLASH_BF16_TOL, f32 to DTYPE_TOL.  Both compute the scores, m, l and acc
    in f32 and round the output once; the tensor-core kernel also rounds p
    to bf16 for its product with v, and the sums run in another order.
    Returns the max error."""
    import torch
    from repro_torch.core.space import Workload, attention_space
    from repro_torch.hw.profiles import get_profile
    from repro_torch.kernels.attention.kernel import (flash_attention,
                                                      flash_attention_plain)

    gen = torch.Generator(device=dev).manual_seed(21)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    space = attention_space(Workload(op="attention", n=2048, batch=8,
                                     variant="flash"), get_profile("h100"))
    sweep = [(8, 2048, 2048, 64, c["block_q"], c["block_k"], True, None,
              dtype) for dtype in ("bfloat16", "float32")
             for c in space.enumerate_valid()]
    cases = sweep + attention_kernel_cases()
    if quick:
        cases = sweep[:2] + sweep[-2:] + attention_kernel_cases()[:2]
    stats, qkv = {}, {}
    before = {r: getattr(flash_attention, f"launches_{r}")
              for r in LAUNCH_ROUTES["flash_attention"]}
    for BH, lq, lk, d, bq, bk, causal, window, dtype in cases:
        key = (BH, lq, lk, d, dtype)
        if key not in qkv:
            qkv[key] = tuple(torch.randn(BH, n, d, generator=gen,
                                         device=dev).to(dtypes[dtype])
                             for n in (lq, lk, lk))
        q, k, v = qkv[key]
        kw = dict(block_q=bq, block_k=bk, causal=causal, window=window)
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        what = (f"flash_attention ({BH}, {lq}, {lk}, {d}) {dtype} {kw}")
        path = "wgmma bf16" if dtype == "bfloat16" else "simt f32"
        path_stats(stats, path, check_flash(got, want, dtype, what), got,
                   want)
    n_bf16 = sum(case[-1] == "bfloat16" for case in cases)
    require_routes(flash_attention, "flash_attention", before,
                   {"wgmma": n_bf16, "simt": len(cases) - n_bf16})
    log(f"[kernels] flash_attention: {len(cases)} cases ({len(sweep) // 2} "
        f"h100 configs at n = 2048, bf16 and f32) within tolerance; by path "
        f"{json.dumps(stats, sort_keys=True)}")
    return max(entry["max_abs_err"] for entry in stats.values())


def check_matmul_bf16(got, want, what: str):
    """Hold the tensor-core matmul to its plain version element by element:
    |got - want| <= ulp(want) + MATMUL_BF16_ATOL max |want|, ulp(want) the
    bf16 spacing at |want|; returns the max error and the largest excess
    over one ulp as a fraction of max |want|."""
    import torch
    g, r = got.double(), want.double()
    mag = r.abs()
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=1e-30))) - 7)
    top = float(mag.max())
    diff = (g - r).abs()
    bad = diff > ulp + MATMUL_BF16_ATOL * top
    err = max_err(got, want)
    if bool(torch.any(bad)) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside one "
                             f"bf16 ulp + {MATMUL_BF16_ATOL} max |want| (max "
                             f"abs err {err:.3e})")
    return err, float((diff - ulp).clamp(min=0).max()) / top


def phase_matmul_kernels(dev, quick: bool):
    """matmul_tiled against matmul_plain on the card over every config the
    h100 matmul space admits at qwen's MLP up-projection, (8192, 1024) @
    (1024, 2816), fitted as the entry point fits it: f32 through the
    CUDA-core kernel at DTYPE_TOL, bf16 through the tensor-core kernel
    within one bf16 ulp plus MATMUL_BF16_ATOL of max |want|."""
    import torch
    from repro_torch.core.space import Workload, matmul_space
    from repro_torch.hw.profiles import get_profile
    from repro_torch.kernels.matmul.kernel import matmul_plain, matmul_tiled
    from repro_torch.kernels.matmul.ops import _normalize

    m, k, n = MATMUL_SHAPE
    wl = Workload(op="matmul", n=n, batch=m, variant="tiled")
    fitted = []
    for cfg in matmul_space(wl, get_profile("h100")).enumerate_valid():
        kw = _normalize(cfg, wl, {"m": m, "k": k})
        if kw not in fitted:
            fitted.append(kw)
    if quick:
        fitted = fitted[:2]
    gen = torch.Generator(device=dev).manual_seed(22)
    stats = {}
    before = {r: getattr(matmul_tiled, f"launches_{r}")
              for r in LAUNCH_ROUTES["matmul"]}
    for dtype, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        a = torch.randn(m, k, generator=gen, device=dev).to(dt)
        b = torch.randn(k, n, generator=gen, device=dev).to(dt)
        for kw in fitted:
            got = matmul_tiled(a, b, **kw)
            want = matmul_plain(a, b, **kw)
            torch.cuda.synchronize()
            what = f"matmul {dtype} {kw}"
            if dtype == "bfloat16":
                err, excess = check_matmul_bf16(got, want, what)
                path_stats(stats, "wgmma bf16", err, got, want,
                           max_beyond_one_ulp_of_max_want=excess)
            else:
                path_stats(stats, "simt f32",
                           check_close(got, want, dtype, what), got, want)
    require_routes(matmul_tiled, "matmul", before,
                   {"wgmma": len(fitted), "simt": len(fitted)})
    log(f"[kernels] matmul: {len(fitted)} fitted configs x 2 dtypes at "
        f"{MATMUL_SHAPE} within tolerance; by path "
        f"{json.dumps(stats, sort_keys=True)}")
    return max(entry["max_abs_err"] for entry in stats.values())


# ---------------------------------------------------------------------------
# Static analysis and the differential table (phases 9a, 9b)
# ---------------------------------------------------------------------------

# the port's lint: exactly these findings, by key — the seven h100 spaces
# whose every valid config's modeled footprint exceeds h100's vmem_budget
# (2^17); reported, not fixed (a new budget changes which configs h100
# picks, which is a measured change)
ANALYSIS_FINDINGS = tuple(
    f"invariant.no-feasible-config:h100/{where}:4b04410eb452"
    for where in ("attention:flash:n512:b64:float32",
                  "attention:flash:n1024:b64:float32",
                  "attention:flash:n2048:b64:float32",
                  "attention:flash:n4096:b64:float32",
                  "matmul:default:n512:b1024:float32",
                  "matmul:default:n1024:b1024:float32",
                  "matmul:default:n2048:b1024:float32"))
# the table's rows that reach no kernel in either package: the cr, lf
# (below LF_MULTIPASS_MIN) and wm solvers are torch in the port and jnp in
# the JAX package; each must launch none
NO_KERNEL_ROWS = ("solve_cr", "solve_lf", "solve_wm")


def phase_analysis():
    """The port's ``run_lint()`` (AST lint, contract fingerprints, the
    invariant sweep over every op x profile) in the card's process: its
    findings must be exactly ANALYSIS_FINDINGS, none baselined.  Returns
    its seconds."""
    from repro_torch.analysis import (apply_baseline, default_fixture_path,
                                      load_baseline, run_lint)
    t0 = time.perf_counter()
    findings = run_lint()
    seconds = time.perf_counter() - t0
    baseline = os.path.join(os.path.dirname(default_fixture_path()),
                            "analysis_baseline_torch.json")
    fresh, quiet = apply_baseline(findings, load_baseline(baseline))
    keys = sorted(f.key() for f in fresh)
    if quiet or keys != sorted(ANALYSIS_FINDINGS):
        raise AssertionError(
            f"[analysis] findings {keys} (baselined {len(quiet)}) != the "
            f"seven h100 no-feasible-config findings")
    log(f"[analysis] run_lint: {len(fresh)} findings, 0 baselined, in "
        f"{seconds:.2f} s: "
        + "; ".join(f.render() for f in fresh))
    return seconds


def phase_differential(dev):
    """The port's differential table (``repro_torch.evaluation.differential``,
    the JAX table's rows and one bf16 matmul at a prime N) on the card:
    every registered entry point must have a row; every (entry, dtype,
    shape) runs through the public entry point on CUDA tensors with
    config=None, resolved under h100, and is held against the same entry
    point on CPU tensors given the configs the card's call resolved, at
    DTYPE_TOL x the row's scale.  Each case must launch kernels (none for
    NO_KERNEL_ROWS), as many as its launch list where ``capture_launches``
    records one; the bf16 matmuls on the "ragged" route.  Returns the
    launches by kernel and route."""
    import torch
    from repro_torch.evaluation import differential as diff
    from repro_torch.kernels.blocks.driver import capture_launches

    missing = diff.missing_rows()
    if missing:
        raise AssertionError(f"[differential] registered entry points "
                             f"without a row: {missing}")
    cpu = torch.device("cpu")
    names = list(launch_wrappers())
    total = dict.fromkeys(launch_counts(), 0)
    report = {}
    t0 = time.perf_counter()
    for entry, dtype, batch, n in diff.cases():
        row = diff.TABLE[entry]
        inputs = row.make(batch, n)
        what = f"[differential] {entry} {dtype} b{batch} n{n}"
        torch.cuda.synchronize()
        before = launch_counts()
        with capture_launches() as launched:
            got, cfgs = diff.run_case(entry, diff.tensors(inputs, dtype, dev))
        torch.cuda.synchronize()
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        want, _ = diff.run_case(entry, diff.tensors(inputs, dtype, cpu), cfgs)
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{what}: card {tuple(got.shape)} "
                                 f"{got.dtype}, CPU {tuple(want.shape)} "
                                 f"{want.dtype}")
        ok, err = diff.close(got, want, dtype, row.scale)
        if not ok:
            raise AssertionError(f"{what}: card against CPU outside "
                                 f"{dtype} x {row.scale} (max err "
                                 f"{err:.3e}), configs {cfgs}")
        if entry.endswith("_fused"):   # fuse 1 against fuse 0, on the card
            ok, fused_err = diff.close(got[0], got[1], dtype, row.scale)
            if not ok:
                raise AssertionError(f"{what}: fused against unfused "
                                     f"{fused_err:.3e}")
        kernels = sum(delta[name] for name in names)
        if entry in NO_KERNEL_ROWS:
            if kernels:
                raise AssertionError(f"{what}: launched {kernels} kernels, "
                                     f"expected none")
        elif kernels == 0 or (launched and kernels != len(launched)):
            raise AssertionError(f"{what}: {kernels} kernel launches, "
                                 f"launch list {len(launched)}")
        if entry.startswith("matmul") and dtype == "bfloat16" \
                and delta["matmul.ragged"] != 1:
            raise AssertionError(f"{what}: not on the ragged route: {delta}")
        for key, k in delta.items():
            total[key] += k
        rec = report.setdefault(entry, {"cases": 0, "max_err": 0.0,
                                        "configs": [], "launches": {}})
        rec["cases"] += 1
        rec["max_err"] = max(rec["max_err"], err)
        rec["configs"].append([f"{dtype} b{batch} n{n}", cfgs])
        for key, k in delta.items():
            if k:
                rec["launches"][key] = rec["launches"].get(key, 0) + k
    seconds = time.perf_counter() - t0
    for entry in sorted(report):
        log(f"[differential] {entry}: {json.dumps(report[entry])}")
    reached = sorted(name for name in names if total[name])
    log(f"[differential] {sum(r['cases'] for r in report.values())} cases "
        f"of {len(report)} rows within tolerance in {seconds:.1f} s; "
        f"kernels reached: {reached}; not reached: "
        f"{sorted(set(names) - set(reached))}; launches "
        f"{json.dumps({k: v for k, v in total.items() if v})}")
    return total


def phase_dense_path(dev):
    """qwen1.5-0.5b at full width (24 layers, d_model 1024, 16 heads of 64,
    d_ff 2816, vocab 151936, QKV bias, bf16), random weights at the JAX
    init's scales, use_pallas on: forward on 4 x 2048 tokens (one flash
    launch per layer), held against the same weights on the plain-op path;
    then a 63-token prefill, the prompt's last token and 7 greedy tokens
    through decode_step, held against the forward's logits."""
    import dataclasses

    import torch
    from repro_torch.configs.qwen15_05b import CONFIG
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(CONFIG, use_pallas=True)
    gen = torch.Generator(device=dev).manual_seed(13)
    t0 = time.perf_counter()
    model = Model.init(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (DENSE_BATCH, DENSE_LEN),
                           generator=gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[dense] {cfg.arch}: {n_params / 1e9:.3f} B parameters "
        f"({sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30:.2f} GiB) "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    reset_launch_counts()
    with torch.inference_mode():
        logits, _ = model(tokens)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[dense] launches in one forward: {counts}")
    if counts["flash_attention"] != cfg.n_layers \
            or counts["flash_attention.wgmma"] != cfg.n_layers:
        raise AssertionError(f"forward launched flash_attention "
                             f"{counts['flash_attention']} times, "
                             f"{counts['flash_attention.wgmma']} on the "
                             f"tensor cores, not one per layer "
                             f"({cfg.n_layers}) there")
    want_shape = (DENSE_BATCH, DENSE_LEN, cfg.vocab)
    if tuple(logits.shape) != want_shape or logits.dtype != torch.float32 \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"forward logits {tuple(logits.shape)} "
                             f"{logits.dtype}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    model.cfg = dataclasses.replace(cfg, use_pallas=False)
    with torch.inference_mode():
        ref, _ = model(tokens)
    model.cfg = cfg
    scale = float(ref.abs().max())
    rel = float((logits - ref).abs().max()) / scale
    mean_rel = float((logits - ref).abs().mean()) / float(ref.abs().mean())
    agree = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
    del ref
    log(f"[dense] flash path vs plain-op path: max |diff| / max |logits| "
        f"{rel:.3e} (bound {DENSE_LOGITS_TOL}), mean |diff| / mean |logits| "
        f"{mean_rel:.3e}, argmax agreement {agree:.4f}")
    if not rel < DENSE_LOGITS_TOL:
        raise AssertionError(f"flash-path logits off the plain path by "
                             f"{rel:.3e} relative")

    # prefill + greedy decode, against the forward
    B = DENSE_BATCH
    prompt = tokens[:, :PROMPT]
    with torch.inference_mode():
        cache = model.init_cache(B, PROMPT + DECODE_STEPS, device=dev)
        steps = prompt[:, :PROMPT - 1].T.contiguous()
        pos = torch.arange(PROMPT - 1, device=dev)[:, None].expand(
            PROMPT - 1, B).contiguous()
        cache = model.prefill(steps, cache, pos, torch.ones(
            PROMPT - 1, B, dtype=torch.bool, device=dev))
        tok = prompt[:, PROMPT - 1:]
        fed, dec = [], []
        for t in range(DECODE_STEPS):
            fed.append(tok)
            lg, cache = model.decode_step(
                tok, cache, torch.full((B, 1), PROMPT - 1 + t, device=dev))
            dec.append(lg[:, 0])
            tok = lg[:, 0].argmax(-1, keepdim=True)
        seq = torch.cat([prompt[:, :PROMPT - 1]] + fed, dim=1)
        # the forward's flash path needs L >= 128: causal logits at the
        # first positions do not depend on the padding after them
        padded = torch.cat([seq, torch.zeros(B, 128 - seq.shape[1],
                                             dtype=seq.dtype, device=dev)],
                           dim=1)
        full, _ = model(padded)
    torch.cuda.synchronize()
    fwd = full[:, PROMPT - 1:PROMPT - 1 + DECODE_STEPS]
    got = torch.stack(dec, dim=1)
    dec_rel = float((got - fwd).abs().max()) / float(fwd.abs().max())
    log(f"[dense] prefill {PROMPT - 1} + {DECODE_STEPS} greedy decode steps "
        f"vs forward: max |diff| / max |logits| {dec_rel:.3e} (bound "
        f"{DECODE_TOL}); greedy tokens {torch.cat(fed[1:], 1).tolist()}")
    if not dec_rel < DECODE_TOL:
        raise AssertionError(f"decode logits off the forward by {dec_rel:.3e}"
                             f" relative")
    del logits, full
    torch.cuda.empty_cache()
    return {"model": model, "tokens": tokens, "counts": counts,
            "rel": rel, "mean_rel": mean_rel, "decode_rel": dec_rel}


def phase_dense_numbers(dev, run):
    """The forward's time on the card, split into the flash kernel's
    launches (timed alone at the forward's shapes and config) and the rest
    (projections, MLP, norms, rope, the f32 unembedding)."""
    import torch
    from repro_torch.core.space import Workload
    from repro_torch.kernels.attention.kernel import flash_attention
    from repro_torch.models import layers as L
    from repro_torch.tuning import default_session

    model, tokens = run["model"], run["tokens"]
    cfg = model.cfg
    BH, hd = DENSE_BATCH * cfg.n_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(14)
    q, k, v = (torch.randn(BH, DENSE_LEN, hd, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    blocks = default_session().resolve(
        Workload(op="attention", n=DENSE_LEN, batch=BH, variant="flash"),
        dims={"lq": DENSE_LEN, "lk": DENSE_LEN})
    x = torch.randn(DENSE_BATCH, DENSE_LEN, cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        forward_ms = time_ms(lambda: model(tokens), 3, warmup=1)
        flash_ms = time_ms(lambda: flash_attention(q, k, v, causal=True,
                                                   **blocks), 10)
        unembed_ms = time_ms(lambda: L.unembed(model.embed, x), 3)
    out = {"forward_ms": forward_ms, "flash_ms_per_layer": flash_ms,
           "flash_ms": flash_ms * cfg.n_layers,
           "flash_share": flash_ms * cfg.n_layers / forward_ms,
           "unembed_ms": unembed_ms,
           "rest_ms": forward_ms - flash_ms * cfg.n_layers,
           "config": blocks, "tokens": DENSE_BATCH * DENSE_LEN,
           "tokens_per_s": DENSE_BATCH * DENSE_LEN / (forward_ms / 1e3),
           "logits_rel_vs_plain_path": run["rel"],
           "decode_rel_vs_forward": run["decode_rel"]}
    log(f"[numbers] dense forward {json.dumps(out, sort_keys=True)}")
    return out


def phase_trace(dev, run):
    """One qwen forward under torch.profiler (see ``trace_call``)."""
    import torch
    model, tokens = run["model"], run["tokens"]
    with torch.inference_mode():
        return trace_call(lambda: model(tokens), "qwen forward")


def trace_call(fn, what: str):
    """One call of ``fn`` under torch.profiler (CPU + CUDA) after a
    warm-up: the five kernels with the most device time, by name, and the
    device's idle share over the call (1 - the union of kernel intervals
    over the time from the first kernel's start to the last one's end).
    Where the profiler records no device time, say so: the CUDA-event
    splits stand alone then."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and e.time_range.end > e.time_range.start]
    if not kernels:
        log(f"[trace] {what}: torch.profiler recorded no device time on "
            f"this machine; the split rests on CUDA events alone")
        return None
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = spans[-1][1] - spans[0][0]
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out = {"kernel_launches": len(kernels),
           "device_busy_ms": busy / 1e3, "window_ms": window / 1e3,
           "idle_share": 1.0 - busy / window, "host_wall_ms": wall_ms,
           "top5": [{"name": name[:120], "ms": ms, "share": ms / total}
                    for name, ms in top]}
    log(f"[trace] {what} under torch.profiler: "
        f"{json.dumps(out, sort_keys=True)}")
    return out


def phase_mamba_model(dev, bandwidth: float):
    """One full-depth mamba2-130m Model.forward (24 SSD groups, 8 x 2048
    tokens, random weights, bf16): finite logits of the right shape, the
    SSD kernels launched, every ssd_intra launch on the tiled kernel; the
    forward's time split into its ssd_intra launches (kernel 8 timed at
    the forward's shapes and resolved chunk, times the layers) and the
    rest."""
    import torch
    from repro_torch.configs.mamba2_130m import CONFIG
    from repro_torch.core.space import Workload
    from repro_torch.kernels.ssd.kernel import ssd_intra
    from repro_torch.models.model import Model
    from repro_torch.tuning import default_session

    gen = torch.Generator(device=dev).manual_seed(15)
    model = Model.init(CONFIG, gen, device=dev)
    tokens = torch.randint(0, CONFIG.vocab, (MAMBA_BATCH, SSD_LEN),
                           generator=gen, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.inference_mode():
        logits, _ = model(tokens)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[mamba] {CONFIG.arch} forward launches: {counts}")
    require_launched(counts, ("ssd_intra", "ssd_intra.tiled"),
                     "the ssm Model.forward")
    require_new_routes(counts, "the ssm Model.forward")
    if tuple(logits.shape) != (MAMBA_BATCH, SSD_LEN, CONFIG.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"mamba2 forward logits {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    del logits
    H = CONFIG.ssm_expand * CONFIG.d_model // CONFIG.ssm_head_dim
    P, S = CONFIG.ssm_head_dim, CONFIG.ssm_state
    wl = Workload(op="ssd", n=SSD_LEN, batch=MAMBA_BATCH * H,
                  variant="chunked")
    chunk = default_session().resolve(wl)["chunk"]
    x, a, b, c = ssd_inputs(gen, dev, MAMBA_BATCH * H, MAMBA_BATCH, SSD_LEN,
                            P, S, torch.float32, False)
    with torch.inference_mode():
        ms = time_ms(lambda: model(tokens), 2, warmup=1)
        intra_ms = time_ms(lambda: ssd_intra(x, a, b, c, chunk=chunk), 5)
        block_ms = time_ms(lambda: ssd_intra(x, a, b, c, chunk=chunk,
                                             route="block"), 3)
    layers = counts["ssd_intra"]
    out = {"forward_ms": ms, "tokens": MAMBA_BATCH * SSD_LEN,
           "ssd_chunk": chunk, "ssd_intra_launches": layers,
           "ssd_intra_ms_per_launch": intra_ms,
           "ssd_intra_ms": intra_ms * layers,
           "ssd_intra_share": intra_ms * layers / ms,
           "rest_ms": ms - intra_ms * layers,
           "ssd_intra_block_ms_per_launch": block_ms,
           "ssd_intra_bound_ms_per_launch": ssd_bounds(
               MAMBA_BATCH * H, MAMBA_BATCH, SSD_LEN, P, S, chunk,
               bandwidth)["ssd_intra"]["bound_ms"]}
    log(f"[numbers] mamba2-130m forward ({MAMBA_BATCH} x {SSD_LEN} tokens): "
        f"{json.dumps(out, sort_keys=True)}")
    del model, x, a, b, c
    torch.cuda.empty_cache()
    return counts, out


# ---------------------------------------------------------------------------
# The model families (phase 11): every other arch of the registry
# ---------------------------------------------------------------------------

# arch: (batch, tokens, layers kept or None).  granite-34b is 93.9 GB and
# llama-3.2-vision-90b 179 GB of bf16 weights: the first 44 layers (47 GB)
# and 5 groups of 5 (46 GB) fit the 80 GB card with their activations.
# recurrentgemma runs 4096 tokens so that its 2048 window binds, at 12
# of its 36 layers (four of its (rec, rec, attn) groups): at full depth
# its ring-wrapping prefill, a step a position, took 213.8 s of a whole
# run of 1190.3 s against the 1200 s limit; whisper runs its encoder over
# 2 x 1500 frames and its decoder over 2 x 448 tokens (its context).
MODEL_RUNS = {"gemma-2b": (2, 2048, None), "minitron-4b": (2, 2048, None),
              "granite-34b": (2, 2048, 44),
              "recurrentgemma-9b": (1, 4096, 12),
              "qwen2-moe-a2.7b": (2, 2048, None),
              "qwen3-moe-30b-a3b": (1, 2048, None),
              "llama-3.2-vision-90b": (1, 2048, 25),
              "whisper-large-v3": (2, 448, None)}
RG_PREFILL = 2112           # past recurrentgemma's 2048-slot ring buffer
REC_BLOCK_SHAPE = (1, 4096)  # RecurrentBlock vs float64, at the forward's shape
MODEL_SEED = 31


class RouteLog:
    """Wraps ``repro_torch.models.moe.route`` while installed: records each
    call's expert choices and queue positions, or replays a recorded run's
    choices (the expert indices and positions; the weights from this run's
    own probabilities at those indices), so that the plain-op path is held
    to the flash path on the same experts and the comparison sees the
    attention cores alone.  Counts the (token, choice) pairs that
    capacity drops and, in a replay, the tokens whose own top-k differs
    from the replayed one."""

    def __init__(self, replay=None):
        self.replay = replay
        self.calls = []
        self.pairs = self.dropped = self.flipped = self.tokens = 0

    def __enter__(self):
        from repro_torch.models import moe
        self.original = moe.route
        moe.route = self
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self.original

    def __call__(self, p, x, cfg):
        import torch
        from repro_torch.models.moe import capacity
        s, gate_w, idx, probs, pos = self.original(p, x, cfg)
        if self.replay is not None:
            want_idx, want_pos = self.replay.calls[len(self.calls)]
            same = torch.sort(idx, -1).values == torch.sort(want_idx,
                                                             -1).values
            self.flipped += int((~same.all(-1)).sum())
            self.tokens += idx.shape[0] * idx.shape[1]
            gate_w = torch.gather(probs, -1, want_idx)
            gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True),
                                          min=1e-9)
            idx, pos = want_idx, want_pos
        self.calls.append((idx, pos))
        self.pairs += pos.numel()
        self.dropped += int((pos >= capacity(cfg, s)).sum())
        return s, gate_w, idx, probs, pos


def rec_layers(model) -> int:
    """The RG-LRU layers of the built model (0 outside the hybrid family)."""
    from repro_torch.models.recurrent import RecurrentBlock
    return sum(isinstance(m, RecurrentBlock) for m in model.modules())


def attention_calls(model, batch, length):
    """The flash calls of one forward (an audio arch's encode included),
    read off the built model: each decoder ``StdBlock``'s self-attention
    over the tokens and cross-attention over the memory, each encoder
    block's over the frames, as (label, BH, Lq, Lk, head_dim, causal,
    window, launches)."""
    from repro_torch.models.model import StdBlock
    cfg = model.cfg
    bh, hd = batch * cfg.n_heads, cfg.head_dim
    dec = [m for m in model.blocks.modules() if isinstance(m, StdBlock)]
    n_cross = sum(hasattr(m, "xattn") for m in dec)
    n_enc = len(getattr(model, "enc_blocks", ()))
    calls = [("self", bh, length, length, hd, True, cfg.attn_window,
              len(dec))]
    if n_cross:
        calls.append(("cross", bh, length, cfg.vision_len, hd, False, None,
                      n_cross))
    if n_enc:
        calls.append(("encoder", bh, cfg.enc_len, cfg.enc_len, hd, True,
                      None, n_enc))
    return calls


def rec_block_f64(block, x, lru_f64):
    """The RG-LRU block's arithmetic written out in float64 on the block's
    own weights: projections, the tanh gelu, the causal conv, the f32
    gates' formulas, and the recurrence one step after another by
    ``lru_f64`` (``linrec_f64_sequential``)."""
    import torch
    w = {name: p.detach().double() for name, p in block.named_parameters()}
    x = x.double()
    bsz, L, _ = x.shape
    u = x @ w["wx.w"]
    g = x @ w["wy.w"]
    gate = g * (0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                        * (g + 0.044715 * g ** 3))))
    K = w["conv_w"].shape[0]
    ctx = torch.nn.functional.pad(u, (0, 0, K - 1, 0))
    u = sum(ctx[:, i:i + L] * w["conv_w"][i] for i in range(K))
    r = torch.sigmoid(u @ w["wa.w"])
    i_gate = torch.sigmoid(u @ w["wi.w"])
    log_a = -8.0 * torch.nn.functional.softplus(w["lambda"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12)) \
        * i_gate * u
    W = a.shape[-1]
    h = lru_f64(a.transpose(1, 2).reshape(bsz * W, L),
                b.transpose(1, 2).reshape(bsz * W, L))
    h = h.to(x.device).reshape(bsz, W, L).transpose(1, 2)
    return (h * gate) @ w["wo.w"]


def phase_rec_block(dev, cfg):
    """One RecurrentBlock at recurrentgemma-9b's width (d_model 4096,
    lru_width 4096) on bf16 weights drawn at the JAX init's scales, in f32
    and bf16 compute, against its arithmetic in float64 (the recurrence by
    ``linrec_f64_sequential``) at the tests' DTYPE_TOL; on a CUDA tensor
    the block's recurrence is the tuned linear_recurrence (the linrec
    kernels)."""
    import torch
    from repro_torch.models.recurrent import RecurrentBlock

    gen = torch.Generator(device=dev).manual_seed(MODEL_SEED + 1)
    block = RecurrentBlock(cfg, torch.bfloat16, device=dev)
    block.reset(gen)
    B, L = REC_BLOCK_SHAPE
    x = torch.randn(B, L, cfg.d_model, generator=gen, device=dev).to(
        torch.bfloat16)
    t0 = time.perf_counter()
    want = rec_block_f64(block, x, linrec_f64_sequential)
    f64_s = time.perf_counter() - t0
    errs = {}
    with torch.inference_mode():
        for dtype, name in ((torch.float32, "float32"),
                            (torch.bfloat16, "bfloat16")):
            got, _ = block(x.to(dtype), cfg, compute_dtype=dtype)
            errs[name] = check_close(got, want, name,
                                     f"RecurrentBlock {name} compute vs "
                                     f"float64")
    log(f"[models] RecurrentBlock ({B}, {L}, {cfg.d_model}) vs float64 "
        f"(the recurrence in {f64_s:.1f} s on the host): max abs err "
        f"{json.dumps(errs)}")
    return errs


def flash_at_shape(dev, timed, call, batch):
    """Kernel 11 at one attention shape of a model's forward, once per
    distinct shape (``timed`` keeps each result under its shape's key):
    held against its plain version on a few rows, its route read from the
    launch counters, then timed in turns beside
    ``scaled_dot_product_attention`` on the same tensors, with the
    session's blocks.  Returns (key, result)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.space import Workload
    from repro_torch.kernels.attention.kernel import (flash_attention,
                                                      flash_attention_plain)
    from repro_torch.tuning import default_session

    _, BH, lq, lk, hd, causal, window, _ = call
    key = f"({BH}, {lq}, {lk}, {hd}) " + ("causal" if causal else "full") \
        + (f" window {window}" if window else "")
    if key in timed:
        return key, timed[key]
    gen = torch.Generator(device=dev).manual_seed(MODEL_SEED + 2)
    q = torch.randn(BH, lq, hd, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(BH, lk, hd, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    blocks = default_session().resolve(
        Workload(op="attention", n=lk, batch=BH, variant="flash"),
        dims={"lq": lq, "lk": lk})
    rows = slice(0, 4)
    before = launch_counts()
    got = flash_attention(q[rows], k[rows], v[rows], causal=causal,
                          window=window, **blocks)
    after = launch_counts()
    route = [r for r in LAUNCH_ROUTES["flash_attention"]
             if after[f"flash_attention.{r}"] > before[f"flash_attention.{r}"]]
    want = flash_attention_plain(q[rows], k[rows], v[rows], causal=causal,
                                 window=window, **blocks)
    err = check_flash(got, want, "bfloat16", f"flash_attention {key} "
                      f"{blocks}")
    heads = [t.view(batch, BH // batch, t.shape[1], hd) for t in (q, k, v)]
    mask = None
    if window is not None:
        qpos = torch.arange(lq, device=dev)[:, None] + (lk - lq)
        kpos = torch.arange(lk, device=dev)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - window)
    sdpa_causal = causal and mask is None
    with torch.inference_mode():
        turns = time_turns({
            "flash": (lambda: flash_attention(
                q, k, v, causal=causal, window=window, **blocks), 5),
            "sdpa": (lambda: F.scaled_dot_product_attention(
                *heads, attn_mask=mask, is_causal=sdpa_causal), 5)})
    med = {name: sorted(ts)[len(ts) // 2] for name, ts in turns.items()}
    timed[key] = {"shape": [BH, lq, lk, hd], "causal": causal,
                  "window": window, "config": blocks,
                  "route": ",".join(route),
                  "max_abs_err_vs_plain": err, "ms": med["flash"],
                  "sdpa_ms": med["sdpa"], "turns_ms": turns, "calls": []}
    return key, timed[key]


def model_forward_split(dev, model, tokens, forward_ms, timed, arch):
    """The forward's time split into its flash launches (kernel 11 at each
    attention shape, ``flash_at_shape``, times its launches), its linear
    recurrences (the tuned entry point at the RG-LRU's rows, held against
    float64 on the inputs it is timed on, times the rec layers) and the
    rest; the f32 unembedding timed alone."""
    import torch
    from repro_torch.kernels.scan.ops import linear_recurrence
    from repro_torch.models import layers as L

    cfg = model.cfg
    B, T = tokens.shape
    gen = torch.Generator(device=dev).manual_seed(MODEL_SEED + 3)
    flash_ms, shapes = 0.0, {}
    for call in attention_calls(model, B, T):
        key, res = flash_at_shape(dev, timed, call, B)
        res["calls"].append(f"{arch} {call[0]}")
        flash_ms += res["ms"] * call[-1]
        shapes[call[0]] = {"shape": key, "launches": call[-1],
                           "ms_per_launch": res["ms"]}
    out = {}
    linrec_ms, n_rec = 0.0, rec_layers(model)
    if n_rec:
        W = cfg.lru_width or cfg.d_model
        a = torch.rand(B * W, T, generator=gen, device=dev) * 0.19 + 0.8
        b = torch.randn(B * W, T, generator=gen, device=dev)
        with torch.inference_mode():
            h = linear_recurrence(a, b)
            linrec_ms = time_ms(lambda: linear_recurrence(a, b), 5) * n_rec
        out["linrec_max_abs_err_vs_float64"] = check_close(
            h.cpu(), linrec_f64_sequential(a, b), "float32",
            f"linear_recurrence {tuple(a.shape)} (the {arch} forward's "
            f"shape) vs float64")
        del a, b, h
    x = torch.randn(B, T, cfg.d_model, generator=gen, device=dev).to(
        torch.bfloat16)
    with torch.inference_mode():
        unembed_ms = time_ms(lambda: L.unembed(model.embed, x), 3)
    del x
    out.update({"forward_ms": forward_ms, "flash_ms": flash_ms,
                "flash_share": flash_ms / forward_ms,
                "flash_by_shape": shapes, "linrec_ms": linrec_ms,
                "linrec_launches_timed": n_rec,
                "linrec_share": linrec_ms / forward_ms,
                "rest_ms": forward_ms - flash_ms - linrec_ms,
                "unembed_ms": unembed_ms,
                "unembed_share": unembed_ms / forward_ms,
                "tokens": B * T, "tokens_per_s": B * T / (forward_ms / 1e3)})
    return out


def phase_model_arch(dev, arch, trace: bool, timed):
    """One arch at full width in bf16 with ``use_pallas`` on, weights from
    a seeded generator at the JAX init's scales: the forward (an audio
    arch's encode first) with its launches counted; its logits against
    the same weights on the plain-op path (max |diff| / max |logits| <
    DENSE_LOGITS_TOL; moe archs with the flash path's expert choices
    replayed); decode steps against the forward (DECODE_TOL), after a
    prefill (dense, hybrid) or from an empty cache with the memory (vlm,
    audio; the JAX model's prefill steps without memory) — moe archs only
    timed, since a forward and a decode drop different pairs at capacity
    factor 1.25; the forward's time split; for the hybrid arch, one
    RecurrentBlock against float64 and a profiler trace."""
    import dataclasses

    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core.space import Workload
    from repro_torch.kernels.blocks.driver import capture_launches
    from repro_torch.kernels.blocks.plan import plan_for
    from repro_torch.models.model import Model
    from repro_torch.tuning import default_session

    B, T, layers = MODEL_RUNS[arch]
    full = get_arch(arch)
    cfg = dataclasses.replace(full, use_pallas=True,
                              n_layers=layers or full.n_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(MODEL_SEED)
    t0 = time.perf_counter()
    model = Model.init(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (B, T), generator=gen, device=dev)
    frames = memory = None
    if cfg.family == "audio":
        frames = torch.randn(B, cfg.enc_len, cfg.d_model, generator=gen,
                             device=dev).to(torch.bfloat16)
    if cfg.family == "vlm":
        memory = torch.randn(B, cfg.vision_len, cfg.d_model, generator=gen,
                             device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weights_gb = sum(p.numel() * p.element_size()
                     for p in model.parameters()) / 1e9
    out = {"arch": arch, "family": cfg.family, "batch": B, "tokens": T,
           "layers": cfg.n_layers, "layers_published": full.n_layers,
           "parameters": n_params, "weights_gb": weights_gb,
           "init_s": time.perf_counter() - t0}
    moe = cfg.family == "moe"

    def forward():
        mem = model.encode(frames) if frames is not None else memory
        return model(tokens, memory=mem)

    reset_launch_counts()
    route_log = RouteLog()
    with torch.inference_mode(), capture_launches() as launched:
        if moe:
            with route_log:
                logits, aux = forward()
        else:
            logits, aux = forward()
    torch.cuda.synchronize()
    counts = launch_counts()
    out["counts"] = counts
    calls = attention_calls(model, B, T)
    n_flash = sum(c[-1] for c in calls)
    if counts["flash_attention"] != n_flash \
            or counts["flash_attention.wgmma"] != n_flash:
        raise AssertionError(f"{arch}: flash_attention launched "
                             f"{counts['flash_attention']} times, "
                             f"{counts['flash_attention.wgmma']} on the "
                             f"tensor cores, not once per attention layer "
                             f"({n_flash}) there")
    if cfg.family == "hybrid":
        W = cfg.lru_width or cfg.d_model
        wl = Workload(op="scan", n=T, batch=B * W, variant="linrec")
        plan = plan_for(wl, default_session().resolve(wl))
        n_rec = rec_layers(model)
        want = list(plan.launches) * n_rec
        if list(launched) != want:
            raise AssertionError(f"{arch}: linrec launches {launched} != "
                                 f"{n_rec} rec layers x {plan.launches}")
        require_launched(counts, ("scan_linrec", "scan_linrec.warp"),
                         f"the {arch} forward")
        require_new_routes(counts, f"the {arch} forward")
        out["linrec_plan"] = [launch.name for launch in plan.launches]
    elif launched:
        raise AssertionError(f"{arch}: unexpected block launches "
                             f"{launched}")
    want_shape = (B, T, cfg.vocab)
    if tuple(logits.shape) != want_shape or logits.dtype != torch.float32 \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: logits {tuple(logits.shape)} "
                             f"{logits.dtype}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    out["aux"] = float(aux)
    if moe:
        out["pairs"] = route_log.pairs
        out["dropped_share"] = route_log.dropped / route_log.pairs

    # the same weights on the plain-op path (moe: the same experts)
    model.cfg = dataclasses.replace(cfg, use_pallas=False)
    replay = RouteLog(replay=route_log)
    with torch.inference_mode():
        if moe:
            with replay:
                ref, _ = forward()
        else:
            ref, _ = forward()
    model.cfg = cfg
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    rel = float((logits - ref).abs().max()) / scale
    out["logits_rel_vs_plain_path"] = rel
    out["argmax_agreement"] = float(
        (logits.argmax(-1) == ref.argmax(-1)).float().mean())
    if moe:
        out["plain_path_tokens_choosing_other_experts"] = replay.flipped
        out["plain_path_router_tokens"] = replay.tokens
    del ref
    if not rel < DENSE_LOGITS_TOL:
        raise AssertionError(f"{arch}: flash-path logits off the plain path "
                             f"by {rel:.3e} relative")

    # decode: after a prefill (dense, hybrid, moe) or from position 0 with
    # the memory (vlm, audio), teacher-forced, against the forward
    mem = model.encode(frames) if frames is not None else memory
    if cfg.family in ("vlm", "audio"):
        start, prefill_len = 0, 0
    else:
        prefill_len = RG_PREFILL if cfg.family == "hybrid" else PROMPT - 1
        start = prefill_len
    t0 = time.perf_counter()
    with torch.inference_mode():
        cache = model.init_cache(B, start + DECODE_STEPS, device=dev)
        if prefill_len:
            steps = tokens[:, :prefill_len].T.contiguous()
            pos = torch.arange(prefill_len, device=dev)[:, None].expand(
                prefill_len, B).contiguous()
            cache = model.prefill(steps, cache, pos, torch.ones(
                prefill_len, B, dtype=torch.bool, device=dev))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dec = []
        for t in range(start, start + DECODE_STEPS):
            lg, cache = model.decode_step(
                tokens[:, t:t + 1], cache,
                torch.full((B, 1), t, device=dev), memory=mem)
            dec.append(lg[:, 0])
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    out["prefill_tokens"] = prefill_len
    out["prefill_s"] = t1 - t0
    out["decode_ms_per_step"] = (t2 - t1) * 1e3 / DECODE_STEPS
    got = torch.stack(dec, dim=1)
    fwd = logits[:, start:start + DECODE_STEPS]
    out["decode_rel_vs_forward"] = float((got - fwd).abs().max()) \
        / float(fwd.abs().max())
    if cfg.family == "hybrid":
        ring = cache[0][cfg.block_pattern.index("attn")]
        out["ring_slots"] = int(ring["k"].shape[1])
        out["ring_positions"] = [int(ring["pos"].min()),
                                 int(ring["pos"].max())]
    del cache, dec, got, fwd, logits
    if not moe and not out["decode_rel_vs_forward"] < DECODE_TOL:
        raise AssertionError(f"{arch}: decode logits off the forward by "
                             f"{out['decode_rel_vs_forward']:.3e} relative")

    with torch.inference_mode():
        forward_ms = time_ms(forward, 2, warmup=1)
    out.update(model_forward_split(dev, model, tokens, forward_ms, timed,
                                   arch))
    out["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if trace:
        with torch.inference_mode():
            out["trace"] = trace_call(forward, f"{arch} forward")
    if cfg.family == "hybrid":
        del model, mem
        torch.cuda.empty_cache()
        out["rec_block_max_abs_err"] = phase_rec_block(dev, cfg)
    shown = dict(out, counts={k: v for k, v in counts.items() if v})
    log(f"[numbers] models {arch}: {json.dumps(shown, sort_keys=True)}")
    return out


def phase_models(dev):
    """Every arch of the registry beside qwen1.5-0.5b and mamba2-130m (the
    dense path and the mamba phase run those) through the port's Model at
    full width, one after another, each freed before the next, with
    kernel 11 at each distinct attention shape beside SDPA."""
    import torch
    log(f"[models] {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"by earlier phases")
    runs, timed = {}, {}
    for arch in MODEL_RUNS:
        t0 = time.perf_counter()
        runs[arch] = phase_model_arch(dev, arch,
                                      trace=arch == "recurrentgemma-9b",
                                      timed=timed)
        torch.cuda.empty_cache()
        log(f"[models] {arch}: {time.perf_counter() - t0:.1f} s, peak "
            f"{runs[arch]['max_memory_gb']:.1f} GB")
    log(f"[numbers] flash at the models' shapes: "
        f"{json.dumps(timed, sort_keys=True)}")
    return runs, timed


def phase_long_carry(dev):
    """The repaired multipass case: prefix_sum and linear_recurrence at
    n = 2^22 x 16 forced to tile_n 128, rows 2, whose carry scan is a
    (2, 32768) block, twice the kernels' staging: each against float64
    (cumsum; a sequential recurrence of row 0), the launch list equal to
    the plan's."""
    import torch
    from repro_torch.core.space import Workload
    from repro_torch.kernels.blocks.driver import capture_launches
    from repro_torch.kernels.blocks.plan import plan_for
    from repro_torch.kernels.scan.ops import (_plan_workload,
                                              linear_recurrence, prefix_sum)
    from repro_torch.tuning import default_session

    cfg = {"tile_n": 128, "rows_per_program": 2, "radix": 2, "unroll": 1,
           "in_register": 0}
    n, batch = 2 ** 22, 16
    gen = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn(batch, n, generator=gen, device=dev)
    a = torch.rand(batch, n, generator=gen, device=dev) * 0.19 + 0.8
    reset_launch_counts()
    with capture_launches() as sum_launches:
        y = prefix_sum(x, config=cfg)
    with capture_launches() as rec_launches:
        h = linear_recurrence(a, x, config=cfg)
    torch.cuda.synchronize()
    counts = launch_counts()
    require_new_routes(counts, "the 2^22 carry-tile path")
    for linrec, launched in ((False, sum_launches), (True, rec_launches)):
        wl = Workload(op="scan", n=n, batch=batch,
                      variant="linrec" if linrec else "ks")
        plan = plan_for(_plan_workload(wl, linrec=linrec),
                        default_session().resolve(wl, config=cfg))
        if tuple(launched) != plan.launches:
            raise AssertionError(f"{wl.key}: launched {launched} != plan "
                                 f"{plan.launches}")
    # the carry-scan launch alone against its plain version (which walks
    # the same pieces), on a (batch, 32768) row of chunk sums
    from repro_torch.kernels.scan.kernel import (scan_add, scan_add_plain,
                                                 scan_linrec,
                                                 scan_linrec_plain)
    l2 = plan.launches[1]
    kw = dict(rows_per_program=l2.block_shape[0], tile_n=l2.block_shape[1],
              stages=l2.stages)
    sums = torch.randn(batch, l2.block_shape[1], generator=gen, device=dev)
    ops = a[:, :l2.block_shape[1]].contiguous()
    pairs = ((scan_add(sums, **kw), scan_add_plain(sums, **kw)),
             (scan_linrec(ops, sums, **kw), scan_linrec_plain(ops, sums, **kw)))
    torch.cuda.synchronize()
    unequal = [int((got != want).sum()) for got, want in pairs]
    for (got, want), name in zip(pairs, ("scan_add", "scan_linrec")):
        check_close(got, want, "float32", f"{name} carry tile {kw}")
    err_sum = check_close(y, torch.cumsum(x.double(), dim=-1), "float32",
                          "prefix_sum 2^22 carry tile (2, 32768)")
    err_rec = check_close(h[:1].cpu(), linrec_f64_sequential(a[:1], x[:1]),
                          "float32", "linear_recurrence 2^22 carry tile "
                          "(2, 32768)")
    log(f"[long] carry tile (2, 32768) at 2^22 x 16: launches {counts}; "
        f"prefix_sum max abs err vs float64 {err_sum:.3e}, "
        f"linear_recurrence {err_rec:.3e}; the carry launch alone, elements "
        f"not bit-equal to the plain version: scan_add {unequal[0]}, "
        f"scan_linrec {unequal[1]}")
    return counts


def phase_matmul_path(dev):
    """The matmul entry point at qwen's MLP up-projection (bf16), the
    session's config under h100, against a float64 product."""
    import torch
    from repro_torch.core.space import Workload
    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.tuning import default_session

    m, k, n = MATMUL_SHAPE
    gen = torch.Generator(device=dev).manual_seed(23)
    a = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn(k, n, generator=gen, device=dev).to(torch.bfloat16)
    cfg = default_session().resolve(
        Workload(op="matmul", n=n, batch=m, variant="tiled"),
        dims={"m": m, "k": k})
    torch.cuda.synchronize()
    reset_launch_counts()
    c = matmul(a, b)
    torch.cuda.synchronize()
    counts = launch_counts()
    require_launched(counts, ("matmul",), "the matmul entry point")
    err = check_close(c, a.double() @ b.double(), "bfloat16",
                      "matmul vs float64")
    log(f"[matmul] {MATMUL_SHAPE} bf16, config {cfg}: max abs err vs "
        f"float64 {err:.3e}; launches {counts['matmul']}")
    return {"a": a, "b": b, "cfg": cfg, "counts": counts}


def time_turns(fns, turns: int = 3):
    """Device times (CUDA events, after a warm-up) of each named call,
    taken in turns within this run: every turn times all of them, in
    alternating order, so that clocks and neighbours weigh on each alike.
    ``fns`` maps a name to (fn, iterations); returns name -> the turns'
    times (ms)."""
    names = list(fns)
    times = {name: [] for name in names}
    for turn in range(turns):
        for name in names if turn % 2 == 0 else names[::-1]:
            fn, iters = fns[name]
            times[name].append(time_ms(fn, iters))
    return times


def phase_attention_matmul_numbers(dev, dense_counts, mm, loop_counts, errs,
                                   bandwidth: float):
    """The kernels line's entries for kernels 11 and 12 at the main paths'
    shapes: the flash kernel at one qwen layer's attention (64 rows of
    2048, head dim 64, bf16, causal), the matmul at qwen's MLP
    up-projection (bf16), each timed in turns against its yardstick: the
    tensor-core kernel at the session's blocks (and flash at the tuned
    (128, 128)), the library call, and the CUDA-core kernel on the same bf16
    inputs (the earlier design, through its test-only entry)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.space import Workload
    from repro_torch.kernels.attention.kernel import (flash_attention,
                                                      flash_attention_plain,
                                                      flash_attention_simt)
    from repro_torch.kernels.matmul.kernel import (matmul_plain, matmul_simt,
                                                   matmul_tiled)
    from repro_torch.tuning import default_session

    BH, L, D = DENSE_BATCH * 16, DENSE_LEN, 64
    gen = torch.Generator(device=dev).manual_seed(24)
    q, k, v = (torch.randn(BH, L, D, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    blocks = default_session().resolve(
        Workload(op="attention", n=L, batch=BH, variant="flash"),
        dims={"lq": L, "lk": L})
    tuned = {"block_q": 128, "block_k": 128}
    got = flash_attention(q, k, v, causal=True, **blocks)
    want = flash_attention_plain(q, k, v, causal=True, **blocks)
    torch.cuda.synchronize()
    check_flash(got, want, "bfloat16",
                f"flash_attention ({BH}, {L}, {L}, {D}) bf16 {blocks}")
    err = max_err(got, want)
    del got, want
    a, b, cfg = mm["a"], mm["b"], mm["cfg"]
    m, kk = a.shape
    n = b.shape[1]
    got = matmul_tiled(a, b, **cfg)
    want = matmul_plain(a, b, **cfg)
    torch.cuda.synchronize()
    mm_err, _ = check_matmul_bf16(got, want,
                                  f"matmul {MATMUL_SHAPE} bf16 {cfg}")
    del got, want
    # SDPA's (B, H, L, D) layout of the same rows, for library_ms
    heads = tuple(t.view(DENSE_BATCH, BH // DENSE_BATCH, L, D)
                  for t in (q, k, v))
    with torch.inference_mode():
        turns = time_turns({
            "flash wgmma, session's blocks": (
                lambda: flash_attention(q, k, v, causal=True, **blocks), 10),
            "flash wgmma, (128, 128)": (
                lambda: flash_attention(q, k, v, causal=True, **tuned), 10),
            "scaled_dot_product_attention": (
                lambda: F.scaled_dot_product_attention(*heads,
                                                       is_causal=True), 10),
            "flash simt bf16, session's blocks": (
                lambda: flash_attention_simt(q, k, v, causal=True,
                                             **blocks), 2),
            "flash simt bf16, (128, 128)": (
                lambda: flash_attention_simt(q, k, v, causal=True,
                                             **tuned), 3),
            "matmul wgmma, session's blocks": (
                lambda: matmul_tiled(a, b, **cfg), 10),
            "torch.matmul": (lambda: torch.matmul(a, b), 10),
            "matmul simt bf16, session's blocks": (
                lambda: matmul_simt(a, b, **cfg), 3)})
        flash_plain_ms = time_ms(lambda: flash_attention_plain(
            q, k, v, causal=True, **blocks), 3, warmup=1)
        mm_plain_ms = time_ms(lambda: matmul_plain(a, b, **cfg), 5)

    def med(name):
        return sorted(turns[name])[len(turns[name]) // 2]

    pairs = BH * L * (L + 1) // 2               # causal (query, key) pairs
    flash_ops_ms = pairs * 4 * D / BF16_PEAK * 1e3
    flash_bytes_ms = 4 * q.numel() * q.element_size() / bandwidth * 1e3
    mm_ops_ms = 2 * m * n * kk / BF16_PEAK * 1e3
    mm_bytes_ms = (a.numel() + b.numel() + m * n) * 2 / bandwidth * 1e3
    record = {"ms": turns,
              "median_ms": {name: med(name) for name in turns},
              "bound_ms": {"flash_attention": max(flash_ops_ms,
                                                  flash_bytes_ms),
                           "matmul": max(mm_ops_ms, mm_bytes_ms)},
              "config": {"flash_attention": blocks, "matmul": cfg}}
    log(f"[turns] {json.dumps(record, sort_keys=True)}")
    routes = {"bfloat16": "wgmma (tensor cores)",
              "float32": "simt (CUDA cores)"}
    flash = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/attention.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:87",
        "paths": routes,
        "launches": dense_counts["flash_attention"],
        "launches_by_path": {"dense forward": dense_counts[
            "flash_attention"], "tuning loop": loop_counts[
            "flash_attention"]},
        "launches_by_route": {
            "dense forward": {r: dense_counts[f"flash_attention.{r}"]
                              for r in LAUNCH_ROUTES["flash_attention"]},
            "tuning loop": {r: loop_counts[f"flash_attention.{r}"]
                            for r in LAUNCH_ROUTES["flash_attention"]}},
        "max_abs_err": max(err, errs["flash"]),
        "ms": med("flash wgmma, session's blocks"),
        "ms_tuned_128_128": med("flash wgmma, (128, 128)"),
        "simt_bf16_ms": med("flash simt bf16, session's blocks"),
        "simt_bf16_ms_tuned_128_128": med("flash simt bf16, (128, 128)"),
        "plain_ms": flash_plain_ms,
        "bound_ms": max(flash_ops_ms, flash_bytes_ms),
        "bound_by": "operations" if flash_ops_ms >= flash_bytes_ms
        else "bytes",
        "library_ms": med("scaled_dot_product_attention"),
        "shape": [BH, L, D], "dtype": "bfloat16",
        "config": {key: blocks[key] for key in sorted(blocks)}}
    matmul = {
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul/kernel.py:37",
        "paths": routes,
        "launches": mm["counts"]["matmul"] + loop_counts["matmul"],
        "launches_by_path": {"matmul entry point": mm["counts"]["matmul"],
                             "tuning loop": loop_counts["matmul"]},
        "launches_by_route": {
            "matmul entry point": {r: mm["counts"][f"matmul.{r}"]
                                   for r in LAUNCH_ROUTES["matmul"]},
            "tuning loop": {r: loop_counts[f"matmul.{r}"]
                            for r in LAUNCH_ROUTES["matmul"]}},
        "max_abs_err": max(mm_err, errs["matmul"]),
        "ms": med("matmul wgmma, session's blocks"),
        "simt_bf16_ms": med("matmul simt bf16, session's blocks"),
        "plain_ms": mm_plain_ms,
        "bound_ms": max(mm_ops_ms, mm_bytes_ms),
        "bound_by": "operations" if mm_ops_ms >= mm_bytes_ms else "bytes",
        "library_ms": med("torch.matmul"),
        "shape": [m, kk, n], "dtype": "bfloat16",
        "config": {key: cfg[key] for key in sorted(cfg)}}
    for entry in (flash, matmul):
        log(f"[numbers] {json.dumps(entry, sort_keys=True)}")
    return [flash, matmul]


# ---------------------------------------------------------------------------
# Serving (phase 15): the engines and online tuning in traffic
# ---------------------------------------------------------------------------

# the multi-tenant trace of the JAX package's serving benchmark
# (benchmarks/bench_serving.py: default_tenants, seed 0) over 28 of its 40
# ticks: at 40 ticks (53 requests) the phase took 226.5 s on the card,
# over its 200 s budget, the eager steps being host-bound (about 55 ms)
SERVE_HORIZON = 28
SERVE_ENGINE = dict(max_batch=8, max_len=128, prefill_chunk=16,
                    admit_threshold=4)
SERVE_MAMBA_REQUESTS = 16
# the online tuner's workload: attention at batch = max_batch, as
# launch.serve builds it, but n = 256 rather than max_len: at n = 128 the
# h100 attention space holds one config and no trial could run (JAX's
# test_online_tuner_attached_to_engine takes 256 for the same reason)
SERVE_ONLINE_N = 256
SERVE_ONLINE_BUDGET = 24


def serve_trace(vocab: int):
    from repro_torch.serve import default_tenants, synthetic_trace
    return synthetic_trace(default_tenants(), horizon=SERVE_HORIZON,
                           vocab=vocab, seed=0)


def serve_once(engine, trace):
    """Submit the trace, run it to the end; (requests, seconds)."""
    import torch
    for r in trace:
        engine.submit(r.prompt, max_new_tokens=r.max_new_tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run(max_steps=1_000_000)
    torch.cuda.synchronize()
    return done, time.perf_counter() - t0


def first_difference(model, got, want, max_len: int):
    """The first request whose tokens differ between two runs, the
    position, and the top-2 logit margin there on ``want``'s sequence
    (teacher-forced at B = 1): the record a token mismatch fails with."""
    import torch
    for a, b in zip(got, want):
        if a.output == b.output and a.finish_reason == b.finish_reason:
            continue
        k = next((i for i, (x, y) in enumerate(zip(a.output, b.output))
                  if x != y), min(len(a.output), len(b.output)))
        seq = list(a.prompt) + list(b.output[:k])
        dev = next(model.parameters()).device
        with torch.inference_mode():
            cache = model.init_cache(1, max_len, dtype=torch.float32)
            for t, tok in enumerate(seq):
                lg, cache = model.decode_step(
                    torch.tensor([[int(tok)]], device=dev), cache,
                    torch.tensor([[t]], device=dev))
        top = torch.topk(lg.reshape(-1).float(), 2)
        return {"rid": a.rid, "position": k, "engine": a.output,
                "reference": b.output, "finish": [a.finish_reason,
                                                  b.finish_reason],
                "top2": top.indices.tolist(),
                "top2_margin": float(top.values[0] - top.values[1])}
    return None


def step_stats(durations):
    import statistics
    ms = sorted(d * 1e3 for d in durations)
    return {"steps": len(ms), "median_ms": statistics.median(ms),
            "p90_ms": ms[min(len(ms) - 1, int(0.9 * len(ms)))],
            "mean_ms": sum(ms) / len(ms)}


def phase_serve(dev):
    """The serving stack on the card (``[serve]``): qwen1.5-0.5b at full
    width and depth (bf16 weights at the JAX init's scales, f32 cache)
    through ``ServeEngine`` and ``ReferenceEngine`` on the serving
    benchmark's trace (``SERVE_HORIZON`` ticks), greedy tokens and finish reasons equal; the engine's
    prefill calls against ceil((len - 1) / chunk) summed, its host
    transfers against its steps; ten steady-state decode steps under
    torch.profiler; the online tuner attached in traffic, that timed run's
    decode-step times, its recorded trace replayed twice to the same
    winner; mamba2-130m at full width against one-request reference runs
    (8 lanes, as the engine's).  Every check raises."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs.mamba2_130m import CONFIG as MAMBA
    from repro_torch.configs.qwen15_05b import CONFIG as QWEN
    from repro_torch.core.space import Workload
    from repro_torch.launch.tune import online_replay
    from repro_torch.models.model import Model
    from repro_torch.serve import ReferenceEngine, ServeEngine, trace_summary
    from repro_torch.tuning import TunerSession
    from repro_torch.tuning.online import (OnlineTuner, TraceRecorder,
                                           attach)

    t_phase = time.perf_counter()
    out = {}
    model = Model.init(QWEN, torch.Generator(device=dev).manual_seed(41),
                       device=dev)
    trace = serve_trace(QWEN.vocab)
    chunk = SERVE_ENGINE["prefill_chunk"]
    bound = sum(math.ceil((len(r.prompt) - 1) / chunk) for r in trace)
    log(f"[serve] {QWEN.arch}: trace {json.dumps(trace_summary(trace))}, "
        f"engine {json.dumps(SERVE_ENGINE)}, prefill-call bound {bound}")

    eng = ServeEngine(model, **SERVE_ENGINE)
    t0 = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    done, eng_s = serve_once(eng, trace)
    counts = launch_counts()
    eng_peak = torch.cuda.max_memory_allocated()
    ref = ReferenceEngine(model, max_batch=SERVE_ENGINE["max_batch"],
                          max_len=SERVE_ENGINE["max_len"])
    torch.cuda.reset_peak_memory_stats()
    ref_done, ref_s = serve_once(ref, trace)
    ref_peak = torch.cuda.max_memory_allocated()
    tokens = sum(len(r.output) for r in done)
    ref_tokens = sum(len(r.output) for r in ref_done)
    out["qwen"] = {
        "requests": len(done), "tokens": tokens, "warmup_s": warm_s,
        "engine_s": eng_s, "engine_tokens_per_s": tokens / eng_s,
        "reference_s": ref_s, "reference_tokens_per_s": ref_tokens / ref_s,
        "ratio": (tokens / eng_s) / (ref_tokens / ref_s),
        "prefill_calls": eng.prefill_calls, "prefill_call_bound": bound,
        "host_transfers": eng.host_transfers, "engine_steps":
        eng._step_index, "reference_steps": ref._step_index,
        "engine_peak_gib": eng_peak / 2 ** 30,
        "reference_peak_gib": ref_peak / 2 ** 30,
        "kernel_launches": {k: v for k, v in counts.items() if "." not in k},
        "finish": {r: sum(q.finish_reason == r for q in done)
                   for r in ("stop", "length")}}
    log(f"[serve] qwen engines {json.dumps(out['qwen'], sort_keys=True)}")
    diff = first_difference(model, done, ref_done, SERVE_ENGINE["max_len"])
    if diff is not None or len(done) != len(trace):
        raise AssertionError(f"engine and reference disagree: {diff}")
    if any(not 0 <= t < QWEN.vocab for r in done for t in r.output):
        raise AssertionError("a token outside the vocabulary")
    if eng.prefill_calls > bound:
        raise AssertionError(f"prefill_calls {eng.prefill_calls} > {bound}")
    if eng.host_transfers > eng._step_index:
        raise AssertionError(f"host_transfers {eng.host_transfers} > steps "
                             f"{eng._step_index}")

    # the engine again with the online tuner attached in traffic: a timed
    # run (the tuner's and a second listener's step times), then the
    # recorded trace replayed twice
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        wl = Workload(op="attention", n=SERVE_ONLINE_N,
                      batch=SERVE_ENGINE["max_batch"], variant="flash")
        session = TunerSession(db_path=os.path.join(tmp, "db.json"))
        tuner = OnlineTuner(wl, session, budget=SERVE_ONLINE_BUDGET,
                            journal_dir=os.path.join(tmp, "journals"))
        path = os.path.join(tmp, "trace.jsonl")
        recorder = TraceRecorder(path, wl)
        live = ServeEngine(model, **SERVE_ENGINE)
        live.warmup()
        attach(live, tuner, recorder=recorder)
        durations = []
        live.add_step_listener(lambda rec: durations.append(rec.duration_s))
        live_done, live_s = serve_once(live, trace)
        if [r.output for r in live_done] != [r.output for r in done]:
            raise AssertionError("the timed run decoded other tokens")
        out["qwen_steps"] = dict(step_stats(durations), run_s=live_s,
                                 tokens_per_s=tokens / live_s,
                                 host_transfers=live.host_transfers)
        log(f"[serve] qwen timed decode steps "
            f"{json.dumps(out['qwen_steps'], sort_keys=True)}")
        s = tuner.summary()
        ewmas = [t["ewma_s"] for t in s["trials"] if t["ewma_s"]]
        out["online"] = {
            "workload": s["workload"], "state": s["state"],
            "stopped_by": s["stopped_by"], "steps": s["steps"],
            "measured": s["measured"], "budget": s["budget"],
            "promotions": s["promotions"], "incumbent": s["incumbent"],
            "incumbent_ewma_ms": (s["incumbent_ewma_s"] or 0.0) * 1e3,
            "trials": [{"config": t["config"], "state": t["state"],
                        "samples": t["samples"],
                        "ewma_ms": (t["ewma_s"] or 0.0) * 1e3}
                       for t in s["trials"]],
            "ewma_spread": (max(ewmas) - min(ewmas)) / min(ewmas)
            if ewmas else None,
            "records": recorder.records, "run_s": live_s}
        log(f"[serve] online tuner in traffic "
            f"{json.dumps(out['online'], sort_keys=True)}")
        replays = [online_replay(path, budget=SERVE_ONLINE_BUDGET)[0]
                   for _ in range(2)]
        fates = [(r["incumbent"], [(t["config"], t["state"])
                                   for t in r["trials"]]) for r in replays]
        log(f"[serve] online-replay x2: winner {replays[0]['incumbent']}, "
            f"stopped_by {replays[0]['stopped_by']}, promotions "
            f"{replays[0]['promotions']}; identical "
            f"{replays[0] == replays[1]}")
        if fates[0] != fates[1] or not s["steps"]:
            raise AssertionError(f"the trace replayed to other fates: "
                                 f"{fates}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ten steady-state decode steps, 8 lanes, under torch.profiler (last:
    # after a profiled window, the timed runs would not time the same host)
    steady = ServeEngine(model, **SERVE_ENGINE)
    for lane in range(SERVE_ENGINE["max_batch"]):
        steady.submit(trace[lane].prompt[:8], max_new_tokens=100)
    steady.run(max_steps=2)
    out["qwen_trace"] = trace_call(lambda: steady.run(max_steps=10),
                                   "qwen serve, 10 decode steps x 8 lanes")

    del model, eng, ref, steady, live
    torch.cuda.empty_cache()

    # mamba2-130m: the engine's lanes against one-request reference runs
    # at the engine's 8 lanes.  Alone in the reference, a request's lane
    # is never padding, so its state is defined; at 1 lane the card's bf16
    # products take other kernels (M = 1, not 8) and round otherwise, which
    # flipped a near-tie (top-2 margin 0.008) in this phase's first run
    model = Model.init(MAMBA, torch.Generator(device=dev).manual_seed(42),
                       device=dev)
    mtrace = serve_trace(MAMBA.vocab)[:SERVE_MAMBA_REQUESTS]
    eng = ServeEngine(model, **SERVE_ENGINE)
    eng.warmup()
    reset_launch_counts()
    done, eng_s = serve_once(eng, mtrace)
    mcounts = launch_counts()
    refs, ref_s = [], 0.0
    for r in mtrace:
        solo = ReferenceEngine(model, max_batch=SERVE_ENGINE["max_batch"],
                               max_len=SERVE_ENGINE["max_len"])
        got, seconds = serve_once(solo, [r])
        refs.append(got[0])
        ref_s += seconds
    tokens = sum(len(r.output) for r in done)
    out["mamba2"] = {"requests": len(done), "tokens": tokens,
                     "engine_s": eng_s, "engine_tokens_per_s": tokens / eng_s,
                     "reference_s": ref_s,
                     "prefill_calls": eng.prefill_calls,
                     "host_transfers": eng.host_transfers,
                     "engine_steps": eng._step_index,
                     "kernel_launches": {k: v for k, v in mcounts.items()
                                         if "." not in k}}
    log(f"[serve] {MAMBA.arch} engine "
        f"{json.dumps(out['mamba2'], sort_keys=True)}")
    diff = first_difference(model, done, refs, SERVE_ENGINE["max_len"])
    if diff is not None:
        raise AssertionError(f"mamba2 lanes disagree with their "
                             f"one-request reference runs: {diff}")
    del model, eng
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[serve] {out['seconds']:.1f} s")
    return out


# Portability (phase 16): policies, pruning and cross-device transfer
PORT_PROFILES = ("tpu_v5e", "gpu_sm", "h100")   # h100 last: it reads the rest
PORT_POLICIES = ("latency", "energy", "edp", "memory_cap")
PORT_METHODS = ("exhaustive", "analytical", "transfer", "bayesian", "random")
PORT_TOP_K = (8, 16, 64)
# the kernels the phase's measured sweep must launch, on their new routes
PORT_KERNELS = ("scan_add", "pcr", "fft_stockham", "ssd_intra",
                "flash_attention", "matmul")
JOULE_SECONDS = 1.0         # back-to-back calls of each winner per reading


def foreign_histories(journal_dir, wl, target):
    """{source profile: (entries, weight)} of the journals in
    ``journal_dir`` that ``device_histories`` turns into priors for ``wl``
    on ``target``: other profiles' sweeps, weighted
    exp(-profile_distance)."""
    from repro_torch.core.transfer import _journal_profile, journal_history
    from repro_torch.tuning.sweep import SweepJournal, _safe

    out = {}
    prefix = _safe(wl.key) + "__"
    for name in sorted(os.listdir(journal_dir)):
        if not (name.startswith(prefix) and name.endswith(".jsonl")):
            continue
        path = os.path.join(journal_dir, name)
        got = journal_history(path, target)
        if got is not None and got[0].workload.key == wl.key:
            src = _journal_profile(SweepJournal(path).read_header())
            out[src] = (len(got[0].configs), got[1])
    return out


def nvml_energy_reader():
    """The card's total energy counter in mJ, read through NVML's
    ``nvmlDeviceGetTotalEnergyConsumption`` (ctypes on the NVML library
    ``libnvidia-ml.so.1``; the port never loads it)."""
    import ctypes
    lib = ctypes.CDLL("libnvidia-ml.so.1")
    if lib.nvmlInit_v2() != 0:
        raise RuntimeError("nvmlInit_v2 failed")
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    index = int(visible) if visible.strip().isdigit() else 0
    handle = ctypes.c_void_p()
    rc = lib.nvmlDeviceGetHandleByIndex_v2(ctypes.c_uint(index),
                                           ctypes.byref(handle))
    if rc != 0:
        raise RuntimeError(f"nvmlDeviceGetHandleByIndex_v2: {rc}")
    mj = ctypes.c_ulonglong()

    def read():
        rc = lib.nvmlDeviceGetTotalEnergyConsumption(handle, ctypes.byref(mj))
        if rc != 0:
            raise RuntimeError(f"nvmlDeviceGetTotalEnergyConsumption: {rc}")
        return mj.value

    return read


def joules_per_call(fn, read, seconds: float):
    """(mJ, ms) a call over at least ``seconds`` of back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    calls, e0, t0 = 0, read(), time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(8):
            fn()
        calls += 8
        torch.cuda.synchronize()
    dt, e1 = time.perf_counter() - t0, read()
    return (e1 - e0) / calls, dt * 1e3 / calls


def phase_portability(dev, card: str):
    """The paper's portability methods on the card (``[portability]``), on
    the [loop] phase's workloads in a fresh temporary journal directory:
    1. ``compare_methods_matrix`` over ``PORT_PROFILES``, each on its own
       cost model, under every policy (``check_matrix`` empty); its
       tpu_v5e and gpu_sm journals are the foreign evidence;
    2. ``compare_methods`` on the card with the [loop] phase's wall-clock
       factory and ``PORT_METHODS`` on the same directory: every workload
       must find a foreign history (else ``transfer`` is a cold Bayesian
       search), ``check_report`` empty, 0 runner failures;
    3. ``ExhaustiveSearch(prune="analytical", top_k=k)`` for each k of
       ``PORT_TOP_K`` on the same measurements (the card sweep's journal):
       ``stopped_by`` "pruned" and k evaluations where the space holds more
       than k, the winner against the full sweep's optimum; ``prune=``
       under ``policy="energy"`` must raise;
    4. a ``memory_cap`` session (half the latency winner's modeled peak
       shared memory) tuned exhaustively on the h100 cost model and
       installed as the default session: ``prefix_sum`` at n = 1024 must
       launch the capped plan and agree with float64 ``torch.cumsum``,
       the latency session still resolve its own winner;
    5. joules: where the h100 model's energy winner differs from its
       latency winner, NVML's energy counter around ``JOULE_SECONDS`` of
       back-to-back calls of each, printed beside the model's ratio (not
       gated).
    Returns the kernels' launches over the phase."""
    import shutil
    import tempfile

    import torch
    from repro_torch.core.exhaustive import ExhaustiveSearch
    from repro_torch.core.objective import (CachedObjective,
                                            CostModelObjective)
    from repro_torch.core.space import Workload, build_space
    from repro_torch.core.transfer import device_histories
    from repro_torch.evaluation import (check_matrix, check_report,
                                        compare_methods,
                                        compare_methods_matrix, format_matrix,
                                        format_report)
    from repro_torch.hw.profiles import get_profile
    from repro_torch.kernels.blocks.driver import capture_launches
    from repro_torch.kernels.blocks.plan import plan_for
    from repro_torch.kernels.scan.ops import _plan_workload, prefix_sum
    from repro_torch.launch.tune import make_suite_runner
    from repro_torch.tuning import TunerSession, set_default_session

    t_phase = time.perf_counter()
    h100 = get_profile("h100")
    wls = [wl.canonical() for wl in loop_workloads()]
    root = tempfile.mkdtemp(prefix="chip_smoke_portability_")
    journals = os.path.join(root, "journals")
    os.makedirs(journals)
    previous = None
    try:
        # 1. the device matrix on the host: every profile on its own model
        t0 = time.perf_counter()
        matrix = compare_methods_matrix(wls, profiles=PORT_PROFILES,
                                        journal_dir=journals,
                                        policies=PORT_POLICIES)
        t_matrix = time.perf_counter() - t0
        log(f"[portability] device matrix: {len(wls)} workloads x "
            f"{len(matrix['methods'])} methods x {len(PORT_PROFILES)} "
            f"profiles x {len(PORT_POLICIES)} policies on the cost models "
            f"in {t_matrix:.1f} s")
        for line in format_matrix(matrix).splitlines():
            log(f"[portability] {line}")
        log("[portability] matrix phi by policy " + json.dumps(
            {prof: {pol: {m: agg["phi"] for m, agg in per.items()}
                    for pol, per in rep["per_policy"].items()}
             for prof, rep in matrix["reports"].items()}))
        problems = check_matrix(matrix)
        if problems:
            raise AssertionError(f"[portability] device matrix: {problems}")

        # 2. measured transfer: the card's times, the foreign journals' priors
        priors = {wl.key: foreign_histories(journals, wl, h100) for wl in wls}
        for wl in wls:
            found = len(device_histories(journals, wl, h100))
            log(f"[portability] {wl.key}: {found} foreign histories "
                f"{json.dumps({src: {'entries': n, 'weight': w} for src, (n, w) in priors[wl.key].items()}, sort_keys=True)}")
            if not found or found != len(priors[wl.key]):
                raise AssertionError(f"[portability] {wl.key}: "
                                     f"{found} foreign histories "
                                     f"({priors[wl.key]}): transfer would "
                                     f"be a cold Bayesian search")
        made = []
        reset_launch_counts()
        t0 = time.perf_counter()
        report = compare_methods(wls, PORT_METHODS,
                                 objective_factory=loop_factory(dev, made),
                                 seed=0, max_evals=20, journal_dir=journals)
        t_card = time.perf_counter() - t0
        failures = sum(o.failures for o in made)
        for line in format_report(report).splitlines():
            log(f"[portability] {line}")
        log("[portability] card " + json.dumps(
            {name: {"phi": agg["phi"],
                    "evaluations": agg["total_evaluations"],
                    "mean_evals_to_optimum": agg["mean_evals_to_optimum"],
                    "optimum_rate": agg["optimum_rate"]}
             for name, agg in report["overall"].items()}))
        for row in report["workloads"]:
            picks = {m: [row["methods"][m]["evaluations"],
                         row["methods"][m]["evals_to_optimum"],
                         row["methods"][m]["slowdown"]]
                     for m in ("transfer", "bayesian")}
            log(f"[portability] {row['workload']}: sweep "
                f"{row['space_size']} configs, optimum "
                f"{row['best_time_s'] * 1e3:.4f} ms; evaluations, evals to "
                f"optimum, slowdown {json.dumps(picks)}")
        log(f"[portability] card compare_methods in {t_card:.1f} s; runner "
            f"failures: {failures}")
        problems = check_report(report)
        if problems or failures:
            raise AssertionError(f"[portability] compare_methods: "
                                 f"{problems}, runner failures {failures}")

        # 3. pruning on the same measurements (the card sweep's journal)
        measured = CachedObjective(loop_factory(dev, made)())
        optimum = {row["workload"]: row["best_time_s"]
                   for row in report["workloads"]}
        for k in PORT_TOP_K:
            effs, evals = [], 0
            for wl in wls:
                space = build_space(wl, h100)
                size = len(space.enumerate_valid())
                res = ExhaustiveSearch(journal_dir=journals,
                                       prune="analytical",
                                       top_k=k).tune(space, measured)
                ratio = res.best_time / optimum[wl.key]
                effs.append(1.0 / ratio)
                evals += res.evaluations
                log(f"[portability] prune top_k={k} {wl.key}: "
                    f"{res.evaluations} of {size} configs, stopped_by "
                    f"{res.stopped_by}, winner / optimum {ratio:.4f}")
                want = ("pruned", k) if size > k else ("exhausted", size)
                if (res.stopped_by, res.evaluations) != want:
                    raise AssertionError(f"[portability] prune top_k={k} "
                                         f"{wl.key}: {res.stopped_by}, "
                                         f"{res.evaluations} evaluations")
            log(f"[portability] prune top_k={k}: phi "
                f"{len(effs) / sum(1.0 / e for e in effs):.4f}, "
                f"{evals} evaluations")
        if measured.evaluations or failures:
            raise AssertionError(f"[portability] the pruned sweeps measured "
                                 f"{measured.evaluations} configs again")
        try:
            ExhaustiveSearch(prune="analytical", top_k=8,
                             policy="energy").tune(build_space(wls[0], h100),
                                                   CostModelObjective(h100))
        except ValueError as e:
            log(f"[portability] prune under energy raises: {e}")
        else:
            raise AssertionError("[portability] prune= under policy=energy "
                                 "did not raise")

        # 4. a memory_cap session reaching the kernel
        wl = Workload(op="scan", n=1024, batch=TOTAL_ELEMS // 1024,
                      variant="ks")
        db = os.path.join(root, "db.json")
        model = CostModelObjective(h100)
        space = build_space(wl, h100)
        latency = TunerSession(db_path=db, spec=h100)
        lat_cfg = latency.tune(wl, method="exhaustive").best_config
        cap = model(space, lat_cfg).metrics["peak_vmem_bytes"] / 2
        capped = TunerSession(db_path=db, spec=h100,
                              policy=f"memory_cap:{cap:.0f}")
        res = capped.tune(wl, method="exhaustive")
        cap_vec = model(space, res.best_config).metrics
        if res.best_config == lat_cfg or cap_vec["peak_vmem_bytes"] > cap:
            raise AssertionError(f"[portability] memory_cap winner "
                                 f"{res.best_config} {cap_vec}")
        x = torch.randn(wl.batch, wl.n, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
        previous = set_default_session(capped)
        before = launch_counts()["scan_add"]
        with capture_launches() as launched:
            y = prefix_sum(x)
        torch.cuda.synchronize()
        cfg = capped.resolve(wl)
        plan = plan_for(_plan_workload(wl, linrec=False), cfg)
        if tuple(launched) != plan.launches or \
                launch_counts()["scan_add"] == before:
            raise AssertionError(f"[portability] memory_cap prefix_sum "
                                 f"launched {launched}, plan "
                                 f"{plan.launches}")
        err = check_close(y, torch.cumsum(x.double(), dim=-1), "float32",
                          "memory_cap prefix_sum")
        lat_resolved = latency.resolve(wl)
        if lat_resolved == cfg or latency.lookup(wl) != lat_cfg:
            raise AssertionError(f"[portability] the latency session "
                                 f"resolved {lat_resolved}")
        log(f"[portability] memory_cap session ({capped.policy.key}): "
            f"winner {res.best_config} (modeled peak "
            f"{cap_vec['peak_vmem_bytes']:.0f} B, {cap_vec['time_s'] * 1e3:.4f}"
            f" ms) against latency's {lat_cfg}; prefix_sum launched "
            f"{[(l.grid, l.block_shape) for l in launched]}, max abs err vs "
            f"float64 cumsum {err:.3e}; the latency session resolves "
            f"{lat_resolved}")
        set_default_session(previous)
        previous = None
        del x, y

        # 5. joules of the energy and latency winners (printed, not gated)
        differ = []
        for wl in wls:
            space = build_space(wl, h100)
            lat = ExhaustiveSearch().tune(space, CachedObjective(model))
            en = ExhaustiveSearch(policy="energy").tune(space,
                                                        CachedObjective(model))
            if lat.best_config != en.best_config:
                differ.append((wl, space, lat.best_config, en.best_config))
        if not differ:
            log("[portability] joules: the h100 model's energy winner is its "
                "latency winner on every workload")
        else:
            read = nvml_energy_reader()
            runner = make_suite_runner(dev, seed=2)
            for wl, space, lat_cfg, en_cfg in differ:
                got = {}
                for tag, c in (("latency", lat_cfg), ("energy", en_cfg)):
                    mj, ms = joules_per_call(runner(wl, c), read,
                                             JOULE_SECONDS)
                    vec = model(space, c).metrics
                    got[tag] = {"config": c, "mJ": mj, "ms": ms,
                                "model_mJ": vec["energy_j"] * 1e3,
                                "model_ms": vec["time_s"] * 1e3}
                log(f"[portability] joules {wl.key} ({card}): "
                    f"{json.dumps(got, sort_keys=True)}; energy / latency "
                    f"measured {got['energy']['mJ'] / got['latency']['mJ']:.4f}"
                    f", modeled {got['energy']['model_mJ'] / got['latency']['model_mJ']:.4f}")
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        if previous is not None:
            set_default_session(previous)
        shutil.rmtree(root, ignore_errors=True)
    log(f"[portability] launches {counts}")
    require_launched(counts, PORT_KERNELS, "the [portability] phase")
    require_new_routes(counts, "the [portability] phase")
    log(f"[portability] {time.perf_counter() - t_phase:.1f} s (matrix "
        f"{t_matrix:.1f}, card compare {t_card:.1f}) on {card}")
    return counts


# Training (phase 17): qwen1.5-0.5b at full width through the port's loop
TRAIN_STEPS = 20
TRAIN_BATCH, TRAIN_SEQ = 8, 512        # global batch x sequence: 4096 tokens
TRAIN_VARIANT_STEPS = 3
TRAIN_VARIANTS = (("adafactor", {"optimizer": "adafactor"}),
                  ("micro_steps=2", {"micro_steps": 2}),
                  ("int8_ef", {"grad_compression": "int8_ef"}),
                  ("remat=none", {}))
TRAIN_RESTART = (8, 4, 6)     # steps, checkpoint every, injected failure at
TRAIN_GUARD_TOKENS = (1, 256)  # the guard's train steps: batch x length
TRAIN_SEED = 51


def train_config():
    """qwen1.5-0.5b as the registry holds it: 24 layers, d 1024, vocab
    151936, bf16 parameters, remat "full", use_pallas off (the plain-op
    attention: neither package has a backward for the flash kernel)."""
    from repro_torch.configs.qwen15_05b import CONFIG
    return CONFIG


def train_run(dev, model, hp, steps: int, loop_kw=None, injector=None,
              seed: int = TRAIN_SEED):
    """``run_training`` for ``steps`` steps on a fresh Batcher: (result,
    peak GiB, median step ms)."""
    import statistics

    import torch
    from repro_torch.data.pipeline import Batcher, DataConfig
    from repro_torch.train.loop import LoopConfig, run_training

    cfg = model.cfg
    data = Batcher(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH, seed=seed))
    loop = LoopConfig(total_steps=steps, log_every=1, seed=seed,
                      **(loop_kw or {}))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = run_training(model, hp, loop, data, injector=injector,
                       log=lambda _: None)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = [h["step_time_s"] * 1e3 for h in res["history"]]
    return res, peak, (statistics.median(ms) if ms else None)


def train_guard_checks(dev):
    """A backward through each of the thirteen kernels, on small CUDA inputs
    that require grad, must raise the gradient guard's error naming the
    kernel before any gradient reaches an input; so must a qwen train step
    with use_pallas (the flash kernel) and a full-width mamba2-130m one
    (the SSD chain).  Returns the kernels that raised, and for each train
    step the kernel its error named and the launches of its forward."""
    import dataclasses

    import torch
    from repro_torch.configs.mamba2_130m import CONFIG as MAMBA
    from repro_torch.kernels.attention.ops import attention
    from repro_torch.kernels.blocks.driver import apply_add, apply_linrec
    from repro_torch.kernels.blocks.plan import stage_radices
    from repro_torch.kernels.fft.kernel import fft_stockham
    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.kernels.scan.kernel import (scan_add, scan_linrec,
                                                 scan_linrec_prod)
    from repro_torch.kernels.ssd.kernel import (ssd_apply_entry, ssd_intra,
                                                ssd_state_apply)
    from repro_torch.kernels.tridiag.kernel import pcr, thomas
    from repro_torch.models.model import Model
    from repro_torch.train.step import (TrainHParams, init_train_state,
                                        make_train_step)

    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 1)

    def leaf(t):
        return t.detach().requires_grad_()

    x = leaf(torch.randn(4, 1024, generator=gen, device=dev))
    a = leaf(torch.rand(4, 1024, generator=gen, device=dev) * 0.149 + 0.85)
    y96 = leaf(torch.randn(96, 100, generator=gen, device=dev))
    p96 = leaf(torch.rand(96, 100, generator=gen, device=dev))
    e96 = leaf(torch.randn(96, 1, generator=gen, device=dev))
    planes = [leaf(t) for t in laplacian_system(gen, dev, 4, 256)]
    z = leaf(torch.randn(4, 1024, generator=gen, device=dev,
                         dtype=torch.complex64))
    sx, sa, sb, sc = (leaf(t) for t in ssd_inputs(
        gen, dev, 4, 2, 1024, 16, 8, torch.float32, False))
    with torch.no_grad():
        y_intra, a_chunk, state = ssd_intra(sx, sa, sb, sc, chunk=64)
    y_intra, a_chunk, state = (leaf(t) for t in (y_intra, a_chunk, state))
    qkv = [leaf(torch.randn(4, 1024, 64, generator=gen, device=dev)
                .to(torch.bfloat16)) for _ in range(3)]
    ma = leaf(torch.randn(1024, 1024, generator=gen, device=dev)
              .to(torch.bfloat16))
    mb = leaf(torch.randn(1024, 2816, generator=gen, device=dev)
              .to(torch.bfloat16))
    radix4 = stage_radices(1024, 4)
    calls = {
        "scan_add": (lambda: scan_add(x, rows_per_program=4, tile_n=1024,
                                      stages=radix4, unroll=2), [x]),
        "scan_linrec": (lambda: scan_linrec(a, x, rows_per_program=4,
                                            tile_n=1024, stages=radix4),
                        [a, x]),
        "scan_linrec_prod": (lambda: scan_linrec_prod(
            a, x, rows_per_program=4, stages=radix4)[1], [a, x]),
        "apply_add": (lambda: apply_add(y96, e96, rows=3), [y96, e96]),
        "apply_linrec": (lambda: apply_linrec(y96, p96, e96, rows=3),
                         [y96, p96, e96]),
        "pcr": (lambda: pcr(*planes, rows_per_program=4, unroll=1), planes),
        "thomas": (lambda: thomas(*planes), planes),
        "fft_stockham": (lambda: torch.view_as_real(fft_stockham(
            z, rows_per_program=4, stages=radix4)), [z]),
        "ssd_intra": (lambda: ssd_intra(sx, sa, sb, sc, chunk=64)[2],
                      [sx, sa, sb, sc]),
        "ssd_state_apply": (lambda: ssd_state_apply(
            y_intra, sa, sc, a_chunk, state, chunk=64),
            [y_intra, a_chunk, state]),
        "ssd_apply_entry": (lambda: ssd_apply_entry(
            y_intra, sa, sc, state, chunk=64), [y_intra, state]),
        "flash_attention": (lambda: attention(*qkv), qkv),
        "matmul": (lambda: matmul(ma, mb), [ma, mb]),
    }
    wrappers = launch_wrappers()
    named = {"kernels": []}
    for name, (call, inputs) in calls.items():
        before = wrappers[name].launches
        out = call()
        if wrappers[name].launches == before:
            raise AssertionError(f"guard check: {name} was not launched")
        if not out.requires_grad:
            raise AssertionError(f"{name}'s output is not tied to its "
                                 f"inputs: a backward would drop it")
        try:
            out.float().sum().backward()
        except RuntimeError as e:
            kname = "matmul_tiled" if name == "matmul" else name
            if f"CUDA kernel {kname}:" not in str(e):
                raise AssertionError(f"{name}: another error: {e}")
            named["kernels"].append(name)
        else:
            raise AssertionError(f"a backward through {name} did not raise")
        if any(t.grad is not None for t in inputs):
            raise AssertionError(f"{name}: a partial gradient reached an "
                                 f"input")

    def step_raises(cfg, what, want):
        model = Model(cfg, device=dev)
        hp = TrainHParams()
        state = init_train_state(model, hp,
                                 torch.Generator(device=dev).manual_seed(3))
        b, l = TRAIN_GUARD_TOKENS
        tokens = torch.randint(0, cfg.vocab, (b, l + 1), generator=gen,
                               device=dev)
        batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
                 "mask": torch.ones(b, l, device=dev)}
        reset_launch_counts()
        try:
            make_train_step(model, hp)(state, batch)
        except RuntimeError as e:
            msg = str(e)
            hit = [k for k in want if f"CUDA kernel {k}:" in msg]
            if not hit:
                raise AssertionError(f"{what}: another error: {msg}")
            launched = {k: v for k, v in launch_counts().items()
                        if "." not in k and v}
            if any(p.grad is not None for p in model.parameters()):
                raise AssertionError(f"{what}: partial gradients were left "
                                     f"on the parameters")
            named[what] = {"named": hit[0], "launched": launched}
        else:
            raise AssertionError(f"{what}: a train step through the kernels "
                                 f"did not raise")
        del model, state
        torch.cuda.empty_cache()

    step_raises(dataclasses.replace(train_config(), use_pallas=True),
                "qwen1.5-0.5b use_pallas", ("flash_attention",))
    step_raises(MAMBA, "mamba2-130m", ("ssd_intra", "ssd_state_apply",
                                       "ssd_apply_entry", "scan_linrec"))
    return named


def phase_train(dev):
    """Training on the card (``[train]``): ``run_training`` on
    qwen1.5-0.5b at full width and depth for TRAIN_STEPS steps (AdamW,
    warmup 2, Batcher 8 x 512), losses finite and the mean of the last
    three below the first three's, the median step, tokens/s and peak
    memory, one step under torch.profiler; three steps each of Adafactor,
    two micro steps, int8 error feedback and remat "none" beside it; a
    restart at full width (a checkpoint every 4 steps, a failure injected
    at step 6: the second run resumes at 4 and ends at 8, the restored bf16
    params bit-equal to the saved ones); one reduced f32 train step on the
    card against the CPU (loss and grad norm at DTYPE_TOL); the packing's
    input scan on the card (``scan_add`` launched, offsets bit-equal to the
    plain version's); the gradient guard (``train_guard_checks``).
    Returns the train path's launch counts."""
    import dataclasses
    import math as _math
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.data.pipeline import (Batcher, DataConfig,
                                           SyntheticCorpus, pack_documents)
    from repro_torch.models.model import Model, build_model
    from repro_torch.optim.tree import flatten_with_path, tree_map
    from repro_torch.train import loop as train_loop
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault import FaultInjector
    from repro_torch.train.step import (TrainHParams, init_train_state,
                                        make_train_step)

    t_phase = time.perf_counter()
    cfg = train_config()
    if cfg.remat != "full" or cfg.use_pallas:
        raise AssertionError(f"{cfg.arch}: remat {cfg.remat!r}, use_pallas "
                             f"{cfg.use_pallas}: not the JAX defaults")
    hp = TrainHParams(peak_lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    tokens_step = TRAIN_BATCH * TRAIN_SEQ
    out = {}

    # the main run
    model = build_model(cfg, device=dev)
    reset_launch_counts()
    res, peak, med = train_run(dev, model, hp, TRAIN_STEPS)
    counts = launch_counts()
    losses = [h["loss"] for h in res["history"]]
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    out["main"] = {"arch": cfg.arch, "steps": len(losses),
                   "tokens_per_step": tokens_step, "median_step_ms": med,
                   "tokens_per_s": tokens_step / (med / 1e3),
                   "peak_gib": peak, "first3": first, "last3": last,
                   "losses": losses,
                   "grad_norms": [h["grad_norm"] for h in res["history"]],
                   "step_ms": [h["step_time_s"] * 1e3
                               for h in res["history"]]}
    log(f"[train] {cfg.arch} {json.dumps(out['main'], sort_keys=True)}")
    if len(losses) != TRAIN_STEPS \
            or not all(_math.isfinite(v) for v in losses) \
            or not last < first:
        raise AssertionError(f"[train] the loss did not fall: first three "
                             f"{first}, last three {last}: {losses}")

    # one step under the profiler (two steps: a warm-up, then the window)
    step = make_train_step(model, hp)
    box = [res["state"]]
    data = iter(Batcher(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH,
                                   seed=TRAIN_SEED)))

    def one_step():
        box[0], metrics = step(box[0], next(data))
        float(metrics["loss"])

    out["trace"] = trace_call(one_step, f"{cfg.arch} train step")
    del res, box, step
    torch.cuda.empty_cache()

    # the variants, three steps each (weights redrawn from the seed); the
    # model without remat is built last
    out["variants"] = {}
    for name, kw in TRAIN_VARIANTS:
        if name == "remat=none":
            del model
            torch.cuda.empty_cache()
            model = build_model(dataclasses.replace(cfg, remat="none"),
                                device=dev)
        res, peak, med = train_run(dev, model, dataclasses.replace(hp, **kw),
                                   TRAIN_VARIANT_STEPS)
        vlosses = [h["loss"] for h in res["history"]]
        out["variants"][name] = {"median_step_ms": med, "peak_gib": peak,
                                 "losses": vlosses}
        if not all(_math.isfinite(v) for v in vlosses):
            raise AssertionError(f"[train] {name}: losses {vlosses}")
        del res
        torch.cuda.empty_cache()
    log(f"[train] variants ({TRAIN_VARIANT_STEPS} steps each) beside the "
        f"main run's {out['main']['median_step_ms']:.1f} ms / "
        f"{out['main']['peak_gib']:.2f} GiB: "
        f"{json.dumps(out['variants'], sort_keys=True)}")
    del model
    torch.cuda.empty_cache()

    # the restart at full width: what the first run saved at step 4 and
    # what the second restored, read on the manager itself
    steps, every, fail_at = TRAIN_RESTART
    saved, restored = {}, {}

    class Recording(CheckpointManager):
        def save(self, step, state):
            if step not in saved:
                saved[step] = {k: v.detach().cpu().clone() for k, v
                               in flatten_with_path(state["params"])}
            super().save(step, state)

        def restore(self, step, like, **kw):
            got = super().restore(step, like, **kw)
            restored[step] = {k: v.detach().cpu() for k, v
                              in flatten_with_path(got["params"])}
            return got

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    real = train_loop.CheckpointManager
    train_loop.CheckpointManager = Recording
    try:
        loop_kw = dict(checkpoint_dir=tmp, checkpoint_every=every,
                       keep_last=1)
        injector = FaultInjector((fail_at,))
        t0 = time.perf_counter()
        try:
            train_run(dev, build_model(cfg, device=dev), hp, steps, loop_kw,
                      injector)
        except RuntimeError as e:
            if "injected node failure" not in str(e):
                raise
        else:
            raise AssertionError("[train] the injected failure did not fire")
        first_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res, peak, med = train_run(dev, build_model(cfg, device=dev), hp,
                                   steps, loop_kw, injector)
        second_s = time.perf_counter() - t0
        latest = CheckpointManager(tmp).latest_step()
    finally:
        train_loop.CheckpointManager = real
        shutil.rmtree(tmp, ignore_errors=True)
    resumed = res["resumed_from"]
    unequal = {k: int((v.view(torch.int16) != restored[every][k]
                       .view(torch.int16)).sum())
               for k, v in saved[every].items()} \
        if every in saved and every in restored else None
    out["restart"] = {"steps": steps, "checkpoint_every": every,
                      "failed_at": fail_at, "resumed_from": resumed,
                      "last_step": res["history"][-1]["step"],
                      "latest_checkpoint": latest,
                      "first_run_s": first_s, "second_run_s": second_s,
                      "second_median_step_ms": med,
                      "param_leaves": len(saved.get(every, {})),
                      "params_not_bit_equal": unequal}
    log(f"[train] restart {json.dumps(out['restart'], sort_keys=True)}")
    if resumed != every or res["history"][-1]["step"] != steps - 1 \
            or latest != steps or unequal is None or any(unequal.values()) \
            or any(v.dtype != torch.bfloat16
                   for v in saved[every].values()):
        raise AssertionError(f"[train] the restart failed: "
                             f"{out['restart']}")
    del res
    torch.cuda.empty_cache()

    # one reduced f32 step on the card against the CPU
    rcfg = cfg.reduced()
    rhp = TrainHParams(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    cpu_model = Model.init(rcfg, torch.Generator().manual_seed(TRAIN_SEED),
                           device="cpu")
    cpu_state = init_train_state(cpu_model, rhp)
    card_state = tree_map(lambda t: t.to(dev), cpu_state)
    batch = next(Batcher(DataConfig(vocab=rcfg.vocab, seq_len=64,
                                    global_batch=4, seed=TRAIN_SEED)))
    _, m_cpu = make_train_step(cpu_model, rhp)(cpu_state, batch)
    _, m_card = make_train_step(Model(rcfg, device=dev), rhp)(card_state,
                                                              batch)
    out["card_vs_cpu"] = {k: {"card": float(m_card[k]),
                              "cpu": float(m_cpu[k]),
                              "err": check_close(m_card[k].cpu(), m_cpu[k],
                                                 "float32",
                                                 f"reduced train step {k}, "
                                                 f"card against CPU")}
                          for k in ("loss", "grad_norm")}
    log(f"[train] reduced f32 step, card against CPU (DTYPE_TOL): "
        f"{json.dumps(out['card_vs_cpu'], sort_keys=True)}")

    # the packing's prefix sum on the card: kernel 1
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=TRAIN_SEED)
    reset_launch_counts()
    got = pack_documents(SyntheticCorpus(dcfg).documents(), TRAIN_SEQ,
                         TRAIN_BATCH, use_kernel_scan=True, device=dev)
    scan_counts = launch_counts()
    want = pack_documents(SyntheticCorpus(dcfg).documents(), TRAIN_SEQ,
                          TRAIN_BATCH)
    same = all(np.array_equal(g, w) and g.dtype == w.dtype
               for g, w in zip(got, want))
    out["input_scan"] = {"documents": int(got[2].shape[0]),
                         "scan_add": scan_counts["scan_add"],
                         "bit_equal": same}
    log(f"[train] input scan {json.dumps(out['input_scan'])}")
    if not same or scan_counts["scan_add"] == 0:
        raise AssertionError(f"[train] the input scan: {out['input_scan']}")
    counts = {k: counts[k] + scan_counts[k] for k in counts}

    out["guard"] = train_guard_checks(dev)
    log(f"[train] gradient guard: {json.dumps(out['guard'], sort_keys=True)}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[train] {out['seconds']:.1f} s")
    return counts


DRYRUN_CELLS = (("qwen1.5-0.5b", "train_4k"), ("mamba2-130m", "prefill_32k"))
DRYRUN_BATCH, DRYRUN_LEN = 8, 2048     # the prefill held to the card
DRYRUN_REPS = 3
DECODE_STEPS = 20

# The examples (phase 19): examples_torch/*.py, each through its main()
EXAMPLES = os.path.join(ROOT, "examples_torch")
# train_lm at the 100M preset and the example's own defaults (200 steps
# of 8 x 128 tokens: about 15 s on the card)
EXAMPLES_TRAIN = ["--preset", "100m", "--batch", "8", "--seq", "128"]


def call_example(name: str, argv, entry: str):
    """examples_torch/<name>.py's ``main(argv)`` in this process: its exit
    code, and what the function it runs (``entry``) returned."""
    import importlib
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    module = importlib.import_module(name)
    inner, results = getattr(module, entry), []

    def capture(*args, **kwargs):
        results.append(inner(*args, **kwargs))
        return results[-1]

    setattr(module, entry, capture)
    try:
        rc = module.main(argv)
    finally:
        setattr(module, entry, inner)
    if rc != 0 or len(results) != 1:
        raise AssertionError(f"[examples] {name}: main returned {rc} after "
                             f"{len(results)} call(s) of {entry}")
    return results[0]


def phase_examples(dev):
    """The five examples on the card through their ``main`` at their
    defaults (train_lm at the 100M preset, EXAMPLES_TRAIN), each gated:
    quickstart's tuned and radix-4 scans within DTYPE_TOL of a float64
    cumsum, ``scan_add`` launched; autotune_kernels' Phi <= 1 in every
    row and no runner failure (no time at PENALTY_TIME); serve_lm's ten
    requests done with the greedy tokens of a ``ReferenceEngine`` on the
    same model; train_lm's recorded losses finite and falling (the mean
    of the last three below the first three's), its newest checkpoint
    restored equal to its final state; fault_tolerant_train dead at step
    17, resumed from 10, finished at 29.  Prints each example's seconds
    and launches by kernel, and the 100M run's median step, tokens/s and
    peak memory.  Returns the launches of all five."""
    import shutil
    import statistics
    import tempfile

    import torch
    from repro_torch.core import PENALTY_TIME
    from repro_torch.optim.tree import flatten_with_path
    from repro_torch.serve.reference import ReferenceEngine
    from repro_torch.train.checkpoint import CheckpointManager

    total = dict.fromkeys(launch_counts(), 0)
    seconds = {}

    def run(name, argv, entry):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = call_example(name, argv, entry)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        counts = launch_counts()
        for k, v in counts.items():
            total[k] += v
        log(f"[examples] {name}: {seconds[name]:.1f} s, launches "
            f"{json.dumps({k: v for k, v in counts.items() if v})}")
        return res, counts

    res, counts = run("quickstart", [], "run")
    want = torch.cumsum(res["x"].double(), dim=-1)
    errs = {what: check_close(res[what], want, "float32",
                              f"[examples] quickstart {what}")
            for what in ("y", "y4")}
    require_launched(counts, ("scan_add",), "quickstart")
    log(f"[examples] quickstart: config {res['config']}, max abs err vs "
        f"float64 cumsum {json.dumps(errs)}")

    res, _ = run("autotune_kernels", [], "run")
    bad = {row: v for row, v in res["phi"].items()
           if not (v["analytical"] <= 1.0 and v["bayesian"] <= 1.0)}
    failed = [key for key, methods in res["runs"].items()
              for m in methods.values() if not m["time_s"] < PENALTY_TIME]
    if bad or failed or len(res["runs"]) != 20:
        raise AssertionError(f"[examples] autotune_kernels: Phi above 1 "
                             f"{bad}, runner failures {failed}, "
                             f"{len(res['runs'])} sizes")
    log(f"[examples] autotune_kernels Phi: {json.dumps(res['phi'])}")

    res, _ = run("serve_lm", [], "run")
    ref = ReferenceEngine(res["model"], max_batch=4, max_len=128)
    for prompt, new in sys.modules["serve_lm"].requests(
            res["model"].cfg.vocab):
        ref.submit(prompt, max_new_tokens=new)
    want = {r.rid: list(r.output) for r in ref.run()}
    got = {r.rid: list(r.output) for r in res["done"]}
    if len(got) != 10 or got != want:
        raise AssertionError(f"[examples] serve_lm: {len(got)} requests "
                             f"done; tokens {got} against the reference "
                             f"engine's {want}")
    log(f"[examples] serve_lm: {res['tokens']} tokens in "
        f"{res['seconds']:.2f} s, equal to the reference engine's; tuner "
        f"{res['tuner']['state']}, {res['tuner']['measured']} trial "
        f"measurements")
    del res, ref

    ckpt = tempfile.mkdtemp(prefix="examples_train_lm_")
    try:
        torch.cuda.reset_peak_memory_stats()
        res, _ = run("train_lm", EXAMPLES_TRAIN + ["--ckpt", ckpt], "train")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        hist = res["history"]
        losses = [h["loss"] for h in hist]
        first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
        if not (all(math.isfinite(v) for v in losses) and last < first):
            raise AssertionError(f"[examples] train_lm: losses {losses}")
        steps = CheckpointManager(ckpt).all_steps()
        step, restored = CheckpointManager(ckpt).restore_latest(
            res["state"], device=dev)
        unequal = sum(int((a != b).sum()) for (_, a), (_, b) in zip(
            flatten_with_path(res["state"]["params"]),
            flatten_with_path(restored["params"]))) if restored else None
        if not steps or unequal != 0:
            raise AssertionError(f"[examples] train_lm: checkpoints {steps}, "
                                 f"restored step {step}, {unequal} parameter "
                                 f"elements unequal")
        # the loop records every tenth step's time (and the last's); the
        # first step's holds the allocator's first blocks
        med = statistics.median(h["step_time_s"] for h in hist[1:])
        tokens = 8 * 128                   # EXAMPLES_TRAIN's batch x seq
        stats = {"steps": hist[-1]["step"] + 1, "losses": losses,
                 "first3": first, "last3": last,
                 "median_step_ms": med * 1e3, "tokens_per_s": tokens / med,
                 "peak_gib": peak, "checkpoints": steps,
                 "restored_step": step,
                 "parameters": sum(p.numel() for _, p in flatten_with_path(
                     res["state"]["params"]))}
        log(f"[examples] train_lm 100m: {json.dumps(stats)}")
        del res, restored
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    ckpt = tempfile.mkdtemp(prefix="examples_fault_")
    try:
        res, _ = run("fault_tolerant_train", ["--ckpt", ckpt], "run")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    last = res["history"][-1]["step"]
    if res["died"] != "injected node failure at step 17" \
            or res["resumed_from"] != 10 or last != 29:
        raise AssertionError(f"[examples] fault_tolerant_train: died "
                             f"{res['died']!r}, resumed from "
                             f"{res['resumed_from']}, last step {last}")
    log(f"[examples] seconds {json.dumps(seconds)}; launches "
        f"{json.dumps({k: v for k, v in total.items() if v})}")
    torch.cuda.empty_cache()
    return total


def _gib(n) -> str:
    return f"{n / 2**30:.3f} GiB"


def dryrun_production_cells():
    """(a) The production cells on this host: the (16, 16) mesh over a
    fake world of 256 ranks, nothing on the card."""
    import math as _math

    from repro_torch.launch.roofline import analyze_cell

    hbm = 80 * 2 ** 30
    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = analyze_cell(arch, shape, profile="h100")
        secs = time.perf_counter() - t0
        if rec["status"] != "ok":
            raise AssertionError(f"[dryrun] {arch}|{shape}: {rec}")
        pd, terms, coll = rec["per_device"], rec["roofline"], \
            rec["collectives"]
        log(f"[dryrun] {arch}|{shape}|16x16 (h100): per device argument "
            f"{_gib(pd['argument_bytes'])}, temp {_gib(pd['temp_bytes'])}, "
            f"peak {_gib(pd['peak_bytes'])} of {_gib(hbm)}; flops "
            f"{rec['flops']:.4e}, bytes {rec['bytes_accessed']:.4e}; "
            f"collectives {coll['count_by_kind']} wire bytes "
            f"{ {k: round(v) for k, v in coll['per_kind'].items()} }; "
            f"terms {terms}, dominant {rec['dominant']}, mfu_upper_bound "
            f"{rec['mfu_upper_bound']:.4f}, useful_flops_ratio "
            f"{rec['useful_flops_ratio']:.4f}; fallbacks "
            f"{rec['sharding_fallbacks']}; lower {rec['lower_s']} s, step "
            f"{rec['compile_s']} s, {secs:.1f} s in all")
        if not all(_math.isfinite(v) and v > 0 for v in terms.values()):
            raise AssertionError(f"[dryrun] {arch}|{shape} terms {terms}")
        if shape.startswith("train") and not (
                coll["count_by_kind"].get("all-gather", 0) > 0
                and coll["count_by_kind"].get("reduce-scatter", 0) > 0):
            raise AssertionError(f"[dryrun] {arch}|{shape}: FSDP's "
                                 f"collectives missing: {coll}")


def phase_dryrun(dev):
    """(a) the production cells; (b) the dry-run of qwen1.5-0.5b's 8 x
    2048 prefill on this card's (1, 1) host mesh, held to the same prefill
    run for real, plain and flash.  Returns kernel 11's launch counts in
    the flash run."""
    import dataclasses
    import statistics

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.qwen15_05b import CONFIG
    from repro_torch.launch.mesh import make_host_mesh, release_world
    from repro_torch.launch.roofline import analyze_cell
    from repro_torch.models.model import Model
    from repro_torch.train.step import make_prefill_step

    t0 = time.perf_counter()
    dryrun_production_cells()
    log(f"[dryrun] production cells {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    shape = ShapeConfig(f"prefill_{DRYRUN_BATCH}x{DRYRUN_LEN}", DRYRUN_LEN,
                        DRYRUN_BATCH, "prefill")
    mesh = make_host_mesh()
    log(f"[dryrun] host mesh: {mesh}")
    try:
        rec = analyze_cell(CONFIG.arch, shape.name, arch_cfg=CONFIG,
                           profile="h100", mesh=mesh, shape=shape)
    finally:
        release_world()
    if rec["status"] != "ok":
        raise AssertionError(f"[dryrun] host-mesh cell: {rec}")
    pd, cost = rec["per_device"], rec["op_cost"]
    bound_s = rec["step_time_bound_s"]
    log(f"[dryrun] {CONFIG.arch}|{shape.name}|{rec['mesh']} predicted: "
        f"argument {pd['argument_bytes']} B, temp {pd['temp_bytes']} B, "
        f"peak {pd['peak_bytes']} B; flops {cost['flops']:.6e}, dot flops "
        f"{cost['dot_flops']:.6e} in {int(cost['dot_count'])} dots; terms "
        f"{rec['roofline']}, bound {bound_s * 1e3:.3f} ms; lower "
        f"{rec['lower_s']} s, step {rec['compile_s']} s, "
        f"{time.perf_counter() - t0:.1f} s in all")

    # the same cell for real: the config the dry-run ran (its mesh hints,
    # so the one-hot embedding too), random weights on the card
    cfg = dataclasses.replace(CONFIG, batch_axes=("data",), batch_shards=1,
                              model_axis_size=1)
    gen = torch.Generator(device=dev).manual_seed(61)
    model = Model.init(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (DRYRUN_BATCH, DRYRUN_LEN),
                           generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": tokens}
    real_args = sum(p.numel() * p.element_size()
                    for p in model.parameters()) \
        + tokens.numel() * tokens.element_size()
    log(f"[dryrun] argument bytes predicted {pd['argument_bytes']}, on the "
        f"card {real_args}")
    if pd["argument_bytes"] != real_args:
        raise AssertionError("[dryrun] predicted argument bytes differ from "
                             "the card's")
    step = make_prefill_step(model)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as fc:
        plain = step(batch)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    counted = fc.get_total_flops()
    log(f"[dryrun] dot flops predicted {int(cost['dot_flops'])}, "
        f"FlopCounterMode on the card {counted}")
    if int(cost["dot_flops"]) != counted:
        raise AssertionError("[dryrun] predicted dot flops differ from the "
                             "card's count")
    log(f"[dryrun] peak memory above the arguments: predicted "
        f"{_gib(pd['temp_bytes'])}, measured {_gib(measured)} (ratio "
        f"{pd['temp_bytes'] / measured:.4f}); whole peak predicted "
        f"{_gib(pd['peak_bytes'])}, measured {_gib(real_args + measured)} "
        f"(the arguments plus the peak above them; ratio "
        f"{pd['peak_bytes'] / (real_args + measured):.4f}); earlier phases "
        f"leave {base - real_args} B allocated beside the arguments")

    def median_ms(fn):
        fn()
        times = []
        for _ in range(DRYRUN_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    plain_ms = median_ms(lambda: step(batch))
    model.cfg = dataclasses.replace(cfg, use_pallas=True)
    reset_launch_counts()
    flash = step(batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"[dryrun] the flash prefill launched kernel 11 "
                             f"{counts['flash_attention']} times, not once a "
                             f"layer ({cfg.n_layers})")
    flash_ms = median_ms(lambda: step(batch))
    model.cfg = cfg
    scale = float(plain.abs().max())
    rel = float((flash - plain).abs().max()) / scale
    finite = bool(torch.isfinite(plain).all() and torch.isfinite(flash).all())
    log(f"[dryrun] last-position logits {tuple(plain.shape)}: flash vs "
        f"plain max |diff| / max |logits| {rel:.3e} (bound "
        f"{DENSE_LOGITS_TOL}), finite {finite}; kernel 11 launched "
        f"{counts['flash_attention']} times "
        f"({counts['flash_attention.wgmma']} wgmma)")
    if not (finite and rel < DENSE_LOGITS_TOL
            and tuple(plain.shape) == (DRYRUN_BATCH, cfg.vocab)):
        raise AssertionError(f"[dryrun] flash prefill off the plain one by "
                             f"{rel:.3e}")
    log(f"[dryrun] median of {DRYRUN_REPS}: plain {plain_ms:.3f} ms, flash "
        f"{flash_ms:.3f} ms; roofline bound (h100) {bound_s * 1e3:.3f} ms: "
        f"bound / time {bound_s * 1e3 / plain_ms:.4f} plain, "
        f"{bound_s * 1e3 / flash_ms:.4f} flash")
    del plain, flash
    model.cfg = CONFIG
    time_cache_write(dev, model)
    del model
    torch.cuda.empty_cache()
    return counts


def _scatter_write(cache, slot, value):
    """The decode's cache write as a clone and an index_put, the form the
    model's select (``models.attention._write_slot``) is timed against."""
    import torch
    out = cache.clone()
    out[torch.arange(cache.shape[0], device=cache.device), slot] = value
    return out


def time_cache_write(dev, model):
    """qwen1.5-0.5b's decode step at the dry-run's batch over a cache of the
    dry-run's length, with the model's cache write (a select against the
    slot's one-hot) and with a clone and index_put in its place: the same
    logits and cache, and the mean time of DECODE_STEPS steps, in the order
    select, scatter, scatter, select."""
    import torch

    from repro_torch.models import attention
    from repro_torch.train.step import make_decode_step

    step = make_decode_step(model)
    cache = model.init_cache(DRYRUN_BATCH, DRYRUN_LEN)
    gen = torch.Generator(device=dev).manual_seed(62)
    for c in cache:
        for t in c.values():
            if t.is_floating_point():
                t.normal_(generator=gen)
    token = torch.randint(0, model.cfg.vocab, (DRYRUN_BATCH, 1),
                          generator=gen, device=dev, dtype=torch.int32)
    pos = torch.randint(0, DRYRUN_LEN, (DRYRUN_BATCH, 1), generator=gen,
                        device=dev, dtype=torch.int32)
    select = attention._write_slot

    def run(write):
        attention._write_slot = write
        try:
            return step(token, cache, pos)
        finally:
            attention._write_slot = select

    (a, ca), (b, cb) = run(select), run(_scatter_write)
    same = torch.equal(a, b) and all(
        torch.equal(x[k], y[k]) for x, y in zip(ca, cb) for k in x)
    del ca, cb
    if not same:
        raise AssertionError("[dryrun] the decode's select and scatter "
                             "cache writes differ")
    times = {"select": [], "scatter": []}
    for form in ("select", "scatter", "scatter", "select"):
        write = select if form == "select" else _scatter_write
        times[form].append(time_ms(lambda: run(write), DECODE_STEPS))
    sel, sca = (sum(times[f]) / 2 for f in ("select", "scatter"))
    log(f"[dryrun] decode {DRYRUN_BATCH} x 1 over {DRYRUN_LEN} slots, mean "
        f"of {DECODE_STEPS} steps: select {times['select']} ms, clone + "
        f"index_put {times['scatter']} ms; select / scatter "
        f"{sel / sca:.4f}; logits and cache equal")


def add_model_launches(entries, model_runs, model_shapes):
    """The kernels line's model paths: kernel 11 in every arch's forward
    (encoder and cross-attention layers included), kernels 2, 3 and 5 in
    the recurrentgemma-9b forward (0 where its plan is one pass), by arch,
    added to each kernel's launches and routes."""
    for entry in entries:
        name = entry["name"]
        if name not in ("flash_attention", "scan_linrec", "scan_linrec_prod",
                        "apply_linrec"):
            continue
        per_arch = {arch: run["counts"][name]
                    for arch, run in model_runs.items()
                    if run["counts"][name]
                    or (name != "flash_attention"
                        and run["family"] == "hybrid")}
        n = sum(per_arch.values())
        entry["launches_by_model"] = per_arch
        entry["launches_by_path"]["models"] = n
        entry["launches"] += n
        routes = {r: sum(run["counts"][f"{name}.{r}"]
                         for run in model_runs.values())
                  for r in LAUNCH_ROUTES.get(name, ())}
        if name == "flash_attention":
            entry["launches_by_route"]["models"] = routes
            entry["model_shapes"] = model_shapes
        else:
            for route, k in routes.items():
                entry["launches_by_route"][route] += k


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build, check the kernels, run [analysis] and "
                         "[differential] only")
    ap.add_argument("--cusparse", metavar="CASES",
                    help=argparse.SUPPRESS)   # the cuSPARSE phase's child
    args = ap.parse_args(argv)
    if args.cusparse:
        lib, path = cusparse_library()     # before torch: see its note
        load_port()
        cusparse_probe(lib, path, json.loads(args.cusparse))
        return 0

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}: run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    load_port()
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
    errs = phase_linrec_kernels(dev, args.quick)
    thomas_kernel_check(dev)
    fft_err = phase_fft_kernels(dev, args.quick)
    ssd_errs = phase_ssd_kernels(dev, args.quick)
    kernel_errs = {"flash": phase_attention_kernels(dev, args.quick),
                   "matmul": phase_matmul_kernels(dev, args.quick)}
    log(f"[kernels] {time.perf_counter() - t0:.1f} s")
    phase_analysis()
    t0 = time.perf_counter()
    diff_counts = phase_differential(dev)
    log(f"[differential] {time.perf_counter() - t0:.1f} s")
    if not args.quick:
        from repro_torch.hw.profiles import get_profile
        bandwidth = get_profile("h100").hbm_bandwidth
        t0 = time.perf_counter()
        inputs, runs, counts = phase_main_path(dev)
        log(f"[main] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        entries, _ = phase_numbers(dev, inputs, runs, counts, bandwidth)
        log(f"[numbers] {time.perf_counter() - t0:.1f} s")
        del inputs
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        systems, recs, plans, counts = phase_tridiag_path(dev)
        log(f"[main] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        more, _ = phase_tridiag_numbers(dev, systems, recs, plans, counts,
                                        errs, bandwidth)
        entries += more
        log(f"[numbers] {time.perf_counter() - t0:.1f} s")
        del systems, recs
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ffts, runs, counts = phase_fft_path(dev)
        log(f"[main] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        fft_entries, _ = phase_fft_numbers(dev, ffts, runs, counts, fft_err,
                                           bandwidth)
        entries += fft_entries
        log(f"[numbers] {time.perf_counter() - t0:.1f} s")
        del ffts
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ssd_run = phase_ssd_path(dev)
        log(f"[ssd] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ssd_entries, _ = phase_ssd_numbers(dev, ssd_run, ssd_errs, bandwidth)
        log(f"[numbers] {time.perf_counter() - t0:.1f} s")
        ssd_counts = ssd_run["counts"]
        del ssd_run
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rglru_counts, _, _ = phase_rglru_path(dev)
        log(f"[rglru] {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        # kernels 2, 3 and 5 run on three paths: the linear recurrence and
        # tridiagonal solvers, SSD phase B and the RG-LRU
        for entry in entries:
            name = entry["name"]
            if name in ("scan_linrec", "scan_linrec_prod", "apply_linrec"):
                paths = {"linrec/tridiag": entry["launches"],
                         "ssd": ssd_counts[name],
                         "rglru": rglru_counts[name]}
                entry["launches_by_path"] = paths
                entry["launches"] = sum(paths.values())
            if name in ("scan_linrec", "scan_linrec_prod"):
                for route in LAUNCH_ROUTES[name]:
                    entry["launches_by_route"][route] += \
                        ssd_counts[f"{name}.{route}"] \
                        + rglru_counts[f"{name}.{route}"]
        entries += ssd_entries
        t0 = time.perf_counter()
        dense = phase_dense_path(dev)
        log(f"[dense] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_dense_numbers(dev, dense)
        log(f"[numbers] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_trace(dev, dense)
        log(f"[trace] {time.perf_counter() - t0:.1f} s")
        dense_counts = dense["counts"]
        del dense
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mamba_counts, _ = phase_mamba_model(dev, bandwidth)
        log(f"[mamba] {time.perf_counter() - t0:.1f} s")
        # kernels 8 and 9 run on two main paths: the SSD block and op, and
        # the mamba2-130m forward (kernel 9 where its chunks are fused)
        for entry in entries:
            name = entry["name"]
            if name in ("ssd_intra", "ssd_state_apply"):
                paths = {"ssd": entry["launches"],
                         "mamba2 forward": mamba_counts[name]}
                entry["launches_by_path"] = paths
                entry["launches"] = sum(paths.values())
                for route in LAUNCH_ROUTES[name]:
                    entry["launches_by_route"][route] += \
                        mamba_counts[f"{name}.{route}"]
        t0 = time.perf_counter()
        model_runs, model_shapes = phase_models(dev)
        log(f"[models] {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase_long_carry(dev)
        log(f"[long] {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        mm = phase_matmul_path(dev)
        t0 = time.perf_counter()
        _, loop_counts = phase_loop(dev)
        log(f"[loop] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ml_counts = phase_ml(dev)
        log(f"[ml] {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        phase_serve(dev)
        torch.cuda.empty_cache()
        port_counts = phase_portability(dev, card)
        torch.cuda.empty_cache()
        train_counts = phase_train(dev)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dryrun_counts = phase_dryrun(dev)
        log(f"[dryrun] {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        example_counts = phase_examples(dev)
        log(f"[examples] {time.perf_counter() - t0:.1f} s")
        # the SSD kernels' launches in the tuning loop, apart from the
        # main paths', by route
        for entry in entries:
            if entry["name"].startswith("ssd_"):
                entry["launches_loop"] = {
                    r: loop_counts[f"{entry['name']}.{r}"]
                    for r in LAUNCH_ROUTES[entry["name"]]}
        t0 = time.perf_counter()
        entries += phase_attention_matmul_numbers(
            dev, dense_counts, mm, loop_counts, kernel_errs, bandwidth)
        log(f"[numbers] {time.perf_counter() - t0:.1f} s")
        add_model_launches(entries, model_runs, model_shapes)
        # every kernel's launches in the [ml] sweeps, apart from the main
        # paths', by route where it has routes
        for entry in entries:
            name = entry["name"]
            entry["launches_ml"] = ml_counts[name]
            if name in LAUNCH_ROUTES:
                entry["launches_ml_by_route"] = {
                    r: ml_counts[f"{name}.{r}"] for r in LAUNCH_ROUTES[name]}
        # and in the [portability] phase (its measured sweep, the
        # memory_cap session's prefix_sum, the joule readings)
        for entry in entries:
            name = entry["name"]
            entry["launches_portability"] = port_counts[name]
            if name in LAUNCH_ROUTES:
                entry["launches_portability_by_route"] = {
                    r: port_counts[f"{name}.{r}"] for r in LAUNCH_ROUTES[name]}
        # and in the differential table's cases (phase 9b), apart from the
        # main paths', by route where it has routes
        for entry in entries:
            name = entry["name"]
            entry["launches_differential"] = diff_counts[name]
            if name in LAUNCH_ROUTES:
                entry["launches_differential_by_route"] = {
                    r: diff_counts[f"{name}.{r}"] for r in LAUNCH_ROUTES[name]}
        # and on the train path (the packing's input scan: kernel 1)
        for entry in entries:
            name = entry["name"]
            n = train_counts[name]
            entry["launches_train"] = n
            if n:
                entry.setdefault("launches_by_path",
                                 {"main": entry["launches"]})["train"] = n
                entry["launches"] += n
                for route in LAUNCH_ROUTES.get(name, ()):
                    entry["launches_by_route"][route] += \
                        train_counts[f"{name}.{route}"]
        # and in the examples
        for entry in entries:
            name = entry["name"]
            n = example_counts[name]
            entry["launches_examples"] = n
            if n:
                entry.setdefault("launches_by_path",
                                 {"main": entry["launches"]})["examples"] = n
                entry["launches"] += n
                for route in LAUNCH_ROUTES.get(name, ()):
                    entry["launches_by_route"][route] += \
                        example_counts[f"{name}.{route}"]
        # and kernel 11 in the dry-run's flash prefill
        for entry in entries:
            if entry["name"] == "flash_attention":
                n = dryrun_counts["flash_attention"]
                entry["launches_by_path"]["dryrun"] = n
                entry["launches_by_route"]["dryrun"] = {
                    r: dryrun_counts[f"flash_attention.{r}"]
                    for r in LAUNCH_ROUTES["flash_attention"]}
                entry["launches"] += n
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
