"""Serving CLI: batched requests through the continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --requests 8 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --reduced --device cpu          # the plain versions, on the CPU

The named arch runs at its full width on the card (``--device cuda``, the
default; an error without CUDA), or at ``--reduced`` width, with weights
drawn by ``Model.init`` from a seeded generator.

Online tuning against live traffic:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --requests 32 --online-tune --tune-op attention --tune-budget 24 \\
      --record-trace artifacts/serve_trace.jsonl

``--online-tune`` attaches a :class:`repro_torch.tuning.OnlineTuner` to
the engine's step-timing hooks: decode steps are wall-clock timed,
candidate configs run as shadowed trials (guard-banded, rolled back on
slowdown), and a promoted winner is persisted to the TuningDB.
``--record-trace`` writes every (config, step latency) pair to a JSONL
trace that ``python -m repro_torch.launch.tune online-replay`` can replay
deterministically; on its own it records PASSIVELY (the resolved
incumbent config, no trials) — combine with ``--online-tune`` to capture
trial coverage.  The port of ``repro.launch.serve``.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.space import Workload
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeEngine
from repro_torch.tuning import default_session, resolve_device
from repro_torch.tuning.online import (OnlineTuner, TraceRecorder, attach,
                                       warm_tuner)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="max tokens per prefill call (power-of-two chunks, "
                         "as in the JAX engine)")
    ap.add_argument("--admit-threshold", type=int, default=1,
                    help="hold admissions until this many slots free so "
                         "co-admitted prompts share prefill chunks "
                         "(1 = eager/latency-first)")
    ap.add_argument("--harvest-every", type=int, default=4,
                    help="decode steps batched per device->host token "
                         "harvest when untimed")
    ap.add_argument("--max-prefill-tokens", type=int, default=None,
                    help="per-engine-step prefill token budget so long "
                         "prompts cannot starve active decoders")
    ap.add_argument("--fleet-dirs", default=None,
                    help="comma list of fleet replica journal dirs: "
                         "warm-start the online tuner from the fleet "
                         "consensus (implies --online-tune)")
    ap.add_argument("--online-tune", action="store_true",
                    help="attach an OnlineTuner to the decode step hooks")
    ap.add_argument("--tune-op", default="attention",
                    help="tuned op the online trials target (default "
                         "attention)")
    ap.add_argument("--tune-variant", default="flash")
    ap.add_argument("--tune-budget", type=int, default=24,
                    help="measurement budget: max production steps spent "
                         "on non-incumbent configs")
    ap.add_argument("--guard-band", type=float, default=0.25,
                    help="rollback threshold: trial EWMA above "
                         "incumbent*(1+band) is abandoned")
    ap.add_argument("--journal-dir", default=None,
                    help="journal trial EWMAs here (sweep-journal format)")
    ap.add_argument("--record-trace", default=None,
                    help="record (config, step latency) pairs to this JSONL "
                         "trace for deterministic replay")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model.init(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device)
    engine = ServeEngine(model, max_batch=args.max_batch,
                         max_len=args.max_len,
                         prefill_chunk=args.prefill_chunk,
                         admit_threshold=args.admit_threshold,
                         harvest_every=args.harvest_every,
                         max_prefill_tokens=args.max_prefill_tokens)

    tuner = None
    recorder = None
    if args.online_tune or args.record_trace or args.fleet_dirs:
        wl = Workload(op=args.tune_op, n=args.max_len,
                      batch=args.max_batch, variant=args.tune_variant)
        if args.record_trace:
            recorder = TraceRecorder(args.record_trace, wl)
        if args.online_tune or args.fleet_dirs:
            kwargs = dict(budget=args.tune_budget,
                          guard_band=args.guard_band,
                          journal_dir=args.journal_dir)
            if args.fleet_dirs:
                # warm start: prior = fleet consensus winner, trial queue =
                # fleet runner-ups (falls back to cold when dirs are empty)
                tuner = warm_tuner(wl, args.fleet_dirs.split(","),
                                   default_session(), **kwargs)
            else:
                tuner = OnlineTuner(wl, default_session(), **kwargs)
            attach(engine, tuner, recorder=recorder)
        else:
            # --record-trace alone is PASSIVE: time the incumbent config
            # the session already resolves, run no trials, perturb nothing
            baseline = default_session().resolve_raw(wl)
            engine.add_step_listener(
                lambda rec: recorder.add(baseline, rec.duration_s))

    rng = np.random.default_rng(0)
    # the engine's injectable clock (fake-able in tests) is the serving
    # stack's one time source; timing the request loop on anything else
    # would disagree with the per-step latencies the tuner/trace see
    t0 = engine.step_timer()
    for _ in range(args.requests):
        plen = int(rng.integers(4, 16))
        engine.submit(rng.integers(0, cfg.vocab, size=plen),
                      max_new_tokens=args.max_new)
    done = engine.run(max_steps=10_000)
    dt = engine.step_timer() - t0
    toks = sum(len(r.output) for r in done)
    reasons = {}
    for r in done:
        reasons[r.finish_reason] = reasons.get(r.finish_reason, 0) + 1
    print(f"[serve] {cfg.arch} on {device.type}: {len(done)} requests, "
          f"{toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s, "
          f"prefill_calls={engine.prefill_calls}, "
          f"host_transfers={engine.host_transfers})")
    print("[serve] finish reasons: " + ", ".join(
        f"{k}={v}" for k, v in sorted(reasons.items())))
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4].tolist()} "
              f"-> out[:8]={r.output[:8]}")
    if tuner is not None:
        s = tuner.summary()
        ewma = s["incumbent_ewma_s"]
        print(f"[online] state={s['state']} stopped_by={s['stopped_by']} "
              f"steps={s['steps']} measured={s['measured']}/{s['budget']} "
              f"promotions={s['promotions']}")
        if ewma:
            print(f"[online] incumbent {s['incumbent']} "
                  f"ewma={ewma*1e3:.2f}ms")
        for t in s["trials"]:
            print(f"[online]   trial {t['config']} -> {t['state']} "
                  f"(samples={t['samples']})")
    if recorder is not None:
        print(f"[online] trace: {recorder.records} records "
              f"-> {args.record_trace}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
