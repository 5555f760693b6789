"""Readings that the limits of ``correct`` are set from: the program's
numbers over many seeds (the lower reading) and the control's (the upper),
in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 4] [--out control_<cell>.jsonl]

For each seed the cell is set up as a run sets it up, a short window of
its own traffic is driven, and the kept outputs are judged; then the
control, the reference one precision step below the configuration's, is
judged in the program's place on the same inputs.  One JSON line a seed,
then a summary line with the largest program reading and the smallest
control reading of each number.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(bench, name: str, seeds, seconds: float, dev, log,
             config=None, traffic=None):
    """(per-seed lines, summary) for cell ``name``."""
    from portbench import harness
    cell = bench.cell(name)
    config = config if config is not None else bench.config(cell)
    traffic = traffic if traffic is not None else bench.traffic(cell)
    drv = harness.driver(traffic["driver"])
    lines = []
    for seed in seeds:
        state = drv.setup(config, traffic, seed, dev, log)
        drv.window(state, seconds, timed_calls=False)
        program = drv.judge(state, control=False)
        detail = dict(state.get("per_shape", state.get("per_length", {})))
        control = drv.judge(state, control=True)
        lines.append({"seed": seed, "program": program, "control": control,
                      "program_detail": detail})
        del state
        if dev.cuda:
            import torch
            torch.cuda.empty_cache()
    keys = lines[0]["program"].keys()
    summary = {k: {"lower": max(r["program"][k] for r in lines),
                   "upper": min(r["control"][k] for r in lines)}
               for k in keys}
    return lines, summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch
    from portbench import harness, timing
    if not torch.cuda.is_available():
        harness.log("[control] needs CUDA")
        return 2
    bench = harness.Benchmark(ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    lines, summary = readings(bench, args.workload, seeds, args.seconds,
                              timing.Device(torch.device("cuda", 0)),
                              harness.log)
    out = open(args.out, "w") if args.out else None
    try:
        for line in lines + [{"summary": summary,
                              "card": harness.card_line()}]:
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
