"""Load ``BENCHMARK.json``, find a cell's files by name, run the cell once
and assemble its result line.

A cell names a configuration (``configs/<config>.json`` through the
``file`` given in ``BENCHMARK.json``) and a traffic mix
(``traffic/<traffic>.json``); the mix names its driver
(``drivers/<driver>.py``); each metric is read by ``metrics/<name>.py``;
each cell's limits on the numbers that decide ``correct`` are in
``limits/<cell>.json``.  A new cell, mix, metric or driver is a new file:
nothing here changes.

A driver module gives ``setup(config, traffic, seed, dev, log)`` -> state,
``window(state, seconds, timed_calls)`` -> record (the measured window),
``trace(state)`` -> the traced stretch's calls, run under the profiler by
``timing.traced``, and ``judge(state, control)`` -> {number: value}, run
after the window with the program's state freed.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Dict, Optional

from portbench import timing

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


class Benchmark:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        self.cells = {w["name"]: w for w in self.spec["workloads"]}
        self.configs = {c["name"]: c for c in self.spec["configs"]}

    def cell(self, name: str) -> Dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(self.cells)})")
        return self.cells[name]

    def config(self, cell: Dict) -> Dict:
        return load_json(os.path.join(self.root,
                                      self.configs[cell["config"]]["file"]))

    def traffic(self, cell: Dict) -> Dict:
        return load_json(os.path.join(HERE, "traffic",
                                      cell["traffic"] + ".json"))

    def limits(self, cell: Dict) -> Dict[str, float]:
        return load_json(os.path.join(HERE, "limits",
                                      cell["name"] + ".json"))["limits"]

    def metrics(self, cell: Dict, kind: str):
        """The cell's metrics of ``kind`` ("end_to_end" or "per_layer"):
        those without a ``workloads`` key and those that list it."""
        return [m for m in self.spec[kind]
                if cell["name"] in m.get("workloads", [cell["name"]])]


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def reader(metric: str) -> Callable[[Dict], Optional[float]]:
    """``metrics/<metric>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    mod_name = "portbench_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(bench: Benchmark, name: str, seed: int, seconds: float,
             trace: bool, dev: timing.Device, started: float,
             config: Optional[Dict] = None,
             traffic: Optional[Dict] = None) -> Dict:
    """One run of cell ``name``: set-up, the window, with ``trace`` the
    traced stretch, then the check.  ``started`` is the process's start in
    epoch seconds; ``config`` and ``traffic`` replace the files' (the CPU
    tests run small sizes)."""
    cell = bench.cell(name)
    config = config if config is not None else bench.config(cell)
    traffic = traffic if traffic is not None else bench.traffic(cell)
    limits = bench.limits(cell)
    drv = driver(traffic["driver"])
    log(f"[portbench] set-up: {time.time() - started:.3f} s to the "
        f"driver's set-up (interpreter, torch, CUDA checked)")
    state = drv.setup(config, traffic, seed, dev, log)
    record = drv.window(state, seconds, timed_calls=trace)
    record["setup_s"] = record["window_start"] - started
    if "ms_by_length" in record:
        log(f"[portbench] requests and median ms by length: "
            f"{record['ms_by_length']}")
    if trace:
        record["trace"] = timing.traced(lambda: drv.trace(state), dev)
        record["trace_calls"] = state["trace_calls"]
    device = dev.describe(cell["chips"])
    if trace:
        t = record["trace"] or {"busy_s": 0.0, "window_s": 0.0}
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(cell, kind):
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t = time.perf_counter()
    numbers = drv.judge(state, control=False)
    log(f"[portbench] judged in {time.perf_counter() - t:.3f} s: "
        f"{state.get('per_shape') or state.get('per_length')}")
    checks = {k: {"value": numbers.get(k, float("inf")), "limit": lim}
              for k, lim in limits.items()}
    correct = (record["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics,
              "device": device}
    if trace and record["trace"]:
        result["breakdown"] = timing.breakdown(record["trace"])
    result["checks"] = checks
    return result



def card_line() -> str:
    """The card's name and power limit from nvidia-smi, or why not."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or out.stderr.strip()
