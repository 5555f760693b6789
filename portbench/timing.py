"""The benchmark's clocks: CUDA events, the host clock around work that
ends in a synchronize, and ``torch.profiler``'s trace read over the traced
window's own bounds.

``Device`` stands between the drivers and ``torch.cuda``: on a CPU device
(the CPU tests drive a whole run there at small sizes) its events read the
host clock and its synchronize does nothing.  A measurement on the card
never falls back to it: ``run.py`` refuses to start without CUDA.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import torch


def process_start() -> float:
    """Epoch seconds at which this process started: its age on the boot
    clock (its start in ``/proc/self/stat`` against ``/proc/uptime``, both
    read now, to a clock tick) taken from the host clock.  Now where
    ``/proc`` cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        now = time.time()
        return now - (uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, IndexError, ValueError):
        return time.time()


class HostEvent:
    """A CUDA event's interface on the host clock (CPU device only)."""

    def __init__(self):
        self.t = 0.0

    def record(self) -> None:
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "HostEvent") -> float:
        return (end.t - self.t) * 1e3


class Device:
    """The device a run drives, with its synchronize, events and peak."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def event(self, timing: bool = True):
        if self.cuda:
            return torch.cuda.Event(enable_timing=timing)
        return HostEvent()

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            int(seed) % (1 << 63))

    def memory_peak(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.device)) \
            if self.cuda else 0

    def describe(self, count: int) -> Dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": count,
                    "memory_peak_bytes": 0}
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(self.device),
                "count": count, "memory_peak_bytes": self.memory_peak()}


def time_ms(fn: Callable[[], object], iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
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


WINDOW = "portbench.traced"


def _union(spans: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [tuple(s) for s in out]


def _host_labels(cpu: List[tuple], points: List[float]) -> List[str]:
    """For each time in ``points`` (ascending), what the host thread was
    doing: the innermost benchmark label (a ``portbench.*`` range) and the
    innermost operation inside it, from properly nested CPU ranges."""
    labels, stack, j = [], [], 0
    for t in points:
        while j < len(cpu) and cpu[j][0] <= t:
            while stack and stack[-1][1] <= cpu[j][0]:
                stack.pop()
            stack.append(cpu[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        outer = next((e[2] for e in reversed(stack)
                      if e[2].startswith("portbench.")), "portbench")
        inner = stack[-1][2] if stack else ""
        labels.append(outer if inner in ("", outer) else f"{outer}/{inner}")
    return labels


def traced(fn: Callable[[], object], dev: Device) -> Optional[Dict]:
    """Run ``fn`` and a synchronize under ``torch.profiler`` inside one
    labelled range, and read the trace over that range's own bounds: the
    seconds in which a device operation ran (the union of their
    intervals), the window's length, device time and count by operation
    name, and the idle time inside the window by what the host was doing.
    None where the profiler recorded no device operation."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            dev.sync()
    events = prof.events()
    window = next(e for e in events if e.name == WINDOW)
    w0, w1 = window.time_range.start, window.time_range.end
    # the device timeline also carries the labelled ranges themselves
    ops = [e for e in events
           if str(getattr(e, "device_type", "")).endswith("CUDA")
           and not e.name.startswith("portbench")
           and e.time_range.end > e.time_range.start]
    if not ops:
        return None
    by_name: Dict[str, List[float]] = {}
    spans = []
    for e in ops:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        slot = by_name.setdefault(e.name, [0, 0.0])
        slot[0] += 1
        slot[1] += (e.time_range.end - e.time_range.start) / 1e6
        if t > s:
            spans.append((s, t))
    busy = _union(spans)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if w1 > prev:
        gaps.append((prev, w1))
    cpu = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in events
                  if e.thread == window.thread
                  and not str(getattr(e, "device_type", "")).endswith("CUDA")),
                 key=lambda r: (r[0], -r[1]))
    mids = sorted(((s + t) / 2, (t - s) / 1e6) for s, t in gaps)
    idle: Dict[str, float] = {}
    for label, (_, secs) in zip(_host_labels(cpu, [m for m, _ in mids]),
                                mids):
        idle[label] = idle.get(label, 0.0) + secs
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(t - s for s, t in busy) / 1e6,
            "device_ops": by_name,
            "n_device_ops": len(ops),
            "idle_by_host": idle}


def breakdown(trace: Dict) -> Dict:
    """The ten device operations with the most time and the ten host
    activities with the most device idle time, as the result line gives
    them."""
    ops = sorted(trace["device_ops"].items(), key=lambda kv: -kv[1][1])
    idle = sorted(trace["idle_by_host"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[name[:200], secs] for name, (_, secs) in ops[:10]],
            "idle_gaps": [[name[:200], secs] for name, secs in idle[:10]]}
