"""Calls of the port's prefix-operation entry points
(``repro_torch.kernels.scan.ops.prefix_sum``,
``repro_torch.kernels.tridiag.ops.solve``,
``repro_torch.kernels.fft.ops.fft``), each resolving its configuration
through the default ``TunerSession`` as a user's call does.

A closed loop with one client: the host waits on call i - k's end before it
issues call i (``in_flight`` k).  Each family's inputs are one device
buffer of ``elements_per_call`` elements made from the seed, viewed as
(elements / N, N); the port allocates each output.  One output of every
(family, variant, N) the window drives is kept, the first at or after a
call drawn from the seed, and judged against the float64 reference once
the window has closed.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from portbench import traffic as gen_traffic
from portbench.reference import prefix_ops as ref
from portbench.work import fft as work_fft
from portbench.work import scan as work_scan
from portbench.work import tridiag as work_tridiag

WORK = {"scan": work_scan, "tridiag": work_tridiag, "fft": work_fft,
        "large_fft": work_fft}
REF_BLOCK = 1 << 26        # elements of one block of reference rows


def _entry(family: str):
    """The port's public entry point of ``family`` as f(inputs, variant)."""
    if family == "scan":
        from repro_torch.kernels.scan.ops import prefix_sum
        return lambda ins, variant: prefix_sum(ins[0], variant=variant)
    if family == "tridiag":
        from repro_torch.kernels.tridiag.ops import solve
        return lambda ins, variant: solve(*ins, variant=variant)
    if family in ("fft", "large_fft"):
        from repro_torch.kernels.fft.ops import fft
        return lambda ins, variant: fft(ins[0])
    raise KeyError(f"no entry point for family {family!r}")


def laplacian_system(total: int, gen: torch.Generator):
    """A perturbed 1-D Laplacian, diagonally dominant by a hair: a, c in
    [-1.01, -1), b in [2.03, 2.04), d standard normal.  Its off-diagonals
    keep their size at every level of a cyclic reduction, where those of a
    strongly dominant system vanish after a few."""
    u = torch.rand(3, total, generator=gen, device=gen.device)
    a = -1.0 - 0.01 * u[0]
    c = -1.0 - 0.01 * u[1]
    b = 2.03 + 0.01 * u[2]
    d = torch.randn(total, generator=gen, device=gen.device)
    return a, b, c, d


def make_inputs(family: str, total: int, gen: torch.Generator):
    if family == "scan":
        return (torch.randn(total, generator=gen, device=gen.device),)
    if family == "tridiag":
        return laplacian_system(total, gen)
    if family in ("fft", "large_fft"):
        return (torch.randn(total, generator=gen, device=gen.device,
                            dtype=torch.complex64),)
    raise KeyError(f"no inputs for family {family!r}")


def _key(item: Dict):
    return item["family"], item["variant"], item["n"]


def _name(key) -> str:
    return "_".join(str(k) for k in key)


def setup(config: Dict, traffic: Dict, seed: int, dev, log) -> Dict:
    total = config["elements_per_call"]
    mix = [{"n": config["families"][e["family"]]["sizes"], **e}
           for e in traffic["mix"]]
    counted = gen_traffic.expand(mix)
    families = sorted({item["family"] for item, _ in counted})
    gen = dev.generator(seed)
    buffers = {f: make_inputs(f, total, gen) for f in families}
    entries = {f: _entry(f) for f in families}
    t = time.perf_counter()
    views = {_key(item): tuple(v.view(total // item["n"], item["n"])
                               for v in buffers[item["family"]])
             for item, _ in counted}
    state = {"config": config, "traffic": traffic, "seed": seed, "dev": dev,
             "counted": counted, "entries": entries, "views": views,
             "total": total, "samples": {}}
    # warm-up: every shape of the mix once (the library loads or builds on
    # the first launch; the session resolves and memoizes each shape)
    for item, _ in counted:
        _call(state, item)
    dev.sync()
    log(f"[portbench] set-up: inputs and warm-up "
        f"{time.perf_counter() - t:.3f} s")
    from repro_torch.core.space import Workload
    from repro_torch.tuning import default_session
    session = default_session()
    log(f"[portbench] tuning DB entries: {session.stats()['db_entries']}")
    for item, _ in counted:
        fam, variant, n = _key(item)
        wl = Workload(op=fam, n=n, batch=total // n, variant=variant)
        log(f"[portbench] resolved {_name(_key(item))}: "
            f"{session.resolve(wl)}")
    block = gen_traffic.block_size(counted)
    state["sample_from"] = int(gen_traffic.rng(seed, 2).integers(block))
    return state


def _call(state: Dict, item: Dict):
    key = _key(item)
    return state["entries"][key[0]](state["views"][key], key[1])


def _loop(state: Dict, items, timed_calls: bool, keep: bool) -> Dict:
    """Issue ``items`` (index, item) with ``in_flight`` calls in flight;
    with ``timed_calls`` each call's device time from CUDA events."""
    dev = state["dev"]
    k = state["traffic"]["in_flight"]
    done = [dev.event(timing=False) for _ in range(k)]
    pairs = [(dev.event(), dev.event()) for _ in range(k)] \
        if timed_calls else None
    calls, enqueue, device_s = [], [], []
    failed = 0
    for i, item in items:
        slot = i % k
        if i >= k:
            done[slot].synchronize()
            if timed_calls:
                device_s.append(pairs[slot][0].elapsed_time(pairs[slot][1])
                                / 1e3)
        if timed_calls:
            pairs[slot][0].record()
        t = time.perf_counter()
        try:
            out = _call(state, item)
        except RuntimeError:
            failed += 1
            out = None
        enqueue.append(time.perf_counter() - t)
        if timed_calls:
            pairs[slot][1].record()
        done[slot].record()
        key = _key(item)
        calls.append(key)
        if keep and out is not None and i >= state["sample_from"] \
                and key not in state["samples"]:
            state["samples"][key] = out
    dev.sync()
    if timed_calls:
        for i in range(max(len(calls) - k, 0), len(calls)):
            slot = i % k
            device_s.append(pairs[slot][0].elapsed_time(pairs[slot][1]) / 1e3)
    return {"calls": calls, "enqueue_s": enqueue, "device_s": device_s,
            "failed": failed}


def window(state: Dict, seconds: float, timed_calls: bool) -> Dict:
    schedule = gen_traffic.schedule(state["counted"], state["seed"])
    state["schedule"] = schedule
    start = time.time()
    t0 = time.perf_counter()
    block = gen_traffic.block_size(state["counted"])
    out = _loop(state, gen_traffic.timed(schedule, seconds, block),
                timed_calls, keep=True)
    window_s = time.perf_counter() - t0
    total = state["total"]
    least = [WORK[f].least(total // n, n) for f, _, n in out["calls"]]
    return {"driver": "ops", "window_start": start, "window_s": window_s,
            "attempted": len(out["calls"]), "failed": out["failed"],
            "elements": total * (len(out["calls"]) - out["failed"]),
            "calls": out["calls"], "least_s": least,
            "enqueue_s": out["enqueue_s"], "device_s": out["device_s"]}


def trace(state: Dict) -> None:
    """One block of the schedule after the window, under the profiler."""
    n = gen_traffic.block_size(state["counted"])
    schedule = state["schedule"]
    items = [next(schedule) for _ in range(n)]
    base = items[0][0]
    _loop(state, [(i - base, item) for i, item in items], False, keep=False)
    state["trace_calls"] = [_key(item) for _, item in items]


def judge(state: Dict, control: bool) -> Dict[str, float]:
    """Each family's largest error over its kept outputs, as a share of
    the largest |reference| of the shape: the program's outputs, or with
    ``control`` the control's on the same inputs.  A shape of the mix with
    no kept output reads infinity."""
    worst: Dict[str, float] = {}
    detail = state["per_shape"] = {}
    for item, _ in state["counted"]:
        key = _key(item)
        fam = key[0]
        got = state["samples"].get(key)
        if got is None and not control:
            worst[f"{fam}_err"] = float("inf")
            continue
        ins = state["views"][key]
        rows = max(1, REF_BLOCK // key[2])
        err, top = 0.0, 0.0
        for r in range(0, ins[0].shape[0], rows):
            block = tuple(v[r:r + rows] for v in ins)
            want = ref.reference(fam, block)
            have = ref.control(fam, block) if control else got[r:r + rows]
            e, t = ref.max_err(have, want)
            err, top = max(err, e), max(top, t)
        value = err / max(top, 1e-30)
        detail[_name(key)] = value
        worst[f"{fam}_err"] = max(worst.get(f"{fam}_err", 0.0), value)
    return worst
