"""The readers of the program's spans and launch counters
(``resolve_us_per_call.bplg``, ``launch_us_per_call.bplg``,
``entry_self_us_per_call.bplg``, ``fallback_route_pct.bplg``,
``forward_host_ms.prefill``): nothing to read gives None, a program without
``repro_torch.telemetry`` gives None, and a traced run of each cell on the
CPU reports them."""
import sys

import pytest
import torch

from portbench import harness, timing

CPU = timing.Device(torch.device("cpu"))
GRID = ("resolve_us_per_call.bplg", "launch_us_per_call.bplg",
        "entry_self_us_per_call.bplg", "fallback_route_pct.bplg")
PREFILL = ("forward_host_ms.prefill",)
GRID_RECORD = {"driver": "ops", "trace_calls": [("scan", "ks", 128)] * 4}
PREFILL_RECORD = {"driver": "prefill", "trace_calls": [{"length": 32}] * 2}


@pytest.fixture
def telemetry():
    """The program's span buffer emptied and its launch counters zeroed,
    both put back afterwards."""
    from repro_torch import telemetry
    wrappers = telemetry.launch_wrappers()
    saved = {name: {k: v for k, v in vars(fn).items()
                    if k.startswith("launches")}
             for name, fn in wrappers.items()}
    telemetry.clear()
    telemetry.reset_launch_counts()
    yield telemetry
    telemetry.clear()
    for name, attrs in saved.items():
        for k, v in attrs.items():
            setattr(wrappers[name], k, v)


@pytest.mark.parametrize("metric, record", [
    *((m, GRID_RECORD) for m in GRID), *((m, PREFILL_RECORD) for m in PREFILL)])
def test_nothing_to_read_gives_none(telemetry, metric, record):
    read = harness.reader(metric)
    assert read(record) is None
    assert read({"driver": "other", "trace_calls": [1]}) is None


@pytest.mark.parametrize("metric, record", [
    *((m, GRID_RECORD) for m in GRID), *((m, PREFILL_RECORD) for m in PREFILL)])
def test_a_program_without_spans_gives_none(telemetry, monkeypatch, metric,
                                            record):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        for name in ("repro.tuning.resolve", "repro.launch.pcr",
                     "repro.entry.solve", "repro.model.forward"):
            with telemetry.span(name):
                pass
    from repro_torch.kernels.scan.kernel import count_launch, scan_add
    count_launch(scan_add, "block")
    read = harness.reader(metric)
    assert read(record) is not None
    # the parent program: no telemetry module to import
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "telemetry")
    assert read(record) is None


def _stub_launchers(monkeypatch):
    """The grid's three wrappers through their launch paths on the CPU:
    each takes and counts the route its kernel would, and computes with
    the plain version in place of the card."""
    from repro_torch.kernels.fft import kernel as fk
    from repro_torch.kernels.scan import kernel as sk
    from repro_torch.kernels.tridiag import kernel as tk
    for mod in (sk, tk, fk):
        monkeypatch.setattr(mod, "kernel_path", lambda t: True)
    monkeypatch.setattr(sk, "_launch", lambda x, rows, tile_n, stages,
                        unroll, route=None: sk.scan_add_plain(
                            x, rows_per_program=rows, tile_n=tile_n,
                            stages=stages, unroll=unroll))
    monkeypatch.setattr(tk, "_launch", lambda planes, rows, unroll,
                        route=None: tk.pcr_plain(
                            *planes, rows_per_program=rows, unroll=unroll))
    monkeypatch.setattr(fk, "_launch", lambda x, rows, stages, inverse,
                        unroll, route=None: fk.fft_plain(
                            x, rows_per_program=rows, stages=stages,
                            inverse=inverse, unroll=unroll))


def _run(bench, cell, config, traffic, seconds):
    return harness.run_cell(bench, cell, 2**31 + 29, seconds, True, CPU,
                            timing.process_start(), config=config,
                            traffic=traffic)


def test_a_traced_grid_run_reports_the_spans(bench, small_grid, telemetry,
                                             monkeypatch, three_blocks):
    _stub_launchers(monkeypatch)
    result = _run(bench, "bplg.grid", *small_grid, seconds=0.4)
    assert result["correct"] is True
    got = {m: result["metrics"][m]["value"] for m in GRID}
    assert all(v > 0 for k, v in got.items() if k != "fallback_route_pct.bplg")

    # one entry span a call, holding its resolve and launch spans and no
    # other: the three parts add up to the mean entry span
    recs = telemetry.spans()
    entries = [r for r in recs if r.name.startswith("repro.entry.")]
    assert entries and all(r.parent is None for r in entries)
    mean_entry = sum(r.end_ns - r.start_ns for r in entries) / 1e3 \
        / len(entries)
    parts = got["resolve_us_per_call.bplg"] + got["launch_us_per_call.bplg"] \
        + got["entry_self_us_per_call.bplg"]
    assert parts == pytest.approx(mean_entry, rel=1e-9)

    counts = telemetry.launch_counts()
    routed = sum(counts[k] for k in telemetry.NEWEST_ROUTE)
    earlier = sum(counts[k] - counts[f"{k}.{r}"]
                  for k, r in telemetry.NEWEST_ROUTE.items())
    assert routed > 0
    assert got["fallback_route_pct.bplg"] == pytest.approx(
        100.0 * earlier / routed)


def test_a_traced_prefill_run_reports_the_forward(bench, small_prefill,
                                                  telemetry, three_blocks):
    result = _run(bench, "mamba2.prefill", *small_prefill, seconds=0.6)
    assert result["correct"] is True
    value = result["metrics"]["forward_host_ms.prefill"]["value"]
    forwards = [r for r in telemetry.spans()
                if r.name == "repro.model.forward"]
    assert forwards and all(r.parent is None for r in forwards)
    assert value == pytest.approx(sum(r.end_ns - r.start_ns
                                      for r in forwards) / 1e6
                                  / len(forwards))
