"""``repro_torch.telemetry``: spans at the entry points, the tuning
session's resolve, the kernel wrappers and the model's forward, on while a
profiler records and off otherwise; the launch counters' readers."""
import os
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import telemetry
from repro_torch.configs.base import get_arch
from repro_torch.kernels.fft.ops import fft
from repro_torch.kernels.scan.ops import prefix_sum
from repro_torch.kernels.tridiag.ops import solve
from repro_torch.kernels.tridiag.ref import random_system
from repro_torch.models.model import Model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# chip_smoke.py's read_counts() before the counters' readers moved into the
# package: every wrapper's total, then each of its routes
READ_COUNTS_KEYS = [
    "scan_add", "scan_add.warp", "scan_add.block", "apply_add",
    "scan_linrec", "scan_linrec.warp", "scan_linrec.block",
    "scan_linrec_prod", "scan_linrec_prod.warp", "scan_linrec_prod.block",
    "apply_linrec", "pcr", "pcr.warp", "pcr.block",
    "thomas", "thomas.lane", "thomas.wide", "thomas.long",
    "fft_stockham", "fft_stockham.pow2", "fft_stockham.generic", "fft_pass",
    "ssd_intra", "ssd_intra.tiled", "ssd_intra.block",
    "ssd_state_apply", "ssd_state_apply.tiled", "ssd_state_apply.block",
    "ssd_apply_entry", "ssd_apply_entry.tiled", "ssd_apply_entry.block",
    "flash_attention", "flash_attention.wgmma", "flash_attention.simt",
    "matmul", "matmul.wgmma", "matmul.ragged", "matmul.simt"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def empty_buffer():
    telemetry.clear()
    yield
    telemetry.clear()


def _grid_calls():
    """prefix_sum, solve(variant="pcr") and fft on small CPU rows, with the
    wrapper each launches through."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(16, 256, generator=gen)
    system = random_system(gen, 16, 64)
    z = torch.randn(16, 128, generator=gen, dtype=torch.complex64)
    return [("prefix_sum", "scan_add", lambda: prefix_sum(x)),
            ("solve", "pcr", lambda: solve(*system, variant="pcr")),
            ("fft", "fft_stockham", lambda: fft(z))]


def test_off_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    assert telemetry.span("repro.anything") is telemetry.OFF
    assert telemetry.span("repro.other") is telemetry.OFF
    with telemetry.span("repro.anything") as s:
        assert s is telemetry.OFF
        s.note(hit=True)
    with pytest.raises(KeyError):
        with telemetry.span("repro.anything"):
            raise KeyError("an error inside a span that is off propagates")
    for _, _, call in _grid_calls():
        call()
    assert telemetry.spans() == []
    assert telemetry.summary() == {}


@pytest.mark.parametrize("entry, wrapper, index", [
    ("prefix_sum", "scan_add", 0), ("solve", "pcr", 1),
    ("fft", "fft_stockham", 2)])
def test_an_entry_point_records_its_tree(entry, wrapper, index):
    call = _grid_calls()[index][2]
    call()                       # the session resolves and memoizes
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    recs = telemetry.spans()
    top = [r for r in recs if r.parent is None]
    assert [r.name for r in top] == [f"repro.entry.{entry}"]
    root = top[0]
    assert {r.request for r in recs} == {root.id}
    kids = sorted((r for r in recs if r.parent == root.id),
                  key=lambda r: r.start_ns)
    assert [r.name for r in kids] == ["repro.tuning.resolve",
                                      f"repro.launch.{wrapper}"]
    assert kids[0].attrs == {"hit": True}
    for r in kids:
        assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
    assert kids[0].end_ns <= kids[1].start_ns

    # the profiler's timeline holds the same ranges, inside the call's
    events = {e.name: e for e in prof.events() if e.name.startswith("repro.")}
    assert set(events) == {r.name for r in recs}
    outer = events[root.name].time_range
    for r in kids:
        inner = events[r.name].time_range
        assert outer.start <= inner.start <= inner.end <= outer.end


def test_a_resolve_notes_a_miss_then_a_hit(tmp_path):
    from repro_torch.core.space import Workload
    from repro_torch.tuning import TunerSession
    session = TunerSession(db_path=str(tmp_path / "db.json"),
                           platform="h100")
    wl = Workload(op="scan", n=256, batch=16, variant="ks")
    with profile(activities=[ProfilerActivity.CPU]):
        session.resolve(wl)
        session.resolve(wl)
        session.resolve(wl, config={"rows_per_program": 4, "tile_n": 256,
                                    "radix": 2, "unroll": 1})
    assert [r.attrs for r in telemetry.spans()] == [
        {"hit": False}, {"hit": True}, {"hit": False}]


def test_self_time_leaves_out_the_children():
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.span("repro.a"):
            with telemetry.span("repro.b"):
                with telemetry.span("repro.c"):
                    sum(range(2000))
                sum(range(2000))
            with telemetry.span("repro.b"):
                sum(range(2000))
    recs = {r.id: r for r in telemetry.spans()}
    took = {i: r.end_ns - r.start_ns for i, r in recs.items()}
    a = next(r for r in recs.values() if r.name == "repro.a")
    bs = [r for r in recs.values() if r.name == "repro.b"]
    c = next(r for r in recs.values() if r.name == "repro.c")
    assert a.parent is None and all(b.parent == a.id for b in bs)
    assert c.parent == bs[0].id or c.parent == bs[1].id
    assert {r.request for r in recs.values()} == {a.id}
    s = telemetry.summary()
    assert s["repro.a"] == {"count": 1, "total_ns": took[a.id],
                            "self_ns": took[a.id] - sum(took[b.id]
                                                        for b in bs)}
    assert s["repro.b"]["count"] == 2
    assert s["repro.b"]["self_ns"] == sum(took[b.id] for b in bs) \
        - took[c.id]
    assert s["repro.c"]["self_ns"] == s["repro.c"]["total_ns"] == took[c.id]


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(telemetry, "CAPACITY", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with telemetry.span("repro.x"):
                pass
    assert len(telemetry.spans()) == 3 and telemetry.dropped() == 2
    telemetry.clear()
    assert telemetry.spans() == [] and telemetry.dropped() == 0


def test_a_model_forward_holds_its_ssd_entries():
    cfg = get_arch("mamba2-130m").reduced()
    model = Model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model(tokens)
        with profile(activities=[ProfilerActivity.CPU]):
            model(tokens)
    recs = telemetry.spans()
    forward = [r for r in recs if r.name == "repro.model.forward"]
    assert len(forward) == 1 and forward[0].parent is None
    fwd = forward[0]
    ssd = [r for r in recs if r.name == "repro.entry.ssd"]
    assert len(ssd) == model.n_groups
    for r in ssd:
        assert r.parent == fwd.id
        assert fwd.start_ns <= r.start_ns <= r.end_ns <= fwd.end_ns
    assert {r.request for r in recs} == {fwd.id}
    assert {r.name for r in recs if r.parent in {s.id for s in ssd}} >= {
        "repro.tuning.resolve", "repro.launch.ssd_intra"}


def test_spans_keep_the_entry_points_names():
    assert prefix_sum.__name__ == "prefix_sum"
    assert prefix_sum.kernel_spec.entry_name == "prefix_sum"
    assert Model.forward.__name__ == "forward"


def test_launch_counts_keep_chip_smokes_keys():
    counts = telemetry.launch_counts()
    assert list(counts) == READ_COUNTS_KEYS
    assert all(isinstance(v, int) for v in counts.values())


def test_launch_counts_read_and_reset_the_wrappers(monkeypatch):
    from repro_torch.kernels.scan.kernel import count_launch
    from repro_torch.kernels.tridiag import kernel as tk
    wrappers = telemetry.launch_wrappers()
    saved = {name: {k: v for k, v in vars(fn).items()
                    if k.startswith("launches")}
             for name, fn in wrappers.items()}
    try:
        telemetry.reset_launch_counts()
        assert set(telemetry.launch_counts().values()) == {0}
        count_launch(tk.pcr, "block")
        count_launch(tk.pcr, "warp")
        count_launch(tk.pcr, "warp")
        counts = telemetry.launch_counts()
        assert (counts["pcr"], counts["pcr.warp"], counts["pcr.block"]) \
            == (3, 2, 1)
        telemetry.reset_launch_counts()
        assert set(telemetry.launch_counts().values()) == {0}
    finally:
        for name, attrs in saved.items():
            for k, v in attrs.items():
                setattr(wrappers[name], k, v)


def test_newest_route_is_each_modules_first_route():
    from repro_torch.kernels.fft import kernel as fk
    from repro_torch.kernels.scan import kernel as sk
    from repro_torch.kernels.ssd import kernel as dk
    from repro_torch.kernels.tridiag import kernel as tk
    assert telemetry.NEWEST_ROUTE == {
        "scan_add": sk.ROUTES[0], "scan_linrec": sk.ROUTES[0],
        "scan_linrec_prod": sk.ROUTES[0], "pcr": tk.ROUTES[0],
        "fft_stockham": fk.ROUTES[0], "ssd_intra": dk.ROUTES[0],
        "ssd_state_apply": dk.ROUTES[0], "ssd_apply_entry": dk.ROUTES[0]}
    assert set(telemetry.NEWEST_ROUTE.values()) == {"warp", "pow2", "tiled"}
    assert telemetry.LAUNCH_ROUTES["thomas"] == tk.THOMAS_ROUTES
    with pytest.raises(AttributeError):
        telemetry.NO_SUCH_TABLE


def test_pass_launches_stay_out_of_the_fallback_share():
    """The four-step pass wrapper counts its launches (``launch_counts``)
    but picks no route, so ``fallback_route_pct.bplg`` reads the routed
    kernels alone whatever it counts."""
    import importlib.util
    from repro_torch.kernels.fft.kernel import fft_pass, fft_stockham
    spec = importlib.util.spec_from_file_location(
        "fallback_route_pct", os.path.join(
            ROOT, "portbench", "metrics", "fallback_route_pct.bplg.py"))
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    assert "fft_pass" not in telemetry.NEWEST_ROUTE
    assert "fft_pass" not in telemetry.LAUNCH_ROUTES
    wrappers = telemetry.launch_wrappers()
    saved = {name: {k: v for k, v in vars(fn).items()
                    if k.startswith("launches")}
             for name, fn in wrappers.items()}
    try:
        telemetry.reset_launch_counts()
        fft_pass.launches = 12
        assert metric.read({"driver": "ops"}) is None
        fft_stockham.launches, fft_stockham.launches_pow2 = 4, 3
        fft_stockham.launches_generic = 1
        assert telemetry.launch_counts()["fft_pass"] == 12
        assert metric.read({"driver": "ops"}) == 25.0
    finally:
        for name, attrs in saved.items():
            for k, v in attrs.items():
                setattr(wrappers[name], k, v)


def test_chip_smoke_reads_the_packages_counters():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    chip_smoke.load_port()
    assert chip_smoke.launch_counts is telemetry.launch_counts
    assert chip_smoke.reset_launch_counts is telemetry.reset_launch_counts
    assert chip_smoke.NEWEST_ROUTE == telemetry.NEWEST_ROUTE
    for gone in ("counted_wrappers", "ROUTES", "NEW_ROUTES", "reset_counts",
                 "read_counts"):
        assert not hasattr(chip_smoke, gone)


def test_importing_telemetry_imports_no_torch():
    code = ("import sys; import repro_torch.telemetry; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'torch'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=os.path.join(
                             ROOT, "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
