"""The port's tridiagonal solvers on the CPU against the JAX package's.

A CPU tensor runs the PCR kernel's plain version (``pcr_plain``) and the
linrec kernels' plain versions through the same plans, so this is where
``solve`` (all five variants), ``lf_solve_multipass`` and their launch
lists are held against the JAX package (its Pallas PCR kernel in interpret
mode).  Systems are made with numpy by the rule of JAX's
``random_system`` and handed to both packages.  Solvers held against the
Thomas ground truth use the shared f32 tolerance x50, as the differential
suite does; solver against solver uses ``DTYPE_TOL``.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ODD_BATCH_SHAPES, _rng, assert_kernel_close
from repro import tuning as j_tuning
from repro.kernels.blocks import driver as j_driver
from repro.kernels.tridiag import ops as j_ops
from repro.kernels.tridiag import ref as j_ref
from repro.kernels.tridiag.kernel import pcr_pallas
from repro_torch import tuning as t_tuning
from repro_torch.core.space import Workload as TWorkload
from repro_torch.kernels.blocks import driver as t_driver
from repro_torch.kernels.blocks.plan import plan_for as t_plan_for
from repro_torch.kernels.tridiag import ops as t_ops
from repro_torch.kernels.tridiag import ref as t_ref
from repro_torch.kernels.tridiag import kernel as t_kernel
from repro_torch.kernels.tridiag.kernel import pcr, pcr_plain, thomas
from repro_torch.launch import tune

j_hw = importlib.import_module("repro.hw.profiles")
t_hw = importlib.import_module("repro_torch.hw.profiles")

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
VARIANTS = ("pcr", "cr", "lf", "wm", "thomas")


def _system(tag, batch, n, dtype="float32"):
    """A diagonally dominant system by the rule of JAX's random_system,
    drawn with numpy, for both packages."""
    rng = _rng(tag)
    a = rng.uniform(0.1, 1.0, size=(batch, n))
    c = rng.uniform(0.1, 1.0, size=(batch, n))
    a[:, 0] = 0.0
    c[:, -1] = 0.0
    b = np.abs(a) + np.abs(c) + rng.uniform(1.0, 2.0, size=(batch, n))
    d = rng.normal(size=(batch, n))
    planes = [v.astype(np.float32) for v in (a, b, c, d)]
    return ([jnp.asarray(v).astype(_JNP[dtype]) for v in planes],
            [torch.from_numpy(v).to(_TORCH[dtype]) for v in planes])


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _asdicts(launches):
    return [dataclasses.asdict(l) for l in launches]


@pytest.fixture
def pinned(tmp_path):
    """Both packages' default sessions on the same profile (tpu_v5e) with
    empty DBs, so they resolve the same configs and build the same plans."""
    jprev = j_tuning.set_default_session(j_tuning.TunerSession(
        db_path=str(tmp_path / "jax.json"),
        spec=j_hw.get_profile("tpu_v5e")))
    tprev = t_tuning.set_default_session(t_tuning.TunerSession(
        db_path=str(tmp_path / "torch.json"),
        spec=t_hw.get_profile("tpu_v5e")))
    yield
    j_tuning.set_default_session(jprev)
    t_tuning.set_default_session(tprev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n,rows,unroll", [
    (8, 64, 1, 1), (8, 64, 2, 2), (8, 64, 4, 4), (8, 64, 8, 1),
    (7, 96, 7, 2),              # non-power-of-two n
    (5, 100, 5, 1),
    (3, 7, 3, 4),               # prime n
    (4, 1, 2, 1),               # one equation: one level, x = d / b
])
def test_pcr_body_matches_pallas(dtype, batch, n, rows, unroll):
    """The plain PCR body (the CUDA kernel's function) against pcr_pallas
    in interpret mode, over a rows sweep."""
    (ja, jb, jc, jd), (ta, tb, tc, td) = _system(f"pcr{batch}x{n}", batch, n,
                                                 dtype)
    jx = pcr_pallas(ja, jb, jc, jd, rows_per_program=rows, unroll=unroll,
                    interpret=True)
    tx = pcr(ta, tb, tc, td, rows_per_program=rows, unroll=unroll)
    assert tx.dtype == ta.dtype and tx.shape == ta.shape
    assert_kernel_close(_np(tx), _np(jx), dtype)
    assert torch.equal(tx, pcr_plain(ta, tb, tc, td, rows_per_program=rows,
                                     unroll=unroll))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("batch,n", ODD_BATCH_SHAPES + ((3, 100), (2, 2)))
def test_solve_matches_repro(pinned, variant, batch, n):
    """One profile for both: the same config and launch list, solutions
    within DTYPE_TOL of JAX's and within x50 of the Thomas ground truth."""
    js, ts = _system(f"solve{variant}{batch}x{n}", batch, n)
    with j_driver.capture_launches() as jl:
        jx = j_ops.solve(*js, variant=variant)
    with t_driver.capture_launches() as tl:
        tx = t_ops.solve(*ts, variant=variant)
    assert _asdicts(tl) == _asdicts(jl)
    assert len(tl) == (1 if variant == "pcr" else 0)
    assert tx.shape == ts[0].shape and tx.dtype == ts[0].dtype
    assert_kernel_close(_np(tx), _np(jx), "float32")
    thomas = t_ref.thomas_ref(*(v.double() for v in ts))
    assert_kernel_close(_np(tx), thomas.numpy(), "float32", scale=50.0)
    assert float(t_ref.residual(*ts, tx)) < 1e-4


def test_lf_solve_multipass_matches_repro(pinned):
    """LF with its sweeps on the tuned linrec kernels, at n = 256: the
    same launch list (two linrec plans) and solution as JAX's."""
    js, ts = _system("lfmultipass", 3, 256)
    with j_driver.capture_launches() as jl:
        jx = j_ops.lf_solve_multipass(*js, use_pallas=True, interpret=True)
    with t_driver.capture_launches() as tl:
        tx = t_ops.lf_solve_multipass(*ts)
    assert _asdicts(tl) == _asdicts(jl) and len(tl) == 2
    assert_kernel_close(_np(tx), _np(jx), "float32")
    assert_kernel_close(_np(tx), _np(t_ops.lf_solve(*ts)), "float32")


@pytest.mark.parametrize("n", [t_ops.LF_MULTIPASS_MIN,
                               2 * t_ops.LF_MULTIPASS_MIN])
def test_lf_routes_above_multipass_min(n):
    """solve(variant="lf") at batch 1: plain tensor ops up to
    LF_MULTIPASS_MIN, the linrec kernels' plan for each sweep above it."""
    g = torch.Generator().manual_seed(n)
    system = t_ref.random_system(g, 1, n)
    with t_driver.capture_launches() as launched:
        x = t_ops.solve(*system, variant="lf")
    if n > t_ops.LF_MULTIPASS_MIN:
        wl = TWorkload(op="scan", n=n, batch=1, variant="linrec")
        plan = t_plan_for(wl, t_tuning.default_session().resolve(wl))
        assert tuple(launched) == plan.launches * 2
    else:
        assert launched == []
    assert float(t_ref.residual(*system, x)) < 1e-4


@pytest.mark.parametrize("n", [1, 2, 3, 8, 33])
def test_tridiag_refs_match_repro(n):
    js, ts = _system(f"tridiagref{n}", 4, n)
    tx = t_ref.thomas_ref(*ts)
    assert_kernel_close(_np(tx), _np(j_ref.thomas_ref(*js)), "float32")
    assert_kernel_close(_np(t_ref.dense_solve_ref(*ts)),
                        _np(j_ref.dense_solve_ref(*js)), "float32",
                        scale=50.0)
    np.testing.assert_allclose(float(t_ref.residual(*ts, tx)),
                               float(j_ref.residual(*js, jnp.asarray(
                                   tx.numpy()))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("batch,n", [(64, 256), (3, 7)])
def test_random_system_is_diagonally_dominant(batch, n):
    """The port's random_system draws from JAX's distribution (other
    draws): zero corners, a and c in [0.1, 1), b - |a| - |c| in [1, 2)."""
    a, b, c, d = t_ref.random_system(torch.Generator().manual_seed(7),
                                     batch, n)
    assert all(v.shape == (batch, n) and v.dtype == torch.float32
               for v in (a, b, c, d))
    assert torch.all(a[:, 0] == 0) and torch.all(c[:, -1] == 0)
    for v in (a[:, 1:], c[:, :-1]):
        assert float(v.min()) >= 0.1 and float(v.max()) < 1.0
    margin = b - a.abs() - c.abs()
    assert float(margin.min()) >= 1.0 - 1e-6
    assert float(margin.max()) < 2.0 + 1e-6
    x = t_ops.solve(a, b, c, d, variant="thomas")
    assert float(t_ref.residual(a, b, c, d, x)) < 1e-4


def test_cpu_path_counts_no_kernel_launch():
    before = pcr.launches
    t_ops.solve(*t_ref.random_system(torch.Generator().manual_seed(1), 8,
                                     64), variant="pcr")
    assert pcr.launches == before


def test_thomas_on_cuda_tensors_routes_to_its_kernel(monkeypatch):
    """solve(variant="thomas") on a tensor bound for the card reaches the
    Thomas kernel's launcher (stubbed here: there is no card) and counts
    one launch; a CPU tensor runs thomas_ref and counts none; a meta
    tensor raises rather than falling back."""
    system = t_ref.random_system(torch.Generator().manual_seed(3), 5, 40)
    launched = []

    def launcher(planes, route=None):
        launched.append(tuple(v.shape for v in planes))
        return t_ref.thomas_ref(*planes)

    before = thomas.launches
    x = t_ops.solve(*system, variant="thomas")
    assert thomas.launches == before and launched == []
    monkeypatch.setattr(t_kernel, "kernel_path", lambda t: True)
    monkeypatch.setattr(t_kernel, "sm_count", lambda device: 132)
    monkeypatch.setattr(t_kernel, "_launch_thomas", launcher)
    with t_driver.capture_launches() as planned:
        y = t_ops.solve(*system, variant="thomas")
    assert launched == [((5, 40),) * 4] and planned == []
    assert thomas.launches == before + 1
    assert torch.equal(x, y)
    monkeypatch.undo()
    meta = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        t_ops.solve(meta, meta, meta, meta, variant="thomas")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        t_kernel._launch_thomas(system)


# (batch, n, route, long-route rows) on a card of 132 SMs: the main path's
# four sizes at 2^26 equations, and the edges
THOMAS_ROUTE_TABLE = [
    (262144, 256, "wide", 32),
    (65536, 1024, "wide", 32),
    (1024, 2 ** 16, "long", 8),
    (16, 2 ** 22, "long", 1),
    (1, 1, "long", 1),                  # one system of one equation
    (1, 2 ** 20, "long", 1),
    (4224, 8, "wide", 32),              # the batch where "wide" begins
    (4223, 8, "long", 32),              # one system short of it
    (4224, 33, "lane", 32),             # many systems of a ragged n
    (65536, 97, "lane", 32),
    (4096, 4097, "long", 32),
    (133, 1024, "long", 2),             # a ragged batch: 67 blocks
    (0, 64, "long", 1),
]


@pytest.mark.parametrize("batch,n,route,rows", THOMAS_ROUTE_TABLE)
def test_thomas_route_by_shape(batch, n, route, rows):
    """thomas_route picks by (batch, n, SMs) alone; the long route's rows a
    block shrink until the blocks cover the card, down to one."""
    assert t_kernel.thomas_route(batch, n, 132) == route
    assert t_kernel.thomas_long_rows(batch, 132) == rows
    if route == "long":
        assert -(-batch // rows) <= 132 or rows == 32
    if route == "wide":
        assert n % t_kernel.THOMAS_WIDE_ALIGN == 0


@pytest.mark.parametrize("n,itemsize,resident", [
    (256, 4, True), (264, 4, False), (1024, 4, False), (512, 2, True),
    (1024, 2, False), (8, 4, True)])
def test_thomas_wide_keeps_c_and_d_on_chip_where_they_fit(n, itemsize,
                                                         resident):
    """The wide route's c' and d' stay in shared memory up to 64 KB a warp
    (five planes of traffic), and its block asks for at most what the H100
    gives one where it does."""
    assert t_kernel.thomas_resident(n, itemsize) == resident
    smem = t_kernel.thomas_wide_smem(n, itemsize, resident)
    assert smem <= t_kernel.SMEM_MAX
    assert t_kernel.thomas_wide_smem(n, itemsize, False) == 18 * 4096


@pytest.mark.parametrize("batch,n,sms,route", [
    (64, 16, 2, "wide"), (64, 33, 2, "lane"), (3, 97, 2, "long"),
    (1, 1, 132, "long")])
def test_thomas_wrapper_passes_and_counts_its_route(monkeypatch, batch, n,
                                                    sms, route):
    """Through a stubbed _launch_thomas (a card of ``sms`` SMs): the wrapper
    passes the route thomas_route picks and counts it, in launches and
    launches_<route> alone; a CPU tensor counts none; a meta tensor
    raises; nothing falls back."""
    assert t_kernel.thomas_route(batch, n, sms) == route
    planes = t_ref.random_system(torch.Generator().manual_seed(5), batch, n)
    calls = []

    def launcher(planes, route=None):
        calls.append(route)
        return t_ref.thomas_ref(*planes)

    def counts():
        return {r: getattr(thomas, f"launches_{r}")
                for r in t_kernel.THOMAS_ROUTES} | {"all": thomas.launches}

    before = counts()
    x = t_kernel.thomas(*planes)
    assert counts() == before and calls == []
    monkeypatch.setattr(t_kernel, "kernel_path", lambda t: True)
    monkeypatch.setattr(t_kernel, "sm_count", lambda device: sms)
    monkeypatch.setattr(t_kernel, "_launch_thomas", launcher)
    y = t_kernel.thomas(*planes)
    assert calls == [route] and torch.equal(x, y)
    after = counts()
    assert after == {**before, "all": before["all"] + 1,
                     route: before[route] + 1}
    monkeypatch.undo()
    meta = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        t_kernel.thomas(meta, meta, meta, meta)
    with pytest.raises(ValueError, match="unknown thomas route"):
        t_kernel._launch_thomas(tuple(planes), route="warp")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        t_kernel._launch_thomas(tuple(planes), route=route)
    assert counts() == after


def test_pcr_rejects_what_the_kernel_does_not_take():
    planes = [torch.rand(8, 64) for _ in range(4)]
    with pytest.raises(ValueError):
        pcr(*planes, rows_per_program=3)                    # 3 !| 8
    with pytest.raises(ValueError):
        pcr(*planes, rows_per_program=2, unroll=0)
    with pytest.raises(ValueError):
        pcr(*planes[:3], torch.rand(8, 32), rows_per_program=2)
    with pytest.raises(TypeError):
        pcr(*planes[:3], planes[3].double(), rows_per_program=2)
    with pytest.raises(ValueError, match="unknown tridiag variant"):
        t_ops.solve(*planes, variant="ks")


def test_compare_methods_cli_tunes_tridiag_on_the_cpu(tmp_path):
    """--op tridiag --variant pcr runs the paper's loop through
    make_tridiag_runner (plain versions on the CPU) with 0 failures."""
    rc = tune.main(["compare-methods", "--device", "cpu", "--op", "tridiag",
                    "--variant", "pcr", "--sizes", "64", "--batch", "8",
                    "--reps", "1", "--max-evals", "4",
                    "--json", str(tmp_path / "report.json")])
    assert rc == 0
    with pytest.raises(SystemExit):
        tune.main(["compare-methods", "--device", "cpu", "--op", "tridiag",
                   "--variant", "ks", "--sizes", "64", "--batch", "8"])
    with pytest.raises(SystemExit):
        tune.main(["compare-methods", "--device", "cpu", "--op", "fft",
                   "--sizes", "64", "--batch", "8"])
