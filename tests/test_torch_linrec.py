"""The port's linear recurrence on the CPU against the JAX package's.

A CPU tensor runs the CUDA kernels' plain versions (``scan_linrec``,
``scan_linrec_prod``, ``apply_linrec``) through the same plans, so this is
where their arithmetic (stage loop, composition order, the RG-LRU gate,
carry chain, multipass driver) and their launch lists are held against
the Pallas kernels, run in interpret mode.  Inputs are made with numpy and
handed to both packages; tolerances are the shared ``DTYPE_TOL``.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ODD_BATCH_SHAPES, _rng, assert_kernel_close
from repro import tuning as j_tuning
from repro.core.space import Workload as JWorkload
from repro.kernels.blocks import driver as j_driver
from repro.kernels.blocks.plan import build_plan as j_build_plan
from repro.kernels.scan import ref as j_ref
from repro.kernels.scan.kernel import (scan_linrec_pallas,
                                       scan_linrec_prod_pallas)
from repro.kernels.scan.ops import linear_recurrence as j_linear_recurrence
from repro_torch import tuning as t_tuning
from repro_torch.core.space import Workload as TWorkload
from repro_torch.kernels.blocks import driver as t_driver
from repro_torch.kernels.blocks.associative import associative_scan
from repro_torch.kernels.blocks.plan import build_plan as t_build_plan
from repro_torch.kernels.blocks.plan import plan_for as t_plan_for
from repro_torch.kernels.blocks.plan import stage_radices
from repro_torch.kernels.scan import ref as t_ref
from repro_torch.kernels.scan.kernel import (scan_linrec, scan_linrec_plain,
                                             scan_linrec_prod,
                                             scan_linrec_prod_plain)
from repro_torch.kernels.scan.ops import linear_recurrence as t_linear_recurrence

# the packages' hw/__init__ re-export a ``profiles()`` function that
# shadows the submodule attribute, so fetch the modules themselves
j_hw = importlib.import_module("repro.hw.profiles")
t_hw = importlib.import_module("repro_torch.hw.profiles")

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pairs(tag, batch, n, dtype="float32"):
    """(a, b) for both packages: a in [0.8, 0.99) (a stable recurrence),
    b standard normal, made once in numpy f32 and rounded by each
    package to ``dtype`` (both round to nearest even)."""
    rng = _rng(tag)
    a = rng.uniform(0.8, 0.99, size=(batch, n)).astype(np.float32)
    b = rng.normal(size=(batch, n)).astype(np.float32)
    return ((jnp.asarray(a).astype(_JNP[dtype]),
             jnp.asarray(b).astype(_JNP[dtype])),
            (torch.from_numpy(a).to(_TORCH[dtype]),
             torch.from_numpy(b).to(_TORCH[dtype])))


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


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n,rows,tile_n,radix", [
    (7, 96, 7, 96, 8),          # ragged radix-8 stages (8, 4, 3)
    (3, 768, 1, 768, 8),        # (8, 8, 4, 3)
    (4, 512, 2, 128, 4),        # four column tiles: the carry chain
    (6, 256, 3, 64, 2),
    (5, 212, 5, 106, 2),        # a large prime fan-in: (2, 53)
])
def test_scan_linrec_body_matches_pallas(gate, dtype, batch, n, rows, tile_n,
                                         radix):
    """The plain scan_linrec body (the CUDA kernel's function) against
    scan_linrec_pallas in interpret mode, explicit stages, gate on and off."""
    stages = stage_radices(tile_n, radix)
    (ja, jb), (ta, tb) = _pairs(f"linrecbody{batch}x{n}", batch, n, dtype)
    jh = scan_linrec_pallas(ja, jb, rows_per_program=rows, tile_n=tile_n,
                            stages=stages, gate=gate, interpret=True)
    th = scan_linrec(ta, tb, rows_per_program=rows, tile_n=tile_n,
                     stages=stages, gate=gate)
    assert th.dtype == ta.dtype and th.shape == ta.shape
    assert_kernel_close(_np(th), _np(jh), dtype)
    assert torch.equal(th, scan_linrec_plain(ta, tb, rows_per_program=rows,
                                             tile_n=tile_n, stages=stages,
                                             gate=gate))


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n,rows,radix", [
    (12, 128, 4, 2), (21, 96, 7, 8), (8, 100, 1, 4)])
def test_scan_linrec_prod_body_matches_pallas(gate, dtype, batch, n, rows,
                                              radix):
    """The chunk kernel: h and the prefix products of a, one tile a row."""
    stages = stage_radices(n, radix)
    (ja, jb), (ta, tb) = _pairs(f"linrecprod{batch}x{n}", batch, n, dtype)
    jh, jp = scan_linrec_prod_pallas(ja, jb, rows_per_program=rows,
                                     stages=stages, gate=gate,
                                     interpret=True)
    th, tp = scan_linrec_prod(ta, tb, rows_per_program=rows, stages=stages,
                              gate=gate)
    assert th.dtype == tp.dtype == ta.dtype
    assert_kernel_close(_np(th), _np(jh), dtype)
    assert_kernel_close(_np(tp), _np(jp), dtype)
    ph, pp = scan_linrec_prod_plain(ta, tb, rows_per_program=rows,
                                    stages=stages, gate=gate)
    assert torch.equal(ph, th) and torch.equal(pp, tp)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows_n,length,rows", [(12, 128, 4), (21, 96, 7),
                                                 (8, 1000, 1)])
def test_apply_linrec_matches_repro(out_dtype, rows_n, length, rows):
    rng = _rng(f"applylinrec{rows_n}x{length}")
    h = rng.normal(size=(rows_n, length)).astype(np.float32)
    p = rng.uniform(0.0, 1.0, size=(rows_n, length)).astype(np.float32)
    e = (100 * rng.normal(size=(rows_n, 1))).astype(np.float32)
    jy = j_driver._apply_linrec(jnp.asarray(h), jnp.asarray(p),
                                jnp.asarray(e), rows=rows,
                                interpret=True).astype(_JNP[out_dtype])
    ty = t_driver.apply_linrec(torch.from_numpy(h), torch.from_numpy(p),
                               torch.from_numpy(e), rows=rows,
                               out_dtype=_TORCH[out_dtype])
    assert ty.dtype == _TORCH[out_dtype]
    assert_kernel_close(_np(ty), _np(jy), out_dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gate", [False, True])
def test_multipass_linrec_matches_repro(dtype, gate):
    """A plan forced multipass with seq_limit: identical plans and launch
    lists, outputs at DTYPE_TOL, the output in the input type."""
    cfg = {"tile_n": 64, "rows_per_program": 2, "radix": 2}
    jplan = j_build_plan(JWorkload(op="scan", n=512, batch=4,
                                   variant="linrec"), cfg, seq_limit=4)
    tplan = t_build_plan(TWorkload(op="scan", n=512, batch=4,
                                   variant="linrec"), cfg, seq_limit=4)
    assert tplan.kind == "multipass" and tplan.passes == 3
    assert _asdicts(tplan.launches) == _asdicts(jplan.launches)
    (ja, jb), (ta, tb) = _pairs("multipasslinrec", 4, 512, dtype)
    with j_driver.capture_launches() as jl:
        jh = j_driver.multipass_linrec(ja, jb, jplan, gate=gate,
                                       interpret=True)
    with t_driver.capture_launches() as tl:
        th = t_driver.multipass_linrec(ta, tb, tplan, gate=gate)
    assert _asdicts(tl) == _asdicts(jl)
    assert th.dtype == ta.dtype and th.shape == ta.shape
    assert_kernel_close(_np(th), _np(jh), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n", ODD_BATCH_SHAPES)
def test_linear_recurrence_matches_repro(pinned, dtype, batch, n):
    """One profile for both: the same config, the same launch list, and
    outputs at DTYPE_TOL (and against the float64 recurrence)."""
    (ja, jb), (ta, tb) = _pairs(f"linrec{batch}x{n}", batch, n, dtype)
    with j_driver.capture_launches() as jl:
        jh = j_linear_recurrence(ja, jb, interpret=True, use_pallas=True)
    with t_driver.capture_launches() as tl:
        th = t_linear_recurrence(ta, tb)
    assert th.dtype == ta.dtype and th.shape == ta.shape
    assert _asdicts(tl) == _asdicts(jl) and len(tl) >= 1
    twl = TWorkload(op="scan", n=n, batch=batch, variant="linrec")
    assert tuple(tl) == t_plan_for(
        twl, t_tuning.default_session().resolve(twl)).launches
    assert_kernel_close(_np(th), _np(jh), dtype)
    assert_kernel_close(_np(th), _np(t_ref.scan_linrec_ref(
        ta.double(), tb.double())), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n,cfg", [
    (5, 96, {"radix": 8, "tile_n": 96}),
    (3, 256, {"tile_n": 128, "rows_per_program": 1, "radix": 4}),
    # 2^14 / 128 = 128 column tiles > 64: the three-launch plan
    (4, 2 ** 14, {"tile_n": 128, "rows_per_program": 2, "radix": 4}),
])
def test_linear_recurrence_explicit_config_matches_repro(dtype, batch, n,
                                                         cfg):
    (ja, jb), (ta, tb) = _pairs(f"linreccfg{batch}x{n}", batch, n, dtype)
    with j_driver.capture_launches() as jl:
        jh = j_linear_recurrence(ja, jb, config=cfg, interpret=True,
                                 use_pallas=True)
    with t_driver.capture_launches() as tl:
        th = t_linear_recurrence(ta, tb, config=cfg)
    assert _asdicts(tl) == _asdicts(jl)
    assert len(tl) == (3 if n // cfg["tile_n"] > 64 else 1)
    assert_kernel_close(_np(th), _np(jh), dtype)


@pytest.mark.parametrize("batch,n", ODD_BATCH_SHAPES + ((3, 97), (4, 1),
                                                        (2, 2)))
def test_linrec_rows_matches_repro(pinned, batch, n):
    """The building block the LF sweeps call: the tuned kernels for even
    n, the associative-scan reference for odd n, b itself for n <= 1 —
    the JAX package's routing, with its launch list."""
    (ja, jb), (ta, tb) = _pairs(f"linrecrows{batch}x{n}", batch, n)
    with j_driver.capture_launches() as jl:
        jh = j_driver.linrec_rows(ja, jb, use_pallas=True, interpret=True)
    with t_driver.capture_launches() as tl:
        th = t_driver.linrec_rows(ta, tb)
    assert _asdicts(tl) == _asdicts(jl)
    assert len(tl) == (0 if n % 2 or n < 2 else 1)
    assert_kernel_close(_np(th), _np(jh), "float32")


@pytest.mark.parametrize("n", [1, 2, 5, 64, 97, 256])
def test_linrec_refs_match_repro(n):
    (ja, jb), (ta, tb) = _pairs(f"linrecref{n}", 3, n)
    for jf, tf in ((j_ref.scan_linrec_ref, t_ref.scan_linrec_ref),
                   (j_ref.scan_linrec_assoc_ref, t_ref.scan_linrec_assoc_ref)):
        assert_kernel_close(_np(tf(ta, tb)), _np(jf(ja, jb)), "float32")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 16, 17, 64, 100, 257])
def test_associative_scan_follows_jax_recursion(n):
    """A combine that is associative only up to rounding (the linrec pair
    monoid) and one that is exact (an integer matrix product): the port's
    odd/even recursion gives JAX's results."""
    (ja, jb), (ta, tb) = _pairs(f"assoc{n}", 2, n)

    def jcombine(l, r):
        return l[0] * r[0], r[0] * l[1] + r[1]

    def tcombine(l, r):
        return l[0] * r[0], r[0] * l[1] + r[1]

    jres = jax.lax.associative_scan(jcombine, (ja, jb), axis=-1)
    tres = associative_scan(tcombine, (ta, tb), dim=-1)
    for j, t in zip(jres, tres):
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-6, atol=1e-6)
    # non-commutative and exact: 2x2 integer matrices mod 7, newer @ older
    m = _rng(f"assocmat{n}").integers(0, 7, size=(4, n)).astype(np.int32)

    def matmul(x, y):
        return ((y[0] * x[0] + y[1] * x[2]) % 7,
                (y[0] * x[1] + y[1] * x[3]) % 7,
                (y[2] * x[0] + y[3] * x[2]) % 7,
                (y[2] * x[1] + y[3] * x[3]) % 7)

    jm = jax.lax.associative_scan(matmul, tuple(jnp.asarray(v) for v in m))
    tm = associative_scan(matmul, tuple(torch.from_numpy(v) for v in m),
                          dim=0)
    for j, t in zip(jm, tm):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_cpu_path_counts_no_kernel_launch():
    before = (scan_linrec.launches, scan_linrec_prod.launches,
              t_driver.apply_linrec.launches)
    a, b = torch.rand(4, 2 ** 14) * 0.19 + 0.8, torch.randn(4, 2 ** 14)
    t_linear_recurrence(a, b, config={"tile_n": 128, "rows_per_program": 2,
                                      "radix": 2})
    assert (scan_linrec.launches, scan_linrec_prod.launches,
            t_driver.apply_linrec.launches) == before


@pytest.mark.parametrize("a_shape,b_shape,kwargs,err", [
    ((8, 64), (8, 32), {"tile_n": 64, "stages": (2,) * 6}, ValueError),
    ((8, 64), (8, 64), {"tile_n": 48, "stages": (2, 2, 2, 2, 3)},
     ValueError),                                            # 48 !| 64
    ((8, 64), (8, 64), {"tile_n": 64, "stages": (2, 2)}, ValueError),
    ((8, 64), (8, 64), {"tile_n": 64, "stages": (2,) * 6,
                        "rows_per_program": 3}, ValueError),  # 3 !| 8
])
def test_scan_linrec_rejects_what_the_kernel_does_not_take(a_shape, b_shape,
                                                           kwargs, err):
    kwargs = {"rows_per_program": 2, **kwargs}
    with pytest.raises(err):
        scan_linrec(torch.rand(*a_shape), torch.rand(*b_shape), **kwargs)


def test_scan_linrec_rejects_mixed_or_other_dtypes():
    kw = {"rows_per_program": 2, "tile_n": 64, "stages": (2,) * 6}
    with pytest.raises(TypeError):
        scan_linrec(torch.rand(4, 64, dtype=torch.float64),
                    torch.rand(4, 64, dtype=torch.float64), **kw)
    with pytest.raises(TypeError):
        scan_linrec(torch.rand(4, 64), torch.rand(4, 64).bfloat16(), **kw)
