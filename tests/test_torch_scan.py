"""The port's prefix-sum path on the CPU against the JAX package's.

A CPU tensor runs the CUDA kernels' plain versions through the same plan,
so this is where the kernels' arithmetic (stage loop, fold order, carry
chain, multipass driver) and their launch lists are held against the
Pallas kernels, run in interpret mode.  Inputs are made with numpy from
the seeds the shared differential suite uses and handed to both packages.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ODD_BATCH_SHAPES, _rng, assert_kernel_close
from repro.core.space import Workload as JWorkload
from repro.kernels.blocks import driver as j_driver
from repro.kernels.blocks.plan import plan_for as j_plan_for
from repro.kernels.scan.kernel import scan_add_pallas
from repro.kernels.scan.ops import prefix_sum as j_prefix_sum
from repro.tuning import default_session as j_default_session
from repro_torch.core.space import Workload as TWorkload
from repro_torch.kernels.blocks import driver as t_driver
from repro_torch.kernels.blocks.plan import plan_for as t_plan_for
from repro_torch.kernels.blocks.plan import stage_radices
from repro_torch.kernels.scan.kernel import scan_add, scan_add_plain
from repro_torch.kernels.scan.ops import prefix_sum as t_prefix_sum
from repro_torch.kernels.scan.ref import scan_add_ref
from repro_torch.tuning import default_session as t_default_session

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(tag, batch, n, dtype):
    """The same values for both packages: numpy f32, then each package's
    own f32 -> dtype rounding (both round to nearest even)."""
    arr = _rng(tag).normal(size=(batch, n)).astype(np.float32)
    return (jnp.asarray(arr).astype(_JNP[dtype]),
            torch.from_numpy(arr).to(_TORCH[dtype]))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _asdicts(launches):
    return [dataclasses.asdict(l) for l in launches]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n", ODD_BATCH_SHAPES)
def test_prefix_sum_matches_repro(dtype, batch, n):
    """Each package through its own default session: the outputs agree at
    DTYPE_TOL, and each side launches exactly its plan's launch list."""
    jx, tx = _inputs(f"scan{batch}x{n}", batch, n, dtype)
    with j_driver.capture_launches() as jl:
        jy = j_prefix_sum(jx, interpret=True, use_pallas=True)
    with t_driver.capture_launches() as tl:
        ty = t_prefix_sum(tx)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    assert_kernel_close(_np(ty), _np(jy), dtype)
    assert_kernel_close(_np(ty), _np(scan_add_ref(tx.double())), dtype)
    jwl = JWorkload(op="scan", n=n, batch=batch, variant="ks")
    twl = TWorkload(op="scan", n=n, batch=batch, variant="ks")
    assert tuple(jl) == j_plan_for(jwl, j_default_session().resolve(jwl)
                                   ).launches
    assert tuple(tl) == t_plan_for(twl, t_default_session().resolve(twl)
                                   ).launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n,cfg", [
    (7, 96, {"tile_n": 96, "rows_per_program": 7, "radix": 8, "unroll": 1}),
    (3, 256, {"tile_n": 128, "rows_per_program": 1, "radix": 4,
              "unroll": 2}),
    # 2^14 / 128 = 128 column tiles > 64: the three-launch multipass plan
    (4, 2 ** 14, {"tile_n": 128, "rows_per_program": 2, "radix": 4,
                  "unroll": 2}),
    (6, 2 ** 13, {"tile_n": 64, "rows_per_program": 3, "radix": 8,
                  "unroll": 8}),
])
def test_prefix_sum_explicit_config_matches_repro(dtype, batch, n, cfg):
    """One config for both packages: identical launch lists (fused and
    multipass), outputs at DTYPE_TOL."""
    jx, tx = _inputs(f"scancfg{batch}x{n}", batch, n, dtype)
    with j_driver.capture_launches() as jl:
        jy = j_prefix_sum(jx, config=cfg, interpret=True, use_pallas=True)
    with t_driver.capture_launches() as tl:
        ty = t_prefix_sum(tx, config=cfg)
    assert _asdicts(tl) == _asdicts(jl)
    twl = TWorkload(op="scan", n=n, batch=batch, variant="ks")
    plan = t_plan_for(twl, t_default_session().resolve(twl, config=cfg))
    assert tuple(tl) == plan.launches
    assert plan.kind == ("multipass" if n // cfg["tile_n"] > 64 else "fused")
    assert_kernel_close(_np(ty), _np(jy), dtype)


def test_prefix_sum_of_a_sliced_input_matches_repro():
    """A column slice (not contiguous) reads as its values, as in repro."""
    jx, tx = _inputs("scanslice", 6, 512, "float32")
    cfg = {"tile_n": 64, "rows_per_program": 2, "radix": 4, "unroll": 2}
    ts = tx[:, 128:384]
    assert not ts.is_contiguous()
    jy = j_prefix_sum(jx[:, 128:384], config=cfg, interpret=True,
                      use_pallas=True)
    assert_kernel_close(_np(t_prefix_sum(ts, config=cfg)), _np(jy),
                        "float32")


@pytest.mark.parametrize("unroll", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n,rows,tile_n,radix", [
    (7, 96, 7, 96, 8),          # ragged radix-8 stages (8, 4, 3)
    (3, 768, 1, 768, 8),        # (8, 8, 4, 3)
    (4, 512, 2, 128, 4),        # four column tiles: the carry chain
    (6, 256, 3, 64, 2),
    (5, 212, 5, 106, 2),        # a large prime fan-in: (2, 53)
])
def test_scan_add_body_matches_pallas(unroll, dtype, batch, n, rows, tile_n,
                                      radix):
    """The plain scan_add body (the CUDA kernel's function) against
    scan_add_pallas in interpret mode, explicit stages and unroll."""
    stages = stage_radices(tile_n, radix)
    jx, tx = _inputs(f"scanbody{batch}x{n}", batch, n, dtype)
    jy = scan_add_pallas(jx, rows_per_program=rows, tile_n=tile_n,
                         stages=stages, unroll=unroll, interpret=True)
    ty = scan_add(tx, rows_per_program=rows, tile_n=tile_n, stages=stages,
                  unroll=unroll)
    assert ty.dtype == tx.dtype
    assert_kernel_close(_np(ty), _np(jy), dtype)
    plain = scan_add_plain(tx, rows_per_program=rows, tile_n=tile_n,
                           stages=stages, unroll=unroll)
    assert torch.equal(plain, ty)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows_n,length,rows", [(12, 128, 4), (21, 96, 7),
                                                 (8, 1000, 1)])
def test_apply_add_matches_repro(out_dtype, rows_n, length, rows):
    rng = _rng(f"apply{rows_n}x{length}")
    y = rng.normal(size=(rows_n, length)).astype(np.float32)
    e = (100 * rng.normal(size=(rows_n, 1))).astype(np.float32)
    jy = j_driver._apply_add(jnp.asarray(y), jnp.asarray(e), rows=rows,
                             interpret=True).astype(_JNP[out_dtype])
    ty = t_driver.apply_add(torch.from_numpy(y), torch.from_numpy(e),
                            rows=rows, out_dtype=_TORCH[out_dtype])
    assert ty.dtype == _TORCH[out_dtype]
    assert_kernel_close(_np(ty), _np(jy), out_dtype)
    np.testing.assert_array_equal(_np(ty), _np(jy))


def test_cpu_path_counts_no_kernel_launch():
    """The counters count CUDA launches only: the plain versions on the CPU
    leave them where they were."""
    before = (scan_add.launches, t_driver.apply_add.launches)
    t_prefix_sum(torch.randn(4, 2 ** 14),
                 config={"tile_n": 128, "rows_per_program": 2, "radix": 2})
    assert (scan_add.launches, t_driver.apply_add.launches) == before


@pytest.mark.parametrize("kwargs,err", [
    ({"rows_per_program": 3, "tile_n": 64, "stages": (2,) * 6},
     ValueError),                                            # 3 !| 8 rows
    ({"rows_per_program": 2, "tile_n": 48, "stages": (2, 2, 2, 2, 3)},
     ValueError),                                            # 48 !| 64
    ({"rows_per_program": 2, "tile_n": 64, "stages": (2, 2)}, ValueError),
    ({"rows_per_program": 2, "tile_n": 64, "stages": (2,) * 6, "unroll": 0},
     ValueError),
])
def test_scan_add_rejects_what_the_kernel_does_not_take(kwargs, err):
    with pytest.raises(err):
        scan_add(torch.randn(8, 64), **kwargs)


def test_scan_add_rejects_other_dtypes():
    with pytest.raises(TypeError):
        scan_add(torch.randn(4, 64, dtype=torch.float64), tile_n=64,
                 rows_per_program=2, stages=(2,) * 6)


# ---------------------------------------------------------------------------
# A carry-scan tile longer than the kernels' staging (multipass launch 2)
# ---------------------------------------------------------------------------

def _long_carry_plan(n=2 ** 22, batch=2):
    """tile_n 128, rows 2 at n = 2^22: the carry scan's block is (2, 32768),
    65536 elements, twice the kernels' 32768-element staging."""
    cfg = {"tile_n": 128, "rows_per_program": 2, "radix": 2, "unroll": 1,
           "in_register": 0}
    wl = TWorkload(op="scan", n=n, batch=batch, variant="ks")
    h100 = importlib.import_module("repro_torch.hw.profiles").get_profile(
        "h100")
    plan = t_plan_for(wl, cfg, profile=h100)
    jplan = j_plan_for(JWorkload(op="scan", n=n, batch=batch, variant="ks"),
                       cfg)
    assert [dataclasses.asdict(l) for l in plan.launches] \
        == [dataclasses.asdict(l) for l in jplan.launches]
    return plan


def test_staged_piece_walks_a_long_tile_in_stage_prefixes():
    from repro_torch.kernels.scan.kernel import MAX_TILE_ELEMS, staged_piece
    plan = _long_carry_plan()
    l2 = plan.launches[1]
    rows, tile = l2.block_shape
    assert rows * tile > MAX_TILE_ELEMS
    piece, stages = staged_piece(rows, tile, l2.stages)
    assert rows * piece <= MAX_TILE_ELEMS and tile % piece == 0
    assert stages == l2.stages[:len(stages)] and int(np.prod(stages)) == piece
    assert staged_piece(2, 64, (4, 4, 4)) == (64, (4, 4, 4))
    assert staged_piece(4, 16384, (16,) * 3 + (4,)) == (4096, (16,) * 3)
    with pytest.raises(ValueError, match="staging"):
        staged_piece(4096, 64, (16, 4))


def test_multipass_scan_with_a_long_carry_tile():
    """The plan that raised on the card: launch list equal to the plan's
    (and to JAX's), the sum equal to a float64 cumsum."""
    plan = _long_carry_plan()
    x = torch.from_numpy(_rng("longcarry").normal(size=(2, 2 ** 22)).astype(
        np.float32))
    with t_driver.capture_launches() as got:
        y = t_driver.multipass_scan_add(x, plan)
    assert tuple(got) == plan.launches
    assert_kernel_close(y.numpy(), np.cumsum(x.double().numpy(), axis=-1),
                        "float32")


def test_multipass_linrec_with_a_long_carry_tile():
    from repro_torch.kernels.scan.ref import scan_linrec_assoc_ref
    plan = _long_carry_plan()
    rng = _rng("longcarrylinrec")
    a = torch.from_numpy(rng.uniform(0.9, 1.0, size=(2, 2 ** 22)).astype(
        np.float32))
    b = torch.from_numpy(rng.normal(size=(2, 2 ** 22)).astype(np.float32))
    with t_driver.capture_launches() as got:
        h = t_driver.multipass_linrec(a, b, plan)
    assert tuple(got) == plan.launches
    ref = scan_linrec_assoc_ref(a.double(), b.double())
    assert_kernel_close(h.numpy(), ref.numpy(), "float32")


@pytest.mark.parametrize("linrec", [False, True])
def test_a_long_carry_tile_equals_its_pieces(linrec):
    """The plain version of a carrying tile over the staging is, bit for
    bit, the same call at the piece tile (what the kernels launch)."""
    from repro_torch.kernels.scan.kernel import (scan_linrec_plain,
                                                 staged_piece)
    rng = _rng(f"pieces{linrec}")
    x = torch.from_numpy(rng.normal(size=(4, 2 ** 16)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.9, 1.0, size=x.shape).astype(
        np.float32))
    stages = (4,) * 8
    piece, pstages = staged_piece(2, 2 ** 16, stages)
    if linrec:
        got = scan_linrec_plain(a, x, rows_per_program=2, tile_n=2 ** 16,
                                stages=stages)
        want = scan_linrec_plain(a, x, rows_per_program=2, tile_n=piece,
                                 stages=pstages)
    else:
        got = scan_add_plain(x, rows_per_program=2, tile_n=2 ** 16,
                             stages=stages)
        want = scan_add_plain(x, rows_per_program=2, tile_n=piece,
                              stages=pstages)
    assert piece == 2 ** 14 and torch.equal(got, want)
