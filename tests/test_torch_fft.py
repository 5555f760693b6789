"""The port's FFT on the CPU against the JAX package's.

A CPU tensor runs the Stockham kernel's plain version (``fft_plain``)
through the same plans and launch lists as the card, so this is where
``fft``, ``ifft`` and the four-step driver are held against the JAX
package (its Pallas Stockham kernel in interpret mode).  Inputs are made
with numpy and handed to both packages; outputs agree within
``DTYPE_TOL["complex64"]`` (relative to the output's magnitude).

The entry point picks its path with ``max_resident_tile`` under the
*active* profile of each package (``REPRO_HW_PROFILE``, default tpu_v5e;
``REPRO_TORCH_HW_PROFILE``, default h100), so every entry-level test sets
both variables to one profile and pins both default sessions to it.
"""
import dataclasses
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ODD_BATCH_SHAPES, _rng, assert_kernel_close
from repro import tuning as j_tuning
from repro.core.space import Workload as JWorkload
from repro.kernels.blocks import driver as j_driver
from repro.kernels.blocks.plan import plan_for as j_plan_for
from repro.kernels.fft import ops as j_ops
from repro.kernels.fft import ref as j_ref
from repro.kernels.fft.kernel import fft_pallas
from repro_torch import tuning as t_tuning
from repro_torch.core.multikernel import max_resident_tile
from repro_torch.core.space import Workload as TWorkload
from repro_torch.kernels.blocks import driver as t_driver
from repro_torch.kernels.blocks.plan import plan_for as t_plan_for
from repro_torch.kernels.blocks.plan import stage_radices
from repro_torch.kernels.blocks.primitives import round_f32
from repro_torch.kernels.fft import ops as t_ops
from repro_torch.kernels.fft import ref as t_ref
from repro_torch.kernels.fft.kernel import (PassLayout, fft_pass,
                                            fft_pass_plain, fft_plain,
                                            fft_stockham, pass_problems)

j_hw = importlib.import_module("repro.hw.profiles")
t_hw = importlib.import_module("repro_torch.hw.profiles")

SIZES = (64, 96, 106, 128, 256, 1000, 1024)
RADICES = (2, 4, 8, 16)
BATCHES = tuple(b for b, _ in ODD_BATCH_SHAPES)          # 3, 7, 5


def _complex(tag, batch, n):
    rng = _rng(tag)
    x = (rng.normal(size=(batch, n))
         + 1j * rng.normal(size=(batch, n))).astype(np.complex64)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.numpy()
    return np.asarray(t)


def _asdicts(launches):
    return [dataclasses.asdict(l) for l in launches]


def _pin(monkeypatch, tmp_path, profile):
    """Both packages on ``profile``: active profiles and default sessions
    (empty DBs), so they resolve the same configs and take the same path."""
    monkeypatch.setenv("REPRO_HW_PROFILE", profile)
    monkeypatch.setenv("REPRO_TORCH_HW_PROFILE", profile)
    jprev = j_tuning.set_default_session(j_tuning.TunerSession(
        db_path=str(tmp_path / "jax.json"), spec=j_hw.get_profile(profile)))
    tprev = t_tuning.set_default_session(t_tuning.TunerSession(
        db_path=str(tmp_path / "torch.json"),
        spec=t_hw.get_profile(profile)))
    return jprev, tprev


@pytest.fixture
def pinned(monkeypatch, tmp_path):
    jprev, tprev = _pin(monkeypatch, tmp_path, "tpu_v5e")
    yield
    j_tuning.set_default_session(jprev)
    t_tuning.set_default_session(tprev)


@pytest.fixture
def pinned_gpu_sm(monkeypatch, tmp_path):
    jprev, tprev = _pin(monkeypatch, tmp_path, "gpu_sm")
    yield
    j_tuning.set_default_session(jprev)
    t_tuning.set_default_session(tprev)


def _entry_pair(xj, xt, *, inverse, config=None):
    """Run both packages' entry points; return outputs and launch lists."""
    jfn, tfn = (j_ops.ifft, t_ops.ifft) if inverse else (j_ops.fft,
                                                          t_ops.fft)
    with j_driver.capture_launches() as jl:
        jy = jfn(xj, config=config, interpret=True)
    with t_driver.capture_launches() as tl:
        ty = tfn(xt, config=config)
    return jy, ty, jl, tl


@pytest.mark.parametrize("radix", RADICES)
@pytest.mark.parametrize("n", SIZES)
def test_fft_matches_repro(pinned, n, radix):
    """Forward, rows 1, an odd batch: outputs and launch lists agree."""
    batch = BATCHES[SIZES.index(n) % len(BATCHES)]
    xj, xt = _complex(f"fft{batch}x{n}", batch, n)
    cfg = {"radix": radix, "rows_per_program": 1}
    jy, ty, jl, tl = _entry_pair(xj, xt, inverse=False, config=cfg)
    assert ty.dtype == torch.complex64 and ty.shape == (batch, n)
    assert_kernel_close(_np(ty), _np(jy), "complex64")
    assert _asdicts(tl) == _asdicts(jl)
    # fused up to the resident cap, else four-step (n = 1000 > 512, the
    # cap below it: n1 = 8, n2 = 125)
    cap = max_resident_tile(TWorkload(op="fft", n=n, batch=batch))
    plan = t_ops.fft_plan(batch, n, cfg)
    assert tuple(tl) == plan.launches
    assert plan.kind == ("fused" if n <= cap else "multipass")
    if n <= cap:
        assert plan.stages == stage_radices(n, radix)


# n = 106 = 2 * 53 is held against the JAX package once, forward
# (test_fft_matches_repro; every radix gives the stages (2, 53) there): its
# 53-point stage takes the JAX Pallas interpreter half a minute to compile
# per shape and direction.  The port's own checks below cover it both ways.
SIZES_NO_PRIME = tuple(n for n in SIZES if n != 106)


@pytest.mark.parametrize("n", SIZES_NO_PRIME)
def test_fft_two_rows_a_block_matches_repro(pinned, n):
    """rows_per_program = 2 on an even batch (twice an odd one)."""
    batch = 2 * BATCHES[SIZES.index(n) % len(BATCHES)]
    xj, xt = _complex(f"fft2r{batch}x{n}", batch, n)
    cfg = {"radix": 8, "rows_per_program": 2}
    jy, ty, jl, tl = _entry_pair(xj, xt, inverse=False, config=cfg)
    assert_kernel_close(_np(ty), _np(jy), "complex64")
    assert _asdicts(tl) == _asdicts(jl)
    assert all(l.block_shape[0] == 2 for l in tl)


@pytest.mark.parametrize("n", SIZES_NO_PRIME)
def test_ifft_matches_repro(pinned, n):
    batch = BATCHES[(SIZES.index(n) + 1) % len(BATCHES)]
    xj, xt = _complex(f"ifft{batch}x{n}", batch, n)
    cfg = {"radix": 4, "rows_per_program": 1}
    jy, ty, jl, tl = _entry_pair(xj, xt, inverse=True, config=cfg)
    assert_kernel_close(_np(ty), _np(jy), "complex64")
    assert _asdicts(tl) == _asdicts(jl)


@pytest.mark.parametrize("radix", RADICES)
@pytest.mark.parametrize("n", SIZES)
def test_ifft_fft_round_trip(n, radix):
    """ifft(fft(x)) = x on the port's path (h100, the default profile)."""
    _, xt = _complex(f"trip{n}", 3, n)
    cfg = {"radix": radix, "rows_per_program": 1}
    back = t_ops.ifft(t_ops.fft(xt, config=cfg), config=cfg)
    assert_kernel_close(back.numpy(), xt.numpy(), "complex64")


@pytest.mark.parametrize("radix", RADICES)
@pytest.mark.parametrize("n", SIZES)
def test_plain_stockham_against_a_complex128_dft(n, radix):
    """fft_plain over every stage sequence (ragged and prime tails
    included), forward and inverse, against torch.fft in complex128."""
    _, xt = _complex(f"plain{n}", 2, n)
    stages = stage_radices(n, radix)
    ref = torch.fft.fft(xt.to(torch.complex128))
    got = fft_plain(xt, rows_per_program=1, stages=stages)
    assert_kernel_close(got.numpy(), ref.numpy(), "complex64")
    inv = fft_plain(got, rows_per_program=2, stages=stages, inverse=True)
    assert_kernel_close(inv.numpy(), xt.numpy(), "complex64")


@pytest.mark.parametrize("n,radix,batch,rows,inverse", [
    (96, 8, 7, 1, False), (96, 8, 7, 1, True), (106, 2, 5, 1, False),
    (1000, 8, 7, 7, False), (1000, 8, 7, 7, True), (256, 16, 7, 7, False),
    (256, 16, 7, 7, True)])
def test_fft_stockham_matches_fft_pallas(n, radix, batch, rows, inverse):
    """The wrapper (plain version on the CPU) against the Pallas kernel on
    the same stage sequence: the ragged (8, 6, 2), prime (2, 53) and
    (8, 5, 5, 5) tails."""
    xj, xt = _complex(f"stock{n}", batch, n)
    stages = stage_radices(n, radix)
    yr, yi = fft_pallas(jnp.real(xj), jnp.imag(xj), rows_per_program=rows,
                        stages=stages, inverse=inverse, interpret=True)
    got = fft_stockham(xt, rows_per_program=rows, stages=stages,
                       inverse=inverse)
    assert_kernel_close(got.numpy(), np.asarray(yr) + 1j * np.asarray(yi),
                        "complex64")


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m,tile,max_tile", [(2, 64, 64), (3, 16, 16)])
def test_four_step_fft_matches_repro(m, tile, max_tile, inverse):
    """four_step_fft at n = 4096 driven on purpose: m = 2 (n1 = n2 = 64)
    and m = 3 (n1 = 16, n2 = 256 > max_tile recurses into 16 x 16)."""
    batch, n = 3, 4096
    xj, xt = _complex(f"four{m}", batch, n)
    cfg = {"tile_n": tile, "radix": 4, "rows_per_program": 2, "unroll": 1,
           "in_register": 0}
    jwl = JWorkload(op="large_fft", n=n, batch=batch, variant="stockham")
    twl = TWorkload(op="large_fft", n=n, batch=batch, variant="stockham")
    jplan = j_plan_for(jwl, cfg, max_tile=max_tile)
    tplan = t_plan_for(twl, cfg, max_tile=max_tile)
    assert tplan.passes == len(tplan.launches) == m
    with j_driver.capture_launches() as jl:
        jy = j_driver.four_step_fft(xj, jplan, inverse=inverse,
                                    interpret=True)
    with t_driver.capture_launches() as tl:
        ty = t_driver.four_step_fft(xt, tplan, inverse=inverse)
    assert_kernel_close(_np(ty), _np(jy), "complex64")
    assert _asdicts(tl) == _asdicts(jl) == _asdicts(tplan.launches)
    ref = torch.fft.ifft(xt.to(torch.complex128)) if inverse \
        else torch.fft.fft(xt.to(torch.complex128))
    assert_kernel_close(ty.numpy(), ref.numpy(), "complex64")


def _torch_op_four_step(x, plan, inverse):
    """The four-step as torch ops around the row kernel's plain version:
    transpose the columns out, transform, multiply the twiddle table in,
    transform the rows, transpose back (the driver's dataflow before each
    pass read and wrote device memory once)."""
    if plan.kind == "fused":
        return fft_plain(x, rows_per_program=plan.rows, stages=plan.stages,
                         inverse=inverse)
    col, row = plan.children
    batch, n = x.shape
    n1, n2 = row.n, col.n
    vc = x.reshape(batch, n2, n1).transpose(1, 2).reshape(batch * n1, n2)
    vc = _torch_op_four_step(vc, col, inverse)
    k = torch.arange(n2).reshape(n2, 1) * torch.arange(n1).reshape(1, n1)
    ang = k.to(torch.float32) \
        * round_f32((1.0 if inverse else -1.0) * 2.0 * math.pi) / n
    v = vc.reshape(batch, n1, n2).transpose(1, 2) \
        * torch.polar(torch.ones_like(ang), ang)
    vr = _torch_op_four_step(v.reshape(batch * n2, n1), row, inverse)
    return vr.reshape(batch, n2, n1).transpose(1, 2).reshape(batch, n)


def _forced_plan(m, batch, rows):
    """n = 4096 on m = 2 (64 x 64) or m = 3 (16 x (16 x 16)) passes."""
    tile = {2: 64, 3: 16}[m]
    cfg = {"tile_n": tile, "radix": 4, "rows_per_program": rows,
           "unroll": 1, "in_register": 0}
    plan = t_plan_for(TWorkload(op="large_fft", n=4096, batch=batch,
                                variant="stockham"), cfg, max_tile=tile)
    assert plan.passes == m
    return plan


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", [2, 3])
def test_four_step_passes_match_the_torch_op_composition(m, inverse, rows):
    """The driver's passes (``fft_pass_plain`` on the CPU) against the
    torch-op four-step and the one-level oracle ``four_step_ref``."""
    batch = 4
    plan = _forced_plan(m, batch, rows)
    _, xt = _complex(f"passes{m}{rows}", batch, 4096)
    with t_driver.capture_launches() as tl:
        got = t_driver.four_step_fft(xt, plan, inverse=inverse)
    assert tuple(tl) == plan.launches
    assert got.dtype == torch.complex64 and got.shape == xt.shape
    assert_kernel_close(got.numpy(),
                        _torch_op_four_step(xt, plan, inverse).numpy(),
                        "complex64")
    n1 = plan.children[1].n
    if inverse:
        # the oracle's forward, conjugated: ifft(x) = conj(fft(conj x)) / n
        ref = t_ref.four_step_ref(xt.conj().to(torch.complex128), n1).conj() \
            / 4096
    else:
        ref = t_ref.four_step_ref(xt.to(torch.complex128), n1)
    assert_kernel_close(got.numpy(), ref.numpy(), "complex64")


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", [2, 3])
def test_each_pass_is_its_plain_twin(m, inverse):
    """Pass by pass, ``fft_pass`` on a CPU tensor is ``fft_pass_plain``,
    and chaining the passes is the driver; the wrapper counts no launch
    there."""
    plan = _forced_plan(m, 2, 2)
    _, z = _complex(f"twin{m}", 2, 4096)
    x = z
    before = fft_pass.launches
    for sub, layout in t_driver.four_step_passes(plan):
        kw = dict(stages=sub.stages, inverse=inverse)
        y = fft_pass(z, layout, **kw)
        assert torch.equal(y, fft_pass_plain(z, layout, **kw))
        z = y
    assert fft_pass.launches == before
    assert torch.equal(z, t_driver.four_step_fft(x, plan, inverse=inverse))


@pytest.mark.parametrize("m", [2, 3])
def test_each_pass_reads_and_writes_every_element_once(m):
    """A pass's reads and its writes are each a permutation of the batch
    item; the twiddled passes are the column side's last ones."""
    plan = _forced_plan(m, 1, 1)
    passes = t_driver.four_step_passes(plan)
    assert [sub for sub, _ in passes] == [p for p in _fused_leaves(plan)]
    for _, layout in passes:
        c = np.arange(layout.problems).reshape(-1, 1)
        t = np.arange(layout.n).reshape(1, -1)
        for hs, ps in ((layout.in_hs, layout.in_ps),
                       (layout.out_hs, layout.out_ps)):
            at = c // layout.lo * hs + c % layout.lo + t * ps
            assert sorted(at.ravel().tolist()) == list(range(4096))
    assert [layout.tw_n for _, layout in passes] == \
        ([4096, 0] if m == 2 else [256, 4096, 0])


def _fused_leaves(plan):
    if plan.kind == "fused":
        return [plan]
    return [leaf for child in plan.children for leaf in _fused_leaves(child)]


def test_pass_tiles_on_the_cells_plans():
    """The h100 plans of the large FFT sizes: every pass on the pass kernel
    with tiles of at least 4 adjacent problems (runs of 32 bytes or more);
    a row that is no power of two is left to the composed pass."""
    for n in (65536, 1 << 20, 1 << 23):
        plan = t_ops.fft_plan((1 << 26) // n, n)
        assert plan.kind == "multipass"
        for sub, layout in t_driver.four_step_passes(plan):
            assert pass_problems(layout, sub.stages) >= 4
    ragged = PassLayout(total=3 * 4096, n=3, lo=4096, in_ps=4096,
                        in_hs=3 * 4096, out_ps=4096, out_hs=3 * 4096)
    assert pass_problems(ragged, (3,)) == 0


def test_pass_problems_refuses_what_the_kernel_cannot_address():
    """A power-of-two row at a stride that is no power of two is left to
    the composed pass (0); a batch item of 2^31 points, which the kernel
    cannot address in 32 bits, raises instead of taking a slower route."""
    rows = PassLayout(total=3 * 4096, n=4096, lo=1, in_ps=1, in_hs=4096,
                      out_ps=3, out_hs=1)
    assert pass_problems(rows, stage_radices(4096, 16)) == 0
    huge = PassLayout(total=1 << 31, n=4096, lo=1, in_ps=1, in_hs=4096,
                      out_ps=1 << 19, out_hs=1)
    with pytest.raises(ValueError, match="32 bits"):
        pass_problems(huge, stage_radices(4096, 16))


def test_entry_point_takes_the_four_step_path(pinned_gpu_sm):
    """Above the resident cap (32768 points under gpu_sm) both entry
    points resolve op="large_fft" and run the same four-step launches."""
    n = 65536
    xj, xt = _complex("entry-four-step", 1, n)
    jy, ty, jl, tl = _entry_pair(xj, xt, inverse=False)
    assert_kernel_close(_np(ty), _np(jy), "complex64")
    assert _asdicts(tl) == _asdicts(jl)
    assert len(tl) == 2
    ref = torch.fft.fft(xt.to(torch.complex128))
    assert_kernel_close(ty.numpy(), ref.numpy(), "complex64")


def test_refs_match_repro():
    xj, xt = _complex("refs", 3, 256)
    assert_kernel_close(t_ref.fft_ref(xt).numpy(), _np(j_ref.fft_ref(xj)),
                        "complex64")
    for radix in (2, 4):
        assert_kernel_close(t_ref.stockham_plain(xt, radix).numpy(),
                            _np(j_ref.stockham_jnp(xj, radix)), "complex64")
    assert_kernel_close(t_ref.four_step_ref(xt, 16).numpy(),
                        _np(j_ref.four_step_ref(xj, 16)), "complex64")


def test_fft_takes_real_input(pinned):
    """A real input is transformed as a complex one with zero imaginary
    part, as in the JAX package."""
    rng = _rng("real-fft")
    x = rng.normal(size=(3, 128)).astype(np.float32)
    jy = j_ops.fft(jnp.asarray(x), config={"radix": 4}, interpret=True)
    ty = t_ops.fft(torch.from_numpy(x), config={"radix": 4})
    assert ty.dtype == torch.complex64
    assert_kernel_close(ty.numpy(), _np(jy), "complex64")


def test_fft_stockham_rejects_bad_arguments():
    x = torch.zeros(4, 64, dtype=torch.complex64)
    with pytest.raises(ValueError, match="must divide"):
        fft_stockham(x, rows_per_program=3, stages=(4, 4, 4))
    with pytest.raises(ValueError, match="multiply to"):
        fft_stockham(x, rows_per_program=1, stages=(4, 4))
    with pytest.raises(TypeError, match="complex"):
        fft_stockham(x.real.contiguous(), rows_per_program=1,
                     stages=(4, 4, 4))
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        fft_stockham(torch.empty(4, 64, dtype=torch.complex64,
                                 device="meta"),
                     rows_per_program=1, stages=(4, 4, 4))
