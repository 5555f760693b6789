"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test asks the ``cuda`` fixture for the card and
skips where there is none.  On a machine with an H100 run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(``python3 chip_smoke.py`` runs the same checks at the paper's sizes).
"""
import pytest
import torch

from conftest import assert_kernel_close
from repro_torch.kernels.blocks import driver
from repro_torch.core.space import Workload
from repro_torch.kernels.blocks.plan import plan_for, stage_radices
from repro_torch.kernels.fft import ops as fft_ops
from repro_torch.kernels.fft.kernel import (fft_generic, fft_plain,
                                            fft_route, fft_stockham)
from repro_torch.kernels.scan import kernel as scan_kernel
from repro_torch.kernels.scan.kernel import (linrec_route, scan_add,
                                             scan_add_block, scan_add_plain,
                                             scan_linrec, scan_linrec_plain,
                                             scan_linrec_prod,
                                             scan_linrec_prod_plain,
                                             scan_route, staged_piece)
from repro_torch.kernels.scan.ops import linear_recurrence, prefix_sum
from repro_torch.kernels.scan.ref import scan_linrec_assoc_ref
from repro_torch.kernels.tridiag import ops as tridiag_ops
from repro_torch.kernels.tridiag import kernel as pcr_kernel
from repro_torch.kernels.tridiag.kernel import (pcr, pcr_plain, pcr_route,
                                                thomas)
from repro_torch.kernels.tridiag.ref import (random_system, residual,
                                             thomas_ref)

pytestmark = pytest.mark.cuda

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _linrec_block(a, b, rows, tile_n, stages, gate=False, products=False):
    """The block linrec kernel forced (its record beside the warp kernel):
    h, or (h, products)."""
    out = scan_kernel._launch_linrec(a, b, rows, tile_n, tuple(stages), gate,
                                     products, route="block")
    return out if products else out[0]


def _pcr_block(planes, rows, unroll=1):
    """The block PCR kernel forced, as _linrec_block (unroll capped at its
    16 equations a thread: the knob changes no result)."""
    return pcr_kernel._launch(tuple(v.contiguous() for v in planes), rows,
                              min(unroll, 16), route="block")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _close(got, ref, dtype):
    assert_kernel_close(got.float().cpu().numpy(), ref.float().cpu().numpy(),
                        dtype)


@pytest.mark.parametrize("unroll", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n,rows,tile_n,radix", [
    (7, 96, 7, 96, 8), (4, 512, 2, 128, 4), (5, 212, 5, 106, 2),
    (8, 16384, 1, 16384, 2)])
def test_scan_add_kernel_matches_plain(cuda, unroll, dtype, batch, n, rows,
                                       tile_n, radix):
    gen = torch.Generator(device=cuda).manual_seed(batch * n)
    x = torch.randn(batch, n, generator=gen, device=cuda).to(_TORCH[dtype])
    stages = stage_radices(tile_n, radix)
    before = scan_add.launches
    got = scan_add(x, rows_per_program=rows, tile_n=tile_n, stages=stages,
                   unroll=unroll)
    assert scan_add.launches == before + 1
    ref = scan_add_plain(x, rows_per_program=rows, tile_n=tile_n,
                         stages=stages, unroll=unroll)
    _close(got, ref, dtype)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n,rows,tile_n,stages", [
    # fan-in 2, 4 and 8 at tiles 32 (the block kernel), 128 and 1024
    *[(8, 1024, 2, t, stage_radices(t, r)) for t in (32, 128, 1024)
      for r in (2, 4, 8)],
    (16, 4096, 4, 256, stage_radices(256, 4)),       # multi-tile carry
    (4, 8192, 1, 1024, stage_radices(1024, 8)),      # 8 tiles of one warp
    (8, 8192, 2, 2048, stage_radices(2048, 4)),      # rows over warps
    (4, 32768, 1, 32768, stage_radices(32768, 2)),   # 1024 threads
    (5, 212, 5, 106, (2, 53)),                       # prime stages
    (3, 1018, 3, 1018, (2, 509)),
    (16, 32768, 16, 32768, stage_radices(32768, 8)),  # a staged piece
])
def test_scan_kernels_are_bit_equal_to_plain(cuda, tree, dtype, batch, n,
                                             rows, tile_n, stages):
    """Both scan kernels keep scan_add_plain's order: every element equal,
    whichever route the plan takes (and the block kernel on the warp
    route's plans too)."""
    gen = torch.Generator(device=cuda).manual_seed(batch * n + tile_n)
    x = torch.randn(batch, n, generator=gen, device=cuda).to(_TORCH[dtype])
    kw = dict(rows_per_program=rows, tile_n=tile_n, stages=stages,
              unroll=4 if tree else 1)
    ref = scan_add_plain(x, **kw)
    assert torch.equal(scan_add(x, **kw), ref)
    assert torch.equal(scan_add_block(x, **kw), ref)


def test_scan_add_counts_its_route(cuda):
    """One call on each route adds one to its count and to the total;
    the block kernel's record entry counts nothing."""
    x = torch.randn(8, 1024, device=cuda)
    for stages, route in ((stage_radices(1024, 4), "warp"),
                          ((2, 4) + (2,) * 7, "block")):
        assert scan_route(2, 1024, stages) == route
        before = (scan_add.launches, scan_add.launches_warp,
                  scan_add.launches_block)
        scan_add(x, rows_per_program=2, tile_n=1024, stages=stages)
        after = (scan_add.launches, scan_add.launches_warp,
                 scan_add.launches_block)
        assert after[0] == before[0] + 1
        assert after[1:] == (before[1] + (route == "warp"),
                             before[2] + (route == "block"))
    before = scan_add.launches
    scan_add_block(x, rows_per_program=2, tile_n=1024,
                   stages=stage_radices(1024, 4))
    assert scan_add.launches == before


def test_prefix_sum_takes_a_sliced_input(cuda):
    """A column slice is not contiguous; the wrapper copies it, as the
    plain version on the CPU reads it, instead of refusing it."""
    x = torch.randn(32, 4096, device=cuda)[:, 1024:3072]
    assert not x.is_contiguous()
    cfg = {"tile_n": 512, "rows_per_program": 4, "radix": 4, "unroll": 2}
    got = prefix_sum(x, config=cfg)
    _close(got, torch.cumsum(x.double(), dim=-1), "float32")
    _close(got, prefix_sum(x.cpu(), config=cfg), "float32")


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_apply_add_kernel_matches_plain(cuda, out_dtype):
    y = torch.randn(96, 1000, device=cuda)
    e = torch.randn(96, 1, device=cuda)
    got = driver.apply_add(y, e, rows=3, out_dtype=_TORCH[out_dtype])
    ref = driver.apply_add_plain(y, e, rows=3, out_dtype=_TORCH[out_dtype])
    assert torch.equal(got, ref)


@pytest.mark.parametrize("cfg", [
    {"tile_n": 256, "rows_per_program": 4, "radix": 4, "unroll": 2},
    {"tile_n": 128, "rows_per_program": 2, "radix": 8, "unroll": 1}])
def test_prefix_sum_on_the_card(cuda, cfg):
    """Fused (n = 1024) and multipass (n = 2^15 / 128 = 256 tiles)."""
    for n in (1024, 2 ** 15):
        x = torch.randn(16, n, device=cuda)
        with driver.capture_launches() as launched:
            y = prefix_sum(x, config=cfg)
        assert len(launched) == (3 if n // cfg["tile_n"] > 64 else 1)
        _close(y, torch.cumsum(x.double(), dim=-1), "float32")


def _linrec_pair(gen, batch, n, dtype, device, slow=False):
    """a in [0.8, 0.99), or with ``slow`` in [0.9999, 1) (prefix products
    near 1, so every stage's neighbours show in h); b standard normal."""
    lo, width = (0.9999, 1e-4) if slow else (0.8, 0.19)
    a = torch.rand(batch, n, generator=gen, device=device) * width + lo
    b = torch.randn(batch, n, generator=gen, device=device)
    return a.to(_TORCH[dtype]), b.to(_TORCH[dtype])


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n,rows,tile_n,radix", [
    (7, 96, 7, 96, 8), (4, 512, 2, 128, 4), (5, 212, 5, 106, 2),
    (8, 16384, 1, 16384, 2), (2, 65536, 1, 32768, 8)])
def test_scan_linrec_kernel_matches_plain(cuda, gate, dtype, batch, n, rows,
                                          tile_n, radix):
    """32768 elements a block puts the stage planes in global scratch."""
    gen = torch.Generator(device=cuda).manual_seed(batch * n)
    a, b = _linrec_pair(gen, batch, n, dtype, cuda)
    kw = dict(rows_per_program=rows, tile_n=tile_n,
              stages=stage_radices(tile_n, radix), gate=gate)
    before = scan_linrec.launches
    got = scan_linrec(a, b, **kw)
    assert scan_linrec.launches == before + 1
    _close(got, scan_linrec_plain(a, b, **kw), dtype)


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n,rows,radix", [
    (96, 100, 3, 4), (512, 2048, 4, 2), (7, 106, 7, 2)])
def test_scan_linrec_prod_kernel_matches_plain(cuda, gate, dtype, batch, n,
                                               rows, radix):
    gen = torch.Generator(device=cuda).manual_seed(batch + n)
    a, b = _linrec_pair(gen, batch, n, dtype, cuda)
    kw = dict(rows_per_program=rows, stages=stage_radices(n, radix),
              gate=gate)
    before = scan_linrec_prod.launches
    h, p = scan_linrec_prod(a, b, **kw)
    assert scan_linrec_prod.launches == before + 1
    hr, pr = scan_linrec_prod_plain(a, b, **kw)
    _close(h, hr, dtype)
    _close(p, pr, dtype)


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n,rows,tile_n,stages", [
    # a warp a row at tiles 128 and 1024 (register stages), fan-ins 2, 4, 8
    *[(8, 1024, 2, t, stage_radices(t, r)) for t in (128, 1024)
      for r in (2, 4, 8)],
    (16, 4096, 4, 256, stage_radices(256, 4)),       # multi-tile carry
    (48, 64, 8, 16, stage_radices(16, 4)),           # two rows a warp
    (40, 64, 5, 4, stage_radices(4, 2)),             # a partial warp
    (8, 8192, 2, 2048, stage_radices(2048, 4)),      # rows over warps
    (4, 32768, 1, 32768, stage_radices(32768, 8)),   # global-scratch planes
    (16, 32768, 16, 32768, stage_radices(32768, 8)),  # a staged piece
    (5, 212, 5, 106, (2, 53)),                       # prime stages (block)
])
@pytest.mark.parametrize("slow", [False, True])
def test_linrec_kernels_are_bit_equal_to_plain(cuda, slow, gate, dtype, batch,
                                               n, rows, tile_n, stages):
    """Both linrec kernels keep scan_linrec_plain's order: every element
    equal, whichever route the plan takes (and the block kernel on the
    warp route's plans too)."""
    gen = torch.Generator(device=cuda).manual_seed(batch * n + tile_n)
    a, b = _linrec_pair(gen, batch, n, dtype, cuda, slow)
    kw = dict(rows_per_program=rows, tile_n=tile_n, stages=stages, gate=gate)
    ref = scan_linrec_plain(a, b, **kw)
    assert torch.equal(scan_linrec(a, b, **kw), ref)
    assert torch.equal(_linrec_block(a, b, rows, tile_n, stages, gate), ref)


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n,rows,radix", [
    (96, 128, 3, 4), (512, 2048, 4, 2), (64, 16, 8, 4), (2, 32768, 1, 8),
    (7, 106, 7, 2)])
def test_chunk_kernels_are_bit_equal_to_plain(cuda, gate, dtype, batch, n,
                                              rows, radix):
    """The chunk kernel's h and prefix products, on both routes."""
    gen = torch.Generator(device=cuda).manual_seed(batch + n + 1)
    a, b = _linrec_pair(gen, batch, n, dtype, cuda, slow=True)
    kw = dict(rows_per_program=rows, stages=stage_radices(n, radix),
              gate=gate)
    hr, pr = scan_linrec_prod_plain(a, b, **kw)
    for h, p in (scan_linrec_prod(a, b, **kw),
                 _linrec_block(a, b, rows, n, kw["stages"], gate,
                               products=True)):
        assert torch.equal(h, hr) and torch.equal(p, pr)


def test_linrec_kernels_count_their_route(cuda):
    """One call on each route adds one to its count and to the total; the
    block kernels forced for the record count nothing."""
    a, b = _linrec_pair(torch.Generator(device=cuda).manual_seed(9), 8,
                        1024, "float32", cuda)
    for stages, route in ((stage_radices(1024, 4), "warp"),
                          ((2, 4) + (2,) * 7, "block")):
        assert linrec_route(2, 1024, stages) == route
        for fn, kw in ((scan_linrec, dict(tile_n=1024)),
                       (scan_linrec_prod, {})):
            before = (fn.launches, fn.launches_warp, fn.launches_block)
            fn(a, b, rows_per_program=2, stages=stages, **kw)
            after = (fn.launches, fn.launches_warp, fn.launches_block)
            assert after == (before[0] + 1, before[1] + (route == "warp"),
                             before[2] + (route == "block"))
    before = (scan_linrec.launches, scan_linrec_prod.launches)
    stages = stage_radices(1024, 4)
    _linrec_block(a, b, 2, 1024, stages)
    _linrec_block(a, b, 2, 1024, stages, products=True)
    assert (scan_linrec.launches, scan_linrec_prod.launches) == before


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_apply_linrec_kernel_matches_plain(cuda, out_dtype):
    h = torch.randn(96, 1000, device=cuda)
    p = torch.rand(96, 1000, device=cuda)
    e = torch.randn(96, 1, device=cuda)
    got = driver.apply_linrec(h, p, e, rows=3, out_dtype=_TORCH[out_dtype])
    ref = driver.apply_linrec_plain(h, p, e, rows=3,
                                    out_dtype=_TORCH[out_dtype])
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n,rows,unroll", [
    (64, 1024, 4, 1), (6, 96, 3, 2), (10, 100, 5, 4), (8, 1, 2, 1),
    (4, 8192, 1, 1), (1024, 256, 16, 4), (96, 32, 3, 1), (40, 512, 5, 2),
    (16, 1024, 2, 32), (16, 1024, 4, 16), (64, 256, 8, 8), (32, 512, 4, 3)])
def test_pcr_kernel_matches_plain(cuda, dtype, batch, n, rows, unroll):
    """Both pcr kernels keep pcr_plain's order: every element equal,
    whichever route the plan takes (and the block kernel on the warp
    route's plans too); on the warp kernel 1 ... 32 equations a lane and
    1 ... 32 warps a system."""
    gen = torch.Generator(device=cuda).manual_seed(batch * n)
    planes = [v.to(_TORCH[dtype]) for v in random_system(gen, batch, n)]
    before = pcr.launches
    got = pcr(*planes, rows_per_program=rows, unroll=unroll)
    assert pcr.launches == before + 1
    ref = pcr_plain(*planes, rows_per_program=rows, unroll=unroll)
    assert torch.equal(got, ref)
    assert torch.equal(_pcr_block(planes, rows, unroll), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n,rows,unroll", [
    (64, 1024, 4, 4), (1024, 256, 16, 1), (96, 32, 3, 1), (40, 512, 5, 2),
    (6, 96, 3, 2)])
def test_pcr_kernels_are_bit_equal_on_a_laplacian(cuda, dtype, batch, n,
                                                  rows, unroll):
    """A perturbed 1-D Laplacian keeps its off-diagonals at every level
    (those of random_system underflow to 0 after a few), so every level's
    neighbours show in x."""
    gen = torch.Generator(device=cuda).manual_seed(batch + n)
    a, c = (-1.0 - 0.01 * torch.rand(batch, n, generator=gen, device=cuda)
            for _ in range(2))
    b = 2.03 + 0.01 * torch.rand(batch, n, generator=gen, device=cuda)
    d = torch.randn(batch, n, generator=gen, device=cuda)
    a[:, 0], c[:, -1] = 0.0, 0.0
    planes = [v.to(_TORCH[dtype]) for v in (a, b, c, d)]
    ref = pcr_plain(*planes, rows_per_program=rows, unroll=unroll)
    assert bool(torch.isfinite(ref.float()).all())
    assert torch.equal(pcr(*planes, rows_per_program=rows, unroll=unroll),
                       ref)
    assert torch.equal(_pcr_block(planes, rows, unroll), ref)


@pytest.mark.parametrize("n", [32, 256, 1024])
@pytest.mark.parametrize("kind", ["scaled", "signed zeros", "subnormal"])
def test_pcr_warp_divides_are_exact_on_every_path(cuda, n, kind):
    """The warp kernel's divides take one of three paths a level (the
    fast-path sequence of __fdiv_rn, its scaled form for tiny dividends,
    __fdiv_rn itself): systems scaled by 2^30 (divisors out of the fast
    ranges), with -0 / +0 off-diagonals, and with subnormal ones, all
    bit-equal to pcr_plain, at one warp a system and at n / 32 warps (the
    shared levels too)."""
    gen = torch.Generator(device=cuda).manual_seed(n + len(kind))
    a, b, c, d = random_system(gen, 64, n)
    if kind == "scaled":
        a, b, c, d = (v * 2.0 ** 30 for v in (a, b, c, d))
    elif kind == "signed zeros":
        zero = torch.rand(a.shape, generator=gen, device=cuda) < 0.2
        a = torch.where(zero, -0.0 * torch.sign(a), a)
        c = torch.where(zero.roll(1, 1), 0.0 * c, c)
    else:
        tiny = torch.rand(a.shape, generator=gen, device=cuda) < 0.2
        a = torch.where(tiny, a * 2.0 ** -140, a)
        c = torch.where(tiny.roll(3, 1), c * 2.0 ** -130, c)
    ref = pcr_plain(a, b, c, d, rows_per_program=2)
    for unroll in (1, n // 32):
        assert torch.equal(pcr(a, b, c, d, rows_per_program=2,
                               unroll=unroll), ref)
    assert torch.equal(_pcr_block((a, b, c, d), 2), ref)


def test_pcr_counts_its_route(cuda):
    planes = random_system(torch.Generator(device=cuda).manual_seed(10), 8,
                           256)
    for n, route in ((256, "warp"), (96, "block")):
        part = [v[:, :n].contiguous() for v in planes]
        assert pcr_route(2, n, 1) == route
        before = (pcr.launches, pcr.launches_warp, pcr.launches_block)
        pcr(*part, rows_per_program=2)
        after = (pcr.launches, pcr.launches_warp, pcr.launches_block)
        assert after == (before[0] + 1, before[1] + (route == "warp"),
                         before[2] + (route == "block"))
    before = pcr.launches
    _pcr_block(planes, 2)
    assert pcr.launches == before


_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 3, 31, 33, 97, 256, 1024])
@pytest.mark.parametrize("batch", [1, 3, 32, 33, 4096])
def test_thomas_kernel_is_bit_equal_to_thomas_ref(cuda, dtype, n, batch):
    """The Thomas kernel rounds every step where thomas_ref's torch ops do
    on the card: every element bit-equal, over ragged warps (batch 3, 33)
    and ragged tiles (n = 31, 33, 97)."""
    gen = torch.Generator(device=cuda).manual_seed(batch * 7919 + n)
    planes = [v.to(_TORCH[dtype]) for v in random_system(gen, batch, n)]
    before = thomas.launches
    got = thomas(*planes)
    assert thomas.launches == before + 1
    ref = thomas_ref(*planes)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    bits = _BITS[got.dtype]
    assert int((got.view(bits) != ref.view(bits)).sum()) == 0


@pytest.mark.parametrize("variant", ["pcr", "cr", "lf", "wm", "thomas"])
def test_solve_on_the_card(cuda, variant):
    gen = torch.Generator(device=cuda).manual_seed(5)
    system = random_system(gen, 256, 1024)
    x = tridiag_ops.solve(*system, variant=variant)
    assert float(residual(*system, x)) < 1e-4
    _close(x, tridiag_ops.solve(*(v.cpu() for v in system),
                                variant=variant), "float32")


def test_lf_solve_above_multipass_min_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(6)
    system = random_system(gen, 2, 2 * tridiag_ops.LF_MULTIPASS_MIN)
    with driver.capture_launches() as launched:
        x = tridiag_ops.solve(*system, variant="lf")
    assert len(launched) >= 2
    assert float(residual(*system, x)) < 1e-4


@pytest.mark.parametrize("cfg", [
    {"tile_n": 256, "rows_per_program": 4, "radix": 4},
    {"tile_n": 128, "rows_per_program": 2, "radix": 8}])
def test_linear_recurrence_on_the_card(cuda, cfg):
    """Fused (n = 1024) and multipass (n = 2^15 / 128 = 256 tiles)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    for n in (1024, 2 ** 15):
        a, b = _linrec_pair(gen, 16, n, "float32", cuda)
        with driver.capture_launches() as launched:
            h = linear_recurrence(a, b, config=cfg)
        assert len(launched) == (3 if n // cfg["tile_n"] > 64 else 1)
        _close(h, scan_linrec_assoc_ref(a.double(), b.double()), "float32")


def _fft_close(got, ref):
    assert_kernel_close(got.cpu().numpy(), ref.cpu().numpy(), "complex64")


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("batch,n,rows,radix,unroll", [
    (8, 1024, 2, 4, 1), (8, 1024, 8, 16, 2), (6, 96, 3, 8, 1),
    (5, 106, 5, 2, 4), (4, 1000, 2, 8, 1), (2, 8192, 1, 16, 1),
    (4, 8192, 1, 2, 2), (512, 16, 256, 16, 4), (64, 4096, 32, 8, 1),
    (3, 1, 3, 2, 1)])
def test_fft_kernel_matches_plain(cuda, inverse, batch, n, rows, radix,
                                  unroll):
    """repro_fft against fft_plain: ragged (8, 6, 2), prime (2, 53) and
    (8, 5, 5, 5) stages, the largest resident rows, a block that loops
    over row groups (32 x 4096), n = 1."""
    gen = torch.Generator(device=cuda).manual_seed(batch * n)
    x = torch.randn(batch, n, generator=gen, device=cuda,
                    dtype=torch.complex64)
    kw = dict(rows_per_program=rows, stages=stage_radices(n, radix),
              inverse=inverse)
    before = fft_stockham.launches
    got = fft_stockham(x, unroll=unroll, **kw)
    assert fft_stockham.launches == before + 1
    _fft_close(got, fft_plain(x, **kw))
    assert torch.equal(got, fft_plain(x, **kw))
    ref = (torch.fft.ifft if inverse else torch.fft.fft)(
        x.to(torch.complex128))
    _fft_close(got, ref)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("batch,n,rows,radix,unroll", [
    (8, 1024, 2, 4, 1), (8, 1024, 8, 4, 1), (8, 1024, 8, 16, 1),
    (8, 1024, 8, 16, 2), (6, 96, 3, 8, 1), (5, 106, 5, 2, 4),
    (2, 8192, 1, 16, 1), (4, 8192, 1, 2, 2), (512, 16, 256, 16, 4),
    (64, 4096, 32, 8, 1)])
def test_fft_kernels_on_a_real_input(cuda, inverse, batch, n, rows, radix,
                                     unroll):
    """A real-valued input (im = 0 exactly, where a weight's cos(pi/2) of
    6.1e-17 would show): both kernels equal fft_plain bit for bit and
    torch.fft on complex128 within the complex64 tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(batch + n)
    re = torch.randn(batch, n, generator=gen, device=cuda)
    x = torch.complex(re, torch.zeros_like(re))
    kw = dict(rows_per_program=rows, stages=stage_radices(n, radix),
              inverse=inverse)
    ref = fft_plain(x, **kw)
    assert torch.equal(fft_stockham(x, unroll=unroll, **kw), ref)
    assert torch.equal(fft_generic(x, unroll=unroll, **kw), ref)
    want = (torch.fft.ifft if inverse else torch.fft.fft)(
        x.to(torch.complex128))
    _fft_close(ref, want)


def test_fft_stockham_counts_its_route(cuda):
    x = torch.randn(8, 96, device=cuda, dtype=torch.complex64)
    y = torch.randn(8, 1024, device=cuda, dtype=torch.complex64)
    for z, stages, route in ((y, stage_radices(1024, 4), "pow2"),
                             (x, stage_radices(96, 8), "generic")):
        assert fft_route(z.shape[1], stages) == route
        before = (fft_stockham.launches, fft_stockham.launches_pow2,
                  fft_stockham.launches_generic)
        fft_stockham(z, rows_per_program=2, stages=stages)
        after = (fft_stockham.launches, fft_stockham.launches_pow2,
                 fft_stockham.launches_generic)
        assert after == (before[0] + 1, before[1] + (route == "pow2"),
                         before[2] + (route == "generic"))
    before = fft_stockham.launches
    fft_generic(y, rows_per_program=2, stages=stage_radices(1024, 4))
    assert fft_stockham.launches == before


@pytest.mark.parametrize("tile,m", [(64, 2), (16, 3)])
def test_four_step_fft_on_the_card(cuda, tile, m):
    """The four-step driver on the card at m = 2 and 3 (n = 4096, forced
    through plan_for's max_tile), against the CPU path and torch.fft."""
    gen = torch.Generator(device=cuda).manual_seed(tile)
    x = torch.randn(4, 4096, generator=gen, device=cuda,
                    dtype=torch.complex64)
    plan = plan_for(Workload(op="large_fft", n=4096, batch=4,
                             variant="stockham"),
                    {"tile_n": tile, "radix": 4, "rows_per_program": 2},
                    max_tile=tile)
    with driver.capture_launches() as launched:
        y = driver.four_step_fft(x, plan, inverse=False)
    assert tuple(launched) == plan.launches and len(launched) == m
    _fft_close(y, driver.four_step_fft(x.cpu(), plan, inverse=False))
    _fft_close(y, torch.fft.fft(x.to(torch.complex128)))


def test_fft_entry_points_on_the_card(cuda):
    """fft above the h100 cap (2^14 > 8192) runs four-step; ifft inverts."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    for n in (1024, 2 ** 14):
        x = torch.randn(4, n, generator=gen, device=cuda,
                        dtype=torch.complex64)
        with driver.capture_launches() as launched:
            y = fft_ops.fft(x)
        assert len(launched) == (1 if n <= 8192 else 2)
        _fft_close(y, torch.fft.fft(x.to(torch.complex128)))
        _fft_close(fft_ops.ifft(y), x)


# ---------------------------------------------------------------------------
# The SSD chain, the RG-LRU op and the Mamba-2 block
# ---------------------------------------------------------------------------

def _ssd_rows(gen, BH, G, L, P, S, dtype, device, strong=False):
    x = torch.randn(BH, L, P, generator=gen, device=device)
    a = torch.rand(BH, L, generator=gen, device=device) * 0.149 + 0.85
    if strong:
        a = a * 0.01
    b = torch.randn(G, L, S, generator=gen, device=device) * 0.3
    c = torch.randn(G, L, S, generator=gen, device=device) * 0.3
    return [v.to(_TORCH[dtype]) for v in (x, a, b, c)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,G,L,P,S,chunk,strong", [
    (4, 2, 192, 16, 8, 64, False), (6, 3, 384, 8, 16, 128, False),
    (4, 2, 512, 64, 128, 128, True), (3, 1, 2048, 64, 128, 2048, False),
    (2, 1, 300, 70, 130, 100, False), (2, 2, 96, 16, 8, 96, False)])
def test_ssd_kernels_match_plain(cuda, dtype, BH, G, L, P, S, chunk, strong):
    """Kernels 8, 9 and 10 against their plain versions: chunk 64 ...
    2048, nc = 1, 3, 4, ragged tiles (P = 70, S = 130, Q = 100), a strong
    decay, shared b / c (G < BH)."""
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    gen = torch.Generator(device=cuda).manual_seed(BH * L + P)
    x, a, b, c = _ssd_rows(gen, BH, G, L, P, S, dtype, cuda, strong)
    before = ssd_kernel.ssd_intra.launches
    got = ssd_kernel.ssd_intra(x, a, b, c, chunk=chunk)
    assert ssd_kernel.ssd_intra.launches == before + 1
    want = ssd_kernel.ssd_intra_plain(x, a, b, c, chunk=chunk)
    for g, w in zip(got, want):
        assert_kernel_close(g.float().cpu().numpy(), w.float().cpu().numpy(),
                            dtype, scale=10.0)
    y, ac, st = want
    if L // chunk > 1:
        fused = ssd_kernel.ssd_state_apply(y, a, c, ac, st, chunk=chunk)
        _close(fused, ssd_kernel.ssd_state_apply_plain(y, a, c, ac, st,
                                                       chunk=chunk), dtype)
        entry = ssd_kernel.ssd_apply_entry(y, a, c, st, chunk=chunk)
        _close(entry, ssd_kernel.ssd_apply_entry_plain(y, a, c, st,
                                                       chunk=chunk), dtype)


@pytest.mark.parametrize("route", ["tiled", "block"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,G,L,P,S,chunk,strong", [
    (4, 2, 192, 16, 8, 64, False), (6, 3, 384, 8, 16, 128, False),
    (4, 2, 512, 64, 128, 128, True), (3, 1, 2048, 64, 128, 2048, False),
    (2, 1, 3072, 64, 128, 1024, False), (2, 2, 96, 16, 8, 96, False),
    (2, 1, 300, 8, 16, 100, True)])
def test_ssd_routes_equal_the_plain_versions_bit_for_bit(
        cuda, route, dtype, BH, G, L, P, S, chunk, strong):
    """Kernels 8, 9 and 10 on each route (the tiled kernels and the
    earlier block kernels, forced) against their plain versions, every
    element equal; each launch counted on its route."""
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    assert ssd_kernel.ssd_intra_route(P, S, chunk) == "tiled"
    gen = torch.Generator(device=cuda).manual_seed(BH * L + P + 1)
    x, a, b, c = _ssd_rows(gen, BH, G, L, P, S, dtype, cuda, strong)
    fn = ssd_kernel.ssd_intra
    before = (fn.launches, getattr(fn, f"launches_{route}"))
    got = fn(x, a, b, c, chunk=chunk, route=route)
    assert (fn.launches, getattr(fn, f"launches_{route}")) \
        == (before[0] + 1, before[1] + 1)
    want = ssd_kernel.ssd_intra_plain(x, a, b, c, chunk=chunk)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    y, ac, st = want
    if L // chunk > 1:
        got = ssd_kernel.ssd_state_apply(y, a, c, ac, st, chunk=chunk,
                                         route=route)
        assert torch.equal(got, ssd_kernel.ssd_state_apply_plain(
            y, a, c, ac, st, chunk=chunk))
        fn = ssd_kernel.ssd_apply_entry
        before = (fn.launches, getattr(fn, f"launches_{route}"))
        got = fn(y, a, c, st, chunk=chunk, route=route)
        assert (fn.launches, getattr(fn, f"launches_{route}")) \
            == (before[0] + 1, before[1] + 1)
        assert torch.equal(got, ssd_kernel.ssd_apply_entry_plain(
            y, a, c, st, chunk=chunk))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,G,L,P,S,chunk,strong", [
    (4, 2, 192, 16, 8, 64, False), (6, 3, 384, 8, 16, 128, False),
    (4, 2, 512, 64, 128, 128, True), (2, 1, 3072, 64, 128, 1024, False),
    (2, 1, 300, 8, 16, 100, True), (2, 1, 768, 64, 128, 256, False)])
def test_ssd_apply_entry_tiled_equals_the_plain_version_bit_for_bit(
        cuda, dtype, BH, G, L, P, S, chunk, strong):
    """Kernel 10's tiled kernel through its launcher, every element equal
    to the plain version; the launcher counts nothing."""
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    gen = torch.Generator(device=cuda).manual_seed(BH * L + P + 2)
    _, a, _, c = _ssd_rows(gen, BH, G, L, P, S, dtype, cuda, strong)
    y = torch.randn(BH, L, P, generator=gen, device=cuda).to(_TORCH[dtype])
    st = torch.randn(BH, L // chunk, S, P, generator=gen, device=cuda)
    fn = ssd_kernel.ssd_apply_entry
    before = (fn.launches, fn.launches_tiled)
    got = ssd_kernel._launch_apply("ssd_apply_entry", y, a, c, chunk, None,
                                   st, False, route="tiled")
    assert (fn.launches, fn.launches_tiled) == before
    assert torch.equal(got, ssd_kernel.ssd_apply_entry_plain(
        y, a, c, st, chunk=chunk))


def test_ssd_default_routes_are_the_tiled_kernels(cuda):
    """At the block's widths the wrappers' own choice is the tiled
    kernel; the ragged shape takes the block kernel."""
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    gen = torch.Generator(device=cuda).manual_seed(5)
    for (P, S, chunk), route in (((64, 128, 128), "tiled"),
                                 ((70, 130, 100), "block")):
        x, a, b, c = _ssd_rows(gen, 2, 1, 300 if chunk == 100 else 256, P,
                               S, "float32", cuda)
        y, ac, st = ssd_kernel.ssd_intra_plain(x, a, b, c, chunk=chunk)
        for fn, args in ((ssd_kernel.ssd_intra, (x, a, b, c)),
                         (ssd_kernel.ssd_state_apply, (y, a, c, ac, st)),
                         (ssd_kernel.ssd_apply_entry, (y, a, c, st))):
            before = getattr(fn, f"launches_{route}")
            fn(*args, chunk=chunk)
            assert getattr(fn, f"launches_{route}") == before + 1


@pytest.mark.parametrize("fuse", [0, 1])
@pytest.mark.parametrize("L,chunk", [(1024, 128), (384, 128), (256, 256)])
def test_ssd_on_the_card(cuda, fuse, L, chunk):
    """The op at nc = 8, 3 (odd) and 1 against a float64 sequential scan,
    with the chain plan's launch list."""
    from repro_torch.kernels.blocks.plan import plan_for_chain
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.kernels.ssd.ref import ssd_ref
    gen = torch.Generator(device=cuda).manual_seed(L + fuse)
    B, H, P, S = 2, 4, 64, 128
    x = torch.randn(B, L, H, P, generator=gen, device=cuda)
    a = torch.rand(B, L, H, generator=gen, device=cuda) * 0.149 + 0.85
    b = torch.randn(B, L, S, generator=gen, device=cuda) * 0.3
    c = torch.randn(B, L, S, generator=gen, device=cuda) * 0.3
    cfg = {"tile_n": chunk, "radix": 2, "fuse": fuse}
    with driver.capture_launches() as launched:
        y = ssd(x, a, b, c, config=cfg)
    wl = Workload(op="ssd", n=L, batch=B * H, variant="chunked")
    assert tuple(launched) == plan_for_chain(wl, cfg, dims=(S, P)).launches
    ref = ssd_ref(*(v.double() for v in (x, a, b, c)))
    assert_kernel_close(y.cpu().numpy(), ref.cpu().numpy(), "float32",
                        scale=10.0)


@pytest.mark.parametrize("fuse", [0, 1])
@pytest.mark.parametrize("B,L,D,cfg", [
    (2, 2048, 64, {"tile_n": 2048, "rows_per_program": 4, "radix": 2}),
    (1, 2 ** 15, 4, {"tile_n": 128, "rows_per_program": 2, "radix": 4})])
def test_rglru_on_the_card(cuda, fuse, B, L, D, cfg):
    """Fused and multipass, the gate in the kernel (fuse = 1) or in torch,
    against a float64 sequential recurrence."""
    from repro_torch.kernels.rglru.ops import rglru
    from repro_torch.kernels.rglru.ref import rglru_ref
    gen = torch.Generator(device=cuda).manual_seed(L + fuse)
    a = torch.rand(B, L, D, generator=gen, device=cuda) * 0.19 + 0.8
    u = torch.randn(B, L, D, generator=gen, device=cuda)
    with driver.capture_launches() as launched:
        h = rglru(a, u, config=dict(cfg, fuse=fuse))
    assert len(launched) == (1 if L // cfg["tile_n"] <= 64 else 3)
    ref = rglru_ref(a.double().cpu(), u.double().cpu())
    assert_kernel_close(h.cpu().numpy(), ref.numpy(), "float32", scale=10.0)


def test_ssd_block_on_the_card(cuda):
    """The reduced Mamba-2 block on the card against the same weights on
    the CPU (the plain versions), f32 compute: prefill and one decode
    step."""
    from repro_torch.configs.mamba2_130m import CONFIG
    from repro_torch.models.ssm import SSDBlock, init_ssd_cache
    cfg = CONFIG.reduced()
    block = SSDBlock.init(cfg, torch.Generator().manual_seed(0))
    card = SSDBlock(cfg, device=cuda)
    card.load_state_dict(block.state_dict())
    x = torch.randn(2, 256, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    f32 = torch.float32
    with torch.no_grad():
        want, _ = block(x, compute_dtype=f32)
        got, _ = card(x.to(cuda), compute_dtype=f32)
        _close(got, want, "float32")
        cache = init_ssd_cache(cfg, 2)
        want, wnew = block(x[:, :1], cache=cache, compute_dtype=f32)
        got, gnew = card(x[:, :1].to(cuda),
                         cache={k: v.to(cuda) for k, v in cache.items()},
                         compute_dtype=f32)
        _close(got, want, "float32")
        _close(gnew["state"], wnew["state"], "float32")


def test_ssd_block_bf16_core_on_the_card(cuda):
    """bf16 compute: the block's SSD core at its own (bf16-projected)
    inputs against a float64 sequential scan, and a finite output.  The
    whole block in bf16 is not held to another device's bf16 run: its
    RMS norm scales each position by 1 / rms, and positions whose rms is
    near 0 turn one-ulp differences of the two devices' bf16 products into
    large ones."""
    from repro_torch.configs.mamba2_130m import CONFIG
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.kernels.ssd.ref import ssd_ref
    from repro_torch.models.ssm import SSDBlock
    cfg = CONFIG.reduced()
    card = SSDBlock.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    x = torch.randn(2, 256, cfg.d_model, device=cuda)
    with torch.no_grad():
        out, _ = card(x)
        assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
        xh, a, b, c, _, _ = card.ssd_inputs(x)
        args = (xh.float(), a, b.float(), c.float())
        y = ssd(*args)
        ref = ssd_ref(*(v.double() for v in args))
    assert_kernel_close(y.cpu().numpy(), ref.cpu().numpy(), "float32",
                        scale=10.0)


# ---------------------------------------------------------------------------
# Flash attention, the tiled matmul, the long carry tile, the dense model
# ---------------------------------------------------------------------------

def _flash_close(got, want, dtype):
    """Kernel 11 against its plain version: both compute in f32 and round
    once, so in bf16 they may differ by one ulp (at most 2^-7 |want|):
    |got - want| <= 4e-3 + 8e-3 |want| element by element; f32 at
    DTYPE_TOL."""
    if dtype == "float32":
        return _close(got, want, dtype)
    g, w = got.double().cpu(), want.double().cpu()
    assert torch.isfinite(g).all()
    assert bool(((g - w).abs() <= 4e-3 + 8e-3 * w.abs()).all())


_ROUTE = {"float32": "simt", "bfloat16": "wgmma"}


def _route_counts(fn):
    return {r: getattr(fn, f"launches_{r}") for r in ("wgmma", "simt")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,lq,lk,d,bq,bk,causal,window", [
    (2, 2048, 2048, 64, 1024, 2048, True, None),
    (2, 2048, 2048, 64, 512, 1024, True, None),
    (2, 256, 256, 64, 128, 128, True, None),
    (2, 256, 256, 16, 64, 256, False, None),
    (2, 256, 256, 128, 256, 64, True, None),
    (2, 512, 512, 256, 128, 128, True, 128),
    (3, 128, 384, 64, 64, 128, True, None),
    (2, 64, 1500, 64, 64, 4, False, None)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, BH, lq, lk, d, bq,
                                              bk, causal, window):
    from repro_torch.kernels.attention.kernel import (flash_attention,
                                                      flash_attention_plain)
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(BH, n, d, generator=gen, device=cuda).to(
        _TORCH[dtype]) for n in (lq, lk, lk))
    kw = dict(block_q=bq, block_k=bk, causal=causal, window=window)
    before = flash_attention.launches
    routes = _route_counts(flash_attention)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    routes[_ROUTE[dtype]] += 1
    assert _route_counts(flash_attention) == routes
    _flash_close(got, flash_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.parametrize("BH,lq,lk,d,bq,bk,causal", [
    (2, 256, 256, 64, 128, 128, True), (2, 256, 256, 256, 128, 256, False)])
def test_flash_simt_record_takes_bf16(cuda, BH, lq, lk, d, bq, bk, causal):
    """The CUDA-core kernel on bf16 inputs (the earlier design, timed
    beside the tensor-core kernel) counts no launch and matches the plain
    version."""
    from repro_torch.kernels.attention.kernel import (flash_attention,
                                                      flash_attention_plain,
                                                      flash_attention_simt)
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(BH, n, d, generator=gen, device=cuda).to(
        torch.bfloat16) for n in (lq, lk, lk))
    kw = dict(block_q=bq, block_k=bk, causal=causal)
    before = flash_attention.launches
    got = flash_attention_simt(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before
    _flash_close(got, flash_attention_plain(q, k, v, **kw), "bfloat16")


@pytest.mark.parametrize("n,b_mn_major,k_steps", [
    (64, False, 1), (64, False, 4), (128, False, 4), (64, True, 1),
    (128, True, 4)])
def test_one_wgmma_product_matches_torch_matmul(cuda, n, b_mn_major,
                                                k_steps):
    """m64n{64,128}k16 on the tensor cores, B K-major or MN-major (the
    transpose bit), against torch.matmul in f32 (products of bf16 are
    exact in f32; only the sums' order differs)."""
    from repro_torch.kernels.matmul.kernel import wgmma_probe
    gen = torch.Generator(device=cuda).manual_seed(n + k_steps)
    a = torch.randn(64, 64, generator=gen, device=cuda).to(torch.bfloat16)
    shape = (64, n) if b_mn_major else (n, 64)
    b = torch.randn(*shape, generator=gen, device=cuda).to(torch.bfloat16)
    got = wgmma_probe(a, b, b_mn_major=b_mn_major, k_steps=k_steps)
    kk = 16 * k_steps
    bm = b[:kk].float() if b_mn_major else b[:, :kk].float().T
    want = torch.matmul(a[:, :kk].float(), bm)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _matmul_bf16_close(got, want):
    """Kernel 12 in bf16 against its plain version, element by element:
    one bf16 ulp of |want| (the two may round to neighbours) plus 1e-3 of
    max |want| (the tensor cores sum a k-block's products in their own
    order), as chip_smoke.py's MATMUL_BF16_ATOL."""
    g, w = got.double().cpu(), want.double().cpu()
    mag = w.abs()
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=1e-30))) - 7)
    assert torch.isfinite(g).all()
    assert bool(((g - w).abs() <= ulp + 1e-3 * float(mag.max())).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (256, 384, 512, 128, 256, 128), (128, 128, 128, 128, 128, 128),
    (512, 1024, 2816, 512, 256, 256), (96, 64, 80, 32, 16, 64)])
def test_matmul_kernel_matches_plain(cuda, dtype, m, k, n, bm, bn, bk):
    from repro_torch.kernels.matmul.kernel import matmul_plain, matmul_tiled
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(m, k, generator=gen, device=cuda).to(_TORCH[dtype])
    b = torch.randn(k, n, generator=gen, device=cuda).to(_TORCH[dtype])
    kw = dict(block_m=bm, block_n=bn, block_k=bk)
    routes = _route_counts(matmul_tiled)
    got = matmul_tiled(a, b, **kw)
    torch.cuda.synchronize()
    routes[_ROUTE[dtype]] += 1
    assert _route_counts(matmul_tiled) == routes
    want = matmul_plain(a, b, **kw)
    _close(got, want, dtype)
    if dtype == "bfloat16":
        _matmul_bf16_close(got, want)


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (256, 384, 512, 128, 128, 32), (256, 96, 512, 64, 128, 48),
    (64, 48, 32, 64, 32, 16), (8192, 1024, 2816, 128, 256, 1024)])
def test_matmul_wgmma_folds_k_blocks_inside_a_stage(cuda, m, k, n, bm, bn,
                                                    bk):
    """block_k below the 64-deep stage: the partial is folded inside a
    stage; and qwen's MLP shape at the session's blocks."""
    from repro_torch.kernels.matmul.kernel import matmul_plain, matmul_tiled
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    a = torch.randn(m, k, generator=gen, device=cuda).to(torch.bfloat16)
    b = torch.randn(k, n, generator=gen, device=cuda).to(torch.bfloat16)
    kw = dict(block_m=bm, block_n=bn, block_k=bk)
    got = matmul_tiled(a, b, **kw)
    torch.cuda.synchronize()
    _matmul_bf16_close(got, matmul_plain(a, b, **kw))


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (33, 65, 96, 33, 96, 65), (55, 65, 128, 55, 128, 65),
    (33, 65, 97, 33, 97, 65), (64, 64, 64, 64, 64, 8)])
def test_matmul_ragged_route_takes_what_wgmma_does_not(cuda, m, k, n, bm, bn,
                                                       bk):
    """bf16 at K = 65 (a k-block not whole k16 steps, A's row pitch off
    TMA's 16 bytes), at a prime N and at block_k 8: the CUDA-core kernel,
    chosen before the launch and counted on the "ragged" route."""
    from repro_torch.kernels.matmul.kernel import (matmul_plain, matmul_route,
                                                   matmul_tiled)
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    a = torch.randn(m, k, generator=gen, device=cuda).to(torch.bfloat16)
    b = torch.randn(k, n, generator=gen, device=cuda).to(torch.bfloat16)
    kw = dict(block_m=bm, block_n=bn, block_k=bk)
    assert matmul_route(a, b, bk) == "ragged"
    before = (matmul_tiled.launches, matmul_tiled.launches_ragged,
              matmul_tiled.launches_wgmma, matmul_tiled.launches_simt)
    got = matmul_tiled(a, b, **kw)
    torch.cuda.synchronize()
    assert (matmul_tiled.launches, matmul_tiled.launches_ragged,
            matmul_tiled.launches_wgmma, matmul_tiled.launches_simt) \
        == (before[0] + 1, before[1] + 1, before[2], before[3])
    want = matmul_plain(a, b, **kw)
    _close(got, want, "bfloat16")
    _matmul_bf16_close(got, want)


def test_matmul_simt_record_takes_bf16(cuda):
    from repro_torch.kernels.matmul.kernel import (matmul_plain, matmul_simt,
                                                   matmul_tiled)
    gen = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(256, 384, generator=gen, device=cuda).to(torch.bfloat16)
    b = torch.randn(384, 512, generator=gen, device=cuda).to(torch.bfloat16)
    kw = dict(block_m=128, block_n=256, block_k=128)
    before = matmul_tiled.launches
    got = matmul_simt(a, b, **kw)
    torch.cuda.synchronize()
    assert matmul_tiled.launches == before
    assert torch.equal(got, matmul_plain(a, b, **kw))


@pytest.mark.parametrize("linrec", [False, True])
def test_long_carry_tile_on_the_card(cuda, linrec):
    """tile_n 128, rows 2 at n = 2^22: the carry scan's (2, 32768) block,
    twice the staging, runs in pieces; launch list equal to the plan's."""
    from repro_torch.hw.profiles import get_profile
    cfg = {"tile_n": 128, "rows_per_program": 2, "radix": 2, "unroll": 1,
           "in_register": 0}
    plan = plan_for(Workload(op="scan", n=2 ** 22, batch=16, variant="ks"),
                    cfg, profile=get_profile("h100"))
    gen = torch.Generator(device=cuda).manual_seed(0)
    b = torch.randn(16, 2 ** 22, generator=gen, device=cuda)
    a = torch.rand(16, 2 ** 22, generator=gen, device=cuda) * 0.1 + 0.9
    with driver.capture_launches() as got:
        out = driver.multipass_linrec(a, b, plan) if linrec \
            else driver.multipass_scan_add(b, plan)
    torch.cuda.synchronize()
    assert tuple(got) == plan.launches
    ref = scan_linrec_assoc_ref(a.double(), b.double()) if linrec \
        else torch.cumsum(b.double(), dim=-1)
    _close(out, ref, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_model_on_the_card(cuda, dtype):
    """The reduced qwen with the flash kernel against the plain-op path,
    and decode after prefill against the forward."""
    import dataclasses

    from repro_torch.configs.qwen15_05b import CONFIG
    from repro_torch.kernels.attention.kernel import flash_attention
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(CONFIG.reduced(), use_pallas=True,
                              compute_dtype=dtype)
    model = Model.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                       device=cuda)
    plain = Model(dataclasses.replace(cfg, use_pallas=False), device=cuda)
    plain.load_state_dict(model.state_dict())
    tokens = torch.randint(0, cfg.vocab, (2, 256), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    before = flash_attention.launches
    routes = _route_counts(flash_attention)
    with torch.no_grad():
        got, _ = model(tokens)
        want, _ = plain(tokens)
        cache = model.init_cache(2, 16, dtype=torch.float32, device=cuda)
        steps = tokens[:, :8].T.contiguous()
        pos = torch.arange(8, device=cuda)[:, None].expand(8, 2).contiguous()
        cache = model.prefill(steps, cache, pos,
                              torch.ones(8, 2, dtype=torch.bool, device=cuda))
        lg, _ = model.decode_step(tokens[:, 8:9], cache,
                                  torch.full((2, 1), 8, device=cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.n_layers
    routes[_ROUTE[dtype]] += cfg.n_layers
    assert _route_counts(flash_attention) == routes
    _close(got, want, dtype)
    rel = float((lg[:, 0] - got[:, 8]).abs().max() / got[:, 8].abs().max())
    assert rel < 2e-2, rel


@pytest.mark.parametrize("name", ["scan_add", "scan_linrec", "pcr",
                                  "fft_stockham"])
def test_a_backward_through_a_kernel_raises(cuda, name):
    """The gradient guard: the kernel's output is tied to its inputs, and a
    backward through it raises naming the kernel, before any gradient
    reaches an input; without grad mode the output is left alone."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(4, 1024, generator=gen, device=cuda)
    a = torch.rand(4, 1024, generator=gen, device=cuda) * 0.1 + 0.85
    radix4 = stage_radices(1024, 4)
    if name == "scan_add":
        inputs = [x]
        call = lambda x: scan_add(x, rows_per_program=4, tile_n=1024,  # noqa: E731
                                  stages=radix4)
    elif name == "scan_linrec":
        inputs = [a, x]
        call = lambda a, x: scan_linrec(a, x, rows_per_program=4,  # noqa: E731
                                        tile_n=1024, stages=radix4)
    elif name == "pcr":
        inputs = [t.to(cuda) for t in random_system(
            torch.Generator().manual_seed(1), 4, 256)]
        call = lambda *planes: pcr(*planes, rows_per_program=4)  # noqa: E731
    else:
        inputs = [torch.randn(4, 1024, generator=gen, device=cuda,
                              dtype=torch.complex64)]
        call = lambda z: torch.view_as_real(fft_stockham(  # noqa: E731
            z, rows_per_program=4, stages=radix4))
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = call(*leaves)
    assert out.requires_grad
    with pytest.raises(RuntimeError, match=f"CUDA kernel {name}:"):
        out.sum().backward()
    assert all(t.grad is None for t in leaves)
    with torch.no_grad():
        assert not call(*leaves).requires_grad
