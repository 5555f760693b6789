"""Which kernel a scan, linrec, PCR or FFT launch runs on the card,
decided by the plan, and the warp kernels' exchange schedules replayed.

``scan_add``, ``scan_linrec`` / ``scan_linrec_prod``, ``pcr`` and
``fft_stockham`` each have two CUDA kernels: the warp / pow2 kernel,
redesigned for Hopper, and the earlier block / generic kernel for the
shapes the new one does not take.  The choice is a pure function of the
plan (``scan_route``, ``linrec_route``, ``pcr_route``, ``fft_route``), so
it is held here on the CPU: every admitted h100 config at the paper's
sizes, and every launch of the multipass, four-step and SSD chain
drivers, goes to the new kernel; ragged, prime and short sequences go to
the earlier one.  On the CPU the wrappers run their plain versions and
count no launch on any route.

The warp linrec and PCR kernels move data between lanes and registers by
index algebra (which lane a shuffle reads, which register the source lane
sends, the halo a warp recomputes, the planes a row over warps shares).
``replay_linrec`` and ``replay_pcr`` repeat that schedule in torch on the
CPU, lane by lane, with the kernels' order of operations, and must equal
the plain versions bit for bit: the algebra is checked here before the
card runs it.
"""
import importlib
import math

import numpy as np

import pytest
import torch

from repro_torch.core.space import (Workload, build_space, fft_space,
                                    scan_space, tridiag_space)
from repro_torch.kernels.blocks import driver
from repro_torch.kernels.blocks.plan import plan_for, stage_radices
from repro_torch.kernels.fft import kernel as fft_kernel
from repro_torch.kernels.fft.kernel import (fft_route, fft_stockham,
                                            pow2_table_points)
from repro_torch.kernels.fft.ops import fft, fft_plan
from repro_torch.kernels.blocks import primitives as prim
from repro_torch.kernels.blocks.plan import plan_for_chain
from repro_torch.kernels.scan import kernel as scan_kernel
from repro_torch.kernels.scan.kernel import (linrec_route, scan_add,
                                             scan_linrec, scan_linrec_plain,
                                             scan_linrec_prod,
                                             scan_linrec_prod_plain,
                                             scan_route, staged_piece)
from repro_torch.kernels.scan.ops import (_plan_workload, linear_recurrence,
                                          prefix_sum)
from repro_torch.kernels.tridiag import kernel as pcr_kernel
from repro_torch.kernels.tridiag.kernel import pcr, pcr_plain, pcr_route
from repro_torch.kernels.tridiag.ops import solve
from repro_torch.kernels.tridiag.ref import random_system

H100 = importlib.import_module("repro_torch.hw.profiles").get_profile("h100")
TOTAL = 2 ** 26                      # the paper's elements a call


def _scan_launches(n):
    """(rows, tile, stages) of every scan launch of every admitted h100
    config at n (fused, or the multipass chunk and carry scans)."""
    wl = Workload(op="scan", n=n, batch=TOTAL // n, variant="ks")
    out = []
    for cfg in scan_space(wl, H100).enumerate_valid():
        plan = plan_for(_plan_workload(wl, linrec=False), cfg)
        out += [(l.block_shape[0], l.block_shape[1], l.stages)
                for l in plan.launches if l.stages]
    return out


@pytest.mark.parametrize("n", [128, 1024, 4096, 2 ** 22])
def test_every_h100_scan_config_takes_the_warp_kernel(n):
    launches = _scan_launches(n)
    assert launches
    routes = {scan_route(rows, tile, stages) for rows, tile, stages in launches}
    assert routes == {"warp"}


@pytest.mark.parametrize("radix", [2, 4, 8])
@pytest.mark.parametrize("tile", [128, 256, 512, 1024, 2048, 4096, 8192,
                                  16384, 32768])
def test_power_of_two_tiles_take_the_warp_kernel(tile, radix):
    stages = stage_radices(tile, radix)
    assert scan_route(1, tile, stages) == "warp"
    # the shuffle stages are those the kernel specialises
    stride = 1
    for fan_in in stages:
        if stride < 32:
            assert (fan_in, stride) in scan_kernel.WARP_SHUFFLE_STAGES
        stride *= fan_in


@pytest.mark.parametrize("rows,tile,stages", [
    (7, 96, stage_radices(96, 8)),          # not a power of two: (8, 6, 2)
    (5, 106, (2, 53)),                      # a large prime fan-in
    (3, 1018, (2, 509)),
    (4, 64, stage_radices(64, 4)),          # below the warp kernel's tiles
    (2, 1024, (2, 4) + (2,) * 7),           # a (4, 2) shuffle stage
    (1, 2048, (2, 2, 2, 2, 8, 4, 2, 2)),   # halo reach 127 > 63
    (1, 256, (16, 16)),                     # fan-in 16
    (512, 128, stage_radices(128, 2)),      # staged to a 64-column piece
])
def test_ragged_prime_and_short_sequences_take_the_block_kernel(rows, tile,
                                                                stages):
    assert math.prod(stages) == tile
    assert scan_route(rows, tile, stages) == "block"


def test_a_long_tile_is_routed_by_its_staged_piece():
    """(16, 32768) at radix 2 is walked in 2048-column pieces; the route
    reads the piece, not the tile."""
    stages = stage_radices(32768, 2)
    piece, head = staged_piece(16, 32768, stages)
    assert (piece, 16 * piece) == (2048, scan_kernel.MAX_TILE_ELEMS)
    assert scan_route(16, 32768, stages) == scan_route(16, piece, head) \
        == "warp"


@pytest.mark.parametrize("n", [256, 1024, 4096, 8192])
def test_every_h100_fft_config_takes_the_pow2_kernel(n):
    wl = Workload(op="fft", n=n, batch=TOTAL // n, variant="stockham")
    cfgs = fft_space(wl, H100).enumerate_valid()
    assert cfgs
    assert {fft_route(n, stage_radices(n, c["radix"])) for c in cfgs} \
        == {"pow2"}


@pytest.mark.parametrize("n", [2 ** 14, 2 ** 16, 2 ** 20, 2 ** 23])
def test_every_four_step_launch_takes_the_pow2_kernel(n):
    """The column and row launches of the four-step driver (m = 2 and 3)
    under h100, as the entry point plans them."""
    plan = fft_plan(TOTAL // n if n <= TOTAL else 1, n)
    assert plan.kind == "multipass"
    stack = list(plan.children)
    leaves = []
    while stack:
        child = stack.pop()
        if child.children:
            stack += list(child.children)
        else:
            leaves.append(child)
    assert leaves
    for leaf in leaves:
        assert fft_route(leaf.n, leaf.stages) == "pow2"


@pytest.mark.parametrize("n,stages", [
    (96, stage_radices(96, 8)),             # (8, 6, 2)
    (106, (2, 53)),
    (1000, stage_radices(1000, 8)),         # (8, 5, 5, 5)
    (8, (8,)),                              # below the pow2 kernel's rows
    (1, ()),                                # the identity
    (64, (2, 32)),                          # fan-in 32
])
def test_ragged_prime_and_short_ffts_take_the_generic_kernel(n, stages):
    assert fft_route(n, stages) == "generic"


@pytest.mark.parametrize("n,radix", [(16, 16), (1024, 4), (8192, 2),
                                     (8192, 16)])
def test_pow2_tables_fit_a_block(n, radix):
    """The pow2 kernel keeps one row plus its tables in shared memory; its
    tables hold about n twiddles."""
    stages = stage_radices(n, radix)
    points = pow2_table_points(n, stages)
    assert n - 1 <= points - sum(stages) < n
    assert 8 * (n + n // 16 + points) <= fft_kernel.SMEM_LIMIT


def test_cpu_calls_count_no_launch_on_any_route():
    """The plain versions on the CPU leave every route's count where it
    was, and the launch lists stay the plans'."""
    def counts():
        return tuple(getattr(fn, f"launches{route}")
                     for fn, routes in ((scan_add, ("warp", "block")),
                                        (scan_linrec, ("warp", "block")),
                                        (scan_linrec_prod, ("warp", "block")),
                                        (pcr, ("warp", "block")),
                                        (fft_stockham, ("pow2", "generic")))
                     for route in ("",) + tuple(f"_{r}" for r in routes))
    before = counts()
    cfg = {"tile_n": 128, "rows_per_program": 2, "radix": 4, "unroll": 2}
    x = torch.randn(4, 2 ** 14)
    with driver.capture_launches() as launched:
        prefix_sum(x, config=cfg)
    wl = Workload(op="scan", n=2 ** 14, batch=4, variant="ks")
    assert tuple(launched) == plan_for(_plan_workload(wl, linrec=False),
                                       cfg).launches
    z = torch.randn(4, 1024, dtype=torch.complex64)
    with driver.capture_launches() as launched:
        fft(z)
    assert tuple(launched) == fft_plan(4, 1024).launches
    a = torch.rand(4, 2 ** 14) * 0.19 + 0.8
    with driver.capture_launches() as launched:
        linear_recurrence(a, x, config=cfg)
    wl = Workload(op="scan", n=2 ** 14, batch=4, variant="linrec")
    assert tuple(launched) == plan_for(_plan_workload(wl, linrec=True),
                                       cfg).launches
    solve(*random_system(torch.Generator().manual_seed(0), 4, 256),
          variant="pcr")
    assert counts() == before


@pytest.mark.parametrize("route", ["warp", "block"])
def test_scan_add_block_and_routes_need_a_card(route):
    """The record entry and a forced route take CUDA tensors only."""
    x = torch.randn(4, 128)
    with pytest.raises(ValueError):
        scan_kernel._launch(x, 2, 128, stage_radices(128, 4), 1, route=route)
    with pytest.raises(ValueError):
        scan_kernel.scan_add_block(x, rows_per_program=2, tile_n=128,
                                   stages=stage_radices(128, 4))


@pytest.mark.parametrize("route", ["pow2", "generic"])
def test_fft_generic_and_routes_need_a_card(route):
    z = torch.randn(4, 64, dtype=torch.complex64)
    with pytest.raises(ValueError):
        fft_kernel._launch(z, 2, stage_radices(64, 4), False, 1, route=route)
    with pytest.raises(ValueError):
        fft_kernel.fft_generic(z, rows_per_program=2,
                               stages=stage_radices(64, 4))


@pytest.mark.parametrize("route", ["warp", "block"])
def test_linrec_records_and_routes_need_a_card(route):
    """Either route, forced (the block kernel's record is such a launch),
    with or without products, takes CUDA tensors only."""
    a, b = torch.rand(4, 128) * 0.19 + 0.8, torch.randn(4, 128)
    stages = stage_radices(128, 4)
    for products in (False, True):
        with pytest.raises(ValueError):
            scan_kernel._launch_linrec(a, b, 2, 128, stages, False, products,
                                       route=route)


@pytest.mark.parametrize("route", ["warp", "block"])
def test_pcr_block_and_routes_need_a_card(route):
    planes = random_system(torch.Generator().manual_seed(1), 4, 256)
    for rows, unroll in ((2, 1), (4, 8)):
        with pytest.raises(ValueError):
            pcr_kernel._launch(planes, rows, unroll, route=route)


# ---------------------------------------------------------------------------
# Linear recurrence and PCR routes
# ---------------------------------------------------------------------------

def _linrec_launches(n):
    """(rows, tile, stages, products) of every linrec launch of every
    admitted h100 config at n (fused, or the multipass chunk and carry
    scans; products: the chunk kernel)."""
    wl = Workload(op="scan", n=n, batch=TOTAL // n if n < 2 ** 22 else 16,
                  variant="linrec")
    out = []
    for cfg in scan_space(wl, H100).enumerate_valid():
        plan = plan_for(_plan_workload(wl, linrec=True), cfg)
        out += [(l.block_shape[0], l.block_shape[1], l.stages,
                 l.name == "chunk-scan")
                for l in plan.launches if l.stages]
    return out


@pytest.mark.parametrize("n,configs", [(1024, 78), (2 ** 16, 108),
                                       (2 ** 22, 90)])
def test_every_h100_linrec_launch_takes_the_warp_kernel(n, configs):
    wl = Workload(op="scan", n=n, batch=TOTAL // n if n < 2 ** 22 else 16,
                  variant="linrec")
    assert len(scan_space(wl, H100).enumerate_valid()) == configs
    launches = _linrec_launches(n)
    assert {linrec_route(*launch) for launch in launches} == {"warp"}


def test_ssd_phase_b_launches_take_the_warp_kernel():
    """SSD phase B scans rows of chunk states (tiles of 2 ... 16 columns,
    several rows a warp) over every admitted h100 ssd config at n = 1024
    (mamba2-130m's state 128 x head 64)."""
    wl = Workload(op="ssd", n=1024, batch=8 * 24, variant="chunked")
    tiles = set()
    for cfg in build_space(wl, H100).enumerate_valid():
        for launch in plan_for_chain(wl, cfg, dims=(128, 64)).launches:
            if launch.name == "scan":
                rows, tile = launch.block_shape
                tiles.add(tile)
                assert linrec_route(rows, tile, launch.stages) == "warp"
    assert tiles and max(tiles) <= 32


@pytest.mark.parametrize("rows,tile,stages", [
    (7, 96, stage_radices(96, 8)),          # not a power of two
    (5, 106, (2, 53)),                      # a large prime fan-in
    (1, 1, ()),                             # one column: no stage
    (2, 1024, (2, 4) + (2,) * 7),           # a (4, 2) shuffle stage
    (1, 2048, (2, 2, 2, 2, 8, 4, 2, 2)),   # halo reach 127 > 63
    (1, 256, (16, 16)),                     # fan-in 16
])
def test_ragged_prime_and_odd_linrec_tiles_take_the_block_kernel(rows, tile,
                                                                stages):
    assert math.prod(stages) == tile
    assert linrec_route(rows, tile, stages) == "block"


def test_short_linrec_tiles_take_the_warp_kernel_and_scans_do_not():
    for tile, radix in ((2, 2), (8, 8), (16, 4), (32, 2), (64, 8)):
        stages = stage_radices(tile, radix)
        assert linrec_route(8, tile, stages) == "warp"
        assert scan_route(8, tile, stages) == "block"


@pytest.mark.parametrize("tile,radix,route", [
    (16, 4, "block"), (64, 8, "block"),       # no short chunk rows
    (128, 4, "warp"), (16384, 8, "warp"),
    (32768, 8, "block")])                     # no 1024-thread chunk blocks
def test_the_warp_chunk_kernel_takes_the_tiles_plans_give_it(tile, radix,
                                                            route):
    """The chunk kernel (products out) is instantiated for the tiles of
    128 ... 16384 columns the admitted h100 plans reach; the carrying
    kernel takes them all."""
    stages = stage_radices(tile, radix)
    assert linrec_route(1, tile, stages, products=True) == route
    assert linrec_route(1, tile, stages) == "warp"


@pytest.mark.parametrize("n,configs", [(256, 15), (1024, 9)])
def test_every_h100_pcr_config_takes_the_warp_kernel(n, configs):
    wl = Workload(op="tridiag", n=n, batch=TOTAL // n, variant="pcr")
    cfgs = tridiag_space(wl, H100).enumerate_valid()
    assert len(cfgs) == configs
    assert {pcr_route(c["rows_per_program"], n, c["unroll"])
            for c in cfgs} == {"warp"}


@pytest.mark.parametrize("rows,n,unroll", [
    (3, 96, 1), (5, 100, 1), (2, 1, 1), (3, 7, 4),   # not a power of two
    (4, 16, 1),                      # below a warp's 32 equations
    (1, 2048, 1), (1, 8192, 1),      # beyond one warp's registers
    (2, 64, 4),                      # a lane would own 2 < unroll
])
def test_odd_short_and_long_systems_take_the_block_pcr_kernel(rows, n,
                                                              unroll):
    assert pcr_route(rows, n, unroll) == "block"


# ---------------------------------------------------------------------------
# The warp kernels' exchange schedules, replayed lane by lane
# ---------------------------------------------------------------------------

LANES = torch.arange(32)


def _reg(v, i, fill):
    """Register i of v (..., NA, 32), or `fill` left of the array."""
    return v[..., i, :] if i >= 0 else torch.full_like(v[..., 0, :], fill)


def _compose(acc, na, nb):
    """linrec_level's order: acc_b = acc_a nb + acc_b, then acc_a na."""
    acc_a, acc_b = acc
    return acc_a * na, acc_a * nb + acc_b


def _linrec_shfl_stage(va, vb, fan_in, stride, sub_col):
    """One stage of stride < 32, registers from the last down: neighbour
    d = 32 q + r of register i on lane l is read from lane (l - r) % 32,
    which sends its register i - q (if it lies r or more lanes below 32)
    or i - q - 1; sub_col (several rows a warp) masks a row's start."""
    for i in reversed(range(va.shape[-2])):
        acc = (va[..., i, :], vb[..., i, :])
        for k in range(1, fan_in):
            d = k * stride
            q, r = divmod(d, 32)
            na, nb = _reg(va, i - q, 1.0), _reg(vb, i - q, 0.0)
            if r:
                own = LANES < 32 - r
                src = (LANES - r) % 32
                na = torch.where(own, na, _reg(va, i - q - 1, 1.0))[..., src]
                nb = torch.where(own, nb, _reg(vb, i - q - 1, 0.0))[..., src]
                if sub_col is not None:
                    na = torch.where(sub_col < d, 1.0, na)
                    nb = torch.where(sub_col < d, 0.0, nb)
            acc = _compose(acc, na, nb)
        va[..., i, :], vb[..., i, :] = acc


def _linrec_reg_stage(va, vb, fan_in, q_stride):
    """One stage of stride 32 Q in a warp's row: register i reads register
    i - k Q of its own lane."""
    for i in reversed(range(va.shape[-2])):
        acc = (va[..., i, :], vb[..., i, :])
        for k in range(1, fan_in):
            acc = _compose(acc, _reg(va, i - k * q_stride, 1.0),
                           _reg(vb, i - k * q_stride, 0.0))
        va[..., i, :], vb[..., i, :] = acc


def _linrec_plane_stage(va, vb, fan_in, stride, halo):
    """One stage of stride >= 32 in a row over warps, registers from the
    last down: neighbour k of register i is register i - k Q of the same
    lane (stride = 32 Q) inside the segment, else read from the row's
    planes at col - d, where each segment published only its top
    min(E, (fan_in - 1) Q) registers (the rest of the planes is NaN, so a
    read of an unpublished word shows)."""
    batch, segs, na_, _ = va.shape
    elems = na_ - halo
    q_stride = stride // 32
    pub = min(elems, (fan_in - 1) * q_stride)
    wa = torch.full((batch, segs, elems, 32), float("nan"))
    wb = torch.full((batch, segs, elems, 32), float("nan"))
    wa[:, :, elems - pub:] = va[:, :, halo + elems - pub:]
    wb[:, :, elems - pub:] = vb[:, :, halo + elems - pub:]
    wa, wb = wa.reshape(batch, -1), wb.reshape(batch, -1)
    col = torch.arange(segs * elems * 32).reshape(segs, elems, 32)
    for i in reversed(range(elems)):
        acc = (va[:, :, halo + i, :], vb[:, :, halo + i, :])
        for k in range(1, fan_in):
            j = i - k * q_stride
            if j >= 0:
                na, nb = va[:, :, halo + j, :], vb[:, :, halo + j, :]
            else:
                c = col[:, i, :] - k * stride
                na = torch.where(c >= 0, wa[:, c.clamp(min=0)], 1.0)
                nb = torch.where(c >= 0, wb[:, c.clamp(min=0)], 0.0)
            acc = _compose(acc, na, nb)
        va[:, :, halo + i, :], vb[:, :, halo + i, :] = acc


def replay_linrec(a, b, rows, tile, stages, *, gate=False, products=False,
                  seg_elems=32):
    """linrec_warp_kernel's schedule on CPU tensors: h (and the prefix
    products with ``products``).  A tile of at most 32 columns puts 32 /
    tile rows in a warp; up to 1024 one warp a row, E = tile / 32; beyond
    that segments of 32 x seg_elems columns (32 in the kernel) with a
    64-column halo."""
    batch, n = a.shape
    stages = tuple(stages)
    if not products:
        tile, stages = staged_piece(rows, tile, stages)
    strides = [math.prod(stages[:s]) for s in range(len(stages))]
    sub = tile <= 32
    halo = 2 if tile > 1024 else 0
    elems = seg_elems if halo else max(tile // 32, 1)
    segs = tile // (32 * elems) if not sub else 1
    h, p = torch.empty_like(a), torch.empty_like(a)
    carry = torch.zeros(batch, 1)
    for j in range(n // tile):
        cols = slice(j * tile, (j + 1) * tile)
        ta, tb = a[:, cols].float(), b[:, cols].float()
        if gate:
            tb = prim.rglru_gate(ta, tb)
        if sub:        # lane l: row l // tile of its warp, column l % tile
            va = ta.reshape(batch * tile // 32, 1, 1, 32).clone()
            vb = tb.reshape(batch * tile // 32, 1, 1, 32).clone()
            sub_col = LANES % tile
        else:
            va = torch.ones(batch, segs, halo + elems, 32)
            vb = torch.zeros(batch, segs, halo + elems, 32)
            va[:, :, halo:] = ta.reshape(batch, segs, elems, 32)
            vb[:, :, halo:] = tb.reshape(batch, segs, elems, 32)
            for s in range(1, segs):   # the 64 columns before segment s
                lo = s * 32 * elems - 32 * halo
                va[:, s, :halo] = ta[:, lo:lo + 32 * halo].reshape(
                    batch, halo, 32)
                vb[:, s, :halo] = tb[:, lo:lo + 32 * halo].reshape(
                    batch, halo, 32)
            sub_col = None
        for fan_in, stride in zip(stages, strides):
            if stride < 32:
                _linrec_shfl_stage(va, vb, fan_in, stride, sub_col)
            elif halo:
                _linrec_plane_stage(va, vb, fan_in, stride, halo)
            else:
                _linrec_reg_stage(va, vb, fan_in, stride // 32)
        ta = va[..., halo:, :].reshape(batch, tile)
        tb = vb[..., halo:, :].reshape(batch, tile)
        if products:
            h[:, cols], p[:, cols] = tb.to(a.dtype), ta.to(a.dtype)
        else:
            tb = tb + ta * carry
            carry = tb[:, -1:]
            h[:, cols] = tb.to(a.dtype)
    return (h, p) if products else h


def _pcr_eq(old, m, p):
    """pcr_step for one register: old, minus and plus neighbours as
    (a, b, c, d)."""
    a, b, c, d = old
    alpha, gamma = -a / m[1], -c / p[1]
    return (alpha * m[0], b + alpha * m[2] + gamma * p[0], gamma * p[2],
            d + alpha * m[3] + gamma * p[3])


def _warp_pcr(v):
    """One warp a system of m = 32 E equations, equation j on lane j % 32,
    register j / 32: v the four planes (batch, E, 32); returns x in the
    same layout."""
    batch, elems, _ = v[0].shape
    ident = [torch.full((batch, 32), f) for f in (0.0, 1.0, 0.0, 0.0)]
    for s in (1, 2, 4, 8, 16):
        # lane l reads i - s from lane (l - s) % 32, which sends register i
        # where lane + s < 32 there, else the register below (kept in prev);
        # and i + s from lane (l + s) % 32, which sends register i where
        # lane >= s there, else the register above
        own_m, own_p = LANES < 32 - s, LANES >= s
        from_m, from_p = (LANES - s) % 32, (LANES + s) % 32
        prev = ident
        for i in range(elems):
            old = [t[:, i].clone() for t in v]
            nxt = [t[:, i + 1] for t in v] if i + 1 < elems else ident
            m = [torch.where(own_m, o, q)[:, from_m] for o, q in zip(old, prev)]
            p = [torch.where(own_p, o, q)[:, from_p] for o, q in zip(old, nxt)]
            for t, new in zip(v, _pcr_eq(old, m, p)):
                t[:, i] = new
            prev = old
    # every lane's registers are now an independent chain (equation
    # 32 r + lane); lay chain l = j (32 / E) + L / E, equation r = L % E on
    # lane L, register j, and run the levels of stride 32 ... n / 2 as lane
    # shuffles within each chain of E lanes
    chains = elems and 32 // elems
    lane_chain = (torch.arange(elems)[:, None] * chains + LANES // elems)
    lane_r = LANES % elems
    v = [t[:, lane_r, lane_chain] for t in v]      # (batch, register j, lane L)
    s = 1
    while s < elems:
        from_m, from_p = (LANES - s) % 32, (LANES + s) % 32
        has_m, has_p = lane_r >= s, lane_r + s < elems
        old = [t.clone() for t in v]
        m = [torch.where(has_m, o[:, :, from_m], f)
             for o, f in zip(old, (0.0, 1.0, 0.0, 0.0))]
        p = [torch.where(has_p, o[:, :, from_p], f)
             for o, f in zip(old, (0.0, 1.0, 0.0, 0.0))]
        v = list(_pcr_eq(old, m, p))
        s *= 2
    x = v[3] / v[1]
    out = torch.empty(batch, elems, 32)
    out[:, lane_r, lane_chain] = x
    return out




def replay_pcr(a, b, c, d, unroll=None):
    """pcr_warp_kernel's schedule on CPU tensors: a lane owns E = unroll
    rounded up to a power of two equations (n / 32 by default: one warp a
    system), a system W = n / (32 E) warps, warp r, lane l, register i
    holding equation W (l + 32 i) + r.  The levels of stride 1 ... W / 2
    read their neighbours from a residue-major buffer (equation W j + r
    at r m + j, m = 32 E); then warp r solves residue r alone."""
    batch, n = a.shape
    elems = n // 32 if unroll is None else 1 << (unroll - 1).bit_length()
    warps, m = n // (32 * elems), 32 * elems
    v = [t.float().reshape(batch, elems, 32, warps).permute(0, 3, 1, 2)
         .reshape(batch, warps, m).clone() for t in (a, b, c, d)]
    fills = (0.0, 1.0, 0.0, 0.0)
    s = 1
    while s < warps:
        buf = [t.reshape(batch, warps * m).clone() for t in v]
        j = torch.arange(m)
        for r in range(warps):
            # g - s: residue r - s, one j lower where that wraps below 0;
            # g + s: residue r + s, one j higher where it wraps past W - 1
            rm, jm = (r - s, j) if r >= s else (r - s + warps, j - 1)
            rp, jp = (r + s, j) if r + s < warps else (r + s - warps, j + 1)
            has_m, has_p = jm >= 0, jp < m
            im = (rm * m + jm).clamp(0, warps * m - 1)
            ip = (rp * m + jp).clamp(0, warps * m - 1)
            old = [t[:, r] for t in v]
            mv = [torch.where(has_m, t[:, im], f) for t, f in zip(buf, fills)]
            pv = [torch.where(has_p, t[:, ip], f) for t, f in zip(buf, fills)]
            for t, new in zip(v, _pcr_eq(old, mv, pv)):
                t[:, r] = new
        s *= 2
    x = _warp_pcr([t.reshape(batch * warps, elems, 32) for t in v])
    return x.reshape(batch, warps, elems, 32).permute(0, 2, 3, 1).reshape(
        batch, n).to(a.dtype)


def _pair(seed, batch, n, slow=False):
    """a in [0.8, 0.99) (as the tests draw it), or, with ``slow``, in
    [0.9999, 1): the prefix products then stay near 1 over 32768 columns,
    so a wrong neighbour at any stride shows in h."""
    rng = np.random.default_rng(seed)
    lo, hi = (0.9999, 1.0) if slow else (0.8, 0.99)
    a = torch.from_numpy(rng.uniform(lo, hi, (batch, n)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((batch, n)).astype(np.float32))
    return a, b


@pytest.mark.parametrize("batch,n,rows,tile,radix,gate,seg", [
    (4, 256, 2, 128, 2, False, 32),      # a warp a row, E = 4, two tiles
    (4, 128, 1, 128, 4, True, 32),
    (2, 1024, 2, 1024, 8, False, 32),    # E = 32: register stages Q = 2, 16
    (2, 1024, 1, 1024, 4, False, 32),    # Q = 2, 8
    (8, 32, 8, 16, 2, False, 32),        # two rows a warp, two tiles
    (16, 8, 8, 8, 8, True, 32),          # four rows a warp
    (16, 16, 8, 16, 4, False, 32),
    (32, 4, 32, 2, 2, False, 32),        # sixteen rows a warp
    (4, 64, 4, 64, 8, False, 32),        # E = 2
    (2, 1024, 2, 512, 2, False, 4),      # rows over 4 warps of 128, halo
    (2, 512, 1, 512, 4, True, 4),        # halo reach 63
    (2, 512, 2, 512, 8, False, 4),
    (2, 2048, 2, 2048, 4, False, 32),    # the kernel's own 1024-col segments
    (64, 1024, 64, 1024, 2, False, 32),  # a staged 512-column piece
])
@pytest.mark.parametrize("slow", [False, True])
def test_linrec_warp_schedule_replays_the_plain_version(batch, n, rows, tile,
                                                        radix, gate, seg,
                                                        slow):
    a, b = _pair(batch * n + tile, batch, n, slow)
    stages = stage_radices(tile, radix)
    if tile > 1024 or seg < 32:
        assert scan_kernel.WARP_HALO_REACH >= sum(
            (f - 1) * math.prod(stages[:s]) for s, f in enumerate(stages)
            if math.prod(stages[:s]) < 32)
    want = scan_linrec_plain(a, b, rows_per_program=rows, tile_n=tile,
                             stages=stages, gate=gate)
    got = replay_linrec(a, b, rows, tile, stages, gate=gate, seg_elems=seg)
    assert torch.equal(got, want)


@pytest.mark.parametrize("batch,n,rows,radix,seg", [
    (4, 256, 2, 4, 32), (16, 16, 8, 2, 32), (2, 512, 1, 8, 4),
    (2, 2048, 1, 8, 32)])
def test_linrec_warp_schedule_replays_the_chunk_kernel(batch, n, rows, radix,
                                                       seg):
    a, b = _pair(batch + n, batch, n, slow=True)
    stages = stage_radices(n, radix)
    want = scan_linrec_prod_plain(a, b, rows_per_program=rows, stages=stages)
    got = replay_linrec(a, b, rows, n, stages, products=True, seg_elems=seg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def laplacian_system(seed, batch, n):
    """A perturbed 1-D Laplacian (a = c ~ -1, b ~ 2): unlike a strongly
    diagonally dominant system, whose off-diagonals underflow to 0 after a
    few PCR levels (so a later level's neighbours stop mattering), its
    coefficients keep their size at every level."""
    rng = np.random.default_rng(seed)
    a, c = (-1.0 - 0.01 * rng.random((batch, n)) for _ in range(2))
    b = 2.0 + 0.03 + 0.01 * rng.random((batch, n))
    d = rng.standard_normal((batch, n))
    a[:, 0] = 0.0
    c[:, -1] = 0.0
    return tuple(torch.from_numpy(v.astype(np.float32)) for v in (a, b, c, d))


@pytest.mark.parametrize("system", ["dominant", "laplacian"])
@pytest.mark.parametrize("n", [32, 64, 256, 1024])
def test_pcr_warp_schedule_replays_the_plain_version(n, system):
    """Both directions of every shuffle level and the register levels."""
    planes = random_system(torch.Generator().manual_seed(n), 3, n) \
        if system == "dominant" else laplacian_system(n, 3, n)
    assert pcr_route(1, n, 1) == "warp"
    want = pcr_plain(*planes, rows_per_program=1)
    assert bool(torch.isfinite(want).all())
    assert torch.equal(replay_pcr(*planes), want)



def _div_tiny(x, y):
    """csrc/tridiag.cu div_tiny in numpy, with div_near taken as the
    correctly rounded quotient (the card check holds it to __fdiv_rn):
    x scaled by 2^64, divided, and where the quotient is subnormal a
    scaled quotient on a midpoint of the subnormal grid moved one ulp
    toward the exact quotient before the final rounding."""
    f32, f64 = np.float32, np.float64
    xs = (x.astype(f64) * 2.0 ** 64).astype(f32)
    q = (xs.astype(f64) / y.astype(f64)).astype(f32)
    res = (-y.astype(f64) * q.astype(f64) + xs.astype(f64)).astype(f32)
    with np.errstate(over="ignore", invalid="ignore"):
        h = (np.abs(q).astype(f64) * 2.0 ** 86).astype(f32)
        odd = (h - f32(2) * np.trunc(h * f32(0.5))) == 1
    mid = (np.abs(q) < f32(2.0 ** -62)) & (res != 0) & odd
    qi = q.view(np.int32)
    toward = np.where((res.view(np.int32) ^ y.view(np.int32) ^ qi) >= 0,
                      1, -1)
    nudged = (qi + toward).astype(np.int32).view(f32)
    return (np.where(mid, nudged, q).astype(f64) * 2.0 ** -64).astype(f32)


@pytest.mark.parametrize("kind", ["random", "ties", "near ties"])
def test_pcr_scaled_divide_rounds_like_ieee_division(kind):
    """The warp PCR kernel's scaled divide (the levels whose dividends
    pass through the subnormals) equals IEEE float division on tiny and
    subnormal dividends and quotients, ties on the subnormal grid
    included."""
    rng = np.random.default_rng(len(kind))
    n = 200_000

    def bits(lo, hi):
        m = rng.integers(0, 1 << 23, n)
        e = rng.integers(127 + lo, 127 + hi + 1, n)
        s = rng.integers(0, 2, n)
        return ((s << 31) | (e << 23) | m).astype(np.uint32).view(np.float32)

    y = bits(-24, 24)
    if kind == "random":
        x = bits(-127, 32)
    else:
        k = rng.integers(0, 1 << 22, n).astype(np.float64)
        x = (y.astype(np.float64) * (k + 0.5) * 2.0 ** -149).astype(
            np.float32)
        if kind == "near ties":
            x = (x.view(np.int32) + rng.integers(-2, 3, n).astype(np.int32)
                 ).view(np.float32)
    want = (x.astype(np.float64) / y.astype(np.float64)).astype(np.float32)
    got = _div_tiny(x, y)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("system", ["dominant", "laplacian"])
@pytest.mark.parametrize("n,unroll", [(64, 1), (256, 1), (256, 2), (256, 4),
                                      (512, 3), (1024, 1), (1024, 2),
                                      (1024, 4), (1024, 16)])
def test_pcr_multiwarp_schedule_replays_the_plain_version(n, unroll, system):
    """A system over W = n / (32 E) warps: the shared levels' residue
    arithmetic (both directions, the wrap past either end), then each
    warp's residue class on its own; every admitted h100 unroll at the
    paper's n = 256 and 1024."""
    planes = random_system(torch.Generator().manual_seed(n + unroll), 3, n) \
        if system == "dominant" else laplacian_system(n + unroll, 3, n)
    assert pcr_route(1, n, unroll) == "warp"
    want = pcr_plain(*planes, rows_per_program=1, unroll=unroll)
    assert torch.equal(replay_pcr(*planes, unroll=unroll), want)
