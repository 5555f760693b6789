"""Which kernel a scan or FFT launch runs on the card, decided by the plan.

``scan_add`` and ``fft_stockham`` each have two CUDA kernels: the warp /
pow2 kernel, redesigned for Hopper, and the earlier block / generic kernel
for the stage sequences the new one does not take.  The choice is a pure
function of the plan (``scan_route``, ``fft_route``), so it is held here on
the CPU: every admitted h100 config at the paper's sizes, and every launch
of the multipass and four-step drivers, goes to the new kernel; ragged,
prime and short sequences go to the earlier one.  On the CPU the wrappers
run their plain versions and count no launch on any route.
"""
import importlib
import math

import pytest
import torch

from repro_torch.core.space import Workload, fft_space, scan_space
from repro_torch.kernels.blocks import driver
from repro_torch.kernels.blocks.plan import plan_for, stage_radices
from repro_torch.kernels.fft import kernel as fft_kernel
from repro_torch.kernels.fft.kernel import (fft_route, fft_stockham,
                                            pow2_table_points)
from repro_torch.kernels.fft.ops import fft, fft_plan
from repro_torch.kernels.scan import kernel as scan_kernel
from repro_torch.kernels.scan.kernel import scan_add, scan_route, staged_piece
from repro_torch.kernels.scan.ops import _plan_workload, prefix_sum

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
    counts = lambda: (scan_add.launches, scan_add.launches_warp,  # noqa: E731
                      scan_add.launches_block, fft_stockham.launches,
                      fft_stockham.launches_pow2,
                      fft_stockham.launches_generic)
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
