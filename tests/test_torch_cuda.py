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
from repro_torch.kernels.blocks.plan import stage_radices
from repro_torch.kernels.scan.kernel import scan_add, scan_add_plain
from repro_torch.kernels.scan.ops import prefix_sum

pytestmark = pytest.mark.cuda

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
