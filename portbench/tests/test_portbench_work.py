"""Operations and bytes of each op family at small shapes, and the least
times they give."""
import math

import pytest

from portbench.work import fft, mamba2, peaks, scan, ssd, tridiag


def test_scan_counts():
    assert scan.work(3, 8) == (2 * 3 * 8 * 4, 3 * 7)


def test_tridiag_counts():
    assert tridiag.work(2, 16) == (5 * 2 * 16 * 4, 2 * (8 * 16 - 7))


def test_fft_counts():
    nbytes, flops = fft.work(4, 64)
    assert nbytes == 2 * 4 * 64 * 8
    assert flops == pytest.approx(5 * 4 * 64 * 6)


def test_ssd_counts():
    nbytes, flops = ssd.work(B=2, L=8, H=3, P=4, S=5)
    assert nbytes == 4 * (2 * 2 * 8 * 3 * 4 + 2 * 8 * 3 + 2 * 2 * 8 * 5)
    assert flops == 5 * 2 * 8 * 3 * 5 * 4


def test_least_is_the_larger_bound():
    assert peaks.least_s(peaks.HBM_BYTES_PER_S, 0.0) == pytest.approx(1.0)
    assert peaks.least_s(0.0, peaks.F32_FLOPS) == pytest.approx(1.0)
    assert peaks.least_s(1.0, peaks.BF16_FLOPS, peaks.BF16_FLOPS) == \
        pytest.approx(1.0)


def test_paper_sizes_are_memory_bound():
    total = 1 << 26
    for n in (128, 4096):
        assert scan.least(total // n, n) == pytest.approx(
            2 * total * 4 / peaks.HBM_BYTES_PER_S)
    for n in (64, 1024):
        assert tridiag.least(total // n, n) == pytest.approx(
            5 * total * 4 / peaks.HBM_BYTES_PER_S)
    for n in (64, 4096):
        assert fft.least(total // n, n) == pytest.approx(
            2 * total * 8 / peaks.HBM_BYTES_PER_S)


def test_mamba2_matrix_parameters(bench):
    cfg = bench.config(bench.cell("mamba2.prefill"))
    per_layer = 768 * (2 * 1536 + 2 * 128 + 24) + 1536 * 768
    assert mamba2.matrix_params(cfg) == 24 * per_layer + 50288 * 768
    flops = mamba2.flops(cfg, 4, 512)
    assert flops == pytest.approx(
        2 * mamba2.matrix_params(cfg) * 4 * 512
        + 24 * 5 * 4 * 512 * 24 * 128 * 64)
    assert math.isfinite(flops)
