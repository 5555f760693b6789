"""Batched complex FFT of (batch, n) rows: each complex input read once and
each output written once; 5 n log2 n operations a row (the radix-2
count)."""
import math

from portbench.work.peaks import least_s


def work(batch: int, n: int, itemsize: int = 8):
    """(bytes, flops) of one call; ``itemsize`` of one complex element."""
    return 2 * batch * n * itemsize, 5.0 * batch * n * math.log2(n)


def least(batch: int, n: int, itemsize: int = 8) -> float:
    return least_s(*work(batch, n, itemsize))
