"""Inclusive row-wise prefix sum of (batch, n) rows: each input read once,
each output written once; n - 1 additions a row."""
from portbench.work.peaks import least_s


def work(batch: int, n: int, itemsize: int = 4):
    """(bytes, flops) of one call."""
    return 2 * batch * n * itemsize, batch * (n - 1)


def least(batch: int, n: int, itemsize: int = 4) -> float:
    return least_s(*work(batch, n, itemsize))
