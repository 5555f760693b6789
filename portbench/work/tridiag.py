"""Batched tridiagonal solve of (batch, n) systems: a, b, c and d read once,
x written once; the Thomas algorithm's 8 n - 7 operations a system (the
fewest of the family's algorithms)."""
from portbench.work.peaks import least_s


def work(batch: int, n: int, itemsize: int = 4):
    """(bytes, flops) of one call."""
    return 5 * batch * n * itemsize, batch * max(8 * n - 7, 0)


def least(batch: int, n: int, itemsize: int = 4) -> float:
    return least_s(*work(batch, n, itemsize))
