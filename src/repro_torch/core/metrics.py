"""Performance-portability metric Phi (paper §VI, after Pennycook et al.).

    Phi(a, C) = |C| / sum_i 1 / e_i(a, p_i)

where e_i is the efficiency of methodology `a` on problem size p_i, measured
as a fraction of the best empirically-observed performance (the exhaustive
optimum). Phi = 1 means every size matched the optimum; the harmonic mean
punishes any single bad size hard — exactly why the paper chose it.
"""
from __future__ import annotations

from typing import Mapping, Sequence


def efficiency(achieved_time: float, best_time: float) -> float:
    """Performance efficiency in (0, 1]; performance = 1/time."""
    if achieved_time <= 0 or best_time <= 0:
        raise ValueError("times must be positive")
    return min(best_time / achieved_time, 1.0)


def phi(efficiencies: Sequence[float]) -> float:
    if not len(efficiencies):
        raise ValueError("need at least one efficiency")
    for e in efficiencies:
        if not (0 < e <= 1.0 + 1e-9):
            raise ValueError(f"efficiency out of range: {e}")
    return len(efficiencies) / sum(1.0 / e for e in efficiencies)


def phi_from_times(method_times: Mapping[int, float], best_times: Mapping[int, float]) -> float:
    """Phi over a common set of problem sizes: {N: time}."""
    sizes = sorted(method_times)
    if sorted(best_times) != sizes:
        raise ValueError("method and best time tables cover different sizes")
    return phi([efficiency(method_times[n], best_times[n]) for n in sizes])
