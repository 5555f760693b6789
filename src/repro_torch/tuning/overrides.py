"""Scoped config overrides for benchmarks, tests, and experiments.

    with tuning.overrides(scan={"radix": 4}):
        prefix_sum(x)                      # resolves with radix forced to 4

Overrides stack: nested ``with`` blocks merge per-op fragments with the
innermost block winning, and every block restores the previous state on
exit (including on exceptions). The stack is thread-local, so concurrent
request threads cannot see each other's experiments.

Keys are op names (``scan``, ``tridiag``, ``fft``, ``large_fft``, ``ssd``,
``rglru``, ``attention``, ``matmul``); values are partial config dicts merged on top of whatever the
session resolves (DB hit, analytical suggestion, or an explicit
``config=`` argument).

The PyTorch port's own copy of ``repro.tuning.overrides``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Mapping, Optional

_LOCAL = threading.local()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


@contextlib.contextmanager
def overrides(**per_op: Mapping[str, int]) -> Iterator[None]:
    """Force config knobs for the ops named by keyword, within the block."""
    frame: Dict[str, Dict[str, int]] = {}
    for op, fragment in per_op.items():
        if not isinstance(fragment, Mapping):
            raise TypeError(
                f"overrides({op}=...) expects a mapping of knob -> value, "
                f"got {type(fragment).__name__}")
        frame[op] = dict(fragment)
    stack = _stack()
    stack.append(frame)
    try:
        yield
    finally:
        stack.pop()


def active_overrides(op: str) -> Optional[Dict[str, int]]:
    """Merged override fragment for ``op`` (innermost wins), or None."""
    stack = getattr(_LOCAL, "stack", None)
    if not stack:
        return None
    merged: Dict[str, int] = {}
    for frame in stack:
        fragment = frame.get(op)
        if fragment:
            merged.update(fragment)
    return merged or None


def overrides_active() -> bool:
    return bool(getattr(_LOCAL, "stack", None))
