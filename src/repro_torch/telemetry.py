"""Spans at the port's layer boundaries, and its launch counters.

A span names a stretch of the host's work at one of four boundaries:

  * ``repro.entry.<name>`` — a call of a tuned entry point (``prefix_sum``,
    ``linear_recurrence``, ``solve``, ``fft``, ``ssd``, ``rglru``,
    ``attention``, ``matmul``): the plan, the views and the Python around
    the layers below;
  * ``repro.tuning.resolve`` — ``TunerSession.resolve``; its record notes
    whether the session's cache hit (``hit``);
  * ``repro.launch.<wrapper>`` — the body of a kernel wrapper that counts
    launches: the route, the output's allocation, the stream and the ctypes
    call (on a CPU tensor, the plain version);
  * ``repro.model.forward`` — ``Model.forward``;
  * ``repro.model.moe`` — a dropless MoE layer's call (its record notes the
    ``dispatch``), and inside it ``repro.moe.route`` (the router, the sort
    by expert and the counters) and ``repro.moe.experts`` (the gathers,
    the grouped products and the combine).

Spans are on exactly while a ``torch.profiler`` session records in the
process; nothing else turns them on.  Off, :func:`span` returns one shared
object whose enter and exit do nothing: no clock is read, nothing is
allocated and no profiler op is dispatched.  On, a span opens a profiler
range of its own name, so it lies on the profiler's timeline beside the
device's kernels (``export_chrome_trace`` writes it out), and appends one
:class:`Record` to a bounded buffer: its name, its start and end on
``time.perf_counter_ns``, its id, the id of the span open around it on the
same thread, and the id of the outermost one, its request.  :func:`spans`,
:func:`summary` and :func:`clear` read and empty the buffer.

The launch counters stay where ``count_launch`` keeps them, on the
wrappers (``fn.launches``, ``fn.launches_<route>``); :func:`launch_counts`
reads all of them, :func:`reset_launch_counts` zeroes them,
``LAUNCH_ROUTES`` names the routes each wrapper counts apart, and
``NEWEST_ROUTE`` names, for each kernel whose plan or shape picks between
a redesigned kernel and the earlier one, the redesign's route: the first
of its module's ``ROUTES``.

The dropless MoE's counters (:func:`count_moe`) stay on the device, so
that counting never waits on it: the rows routed to each expert, the
largest expert's rows summed over the calls, and the assignments the
expert products were not handed.  :func:`moe_counts` reads them (and
waits), :func:`reset_moe_counts` zeroes them.
"""
from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

CAPACITY = 1 << 16          # records kept; later ones are counted as dropped


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]   # the enclosing span's id, None at the top
    request: int            # the outermost enclosing span's id (or its own)
    attrs: Optional[Dict]   # what the span noted (``hit`` on a resolve)


_records: List[Record] = []
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()        # the buffer and its count of dropped


def _profiling() -> bool:
    """Whether a profiler records in this process.  Binds torch's own
    check on the first call, so importing this module imports no torch."""
    global _profiling
    import torch
    _profiling = torch._C._autograd._profiler_enabled
    return _profiling()


def _profiler_range(name: str):
    """The cheapest profiler range torch offers, as a context manager."""
    global _profiler_range
    import torch
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is None:
        from torch.profiler import record_function as fast
    _profiler_range = fast
    return fast(name)


class _Off:
    """The span while no profiler records: does nothing."""
    __slots__ = ()

    def note(self, **attrs) -> None:
        pass


OFF = _Off()
# enter and exit as C callables rather than Python methods, which halves
# the cost of a span that is off: enter returns OFF; exit takes the three
# exception arguments and returns "", false, so an exception propagates
_Off.__enter__ = itertools.repeat(OFF).__next__
_Off.__exit__ = "".format


class _Span:
    __slots__ = ("name", "attrs", "_range", "_start", "_id", "_parent",
                 "_request")

    def __init__(self, name: str):
        self.name = name
        self.attrs: Optional[Dict] = None

    def note(self, **attrs) -> None:
        """Attach ``attrs`` to the span's record."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._id = next(_ids)
        if stack:
            self._parent, self._request = stack[-1]._id, stack[-1]._request
        else:
            self._parent, self._request = None, self._id
        stack.append(self)
        self._range = _profiler_range(self.name)
        self._range.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        end = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _local.stack.pop()
        with _lock:
            if len(_records) < CAPACITY:
                _records.append(Record(self.name, self._start, end, self._id,
                                       self._parent, self._request,
                                       self.attrs))
            else:
                _dropped += 1
        return False


def span(name: str):
    """A context manager over one stretch of work named ``name``: a
    recorded span while a profiler records, else the shared no-op."""
    if not _profiling():
        return OFF
    return _Span(name)


def spanned(name: str) -> Callable:
    """Decorate a function so that each call is one span ``name``."""
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return deco


def spans() -> List[Record]:
    """The records kept since the last :func:`clear`, in closing order."""
    return list(_records)


def dropped() -> int:
    """Records not kept since the last :func:`clear`: the buffer was full."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def summary(records: Optional[List[Record]] = None) -> Dict[str, Dict]:
    """By span name: ``count``, ``total_ns`` (the sum of the durations) and
    ``self_ns`` (each span's duration less its children's)."""
    records = spans() if records is None else records
    children: Dict[int, int] = {}
    for r in records:
        if r.parent is not None:
            children[r.parent] = children.get(r.parent, 0) \
                + r.end_ns - r.start_ns
    out: Dict[str, Dict] = {}
    for r in records:
        row = out.setdefault(r.name, {"count": 0, "total_ns": 0,
                                      "self_ns": 0})
        took = r.end_ns - r.start_ns
        row["count"] += 1
        row["total_ns"] += took
        row["self_ns"] += took - children.get(r.id, 0)
    return out


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

def launch_wrappers() -> Dict[str, Callable]:
    """Every kernel wrapper that counts its CUDA launches, by name."""
    from repro_torch.kernels.attention.kernel import flash_attention
    from repro_torch.kernels.blocks.driver import apply_add, apply_linrec
    from repro_torch.kernels.fft.kernel import fft_pass, fft_stockham
    from repro_torch.kernels.matmul.kernel import matmul_tiled
    from repro_torch.kernels.scan.kernel import (scan_add, scan_linrec,
                                                 scan_linrec_prod)
    from repro_torch.kernels.ssd.kernel import (ssd_apply_entry, ssd_intra,
                                                ssd_state_apply)
    from repro_torch.kernels.tridiag.kernel import pcr, thomas
    return {"scan_add": scan_add, "apply_add": apply_add,
            "scan_linrec": scan_linrec, "scan_linrec_prod": scan_linrec_prod,
            "apply_linrec": apply_linrec, "pcr": pcr, "thomas": thomas,
            "fft_stockham": fft_stockham, "fft_pass": fft_pass,
            "ssd_intra": ssd_intra,
            "ssd_state_apply": ssd_state_apply,
            "ssd_apply_entry": ssd_apply_entry,
            "flash_attention": flash_attention, "matmul": matmul_tiled}


@functools.lru_cache(maxsize=None)
def _launch_routes() -> Dict[str, Tuple[str, ...]]:
    """The routes each wrapper counts apart, from its module's constants:
    ``ROUTES`` (a tuple of routes, or the route of each dtype) and
    ``THOMAS_ROUTES``; a bf16 matmul whose shape the tensor-core kernel
    does not take counts as "ragged" (``matmul_route``)."""
    import torch

    from repro_torch.kernels.attention import kernel as attention
    from repro_torch.kernels.fft import kernel as fft
    from repro_torch.kernels.matmul import kernel as matmul
    from repro_torch.kernels.scan import kernel as scan
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.kernels.tridiag import kernel as tridiag
    return {"flash_attention": tuple(attention.ROUTES.values()),
            "matmul": (matmul.ROUTES[torch.bfloat16], "ragged",
                       matmul.ROUTES[torch.float32]),
            "scan_add": scan.ROUTES, "scan_linrec": scan.ROUTES,
            "scan_linrec_prod": scan.ROUTES, "pcr": tridiag.ROUTES,
            "thomas": tridiag.THOMAS_ROUTES, "fft_stockham": fft.ROUTES,
            "ssd_intra": ssd.ROUTES, "ssd_state_apply": ssd.ROUTES,
            "ssd_apply_entry": ssd.ROUTES}


@functools.lru_cache(maxsize=None)
def _newest_route() -> Dict[str, str]:
    """The kernels whose plan or shape picks between an earlier kernel and
    its redesign, each with the redesign's route (its ``ROUTES[0]``)."""
    names = ("scan_add", "scan_linrec", "scan_linrec_prod", "pcr",
             "fft_stockham", "ssd_intra", "ssd_state_apply",
             "ssd_apply_entry")
    return {name: _launch_routes()[name][0] for name in names}


def __getattr__(name: str):
    # the route tables read the kernel modules, which import this one, so
    # they are built on first use rather than at import
    if name == "LAUNCH_ROUTES":
        return _launch_routes()
    if name == "NEWEST_ROUTE":
        return _newest_route()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def launch_counts() -> Dict[str, int]:
    """Launches by kernel, and by route as ``"<kernel>.<route>"``."""
    counts = {}
    for name, fn in launch_wrappers().items():
        counts[name] = fn.launches
        for route in _launch_routes().get(name, ()):
            counts[f"{name}.{route}"] = getattr(fn, f"launches_{route}")
    return counts


def reset_launch_counts() -> None:
    for name, fn in launch_wrappers().items():
        fn.launches = 0
        for route in _launch_routes().get(name, ()):
            setattr(fn, f"launches_{route}", 0)


# ---------------------------------------------------------------------------
# dropless MoE counters
# ---------------------------------------------------------------------------

_moe: Dict = {"calls": 0, "routed": 0, "acc": None}


def count_moe(counts, assigned: int, ends) -> None:
    """Add one dropless MoE call: ``counts`` (E,) the rows routed to each
    expert, ``assigned`` the call's (token, choice) assignments and
    ``ends`` (E,) the row ends the expert products were handed, the last
    of which falls short of ``assigned`` by the assignments dropped.  The
    sums stay on the tensors' device: nothing here waits on it."""
    import torch
    acc = _moe["acc"]
    if acc is None or acc.shape[0] != counts.shape[0] + 2 \
            or acc.device != counts.device:
        acc = _moe["acc"] = torch.zeros(counts.shape[0] + 2,
                                        dtype=torch.int64,
                                        device=counts.device)
    acc[:-2] += counts
    acc[-2] += counts.max()
    acc[-1] += assigned - ends[-1]
    _moe["calls"] += 1
    _moe["routed"] += assigned


def moe_counts() -> Dict:
    """The dropless MoE's counters since the last reset: ``calls``,
    ``routed`` (assignments), ``dropped`` (assignments no expert product
    was handed), ``rows`` (each expert's rows, a list) and ``max_rows``
    (the most-loaded expert's rows, summed over the calls).  Waits for the
    device."""
    acc = _moe["acc"]
    values = acc.tolist() if acc is not None else [0, 0]
    return {"calls": _moe["calls"], "routed": _moe["routed"],
            "dropped": values[-1], "rows": values[:-2],
            "max_rows": values[-2]}


def reset_moe_counts() -> None:
    _moe.update(calls=0, routed=0, acc=None)
