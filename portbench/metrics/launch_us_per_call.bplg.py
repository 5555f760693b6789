"""launch_us_per_call.bplg [us]: the host side of the kernel launches over
the traced stretch, per entry-point call: the ``repro.launch.<wrapper>``
spans the program records while the profiler runs
(``repro_torch.telemetry``: the route, the output's allocation, the stream
and the ctypes call), summed.  None where the program records no such
span."""


def read(record):
    calls = record.get("trace_calls")
    if record.get("driver") != "ops" or not calls:
        return None
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    rows = [row for name, row in telemetry.summary().items()
            if name.startswith("repro.launch.")]
    return sum(r["total_ns"] for r in rows) / 1e3 / len(calls) \
        if rows else None
