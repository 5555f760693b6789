"""entry_self_us_per_call.bplg [us]: the entry points' own host time over
the traced stretch, per call: the self time of the ``repro.entry.<name>``
spans the program records while the profiler runs
(``repro_torch.telemetry``), their durations less the resolve and launch
spans inside them: the plan lookup, the views and the Python between.
None where the program records no such span."""


def read(record):
    calls = record.get("trace_calls")
    if record.get("driver") != "ops" or not calls:
        return None
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    rows = [row for name, row in telemetry.summary().items()
            if name.startswith("repro.entry.")]
    return sum(r["self_ns"] for r in rows) / 1e3 / len(calls) \
        if rows else None
