"""resolve_us_per_call.bplg [us]: the host's time in the tuning session's
resolve over the traced stretch, per entry-point call: the
``repro.tuning.resolve`` spans the program records while the profiler
runs (``repro_torch.telemetry``), summed.  None where the program records
no such span."""


def read(record):
    calls = record.get("trace_calls")
    if record.get("driver") != "ops" or not calls:
        return None
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    row = telemetry.summary().get("repro.tuning.resolve")
    return row["total_ns"] / 1e3 / len(calls) if row else None
