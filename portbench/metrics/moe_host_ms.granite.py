"""moe_host_ms.granite [ms]: the host's time to enqueue one MoE layer over
the traced stretch: the mean duration of the ``repro.model.moe`` spans the
program records while the profiler runs (``repro_torch.telemetry``).  None
where the program records no such span."""


def read(record):
    if record.get("driver") != "prefill" or not record.get("trace_calls"):
        return None
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    row = telemetry.summary().get("repro.model.moe")
    return row["total_ns"] / 1e6 / row["count"] if row else None
