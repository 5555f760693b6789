"""moe_roofline.granite [%]: the MoE layers' least time over the traced
stretch (work/granite4h.py ``moe_least``: a layer's operations, the router,
the top-k experts and the shared one at 2 a multiply-add, at the bf16 peak,
or its bytes, every expert's weights read once and the tokens in and out,
at the memory rate, whichever is larger) over their device time (CUDA
events that drivers/hybrid_prefill.py records around each MoE module).
None where the record holds no such times."""


def read(record):
    calls = record.get("trace_calls") \
        if record.get("driver") == "prefill" else None
    if not calls or "moe_device_s" not in calls[0]:
        return None
    secs = sum(c["moe_device_s"] for c in calls)
    if secs <= 0:
        return None
    return 100.0 * sum(c["moe_least_s"] for c in calls) / secs
