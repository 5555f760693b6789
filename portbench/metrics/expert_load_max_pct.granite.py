"""expert_load_max_pct.granite [%]: the most-loaded expert's rows over the
mean expert's, a dropless MoE call at a time, over the whole run (warm-up,
window and traced stretch): the straggler bound of a grouped product, from
the program's counters (``repro_torch.telemetry.moe_counts``).  None where
the program has no such counters or counted no call."""


def read(record):
    if record.get("driver") != "prefill":
        return None
    try:
        from repro_torch import telemetry
        counts = telemetry.moe_counts()
    except (ImportError, AttributeError):
        return None
    if not counts["routed"]:
        return None
    return 100.0 * counts["max_rows"] * len(counts["rows"]) \
        / counts["routed"]
