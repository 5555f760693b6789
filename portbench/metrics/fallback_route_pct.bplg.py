"""fallback_route_pct.bplg [%]: the share of the launches of the kernels
that pick between a redesigned kernel and the earlier one
(``repro_torch.telemetry.NEWEST_ROUTE``) that took the earlier one, over
the whole process (warm-up, window and traced stretch), from the program's
launch counters (``telemetry.launch_counts``).  None where the program has
no such counters or counted no such launch."""


def read(record):
    if record.get("driver") != "ops":
        return None
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    counts = telemetry.launch_counts()
    newest = telemetry.NEWEST_ROUTE
    total = sum(counts[name] for name in newest)
    if total == 0:
        return None
    on_newest = sum(counts[f"{name}.{route}"]
                    for name, route in newest.items())
    return 100.0 * (total - on_newest) / total
