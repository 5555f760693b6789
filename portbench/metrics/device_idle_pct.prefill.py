"""device_idle_pct.prefill [%]: the share of the traced stretch, over its
own bounds, in which no device operation ran (torch.profiler)."""
from portbench.readers import idle_pct


def read(record):
    return idle_pct(record)
