"""kernels_per_call.bplg [kernels]: device kernels (copies and sets
left out) per entry-point call over the traced stretch, from the profiler."""
from portbench.readers import is_copy


def read(record):
    t = record.get("trace")
    if record.get("driver") != "ops" or not t:
        return None
    kernels = sum(n for name, (n, _) in t["device_ops"].items()
                  if not is_copy(name))
    return kernels / len(record["trace_calls"])
