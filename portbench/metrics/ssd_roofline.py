"""ssd_roofline [%]: the SSD op's least time over the traced
stretch (work/ssd.py, whatever the chunk: x, a, b, c read once, y written
once, its linear-time operations) over the device time of every kernel
of the port's own sources in the profiler (``readers.port_kernels``: in
this model those are the SSD op's, from csrc/ssd.cu and csrc/linrec.cu).
Kernels are found in the sources, not listed here: a kernel that a later
change adds, splits or renames is counted, and a port kernel that joins
the path elsewhere lowers the share, never raises it."""
from portbench.readers import is_port_kernel


def read(record):
    t = record.get("trace")
    if record.get("driver") != "prefill" or not t:
        return None
    secs = sum(s for name, (_, s) in t["device_ops"].items()
               if is_port_kernel(name))
    if secs <= 0:
        return None
    return 100.0 * sum(c["ssd_least_s"] for c in record["trace_calls"]) / secs
