"""prefill_p95_ms [ms]: the 95th percentile of all requests'
latencies in the window, each from submission to logits ready
(synchronized)."""
import numpy as np


def read(record):
    if record.get("driver") != "prefill" or not record["latency_s"]:
        return None
    return float(np.percentile(record["latency_s"], 95)) * 1e3
