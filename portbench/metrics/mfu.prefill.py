"""mfu.prefill [%]: the model's operations over the window
(work/mamba2.py: 2 a matrix parameter a token, the unembedding included,
plus the SSD's linear-time operations) over the window's time at the
dense bf16 peak."""
from portbench.work.peaks import BF16_FLOPS


def read(record):
    if record.get("driver") != "prefill" or record["window_s"] <= 0:
        return None
    return 100.0 * record["flops"] / (record["window_s"] * BF16_FLOPS)
