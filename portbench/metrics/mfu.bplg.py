"""mfu.bplg [%]: the calls' least times (work/) summed over the
window's wall time: the whole loop's share of the chip's peak."""


def read(record):
    if record.get("driver") != "ops" or record["window_s"] <= 0:
        return None
    return 100.0 * sum(record["least_s"]) / record["window_s"]
