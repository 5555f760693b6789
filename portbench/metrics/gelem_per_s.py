"""gelem_per_s [Gelem/s]: all elements of the calls completed in
the window (scan elements, equations, FFT points) over all the window's
time, which ends after a final synchronize."""


def read(record):
    if record.get("driver") != "ops":
        return None
    return record["elements"] / record["window_s"] / 1e9
