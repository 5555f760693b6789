"""scan_roofline [%]: the scan calls' least time (work/scan.py: bytes at
the memory rate or operations at the f32 rate, from the shapes alone) over
their device time (CUDA events around each call)."""
from portbench.readers import family_roofline


def read(record):
    return family_roofline(record, "scan")
