"""tridiag_roofline [%]: the tridiag calls' least time (work/tridiag.py: bytes at
the memory rate or operations at the f32 rate, from the shapes alone) over
their device time (CUDA events around each call)."""
from portbench.readers import family_roofline


def read(record):
    return family_roofline(record, "tridiag")
