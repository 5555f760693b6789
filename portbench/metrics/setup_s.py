"""setup_s [s]: process start to the first timed call: imports,
the library loaded (built on a first run), inputs and weights made, every
shape of the mix warmed up."""


def read(record):
    return record["setup_s"]
