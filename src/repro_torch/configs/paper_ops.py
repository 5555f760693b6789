"""The paper's own workload set: parallel-prefix operations on batched
problem sizes (paper §V/§VI).  The PyTorch port's own copy of
``repro.configs.paper_ops``: the ML suite's batches and the CLI's default
batch come from ``TOTAL_ELEMS``."""
PREFIX_OPS = {
    "scan": {"variants": ["lf", "ks"], "sizes": [128, 256, 512, 1024, 2048, 4096]},
    "tridiag": {"variants": ["cr", "pcr", "lf", "wm"],
                "sizes": [64, 128, 256, 512, 1024]},
    "fft": {"variants": ["stockham"], "sizes": [64, 128, 256, 512, 1024, 2048, 4096]},
    "large_fft": {"variants": ["stockham"],
                  "sizes": [8192, 65536, 1048576, 8388608]},
}
TOTAL_ELEMS = 2 ** 26   # paper: batch = 2^26 / N problems per invocation
