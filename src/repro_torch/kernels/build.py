"""Build and bind the port's CUDA kernels (``repro_torch/csrc``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``: one
``nvcc -c`` per source, all started together, then one link.  The
library lands in ``repro_torch/_build/<hash>/`` (listed in .gitignore),
keyed by a hash of the sources and the flags, so an edited source is
rebuilt and an unchanged one is not.  Nothing here runs at import time:
the first kernel launch calls :func:`load_library`.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
SOURCES = ("scan.cu", "linrec.cu", "tridiag.cu", "fft.cu", "ssd.cu",
           "attention.cu", "matmul.cu")
HEADERS = ("sm90.cuh",)   # included by attention.cu, matmul.cu and ssd.cu
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_kernels.so"

# what the last build in this process reported (build seconds, each nvcc
# call's seconds by source and the link's, ptxas log)
BUILD_INFO: Dict[str, object] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDACXX"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set $CUDACXX or put the CUDA "
                       "toolkit's bin directory on PATH)")


def _source_paths() -> List[str]:
    return [os.path.join(CSRC, s) for s in SOURCES]


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _source_paths() + [os.path.join(CSRC, s) for s in HEADERS]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build_library(force: bool = False) -> str:
    """Compile the sources unless this exact build exists (or ``force``);
    returns the library path.  Raises with nvcc's output when the build
    fails."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib) and not force:
        if BUILD_INFO.get("path") != lib:
            BUILD_INFO.update(path=lib, seconds=0.0, cached=True, log="",
                              source_seconds={})
        return lib
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(out_dir, f"{os.path.splitext(s)[0]}.{tag}.o")
            for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for obj, src in zip(objs, _source_paths())]
    tmp = f"{lib}.{tag}"
    cmds.append([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                 "-o", tmp, *objs])
    def run(cmd):
        t = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        return proc, time.perf_counter() - t

    t0 = time.perf_counter()
    logs, source_seconds = [], {}
    # every source at once, then the link
    for batch in (cmds[:-1], cmds[-1:]):
        with ThreadPoolExecutor(len(batch)) as pool:
            done = list(pool.map(run, batch))
        for cmd, (proc, secs) in zip(batch, done):
            out = " ".join(cmd) + "\n" + proc.stdout
            logs.append(out)
            key = os.path.basename(cmd[-1]) if "-c" in cmd else "link"
            source_seconds[key] = secs
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{out}")
    seconds = time.perf_counter() - t0
    log = "\n".join(logs)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(log)
    os.replace(tmp, lib)
    for obj in objs:
        os.remove(obj)
    BUILD_INFO.update(path=lib, seconds=seconds, cached=False, log=log,
                      source_seconds=source_seconds)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built kernel library with every C signature declared."""
    lib = ctypes.CDLL(build_library())
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_scan_add.argtypes = [vp, vp, i32, i64, i64, i32, i32,
                                   ctypes.POINTER(ctypes.c_int), i32, i32, vp]
    lib.repro_scan_add.restype = i32
    lib.repro_scan_add_warp.argtypes = lib.repro_scan_add.argtypes
    lib.repro_scan_add_warp.restype = i32
    lib.repro_apply_add.argtypes = [vp, vp, vp, i32, i64, i64, i32, vp]
    lib.repro_apply_add.restype = i32
    lib.repro_linrec_scratch.argtypes = [i64, i32, i32, i32]
    lib.repro_linrec_scratch.restype = i64
    lib.repro_scan_linrec.argtypes = [vp, vp, vp, vp, i32, i64, i64, i32, i32,
                                      ctypes.POINTER(ctypes.c_int), i32, i32,
                                      i32, vp, vp]
    lib.repro_scan_linrec.restype = i32
    lib.repro_scan_linrec_warp.argtypes = lib.repro_scan_linrec.argtypes
    lib.repro_scan_linrec_warp.restype = i32
    lib.repro_apply_linrec.argtypes = [vp, vp, vp, vp, i32, i64, i64, i32, vp]
    lib.repro_apply_linrec.restype = i32
    lib.repro_pcr.argtypes = [vp, vp, vp, vp, vp, i32, i64, i32, i32, i32,
                              i32, vp]
    lib.repro_pcr.restype = i32
    lib.repro_pcr_warp.argtypes = lib.repro_pcr.argtypes
    lib.repro_pcr_warp.restype = i32
    lib.repro_thomas.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32, i64, i32,
                                 vp]
    lib.repro_thomas.restype = i32
    lib.repro_pcr_divide_check.argtypes = [vp, vp, i64, vp, vp]
    lib.repro_pcr_divide_check.restype = i32
    lib.repro_fft.argtypes = [vp, vp, i64, i32, i32,
                              ctypes.POINTER(ctypes.c_int), i32, i32, i32,
                              vp]
    lib.repro_fft.restype = i32
    lib.repro_fft_pow2.argtypes = lib.repro_fft.argtypes
    lib.repro_fft_pow2.restype = i32
    lib.repro_ssd_intra.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i32, i64,
                                    i64, i32, i32, i64, i32, vp]
    lib.repro_ssd_intra.restype = i32
    lib.repro_ssd_apply.argtypes = [vp, vp, vp, vp, vp, vp, i32, i64, i64,
                                    i32, i32, i64, i32, i32, vp]
    lib.repro_ssd_apply.restype = i32
    lib.repro_ssd_intra_tiled.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32,
                                          i64, i64, i32, i32, i64, i32, vp]
    lib.repro_ssd_intra_tiled.restype = i32
    lib.repro_ssd_state_apply_tiled.argtypes = [vp, vp, vp, vp, vp, vp, i32,
                                                i64, i64, i32, i32, i64, i32,
                                                vp]
    lib.repro_ssd_state_apply_tiled.restype = i32
    lib.repro_ssd_apply_entry_tiled.argtypes = [vp, vp, vp, vp, vp, i32, i64,
                                                i64, i32, i32, i64, i32, vp]
    lib.repro_ssd_apply_entry_tiled.restype = i32
    lib.repro_flash_attention.argtypes = [vp, vp, vp, vp, i32, i64, i32, i32,
                                          i32, i32, i32, i32, i32,
                                          ctypes.c_float, vp]
    lib.repro_flash_attention.restype = i32
    lib.repro_matmul.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32,
                                 i32, vp]
    lib.repro_matmul.restype = i32
    lib.repro_flash_attention_wgmma.argtypes = [vp, vp, vp, vp, i64, i32, i32,
                                                i32, i32, i32, i32, i32,
                                                ctypes.c_float, vp]
    lib.repro_flash_attention_wgmma.restype = i32
    lib.repro_matmul_wgmma.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32,
                                       i32, vp]
    lib.repro_matmul_wgmma.restype = i32
    lib.repro_wgmma_probe.argtypes = [vp, vp, vp, i32, i32, i32, vp]
    lib.repro_wgmma_probe.restype = i32
    lib.repro_error_string.argtypes = [i32]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if code != 0:
        msg = load_library().repro_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
