"""Helpers the metric readers (``metrics/<name>.py``) share.  A reader
takes a run's record and returns its number, or None where the record
holds nothing to read (then the metric is left out of the line)."""
from __future__ import annotations

import functools
import os
import re
from typing import Dict, FrozenSet, Optional

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch")
_BOUNDS = re.compile(r"__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)")
_GLOBAL = re.compile(r"__global__\s+void\s+(\w+)\s*[(<]")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)")


@functools.lru_cache(maxsize=None)
def port_kernels(root: str = PORT) -> FrozenSet[str]:
    """The names of every kernel the port's sources define: each
    ``__global__`` function of its CUDA files (and of CUDA held in its
    Python files) and each ``@triton.jit`` function, found in the sources
    as they stand, so a kernel that is added, split or renamed is counted
    without an edit here."""
    names = set()
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith((".cu", ".cuh", ".py")):
                continue
            with open(os.path.join(dirpath, f), errors="replace") as fh:
                text = _BOUNDS.sub(" ", fh.read())
            names.update(_GLOBAL.findall(text))
            if f.endswith(".py"):
                names.update(_TRITON.findall(text))
    return frozenset(names)


def kernel_name(name: str) -> str:
    """The bare function name of a device operation as the profiler gives
    it: ``void (anonymous namespace)::k<float>(int, ...)`` -> ``k``."""
    head = re.sub(r"\(anonymous namespace\)::", "", name)
    words = head.split("(", 1)[0].split("<", 1)[0].split()
    return words[-1].rsplit("::", 1)[-1] if words else ""


def is_port_kernel(name: str) -> bool:
    return kernel_name(name) in port_kernels()


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def family_roofline(record: Dict, family: str) -> Optional[float]:
    """The family's least time over its calls, as a percentage of their
    device time (CUDA events around each call)."""
    if record.get("driver") != "ops" or not record.get("device_s"):
        return None
    least = dev = 0.0
    for (fam, _, _), lo, secs in zip(record["calls"], record["least_s"],
                                     record["device_s"]):
        if fam == family:
            least += lo
            dev += secs
    return 100.0 * least / dev if dev > 0 else None


def idle_pct(record: Dict) -> Optional[float]:
    """The share of the traced window in which no device operation ran."""
    t = record.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
