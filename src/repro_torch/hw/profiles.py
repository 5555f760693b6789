"""Hardware profiles — parametric machine models as data, not code.

The paper retargets its analytical and ML tuning methodologies across
devices by swapping the machine model underneath (PAPER.md §III–V).  A
:class:`HardwareProfile` is a frozen dataclass of architectural constants
(peak rates, memory hierarchy, tiling geometry, launch/sync latencies)
plus the machine-model response curves evaluated against it (lane/sublane
utilization, memory-transfer ramp, ILP issue factor).

This is the PyTorch port's own copy of ``repro.hw.profiles``: the three
profiles of the JAX package (``tpu_v5e``, ``gpu_sm``, ``cpu_interpret``)
are carried unchanged, so spaces, plans and costs can be compared between
the two packages under each of them, and one more is added:

* ``h100`` — the NVIDIA H100 SXM5 (80 GB HBM3) the port's CUDA kernels run
  on, from NVIDIA's data sheet.  It is the port's default profile.

``active_profile()`` resolves ``$REPRO_TORCH_HW_PROFILE`` (default
``h100``).  The registry is the port's own: registering a profile here
never changes what the JAX package sees.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """One device's architectural constants (the paper's Table of limits).

    Field defaults ARE the TPU v5e machine model — ``HardwareProfile()``
    is bit-identical to the historical ``TpuSpec()`` so every cost the
    pre-profile stack computed is reproduced exactly.
    """

    name: str = "tpu_v5e"
    # --- identity ---
    kind: str = "tpu"                     # "tpu" | "gpu" | "cpu"
    backend: str = "pallas_tpu"           # "pallas_tpu" | "pallas_triton"
    #                                       | "cuda"
    #                                       | "interpret"
    # --- per-chip peak rates ---
    peak_bf16_flops: float = 197e12       # FLOP/s per chip, matrix-unit bf16
    peak_f32_flops: float = 98.5e12       # matrix-unit f32
    peak_vpu_flops: float = 3.2e12        # vector/elementwise f32
    hbm_bandwidth: float = 819e9          # B/s per chip
    ici_link_bandwidth: float = 50e9      # B/s per interconnect link
    # --- memory hierarchy ---
    hbm_bytes: int = 16 * 2**30           # device memory per chip
    vmem_bytes: int = 128 * 2**20         # fast on-chip scratch pool
    vmem_budget: int = 64 * 2**20         # usable budget for kernel
    #                                       working sets (SearchSpace bound)
    # --- tiling geometry ---
    lane_count: int = 128                 # trailing vector dim (warp width
    #                                       on GPU, SIMD lanes on CPU)
    sublane_count: int = 8                # second-to-last vector dim
    mxu_dim: int = 128                    # matrix-unit edge (tensor-core
    #                                       tile on GPU)
    # --- pipeline model ---
    dma_latency_s: float = 2e-6           # per-block DMA issue latency
    kernel_launch_s: float = 5e-6         # fixed kernel-launch overhead
    pass_sync_s: float = 1.5e-6           # per-pass barrier/flush cost
    dma_half_bytes: int = 64 * 2**10      # DMA ramp half-saturation point
    ilp_base: float = 0.55                # issue utilization at unroll=1
    ilp_slope: float = 0.15               # utilization gained per doubling
    # --- power model (energy = idle + compute-activity + data-movement) ---
    idle_w: float = 60.0                  # static draw while a kernel runs
    peak_compute_w: float = 140.0         # dynamic draw of busy compute units
    hbm_pj_per_byte: float = 150.0        # pJ per byte moved through HBM/DDR
    # --- mesh geometry ---
    chips_per_pod: int = 256
    # --- GPU geometry (0 where the profile does not model it) ---
    sm_count: int = 0                     # streaming multiprocessors


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

TPU_V5E = HardwareProfile()

GPU_SM = HardwareProfile(
    name="gpu_sm",
    kind="gpu",
    backend="pallas_triton",
    # Ampere-class server part (where the Pallas Triton backend runs),
    # with the CUDA-core/SMEM field shape of the paper's GM20B table
    peak_bf16_flops=165e12,               # tensor-core bf16
    peak_f32_flops=19.5e12,               # tensor-core tf32-ish
    peak_vpu_flops=19.5e12,               # CUDA-core f32
    hbm_bandwidth=1555e9,
    ici_link_bandwidth=600e9,             # NVLink
    hbm_bytes=40 * 2**30,
    vmem_bytes=40 * 2**20,                # L2 slice + SMEM pool
    vmem_budget=512 * 2**10,              # per-CTA staging budget (SMEM +
    #                                       register file the scheduler can
    #                                       keep resident per program)
    lane_count=32,                        # warp width
    sublane_count=4,                      # scheduler partitions per SM
    mxu_dim=16,                           # tensor-core tile edge
    dma_latency_s=1e-6,
    kernel_launch_s=8e-6,                 # CUDA launch overhead
    pass_sync_s=4e-6,                     # global barrier == kernel relaunch
    dma_half_bytes=32 * 2**10,            # coalescing saturates earlier
    ilp_base=0.60,
    ilp_slope=0.10,
    idle_w=90.0,                          # server-part static draw
    peak_compute_w=310.0,                 # SM array at full issue
    hbm_pj_per_byte=180.0,                # HBM2e access energy
    chips_per_pod=8,                      # one NVLink island
)

CPU_INTERPRET = HardwareProfile(
    name="cpu_interpret",
    kind="cpu",
    backend="interpret",
    # pallas interpret mode on the CI host: AVX-ish vector unit, DDR
    # bandwidth, LLC as the "VMEM" analogue.  Exists so the profile layer
    # (spaces, plans, objectives, DB keying) is exercisable in CI without
    # accelerators — the constants are deliberately round.
    peak_bf16_flops=5e10,                 # bf16 emulated: slower than f32
    peak_f32_flops=1e11,
    peak_vpu_flops=1e11,
    hbm_bandwidth=40e9,
    ici_link_bandwidth=10e9,
    hbm_bytes=16 * 2**30,
    vmem_bytes=32 * 2**20,                # last-level cache
    vmem_budget=4 * 2**20,                # per-program resident working set
    lane_count=8,                         # AVX f32 lanes
    sublane_count=1,
    mxu_dim=8,
    dma_latency_s=1e-7,
    kernel_launch_s=50e-6,                # interpret-mode dispatch is slow
    pass_sync_s=1e-6,
    dma_half_bytes=4 * 2**10,             # streaming saturates quickly
    ilp_base=0.70,
    ilp_slope=0.10,
    idle_w=20.0,                          # host package at light load
    peak_compute_w=45.0,                  # vector units saturated
    hbm_pj_per_byte=400.0,                # DDR access is energy-expensive
    chips_per_pod=1,
)

H100 = HardwareProfile(
    name="h100",
    kind="gpu",
    backend="cuda",
    # NVIDIA H100 SXM5 80 GB data sheet (dense rates, 700 W board limit)
    peak_bf16_flops=989e12,               # tensor-core bf16
    peak_f32_flops=495e12,                # tensor-core tf32
    peak_vpu_flops=67e12,                 # CUDA-core f32
    hbm_bandwidth=3.35e12,                # HBM3
    ici_link_bandwidth=450e9,             # NVLink, each way
    hbm_bytes=80 * 2**30,
    vmem_bytes=50 * 2**20,                # L2: the on-chip pool blocks share
    # Per-block staging budget.  scan_space admits a config when
    # rows * tile_n * dtype_bytes * 2 <= vmem_budget, but the CUDA scan
    # kernel (csrc/scan.cu) stages its tile in f32 whatever the input type:
    # it needs rows * tile_n * 4 bytes of shared memory plus rows * 4 for
    # the row carry.  For bf16 (2 bytes) the admitted tile is therefore
    # rows * tile_n <= 2**17 / 4 = 32768 elements -> 128 KiB of f32 tile
    # (+ at most 512 * 4 = 2 KiB of carry); for f32 it is 16384 elements
    # -> 64 KiB.  Both fit the 227 KB (232,448 bytes) a block may use.
    vmem_budget=2**17,
    lane_count=32,                        # warp width
    sublane_count=4,                      # warp schedulers per SM
    mxu_dim=16,                           # mma.sync tile edge
    dma_latency_s=1e-6,
    kernel_launch_s=8e-6,                 # eager PyTorch launch overhead
    pass_sync_s=4e-6,                     # global barrier == kernel relaunch
    dma_half_bytes=32 * 2**10,
    ilp_base=0.60,
    ilp_slope=0.10,
    idle_w=100.0,                         # model constants, not measured
    peak_compute_w=500.0,
    hbm_pj_per_byte=120.0,
    chips_per_pod=8,                      # one NVLink (HGX) node
    sm_count=132,
)

_PROFILES: Dict[str, HardwareProfile] = {}


def register_profile(profile: HardwareProfile) -> HardwareProfile:
    """Add (or replace) a profile in the registry; returns it."""
    _PROFILES[profile.name] = profile
    return profile


def get_profile(name: str) -> HardwareProfile:
    try:
        return _PROFILES[name]
    except KeyError:
        raise ValueError(f"unknown hardware profile {name!r}; registered: "
                         f"{', '.join(profiles())}") from None


def profiles() -> Tuple[str, ...]:
    return tuple(sorted(_PROFILES))


def active_profile() -> HardwareProfile:
    """The process-wide default profile: ``$REPRO_TORCH_HW_PROFILE`` or h100.

    Read per call (cheap dict lookups), so tests can retarget the stack by
    environment without import-order traps.
    """
    return get_profile(os.environ.get("REPRO_TORCH_HW_PROFILE", "h100"))


for _p in (TPU_V5E, GPU_SM, CPU_INTERPRET, H100):
    register_profile(_p)


# ---------------------------------------------------------------------------
# Profile distance (cross-device transfer weighting)
# ---------------------------------------------------------------------------

# rate/geometry fields that shape a kernel's operating point; latencies are
# included because pass-heavy configs trade differently on launch-expensive
# devices
_DISTANCE_FIELDS = (
    "peak_vpu_flops", "peak_f32_flops", "hbm_bandwidth", "vmem_budget",
    "lane_count", "sublane_count", "mxu_dim", "kernel_launch_s",
    "pass_sync_s", "dma_half_bytes",
)


def profile_distance(a: HardwareProfile, b: HardwareProfile) -> float:
    """Mean |log2 ratio| over the rate/geometry fields; 0.0 iff identical.

    The transfer-seeding weight is ``exp(-distance)``: a device twice as
    fast in every dimension is "one octave away" and its journal evidence
    is discounted accordingly — close devices transfer almost fully,
    wildly different ones barely at all.
    """
    total = 0.0
    for field in _DISTANCE_FIELDS:
        va, vb = float(getattr(a, field)), float(getattr(b, field))
        total += abs(math.log2(max(va, 1e-30) / max(vb, 1e-30)))
    return total / len(_DISTANCE_FIELDS)


# ---------------------------------------------------------------------------
# Machine-model response curves
# ---------------------------------------------------------------------------
# Scalar and vectorized forms mirror each other element-for-element so
# batched and per-config evaluation agree to floating-point identity (the
# sweep engine depends on this).

# numpy knows "bfloat16" only once ml_dtypes (a JAX dependency) has been
# imported; the port names its width itself
_DTYPE_BYTES = {"bfloat16": 2}


def dtype_bytes(dtype) -> int:
    if isinstance(dtype, str) and dtype in _DTYPE_BYTES:
        return _DTYPE_BYTES[dtype]
    return np.dtype(dtype).itemsize


def effective_element_bytes(op: str, dtype) -> int:
    """Bytes one logical element of ``op`` moves through memory.

    Per-family multipliers over the raw dtype width: a tridiagonal element
    is an equation of 4 coefficients, an FFT element is an interleaved
    complex pair. The single source of truth for the analytical model, the
    cost objective, and the ML featurizer — which must agree, since the
    learned labels come from the cost model.
    """
    eb = dtype_bytes(dtype)
    if op == "tridiag":
        return 4 * eb
    if op in ("fft", "large_fft"):
        return 2 * eb
    return eb


def lane_utilization(trailing_dim: int,
                     spec: HardwareProfile = TPU_V5E) -> float:
    """Fraction of the lane dim that does useful work.

    The analogue of warp occupancy in the paper's guideline: a trailing
    dim of 96 on a 128-lane device wastes 25% of every vector issue; a
    trailing dim of 384 is three full tiles -> 1.0.
    """
    lanes = spec.lane_count
    if trailing_dim <= 0:
        return 0.0
    if trailing_dim >= lanes:
        full, rem = divmod(trailing_dim, lanes)
        used = full * lanes + rem
        tiles = full + (1 if rem else 0)
        return used / (tiles * lanes)
    return trailing_dim / lanes


def sublane_utilization(second_dim: int,
                        spec: HardwareProfile = TPU_V5E) -> float:
    sub = spec.sublane_count
    if second_dim <= 0:
        return 0.0
    if second_dim >= sub:
        full, rem = divmod(second_dim, sub)
        tiles = full + (1 if rem else 0)
        return second_dim / (tiles * sub)
    return second_dim / sub


def dma_efficiency(block_bytes: int,
                   spec: HardwareProfile = TPU_V5E) -> float:
    """Memory-bandwidth ramp: small transfers underutilize the system.

    Modeled as ``b / (b + b_half)`` with the half-saturation point a
    profile constant (64 KiB fits TPU DMA engines; GPUs coalesce earlier,
    CPUs stream-prefetch earlier still).
    """
    b_half = spec.dma_half_bytes
    return block_bytes / (block_bytes + b_half)


def ilp_factor(unroll: int, spec: HardwareProfile = TPU_V5E) -> float:
    """Issue-pipeline utilization vs in-kernel ILP (the paper's premise iii).

    One node-op per step leaves issue bubbles; saturates as unroll grows,
    with profile-specific base and slope.
    """
    return min(1.0, spec.ilp_base + spec.ilp_slope * math.log2(max(unroll, 1)))


# ---------------------------------------------------------------------------
# Vectorized counterparts (numpy arrays in, arrays out)
# ---------------------------------------------------------------------------

def lane_utilization_arr(trailing_dim, spec: HardwareProfile = TPU_V5E):
    t = np.asarray(trailing_dim, dtype=np.float64)
    lanes = float(spec.lane_count)
    full = np.floor(t / lanes)
    rem = t - full * lanes
    tiles = full + (rem > 0)
    multi = t / np.maximum(tiles * lanes, 1.0)
    out = np.where(t >= lanes, multi, t / lanes)
    return np.where(t <= 0, 0.0, out)


def sublane_utilization_arr(second_dim, spec: HardwareProfile = TPU_V5E):
    s = np.asarray(second_dim, dtype=np.float64)
    sub = float(spec.sublane_count)
    full = np.floor(s / sub)
    rem = s - full * sub
    tiles = full + (rem > 0)
    multi = s / np.maximum(tiles * sub, 1.0)
    out = np.where(s >= sub, multi, s / sub)
    return np.where(s <= 0, 0.0, out)


def dma_efficiency_arr(block_bytes, spec: HardwareProfile = TPU_V5E):
    b = np.trunc(np.asarray(block_bytes, dtype=np.float64))
    b_half = spec.dma_half_bytes
    return b / (b + b_half)


def ilp_factor_arr(unroll, spec: HardwareProfile = TPU_V5E):
    u = np.maximum(np.asarray(unroll, dtype=np.float64), 1.0)
    return np.minimum(1.0, spec.ilp_base + spec.ilp_slope * np.log2(u))
