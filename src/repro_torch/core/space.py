"""Search spaces for kernel performance parameters (paper Table I).

The PyTorch port's own copy of ``repro.core.space``: the numpy code that
decides a space is the JAX package's, verbatim, so both packages enumerate
identical spaces for the same workload and profile.  One deliberate
difference: under a profile whose backend is "cuda" (``h100``) the
attention and matmul spaces admit a config by the shared memory the CUDA
kernels really use, not by the TPU footprint (see ``attention_space``).

A space is declared per (operation, input-parameters) pair:
  - Input Parameters (paper: `A`): problem size N, batch G, dtype — they
    characterize the workload and are NOT searched.
  - Performance Parameters (paper: `B`): the tunable knobs with power-of-two
    domains and validity constraints.

`Config` is an immutable mapping knob-name -> value. Spaces are small and
enumerable (as in the paper), so `enumerate_valid()` is exact and the
exhaustive search is feasible — that property is what makes the Phi metric
computable.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.hw.profiles import HardwareProfile, active_profile, dtype_bytes

Config = Dict[str, int]


def pow2_range(lo: int, hi: int) -> Tuple[int, ...]:
    """Inclusive powers of two from lo to hi."""
    assert lo > 0 and hi >= lo and lo & (lo - 1) == 0 and hi & (hi - 1) == 0
    out = []
    v = lo
    while v <= hi:
        out.append(v)
        v *= 2
    return tuple(out)


def floor_pow2(v: int) -> int:
    """Largest power of two <= v (v >= 1).

    Space builders bound their rows/tile domains with this so odd batch
    sizes (3 active serving slots, a ragged last shard) build a valid
    space instead of tripping ``pow2_range``'s power-of-two precondition.
    """
    v = int(v)
    assert v >= 1, v
    return 1 << (v.bit_length() - 1)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One Performance Parameter: a named discrete domain."""

    name: str
    domain: Tuple[int, ...]

    def index_of(self, value: int) -> int:
        return self.domain.index(value)


@dataclasses.dataclass(frozen=True)
class Workload:
    """Input Parameters `A`: what problem are we tuning for."""

    op: str                 # "scan" | "tridiag" | "fft" | "ssd" | "attention" | ...
    n: int                  # problem size (elements per problem / seq length)
    batch: int = 1          # simultaneous problems (paper: G batches)
    dtype: str = "float32"
    variant: str = ""       # e.g. "lf" | "ks" | "wm" | "pcr" | "cr" | "stockham"

    @property
    def key(self) -> str:
        return f"{self.op}:{self.variant or 'default'}:n{self.n}:b{self.batch}:{self.dtype}"

    def canonical(self) -> "Workload":
        """Canonical form: int dims, batch >= 1, dtype as a numpy name.

        Every config-resolution entry point funnels through this so that
        e.g. ``dtype=jnp.float32`` and ``dtype="float32"`` hit the same DB
        and cache keys.
        """
        dtype = self.dtype if isinstance(self.dtype, str) \
            else np.dtype(self.dtype).name
        n, batch = int(self.n), max(int(self.batch), 1)
        if dtype == self.dtype and n == self.n and batch == self.batch:
            return self
        return dataclasses.replace(self, n=n, batch=batch, dtype=dtype)


@dataclasses.dataclass
class SearchSpace:
    """Performance Parameters `B` + constraints for one workload."""

    workload: Workload
    params: Sequence[ParamSpec]
    constraints: Sequence[Callable[[Config, Workload], bool]] = ()
    # the hardware profile whose limits bound this space (validity
    # constraints capture it at build time; consumers read it for
    # budgets/geometry). Defaults to the process-wide active profile.
    spec: HardwareProfile = dataclasses.field(default_factory=active_profile)
    # memoized enumerate_valid(): every consumer (sweep, analytical rank,
    # strategies, featurizer) re-enumerates the same space; the constraint
    # closures are the expensive part, not the product itself
    _valid_cache: Optional[List[Config]] = dataclasses.field(
        default=None, repr=False, compare=False)

    def param(self, name: str) -> ParamSpec:
        for p in self.params:
            if p.name == name:
                return p
        raise KeyError(name)

    def is_valid(self, cfg: Config) -> bool:
        for p in self.params:
            if cfg.get(p.name) not in p.domain:
                return False
        return all(c(cfg, self.workload) for c in self.constraints)

    def enumerate_all(self) -> List[Config]:
        names = [p.name for p in self.params]
        out = []
        for values in itertools.product(*[p.domain for p in self.params]):
            out.append(dict(zip(names, values)))
        return out

    def enumerate_valid(self) -> List[Config]:
        if self._valid_cache is None:
            self._valid_cache = [c for c in self.enumerate_all()
                                 if self.is_valid(c)]
        # fresh list each call — callers sort/slice it (the config dicts
        # themselves are treated read-only everywhere)
        return list(self._valid_cache)

    # --- encoding for the GP surrogate: log2-normalized coordinates ---
    def encode(self, cfg: Config) -> List[float]:
        coords = []
        for p in self.params:
            dom = p.domain
            if len(dom) == 1:
                coords.append(0.0)
                continue
            lo, hi = math.log2(dom[0] + 1), math.log2(dom[-1] + 1)
            coords.append((math.log2(cfg[p.name] + 1) - lo) / (hi - lo))
        return coords

    def size(self) -> int:
        return len(self.enumerate_valid())


# ---------------------------------------------------------------------------
# Constraint builders shared by the kernel spaces
# ---------------------------------------------------------------------------

def vmem_fits(bytes_per_elem: int, buffers: int = 2,
              spec: Optional[HardwareProfile] = None):
    """Double-buffered fast-memory footprint must fit the profile's budget.

    footprint = rows_per_program * tile_n * bytes_per_elem * buffers
    The analogue of the paper's 48KB shared-memory-per-block constraint
    (which is literally what it becomes under the ``gpu_sm`` profile).
    """
    spec = spec if spec is not None else active_profile()

    def check(cfg: Config, wl: Workload) -> bool:
        tile_n = cfg.get("tile_n", wl.n)
        rows = cfg.get("rows_per_program", 1)
        return rows * tile_n * bytes_per_elem * buffers <= spec.vmem_budget

    return check


def tile_divides_n():
    def check(cfg: Config, wl: Workload) -> bool:
        tile_n = cfg.get("tile_n", wl.n)
        return tile_n <= wl.n and wl.n % tile_n == 0

    return check


def rows_divide_batch():
    def check(cfg: Config, wl: Workload) -> bool:
        rows = cfg.get("rows_per_program", 1)
        return rows <= max(wl.batch, 1) and max(wl.batch, 1) % rows == 0

    return check


def radix_compatible():
    """radix^k must reach tile_n, and unroll must cover the radix fan-in."""

    def check(cfg: Config, wl: Workload) -> bool:
        r = cfg.get("radix", 2)
        tile_n = cfg.get("tile_n", wl.n)
        if r > tile_n:
            return False
        # tile_n must be a power of the radix for a uniform circuit; mixed
        # radix (paper Fig 5's jagged WM line) is valid but penalized by the
        # objective, not the space.
        k = round(math.log(tile_n, r))
        return r ** k == tile_n or (r ** k) * 2 == tile_n or tile_n % r == 0

    return check


def in_register_rule(spec: Optional[HardwareProfile] = None):
    """`in_register` (shuffle analogue) only when one problem row fits a VREG
    tile region: n <= 8 lanes*sublanes worth of data we keep resident."""
    spec = spec if spec is not None else active_profile()

    def check(cfg: Config, wl: Workload) -> bool:
        if not cfg.get("in_register", 0):
            return True
        return wl.n <= spec.lane_count * spec.sublane_count

    return check


# ---------------------------------------------------------------------------
# Per-operation space declarations (paper Table I, adapted per DESIGN.md §2)
# ---------------------------------------------------------------------------

def scan_space(wl: Workload,
               spec: Optional[HardwareProfile] = None) -> SearchSpace:
    spec = spec if spec is not None else active_profile()
    eb = dtype_bytes(wl.dtype)
    max_rows = floor_pow2(min(512, max(wl.batch, 1)))
    # variant-aware knob pruning: the linrec kernel's fold order is fixed
    # by the (a, b) composition algebra, so sweeping `unroll` there only
    # duplicated configs (inflated exhaustive sweeps, label noise in the
    # ML dataset)
    unroll_dom = (1,) if wl.variant == "linrec" else (1, 2, 4, 8)
    params = [
        ParamSpec("tile_n", tuple(v for v in pow2_range(128, max(wl.n, 128)) if v <= wl.n) or (wl.n,)),
        ParamSpec("rows_per_program", pow2_range(1, max_rows)),
        ParamSpec("radix", (2, 4, 8)),          # tree fan-in per level
        ParamSpec("unroll", unroll_dom),        # node-ops per VPU step
        ParamSpec("in_register", (0, 1)),
    ]
    if wl.op in ("ssd", "rglru"):
        # chain-fusion boundary knob: 1 folds the op's neighbouring chain
        # links into a shared launch (rglru's gate into the scan kernel's
        # first stage, SSD's phase B + apply into one sequential launch),
        # 0 breaks at the historical kernel boundaries — each break is a
        # full HBM roundtrip the analytical model charges as a pass.
        # Plain scans have no chain, so the knob would be dead there.
        params.append(ParamSpec("fuse", (0, 1)))
    return SearchSpace(
        wl,
        params,
        constraints=(
            vmem_fits(eb, spec=spec),
            tile_divides_n(),
            rows_divide_batch(),
            radix_compatible(),
            in_register_rule(spec),
        ),
        spec=spec,
    )


def linrec_space(wl: Workload,
                 spec: Optional[HardwareProfile] = None) -> SearchSpace:
    """Scan space with the linrec-dead knobs pruned (rglru & friends)."""
    return scan_space(dataclasses.replace(wl, variant=wl.variant or "linrec"),
                      spec)


def tridiag_space(wl: Workload,
                  spec: Optional[HardwareProfile] = None) -> SearchSpace:
    spec = spec if spec is not None else active_profile()
    # each element is an equation: 4 coefficients (a,b,c,d)
    eb = 4 * dtype_bytes(wl.dtype)
    if wl.variant in ("cr", "lf", "thomas"):
        # these variants consume no tuned knobs at all (XLA-fused solves);
        # a singleton space keeps sweeps/datasets free of duplicate configs
        params = [
            ParamSpec("tile_n", (wl.n,)),
            ParamSpec("rows_per_program", (1,)),
            ParamSpec("radix", (2,)),
            ParamSpec("unroll", (1,)),
            ParamSpec("in_register", (0,)),
        ]
        return SearchSpace(wl, params, constraints=(vmem_fits(eb, spec=spec),),
                           spec=spec)
    max_rows = floor_pow2(min(256, max(wl.batch, 1)))
    radix_dom = (2, 4, 8) if wl.variant == "wm" else (2,)  # paper: only WM retunes r
    # wm runs as an XLA chunked prefix: rows/unroll/in_register shape
    # nothing it executes, so only the radix (-> chunk) is swept
    rows_dom = (1,) if wl.variant == "wm" else pow2_range(1, max_rows)
    unroll_dom = (1,) if wl.variant == "wm" else (1, 2, 4)
    in_reg_dom = (0,) if wl.variant == "wm" else (0, 1)
    params = [
        ParamSpec("tile_n", (wl.n,)),           # whole system stays resident
        ParamSpec("rows_per_program", rows_dom),
        ParamSpec("radix", radix_dom),
        ParamSpec("unroll", unroll_dom),
        ParamSpec("in_register", in_reg_dom),
    ]
    return SearchSpace(
        wl,
        params,
        constraints=(
            vmem_fits(eb, spec=spec),
            rows_divide_batch(),
            radix_compatible(),
            in_register_rule(spec),
        ),
        spec=spec,
    )


def fft_space(wl: Workload,
              spec: Optional[HardwareProfile] = None) -> SearchSpace:
    spec = spec if spec is not None else active_profile()
    eb = 2 * dtype_bytes(wl.dtype)  # complex: interleaved re/im
    max_rows = floor_pow2(min(256, max(wl.batch, 1)))
    params = [
        ParamSpec("tile_n", (wl.n,)),
        ParamSpec("rows_per_program", pow2_range(1, max_rows)),
        ParamSpec("radix", (2, 4, 8, 16)),      # Stockham radix (paper: {2,4,8,16})
        ParamSpec("unroll", (1, 2, 4)),
        ParamSpec("in_register", (0,)),          # paper: no shuffle for FFT
    ]
    return SearchSpace(
        wl,
        params,
        constraints=(vmem_fits(eb, spec=spec), rows_divide_batch(),
                     radix_compatible()),
        spec=spec,
    )


def large_fft_space(wl: Workload, max_tile: int = 4096,
                    spec: Optional[HardwareProfile] = None) -> SearchSpace:
    """Multi-pass FFT (paper §IV-C): N exceeds the on-chip tile -> m passes.

    The space covers (tile_n per pass, radix per pass, rows). tile_n here is
    the per-pass working-set S; m = ceil(log(N)/log(S)).
    """
    spec = spec if spec is not None else active_profile()
    eb = 2 * dtype_bytes(wl.dtype)
    max_rows = floor_pow2(min(64, max(wl.batch, 1)))
    tiles = tuple(v for v in pow2_range(256, max_tile))
    params = [
        ParamSpec("tile_n", tiles),
        ParamSpec("rows_per_program", pow2_range(1, max_rows)),
        ParamSpec("radix", (2, 4, 8, 16)),
        ParamSpec("unroll", (1, 2, 4)),
        ParamSpec("in_register", (0,)),
    ]

    def tile_le_n(cfg: Config, w: Workload) -> bool:
        return cfg["tile_n"] <= w.n

    return SearchSpace(
        wl,
        params,
        constraints=(vmem_fits(eb, spec=spec), rows_divide_batch(),
                     radix_compatible(), tile_le_n),
        spec=spec,
    )


# ---------------------------------------------------------------------------
# Attention and matmul: the JAX package's spaces, and what the CUDA kernels
# (csrc/attention.cu, csrc/matmul.cu) stage in shared memory
# ---------------------------------------------------------------------------
# The JAX fit constraints count a TPU VMEM footprint (bf16 tiles of head_dim
# 128, double-buffered, plus the f32 score block); under h100's 2^17-byte
# vmem_budget they admit no config at all.  Under a profile whose backend is
# "cuda" the constraint counts instead what the hand-written kernels really
# hold in a block's shared memory, against the 227 KB a block may use.

# shared memory one thread block may use on Hopper (227 KB)
CUDA_SMEM_LIMIT = 232448
# head dims the flash kernel is built for (the reduced configs' 16; qwen /
# whisper 64; minitron / llama-vision 128; gemma / recurrentgemma 256)
FLASH_HEAD_DIMS = (16, 64, 128, 256)
FLASH_QT_MAX = 64            # query rows a flash block works on at once
FLASH_SCORE_FLOATS = 16384   # f32 score tile: query rows x block_k


def flash_tiles(block_q: int, block_k: int, head_dim: int) -> Tuple[int, int]:
    """(query rows per sub-tile, keys per staged K/V sub-tile) of the flash
    kernel: the whole block_k span of scores for qt rows stays in shared
    memory, so qt shrinks as block_k grows."""
    qt = max(1, min(int(block_q), FLASH_QT_MAX,
                    FLASH_SCORE_FLOATS // max(int(block_k), 1)))
    kt = min(int(block_k), 64 if head_dim <= 128 else 32)
    return qt, kt


def flash_smem_bytes(block_q: int, block_k: int, head_dim: int) -> int:
    """Shared memory of one flash-attention block: the f32 Q sub-tile and
    K sub-tile (rows padded by one float), the V sub-tile, the score tile
    (rows padded by one) and the per-row m, l and rescale factor."""
    qt, kt = flash_tiles(block_q, block_k, head_dim)
    floats = (qt * (head_dim + 1) + kt * (head_dim + 1) + kt * head_dim
              + qt * (int(block_k) + 1) + 3 * qt)
    return 4 * floats


# the bf16 tensor-core flash kernel (csrc/attention.cu flash_wgmma_kernel):
# query tiles of 128 rows (two warpgroups of 64), the head dim held in
# 64-wide swizzle chunks (16 zero-filled to 64), kt keys a step through a
# ring of K / V stages; its footprint depends on the head dim alone
FLASH_WGMMA_TILE_Q = 128


def flash_wgmma_geometry(head_dim: int) -> Dict[str, int]:
    """The bf16 flash kernel's tile per head dim: the head dim it holds in
    shared memory, the keys a step (S = 64 x kt and O = 64 x dp f32 fit a
    warpgroup's registers), the ring's stages and the dynamic shared memory
    (Q tile, K and V stages, 1 KB of alignment, the mbarriers)."""
    dp = max(int(head_dim), 64)
    kt = 128 if dp == 64 else 64
    stages = 2 if dp == 256 else 3
    smem = (1024 + FLASH_WGMMA_TILE_Q * dp * 2 + 2 * stages * kt * dp * 2
            + (3 * stages + 2) * 8)
    return {"dp": dp, "kt": kt, "stages": stages, "smem": smem}


def flash_wgmma_smem_bytes(head_dim: int) -> int:
    """Shared memory of one bf16 flash block: fixed per head dim, whatever
    block_q and block_k."""
    return flash_wgmma_geometry(head_dim)["smem"]


def attention_space(wl: Workload,
                    spec: Optional[HardwareProfile] = None) -> SearchSpace:
    """Flash-attention block sizes (beyond-paper application of the method).

    wl.n = kv sequence length; wl.batch = #(batch*heads) rows.
    """
    spec = spec if spec is not None else active_profile()
    # no `unroll` knob: the flash kernel's inner loop is the block_k walk —
    # there is nothing to unroll independently of block_k, so sweeping it
    # only duplicated configs (the repro.analysis dead-knob detector flags
    # exactly this class; same pruning as linrec's unroll)
    params = [
        ParamSpec("block_q", (128, 256, 512, 1024)),
        ParamSpec("block_k", (128, 256, 512, 1024, 2048)),
        ParamSpec("rows_per_program", (1,)),
        ParamSpec("radix", (2,)),
        ParamSpec("in_register", (0,)),
    ]

    def blocks_fit(cfg: Config, w: Workload) -> bool:
        head_dim = 128
        eb = 2  # bf16
        # q-block + k-block + v-block + scores
        foot = (cfg["block_q"] + 2 * cfg["block_k"]) * head_dim * eb
        foot += cfg["block_q"] * cfg["block_k"] * 4
        return foot * 2 <= spec.vmem_budget and cfg["block_k"] <= w.n \
            and cfg["block_q"] <= w.n

    def blocks_fit_cuda(cfg: Config, w: Workload) -> bool:
        # both kernels (f32 on the CUDA cores, bf16 on the tensor cores) at
        # every head dim they take: workload keys carry no dtype, so a bf16
        # call may resolve an f32 entry and the other way round
        foot = max(max(flash_smem_bytes(cfg["block_q"], cfg["block_k"], hd),
                       flash_wgmma_smem_bytes(hd))
                   for hd in FLASH_HEAD_DIMS)
        return foot <= CUDA_SMEM_LIMIT and cfg["block_k"] <= w.n \
            and cfg["block_q"] <= w.n

    fit = blocks_fit_cuda if spec.backend == "cuda" else blocks_fit
    return SearchSpace(wl, params, constraints=(fit,), spec=spec)


# the bf16 tensor-core matmul (csrc/matmul.cu matmul_wgmma_kernel): 128 x
# 128 tiles, 64-deep stages of A (16 KB) and B (16 KB) in a ring of 4, 1 KB
# of alignment and the mbarriers
MATMUL_WGMMA_SMEM_BYTES = 1024 + 4 * (128 * 64 * 2 + 64 * 128 * 2) + 8 * 8


def matmul_space(wl: Workload,
                 spec: Optional[HardwareProfile] = None) -> SearchSpace:
    """Tiled matmul (M=batch, K=N=wl.n simplification for tuning demos)."""
    spec = spec if spec is not None else active_profile()
    params = [
        ParamSpec("block_m", (128, 256, 512)),
        ParamSpec("block_n", (128, 256, 512, 1024)),
        ParamSpec("block_k", (128, 256, 512, 1024, 2048)),
    ]

    def fits(cfg: Config, w: Workload) -> bool:
        eb = 2
        foot = (cfg["block_m"] * cfg["block_k"] + cfg["block_k"] * cfg["block_n"]) * eb
        foot += cfg["block_m"] * cfg["block_n"] * 4
        return foot * 2 <= spec.vmem_budget

    # the CUDA kernels stage a fixed slab whatever the blocks (f32 16.5 KB,
    # bf16 MATMUL_WGMMA_SMEM_BYTES): no fit
    constraints = () if spec.backend == "cuda" else (fits,)
    return SearchSpace(wl, params, constraints=constraints, spec=spec)


_SPACE_BUILDERS: Dict[str, Callable[..., SearchSpace]] = {
    "scan": scan_space,
    "tridiag": tridiag_space,
    "fft": fft_space,
    # registered without max_tile: its builder keeps the 4096 default
    "large_fft": large_fft_space,
    "ssd": scan_space,        # the SSD inter-chunk scan shares the scan space
    "rglru": linrec_space,    # rglru IS a linrec: dead unroll knob pruned
    "attention": attention_space,
    "matmul": matmul_space,
}


def build_space(wl: Workload,
                profile: Optional[HardwareProfile] = None) -> SearchSpace:
    """Search space for ``wl`` bounded by ``profile`` (default: the active
    profile)."""
    try:
        builder = _SPACE_BUILDERS[wl.op]
    except KeyError:
        raise NotImplementedError(
            f"no search space for op={wl.op!r} in the PyTorch port yet: "
            f"see ROADMAP.md, 'Modules to port'") from None
    return builder(wl, spec=profile)


def register_space(op: str, builder: Callable[..., SearchSpace]) -> None:
    _SPACE_BUILDERS[op] = builder


# ---------------------------------------------------------------------------
# Shared config normalization (launch-geometry fitting)
# ---------------------------------------------------------------------------
# Tuned configs are stored for the workload they were searched on; at launch
# time the knobs must still divide the actual array dims (a stored tile of
# 512 against n=384, say). Every kernel family used to carry its own copy of
# this halving descent; it lives here now and per-op normalizers in
# kernels/*/ops.py compose it.

def fit_block(value: int, dim: int) -> int:
    """Largest v <= min(value, dim) reachable by halving with dim % v == 0."""
    v = int(max(min(value, dim), 1))
    while dim % v:
        v //= 2
    return max(v, 1)


def normalize_config(cfg: Mapping[str, int], wl: Workload,
                     dims: Optional[Mapping[str, int]] = None) -> Config:
    """Generic normalizer: snap row/tile knobs to the workload dims.

    Per-op normalizers registered via ``repro_torch.tuning.tuned_kernel`` take
    precedence; this fallback handles any op without one.
    """
    out = dict(cfg)
    if "rows_per_program" in out:
        out["rows_per_program"] = fit_block(out["rows_per_program"],
                                            max(wl.batch, 1))
    if "tile_n" in out:
        out["tile_n"] = fit_block(out["tile_n"], wl.n)
    return out
