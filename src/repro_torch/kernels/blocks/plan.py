"""StagePlan — the staged-execution planner shared by kernels, the
analytical model and the tuners.

Given ``(Workload, Config)`` this module produces the exact staged
execution: the per-stage radix sequence (with the mixed-radix ragged
final stage), the launch grid / block shapes / scratch, the per-stage
fast-memory bytes, and the memory pass count (== the number of kernel
launches the driver performs).  The kernel drivers execute
``plan.launches`` verbatim and ``core.analytical.resources`` reads the
same fields, so model and kernel cannot disagree.

Composite ops (rglru's gate→linrec, SSD's intra→linrec→apply) are chains
of links (``plan_for_chain``): the ``fuse`` knob decides whether
neighbouring links share a launch or break at the historical boundaries.

The PyTorch port's own copy of ``repro.kernels.blocks.plan``, for the
scan, tridiag, FFT, SSD, RG-LRU, attention and matmul ops.  The arithmetic is the JAX package's,
verbatim, so both packages build identical plans; the field names keep
the JAX package's words (``grid``, ``vmem_bytes``) — on the GPU a plan's
grid row count is the CUDA grid and its ``vmem_bytes`` the shared-memory
staging footprint the same config occupies.  Pure Python: no torch
import.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.core.space import Workload, fit_block
from repro_torch.hw.profiles import (HardwareProfile, active_profile,
                                     dtype_bytes, effective_element_bytes,
                                     lane_utilization, sublane_utilization)

# Column tiles a fused carry chain tolerates before the multi-pass driver
# (three launches, parallel across chunks) wins over serializing the grid's
# sequential dimension — the paper's §IV-C small/large-N boundary.
DEFAULT_SEQ_LIMIT = 64

# Variants whose in-kernel state is an (a, b) pair: three resident planes
# (two inputs + output) instead of two.
_LINREC_VARIANTS = ("linrec",)


# ---------------------------------------------------------------------------
# Mixed-radix stage decomposition
# ---------------------------------------------------------------------------

def _smallest_prime_factor(n: int) -> int:
    if n % 2 == 0:
        return 2
    f = 3
    while f * f <= n:
        if n % f == 0:
            return f
        f += 2
    return n


def stage_radices(n: int, radix: int) -> Tuple[int, ...]:
    """Per-stage fan-in sequence for an n-point staged circuit.

    Generalizes the FFT kernel's ``rr = min(radix, n_cur)`` and the scan
    kernel's ``_ks_levels``: each stage takes the preferred fan-in when it
    divides what is left, else the largest divisor <= radix (the ragged
    mixed-radix final stage), else the smallest prime factor.  Invariant
    (pinned by tests): ``prod(stage_radices(n, r)) == n`` for every n >= 1,
    so a stage loop driven by this sequence can never mis-reshape — unlike
    the historical per-kernel loops, which crashed whenever an intermediate
    ``n_cur`` stopped dividing by the radix (e.g. radix 8 at n = 96).
    """
    n = int(n)
    radix = max(int(radix), 2)
    out = []
    n_cur = n
    while n_cur > 1:
        rr = min(radix, n_cur)
        if n_cur % rr:
            divisors = [d for d in range(rr, 1, -1) if n_cur % d == 0]
            rr = divisors[0] if divisors else _smallest_prime_factor(n_cur)
        out.append(rr)
        n_cur //= rr
    return tuple(out)


def stage_strides(stages: Tuple[int, ...]) -> Tuple[int, ...]:
    """Input stride of each stage: cumulative product of earlier fan-ins."""
    strides = []
    s = 1
    for r in stages:
        strides.append(s)
        s *= r
    return tuple(strides)


def is_ragged(stages: Tuple[int, ...], nominal: int, span: int) -> bool:
    """Mixed-radix tail check shared by every plan builder.

    ``stage_radices`` only ever reduces the fan-in toward the tail, so a
    sequence is ragged exactly when its last stage falls short of the
    nominal fan-in (clamped by the circuit span for tiny tiles).  The
    analytical radix_rank reads this flag — keep the definition in one
    place.
    """
    return bool(stages) and stages[-1] != min(nominal, span)


def resident_tile_cap(wl: Workload,
                      spec: Optional[HardwareProfile] = None) -> int:
    """Largest power-of-two tile whose double-buffered footprint fits VMEM
    with at least one problem row per program (paper §IV-C boundary).

    Under ``h100`` (``vmem_budget`` = 2^17) an f32 FFT row is resident up
    to 8192 points: two complex f32 shared-memory buffers of 64 KiB each.
    """
    spec = spec if spec is not None else active_profile()
    eb = dtype_bytes(wl.dtype) * (2 if wl.op in ("fft", "large_fft") else 1)
    tile = 256
    while tile * 2 * eb * 2 <= spec.vmem_budget and tile * 2 <= wl.n:
        tile *= 2
    return tile


def wm_chunk(radix: int, n: int) -> int:
    """The Wang&Mou chunk implied by the tuned radix (paper: the fan-in).

    Lives here — not at the dispatch site — so the tridiag normalizer can
    put the derived chunk INTO the resolved config: what the TuningDB
    records then uniquely determines the executed kernel.
    """
    return fit_block(min(max(radix * 16, 8), max(n // 2, 1)), n)


# ---------------------------------------------------------------------------
# Plan dataclasses
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch the driver will perform."""

    name: str                       # kernel family tag (display/debug)
    grid: Tuple[int, ...]           # program grid (its row axis is the
    #                                 CUDA grid; its column axis the
    #                                 kernel's in-block tile loop)
    block_shape: Tuple[int, int]    # main operand block (rows, cols)
    stages: Tuple[int, ...]         # in-kernel stage radices
    vmem_bytes: int                 # resident io + scratch per program

    @property
    def programs(self) -> int:
        out = 1
        for g in self.grid:
            out *= g
        return out


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """The exact staged execution of one (workload, config) pair."""

    op: str
    variant: str
    n: int
    batch: int
    dtype: str
    kind: str                       # "fused" | "multipass" | "three-phase"
    #                                 (ssd unfused) | "two-phase" (ssd
    #                                 fused) | "xla"; dispatchers branch
    #                                 on == "multipass" only
    tile_n: int                     # elements resident per program
    rows: int                       # problem rows per program
    radix: int                      # nominal (tuned) fan-in
    stages: Tuple[int, ...]         # per-stage radices of the resident tile
    seq_tiles: int                  # sequential carry tiles per program
    grid: Tuple[int, ...]           # main-launch grid
    launches: Tuple[Launch, ...]    # every kernel launch, driver order
    passes: int                     # HBM roundtrips == len(launches) +
    #                                 xla_passes when pallas-backed; 1 for
    #                                 fused XLA variants
    vmem_bytes: int                 # peak resident io+scratch per program
    stage_vmem_bytes: Tuple[int, ...]   # transient footprint per stage
    block_bytes: int                # DMA block (analytical rank input)
    element_bytes: int              # effective bytes per logical element
    trailing: int                   # trailing-dim extent a VPU issue sees
    lane_eff: float                 # trailing-lane efficiency
    sublane_eff: float
    occupancy: float
    ilp: float
    ragged: bool                    # mixed-radix tail (last stage < radix)
    steps_per_pass: float
    # HBM passes performed by XLA-level chain links that are not pallas
    # launches (e.g. rglru's unfused elementwise gate): they cost a full
    # read+write roundtrip but never appear in ``launches``
    xla_passes: int = 0
    children: Tuple["StagePlan", ...] = ()

    @property
    def stage_count(self) -> int:
        return len(self.stages)

    @property
    def grid_size(self) -> int:
        out = 1
        for g in self.grid:
            out *= g
        return out

    def check(self, spec: HardwareProfile) -> List[str]:
        """Structural invariant violations of this plan ([] when sound).

        The zero-execution contract ``repro_torch.analysis`` verifies for every
        valid config of every op x profile: a violation here means the
        planner would hand the drivers an execution that cannot launch
        (non-positive grid/block), mis-reshapes (stage product != tile),
        overflows the physical VMEM pool, or disagrees with its own pass
        accounting.  Checks live on the dataclass so plan builders and the
        analysis pass can never drift apart.
        """
        out: List[str] = []
        if self.tile_n < 1 or self.rows < 1:
            out.append(f"non-positive tile geometry: tile_n={self.tile_n} "
                       f"rows={self.rows}")
        if self.passes < 1:
            out.append(f"non-positive pass count: {self.passes}")
        if self.vmem_bytes <= 0 or self.steps_per_pass <= 0:
            out.append(f"non-positive accounting: vmem={self.vmem_bytes} "
                       f"steps_per_pass={self.steps_per_pass}")
        if self.stages:
            prod = 1
            for r in self.stages:
                prod *= r
            if prod != self.tile_n:
                out.append(f"stage radix product {prod} != tile_n "
                           f"{self.tile_n} (stages={self.stages})")
        if any(g < 1 for g in self.grid):
            out.append(f"non-positive grid dim: {self.grid}")
        if self.xla_passes < 0:
            out.append(f"negative xla_passes: {self.xla_passes}")
        if self.launches \
                and self.passes != len(self.launches) + self.xla_passes:
            out.append(f"passes={self.passes} disagrees with "
                       f"{len(self.launches)} launches "
                       f"+ {self.xla_passes} xla passes")
        for launch in self.launches:
            if any(g < 1 for g in launch.grid) \
                    or any(b < 1 for b in launch.block_shape):
                out.append(f"launch {launch.name}: non-positive shape "
                           f"grid={launch.grid} block={launch.block_shape}")
            if launch.vmem_bytes > spec.vmem_bytes:
                out.append(f"launch {launch.name}: vmem {launch.vmem_bytes} "
                           f"exceeds the physical pool {spec.vmem_bytes}")
            block = launch.block_shape[0] * launch.block_shape[1] \
                * self.element_bytes
            if launch.vmem_bytes < block:
                out.append(f"launch {launch.name}: scratch {launch.vmem_bytes}"
                           f" cannot hold its own BlockSpec block {block} "
                           f"({launch.block_shape} x {self.element_bytes}B)")
        if self.stage_vmem_bytes \
                and max(self.stage_vmem_bytes) > spec.vmem_bytes:
            out.append(f"stage vmem {max(self.stage_vmem_bytes)} exceeds "
                       f"the physical pool {spec.vmem_bytes}")
        return out

    def resources(self) -> Dict[str, float]:
        """Architectural accounting in the shape ``core.analytical`` scores.

        Every quantity is read off the plan — there is no independent
        re-derivation left in the analytical model or the featurizer.
        """
        return {
            "grid": float(self.grid_size),
            "vmem": float(self.vmem_bytes),
            "occupancy": min(self.occupancy, 1.0),
            "ilp": float(self.ilp),
            "radix": float(self.radix),
            "passes": float(self.passes),
            "block_bytes": float(self.block_bytes),
            "seq_tiles": float(self.seq_tiles),
            "stage_count": float(self.stage_count),
            "steps_per_pass": float(self.steps_per_pass),
            "ragged": 1.0 if self.ragged else 0.0,
            "lane_eff": float(self.lane_eff),
            "sublane_eff": float(self.sublane_eff),
        }


# ---------------------------------------------------------------------------
# Per-family builders
# ---------------------------------------------------------------------------

def _occ(tile_n: int, rows: int, spec: HardwareProfile) -> Tuple[int, float, float, float]:
    trailing = min(tile_n, spec.lane_count * spec.sublane_count)
    lane = lane_utilization(trailing, spec)
    sub = sublane_utilization(rows, spec)
    return trailing, lane, sub, lane * max(sub, 0.5)


def _is_linrec(wl: Workload) -> bool:
    return wl.op in ("rglru",) or wl.variant in _LINREC_VARIANTS


def _prefix_plan(wl: Workload, cfg: Mapping[str, int], spec: HardwareProfile,
                 seq_limit: int) -> StagePlan:
    eb = effective_element_bytes(wl.op, wl.dtype)
    ib = dtype_bytes(wl.dtype)
    batch = max(wl.batch, 1)
    tile_n = min(int(cfg.get("tile_n", wl.n)), wl.n)
    rows = int(cfg.get("rows_per_program", 1))
    radix = int(cfg.get("radix", 2))
    unroll = int(cfg.get("unroll", 1))
    stages = stage_radices(tile_n, radix)
    seq_tiles = max(wl.n // max(tile_n, 1), 1)
    planes = 3 if _is_linrec(wl) else 2          # (a, b) in + h out vs in + out
    carry = rows * 4                             # f32 cross-tile carry scratch
    io = planes * rows * tile_n * ib
    trailing, lane, sub, occ = _occ(tile_n, rows, spec)
    stage_vmem = tuple(io + carry + r * rows * tile_n * 4 for r in stages)
    ragged = is_ragged(stages, radix, tile_n)
    # rglru is a gate→linrec chain: fused, the elementwise gate runs inside
    # the scan kernel's first stage (same launches, one fewer HBM pass);
    # unfused, the torch gate materializes b = sqrt(1-a^2)*u through device
    # memory — one extra pass that never shows up as a kernel launch
    gate_xla = 1 if wl.op == "rglru" and not int(cfg.get("fuse", 0)) else 0

    if seq_tiles > seq_limit and tile_n < wl.n:
        # §IV-C m-kernel path: per-chunk scan, chunk-carry scan, apply.
        p, length = seq_tiles, tile_n
        rows1 = fit_block(rows, batch * p)
        rows2 = fit_block(rows, batch)
        c_stages = stage_radices(p, radix)
        # linrec's chunk kernel (scan_linrec_prod_pallas) keeps a fourth
        # plane resident: the per-chunk prefix-products output the carry
        # scan composes
        l1_planes = planes + (1 if planes == 3 else 0)
        l1 = Launch("chunk-scan", (batch * p // rows1, 1), (rows1, length),
                    stages, l1_planes * rows1 * length * ib + rows1 * 4)
        l2 = Launch("carry-scan", (batch // rows2, 1), (rows2, p),
                    c_stages, planes * rows2 * p * ib + rows2 * 4)
        l3 = Launch("apply-entry", (batch * p // rows1,), (rows1, length),
                    (), (planes + 1) * rows1 * length * ib)
        launches = (l1, l2, l3)
        return StagePlan(
            op=wl.op, variant=wl.variant, n=wl.n, batch=batch, dtype=wl.dtype,
            kind="multipass", tile_n=tile_n, rows=rows, radix=radix,
            stages=stages, seq_tiles=seq_tiles, grid=l1.grid,
            launches=launches, passes=len(launches) + gate_xla,
            xla_passes=gate_xla,
            vmem_bytes=max(l.vmem_bytes for l in launches),
            stage_vmem_bytes=stage_vmem,
            block_bytes=rows * tile_n * eb, element_bytes=eb,
            trailing=trailing, lane_eff=lane, sublane_eff=sub, occupancy=occ,
            ilp=unroll * (2 if cfg.get("in_register") else 1), ragged=ragged,
            steps_per_pass=float(len(stages)))

    grid = (batch // rows, seq_tiles)
    launch = Launch(wl.op, grid, (rows, tile_n), stages, io + carry)
    return StagePlan(
        op=wl.op, variant=wl.variant, n=wl.n, batch=batch, dtype=wl.dtype,
        kind="fused", tile_n=tile_n, rows=rows, radix=radix, stages=stages,
        seq_tiles=seq_tiles, grid=grid, launches=(launch,),
        passes=1 + gate_xla, xla_passes=gate_xla,
        vmem_bytes=launch.vmem_bytes, stage_vmem_bytes=stage_vmem,
        block_bytes=rows * tile_n * eb, element_bytes=eb, trailing=trailing,
        lane_eff=lane, sublane_eff=sub, occupancy=occ,
        ilp=unroll * (2 if cfg.get("in_register") else 1), ragged=ragged,
        steps_per_pass=float(len(stages)))


def _ssd_plan(wl: Workload, cfg: Mapping[str, int], spec: HardwareProfile,
              seq_limit: int) -> StagePlan:
    """SSD chain: intra-chunk kernel → linrec over chunk transitions →
    apply.  Unfused, phase B is a child prefix plan on the shared blocks
    and the chain runs as three launches with HBM roundtrips between;
    ``fuse=1`` collapses phase B + apply into one sequential-grid launch
    whose VMEM carry holds the running (S, P) entry state — the chunk
    states feed the recurrence without ever leaving the core (two-phase).

    Model-level plan: the phase count and chunk staging are exact, but the
    state dims (S, P) are runtime shapes a ``Workload`` does not carry, so
    the unfused phase-B child models the nc-length transition scan per
    (batch) row, not the S*P row fan-out ``driver.linrec_rows`` resolves
    at launch.  ``plan_for_chain(wl, cfg, dims=(S, P))`` rebuilds the
    exact embedded launches for the conformance suite."""
    base = _prefix_plan(wl, cfg, spec, seq_limit)
    chunk = base.tile_n
    nc = max(wl.n // max(chunk, 1), 1)
    if nc <= 1:
        # single chunk: intra kernel alone already yields the answer
        return dataclasses.replace(base, kind="fused", seq_tiles=1)
    intra = Launch("ssd-intra", (base.batch, nc), (1, chunk), (),
                   base.vmem_bytes)
    if int(cfg.get("fuse", 0)):
        state_apply = Launch("ssd-state-apply", (base.batch, nc),
                             (1, chunk), (), base.vmem_bytes)
        launches = (intra, state_apply)
        return dataclasses.replace(
            base, kind="two-phase", seq_tiles=nc, launches=launches,
            passes=len(launches), children=())
    child = _prefix_plan(
        Workload(op="scan", n=nc, batch=base.batch, dtype=wl.dtype,
                 variant="linrec"),
        {"tile_n": nc, "rows_per_program": 1,
         "radix": cfg.get("radix", 2)}, spec, seq_limit)
    apply_ = Launch("ssd-apply", (base.batch, nc), (1, chunk), (),
                    base.vmem_bytes)
    launches = (intra,) + child.launches + (apply_,)
    return dataclasses.replace(
        base, kind="three-phase", seq_tiles=nc, launches=launches,
        passes=len(launches), children=(child,))


def _tridiag_plan(wl: Workload, cfg: Mapping[str, int], spec: HardwareProfile
                  ) -> StagePlan:
    eb = effective_element_bytes(wl.op, wl.dtype)        # 4 coefficients
    ib = dtype_bytes(wl.dtype)
    batch = max(wl.batch, 1)
    rows = int(cfg.get("rows_per_program", 1))
    radix = int(cfg.get("radix", 2))
    n = wl.n
    trailing, lane, sub, occ = _occ(n, rows, spec)
    ilp = int(cfg.get("unroll", 1)) * (2 if cfg.get("in_register") else 1)

    if wl.variant == "pcr":
        steps = max(1, math.ceil(math.log2(max(n, 2))))
        stages = (2,) * steps
        io = 5 * rows * n * ib                 # a,b,c,d in + x out
        grid = (batch // rows,)
        launch = Launch("pcr", grid, (rows, n), stages, io)
        return StagePlan(
            op=wl.op, variant=wl.variant, n=n, batch=batch, dtype=wl.dtype,
            kind="fused", tile_n=n, rows=rows, radix=2, stages=stages,
            seq_tiles=1, grid=grid, launches=(launch,), passes=1,
            vmem_bytes=io,
            stage_vmem_bytes=tuple(io + 2 * rows * n * 4 for _ in stages),
            block_bytes=rows * n * eb, element_bytes=eb, trailing=trailing,
            lane_eff=lane, sublane_eff=sub, occupancy=occ, ilp=ilp,
            ragged=False, steps_per_pass=float(steps))

    # plain-tensor variants (cr / lf / wm / thomas): no kernel launches; the
    # logical circuit still has a stage structure the models consume
    # (for wm the nominal fan-in is the tuned radix; cr/lf/thomas halve).
    # kind "xla" keeps the JAX package's name for them.
    nominal = radix if wl.variant == "wm" else 2
    stages = stage_radices(n, nominal)
    vmem = rows * n * eb * 2                    # double-buffered row estimate
    ragged = is_ragged(stages, nominal, n)
    return StagePlan(
        op=wl.op, variant=wl.variant, n=n, batch=batch, dtype=wl.dtype,
        kind="xla", tile_n=n, rows=rows, radix=radix, stages=stages,
        seq_tiles=1, grid=(batch // max(rows, 1),), launches=(), passes=1,
        vmem_bytes=vmem, stage_vmem_bytes=tuple(vmem for _ in stages),
        block_bytes=rows * n * eb, element_bytes=eb, trailing=trailing,
        lane_eff=lane, sublane_eff=sub, occupancy=occ, ilp=ilp,
        ragged=ragged, steps_per_pass=float(max(len(stages), 1)))


def _fft_fused_plan(wl: Workload, cfg: Mapping[str, int], spec: HardwareProfile
                    ) -> StagePlan:
    eb = effective_element_bytes("fft", wl.dtype)        # interleaved re/im
    batch = max(wl.batch, 1)
    rows = fit_block(int(cfg.get("rows_per_program", 4)), batch)
    radix = int(cfg.get("radix", 2))
    n = wl.n
    stages = stage_radices(n, radix)
    io = 4 * rows * n * 4                      # re/im in + re/im out, f32
    trailing, lane, sub, occ = _occ(n, rows, spec)
    grid = (batch // rows,)
    launch = Launch("fft", grid, (rows, n), stages, io)
    return StagePlan(
        op="fft", variant=wl.variant, n=n, batch=batch, dtype=wl.dtype,
        kind="fused", tile_n=n, rows=rows, radix=radix, stages=stages,
        seq_tiles=1, grid=grid, launches=(launch,), passes=1, vmem_bytes=io,
        stage_vmem_bytes=tuple(io + 2 * r * rows * (n // max(r, 1)) * 4
                               for r in stages),
        block_bytes=rows * n * eb, element_bytes=eb, trailing=trailing,
        lane_eff=lane, sublane_eff=sub, occupancy=occ,
        ilp=int(cfg.get("unroll", 1)), ragged=is_ragged(stages, radix, n),
        steps_per_pass=float(len(stages)))


def _large_fft_plan(wl: Workload, cfg: Mapping[str, int], spec: HardwareProfile,
                    seq_limit: int, max_tile: Optional[int]) -> StagePlan:
    """Four-step decomposition N = n1*n2 (paper §IV-C), recursive.

    Column FFTs (length n2) and row FFTs (length n1) are child plans; the
    launch list is their concatenation, so ``passes`` counts exactly the
    kernel launches the driver performs (m = 2, or 3 when the column side
    recurses — the paper's N >= 2^19 case on its 48KB-tile device).
    """
    cap = max_tile if max_tile is not None else resident_tile_cap(wl, spec)
    batch = max(wl.batch, 1)
    n = wl.n
    n1 = fit_block(min(int(cfg.get("tile_n", cap)), cap), n)
    n2 = max(n // n1, 1)
    sub_cfg = dict(cfg)
    sub_cfg["tile_n"] = n1
    col_wl = Workload(op="fft" if n2 <= cap else "large_fft", n=n2,
                      batch=batch * n1, dtype=wl.dtype, variant=wl.variant)
    col = build_plan(col_wl, sub_cfg, profile=spec, seq_limit=seq_limit,
                     max_tile=cap)
    row = _fft_fused_plan(
        Workload(op="fft", n=n1, batch=batch * n2, dtype=wl.dtype,
                 variant=wl.variant), sub_cfg, spec)
    launches = col.launches + row.launches
    return StagePlan(
        op=wl.op, variant=wl.variant, n=n, batch=batch, dtype=wl.dtype,
        kind="multipass", tile_n=n1, rows=row.rows, radix=row.radix,
        stages=row.stages, seq_tiles=1, grid=row.grid, launches=launches,
        passes=len(launches), vmem_bytes=max(p.vmem_bytes for p in (col, row)),
        stage_vmem_bytes=row.stage_vmem_bytes, block_bytes=row.block_bytes,
        element_bytes=row.element_bytes, trailing=row.trailing,
        lane_eff=row.lane_eff, sublane_eff=row.sublane_eff,
        occupancy=row.occupancy, ilp=row.ilp, ragged=row.ragged,
        steps_per_pass=row.steps_per_pass, children=(col, row))


def _attention_plan(wl: Workload, cfg: Mapping[str, int], spec: HardwareProfile
                    ) -> StagePlan:
    batch = max(wl.batch, 1)
    eb = effective_element_bytes(wl.op, wl.dtype)
    bq = int(cfg.get("block_q", 128))
    bk = int(cfg.get("block_k", 128))
    grid = (batch * max(wl.n // bq, 1),)
    vmem = (bq + 2 * bk) * 128 * eb * 2
    steps = max(wl.n // bk, 1)
    return StagePlan(
        op=wl.op, variant=wl.variant, n=wl.n, batch=batch, dtype=wl.dtype,
        kind="fused", tile_n=bk, rows=bq, radix=2, stages=(),
        seq_tiles=steps, grid=grid, launches=(), passes=1, vmem_bytes=vmem,
        stage_vmem_bytes=(), block_bytes=vmem // 2, element_bytes=eb,
        trailing=bk, lane_eff=lane_utilization(bk, spec),
        sublane_eff=sublane_utilization(bq, spec),
        occupancy=lane_utilization(bk, spec),
        # the flash kernel has no unroll knob (its inner loop IS the
        # block_k walk), so the plan must not report phantom ILP from one
        ilp=1, ragged=False,
        steps_per_pass=float(steps))


def _matmul_plan(wl: Workload, cfg: Mapping[str, int], spec: HardwareProfile
                 ) -> StagePlan:
    batch = max(wl.batch, 1)
    eb = effective_element_bytes(wl.op, wl.dtype)
    bm = int(cfg.get("block_m", 128))
    bn = int(cfg.get("block_n", 128))
    bk = int(cfg.get("block_k", 128))
    grid = (max(batch // bm, 1), max(wl.n // bn, 1))
    vmem = (bm * bk + bk * bn) * eb * 2
    occ = min(bn / spec.mxu_dim, 1.0) * min(bm / spec.mxu_dim, 1.0)
    steps = max(wl.n // bk, 1)
    return StagePlan(
        op=wl.op, variant=wl.variant, n=wl.n, batch=batch, dtype=wl.dtype,
        kind="fused", tile_n=bn, rows=bm, radix=2, stages=(),
        seq_tiles=steps, grid=grid, launches=(), passes=1, vmem_bytes=vmem,
        stage_vmem_bytes=(), block_bytes=vmem // 2, element_bytes=eb,
        trailing=bn, lane_eff=lane_utilization(bn, spec),
        sublane_eff=sublane_utilization(bm, spec), occupancy=occ,
        ilp=bk // 128 or 1, ragged=False, steps_per_pass=float(steps))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def build_plan(wl: Workload, cfg: Mapping[str, int], *,
               profile: Optional[HardwareProfile] = None,
               seq_limit: int = DEFAULT_SEQ_LIMIT,
               max_tile: Optional[int] = None) -> StagePlan:
    """The staged execution of ``cfg`` on ``wl`` (uncached; see plan_for).

    ``max_tile`` bounds the resident FFT row of a four-step plan (default:
    ``resident_tile_cap`` under ``profile``)."""
    wl = wl.canonical()
    spec = profile if profile is not None else active_profile()
    if wl.op in ("scan", "ssd", "rglru"):
        if wl.op == "ssd":
            return _ssd_plan(wl, cfg, spec, seq_limit)
        return _prefix_plan(wl, cfg, spec, seq_limit)
    if wl.op == "tridiag":
        return _tridiag_plan(wl, cfg, spec)
    if wl.op == "fft":
        return _fft_fused_plan(wl, cfg, spec)
    if wl.op == "large_fft":
        return _large_fft_plan(wl, cfg, spec, seq_limit, max_tile)
    if wl.op == "attention":
        return _attention_plan(wl, cfg, spec)
    if wl.op == "matmul":
        return _matmul_plan(wl, cfg, spec)
    raise NotImplementedError(
        f"no plan builder for op={wl.op!r} in the PyTorch port yet: see "
        f"ROADMAP.md, 'Modules to port'")


# ---------------------------------------------------------------------------
# Chain planning: sequences of ops as one staged execution
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChainLink:
    """One op of a chain and what executing it costs.

    ``kind`` records where the link's work happens: ``"pallas"`` links own
    the launches in ``launches``; ``"xla"`` links run as plain tensor ops
    costing ``passes`` memory roundtrips with no kernel launch; ``"fused"``
    links are folded into a neighbouring link's launch (zero launches, zero
    passes of their own — the whole point of the ``fuse`` knob).  The kind
    names are the JAX package's, so both packages' chains compare equal: in
    the port a ``"pallas"`` link launches the hand-written CUDA kernels.
    """

    name: str                       # link tag ("gate", "linrec", "intra"...)
    kind: str                       # "pallas" | "xla" | "fused"
    launches: Tuple[Launch, ...]    # launches this link issues itself
    passes: int                     # HBM roundtrips this link costs
    plan: Optional[StagePlan] = None   # the link's own plan when it has one


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """A sequence of ops planned as one staged execution.

    ``plan`` is the flattened :class:`StagePlan` (what ``resources()``,
    the analytical model and the featurizer consume — built by
    ``plan_for`` with the same config); ``links`` is the per-op view the
    drivers dispatch from.  ``launches`` concatenates the links' launch
    lists in driver order — the conformance contract is that a
    ``capture_launches`` trace of the chain's execution equals it.
    """

    op: str
    links: Tuple[ChainLink, ...]
    plan: StagePlan

    @property
    def launches(self) -> Tuple[Launch, ...]:
        return tuple(l for link in self.links for l in link.launches)

    @property
    def passes(self) -> int:
        return sum(link.passes for link in self.links)

    def check(self, spec: HardwareProfile) -> List[str]:
        """Chain-level violations on top of the flattened plan's own."""
        out = self.plan.check(spec)
        if self.passes != self.plan.passes:
            out.append(f"chain passes {self.passes} disagree with the "
                       f"flattened plan's {self.plan.passes}")
        for link in self.links:
            if link.kind == "fused" and (link.launches or link.passes):
                out.append(f"link {link.name}: fused links own no launches "
                           f"or passes")
            if link.kind == "pallas" and link.passes != len(link.launches):
                out.append(f"link {link.name}: {link.passes} passes vs "
                           f"{len(link.launches)} launches")
        return out


def _rglru_chain(wl: Workload, cfg: Mapping[str, int], plan: StagePlan
                 ) -> ChainPlan:
    fused = bool(int(cfg.get("fuse", 0)))
    gate = ChainLink("gate", "fused" if fused else "xla", (), 0 if fused
                     else 1)
    linrec = ChainLink("linrec", "pallas", plan.launches,
                       len(plan.launches), plan=plan)
    return ChainPlan(op=wl.op, links=(gate, linrec), plan=plan)


def _ssd_chain(wl: Workload, cfg: Mapping[str, int], plan: StagePlan,
               spec: HardwareProfile, seq_limit: int,
               dims: Optional[Tuple[int, int]]) -> ChainPlan:
    if plan.kind == "fused":            # nc <= 1: intra kernel alone
        intra = ChainLink("intra", "pallas", plan.launches,
                          len(plan.launches), plan=plan)
        return ChainPlan(op=wl.op, links=(intra,), plan=plan)
    nc = plan.seq_tiles
    intra = ChainLink("intra", "pallas", plan.launches[:1], 1)
    if plan.kind == "two-phase":
        # phase B + apply share the sequential state-apply launch: the
        # linrec link's carry lives in that launch's VMEM scratch
        linrec = ChainLink("linrec", "fused", (), 0)
        apply_ = ChainLink("apply", "pallas", plan.launches[1:], 1)
        return ChainPlan(op=wl.op, links=(intra, linrec, apply_), plan=plan)
    # unfused: phase B is the embedded linrec block.  With the runtime
    # state dims the embedded plan is exact — the (S, P) fan-out
    # ``driver.linrec_rows`` resolves at launch; without them, fall back
    # to the flattened plan's model-level child.
    if dims is not None and _linrec_space_valid_model(nc):
        s, p = dims
        embed_batch = plan.batch * s * p
        embed_wl = Workload(op="scan", n=nc, batch=embed_batch,
                            dtype="float32", variant="linrec")
        # mirror the scan normalizer's defaults for the threaded config
        # ({"tile_n": nc, "radix": cfg radix}): rows fit from the default 8
        embed_cfg = {"tile_n": nc,
                     "rows_per_program": fit_block(8, embed_batch),
                     "radix": int(cfg.get("radix", 2))}
        child = build_plan(embed_wl, embed_cfg, profile=spec,
                           seq_limit=seq_limit)
        linrec = ChainLink("linrec", "pallas", child.launches,
                           len(child.launches), plan=child)
    elif dims is not None:
        # odd nc: the embedded block falls back to the XLA reference
        linrec = ChainLink("linrec", "xla", (), 1)
    else:
        child = plan.children[0] if plan.children else None
        launches = child.launches if child is not None else ()
        linrec = ChainLink("linrec", "pallas", launches, len(launches),
                           plan=child)
    apply_ = ChainLink("apply", "pallas", plan.launches[-1:], 1)
    chain_plan = plan
    if dims is not None:
        # re-flatten around the exact embedded launches so chain-level
        # pass accounting stays consistent (launch count can only match)
        launches = plan.launches[:1] + linrec.launches + plan.launches[-1:]
        chain_plan = dataclasses.replace(
            plan, launches=launches, passes=len(launches) + plan.xla_passes
            + (1 if linrec.kind == "xla" else 0),
            xla_passes=plan.xla_passes + (1 if linrec.kind == "xla" else 0),
            children=(linrec.plan,) if linrec.plan is not None else ())
    return ChainPlan(op=wl.op, links=(intra, linrec, apply_),
                     plan=chain_plan)


def _linrec_space_valid_model(n: int) -> bool:
    """Planner-side mirror of ``driver._linrec_space_valid`` (kept here so
    the pure-Python planner never imports the torch-backed driver)."""
    return n >= 2 and n % 2 == 0


def plan_for_chain(wl: Workload, cfg: Mapping[str, int], *,
                   dims: Optional[Tuple[int, int]] = None,
                   profile: Optional[HardwareProfile] = None,
                   seq_limit: int = DEFAULT_SEQ_LIMIT) -> ChainPlan:
    """Plan ``wl``'s op — a chain for composite ops — as one staged
    execution.

    For ``rglru`` the chain is gate→linrec; for ``ssd`` it is
    intra→linrec→apply, and passing the runtime state dims ``dims=(S, P)``
    makes the embedded phase-B launches exact (a ``capture_launches``
    trace of the executed chain equals ``chain.launches``).  Every other
    op is a single-link chain around its regular ``plan_for`` plan.
    """
    wl = wl.canonical()
    spec = profile if profile is not None else active_profile()
    plan = plan_for(wl, cfg, profile=spec, seq_limit=seq_limit)
    if wl.op == "rglru":
        return _rglru_chain(wl, cfg, plan)
    if wl.op == "ssd":
        return _ssd_chain(wl, cfg, plan, spec, seq_limit, dims)
    link = ChainLink(wl.op or "op", "pallas" if plan.launches else "xla",
                     plan.launches, plan.passes, plan=plan)
    return ChainPlan(op=wl.op, links=(link,), plan=plan)


@functools.lru_cache(maxsize=65536)
def _plan_cached(op: str, variant: str, n: int, batch: int, dtype: str,
                 cfg_items: Tuple[Tuple[str, int], ...], spec: HardwareProfile,
                 seq_limit: int, max_tile: Optional[int]) -> StagePlan:
    wl = Workload(op=op, n=n, batch=batch, dtype=dtype, variant=variant)
    return build_plan(wl, dict(cfg_items), profile=spec, seq_limit=seq_limit,
                      max_tile=max_tile)


def plan_for(wl: Workload, cfg: Mapping[str, int], *,
             profile: Optional[HardwareProfile] = None,
             seq_limit: int = DEFAULT_SEQ_LIMIT,
             max_tile: Optional[int] = None) -> StagePlan:
    """Memoized ``build_plan`` — the resolve/dispatch hot path and the
    sweeps hit the same plan thousands of times per space."""
    wl = wl.canonical()
    spec = profile if profile is not None else active_profile()
    return _plan_cached(wl.op, wl.variant, wl.n, wl.batch, wl.dtype,
                        tuple(sorted(cfg.items())), spec, seq_limit, max_tile)
