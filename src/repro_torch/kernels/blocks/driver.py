"""Staged-execution driver: runs a StagePlan's launch list.

The PyTorch counterpart of ``repro.kernels.blocks.driver`` for the scan
and FFT families:

  * ``dispatch_fft`` / ``four_step_fft`` — the FFT's fused launch, or the
    Bailey four-step decomposition N = n1 * n2 (paper §IV-C), recursing
    through the plan's children: m = 2 or 3 passes (``fft_pass``,
    ``csrc/fft.cu`` ``repro_fft_pass``), each reading and writing device
    memory once, with the transposes and the twiddle multiply (plain XLA
    in the JAX package) folded into its loads and stores;
  * ``multipass_scan_add`` / ``multipass_linrec`` — the paper's §IV-C
    three-launch block scan (chunk scan, carry scan over the chunk sums or
    chunk transfer operators, entry broadcast), with memory roundtrips
    between launches instead of a serialized carry chain;
  * ``apply_add`` / ``apply_linrec`` — launch 3's kernel wrappers: the
    hand-written CUDA kernels (``csrc/scan.cu`` ``repro_apply_add``,
    ``csrc/linrec.cu`` ``repro_apply_linrec``) for a CUDA tensor, their
    plain versions for a CPU tensor;
  * ``linrec_rows`` — the tuned linear recurrence as a library call for
    composite kernels (the tridiagonal LF sweeps), with the JAX package's
    routing: the associative-scan reference where the radix spaces have
    no config (odd lengths).

Every launch is announced to ``record_launch`` with the plan's ``Launch``
record; ``capture_launches`` lets the conformance tests assert that what
runs is exactly what the plan promised — on the card and on the CPU.
"""
from __future__ import annotations

import contextlib
import threading
from typing import TYPE_CHECKING, Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import telemetry
from repro_torch.core.space import Workload
from repro_torch.kernels.blocks.plan import Launch, StagePlan
from repro_torch.tuning.dispatch import kernel_path, no_backward

if TYPE_CHECKING:
    from repro_torch.kernels.fft.kernel import PassLayout

_TRACE = threading.local()

# output dtype codes of the C interface
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


@contextlib.contextmanager
def capture_launches():
    """Collect every Launch executed in this thread under the context."""
    captured: List[Launch] = []
    prev = getattr(_TRACE, "sink", None)
    _TRACE.sink = captured
    try:
        yield captured
    finally:
        _TRACE.sink = prev


def record_launch(launch: Launch) -> None:
    sink = getattr(_TRACE, "sink", None)
    if sink is not None:
        sink.append(launch)


def launch(kernel_fn: Callable, record: Launch, *args, **kwargs):
    """Record ``record`` and invoke the kernel wrapper."""
    record_launch(record)
    return kernel_fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# Four-step FFT (plan-driven)
# ---------------------------------------------------------------------------

def _kernel_fft(x: torch.Tensor, plan: StagePlan,
                inverse: bool) -> torch.Tensor:
    from repro_torch.kernels.fft.kernel import fft_stockham
    record_launch(plan.launches[0])
    return fft_stockham(x, rows_per_program=plan.rows, stages=plan.stages,
                        inverse=inverse, unroll=int(plan.ilp))


def dispatch_fft(x: torch.Tensor, plan: StagePlan, *,
                 inverse: bool) -> torch.Tensor:
    """Run a (possibly multi-pass) FFT plan on complex (batch, n) rows."""
    if plan.kind == "fused":
        return _kernel_fft(x, plan, inverse)
    return four_step_fft(x, plan, inverse=inverse)


def four_step_passes(plan: StagePlan) -> List[Tuple[StagePlan, PassLayout]]:
    """The passes of a four-step plan in launch order: each fused child
    plan with where its pass reads and writes in the (batch, N) array.

    A level of length N' = n1 * n2 whose points lie s apart, its problems
    c < s at offset c (s = 1 at the top), splits point t = t2 n1 + t1.  Its
    column side is a level of length n2 with points n1 s apart and problems
    t1 s + c, whose last pass multiplies output K2 by the twiddle
    exp(-+2 pi i t1 K2 / N').  Its row pass reads points t1 at stride s,
    problems (K2, c), and writes output k1 at k1 n2 + K2, stride n2 s (the
    self-sorting transposed store), with the twiddle handed to the level."""
    from repro_torch.kernels.fft.kernel import PassLayout
    total = plan.n

    def strided(p: StagePlan, s: int, tw: Tuple[int, int]):
        div, tw_n = tw
        if p.kind == "fused":
            return [(p, PassLayout(total, p.n, lo=s, in_ps=s, in_hs=p.n * s,
                                   out_ps=s, out_hs=p.n * s, tw_n=tw_n,
                                   tw_div=div))]
        col, row = p.children
        n1, n2 = row.n, col.n
        return strided(col, n1 * s, (s, p.n)) + [
            (row, PassLayout(total, n1, lo=s, in_ps=s, in_hs=n1 * s,
                             out_ps=n2 * s, out_hs=s, tw_n=tw_n, tw_div=div,
                             tw_kmul=n2))]

    return strided(plan, 1, (1, 0))


def four_step_fft(x: torch.Tensor, plan: StagePlan, *,
                  inverse: bool) -> torch.Tensor:
    """Bailey four-step N = n1*n2: column FFTs with the twiddle at their
    store, then row FFTs with the transposed store — the §IV-C m-kernel
    path, one pass a launch, launch list == plan.launches."""
    from repro_torch.kernels.fft.kernel import fft_pass
    for record, (sub, layout) in zip(plan.launches, four_step_passes(plan)):
        record_launch(record)
        x = fft_pass(x, layout, stages=sub.stages, inverse=inverse,
                     unroll=int(sub.ilp))
    return x


# ---------------------------------------------------------------------------
# Multi-pass block scan (three launches)
# ---------------------------------------------------------------------------

def apply_add_plain(y: torch.Tensor, entry: torch.Tensor, *, rows: int,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``y + entry`` in f32, each row's entry broadcast along the row."""
    _check_apply(y, entry, rows, out_dtype)
    return (y + entry).to(out_dtype)


def _check_apply(y: torch.Tensor, entry: torch.Tensor, rows: int,
                 out_dtype: torch.dtype, what: str = "apply_add") -> None:
    if y.dim() != 2 or y.dtype != torch.float32:
        raise ValueError(f"{what} takes (rows, L) float32, got "
                         f"{tuple(y.shape)} {y.dtype}")
    if entry.shape != (y.shape[0], 1) or entry.dtype != torch.float32:
        raise ValueError(f"{what} takes a ({y.shape[0]}, 1) float32 "
                         f"entry, got {tuple(entry.shape)} {entry.dtype}")
    if rows < 1 or y.shape[0] % rows:
        raise ValueError(f"rows={rows} must divide {y.shape[0]} rows")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"{what} writes float32 or bfloat16, not "
                        f"{out_dtype}")


@telemetry.spanned("repro.launch.apply_add")
def apply_add(y: torch.Tensor, entry: torch.Tensor, *, rows: int,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Multipass launch 3: ``y + entry`` per row, written as ``out_dtype``."""
    if not kernel_path(y):
        return apply_add_plain(y, entry, rows=rows, out_dtype=out_dtype)
    from repro_torch.kernels.build import check, load_library

    _check_apply(y, entry, rows, out_dtype)
    y, entry = y.contiguous(), entry.contiguous()
    if entry.device != y.device:
        raise ValueError("apply_add: y and entry lie on different devices")
    lib = load_library()
    out = torch.empty(y.shape, dtype=out_dtype, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        code = lib.repro_apply_add(y.data_ptr(), entry.data_ptr(),
                                   out.data_ptr(), _OUT_CODES[out_dtype],
                                   y.shape[0], y.shape[1], rows, stream)
    check(code, "apply_add launch")
    apply_add.launches += 1
    return no_backward("apply_add", out, y, entry)


# launches of the CUDA kernel (plain-version calls are not counted)
apply_add.launches = 0


def multipass_scan_add(x: torch.Tensor, plan: StagePlan, *,
                       unroll: int = 1) -> torch.Tensor:
    """Prefix sum over (batch, n) as three launches: per-chunk scans,
    exclusive scan over chunk sums, entry broadcast."""
    from repro_torch.kernels.scan.kernel import scan_add
    l1, l2, l3 = plan.launches
    batch, n = x.shape
    p, length = plan.seq_tiles, plan.tile_n
    # inter-launch carries round-trip through device memory; sub-f32 dtypes
    # compute the whole pipeline in f32 and quantize ONCE at the output
    # (launch 3 writes the input dtype), matching the fused path's f32 carry
    xc = x.reshape(batch * p, length)
    if x.dtype != torch.float32:
        xc = xc.to(torch.float32)
    record_launch(l1)
    y_local = scan_add(xc, rows_per_program=l1.block_shape[0],
                       tile_n=length, stages=l1.stages, unroll=unroll)
    sums = y_local[:, -1].reshape(batch, p).contiguous()
    record_launch(l2)
    # the carry scan's tile is the CHUNK COUNT p, not tile_n: clamp the
    # workload-tuned unroll to the l2 launch record's own tile
    csums = scan_add(sums, rows_per_program=l2.block_shape[0], tile_n=p,
                     stages=l2.stages,
                     unroll=max(1, min(unroll, l2.block_shape[1])))
    entry = F.pad(csums[:, :-1], (1, 0)).reshape(batch * p, 1)
    record_launch(l3)
    y = apply_add(y_local, entry, rows=l3.block_shape[0], out_dtype=x.dtype)
    return y.reshape(batch, n)


def apply_linrec_plain(h: torch.Tensor, prod: torch.Tensor,
                       entry: torch.Tensor, *, rows: int,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """``h + prod * entry`` in f32, each row's entry broadcast along it."""
    _check_apply_linrec(h, prod, entry, rows, out_dtype)
    return (h + prod * entry).to(out_dtype)


def _check_apply_linrec(h, prod, entry, rows, out_dtype) -> None:
    _check_apply(h, entry, rows, out_dtype, what="apply_linrec")
    if prod.shape != h.shape or prod.dtype != torch.float32:
        raise ValueError(f"apply_linrec takes {tuple(h.shape)} float32 "
                         f"products, got {tuple(prod.shape)} {prod.dtype}")


@telemetry.spanned("repro.launch.apply_linrec")
def apply_linrec(h: torch.Tensor, prod: torch.Tensor, entry: torch.Tensor, *,
                 rows: int, out_dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
    """Multipass launch 3 of the linear recurrence: ``h + prod * entry``
    per row, written as ``out_dtype``."""
    if not kernel_path(h):
        return apply_linrec_plain(h, prod, entry, rows=rows,
                                  out_dtype=out_dtype)
    from repro_torch.kernels.build import check, load_library

    _check_apply_linrec(h, prod, entry, rows, out_dtype)
    if not (prod.device == entry.device == h.device):
        raise ValueError("apply_linrec: h, prod and entry lie on different "
                         "devices")
    h, prod, entry = h.contiguous(), prod.contiguous(), entry.contiguous()
    lib = load_library()
    out = torch.empty(h.shape, dtype=out_dtype, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        code = lib.repro_apply_linrec(h.data_ptr(), prod.data_ptr(),
                                      entry.data_ptr(), out.data_ptr(),
                                      _OUT_CODES[out_dtype], h.shape[0],
                                      h.shape[1], rows, stream)
    check(code, "apply_linrec launch")
    apply_linrec.launches += 1
    return no_backward("apply_linrec", out, h, prod, entry)


# launches of the CUDA kernel (plain-version calls are not counted)
apply_linrec.launches = 0


def multipass_linrec(a: torch.Tensor, b: torch.Tensor, plan: StagePlan, *,
                     gate: bool = False) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t as three launches: per-chunk linrec (+ the
    chunk transfer operators), carry linrec over the operators, apply.

    ``gate=True`` is the fused RG-LRU chain: ``b`` carries the raw input u
    and the chunk kernel applies the gate in-tile (the carry and apply
    launches operate on transfer operators, untouched by the gate).
    """
    from repro_torch.kernels.scan.kernel import scan_linrec, scan_linrec_prod
    l1, l2, l3 = plan.launches
    batch, n = a.shape
    p, length = plan.seq_tiles, plan.tile_n
    # f32 carries between launches; the output is quantized once, by
    # launch 3 (see multipass_scan_add)
    ac = a.reshape(batch * p, length).to(torch.float32)
    bc = b.reshape(batch * p, length).to(torch.float32)
    record_launch(l1)
    h_local, a_cum = scan_linrec_prod(ac, bc,
                                      rows_per_program=l1.block_shape[0],
                                      stages=l1.stages, gate=gate)
    # chunk transfer operator: state_out = A * state_in + B
    A = a_cum[:, -1].reshape(batch, p).contiguous()
    B = h_local[:, -1].reshape(batch, p).contiguous()
    record_launch(l2)
    exits = scan_linrec(A, B, rows_per_program=l2.block_shape[0], tile_n=p,
                        stages=l2.stages)
    entry = F.pad(exits[:, :-1], (1, 0)).reshape(batch * p, 1)
    record_launch(l3)
    h = apply_linrec(h_local, a_cum, entry, rows=l3.block_shape[0],
                     out_dtype=a.dtype)
    return h.reshape(batch, n)


# ---------------------------------------------------------------------------
# Linear recurrence as a library building block
# ---------------------------------------------------------------------------

def _linrec_space_valid(n: int) -> bool:
    # the radix spaces have no valid config for odd lengths; composite
    # kernels take the associative-scan reference there, as in repro
    return n >= 2 and n % 2 == 0


def linrec_rows(a: torch.Tensor, b: torch.Tensor, *,
                config: Optional[dict] = None) -> torch.Tensor:
    """Tuned linear recurrence over (rows, n) — the shared carry-chain
    block composite kernels (the tridiagonal LF sweeps) call.

    Resolves the (op="scan", variant="linrec") workload through the
    session, builds its StagePlan, and dispatches fused or multipass
    exactly like the public ``linear_recurrence`` entry point.
    """
    from repro_torch.kernels.blocks.plan import plan_for
    from repro_torch.kernels.scan.kernel import scan_linrec
    from repro_torch.kernels.scan.ref import scan_linrec_assoc_ref
    from repro_torch.tuning import default_session
    rows, n = a.shape
    if n <= 1:
        return b
    if not _linrec_space_valid(n):
        return scan_linrec_assoc_ref(a, b)
    wl = Workload(op="scan", n=n, batch=rows, variant="linrec")
    cfg = default_session().resolve(wl, config=config)
    plan = plan_for(wl, cfg)
    if plan.kind == "multipass":
        return multipass_linrec(a, b, plan)
    return launch(scan_linrec, plan.launches[0], a, b,
                  rows_per_program=plan.rows, tile_n=plan.tile_n,
                  stages=plan.stages)
