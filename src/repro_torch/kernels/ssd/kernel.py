"""The SSD kernels' wrappers: the Mamba-2 chunked state-space dual.

  * ``ssd_intra`` replaces ``repro.kernels.ssd.kernel.ssd_intra_pallas``
    (phase A: per (row, chunk) the masked quadratic intra-chunk output,
    the chunk's decay and its (S, P) state injection);
  * ``ssd_state_apply`` replaces ``ssd_state_apply_pallas`` (phases B + C
    fused: the chunks in order with an (S, P) f32 carry);
  * ``ssd_apply_entry`` replaces ``ssd_apply_entry_pallas`` (phase C
    unfused: the scanned entry state applied to each chunk).

All three are ``csrc/ssd.cu``.  On a CUDA tensor each launches its
hand-written Hopper kernel; on a CPU tensor it runs its plain version
(``*_plain``), the same function in plain PyTorch, in the kernel's
arithmetic order: the within-chunk log-decay prefix one step after
another, every dot product one fused multiply-add after another in
ascending index order (``_fma``: exact, through float64).  Any other
device raises; nothing falls back.

Each has two kernels, chosen by the shapes alone
(:func:`ssd_intra_route`, :func:`ssd_state_apply_route`,
:func:`ssd_apply_entry_route`): the tiled kernels (route "tiled",
redesigned for Hopper: one launch for phase A, 8 x 4 register tiles over
a TMA ring; phases B + C with a producer warp's TMA loads a panel ahead
of eight consumer warps; the unfused phase C a block a (row, chunk,
128-row panel), TMA copies, 8 x 4 register tiles, two blocks an SM) for S
and P multiples of 8 with S <= 128 (and, for phase A, P <= 64 and chunk
<= 2048; for the unfused phase C, P <= 64), and the earlier kernels
(route "block") for every other shape.  A ``route`` keyword forces one;
each route counts its own launches.

Layout: rows of (BH, L, .) tensors, BH = batch x heads.  ``b`` and ``c``
are (G, L, S) with G dividing BH: row ``bh`` reads group ``bh // (BH //
G)``.  G = BH is the JAX kernels' pre-broadcast layout; G = batch shares
one (L, S) pair across a sequence's heads (Mamba-2's n_groups = 1) without
materializing the broadcast.  Inputs f32 or bf16 (one type for the row
tensors), f32 compute and carry, outputs in the input type; ``a_chunk``,
``state`` and ``entry`` are f32.

Bound on the card: ``ssd_intra`` by operations (O(Q) per output for the
masked scores); the apply kernels by their dots over S and their bytes
about equally (at mamba2-130m's widths, b and c read per sequence).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import telemetry
from repro_torch.kernels.scan.kernel import DTYPE_CODES, count_launch
from repro_torch.tuning.dispatch import kernel_path, no_backward

# the apply kernels keep a block's (S, 32) slice of the carry or entry in
# shared memory beside their staging tiles, within a block's 227 KB
MAX_STATE = 1024
# the tiled kernels (route "tiled"): S and P multiples of 8, S up to
# TILED_MAX_S; phase A also P up to TILED_MAX_P and chunks up to
# TILED_MAX_CHUNK (its shared memory holds the chunk's decay prefix); the
# unfused phase C also P up to TILED_MAX_P (a block holds all columns)
TILED_MAX_S = 128
TILED_MAX_P = 64
TILED_MAX_CHUNK = 2048
# the routes of the three kernels, each with its own count
ROUTES = ("tiled", "block")


def ssd_intra_route(P: int, S: int, chunk: int) -> str:
    """The kernel phase A runs on, by the shapes alone: "tiled" for S and
    P multiples of 8, S <= TILED_MAX_S, P <= TILED_MAX_P and chunk <=
    TILED_MAX_CHUNK; else "block"."""
    if S % 8 == 0 and P % 8 == 0 and S <= TILED_MAX_S \
            and P <= TILED_MAX_P and chunk <= TILED_MAX_CHUNK:
        return "tiled"
    return "block"


def ssd_state_apply_route(P: int, S: int, chunk: int) -> str:
    """The kernel the fused phases B + C run on: "tiled" for S and P
    multiples of 8 with S <= TILED_MAX_S (any chunk, any P slice count);
    else "block"."""
    if S % 8 == 0 and P % 8 == 0 and S <= TILED_MAX_S:
        return "tiled"
    return "block"


def ssd_apply_entry_route(P: int, S: int, chunk: int) -> str:
    """The kernel the unfused phase C runs on: "tiled" for S and P
    multiples of 8 with S <= TILED_MAX_S and P <= TILED_MAX_P (any
    chunk); else "block"."""
    if S % 8 == 0 and P % 8 == 0 and S <= TILED_MAX_S and P <= TILED_MAX_P:
        return "tiled"
    return "block"


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte boundary (the tiled kernels' TMA
    tensor maps need one): a view at an odd offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_route(route) -> None:
    if route is not None and route not in ROUTES:
        raise ValueError(f"unknown ssd route {route!r}")


def _fma(x: torch.Tensor, y: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """round_f32(x * y + acc), rounded once: the kernel's ``__fmaf_rn``.

    The product of two f32 values is exact in f64 and the f64 sum s of it
    and acc carries its exact error e (two-sum), so x * y + acc = s + e.
    Rounding s to f32 gives the right answer unless s falls exactly halfway
    between two f32 values, where e, not the tie rule, decides."""
    p = x.double() * y.double()
    c = acc.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.to(torch.float32)
    rd = r.double()
    away = torch.where(rd < s, torch.full_like(r, float("inf")),
                       torch.full_like(r, float("-inf")))
    other = torch.nextafter(r, away)
    tie = ((rd + other.double()) * 0.5 == s) & (rd != s) & (e != 0) \
        & torch.isfinite(s)
    return torch.where(tie & ((e > 0) == (other.double() > rd)), other, r)


def _log_cumsum(a: torch.Tensor) -> torch.Tensor:
    """la_t = la_{t-1} + log(max(a_t, 1e-30)) along the last axis, in f32,
    one step after another."""
    lg = torch.log(torch.clamp_min(a.to(torch.float32), 1e-30))
    la = torch.empty_like(lg)
    run = lg[..., 0]
    la[..., 0] = run
    for t in range(1, lg.shape[-1]):
        run = run + lg[..., t]
        la[..., t] = run
    return la


def _groups(t: torch.Tensor, rows: int) -> torch.Tensor:
    """The (rows, L, S) view of a (G, L, S) group tensor, in f32."""
    return t.to(torch.float32).repeat_interleave(rows // t.shape[0], dim=0)


def _check_rows(what: str, rows_t: Tuple[torch.Tensor, ...],
                groups_t: Tuple[torch.Tensor, ...], chunk: int) -> None:
    """Shapes, types and devices the kernels take: the row tensors
    (BH, L[, P]) of one type, the group tensors (G, L, S), G | BH, and a
    chunk length dividing L."""
    first = rows_t[0]
    if first.dim() != 3:
        raise ValueError(f"{what} takes (BH, L, P) rows, got "
                         f"{tuple(first.shape)}")
    BH, L, _ = first.shape
    for t in rows_t + groups_t:
        if t.dtype not in DTYPE_CODES or t.dtype != first.dtype:
            raise TypeError(f"{what} takes float32 or bfloat16 inputs of one "
                            f"type, got {t.dtype} beside {first.dtype}")
        if t.device != first.device:
            raise ValueError(f"{what}: inputs lie on different devices")
    for t in rows_t[1:]:
        if t.shape[:2] != (BH, L):
            raise ValueError(f"{what}: a row tensor of shape {tuple(t.shape)} "
                             f"beside ({BH}, {L}, ...)")
    g = groups_t[0]
    for t in groups_t:
        if t.dim() != 3 or t.shape != g.shape or t.shape[1] != L \
                or t.shape[0] < 1 or BH % t.shape[0]:
            raise ValueError(f"{what}: b / c must be (G, {L}, S) with G "
                             f"dividing {BH}, got {tuple(t.shape)}")
    if chunk < 1 or L % chunk:
        raise ValueError(f"{what}: chunk={chunk} must divide L={L}")


def _check_state(what: str, BH: int, nc: int, S: int, P: int,
                 **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        want = (BH, nc) if name == "a_chunk" else (BH, nc, S, P)
        if tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be {want} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")


# ---------------------------------------------------------------------------
# Kernel 8: phase A (intra-chunk)
# ---------------------------------------------------------------------------

def _check_intra(x, a, b, c, chunk):
    if a.dim() != 2:
        raise ValueError(f"ssd_intra takes a (BH, L) decay, got "
                         f"{tuple(a.shape)}")
    _check_rows("ssd_intra", (x, a.unsqueeze(-1)), (b, c), chunk)


def ssd_intra_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, *, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The intra kernel's function in plain PyTorch, in its order.

    Per (row, chunk), with la the chunk's log-decay prefix:
      score[t, s] = (fma chain over k of c[t, k] b[s, k]) * exp(la_t - la_s)
                    for s <= t, else 0;
      y[t, p]     = fma chain over s of score[t, s] x[s, p];
      a_chunk     = exp(la[-1]);
      state[k, p] = fma chain over s of (b[s, k] exp(la[-1] - la_s)) x[s, p].
    """
    _check_intra(x, a, b, c, chunk)
    BH, L, P = x.shape
    S = b.shape[-1]
    nc, Q = L // chunk, chunk
    xf = x.to(torch.float32).reshape(BH, nc, Q, P)
    bf = _groups(b, BH).reshape(BH, nc, Q, S)
    cf = _groups(c, BH).reshape(BH, nc, Q, S)
    la = _log_cumsum(a.reshape(BH, nc, Q))

    cb = torch.zeros(BH, nc, Q, Q, dtype=torch.float32, device=x.device)
    for k in range(S):
        cb = _fma(cf[..., :, None, k], bf[..., None, :, k], cb)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    # the mask inside the exp too, as the JAX kernel applies it: a masked
    # positive difference overflows to inf, whose zero-weighted gradient
    # is NaN; the selected scores are the same either way
    ratio = torch.exp(torch.where(mask, la[..., :, None] - la[..., None, :],
                                  -1e30))
    score = torch.where(mask, cb * ratio, torch.zeros_like(cb))
    y = torch.zeros(BH, nc, Q, P, dtype=torch.float32, device=x.device)
    for s in range(Q):
        y = _fma(score[..., :, s, None], xf[..., s, None, :], y)

    end = la[..., -1:]
    bw = bf * torch.exp(end - la)[..., None]
    state = torch.zeros(BH, nc, S, P, dtype=torch.float32, device=x.device)
    for s in range(Q):
        state = _fma(bw[..., s, :, None], xf[..., s, None, :], state)
    return (y.reshape(BH, L, P).to(x.dtype), torch.exp(end[..., 0]),
            state)


def _launch_intra(x, a, b, c, chunk, route=None):
    """Launch phase A: ``route`` "tiled" or "block"; by default the one
    :func:`ssd_intra_route` picks.  Returns (y, a_chunk, state); counts
    nothing."""
    from repro_torch.kernels.build import check, load_library

    _check_intra(x, a, b, c, chunk)
    _check_route(route)
    if not x.is_cuda:
        raise ValueError(f"the CUDA SSD kernels need CUDA tensors, got ones "
                         f"on {x.device}")
    x, a, b, c = (_aligned(t) for t in (x, a, b, c))
    BH, L, P = x.shape
    G, _, S = b.shape
    nc = L // chunk
    route = route or ssd_intra_route(P, S, chunk)
    y = torch.empty_like(x)
    a_chunk = torch.empty(BH, nc, dtype=torch.float32, device=x.device)
    state = torch.empty(BH, nc, S, P, dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = (x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                y.data_ptr(), a_chunk.data_ptr(), state.data_ptr())
        if route == "tiled":
            code = lib.repro_ssd_intra_tiled(
                *ptrs, DTYPE_CODES[x.dtype], BH, L, P, S, G, chunk, stream)
        else:
            la = torch.empty(BH, L, dtype=torch.float32, device=x.device)
            code = lib.repro_ssd_intra(
                *ptrs, la.data_ptr(), DTYPE_CODES[x.dtype], BH, L, P, S, G,
                chunk, stream)
    check(code, f"ssd_intra launch ({route})")
    return no_backward("ssd_intra", (y, a_chunk, state), x, a, b, c)


@telemetry.spanned("repro.launch.ssd_intra")
def ssd_intra(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, *, chunk: int = 128,
              route: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase A.  x: (BH, L, P); a: (BH, L); b, c: (G, L, S).

    Returns (y_intra (BH, L, P) in x's type, a_chunk (BH, nc) f32, state
    (BH, nc, S, P) f32), nc = L / chunk.  ``route`` forces a kernel (CUDA
    tensors only)."""
    if not kernel_path(x):
        if route is not None:
            raise ValueError(f"ssd_intra: route {route!r} needs CUDA "
                             f"tensors, got ones on {x.device}")
        return ssd_intra_plain(x, a, b, c, chunk=chunk)
    out = _launch_intra(x, a, b, c, chunk, route)
    count_launch(ssd_intra,
                 route or ssd_intra_route(x.shape[-1], b.shape[-1], chunk))
    return out


# ---------------------------------------------------------------------------
# Kernels 9 and 10: phase C, with (9) or without (10) the fused phase B
# ---------------------------------------------------------------------------

def _check_apply(what, y_intra, a, c, chunk, **state):
    if a.dim() != 2:
        raise ValueError(f"{what} takes a (BH, L) decay, got "
                         f"{tuple(a.shape)}")
    _check_rows(what, (y_intra, a.unsqueeze(-1)), (c,), chunk)
    BH, L, P = y_intra.shape
    S = c.shape[-1]
    _check_state(what, BH, L // chunk, S, P, **state)


def _apply_chunks(y_intra, a, c, chunk, entries):
    """out[t, p] = y[t, p] + (fma chain over k of c[t, k] e[k, p]) *
    exp(la_t), chunk by chunk; ``entries(j)`` gives chunk j's (BH, S, P)
    entry state (called in chunk order)."""
    BH, L, P = y_intra.shape
    S = c.shape[-1]
    nc, Q = L // chunk, chunk
    yf = y_intra.to(torch.float32).reshape(BH, nc, Q, P)
    cf = _groups(c, BH).reshape(BH, nc, Q, S)
    amul = torch.exp(_log_cumsum(a.reshape(BH, nc, Q)))
    out = torch.empty(BH, nc, Q, P, dtype=y_intra.dtype,
                      device=y_intra.device)
    for j in range(nc):
        ent = entries(j)
        acc = torch.zeros(BH, Q, P, dtype=torch.float32,
                          device=y_intra.device)
        for k in range(S):
            acc = _fma(cf[:, j, :, k, None], ent[:, None, k, :], acc)
        out[:, j] = (yf[:, j] + acc * amul[:, j, :, None]).to(y_intra.dtype)
    return out.reshape(BH, L, P)


def ssd_state_apply_plain(y_intra: torch.Tensor, a: torch.Tensor,
                          c: torch.Tensor, a_chunk: torch.Tensor,
                          state: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """The fused kernel's function in plain PyTorch: the chunks in order,
    chunk j applying the carry h_{j-1} (h_{-1} = 0), then
    h_j = fma(a_chunk_j, h_{j-1}, state_j)."""
    _check_apply("ssd_state_apply", y_intra, a, c, chunk, a_chunk=a_chunk,
                 state=state)
    carry = [torch.zeros_like(state[:, 0])]

    def entries(j):
        ent = carry[0]
        carry[0] = _fma(a_chunk[:, j, None, None], ent, state[:, j])
        return ent

    return _apply_chunks(y_intra, a, c, chunk, entries)


def ssd_apply_entry_plain(y_intra: torch.Tensor, a: torch.Tensor,
                          c: torch.Tensor, entry: torch.Tensor, *,
                          chunk: int) -> torch.Tensor:
    """The unfused apply kernel's function in plain PyTorch."""
    _check_apply("ssd_apply_entry", y_intra, a, c, chunk, state=entry)
    return _apply_chunks(y_intra, a, c, chunk, lambda j: entry[:, j])


def _launch_apply(what, y_intra, a, c, chunk, a_chunk, state, fused,
                  route=None):
    """Launch phase C: fused (kernel 9) or not (kernel 10), on ``route``;
    by default the one :func:`ssd_state_apply_route` or
    :func:`ssd_apply_entry_route` picks.  Counts nothing."""
    from repro_torch.kernels.build import check, load_library

    _check_route(route)
    if not y_intra.is_cuda:
        raise ValueError(f"the CUDA SSD kernels need CUDA tensors, got ones "
                         f"on {y_intra.device}")
    y_intra, a, c, state = (_aligned(t) for t in (y_intra, a, c, state))
    BH, L, P = y_intra.shape
    G, _, S = c.shape
    route = route or (ssd_state_apply_route if fused
                      else ssd_apply_entry_route)(P, S, chunk)
    if route == "block" and S > MAX_STATE:
        raise ValueError(f"{what}: state size S={S} above the kernel's "
                         f"{MAX_STATE}")
    out = torch.empty_like(y_intra)
    lib = load_library()
    with torch.cuda.device(y_intra.device):
        stream = torch.cuda.current_stream(y_intra.device).cuda_stream
        ptrs = (y_intra.data_ptr(), a.data_ptr(), c.data_ptr(),
                a_chunk.contiguous().data_ptr() if fused else None,
                state.data_ptr(), out.data_ptr())
        if route == "tiled" and fused:
            code = lib.repro_ssd_state_apply_tiled(
                *ptrs, DTYPE_CODES[y_intra.dtype], BH, L, P, S, G, chunk,
                stream)
        elif route == "tiled":
            code = lib.repro_ssd_apply_entry_tiled(
                *ptrs[:3], *ptrs[4:], DTYPE_CODES[y_intra.dtype], BH, L, P,
                S, G, chunk, stream)
        else:
            code = lib.repro_ssd_apply(
                *ptrs, DTYPE_CODES[y_intra.dtype], BH, L, P, S, G, chunk,
                int(fused), stream)
    check(code, f"{what} launch ({route})")
    return no_backward(what, out, y_intra, a, c, a_chunk, state)


@telemetry.spanned("repro.launch.ssd_state_apply")
def ssd_state_apply(y_intra: torch.Tensor, a: torch.Tensor, c: torch.Tensor,
                    a_chunk: torch.Tensor, state: torch.Tensor, *,
                    chunk: int = 128,
                    route: Optional[str] = None) -> torch.Tensor:
    """Fused phases B + C: y_intra (BH, L, P), a (BH, L), c (G, L, S),
    a_chunk (BH, nc), state (BH, nc, S, P) -> (BH, L, P).  Any chunk
    count, odd included: the carry walks the chunks in order.  ``route``
    forces a kernel (CUDA tensors only)."""
    if not kernel_path(y_intra):
        if route is not None:
            raise ValueError(f"ssd_state_apply: route {route!r} needs CUDA "
                             f"tensors, got ones on {y_intra.device}")
        return ssd_state_apply_plain(y_intra, a, c, a_chunk, state,
                                     chunk=chunk)
    _check_apply("ssd_state_apply", y_intra, a, c, chunk, a_chunk=a_chunk,
                 state=state)
    out = _launch_apply("ssd_state_apply", y_intra, a, c, chunk, a_chunk,
                        state, fused=True, route=route)
    count_launch(ssd_state_apply, route or ssd_state_apply_route(
        y_intra.shape[-1], c.shape[-1], chunk))
    return out


@telemetry.spanned("repro.launch.ssd_apply_entry")
def ssd_apply_entry(y_intra: torch.Tensor, a: torch.Tensor, c: torch.Tensor,
                    entry: torch.Tensor, *, chunk: int = 128,
                    route: Optional[str] = None) -> torch.Tensor:
    """Phase C unfused: adds each chunk's entry state (BH, nc, S, P).
    ``route`` forces a kernel (CUDA tensors only)."""
    if not kernel_path(y_intra):
        if route is not None:
            raise ValueError(f"ssd_apply_entry: route {route!r} needs CUDA "
                             f"tensors, got ones on {y_intra.device}")
        return ssd_apply_entry_plain(y_intra, a, c, entry, chunk=chunk)
    _check_apply("ssd_apply_entry", y_intra, a, c, chunk, state=entry)
    out = _launch_apply("ssd_apply_entry", y_intra, a, c, chunk, None, entry,
                        fused=False, route=route)
    count_launch(ssd_apply_entry, route or ssd_apply_entry_route(
        y_intra.shape[-1], c.shape[-1], chunk))
    return out


# launches of the CUDA kernels (plain-version calls are not counted): all,
# and by route
ssd_intra.launches = 0
ssd_intra.launches_tiled = 0
ssd_intra.launches_block = 0
ssd_state_apply.launches = 0
ssd_state_apply.launches_tiled = 0
ssd_state_apply.launches_block = 0
ssd_apply_entry.launches = 0
ssd_apply_entry.launches_tiled = 0
ssd_apply_entry.launches_block = 0
