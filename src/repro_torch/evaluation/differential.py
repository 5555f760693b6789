"""The differential table: every tuned entry point at odd and prime shapes.

The port's copy of the JAX package's kernel-vs-reference case table
(``tests/conftest.py`` ``_KERNEL_TABLE``): one row per tuned entry point
(and per forced radix, per chain fusion), each with its dtypes and its
(batch, n) shapes — prime batches, non-power-of-two lengths, a prime inner
dimension — run through the *public* entry point, so the whole resolution
pipeline (analytical prior -> the op's normalizer -> launch geometry) has
to survive shapes the tuner never saw.

Inputs are numpy arrays drawn from generators seeded by the crc32 of a tag
(``_rng``, as the JAX table's), float32 (complex64 for the FFT) and cast to
the case's type by the caller; the rows whose JAX runner draws with numpy
use its tags and draws, so both packages see the same numbers.  A row's
``call`` takes the tensors and the configs to replay (one per resolve of
the row's op, in order; ``None`` resolves them as the entry point does), so
a card call can be held against the same entry point on CPU tensors given
the configs the card's call resolved (:func:`run_case`).  The FFT rows
replay ``fft`` and ``large_fft`` resolves: above the resident tile ``fft``
resolves its four-step plan as ``large_fft``.

``matmul_prime_n`` is the one row the JAX table lacks: a bf16 product at a
prime N (33 x 65 @ 65 x 97), the shape class the tensor-core kernel does
not take (``kernels/matmul/kernel.py`` ``matmul_route``).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tuning import default_session, registered_kernels
from repro_torch.tuning.registry import _OP_MODULES, _ensure_registered

# the tests' shared tolerances (tests/conftest.py DTYPE_TOL): rtol, and an
# atol relative to the reference's magnitude (prefix sums accumulate)
DTYPE_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2),
             "complex64": (1e-4, 1e-4)}

ODD_BATCH_SHAPES: Tuple[Tuple[int, int], ...] = (
    (3, 256),    # prime batch, pow2 length
    (7, 96),     # prime batch, non-pow2 length (96 = 2^5 * 3)
    (5, 128),
)

MATMUL_K = 65    # the matmul rows' prime inner dimension

# an entry point the table covers under other names: tridiag's one entry
# point (solve) per variant; fft's ifft is the same kernel inverted
ALIASES = {"solve": {"solve_pcr", "solve_cr", "solve_lf", "solve_wm"},
           "ifft": {"fft"}}

Inputs = Dict[str, np.ndarray]
Configs = Optional[Sequence[dict]]


@dataclasses.dataclass(frozen=True)
class Row:
    """One entry point's differential row."""

    ops: Tuple[str, ...]             # the ops whose resolves the row replays
    dtypes: Tuple[str, ...]
    shapes: Tuple[Tuple[int, int], ...]
    make: Callable[[int, int], Inputs]     # (batch, n) -> numpy inputs
    call: Callable[[Dict[str, torch.Tensor], Configs], torch.Tensor]
    scale: float = 1.0               # loosens DTYPE_TOL, as the JAX row's


def _rng(tag: str) -> np.random.Generator:
    # crc32, not hash(): string hashing is salted per process
    return np.random.default_rng(zlib.crc32(tag.encode()))


def _pick(configs: Configs, i: int, default: Optional[dict] = None):
    return dict(configs[i]) if configs else default


def _f32(**arrays) -> Inputs:
    return {k: np.asarray(v, np.float32) for k, v in arrays.items()}


# -- inputs -----------------------------------------------------------------

def _scan_inputs(tag: str) -> Callable[[int, int], Inputs]:
    def make(batch, n):
        return _f32(x=_rng(tag.format(batch=batch, n=n)).normal(
            size=(batch, n)))
    return make


def _linrec_inputs(tag: str) -> Callable[[int, int], Inputs]:
    def make(batch, n):
        rng = _rng(tag.format(batch=batch, n=n))
        a = rng.uniform(0.8, 0.99, size=(batch, n))
        return _f32(a=a, b=rng.normal(size=(batch, n)))
    return make


def _fft_inputs(tag: str) -> Callable[[int, int], Inputs]:
    def make(batch, n):
        rng = _rng(tag.format(batch=batch, n=n))
        re = rng.normal(size=(batch, n))
        return {"x": (re + 1j * rng.normal(size=(batch, n))
                      ).astype(np.complex64)}
    return make


def _tridiag_inputs(variant: str) -> Callable[[int, int], Inputs]:
    """The JAX package's ``random_system`` distribution, drawn with numpy:
    a, c ~ U[0.1, 1) with a[:, 0] = c[:, -1] = 0, b = |a| + |c| + U[1, 2),
    d ~ N(0, 1)."""
    def make(batch, n):
        rng = _rng(f"tridiag-{variant}{batch}x{n}")
        a = rng.uniform(0.1, 1.0, size=(batch, n))
        c = rng.uniform(0.1, 1.0, size=(batch, n))
        a[:, 0] = 0.0
        c[:, -1] = 0.0
        b = np.abs(a) + np.abs(c) + rng.uniform(1.0, 2.0, size=(batch, n))
        return _f32(a=a, b=b, c=c, d=rng.normal(size=(batch, n)))
    return make


def _matmul_inputs(tag: str) -> Callable[[int, int], Inputs]:
    def make(batch, n):
        rng = _rng(tag.format(batch=batch, n=n))
        a = rng.normal(size=(batch * 11, MATMUL_K))
        return _f32(a=a, b=rng.normal(size=(MATMUL_K, n)))
    return make


def _ssd_inputs(tag: str) -> Callable[[int, int], Inputs]:
    def make(batch, n):
        rng = _rng(tag.format(batch=batch, n=n))
        x = rng.normal(size=(batch, n, 2, 16))
        a = rng.uniform(0.85, 0.999, size=(batch, n, 2))
        b = rng.normal(size=(batch, n, 8)) * 0.3
        return _f32(x=x, a=a, b=b, c=rng.normal(size=(batch, n, 8)) * 0.3)
    return make


def _rglru_inputs(tag: str) -> Callable[[int, int], Inputs]:
    def make(batch, n):
        rng = _rng(tag.format(batch=batch, n=n))
        a = rng.uniform(0.8, 0.99, size=(batch, n, 16))
        return _f32(a=a, u=rng.normal(size=(batch, n, 16)))
    return make


def _attention_inputs(batch, n) -> Inputs:
    rng = _rng(f"attention{batch}x{n}")
    return _f32(**{name: rng.normal(size=(batch, n, 64))
                   for name in ("q", "k", "v")})


# -- calls ------------------------------------------------------------------

def _prefix_sum(radix: Optional[int] = None):
    def call(t, configs):
        from repro_torch.kernels.scan.ops import prefix_sum
        x = t["x"]
        fixed = {"radix": radix, "tile_n": x.shape[1]} if radix else None
        return prefix_sum(x, config=_pick(configs, 0, fixed))
    return call


def _linear_recurrence(radix: Optional[int] = None):
    def call(t, configs):
        from repro_torch.kernels.scan.ops import linear_recurrence
        a = t["a"]
        fixed = {"radix": radix, "tile_n": a.shape[1]} if radix else None
        return linear_recurrence(a, t["b"], config=_pick(configs, 0, fixed))
    return call


def _solve(variant: str):
    def call(t, configs):
        from repro_torch.kernels.tridiag.ops import solve
        return solve(t["a"], t["b"], t["c"], t["d"], variant=variant,
                     config=_pick(configs, 0))
    return call


def _fft(radix: Optional[int] = None):
    def call(t, configs):
        from repro_torch.kernels.fft.ops import fft
        fixed = {"radix": radix} if radix else None
        return fft(t["x"], config=_pick(configs, 0, fixed))
    return call


def _matmul(t, configs):
    from repro_torch.kernels.matmul.ops import matmul
    return matmul(t["a"], t["b"], config=_pick(configs, 0))


def _ssd(t, configs):
    from repro_torch.kernels.ssd.ops import ssd
    return ssd(t["x"], t["a"], t["b"], t["c"], config=_pick(configs, 0))


def _ssd_fused(t, configs):
    """fuse = 1 (phases B + C in one launch) and fuse = 0, stacked: fused
    must equal unfused and the oracle."""
    from repro_torch.kernels.ssd.ops import ssd
    cfg = {"tile_n": min(128, t["x"].shape[1]), "radix": 2}
    args = (t["x"], t["a"], t["b"], t["c"])
    return torch.stack([
        ssd(*args, config=_pick(configs, 0, dict(cfg, fuse=1))),
        ssd(*args, config=_pick(configs, 1, dict(cfg, fuse=0)))])


def _rglru(t, configs):
    from repro_torch.kernels.rglru.ops import rglru
    return rglru(t["a"], t["u"], config=_pick(configs, 0))


def _rglru_fused(t, configs):
    """fuse = 1 (the gate in the scan kernel's first stage) and fuse = 0,
    stacked."""
    from repro_torch.kernels.rglru.ops import rglru
    cfg = {"tile_n": min(128, t["a"].shape[1]), "rows_per_program": 8,
           "radix": 2}
    return torch.stack([
        rglru(t["a"], t["u"], config=_pick(configs, 0, dict(cfg, fuse=1))),
        rglru(t["a"], t["u"], config=_pick(configs, 1, dict(cfg, fuse=0)))])


def _attention(t, configs):
    from repro_torch.kernels.attention.ops import attention
    return attention(t["q"], t["k"], t["v"], causal=True,
                     config=_pick(configs, 0))


# entry -> row.  Shapes default to the shared odd/prime table; ops with
# extra constraints narrow them here, visibly (the JAX table's choices).
TABLE: Dict[str, Row] = {
    "prefix_sum": Row(("scan",), ("float32", "bfloat16"), ODD_BATCH_SHAPES,
                      _scan_inputs("scan{batch}x{n}"), _prefix_sum()),
    "linear_recurrence": Row(("scan",), ("float32",), ODD_BATCH_SHAPES,
                             _linrec_inputs("linrec{batch}x{n}"),
                             _linear_recurrence()),
    # diagonally dominant solves are well conditioned, but the parallel
    # eliminations reassociate heavily against Thomas: shared f32 tol x 50
    "solve_pcr": Row(("tridiag",), ("float32",), ODD_BATCH_SHAPES,
                     _tridiag_inputs("pcr"), _solve("pcr"), 50.0),
    "solve_cr": Row(("tridiag",), ("float32",), ((3, 96), (5, 100)),
                    _tridiag_inputs("cr"), _solve("cr"), 50.0),
    "solve_lf": Row(("tridiag",), ("float32",), ((7, 96),),
                    _tridiag_inputs("lf"), _solve("lf"), 50.0),
    "solve_wm": Row(("tridiag",), ("float32",), ((5, 96),),
                    _tridiag_inputs("wm"), _solve("wm"), 50.0),
    "fft": Row(("fft", "large_fft"), ("complex64",), ODD_BATCH_SHAPES,
               _fft_inputs("fft{batch}x{n}"), _fft()),
    # mixed-radix stage plans: radix does not divide n (96 = 2^5*3,
    # 768 = 2^8*3), odd/prime batches — the ragged final stage
    "prefix_sum_radix3": Row(("scan",), ("float32",), ((7, 96), (3, 768)),
                             _scan_inputs("scanr3x{batch}x{n}"),
                             _prefix_sum(3)),
    "prefix_sum_radix8": Row(("scan",), ("float32",), ((7, 96), (3, 768)),
                             _scan_inputs("scanr8x{batch}x{n}"),
                             _prefix_sum(8)),
    "linear_recurrence_radix8": Row(("scan",), ("float32",), ((5, 96),),
                                    _linrec_inputs("linrecr8x{batch}x{n}"),
                                    _linear_recurrence(8)),
    "fft_radix3": Row(("fft", "large_fft"), ("complex64",), ((5, 96),),
                      _fft_inputs("fftr3x{batch}x{n}"), _fft(3)),
    "fft_radix8": Row(("fft", "large_fft"), ("complex64",), ((7, 96), (3, 768)),
                      _fft_inputs("fftr8x{batch}x{n}"), _fft(8)),
    # (batch*11) x 65 x n — every dim odd or prime-factored
    "matmul": Row(("matmul",), ("float32", "bfloat16"), ((3, 96), (5, 128)),
                  _matmul_inputs("matmul{batch}x{n}"), _matmul, 10.0),
    # and N prime: 33 x 65 @ 65 x 97
    "matmul_prime_n": Row(("matmul",), ("bfloat16",), ((3, 97),),
                          _matmul_inputs("matmulp{batch}x{n}"), _matmul,
                          10.0),
    "ssd": Row(("ssd",), ("float32",), ((3, 96),), _ssd_inputs("ssd{batch}x{n}"),
               _ssd, 10.0),
    # chain fusion: nc = 2 and nc = 3 chunks
    "ssd_fused": Row(("ssd",), ("float32",), ((3, 256), (5, 384)),
                     _ssd_inputs("ssdf{batch}x{n}"), _ssd_fused, 10.0),
    "rglru": Row(("rglru",), ("float32",), ((3, 96), (5, 128)),
                 _rglru_inputs("rglru{batch}x{n}"), _rglru, 10.0),
    "rglru_fused": Row(("rglru",), ("float32",), ODD_BATCH_SHAPES,
                       _rglru_inputs("rglruf{batch}x{n}"), _rglru_fused, 10.0),
    "attention": Row(("attention",), ("float32",), ((3, 192), (5, 256)),
                     _attention_inputs, _attention, 10.0),
}


def cases() -> Iterator[Tuple[str, str, int, int]]:
    """Every (entry, dtype, batch, n) of the table, in a fixed order."""
    for entry in sorted(TABLE):
        row = TABLE[entry]
        for dtype in row.dtypes:
            for batch, n in row.shapes:
                yield entry, dtype, batch, n


def registered_entries() -> List[str]:
    """Every tuned entry point's name, after importing every op module."""
    for op in _OP_MODULES:
        _ensure_registered(op)
    return sorted({spec.entry_name for spec in registered_kernels().values()})


def missing_rows() -> List[str]:
    """Registered entry points without a row (opt-out-proof coverage: a new
    ``@tuned_kernel`` entry point must bring its differential row)."""
    covered = set(TABLE)
    return [entry for entry in registered_entries()
            if not ALIASES.get(entry, {entry}) & covered]


_TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "complex64": torch.complex64}


def tensors(inputs: Inputs, dtype: str,
            device: torch.device) -> Dict[str, torch.Tensor]:
    """The numpy inputs on ``device``, cast to the case's type."""
    return {k: torch.from_numpy(v).to(device=device, dtype=_TYPES[dtype])
            for k, v in inputs.items()}


def run_case(entry: str, t: Dict[str, torch.Tensor],
             configs: Configs = None) -> Tuple[torch.Tensor, List[dict]]:
    """The row's call on ``t``, replaying ``configs`` (None: the entry
    point resolves through the default session); returns the output and
    the configs the default session resolved for the row's ops, in
    order."""
    row = TABLE[entry]
    session = default_session()
    resolve = session.resolve
    seen: List[dict] = []

    def recording(wl, **kw):
        cfg = resolve(wl, **kw)
        if wl.op in row.ops:
            seen.append(dict(cfg))
        return cfg

    session.resolve = recording
    try:
        out = row.call(t, configs)
    finally:
        del session.resolve
    return out, seen


def close(got: torch.Tensor, want: torch.Tensor, dtype: str,
          scale: float = 1.0) -> Tuple[bool, float]:
    """The tests' ``assert_kernel_close``: complex outputs by max |got -
    want| relative to max |want| below rtol x scale; real ones elementwise
    within rtol x scale |want| + atol x scale max(max |want|, 1).  Returns
    (within, the max error: relative for complex, absolute otherwise)."""
    rtol, atol_rel = DTYPE_TOL[dtype]
    g, w = got.detach().cpu(), want.detach().cpu()
    if w.is_complex():
        g, w = g.to(torch.complex128), w.to(torch.complex128)
        mag = float(w.abs().max()) or 1.0
        err = float((g - w).abs().max()) / mag
        return err < rtol * scale, err
    g, w = g.double(), w.double()
    atol = atol_rel * scale * max(float(w.abs().max()), 1.0)
    diff = (g - w).abs()
    ok = bool((diff <= atol + rtol * scale * w.abs()).all()) \
        and bool(torch.isfinite(g).all())
    return ok, float(diff.max())
