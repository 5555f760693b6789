"""A parallel associative scan over one tensor dimension.

PyTorch has no ``associative_scan``.  This is the odd/even recursion of
``jax.lax.associative_scan``, step for step: combine adjacent pairs, scan
the half-length result recursively (the odd outputs), combine those with
the even inputs (the even outputs), interleave.  Keeping JAX's recursion
keeps its combine order, so a scan whose combine rounds (the linear
recurrence, the LF solver's normalized 2x2 pivot products) agrees with the
JAX package's to rounding.  Shared by ``kernels/scan/ref.py`` and
``kernels/tridiag/ops.py``.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

Elems = Tuple[torch.Tensor, ...]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... (``even`` one longer or as long):
    out of place, so a DTensor step can take it too."""
    m = odd.shape[-1]
    pairs = torch.stack([even[..., :m], odd], dim=-1).flatten(-2)
    if even.shape[-1] == m:
        return pairs
    return torch.cat([pairs, even[..., m:]], dim=-1)


def _scan(combine: Callable[[Elems, Elems], Sequence[torch.Tensor]],
          elems: Elems) -> Elems:
    n = elems[0].shape[-1]
    if n < 2:
        return elems
    reduced = tuple(combine(tuple(e[..., 0:n - 1:2] for e in elems),
                            tuple(e[..., 1::2] for e in elems)))
    odd = _scan(combine, reduced)
    if n % 2 == 0:
        even = combine(tuple(o[..., :-1] for o in odd),
                       tuple(e[..., 2::2] for e in elems))
    else:
        even = combine(odd, tuple(e[..., 2::2] for e in elems))
    even = tuple(torch.cat([e[..., :1], r], dim=-1)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def associative_scan(combine: Callable[[Elems, Elems], Sequence[torch.Tensor]],
                     elems: Sequence[torch.Tensor], dim: int = -1) -> Elems:
    """Inclusive scan of the tuple ``elems`` along ``dim`` with the
    associative ``combine(older, newer)``, which takes and returns tuples
    of tensors shaped like ``elems``."""
    moved = tuple(e.movedim(dim, -1) for e in elems)
    if len({e.shape[-1] for e in moved}) != 1:
        raise ValueError("associative_scan: every tensor needs the same "
                         "length along the scanned dimension")
    return tuple(r.movedim(-1, dim) for r in _scan(combine, moved))
