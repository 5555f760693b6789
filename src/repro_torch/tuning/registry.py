"""Kernel registry: one declaration per tuned op.

``@tuned_kernel(...)`` ties together, in one place, everything the tuning
layer needs to know about a kernel family:

  op name -> search-space builder, kernel impl, reference impl, config
  normalizer (how raw tuned knobs are fitted to the actual launch dims).

The PyTorch port's own copy of ``repro.tuning.registry``.

The decorated function is the public entry point; the declaration is
attached as ``fn.kernel_spec`` and recorded so that

  * ``TunerSession.resolve`` finds the op's normalizer (the single
    config-resolution pipeline — no per-ops.py ``_norm_cfg`` copies),
  * the op's space builder is registered with ``repro_torch.core.space`` so
    ``build_space`` works for it,
  * tooling can enumerate every tuned entry point (``registered_kernels``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Mapping, Optional, Tuple

from repro_torch.core.space import (Config, SearchSpace, Workload,
                                    normalize_config, register_space)

# normalizer signature: (raw_cfg, workload, dims) -> launch kwargs
Normalizer = Callable[[Mapping[str, int], Workload, Optional[Mapping[str, int]]],
                      Config]
SpaceBuilder = Callable[[Workload], SearchSpace]


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Declarative record for one tuned kernel entry point."""

    op: str
    entry_name: str
    space: Optional[SpaceBuilder] = None
    kernel: Optional[Callable] = None
    reference: Optional[Callable] = None
    normalize: Normalizer = normalize_config
    variants: Tuple[str, ...] = ()


# entry-point name -> spec (an op may expose several entry points, e.g.
# scan -> prefix_sum + linear_recurrence)
_KERNELS: Dict[str, KernelSpec] = {}
# op name -> spec used for config resolution (normalizer / space)
_BY_OP: Dict[str, KernelSpec] = {}


def tuned_kernel(op: str, *, space: Optional[SpaceBuilder] = None,
                 kernel: Optional[Callable] = None,
                 reference: Optional[Callable] = None,
                 normalize: Optional[Normalizer] = None,
                 variants: Tuple[str, ...] = ()) -> Callable:
    """Register the decorated function as the tuned entry point for ``op``."""

    def deco(fn: Callable) -> Callable:
        spec = KernelSpec(op=op, entry_name=fn.__name__, space=space,
                          kernel=kernel, reference=reference,
                          normalize=normalize or normalize_config,
                          variants=tuple(variants))
        # one function may serve several ops (fft drives both "fft" and
        # "large_fft"); qualify the key on collision instead of overwriting
        key = fn.__name__ if fn.__name__ not in _KERNELS else f"{op}:{fn.__name__}"
        _KERNELS[key] = spec
        _BY_OP.setdefault(op, spec)
        if normalize is not None:
            _BY_OP[op] = spec
        if space is not None:
            register_space(op, space)
        if not hasattr(fn, "kernel_spec"):
            fn.kernel_spec = spec    # primary registration wins
        return fn

    return deco


# specs register at kernels/*/ops.py import time; resolving an op before its
# module was imported would silently fall back to the generic normalizer, so
# look the module up lazily (ops sharing a module map onto it here)
_OP_MODULES = {
    "scan": "repro_torch.kernels.scan.ops",
    "tridiag": "repro_torch.kernels.tridiag.ops",
    "fft": "repro_torch.kernels.fft.ops",
    "large_fft": "repro_torch.kernels.fft.ops",
    "ssd": "repro_torch.kernels.ssd.ops",
    "rglru": "repro_torch.kernels.rglru.ops",
    "attention": "repro_torch.kernels.attention.ops",
    "matmul": "repro_torch.kernels.matmul.ops",
}


def _ensure_registered(op: str) -> None:
    if op in _BY_OP:
        return
    module = _OP_MODULES.get(op)
    if module is not None:
        try:
            importlib.import_module(module)
        except ImportError:
            pass


def get_kernel(name: str) -> KernelSpec:
    """Spec by entry-point name (or op name as a fallback)."""
    if name in _KERNELS:
        return _KERNELS[name]
    _ensure_registered(name)
    if name in _BY_OP:
        return _BY_OP[name]
    raise KeyError(f"no tuned kernel registered under {name!r}")


def normalizer_for(op: str) -> Normalizer:
    _ensure_registered(op)
    spec = _BY_OP.get(op)
    return spec.normalize if spec is not None else normalize_config


def registered_kernels() -> Dict[str, KernelSpec]:
    return dict(_KERNELS)


def known_ops() -> Tuple[str, ...]:
    """Every op name the registry can resolve (imported or lazily known).

    The ML training suite (``repro_torch.tuning.ml.dataset.SUITE``) must
    cover exactly this set — a test enforces it, so registering a new
    ``@tuned_kernel`` op forces the author to declare its train/holdout
    sizes rather than silently shipping a kernel the predictor never
    learns.
    """
    return tuple(sorted(set(_OP_MODULES) | set(_BY_OP)))
