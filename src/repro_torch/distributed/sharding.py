"""Sharding-rules engine: parameter paths -> partition specs
(``repro.distributed.sharding``).

2D "FSDP x TP" layout over ("data", "model"):
  * the tensor-parallel dimension of each weight shards on "model"
    (Megatron column/row split; experts shard on "model" = EP);
  * the complementary dimension shards on "data" (ZeRO-3-style), so
    optimizer state for the 34B/90B archs fits per-device HBM;
  * the "pod" axis is pure DP: parameters are replicated across pods and
    gradients all-reduce over the pod axis (optionally compressed,
    ``optim.compression.psum_compressed``).

Rules check divisibility against the actual mesh; a non-divisible dim falls
back to unsharded, and the decision log records every fallback (e.g.
gemma-2b's 8-head QKV on a 16-way model axis shards the fused head*dim
feature dimension instead).

The rule table, the divisibility and fallback logic and the spec functions
are the JAX package's, verbatim.  They apply to the JAX-layout tree of
``models.convert.param_tree`` (``blocks/attn/wq/w``, ...): leaves under
"blocks"/"enc_blocks" carry the stacked group dimension, and their specs
get a leading None prepended automatically.  A mesh is a ``DeviceMesh`` or
a ``launch.mesh.MeshShape``; a spec is a :class:`P`, the port's own
``PartitionSpec``: a tuple of one entry a tensor dim (an axis name, a
tuple of axis names, or None).  ``shardings_from_specs`` turns specs into
DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.distributed.hints import UNCONSTRAINED
from repro_torch.launch.mesh import mesh_shape
from repro_torch.optim.tree import tree_map, tree_map_with_path

PyTree = Any


class P(tuple):
    """A partition spec: ``P("data", None)`` shards dim 0 on "data" and
    replicates dim 1 (JAX's ``PartitionSpec``, as a tuple)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


P.UNCONSTRAINED = UNCONSTRAINED

# rule table: (path regex, spec template applied to the LAST len(template)
# dims of the leaf). "fsdp" -> "data", "tp" -> "model", None -> replicated.
_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    (r"embed/table$",               ("tp", "fsdp")),
    (r"attn/w[qkv]/w$",             ("fsdp", "tp")),
    (r"xattn/w[qkv]/w$",            ("fsdp", "tp")),
    (r"attn/wo/w$",                 ("tp", "fsdp")),
    (r"xattn/wo/w$",                ("tp", "fsdp")),
    (r"w[qkv]/b$",                  ("tp",)),
    (r"mlp/w[iu]/w$",               ("fsdp", "tp")),
    (r"mlp/wo/w$",                  ("tp", "fsdp")),
    (r"shared/w[iu]/w$",            ("fsdp", "tp")),
    (r"shared/wo/w$",               ("tp", "fsdp")),
    (r"moe/router/w$",              ("fsdp", None)),
    (r"moe/w[iu]$",                 ("tp", "fsdp", None)),   # (E, D, F): EP
    (r"moe/wo$",                    ("tp", None, "fsdp")),   # (E, F, D)
    (r"ssd/in_proj/w$",             ("fsdp", "tp")),
    (r"ssd/out_proj/w$",            ("tp", "fsdp")),
    (r"ssd/conv_w$",                (None, "tp")),
    (r"rec/w[xy]/w$",               ("fsdp", "tp")),
    (r"rec/w[ai]/w$",               (None, "tp")),
    (r"rec/conv_w$",                (None, "tp")),
    (r"rec/wo/w$",                  ("tp", "fsdp")),
]

_AXIS_MAP = {"fsdp": "data", "tp": "model"}


class ShardingDecisions:
    """Collects rule hits/fallbacks for reporting."""

    def __init__(self):
        self.fallbacks: List[str] = []
        self.hits: Dict[str, str] = {}

    def record(self, path: str, spec, note: str = ""):
        self.hits[path] = f"{spec}{(' # ' + note) if note else ''}"

    def record_fallback(self, path: str, dim: int, axis: str, size: int,
                        dim_size: int):
        self.fallbacks.append(
            f"{path}: dim{dim} ({dim_size}) not divisible by {axis}"
            f" ({size}) -> replicated on that axis")


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in getattr(leaf, "shape", ()))


def _ndim(leaf) -> int:
    return len(_shape(leaf))


def spec_for_leaf(path: str, shape: Tuple[int, ...], mesh,
                  scanned: bool, decisions: Optional[ShardingDecisions] = None
                  ) -> P:
    mesh = mesh_shape(mesh)
    for pattern, template in _RULES:
        if re.search(pattern, path):
            ndim = len(shape)
            offset = ndim - len(template)
            axes: List[Optional[str]] = [None] * ndim
            for i, logical in enumerate(template):
                if logical is None:
                    continue
                axis = _AXIS_MAP[logical]
                if axis not in mesh.axis_names:
                    continue
                size = mesh.shape[axis]
                dim = offset + i
                if shape[dim] % size == 0 and shape[dim] >= size:
                    axes[dim] = axis
                elif decisions is not None:
                    decisions.record_fallback(path, dim, axis, size, shape[dim])
            spec = P(*axes)
            if decisions is not None:
                decisions.record(path, spec)
            return spec
    # default: replicated (norm scales, small vectors, scalars)
    return P()


def param_specs(params: PyTree, mesh,
                decisions: Optional[ShardingDecisions] = None,
                pure_dp: bool = False) -> PyTree:
    """Spec tree matching `params` (leading stacked-group dims handled).
    pure_dp: replicate everything (small models where TP costs more in
    residual all-reduces than it saves in memory)."""
    if pure_dp:
        return tree_map(lambda l: P(*([None] * _ndim(l))), params)

    def leaf_spec(ps, leaf):
        scanned = ps.startswith(("blocks", "enc_blocks"))
        shape = _shape(leaf)
        if scanned and len(shape) >= 1:
            inner = spec_for_leaf(ps, tuple(shape[1:]), mesh, True, decisions)
            return P(*((None,) + tuple(inner)))
        return spec_for_leaf(ps, tuple(shape), mesh, False, decisions)

    return _map_sorted(leaf_spec, params)


def _map_sorted(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree's leaves in JAX's flattening order
    (a dict's keys sorted), so the decisions log its entries as JAX's
    does."""
    if tree is None:
        return None
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(tree, dict):
        out = {k: _map_sorted(fn, tree[k], join(k)) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_sorted(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def placements_for(spec, mesh) -> list:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(dim)`` on
    each mesh dim that a tensor dim names, ``Replicate()`` on the rest.  A
    tensor dim naming several axes (("pod", "data")) shards major to minor
    in that order, as JAX does."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_shape(mesh).axis_names
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None or entry is UNCONSTRAINED:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(axis)] = Shard(dim)
    return out


def shardings_from_specs(specs: PyTree, mesh) -> PyTree:
    """The placements of every spec in ``specs`` on the ``DeviceMesh``."""
    return map_specs(lambda s: placements_for(s, mesh), specs)


def map_specs(fn, specs: PyTree) -> PyTree:
    """``fn`` over the specs of a spec tree (a :class:`P` is a leaf, not a
    tuple to descend into)."""
    if specs is None:
        return None
    if isinstance(specs, P):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(map_specs(fn, v) for v in specs))
    if isinstance(specs, (list, tuple)):
        return type(specs)(map_specs(fn, v) for v in specs)
    raise TypeError(f"not a spec tree leaf: {specs!r}")


def batch_spec(mesh, extra_dims: int = 1) -> P:
    """Input batch sharding: (B, ...) with B over ("pod","data")."""
    from repro_torch.launch.mesh import batch_axes

    axes = batch_axes(mesh)
    return P(axes if len(axes) > 1 else (axes[0] if axes else None),
             *([None] * extra_dims))


def train_state_specs(state: PyTree, mesh,
                      decisions: Optional[ShardingDecisions] = None,
                      pure_dp: bool = False) -> PyTree:
    """Specs for the full train state: optimizer moments inherit parameter
    specs (AdamW) or sliced specs (Adafactor's factored accumulators)."""
    from repro_torch.optim.adafactor import AdafactorState
    from repro_torch.optim.adamw import AdamWState

    pspecs = param_specs(state["params"], mesh, decisions,
                         pure_dp=pure_dp)
    out: Dict[str, Any] = {"params": pspecs, "step": P()}
    opt = state["opt"]
    if isinstance(opt, AdamWState):
        out["opt"] = AdamWState(mu=pspecs, nu=pspecs, count=P())
    elif isinstance(opt, AdafactorState):
        def vr_spec(spec, p):
            return P(*tuple(spec)[:-1]) if _ndim(p) >= 2 else spec

        def vc_spec(spec, p):
            t = tuple(spec)
            return P(*(t[:-2] + t[-1:])) if _ndim(p) >= 2 else P()

        out["opt"] = AdafactorState(
            vr=zip_specs(vr_spec, pspecs, state["params"]),
            vc=zip_specs(vc_spec, pspecs, state["params"]),
            count=P())
    else:
        raise TypeError(f"unknown optimizer state {type(opt)}")
    if "ef_err" in state:
        out["ef_err"] = pspecs
    return out


def zip_specs(fn, specs: PyTree, tree: PyTree) -> PyTree:
    """``fn(spec, leaf)`` over a spec tree and the tree it describes."""
    if specs is None:
        return None
    if isinstance(specs, P):
        return fn(specs, tree)
    if isinstance(specs, dict):
        return {k: zip_specs(fn, v, tree[k]) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(zip_specs(fn, v, t) for v, t in zip(specs, tree)))
    return type(specs)(zip_specs(fn, v, t) for v, t in zip(specs, tree))


def batch_specs(batch: PyTree, mesh, axes: Optional[Tuple[str, ...]] = None
                ) -> PyTree:
    """Input batches shard on the batch dim only; a batch smaller than the
    batch-axis product (long_500k: global_batch=1) stays replicated.
    `axes` overrides the batch axes (pure_dp: the whole mesh)."""
    from repro_torch.launch.mesh import batch_axes

    ms = mesh_shape(mesh)
    baxes = axes if axes is not None else batch_axes(mesh)
    total = 1
    for a in baxes:
        total *= ms.shape[a]
    b_axis = baxes if len(baxes) > 1 else (baxes[0] if baxes else None)

    def one(leaf):
        shape = _shape(leaf)
        if shape and shape[0] % total == 0:
            return P(b_axis, *([None] * max(len(shape) - 1, 0)))
        return P(*([None] * len(shape)))

    return tree_map(one, batch)


def cache_specs(cache: PyTree, mesh) -> PyTree:
    """KV/state caches shard on batch; KV heads/features on model where
    divisible (decode_32k: 128-batch x 32k cache dominates memory).
    ``cache`` is in the JAX layout: each leaf's leading dim is the stacked
    groups, its second the batch (``launch.inputs.stacked_cache``)."""
    from repro_torch.launch.mesh import batch_axes

    ms = mesh_shape(mesh)
    baxes = batch_axes(mesh)
    b_axis = baxes if len(baxes) > 1 else (baxes[0] if baxes else None)
    model = "model" if "model" in ms.axis_names else None
    msize = ms.shape[model] if model else 1

    total = 1
    for a in baxes:
        total *= ms.shape[a]

    def one(path, leaf):
        shape = _shape(leaf)
        # leading dim = scan groups, second = batch
        axes: List[Optional[str]] = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % total == 0:
            axes[1] = b_axis
        # shard the widest trailing dim on model if divisible
        if model and len(shape) >= 3:
            best, best_dim = 0, -1
            for d in range(2, len(shape)):
                if shape[d] % msize == 0 and shape[d] > best:
                    best, best_dim = shape[d], d
            if best_dim >= 0 and best >= msize:
                axes[best_dim] = model
        return P(*axes)

    return tree_map_with_path(one, cache)
