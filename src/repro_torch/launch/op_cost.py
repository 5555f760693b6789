"""Analytic FLOP/byte counting from the step's aten ops: the port's
counterpart of ``repro.launch.jaxpr_cost``.

Torch has no jaxpr.  What stands in for it is the stream of aten ops a
step dispatches, which a ``TorchDispatchMode`` sees below autograd (so the
backward and any remat recompute appear as explicit ops, as they do as
explicit eqns in a jaxpr) and after the composite ops have decomposed
(``einsum`` and ``matmul`` arrive as ``mm`` / ``bmm``).  On a DTensor step
the mode sees each op once, at the DTensor level, with the global shapes:
the counts are the global step's, as ``analyze_jaxpr``'s are.  Fake
tensors carry the shapes without data, so nothing is computed.

Counts, in JAX's categories:

  flops — 2*M*N*K per ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` (JAX's
          dot_general); 4 per output element for the transcendental set;
          1 per output element for the cheap elementwise set and the
          reductions.  Ops that torch keeps whole and JAX expands count as
          JAX's expansion (``_softmax``: sub + exp + div = 6 per element;
          ``softplus``: 11, ``logsumexp``: 5 per input element, ...).
  bytes — the dot operands plus result, the outputs of the gather /
          scatter / index-put / sort / topk ops, and the entry arguments
          once.  Elementwise chains count no bytes (assumed fused).

Where the bytes differ from JAX's, and why: the port's layers run in a
Python loop, not a ``lax.scan``, so there is no "stacked xs/ys once" term —
JAX adds the stacked per-layer weights and carries once per scan on top
of the per-layer dot operands, which the port's dots already read; and
where the port updates a cache or a loop output by ``index_put`` /
``index_copy`` JAX may use a dynamic_update_slice of a different size.
``dot_count`` and the dot FLOPs are exactly JAX's whenever both sides
contract the same einsums (the tests hold them equal).
"""
from __future__ import annotations

import math
import sys
import weakref
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_DOTS = {"mm", "bmm", "addmm", "baddbmm"}
_TRANSCENDENTAL = {"exp", "exp2", "log", "log2", "tanh", "sigmoid", "sin",
                   "cos", "rsqrt", "sqrt", "erf", "log1p", "expm1", "pow",
                   "cumsum", "cumprod", "logcumsumexp"}
_CHEAP = {"add", "sub", "rsub", "mul", "div", "maximum", "minimum", "neg",
          "abs", "logical_and", "logical_or", "logical_not", "logical_xor",
          "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor",
          "where", "ge", "gt", "le", "lt", "eq", "ne", "sign", "floor",
          "ceil", "round", "clamp", "clamp_min", "clamp_max", "remainder",
          "fmod", "square", "reciprocal", "trunc", "masked_fill"}
_REDUCE = {"sum", "mean", "amax", "amin", "argmax", "argmin", "prod", "any",
           "all", "var", "std", "linalg_vector_norm"}
# JAX's expansion of ops that torch dispatches whole, per output element
_EXPANDED = {"_softmax": 6, "_log_softmax": 6,
             "_softmax_backward_data": 3, "_log_softmax_backward_data": 3,
             "softplus": 11, "softplus_backward": 7,
             "sigmoid_backward": 2, "tanh_backward": 2}
# per input element
_EXPANDED_IN = {"logsumexp": 5}
_MATERIALIZED = {"index", "index_select", "gather", "embedding", "scatter",
                 "scatter_add", "scatter_reduce", "index_put",
                 "_index_put_impl", "index_add", "index_copy", "sort", "topk",
                 "slice_scatter", "select_scatter",
                 "embedding_dense_backward"}


def _nelems(t: torch.Tensor) -> int:
    return math.prod(t.shape)


def _nbytes(t: torch.Tensor) -> int:
    return _nelems(t) * t.element_size()


def _name(func) -> str:
    """The op's name, an in-place variant's ("add_") as its own ("add")."""
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") else name


def _local(t: torch.Tensor) -> torch.Tensor:
    """The per-device tensor: a DTensor's local shard, else ``t``."""
    return getattr(t, "_local_tensor", t)


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and dots of every op dispatched under it, in
    ``acc``.  Entered above a :class:`DeviceTracker`, it sees a DTensor
    step's ops once each, with their global shapes.  A ``torch.einsum``
    counts as JAX's ``jnp.einsum`` lowers it (:class:`_EinsumCounter`),
    not as the ops torch decomposes it into."""

    def __init__(self):
        super().__init__()
        self.acc: Dict[str, float] = {"flops": 0.0, "bytes": 0.0,
                                      "dot_count": 0.0, "dot_flops": 0.0}
        self.suspended = 0
        self._einsum = None

    def __enter__(self):
        self._einsum = _EinsumCounter(self)
        self._einsum.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._einsum.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.suspended:
            outs = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
            self._count(func, args, outs)
        return out

    def add_dot(self, flops: float, nbytes: float) -> None:
        self.acc["flops"] += flops
        self.acc["dot_flops"] += flops
        self.acc["bytes"] += nbytes
        self.acc["dot_count"] += 1

    def _count(self, func, args, outs) -> None:
        acc = self.acc
        name = _name(func)
        out_elems = sum(_nelems(t) for t in outs)
        if name in _DOTS:
            a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") \
                else (args[0], args[1])
            self.add_dot(2 * _nelems(outs[0]) * max(a.shape[-1], 1),
                         _nbytes(a) + _nbytes(b) + _nbytes(outs[0]))
            return
        overload = func._overloadname
        if name in _TRANSCENDENTAL:
            acc["flops"] += 4 * out_elems
        elif name in _CHEAP or (name in ("max", "min")
                                and overload in ("other", "out")):
            acc["flops"] += out_elems
        elif name in _REDUCE or name in ("max", "min"):
            acc["flops"] += out_elems
        elif name in _EXPANDED:
            acc["flops"] += _EXPANDED[name] * out_elems
        elif name in _EXPANDED_IN:
            acc["flops"] += _EXPANDED_IN[name] * _nelems(args[0])
        if name in _MATERIALIZED:
            acc["bytes"] += sum(_nbytes(t) for t in outs)


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


def _einsum_path(equation: str, operands):
    """The pairwise contractions of ``jnp.einsum``: opt_einsum's "auto"
    path, as JAX takes it (left to right where opt_einsum is absent)."""
    try:
        import opt_einsum
    except ImportError:
        opt_einsum = None
    shapes = [_Shape(t.shape) for t in operands]
    if opt_einsum is not None:
        return opt_einsum.contract_path(equation, *shapes, einsum_call=True,
                                        use_blas=True, optimize="auto")[1]
    lhs, out = equation.replace(" ", "").split("->")
    names = lhs.split(",")
    steps = []
    while len(names) > 1:
        a, b = names[0], names[1]
        rest = "".join(names[2:]) + out
        keep = "".join(dict.fromkeys(c for c in a + b if c in rest))
        steps.append(((0, 1), None, f"{a},{b}->{keep}", None, False))
        names = [keep] + names[2:]
    return steps


class _EinsumCounter(TorchFunctionMode):
    """Counts each ``torch.einsum`` as JAX's lowering of it: one
    dot_general per pairwise contraction of the path (2 x output elements
    x contracted size, even where no index is contracted and torch runs a
    plain product), a reduction where an operand's own index is summed out
    first.  In a backward, the einsum's gradient counts as JAX's transpose
    of each dot_general: one dot_general per operand that needs a
    gradient.  The ops torch runs meanwhile, forward and backward, are not
    counted again."""

    def __init__(self, counter: OpCounter):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", None) != "einsum" or not args \
                or not isinstance(args[0], str):
            return func(*args, **kwargs)
        equation, operands = args[0], args[1:]
        if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
            operands = tuple(operands[0])
        backward = self._count(equation, operands)
        self.counter.suspended += 1
        try:
            out = func(*args, **kwargs)
        finally:
            self.counter.suspended -= 1
        if backward and isinstance(out, torch.Tensor) \
                and out.grad_fn is not None:
            self._hook_backward(out, operands, backward)
        return out

    def _count(self, equation: str, operands) -> list:
        """Counts the forward; returns the backward's dots (flops, bytes)."""
        if "->" not in equation or "." in equation:
            return []       # implicit output / ellipsis: torch's ops count
        sizes: Dict[str, int] = {}
        lhs = equation.replace(" ", "").split("->")[0].split(",")
        for names, t in zip(lhs, operands):
            sizes.update(zip(names, t.shape))
        item = operands[0].element_size()
        grad = torch.is_grad_enabled()
        needs = [grad and t.requires_grad for t in operands]
        acc = self.counter.acc
        backward = []

        def elems(names):
            return math.prod(sizes[c] for c in names)

        for step in _einsum_path(equation, operands):
            inds, steq = step[0], step[2]
            ins, out = steq.split("->")
            ins = ins.split(",")
            need = [needs[i] for i in inds]
            for i in sorted(inds, reverse=True):
                needs.pop(i)
            needs.append(any(need))
            if len(ins) == 1:
                acc["flops"] += elems(out)
                continue
            a, b = ins
            # indices only one side holds are summed out first (reductions)
            for side, other in ((a, b), (b, a)):
                if any(c not in other and c not in out for c in side):
                    acc["flops"] += elems(
                        c for c in side if c in other or c in out)
            a = "".join(c for c in a if c in b or c in out)
            b = "".join(c for c in b if c in a or c in out)
            k = elems(c for c in a if c in b and c not in out)
            self.counter.add_dot(2 * elems(out) * k,
                                 item * (elems(a) + elems(b) + elems(out)))
            # the transpose: d(a) = g . b over b's free indices, and back
            for side, other, n in ((a, b, need[0]), (b, a, need[1])):
                if n:
                    free = elems(c for c in other if c not in side)
                    backward.append(
                        (2 * elems(side) * free,
                         item * (elems(out) + elems(other) + elems(side))))
        return backward

    def _hook_backward(self, out, operands, backward) -> None:
        """Count ``backward`` when the einsum's gradient runs, and none of
        the ops of the autograd nodes torch built for it."""
        counter = self.counter
        stop = {id(t.grad_fn) for t in operands
                if isinstance(t, torch.Tensor) and t.grad_fn is not None}
        nodes, todo, seen = [], [out.grad_fn], set()
        while todo:
            node = todo.pop()
            if node is None or id(node) in seen or id(node) in stop \
                    or type(node).__name__ == "AccumulateGrad":
                continue
            seen.add(id(node))
            nodes.append(node)
            todo.extend(n for n, _ in node.next_functions)

        def enter(*_):
            counter.suspended += 1

        def leave(*_):
            counter.suspended -= 1

        def first(*_):
            for flops, nbytes in backward:
                counter.add_dot(flops, nbytes)

        out.grad_fn.register_prehook(first)
        for node in nodes:
            node.register_prehook(enter)
            node.register_hook(leave)


# the functional collectives a DTensor step issues -> the HLO kind
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce",
                "all_to_all_single": "all-to-all",
                "broadcast": "collective-permute"}


def _group_size(func, args, kwargs) -> int:
    vals = dict(zip((a.name for a in func._schema.arguments), args))
    vals.update(kwargs)
    if "group_size" in vals:
        return int(vals["group_size"])
    group = vals["group_name"]
    if isinstance(group, str):
        import torch.distributed.distributed_c10d as c10d

        group = c10d._resolve_process_group(group)
    return group.size()


class DeviceTracker(TorchDispatchMode):
    """What one device holds and sends during a step.

    Under a DTensor step it lets each DTensor op pass (``NotImplemented``,
    as torch's ``CommDebugMode`` does), so it sees the local ops the
    DTensor dispatch runs: each output's storage counts toward the
    per-device ``live_bytes`` / ``peak_bytes`` until it is freed (the
    storages of ``ignore``d tensors, the step's arguments, count nothing),
    and each functional collective is recorded in ``collectives`` as
    (HLO kind, result bytes on this device, group size).  Given the step's
    ``fake_mode``, fake tensors of any other mode (DTensor's own shape
    propagation) count nothing."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.collectives: List[Tuple[str, int, int]] = []
        self._known: Dict[int, Any] = {}
        self._fake_mode = fake_mode

    def ignore(self, tensors) -> None:
        for t in tree_flatten(tensors)[0]:
            if isinstance(t, torch.Tensor):
                self._known.setdefault(
                    _local(t).untyped_storage()._cdata, None)

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":
            return          # no device holds it
        mode = getattr(t, "fake_mode", None)
        if mode is not None and self._fake_mode is not None \
                and mode is not self._fake_mode:
            return          # another fake mode's: DTensor's shape checks
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known:
            return
        nbytes = st.nbytes()

        def freed(_, key=key, nbytes=nbytes, tracker=weakref.ref(self)):
            c = tracker()
            if c is not None and c._known.pop(key, None) is not None:
                c.live_bytes -= nbytes

        self._known[key] = weakref.ref(st, freed)
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if is_dtensor_type(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not isinstance(func, torch._ops.OpOverload):
            return out
        caller = _dtensor_internal()
        if caller == "meta":
            return out      # DTensor's shape propagation, on no device
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        kind = _COLLECTIVES.get(func.overloadpacket.__name__)
        if caller == "alltoall":
            # a CPU mesh's all-to-all runs as all-gather + chunk; a card's
            # NCCL sends each shard once: record that, and no buffer
            if kind is not None:
                self.collectives.append(
                    ("all-to-all", _nbytes(args[0]),
                     _group_size(func, args, kwargs)))
            return out
        if kind is not None:
            self.collectives.append(
                (kind, sum(_nbytes(t) for t in outs),
                 _group_size(func, args, kwargs)))
        for t in outs:
            self._track(t)
        return out


_INTERNAL = {"_propagate_tensor_meta_non_cached": "meta",
             "_propagate_tensor_meta": "meta",
             "shard_dim_alltoall": "alltoall"}


def _dtensor_internal(depth: int = 48):
    """"meta" inside DTensor's shape propagation (its ops run on fake
    global tensors, not on a device), "alltoall" inside a CPU mesh's
    all-to-all fallback, else None."""
    frame = sys._getframe(2)
    while frame is not None and depth:
        hit = _INTERNAL.get(frame.f_code.co_name)
        if hit is not None and "distributed" in frame.f_code.co_filename:
            return hit
        frame, depth = frame.f_back, depth - 1
    return None


def is_dtensor_type(types) -> bool:
    from repro_torch.tuning.dispatch import is_dtensor_class

    return any(is_dtensor_class(t) for t in types)


def argument_bytes(*trees) -> int:
    """Bytes of the tensor leaves of ``trees``, each storage once (global
    shapes for DTensors)."""
    seen, total = set(), 0
    for t in tree_flatten(trees)[0]:
        if isinstance(t, torch.Tensor):
            key = _local(t).untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                total += _nbytes(t)
    return total


def analyze_ops(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Counts over the ops of ``fn(*args, **kwargs)``: ``flops``,
    ``bytes``, ``dot_count`` (JAX's keys) and ``dot_flops``."""
    counter = OpCounter()
    with counter:
        fn(*args, **kwargs)
    acc = dict(counter.acc)
    # entry arguments (params etc.) are read once
    acc["bytes"] += argument_bytes(args, kwargs)
    return acc
