"""Nested containers of tensors: the port's counterpart of a JAX pytree.

A tree is a dict, a list, a tuple or a NamedTuple (an optimizer state)
of trees, ``None`` (an absent sub-tree, which holds no leaf) or a leaf
(a tensor, an array or a number).  Flattening follows JAX's order: a
dict's keys sorted, a sequence's items in turn, a NamedTuple's fields in
declaration order; a leaf's path joins the keys, indices and field names
with "/", as ``repro.train.checkpoint`` names a checkpoint's leaves.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Tree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unzip(tree: Tree, n: int) -> Tuple[Tree, ...]:
    """A tree whose leaves are n-tuples (what ``tree_map`` gives for an
    ``fn`` returning a tuple), as n trees."""
    return tuple(_pick(tree, i) for i in range(n))


def _pick(tree: Tree, i: int) -> Tree:
    # a plain tuple is a leaf here: the containers are dicts, lists and
    # NamedTuples
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_pick(v, i) for v in tree))
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]          # the leaf's tuple


def flatten_with_path(tree: Tree, prefix: str = ""
                      ) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in JAX's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        yield prefix, tree
        return
    for key, value in items:
        yield from flatten_with_path(
            value, f"{prefix}/{key}" if prefix else key)


def tree_leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Tree,
                       prefix: str = "") -> Tree:
    """``fn(path, leaf)`` over the leaves, keeping the structure."""
    if tree is None:
        return None

    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, v, join(name))
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
