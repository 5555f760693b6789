"""Pure-numpy random-forest regressor + versioned ``.npz`` model bundle.

Why a forest and not the GP already in ``core/bayesian.py``: the predictor
must answer *online* (rank hundreds of candidates in well under a
millisecond, zero objective evaluations) and must expose a cheap
uncertainty signal for the fallback gate. Bagged CART trees give both —
prediction is a handful of vectorized array traversals, and the spread of
the per-tree predictions is the disagreement estimate used to decide when
to fall back to the analytical model.

No sklearn: the container policy is numpy-only, and the trees here are
small enough (thousands of rows, ~24 features) that exact greedy splits
via prefix sums are fast.

Serialization: one ``.npz`` holds every per-op forest flattened to arrays
plus a JSON ``__meta__`` blob carrying the schema + feature versions.
Loading a bundle whose versions mismatch raises ``ModelArtifactError`` so
callers fall back instead of silently mis-predicting.

The PyTorch port's own copy of ``repro.tuning.ml.forest``: the same
seeded trees on the same rows, and the same ``.npz`` layout, so an
artifact saved by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.tuning.ml.features import FEATURE_NAMES, FEATURE_VERSION

MODEL_SCHEMA = 1


class ModelArtifactError(RuntimeError):
    """Missing / corrupt / version-mismatched model artifact."""


# ---------------------------------------------------------------------------
# CART regression tree (arrays-of-nodes layout, exact greedy splits)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Tree:
    """Flat node arrays; feature == -1 marks a leaf."""

    feature: np.ndarray      # int32 (n_nodes,)
    threshold: np.ndarray    # float64 (n_nodes,)
    left: np.ndarray         # int32 (n_nodes,)
    right: np.ndarray        # int32 (n_nodes,)
    value: np.ndarray        # float64 (n_nodes,)

    def predict(self, X: np.ndarray) -> np.ndarray:
        idx = np.zeros(len(X), dtype=np.int32)
        while True:
            feat = self.feature[idx]
            active = feat >= 0
            if not active.any():
                return self.value[idx]
            rows = np.nonzero(active)[0]
            f, node = feat[rows], idx[rows]
            go_left = X[rows, f] <= self.threshold[node]
            idx[rows] = np.where(go_left, self.left[node], self.right[node])


def _best_split(X: np.ndarray, y: np.ndarray, feat_ids: np.ndarray,
                min_leaf: int) -> Optional[Tuple[int, float, float]]:
    """(feature, threshold, gain) of the best SSE-reducing split, or None."""
    n = len(y)
    parent_sse = float(np.sum(y * y) - np.sum(y) ** 2 / n)
    best: Optional[Tuple[int, float, float]] = None
    for f in feat_ids:
        order = np.argsort(X[:, f], kind="stable")
        xs, ys = X[order, f], y[order]
        # candidate boundaries: between distinct consecutive x values
        cum_y = np.cumsum(ys)
        cum_y2 = np.cumsum(ys * ys)
        k = np.arange(1, n)                       # left-side sizes
        valid = (xs[1:] != xs[:-1]) & (k >= min_leaf) & (n - k >= min_leaf)
        if not valid.any():
            continue
        ly, ly2 = cum_y[:-1], cum_y2[:-1]
        ry, ry2 = cum_y[-1] - ly, cum_y2[-1] - ly2
        sse = (ly2 - ly * ly / k) + (ry2 - ry * ry / (n - k))
        sse = np.where(valid, sse, np.inf)
        i = int(np.argmin(sse))
        gain = parent_sse - float(sse[i])
        if gain > 1e-12 and (best is None or gain > best[2]):
            thr = 0.5 * (xs[i] + xs[i + 1])
            best = (int(f), float(thr), gain)
    return best


def _grow_tree(X: np.ndarray, y: np.ndarray, rng: np.random.Generator, *,
               max_depth: int, min_leaf: int, feature_frac: float) -> Tree:
    feature: List[int] = []
    threshold: List[float] = []
    left: List[int] = []
    right: List[int] = []
    value: List[float] = []
    n_feat = X.shape[1]
    n_sub = max(1, int(round(feature_frac * n_feat)))

    def new_node() -> int:
        feature.append(-1)
        threshold.append(0.0)
        left.append(-1)
        right.append(-1)
        value.append(0.0)
        return len(feature) - 1

    root = new_node()
    stack: List[Tuple[int, np.ndarray, int]] = [(root, np.arange(len(y)), 0)]
    while stack:
        node, idx, depth = stack.pop()
        ys = y[idx]
        value[node] = float(ys.mean())
        if depth >= max_depth or len(idx) < 2 * min_leaf \
                or float(ys.max() - ys.min()) < 1e-12:
            continue
        feat_ids = rng.permutation(n_feat)[:n_sub]
        split = _best_split(X[idx], ys, feat_ids, min_leaf)
        if split is None:
            continue
        f, thr, _ = split
        mask = X[idx, f] <= thr
        li, ri = idx[mask], idx[~mask]
        if not len(li) or not len(ri):
            continue
        feature[node], threshold[node] = f, thr
        left[node], right[node] = new_node(), new_node()
        stack.append((left[node], li, depth + 1))
        stack.append((right[node], ri, depth + 1))
    return Tree(np.asarray(feature, np.int32), np.asarray(threshold),
                np.asarray(left, np.int32), np.asarray(right, np.int32),
                np.asarray(value))


# ---------------------------------------------------------------------------
# Forest
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Forest:
    """Bagged regression trees; predicts (mean, per-tree std)."""

    trees: List[Tree] = dataclasses.field(default_factory=list)

    @classmethod
    def fit(cls, X: np.ndarray, y: np.ndarray, *, n_trees: int = 48,
            max_depth: int = 12, min_leaf: int = 2, feature_frac: float = 0.8,
            bootstrap: bool = True, seed: int = 0) -> "Forest":
        if len(X) == 0:
            raise ValueError("cannot fit a forest on an empty dataset")
        rng = np.random.default_rng(seed)
        trees = []
        for _ in range(n_trees):
            if bootstrap:
                idx = rng.integers(0, len(X), size=len(X))
                Xi, yi = X[idx], y[idx]
            else:
                Xi, yi = X, y     # diversity from feature subsampling only
            trees.append(_grow_tree(Xi, yi, rng, max_depth=max_depth,
                                    min_leaf=min_leaf,
                                    feature_frac=feature_frac))
        return cls(trees)

    def predict_all(self, X: np.ndarray) -> np.ndarray:
        """Per-tree predictions, shape (n_trees, n_rows)."""
        return np.stack([t.predict(X) for t in self.trees])

    def predict(self, X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        per_tree = self.predict_all(X)
        return per_tree.mean(axis=0), per_tree.std(axis=0)


# ---------------------------------------------------------------------------
# Bundle: one forest per kernel op, one artifact on disk
# ---------------------------------------------------------------------------

_TREE_FIELDS = ("feature", "threshold", "left", "right", "value")


class ModelBundle:
    """{op -> Forest} plus metadata; saved/loaded as a versioned ``.npz``."""

    def __init__(self, forests: Optional[Dict[str, Forest]] = None,
                 meta: Optional[Dict] = None):
        self.forests: Dict[str, Forest] = dict(forests or {})
        self.meta: Dict = {
            "schema": MODEL_SCHEMA,
            "feature_version": FEATURE_VERSION,
            "feature_names": list(FEATURE_NAMES),
            "label": "log_slowdown_vs_group_best",
        }
        self.meta.update(meta or {})

    def ops(self) -> Tuple[str, ...]:
        aliased = tuple(self.meta.get("aliases", {}))
        return tuple(sorted(set(self.forests) | set(aliased)))

    def forest_for(self, op: str) -> Optional[Forest]:
        """Forest for ``op``, following ``meta["aliases"]`` one hop.

        Ops sharing a search space and cost structure (scan / ssd / rglru)
        train one pooled forest; the alias map routes them to it.
        """
        forest = self.forests.get(op)
        if forest is not None:
            return forest
        alias = self.meta.get("aliases", {}).get(op)
        return self.forests.get(alias) if alias else None

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> str:
        arrays: Dict[str, np.ndarray] = {
            "__meta__": np.frombuffer(
                json.dumps(self.meta, sort_keys=True).encode(), dtype=np.uint8),
        }
        for op, forest in self.forests.items():
            arrays[f"{op}::n_trees"] = np.array([len(forest.trees)])
            for i, tree in enumerate(forest.trees):
                for field in _TREE_FIELDS:
                    arrays[f"{op}::{i}::{field}"] = getattr(tree, field)
        directory = os.path.dirname(os.path.abspath(path))
        if directory:
            os.makedirs(directory, exist_ok=True)
        # atomic publish: a reader may load while train-model rewrites
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "ModelBundle":
        if not os.path.exists(path):
            raise ModelArtifactError(f"no model artifact at {path!r}")
        try:
            with np.load(path) as data:
                meta = json.loads(bytes(data["__meta__"]).decode())
                if meta.get("schema") != MODEL_SCHEMA:
                    raise ModelArtifactError(
                        f"model schema {meta.get('schema')} != {MODEL_SCHEMA}")
                if meta.get("feature_version") != FEATURE_VERSION:
                    raise ModelArtifactError(
                        f"feature version {meta.get('feature_version')} != "
                        f"{FEATURE_VERSION}; retrain the model")
                forests: Dict[str, Forest] = {}
                for key in data.files:
                    if not key.endswith("::n_trees"):
                        continue
                    op = key[: -len("::n_trees")]
                    trees = [
                        Tree(*(data[f"{op}::{i}::{field}"]
                               for field in _TREE_FIELDS))
                        for i in range(int(data[key][0]))
                    ]
                    forests[op] = Forest(trees)
        except ModelArtifactError:
            raise
        except Exception as e:                    # corrupt zip/json/arrays
            raise ModelArtifactError(f"unreadable model artifact {path!r}: {e}")
        return cls(forests, meta)


def train_bundle(datasets: Dict[str, Tuple[np.ndarray, np.ndarray]], *,
                 n_trees: int = 48, max_depth: int = 12, min_leaf: int = 2,
                 feature_frac: float = 0.8, bootstrap: bool = True,
                 seed: int = 0, meta: Optional[Dict] = None) -> ModelBundle:
    """Fit one forest per op from ``{op: (X, y)}`` training splits."""
    forests = {}
    for op, (X, y) in sorted(datasets.items()):
        forests[str(op)] = Forest.fit(
            np.asarray(X, np.float64), np.asarray(y, np.float64),
            n_trees=n_trees, max_depth=max_depth, min_leaf=min_leaf,
            feature_frac=feature_frac, bootstrap=bootstrap, seed=seed)
    info = {"n_trees": n_trees, "max_depth": max_depth, "seed": seed,
            "train_rows": {str(op): int(len(X))
                           for op, (X, _) in datasets.items()}}
    info.update(meta or {})
    return ModelBundle(forests, info)
