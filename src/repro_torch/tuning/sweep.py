"""Vectorized, resumable exhaustive sweeps (the Phi-denominator engine).

Exhaustive search is the load-bearing wall of the paper's evaluation: it
supplies the optimum every other methodology is scored against, and the
dense (config, time) pairs the ML predictor trains on.  This module
replaces the seed's serial per-config Python loop with:

  * **batched evaluation** — the whole candidate set goes through
    ``Objective.batch_eval`` (a handful of numpy array ops on the cost
    model) instead of thousands of Python calls;
  * **a resumable journal** — one JSONL file per (workload, objective)
    with atomic line appends, so a long wall-clock sweep survives
    interruption and a re-run only evaluates what is missing;
  * **metric-vector journaling + Pareto fronts** — entries record the full
    metric vector (time/energy/peak-VMEM), the sweep maintains the
    non-dominated set per (workload, objective), and a :class:`Policy`
    picks the winner from the front — one sweep serves every policy;
  * **analytical-dominance pruning** — ``prune="analytical"`` keeps the
    top-k candidates ranked by the zero-evaluation expert model (the
    model-steered pruning lever of Schoonhoven et al.), recording how many
    candidates were dropped.  Pruning is latency-ranked, so combining it
    with a non-latency policy raises rather than silently searching the
    wrong subset.

The PyTorch port's own copy of ``repro.tuning.sweep``: journals, headers,
pruned sets and Pareto fronts are the JAX package's, so a journal written
by either package resumes in the other.

``run_sweep`` is what ``ExhaustiveSearch.tune`` (and therefore
``strategy="exhaustive"``) executes; ``repro_torch.tuning.ml.dataset`` consumes
the same journals directly as training rows.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.bayesian import TuneResult
from repro_torch.core.objective import METRIC_TIME, Objective
from repro_torch.core.policy import (Policy, get_policy, pareto_front,
                                     policy_scalar_cols)
from repro_torch.core.space import Config, SearchSpace, Workload

# v3 adds the per-entry metric vector ("m": {metric: value}); v2 added the
# hardware-profile name to the header. Older journals stay readable — their
# entries load as time_s-only vectors, and the objective-signature check
# already rejects cross-profile resumption, since the profile name is
# embedded in every cost-model signature.
JOURNAL_VERSION = 3

# default kept-set size for prune="analytical"; expensive objectives can
# pass an explicit top_k
DEFAULT_TOP_K = 64

# the journal header contract, flattened (nested workload fields appear as
# "workload.<field>").  ``repro_torch.analysis`` fingerprints this list
# against JOURNAL_VERSION: changing the header layout without bumping the
# version silently orphans every journal on disk, so the lint gate catches
# it.
HEADER_FIELDS = ("kind", "version", "workload.key", "workload.op",
                 "workload.n", "workload.batch", "workload.dtype",
                 "workload.variant", "objective", "profile", "space_size",
                 "pruned")


def make_header(wl: Workload, objective: Objective, space_size: int,
                pruned: int = 0) -> Dict:
    """The version-stamped journal header record (one per journal file).

    The single construction site for the ``HEADER_FIELDS`` contract;
    ``space_size`` is the FULL valid-space size and ``pruned`` the configs
    never measured by design (a model-steered subset), so journal
    consumers (dataset export) can tell "complete enumeration" from
    "model-steered subset"."""
    return {"kind": "header", "version": JOURNAL_VERSION,
            "workload": {"key": wl.key, "op": wl.op, "n": wl.n,
                         "batch": wl.batch, "dtype": wl.dtype,
                         "variant": wl.variant},
            "objective": objective.signature(),
            # device the times were measured on (None for objectives
            # that carry no hardware model, e.g. wallclock runners)
            "profile": getattr(getattr(objective, "spec", None),
                               "name", None),
            "space_size": space_size,
            "pruned": int(pruned)}


def append_journal_lines(path: str, lines) -> None:
    """Crash-tolerant JSONL append: the one sanctioned way to extend a
    journal or trace file.

    The whole payload goes through a single ``os.write`` on an
    ``O_APPEND`` descriptor, so concurrent writers never interleave
    mid-line and a killed writer leaves at most one torn trailing line —
    which every loader skips.  If a previous writer died mid-line, the
    torn tail is terminated first so none of this payload's records are
    glued onto it.
    """
    payload = "".join(line + "\n" for line in lines).encode()
    if not payload:
        return
    if _tail_torn(path):
        # appending directly would glue our first record onto the torn
        # bytes and lose BOTH lines to the json parse
        payload = b"\n" + payload
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, payload)
    finally:
        os.close(fd)


def _tail_torn(path: str) -> bool:
    """True when the file ends mid-line (a writer was killed inside its
    os.write) — the next append must not extend that line."""
    try:
        with open(path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            return f.read(1) != b"\n"
    except (OSError, ValueError):   # absent or empty file
        return False


def config_key(cfg: Config) -> str:
    """Canonical, order-independent identity of a config inside one space."""
    return ",".join(f"{k}={cfg[k]}" for k in sorted(cfg))


def _safe(token: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.=-]+", "_", token)


def journal_path(journal_dir: str, wl: Workload, objective: Objective) -> str:
    """Per-(workload, objective) journal file inside ``journal_dir``."""
    return os.path.join(journal_dir,
                        f"{_safe(wl.key)}__{_safe(objective.signature())}.jsonl")


class SweepJournal:
    """Append-only JSONL checkpoint for one (workload, objective) sweep.

    Line 1 is a header carrying the workload fields and the objective
    signature; every subsequent line is one completed evaluation.  Appends
    go through a single ``os.write`` on an ``O_APPEND`` descriptor per
    chunk, so a killed sweep leaves at most one torn trailing line — which
    ``load`` skips — and concurrent writers never interleave mid-line.
    """

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def for_workload(cls, journal_dir: str, wl: Workload,
                     objective: Objective) -> "SweepJournal":
        os.makedirs(journal_dir, exist_ok=True)
        return cls(journal_path(journal_dir, wl, objective))

    # -- reading ------------------------------------------------------------

    def load(self, wl: Optional[Workload] = None,
             objective: Optional[Objective] = None) -> Dict[str, float]:
        """Completed {config_key: time_s}; {} when the journal is absent.

        When ``wl``/``objective`` are given, a header that does not match
        raises — silently resuming someone else's numbers would corrupt
        the optimum.
        """
        return {k: vec[METRIC_TIME]
                for k, vec in self.load_metrics(wl, objective).items()}

    def load_metrics(self, wl: Optional[Workload] = None,
                     objective: Optional[Objective] = None
                     ) -> Dict[str, Dict[str, float]]:
        """Completed {config_key: metric vector}; {} when absent.

        Version-3 entries carry their vector in ``"m"``; older entries
        (and v3 entries from time-only objectives) load as
        ``{"time_s": t}`` — the documented migration for pre-vector
        journals.  Header validation matches ``load``.
        """
        if not os.path.exists(self.path):
            return {}
        done: Dict[str, Dict[str, float]] = {}
        header_ok = False
        with open(self.path, "r") as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue     # torn trailing line from a killed run
                if not isinstance(rec, dict):
                    continue     # parseable but not a record (e.g. "123")
                if i == 0 and rec.get("kind") == "header":
                    self._check_header(rec, wl, objective)
                    header_ok = True
                    continue
                if "k" in rec and "t" in rec:
                    vec = {n: float(v) for n, v in rec["m"].items()} \
                        if isinstance(rec.get("m"), dict) else {}
                    vec[METRIC_TIME] = float(rec["t"])
                    done[rec["k"]] = vec
        if not header_ok and (wl is not None or objective is not None):
            # a torn/missing header means the entries cannot be validated
            # against this (workload, objective) — never resume them.
            # Quarantine the bytes and let the sweep start a fresh journal.
            self._quarantine()
            return {}
        return done

    def read_header(self) -> Optional[Dict]:
        if not os.path.exists(self.path):
            return None
        with open(self.path, "r") as f:
            first = f.readline().strip()
        if not first:
            return None
        try:
            rec = json.loads(first)
        except json.JSONDecodeError:
            return None
        return rec if isinstance(rec, dict) and rec.get("kind") == "header" \
            else None

    def entries(self) -> List[Tuple[Config, float]]:
        """Completed (config, time) pairs, first-completion order.

        Deduplicated by config (last line wins, matching ``load``):
        concurrent writers that both loaded before either appended can
        legally write the same config twice.
        """
        return [(cfg, vec[METRIC_TIME]) for cfg, vec in self.metric_entries()]

    def metric_entries(self) -> List[Tuple[Config, Dict[str, float]]]:
        """Completed (config, metric-vector) pairs, first-completion order.

        Same dedup semantics as ``entries``; pre-v3 entries come back as
        ``time_s``-only vectors.
        """
        if not os.path.exists(self.path):
            return []
        seen: Dict[str, int] = {}
        out: List[Tuple[Config, Dict[str, float]]] = []
        with open(self.path, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if not isinstance(rec, dict) or rec.get("kind") == "header" \
                        or "cfg" not in rec:
                    continue
                cfg = {k: int(v) for k, v in rec["cfg"].items()}
                key = config_key(cfg)
                vec = {n: float(v) for n, v in rec["m"].items()} \
                    if isinstance(rec.get("m"), dict) else {}
                vec[METRIC_TIME] = float(rec["t"])
                pair = (cfg, vec)
                if key in seen:
                    out[seen[key]] = pair
                else:
                    seen[key] = len(out)
                    out.append(pair)
        return out

    @staticmethod
    def _check_header(rec: Dict, wl: Optional[Workload],
                      objective: Optional[Objective]) -> None:
        if wl is not None and rec.get("workload", {}).get("key") != wl.key:
            raise ValueError(
                f"sweep journal is for workload "
                f"{rec.get('workload', {}).get('key')!r}, not {wl.key!r}")
        if objective is not None and rec.get("objective") != objective.signature():
            raise ValueError(
                f"sweep journal was measured with objective "
                f"{rec.get('objective')!r}, not {objective.signature()!r}")
        if objective is not None and rec.get("profile") is not None:
            want = getattr(getattr(objective, "spec", None), "name", None)
            if want is not None and rec["profile"] != want:
                raise ValueError(
                    f"sweep journal was measured on profile "
                    f"{rec.get('profile')!r}, not {want!r}")

    # -- writing ------------------------------------------------------------

    def _quarantine(self) -> None:
        """Set a corrupt journal aside (bytes preserved for post-mortem)."""
        target = self.path + ".corrupt"
        try:
            os.replace(self.path, target)
        except OSError:
            os.unlink(self.path)

    def _ensure_header(self, wl: Workload, objective: Objective,
                       space_size: int, pruned: int = 0) -> None:
        if os.path.exists(self.path) and os.path.getsize(self.path):
            if self.read_header() is not None:
                return
            # non-empty but headerless (e.g. the very first os.write was
            # torn): unusable — quarantine and re-journal from scratch
            self._quarantine()
        header = make_header(wl, objective, space_size, pruned)
        self._append_lines([json.dumps(header, sort_keys=True)])

    def append(self, wl: Workload, objective: Objective, space_size: int,
               entries: Sequence[Tuple], pruned: int = 0) -> None:
        """Append completed evaluations: ``(config, time)`` pairs, or
        ``(config, time, metric_vector)`` triples (the vector is written as
        ``"m"`` minus the redundant ``time_s`` mirror)."""
        self._ensure_header(wl, objective, space_size, pruned)
        self._append_lines(self._entry_line(*entry) for entry in entries)

    @staticmethod
    def _entry_line(cfg: Config, t: float, metrics=None) -> str:
        rec = {"k": config_key(cfg), "cfg": cfg, "t": float(t)}
        vec = {n: float(v) for n, v in (metrics or {}).items()
               if n != METRIC_TIME}
        if vec:
            rec["m"] = vec
        return json.dumps(rec, sort_keys=True)

    def _append_lines(self, lines) -> None:
        append_journal_lines(self.path, lines)


# ---------------------------------------------------------------------------
# Pruning
# ---------------------------------------------------------------------------

def prune_candidates(space: SearchSpace, cands: List[Config],
                     top_k: int) -> Tuple[List[Config], int]:
    """Keep the ``top_k`` analytically-ranked candidates, enumeration order.

    The expert model ranks for free (no objective evaluations); measuring
    only its favourites is the Prajapati-style "rank before you measure"
    lever for objectives where every evaluation is minutes of wall clock.
    """
    if top_k >= len(cands):
        return cands, 0
    from repro_torch.core.analytical import score
    order = sorted(range(len(cands)),
                   key=lambda i: score(space, cands[i]).key(), reverse=True)
    kept_idx = sorted(order[:top_k])          # preserve enumeration order
    return [cands[i] for i in kept_idx], len(cands) - top_k


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SweepResult:
    best_config: Config
    best_time: float                     # winner's measured seconds
    evaluations: int                     # fresh objective evaluations
    resumed: int                         # configs answered by the journal
    pruned: int                          # candidates dropped before measuring
    total: int                           # candidates actually swept
    history: List[Tuple[Config, float]]  # enumeration order, penalty-clamped
    stopped_by: str                      # "exhausted" | "pruned"
    journal: Optional[str] = None        # journal path, when journaled
    metrics: Optional[Dict[str, np.ndarray]] = None  # columns over history
    pareto: Tuple = ()                   # non-dominated (config, vector)s
    policy: Optional[str] = None         # policy key the winner was picked by
    best_scalar: Optional[float] = None  # winner's policy scalar

    def as_tune_result(self) -> TuneResult:
        # under a policy, the quantity the search minimized (and therefore
        # reports as best/history values) is the policy scalar
        if self.policy is not None and self.metrics is not None:
            pol = get_policy(self.policy)
            scal = policy_scalar_cols(pol, self.metrics)
            history = list(zip((c for c, _ in self.history), scal.tolist()))
            return TuneResult(self.best_config, float(self.best_scalar),
                              self.evaluations + self.resumed, history,
                              self.stopped_by)
        return TuneResult(self.best_config, self.best_time,
                          self.evaluations + self.resumed, self.history,
                          self.stopped_by)


def run_sweep(space: SearchSpace, objective: Objective, *,
              journal: Optional[SweepJournal] = None,
              prune: Optional[str] = None, top_k: Optional[int] = None,
              chunk: int = 1024,
              policy: Union[str, Policy, None] = None) -> SweepResult:
    """Evaluate the (optionally pruned) valid space; resume from ``journal``.

    Evaluation happens in ``chunk``-sized batches through
    ``objective.batch_eval_metrics``; each completed chunk is journaled
    (full metric vectors) before the next starts, so an interrupted sweep
    re-run skips everything already measured and still returns the
    identical winner.  The result carries the Pareto front over the
    objective's metric axes; ``policy`` picks the winner from it (default
    ``latency`` — identical behavior and numbers as the scalar-era sweep).

    Pruning is ranked by the latency-shaped analytical model, so it
    composes only with policies declared ``prune_safe`` — any other
    combination raises instead of optimizing the wrong subset.
    """
    wl = space.workload
    pol = None
    if policy is not None:
        pol = get_policy(policy, getattr(objective, "spec", None))
        if pol.name == "latency":
            pol = None
    if prune is not None and pol is not None and not pol.prune_safe:
        raise ValueError(
            f"prune={prune!r} ranks candidates by latency and cannot vouch "
            f"for policy {pol.key!r}; sweep unpruned and pick from the "
            f"Pareto front instead")
    cands = space.enumerate_valid()
    if not cands:
        raise ValueError(f"empty search space for {wl.key}")
    full_size = len(cands)

    pruned = 0
    if prune is not None:
        if prune != "analytical":
            raise ValueError(f"unknown prune mode {prune!r}; "
                             f"supported: 'analytical'")
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        cands, pruned = prune_candidates(
            space, cands, top_k if top_k is not None else DEFAULT_TOP_K)

    names = objective.metric_names()
    cols = {n: np.full(len(cands), np.nan) for n in names}
    times = cols[METRIC_TIME]
    resumed = 0
    if journal is not None:
        done = journal.load_metrics(wl, objective)
        pending: List[int] = []
        for i, cand in enumerate(cands):
            vec = done.get(config_key(cand)) if done else None
            if vec is None:
                pending.append(i)
            else:
                # axes a pre-vector journal did not record stay NaN; the
                # policy scalarization falls back to time for those rows
                for n in names:
                    if n in vec:
                        cols[n][i] = vec[n]
                resumed += 1
    else:
        pending = list(range(len(cands)))

    chunk = max(int(chunk), 1)
    for lo in range(0, len(pending), chunk):
        idx = pending[lo: lo + chunk]
        mcols = objective.batch_eval_metrics(space, [cands[i] for i in idx],
                                             assume_valid=True)
        for n in names:
            cols[n][idx] = mcols[n]
        if journal is not None:
            journal.append(
                wl, objective, full_size,
                [(cands[i], float(mcols[METRIC_TIME][j]),
                  {n: float(mcols[n][j]) for n in names})
                 for j, i in enumerate(idx)],
                pruned=pruned)

    if pol is not None:
        scal = policy_scalar_cols(pol, cols)
        best_i = int(np.argmin(scal))
        best_scalar = float(scal[best_i])
    else:
        best_i = int(np.argmin(times))
        best_scalar = None
    return SweepResult(
        best_config=cands[best_i],
        best_time=float(times[best_i]),
        evaluations=len(pending),
        resumed=resumed,
        pruned=pruned,
        total=len(cands),
        history=list(zip(cands, times.tolist())),
        stopped_by="pruned" if pruned else "exhausted",
        journal=journal.path if journal is not None else None,
        metrics=cols,
        pareto=_sweep_front(cols, cands, names),
        policy=pol.key if pol is not None else None,
        best_scalar=best_scalar,
    )


def _sweep_front(cols: Dict[str, np.ndarray], cands: List[Config],
                 names: Sequence[str]) -> Tuple:
    """Pareto front over the swept columns; rows with unrecorded axes
    (pre-vector journal resumes) count as worst-possible on those axes."""
    filled = {n: np.nan_to_num(cols[n], nan=np.inf) for n in names}
    filled[METRIC_TIME] = cols[METRIC_TIME]
    return pareto_front(filled, cands, names)
