"""Transfer tuning: cross-size AND cross-device warm-starting (paper §IV-B).

The paper uses GPTune, whose Linear Coregionalization Model shares a
surrogate ACROSS tasks (problem sizes), so tuning size N starts from what
sizes N/2 and 2N already taught it. We reproduce the effect with a
transfer-GP: prior observations from neighbouring workloads enter the
training set with a task-distance kernel weight, and the acquisition is
optimized as usual. The practical win mirrors the paper's online story —
amortizing evaluations across repeated invocations of a routine family.

Task encoding: log2(N) normalized over the family's size range; the task
kernel is RBF over that coordinate, so closer sizes transfer more.

With the hardware-profile subsystem the module also earns its name
cross-*device* (Xue & Roy's cross-GPU CFD result): sweep
journals recorded on device A become prior histories for device B's
search. Absolute seconds do not transfer between machines, so each source
journal is normalized to per-journal *slowdowns* (t / min t — the
scale-free ranking), then reweighted by profile distance: slowdowns are
flattened toward 1.0 by ``exp(-profile_distance(src, dst))``, so a near
twin transfers its full ranking while a wildly different device
contributes almost nothing. ``transfer_seed`` drives a whole session from
foreign journals; ``transfer_strategy`` is the same path registered as
``strategy="transfer"``.

Histories from a different op family are rejected: the task kernel only
sees log2(N), so an FFT history at the same N would silently pollute a
scan search (regression-tested).

The PyTorch port's own copy of ``repro.core.transfer``, on the port's
copy of the GP: the same journals give the same priors, the same visited
configs and the same winner in both packages.  A wall-clock journal names
no profile in its header, so it is never a transfer source; on the card
the foreign evidence is the cost-model journals of other profiles
(``compare_methods_matrix`` writes them).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.bayesian import GP, TuneResult, expected_improvement
from repro_torch.core.objective import Objective, PENALTY_TIME
from repro_torch.core.space import Config, SearchSpace, Workload, build_space
from repro_torch.hw.profiles import (HardwareProfile, get_profile,
                                    profile_distance)

# ops that share one kernel family (and therefore one knob semantics); a
# history transfers inside a family, never across families
_FAMILY_POOL = {"ssd": "scan", "rglru": "scan"}


def op_family(op: str) -> str:
    return _FAMILY_POOL.get(op, op)


@dataclasses.dataclass
class TaskHistory:
    workload: Workload
    configs: List[Config]
    times: List[float]


class TransferBayesianTuner:
    """BO with cross-size transfer. `histories` hold (workload, config,
    time) observations from already-tuned sizes of the same op family."""

    name = "transfer"

    def __init__(self, n_init: int = 2, patience: int = 5, max_evals: int = 64,
                 seed: int = 0, task_lengthscale: float = 0.75):
        self.n_init = n_init
        self.patience = patience
        self.max_evals = max_evals
        self.seed = seed
        self.task_ls = task_lengthscale

    def _task_coord(self, wl: Workload) -> float:
        return math.log2(max(wl.n, 1)) / 24.0

    def tune(self, space: SearchSpace, objective: Objective,
             histories: Sequence[TaskHistory] = ()) -> TuneResult:
        rng = np.random.default_rng(self.seed)
        candidates = space.enumerate_valid()
        if not candidates:
            raise ValueError("empty space")
        # family guard: the task kernel only sees log2(N) — an FFT history
        # at the same N would otherwise enter a scan search's prior with
        # full weight and steer the bootstrap toward foreign-knob optima
        fam = op_family(space.workload.op)
        histories = [h for h in histories
                     if op_family(h.workload.op) == fam]
        enc = np.array([space.encode(c) for c in candidates])
        t_here = self._task_coord(space.workload)
        enc_aug = np.concatenate(
            [enc, np.full((len(enc), 1), 0.0)], axis=1)  # task delta 0

        # transfer set: neighbour observations, with their encoded config in
        # THIS space's coordinates when compatible, plus task-delta feature
        xs_prior: List[np.ndarray] = []
        ys_prior: List[float] = []
        for hist in histories:
            dt = (self._task_coord(hist.workload) - t_here) / self.task_ls
            for cfg, t in zip(hist.configs, hist.times):
                try:
                    x = space.encode({k: cfg.get(k, 0) for k in
                                      [p.name for p in space.params]})
                except Exception:
                    continue
                xs_prior.append(np.array(x + [dt]))
                ys_prior.append(t)

        history: List[Tuple[Config, float]] = []
        evaluated: Dict[int, float] = {}

        def measure(idx: int) -> float:
            m = objective(space, candidates[idx])
            t = m.time_s if m.valid else PENALTY_TIME
            evaluated[idx] = t
            history.append((candidates[idx], t))
            return t

        # warm bootstrap: rank candidates by the transfer-GP posterior mean
        # (zero fresh evaluations spent on ranking)
        order = rng.permutation(len(candidates))
        if xs_prior:
            gp0 = GP(lengthscale=0.5).fit(np.array(xs_prior),
                                          np.log(np.array(ys_prior)))
            mu0, _ = gp0.predict(enc_aug)
            order = np.argsort(mu0)      # most promising first
        for idx in order[: min(self.n_init, len(candidates))]:
            measure(int(idx))

        best_idx = min(evaluated, key=evaluated.get)
        best_t = evaluated[best_idx]
        since = 0
        stopped = "exhausted"
        while len(evaluated) < min(self.max_evals, len(candidates)):
            if since >= self.patience:
                stopped = "sliding_window"
                break
            xs = [list(enc[i]) + [0.0] for i in evaluated]
            ys = list(np.log(np.array(list(evaluated.values()))))
            xs_all = np.array(xs_prior + [np.array(x) for x in xs]) \
                if xs_prior else np.array(xs)
            ys_log_prior = [float(v) for v in np.log(np.asarray(ys_prior))] \
                if ys_prior else []
            ys_all = ys_log_prior + ys
            gp = GP(lengthscale=0.5).fit(np.asarray(xs_all, float),
                                         np.asarray(ys_all, float))
            remaining = [i for i in range(len(candidates))
                         if i not in evaluated]
            mu, sigma = gp.predict(enc_aug[remaining])
            ei = expected_improvement(mu, sigma, math.log(best_t))
            pick = remaining[int(np.argmax(ei))]
            t = measure(pick)
            if t < best_t * (1 - 1e-9):
                best_t, best_idx = t, pick
                since = 0
            else:
                since += 1
        else:
            # same semantics as BayesianTuner: "max_evals" when the budget
            # bound, "exhausted" only when the space truly ran out
            stopped = "max_evals" if len(evaluated) >= self.max_evals \
                else "exhausted"
        return TuneResult(candidates[best_idx], best_t, len(evaluated),
                          history, stopped)


# ---------------------------------------------------------------------------
# Cross-device transfer (profile-distance-weighted journal seeding)
# ---------------------------------------------------------------------------

def _journal_profile(header: Dict) -> Optional[str]:
    """Source profile of a journal: the v2 header field, else parsed from
    the legacy cost-model signature ("tpu_cost:<name>:noise=...")."""
    name = header.get("profile")
    if name:
        return str(name)
    sig = str(header.get("objective", ""))
    parts = sig.split(":")
    if len(parts) >= 3 and parts[0] in ("tpu_cost", "cost"):
        return parts[1]
    return None


def _journal_workload(header: Dict) -> Optional[Workload]:
    wl = header.get("workload") or {}
    try:
        return Workload(op=wl["op"], n=int(wl["n"]),
                        batch=int(wl.get("batch", 1)),
                        dtype=wl.get("dtype", "float32"),
                        variant=wl.get("variant", ""))
    except (KeyError, TypeError, ValueError):
        return None


def journal_history(path: str, target: HardwareProfile
                    ) -> Optional[Tuple[TaskHistory, float]]:
    """One journal -> (profile-distance-reweighted TaskHistory, weight).

    Times become per-journal slowdowns (t / min t) flattened toward 1.0 by
    ``w = exp(-profile_distance(src, target))``: the scale-free ranking of
    a close device transfers almost fully; a distant one barely at all.
    Returns None for unreadable journals, unknown source profiles, or
    journals measured on ``target`` itself (those are resumable directly —
    nothing to transfer).
    """
    from repro_torch.tuning.sweep import SweepJournal

    j = SweepJournal(path)
    header = j.read_header()
    if header is None:
        return None
    src_name = _journal_profile(header)
    wl = _journal_workload(header)
    if src_name is None or wl is None or src_name == target.name:
        return None
    try:
        src = get_profile(src_name)
    except ValueError:
        return None
    entries = [(c, t) for c, t in j.entries() if t < PENALTY_TIME]
    if not entries:
        return None
    tmin = min(t for _, t in entries)
    w = math.exp(-profile_distance(src, target))
    hist = TaskHistory(
        wl, [c for c, _ in entries],
        [1.0 + (t / tmin - 1.0) * w for _, t in entries])
    return hist, w


def device_histories(journal_dir: str, wl: Workload,
                     target: HardwareProfile) -> List[TaskHistory]:
    """Other devices' sweep histories for ``wl``, reweighted for ``target``.

    Scans ``journal_dir`` for journals of the same workload recorded under
    a different profile (the per-(workload, objective) file naming makes
    them coexist in one directory).
    """
    from repro_torch.tuning.sweep import _safe

    if not journal_dir or not os.path.isdir(journal_dir):
        return []
    prefix = _safe(wl.key) + "__"
    out: List[TaskHistory] = []
    for name in sorted(os.listdir(journal_dir)):
        if not (name.startswith(prefix) and name.endswith(".jsonl")):
            continue
        got = journal_history(os.path.join(journal_dir, name), target)
        if got is None:
            continue
        hist, _ = got
        if hist.workload.key == wl.key:
            out.append(hist)
    return out


def transfer_strategy(space: SearchSpace, objective: Objective, *,
                      seed: int = 0, max_evals: int = 64,
                      journal_dir: Optional[str] = None) -> TuneResult:
    """``strategy="transfer"``: warm-start from other devices' journals.

    With no journal directory (or no foreign journals in it) this is a
    cold Bayesian search — the strategy degrades, it never fails.
    """
    histories: Sequence[TaskHistory] = ()
    if journal_dir:
        histories = device_histories(journal_dir, space.workload, space.spec)
    return TransferBayesianTuner(seed=seed, max_evals=max_evals).tune(
        space, objective, histories)


def transfer_seed(session, journals, *, max_evals: int = 16, seed: int = 0,
                  store: bool = True) -> Dict[str, TuneResult]:
    """Warm-start ``session``'s device from another device's sweep journals.

    ``journals`` is an iterable of journal paths and/or directories (a
    directory contributes every ``*.jsonl`` inside). For each foreign
    journal the workload is rebuilt from its header, the recorded sweep
    becomes a profile-distance-weighted prior, and a short transfer search
    runs on the session's profile; winners land in the session's TuningDB
    under ``method="transfer"``. Returns ``{workload key: TuneResult}``.
    """
    from repro_torch.core.objective import CachedObjective, CostModelObjective
    from repro_torch.tuning.sweep import SweepJournal

    paths: List[str] = []
    for j in journals:
        if os.path.isdir(j):
            paths.extend(os.path.join(j, n) for n in sorted(os.listdir(j))
                         if n.endswith(".jsonl"))
        else:
            paths.append(j)

    out: Dict[str, TuneResult] = {}
    for path in paths:
        header = SweepJournal(path).read_header()
        wl = _journal_workload(header) if header else None
        if wl is None:
            continue
        got = journal_history(path, session.spec)
        if got is None:
            continue
        hist, _ = got
        space = build_space(wl, session.spec)
        cached = CachedObjective(CostModelObjective(session.spec))
        res = TransferBayesianTuner(seed=seed, max_evals=max_evals).tune(
            space, cached, (hist,))
        if store:
            session.db.store(wl, res.best_config, res.best_time, "transfer",
                             res.evaluations)
            session.invalidate(wl)
        out[wl.key] = res
    return out


def tune_family(op: str, variant: str, sizes: Sequence[int],
                batch_of, objective_factory, seed: int = 0
                ) -> Dict[int, TuneResult]:
    """Tune a family of sizes in order, transferring histories forward —
    the amortized online flow the paper describes for iterative callers."""
    histories: List[TaskHistory] = []
    out: Dict[int, TuneResult] = {}
    for n in sizes:
        wl = Workload(op=op, n=n, batch=batch_of(n), variant=variant)
        space = build_space(wl)
        tuner = TransferBayesianTuner(seed=seed)
        res = tuner.tune(space, objective_factory(), histories)
        out[n] = res
        histories.append(TaskHistory(
            wl, [c for c, _ in res.history], [t for _, t in res.history]))
    return out
