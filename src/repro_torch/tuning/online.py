"""Online tuning: in-traffic measurement, safe trial/rollback, promotion.

The paper's closing guidance splits deployment into *offline* tuning (the
session/strategy stack) and *online* tuning: refining the
config while real traffic flows, paying for measurements with production
steps instead of a dedicated sweep.  This module is the online half:

  * :class:`OnlineTuner` wraps a :class:`~repro_torch.tuning.session.TunerSession`
    and starts from the session's prior (TuningDB hit, else the
    analytical/ML suggestion — zero evaluations, the paper's cold-start).
  * Candidate configs are trialed *in traffic*: while a trial is active the
    serving path runs the candidate, and every step's wall-clock latency
    feeds a per-config EWMA (outlier-clipped, so one GC pause cannot
    promote or kill a config).
  * A strict **measurement budget** bounds how many production steps are
    ever spent on non-incumbent configs, and a **guard band** bounds how
    bad a trial may look before it is rolled back: a trial whose EWMA
    exceeds ``incumbent * (1 + guard_band)`` is abandoned the moment it has
    enough samples to be believed.  The guard band generalizes to a
    **power envelope** (``power_envelope=``): a candidate whose
    *model-predicted* average draw (``energy_j / time_s`` from the cost
    model's metric vector) exceeds the
    incumbent's modeled draw times the envelope is vetoed before it ever
    serves a production step.  Off by default; latency behavior is
    unchanged when disabled.
  * Winners are **promoted**: persisted to the TuningDB (``method="online"``
    — deliberately outside the ``dataset_from_db`` exhaustive allowlist,
    a traffic winner is not a guaranteed optimum) and journaled to the
    sweep-journal format, so completed spaces of production measurements
    feed the ML dataset exactly like offline sweeps (Schoonhoven et al.'s
    model-prior + few-live-measurements hybrid).  The journal path and
    header are JAX's for the same workload, so online journals read
    across the packages in both directions.

Trial lifecycle (exposed via :attr:`TrialRecord.state` and, in the final
:class:`~repro_torch.core.bayesian.TuneResult`, via ``stopped_by`` — the same
truthful-semantics contract of the offline strategies)::

    trialing ──(EWMA < incumbent after samples_per_trial)──> incumbent
        └─────(EWMA > guard band, or loses the decision)──> rolled_back

``replay`` drives the same state machine deterministically from a recorded
:class:`ReplayTrace` (the ``tune.py online-replay`` subcommand), which is
how the convergence/rollback behavior is tested without a live engine.

The PyTorch port's own copy of ``repro.tuning.online``: the state machine
is the same Python over floats, so the same sequence of ``observe`` calls
gives the same trials, states, promotions and ``stopped_by``.  The
port has no ``core/policy.py`` yet: ``online_search(policy=...)`` takes
``None`` or ``"latency"`` and raises ``NotImplementedError`` for the rest.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

from repro_torch.core.analytical import AnalyticalTuner, score
from repro_torch.core.bayesian import TuneResult
from repro_torch.core.objective import Measurement, Objective, PENALTY_TIME
from repro_torch.core.space import Config, SearchSpace, Workload, build_space
from repro_torch.tuning.sweep import (SweepJournal, append_journal_lines,
                                config_key)

# A StepTimer is any zero-arg callable returning monotonic seconds —
# ``time.perf_counter`` in production, a fake clock in tests.  The serving
# engine takes one per instance so step timings are injectable end to end.
StepTimer = Callable[[], float]

TRACE_VERSION = 1

# trial / incumbent states (TrialRecord.state)
TRIALING = "trialing"
INCUMBENT = "incumbent"
ROLLED_BACK = "rolled_back"
SUPERSEDED = "superseded"     # an incumbent a promoted trial replaced


class EwmaTracker:
    """Outlier-clipped exponentially-weighted moving average of latencies.

    A sample more than ``clip``x the current EWMA is clipped to that bound
    before mixing: host jitter (GC, preemption) shifts the estimate by at
    most a bounded factor per step instead of swamping it.  ``alpha``
    defaults to 0.25 so a config's EWMA converges in a handful of steps
    but a single sample never dominates.
    """

    def __init__(self, alpha: float = 0.25, clip: float = 4.0,
                 hint: Optional[float] = None):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if clip <= 1.0:
            raise ValueError(f"clip must be > 1, got {clip}")
        self.alpha = alpha
        self.clip = clip
        # baseline for clipping the FIRST sample (a trial tracker gets the
        # incumbent's EWMA): without it a single startup spike would seed
        # the estimate unclipped and kill a genuinely good config
        self.hint = hint
        self.value: Optional[float] = None
        self.samples = 0
        self.clipped = 0

    def observe(self, dt: float) -> float:
        dt = float(dt)
        if self.value is None:
            if self.hint is not None and dt > self.clip * self.hint:
                # a first sample implausibly worse than the baseline is a
                # measurement artifact, not signal: discard it to the
                # baseline so it cannot seed (and doom) the estimate —
                # genuinely-slow configs re-assert themselves immediately
                dt = self.hint
                self.clipped += 1
            self.value = dt
        else:
            bound = self.clip * self.value
            if dt > bound:
                dt = bound
                self.clipped += 1
            self.value = (1.0 - self.alpha) * self.value + self.alpha * dt
        self.samples += 1
        return self.value


@dataclasses.dataclass
class TrialRecord:
    """One config's life in traffic: its EWMA, sample count, and fate."""

    config: Config
    tracker: EwmaTracker
    state: str = TRIALING
    baseline: Optional[float] = None   # incumbent EWMA when the trial ended

    @property
    def key(self) -> str:
        return config_key(self.config)

    @property
    def ewma(self) -> Optional[float]:
        return self.tracker.value

    @property
    def samples(self) -> int:
        return self.tracker.samples


class OnlineWallClockObjective(Objective):
    """Objective view of recorded in-traffic step timings.

    Answers from a mapping ``config_key -> [step seconds]`` (a
    :class:`ReplayTrace` or an OnlineTuner's measurement log) with the
    median recorded time; configs never measured in traffic get the
    penalty clamp, exactly like an invalid offline configuration.  This is
    the objective identity under which online measurements are journaled —
    its ``signature`` carries the traffic source so an online journal can
    never be resumed as (or by) a cost-model sweep.
    """

    def __init__(self, times: Mapping[str, Sequence[float]],
                 source: str = "trace"):
        self.times = {k: list(v) for k, v in times.items()}
        self.source = source

    def __call__(self, space: SearchSpace, cfg: Config) -> Measurement:
        if not space.is_valid(cfg):
            return Measurement(PENALTY_TIME, False)
        ts = self.times.get(config_key(cfg))
        if not ts:
            return Measurement(PENALTY_TIME, False)
        ordered = sorted(float(t) for t in ts)
        return Measurement(ordered[len(ordered) // 2], True,
                           meta={"samples": float(len(ordered))})

    def signature(self) -> str:
        return f"online_wallclock:{self.source}"


# ---------------------------------------------------------------------------
# Recorded traces (deterministic replay)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReplayTrace:
    """Per-config step-latency sequences recorded from live traffic.

    JSONL on disk: a header line (workload + source), then one record per
    timed step ``{"k": <config_key>, "cfg": {...}, "t": seconds}`` in
    arrival order.  Loading tolerates a torn trailing line (a recorder
    killed mid-append), mirroring the sweep-journal contract.
    """

    workload: Workload
    source: str = "trace"
    times: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    configs: Dict[str, Config] = dataclasses.field(default_factory=dict)

    def add(self, cfg: Config, t: float) -> None:
        key = config_key(cfg)
        self.configs.setdefault(key, dict(cfg))
        self.times.setdefault(key, []).append(float(t))

    def steps(self) -> int:
        return sum(len(v) for v in self.times.values())

    def objective(self) -> OnlineWallClockObjective:
        return OnlineWallClockObjective(self.times, source=self.source)

    def save(self, path: str) -> str:
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        wl = self.workload
        with open(path, "w") as f:
            f.write(json.dumps(
                {"kind": "header", "version": TRACE_VERSION,
                 "source": self.source,
                 "workload": {"op": wl.op, "n": wl.n, "batch": wl.batch,
                              "dtype": wl.dtype, "variant": wl.variant}},
                sort_keys=True) + "\n")
            for key, ts in self.times.items():
                cfg = self.configs[key]
                for t in ts:
                    f.write(json.dumps({"k": key, "cfg": cfg, "t": t},
                                       sort_keys=True) + "\n")
        return path

    @classmethod
    def load(cls, path: str) -> "ReplayTrace":
        wl: Optional[Workload] = None
        source = "trace"
        trace: Optional[ReplayTrace] = None
        with open(path, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue                      # torn trailing line
                if not isinstance(rec, dict):
                    continue                      # parseable but not a record
                if rec.get("kind") == "header":
                    if trace is not None:
                        # e.g. two recording sessions cat'ed together:
                        # silently resetting would replay half the data
                        raise ValueError(
                            f"trace {path!r} contains multiple headers — "
                            f"replay one recording session at a time")
                    w = rec.get("workload", {})
                    wl = Workload(op=w["op"], n=int(w["n"]),
                                  batch=int(w.get("batch", 1)),
                                  dtype=w.get("dtype", "float32"),
                                  variant=w.get("variant", ""))
                    source = rec.get("source", "trace")
                    trace = cls(wl, source=source)
                    continue
                if trace is None:
                    raise ValueError(f"trace {path!r} has no header line")
                if "cfg" in rec and "t" in rec:
                    trace.add({k: int(v) for k, v in rec["cfg"].items()},
                              float(rec["t"]))
        if trace is None:
            raise ValueError(f"trace {path!r} is empty")
        return trace


class TraceRecorder:
    """Appends (config, step latency) records to a trace file as they
    happen — crash-tolerant (every record is one line; a torn tail is
    skipped by :meth:`ReplayTrace.load`)."""

    def __init__(self, path: str, wl: Workload, source: str = "serve"):
        self.path = path
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        with open(path, "w") as f:
            f.write(json.dumps(
                {"kind": "header", "version": TRACE_VERSION, "source": source,
                 "workload": {"op": wl.op, "n": wl.n, "batch": wl.batch,
                              "dtype": wl.dtype, "variant": wl.variant}},
                sort_keys=True) + "\n")
        self.records = 0

    def add(self, cfg: Config, t: float) -> None:
        line = json.dumps({"k": config_key(cfg), "cfg": dict(cfg),
                           "t": float(t)}, sort_keys=True)
        # the sweep journal's O_APPEND helper: a single unbuffered write
        # per record, so a recorder killed mid-append leaves one torn line
        # (skipped by load) instead of a buffered multi-line tear, and
        # concurrent recorders never interleave mid-line
        append_journal_lines(self.path, [line])
        self.records += 1


# ---------------------------------------------------------------------------
# The online tuner
# ---------------------------------------------------------------------------

def ranked_candidates(space: SearchSpace, top_k: int,
                      exclude: Iterable[str] = ()) -> List[Config]:
    """Top-``top_k`` candidates by the zero-evaluation analytical rank.

    The expert model orders the trial queue for free, so the measurement
    budget is spent where the model expects wins first — the same
    "rank before you measure" lever as ``prune='analytical'`` offline.
    """
    skip = set(exclude)
    cands = [c for c in space.enumerate_valid() if config_key(c) not in skip]
    order = sorted(range(len(cands)),
                   key=lambda i: score(space, cands[i]).key(), reverse=True)
    return [cands[i] for i in order[:max(top_k, 0)]]


def replay_candidates(space: SearchSpace, trace: ReplayTrace,
                      prior: Config) -> List[Config]:
    """Every recorded config except the prior, expert-ranked, untruncated.

    Replay must be able to trial exactly what the traffic measured: a
    recorded config with a poor analytical rank (a DB-sourced production
    incumbent, say) still belongs in the queue — ranking orders the
    recorded set, it never filters it.  Configs no longer valid in the
    current space are dropped (they could not be applied anyway).
    """
    pk = config_key(prior)
    recorded = [cfg for key, cfg in trace.configs.items()
                if key != pk and space.is_valid(cfg)]
    return sorted(recorded, key=lambda c: score(space, c).key(),
                  reverse=True)


class OnlineTuner:
    """Trial/rollback state machine fed by in-traffic step timings.

    Feed it one wall-clock duration per serving step via :meth:`observe`;
    read the config the *next* step should run via :meth:`config` (raw
    knobs — the session normalizer fits them at resolve time).  The tuner
    never runs anything itself, so the same object serves a live engine
    (see :func:`attach`), a deterministic trace replay (:func:`replay`),
    and the ``strategy="online"`` simulation (:func:`online_search`).
    """

    def __init__(self, wl: Workload, session=None, *,
                 prior: Optional[Config] = None,
                 candidates: Optional[Sequence[Config]] = None,
                 budget: int = 64, guard_band: float = 0.25,
                 power_envelope: Optional[float] = None,
                 min_samples: int = 3, samples_per_trial: int = 8,
                 alpha: float = 0.25, clip: float = 4.0, top_k: int = 8,
                 cooldown: int = 1, journal_dir: Optional[str] = None,
                 source: str = "serve", store: bool = True):
        if budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        if guard_band <= 0:
            raise ValueError(f"guard_band must be > 0, got {guard_band}")
        if power_envelope is not None and power_envelope <= 0:
            raise ValueError(
                f"power_envelope must be > 0, got {power_envelope}")
        if samples_per_trial < min_samples:
            raise ValueError("samples_per_trial must be >= min_samples "
                             f"({samples_per_trial} < {min_samples})")
        self.wl = wl.canonical()
        self.space = build_space(self.wl)
        if session is None and (prior is None or store):
            from repro_torch.tuning.session import default_session
            session = default_session()
        self.session = session
        if prior is None:
            prior = session.resolve_raw(self.wl)
        self.guard_band = guard_band
        self.power_envelope = power_envelope
        self.power_vetoed: List[Config] = []
        self._watts_cache: Dict[str, float] = {}
        self._power_obj = None
        self.budget = budget
        self.min_samples = max(int(min_samples), 1)
        self.samples_per_trial = samples_per_trial
        self.cooldown = max(int(cooldown), 0)
        self.store = store and session is not None
        self._ewma_kwargs = {"alpha": alpha, "clip": clip}

        self.incumbent = TrialRecord(dict(prior), EwmaTracker(alpha, clip),
                                     state=INCUMBENT)
        if candidates is None:
            candidates = ranked_candidates(self.space, top_k,
                                           exclude=(self.incumbent.key,))
        seen = {self.incumbent.key}
        self._pending: List[Config] = []
        for cfg in candidates:
            key = config_key(cfg)
            if key not in seen:
                seen.add(key)
                self._pending.append(dict(cfg))
        self.trial: Optional[TrialRecord] = None
        self.trials: List[TrialRecord] = []      # finished trials, in order
        self.measured = 0                        # trial samples spent (budget)
        self.steps = 0                           # every observed step
        self.promotions = 0
        self.finished = False
        self.stopped_by = "running"
        self._since_trial = self.cooldown        # allow an immediate first trial

        self._journal: Optional[SweepJournal] = None
        self._journal_identity = OnlineWallClockObjective({}, source=source)
        if journal_dir is not None:
            self._journal = SweepJournal.for_workload(
                journal_dir, self.wl, self._journal_identity)

    # -- what should the next step run? -------------------------------------

    def config(self) -> Config:
        """Raw config the next serving step should run (trial or incumbent)."""
        rec = self.trial if self.trial is not None else self.incumbent
        return dict(rec.config)

    def state(self) -> str:
        """Current activity: ``trialing`` while a candidate is shadowed,
        else ``incumbent`` (serving the best known config)."""
        return TRIALING if self.trial is not None else INCUMBENT

    def overrides_fragment(self) -> Dict[str, Dict[str, int]]:
        """Per-op override dict applying :meth:`config` to the serve path."""
        return {self.wl.op: self.config()}

    # -- feed measurements ---------------------------------------------------

    def observe(self, dt: float) -> None:
        """Record one step's wall-clock duration for the active config."""
        self.steps += 1
        if self.trial is None:
            self.incumbent.tracker.observe(dt)
            self._since_trial += 1
            if self.incumbent.tracker.samples == self.min_samples:
                # baseline established: the prior's production latency is a
                # measurement worth keeping too
                self._journal_entry(self.incumbent)
            if not self.finished:
                self._maybe_start_trial()
            return

        self.trial.tracker.observe(dt)
        self.measured += 1
        inc = self.incumbent.tracker.value
        trial = self.trial
        decided = False
        if trial.samples >= self.min_samples:
            if inc is not None and trial.tracker.value > inc * (1.0 + self.guard_band):
                # guard band: visibly worse than the incumbent — stop
                # burning production steps on it immediately
                self._finish_trial(ROLLED_BACK)
                decided = True
            elif trial.samples >= self.samples_per_trial \
                    or self.measured >= self.budget:
                win = inc is None or trial.tracker.value < inc
                self._finish_trial(INCUMBENT if win else ROLLED_BACK)
                decided = True
        elif self.measured >= self.budget:
            # budget died mid-trial before min_samples: not enough evidence
            # to promote — roll back
            self._finish_trial(ROLLED_BACK)
            decided = True
        if decided and not self.finished:
            self._maybe_start_trial()

    # -- internals -----------------------------------------------------------

    def _maybe_start_trial(self) -> None:
        if self.trial is not None or self.finished:
            return
        if self.incumbent.samples < self.min_samples:
            return                     # no believable baseline yet
        if self._since_trial < self.cooldown:
            return                     # let the incumbent breathe between trials
        if self.measured >= self.budget:
            self._stop("budget")
            return
        if not self._pending:
            self._stop("exhausted")
            return
        cfg = self._pending.pop(0)
        if self.power_envelope is not None:
            # the trial queue never spends a production step on a config the
            # model says would blow the incumbent's power budget
            cap = self._modeled_watts(self.incumbent.config) \
                * self.power_envelope
            while self._modeled_watts(cfg) > cap:
                self.power_vetoed.append(cfg)
                if not self._pending:
                    self._stop("exhausted")
                    return
                cfg = self._pending.pop(0)
        self.trial = TrialRecord(cfg, EwmaTracker(
            hint=self.incumbent.tracker.value, **self._ewma_kwargs))

    def _finish_trial(self, state: str) -> None:
        trial = self.trial
        assert trial is not None
        self.trial = None
        self._since_trial = 0
        trial.state = state
        trial.baseline = self.incumbent.tracker.value
        self.trials.append(trial)
        self._journal_entry(trial)
        if state == INCUMBENT:
            old = self.incumbent
            old.state = SUPERSEDED
            old.baseline = trial.tracker.value
            if old not in self.trials and old.samples:
                # the original prior was never a trial; record its
                # measured life so result().history reports every config
                # that informed a decision
                self.trials.append(old)
            self.incumbent = trial
            self.promotions += 1
            self._persist_winner()
        if self.measured >= self.budget:
            self._stop("budget")
        elif not self._pending:
            self._stop("exhausted")

    def _modeled_watts(self, cfg: Config) -> float:
        """Model-predicted average draw (W) for ``cfg`` on the active device:
        ``energy_j / time_s`` from the cost model's metric vector.  Zero
        production cost — the power veto never spends a traffic step.  A
        config the model cannot time answers with +inf (always vetoed)."""
        key = config_key(cfg)
        if key not in self._watts_cache:
            if self._power_obj is None:
                from repro_torch.core.objective import CostModelObjective
                profile = getattr(self.session, "spec", None)
                self._power_obj = CostModelObjective(profile)
            m = self._power_obj(self.space, cfg)
            watts = m.energy_j / m.time_s if m.valid and m.time_s > 0 \
                else float("inf")
            self._watts_cache[key] = watts
        return self._watts_cache[key]

    def _stop(self, reason: str) -> None:
        if not self.finished:
            self.finished = True
            self.stopped_by = reason

    def _persist_winner(self) -> None:
        if not self.store or self.session is None:
            return
        inc = self.incumbent
        self.session.db.store(self.wl, inc.config, float(inc.tracker.value),
                              "online", self.measured)
        self.session.invalidate(self.wl)

    def _journal_entry(self, rec: TrialRecord) -> None:
        if self._journal is None or rec.ewma is None or rec.samples == 0:
            return
        # space_size is the FULL valid space; "pruned" marks the journal as
        # a model-steered subset, so dataset export ignores it until every
        # config in the space has a production measurement (the sweep
        # journal's pruned-subset contract).
        # The count is configs never queued: incumbent + trial queue cover
        # the rest. Only the FIRST append's value lands (the journal
        # header is write-once), and the queue never grows, so the
        # baseline-time value is the right one.
        full = len(self.space.enumerate_valid())
        self._journal.append(self.wl, self._journal_identity, full,
                             [(rec.config, float(rec.ewma))],
                             pruned=max(full - 1 - len(self._pending), 0))

    # -- results -------------------------------------------------------------

    def result(self) -> TuneResult:
        """Session-compatible result; ``stopped_by`` says what ended it:
        ``budget`` (measurement budget was binding), ``exhausted`` (trial
        queue ran dry first), or ``running`` (mid-flight snapshot)."""
        history: List[Tuple[Config, float]] = []
        for rec in self.trials:
            if rec.ewma is not None:
                history.append((dict(rec.config), float(rec.ewma)))
        inc = self.incumbent
        best_time = float(inc.tracker.value) if inc.tracker.value is not None \
            else float("inf")
        if all(config_key(c) != inc.key for c, _ in history) \
                and inc.tracker.value is not None:
            history.append((dict(inc.config), best_time))
        return TuneResult(dict(inc.config), best_time, self.measured,
                          history, self.stopped_by)

    def summary(self) -> Dict[str, object]:
        return {
            "workload": self.wl.key,
            "incumbent": dict(self.incumbent.config),
            "incumbent_ewma_s": self.incumbent.tracker.value,
            "state": self.state(),
            "stopped_by": self.stopped_by,
            "steps": self.steps,
            "measured": self.measured,
            "budget": self.budget,
            "promotions": self.promotions,
            "power_envelope": self.power_envelope,
            "power_vetoed": len(self.power_vetoed),
            "trials": [{"config": dict(t.config), "state": t.state,
                        "samples": t.samples, "ewma_s": t.ewma}
                       for t in self.trials],
        }


# ---------------------------------------------------------------------------
# Callers of the tuner: live engine, deterministic replay, strategy simulation
# ---------------------------------------------------------------------------

def attach(engine, tuner: OnlineTuner,
           recorder: Optional[TraceRecorder] = None) -> None:
    """Wire an OnlineTuner into a serving engine's step hooks.

    The engine applies ``tuner.overrides_fragment()`` around every decode
    step (so the active trial's knobs reach the kernels through the normal
    override stack) and reports each step's wall-clock duration; the
    listener attributes the sample to the config that was live *during*
    the step — reading it before ``observe`` possibly switches trials.
    """
    engine.set_override_provider(tuner.overrides_fragment)

    def _on_step(record) -> None:
        cfg = tuner.config()
        tuner.observe(record.duration_s)
        if recorder is not None:
            recorder.add(cfg, record.duration_s)

    engine.add_step_listener(_on_step)


def replay(tuner: OnlineTuner, trace: ReplayTrace,
           max_steps: int = 100_000) -> TuneResult:
    """Drive the tuner's state machine from a recorded trace.

    Each simulated step feeds the next recorded latency of whichever
    config the tuner wants live (cycling per-config when a sequence runs
    out — steady-state traffic); a config the trace never saw answers with
    the penalty clamp, so the guard band rolls it back, exactly as an
    unmeasurable config should die in production.  Fully deterministic:
    same trace + same tuner parameters -> same promotions, same winner.
    """
    cursors: Dict[str, int] = {}
    steps = 0
    while not tuner.finished and steps < max_steps:
        key = config_key(tuner.config())
        ts = trace.times.get(key)
        if ts:
            i = cursors.get(key, 0)
            t = ts[i % len(ts)]
            cursors[key] = i + 1
        else:
            t = PENALTY_TIME
        tuner.observe(t)
        steps += 1
    return tuner.result()


def online_search(space: SearchSpace, objective: Objective, *, seed: int = 0,
                  budget: int = 16, guard_band: float = 0.25,
                  min_samples: int = 2, samples_per_trial: int = 3,
                  top_k: Optional[int] = None,
                  prior: Optional[Config] = None,
                  policy=None,
                  power_envelope: Optional[float] = None) -> TuneResult:
    """``strategy="online"`` — simulate in-traffic tuning on an objective.

    Every simulated step "measures" the active config by evaluating the
    objective (deterministic objectives make the EWMA collapse to the
    measured time, so the comparison report scores online tuning on the
    same numbers as everyone else).  The prior is the analytical
    suggestion — the paper's zero-evaluation cold start.

    ``policy``: JAX scalarizes the objective's metric vector by a
    :mod:`repro.core.policy` policy before the EWMA sees it; the port has
    the latency policy alone (``None`` or ``"latency"``), and any other
    raises until ``core/policy.py`` is ported (``ROADMAP.md`` §1 item 8).
    ``power_envelope`` forwards to :class:`OnlineTuner`.
    """
    del seed    # the trial queue is analytically ranked: deterministic
    wl = space.workload
    if policy not in (None, "latency"):
        raise NotImplementedError(
            f"policy={policy!r}: the port tunes latency alone until "
            f"core/policy.py is ported (ROADMAP.md §1 item 8)")
    if prior is None:
        prior = AnalyticalTuner().suggest(space)
    if top_k is None:
        # one queue slot per full trial the budget can afford
        top_k = max(budget // samples_per_trial, 1)
    tuner = OnlineTuner(wl, session=None, prior=prior, store=False,
                        budget=budget, guard_band=guard_band,
                        power_envelope=power_envelope,
                        min_samples=min_samples,
                        samples_per_trial=samples_per_trial, top_k=top_k,
                        cooldown=0)
    # cap far above budget: warmup + cooldown steps are incumbent-only
    cap = 4 * budget + 8 * tuner.min_samples + 64
    steps = 0
    while not tuner.finished and steps < cap:
        cfg = tuner.config()
        m = objective(space, cfg)
        tuner.observe(m.time_s if m.valid else PENALTY_TIME)
        steps += 1
    if not tuner.finished:
        tuner._stop("budget")
    return tuner.result()


# ---------------------------------------------------------------------------
# Fleet priors: aggregate replica journals into one warm start
# ---------------------------------------------------------------------------

def aggregate_fleet(journal_dirs: Sequence[str], wl: Workload, *,
                    source: str = "serve", min_replicas: int = 1,
                    ) -> Dict[str, Tuple[Config, float, int]]:
    """Merge per-replica online journals into fleet-wide config estimates.

    Each serving replica streams its in-traffic EWMAs to its own journal
    directory (``OnlineTuner(journal_dir=...)``); a fleet is just a list
    of those directories on shared storage.  This reads every replica's
    journal for ``wl`` under the online objective identity and merges
    per config: the fleet estimate is the mean of the replicas' final
    EWMAs (journal entries are last-wins per config, so each replica
    contributes at most one number per config).  Configs measured by
    fewer than ``min_replicas`` replicas are dropped — one replica's
    fluke cannot steer the fleet.

    Returns ``{config_key: (config, mean_seconds, replicas)}``.
    """
    wl = wl.canonical()
    identity = OnlineWallClockObjective({}, source=source)
    merged: Dict[str, Tuple[Config, List[float]]] = {}
    for d in journal_dirs:
        journal = SweepJournal.for_workload(d, wl, identity)
        for cfg, t in journal.entries():
            _, ts = merged.setdefault(config_key(cfg), (dict(cfg), []))
            ts.append(float(t))
    return {key: (cfg, sum(ts) / len(ts), len(ts))
            for key, (cfg, ts) in merged.items()
            if len(ts) >= max(min_replicas, 1)}


def fleet_prior(journal_dirs: Sequence[str], wl: Workload, *,
                source: str = "serve", min_replicas: int = 1,
                ) -> Tuple[Optional[Config], List[Config]]:
    """Fleet-aggregated warm start: ``(winner, runner-up candidates)``.

    The winner is the config with the best fleet-mean latency; the other
    measured configs follow ordered by their fleet means, so a fresh
    replica trials the fleet's runner-ups first instead of re-deriving
    the queue analytically.  ``(None, [])`` when no journal has data.
    """
    agg = aggregate_fleet(journal_dirs, wl, source=source,
                          min_replicas=min_replicas)
    if not agg:
        return None, []
    ranked = sorted(agg.values(), key=lambda item: item[1])
    return dict(ranked[0][0]), [dict(cfg) for cfg, _, _ in ranked[1:]]


def promote_fleet_winner(session, wl: Workload, journal_dirs: Sequence[str],
                         *, source: str = "serve", min_replicas: int = 1,
                         ) -> Optional[Tuple[Config, float, int]]:
    """Store the fleet's best config in the TuningDB (``method="fleet"``).

    The stored record seeds ``session.resolve_raw`` for every future
    engine on this device even with no fleet journal in reach.  Like
    ``method="online"``, ``"fleet"`` stays outside the exhaustive dataset
    allowlist — a traffic consensus is not a sweep optimum.  Returns the
    ``(config, mean_seconds, replicas)`` stored, or ``None`` when no
    journal has enough data to promote.
    """
    wl = wl.canonical()
    agg = aggregate_fleet(journal_dirs, wl, source=source,
                          min_replicas=min_replicas)
    if not agg:
        return None
    cfg, t, replicas = min(agg.values(), key=lambda item: item[1])
    session.db.store(wl, cfg, float(t), "fleet", replicas)
    session.invalidate(wl)
    return dict(cfg), float(t), int(replicas)


def warm_tuner(wl: Workload, journal_dirs: Sequence[str], session=None, *,
               source: str = "serve", min_replicas: int = 1,
               **tuner_kwargs) -> OnlineTuner:
    """An :class:`OnlineTuner` warm-started from fleet journals.

    The fleet winner becomes the prior — the new replica serves the
    consensus config from its very first step — and the fleet's
    runner-ups, ordered by their measured means, become the trial queue.
    With no usable fleet data this falls back to the normal cold start
    (session prior + analytically-ranked queue), so callers can pass the
    fleet directories unconditionally.
    """
    prior, candidates = fleet_prior(journal_dirs, wl, source=source,
                                    min_replicas=min_replicas)
    if prior is None:
        return OnlineTuner(wl, session, source=source, **tuner_kwargs)
    return OnlineTuner(wl, session, prior=prior, candidates=candidates,
                       source=source, **tuner_kwargs)


def measurements_to_incumbent(tuner: OnlineTuner) -> int:
    """Trial samples spent before the tuner's final incumbent went live.

    The fleet-prior gate metric: a replica warm-started on the fleet
    winner pays zero (or few) trial samples before serving it; a cold
    replica pays for every trial through the winning promotion.
    Superseded incumbents' samples are incumbent-time serving, not trial
    spend, and are excluded.
    """
    spent = 0
    answer = 0
    for rec in tuner.trials:
        if rec.state == SUPERSEDED:
            continue
        spent += rec.samples
        if rec.state == INCUMBENT:
            answer = spent
    return answer
