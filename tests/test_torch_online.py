"""The port's online tuning (``repro_torch.tuning.online``) against the JAX
package's, and its behaviour on the port alone.

Parity, with both ``REPRO_HW_PROFILE`` and ``REPRO_TORCH_HW_PROFILE`` set
to one profile: the ``OnlineTuner`` state machine step by step under the
same ``observe`` streams (configs, states, summaries); ``replay`` of the
same ``ReplayTrace``; trace files and online journals written by one
package and read by the other (same path, same header); the fleet
functions and ``warm_tuner`` over journals of either package;
``online_search`` and the ``online`` row of ``compare_methods`` on the
cost model under tpu_v5e, gpu_sm and cpu_interpret; the ``online-replay``
CLI's summary.  Then the counterparts of ``tests/test_online.py`` on the
port (its default profile, h100), the ``online-replay`` and
``launch.serve --device cpu --reduced`` CLIs end to end, and
``online_search`` under each policy against repro's.
"""
import importlib
import json
import os

import numpy as np
import pytest

from repro.core import Workload as JWorkload
from repro.core import build_space as j_build_space
from repro.core.analytical import AnalyticalTuner as JAnalytical
from repro.core.objective import CachedObjective as JCached
from repro.core.objective import CostModelObjective as JCost
from repro.evaluation.compare import compare_methods as j_compare
from repro.tuning import TunerSession as JSession
from repro.tuning import online as j_online
from repro.tuning import sweep as j_sweep
from repro_torch.core import Workload, build_space
from repro_torch.core.analytical import AnalyticalTuner
from repro_torch.core.exhaustive import ExhaustiveSearch
from repro_torch.core.objective import (PENALTY_TIME, CachedObjective,
                                        CostModelObjective)
from repro_torch.evaluation import check_report, compare_methods
from repro_torch.hw.profiles import get_profile
from repro_torch.launch import tune as t_tune
from repro_torch.tuning import (OnlineTuner, ReplayTrace, TunerSession,
                                aggregate_fleet, fleet_prior,
                                measurements_to_incumbent, online_search,
                                promote_fleet_winner, replay, warm_tuner)
from repro_torch.tuning import online as t_online
from repro_torch.tuning.online import (INCUMBENT, ROLLED_BACK, EwmaTracker,
                                       ranked_candidates)
from repro_torch.tuning.sweep import SweepJournal, config_key

j_tune = importlib.import_module("repro.launch.tune")

PROFILES = ["tpu_v5e", "gpu_sm", "cpu_interpret"]
WL = Workload(op="scan", n=512, batch=2**17, variant="lf")
J_WL = JWorkload(op="scan", n=512, batch=2**17, variant="lf")


@pytest.fixture
def pin(monkeypatch):
    """Point both packages' active profile at one name."""
    def set_profile(name):
        monkeypatch.setenv("REPRO_HW_PROFILE", name)
        monkeypatch.setenv("REPRO_TORCH_HW_PROFILE", name)
    return set_profile


def _pair(wl_kwargs):
    return JWorkload(**wl_kwargs), Workload(**wl_kwargs)


# ---------------------------------------------------------------------------
# The state machine against JAX's
# ---------------------------------------------------------------------------

# step ms by rank: the prior first, then faster and slower candidates
_BASE_MS = (2.0, 2.3, 1.6, 2.9, 1.2, 2.1, 0.9, 2.6, 1.4)


def _times(keys, seed, jitter, spikes):
    """Per-config step-latency sequences (seconds): config i of the ranked
    list at its own base, jittered, with occasional 50x spikes."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, key in enumerate(keys):
        base = 1e-3 * _BASE_MS[i % len(_BASE_MS)]
        ts = base * (1.0 + jitter * rng.uniform(-1, 1, size=40))
        ts[rng.uniform(size=40) < spikes] *= 50.0
        out[key] = [float(t) for t in ts]
    return out


TUNER_CASES = {
    "default": (dict(budget=64), 0.05, 0.0),
    "budget-bound": (dict(budget=5, samples_per_trial=4, min_samples=2),
                     0.05, 0.0),
    "tight-band": (dict(budget=48, guard_band=0.05, top_k=6), 0.2, 0.05),
    "cooldown": (dict(budget=40, cooldown=3, alpha=0.5, clip=2.0), 0.1,
                 0.1),
    "power": (dict(budget=64, power_envelope=1.0), 0.05, 0.0),
}


@pytest.mark.parametrize("case", list(TUNER_CASES))
@pytest.mark.parametrize("wl_kwargs", [
    dict(op="scan", n=512, batch=2**17, variant="lf"),
    dict(op="attention", n=256, batch=8, variant="flash")],
    ids=["scan-lf", "attention"])
def test_tuner_state_machine_matches_repro(pin, case, wl_kwargs):
    pin("tpu_v5e")
    kwargs, jitter, spikes = TUNER_CASES[case]
    jwl, twl = _pair(wl_kwargs)
    jprior = JAnalytical().suggest(j_build_space(jwl))
    tprior = AnalyticalTuner().suggest(build_space(twl))
    assert tprior == jprior
    jt = j_online.OnlineTuner(jwl, None, prior=jprior, store=False, **kwargs)
    tt = OnlineTuner(twl, None, prior=tprior, store=False, **kwargs)
    keys = [config_key(tprior)] + [config_key(c) for c in tt._pending]
    assert keys[1:] == [j_sweep.config_key(c) for c in jt._pending]
    times = _times(keys, seed=len(case), jitter=jitter, spikes=spikes)
    cursors = {}
    for _ in range(160):
        assert tt.config() == jt.config()
        assert tt.state() == jt.state()
        key = config_key(tt.config())
        i = cursors.get(key, 0)
        cursors[key] = i + 1
        t = times[key][i % len(times[key])]
        jt.observe(t)
        tt.observe(t)
    assert tt.summary() == jt.summary()
    jr, tr = jt.result(), tt.result()
    assert (tr.best_config, tr.best_time, tr.evaluations, tr.history,
            tr.stopped_by) == (jr.best_config, jr.best_time, jr.evaluations,
                               jr.history, jr.stopped_by)
    assert j_online.measurements_to_incumbent(jt) \
        == measurements_to_incumbent(tt)
    assert len(tt.power_vetoed) == len(jt.power_vetoed)


def _traces(source="test", seed=0):
    """The same recorded trace in both packages (tpu_v5e's scan lf space):
    the prior 2x slower than the fourth-ranked candidate."""
    space = build_space(WL)
    prior = AnalyticalTuner().suggest(space)
    cands = ranked_candidates(space, 8, exclude=(config_key(prior),))
    rng = np.random.default_rng(seed)
    jtr, ttr = j_online.ReplayTrace(J_WL, source=source), \
        ReplayTrace(WL, source=source)
    for i, cfg in enumerate([prior] + cands):
        ms = 2.0 if i == 0 else (1.0 if i == 4 else 2.4)
        for t in ms * 1e-3 * (1.0 + 0.05 * rng.uniform(-1, 1, size=40)):
            jtr.add(cfg, float(t))
            ttr.add(cfg, float(t))
    return jtr, ttr, prior, cands[3]


@pytest.mark.parametrize("kwargs", [dict(budget=64), dict(budget=12),
                                    dict(budget=48, guard_band=0.1,
                                         min_samples=2, samples_per_trial=5)])
def test_replay_matches_repro(pin, kwargs):
    pin("tpu_v5e")
    jtr, ttr, prior, best = _traces()
    jt = j_online.OnlineTuner(J_WL, None, prior=prior, store=False, **kwargs)
    tt = OnlineTuner(WL, None, prior=prior, store=False, **kwargs)
    jr, tr = j_online.replay(jt, jtr), replay(tt, ttr)
    assert (tr.best_config, tr.best_time, tr.evaluations, tr.history,
            tr.stopped_by) == (jr.best_config, jr.best_time, jr.evaluations,
                               jr.history, jr.stopped_by)
    assert tt.summary() == jt.summary()
    space = build_space(WL)
    assert t_online.replay_candidates(space, ttr, prior) \
        == j_online.replay_candidates(j_build_space(J_WL), jtr, prior)


def test_trace_files_read_across_packages(pin, tmp_path):
    pin("tpu_v5e")
    jtr, ttr, prior, _ = _traces(source="serve")
    ttr.save(str(tmp_path / "torch.jsonl"))
    jtr.save(str(tmp_path / "jax.jsonl"))
    assert (tmp_path / "torch.jsonl").read_text() \
        == (tmp_path / "jax.jsonl").read_text()
    for path in ("torch.jsonl", "jax.jsonl"):
        a = ReplayTrace.load(str(tmp_path / path))
        b = j_online.ReplayTrace.load(str(tmp_path / path))
        assert (a.times, a.configs, a.source) == (b.times, b.configs,
                                                  b.source)
        assert a.workload.key == b.workload.key
    # recorders append the same lines
    trec = t_online.TraceRecorder(str(tmp_path / "trec.jsonl"), WL)
    jrec = j_online.TraceRecorder(str(tmp_path / "jrec.jsonl"), J_WL)
    for key, ts in ttr.times.items():
        for t in ts[:3]:
            trec.add(ttr.configs[key], t)
            jrec.add(ttr.configs[key], t)
    assert (tmp_path / "trec.jsonl").read_text() \
        == (tmp_path / "jrec.jsonl").read_text()
    assert j_online.ReplayTrace.load(str(tmp_path / "trec.jsonl")).times \
        == ReplayTrace.load(str(tmp_path / "jrec.jsonl")).times


def test_online_journals_read_across_packages(pin, tmp_path):
    """The same replay journaled by each package: one file name, one
    header, the same entries, readable by the other package's journal."""
    pin("tpu_v5e")
    jtr, ttr, prior, _ = _traces()
    jt = j_online.OnlineTuner(J_WL, None, prior=prior, store=False,
                              budget=64, journal_dir=str(tmp_path / "j"),
                              source="test")
    tt = OnlineTuner(WL, None, prior=prior, store=False, budget=64,
                     journal_dir=str(tmp_path / "t"), source="test")
    j_online.replay(jt, jtr)
    replay(tt, ttr)
    (jpath,), (tpath,) = os.listdir(tmp_path / "j"), os.listdir(tmp_path / "t")
    assert jpath == tpath
    jfile, tfile = str(tmp_path / "j" / jpath), str(tmp_path / "t" / tpath)
    assert SweepJournal(tfile).read_header() \
        == j_sweep.SweepJournal(jfile).read_header()
    assert SweepJournal(tfile).read_header()["pruned"] > 0
    assert SweepJournal(jfile).entries() == SweepJournal(tfile).entries() \
        == j_sweep.SweepJournal(tfile).entries()
    # fleets over either package's journals
    assert aggregate_fleet([str(tmp_path / "j")], WL, source="test") \
        == j_online.aggregate_fleet([str(tmp_path / "t")], J_WL,
                                    source="test")


def test_fleet_and_warm_tuner_match_repro(pin, tmp_path):
    pin("tpu_v5e")
    dirs = []
    for seed in range(3):
        jtr, _, prior, _ = _traces(seed=seed)
        d = str(tmp_path / f"replica{seed}")
        jt = j_online.OnlineTuner(J_WL, None, prior=prior, store=False,
                                  budget=64, journal_dir=d, source="test")
        j_online.replay(jt, jtr)
        dirs.append(d)
    for min_replicas in (1, 2, 3):
        assert aggregate_fleet(dirs, WL, source="test",
                               min_replicas=min_replicas) \
            == j_online.aggregate_fleet(dirs, J_WL, source="test",
                                        min_replicas=min_replicas)
        assert fleet_prior(dirs, WL, source="test",
                           min_replicas=min_replicas) \
            == j_online.fleet_prior(dirs, J_WL, source="test",
                                    min_replicas=min_replicas)
    jsession = JSession(db_path=str(tmp_path / "j.json"))
    tsession = TunerSession(db_path=str(tmp_path / "t.json"))
    assert promote_fleet_winner(tsession, WL, dirs, source="test") \
        == j_online.promote_fleet_winner(jsession, J_WL, dirs, source="test")
    assert tsession.db.entries() == jsession.db.entries()
    jtr, ttr, _, _ = _traces(seed=9)
    jw = j_online.warm_tuner(J_WL, dirs, jsession, source="test", budget=64,
                             store=False)
    tw = warm_tuner(WL, dirs, tsession, source="test", budget=64,
                    store=False)
    assert tw.config() == jw.config()
    assert tw._pending == jw._pending
    j_online.replay(jw, jtr)
    replay(tw, ttr)
    assert tw.summary() == jw.summary()


# ---------------------------------------------------------------------------
# online_search and the compare row under the three profiles
# ---------------------------------------------------------------------------

SEARCH_WLS = [dict(op="scan", n=512, batch=2**17, variant="ks"),
              dict(op="tridiag", n=128, batch=2**13, variant="pcr"),
              dict(op="fft", n=256, batch=2**14, variant="stockham"),
              dict(op="attention", n=256, batch=8, variant="flash")]


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("wl_kwargs", SEARCH_WLS,
                         ids=[w["op"] for w in SEARCH_WLS])
def test_online_search_matches_repro(pin, profile, wl_kwargs):
    pin(profile)
    jwl, twl = _pair(wl_kwargs)
    for budget in (4, 16):
        jr = j_online.online_search(j_build_space(jwl), JCached(JCost()),
                                    budget=budget)
        tr = online_search(build_space(twl), CachedObjective(
            CostModelObjective()), budget=budget)
        assert (tr.best_config, tr.best_time, tr.evaluations, tr.history,
                tr.stopped_by) == (jr.best_config, jr.best_time,
                                   jr.evaluations, jr.history, jr.stopped_by)


@pytest.mark.parametrize("profile", PROFILES)
def test_compare_online_row_matches_repro(pin, profile):
    pin(profile)
    methods = ("analytical", "online")
    jrep = j_compare([JWorkload(**w) for w in SEARCH_WLS[:3]], methods,
                     max_evals=10)
    trep = compare_methods([Workload(**w) for w in SEARCH_WLS[:3]], methods,
                           max_evals=10)
    for jrow, trow in zip(jrep["workloads"], trep["workloads"]):
        assert trow["best_time_s"] == jrow["best_time_s"]
        assert trow["methods"]["online"] == jrow["methods"]["online"]
    assert trep["overall"]["online"] == jrep["overall"]["online"]
    assert trep["per_op"] == {op: {m: jrep["per_op"][op][m] for m in methods}
                              for op in jrep["per_op"]}
    assert check_report(trep) == []


def test_online_replay_cli_matches_repro(pin, tmp_path, capsys):
    pin("tpu_v5e")
    jtr, _, _, _ = _traces(source="serve")
    trace = str(tmp_path / "trace.jsonl")
    jtr.save(trace)
    out = {}
    for name, mod in (("torch", t_tune), ("jax", j_tune)):
        path = str(tmp_path / f"{name}.json")
        assert mod.main(["online-replay", "--trace", trace, "--budget", "48",
                         "--json", path,
                         "--journal-dir", str(tmp_path / name)]) == 0
        out[name] = json.loads(open(path).read())
    assert out["torch"] == out["jax"]
    assert out["torch"]["promotions"] >= 1
    text = capsys.readouterr().out
    assert "[online-replay] winner" in text


# ---------------------------------------------------------------------------
# Behaviour (tests/test_online.py's, on the port under h100)
# ---------------------------------------------------------------------------

def _trace_with_best(session, *, prior_ms=2.0, best_ms=1.0, other_ms=2.4,
                     best_rank=3, top_k=8, jitter=0.0, seed=0):
    space = build_space(WL)
    prior = session.resolve_raw(WL)
    cands = ranked_candidates(space, top_k, exclude=(config_key(prior),))
    best = cands[best_rank]
    rng = np.random.default_rng(seed)
    trace = ReplayTrace(WL, source="test")

    def times(ms):
        base = ms * 1e-3
        if not jitter:
            return [base] * 40
        return list(base * (1.0 + jitter * rng.uniform(-1, 1, size=40)))

    for t in times(prior_ms):
        trace.add(prior, t)
    for i, cfg in enumerate(cands):
        for t in times(best_ms if i == best_rank else other_ms):
            trace.add(cfg, t)
    return trace, prior, best


@pytest.fixture
def session(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_HW_PROFILE", raising=False)
    return TunerSession(db_path=str(tmp_path / "db.json"))


def test_ewma_clips_outliers():
    tr = EwmaTracker(alpha=0.25, clip=4.0)
    tr.observe(1.0)
    tr.observe(1000.0)
    assert tr.clipped == 1
    assert tr.value <= 1.0 * (1 - 0.25) + 4.0 * 0.25 + 1e-12
    for _ in range(20):
        tr.observe(1.0)
    assert abs(tr.value - 1.0) < 0.05
    with pytest.raises(ValueError, match="alpha"):
        EwmaTracker(alpha=0.0)
    with pytest.raises(ValueError, match="clip"):
        EwmaTracker(clip=1.0)
    const = EwmaTracker(alpha=0.25)
    for _ in range(10):
        const.observe(3.14159e-3)
    assert const.value == 3.14159e-3


def test_first_trial_sample_clipped_against_incumbent_hint(session):
    tr = EwmaTracker(alpha=0.25, clip=4.0, hint=1e-3)
    tr.observe(1.0)
    assert tr.clipped == 1 and tr.value <= 4e-3
    prior = session.resolve_raw(WL)
    best = ranked_candidates(build_space(WL), 1,
                             exclude=(config_key(prior),))[0]
    trace = ReplayTrace(WL, source="test")
    for _ in range(30):
        trace.add(prior, 2e-3)
    trace.add(best, 2.0)
    for _ in range(30):
        trace.add(best, 1e-3)
    tuner = OnlineTuner(WL, session, prior=prior, candidates=[best],
                        budget=32, store=False)
    assert replay(tuner, trace).best_config == best


def test_replay_converges_and_persists(session, tmp_path):
    """Prior 2x slower than the best recorded config: found within the
    budget, persisted (method "online"), journaled; the history keeps the
    demoted prior; states stay consistent."""
    trace, prior, best = _trace_with_best(session, jitter=0.05)
    tuner = OnlineTuner(WL, session, budget=64, guard_band=0.25,
                        journal_dir=str(tmp_path / "journals"),
                        source="test")
    assert tuner.state() == INCUMBENT
    res = replay(tuner, trace)
    assert res.best_config == best and tuner.promotions >= 1
    assert res.evaluations <= 64
    assert res.stopped_by in ("budget", "exhausted")
    assert session.lookup(WL) == best
    assert next(iter(session.db.entries().values()))["method"] == "online"
    (journal,) = (tmp_path / "journals").glob("*.jsonl")
    header = SweepJournal(str(journal)).read_header()
    assert header["objective"] == "online_wallclock:test"
    assert header["pruned"] > 0
    keys = {config_key(c) for c, _ in SweepJournal(str(journal)).entries()}
    assert config_key(best) in keys and config_key(prior) in keys
    hist = {config_key(c) for c, _ in res.history}
    assert config_key(prior) in hist and config_key(best) in hist
    assert tuner.incumbent.state == INCUMBENT
    promoted = [t for t in tuner.trials if t.state == INCUMBENT]
    assert promoted and promoted[-1] is tuner.incumbent


def test_replay_never_exceeds_guard_band_mid_run(session):
    trace, prior, best = _trace_with_best(session, other_ms=5.0, jitter=0.05)
    tuner = OnlineTuner(WL, session, budget=64, guard_band=0.25,
                        min_samples=3, store=False)
    cursors = {}
    while not tuner.finished and tuner.steps < 10_000:
        key = config_key(tuner.config())
        ts = trace.times.get(key, [PENALTY_TIME])
        t = ts[cursors.get(key, 0) % len(ts)]
        cursors[key] = cursors.get(key, 0) + 1
        tuner.observe(t)
        if tuner.trial is not None and tuner.trial.samples >= 3:
            assert tuner.trial.ewma \
                <= tuner.incumbent.tracker.value * 1.25 + 1e-12
    for rec in tuner.trials:
        if rec.state == ROLLED_BACK and rec.ewma > rec.baseline * 1.25:
            assert rec.samples <= 3


def test_replay_is_deterministic(session):
    trace, _, _ = _trace_with_best(session, jitter=0.1)

    def run():
        tuner = OnlineTuner(WL, session, budget=48, store=False)
        res = replay(tuner, trace)
        return (res.best_config, res.best_time, res.stopped_by,
                [(t.key, t.state, t.samples) for t in tuner.trials])

    assert run() == run()


def test_unrecorded_candidate_rolls_back_on_penalty(session):
    prior = session.resolve_raw(WL)
    ghost = ranked_candidates(build_space(WL), 1,
                              exclude=(config_key(prior),))[0]
    trace = ReplayTrace(WL, source="test")
    for _ in range(20):
        trace.add(prior, 1e-3)
    tuner = OnlineTuner(WL, session, prior=prior, candidates=[ghost],
                        budget=16, min_samples=2, store=False)
    assert replay(tuner, trace).best_config == prior
    assert tuner.trials[0].state == ROLLED_BACK
    assert tuner.trials[0].samples == 2


def test_stopped_by_budget_vs_exhausted(session):
    trace, _, _ = _trace_with_best(session, top_k=4)
    tight = OnlineTuner(WL, session, budget=5, samples_per_trial=4,
                        min_samples=2, store=False)
    assert replay(tight, trace).stopped_by == "budget"
    assert tight.measured <= 5
    roomy = OnlineTuner(WL, session, budget=500, top_k=4, store=False)
    assert replay(roomy, trace).stopped_by == "exhausted"
    assert len(roomy.trials) >= 4


def test_promotion_requires_strict_win(session):
    prior = session.resolve_raw(WL)
    cands = ranked_candidates(build_space(WL), 3,
                              exclude=(config_key(prior),))
    trace = ReplayTrace(WL, source="test")
    for cfg in [prior] + cands:
        for _ in range(30):
            trace.add(cfg, 1e-3)
    tuner = OnlineTuner(WL, session, budget=200, top_k=3, store=False)
    assert replay(tuner, trace).best_config == prior
    assert tuner.promotions == 0


def test_tuner_parameter_validation(session):
    for bad, match in ((dict(budget=0), "budget"),
                       (dict(guard_band=0.0), "guard_band"),
                       (dict(power_envelope=0.0), "power_envelope"),
                       (dict(min_samples=5, samples_per_trial=2),
                        "samples_per_trial")):
        with pytest.raises(ValueError, match=match):
            OnlineTuner(WL, session, **bad)


def test_ranked_candidates_exclude_and_order():
    space = build_space(WL, get_profile("h100"))
    ranked = ranked_candidates(space, 10)
    assert len(ranked) == 10
    head = config_key(ranked[0])
    without = ranked_candidates(space, 10, exclude=(head,))
    assert all(config_key(c) != head for c in without)
    assert [config_key(c) for c in without[:9]] \
        == [config_key(c) for c in ranked[1:10]]


def test_replay_candidates_keep_low_ranked_recorded_configs(session):
    space = build_space(WL)
    ranked = ranked_candidates(space, top_k=space.size())
    prior, low = ranked[0], ranked[-1]
    trace = ReplayTrace(WL, source="test")
    trace.add(prior, 2e-3)
    trace.add(ranked[1], 1.8e-3)
    trace.add(low, 1e-3)
    cands = t_online.replay_candidates(space, trace, prior)
    keys = [config_key(c) for c in cands]
    assert config_key(low) in keys and config_key(prior) not in keys
    assert keys[0] == config_key(ranked[1])
    for _ in range(30):
        trace.add(prior, 2e-3)
        trace.add(ranked[1], 1.8e-3)
        trace.add(low, 1e-3)
    tuner = OnlineTuner(WL, session=None, prior=prior, candidates=cands,
                        budget=64, store=False)
    assert replay(tuner, trace).best_config == low


def test_trace_roundtrip_and_torn_tail(tmp_path):
    trace = ReplayTrace(WL, source="roundtrip")
    for i, cfg in enumerate(build_space(WL).enumerate_valid()[:3]):
        for j in range(4):
            trace.add(cfg, 1e-3 * (i + 1) + 1e-6 * j)
    path = str(tmp_path / "trace.jsonl")
    trace.save(path)
    with open(path, "a") as f:
        f.write('{"k": "torn')
    loaded = ReplayTrace.load(path)
    assert loaded.workload == WL and loaded.source == "roundtrip"
    assert (loaded.times, loaded.configs) == (trace.times, trace.configs)
    bad = str(tmp_path / "headerless.jsonl")
    with open(bad, "w") as f:
        f.write('{"k": "a", "cfg": {}, "t": 1.0}\n')
    with pytest.raises(ValueError, match="header"):
        ReplayTrace.load(bad)
    clean, merged = str(tmp_path / "clean.jsonl"), str(tmp_path / "m.jsonl")
    trace.save(clean)
    with open(merged, "w") as f:
        f.write(open(clean).read() + open(clean).read())
    with pytest.raises(ValueError, match="multiple headers"):
        ReplayTrace.load(merged)


def test_online_strategy_never_beats_exhaustive():
    space = build_space(Workload(op="fft", n=256, batch=2**14,
                                 variant="stockham"))
    obj = CachedObjective(CostModelObjective(noise=0.02))
    ex = ExhaustiveSearch().tune(space, obj)
    res = online_search(space, obj, budget=16)
    assert res.best_time >= ex.best_time - 1e-18
    assert res.evaluations <= 16
    assert res.stopped_by in ("budget", "exhausted")
    assert space.is_valid(res.best_config)


def test_online_strategy_through_session(session):
    from repro_torch.tuning.ml.dataset import dataset_from_db
    wl = Workload(op="tridiag", n=128, batch=2**13, variant="pcr")
    res = session.tune(wl, method="online", max_evals=12)
    assert res.stopped_by in ("budget", "exhausted")
    assert session.lookup(wl) == res.best_config
    assert next(iter(session.db.entries().values()))["method"] == "online"
    # a traffic winner is no exhaustive optimum: no training rows
    assert len(dataset_from_db(session.db)) == 0


def test_online_in_compare_report():
    report = compare_methods(
        [Workload(op="tridiag", n=128, batch=2**13, variant="pcr")],
        methods=("analytical", "online"),
        objective_factory=lambda: CostModelObjective(noise=0.02),
        max_evals=10)
    assert check_report(report) == []
    row = report["workloads"][0]["methods"]["online"]
    assert row["slowdown"] >= 1.0 - 1e-9
    assert row["stopped_by"] in ("budget", "exhausted")


def test_non_latency_policy_raises(pin):
    """Kept name, new check: ``online_search(policy=)`` scalarizes the
    metric vector through ``PolicyObjective``, as JAX's does — the same
    trials, winner, scalar and ``stopped_by`` as repro's under every
    policy (it raised until ``core/policy.py`` was ported)."""
    pin("gpu_sm")
    kw = dict(op="tridiag", n=128, batch=2**13, variant="pcr")
    jwl, twl = _pair(kw)
    space, jspace = build_space(twl), j_build_space(jwl)
    obj = CachedObjective(CostModelObjective())
    assert online_search(space, obj, budget=4, policy="latency") \
        .best_config == online_search(space, obj, budget=4).best_config
    winners = set()
    for policy in ("energy", "edp", "memory_cap", "memory_cap:16384"):
        tres = online_search(space, CachedObjective(CostModelObjective()),
                             budget=12, policy=policy)
        jres = j_online.online_search(jspace, JCached(JCost()), budget=12,
                                      policy=policy)
        assert (tres.best_config, tres.best_time, tres.evaluations,
                tres.stopped_by) == (jres.best_config, jres.best_time,
                                     jres.evaluations, jres.stopped_by)
        assert tres.history == jres.history
        winners.add(tres.best_time)
    # the scalars are policy scalars (joules, joule-seconds), not one time
    assert len(winners) > 1


# ---------------------------------------------------------------------------
# Fleet priors (on the port)
# ---------------------------------------------------------------------------

def _run_replica(session, journal_dir, *, seed, candidates=None):
    trace, prior, best = _trace_with_best(session, jitter=0.05, seed=seed)
    tuner = OnlineTuner(WL, session, budget=64, store=False,
                        candidates=candidates, journal_dir=journal_dir,
                        source="test")
    replay(tuner, trace)
    return tuner, prior, best


def test_fleet_aggregation_and_min_replicas(session, tmp_path):
    dirs = [str(tmp_path / f"replica{i}") for i in range(3)]
    for i, d in enumerate(dirs):
        _, _, best = _run_replica(session, d, seed=i)
    agg = aggregate_fleet(dirs, WL, source="test")
    cfg, mean_s, replicas = agg[config_key(best)]
    assert cfg == best and replicas == 3
    assert mean_s == pytest.approx(1e-3, rel=0.2)
    assert min(agg.values(), key=lambda it: it[1])[0] == best

    prior = session.resolve_raw(WL)
    cands = ranked_candidates(build_space(WL), 8,
                              exclude=(config_key(prior),))
    best, extra = cands[3], cands[5]
    two = [str(tmp_path / "a"), str(tmp_path / "b")]
    _run_replica(session, two[0], seed=0, candidates=[best])
    _run_replica(session, two[1], seed=1, candidates=[best, extra])
    assert config_key(extra) in aggregate_fleet(two, WL, source="test")
    strict = aggregate_fleet(two, WL, source="test", min_replicas=2)
    assert config_key(extra) not in strict and config_key(best) in strict
    winner, ranked = fleet_prior(two, WL, source="test", min_replicas=2)
    assert winner == best
    assert all(config_key(c) != config_key(extra) for c in ranked)


def test_fleet_warm_tuner_beats_cold_start(session, tmp_path):
    dirs = [str(tmp_path / f"replica{i}") for i in range(2)]
    for i, d in enumerate(dirs):
        _run_replica(session, d, seed=i)
    trace, prior, best = _trace_with_best(session, jitter=0.05, seed=9)
    cold = OnlineTuner(WL, session, budget=64, store=False, source="test")
    replay(cold, trace)
    warm = warm_tuner(WL, dirs, session, source="test", budget=64,
                      store=False)
    assert warm.config() == best
    replay(warm, trace)
    assert cold.result().best_config == best == warm.result().best_config
    assert 0 <= measurements_to_incumbent(warm) \
        < measurements_to_incumbent(cold)


def test_promote_fleet_winner_seeds_session(session, tmp_path):
    from repro_torch.tuning.ml.dataset import dataset_from_db
    dirs = [str(tmp_path / f"replica{i}") for i in range(2)]
    for i, d in enumerate(dirs):
        _, _, best = _run_replica(session, d, seed=i)
    cfg, mean_s, replicas = promote_fleet_winner(session, WL, dirs,
                                                 source="test")
    assert cfg == best and replicas == 2 and mean_s > 0
    assert session.resolve_raw(WL) == best
    assert next(e for e in session.db.entries().values()
                if e["config"] == best)["method"] == "fleet"
    assert len(dataset_from_db(session.db)) == 0
    fresh = OnlineTuner(WL, session, budget=8, store=False, source="test")
    assert fresh.config() == best


def test_fleet_empty_journals_fall_back_to_cold_start(session, tmp_path):
    dirs = [str(tmp_path / "nothing-here")]
    assert aggregate_fleet(dirs, WL, source="test") == {}
    assert fleet_prior(dirs, WL, source="test") == (None, [])
    assert promote_fleet_winner(session, WL, dirs, source="test") is None
    tuner = warm_tuner(WL, dirs, session, source="test", budget=8,
                       store=False)
    assert tuner.config() == session.resolve_raw(WL)


# ---------------------------------------------------------------------------
# The serve CLI end to end, and the engine with a tuner attached
# ---------------------------------------------------------------------------

def test_online_tuner_attached_to_engine(session):
    """A fake clock that charges the config live during the step: the
    faster trial is promoted mid-traffic and persisted."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine
    from repro_torch.tuning import attach

    cfg = get_arch("qwen1.5-0.5b").reduced()
    model = Model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    wl = Workload(op="attention", n=256, batch=2, variant="flash")
    prior = session.resolve_raw(wl)
    fast = ranked_candidates(build_space(wl), 1,
                             exclude=(config_key(prior),))[0]
    tuner = OnlineTuner(wl, session, candidates=[fast], budget=8,
                        min_samples=2, samples_per_trial=3, store=True)

    class ConfigClock:
        t = 0.0

        def __call__(self):
            key = config_key(tuner.config())
            self.t += 0.5e-3 if key == config_key(fast) else 1.0e-3
            return self.t

    eng = ServeEngine(model, max_batch=2, max_len=64, step_timer=ConfigClock())
    attach(eng, tuner)
    rng = np.random.default_rng(0)
    for _ in range(6):
        eng.submit(rng.integers(0, cfg.vocab, size=3), max_new_tokens=4)
    eng.run()
    assert tuner.steps > 0 and tuner.measured <= 8
    assert tuner.promotions == 1 and tuner.incumbent.config == fast
    assert session.lookup(wl) == fast


def test_serve_cli_on_cpu_then_online_replay(tmp_path, monkeypatch, capsys):
    """``launch.serve --device cpu --reduced`` with the tuner, the
    recorder and journals, then ``online-replay`` of its trace twice: the
    same summary both times."""
    from repro_torch.launch import serve as t_serve
    from repro_torch.tuning import session as t_session

    monkeypatch.delenv("REPRO_TORCH_HW_PROFILE", raising=False)
    prev = t_session.set_default_session(
        TunerSession(db_path=str(tmp_path / "db.json")))
    try:
        trace = str(tmp_path / "trace.jsonl")
        assert t_serve.main(["--arch", "qwen1.5-0.5b", "--reduced",
                             "--device", "cpu", "--requests", "6",
                             "--max-new", "8", "--online-tune",
                             "--tune-budget", "12", "--record-trace", trace,
                             "--journal-dir", str(tmp_path / "j")]) == 0
        out = capsys.readouterr().out
        assert "[serve] qwen1.5-0.5b on cpu: 6 requests, 48 tokens" in out
        assert "[online] state=" in out and "[online] trace:" in out
        assert list((tmp_path / "j").glob("*.jsonl"))
        summaries = []
        for i in range(2):
            path = str(tmp_path / f"replay{i}.json")
            assert t_tune.main(["online-replay", "--trace", trace,
                                "--budget", "12", "--json", path]) == 0
            summaries.append(json.loads(open(path).read()))
        assert summaries[0] == summaries[1]
        recorded = ReplayTrace.load(trace)
        assert f"[online] trace: {recorded.steps()} records" in out
        assert len(recorded.configs) > 1      # the trials were recorded
        # passive recording: the resolved incumbent alone, no trials
        passive = str(tmp_path / "passive.jsonl")
        assert t_serve.main(["--arch", "mamba2-130m", "--reduced",
                             "--device", "cpu", "--requests", "2",
                             "--max-new", "3", "--record-trace",
                             passive]) == 0
        assert len(ReplayTrace.load(passive).configs) == 1
    finally:
        t_session.set_default_session(prev)


def test_serve_cli_asks_for_the_card_by_default(monkeypatch):
    """Without --device the CLI builds on CUDA, and raises where there is
    none: no quiet move to the CPU."""
    import torch

    from repro_torch.launch import serve as t_serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_serve.main(["--arch", "qwen1.5-0.5b", "--reduced"])
