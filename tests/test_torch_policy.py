"""Policies, Pareto fronts, analytical pruning and policy-keyed DB entries in
the port (``repro_torch.core.policy``, ``repro_torch.tuning.sweep``,
``repro_torch.tuning.db``, ``repro_torch.tuning.session``) held against
``repro``: the same numpy arithmetic, so scalars, fronts, pruned sets,
journals, DB keys and session winners are exactly equal under tpu_v5e,
gpu_sm and cpu_interpret (both packages' active profile set to one).
Then the port alone: the ``memory_cap`` sweep JAX cannot finish, the
exhaustive strategy under a policy wrapper, and the CLI's ``--policy``."""
import contextlib
import importlib
import json
import math

import numpy as np
import pytest

from repro.core.objective import CostModelObjective as JCost
from repro.core.objective import PENALTY_TIME as J_PENALTY
from repro.core.space import Workload as JWorkload
from repro.core.space import build_space as j_build_space
from repro.tuning.session import TunerSession as JSession
from repro.tuning.sweep import SweepJournal as JJournal
from repro.tuning.sweep import run_sweep as j_run_sweep
from repro_torch.core.objective import CachedObjective
from repro_torch.core.objective import CostModelObjective as TCost
from repro_torch.core.objective import PENALTY_TIME
from repro_torch.core.space import Workload as TWorkload
from repro_torch.core.space import build_space as t_build_space
from repro_torch.tuning import get_strategy
from repro_torch.tuning.session import TunerSession as TSession
from repro_torch.tuning.sweep import SweepJournal as TJournal
from repro_torch.tuning.sweep import run_sweep as t_run_sweep

j_policy = importlib.import_module("repro.core.policy")
t_policy = importlib.import_module("repro_torch.core.policy")
j_profiles = importlib.import_module("repro.hw.profiles")
t_profiles = importlib.import_module("repro_torch.hw.profiles")
j_sweep = importlib.import_module("repro.tuning.sweep")
t_sweep = importlib.import_module("repro_torch.tuning.sweep")

PROFILES = ("tpu_v5e", "gpu_sm", "cpu_interpret")
POLICIES = ("latency", "energy", "edp", "memory_cap")
# small spaces of three op families (42 to 216 configs under the profiles)
CASES = [("scan", "ks", 256, 64), ("tridiag", "pcr", 64, 64),
         ("fft", "stockham", 256, 16)]


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """The GP's solves on one BLAS thread: beside other busy test workers
    a thread pool only contends (both packages run under the same limit,
    so the comparison is unchanged)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@contextlib.contextmanager
def _profile(name):
    """Both packages' active profile set to ``name``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_HW_PROFILE", name)
        mp.setenv("REPRO_TORCH_HW_PROFILE", name)
        yield


def _pair(op, variant, n, batch):
    return (JWorkload(op=op, n=n, batch=batch, variant=variant).canonical(),
            TWorkload(op=op, n=n, batch=batch, variant=variant).canonical())


def _spaces(profile, case):
    jwl, twl = _pair(*case)
    return (j_build_space(jwl, j_profiles.get_profile(profile)),
            t_build_space(twl, t_profiles.get_profile(profile)))


def _policy_arg(name, profile):
    """``memory_cap`` with a cap between the space's smallest and largest
    peak, so it binds (a bare name takes the profile's budget)."""
    if name != "memory_cap":
        return name
    return {"tpu_v5e": "memory_cap:32768", "gpu_sm": "memory_cap:16384",
            "cpu_interpret": "memory_cap:65536"}[profile]


def _cols(space, cost):
    return cost.batch_eval_metrics(space, space.enumerate_valid())


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# Profile distance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a", PROFILES)
@pytest.mark.parametrize("b", PROFILES)
def test_profile_distance_equals_repro(a, b):
    got = t_profiles.profile_distance(t_profiles.get_profile(a),
                                      t_profiles.get_profile(b))
    want = j_profiles.profile_distance(j_profiles.get_profile(a),
                                       j_profiles.get_profile(b))
    assert got == want
    assert (got == 0.0) == (a == b)


@pytest.mark.parametrize("other", PROFILES + ("h100",))
def test_profile_distance_to_h100_is_the_formula(other):
    h100, prof = t_profiles.get_profile("h100"), t_profiles.get_profile(other)
    total = 0.0         # summed in field order (sum() compensates)
    for f in t_profiles._DISTANCE_FIELDS:
        total += abs(math.log2(max(float(getattr(prof, f)), 1e-30)
                               / max(float(getattr(h100, f)), 1e-30)))
    want = total / len(t_profiles._DISTANCE_FIELDS)
    assert t_profiles.profile_distance(prof, h100) == want
    assert t_profiles.profile_distance(h100, prof) == pytest.approx(want,
                                                                    rel=1e-12)
    assert t_profiles._DISTANCE_FIELDS == j_profiles._DISTANCE_FIELDS
    weight = {"gpu_sm": 0.385, "tpu_v5e": 0.068, "cpu_interpret": 0.010,
              "h100": 1.0}[other]
    assert math.exp(-want) == pytest.approx(weight, abs=5e-4)


# ---------------------------------------------------------------------------
# Policies and their scalars
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", PROFILES)
def test_get_policy_equals_repro(profile):
    jprof, tprof = (j_profiles.get_profile(profile),
                    t_profiles.get_profile(profile))
    assert t_policy.policies() == j_policy.policies() == POLICIES
    for name in POLICIES + ("memory_cap:12345", None):
        jp = j_policy.get_policy(name, jprof)
        tp = t_policy.get_policy(name, tprof)
        assert (tp.name, tp.cap_bytes, tp.key, tp.prune_safe) == \
            (jp.name, jp.cap_bytes, jp.key, jp.prune_safe)
        # a policy's key resolves back to it in the port (JAX refuses the
        # memory_cap[<bytes>] form: see test_memory_cap_sweep_*)
        assert t_policy.get_policy(tp.key, tprof) == tp
    with _profile(profile):
        assert t_policy.get_policy("memory_cap").key == \
            j_policy.get_policy("memory_cap").key
    for bad in ("fastest", "memory_cap:x"):
        with pytest.raises(ValueError):
            t_policy.get_policy(bad, tprof)
        with pytest.raises(ValueError):
            j_policy.get_policy(bad, jprof)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("profile", PROFILES)
def test_scalars_equal_repro(profile, policy):
    """``scalarize`` / ``scalarize_cols`` / ``policy_scalar_cols`` over a
    cost-model sweep's columns, with NaN axes and failed rows injected."""
    jspace, tspace = _spaces(profile, CASES[0])
    jprof, tprof = jspace.spec, tspace.spec
    cols = _cols(tspace, TCost(tprof))
    jcols = _cols(jspace, JCost(jprof))
    for name in cols:
        assert np.array_equal(cols[name], jcols[name])
    rng = np.random.default_rng(7)
    cols = {k: v.copy() for k, v in cols.items()}
    rows = rng.choice(len(cols["time_s"]), 6, replace=False)
    cols["energy_j"][rows[:3]] = np.nan          # axes a journal lacked
    cols["time_s"][rows[3:]] = PENALTY_TIME      # failed measurements
    assert PENALTY_TIME == J_PENALTY
    arg = _policy_arg(policy, profile)
    tp, jp = t_policy.get_policy(arg, tprof), j_policy.get_policy(arg, jprof)
    got, want = tp.scalarize_cols(cols), jp.scalarize_cols(cols)
    assert np.array_equal(got, want, equal_nan=True)
    assert np.array_equal(t_policy.policy_scalar_cols(tp, cols),
                          j_policy.policy_scalar_cols(jp, cols))
    for i in range(0, len(got), 7):
        vec = {k: float(v[i]) for k, v in cols.items()}
        s = tp.scalarize(vec)
        assert s == jp.scalarize(vec)
        assert s == got[i] or (math.isinf(s) and math.isinf(got[i]))
    if policy == "memory_cap":      # the cap binds: some rows go infinite
        assert 0 < np.count_nonzero(np.isinf(got)) < len(got)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pareto_mask_equals_repro(seed):
    """Random columns on a coarse grid (many exact ties, dominated and
    duplicate rows) with failed rows; mask and front equal repro's."""
    rng = np.random.default_rng(seed)
    n = 200
    cols = {"time_s": rng.integers(1, 12, n).astype(float),
            "energy_j": rng.integers(1, 12, n).astype(float),
            "peak_vmem_bytes": rng.integers(1, 4, n).astype(float)}
    cols["time_s"][rng.choice(n, 9, replace=False)] = PENALTY_TIME
    cols["energy_j"][:4] = cols["energy_j"][4:8]          # exact ties
    cols["time_s"][:4] = cols["time_s"][4:8]
    cols["peak_vmem_bytes"][:4] = cols["peak_vmem_bytes"][4:8]
    cfgs = [{"i": i} for i in range(n)]
    for names in (None, ("time_s", "energy_j")):
        got = t_policy.pareto_mask(cols, names)
        assert np.array_equal(got, j_policy.pareto_mask(cols, names))
        assert not np.any(got[cols["time_s"] == PENALTY_TIME])
        assert t_policy.pareto_front(cols, cfgs, names) == \
            j_policy.pareto_front(cols, cfgs, names)
    tied = [i for i in range(4) if got[i + 4]]
    assert all(got[i] for i in tied)    # a tie with a front row stays


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("profile", PROFILES)
def test_policy_objective_equals_repro(profile, policy):
    jspace, tspace = _spaces(profile, CASES[1])
    arg = _policy_arg(policy, profile)
    tobj = t_policy.PolicyObjective(TCost(tspace.spec), arg)
    jobj = j_policy.PolicyObjective(JCost(jspace.spec), arg)
    assert tobj.signature() == jobj.signature()
    assert tobj.signature().endswith(f"|policy={tobj.policy.key}")
    assert tobj.metric_names() == jobj.metric_names()
    cfgs = tspace.enumerate_valid()
    assert cfgs == jspace.enumerate_valid()
    for cfg in cfgs[::3]:
        tm, jm = tobj(tspace, cfg), jobj(jspace, cfg)
        assert (tm.time_s, tm.valid, tm.metrics) == \
            (jm.time_s, jm.valid, jm.metrics)
    assert np.array_equal(tobj.batch_eval(tspace, cfgs),
                          jobj.batch_eval(jspace, cfgs))
    tcols = tobj.batch_eval_metrics(tspace, cfgs)
    jcols = jobj.batch_eval_metrics(jspace, cfgs)
    assert sorted(tcols) == sorted(jcols)
    for name in tcols:
        assert np.array_equal(tcols[name], jcols[name])


# ---------------------------------------------------------------------------
# Sweeps: policy winners, fronts, pruning, journals
# ---------------------------------------------------------------------------

def _same_sweep(tres, jres):
    assert tres.best_config == jres.best_config
    assert tres.best_time == jres.best_time
    assert tres.best_scalar == jres.best_scalar
    assert tres.policy == jres.policy
    assert (tres.evaluations, tres.resumed, tres.pruned, tres.total,
            tres.stopped_by) == (jres.evaluations, jres.resumed, jres.pruned,
                                 jres.total, jres.stopped_by)
    assert tres.history == jres.history
    assert tres.pareto == jres.pareto
    assert sorted(tres.metrics) == sorted(jres.metrics)
    for name in tres.metrics:
        assert np.array_equal(tres.metrics[name], jres.metrics[name],
                              equal_nan=True)


@pytest.mark.parametrize("policy", ["energy", "edp", "memory_cap"])
@pytest.mark.parametrize("profile", PROFILES)
def test_run_sweep_under_policy_equals_repro(tmp_path, profile, policy):
    case = CASES[0]
    jspace, tspace = _spaces(profile, case)
    arg = _policy_arg(policy, profile)
    jcost, tcost = JCost(jspace.spec), TCost(tspace.spec)
    jj = JJournal.for_workload(str(tmp_path / "j"), jspace.workload, jcost)
    tj = TJournal.for_workload(str(tmp_path / "t"), tspace.workload, tcost)
    jres = j_run_sweep(jspace, jcost, journal=jj, policy=arg, chunk=50)
    tres = t_run_sweep(tspace, tcost, journal=tj, policy=arg, chunk=50)
    _same_sweep(tres, jres)
    assert tres.policy == t_policy.get_policy(arg, tspace.spec).key
    assert _lines(tj.path) == _lines(jj.path)
    # the journal is keyed by the raw objective: every policy's winner
    # comes out of one set of measurements, resumed without evaluating
    for other in POLICIES:
        oarg = _policy_arg(other, profile)
        tagain = t_run_sweep(tspace, tcost, journal=tj, policy=oarg)
        jagain = j_run_sweep(jspace, jcost, journal=jj, policy=oarg)
        _same_sweep(tagain, jagain)
        assert tagain.evaluations == 0 and tagain.resumed == tres.total


@pytest.mark.parametrize("top_k", [1, 8, 32, 10_000])
@pytest.mark.parametrize("profile", PROFILES)
def test_pruned_sweep_equals_repro(tmp_path, profile, top_k):
    """The kept set, the pruned count, ``stopped_by``, the winner and the
    journal's header and lines equal repro's; a resume measures nothing."""
    case = CASES[2] if top_k == 32 else CASES[0]
    jspace, tspace = _spaces(profile, case)
    jcost, tcost = JCost(jspace.spec), TCost(tspace.spec)
    size = len(tspace.enumerate_valid())
    jj = JJournal.for_workload(str(tmp_path / "j"), jspace.workload, jcost)
    tj = TJournal.for_workload(str(tmp_path / "t"), tspace.workload, tcost)
    jres = j_run_sweep(jspace, jcost, journal=jj, prune="analytical",
                       top_k=top_k)
    tres = t_run_sweep(tspace, tcost, journal=tj, prune="analytical",
                       top_k=top_k)
    _same_sweep(tres, jres)
    kept = min(top_k, size)
    assert (tres.total, tres.pruned) == (kept, size - kept)
    assert tres.stopped_by == ("pruned" if top_k < size else "exhausted")
    assert tres.as_tune_result().evaluations == kept
    lines = _lines(tj.path)
    assert lines == _lines(jj.path)
    assert lines[0]["pruned"] == size - kept
    assert lines[0]["space_size"] == size
    kept_cfgs, dropped = t_sweep.prune_candidates(
        tspace, tspace.enumerate_valid(), top_k)
    assert (kept_cfgs, dropped) == j_sweep.prune_candidates(
        jspace, jspace.enumerate_valid(), top_k)
    again = t_run_sweep(tspace, tcost, journal=tj, prune="analytical",
                        top_k=top_k)
    assert again.evaluations == 0 and again.best_config == tres.best_config


@pytest.mark.parametrize("profile", PROFILES)
def test_prune_refusals_equal_repro(profile):
    jspace, tspace = _spaces(profile, CASES[1])
    jcost, tcost = JCost(jspace.spec), TCost(tspace.spec)
    for kw, msg in ((dict(prune="analytical", policy="energy"), "latency"),
                    (dict(prune="model"), "unknown prune mode"),
                    (dict(prune="analytical", top_k=0), "top_k")):
        with pytest.raises(ValueError, match=msg):
            t_run_sweep(tspace, tcost, **kw)
        with pytest.raises(ValueError, match=msg):
            j_run_sweep(jspace, jcost, **kw)
    # latency itself stays prune-safe
    assert t_run_sweep(tspace, tcost, prune="analytical", top_k=4,
                       policy="latency").stopped_by == "pruned"
    assert t_sweep.DEFAULT_TOP_K == j_sweep.DEFAULT_TOP_K == 64


def test_memory_cap_sweep_finishes_in_the_port():
    """``SweepResult.as_tune_result`` rebuilds the policy from its key.
    JAX's ``get_policy`` refuses the ``memory_cap[<bytes>]`` key, so its
    exhaustive strategy under an explicit cap raises; the port returns the
    same winner and scalars JAX's ``run_sweep`` computed."""
    with _profile("gpu_sm"):
        jspace, tspace = _spaces("gpu_sm", CASES[0])
        arg = _policy_arg("memory_cap", "gpu_sm")
        jres = j_run_sweep(jspace, JCost(jspace.spec), policy=arg)
        with pytest.raises(ValueError, match="unknown policy"):
            jres.as_tune_result()
        tres = t_run_sweep(tspace, TCost(tspace.spec), policy=arg)
        got = tres.as_tune_result()
        scal = j_policy.policy_scalar_cols(
            j_policy.get_policy(arg, jspace.spec), jres.metrics)
        assert got.best_config == jres.best_config
        assert got.best_time == jres.best_scalar
        assert [t for _, t in got.history] == scal.tolist()
        assert got.evaluations == len(scal)


@pytest.mark.parametrize("policy", ["energy", "edp"])
def test_exhaustive_strategy_under_a_policy_wrapper(policy):
    """``get_strategy("exhaustive")`` on a ``PolicyObjective`` sweeps the
    raw objective and picks by the policy's scalar, as ``tune`` does (the
    JAX strategy would rank the wrapper's raw time column)."""
    with _profile("tpu_v5e"):
        _, tspace = _spaces("tpu_v5e", CASES[0])
        cost = TCost(tspace.spec)
        wrapped = t_policy.PolicyObjective(CachedObjective(cost), policy)
        res = get_strategy("exhaustive")(tspace, wrapped)
        want = t_run_sweep(tspace, cost, policy=policy)
        assert res.best_config == want.best_config
        assert res.best_time == want.best_scalar
        assert res.best_time == min(wrapped.batch_eval(
            tspace, tspace.enumerate_valid()))


# ---------------------------------------------------------------------------
# The DB's policy keys, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["repro", "port"])
def test_db_policy_keys_cross_package(tmp_path, writer):
    path = str(tmp_path / "db.json")
    jwl, twl = _pair(*CASES[0])
    jprof, tprof = (j_profiles.get_profile("gpu_sm"),
                    t_profiles.get_profile("gpu_sm"))
    policies = ("latency", "energy", "edp", "memory_cap:32768")
    sessions = {"repro": lambda pol: JSession(db_path=path, spec=jprof,
                                              policy=pol),
                "port": lambda pol: TSession(db_path=path, spec=tprof,
                                             policy=pol)}
    wls = {"repro": jwl, "port": twl}
    reader = "port" if writer == "repro" else "repro"
    stored = {}
    for pol in policies:
        s = sessions[writer](pol)
        s.tune(wls[writer], method="random", max_evals=8, seed=3)
        stored[pol] = s.lookup(wls[writer])
    with open(path) as f:
        keys = sorted(json.load(f)["entries"])
    assert keys == sorted(
        ["gpu_sm|" + twl.key] + [f"gpu_sm|policy={p}|{twl.key}"
                                 for p in ("energy", "edp",
                                           "memory_cap[32768]")])
    for pol in policies:
        other = sessions[reader](pol)
        assert other.lookup(wls[reader]) == stored[pol]
        assert other.resolve_raw(wls[reader]) == stored[pol]
    # an energy winner never answers a latency lookup, and vice versa
    latency = sessions[reader]("latency")
    assert latency.db.lookup(wls[reader], policy="energy") == stored["energy"]
    assert latency.db.lookup(wls[reader]) == stored["latency"]


def test_db_refuses_an_entry_stamped_for_another_policy(tmp_path):
    """``lookup`` checks the entry's policy stamp, in both packages."""
    path = str(tmp_path / "db.json")
    jwl, twl = _pair(*CASES[1])
    TSession(db_path=path, spec=t_profiles.get_profile("tpu_v5e"),
             policy="energy").tune(twl, method="random", max_evals=4, seed=1)
    with open(path) as f:
        data = json.load(f)
    (key, entry), = data["entries"].items()
    data["entries"][key] = dict(entry, policy="edp")
    with open(path, "w") as f:
        json.dump(data, f)
    from repro.tuning.db import TuningDB as JDB
    from repro_torch.tuning.db import TuningDB as TDB
    assert TDB(path, platform="tpu_v5e").lookup(twl, policy="energy") is None
    assert JDB(path, platform="tpu_v5e").lookup(jwl, policy="energy") is None


# ---------------------------------------------------------------------------
# The session under each policy
# ---------------------------------------------------------------------------

# JAX's exhaustive sweep under an explicit cap raises in as_tune_result
# (test_memory_cap_sweep_finishes_in_the_port): that pair is left out
SESSION_CASES = [(p, m) for p in ("energy", "edp", "memory_cap")
                 for m in ("bayesian", "random", "analytical", "online",
                           "exhaustive")
                 if (p, m) != ("memory_cap", "exhaustive")]


@pytest.mark.parametrize("policy,method", SESSION_CASES)
def test_session_tune_resolve_lookup_equal_repro(tmp_path, policy, method):
    """Both sessions tune the same workload under the policy on their own
    DB: the same result, the same stored entry (real seconds and the
    metric vector under the policy's key), the same resolved config; the
    latency key stays untouched."""
    profile = "cpu_interpret"
    arg = _policy_arg(policy, profile)
    jwl, twl = _pair(*CASES[1])
    with _profile(profile):
        js = JSession(db_path=str(tmp_path / "j.json"), policy=arg)
        ts = TSession(db_path=str(tmp_path / "t.json"), policy=arg)
        assert ts.policy == t_policy.get_policy(arg)
        assert ts.policy.key == js.policy.key
        kw = dict(method=method, seed=2, max_evals=8)
        jres, tres = js.tune(jwl, **kw), ts.tune(twl, **kw)
        assert (tres.best_config, tres.best_time, tres.evaluations,
                tres.stopped_by) == (jres.best_config, jres.best_time,
                                     jres.evaluations, jres.stopped_by)
        assert tres.history == jres.history
        assert ts.db.entries() == js.db.entries()
        (entry,) = ts.db.entries().values()
        assert entry["policy"] == ts.policy.key
        assert entry["time_s"] == entry["metrics"]["time_s"]
        assert ts.lookup(twl) == js.lookup(jwl) == tres.best_config
        assert ts.lookup(twl, policy="latency") is None
        assert ts.resolve(twl) == js.resolve(jwl)
        assert ts.resolve_raw(twl) == tres.best_config


@pytest.mark.parametrize("profile", PROFILES)
def test_session_pruned_tune_equals_repro(tmp_path, profile):
    """A pruned exhaustive tune stores ``exhaustive-pruned`` in both."""
    jwl, twl = _pair(*CASES[0])
    with _profile(profile):
        js = JSession(db_path=str(tmp_path / "j.json"))
        ts = TSession(db_path=str(tmp_path / "t.json"))
        jres = js.tune(jwl, method="exhaustive", prune="analytical", top_k=6)
        tres = ts.tune(twl, method="exhaustive", prune="analytical", top_k=6)
        assert (tres.best_config, tres.best_time, tres.evaluations,
                tres.stopped_by) == (jres.best_config, jres.best_time, 6,
                                     "pruned")
        assert ts.db.entries() == js.db.entries()
        (entry,) = ts.db.entries().values()
        assert entry["method"] == "exhaustive-pruned"


def test_session_lru_is_keyed_by_policy(tmp_path):
    """Two sessions on one DB under different policies resolve their own
    winners; a session's cache never answers for another policy."""
    path = str(tmp_path / "db.json")
    twl = TWorkload(op="scan", n=1024, batch=65536, variant="ks").canonical()
    h100 = t_profiles.get_profile("h100")
    lat = TSession(db_path=path, spec=h100)
    lat_cfg = lat.tune(twl, method="exhaustive").best_config
    peak = TCost(h100)(t_build_space(twl, h100), lat_cfg).metrics
    cap = TSession(db_path=path, spec=h100,
                   policy=f"memory_cap:{peak['peak_vmem_bytes'] / 2:.0f}")
    res = cap.tune(twl, method="exhaustive")
    assert res.best_config != lat_cfg
    assert cap.resolve(twl) != lat.resolve(twl)
    assert lat.lookup(twl) == lat_cfg
    assert cap.lookup(twl) == res.best_config
    assert cap.lookup(twl, policy="latency") == lat_cfg
    assert [k[2] for k in cap._resolved] == [cap.policy.key]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_tune_cli_policy(tmp_path, capsys):
    from repro_torch.launch import tune as t_tune
    path = str(tmp_path / "db.json")
    assert t_tune.main(["--device", "cpu", "--objective", "cost", "--op",
                        "tridiag", "--variant", "pcr", "--sizes", "64",
                        "--batch", "64", "--method", "random",
                        "--max-evals", "6", "--policy", "edp",
                        "--db", path]) == 0
    out = capsys.readouterr().out
    assert "edp=" in out
    with open(path) as f:
        (key,) = json.load(f)["entries"]
    assert key.startswith("h100|policy=edp|tridiag:pcr:n64")
