"""Cross-size and cross-device transfer in the port
(``repro_torch.core.transfer``, ``strategy="transfer"``) and the
methodology reports that carry it (``compare_methods(policies=)``,
``compare_methods_matrix``) held against ``repro``: on a journal directory
written by JAX's ``run_sweep`` under tpu_v5e, gpu_sm and cpu_interpret,
both packages build the same priors and weights, visit the same configs,
return the same winner after the same evaluations and print the same
reports.  Then the port alone: the h100 column of the matrix, a wall-clock
journal that is never a source, and the two-command CLI flow."""
import contextlib
import importlib
import json
import os

import numpy as np
import pytest

from repro.core.objective import CachedObjective as JCached
from repro.core.objective import CostModelObjective as JCost
from repro.core.space import Workload as JWorkload
from repro.core.space import build_space as j_build_space
from repro.tuning.session import TunerSession as JSession
from repro.tuning.sweep import SweepJournal as JJournal
from repro.tuning.sweep import run_sweep as j_run_sweep
from repro_torch.core.objective import CachedObjective as TCached
from repro_torch.core.objective import CostModelObjective as TCost
from repro_torch.core.space import Workload as TWorkload
from repro_torch.core.space import build_space as t_build_space
from repro_torch.tuning.session import TunerSession as TSession
from repro_torch.tuning.sweep import make_header

j_transfer = importlib.import_module("repro.core.transfer")
t_transfer = importlib.import_module("repro_torch.core.transfer")
j_profiles = importlib.import_module("repro.hw.profiles")
t_profiles = importlib.import_module("repro_torch.hw.profiles")
j_compare = importlib.import_module("repro.evaluation.compare")
t_compare = importlib.import_module("repro_torch.evaluation.compare")

PROFILES = ("tpu_v5e", "gpu_sm", "cpu_interpret")
# the journaled workloads: two scan sizes (one family, two tasks) and a
# tridiagonal solve; small spaces keep the GP priors a few hundred rows
JOURNALED = [("scan", "ks", 256, 64), ("scan", "ks", 512, 32),
             ("tridiag", "pcr", 64, 64)]


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


@pytest.fixture(scope="module")
def jax_journals(tmp_path_factory):
    """A directory of JAX ``run_sweep`` journals: every JOURNALED workload
    on every profile's cost model (noise 0.02, so the rankings differ
    from the plain model's)."""
    root = str(tmp_path_factory.mktemp("jax_journals"))
    for name in PROFILES:
        prof = j_profiles.get_profile(name)
        cost = JCost(prof, noise=0.02)
        for case in JOURNALED:
            jwl, _ = _pair(*case)
            j_run_sweep(j_build_space(jwl, prof), cost,
                        journal=JJournal.for_workload(root, jwl, cost))
    return root


def _same_result(tres, jres):
    assert tres.best_config == jres.best_config
    assert tres.best_time == jres.best_time
    assert tres.evaluations == jres.evaluations
    assert tres.stopped_by == jres.stopped_by
    assert tres.history == jres.history


def _same_history(th, jh):
    assert th.workload.key == jh.workload.key
    assert th.configs == jh.configs
    assert th.times == jh.times


# ---------------------------------------------------------------------------
# Priors from journals
# ---------------------------------------------------------------------------

def test_op_family_equals_repro():
    for op in ("scan", "ssd", "rglru", "fft", "large_fft", "tridiag",
               "attention", "matmul"):
        assert t_transfer.op_family(op) == j_transfer.op_family(op)


@pytest.mark.parametrize("target", PROFILES + ("h100",))
def test_journal_history_equals_repro(jax_journals, target):
    """Every JAX journal, read for each target: the same slowdowns
    flattened by the same exp(-profile_distance) weight; a journal of the
    target itself is no source."""
    tprof = t_profiles.get_profile(target)
    jprof = j_profiles.get_profile(target if target != "h100" else "gpu_sm")
    seen = 0
    for name in sorted(os.listdir(jax_journals)):
        path = os.path.join(jax_journals, name)
        got = t_transfer.journal_history(path, tprof)
        header = JJournal(path).read_header()
        src = t_transfer._journal_profile(header)
        assert src == j_transfer._journal_profile(header)
        if src == target:
            assert got is None
            continue
        assert got is not None
        hist, w = got
        assert w == np.exp(-t_profiles.profile_distance(
            t_profiles.get_profile(src), tprof))
        assert min(hist.times) == 1.0
        if target != "h100":
            jhist, jw = j_transfer.journal_history(path, jprof)
            assert w == jw
            _same_history(hist, jhist)
        seen += 1
    assert seen == len(JOURNALED) * (len(PROFILES) - (target in PROFILES))


@pytest.mark.parametrize("target", PROFILES)
def test_device_histories_equal_repro(jax_journals, target):
    for case in JOURNALED:
        jwl, twl = _pair(*case)
        th = t_transfer.device_histories(jax_journals, twl,
                                         t_profiles.get_profile(target))
        jh = j_transfer.device_histories(jax_journals, jwl,
                                         j_profiles.get_profile(target))
        assert len(th) == len(jh) == len(PROFILES) - 1
        for a, b in zip(th, jh):
            _same_history(a, b)
    assert t_transfer.device_histories("", twl,
                                       t_profiles.get_profile(target)) == []


def test_a_wallclock_journal_is_no_source(tmp_path):
    """A wall-clock sweep's header names no profile: neither package
    transfers from it (the card's own measurements never seed a search)."""
    _, twl = _pair(*JOURNALED[2])

    class _Wall:
        spec = None

        def signature(self):
            return "wallclock:launch.tune.run:reps=5:warmup=1:device=cuda"

    path = str(tmp_path / "wall.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps(make_header(twl, _Wall(), 42)) + "\n")
        f.write(json.dumps({"k": "a=1", "cfg": {"a": 1}, "t": 1e-3}) + "\n")
    for mod, profs in ((t_transfer, t_profiles), (j_transfer, j_profiles)):
        assert mod._journal_profile(JJournal(path).read_header()) is None
        assert mod.journal_history(path, profs.get_profile("gpu_sm")) is None


# ---------------------------------------------------------------------------
# Searches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_transfer_tuner_across_sizes_equals_repro(seed):
    """Histories of another size (same family) and of another family at the
    same size: the same visited configs, winner and evaluations."""
    with _profile("tpu_v5e"):
        jneigh, tneigh = _pair("scan", "ks", 512, 32)
        jfft, tfft = _pair("fft", "stockham", 256, 16)
        jwl, twl = _pair("scan", "ks", 256, 64)
        jh, th = [], []
        for (jw, tw) in ((jneigh, tneigh), (jfft, tfft)):
            jr = j_run_sweep(j_build_space(jw), JCost(noise=0.05))
            tr = _t_sweep(tw)
            assert tr.history == jr.history
            jh.append(j_transfer.TaskHistory(
                jw, [c for c, _ in jr.history], [t for _, t in jr.history]))
            th.append(t_transfer.TaskHistory(
                tw, [c for c, _ in tr.history], [t for _, t in tr.history]))
        jres = j_transfer.TransferBayesianTuner(seed=seed, max_evals=24).tune(
            j_build_space(jwl), JCached(JCost()), jh)
        tres = t_transfer.TransferBayesianTuner(seed=seed, max_evals=24).tune(
            t_build_space(twl), TCached(TCost()), th)
        _same_result(tres, jres)
        cold = t_transfer.TransferBayesianTuner(seed=seed, max_evals=24).tune(
            t_build_space(twl), TCached(TCost()), ())
        _same_result(cold, j_transfer.TransferBayesianTuner(
            seed=seed, max_evals=24).tune(j_build_space(jwl),
                                          JCached(JCost()), ()))


def _t_sweep(twl):
    from repro_torch.tuning.sweep import run_sweep
    return run_sweep(t_build_space(twl), TCost(noise=0.05))


@pytest.mark.parametrize("target", PROFILES)
def test_transfer_strategy_equals_repro(jax_journals, target):
    """``transfer_strategy`` (and ``strategy="transfer"``) on the JAX
    journal directory: the same configs visited, the same winner, the
    same evaluations, for every journaled workload."""
    from repro.tuning.session import get_strategy as j_get
    from repro_torch.tuning.session import get_strategy as t_get
    jprof, tprof = (j_profiles.get_profile(target),
                    t_profiles.get_profile(target))
    for case in JOURNALED:
        jwl, twl = _pair(*case)
        jsp, tsp = j_build_space(jwl, jprof), t_build_space(twl, tprof)
        jres = j_transfer.transfer_strategy(
            jsp, JCached(JCost(jprof)), seed=1, max_evals=16,
            journal_dir=jax_journals)
        tres = t_transfer.transfer_strategy(
            tsp, TCached(TCost(tprof)), seed=1, max_evals=16,
            journal_dir=jax_journals)
        _same_result(tres, jres)
    # the registered strategy is the same search (the tridiagonal space)
    via = t_get("transfer")(tsp, TCached(TCost(tprof)), seed=1,
                            max_evals=16, journal_dir=jax_journals,
                            prune=None, top_k=None, policy=None)
    _same_result(via, j_get("transfer")(
        jsp, JCached(JCost(jprof)), seed=1, max_evals=16,
        journal_dir=jax_journals))


def test_transfer_seed_equals_repro(jax_journals, tmp_path):
    """Seed a gpu_sm session from the JAX journals: the same winners in
    both packages' DBs, keyed and stamped ``transfer``."""
    js = JSession(db_path=str(tmp_path / "j.json"), platform="gpu_sm")
    ts = TSession(db_path=str(tmp_path / "t.json"), platform="gpu_sm")
    jout = j_transfer.transfer_seed(js, [jax_journals], max_evals=8)
    tout = t_transfer.transfer_seed(ts, [jax_journals], max_evals=8)
    assert sorted(tout) == sorted(jout) == sorted(
        _pair(*c)[1].key for c in JOURNALED)
    for key in tout:
        _same_result(tout[key], jout[key])
    assert ts.db.entries() == js.db.entries()
    assert {e["method"] for e in ts.db.entries().values()} == {"transfer"}
    for case in JOURNALED:
        jwl, twl = _pair(*case)
        assert ts.resolve(twl) == js.resolve(jwl)


def test_tune_family_equals_repro():
    with _profile("gpu_sm"):
        kw = dict(op="scan", variant="ks", sizes=[128, 256, 512],
                  batch_of=lambda n: 2 ** 14 // n, seed=2)
        jout = j_transfer.tune_family(
            objective_factory=lambda: JCached(JCost(noise=0.02)), **kw)
        tout = t_transfer.tune_family(
            objective_factory=lambda: TCached(TCost(noise=0.02)), **kw)
        assert sorted(tout) == sorted(jout)
        for n in tout:
            _same_result(tout[n], jout[n])


@pytest.mark.parametrize("policy", ["latency", "energy"])
def test_session_transfer_tune_equals_repro(jax_journals, tmp_path, policy):
    """``TunerSession.tune(method="transfer")`` with the journal directory
    as its sweep directory, under a policy: the same result and entry."""
    jwl, twl = _pair(*JOURNALED[0])
    with _profile("cpu_interpret"):
        js = JSession(db_path=str(tmp_path / "j.json"), policy=policy,
                      sweep_dir=jax_journals)
        ts = TSession(db_path=str(tmp_path / "t.json"), policy=policy,
                      sweep_dir=jax_journals)
        jres = js.tune(jwl, method="transfer", max_evals=12, seed=4)
        tres = ts.tune(twl, method="transfer", max_evals=12, seed=4)
        _same_result(tres, jres)
        assert ts.db.entries() == js.db.entries()


# ---------------------------------------------------------------------------
# Reports: policies per method, the device matrix
# ---------------------------------------------------------------------------

SUITE = [("scan", "ks", 256, 64), ("tridiag", "pcr", 64, 64),
         ("fft", "stockham", 256, 16)]


def _strip(report):
    """A report as plain JSON (tuples as lists), for equality."""
    return json.loads(json.dumps(report, sort_keys=True))


@pytest.mark.parametrize("profile", PROFILES)
def test_compare_methods_policies_equal_repro(tmp_path, profile):
    methods = ("analytical", "bayesian", "random", "transfer")
    policies = ("latency", "energy", "edp", "memory_cap")
    jwls = [_pair(*c)[0] for c in SUITE]
    twls = [_pair(*c)[1] for c in SUITE]
    with _profile(profile):
        jrep = j_compare.compare_methods(jwls, methods, max_evals=10,
                                         policies=policies)
        trep = t_compare.compare_methods(twls, methods, max_evals=10,
                                         policies=policies)
    assert _strip(trep) == _strip(jrep)
    assert sorted(trep["per_policy"]) == sorted(trep["policies"])
    assert len(trep["policies"]) == 4
    assert t_compare.check_report(trep) == j_compare.check_report(jrep) == []
    assert t_compare.format_report(trep) == j_compare.format_report(jrep)
    assert "energy" in t_compare.format_report(trep)


def test_compare_methods_matrix_equals_repro(tmp_path):
    """The matrix over JAX's default profiles on a shared journal directory
    (transfer warm-starts on the later profiles): equal reports, checks
    and tables."""
    jwls = [_pair(*c)[0] for c in SUITE]
    twls = [_pair(*c)[1] for c in SUITE]
    assert t_compare.DEFAULT_MATRIX_PROFILES == \
        j_compare.DEFAULT_MATRIX_PROFILES
    assert t_compare.DEFAULT_MATRIX_METHODS == \
        j_compare.DEFAULT_MATRIX_METHODS
    kw = dict(max_evals=10, policies=("latency", "edp"))
    jm = j_compare.compare_methods_matrix(
        jwls, journal_dir=str(tmp_path / "j"), **kw)
    tm = t_compare.compare_methods_matrix(
        twls, journal_dir=str(tmp_path / "t"), **kw)
    assert _strip(tm) == _strip(jm)
    assert t_compare.check_matrix(tm) == j_compare.check_matrix(jm) == []
    assert t_compare.format_matrix(tm) == j_compare.format_matrix(jm)
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))


def test_check_matrix_flags_a_beaten_optimum():
    report = {"profiles": ["gpu_sm"], "methods": ["transfer"],
              "reports": {"gpu_sm": {
                  "violations": ["transfer beat exhaustive on w"],
                  "overall": {"transfer": {"phi": 1.01}},
                  "per_policy": {"energy": {"transfer": {"phi": 1.2}}}}}}
    got = t_compare.check_matrix(report)
    assert got == j_compare.check_matrix(report)
    assert len(got) == 3 and all(m.startswith("[gpu_sm] ") for m in got)


def test_matrix_with_h100_reads_both_foreign_profiles(tmp_path):
    """The port's own column: h100 last, its transfer seeded by the
    tpu_v5e and gpu_sm journals the earlier columns wrote."""
    twls = [_pair(*c)[1] for c in SUITE[:2]]
    journals = str(tmp_path / "journals")
    tm = t_compare.compare_methods_matrix(
        twls, profiles=("tpu_v5e", "gpu_sm", "h100"), max_evals=10,
        journal_dir=journals, policies=("latency", "energy", "memory_cap"))
    assert t_compare.check_matrix(tm) == []
    h100 = t_profiles.get_profile("h100")
    for wl in twls:
        hists = t_transfer.device_histories(journals, wl, h100)
        assert len(hists) == 2
    caps = [k for k in tm["reports"]["h100"]["per_policy"]
            if k.startswith("memory_cap")]
    assert caps == [f"memory_cap[{h100.vmem_budget}]"]


def test_transfer_cli_flow(tmp_path, capsys):
    """The two commands: the device matrix writes tpu_v5e / gpu_sm journals
    on the host, then compare-methods (here on the h100 cost model, on the
    card with measured times) reads them for its transfer row."""
    from repro_torch.launch import tune as t_tune
    journals = str(tmp_path / "journals")
    common = ["--op", "tridiag", "--variant", "pcr", "--sizes", "64",
              "--batch", "64", "--max-evals", "8"]
    with pytest.raises(SystemExit) as err:
        t_tune.main(["compare-methods", "--device-matrix", *common])
    assert err.value.code == 2
    assert "--objective cost" in capsys.readouterr().err
    assert t_tune.main(["compare-methods", "--device-matrix", "--objective",
                        "cost", "--profiles", "tpu_v5e,gpu_sm",
                        "--journal-dir", journals, "--policies",
                        "latency,energy", "--json",
                        str(tmp_path / "m.json"), *common]) == 0
    out = capsys.readouterr().out
    assert "gpu_sm" in out and "transfer" in out
    with open(tmp_path / "m.json") as f:
        assert json.load(f)["profiles"] == ["tpu_v5e", "gpu_sm"]
    assert len(os.listdir(journals)) == 2
    assert t_tune.main(["compare-methods", "--device", "cpu", "--objective",
                        "cost", "--methods", "analytical,bayesian,transfer",
                        "--journal-dir", journals, "--policies",
                        "latency,edp", "--json", str(tmp_path / "r.json"),
                        *common]) == 0
    with open(tmp_path / "r.json") as f:
        rep = json.load(f)
    assert rep["profile"] == "h100"
    assert rep["policies"] == ["latency", "edp"]
    assert rep["overall"]["transfer"]["phi"] <= 1.0 + 1e-9
