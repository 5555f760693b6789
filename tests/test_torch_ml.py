"""The ML-based methodology in the port (``repro_torch.tuning.ml``) held
against ``repro.tuning.ml``: features, datasets, journals read across the
packages, fixed-seed forests, artifacts saved by one package and loaded by
the other, the strategy's choices and rungs, ``evaluate_model`` reports and
``compare_methods``' ``ml`` rows — all exactly equal, since both packages
run the same numpy arithmetic.  Then the port alone under ``h100``: a
forest trained on its cost-model sweeps, ``strategy="ml"`` through the
session, the ``train-model`` / ``eval-model`` / ``compare-methods --model``
commands on the CPU, and the card suite's workloads and runners."""
import contextlib
import importlib
import json

import numpy as np
import pytest
import torch

from repro.core.objective import CostModelObjective as JCost
from repro.core.space import Workload as JWorkload
from repro.core.space import build_space as j_build_space
from repro.evaluation.compare import compare_methods as j_compare
from repro.tuning.db import TuningDB as JDB
from repro_torch.core.objective import CachedObjective
from repro_torch.core.objective import CostModelObjective as TCost
from repro_torch.core.space import Workload as TWorkload
from repro_torch.core.space import build_space as t_build_space
from repro_torch.evaluation import check_report
from repro_torch.evaluation import compare_methods as t_compare
from repro_torch.evaluation.compare import DEFAULT_METHODS
from repro_torch.kernels.blocks.driver import capture_launches
from repro_torch.launch import tune as t_tune
from repro_torch.tuning import TunerSession, get_strategy, strategies
from repro_torch.tuning.db import TuningDB as TDB
from repro_torch.tuning.sweep import config_key, make_header

jml = importlib.import_module("repro.tuning.ml")
tml = importlib.import_module("repro_torch.tuning.ml")
j_dataset = importlib.import_module("repro.tuning.ml.dataset")
t_dataset = importlib.import_module("repro_torch.tuning.ml.dataset")
t_forest = importlib.import_module("repro_torch.tuning.ml.forest")
t_sweep = importlib.import_module("repro_torch.tuning.sweep")
j_evaluate = importlib.import_module("repro.tuning.ml.evaluate")
t_evaluate = importlib.import_module("repro_torch.tuning.ml.evaluate")
j_profiles = importlib.import_module("repro.hw.profiles")
t_profiles = importlib.import_module("repro_torch.hw.profiles")

PROFILES = ("tpu_v5e", "gpu_sm", "cpu_interpret")
ML_RUNGS = ("ml", "ml-defer-analytical")


@contextlib.contextmanager
def _profile(name):
    """Both packages' active profile set to ``name``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_HW_PROFILE", name)
        mp.setenv("REPRO_TORCH_HW_PROFILE", name)
        yield


def _batch(op, n):
    return tml.SUITE[op].get("batch") or max(2 ** 26 // n, 1)


def _pair(op, variant, n, batch=None):
    batch = batch or _batch(op, n)
    return (JWorkload(op=op, n=n, batch=batch, variant=variant).canonical(),
            TWorkload(op=op, n=n, batch=batch, variant=variant).canonical())


def _same_dataset(jds, tds):
    assert len(jds) == len(tds) > 0
    assert np.array_equal(jds.X, tds.X)
    assert np.array_equal(jds.y, tds.y)
    assert np.array_equal(jds.group, tds.group)
    assert jds.keys == tds.keys and jds.ops == tds.ops


def _same_split(jsplit, tsplit):
    assert sorted(jsplit) == sorted(tsplit)
    for op in jsplit:
        assert np.array_equal(jsplit[op][0], tsplit[op][0])
        assert np.array_equal(jsplit[op][1], tsplit[op][1])


@pytest.fixture(scope="module")
def tiny_bundle_path(tmp_path_factory):
    """The JAX tests' tiny bundle (every op, first variant, first two train
    sizes, 8 trees of depth 10), trained by the port under tpu_v5e and
    saved; both packages load it."""
    with _profile("tpu_v5e"):
        workloads = []
        for op, spec in tml.SUITE.items():
            for variant in spec["variants"][:1]:
                for n in spec["train"][:2]:
                    workloads.append(TWorkload(op=op, n=n,
                                               batch=_batch(op, n),
                                               variant=variant))
        ds = tml.build_dataset(workloads)
        bundle = tml.train_bundle(ds.by_op(), n_trees=8, max_depth=10,
                                  seed=0, meta={"aliases": t_dataset.POOLED_OPS})
    return bundle.save(str(tmp_path_factory.mktemp("ml") / "tiny.npz"))


# ---------------------------------------------------------------------------
# Features
# ---------------------------------------------------------------------------

def test_feature_layout_equals_repro():
    assert tml.FEATURE_NAMES == jml.FEATURE_NAMES
    assert tml.FEATURE_VERSION == jml.FEATURE_VERSION == 5
    assert tml.N_FEATURES == jml.N_FEATURES
    assert tml.MODEL_SCHEMA == jml.MODEL_SCHEMA == 1
    assert tml.SUITE == jml.SUITE
    assert t_dataset.POOLED_OPS == j_dataset.POOLED_OPS
    assert (t_evaluate.TIE_TOL, t_evaluate.ML_RUNGS) \
        == (j_evaluate.TIE_TOL, j_evaluate.ML_RUNGS)
    assert sorted(tml.__all__) == sorted(jml.__all__)


FEATURE_CASES = [("scan", "lf", 256), ("scan", "ks", 1024),
                 ("scan", "linrec", 512), ("tridiag", "pcr", 128),
                 ("fft", "stockham", 256), ("large_fft", "stockham", 65536),
                 ("ssd", "", 512), ("rglru", "", 256),
                 ("attention", "flash", 2048), ("matmul", "", 1024)]


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("op,variant,n", FEATURE_CASES)
def test_featurize_batch_equals_repro(profile, op, variant, n):
    """Every valid config of the space encodes to the same row."""
    jwl, twl = _pair(op, variant, n)
    with _profile(profile):
        jspace = j_build_space(jwl, j_profiles.get_profile(profile))
        tspace = t_build_space(twl, t_profiles.get_profile(profile))
        jc, tc = jspace.enumerate_valid(), tspace.enumerate_valid()
        assert jc == tc and len(tc) > 0
        X = tml.featurize_batch(tspace, tc)
        assert np.array_equal(jml.featurize_batch(jspace, jc), X)
        assert np.array_equal(jml.featurize(jspace, jc[-1]),
                              tml.featurize(tspace, tc[-1]))
    if op == "ssd":      # the chain-fusion knob takes both values
        assert set(X[:, tml.FEATURE_NAMES.index("fuse")]) == {0.0, 1.0}


def test_h100_device_columns_are_its_own():
    """Under h100 the device columns are the card's: they differ from
    gpu_sm's, the portability signal the v4 columns carry."""
    wl = TWorkload(op="scan", n=1024, batch=65536, variant="ks")
    dev = [i for i, name in enumerate(tml.FEATURE_NAMES)
           if name.startswith("dev_")]
    rows = {}
    for name in ("h100", "gpu_sm"):
        space = t_build_space(wl, t_profiles.get_profile(name))
        rows[name] = tml.featurize_batch(space, space.enumerate_valid())
        assert len(set(map(tuple, rows[name][:, dev]))) == 1
    differ = {tml.FEATURE_NAMES[i] for i in dev
              if rows["h100"][0, i] != rows["gpu_sm"][0, i]}
    assert differ == {"dev_log2_vmem_budget", "dev_log2_bw",
                      "dev_log2_flops_bytes"}
    h100 = t_profiles.get_profile("h100")
    col = tml.FEATURE_NAMES.index
    assert rows["h100"][0, col("dev_log2_bw")] == np.log2(h100.hbm_bandwidth)
    assert rows["h100"][0, col("dev_log2_vmem_budget")] == 17.0


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------

DATASET_CASES = [("scan", "ks", 256), ("fft", "stockham", 128),
                 ("tridiag", "wm", 128), ("ssd", "", 256),
                 ("attention", "flash", 512)]


@pytest.mark.parametrize("profile", PROFILES)
def test_build_dataset_equals_repro(profile):
    pairs = [_pair(*case) for case in DATASET_CASES]
    with _profile(profile):
        jds = jml.build_dataset([j for j, _ in pairs], JCost())
        tds = tml.build_dataset([t for _, t in pairs], TCost())
    _same_dataset(jds, tds)
    _same_split(jds.by_op(), tds.by_op())
    _same_split(jds.by_op({}), tds.by_op({}))


def _fields(wls):
    return [(w.op, w.n, w.batch, w.dtype, w.variant) for w in wls]


def test_suite_split_and_keys_equal_repro():
    for split in ("train", "holdout"):
        for ops in (None, ["scan", "matmul"]):
            assert _fields(tml.suite_workloads(split, ops)) \
                == _fields(jml.suite_workloads(split, ops))
    with pytest.raises(ValueError, match="unknown op"):
        tml.suite_workloads("train", ["moe"])
    holdout = {op: spec["holdout"] for op, spec in tml.SUITE.items()}
    t_parts = tml.split_by_size(tml.suite_workloads("train")
                                + tml.suite_workloads("holdout"), holdout)
    j_parts = jml.split_by_size(jml.suite_workloads("train")
                                + jml.suite_workloads("holdout"), holdout)
    assert [_fields(p) for p in t_parts] == [_fields(p) for p in j_parts]
    for key in ("h100|scan:ks:n512:b131072:float32",
                "tpu_v5e|ssd:default:n256:b192:float32",
                "matmul:default:n1024:b1024:bfloat16", "scan:ks:n512",
                "scan:ks:nx:b4:float32", "scan:ks:n12:bq:float32"):
        got, want = tml.parse_db_key(key), jml.parse_db_key(key)
        assert (None if got is None else _fields([got])) \
            == (None if want is None else _fields([want]))


def test_dataset_from_db_equals_repro(tmp_path):
    """The same DB file gives the same rows: exhaustive winners only, an
    invalid config skipped."""
    path = str(tmp_path / "db.json")
    db = JDB(path=path, platform="tpu_v5e")
    with _profile("tpu_v5e"):
        for i, (op, variant, n) in enumerate(DATASET_CASES):
            jwl, _ = _pair(op, variant, n)
            space = j_build_space(jwl)
            cfg = space.enumerate_valid()[i]
            db.store(jwl, cfg, 1e-3 * (i + 1),
                     "bayesian" if i == 3 else "exhaustive", 5)
        bad, _ = _pair("fft", "stockham", 512)
        db.store(bad, {"radix": 3, "rows_per_program": 1, "tile_n": 512},
                 1e-3, "exhaustive", 5)
        jds = jml.dataset_from_db(JDB(path=path, platform="tpu_v5e"))
        tds = tml.dataset_from_db(TDB(path=path, platform="tpu_v5e"))
    _same_dataset(jds, tds)
    assert len(tds.keys) == len(DATASET_CASES) - 1


# ---------------------------------------------------------------------------
# Journals across the packages
# ---------------------------------------------------------------------------

def test_port_journals_read_in_repro(tmp_path):
    pairs = [_pair("fft", "stockham", 256), _pair("tridiag", "pcr", 128),
             _pair("scan", "linrec", 512)]
    with _profile("tpu_v5e"):
        direct = tml.build_dataset([t for _, t in pairs], TCost(),
                                   journal_dir=str(tmp_path))
        tds = tml.dataset_from_journal_dir(str(tmp_path), objective=TCost())
        jds = jml.dataset_from_journal_dir(str(tmp_path), objective=JCost())
    assert len(list(tmp_path.glob("*.jsonl"))) == len(pairs)
    _same_dataset(jds, tds)
    assert sorted(tds.keys) == sorted(direct.keys)
    assert np.array_equal(np.sort(tds.y), np.sort(direct.y))


def _hand_journal(path, wl, obj, space, entries, pruned):
    header = make_header(wl, obj, len(space.enumerate_valid()))
    header["pruned"] = pruned
    lines = [json.dumps(header, sort_keys=True)]
    lines += [json.dumps({"k": config_key(c), "cfg": c,
                          "t": obj(space, c).time_s}, sort_keys=True)
              for c in entries]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("pruned,part,rows", [(1, 3, 0), (1, 1, None),
                                              (0, 3, None)])
def test_pruned_journal_rule_equals_repro(tmp_path, pruned, part, rows):
    """A pruned sweep's partial journal is skipped by both packages (its
    winner is unguaranteed); once the space is complete, or when the
    sweep was never pruned, it loads.  The header here is written by hand
    (a pruned sweep of the port's own: the next test)."""
    _, twl = _pair("fft", "stockham", 256)
    with _profile("tpu_v5e"):
        space = t_build_space(twl)
        cfgs = space.enumerate_valid()
        keep = cfgs[: len(cfgs) // part]
        path = _hand_journal(tmp_path / "j.jsonl", twl, TCost(), space,
                             keep, pruned)
        tds = tml.dataset_from_journal(path)
        jds = jml.dataset_from_journal(path)
    assert len(tds) == len(jds) == (len(keep) if rows is None else rows)
    if len(tds):
        _same_dataset(jds, tds)


def test_journal_of_another_objective_is_filtered_out(tmp_path):
    _, twl = _pair("fft", "stockham", 256)
    with _profile("tpu_v5e"):
        tml.sweep_workload(twl, TCost(), journal_dir=str(tmp_path))
        tml.sweep_workload(twl, TCost(noise=0.1), journal_dir=str(tmp_path))
        assert len(list(tmp_path.glob("*.jsonl"))) == 2
        for ml_pkg, cost in ((tml, TCost), (jml, JCost)):
            assert len(ml_pkg.dataset_from_journal_dir(
                str(tmp_path), objective=cost()).keys) == 1
            assert len(ml_pkg.dataset_from_journal_dir(
                str(tmp_path)).keys) == 2


def test_port_pruned_sweep_journal_loads_once_complete(tmp_path):
    """A journal left partway through a sweep the port pruned (its header
    records the dropped configs) is skipped by both packages' readers;
    the full sweep resumed into it completes the space, and then both
    load it, equal to a never-pruned sweep's rows."""
    _, twl = _pair("fft", "stockham", 256)
    with _profile("tpu_v5e"):
        space, cost = t_build_space(twl), TCost()
        journal = t_sweep.SweepJournal.for_workload(str(tmp_path), twl, cost)
        res = t_sweep.run_sweep(space, cost, journal=journal,
                                prune="analytical", top_k=8)
        assert res.stopped_by == "pruned" and res.pruned > 0
        assert journal.read_header()["pruned"] == res.pruned
        for ml_pkg in (tml, jml):
            assert len(ml_pkg.dataset_from_journal(journal.path)) == 0
            assert len(ml_pkg.dataset_from_journal_dir(str(tmp_path))) == 0
        full = t_sweep.run_sweep(space, cost, journal=journal)
        assert (full.evaluations, full.resumed) == (res.pruned, 8)
        tds = tml.dataset_from_journal(journal.path)
        jds = jml.dataset_from_journal(journal.path)
        _same_dataset(jds, tds)
        assert len(tds) == len(space.enumerate_valid())
        # the pruned part's rows come first: the same rows, journal order
        direct = tml.build_dataset([twl], cost)
        assert np.array_equal(np.sort(tds.y), np.sort(direct.y))
        assert sorted(map(tuple, tds.X)) == sorted(map(tuple, direct.X))


@pytest.mark.parametrize("fn", ["sweep_workload", "build_dataset",
                                "dataset_from_journal",
                                "dataset_from_journal_dir"])
def test_policies_other_than_latency_raise(tmp_path, fn):
    """Kept name, new check: each dataset source labels its groups with a
    non-latency policy's scalars (energy) exactly as repro's does, and not
    with times (it raised until ``core/policy.py`` was ported)."""
    jwl, twl = _pair("fft", "stockham", 256)
    with _profile("tpu_v5e"):
        if fn in ("dataset_from_journal", "dataset_from_journal_dir"):
            t_sweep.run_sweep(t_build_space(twl), TCost(),
                              journal=t_sweep.SweepJournal.for_workload(
                                  str(tmp_path), twl, TCost()))
        path = str(next(tmp_path.glob("*.jsonl"), tmp_path / "none.jsonl"))
        args = {"sweep_workload": (jwl, twl), "build_dataset": ([jwl], [twl]),
                "dataset_from_journal": (path, path),
                "dataset_from_journal_dir": (str(tmp_path), str(tmp_path))}
        jarg, targ = args[fn]
        kw = {"objective": TCost()} if fn in ("sweep_workload",
                                              "build_dataset") else {}
        jkw = {"objective": JCost()} if kw else {}
        got = getattr(tml, fn)(targ, policy="energy", **kw)
        want = getattr(jml, fn)(jarg, policy="energy", **jkw)
        times = getattr(tml, fn)(targ, policy="latency", **kw)
    if fn == "sweep_workload":
        assert got[0] == want[0]
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[2], want[2])
        assert not np.array_equal(got[2], times[2])
    else:
        _same_dataset(want, got)
        assert not np.array_equal(got.y, times.y)


# ---------------------------------------------------------------------------
# Forests and artifacts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,bootstrap", [(0, True), (3, False)])
def test_forest_fit_equals_repro(seed, bootstrap):
    with _profile("tpu_v5e"):
        ds = tml.build_dataset([_pair(*c)[1] for c in DATASET_CASES[:3]],
                               TCost())
    kw = dict(n_trees=6, max_depth=8, seed=seed, bootstrap=bootstrap)
    tf = tml.Forest.fit(ds.X, ds.y, **kw)
    jf = jml.Forest.fit(ds.X, ds.y, **kw)
    assert np.array_equal(tf.predict_all(ds.X), jf.predict_all(ds.X))
    for tt, jt in zip(tf.trees, jf.trees):
        for field in t_forest._TREE_FIELDS:
            assert np.array_equal(getattr(tt, field), getattr(jt, field))


def _holdout_rows(profile="tpu_v5e"):
    wl = TWorkload(op="scan", n=512, batch=131072, variant="ks")
    space = t_build_space(wl, t_profiles.get_profile(profile))
    return tml.featurize_batch(space, space.enumerate_valid())


def test_port_artifact_loads_in_repro(tiny_bundle_path):
    t_b = tml.ModelBundle.load(tiny_bundle_path)
    j_b = jml.ModelBundle.load(tiny_bundle_path)
    assert t_b.ops() == j_b.ops() and t_b.meta == j_b.meta
    X = _holdout_rows()
    for op in t_b.ops():
        assert np.array_equal(t_b.forest_for(op).predict_all(X),
                              j_b.forest_for(op).predict_all(X))


def test_repro_artifact_loads_in_port(tmp_path):
    wls = [_pair("scan", "ks", n)[0] for n in (128, 256)]
    with _profile("tpu_v5e"):
        ds = jml.build_dataset(wls)
    j_b = jml.train_bundle(ds.by_op(), n_trees=4, max_depth=6, seed=1,
                           meta={"aliases": j_dataset.POOLED_OPS})
    path = j_b.save(str(tmp_path / "jax.npz"))
    t_b = tml.ModelBundle.load(path)
    assert t_b.ops() == ("rglru", "scan", "ssd")
    X = _holdout_rows()
    assert np.array_equal(t_b.forest_for("ssd").predict_all(X),
                          j_b.forest_for("scan").predict_all(X))


@pytest.mark.parametrize("field,value", [("schema", 0),
                                         ("feature_version", 4)])
def test_stale_artifact_raises(tmp_path, tiny_bundle_path, field, value):
    bundle = tml.ModelBundle.load(tiny_bundle_path)
    bundle.meta[field] = value
    path = bundle.save(str(tmp_path / "stale.npz"))
    with pytest.raises(tml.ModelArtifactError):
        tml.ModelBundle.load(path)
    with pytest.raises(tml.ModelArtifactError, match="no model artifact"):
        tml.ModelBundle.load(str(tmp_path / "missing.npz"))
    (tmp_path / "corrupt.npz").write_bytes(b"not a zip")
    with pytest.raises(tml.ModelArtifactError, match="unreadable"):
        tml.ModelBundle.load(str(tmp_path / "corrupt.npz"))


# ---------------------------------------------------------------------------
# The strategy: choices and rungs
# ---------------------------------------------------------------------------

HOLDOUT = [(w.op, w.variant, w.n) for w in jml.suite_workloads("holdout")]


@pytest.mark.parametrize("op,variant,n", HOLDOUT)
def test_choose_equals_repro(tiny_bundle_path, op, variant, n):
    jwl, twl = _pair(op, variant, n)
    with _profile("tpu_v5e"):
        jspace, tspace = j_build_space(jwl), t_build_space(twl)
        cfgs = tspace.enumerate_valid()
        t_s = tml.MLStrategy(model=tml.ModelBundle.load(tiny_bundle_path))
        j_s = jml.MLStrategy(model=jml.ModelBundle.load(tiny_bundle_path))
        got = t_s.choose(tspace, cfgs)
        assert got == j_s.choose(jspace, jspace.enumerate_valid())
    assert got[1] in ML_RUNGS


def test_every_fallback_rung_equals_repro(tmp_path, tiny_bundle_path,
                                          monkeypatch):
    jwl, twl = _pair("scan", "ks", 512)
    mm_j, mm_t = _pair("matmul", "", 1024)
    monkeypatch.setenv("REPRO_HW_PROFILE", "tpu_v5e")
    monkeypatch.setenv("REPRO_TORCH_HW_PROFILE", "tpu_v5e")
    t_full = tml.ModelBundle.load(tiny_bundle_path)
    j_full = jml.ModelBundle.load(tiny_bundle_path)
    ladders = [
        ({"model_path": str(tmp_path / "missing.npz")}, {}, twl, jwl,
         "ml-fallback:no-model"),
        ({"model": tml.ModelBundle({"scan": t_full.forests["scan"]}, {})},
         {"model": jml.ModelBundle({"scan": j_full.forests["scan"]}, {})},
         mm_t, mm_j, "ml-fallback:no-forest:matmul"),
        ({"model": t_full, "max_std": -1.0},
         {"model": j_full, "max_std": -1.0}, twl, jwl,
         "ml-fallback:low-confidence"),
    ]
    for t_kw, j_kw, t_wl, j_wl, rung in ladders:
        j_kw = j_kw or t_kw
        tspace, jspace = t_build_space(t_wl), j_build_space(j_wl)
        got = tml.MLStrategy(**t_kw).choose(tspace, tspace.enumerate_valid())
        assert got == jml.MLStrategy(**j_kw).choose(
            jspace, jspace.enumerate_valid())
        assert got[1] == rung
        res = tml.MLStrategy(**t_kw).tune(tspace, TCost())
        assert res.stopped_by == rung and res.evaluations == 0


def test_registry_reads_the_ports_own_artifact_variable(
        tmp_path, tiny_bundle_path, monkeypatch):
    """strategy="ml" reads $REPRO_TORCH_ML_MODEL at call time, never the
    JAX package's $REPRO_ML_MODEL."""
    assert "ml" in strategies()
    monkeypatch.setenv("REPRO_TORCH_HW_PROFILE", "tpu_v5e")
    space = t_build_space(_pair("scan", "ks", 512)[1])
    monkeypatch.setenv("REPRO_ML_MODEL", tiny_bundle_path)
    monkeypatch.setenv("REPRO_TORCH_ML_MODEL", str(tmp_path / "none.npz"))
    assert tml.default_model_path() == str(tmp_path / "none.npz")
    res = get_strategy("ml")(space, CachedObjective(TCost()))
    assert res.stopped_by == "ml-fallback:no-model"
    monkeypatch.setenv("REPRO_TORCH_ML_MODEL", tiny_bundle_path)
    res = get_strategy("ml")(space, CachedObjective(TCost()))
    assert res.stopped_by in ML_RUNGS and space.is_valid(res.best_config)
    monkeypatch.delenv("REPRO_TORCH_ML_MODEL")
    assert tml.default_model_path().endswith("artifacts/ml_model_torch.npz")


# ---------------------------------------------------------------------------
# evaluate_model and compare_methods
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["scan", "fft"])
def test_evaluate_model_equals_repro(tiny_bundle_path, op):
    with _profile("tpu_v5e"):
        t_rep = tml.evaluate_model(tml.ModelBundle.load(tiny_bundle_path),
                                   tml.suite_workloads("holdout", [op]))
        j_rep = jml.evaluate_model(jml.ModelBundle.load(tiny_bundle_path),
                                   jml.suite_workloads("holdout", [op]))
    assert t_rep == j_rep
    assert t_rep["ml_rate"] == 1.0 and t_rep["mean_slowdown"] >= 1.0
    assert tml.check_floors(t_rep, min_top1=1.01)
    assert tml.check_floors({"n_scored": 0}) == ["no workloads were scored"]


@pytest.mark.parametrize("profile", PROFILES)
def test_compare_methods_ml_row_equals_repro(tiny_bundle_path, monkeypatch,
                                             profile):
    monkeypatch.setenv("REPRO_ML_MODEL", tiny_bundle_path)
    monkeypatch.setenv("REPRO_TORCH_ML_MODEL", tiny_bundle_path)
    pairs = [_pair("scan", "ks", 512), _pair("fft", "stockham", 256)]
    methods = ("exhaustive", "analytical", "ml")
    jrep = j_compare([j for j, _ in pairs], methods,
                     profile=j_profiles.get_profile(profile))
    trep = t_compare([t for _, t in pairs], methods,
                     profile=t_profiles.get_profile(profile))
    for jrow, trow in zip(jrep["workloads"], trep["workloads"]):
        assert trow["methods"]["ml"] == jrow["methods"]["ml"]
    assert trep["overall"]["ml"] == jrep["overall"]["ml"]
    assert check_report(trep) == []


def test_default_methods_take_ml_after_analytical():
    assert DEFAULT_METHODS == ("exhaustive", "analytical", "ml", "online",
                               "bayesian", "random")


# ---------------------------------------------------------------------------
# The port under h100
# ---------------------------------------------------------------------------

H100_OPS = ["scan", "tridiag", "fft", "matmul"]


@pytest.fixture(scope="module")
def h100_model(tmp_path_factory):
    """A forest trained on the h100 cost model's sweeps of a reduced suite
    (first variant, two train sizes a family)."""
    wls = [w for w in tml.suite_workloads("train", H100_OPS)
           if w.variant == tml.SUITE[w.op]["variants"][0]
           and w.n in tml.SUITE[w.op]["train"][:2]]
    ds = tml.build_dataset(wls, TCost(t_profiles.get_profile("h100")))
    bundle = tml.train_bundle(ds.by_op(), n_trees=8, max_depth=10, seed=0,
                              meta={"aliases": t_dataset.POOLED_OPS})
    return bundle.save(str(tmp_path_factory.mktemp("h100") / "ml.npz"))


def test_h100_forest_scores_the_holdout_within_phi(h100_model, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_HW_PROFILE", raising=False)
    monkeypatch.setenv("REPRO_TORCH_ML_MODEL", h100_model)
    hold = [w for w in tml.suite_workloads("holdout", H100_OPS)
            if w.variant == tml.SUITE[w.op]["variants"][0]]
    report = tml.evaluate_model(tml.ModelBundle.load(h100_model), hold)
    assert report["n_scored"] == len(hold)
    assert not any(r.startswith(("ml-fallback:no-model",
                                 "ml-fallback:no-forest"))
                   for r in report["rungs"])
    rep = t_compare(hold, DEFAULT_METHODS)
    assert rep["profile"] == "h100"
    assert check_report(rep) == []
    assert 0.0 < rep["overall"]["ml"]["phi"] <= 1.0
    assert all(row["methods"]["ml"]["evaluations"] == 0
               for row in rep["workloads"])


def test_session_tune_ml_persists_method_ml(tmp_path, h100_model,
                                            monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_HW_PROFILE", raising=False)
    monkeypatch.setenv("REPRO_TORCH_ML_MODEL", h100_model)
    wl = TWorkload(op="scan", n=512, batch=131072, variant="ks")
    session = TunerSession(db_path=str(tmp_path / "db.json"))
    res = session.tune(wl, method="ml")
    assert res.stopped_by in ML_RUNGS and res.evaluations == 0
    entry = session.db.entries()["h100|scan:ks:n512:b131072:float32"]
    assert entry["method"] == "ml" and entry["config"] == res.best_config
    assert session.lookup(wl) == res.best_config
    on_disk = json.loads((tmp_path / "db.json").read_text())["entries"]
    assert on_disk["h100|scan:ks:n512:b131072:float32"]["method"] == "ml"


def test_cli_train_eval_compare_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("REPRO_TORCH_HW_PROFILE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_ML_MODEL", raising=False)
    model, db = str(tmp_path / "ml.npz"), str(tmp_path / "db.json")
    cost = ["--device", "cpu", "--objective", "cost"]
    assert t_tune.main(["train-model", *cost, "--ops", "scan", "--out",
                        model, "--trees", "4", "--depth", "6", "--db", db,
                        "--journal-dir", str(tmp_path / "train")]) == 0
    assert set(tml.ModelBundle.load(model).forests) == {"scan"}
    assert len(json.loads(open(db).read())["entries"]) == 12
    assert len(list((tmp_path / "train").glob("*.jsonl"))) == 12
    out = tmp_path / "eval.json"
    assert t_tune.main(["eval-model", *cost, "--ops", "scan", "--model",
                        model, "--json", str(out), "--min-ml-rate", "0.5",
                        "--journal-dir", str(tmp_path / "hold")]) == 0
    report = json.loads(out.read_text())
    assert report["n_scored"] == 6 and report["ml_rate"] >= 0.5
    assert t_tune.main(["eval-model", *cost, "--ops", "scan", "--model",
                        model, "--min-top1", "1.01"]) == 1
    rep = tmp_path / "compare.json"
    assert t_tune.main(["compare-methods", *cost, "--sizes", "512",
                        "--model", model, "--json", str(rep)]) == 0
    row = json.loads(rep.read_text())["workloads"][0]
    assert set(row["methods"]) == set(DEFAULT_METHODS)
    assert row["methods"]["ml"]["stopped_by"] in ML_RUNGS
    split = tmp_path / "split.json"
    assert t_tune.main(["compare-methods", *cost, "--split", "holdout",
                        "--ops", "scan,fft", "--model", model, "--methods",
                        "exhaustive,analytical,ml", "--json",
                        str(split)]) == 0
    assert [w["workload"] for w in json.loads(split.read_text())[
        "workloads"]] == [w.key for w in tml.suite_workloads(
            "holdout", ["scan", "fft"])]
    printed = capsys.readouterr().out
    assert "[train-model] saved" in printed and "[eval-model]" in printed


@pytest.mark.parametrize("cmd", [["train-model", "--out", "m.npz"],
                                 ["eval-model", "--model", "m.npz"]])
def test_cli_wallclock_needs_the_card(monkeypatch, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_tune.main(cmd)


def test_card_suite_is_the_suite_at_sizes_the_card_holds():
    """SUITE's sizes and split; ssd at the mamba2-130m prefill's rows,
    attention and matmul in bf16, the large_fft size that fft runs in one
    launch under h100 (n = 8192) left out."""
    for split in ("train", "holdout"):
        card = t_tune.card_workloads(split)
        suite = [w for w in tml.suite_workloads(split)
                 if (w.op, w.n) != ("large_fft", 8192)]
        assert [(w.op, w.n) for w in card] == [(w.op, w.n) for w in suite]
        for wl in card:
            assert t_build_space(wl).enumerate_valid()
            want = {"ssd": ("chunked", 192, "float32"),
                    "attention": ("flash", 64, "bfloat16"),
                    "matmul": ("tiled", 1024, "bfloat16")}.get(
                        wl.op, (tml.SUITE[wl.op]["variants"], 2 ** 26 // wl.n,
                                "float32"))
            assert (wl.variant in want[0], wl.batch, wl.dtype) \
                == (True, want[1], want[2])
    assert len(t_tune.card_workloads("train")) == 40
    assert len(t_tune.card_workloads("holdout")) == 16


def test_the_linrec_runner_times_the_linear_recurrence():
    """A scan linrec workload runs ``linear_recurrence`` on (a, b), not the
    prefix sum (the runner used to time ``prefix_sum`` under the linrec
    configs)."""
    from repro_torch.kernels.scan.ops import linear_recurrence, prefix_sum
    run = t_tune.make_scan_runner(torch.device("cpu"), seed=5)
    for variant in ("linrec", "ks"):
        wl = TWorkload(op="scan", n=256, batch=8, variant=variant)
        cfg = t_build_space(wl).enumerate_valid()[0]
        thunk = run(wl, cfg)
        with capture_launches() as launched:
            got = thunk()
        gen = torch.Generator().manual_seed(5)
        if variant == "linrec":
            a = torch.rand(8, 256, generator=gen) * 0.19 + 0.8
            want = linear_recurrence(a, torch.randn(8, 256, generator=gen),
                                     config=cfg)
        else:
            want = prefix_sum(torch.randn(8, 256, generator=gen),
                              variant="ks", config=cfg)
        assert launched and torch.equal(got, want)


def test_suite_runner_holds_one_workloads_input():
    made = []

    def factory(device, seed):
        def run(wl, cfg):
            made.append((wl.op, wl.key))
            return lambda: None
        return run

    ops = dict(t_tune._OPS)
    try:
        for op in ops:
            t_tune._OPS[op] = (factory, ops[op][1])
        run = t_tune.make_suite_runner(torch.device("cpu"))
        for op in ("scan", "scan", "fft", "large_fft"):
            run(TWorkload(op=op, n=64, batch=2), {})
    finally:
        t_tune._OPS.update(ops)
    assert [op for op, _ in made] == ["scan", "scan", "fft", "large_fft"]
    calls = []
    get = t_tune._latest(lambda wl: calls.append(wl.key) or object())
    a, b = TWorkload(op="scan", n=64), TWorkload(op="scan", n=128)
    assert get(a) is get(a)
    get(b)
    get(a)
    assert calls == [a.key, b.key, a.key]


def test_sweep_into_seeds_the_cache_from_the_journals(tmp_path):
    """The holdout is measured once: a second reader resumes the journals
    and answers every config from the seeded cache."""
    wls = [TWorkload(op="fft", n=256, batch=2 ** 18, variant="stockham")]
    first = CachedObjective(TCost())
    t_tune.sweep_into(first, wls, str(tmp_path))
    n = first.evaluations
    assert n == len(t_build_space(wls[0]).enumerate_valid())

    class Boom(TCost):
        def signature(self):
            return TCost().signature()

        def __call__(self, space, cfg):
            raise AssertionError("re-measured")

        def batch_eval_metrics(self, *a, **kw):
            raise AssertionError("re-measured")

    second = CachedObjective(Boom())
    t_tune.sweep_into(second, wls, str(tmp_path))
    assert second.evaluations == 0
    times = tml.sweep_workload(wls[0], second)[2]
    assert np.array_equal(times, tml.sweep_workload(wls[0], first)[2])
