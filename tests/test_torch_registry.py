"""The port's registry enumeration and the rest of ``repro_torch.tuning``'s
public API, held against ``repro.tuning`` on the same workloads.

``known_ops`` / ``registered_kernels`` / ``get_kernel`` enumerate every
tuned entry point, so the ML suite and the differential table can be held
to cover them (``test_torch_differential.py``).  The module-level
``resolve`` / ``suggest`` / ``tune`` delegate to the default session, which
each test swaps for one on a temporary DB and restores; ``register_strategy``
writes a module-level table, which each test restores too.
"""
import importlib
import json

import pytest

import repro.tuning as jt
from repro.core.space import Workload as JWorkload
from repro.launch.tune import tune_suite as j_tune_suite
from repro.tuning import registry as j_registry
from repro.tuning.ml.dataset import SUITE as J_SUITE
import repro_torch.tuning as tt
from repro_torch.core.space import Workload as TWorkload
from repro_torch.launch import tune as t_tune
from repro_torch.tuning import registry as t_registry
from repro_torch.tuning.ml.dataset import SUITE as T_SUITE

j_session = importlib.import_module("repro.tuning.session")
t_session = importlib.import_module("repro_torch.tuning.session")
j_profiles = importlib.import_module("repro.hw.profiles")
t_profiles = importlib.import_module("repro_torch.hw.profiles")

WORKLOADS = [("scan", 1024, 64, "ks"), ("scan", 4096, 16, "linrec"),
             ("tridiag", 256, 256, "pcr"), ("fft", 1024, 64, "stockham"),
             ("rglru", 2048, 64, ""), ("matmul", 512, 256, "tiled")]


def _all_registered(registry):
    for op in registry._OP_MODULES:
        registry._ensure_registered(op)
    return registry.registered_kernels()


@pytest.fixture
def sessions(tmp_path):
    """Both packages' default sessions on temporary DBs under tpu_v5e (the
    profile both packages have), restored afterwards."""
    jsess = jt.TunerSession(db_path=str(tmp_path / "jax_db.json"),
                            spec=j_profiles.get_profile("tpu_v5e"))
    tsess = tt.TunerSession(db_path=str(tmp_path / "torch_db.json"),
                            spec=t_profiles.get_profile("tpu_v5e"))
    j_prev = jt.set_default_session(jsess)
    t_prev = tt.set_default_session(tsess)
    try:
        yield jsess, tsess
    finally:
        jt.set_default_session(j_prev)
        tt.set_default_session(t_prev)


def test_known_ops_match_repro_and_the_ml_suite():
    _all_registered(t_registry)
    _all_registered(j_registry)
    assert set(t_registry.known_ops()) == set(j_registry.known_ops()) \
        == set(T_SUITE) == set(J_SUITE)
    assert "large_fft" in t_registry.known_ops()


def test_registered_entry_points_match_repro():
    tk, jk = _all_registered(t_registry), _all_registered(j_registry)
    assert set(tk) == set(jk)
    assert {s.entry_name for s in tk.values()} \
        == {s.entry_name for s in jk.values()}
    for key in tk:
        assert (tk[key].op, tk[key].entry_name, tk[key].variants) \
            == (jk[key].op, jk[key].entry_name, jk[key].variants)
    # the fft entry point serves two ops: the collision key keeps both
    assert tk["large_fft:fft"].op == "large_fft" and tk["fft"].op == "fft"


@pytest.mark.parametrize("name", ["prefix_sum", "linear_recurrence", "solve",
                                  "fft", "large_fft:fft", "matmul", "scan",
                                  "tridiag", "large_fft", "attention",
                                  "ssd", "rglru"])
def test_get_kernel_by_entry_name_and_by_op(name):
    _all_registered(t_registry)
    tspec, jspec = tt.get_kernel(name), jt.get_kernel(name)
    assert (tspec.op, tspec.entry_name, tspec.variants) \
        == (jspec.op, jspec.entry_name, jspec.variants)
    assert tspec.kernel is not None and tspec.space is not None


def test_get_kernel_raises_for_an_unknown_name():
    with pytest.raises(KeyError, match="no tuned kernel"):
        tt.get_kernel("no_such_kernel")


def test_public_exports_match_repro():
    for name in ("get_kernel", "registered_kernels", "register_strategy",
                 "overrides_active", "fit_block", "normalize_config",
                 "resolve", "tune", "suggest"):
        assert name in tt.__all__ and callable(getattr(tt, name))
    assert tt.fit_block(256, 65) == jt.fit_block(256, 65) == 65
    assert tt.normalize_config({"tile_n": 512}, TWorkload(
        op="scan", n=256, batch=8)) == jt.normalize_config(
        {"tile_n": 512}, JWorkload(op="scan", n=256, batch=8))


def test_overrides_active_matches_repro():
    assert tt.overrides_active() is jt.overrides_active() is False
    with tt.overrides(scan={"radix": 4}), jt.overrides(scan={"radix": 4}):
        assert tt.overrides_active() is jt.overrides_active() is True
        with tt.overrides(fft={"radix": 2}):
            assert tt.overrides_active()
        assert tt.overrides_active()
    assert tt.overrides_active() is jt.overrides_active() is False


def _first_valid(space, objective, *, seed=0, max_evals=0, **_):
    """A toy strategy: the first valid config, measured once."""
    cfg = space.enumerate_valid()[0]
    m = objective(space, cfg)
    return cfg, m


@pytest.mark.parametrize("op,n,batch,variant", WORKLOADS[:3])
def test_register_strategy_matches_repro(monkeypatch, sessions, op, n,
                                         batch, variant):
    monkeypatch.setattr(t_session, "_STRATEGIES",
                        dict(t_session._STRATEGIES))
    monkeypatch.setattr(j_session, "_STRATEGIES",
                        dict(j_session._STRATEGIES))

    def strategy(result_cls):
        def run(space, objective, **kw):
            cfg, m = _first_valid(space, objective, **kw)
            return result_cls(best_config=cfg, best_time=m.time_s,
                              evaluations=1, history=[(cfg, m.time_s)],
                              stopped_by="first")
        return run

    tt.register_strategy("first", strategy(tt.TuneResult))
    jt.register_strategy("first", strategy(jt.TuneResult))
    assert "first" in tt.strategies() and "first" in jt.strategies()
    tres = tt.tune(TWorkload(op=op, n=n, batch=batch, variant=variant),
                   method="first")
    jres = jt.tune(JWorkload(op=op, n=n, batch=batch, variant=variant),
                   method="first")
    assert tres.best_config == jres.best_config
    assert tres.best_time == pytest.approx(jres.best_time, rel=1e-12)
    assert tres.evaluations == jres.evaluations == 1


def test_register_strategy_is_undone_between_tests():
    assert "first" not in tt.strategies()
    assert "first" not in jt.strategies()


@pytest.mark.parametrize("op,n,batch,variant", WORKLOADS)
def test_module_level_resolve_suggest_tune_match_repro(sessions, op, n,
                                                       batch, variant):
    jsess, tsess = sessions
    twl = TWorkload(op=op, n=n, batch=batch, variant=variant)
    jwl = JWorkload(op=op, n=n, batch=batch, variant=variant)
    assert tt.suggest(twl) == jt.suggest(jwl)
    assert tt.resolve(twl) == jt.resolve(jwl)
    tres = tt.tune(twl, method="analytical")
    jres = jt.tune(jwl, method="analytical")
    assert tres.best_config == jres.best_config
    assert tres.evaluations == jres.evaluations
    assert tres.best_time == pytest.approx(jres.best_time, rel=1e-12)
    # the winner persisted into each default session's DB alike
    assert tsess.lookup(twl) == jsess.lookup(jwl) == tres.best_config
    assert tt.resolve(twl) == jt.resolve(jwl)


def test_paper_suite_writes_the_winners_of_repro(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_HW_PROFILE", "tpu_v5e")
    monkeypatch.setenv("REPRO_TORCH_HW_PROFILE", "tpu_v5e")
    t_path, j_path = tmp_path / "torch_db.json", tmp_path / "jax_db.json"
    assert t_tune.main(["--paper-suite", "--method", "analytical", "--db",
                        str(t_path)]) == 0
    j_tune_suite("analytical", verbose=False,
                 session=jt.TunerSession(db_path=str(j_path)))
    t_db, j_db = json.loads(t_path.read_text()), json.loads(j_path.read_text())
    t_entries, j_entries = t_db["entries"], j_db["entries"]
    assert len(t_entries) == 43
    assert set(t_entries) == set(j_entries)
    for key, entry in t_entries.items():
        want = j_entries[key]
        assert entry["config"] == want["config"], key
        assert (entry["method"], entry["evaluations"], entry["profile"]) \
            == (want["method"], want["evaluations"], want["profile"]), key
        assert entry["time_s"] == pytest.approx(want["time_s"], rel=1e-12)
    # the same contract, one construction site in each package: the files
    # are the same bytes
    assert t_path.read_bytes() == j_path.read_bytes()
