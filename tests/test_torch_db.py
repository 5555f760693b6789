"""State carried across the two packages: the TuningDB and sweep journals.

The port keeps its own copies of ``repro.tuning.db`` and
``repro.tuning.sweep``; a DB file the JAX package tuned and a journal it
swept must read back in the port to the identical configs and times.
"""
import importlib
import json
import os

import pytest

from repro.core.objective import CostModelObjective as JCost
from repro.core.space import Workload as JWorkload
from repro.core.space import scan_space as j_scan_space
from repro.tuning import overrides as j_overrides
from repro.tuning.session import TunerSession as JSession
from repro.tuning.sweep import SweepJournal as JJournal
from repro.tuning.sweep import run_sweep as j_run_sweep
from repro_torch.core.objective import CostModelObjective as TCost
from repro_torch.core.space import Workload as TWorkload
from repro_torch.core.space import scan_space as t_scan_space
from repro_torch.tuning import overrides as t_overrides
from repro_torch.tuning.db import TuningDB as TDB
from repro_torch.tuning.session import TunerSession as TSession
from repro_torch.tuning.sweep import SweepJournal as TJournal
from repro_torch.tuning.sweep import run_sweep as t_run_sweep

j_profiles = importlib.import_module("repro.hw.profiles")
t_profiles = importlib.import_module("repro_torch.hw.profiles")

TUNED = [(256, 64, "ks"), (4096, 16, "lf")]


@pytest.fixture
def repro_db(tmp_path):
    """A DB the JAX package wrote: two scan workloads tuned with random
    search on its tpu_v5e cost model."""
    path = str(tmp_path / "tuning_db.json")
    session = JSession(db_path=path, spec=j_profiles.get_profile("tpu_v5e"))
    for n, batch, variant in TUNED:
        session.tune(JWorkload(op="scan", n=n, batch=batch, variant=variant),
                     method="random", max_evals=12, seed=3)
    return path, session


@pytest.mark.parametrize("n,batch,variant", TUNED)
def test_port_resolves_a_repro_db(repro_db, n, batch, variant):
    path, jsession = repro_db
    tsession = TSession(db_path=path, spec=t_profiles.get_profile("tpu_v5e"))
    jwl = JWorkload(op="scan", n=n, batch=batch, variant=variant)
    twl = TWorkload(op="scan", n=n, batch=batch, variant=variant)
    assert tsession.lookup(twl) is not None
    assert tsession.lookup(twl) == jsession.lookup(jwl)
    assert tsession.resolve(twl) == jsession.resolve(jwl)
    with j_overrides(scan={"radix": 4}), t_overrides(scan={"radix": 4}):
        tcfg, jcfg = tsession.resolve(twl), jsession.resolve(jwl)
    assert tcfg == jcfg and tcfg["radix"] == 4


def test_port_db_entries_equal_repro_entries(repro_db):
    path, _ = repro_db
    with open(path) as f:
        raw = json.load(f)
    assert TDB(path=path, platform="tpu_v5e").entries() == raw["entries"]
    # another device's session never resolves the tpu_v5e winners
    h100 = TSession(db_path=path, spec=t_profiles.get_profile("h100"))
    assert h100.lookup(TWorkload(op="scan", n=256, batch=64)) is None


def test_port_writes_what_repro_reads(tmp_path):
    path = str(tmp_path / "port_db.json")
    tsession = TSession(db_path=path, spec=t_profiles.get_profile("gpu_sm"))
    twl = TWorkload(op="scan", n=1024, batch=32, variant="ks")
    tsession.tune(twl, method="random", max_evals=6, seed=1)
    jsession = JSession(db_path=path, spec=j_profiles.get_profile("gpu_sm"))
    jwl = JWorkload(op="scan", n=1024, batch=32, variant="ks")
    assert jsession.lookup(jwl) == tsession.lookup(twl)


def test_legacy_flat_db_migrates(tmp_path):
    """A schema-1 flat file (bare keys) loads under tpu_v5e in both."""
    path = str(tmp_path / "legacy.json")
    cfg = {"tile_n": 128, "rows_per_program": 4, "radix": 2, "unroll": 1,
           "in_register": 0}
    key = JWorkload(op="scan", n=256, batch=8, variant="ks").key
    with open(path, "w") as f:
        json.dump({key: {"config": cfg, "time_s": 1e-5, "method": "seed"}}, f)
    twl = TWorkload(op="scan", n=256, batch=8, variant="ks")
    assert TDB(path=path, platform="tpu_v5e").lookup(twl) == cfg


@pytest.mark.parametrize("keep", [None, 10])
def test_port_resumes_a_repro_journal(tmp_path, keep):
    """A sweep journal the JAX package wrote resumes in the port under the
    same objective signature: complete, or torn after ``keep`` entries."""
    jp, tp = j_profiles.get_profile("tpu_v5e"), t_profiles.get_profile(
        "tpu_v5e")
    jwl = JWorkload(op="scan", n=1024, batch=64, variant="ks")
    twl = TWorkload(op="scan", n=1024, batch=64, variant="ks")
    jdir = str(tmp_path / "journals")
    jres = j_run_sweep(j_scan_space(jwl, jp), JCost(jp),
                       journal=JJournal.for_workload(jdir, jwl, JCost(jp)))
    tjournal = TJournal.for_workload(jdir, twl, TCost(tp))
    assert os.path.exists(tjournal.path)
    if keep is not None:
        with open(tjournal.path) as f:
            lines = f.readlines()
        with open(tjournal.path, "w") as f:
            f.writelines(lines[:1 + keep])
            f.write(lines[1 + keep][:7])      # a torn trailing line
    tres = t_run_sweep(t_scan_space(twl, tp), TCost(tp), journal=tjournal)
    assert tres.resumed == (jres.total if keep is None else keep)
    assert tres.evaluations == tres.total - tres.resumed
    assert tres.best_config == jres.best_config
    assert tres.best_time == jres.best_time
    assert tres.history == jres.history


def test_port_keeps_repro_non_latency_winners(tmp_path):
    """The port tunes and resolves latency winners only: an energy winner
    that repro stored never answers the port's lookup, and survives the
    port's next store so repro still resolves it."""
    path = str(tmp_path / "policies.json")
    jsession = JSession(db_path=path, spec=j_profiles.get_profile("gpu_sm"))
    jwl = JWorkload(op="scan", n=1024, batch=32, variant="ks")
    jsession.tune(jwl, method="random", max_evals=6, seed=2, policy="energy")
    energy_cfg = jsession.lookup(jwl, policy="energy")
    assert energy_cfg is not None and jsession.lookup(jwl) is None
    tsession = TSession(db_path=path, spec=t_profiles.get_profile("gpu_sm"))
    twl = TWorkload(op="scan", n=1024, batch=32, variant="ks")
    assert tsession.lookup(twl) is None
    tsession.tune(twl, method="random", max_evals=6, seed=1)
    again = JSession(db_path=path, spec=j_profiles.get_profile("gpu_sm"))
    assert again.lookup(jwl, policy="energy") == energy_cfg
    assert again.lookup(jwl) == tsession.lookup(twl)


FFT_TUNED = [("fft", 1024, 64), ("large_fft", 2 ** 16, 16)]


@pytest.fixture
def repro_fft_db(tmp_path):
    """A DB the JAX package wrote: an fft and a large_fft workload tuned
    with random search on its tpu_v5e cost model."""
    path = str(tmp_path / "fft_db.json")
    session = JSession(db_path=path, spec=j_profiles.get_profile("tpu_v5e"))
    for op, n, batch in FFT_TUNED:
        session.tune(JWorkload(op=op, n=n, batch=batch, variant="stockham"),
                     method="random", max_evals=12, seed=3)
    return path, session


@pytest.mark.parametrize("op,n,batch", FFT_TUNED)
def test_port_resolves_a_repro_fft_db(repro_fft_db, op, n, batch):
    """fft and large_fft DB keys and entries written by repro resolve to
    the same config in the port (each op's normalizer, overrides too)."""
    path, jsession = repro_fft_db
    tsession = TSession(db_path=path, spec=t_profiles.get_profile("tpu_v5e"))
    jwl = JWorkload(op=op, n=n, batch=batch, variant="stockham")
    twl = TWorkload(op=op, n=n, batch=batch, variant="stockham")
    assert twl.key == jwl.key
    assert tsession.lookup(twl) is not None
    assert tsession.lookup(twl) == jsession.lookup(jwl)
    assert tsession.resolve(twl) == jsession.resolve(jwl)
    with j_overrides(**{op: {"radix": 4}}), t_overrides(**{op: {"radix": 4}}):
        tcfg, jcfg = tsession.resolve(twl), jsession.resolve(jwl)
    assert tcfg == jcfg and tcfg["radix"] == 4


@pytest.mark.parametrize("op,n,batch", FFT_TUNED)
def test_port_fft_entries_read_back_in_repro(tmp_path, op, n, batch):
    path = str(tmp_path / "port_fft_db.json")
    tsession = TSession(db_path=path, spec=t_profiles.get_profile("gpu_sm"))
    twl = TWorkload(op=op, n=n, batch=batch, variant="stockham")
    tsession.tune(twl, method="random", max_evals=6, seed=1)
    jsession = JSession(db_path=path, spec=j_profiles.get_profile("gpu_sm"))
    jwl = JWorkload(op=op, n=n, batch=batch, variant="stockham")
    assert jsession.lookup(jwl) == tsession.lookup(twl)
    assert jsession.resolve(jwl) == tsession.resolve(twl)


CHAIN_TUNED = [("ssd", "chunked", 512, 48), ("rglru", "", 1024, 256)]


@pytest.fixture
def repro_chain_db(tmp_path):
    """A DB the JAX package wrote: an ssd and an rglru workload (both with
    the chain-fusion knob) tuned with random search on its tpu_v5e cost
    model."""
    path = str(tmp_path / "chain_db.json")
    session = JSession(db_path=path, spec=j_profiles.get_profile("tpu_v5e"))
    for op, variant, n, batch in CHAIN_TUNED:
        session.tune(JWorkload(op=op, n=n, batch=batch, variant=variant),
                     method="random", max_evals=12, seed=3)
    return path, session


@pytest.mark.parametrize("op,variant,n,batch", CHAIN_TUNED)
def test_port_resolves_a_repro_chain_db(repro_chain_db, op, variant, n,
                                        batch):
    """ssd and rglru DB keys and entries written by repro resolve to the
    same launch knobs in the port (each op's normalizer: chunk / radix /
    fuse for ssd, the scan knobs and fuse for rglru), overrides too."""
    path, jsession = repro_chain_db
    tsession = TSession(db_path=path, spec=t_profiles.get_profile("tpu_v5e"))
    jwl = JWorkload(op=op, n=n, batch=batch, variant=variant)
    twl = TWorkload(op=op, n=n, batch=batch, variant=variant)
    assert twl.key == jwl.key
    assert tsession.lookup(twl) is not None
    assert tsession.lookup(twl) == jsession.lookup(jwl)
    assert "fuse" in tsession.lookup(twl)
    assert tsession.resolve(twl) == jsession.resolve(jwl)
    assert "fuse" in tsession.resolve(twl)
    with j_overrides(**{op: {"fuse": 1, "radix": 4}}), \
            t_overrides(**{op: {"fuse": 1, "radix": 4}}):
        tcfg, jcfg = tsession.resolve(twl), jsession.resolve(jwl)
    assert tcfg == jcfg and (tcfg["fuse"], tcfg["radix"]) == (1, 4)


@pytest.mark.parametrize("op,variant,n,batch", CHAIN_TUNED)
def test_port_chain_entries_read_back_in_repro(tmp_path, op, variant, n,
                                               batch):
    path = str(tmp_path / "port_chain_db.json")
    tsession = TSession(db_path=path, spec=t_profiles.get_profile("gpu_sm"))
    twl = TWorkload(op=op, n=n, batch=batch, variant=variant)
    tsession.tune(twl, method="random", max_evals=6, seed=1)
    jsession = JSession(db_path=path, spec=j_profiles.get_profile("gpu_sm"))
    jwl = JWorkload(op=op, n=n, batch=batch, variant=variant)
    assert jsession.lookup(jwl) == tsession.lookup(twl)
    assert jsession.resolve(jwl) == tsession.resolve(twl)
