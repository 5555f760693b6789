"""The paper's loop in the port: compare_methods against the JAX package's
on the cost model, the wall-clock objective's protocol, and the CLI on the
CPU (plain versions, small sizes)."""
import importlib
import json

import pytest
import torch

from repro.core.space import Workload as JWorkload
from repro.evaluation.compare import compare_methods as j_compare
from repro_torch.core.objective import (PENALTY_TIME, RunnerError,
                                        WallClockObjective)
from repro_torch.core.space import Workload as TWorkload
from repro_torch.core.space import scan_space
from repro_torch.evaluation import (check_report, compare_methods,
                                    format_report)
from repro_torch.evaluation.compare import DEFAULT_METHODS
from repro_torch.launch import tune as t_tune

j_profiles = importlib.import_module("repro.hw.profiles")
t_profiles = importlib.import_module("repro_torch.hw.profiles")

METHODS = ("exhaustive", "analytical", "bayesian", "random")


@pytest.mark.parametrize("profile", ["tpu_v5e", "gpu_sm"])
@pytest.mark.parametrize("variant,n,batch", [("ks", 256, 64),
                                             ("lf", 1024, 16)])
def test_compare_methods_report_equals_repro(profile, variant, n, batch):
    jrep = j_compare([JWorkload(op="scan", n=n, batch=batch,
                                variant=variant)], METHODS,
                     profile=j_profiles.get_profile(profile), max_evals=12)
    trep = compare_methods([TWorkload(op="scan", n=n, batch=batch,
                                      variant=variant)], METHODS,
                           profile=t_profiles.get_profile(profile),
                           max_evals=12)
    (jrow,), (trow,) = jrep["workloads"], trep["workloads"]
    assert trow["space_size"] == jrow["space_size"]
    assert trow["best_time_s"] == jrow["best_time_s"]
    for name in METHODS:
        assert trow["methods"][name] == jrow["methods"][name], name
        assert trep["overall"][name] == jrep["overall"][name], name
    assert check_report(trep) == []
    assert "OVERALL" in format_report(trep)


def _space(n=128, batch=4):
    return scan_space(TWorkload(op="scan", n=n, batch=batch, variant="ks"),
                      t_profiles.get_profile("h100"))


def test_wallclock_runner_failure_raises_and_counts():
    """A runner that raises (a kernel that fails to build or launch) is a
    failure, not a slow config: it is counted and propagates."""
    def runner(wl, cfg):
        raise RuntimeError("nvcc failed")
    obj = WallClockObjective(runner, reps=1, device="cpu")
    space = _space()
    with pytest.raises(RunnerError, match="nvcc failed"):
        obj(space, space.enumerate_valid()[0])
    assert (obj.failures, obj.slow) == (1, 0)


def test_wallclock_slow_config_is_the_penalty():
    def runner(wl, cfg):
        return lambda: None
    obj = WallClockObjective(runner, reps=2, device="cpu", timeout_s=-1.0)
    space = _space()
    m = obj(space, space.enumerate_valid()[0])
    assert (m.valid, m.time_s) == (False, PENALTY_TIME)
    assert (obj.failures, obj.slow) == (0, 1)


def test_wallclock_times_the_prefix_sum_runner_on_cpu():
    obj = WallClockObjective(t_tune.make_scan_runner(torch.device("cpu")),
                             reps=3, device="cpu")
    space = _space()
    m = obj(space, space.enumerate_valid()[0])
    assert m.valid and 0 < m.time_s < PENALTY_TIME
    assert "device=cpu" in obj.signature()
    assert "make_scan_runner" in obj.signature()


def test_cli_compare_methods_on_cpu(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = t_tune.main(["compare-methods", "--device", "cpu", "--sizes", "128",
                      "--batch", "4", "--reps", "1", "--max-evals", "4",
                      "--json", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["runner_failures"] == 0
    assert report["device"]["type"] == "cpu"
    assert set(report["overall"]) == set(DEFAULT_METHODS)
    assert "runner failures: 0" in capsys.readouterr().out


def test_cli_tune_cost_model_writes_db(tmp_path):
    db = tmp_path / "db.json"
    rc = t_tune.main(["--device", "cpu", "--objective", "cost", "--sizes",
                      "256,1024", "--method", "random", "--max-evals", "5",
                      "--db", str(db)])
    assert rc == 0
    entries = json.loads(db.read_text())["entries"]
    assert sorted(entries) == ["h100|scan:ks:n1024:b65536:float32",
                               "h100|scan:ks:n256:b262144:float32"]


def test_cli_defaults_to_cuda(monkeypatch):
    """Without --device the CLI asks for the card, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_tune.main(["compare-methods", "--sizes", "128", "--batch", "4"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_tune.main(["--sizes", "128", "--batch", "4"])


def test_cli_rejects_ops_not_ported():
    with pytest.raises(SystemExit, match="--op moe: only 'scan', "
                                         "'tridiag', 'fft', 'ssd', 'rglru', "
                                         "'attention', 'matmul'"):
        t_tune.main(["--device", "cpu", "--op", "moe", "--sizes",
                     "64"])


def test_cli_compare_methods_fft_on_cpu(tmp_path, capsys):
    """--op fft --variant stockham times the fft entry point's configs
    (plain versions on the CPU) and scores every method."""
    out = tmp_path / "report.json"
    rc = t_tune.main(["compare-methods", "--device", "cpu", "--op", "fft",
                      "--variant", "stockham", "--sizes", "64,128",
                      "--batch", "4", "--reps", "1", "--max-evals", "4",
                      "--json", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["runner_failures"] == 0
    assert [row["workload"] for row in report["workloads"]] == [
        "fft:stockham:n64:b4:float32", "fft:stockham:n128:b4:float32"]
    assert set(report["overall"]) == set(DEFAULT_METHODS)
    assert "runner failures: 0" in capsys.readouterr().out


def test_wallclock_times_the_fft_runner_on_cpu():
    from repro_torch.core.space import fft_space
    obj = WallClockObjective(t_tune.make_fft_runner(torch.device("cpu")),
                             reps=2, device="cpu")
    space = fft_space(TWorkload(op="fft", n=64, batch=4, variant="stockham"),
                      t_profiles.get_profile("h100"))
    for cfg in space.enumerate_valid()[:3]:
        m = obj(space, cfg)
        assert m.valid and 0 < m.time_s < PENALTY_TIME
    assert obj.failures == 0


@pytest.mark.parametrize("profile", ["tpu_v5e", "gpu_sm"])
@pytest.mark.parametrize("op,n,batch", [("fft", 1024, 64),
                                        ("large_fft", 2 ** 16, 16)])
def test_compare_methods_fft_report_equals_repro(profile, op, n, batch):
    """The paper's Table II on the FFT spaces, on the cost model: every
    method's config, time and Phi equal the JAX package's."""
    jrep = j_compare([JWorkload(op=op, n=n, batch=batch,
                                variant="stockham")], METHODS,
                     profile=j_profiles.get_profile(profile), max_evals=12)
    trep = compare_methods([TWorkload(op=op, n=n, batch=batch,
                                      variant="stockham")], METHODS,
                           profile=t_profiles.get_profile(profile),
                           max_evals=12)
    (jrow,), (trow,) = jrep["workloads"], trep["workloads"]
    assert trow["space_size"] == jrow["space_size"]
    for name in METHODS:
        assert trow["methods"][name] == jrow["methods"][name], name
    assert trep["per_op"] == jrep["per_op"]
    assert check_report(trep) == []


def _narrow_ssd(monkeypatch):
    """The ssd runner at 2 heads of 16 and state 8 (mamba2-130m's 24 x 64
    and 128 are slow on the CPU's plain versions)."""
    monkeypatch.setattr(t_tune, "SSD_HEADS", 2)
    monkeypatch.setattr(t_tune, "SSD_HEAD_DIM", 16)
    monkeypatch.setattr(t_tune, "SSD_STATE", 8)


@pytest.mark.parametrize("argv,keys", [
    (["--op", "ssd", "--variant", "chunked", "--sizes", "32,64", "--batch",
      "4"],
     ["ssd:chunked:n32:b4:float32", "ssd:chunked:n64:b4:float32"]),
    (["--op", "rglru", "--sizes", "64,128", "--batch", "8"],
     ["rglru:default:n64:b8:float32", "rglru:default:n128:b8:float32"]),
])
def test_cli_compare_methods_ssd_rglru_on_cpu(tmp_path, capsys, monkeypatch,
                                              argv, keys):
    """--op ssd (variant chunked) and --op rglru time their entry points'
    configs (plain versions on the CPU) and score every method."""
    _narrow_ssd(monkeypatch)
    out = tmp_path / "report.json"
    rc = t_tune.main(["compare-methods", "--device", "cpu", *argv, "--reps",
                      "1", "--max-evals", "4", "--json", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["runner_failures"] == 0
    assert [row["workload"] for row in report["workloads"]] == keys
    assert set(report["overall"]) == set(DEFAULT_METHODS)
    assert "runner failures: 0" in capsys.readouterr().out


@pytest.mark.parametrize("argv,err", [
    (["--op", "ssd", "--variant", "ks"], "--op ssd takes chunked"),
    (["--op", "rglru", "--variant", "linrec"], "--op rglru takes"),
])
def test_cli_checks_the_variant_against_the_op(argv, err):
    with pytest.raises(SystemExit, match=err):
        t_tune.main(["--device", "cpu", *argv, "--sizes", "64"])


def _h100_space(wl):
    from repro_torch.core.space import build_space
    return build_space(wl, t_profiles.get_profile("h100"))


def test_wallclock_times_the_ssd_runner_on_cpu(monkeypatch):
    _narrow_ssd(monkeypatch)
    obj = WallClockObjective(t_tune.make_ssd_runner(torch.device("cpu")),
                             reps=1, device="cpu")
    space = _h100_space(TWorkload(op="ssd", n=64, batch=4,
                                       variant="chunked"))
    for cfg in space.enumerate_valid()[:3]:
        m = obj(space, cfg)
        assert m.valid and 0 < m.time_s < PENALTY_TIME
    assert obj.failures == 0
    bad = TWorkload(op="ssd", n=64, batch=3, variant="chunked")
    with pytest.raises(RunnerError):
        obj(_h100_space(bad), space.enumerate_valid()[0])
    assert obj.failures == 1


@pytest.mark.parametrize("profile", ["tpu_v5e", "gpu_sm"])
@pytest.mark.parametrize("op,variant,n,batch", [("ssd", "chunked", 2048, 192),
                                                ("rglru", "", 2048, 8192)])
def test_compare_methods_chain_report_equals_repro(profile, op, variant, n,
                                                   batch):
    """The paper's Table II on the ssd and rglru spaces (with the fuse
    knob), on the cost model: every method's config, time and Phi equal
    the JAX package's."""
    jrep = j_compare([JWorkload(op=op, n=n, batch=batch, variant=variant)],
                     METHODS, profile=j_profiles.get_profile(profile),
                     max_evals=12)
    trep = compare_methods([TWorkload(op=op, n=n, batch=batch,
                                      variant=variant)], METHODS,
                           profile=t_profiles.get_profile(profile),
                           max_evals=12)
    (jrow,), (trow,) = jrep["workloads"], trep["workloads"]
    assert trow["space_size"] == jrow["space_size"]
    for name in METHODS:
        assert trow["methods"][name] == jrow["methods"][name], name
    assert trep["per_op"] == jrep["per_op"]
    assert check_report(trep) == []
