"""The port's static analysis (``repro_torch.analysis``, ``tune lint``) held
against ``repro.analysis`` on the same inputs.

Findings, reports and baselines agree; every AST rule gives the same
findings from both packages' ``lint_source`` over a snippet corpus that
trips each rule (module names mapped); the port's contracts pin what the
JAX package's fixture pins, and a stale or edited fixture gives the same
findings in both; the invariant sweep over the port's profiles reports
exactly the seven h100 spaces whose every config exceeds h100's
``vmem_budget`` (reported, never baselined), and equals JAX's empty sweep
over the profiles both packages have.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

import repro.analysis as ja
import repro_torch.analysis as ta
from repro.core.space import ParamSpec as JParam
from repro.core.space import SearchSpace as JSpace
from repro.core.space import build_space as j_build_space
from repro.hw.profiles import get_profile as j_profile
from repro_torch.core.space import ParamSpec as TParam
from repro_torch.core.space import SearchSpace as TSpace
from repro_torch.core.space import build_space as t_build_space
from repro_torch.hw.profiles import get_profile as t_profile
from repro_torch.tuning.registry import known_ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                           "analysis_fingerprints.json")
SHARED_PROFILES = ("tpu_v5e", "gpu_sm", "cpu_interpret")

# the seven spaces, all under h100, whose every valid config's plan
# exceeds h100's vmem_budget (2^17): reported, not hidden, not baselined
H100_NO_FEASIBLE = tuple(
    f"invariant.no-feasible-config:h100/{where}:4b04410eb452"
    for where in ("attention:flash:n512:b64:float32",
                  "attention:flash:n1024:b64:float32",
                  "attention:flash:n2048:b64:float32",
                  "attention:flash:n4096:b64:float32",
                  "matmul:default:n512:b1024:float32",
                  "matmul:default:n1024:b1024:float32",
                  "matmul:default:n2048:b1024:float32"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The sweeps run thousands of small plans; beside other busy test
    workers torch's thread pool only slows them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port_invariants():
    """The port's full sweep (every op x its four profiles), run once."""
    return ta.check_invariants()


def _rows(findings, port=False):
    """Comparable (rule, path, line, message) rows; the JAX package's
    module names mapped onto the port's."""
    out = []
    for f in findings:
        msg = f.message if port else f.message.replace("repro.",
                                                       "repro_torch.")
        out.append((f.rule, f.path, f.line, msg))
    return out


# ---------------------------------------------------------------------------
# AST rules
# ---------------------------------------------------------------------------

# (package-relative path, JAX-package source); the port's source is the same
# with ``repro.`` module names mapped onto ``repro_torch.``
CORPUS = [
    ("x.py", "import repro.core.tuner\n"),
    ("x.py", "from repro.hw.tpu import TPU_SPEC\n"),
    ("x.py", "import repro.hw.tpu.extra as t\n"),
    ("x.py", "from repro.core.space import build_space\n"),
    ("tuning/x.py", "from repro.core import TPUCostModelObjective\n"),
    ("tuning/x.py", "obj = objective.TPUCostModelObjective()\n"),
    ("tuning/x.py", "obj = TPUCostModelObjective(noise=0.0)\n"),
    ("core/objective.py", "obj = objective.TPUCostModelObjective()\n"),
    ("core/__init__.py", "from repro.core import TPUCostModelObjective\n"),
    ("tuning/x.py", "from repro.core import CostModelObjective\n"),
    ("x.py", "space = build_space(wl, spec=profile)\n"),
    ("x.py", "plan = plan_for(wl, cfg, spec=profile)\n"),
    ("x.py", "obj = CostModelObjective(spec=profile, noise=0.1)\n"),
    ("x.py", "space = build_space(wl, profile=profile)\n"),
    ("x.py", "t = micro_step_overhead_s(spec=profile)\n"),
    ("tuning/x.py", "import time\nt0 = time.time()\n"),
    ("serve/engine.py", "import time\nt0 = time.perf_counter()\n"),
    ("launch/serve.py", "import time\nt0 = time.time()\n"),
    ("launch/dryrun.py", "import time\nt0 = time.time()\n"),
    ("tuning/x.py", "from time import perf_counter\ndt = perf_counter() - t0\n"),
    ("tuning/x.py", "import time\nclock = time.monotonic\n"),
    ("serve/engine.py", "def f(step_timer=time.perf_counter):\n    pass\n"),
    ("x.py", "class FancyObjective(Objective):\n"
             "    def batch_eval(self, space, cfgs):\n"
             "        return []\n"),
    ("x.py", "class FancyObjective(core.Objective):\n"
             "    def batch_eval_metrics(self, space, cfgs):\n"
             "        return []\n"
             "    def batch_eval(self, space, cfgs):\n"
             "        return []\n"),
    ("x.py", "class Helper(Base):\n"
             "    def batch_eval(self):\n"
             "        return []\n"),
    ("x.py", "def f(x=[]):\n    pass\n"),
    ("x.py", "def f(x={}):\n    pass\n"),
    ("x.py", "def f(*, x=dict()):\n    pass\n"),
    ("x.py", "async def f(x={1}, y=set()):\n    pass\n"),
    ("x.py", "def f(x=None, y=()):\n    pass\n"),
    ("x.py", "f = open(p, 'a')\n"),
    ("x.py", "f = open(p, mode='ab')\n"),
    ("x.py", "f = open(p)\nf = open(p, 'w')\n"),
    ("x.py", "fd = os.open(p, flags)\n"),
    ("tuning/x.py",
     "t0 = time.time()  # lint: allow[raw-clock]\nt1 = time.time()\n"),
    ("x.py", "def f(:\n"),
]


@pytest.mark.parametrize("relpath,source", CORPUS,
                         ids=[f"{i}-{p}" for i, (p, _) in enumerate(CORPUS)])
def test_ast_rule_findings_match_repro(relpath, source):
    port_source = source.replace("repro.", "repro_torch.")
    got = _rows(ta.lint_source(relpath, port_source), port=True)
    want = _rows(ja.lint_source(relpath, source))
    assert got == want


def test_corpus_trips_every_rule():
    rules = {f.rule for relpath, source in CORPUS
             for f in ta.lint_source(relpath, source.replace(
                 "repro.", "repro_torch."))}
    assert rules == {f"ast.{name}" for name in ta.RULES} | {"ast.syntax-error"}
    assert set(ta.RULES) == set(ja.RULES)


def test_retired_modules_name_the_port():
    from repro_torch.analysis.astlint import RETIRED_MODULES
    assert RETIRED_MODULES == ("repro_torch.core.tuner", "repro_torch.hw.tpu")
    # the JAX package's own names are not the port's retired modules
    assert ta.lint_source("x.py", "import repro.core.tuner\n") == []


def test_port_tree_is_ast_clean():
    assert ta.lint_tree() == []


# ---------------------------------------------------------------------------
# Findings, reports, baselines
# ---------------------------------------------------------------------------

FINDINGS = [("ast.raw-clock", "tuning/x.py", "direct time.time() call", 3),
            ("ast.raw-clock", "tuning/x.py", "direct time.time() call", 9),
            ("invariant.plan", "scan/scan:ks:n256:b8:float32", "bad", 0),
            ("fingerprint.measurement", "tests/fixtures/f.json", "stale", 0)]


def _findings(pkg):
    return [pkg.Finding(rule=r, path=p, message=m, line=ln)
            for r, p, m, ln in FINDINGS]


def test_finding_keys_and_renders_match_repro():
    for t, j in zip(_findings(ta), _findings(ja)):
        assert t.key() == j.key() and t.render() == j.render()
        assert t.to_dict() == j.to_dict()
    a, b = _findings(ta)[:2]
    assert a.key() == b.key()          # the line is not part of the key
    assert a.key() != dataclasses.replace(a, message="other").key()


def test_report_dict_matches_repro():
    t, j = _findings(ta), _findings(ja)
    assert ta.report_dict(t, t[:1]) == ja.report_dict(j, j[:1])
    assert ta.report_dict(t)["counts"] == {"ast.raw-clock": 2,
                                           "invariant.plan": 1,
                                           "fingerprint.measurement": 1}


def test_baseline_splitting_matches_repro(tmp_path):
    t, j = _findings(ta), _findings(ja)
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"version": 1,
                                "suppress": [t[0].key(), t[3].key()]}))
    keys = ta.load_baseline(str(path))
    assert keys == ja.load_baseline(str(path))
    fresh, quiet = ta.apply_baseline(t, keys)
    jfresh, jquiet = ja.apply_baseline(j, keys)
    assert _rows(fresh, True) == _rows(jfresh, True)
    assert _rows(quiet, True) == _rows(jquiet, True)
    assert len(fresh) == 1 and len(quiet) == 3
    assert ta.load_baseline(str(tmp_path / "absent.json")) == []
    path.write_text("[]")
    with pytest.raises(ValueError, match="suppress"):
        ta.load_baseline(str(path))


def test_shipped_port_baseline_is_empty():
    path = os.path.join(ROOT, "tests", "fixtures",
                        "analysis_baseline_torch.json")
    assert ta.load_baseline(path) == []


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------

def test_port_pins_equal_the_jax_fixture():
    with open(JAX_FIXTURE) as f:
        jax_pins = json.load(f)
    assert ta.current_fingerprints() == jax_pins == ja.current_fingerprints()
    assert {name: pin["version"] for name, pin in jax_pins.items()} == {
        "db_entry": 4, "feature_columns": 5, "journal_header": 3,
        "measurement": 1}
    fixture = ta.default_fixture_path()
    assert fixture.endswith("analysis_fingerprints_torch.json")
    assert fixture != ja.default_fixture_path()
    assert ta.check_fingerprints(fixture) == []
    with open(fixture) as f:
        assert json.load(f) == jax_pins


def test_port_contracts_have_one_construction_site():
    from repro_torch.core.objective import (MEASUREMENT_FIELDS, Measurement)
    from repro_torch.core.space import Workload
    from repro_torch.core.objective import CostModelObjective
    from repro_torch.tuning.db import ENTRY_FIELDS, make_entry
    from repro_torch.tuning.sweep import HEADER_FIELDS, make_header
    m = Measurement(0.5, True, meta={"reps": 3.0}, metrics={"energy_j": 2.0})
    d = m.to_dict()
    assert tuple(d) == MEASUREMENT_FIELDS
    assert Measurement.from_dict(d) == m
    assert Measurement.from_dict({"time_s": 0.25}).metrics == {"time_s": 0.25}
    entry = make_entry({"radix": 2}, 1e-3, "exhaustive", 8, "h100",
                       "latency", {"time_s": 1e-3})
    assert tuple(entry) == ENTRY_FIELDS
    header = make_header(Workload(op="scan", n=256, batch=8, variant="ks"),
                         CostModelObjective(), 24)
    flat = [f"{k}.{sub}" if isinstance(v, dict) else k
            for k, v in header.items()
            for sub in (v if isinstance(v, dict) else [None])]
    assert tuple(flat) == HEADER_FIELDS


def _edits():
    out = []
    for name in ("db_entry", "feature_columns", "journal_header",
                 "measurement"):
        out += [(name, "bump"), (name, "hash"), (name, "drop")]
    return out + [("unknown", "add")]


@pytest.mark.parametrize("name,edit", _edits())
def test_an_edited_fixture_gives_the_findings_of_repro(tmp_path, name, edit):
    pins = ta.current_fingerprints()
    if edit == "bump":
        pins[name]["version"] += 1
    elif edit == "hash":
        pins[name]["hash"] = "0" * 64
    elif edit == "drop":
        del pins[name]
    else:
        pins[name] = {"version": 1, "hash": "0" * 64}
    path = tmp_path / "pins.json"
    path.write_text(json.dumps(pins))
    got = _rows(ta.check_fingerprints(str(path)), port=True)
    want = _rows(ja.check_fingerprints(str(path)))
    assert got == want and len(got) == 1
    assert got[0][0] == f"fingerprint.{name}"


def test_a_missing_fixture_gives_the_finding_of_repro(tmp_path):
    path = str(tmp_path / "absent.json")
    got = _rows(ta.check_fingerprints(path), port=True)
    want = [(r, p, ln, m.replace("tune.py lint", "tune lint"))
            for r, p, ln, m in _rows(ja.check_fingerprints(path))]
    assert got == want
    assert got[0][0] == "fingerprint.missing-fixture"


def test_write_fingerprints_round_trips(tmp_path):
    path = str(tmp_path / "sub" / "pins.json")
    assert ta.write_fingerprints(path) == ta.current_fingerprints()
    assert ta.check_fingerprints(path) == []


# ---------------------------------------------------------------------------
# Invariants
# ---------------------------------------------------------------------------

def test_port_sweep_reports_the_seven_h100_spaces(port_invariants):
    assert sorted(f.key() for f in port_invariants) \
        == sorted(H100_NO_FEASIBLE)
    assert {f.rule for f in port_invariants} \
        == {"invariant.no-feasible-config"}


def test_port_sweep_over_the_shared_profiles_equals_repro():
    got = ta.check_invariants(profile_names=list(SHARED_PROFILES))
    assert _rows(got, port=True) == _rows(ja.check_invariants()) == []


@pytest.mark.parametrize("op", known_ops())
def test_suite_grid_matches_repro(op):
    got = [wl.key for wl in ta.suite_grid(op)]
    assert got and got == [wl.key for wl in ja.suite_grid(op)]


def _with_unroll(build, param_cls, space_cls, profile, grid):
    """Each space of ``grid`` with an ``unroll`` knob of two values
    (replacing a one-value one): a knob no plan or cost reads."""
    spaces = []
    for wl in grid:
        base = build(wl, profile)
        params = [p for p in base.params if p.name != "unroll"]
        spaces.append(space_cls(base.workload,
                                params + [param_cls("unroll", (1, 2))],
                                constraints=base.constraints, spec=base.spec))
    return spaces


@pytest.mark.parametrize("op,dead_unroll", [("attention", True),
                                             ("rglru", False)])
def test_dead_knob_detector_on_a_readded_unroll(op, dead_unroll):
    """A two-value ``unroll`` re-added to each space of the op's grid: no
    attention plan or cost reads it, so both packages call it dead; the
    linrec spaces' cost model does read it (its ILP term), so neither
    does there — the detector sees the model, not the kernel."""
    t_spaces = _with_unroll(t_build_space, TParam, TSpace,
                            t_profile("tpu_v5e"), ta.suite_grid(op))
    j_spaces = _with_unroll(j_build_space, JParam, JSpace,
                            j_profile("tpu_v5e"), ja.suite_grid(op))
    dead = ta.find_dead_knobs(t_spaces)
    assert dead == ja.find_dead_knobs(j_spaces)
    assert ("unroll" in dead) is dead_unroll
    assert _rows(ta.check_dead_knobs(op, t_spaces), True) \
        == _rows(ja.check_dead_knobs(op, j_spaces), True)
    # under h100 too, on the port alone; and the shipped spaces are live
    h100 = _with_unroll(t_build_space, TParam, TSpace, t_profile("h100"),
                        ta.suite_grid(op))
    assert ("unroll" in ta.find_dead_knobs(h100)) is dead_unroll
    assert ta.find_dead_knobs([t_build_space(wl, t_profile("h100"))
                               for wl in ta.suite_grid(op)]) == []


def test_an_empty_space_is_a_finding_in_both():
    from repro.core.space import Workload as JWorkload
    from repro_torch.core.space import Workload as TWorkload
    kw = dict(op="attention", n=2048, batch=64, dtype="bfloat16",
              variant="flash")
    tb = t_build_space(TWorkload(**kw), t_profile("tpu_v5e"))
    jb = j_build_space(JWorkload(**kw), j_profile("tpu_v5e"))
    t_empty = TSpace(tb.workload, tb.params,
                     constraints=(lambda c, w: False,), spec=tb.spec)
    j_empty = JSpace(jb.workload, jb.params,
                     constraints=(lambda c, w: False,), spec=jb.spec)
    got = _rows(ta.check_space(t_empty), True)
    assert got == _rows(ja.check_space(j_empty), True)
    assert [r[0] for r in got] == ["invariant.empty-space"]


# ---------------------------------------------------------------------------
# run_lint and the CLI
# ---------------------------------------------------------------------------

def test_run_lint_without_invariants_is_clean():
    assert ta.run_lint(invariants=False) == []


def test_cli_lint_writes_the_report_and_exits_1(tmp_path):
    report = tmp_path / "lint.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tune", "lint", "--json",
         str(report)], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr
    assert "[lint] 7 finding(s), 0 baselined" in proc.stdout
    data = json.loads(report.read_text())
    assert sorted(f["key"] for f in data["findings"]) \
        == sorted(H100_NO_FEASIBLE)
    assert data["suppressed"] == [] and data["total"] == 7
    assert data["counts"] == {"invariant.no-feasible-config": 7}


def test_cli_baseline_suppresses(tmp_path, capsys):
    from repro_torch.launch.tune import main
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"version": 1, "suppress": ["x"]}))
    report = tmp_path / "lint.json"
    assert main(["lint", "--no-invariants", "--baseline", str(base),
                 "--json", str(report)]) == 0
    assert json.loads(report.read_text())["total"] == 0
    assert "[lint] 0 finding(s), 0 baselined" in capsys.readouterr().out
