"""The port's examples (``examples_torch/``) on the CPU against the calls
the JAX package's examples (``examples/``) make.

The JAX scripts are not run (``examples/quickstart.py`` runs on import and
writes under ``/tmp``): each test repeats their calls through ``repro``'s
API on the same arguments, at a small size where the example's own size
would take minutes here, and holds the port's example against them.
Tuning results (configs, evaluations, times, Phi) are compared exactly:
both packages run the same numpy arithmetic on the ``tpu_v5e`` profile.
Kernel outputs and losses use ``DTYPE_TOL``; greedy tokens are compared
exactly.
"""
import dataclasses
import importlib.util
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import DTYPE_TOL, assert_kernel_close
from repro import tuning as j_tuning
from repro.configs import base as j_base
from repro.core import Workload as JWorkload
from repro.core.metrics import phi as j_phi
from repro.data.pipeline import Batcher as JBatcher, DataConfig as JDataConfig
from repro.kernels.scan.ops import prefix_sum as j_prefix_sum
from repro.models.model import build_model as j_build_model
from repro.serve import ServeEngine as JServeEngine
from repro.train import step as j_step
from repro.train.fault import FaultInjector as JFaultInjector
from repro.train.loop import LoopConfig as JLoopConfig
from repro.train.loop import run_training as j_run_training
from repro_torch import tuning as t_tuning
from repro_torch.configs.base import get_arch
from repro_torch.models.convert import load_params, train_state_from_jax
from repro_torch.models.model import Model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples_torch")
NAMES = ("quickstart", "autotune_kernels", "serve_lm", "train_lm",
         "fault_tolerant_train")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ex():
    """The port's examples by name, imported as their scripts import each
    other (``fault_tolerant_train`` takes ``preset_host`` from the
    ``train_lm`` beside it)."""
    sys.path.insert(0, EXAMPLES)
    try:
        yield {name: _load(os.path.join(EXAMPLES, f"{name}.py"), name)
               for name in NAMES}
    finally:
        sys.path.remove(EXAMPLES)
        for name in NAMES:
            sys.modules.pop(name, None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, so that beside other busy test
    processes torch's pool does not make each of them wait."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tpu_v5e(monkeypatch, tmp_path):
    """Both packages on the tpu_v5e profile, their default sessions too,
    with empty DBs."""
    monkeypatch.setenv("REPRO_TORCH_HW_PROFILE", "tpu_v5e")
    monkeypatch.setenv("REPRO_HW_PROFILE", "tpu_v5e")
    jprev = j_tuning.set_default_session(j_tuning.TunerSession(
        db_path=str(tmp_path / "jax_default.json")))
    tprev = t_tuning.set_default_session(t_tuning.TunerSession(
        db_path=str(tmp_path / "torch_default.json")))
    yield
    j_tuning.set_default_session(jprev)
    t_tuning.set_default_session(tprev)


def test_quickstart_matches_the_jax_calls(ex, tpu_v5e, tmp_path):
    """The same Bayesian winner, evaluations and time, the same resolved
    configs (warm and cold), and prefix sums within DTYPE_TOL of JAX's on
    the same numpy input (the tuned config, and radix 4 by override)."""
    lines = []
    out = ex["quickstart"].run("cpu", db=str(tmp_path / "torch.json"),
                               log=lines.append)
    session = j_tuning.TunerSession(db_path=str(tmp_path / "jax.json"))
    wl = JWorkload(op="scan", n=1024, batch=65536, variant="ks")
    want = session.tune(wl, method="bayesian")
    got = out["result"]
    assert got.best_config == want.best_config
    assert got.evaluations == want.evaluations
    assert got.best_time == want.best_time
    assert out["config"] == session.resolve(wl)
    assert out["cold"] == session.resolve(JWorkload(op="scan", n=2048,
                                                    batch=32768,
                                                    variant="ks"))
    x = np.random.default_rng(0).normal(size=(16, 1024)).astype(np.float32)
    assert np.array_equal(out["x"].numpy(), x)
    jy = j_prefix_sum(jnp.asarray(x), config=out["config"], interpret=True)
    assert_kernel_close(out["y"].numpy(), np.asarray(jy), "float32")
    with j_tuning.overrides(scan={"radix": 4}):
        jy4 = j_prefix_sum(jnp.asarray(x), interpret=True)
    assert_kernel_close(out["y4"].numpy(), np.asarray(jy4), "float32")
    assert lines[0].startswith("offline BO: best=")
    assert len(lines) == 5


def test_autotune_kernels_matches_tune_all_methods(ex, tpu_v5e):
    """One size per case: every method's config, time and evaluations
    equal those of ``benchmarks/common.py``'s ``tune_all_methods`` (loaded
    unchanged), and so the Phi table."""
    common = _load(os.path.join(ROOT, "benchmarks", "common.py"),
                   "jax_benchmarks_common")
    mod = ex["autotune_kernels"]
    cases = [(op, variant, sizes[1:2]) for op, variant, sizes in mod.CASES]
    out = mod.run("cpu", cases=cases, log=lambda *_: None)
    for op, variant, (n,) in cases:
        wl = JWorkload(op=op, n=n, batch=max(2**26 // n, 1), variant=variant)
        want = common.tune_all_methods(wl)
        got = out["runs"][wl.key]
        assert got == want, wl.key
        row = out["phi"][f"{op}-{variant}"]
        assert row["analytical"] == j_phi([want["analytical"]["efficiency"]])
        assert row["bayesian"] == j_phi([want["bayesian"]["efficiency"]])
        assert row["evals"] == [want["bayesian"]["evals"]]


def test_autotune_kernels_names_an_empty_space(ex, monkeypatch):
    """Where the active profile admits no config the example raises,
    naming the workload, rather than skipping the size."""
    mod = ex["autotune_kernels"]

    class Empty:
        spec = type("Spec", (), {"name": "h100"})

        def enumerate_valid(self):
            return []

    monkeypatch.setattr(mod, "build_space", lambda wl: Empty())
    with pytest.raises(ValueError, match="scan:ks:n1024"):
        mod.run("cpu", cases=[("scan", "ks", [1024])], log=lambda *_: None)


def test_serve_lm_gives_the_jax_engines_tokens(ex, tmp_path):
    """The reduced qwen1.5-0.5b with JAX's weights (``Model.init`` draws
    other numbers than ``jax.random``), the same ten requests through both
    engines with an OnlineTuner attached: every request's greedy tokens
    equal."""
    j_base._load_all()
    cfg = j_base._REGISTRY["qwen1.5-0.5b"].reduced()
    jm = j_build_model(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    engine = JServeEngine(jm, params, max_batch=4, max_len=128)
    tuner = j_tuning.OnlineTuner(
        JWorkload(op="attention", n=128, batch=4, variant="flash"),
        j_tuning.TunerSession(db_path=str(tmp_path / "jax.json")),
        budget=16, guard_band=0.25)
    j_tuning.attach(engine, tuner)
    rng = np.random.default_rng(0)
    for _ in range(10):
        engine.submit(rng.integers(0, cfg.vocab,
                                   size=int(rng.integers(4, 20))),
                      max_new_tokens=8)
    want = {r.rid: list(r.output) for r in engine.run()}

    model = load_params(Model(get_arch("qwen1.5-0.5b").reduced(),
                              device="cpu"),
                        jax.tree.map(np.asarray, params))
    out = ex["serve_lm"].run("cpu", model=model, log=lambda *_: None)
    got = {r.rid: list(r.output) for r in out["done"]}
    assert got == want
    assert out["tokens"] == 80 and out["tuner"]["budget"] == 16


def test_train_lm_presets_equal_jax(ex):
    jax_train_lm = _load(os.path.join(ROOT, "examples", "train_lm.py"),
                         "jax_examples_train_lm")
    for name in ("preset_100m", "preset_host"):
        got = dataclasses.asdict(getattr(ex["train_lm"], name)())
        assert got == dataclasses.asdict(getattr(jax_train_lm, name)()), name


def test_train_lm_takes_jax_steps(ex):
    """Two steps of the host preset at batch 2 x 16 tokens from JAX's
    initial state: the losses within DTYPE_TOL of JAX's loop's."""
    jax_train_lm = _load(os.path.join(ROOT, "examples", "train_lm.py"),
                         "jax_examples_train_lm")
    cfg = jax_train_lm.preset_host()
    model = j_build_model(cfg)
    hp = j_step.TrainHParams(peak_lr=1e-3, warmup_steps=20, total_steps=2,
                             z_weight=0.0)
    init = j_step.init_train_state(model, hp, jax.random.PRNGKey(0))
    state = train_state_from_jax(jax.tree.map(np.asarray, init))
    loop = JLoopConfig(total_steps=2, log_every=10, checkpoint_every=50)
    data = iter(JBatcher(JDataConfig(vocab=cfg.vocab, seq_len=16,
                                     global_batch=2)))
    want = j_run_training(model, hp, loop, data, state=init,
                          log=lambda *_: None)["history"]
    got = ex["train_lm"].train(ex["train_lm"].preset_host(), steps=2,
                               batch=2, seq=16, device="cpu", state=state,
                               log=lambda *_: None)["history"]
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1]
    rtol, atol = DTYPE_TOL["float32"]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=rtol,
                               atol=atol)


def test_fault_tolerant_train_resumes_as_jax_does(ex, tmp_path):
    """The demo's schedule (30 steps, a checkpoint every 10, a failure at
    17) on a small model: the job dies at 17, the restart resumes from 10
    and ends at 29, as JAX's loop does on the same arguments."""
    small = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2,
                 head_dim=32, d_ff=128, vocab=256)
    cfg = dataclasses.replace(ex["train_lm"].preset_host(), **small)
    out = ex["fault_tolerant_train"].run(str(tmp_path / "torch"), "cpu",
                                         cfg=cfg, log=lambda *_: None)
    assert out["died"] == "injected node failure at step 17"
    assert out["resumed_from"] == 10
    assert [h["step"] for h in out["history"]] == [10, 20, 29]

    jax_train_lm = _load(os.path.join(ROOT, "examples", "train_lm.py"),
                         "jax_examples_train_lm")
    jcfg = dataclasses.replace(jax_train_lm.preset_host(), **small)
    hp = j_step.TrainHParams(peak_lr=1e-3, warmup_steps=5, total_steps=30,
                             z_weight=0.0)
    loop = JLoopConfig(total_steps=30, checkpoint_dir=str(tmp_path / "jax"),
                       checkpoint_every=10, log_every=10)
    inj = JFaultInjector(fail_at_steps=(17,))

    def data():
        return iter(JBatcher(JDataConfig(vocab=jcfg.vocab, seq_len=64,
                                         global_batch=4)))

    with pytest.raises(RuntimeError, match=out["died"]):
        j_run_training(j_build_model(jcfg), hp, loop, data(), injector=inj,
                       log=lambda *_: None)
    want = j_run_training(j_build_model(jcfg), hp, loop, data(),
                          injector=inj, log=lambda *_: None)
    assert want["resumed_from"] == out["resumed_from"]
    assert [h["step"] for h in want["history"]] == \
        [h["step"] for h in out["history"]]


def test_fault_tolerant_train_refuses_a_used_directory(ex, tmp_path):
    (tmp_path / "step_0000000010").mkdir()
    with pytest.raises(ValueError, match="not empty"):
        ex["fault_tolerant_train"].run(str(tmp_path), "cpu")


@pytest.mark.parametrize("name", NAMES)
def test_every_example_asks_for_the_card(ex, name, monkeypatch):
    """``--device cuda`` (the default) without a card fails; nothing
    carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ex[name].main([])


@pytest.mark.parametrize("name", NAMES)
def test_every_example_runs_from_its_main_on_the_cpu(ex, name, tmp_path,
                                                     monkeypatch):
    """``main(["--device", "cpu", ...])`` returns 0, at the example's
    defaults where they run in seconds here (train_lm at 3 steps of 2 x 16
    tokens; fault_tolerant_train's own schedule on the host preset)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--device", "cpu"]
    if name == "train_lm":
        argv += ["--steps", "3", "--batch", "2", "--seq", "16", "--ckpt",
                 str(tmp_path / "ckpt")]
    assert ex[name].main(argv) == 0
