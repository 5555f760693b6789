"""Training in the port (``repro_torch.train``, ``models.convert``'s tree
bridge, remat, the gradient guard) against the JAX package's.

One ``train_step`` per family from JAX's own initial train state
(``train_state_from_jax``) on JAX's batch (the reduced configs, f32):
dense (``qwen1.5-0.5b``; also Adafactor, two micro steps, int8 error
feedback and the z-loss), ssm (``mamba2-130m``, whose unused ``ln2`` takes
zeros), hybrid (``recurrentgemma-9b``), moe (``qwen2-moe-a2.7b``, aux > 0),
vlm without memory (``llama-3.2-vision-90b``: its cross-attention takes
zero gradients and is still decayed) and audio (``whisper-large-v3``, its
encoder unused).  Metrics at f32 ``DTYPE_TOL``; the optimizer state at
f32 ``DTYPE_TOL``; the new parameters at f32 ``DTYPE_TOL`` but for
AdamW's elements whose gradient is below 1e-6 (see ``_check_params``).
Then remat, the gradient guard, the JAX package's own cases of
``tests/test_train_loop.py`` and ``tests/test_fault.py`` on the port, and
the launcher on the CPU.
"""
import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import DTYPE_TOL, _rng, assert_kernel_close
from repro import tuning as j_tuning
from repro.configs import base as j_base
from repro.data.pipeline import Batcher as JBatcher, DataConfig as JDataConfig
from repro.models.model import Model as JModel
from repro.train import step as j_step
from repro_torch import tuning as t_tuning
from repro_torch.configs.base import get_arch
from repro_torch.data.pipeline import Batcher, DataConfig
from repro_torch.models import attention as t_attn
from repro_torch.models.convert import (assign_tree, grad_tree, load_params,
                                        param_tree, train_state_from_jax)
from repro_torch.models.model import Model, build_model
from repro_torch.optim.tree import flatten_with_path
from repro_torch.train import step as t_step
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import (FaultInjector, HeartbeatWatchdog,
                                     StragglerDetector, plan_elastic_remesh)
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.tuning.dispatch import no_backward

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {"dense": "qwen1.5-0.5b", "ssm": "mamba2-130m",
            "hybrid": "recurrentgemma-9b", "moe": "qwen2-moe-a2.7b",
            "vlm": "llama-3.2-vision-90b", "audio": "whisper-large-v3"}
LR = 1e-3                       # the first step's learning rate below
B1, EPS = 0.9, 1e-8             # AdamW's defaults in both packages
QUIET_GRAD = 100 * EPS          # see _check_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, so that beside other busy test
    processes torch's pool does not make each of them wait."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def pinned(tmp_path):
    """Both default sessions on tpu_v5e with empty DBs (the ssm and hybrid
    forwards resolve kernel configs)."""
    j_hw = __import__("repro.hw.profiles", fromlist=["get_profile"])
    t_hw = __import__("repro_torch.hw.profiles", fromlist=["get_profile"])
    jprev = j_tuning.set_default_session(j_tuning.TunerSession(
        db_path=str(tmp_path / "jax.json"),
        spec=j_hw.get_profile("tpu_v5e")))
    tprev = t_tuning.set_default_session(t_tuning.TunerSession(
        db_path=str(tmp_path / "torch.json"),
        spec=t_hw.get_profile("tpu_v5e")))
    yield
    j_tuning.set_default_session(jprev)
    t_tuning.set_default_session(tprev)


def j_get_arch(name):
    j_base._load_all()
    return j_base._REGISTRY[name]


def _hp(mod, **kw):
    return mod.TrainHParams(peak_lr=LR, warmup_steps=1, total_steps=10, **kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jax_step(arch, seed=0, **kw):
    """JAX's initial state and batch, the state and metrics after one
    jitted step, and their spread: the most each metric and each leaf
    moves when JAX's initial params are perturbed by 1e-7 relative (two
    draws).  That is how far rounding alone moves JAX's own result: at the
    reduced mamba2's init the grad norm moves by up to 1e-4 relative (an
    RMS norm over near-zero rows amplifies the backward's rounding), so
    no f32 implementation can be held closer than that."""
    cfg = j_get_arch(arch).reduced()
    model = JModel(cfg)
    hp = _hp(j_step, **kw)
    state = j_step.init_train_state(model, hp, jax.random.PRNGKey(seed))
    batch = next(JBatcher(JDataConfig(vocab=cfg.vocab, seq_len=32,
                                      global_batch=4, seed=seed)))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(j_step.make_train_step(model, hp))
    init = jax.tree.map(np.asarray, state)
    new, metrics = step(state, jbatch)
    new, metrics = _leaves(new), {k: _np(v) for k, v in metrics.items()}
    spread = {k: 0.0 for k in list(new) + list(metrics)}
    rng = _rng(f"perturb-{arch}-{seed}")
    for _ in range(2):
        params = jax.tree.map(
            lambda p: p * (1 + jnp.asarray(rng.normal(size=p.shape) * 1e-7,
                                           p.dtype)), state["params"])
        other, om = step(dict(state, params=params), jbatch)
        other = dict(_leaves(other), **{k: _np(v) for k, v in om.items()})
        for key, want in list(new.items()) + list(metrics.items()):
            spread[key] = max(spread[key],
                              float(np.max(np.abs(other[key] - want))))
    return init, batch, new, metrics, spread


def _port_step(arch, init, batch, **kw):
    model = Model(get_arch(arch).reduced(), device="cpu")
    state = train_state_from_jax(init)
    step = t_step.make_train_step(model, _hp(t_step, **kw))
    new, metrics = step(state, batch)
    return model, new, metrics


def _leaves(state):
    """(path, f32 numpy) of a train state of either package."""
    tree = {"params": state["params"], "opt": list(state["opt"]),
            "step": state["step"]}
    if "ef_err" in state:
        tree["ef_err"] = state["ef_err"]
    return {k: _np(v) for k, v in flatten_with_path(tree)}


def _tol(want, spread):
    """f32 DTYPE_TOL (as ``assert_kernel_close``) plus four times JAX's
    own spread under rounding-level noise."""
    rtol, atol = DTYPE_TOL["float32"]
    return rtol * np.abs(want) \
        + atol * max(float(np.max(np.abs(want))), 1.0) + 4 * spread


def _check_params(got, want, mu, spread, lr=LR):
    """New params after one AdamW step.  The step is delta = g / (|g| +
    eps) + wd p, so an element whose gradient lies near the two packages'
    rounding noise (far below DTYPE_TOL) can take a step of another size
    or sign: |d delta / dg| = eps / (|g| + eps)^2 reaches 1 / eps at g = 0.
    Such elements (|g| < QUIET_GRAD = 100 eps, g = mu / (1 - b1) from JAX's
    first moment) may differ by up to 2 lr, the most a step of |delta| <= 1
    can move; every other element is held to ``_tol``."""
    tol = _tol(want, spread)
    err = np.abs(got - want)
    quiet = np.abs(mu / (1 - B1)) < QUIET_GRAD
    assert np.all(err[~quiet] <= tol[~quiet]), float(np.max(err[~quiet]))
    assert np.all(err <= 2 * lr + tol)


def _check_state(want, tnew, spread, adam=True):
    got = _leaves(tnew)
    assert sorted(got) == sorted(want)
    for key in want:
        if key.startswith("params/") and adam:
            _check_params(got[key], want[key],
                          want["opt/0/" + key[len("params/"):]], spread[key])
        else:
            err = np.abs(got[key] - want[key])
            assert np.all(err <= _tol(want[key], spread[key])), key
    assert int(tnew["step"]) == 1 and tnew["step"].dtype == torch.int32


def _check_metrics(tmet, jmet, spread):
    assert sorted(tmet) == sorted(jmet) == [
        "accuracy", "aux", "grad_norm", "loss", "nll", "tokens"]
    for key in jmet:
        err = np.abs(_np(tmet[key]) - jmet[key])
        assert np.all(err <= _tol(jmet[key], spread[key])), \
            (key, _np(tmet[key]), jmet[key], spread[key])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_matches_repro(pinned, family):
    arch = FAMILIES[family]
    init, batch, jnew, jmet, spread = _jax_step(arch)
    model, tnew, tmet = _port_step(arch, init, batch)
    _check_metrics(tmet, jmet, spread)
    _check_state(jnew, tnew, spread)
    if family == "moe":
        assert float(tmet["aux"]) > 0
    # the model holds the new params
    for key, leaf in flatten_with_path(param_tree(model)):
        assert torch.equal(leaf, dict(flatten_with_path(tnew["params"]))[key])


@pytest.mark.parametrize("kw", [
    {"optimizer": "adafactor"}, {"micro_steps": 2},
    {"grad_compression": "int8_ef"}, {"z_weight": 1e-2},
    {"micro_steps": 2, "grad_compression": "int8_ef",
     "optimizer": "adafactor"}], ids=lambda kw: "-".join(
         f"{k}={v}" for k, v in kw.items()))
def test_dense_train_step_variants_match_repro(kw):
    init, batch, jnew, jmet, spread = _jax_step(FAMILIES["dense"], seed=1,
                                                **kw)
    _, tnew, tmet = _port_step(FAMILIES["dense"], init, batch, **kw)
    _check_metrics(tmet, jmet, spread)
    _check_state(jnew, tnew, spread, adam=kw.get("optimizer") != "adafactor")
    if "int8_ef" in kw.values():
        assert sorted(tnew) == ["ef_err", "opt", "params", "step"]


def test_micro_steps_accumulate_grads_in_f32(monkeypatch):
    """bf16 params: one micro step keeps the grads in bf16, two accumulate
    (and clip) them in f32, as in JAX."""
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").reduced(),
                              param_dtype="bfloat16")
    seen = []
    clip = t_step.clip_by_global_norm
    monkeypatch.setattr(t_step, "clip_by_global_norm", lambda g, m: (
        seen.append(g["embed"]["table"].dtype), clip(g, m))[1])
    batch = next(Batcher(DataConfig(vocab=cfg.vocab, seq_len=16,
                                    global_batch=4)))
    for n in (1, 2):
        model = Model.init(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
        hp = _hp(t_step, micro_steps=n)
        state = t_step.init_train_state(model, hp)
        new, _ = t_step.make_train_step(model, hp)(state, batch)
        assert new["params"]["embed"]["table"].dtype == torch.bfloat16
        assert new["opt"].mu["embed"]["table"].dtype == torch.float32
    assert seen == [torch.bfloat16, torch.float32]


def test_cross_entropy_matches_repro():
    rng = _rng("xent")
    logits = rng.normal(size=(2, 5, 33)).astype(np.float32)
    logits[0, 0, 7] = logits[0, 0].max() + 1.0          # a correct row
    targets = rng.integers(0, 33, size=(2, 5)).astype(np.int32)
    targets[0, 0] = 7
    mask = (rng.random((2, 5)) < 0.7).astype(np.float32)
    for z in (0.0, 1e-3):
        jl, jm = j_step.cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(targets),
                                      jnp.asarray(mask), z)
        tl, tm = t_step.cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(targets),
                                      torch.from_numpy(mask), z)
        assert_kernel_close(_np(tl), _np(jl), "float32")
        for key in jm:
            assert_kernel_close(_np(tm[key]), _np(jm[key]), "float32")
    _, tm = t_step.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(targets),
                                 torch.zeros(2, 5))
    assert float(tm["tokens"]) == 1.0                  # max(sum(mask), 1)


# --- the tree bridge ---

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_param_tree_is_the_jax_tree(family):
    """Paths and shapes of JAX's params (stacked over the groups, None for
    an absent MLP); assign_tree inverts param_tree."""
    arch = FAMILIES[family]
    jparams = JModel(j_get_arch(arch).reduced()).init(jax.random.PRNGKey(0))
    jparams = jax.tree.map(np.asarray, jparams)
    model = load_params(Model(get_arch(arch).reduced(), device="cpu"),
                        jparams)
    tree = param_tree(model)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jparams)) \
        == jax.tree.structure(jax.tree.map(
            lambda _: 0, tree, is_leaf=lambda x: isinstance(x,
                                                            torch.Tensor)))
    want = dict(flatten_with_path(jparams))
    for key, leaf in flatten_with_path(tree):
        np.testing.assert_array_equal(_np(leaf), want[key].astype(np.float32))
    if family == "ssm":
        assert tree["blocks"]["mlp"] is None
    other = Model(get_arch(arch).reduced(), device="cpu")
    assign_tree(other, tree)
    for (ka, a), (kb, b) in zip(model.state_dict().items(),
                                other.state_dict().items()):
        assert ka == kb and torch.equal(a, b)


def test_grad_tree_gives_zeros_where_the_loss_does_not_reach(pinned):
    """mamba2's ln2 (no MLP) and the vlm's cross-attention without memory
    take no gradient: zeros, as jax.grad gives, in their own types."""
    for arch, path in (("mamba2-130m", ("blocks", "ln2")),
                       ("llama-3.2-vision-90b",
                        ("blocks", "blocks", 1, "xattn", "wq", "w"))):
        model = Model.init(get_arch(arch).reduced(),
                           torch.Generator().manual_seed(0), device="cpu")
        logits, _ = model(torch.zeros(1, 8, dtype=torch.long))
        logits.sum().backward()
        leaf = grad_tree(model)
        for key in path:
            leaf = leaf[key]
        assert leaf.dtype == torch.float32 and not leaf.any()
        assert grad_tree(model)["embed"]["table"].any()


# --- remat ---

def _grads(model, tokens, memory=None):
    model.zero_grad(set_to_none=True)
    logits, aux = model(tokens, memory=memory)
    (logits.square().mean() + aux).backward()
    return {k: v.clone() for k, v in flatten_with_path(grad_tree(model))}


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "recurrentgemma-9b",
                                  "llama-3.2-vision-90b",
                                  "whisper-large-v3"])
def test_remat_gives_the_same_grads(pinned, monkeypatch, arch):
    """remat="full" recomputes every group (and each layer of a hybrid or
    vlm group, each q-chunk of the plain attention, made to chunk here)
    in the backward: the same grads as "none", with more forward calls;
    under no_grad no recompute."""
    monkeypatch.setattr(t_attn, "_SCORE_ELEMS_LIMIT", 16 * 16)
    monkeypatch.setattr(t_attn, "_Q_CHUNK", 16)
    calls = []
    core = t_attn._attention_core
    monkeypatch.setattr(t_attn, "_attention_core",
                        lambda *a, **k: calls.append(1) or core(*a, **k))
    cfg = get_arch(arch).reduced()
    tokens = torch.from_numpy(_rng("remat").integers(0, cfg.vocab,
                                                     size=(2, 64)))
    memory = torch.from_numpy(_rng("remat-mem").normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)) \
        if cfg.family == "vlm" else None
    grads, counts = {}, {}
    for remat in ("none", "full"):
        model = Model.init(dataclasses.replace(cfg, remat=remat),
                           torch.Generator().manual_seed(0), device="cpu")
        calls.clear()
        grads[remat] = _grads(model, tokens, memory)
        counts[remat] = len(calls)
        calls.clear()
        with torch.no_grad():
            model(tokens, memory=memory)
        counts[remat, "no_grad"] = len(calls)
    # the q-chunks recompute under either setting, as in JAX; "full" adds
    # the groups and layers; a forward without grad recomputes nothing
    base = counts["none", "no_grad"]
    assert counts["full", "no_grad"] == base > 0
    assert counts["full"] > counts["none"] == 2 * base
    for key, g in grads["none"].items():
        assert torch.allclose(grads["full"][key], g, rtol=1e-6, atol=1e-7), \
            key
    if cfg.family == "audio":
        model = Model.init(dataclasses.replace(cfg, remat="full"),
                           torch.Generator().manual_seed(0), device="cpu")
        frames = torch.from_numpy(_rng("frames").normal(
            size=(1, 16, cfg.d_model)).astype(np.float32))
        calls.clear()
        model.encode(frames).sum().backward()
        assert len(calls) == 2 * cfg.n_enc_layers
        assert model.enc_blocks[0].attn.wq.w.grad.any()


# --- the gradient guard ---

def test_the_guard_raises_on_backward():
    x = torch.randn(4, 8, requires_grad=True)
    out = x.detach() * 3.0                     # a kernel's fresh output
    y = no_backward("scan_add", out, x)
    assert torch.equal(y, out) and y.requires_grad
    with pytest.raises(RuntimeError, match="no backward for the CUDA "
                                           "kernel scan_add"):
        (y * 2).sum().backward()
    assert x.grad is None                       # no partial gradient
    h, p = no_backward("scan_linrec", (out, None), x, None)
    assert p is None and h.requires_grad
    three = no_backward("ssd_intra", (out, out[:, 0], out[0]), x)
    with pytest.raises(RuntimeError, match="ssd_intra"):
        three[1].sum().backward()


def test_the_guard_leaves_inference_alone():
    x = torch.randn(4, 8, requires_grad=True)
    out = x.detach() + 1
    with torch.no_grad():
        assert no_backward("pcr", out, x) is out
    with torch.inference_mode():
        assert no_backward("pcr", out, x) is out
    assert no_backward("pcr", out, x.detach()) is out


def _launch_functions():
    """(file, function, guarded) of every function under kernels/ that
    calls load_library(): guarded when each return after that call goes
    through no_backward."""
    out = []
    base = os.path.join(ROOT, "src", "repro_torch", "kernels")
    for dirpath, _, files in os.walk(base):
        for name in files:
            path = os.path.join(dirpath, name)
            if not name.endswith(".py") or name == "build.py":
                continue
            tree = ast.parse(open(path).read())
            for fn in ast.walk(tree):
                if not isinstance(fn, ast.FunctionDef):
                    continue
                loads = [c.lineno for c in ast.walk(fn)
                         if isinstance(c, ast.Call)
                         and getattr(c.func, "id", "") == "load_library"]
                if not loads:
                    continue
                # the returns after the library is loaded (an entry point
                # returns its plain version's result before)
                returns = [r for r in ast.walk(fn)
                           if isinstance(r, ast.Return)
                           and r.lineno > min(loads)]
                guarded = bool(returns) and all(
                    isinstance(r.value, ast.Call)
                    and getattr(r.value.func, "id", "") == "no_backward"
                    for r in returns)
                out.append((os.path.relpath(path, base), fn.name, guarded))
    return out


def test_every_launch_site_returns_through_the_guard():
    sites = _launch_functions()
    assert {(f, n) for f, n, _ in sites} >= {
        ("attention/kernel.py", "_launch"), ("matmul/kernel.py", "_launch"),
        ("blocks/driver.py", "apply_add"),
        ("blocks/driver.py", "apply_linrec"),
        ("scan/kernel.py", "_launch"), ("scan/kernel.py", "_launch_linrec"),
        ("ssd/kernel.py", "_launch_intra"),
        ("ssd/kernel.py", "_launch_apply"), ("fft/kernel.py", "_launch"),
        ("tridiag/kernel.py", "_launch"),
        ("tridiag/kernel.py", "_launch_thomas")}
    assert [s for s in sites if not s[2]] == []


# --- the JAX package's own cases (tests/test_train_loop.py), on the port ---

def _setup(arch="qwen1.5-0.5b", steps=8):
    cfg = get_arch(arch).reduced()
    model = build_model(cfg, device="cpu")
    hp = t_step.TrainHParams(peak_lr=5e-3, warmup_steps=2, total_steps=steps,
                             z_weight=0.0)
    data = iter(Batcher(DataConfig(vocab=cfg.vocab, seq_len=64,
                                   global_batch=4)))
    return model, hp, data


def test_loss_decreases():
    model, hp, data = _setup(steps=12)
    out = run_training(model, hp, LoopConfig(total_steps=12, log_every=1),
                       data, log=lambda *_: None)
    hist = out["history"]
    first = np.mean([h["loss"] for h in hist[:3]])
    last = np.mean([h["loss"] for h in hist[-3:]])
    assert np.isfinite(last) and last < first


def test_checkpoint_restart_after_injected_failure(tmp_path):
    model, hp, data = _setup(steps=8)
    loop = LoopConfig(total_steps=8, checkpoint_dir=str(tmp_path),
                      checkpoint_every=2, log_every=100)
    inj = FaultInjector(fail_at_steps=(5,))
    with pytest.raises(RuntimeError, match="injected node failure"):
        run_training(model, hp, loop, data, injector=inj,
                     log=lambda *_: None)
    # restart: auto-resumes from step 4's checkpoint and completes
    model2, hp2, data2 = _setup(steps=8)
    out = run_training(model2, hp2, loop, data2, injector=inj,
                       log=lambda *_: None)
    assert out["resumed_from"] >= 4
    assert out["history"][-1]["step"] == 7


def test_grad_accum_equivalence():
    """micro_steps=2 produces the same loss trajectory scale (sanity)."""
    model, hp, data = _setup(steps=4)
    hp2 = dataclasses.replace(hp, micro_steps=2)
    out = run_training(model, hp2, LoopConfig(total_steps=4, log_every=1),
                       data, log=lambda *_: None)
    assert np.isfinite(out["history"][-1]["loss"])


def test_restart_restores_the_saved_bf16_params_bit_for_bit(tmp_path):
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").reduced(),
                              param_dtype="bfloat16")
    hp = t_step.TrainHParams(peak_lr=5e-3, warmup_steps=1, total_steps=4)
    loop = LoopConfig(total_steps=4, checkpoint_dir=str(tmp_path),
                      checkpoint_every=2, log_every=100)
    data = Batcher(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2))
    with pytest.raises(RuntimeError, match="injected"):
        run_training(build_model(cfg, device="cpu"), hp, loop, data,
                     injector=FaultInjector((3,)), log=lambda *_: None)
    model = build_model(cfg, device="cpu")
    step, saved = CheckpointManager(str(tmp_path)).restore_latest(
        t_step.init_train_state(model, hp))
    assert step == 2
    out = run_training(model, hp, dataclasses.replace(loop, total_steps=2),
                       data, log=lambda *_: None)
    assert out["resumed_from"] == 2 and out["history"] == []
    saved = dict(flatten_with_path(saved["params"]))
    for key, leaf in flatten_with_path(out["state"]["params"]):
        assert leaf.dtype == torch.bfloat16
        assert torch.equal(leaf.view(torch.int16),
                           saved[key].view(torch.int16)), key


def test_prefill_and_decode_steps_match_repro():
    arch = FAMILIES["dense"]
    jcfg = j_get_arch(arch).reduced()
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = load_params(Model(get_arch(arch).reduced(), device="cpu"),
                        jax.tree.map(np.asarray, params))
    tokens = _rng("prefill-step").integers(0, jcfg.vocab, size=(2, 16))
    want = j_step.make_prefill_step(jm)(params,
                                        {"tokens": jnp.asarray(tokens)})
    got = t_step.make_prefill_step(model)({"tokens": tokens})
    assert_kernel_close(_np(got), _np(want), "float32")
    cache = model.init_cache(2, 8, dtype=torch.float32)
    jcache = jm.init_cache(2, 8, dtype=jnp.float32)
    tok, pos = tokens[:, :1], np.zeros((2, 1), np.int32)
    jl, _ = j_step.make_decode_step(jm)(params, jnp.asarray(tok), jcache,
                                        jnp.asarray(pos))
    tl, new_cache = t_step.make_decode_step(model)(
        torch.from_numpy(tok), cache, torch.from_numpy(pos))
    assert tl.shape == (2, jcfg.vocab) and len(new_cache) == jcfg.n_layers
    assert_kernel_close(_np(tl), _np(jl), "float32")


def test_launch_train_runs_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import train as launch
    launch.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
                 "--steps", "2", "--batch", "2", "--seq", "16", "--ckpt",
                 str(tmp_path), "--ckpt-every", "1"])
    out = capsys.readouterr().out
    assert "[train] done: {'step': 1" in out
    assert sorted(os.listdir(tmp_path)) == ["step_0000000001",
                                            "step_0000000002"]


def test_launch_train_asks_for_the_card(monkeypatch):
    from repro_torch.launch import train as launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "1"])


# --- the JAX package's own cases (tests/test_fault.py), on the port ---

def test_straggler_detection():
    d = StragglerDetector(threshold=2.0, warmup_steps=2)
    for i in range(5):
        assert not d.observe(i, 1.0)
    assert d.observe(5, 5.0)          # 5x the EMA
    assert d.events[0][0] == 5
    # a straggler does not poison the EMA
    assert d.ema == pytest.approx(1.0, rel=0.01)


def test_watchdog_with_fake_clock():
    t = [0.0]
    wd = HeartbeatWatchdog(timeout_factor=3.0, min_timeout=10.0,
                           clock=lambda: t[0])
    for _ in range(5):
        t[0] += 2.0
        wd.beat()
    assert not wd.poll()
    t[0] += 9.0                        # < min_timeout
    assert not wd.poll()
    t[0] += 5.0                        # now past the 10s floor
    assert wd.poll()


def test_elastic_plan_keeps_model_axis():
    plan = plan_elastic_remesh(available_chips=240, model_axis=16,
                               target_batch=256)
    assert plan.model_axis == 16
    assert plan.data_axis == 15
    assert plan.global_batch % (plan.data_axis * plan.pod_axis) == 0
    assert plan.dropped_chips == 240 - 15 * 16


def test_elastic_plan_insufficient_chips():
    with pytest.raises(ValueError):
        plan_elastic_remesh(available_chips=8, model_axis=16,
                            target_batch=256)


def test_fault_injector_fires_once():
    inj = FaultInjector(fail_at_steps=(3,))
    inj.maybe_fail(2)
    with pytest.raises(RuntimeError):
        inj.maybe_fail(3)
    inj.maybe_fail(3)                  # second pass (post-restart) proceeds
