"""The port's RG-LRU block (``models.recurrent``) against the JAX package's.

``RecurrentBlock`` on ``recurrentgemma-9b.reduced()`` (d_model 64,
lru_width 64, conv width 4) with the JAX block's parameters loaded through
``models.convert.load_params``: the prefill (no cache: the recurrence over
(B * W, L) rows) in f32 and bf16 compute, with ``use_pallas`` on (JAX's
Pallas linrec kernel in interpret mode against the port's tuned
``linear_recurrence``, the CUDA kernels' plain versions on the CPU, with
the same launch list) and off (both packages' associative-scan
reference); the one-token decode steps through the conv and state cache;
a cache with L > 1 (the recurrence restarts from zero, as in JAX);
``lambda`` and the init scales; and the hybrid model's decode through its
ring-buffer KV cache past the wrap.  Inputs are drawn with numpy.
Tolerance: ``DTYPE_TOL`` of the compute type.
"""
import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import _rng, assert_kernel_close
from repro import tuning as j_tuning
from repro.configs.recurrentgemma_9b import CONFIG as J_RG
from repro.models.model import Model as JModel
from repro.kernels.blocks import driver as j_driver
from repro.models import recurrent as j_rec
from repro_torch import tuning as t_tuning
from repro_torch.configs.recurrentgemma_9b import CONFIG as T_RG
from repro_torch.kernels.blocks import driver as t_driver
from repro_torch.models import recurrent as t_rec
from repro_torch.models.convert import load_params, state_dict_from_params
from repro_torch.models.model import Model

j_hw = importlib.import_module("repro.hw.profiles")
t_hw = importlib.import_module("repro_torch.hw.profiles")

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def pinned(tmp_path):
    """Both default sessions on tpu_v5e with empty DBs: the same linrec
    config and plan in both packages."""
    jprev = j_tuning.set_default_session(j_tuning.TunerSession(
        db_path=str(tmp_path / "jax.json"),
        spec=j_hw.get_profile("tpu_v5e")))
    tprev = t_tuning.set_default_session(t_tuning.TunerSession(
        db_path=str(tmp_path / "torch.json"),
        spec=t_hw.get_profile("tpu_v5e")))
    yield
    j_tuning.set_default_session(jprev)
    t_tuning.set_default_session(tprev)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _asdicts(launches):
    return [dataclasses.asdict(launch) for launch in launches]


def _pair(seed=0, **changes):
    """The JAX block's parameters and the port's block loaded with them,
    both on the reduced recurrentgemma config with ``changes``."""
    jcfg = dataclasses.replace(J_RG.reduced(), **changes)
    tcfg = dataclasses.replace(T_RG.reduced(), **changes)
    params = j_rec.init_recurrent_block(jax.random.PRNGKey(seed), jcfg,
                                        jnp.float32)
    block = load_params(t_rec.RecurrentBlock(tcfg, torch.float32),
                        jax.tree.map(np.asarray, params))
    return jcfg, tcfg, params, block


def _x(tag, cfg, B, L, dtype):
    x = _rng(tag).normal(size=(B, L, cfg.d_model)).astype(np.float32)
    return (jnp.asarray(x).astype(_JNP[dtype]),
            torch.from_numpy(x).to(_TORCH[dtype]))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrent_block_prefill_matches_repro(pinned, use_pallas, dtype):
    """The whole sequence through the recurrence: the tuned entry point
    (use_pallas: the same launch list as JAX's Pallas run) or the
    associative-scan reference."""
    jcfg, tcfg, params, block = _pair(use_pallas=use_pallas)
    jx, tx = _x(f"recprefill{dtype}", jcfg, 2, 64, dtype)
    with j_driver.capture_launches() as jl:
        jy, jc = j_rec.recurrent_block(params, jx, jcfg,
                                       compute_dtype=_JNP[dtype])
    with t_driver.capture_launches() as tl, torch.no_grad():
        ty, tc = block(tx, tcfg, compute_dtype=_TORCH[dtype])
    assert jc is None and tc is None
    assert ty.dtype == _TORCH[dtype] and ty.shape == tx.shape
    assert _asdicts(tl) == _asdicts(jl)
    assert (len(tl) >= 1) == use_pallas
    assert_kernel_close(_np(ty), _np(jy), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrent_block_decode_matches_repro(dtype):
    """Six one-token steps through the conv and state cache from a
    non-zero cache: each step's output and the new cache (conv in the
    cache's type, state in f32)."""
    jcfg, tcfg, params, block = _pair(seed=1)
    B, w = 3, jcfg.lru_width
    rng = _rng(f"recdecode{dtype}")
    conv = rng.normal(size=(B, jcfg.conv_width - 1, w)).astype(np.float32)
    state = rng.normal(size=(B, w)).astype(np.float32)
    jcache = {"conv": jnp.asarray(conv).astype(_JNP[dtype]),
              "state": jnp.asarray(state)}
    tcache = {"conv": torch.from_numpy(conv).to(_TORCH[dtype]),
              "state": torch.from_numpy(state)}
    for t in range(6):
        jx, tx = _x(f"recdecode{dtype}{t}", jcfg, B, 1, dtype)
        jy, jcache = j_rec.recurrent_block(params, jx, jcfg, cache=jcache,
                                           compute_dtype=_JNP[dtype])
        with torch.no_grad():
            ty, tcache = block(tx, tcfg, cache=tcache,
                               compute_dtype=_TORCH[dtype])
        assert_kernel_close(_np(ty), _np(jy), dtype)
        assert tcache["conv"].dtype == _TORCH[dtype]
        assert tcache["state"].dtype == torch.float32
        for key in ("conv", "state"):
            assert_kernel_close(_np(tcache[key]), _np(jcache[key]), dtype)


def test_recurrent_block_with_cache_restarts_the_recurrence():
    """A cached call with L > 1 runs the recurrence from zero and ignores
    cache["state"] (the JAX block's behaviour, copied): its output equals
    the uncached call's, and the new state is the last step's."""
    jcfg, tcfg, params, block = _pair(seed=2)
    B, L, w = 2, 8, jcfg.lru_width
    rng = _rng("recrestart")
    conv = np.zeros((B, jcfg.conv_width - 1, w), np.float32)
    state = rng.normal(size=(B, w)).astype(np.float32)
    jx, tx = _x("recrestartx", jcfg, B, L, "float32")
    jy, jc = j_rec.recurrent_block(
        params, jx, jcfg, cache={"conv": jnp.asarray(conv),
                                 "state": jnp.asarray(state)},
        compute_dtype=jnp.float32)
    with torch.no_grad():
        ty, tc = block(tx, tcfg, cache={"conv": torch.from_numpy(conv),
                                        "state": torch.from_numpy(state)},
                       compute_dtype=torch.float32)
        fresh, _ = block(tx, tcfg, compute_dtype=torch.float32)
    assert torch.equal(ty, fresh)
    assert_kernel_close(_np(ty), _np(jy), "float32")
    for key in ("conv", "state"):
        assert_kernel_close(_np(tc[key]), _np(jc[key]), "float32")


@pytest.mark.parametrize("use_pallas,want", [(False, "reference"),
                                             (True, "entry point")])
def test_recurrence_takes_the_jax_blocks_route(monkeypatch, use_pallas,
                                               want):
    """On the CPU the recurrence runs the tuned entry point only when
    use_pallas is set (JAX's ``use_pallas=cfg.use_pallas or None``); on the
    card it always does (no plain path there)."""
    _, tcfg, _, block = _pair(use_pallas=use_pallas)
    calls = []
    ref, entry = t_rec.scan_linrec_assoc_ref, t_rec.linear_recurrence
    monkeypatch.setattr(t_rec, "scan_linrec_assoc_ref",
                        lambda *a: calls.append("reference") or ref(*a))
    monkeypatch.setattr(t_rec, "linear_recurrence",
                        lambda *a: calls.append("entry point") or entry(*a))
    _, tx = _x("recroute", tcfg, 1, 16, "float32")
    with torch.no_grad():
        block(tx, tcfg, compute_dtype=torch.float32)
    assert calls == [want]


@pytest.mark.parametrize("width", [64, 2560, 4096])
def test_lambda_matches_repro(width):
    """The deterministic ``lambda`` = log(expm1(r^(-1/8) - 1)), r evenly
    spaced over [0.9, 0.999], in f32.  Not bit-equal: XLA's CPU linspace
    (iota times a reciprocal, reassociated) and expm1 (up to 5 ulp off the
    correctly rounded value) round differently from torch's, and one ulp
    of r near 0.999 moves lambda by about 1e-4 relative (d lambda / dr is
    about 1 / (1 - r)); held at that bound."""
    cfg = dataclasses.replace(J_RG.reduced(), lru_width=width)
    want = np.asarray(j_rec.init_recurrent_block(
        jax.random.PRNGKey(0), cfg, jnp.float32)["lambda"])
    got = t_rec.lru_lambda(width)
    assert got.dtype == torch.float32 and got.shape == (width,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4)


def test_recurrent_block_init_draws_at_the_jax_scales():
    """``reset`` draws the JAX tree's names, shapes, types and scales
    (conv_w over sqrt(conv_width)), and sets ``lambda`` deterministically;
    the cache holds conv in the given type and the state in f32."""
    cfg = dataclasses.replace(T_RG.reduced(), lru_width=128)
    jcfg = dataclasses.replace(J_RG.reduced(), lru_width=128)
    block = t_rec.RecurrentBlock(cfg, torch.bfloat16)
    block.reset(torch.Generator().manual_seed(0))
    params = j_rec.init_recurrent_block(jax.random.PRNGKey(0), jcfg,
                                        jnp.bfloat16)
    own = block.state_dict()
    want = state_dict_from_params(jax.tree.map(np.asarray, params))
    assert sorted(own) == sorted(want)
    for key, value in want.items():
        assert own[key].shape == value.shape, key
        assert own[key].dtype == value.dtype, key
        if key != "lambda":
            std = float(value.float().std())
            assert abs(float(own[key].float().std()) - std) <= 0.25 * std
    assert abs(float(own["conv_w"].float().std())
               - 1 / math.sqrt(cfg.conv_width)) < 0.25 / math.sqrt(
        cfg.conv_width)
    assert torch.equal(own["lambda"], t_rec.lru_lambda(128))
    cache = t_rec.init_recurrent_cache(cfg, 2, torch.bfloat16)
    jcache = j_rec.init_recurrent_cache(jcfg, 2, jnp.bfloat16)
    for key in ("conv", "state"):
        assert tuple(cache[key].shape) == jcache[key].shape
        assert str(cache[key].dtype).split(".")[-1] == str(jcache[key].dtype)
        assert not bool(cache[key].any())


def _leaves(tree):
    """A cache's tensors in a fixed order: the port's per-group lists, or
    JAX's group-stacked pytree unstacked the same way."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _j_groups(cache, n_groups):
    return [jax.tree.map(lambda a: a[i], cache) for i in range(n_groups)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_ring_buffer_matches_repro(dtype):
    """recurrentgemma with attn_window = 8 decoding 24 tokens one at a time
    through a ring buffer of 8 slots, past its wrap, in f32 and bf16
    compute: each step's logits and the final cache (slot positions bit
    for bit) against JAX's, and the steps against the port's forward
    (JAX's test_windowed_ring_buffer_cache: rel < 2e-2)."""
    jcfg = dataclasses.replace(J_RG.reduced(), attn_window=8,
                               compute_dtype=dtype)
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(3))
    tm = load_params(Model(dataclasses.replace(
        T_RG.reduced(), attn_window=8, compute_dtype=dtype), device="cpu"),
        jax.tree.map(np.asarray, params))
    cfg, B, L = jm.cfg, 2, 24
    tokens = _rng(f"ring{dtype}").integers(0, cfg.vocab, size=(B, L))
    jc = jm.init_cache(B, max_len=L, dtype=jnp.float32)
    tc = tm.init_cache(B, max_len=L, dtype=torch.float32)
    kinds = cfg.block_pattern
    ring = tc[0][kinds.index("attn")]
    assert ring["k"].shape[1] == 8 and ring["pos"].dtype == torch.int32
    assert bool((ring["pos"] == -2 ** 30).all())
    outs = []
    j_step = jax.jit(jm.decode_step)     # one trace for the 24 steps
    with torch.no_grad():
        full, _ = tm(torch.from_numpy(tokens))
        for t in range(L):
            pos = np.full((B, 1), t, np.int32)
            tok = tokens[:, t:t + 1]
            jl, jc = j_step(params, jnp.asarray(tok), jc, jnp.asarray(pos))
            tl, tc = tm.decode_step(torch.from_numpy(tok), tc,
                                    torch.from_numpy(pos))
            assert_kernel_close(_np(tl), _np(jl), dtype)
            outs.append(tl[:, 0])
    for g, w in zip(_leaves(tc), _leaves(_j_groups(jc, jm.n_groups))):
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            assert_kernel_close(_np(g), _np(w), dtype)
    slots = tc[0][kinds.index("attn")]["pos"]
    assert sorted(slots[0].tolist()) == list(range(L - 8, L))
    dec = torch.stack(outs, dim=1)
    rel = float((full - dec).abs().max()) / float(full.abs().max())
    assert rel < 2e-2, rel
