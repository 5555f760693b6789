"""The port's ``Model`` against the JAX package's.

Dense (``qwen1.5-0.5b.reduced()``: QKV bias, MHA of head_dim 16) and ssm
(``mamba2-130m.reduced()``) models, with the JAX model's parameters loaded
through ``models.convert.load_params``: ``forward`` logits with the flash
path (``use_pallas``: JAX's Pallas kernel in interpret mode, the port's
plain version of the CUDA kernel) and the plain-op path, in f32 and bf16
compute; ``init_cache``, the write-masked ``prefill`` and ``decode_step``;
the ring-buffer decode branch of ``self_attention``.  Inputs are drawn
with numpy.  Tolerance: ``DTYPE_TOL`` of the compute type.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import _rng, assert_kernel_close
from repro import tuning as j_tuning
from repro.configs import base as j_base
from repro.configs.mamba2_130m import CONFIG as J_MAMBA
from repro.configs.qwen15_05b import CONFIG as J_QWEN
from repro.models import attention as j_attn
from repro.models.model import Model as JModel
from repro_torch import tuning as t_tuning
from repro_torch.configs.base import all_archs, get_arch
from repro_torch.kernels.attention import kernel as t_flash
from repro_torch.models import attention as t_attn
from repro_torch.models.convert import load_params, state_dict_from_params
from repro_torch.models.model import Model, build_model

j_hw = importlib.import_module("repro.hw.profiles")
t_hw = importlib.import_module("repro_torch.hw.profiles")

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
QWEN, MAMBA = "qwen1.5-0.5b", "mamba2-130m"
# the JAX configs by module: its get_arch loads the registry only when it
# is empty, and another test module may have registered one config first
_J_CONFIGS = {QWEN: J_QWEN, MAMBA: J_MAMBA}


def j_get_arch(name):
    return _J_CONFIGS[name]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.fixture
def pinned(tmp_path):
    """Both default sessions on tpu_v5e with empty DBs."""
    jprev = j_tuning.set_default_session(j_tuning.TunerSession(
        db_path=str(tmp_path / "jax.json"),
        spec=j_hw.get_profile("tpu_v5e")))
    tprev = t_tuning.set_default_session(t_tuning.TunerSession(
        db_path=str(tmp_path / "torch.json"),
        spec=t_hw.get_profile("tpu_v5e")))
    yield
    j_tuning.set_default_session(jprev)
    t_tuning.set_default_session(tprev)


def _pair(arch, seed=0, **changes):
    """The JAX model, its parameters, and the port's model loaded with
    them, both on ``arch.reduced()`` with ``changes``."""
    jcfg = dataclasses.replace(j_get_arch(arch).reduced(), **changes)
    tcfg = dataclasses.replace(get_arch(arch).reduced(), **changes)
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = load_params(Model(tcfg, device="cpu"),
                     jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("arch", all_archs())
def test_configs_match_repro(arch):
    """Every arch of JAX's registry, field for field, full and reduced."""
    j_base._load_all()
    want = j_base._REGISTRY[arch]
    assert dataclasses.asdict(get_arch(arch)) == dataclasses.asdict(want)
    assert dataclasses.asdict(get_arch(arch).reduced()) \
        == dataclasses.asdict(want.reduced())
    assert all_archs() == tuple(sorted(j_base._REGISTRY))


@pytest.mark.parametrize("use_pallas,L,dtype", [
    (False, 32, "float32"), (False, 32, "bfloat16"),
    (True, 256, "float32"), (True, 256, "bfloat16")])
def test_dense_forward_matches_repro(pinned, monkeypatch, use_pallas, L,
                                     dtype):
    """Logits of the whole reduced qwen; with use_pallas every layer runs
    the flash function once (the CUDA kernel's plain version here)."""
    jm, params, tm = _pair(QWEN, use_pallas=use_pallas, compute_dtype=dtype)
    calls = []
    plain = t_flash.flash_attention_plain
    monkeypatch.setattr(t_flash, "flash_attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    tokens = _rng(f"dense{L}").integers(0, jm.cfg.vocab, size=(2, L))
    jl, jaux = jm.forward(params, jnp.asarray(tokens))
    with torch.no_grad():
        tl, taux = tm(torch.from_numpy(tokens))
    assert tl.dtype == torch.float32 and tl.shape == (2, L, jm.cfg.vocab)
    assert float(taux) == float(jaux) == 0.0
    assert len(calls) == (jm.cfg.n_layers if use_pallas else 0)
    assert_kernel_close(_np(tl), _np(jl), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_forward_matches_repro(pinned, dtype):
    jm, params, tm = _pair(MAMBA, compute_dtype=dtype)
    tokens = _rng("ssmforward").integers(0, jm.cfg.vocab, size=(2, 128))
    jl, _ = jm.forward(params, jnp.asarray(tokens))
    with torch.no_grad():
        tl, _ = tm(torch.from_numpy(tokens))
    assert_kernel_close(_np(tl), _np(jl), dtype)


def _stack(cache, key):
    return np.stack([_np(c[key]) for c in cache])


@pytest.mark.parametrize("arch", [QWEN, MAMBA])
def test_prefill_and_decode_match_repro(arch):
    """A write-masked prefill (lane 1 skips steps 2 and 3), then two decode
    steps: every cache entry and the decode logits, in f32."""
    jm, params, tm = _pair(arch)
    B, steps, max_len = 3, 6, 16
    rng = _rng(f"prefill{arch}")
    tokens = rng.integers(0, jm.cfg.vocab, size=(steps, B))
    positions = np.tile(np.arange(steps)[:, None], (1, B)).astype(np.int32)
    write = np.ones((steps, B), bool)
    write[2:4, 1] = False
    jc = jm.init_cache(B, max_len, dtype=jnp.float32)
    tc = tm.init_cache(B, max_len, dtype=torch.float32)
    assert len(tc) == jm.n_groups
    jc = jm.prefill(params, jnp.asarray(tokens), jc, jnp.asarray(positions),
                    jnp.asarray(write))
    with torch.no_grad():
        tc = tm.prefill(torch.from_numpy(tokens), tc,
                        torch.from_numpy(positions), torch.from_numpy(write))
        for t in range(2):
            tok = rng.integers(0, jm.cfg.vocab, size=(B, 1))
            pos = np.full((B, 1), steps + t, np.int32)
            jl, jc = jm.decode_step(params, jnp.asarray(tok), jc,
                                    jnp.asarray(pos))
            tl, tc = tm.decode_step(torch.from_numpy(tok), tc,
                                    torch.from_numpy(pos))
            assert tl.shape == (B, 1, jm.cfg.vocab)
            assert_kernel_close(_np(tl), _np(jl), "float32")
    for key in tc[0]:
        assert_kernel_close(_stack(tc, key), _np(jc[key]), "float32")


def test_decode_matches_forward():
    """The JAX suite's own check, on the port: one token at a time through
    the cache gives the forward's logits (rel < 2e-2)."""
    cfg = get_arch(QWEN).reduced()
    model = Model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    B, L = 2, 12
    tokens = torch.from_numpy(_rng("decodefwd").integers(0, cfg.vocab,
                                                         size=(B, L)))
    with torch.no_grad():
        full, _ = model(tokens)
        cache = model.init_cache(B, L, dtype=torch.float32)
        outs = []
        for t in range(L):
            pos = torch.full((B, 1), t, dtype=torch.int32)
            lg, cache = model.decode_step(tokens[:, t:t + 1], cache, pos)
            outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    rel = float((full - dec).abs().max()) / (float(full.abs().max()) + 1e-9)
    assert rel < 2e-2, rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_buffer_decode_matches_repro(dtype):
    """self_attention's windowed decode on a ring-buffer cache of W = 8
    slots, past its wrap, against JAX's."""
    jm, params, tm = _pair(QWEN, attn_window=8)
    cfg, W, B = jm.cfg, 8, 2
    blk = jax.tree.map(lambda a: a[0], params["blocks"])["attn"]
    rng = _rng(f"ring{dtype}")
    shape = (B, W, cfg.n_kv_heads, cfg.head_dim)
    k0 = rng.normal(size=shape).astype(np.float32)
    v0 = rng.normal(size=shape).astype(np.float32)
    slot_pos = np.array([[8, 9, 10, 3, 4, 5, 6, 7],
                         [-2 ** 30] * 3 + [3, 4, 5, 6, 7]], np.int32)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([[11], [8]], np.int32)
    jo, jc = j_attn.self_attention(
        blk, jnp.asarray(x), cfg, positions=jnp.asarray(pos),
        cache={"k": jnp.asarray(k0), "v": jnp.asarray(v0),
               "pos": jnp.asarray(slot_pos)}, window=W,
        compute_dtype=_JNP[dtype])
    cache = {"k": torch.from_numpy(k0), "v": torch.from_numpy(v0),
             "pos": torch.from_numpy(slot_pos)}
    with torch.no_grad():
        to, tc = t_attn.self_attention(
            tm.blocks[0].attn, torch.from_numpy(x), tm.cfg,
            positions=torch.from_numpy(pos), cache=cache, window=W,
            compute_dtype=_TORCH[dtype])
    assert torch.equal(cache["pos"], torch.from_numpy(slot_pos))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert_kernel_close(_np(to), _np(jo), dtype)
    for key in ("k", "v"):
        assert_kernel_close(_np(tc[key]), _np(jc[key]), dtype)


def test_chunked_attention_is_exact(monkeypatch):
    """_attention_4d's q-chunking above the score limit equals one tile."""
    rng = _rng("chunked")
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 256, 2, 16)).astype(
        np.float32)) for _ in range(3))
    whole = t_attn._attention_core(q, k, v, causal=True, window=None,
                                   compute_dtype=torch.float32, q_offset=0)
    monkeypatch.setattr(t_attn, "_SCORE_ELEMS_LIMIT", 128 * 128)
    monkeypatch.setattr(t_attn, "_Q_CHUNK", 64)
    got = t_attn._attention_4d(q, k, v, causal=True, window=None,
                               compute_dtype=torch.float32)
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", [QWEN, MAMBA])
def test_model_parameters_carry_the_jax_names(arch):
    """The JAX tree's group axis unstacked: blocks.attn.wq.w (n_groups, d,
    hq * hd) becomes blocks.{i}.attn.wq.w."""
    jm, params, tm = _pair(arch)
    flat = state_dict_from_params(jax.tree.map(np.asarray, params))
    own = tm.state_dict()
    for key, value in flat.items():
        if key.startswith("blocks."):
            for i in range(jm.n_groups):
                name = f"blocks.{i}." + key[len("blocks."):]
                assert torch.equal(own[name], value[i]), name
        else:
            assert torch.equal(own[key], value), key
    if arch == QWEN:
        assert "blocks.1.attn.wq.b" in own and "blocks.1.attn.wo.b" not in own
    with pytest.raises(KeyError):
        load_params(Model(tm.cfg, device="cpu"), {"embed": params["embed"]})


@pytest.mark.parametrize("arch", [QWEN, MAMBA])
def test_model_init_draws_at_the_jax_scales(arch):
    """Model.init (the card's weights, no JAX there): the JAX init's
    names, shapes, types and scales."""
    cfg = get_arch(arch).reduced()
    model = Model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    jm = JModel(j_get_arch(arch).reduced())
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    own = model.state_dict()
    for key, value in state_dict_from_params(params).items():
        key = key.replace("blocks.", "blocks.0.", 1) \
            if key.startswith("blocks.") else key
        value = value[0] if key.startswith("blocks.") else value
        mine = own[key]
        assert mine.shape == value.shape and mine.dtype == value.dtype, key
        assert abs(float(mine.float().std()) - float(value.float().std())) \
            <= 0.25 * float(value.float().std()) + 1e-6, key


@pytest.mark.parametrize("make", [
    lambda cfg: Model(cfg),
    lambda cfg: Model.init(cfg, torch.Generator()),
    lambda cfg: build_model(cfg)])
def test_model_is_built_on_the_card_unless_asked_for_the_cpu(make):
    """The entry points put the weights on CUDA by default (as JAX's Model
    puts them on the accelerator), and raise where there is no card rather
    than run the plain versions."""
    cfg = get_arch(QWEN).reduced()
    if torch.cuda.is_available():
        assert make(cfg).final_norm.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(cfg)
