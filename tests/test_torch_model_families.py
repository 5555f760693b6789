"""The port's ``Model`` for the families beside dense and ssm, against the
JAX package's.

Every arch of the registry that the dense / ssm file does not hold —
gemma-2b, minitron-4b and granite-34b (dense: geglu, MQA, head_dim 256),
recurrentgemma-9b (hybrid: RG-LRU blocks and local attention), qwen2-moe
and qwen3-moe (moe), llama-3.2-vision (vlm: cross-attention over a stub's
patch embeddings) and whisper (audio: an encoder and a decoder) — at its
reduced config, with the JAX model's parameters loaded through
``models.convert.load_params``: ``forward`` logits and aux with the flash
path (``use_pallas``: JAX's Pallas kernels in interpret mode, the port's
plain versions of the CUDA kernels; L = 128 and memories of 128, the
attention space's smallest block) and the plain-op path, f32 and bf16;
the write-masked ``prefill`` caches and ``decode_step`` logits;
``encode``; ``init_cache``; the parameter names
and init scales.  Inputs and memories are drawn with numpy.  Tolerance:
``DTYPE_TOL`` of the compute type, relative to max |logits|.
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
from repro.models.model import Model as JModel
from repro_torch import tuning as t_tuning
from repro_torch.configs.base import all_archs, get_arch
from repro_torch.kernels.attention import kernel as t_flash
from repro_torch.models import moe as t_moe
from repro_torch.models import recurrent as t_rec
from repro_torch.models.convert import load_params, state_dict_from_params
from repro_torch.models.model import Model, build_model

j_hw = importlib.import_module("repro.hw.profiles")
t_hw = importlib.import_module("repro_torch.hw.profiles")

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NEW_ARCHS = ["gemma-2b", "minitron-4b", "granite-34b", "recurrentgemma-9b",
             "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "llama-3.2-vision-90b",
             "whisper-large-v3"]


def j_get_arch(name):
    # JAX's get_arch loads its registry only while it is empty, and another
    # test module may have registered one config first
    j_base._load_all()
    return j_base._REGISTRY[name]


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


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


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


def _memory(cfg, batch, tag):
    """The memory a vlm or audio arch attends over (the same values for
    both packages): stub patch or encoder-output embeddings, or None."""
    if cfg.family not in ("vlm", "audio"):
        return None, None
    length = cfg.vision_len if cfg.family == "vlm" else cfg.enc_len
    mem = (_rng(tag).normal(size=(batch, length, cfg.d_model))
           * 0.5).astype(np.float32)
    return jnp.asarray(mem), torch.from_numpy(mem)


def _attention_layers(cfg, n_groups):
    """Flash calls in one forward: every self-attention layer (a hybrid
    group's attn blocks only) and every cross-attention layer."""
    if cfg.family == "hybrid":
        return n_groups * cfg.block_pattern.count("attn")
    if cfg.family == "vlm":
        return cfg.n_layers + n_groups
    return cfg.n_layers


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


def _record_jax_choices(monkeypatch):
    """JAX's expert indices (G, S, k) of every ``moe_block`` call, in
    order: ``jax.lax.top_k`` (called by the moe block alone in a forward)
    wrapped to hand each call's indices to the host, ordered across the
    scan over the groups.  Read after ``jax.effects_barrier()``."""
    seen, top_k = [], jax.lax.top_k

    def recording(x, k):
        w, idx = top_k(x, k)
        jax.debug.callback(lambda i: seen.append(np.array(i)), idx,
                           ordered=True)
        return w, idx
    monkeypatch.setattr(jax.lax, "top_k", recording)
    return seen


# a bf16 router's probabilities may differ between the packages by the
# bf16 rounding of the hidden state: where the port's own top-k differs
# from JAX's, the port's probabilities of the two choices must agree, one
# by one in descending order, within this
BF16_NEAR_TIE = 2e-2


@pytest.mark.parametrize("use_pallas,dtype", [
    (False, "float32"), (False, "bfloat16"), (True, "float32"),
    (True, "bfloat16")])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_matches_repro(pinned, monkeypatch, arch, use_pallas, dtype):
    """Logits and aux of the whole reduced model.  With use_pallas every
    attention layer (cross-attention included) runs the flash function
    once, and every RG-LRU layer the tuned linear_recurrence once.

    The moe archs run JAX's expert choices: every ``route`` call of the
    port is handed the indices that JAX's matching ``moe_block`` call
    chose (its queue positions, capacity drops and weights follow from
    them as in ``route``), so that dispatch, capacity and combine stay
    under the comparison.  In f32 the port's own top-k must equal JAX's,
    with every router's k-th and (k+1)-th probabilities more than 1e-5
    apart.  In bf16 the two packages' products round a few elements
    apart (another order of accumulation), and a token whose k-th and
    (k+1)-th probabilities lie within that rounding may choose another
    expert in either package; for each such token the port's own choice
    and JAX's must be a near-tie in the port's probabilities
    (``BF16_NEAR_TIE``)."""
    changes = {"use_pallas": use_pallas, "compute_dtype": dtype}
    if use_pallas:
        changes.update(enc_len=128, vision_len=128)
    jm, params, tm = _pair(arch, **changes)
    cfg = jm.cfg
    flash, recs, gaps, flips, ties = [], [], [], [], []
    plain, entry = t_flash.flash_attention_plain, t_rec.linear_recurrence
    route = t_moe.route
    monkeypatch.setattr(t_flash, "flash_attention_plain",
                        lambda *a, **k: flash.append(1) or plain(*a, **k))
    monkeypatch.setattr(t_rec, "linear_recurrence",
                        lambda *a: recs.append(1) or entry(*a))
    jax_choices = _record_jax_choices(monkeypatch)

    def replay_route(p, x, c):
        s, _, idx, probs, _ = route(p, x, c)
        top = torch.sort(probs, dim=-1, descending=True).values
        gaps.append(float((top[..., c.moe_top_k - 1]
                           - top[..., c.moe_top_k]).min()))
        want = torch.from_numpy(jax_choices[len(flips)]).to(idx.dtype)
        assert want.shape == idx.shape
        same = (torch.sort(idx, -1).values
                == torch.sort(want, -1).values).all(-1)
        flips.append(int((~same).sum()))
        chosen = torch.gather(probs, -1, want)
        own = torch.gather(probs, -1, idx)
        ties.append(float((torch.sort(own, -1).values
                           - torch.sort(chosen, -1).values).abs().max()))
        gate_w = chosen / torch.clamp(chosen.sum(-1, keepdim=True), min=1e-9)
        return s, gate_w, want, probs, t_moe.queue_positions(
            want, t_moe.padded_experts(c))
    monkeypatch.setattr(t_moe, "route", replay_route)

    L = 128 if use_pallas else 32
    tokens = _rng(f"forward{arch}{L}").integers(0, cfg.vocab, size=(2, L))
    jmem, tmem = _memory(cfg, 2, f"memory{arch}{L}")
    jl, jaux = jm.forward(params, jnp.asarray(tokens), memory=jmem)
    jax.effects_barrier()
    with torch.no_grad():
        tl, taux = tm(torch.from_numpy(tokens), memory=tmem)
    assert tl.dtype == torch.float32 and tl.shape == (2, L, cfg.vocab)
    assert len(flash) == (_attention_layers(cfg, jm.n_groups)
                          if use_pallas else 0)
    n_rec = jm.n_groups * cfg.block_pattern.count("rec")
    assert len(recs) == (n_rec if use_pallas else 0)
    n_moe = cfg.n_layers if cfg.family == "moe" else 0
    assert len(jax_choices) == len(flips) == n_moe
    if dtype == "float32":
        assert all(gap > 1e-5 for gap in gaps), gaps
        assert sum(flips) == 0, flips
    else:
        assert all(tie < BF16_NEAR_TIE for tie in ties), (flips, ties)
    assert_kernel_close(_np(tl), _np(jl), dtype)
    assert taux.dtype == torch.float32
    assert_kernel_close(_np(taux), _np(jaux), dtype)
    if cfg.family != "moe":
        assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_match_repro(arch):
    """A write-masked prefill (lane 1 skips steps 2 and 3; no memory, as in
    JAX), then two decode steps with the memory: every cache tensor of
    every group and the decode logits, in f32."""
    jm, params, tm = _pair(arch)
    cfg = jm.cfg
    B, steps, max_len = 3, 6, 16
    rng = _rng(f"prefill{arch}")
    tokens = rng.integers(0, cfg.vocab, size=(steps, B))
    positions = np.tile(np.arange(steps)[:, None], (1, B)).astype(np.int32)
    write = np.ones((steps, B), bool)
    write[2:4, 1] = False
    jmem, tmem = _memory(cfg, B, f"prefillmem{arch}")
    jc = jm.init_cache(B, max_len, dtype=jnp.float32)
    tc = tm.init_cache(B, max_len, dtype=torch.float32)
    assert len(tc) == jm.n_groups
    jc = jm.prefill(params, jnp.asarray(tokens), jc, jnp.asarray(positions),
                    jnp.asarray(write))
    with torch.no_grad():
        tc = tm.prefill(torch.from_numpy(tokens), tc,
                        torch.from_numpy(positions), torch.from_numpy(write))
        for t in range(2):
            tok = rng.integers(0, cfg.vocab, size=(B, 1))
            pos = np.full((B, 1), steps + t, np.int32)
            jl, jc = jm.decode_step(params, jnp.asarray(tok), jc,
                                    jnp.asarray(pos), memory=jmem)
            tl, tc = tm.decode_step(torch.from_numpy(tok), tc,
                                    torch.from_numpy(pos), memory=tmem)
            assert tl.shape == (B, 1, cfg.vocab)
            assert_kernel_close(_np(tl), _np(jl), "float32")
    want = _leaves(_j_groups(jc, jm.n_groups))
    got = _leaves(tc)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            assert_kernel_close(_np(g), _np(w), "float32")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_matches_forward(arch):
    """The JAX suite's own check, on the port: one token at a time through
    the cache (with the memory) gives the forward's logits (rel < 2e-2)."""
    cfg = get_arch(arch).reduced()
    model = Model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    B, L = 2, 12
    tokens = torch.from_numpy(_rng(f"decodefwd{arch}").integers(
        0, cfg.vocab, size=(B, L)))
    _, memory = _memory(cfg, B, f"decodefwdmem{arch}")
    with torch.no_grad():
        if cfg.family == "audio":
            memory = model.encode(memory)
        full, _ = model(tokens, memory=memory)
        cache = model.init_cache(B, L, dtype=torch.float32)
        outs = []
        for t in range(L):
            pos = torch.full((B, 1), t, dtype=torch.int32)
            lg, cache = model.decode_step(tokens[:, t:t + 1], cache, pos,
                                          memory=memory)
            outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    rel = float((full - dec).abs().max()) / (float(full.abs().max()) + 1e-9)
    assert rel < 2e-2, rel


@pytest.mark.parametrize("use_pallas,dtype", [
    (False, "float32"), (False, "bfloat16"), (True, "float32")])
def test_encode_matches_repro(pinned, monkeypatch, use_pallas, dtype):
    """whisper's encoder over stub frame embeddings: its causal
    self-attention (the flash function once a layer under use_pallas) and
    enc_norm."""
    jm, params, tm = _pair("whisper-large-v3", enc_len=128,
                           use_pallas=use_pallas, compute_dtype=dtype)
    calls = []
    plain = t_flash.flash_attention_plain
    monkeypatch.setattr(t_flash, "flash_attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    jmem, tmem = _memory(jm.cfg, 2, f"encode{dtype}")
    want = jm.encode(params, jmem)
    with torch.no_grad():
        got = tm.encode(tmem)
    assert got.dtype == _TORCH[dtype] and tuple(got.shape) == want.shape
    assert len(calls) == (jm.cfg.n_enc_layers if use_pallas else 0)
    assert_kernel_close(_np(got), _np(want), dtype)


def test_memory_reaches_the_vlm_but_not_the_audio_decoder():
    """The vlm's cross-attention reads the memory; the audio decoder's
    blocks have no cross-attention (as the JAX model builds them), so its
    logits do not depend on the memory."""
    for arch, reads in (("llama-3.2-vision-90b", True),
                        ("whisper-large-v3", False)):
        cfg = get_arch(arch).reduced()
        model = Model.init(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
        tokens = torch.from_numpy(_rng(f"reads{arch}").integers(
            0, cfg.vocab, size=(2, 8)))
        _, mem = _memory(cfg, 2, f"readsmem{arch}")
        with torch.no_grad():
            a, _ = model(tokens, memory=mem)
            b, _ = model(tokens, memory=2 * mem)
        assert (not torch.equal(a, b)) == reads, arch
        if reads:
            assert hasattr(model.blocks[0].blocks[-1], "xattn")
        else:
            assert not any(hasattr(blk, "xattn") for blk in model.blocks)


@pytest.mark.parametrize("arch", all_archs())
def test_init_cache_matches_repro(arch):
    """Every arch's decode cache: per group the JAX cache's tensors, with
    their shapes, types and fill (a hybrid ring buffer's slot positions
    at -2^30) at a max_len above and below the window."""
    jcfg = dataclasses.replace(j_get_arch(arch).reduced(), attn_window=8) \
        if j_get_arch(arch).attn_window else j_get_arch(arch).reduced()
    tcfg = dataclasses.replace(get_arch(arch).reduced(),
                               attn_window=jcfg.attn_window)
    assert build_model(tcfg, device="cpu").n_groups == JModel(jcfg).n_groups
    for max_len in (4, 16):
        want = _leaves(_j_groups(JModel(jcfg).init_cache(
            2, max_len, dtype=jnp.bfloat16), JModel(jcfg).n_groups))
        got = _leaves(build_model(tcfg, device="cpu").init_cache(2, max_len))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
            np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_model_parameters_carry_the_jax_names(arch):
    """The JAX tree's group axis unstacked (blocks.{i}., enc_blocks.{i}.),
    a group's list of blocks numbered in turn
    (blocks.{i}.blocks.{j}.rec.wx.w), and every value loaded."""
    jm, params, tm = _pair(arch)
    flat = state_dict_from_params(jax.tree.map(np.asarray, params))
    own = tm.state_dict()
    assert len(own) == sum(value.shape[0] if key.startswith(
        ("blocks.", "enc_blocks.")) else 1 for key, value in flat.items())
    for key, value in flat.items():
        stack = key.split(".")[0]
        if stack in ("blocks", "enc_blocks"):
            for i in range(value.shape[0]):
                name = f"{stack}.{i}." + key[len(stack) + 1:]
                assert torch.equal(own[name], value[i]), name
        else:
            assert torch.equal(own[key], value), key
    family = jm.cfg.family
    assert ("blocks.0.blocks.0.rec.lambda" in own) == (family == "hybrid")
    assert ("blocks.0.moe.wi" in own) == (family == "moe")
    assert ("blocks.0.blocks.1.xattn.wq.w" in own) == (family == "vlm")
    assert ("enc_blocks.1.attn.wq.w" in own) == (family == "audio")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_model_init_draws_at_the_jax_scales(arch):
    """Model.init (the card's weights, no JAX there): the JAX init's
    names, shapes, types and scales, group by group."""
    cfg = get_arch(arch).reduced()
    model = Model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    jm = JModel(j_get_arch(arch).reduced())
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    own = model.state_dict()
    for key, value in state_dict_from_params(params).items():
        stack = key.split(".")[0]
        if stack in ("blocks", "enc_blocks"):
            key, value = f"{stack}.0." + key[len(stack) + 1:], value[0]
        mine = own[key]
        assert mine.shape == value.shape and mine.dtype == value.dtype, key
        std = float(value.float().std())
        assert abs(float(mine.float().std()) - std) <= 0.25 * std + 1e-6, key
