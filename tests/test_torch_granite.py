"""The port's hybrid_moe family (granite-4.0-h-small) on the CPU: its
registration apart from the JAX package's ten configurations, the dropless
MoE against a per-token loop and against GShard's dispatch where that
drops nothing, its counters, the published Mamba-2 mixer (conv bias, x
scaled by dt, the D skip) against its recurrence step by step with
mamba2-130m's block left as it was, and NoPE attention at the attention
multiplier on the plain path and through the flash op."""
import dataclasses

import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs.base import HybridMoEConfig, all_archs, get_arch
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as t_moe
from repro_torch.models.layers import mlp, silu
from repro_torch.models.model import Model
from repro_torch.models.ssm import SSDBlock, init_ssd_cache

GRANITE = "granite-4.0-h-small"
F32 = torch.float32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def counters():
    telemetry.reset_moe_counts()
    yield telemetry
    telemetry.reset_moe_counts()


def small(**changes) -> HybridMoEConfig:
    return dataclasses.replace(get_arch(GRANITE).reduced(), **changes)


def close(got, want, rel=2e-5):
    """Within the repo's float32 tolerance, relative to the largest
    |want|."""
    err = float((got - want).abs().max() / want.abs().max())
    assert err < rel, f"relative error {err:.3e}"


def test_registered_apart_from_the_jax_configs():
    cfg = get_arch(GRANITE)
    assert isinstance(cfg, HybridMoEConfig) and cfg.family == "hybrid_moe"
    assert GRANITE not in all_archs() and len(all_archs()) == 10
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.norm_eps) == \
        (40, 4096, 100352, 1e-5)
    assert cfg.block_pattern == ("mamba",) * 5 + ("attention",) \
        + ("mamba",) * 4
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (32, 8, 128)
    assert (cfg.n_experts, cfg.moe_top_k, cfg.d_ff_expert,
            cfg.d_ff_shared) == (72, 10, 768, 1536)
    assert (cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_expand,
            cfg.conv_width) == (128, 64, 2, 4)
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.attention_multiplier, cfg.logits_scaling) == \
        (12.0, 0.22, 0.0078125, 16.0)
    reduced = cfg.reduced()
    assert (reduced.n_layers, reduced.d_model, reduced.block_pattern) == \
        (10, 64, cfg.block_pattern)


def _moe(cfg, seed=0) -> t_moe.DroplessMoE:
    p = t_moe.DroplessMoE(cfg, F32, "cpu")
    p.reset(torch.Generator().manual_seed(seed))
    return p


def _per_token(p, x, cfg):
    """Each token on its own: the softmax's top k renormalised, each chosen
    expert's SwiGLU at its weight, plus the shared expert."""
    rows = []
    for row in x.reshape(-1, x.shape[-1]):
        probs = torch.softmax(row @ p.router.w, dim=-1)
        w, idx = torch.topk(probs, cfg.moe_top_k)
        w = w / w.sum()
        y = sum(wj * ((silu(row @ p.wi[e]) * (row @ p.wu[e])) @ p.wo[e])
                for wj, e in zip(w, idx.tolist()))
        if p.shared is not None:
            y = y + mlp(p.shared, row, "swiglu", F32)
        rows.append(y)
    return torch.stack(rows).view(x.shape)


@pytest.mark.parametrize("tokens,experts,top_k", [(1, 8, 2), (37, 8, 2),
                                                  (24, 72, 10)])
def test_dropless_moe_matches_a_per_token_loop(counters, tokens, experts,
                                               top_k):
    cfg = small(n_experts=experts, moe_top_k=top_k)
    p = _moe(cfg)
    x = torch.randn(1, tokens, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        close(p(x, F32), _per_token(p, x, cfg))
    counts = counters.moe_counts()
    assert counts["calls"] == 1 and counts["routed"] == tokens * top_k
    assert counts["dropped"] == 0 and sum(counts["rows"]) == tokens * top_k
    assert counts["max_rows"] == max(counts["rows"])


def test_dropless_equals_gshard_where_gshard_drops_nothing():
    """A capacity of every token of a group drops nothing: GShard's
    dispatch (``moe_block``) then gives the dropless one's output."""
    cfg = small(d_ff_shared=0)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                              / cfg.moe_top_k)
    p = _moe(cfg, seed=3)
    x = torch.randn(2, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want, _ = t_moe.moe_block(p, x, cfg, F32)
        close(p(x, F32), want)


@pytest.mark.parametrize("top_k", [1, 2])
def test_every_token_to_one_expert(counters, top_k):
    """The router's weights make expert 3 (and, for k = 2, expert 5) every
    token's choice: one group holds all the rows, the others none."""
    cfg = small(moe_top_k=top_k)
    p = _moe(cfg)
    with torch.no_grad():
        p.router.w.zero_()
        p.router.w[:, 3] = 1.0
        p.router.w[:, 5] = 0.5
    x = torch.rand(1, 40, cfg.d_model,
                   generator=torch.Generator().manual_seed(2)) + 0.1
    with torch.no_grad():
        close(p(x, F32), _per_token(p, x, cfg))
    rows = counters.moe_counts()["rows"]
    assert rows[3] == 40 and rows[5] == (40 if top_k == 2 else 0)
    assert sum(rows) == 40 * top_k
    assert counters.moe_counts()["max_rows"] == 40


def test_counters_count_a_dropped_assignment_and_reset(counters,
                                                       monkeypatch):
    cfg = small()
    p = _moe(cfg)
    x = torch.randn(1, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(5))
    real = t_moe.expert_ends

    def short(sorted_e, n):
        ends = real(sorted_e, n).clone()
        ends[-1] -= 1
        return ends
    with torch.no_grad():
        p(x, F32)
        monkeypatch.setattr(t_moe, "expert_ends", short)
        got = p(x, F32)
        assert float((got - _per_token(p, x, cfg)).abs().max()) > 1e-3
    counts = counters.moe_counts()
    assert (counts["calls"], counts["routed"], counts["dropped"]) == \
        (2, 2 * 16 * cfg.moe_top_k, 1)
    counters.reset_moe_counts()
    assert counters.moe_counts() == {"calls": 0, "routed": 0, "dropped": 0,
                                     "rows": [], "max_rows": 0}


def _block64(blk, x, published):
    """The block in float64 with the recurrence step by step: the
    published mixer's conv bias, dt x and D skip where ``published``."""
    cfg = blk.cfg
    d_inner = cfg.ssm_expand * cfg.d_model
    H, P, S, K = d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim, \
        cfg.ssm_state, cfg.conv_width
    B, L, _ = x.shape
    proj = x.double() @ blk.in_proj.w.double()
    xs, z, bc, dt_raw = torch.split(proj, [d_inner, d_inner, 2 * S, H], -1)
    u = torch.cat([xs, bc], -1)
    u = torch.cat([u.new_zeros(B, K - 1, u.shape[-1]), u], 1)
    conv = sum(u[:, j:j + L] * blk.conv_w.double()[j] for j in range(K))
    if published:
        conv = conv + blk.conv_b.double()
    conv = conv * torch.sigmoid(conv)
    xs, b, c = torch.split(conv, [d_inner, S, S], -1)
    dt = torch.nn.functional.softplus(dt_raw + blk.dt_bias.double())
    a = torch.exp(-torch.exp(blk.a_log.double()) * dt)
    xs = xs.reshape(B, L, H, P)
    state = torch.zeros(B, H, S, P, dtype=torch.float64)
    ys = []
    for t in range(L):
        xt = xs[:, t] * dt[:, t, :, None] if published else xs[:, t]
        state = a[:, t, :, None, None] * state \
            + b[:, t, None, :, None] * xt[:, :, None, :]
        y = torch.einsum("bs,bhsp->bhp", c[:, t], state)
        if published:
            y = y + blk.d_skip.double()[:, None] * xs[:, t]
        ys.append(y)
    y = torch.stack(ys, 1).reshape(B, L, d_inner) * z * torch.sigmoid(z)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + cfg.norm_eps) \
        * (1.0 + blk.norm_scale.double())
    return y @ blk.out_proj.w.double()


def _drawn_block(cfg, published):
    gen = torch.Generator().manual_seed(6)
    blk = SSDBlock(cfg, F32, "cpu", published=published)
    blk.reset(gen)
    with torch.no_grad():
        blk.a_log.copy_(torch.log(1 + 15 * torch.rand(
            blk.a_log.shape, generator=gen)))
        blk.dt_bias.uniform_(-3.0, -1.0, generator=gen)
        blk.norm_scale.normal_(0.0, 0.1, generator=gen)
        if published:
            blk.conv_b.normal_(0.0, 0.5, generator=gen)
            blk.d_skip.uniform_(0.5, 1.5, generator=gen)
    return blk


@pytest.mark.parametrize("published", [True, False])
def test_ssd_block_against_its_recurrence(published):
    cfg = small() if published else MAMBA2.reduced()
    blk = _drawn_block(cfg, published)
    x = torch.randn(2, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        got, _ = blk(x, compute_dtype=F32)
        want = _block64(blk, x, published)
    err = float((got.double() - want).abs().max() / want.abs().max())
    assert err < 1e-4, err


def test_unpublished_block_keeps_its_parameters_and_path(monkeypatch):
    """mamba2-130m's block: the JAX tree's six parameters, one SSD op call
    a prefill, and its inputs as the unscaled x."""
    blk = _drawn_block(MAMBA2.reduced(), published=False)
    assert sorted(n for n, _ in blk.named_parameters()) == sorted(
        ["in_proj.w", "conv_w", "a_log", "dt_bias", "norm_scale",
         "out_proj.w"])
    from repro_torch.models import ssm
    calls = []
    real = ssm.ssd_op

    def spy(x, a, b, c):
        calls.append(x)
        return real(x, a, b, c)
    monkeypatch.setattr(ssm, "ssd_op", spy)
    x = torch.randn(1, 16, blk.cfg.d_model,
                    generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        blk(x, compute_dtype=F32)
        xh = blk.ssd_inputs(x, compute_dtype=F32)[0]
    assert len(calls) == 1 and torch.equal(calls[0], xh)


def test_published_block_decodes_as_it_prefills():
    cfg = small()
    blk = _drawn_block(cfg, published=True)
    x = torch.randn(2, 12, cfg.d_model,
                    generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        want, _ = blk(x, compute_dtype=F32)
        cache = init_ssd_cache(cfg, 2, F32, "cpu")
        steps = []
        for t in range(12):
            y, cache = blk(x[:, t:t + 1], cache=cache, compute_dtype=F32)
            steps.append(y)
    close(torch.cat(steps, 1), want, rel=1e-5)


def _nope64(p, x, cfg, scale):
    B, L, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x.double() @ p.wq.w.double()).view(B, L, hq, hd)
    k = (x.double() @ p.wk.w.double()).view(B, L, hkv, hd)
    v = (x.double() @ p.wv.w.double()).view(B, L, hkv, hd)
    k, v = (t.repeat_interleave(hq // hkv, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = s.masked_fill(~torch.ones(L, L, dtype=torch.bool).tril(),
                      float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return o.reshape(B, L, hq * hd) @ p.wo.w.double()


@pytest.mark.parametrize("use_pallas,L", [(False, 32), (True, 128)])
def test_nope_attention_at_the_multiplier(monkeypatch, use_pallas, L):
    """No rotary and scores times attention_multiplier, on the plain path
    and through the flash op (its plain version here, one call)."""
    cfg = small(use_pallas=use_pallas)
    p = attn_mod.Attention(cfg, F32, "cpu")
    p.reset(torch.Generator().manual_seed(10))
    x = torch.randn(2, L, cfg.d_model,
                    generator=torch.Generator().manual_seed(11))
    calls = []
    real = attn_mod.attention_op
    monkeypatch.setattr(attn_mod, "attention_op",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        got, _ = attn_mod.self_attention(
            p, x, cfg, positions=None, compute_dtype=F32, use_rope=False,
            scale=cfg.attention_multiplier)
        want = _nope64(p, x, cfg, cfg.attention_multiplier)
    err = float((got.double() - want).abs().max() / want.abs().max())
    assert err < 2e-5, err
    assert len(calls) == (1 if use_pallas else 0)


def test_model_forward_through_flash_equals_the_plain_path():
    """An attention layer's model, the flash op against the plain-op
    attention on the same weights; a decode cache is refused."""
    cfg = small(block_pattern=("attention",), n_layers=1)
    plain = Model.init(cfg, torch.Generator().manual_seed(12), device="cpu")
    flash = Model(dataclasses.replace(cfg, use_pallas=True), device="cpu")
    flash.load_state_dict(plain.state_dict())
    tokens = torch.randint(0, cfg.vocab, (1, 128),
                           generator=torch.Generator().manual_seed(13))
    with torch.no_grad():
        close(flash(tokens)[0], plain(tokens)[0])
    with pytest.raises(NotImplementedError):
        plain.init_cache(1, 8)
