"""The port's MoE block (``models.moe``) against the JAX package's.

``moe_block`` on the reduced qwen2-moe (8 experts, top 2, a shared expert)
and qwen3-moe (8 experts, top 2, none) with the JAX block's parameters
loaded through ``models.convert.load_params``: the output, the Switch aux
loss and the (token, choice) pairs each keeps, at the reduced configs'
capacity factor 4.0 (nothing drops) and at 1.0 (pairs drop), f32 and bf16
compute, and a group size that halves to divide the length.  The router
runs in f32 from the same bits in both packages; the inputs are normal
draws, and each test asserts that no token's k-th and (k+1)-th router
probabilities lie within 1e-5 of each other, so ``torch.topk`` and
``lax.top_k`` (whose orders may differ on equal values) face no tie.
Tolerance: ``DTYPE_TOL`` of the compute type.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import _rng, assert_kernel_close
from repro.configs.qwen2_moe_a27b import CONFIG as J_QWEN2
from repro.configs.qwen3_moe_30b_a3b import CONFIG as J_QWEN3
from repro.models import moe as j_moe
from repro.models.layers import dense as j_dense
from repro_torch.configs.qwen2_moe_a27b import CONFIG as T_QWEN2
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as T_QWEN3
from repro_torch.models import moe as t_moe
from repro_torch.models.convert import load_params, state_dict_from_params

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_CONFIGS = {"qwen2-moe-a2.7b": (J_QWEN2, T_QWEN2),
            "qwen3-moe-30b-a3b": (J_QWEN3, T_QWEN3)}
TIE_GAP = 1e-5


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _pair(arch, seed=0, **changes):
    jcfg, tcfg = (dataclasses.replace(c.reduced(), **changes)
                  for c in _CONFIGS[arch])
    params = j_moe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    block = load_params(t_moe.MoE(tcfg, torch.float32),
                        jax.tree.map(np.asarray, params))
    return jcfg, tcfg, params, block


def _j_kept(p, x, cfg):
    """The JAX block's queue positions and kept (token, choice) pairs,
    computed as ``repro.models.moe.moe_block`` computes them."""
    bsz, l, d = x.shape
    s = min(cfg.moe_group_size or 1024, l)
    while l % s:
        s //= 2
    g = bsz * (l // s)
    probs = jax.nn.softmax(j_dense(p["router"], x.reshape(g, s, d),
                                   jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.moe_top_k)
    flat = jax.nn.one_hot(idx, j_moe.padded_experts(cfg), dtype=jnp.int32
                          ).reshape(g, s * cfg.moe_top_k, -1)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat) * flat, axis=-1)
    cap = max(int(math.ceil(s * cfg.moe_top_k / cfg.n_experts
                            * cfg.capacity_factor)), 1)
    return np.asarray(idx), np.asarray(pos).reshape(g, s, -1), cap


def _assert_no_ties(probs, k):
    top = torch.sort(probs, dim=-1, descending=True).values[..., :k + 1]
    gap = float((top[..., :-1] - top[..., 1:]).min())
    assert gap > TIE_GAP, f"router probabilities {gap:.2e} apart"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [4.0, 1.0])
@pytest.mark.parametrize("arch", sorted(_CONFIGS))
def test_moe_block_matches_repro(arch, capacity_factor, dtype):
    """Output, aux, expert indices, queue positions and kept pairs: none
    dropped at 4.0, some at 1.0 (capacity 16 of 64 tokens x 2 choices over
    8 experts), the same ones in both packages."""
    jcfg, tcfg, params, block = _pair(arch, capacity_factor=capacity_factor)
    x = _rng(f"moe{arch}{dtype}").normal(size=(2, 64, jcfg.d_model))
    jx = jnp.asarray(x, jnp.float32).astype(_JNP[dtype])
    tx = torch.from_numpy(x).float().to(_TORCH[dtype])
    jy, jaux = j_moe.moe_block(params, jx, jcfg, _JNP[dtype])
    with torch.no_grad():
        ty, taux = t_moe.moe_block(block, tx, tcfg, _TORCH[dtype])
        s, _, tidx, probs, tpos = t_moe.route(block, tx, tcfg)
    _assert_no_ties(probs, tcfg.moe_top_k)
    jidx, jpos, cap = _j_kept(params, jx, jcfg)
    assert s == 64 and cap == t_moe.capacity(tcfg, s)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    dropped = int((tpos >= cap).sum())
    assert (dropped > 0) == (capacity_factor == 1.0), dropped
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    assert taux.dtype == torch.float32 and taux.shape == ()
    assert_kernel_close(_np(ty), _np(jy), dtype)
    assert_kernel_close(_np(taux), _np(jaux), "float32")


@pytest.mark.parametrize("L,group", [(24, 16), (40, 1024), (1, 1024)])
def test_moe_group_size_halves_to_divide_the_length(L, group):
    """GShard's S: ``moe_group_size`` capped at L, halved until it divides
    L (24 over 16: S = 8), and the block's output and aux agree with
    JAX's there, down to a single decode token."""
    arch = "qwen3-moe-30b-a3b"
    jcfg, tcfg, params, block = _pair(arch, seed=1, moe_group_size=group)
    x = _rng(f"moegroup{L}").normal(size=(3, L, jcfg.d_model))
    jy, jaux = j_moe.moe_block(params, jnp.asarray(x, jnp.float32), jcfg,
                               jnp.float32)
    with torch.no_grad():
        tx = torch.from_numpy(x).float()
        ty, taux = t_moe.moe_block(block, tx, tcfg, torch.float32)
        s, _, _, probs, _ = t_moe.route(block, tx, tcfg)
    _assert_no_ties(probs, tcfg.moe_top_k)
    want = min(group, L)
    while L % want:
        want //= 2
    assert s == t_moe.group_size(tcfg, L) == want
    assert_kernel_close(_np(ty), _np(jy), "float32")
    assert_kernel_close(_np(taux), _np(jaux), "float32")


@pytest.mark.parametrize("arch,axis,want", [
    ("qwen2-moe-a2.7b", 16, 64), ("qwen2-moe-a2.7b", 0, 60),
    ("qwen3-moe-30b-a3b", 16, 128), ("qwen2-moe-a2.7b", 7, 63)])
def test_padded_experts_matches_repro(arch, axis, want):
    jcfg, tcfg = (dataclasses.replace(c, model_axis_size=axis)
                  for c in _CONFIGS[arch])
    assert t_moe.padded_experts(tcfg) == j_moe.padded_experts(jcfg) == want


def test_padded_experts_receive_no_tokens():
    """With the bank padded (8 -> 12 experts on a 6-way axis), the padded
    experts' weights exist but the router emits only real indices: the
    output and aux equal JAX's."""
    jcfg, tcfg, params, block = _pair("qwen2-moe-a2.7b", seed=2,
                                      model_axis_size=6)
    assert block.wi.shape[0] == 12 and block.router.w.shape[1] == 8
    x = _rng("moepadded").normal(size=(2, 32, jcfg.d_model))
    jy, jaux = j_moe.moe_block(params, jnp.asarray(x, jnp.float32), jcfg,
                               jnp.float32)
    with torch.no_grad():
        tx = torch.from_numpy(x).float()
        ty, taux = t_moe.moe_block(block, tx, tcfg, torch.float32)
        _, _, idx, probs, _ = t_moe.route(block, tx, tcfg)
    _assert_no_ties(probs, tcfg.moe_top_k)
    assert int(idx.max()) < 8
    assert_kernel_close(_np(ty), _np(jy), "float32")
    assert_kernel_close(_np(taux), _np(jaux), "float32")


@pytest.mark.parametrize("arch", sorted(_CONFIGS))
def test_moe_init_draws_at_the_jax_scales(arch):
    """``reset``: the JAX tree's names, shapes and types; router over
    sqrt(d), wi / wu over sqrt(d), wo over sqrt(d_ff_expert); the shared
    expert's MLP where the config has one."""
    jcfg, tcfg = (dataclasses.replace(c.reduced(), d_ff_expert=128)
                  for c in _CONFIGS[arch])
    block = t_moe.MoE(tcfg, torch.bfloat16)
    block.reset(torch.Generator().manual_seed(0))
    params = j_moe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    own = block.state_dict()
    want = state_dict_from_params(jax.tree.map(np.asarray, params))
    assert sorted(own) == sorted(want)
    assert ("shared.wi.w" in own) == bool(tcfg.n_shared_experts)
    for key, value in want.items():
        assert own[key].shape == value.shape and own[key].dtype == value.dtype
        std = float(value.float().std())
        assert abs(float(own[key].float().std()) - std) <= 0.1 * std, key
    d, f = tcfg.d_model, tcfg.d_ff_expert
    for key, fan_in in (("wi", d), ("wu", d), ("wo", f)):
        assert abs(float(own[key].float().std()) * math.sqrt(fan_in) - 1) \
            < 0.05, key
