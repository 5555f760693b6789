"""Attention blocks: GQA/MQA self-attention (+RoPE, local windows, KV cache)
and cross-attention (enc-dec, VLM).

The PyTorch port of ``repro.models.attention``.  ``Attention`` holds the
projections under the JAX parameter tree's names (``wq``, ``wk``, ``wv``
with the optional QKV bias, ``wo``); ``self_attention`` is the JAX
function of the same name:

  * prefill / training with ``cfg.use_pallas`` (the setting for real
    deployments): the flattened (B*H, L, hd) call to the tuned
    ``attention`` op, the hand-written flash kernel on the card;
  * with ``use_pallas`` off: ``_attention_4d`` in plain tensor ops on the
    (B, L, H, hd) layout, q-chunked above ``_SCORE_ELEMS_LIMIT`` score
    elements per (batch, head);
  * decode (one token with a cache): the full or ring-buffer KV cache,
    masked by true positions.

``cross_attention`` attends from the queries over an encoder's or a
vision stub's memory, without a mask: the flash kernel (``causal=False``,
Lq and Lk apart) under ``use_pallas``, ``_attention_4d`` otherwise.
In a distributed step (DTensors) ``_score_constraint`` pins the score
tensor's sharding on the query sequence (JAX's fallback; JAX prefers the
heads); on plain tensors it is the identity.  The flash kernel takes no
DTensor: a distributed step runs with ``use_pallas`` off, as JAX's
dry-run lowers it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.hints import (UNCONSTRAINED, constrain,
                                          is_dtensor, splittable)
from repro_torch.kernels.attention.ops import attention as attention_op
from repro_torch.models.layers import Dense, rope


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        self.wq = Dense(d, cfg.n_heads * hd, dtype, device, bias=cfg.qkv_bias)
        self.wk = Dense(d, cfg.n_kv_heads * hd, dtype, device,
                        bias=cfg.qkv_bias)
        self.wv = Dense(d, cfg.n_kv_heads * hd, dtype, device,
                        bias=cfg.qkv_bias)
        self.wo = Dense(cfg.n_heads * hd, d, dtype, device)

    def reset(self, generator: torch.Generator) -> None:
        for proj in (self.wq, self.wk, self.wv, self.wo):
            proj.reset(generator)


def init_attention(cfg: ModelConfig, generator: torch.Generator,
                   dtype: torch.dtype, device=None) -> Attention:
    """Projections drawn at the JAX ``init_attention`` scales."""
    p = Attention(cfg, dtype, device)
    p.reset(generator)
    return p


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, l, _ = x.shape
    return splittable(x, -1, n).reshape(b, l, n, hd)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    b, l, h, d = x.shape
    return x[:, :, :, None, :].expand(b, l, h, n_rep, d).reshape(
        b, l, h * n_rep, d)


def _inv_sqrt(d: int, device) -> torch.Tensor:
    """1 / sqrt(d) as the JAX code computes it: the f32 root, then an f32
    division (the root taken in double and rounded once)."""
    root = torch.tensor(math.sqrt(d), dtype=torch.float32, device=device)
    return 1.0 / root


def _score_constraint(lq: int, model_axis: int) -> Optional[tuple]:
    """Sharding for the (B, H, Lq, Lk) score tensor — the largest activation
    in every attention cell — in a DTensor step: the query sequence on the
    model axis when that axis divides Lq, else none (decode's Lq = 1).

    This differs from JAX's, which prefers head (TP) sharding and falls
    back to the query sequence only for head counts the model axis does
    not divide (gemma-2b: 8, minitron: 24, whisper: 20): the score product
    flattens (batch, heads), and a DTensor cannot flatten two sharded dims,
    so the port always takes JAX's fallback.  In decode JAX shards the
    scores on the heads, and the port leaves them unconstrained.

    Non-constrained dims stay UNCONSTRAINED so the batch sharding keeps
    propagating (a None here would *replicate* the batch dim)."""
    if not model_axis or lq % model_axis:
        return None
    return (UNCONSTRAINED, UNCONSTRAINED, "model", UNCONSTRAINED)


def _attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: Optional[int],
                    compute_dtype: torch.dtype, q_offset: int,
                    model_axis: int = 0) -> torch.Tensor:
    """One (B, Lq, H, D) x (B, Lk, H, D) attention tile; q_offset is the
    global position of q[0] minus kpos[0] (supports q-chunking)."""
    lq, d = q.shape[1], q.shape[3]
    lk = k.shape[1]
    cons = _score_constraint(lq, model_axis) if is_dtensor(q) else None
    if cons is not None:
        # the query sequence sharded, k and v whole on the model axis
        q = constrain(q, (UNCONSTRAINED, "model", None, None))
        k = constrain(k, (UNCONSTRAINED, None, None, None))
        v = constrain(v, (UNCONSTRAINED, None, None, None))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) \
        * _inv_sqrt(d, q.device)
    if cons is not None:
        s = constrain(s, cons)
    qpos = torch.arange(lq, device=q.device) + q_offset
    kpos = torch.arange(lk, device=q.device)
    mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1).to(compute_dtype)
    if cons is not None:
        p = constrain(p, cons)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


# chunk the query dim once the full (Lq, Lk) score tensor would exceed this
# many elements per (batch, head) — softmax is per-q-row, so q-chunking is
# exact
_SCORE_ELEMS_LIMIT = 4096 * 4096
_Q_CHUNK = 1024


def _attention_4d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: Optional[int],
                  compute_dtype: torch.dtype,
                  model_axis: int = 0) -> torch.Tensor:
    """Plain-op attention keeping the (B, L, H, D) layout; long sequences
    run over q-chunks so only a (chunk, Lk) score block is live, each
    chunk recomputed in the backward."""
    bq, lq, h, d = q.shape
    lk = k.shape[1]
    base_offset = lk - lq
    if lq * lk <= _SCORE_ELEMS_LIMIT or lq % _Q_CHUNK or lq == lk == 0:
        return _attention_core(q, k, v, causal=causal, window=window,
                               compute_dtype=compute_dtype,
                               q_offset=base_offset, model_axis=model_axis)

    def run(qb, i):
        return _attention_core(qb, k, v, causal=causal, window=window,
                               compute_dtype=compute_dtype,
                               q_offset=i + base_offset,
                               model_axis=model_axis)

    # each chunk is recomputed in the backward, as the JAX function's
    # jax.checkpoint does (whatever cfg.remat says)
    remat = torch.is_grad_enabled()
    return torch.cat([
        checkpoint(run, q[:, i:i + _Q_CHUNK], i, use_reentrant=False)
        if remat else run(q[:, i:i + _Q_CHUNK], i)
        for i in range(0, lq, _Q_CHUNK)], dim=1)


def _write_slot(cache: torch.Tensor, slot: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
    """A copy of ``cache`` (B, S, ...) with ``value[b]`` at ``[b, slot[b]]``:
    a select against the slot's one-hot, which each device of a
    distributed step (a DTensor cache, sharded on batch and sequence)
    applies to its own slice, where a scatter into sharded dims has no
    partitioned form.  A slot past the cache writes nothing, as JAX's
    scatter drops it."""
    hit = slot[:, None] == torch.arange(cache.shape[1], device=cache.device)
    hit = hit.reshape(hit.shape + (1,) * (cache.dim() - 2))
    return torch.where(hit, value[:, None], cache)


def self_attention(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                   positions: torch.Tensor, cache: Optional[Dict] = None,
                   window: Optional[int] = None,
                   compute_dtype: torch.dtype = torch.bfloat16
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, L, D).

    cache layouts:
      full:   {"k","v": (B, L_max, Hkv, hd)} — slot index == position;
      window: additionally {"pos": (B, W) int32} — ring buffer of W slots
              holding the absolute position written into each slot.
    Prefill: cache None (pure forward).  Decode: L == 1; the new cache is
    the old one with the token written at ``positions`` (new tensors, the
    old ones untouched), and attention masks by true positions, so
    unwritten slots never reach the softmax.
    """
    b, l, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    cd = compute_dtype
    q = _split_heads(p.wq(x, cd), hq, hd)
    k = _split_heads(p.wk(x, cd), hkv, hd)
    v = _split_heads(p.wv(x, cd), hkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    n_rep = hq // max(hkv, 1)

    if cache is not None and l == 1:
        pos = positions[:, 0]                                    # (B,)
        cache_len = cache["k"].shape[1]
        if "pos" in cache:                                       # ring buffer
            slot = torch.remainder(pos, cache_len)
            slot_pos = _write_slot(cache["pos"], slot,
                                   pos.to(cache["pos"].dtype))
        else:
            slot = pos
            slot_pos = torch.arange(cache_len, dtype=torch.int32,
                                    device=x.device)[None, :].expand(
                b, cache_len)
        ck = _write_slot(cache["k"], slot, k[:, 0].to(
            cache["k"].dtype))
        cv = _write_slot(cache["v"], slot, v[:, 0].to(
            cache["v"].dtype))
        new_cache = {"k": ck, "v": cv}
        if "pos" in cache:
            new_cache["pos"] = slot_pos

        kk = _repeat_kv(ck.to(cd), n_rep)                        # (B,S,H,hd)
        vv = _repeat_kv(cv.to(cd), n_rep)
        s = torch.einsum("bhd,bshd->bhs", q[:, 0], kk).to(torch.float32)
        s = s * _inv_sqrt(hd, x.device)
        mask = slot_pos <= pos[:, None]                          # causal/valid
        if window is not None:
            mask = mask & (slot_pos > (pos[:, None] - window))
        s = torch.where(mask[:, None, :], s, float("-inf"))
        pattn = torch.softmax(s, dim=-1).to(cd)
        o = torch.einsum("bhs,bshd->bhd", pattn, vv)[:, None]   # (B,1,H,hd)
        o = o.reshape(b, l, hq * hd)
        return p.wo(o, cd), new_cache

    # prefill / training full-sequence path
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    if cfg.use_pallas:
        # the flash kernel over flattened rows (block sizes from the
        # TuningDB or the analytical model)
        o = _flash(q, k, v, causal=True, window=window)
    else:
        o = _attention_4d(q, k, v, causal=True, window=window,
                          compute_dtype=cd, model_axis=cfg.model_axis_size)
    o = o.reshape(b, l, hq * hd)
    return p.wo(o, cd), None


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: Optional[int] = None) -> torch.Tensor:
    """The tuned attention op over flattened (B*H, L, hd) rows of (B, L,
    H, hd) tensors."""
    b, lq, h, hd = q.shape
    of = attention_op(*(t.transpose(1, 2).reshape(b * h, -1, hd)
                        for t in (q, k, v)), causal=causal, window=window)
    return of.reshape(b, h, lq, hd).transpose(1, 2)


def cross_attention(p: Attention, x: torch.Tensor, memory: torch.Tensor,
                    cfg: ModelConfig,
                    compute_dtype: torch.dtype = torch.bfloat16
                    ) -> torch.Tensor:
    """x: (B, L, D) queries over encoder / vision memory (B, M, D)."""
    b, l, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    cd = compute_dtype
    q = _split_heads(p.wq(x, cd), hq, hd)
    k = _split_heads(p.wk(memory, cd), hkv, hd)
    v = _split_heads(p.wv(memory, cd), hkv, hd)
    n_rep = hq // max(hkv, 1)
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    if cfg.use_pallas:
        o = _flash(q, k, v, causal=False)
    else:
        o = _attention_4d(q, k, v, causal=False, window=None,
                          compute_dtype=cd, model_axis=cfg.model_axis_size)
    return p.wo(o.reshape(b, l, hq * hd), cd)
