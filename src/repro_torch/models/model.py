"""Model builder: config -> a module with forward / encode / prefill / decode.

The PyTorch port of ``repro.models.model`` for every family of its
registry.  The JAX package scans its layer stack over parameter groups
(``lax.scan``, remat); here the groups are an ``nn.ModuleList`` walked in
order.  A group is the architecture's repeating pattern:

  * dense, moe, audio: one transformer block (``StdBlock``; moe blocks
    route their MLP through ``models.moe``, audio keeps an encoder stack
    ``enc_blocks`` beside the decoder);
  * hybrid: ``block_pattern``, e.g. (rec, rec, attn) (``HybridGroup``:
    RG-LRU blocks and local attention over ``attn_window``);
  * vlm: ``cross_attn_every`` blocks, the last with cross-attention over
    the vision memory (``VLMGroup``);
  * ssm: one SSD block (``SSDGroup``);
  * hybrid_moe: ``block_pattern``, e.g. five "mamba", one "attention",
    four "mamba" (``HybridMoEGroup``: each layer a Mamba-2 or NoPE
    attention mixer, then the dropless MoE beside its shared expert, each
    branch scaled by ``residual_multiplier``).  Forward only: it has no
    decode cache.

Parameter names follow the JAX tree with the group axis unstacked
(``blocks.{i}.attn.wq.w`` for the tree's ``blocks.attn.wq.w`` of shape
(n_groups, d, hq * hd); a hybrid or vlm group's list of blocks gives
``blocks.{i}.blocks.{j}.rec.wx.w``); ``models.convert.load_params`` loads
a JAX tree into a ``Model``.  Caches are lists with one entry per group (a
list again inside a hybrid or vlm group).  The modality frontends are
stubs, as in JAX: ``forward`` and ``decode_step`` take precomputed
frame or patch embeddings as ``memory``.  A model lives on the card unless
the caller passes ``device="cpu"`` (the plain versions of the kernels, as
the tests run them).

``cfg.remat == "full"`` recomputes activations in the backward exactly
where the JAX model calls ``jax.checkpoint``: each group of the forward,
each layer inside a hybrid or vlm group, each encoder block (and, in
``models.attention``, each q-chunk of the plain-op attention).  Only a
forward under grad mode recomputes; serving is unchanged.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import telemetry
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.hints import UNCONSTRAINED, constrain
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models.moe import DroplessMoE, MoE, moe_block
from repro_torch.models.recurrent import RecurrentBlock, init_recurrent_cache
from repro_torch.models.ssm import SSDBlock, init_ssd_cache

Cache = List[Any]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _device(device) -> torch.device:
    """The device a model is built on: CUDA unless the caller names
    another, and an error when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the model through the plain versions")
    return dev


def _norm(cfg: ModelConfig, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(cfg.d_model, dtype=dtype, device=device))


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _constrain_batch(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Pin the batch sharding of the residual stream. The embedding gather
    (vocab-sharded table) otherwise replicates its output batch dim, and
    the whole stack inherits the replication.  The identity on a plain
    tensor (``distributed.hints.constrain``)."""
    if not cfg.batch_axes or (cfg.batch_shards
                              and x.shape[0] % cfg.batch_shards):
        return x
    b = cfg.batch_axes if len(cfg.batch_axes) > 1 else cfg.batch_axes[0]
    return constrain(x, (b,) + (UNCONSTRAINED,) * (x.dim() - 1))


def _constrain_residual(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sequence-parallel (SP) sharding of the residual stream at layer
    boundaries: (B, L, D) -> (batch, "model", UNCONSTRAINED).

    The tensor saved per layer for the backward pass is the block input;
    without SP it is only batch-sharded, and deep/wide archs blow past the
    device's memory.  With SP the saves shrink by the model-axis size; the
    redistributions put the all-gather at attention entry and the
    reduce-scatter after it (Korthikanti et al.-style SP)."""
    if (cfg.activation_strategy != "sp" or not cfg.batch_axes
            or not cfg.model_axis_size or x.dim() != 3
            or x.shape[1] % cfg.model_axis_size
            or (cfg.batch_shards and x.shape[0] % cfg.batch_shards)):
        return x
    b = cfg.batch_axes if len(cfg.batch_axes) > 1 else cfg.batch_axes[0]
    return constrain(x, (b, "model", UNCONSTRAINED))


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, recomputed in the backward under ``remat="full"``
    (``jax.checkpoint``'s place in the JAX model)."""
    if cfg.remat == "full" and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class StdBlock(nn.Module):
    """Pre-norm transformer block: ln1, self-attention, (lnx and
    cross-attention when ``cross``), ln2, and a gated MLP or, in the moe
    family, the MoE block."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None,
                 cross: bool = False):
        super().__init__()
        self.ln1 = _norm(cfg, dtype, device)
        self.attn = attn_mod.Attention(cfg, dtype, device)
        self.ln2 = _norm(cfg, dtype, device)
        if cfg.family == "moe":
            self.moe = MoE(cfg, dtype, device)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, dtype, device)
        if cross:
            self.lnx = _norm(cfg, dtype, device)
            self.xattn = attn_mod.Attention(cfg, dtype, device)

    def reset(self, generator: torch.Generator) -> None:
        self.attn.reset(generator)
        (self.moe if hasattr(self, "moe") else self.mlp).reset(generator)
        if hasattr(self, "xattn"):
            self.xattn.reset(generator)

    def forward(self, x, cfg: ModelConfig, *, positions, cache=None,
                window=None, memory=None, compute_dtype=None):
        """Returns (x, the new cache, the MoE aux loss or 0)."""
        h, new_cache = attn_mod.self_attention(
            self.attn, L.rms_norm(x, self.ln1, cfg.norm_eps), cfg,
            positions=positions, cache=cache, window=window,
            compute_dtype=compute_dtype)
        x = x + h
        if hasattr(self, "xattn") and memory is not None:
            x = x + attn_mod.cross_attention(
                self.xattn, L.rms_norm(x, self.lnx, cfg.norm_eps), memory,
                cfg, compute_dtype)
        y = L.rms_norm(x, self.ln2, cfg.norm_eps)
        if hasattr(self, "moe"):
            h, aux = moe_block(self.moe, y, cfg, compute_dtype)
        else:
            h, aux = L.mlp(self.mlp, y, cfg.activation, compute_dtype), \
                _zero(x)
        return x + h, new_cache, aux


class SSDGroup(nn.Module):
    """ln, the Mamba-2 block, and (when d_ff is set) ln2 and a gated MLP."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.ln = _norm(cfg, dtype, device)
        self.ssd = SSDBlock(cfg, dtype=dtype, device=device)
        self.ln2 = _norm(cfg, dtype, device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, dtype, device) \
            if cfg.d_ff else None

    def reset(self, generator: torch.Generator) -> None:
        self.ssd.reset(generator)
        if self.mlp is not None:
            self.mlp.reset(generator)

    def forward(self, x, cfg: ModelConfig, *, positions=None, cache=None,
                window=None, memory=None, compute_dtype=None):
        h, new_cache = self.ssd(L.rms_norm(x, self.ln, cfg.norm_eps),
                                cache=cache, compute_dtype=compute_dtype)
        x = x + h
        if self.mlp is not None:
            x = x + L.mlp(self.mlp, L.rms_norm(x, self.ln2, cfg.norm_eps),
                          cfg.activation, compute_dtype)
        return x, new_cache, _zero(x)


class RecLayer(nn.Module):
    """A hybrid group's recurrent entry: ln1, the RG-LRU block, ln2 and a
    gated MLP."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.ln1 = _norm(cfg, dtype, device)
        self.rec = RecurrentBlock(cfg, dtype, device)
        self.ln2 = _norm(cfg, dtype, device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, dtype, device)

    def reset(self, generator: torch.Generator) -> None:
        self.rec.reset(generator)
        self.mlp.reset(generator)

    def forward(self, x, cfg: ModelConfig, *, cache=None,
                compute_dtype=None):
        h, new_cache = self.rec(L.rms_norm(x, self.ln1, cfg.norm_eps), cfg,
                                cache=cache, compute_dtype=compute_dtype)
        x = x + h
        x = x + L.mlp(self.mlp, L.rms_norm(x, self.ln2, cfg.norm_eps),
                      cfg.activation, compute_dtype)
        return x, new_cache


class HybridGroup(nn.Module):
    """One ``block_pattern`` period: ``RecLayer`` for "rec", a ``StdBlock``
    over the local ``attn_window`` for "attn"."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            RecLayer(cfg, dtype, device) if kind == "rec"
            else StdBlock(cfg, dtype, device) for kind in cfg.block_pattern)

    def reset(self, generator: torch.Generator) -> None:
        for blk in self.blocks:
            blk.reset(generator)

    def forward(self, x, cfg: ModelConfig, *, positions, cache=None,
                window=None, memory=None, compute_dtype=None):
        new_caches = []
        for i, blk in enumerate(self.blocks):
            sub = None if cache is None else cache[i]
            if isinstance(blk, RecLayer):
                def run(xx, blk=blk, sub=sub):
                    return blk(xx, cfg, cache=sub,
                               compute_dtype=compute_dtype)
            else:
                def run(xx, blk=blk, sub=sub):
                    xx, nc, _ = blk(xx, cfg, positions=positions, cache=sub,
                                    window=cfg.attn_window,
                                    compute_dtype=compute_dtype)
                    return xx, nc
            # per-layer remat: without it the whole group's forward stays
            # live during the group's backward replay
            x, nc = _remat(cfg, run, x) if cache is None else run(x)
            new_caches.append(nc)
        return x, (new_caches if cache is not None else None), _zero(x)


class MixerMoELayer(nn.Module):
    """A "hybrid_moe" layer: ln1, its mixer (``ssd``, the published
    Mamba-2 block, or ``attn``, causal GQA without a positional encoding
    at scale ``attention_multiplier``), ln2, and the dropless ``moe``; each
    branch times ``residual_multiplier`` before its residual add."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.ln1 = _norm(cfg, dtype, device)
        if kind == "mamba":
            self.ssd = SSDBlock(cfg, dtype=dtype, device=device,
                                published=True)
        elif kind == "attention":
            self.attn = attn_mod.Attention(cfg, dtype, device)
        else:
            raise ValueError(f"no mixer {kind!r}")
        self.ln2 = _norm(cfg, dtype, device)
        self.moe = DroplessMoE(cfg, dtype, device)

    def reset(self, generator: torch.Generator) -> None:
        (self.ssd if hasattr(self, "ssd") else self.attn).reset(generator)
        self.moe.reset(generator)

    def forward(self, x, cfg: ModelConfig, *, positions, compute_dtype):
        y = L.rms_norm(x, self.ln1, cfg.norm_eps)
        if hasattr(self, "ssd"):
            h, _ = self.ssd(y, compute_dtype=compute_dtype)
        else:
            h, _ = attn_mod.self_attention(
                self.attn, y, cfg, positions=positions,
                compute_dtype=compute_dtype, use_rope=False,
                scale=cfg.attention_multiplier)
        x = x + h * cfg.residual_multiplier
        h = self.moe(L.rms_norm(x, self.ln2, cfg.norm_eps), compute_dtype)
        return x + h * cfg.residual_multiplier


class HybridMoEGroup(nn.Module):
    """One ``block_pattern`` period of ``MixerMoELayer``s."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(MixerMoELayer(cfg, kind, dtype, device)
                                    for kind in cfg.block_pattern)

    def reset(self, generator: torch.Generator) -> None:
        for blk in self.blocks:
            blk.reset(generator)

    def forward(self, x, cfg: ModelConfig, *, positions, cache=None,
                window=None, memory=None, compute_dtype=None):
        if cache is not None:
            raise NotImplementedError("the hybrid_moe family has no decode "
                                      "cache")
        for blk in self.blocks:
            # per-layer remat (see HybridGroup)
            x = _remat(cfg, lambda xx, blk=blk: blk(
                xx, cfg, positions=positions, compute_dtype=compute_dtype),
                x)
        return x, None, _zero(x)


class VLMGroup(nn.Module):
    """``cross_attn_every`` blocks; the last attends over the memory."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        period = cfg.cross_attn_every
        self.blocks = nn.ModuleList(
            StdBlock(cfg, dtype, device, cross=(i == period - 1))
            for i in range(period))

    def reset(self, generator: torch.Generator) -> None:
        for blk in self.blocks:
            blk.reset(generator)

    def forward(self, x, cfg: ModelConfig, *, positions, cache=None,
                window=None, memory=None, compute_dtype=None):
        new_caches = []
        for i, blk in enumerate(self.blocks):
            def run(xx, blk=blk, sub=None if cache is None else cache[i]):
                return blk(xx, cfg, positions=positions, cache=sub,
                           memory=memory, compute_dtype=compute_dtype)[:2]
            # per-layer remat inside the group (see HybridGroup)
            x, nc = _remat(cfg, run, x) if cache is None else run(x)
            new_caches.append(nc)
        return x, (new_caches if cache is not None else None), _zero(x)


_GROUPS = {"ssm": SSDGroup, "hybrid": HybridGroup, "vlm": VLMGroup,
           "dense": StdBlock, "moe": StdBlock, "audio": StdBlock,
           "hybrid_moe": HybridMoEGroup}


class Model(nn.Module):
    """The embedding, ``n_groups`` groups and the final norm (and, for
    enc-dec archs, the encoder's blocks and norm); logits come from the
    tied embedding table, in f32."""

    def __init__(self, cfg: ModelConfig, dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        super().__init__()
        device = _device(device)
        self.cfg = cfg
        dtype = dtype if dtype is not None else _dtype(cfg.param_dtype)
        group = _GROUPS[cfg.family]
        self.embed = L.Embedding(cfg.vocab, cfg.d_model, dtype, device)
        self.blocks = nn.ModuleList(group(cfg, dtype, device)
                                    for _ in range(self.n_groups))
        self.final_norm = _norm(cfg, dtype, device)
        if cfg.is_enc_dec:
            self.enc_blocks = nn.ModuleList(
                StdBlock(cfg, dtype, device)
                for _ in range(cfg.n_enc_layers or cfg.n_layers))
            self.enc_norm = _norm(cfg, dtype, device)

    @property
    def group_period(self) -> int:
        if self.cfg.family in ("hybrid", "hybrid_moe"):
            return len(self.cfg.block_pattern)
        if self.cfg.family == "vlm":
            return self.cfg.cross_attn_every
        return 1

    @property
    def n_groups(self) -> int:
        return self.cfg.n_layers // self.group_period

    @classmethod
    def init(cls, cfg: ModelConfig, generator: torch.Generator,
             dtype: Optional[torch.dtype] = None, device="cuda") -> "Model":
        """A model with weights drawn from ``generator`` (on ``device``) at
        the JAX initializers' scales: normal projections and embedding over
        sqrt(fan-in), MoE experts over sqrt(d) and sqrt(d_ff_expert), convs
        over sqrt(width), zero biases and norm scales, and the blocks' own
        deterministic parameters (the SSD block's, the RG-LRU's
        ``lambda``)."""
        return cls(cfg, dtype=dtype, device=device).reset(generator)

    def reset(self, generator: torch.Generator) -> "Model":
        """Draw every weight anew from ``generator`` (on the model's
        device), as :meth:`init` does; returns the model."""
        with torch.no_grad():
            for p in self.parameters():
                p.zero_()
            self.embed.reset(generator)
            for blk in self.blocks:
                blk.reset(generator)
            for blk in getattr(self, "enc_blocks", ()):
                blk.reset(generator)
        return self

    def _cd(self) -> torch.dtype:
        return _dtype(self.cfg.compute_dtype)

    def _memory(self, memory: Optional[torch.Tensor]
                ) -> Optional[torch.Tensor]:
        """The memory the groups see: the encoder's or the vision stub's in
        the compute type, for the families that take one."""
        if memory is None or self.cfg.family not in ("vlm", "audio"):
            return None
        return memory.to(self._cd())

    def _embed(self, tokens: torch.Tensor,
               one_hot: bool = False) -> torch.Tensor:
        cd = self._cd()
        # sqrt(d_model) in the compute type, as the JAX model scales it
        # (hybrid_moe: its embedding_multiplier)
        scale = self.cfg.embedding_multiplier \
            if self.cfg.family == "hybrid_moe" else math.sqrt(self.cfg.d_model)
        root = torch.tensor(scale, dtype=torch.float32,
                            device=tokens.device).to(cd)
        x = L.embed(self.embed, tokens, cd, one_hot=one_hot) * root
        return _constrain_batch(x, self.cfg)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        logits = L.unembed(self.embed, x, self.cfg.logits_softcap)
        if self.cfg.family == "hybrid_moe":
            logits.div_(self.cfg.logits_scaling)
        return logits

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The enc-dec encoder over precomputed frame embeddings (B, T, D)
        (the stub frontend): its blocks, then ``enc_norm``.  Its
        self-attention is causal, as in the JAX package."""
        cfg, cd = self.cfg, self._cd()
        x = _constrain_batch(frames.to(cd), cfg)
        b, t = x.shape[:2]
        positions = torch.arange(t, device=x.device)[None].expand(b, t)
        for blk in self.enc_blocks:
            def run(h, blk=blk):
                return blk(h, cfg, positions=positions, compute_dtype=cd)[0]
            x = _remat(cfg, run, x)
        return L.rms_norm(x, self.enc_norm, cfg.norm_eps)

    @telemetry.spanned("repro.model.forward")
    def forward(self, tokens: torch.Tensor,
                memory: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, L) -> (logits (B, L, V) f32, the aux loss summed over
        the groups over their count)."""
        cfg, cd = self.cfg, self._cd()
        b, l = tokens.shape
        # the one-hot embedding under a mesh, as the JAX model's forward
        x = self._embed(tokens, one_hot=bool(cfg.batch_axes))
        positions = torch.arange(l, device=tokens.device)[None].expand(b, l)
        memory = self._memory(memory)
        aux = _zero(x)
        for blk in self.blocks:
            def run(h, blk=blk):
                y, _, a = blk(h, cfg, positions=positions,
                              window=cfg.attn_window, memory=memory,
                              compute_dtype=cd)
                return y, a
            x = _constrain_residual(x, cfg)
            x, a = _remat(cfg, run, x)
            aux = aux + a
        return self._logits(x), aux / max(self.n_groups, 1)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16, device=None) -> Cache:
        """One cache per group, on the model's device unless ``device``
        names another: a full KV cache (dense, moe, audio), the SSD
        block's conv and state (ssm), a list of one cache a block (vlm:
        full KV caches; hybrid: the RG-LRU's conv and f32 state, and a KV
        ring buffer of min(max_len, window) slots whose ``pos`` holds each
        slot's absolute position, -2^30 while empty, when the window is
        shorter than max_len)."""
        cfg = self.cfg
        if cfg.family == "hybrid_moe":
            raise NotImplementedError("the hybrid_moe family has no decode "
                                      "cache")
        device = device if device is not None else self.final_norm.device

        def kv(length: int, ring: bool = False) -> Dict[str, torch.Tensor]:
            shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
            out = {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device)}
            if ring:
                out["pos"] = torch.full((batch, length), -2 ** 30,
                                        dtype=torch.int32, device=device)
            return out

        def one_group():
            if cfg.family == "ssm":
                return init_ssd_cache(cfg, batch, dtype, device)
            if cfg.family == "hybrid":
                window = cfg.attn_window or max_len
                ring = cfg.attn_window is not None \
                    and cfg.attn_window < max_len
                return [init_recurrent_cache(cfg, batch, dtype, device)
                        if kind == "rec" else kv(min(max_len, window), ring)
                        for kind in cfg.block_pattern]
            if cfg.family == "vlm":
                return [kv(max_len) for _ in range(cfg.cross_attn_every)]
            return kv(max_len)

        return [one_group() for _ in range(self.n_groups)]

    def decode_step(self, token: torch.Tensor, cache: Cache,
                    pos: torch.Tensor,
                    memory: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """token: (B, 1); pos: (B, 1) absolute positions.  Returns the
        logits (B, 1, V) and the new cache (the old one is untouched)."""
        x, new_cache = self._step(token, cache, pos, memory)
        return self._logits(x), new_cache

    def _step(self, token, cache, pos, memory=None):
        """One token through every group: the last hidden state and the
        new cache."""
        cfg, cd = self.cfg, self._cd()
        x = self._embed(token)
        memory = self._memory(memory)
        new_cache = []
        for blk, c in zip(self.blocks, cache):
            x, nc, _ = blk(x, cfg, positions=pos, cache=c,
                           window=cfg.attn_window, memory=memory,
                           compute_dtype=cd)
            new_cache.append(nc)
        return x, new_cache

    def prefill(self, tokens: torch.Tensor, cache: Cache,
                positions: torch.Tensor, write_mask: torch.Tensor) -> Cache:
        """Write a block of prompt tokens into the decode cache.

        ``tokens`` / ``positions`` / ``write_mask``: (steps, batch),
        time-major.  Steps through :meth:`decode_step`'s groups (without
        memory, as the JAX model does, and without its logits, which the
        JAX model's compiled scan never forms); at step t lane b's cache
        advances only where ``write_mask[t, b]``, and masked-off lanes keep
        their cache bit-exactly (their step output is discarded)."""
        for tok, pos, write in zip(tokens, positions, write_mask):
            _, new = self._step(tok[:, None], cache, pos[:, None])
            cache = _merge(new, cache, write)
        return cache


def _merge(new, old, write: torch.Tensor):
    """``new`` where lane b writes, ``old`` elsewhere, through the nested
    lists and dicts of a cache (batch-leading tensors)."""
    if isinstance(new, dict):
        return {key: _merge(n, old[key], write) for key, n in new.items()}
    if isinstance(new, list):
        return [_merge(n, o, write) for n, o in zip(new, old)]
    return torch.where(write.reshape((-1,) + (1,) * (new.dim() - 1)),
                       new, old)


def build_model(cfg: ModelConfig, dtype: Optional[torch.dtype] = None,
                device="cuda") -> Model:
    """A model with zero parameters (load them with
    ``models.convert.load_params``, or draw them with ``Model.init``)."""
    return Model(cfg, dtype=dtype, device=device)
