"""Model builder: config -> a module with forward / prefill / decode.

The PyTorch port of ``repro.models.model`` for the ``dense`` and ``ssm``
families.  The JAX package scans its layer stack over parameter groups
(``lax.scan``, remat); here the groups are an ``nn.ModuleList`` walked in
order (PyTorch runs eagerly, and the port trains nothing yet).  A group is
the architecture's repeating pattern: one transformer block (dense) or one
SSD block (ssm).  Parameter names follow the JAX tree with the group axis
unstacked (``blocks.{i}.attn.wq.w`` for the tree's ``blocks.attn.wq.w``
of shape (n_groups, d, hq * hd)); ``models.convert.load_params`` loads a
JAX tree into a ``Model``.  Caches are lists with one entry per group.
A model lives on the card unless the caller passes ``device="cpu"`` (the
plain versions of the kernels, as the tests run them).

The moe, hybrid, vlm and audio families raise ``NotImplementedError``
until their slices of the port land (ROADMAP.md, "Models").
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models.ssm import SSDBlock, init_ssd_cache

Cache = List[Any]
_FAMILIES = ("dense", "ssm")


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


class StdBlock(nn.Module):
    """Pre-norm transformer block: ln1, self-attention, ln2, gated MLP."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.ln1 = nn.Parameter(torch.zeros(cfg.d_model, dtype=dtype,
                                            device=device))
        self.attn = attn_mod.Attention(cfg, dtype, device)
        self.ln2 = nn.Parameter(torch.zeros(cfg.d_model, dtype=dtype,
                                            device=device))
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, dtype, device)

    def reset(self, generator: torch.Generator) -> None:
        self.attn.reset(generator)
        self.mlp.reset(generator)

    def forward(self, x, cfg: ModelConfig, *, positions, cache=None,
                window=None, compute_dtype=None):
        h, new_cache = attn_mod.self_attention(
            self.attn, L.rms_norm(x, self.ln1, cfg.norm_eps), cfg,
            positions=positions, cache=cache, window=window,
            compute_dtype=compute_dtype)
        x = x + h
        y = L.rms_norm(x, self.ln2, cfg.norm_eps)
        return x + L.mlp(self.mlp, y, cfg.activation, compute_dtype), \
            new_cache


class SSDGroup(nn.Module):
    """ln, the Mamba-2 block, and (when d_ff is set) ln2 and a gated MLP."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.ln = nn.Parameter(torch.zeros(cfg.d_model, dtype=dtype,
                                           device=device))
        self.ssd = SSDBlock(cfg, dtype=dtype, device=device)
        self.ln2 = nn.Parameter(torch.zeros(cfg.d_model, dtype=dtype,
                                            device=device))
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, dtype, device) \
            if cfg.d_ff else None

    def reset(self, generator: torch.Generator) -> None:
        self.ssd.reset(generator)
        if self.mlp is not None:
            self.mlp.reset(generator)

    def forward(self, x, cfg: ModelConfig, *, positions=None, cache=None,
                window=None, compute_dtype=None):
        h, new_cache = self.ssd(L.rms_norm(x, self.ln, cfg.norm_eps),
                                cache=cache, compute_dtype=compute_dtype)
        x = x + h
        if self.mlp is not None:
            x = x + L.mlp(self.mlp, L.rms_norm(x, self.ln2, cfg.norm_eps),
                          cfg.activation, compute_dtype)
        return x, new_cache


class Model(nn.Module):
    """The embedding, ``n_groups`` groups and the final norm; logits come
    from the tied embedding table, in f32."""

    def __init__(self, cfg: ModelConfig, dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        super().__init__()
        if cfg.family not in _FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not in the PyTorch port yet: see "
                f"ROADMAP.md, 'Models'")
        device = _device(device)
        self.cfg = cfg
        dtype = dtype if dtype is not None else _dtype(cfg.param_dtype)
        group = SSDGroup if cfg.family == "ssm" else StdBlock
        self.embed = L.Embedding(cfg.vocab, cfg.d_model, dtype, device)
        self.blocks = nn.ModuleList(group(cfg, dtype, device)
                                    for _ in range(self.n_groups))
        self.final_norm = nn.Parameter(torch.zeros(cfg.d_model, dtype=dtype,
                                                   device=device))

    @property
    def n_groups(self) -> int:
        return self.cfg.n_layers

    @classmethod
    def init(cls, cfg: ModelConfig, generator: torch.Generator,
             dtype: Optional[torch.dtype] = None, device="cuda") -> "Model":
        """A model with weights drawn from ``generator`` (on ``device``) at
        the JAX initializers' scales: normal projections and embedding over
        sqrt(fan-in), zero biases and norm scales (the SSD block's own
        initializer for its parameters)."""
        model = cls(cfg, dtype=dtype, device=device)
        with torch.no_grad():
            model.embed.reset(generator)
            for blk in model.blocks:
                blk.reset(generator)
        return model

    def _cd(self) -> torch.dtype:
        return _dtype(self.cfg.compute_dtype)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        cd = self._cd()
        # sqrt(d_model) in the compute type, as the JAX model scales it
        root = torch.tensor(math.sqrt(self.cfg.d_model), dtype=torch.float32,
                            device=tokens.device).to(cd)
        return L.embed(self.embed, tokens, cd) * root

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return L.unembed(self.embed, x, self.cfg.logits_softcap)

    def forward(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, L) -> (logits (B, L, V) f32, aux loss scalar)."""
        cfg, cd = self.cfg, self._cd()
        b, l = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(l, device=tokens.device)[None].expand(b, l)
        for blk in self.blocks:
            x, _ = blk(x, cfg, positions=positions, window=cfg.attn_window,
                       compute_dtype=cd)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return self._logits(x), aux

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16, device=None) -> Cache:
        """One cache per group: a full KV cache (dense) or the SSD block's
        conv and state cache (ssm), on the model's device unless
        ``device`` names another."""
        cfg = self.cfg
        device = device if device is not None else self.final_norm.device
        if cfg.family == "ssm":
            return [init_ssd_cache(cfg, batch, dtype, device)
                    for _ in range(self.n_groups)]
        shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return [{"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
                for _ in range(self.n_groups)]

    def decode_step(self, token: torch.Tensor, cache: Cache,
                    pos: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """token: (B, 1); pos: (B, 1) absolute positions.  Returns the
        logits (B, 1, V) and the new cache (the old one is untouched)."""
        cfg, cd = self.cfg, self._cd()
        x = self._embed(token)
        new_cache = []
        for blk, c in zip(self.blocks, cache):
            x, nc = blk(x, cfg, positions=pos, cache=c,
                        window=cfg.attn_window, compute_dtype=cd)
            new_cache.append(nc)
        return self._logits(x), new_cache

    def prefill(self, tokens: torch.Tensor, cache: Cache,
                positions: torch.Tensor, write_mask: torch.Tensor) -> Cache:
        """Write a block of prompt tokens into the decode cache.

        ``tokens`` / ``positions`` / ``write_mask``: (steps, batch),
        time-major.  Steps through :meth:`decode_step`; at step t lane b's
        cache advances only where ``write_mask[t, b]``, and masked-off lanes
        keep their cache bit-exactly (their step output is discarded)."""
        for tok, pos, write in zip(tokens, positions, write_mask):
            _, new = self.decode_step(tok[:, None], cache, pos[:, None])
            cache = [_merge(n, o, write) for n, o in zip(new, cache)]
        return cache


def _merge(new: Dict[str, torch.Tensor], old: Dict[str, torch.Tensor],
           write: torch.Tensor) -> Dict[str, torch.Tensor]:
    out = {}
    for key, n in new.items():
        w = write.reshape((-1,) + (1,) * (n.dim() - 1))
        out[key] = torch.where(w, n, old[key])
    return out


def build_model(cfg: ModelConfig, dtype: Optional[torch.dtype] = None,
                device="cuda") -> Model:
    """A model with zero parameters (load them with
    ``models.convert.load_params``, or draw them with ``Model.init``)."""
    return Model(cfg, dtype=dtype, device=device)
