"""Tuned attention entry point with GQA + decode handling.

The PyTorch port of ``repro.kernels.attention.ops``.  ``attention(q, k,
v)`` on flattened (B*H, L, D) tensors resolves its block sizes through the
default TunerSession (op "attention", variant "flash"; both lengths fitted
through ``dims``) and runs ``flash_attention``: the hand-written kernel
(``csrc/attention.cu``) for a CUDA tensor, its plain version for a CPU
tensor.  Decode (Lq == 1) takes the reference, by the JAX entry point's own
rule: a GEMV-shaped, memory-bound op where flash tiling has nothing to
add.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.space import Workload, attention_space, fit_block
from repro_torch.kernels.attention.kernel import flash_attention
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.tuning import default_session, tuned_kernel


def _normalize(cfg, wl, dims=None):
    """Fit flash block sizes to the actual (Lq, Lk); wl.n only carries Lk,
    so the entry point passes both lengths through ``dims``."""
    dims = dims or {}
    lq = int(dims.get("lq", wl.n))
    lk = int(dims.get("lk", wl.n))
    return {"block_q": fit_block(cfg.get("block_q", 256), lq),
            "block_k": fit_block(cfg.get("block_k", 256), lk)}


@tuned_kernel("attention", space=attention_space, kernel=flash_attention,
              reference=attention_ref, normalize=_normalize,
              variants=("flash",))
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              config: Optional[dict] = None) -> torch.Tensor:
    """Multi-head attention core on flattened (B*H, L, D) tensors.

    GQA callers repeat KV heads before the call."""
    BH, lq, d = q.shape
    lk = k.shape[1]
    if lq == 1:
        return attention_ref(q, k, v, causal=causal, window=window)
    cfg = default_session().resolve(
        Workload(op="attention", n=lk, batch=BH, variant="flash"),
        config=config, dims={"lq": lq, "lk": lk})
    return flash_attention(q, k, v, causal=causal, window=window, **cfg)
