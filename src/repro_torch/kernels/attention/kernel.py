"""The flash-attention kernel's wrapper.

``flash_attention`` replaces ``repro.kernels.attention.kernel
.flash_attention_pallas`` (``csrc/attention.cu``
``repro_flash_attention``).  On a CUDA tensor it launches the
hand-written Hopper kernel; on a CPU tensor it runs its plain version
(``flash_attention_plain``), the same function in plain PyTorch and in the
kernel's order: per block of ``block_q`` query rows, the live k-blocks of
``block_k`` keys one after another, each rescaling f32 m, l and acc once.
Any other device raises; nothing falls back.

Layout: q (BH, Lq, D), k and v (BH, Lk, D), f32 or bf16, head_dim one of
``FLASH_HEAD_DIMS``; the output is in q's type.  Knobs, both consumed:
``block_q`` (query rows a CUDA block owns; the grid is BH x Lq / block_q)
and ``block_k`` (keys per online-softmax rescale; the k loop's step).

Bound on the card: operations (4 D per live query-key pair).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.space import (CUDA_SMEM_LIMIT, FLASH_HEAD_DIMS,
                                    flash_smem_bytes)
from repro_torch.tuning.dispatch import kernel_path

# dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the TPU kernel's mask fill: finite, so a fully masked first block gives
# p = 1 (wiped by the next rescale) and never exp(-inf + inf) = NaN
NEG_INF = -1e30


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                block_q: int, block_k: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_attention takes q (BH, Lq, D) and k, v "
                         f"(BH, Lk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v lie on different "
                         "devices")
    d = q.shape[2]
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in "
                         f"{FLASH_HEAD_DIMS}, got {d}")
    lq, lk = q.shape[1], k.shape[1]
    if block_q < 1 or lq % block_q:
        raise ValueError(f"block_q={block_q} must divide Lq={lq}")
    if block_k < 1 or lk % block_k:
        raise ValueError(f"block_k={block_k} must divide Lk={lk}")


def _live(qi: int, ki: int, block_q: int, block_k: int, offset: int,
          causal: bool, window: Optional[int]) -> bool:
    """The TPU kernel's test: is any entry of the (qi, ki) tile unmasked?"""
    live = True
    if causal:
        live &= ki * block_k <= qi * block_q + offset + block_q - 1
    if window is not None:
        live &= (ki + 1) * block_k - 1 > qi * block_q + offset - window
    return live


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, block_q: int = 256, block_k: int = 256,
                          causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, k-block by k-block."""
    BH, lq, d = q.shape
    lk = k.shape[1]
    block_q, block_k = min(block_q, lq), min(block_k, lk)
    _check_args(q, k, v, block_q, block_k)
    scale = 1.0 / math.sqrt(d)
    offset = lk - lq
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    out = torch.empty_like(q)
    rows = torch.arange(block_q, device=q.device)
    cols = torch.arange(block_k, device=q.device)
    for qi in range(lq // block_q):
        sl = slice(qi * block_q, (qi + 1) * block_q)
        qb = qf[:, sl]
        q_pos = (qi * block_q + offset + rows)[:, None]
        m = torch.full((BH, block_q, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(BH, block_q, d, dtype=torch.float32,
                          device=q.device)
        for ki in range(lk // block_k):
            if not _live(qi, ki, block_q, block_k, offset, causal, window):
                continue
            ks = slice(ki * block_k, (ki + 1) * block_k)
            s = torch.matmul(qb, kf[:, ks].transpose(1, 2)) * scale
            k_pos = (ki * block_k + cols)[None, :]
            mask = torch.ones(block_q, block_k, dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= q_pos >= k_pos
            if window is not None:
                mask &= k_pos > q_pos - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=2, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=2, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vf[:, ks])
            m = m_new
        out[:, sl] = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int,
            block_k: int, causal: bool, window: Optional[int]
            ) -> torch.Tensor:
    from repro_torch.kernels.build import check, load_library

    _check_args(q, k, v, block_q, block_k)
    if not q.is_cuda:
        raise ValueError(f"the CUDA flash kernel needs CUDA tensors, got "
                         f"ones on {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")
    BH, lq, d = q.shape
    lk = k.shape[1]
    if lq // block_q > 65535:
        raise ValueError(f"Lq / block_q = {lq // block_q} exceeds the "
                         f"grid's 65535 blocks")
    if flash_smem_bytes(block_q, block_k, d) > CUDA_SMEM_LIMIT:
        raise ValueError(f"block_k={block_k} at head_dim {d} exceeds a "
                         f"block's shared memory")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    lib = load_library()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            DTYPE_CODES[q.dtype], BH, lq, lk, d, block_q, block_k,
            int(causal), -1 if window is None else int(window),
            ctypes.c_float(1.0 / math.sqrt(d)), stream)
    check(code, "flash_attention launch")
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    block_q: int = 256, block_k: int = 256,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (BH, Lq, D), k/v: (BH, Lk, D) -> (BH, Lq, D)."""
    if not kernel_path(q):
        return flash_attention_plain(q, k, v, block_q=block_q,
                                     block_k=block_k, causal=causal,
                                     window=window)
    lq, lk = q.shape[1], k.shape[1]
    o = _launch(q.contiguous(), k.contiguous(), v.contiguous(),
                min(block_q, lq), min(block_k, lk), causal, window)
    flash_attention.launches += 1
    return o


# launches of the CUDA kernel (plain-version calls are not counted)
flash_attention.launches = 0
