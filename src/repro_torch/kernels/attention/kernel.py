"""The flash-attention kernel's wrapper.

``flash_attention`` replaces ``repro.kernels.attention.kernel
.flash_attention_pallas``.  Which code runs is fixed by the tensor, never
by a failure:

  * a CUDA bf16 tensor: the tensor-core kernel (``csrc/attention.cu``
    ``repro_flash_attention_wgmma``: wgmma, TMA, an mbarrier ring);
  * a CUDA f32 tensor: the CUDA-core kernel (``repro_flash_attention``),
    since TF32 on the tensor cores would break f32's DTYPE_TOL;
  * a CPU tensor: its plain version (``flash_attention_plain``), the same
    function in plain PyTorch and in the TPU kernel's order: per block of
    ``block_q`` query rows, the live k-blocks of ``block_k`` keys one after
    another, each rescaling f32 m, l and acc once.

Any other device raises; nothing falls back.  Each route counts its
launches (``flash_attention.launches_wgmma``, ``.launches_simt``), and
both count into ``.launches``.

Layout: q (BH, Lq, D), k and v (BH, Lk, D), f32 or bf16, head_dim one of
``FLASH_HEAD_DIMS``; the output is in q's type.  Knobs, both consumed:
``block_q`` (query rows a CUDA block owns; the grid is BH x Lq / block_q)
and ``block_k`` (which keys are live, by the TPU's test on each (block_q,
block_k) tile; in the f32 kernel also the keys one rescale covers).

Bound on the card: operations (4 D per live query-key pair).
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.core.space import (CUDA_SMEM_LIMIT, FLASH_HEAD_DIMS,
                                    flash_smem_bytes, flash_wgmma_geometry)
from repro_torch.tuning.dispatch import kernel_path, no_backward

# dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel each type runs on the card: tensor cores for bf16, CUDA cores
# for f32 (fixed by type; the f32 kernel also takes bf16 for the record)
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "simt"}
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


def wgmma_steps(lk: int, block_q: int, block_k: int, qi: int, offset: int,
                causal: bool, window: Optional[int], head_dim: int
                ) -> Tuple[int, int, List[int]]:
    """How the bf16 kernel walks the keys of query block ``qi``, as
    ``csrc/attention.cu`` computes it: the live k-blocks (the TPU's test)
    form one run [lo, hi]; ``(k_start, k_end, starts)`` are the run's keys
    and the first key of each step of ``kt`` keys.  Keys of a step at or
    past ``k_end`` score -inf.  No live block: ``(0, 0, [])``."""
    live = [ki for ki in range(lk // block_k)
            if _live(qi, ki, block_q, block_k, offset, causal, window)]
    if not live:
        return 0, 0, []
    k_start, k_end = min(live) * block_k, (max(live) + 1) * block_k
    kt = flash_wgmma_geometry(head_dim)["kt"]
    return k_start, k_end, list(range(k_start, k_end, kt))


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
            block_k: int, causal: bool, window: Optional[int],
            route: Optional[str] = None) -> torch.Tensor:
    """Launch one kernel: ``route`` "wgmma" (bf16 only) or "simt"; by
    default the route of q's type (:data:`ROUTES`)."""
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
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    route = route or ROUTES[q.dtype]
    if route == "wgmma":
        if q.dtype != torch.bfloat16:
            raise TypeError(f"the tensor-core flash kernel takes bfloat16, "
                            f"got {q.dtype}")
        smem = flash_wgmma_geometry(d)["smem"]
    else:
        smem = flash_smem_bytes(block_q, block_k, d)
    if smem > CUDA_SMEM_LIMIT:
        raise ValueError(f"block_k={block_k} at head_dim {d} exceeds a "
                         f"block's shared memory ({route})")
    lib = load_library()
    o = torch.empty_like(q)
    scale = ctypes.c_float(1.0 / math.sqrt(d))
    win = -1 if window is None else int(window)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "wgmma":
            code = lib.repro_flash_attention_wgmma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), BH,
                lq, lk, d, block_q, block_k, int(causal), win, scale, stream)
        else:
            code = lib.repro_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                DTYPE_CODES[q.dtype], BH, lq, lk, d, block_q, block_k,
                int(causal), win, scale, stream)
    check(code, f"flash_attention launch ({route})")
    return no_backward("flash_attention", o, q, k, v)


def flash_attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, block_q: int = 256, block_k: int = 256,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """The CUDA-core kernel on CUDA tensors of either type, bf16 included:
    the earlier design's record, timed beside the tensor-core kernel.  No
    entry point calls it, and it counts no launch."""
    lq, lk = q.shape[1], k.shape[1]
    return _launch(q.contiguous(), k.contiguous(), v.contiguous(),
                   min(block_q, lq), min(block_k, lk), causal, window,
                   route="simt")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    block_q: int = 256, block_k: int = 256,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (BH, Lq, D), k/v: (BH, Lk, D) -> (BH, Lq, D): bf16 on the card
    through the tensor-core kernel, f32 through the CUDA-core one, a CPU
    tensor through the plain version (fixed by type and device)."""
    if not kernel_path(q):
        return flash_attention_plain(q, k, v, block_q=block_q,
                                     block_k=block_k, causal=causal,
                                     window=window)
    lq, lk = q.shape[1], k.shape[1]
    o = _launch(q.contiguous(), k.contiguous(), v.contiguous(),
                min(block_q, lq), min(block_k, lk), causal, window)
    flash_attention.launches += 1
    if ROUTES[q.dtype] == "wgmma":
        flash_attention.launches_wgmma += 1
    else:
        flash_attention.launches_simt += 1
    return o


# launches of the CUDA kernels (plain-version calls are not counted): all,
# and by route
flash_attention.launches = 0
flash_attention.launches_wgmma = 0
flash_attention.launches_simt = 0
