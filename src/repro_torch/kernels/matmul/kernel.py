"""The tiled matmul kernel's wrapper.

``matmul_tiled`` replaces ``repro.kernels.matmul.kernel.matmul_pallas``
(``csrc/matmul.cu`` ``repro_matmul``).  On a CUDA tensor it launches the
hand-written Hopper kernel; on a CPU tensor it runs its plain version
(``matmul_plain``), the same function in plain PyTorch and in the kernel's
order: per (block_m, block_n) output block, the K / block_k partial
products one after another, each added to an f32 accumulator.  Any other
device raises; nothing falls back.  No library product runs on the card:
the plain version is the CPU path and the card's yardstick.

Layout: row-major a (M, K) and b (K, N), f32 or bf16; the product is in
a's type.  Knobs, all consumed: ``block_m`` and ``block_n`` (the output
block a CUDA block owns; the grid is N / block_n x M / block_m) and
``block_k`` (the k-block whose partial product is added at once).

Bound on the card: operations (2 M N K).
"""
from __future__ import annotations

import torch

from repro_torch.tuning.dispatch import kernel_path

# dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(a: torch.Tensor, b: torch.Tensor, block_m: int,
                block_n: int, block_k: int) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul takes (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"matmul takes float32 or bfloat16 of one type, got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError("matmul: a and b lie on different devices")
    (m, k), n = a.shape, b.shape[1]
    for name, block, dim in (("block_m", block_m, m), ("block_n", block_n, n),
                             ("block_k", block_k, k)):
        if block < 1 or dim % block:
            raise ValueError(f"{name}={block} must divide {dim}")


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 256,
                 block_n: int = 256, block_k: int = 256) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 partial products per
    k-block, accumulated in order (the output blocks are independent, so
    one product over all of them computes what every block computes)."""
    (m, k), n = a.shape, b.shape[1]
    block_m, block_n, block_k = min(block_m, m), min(block_n, n), \
        min(block_k, k)
    _check_args(a, b, block_m, block_n, block_k)
    acc = torch.zeros(m, n, dtype=torch.float32, device=a.device)
    for k0 in range(0, k, block_k):
        acc += torch.matmul(a[:, k0:k0 + block_k].to(torch.float32),
                            b[k0:k0 + block_k].to(torch.float32))
    return acc.to(a.dtype)


def _launch(a: torch.Tensor, b: torch.Tensor, block_m: int, block_n: int,
            block_k: int) -> torch.Tensor:
    from repro_torch.kernels.build import check, load_library

    _check_args(a, b, block_m, block_n, block_k)
    if not a.is_cuda:
        raise ValueError(f"the CUDA matmul kernel needs CUDA tensors, got "
                         f"ones on {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul takes contiguous tensors")
    (m, k), n = a.shape, b.shape[1]
    if m // block_m > 65535:
        raise ValueError(f"M / block_m = {m // block_m} exceeds the grid's "
                         f"65535 blocks")
    lib = load_library()
    c = torch.empty(m, n, dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.repro_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                DTYPE_CODES[a.dtype], m, n, k, block_m,
                                block_n, block_k, stream)
    check(code, "matmul launch")
    return c


def matmul_tiled(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 256,
                 block_n: int = 256, block_k: int = 256) -> torch.Tensor:
    """(M, K) @ (K, N) with an f32 accumulator, in a's type."""
    if not kernel_path(a):
        return matmul_plain(a, b, block_m=block_m, block_n=block_n,
                            block_k=block_k)
    (m, k), n = a.shape, b.shape[1]
    c = _launch(a.contiguous(), b.contiguous(), min(block_m, m),
                min(block_n, n), min(block_k, k))
    matmul_tiled.launches += 1
    return c


# launches of the CUDA kernel (plain-version calls are not counted)
matmul_tiled.launches = 0
