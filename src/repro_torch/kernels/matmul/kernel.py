"""The tiled matmul kernel's wrapper.

``matmul_tiled`` replaces ``repro.kernels.matmul.kernel.matmul_pallas``.
Which code runs is fixed by the tensor and its shape before the launch,
never by a failure (:func:`matmul_route`):

  * a CUDA bf16 tensor: the tensor-core kernel (``csrc/matmul.cu``
    ``repro_matmul_wgmma``: wgmma, TMA, an mbarrier ring), route "wgmma";
  * a CUDA bf16 tensor whose shape that kernel does not take — block_k not
    a multiple of 16 (a k-block is whole k16 steps; with it K, and so A's
    row pitch, need not be a multiple of 16 bytes, which TMA requires), N
    not a multiple of 8 (B's row pitch), or a base address off TMA's 16
    bytes: the CUDA-core kernel (``repro_matmul``, which takes bf16 and
    any shape), route "ragged".  The JAX package's ``matmul`` answers
    these shapes (the differential table's (33, 65) @ (65, 96), K prime),
    so the port answers them on a hand-written kernel too;
  * a CUDA f32 tensor: the CUDA-core kernel (``repro_matmul``), since TF32
    on the tensor cores would break f32's DTYPE_TOL, route "simt";
  * a CPU tensor: its plain version (``matmul_plain``), the same function
    in plain PyTorch and in the kernels' order: per (block_m, block_n)
    output block, the K / block_k partial products one after another, each
    added to an f32 accumulator.

Any other device raises; nothing falls back.  Each route counts its
launches (``matmul_tiled.launches_wgmma``, ``.launches_ragged``,
``.launches_simt``), and all count into ``.launches``.  No library
product runs on the card: the plain version is the CPU path and the
card's yardstick.

Layout: row-major a (M, K) and b (K, N), f32 or bf16; the product is in
a's type.  Knobs, all consumed: ``block_m`` and ``block_n`` (the output
block a CUDA block owns; the grid is N / block_n x M / block_m) and
``block_k`` (the k-block whose partial product is added at once).  The
bf16 tensor-core kernel takes block_k a multiple of 16 and N a multiple of
8 (:func:`wgmma_plan`); the CUDA-core kernel takes any blocks that divide
the dimensions.

Bound on the card: operations (2 M N K).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.tuning.dispatch import kernel_path, no_backward

# dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel each type runs on the card: tensor cores for bf16, CUDA cores
# for f32 (fixed by type; the f32 kernel also takes bf16 for the record)
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "simt"}
WGMMA_TILE = (128, 128)   # the bf16 kernel's tile: rows, columns
WGMMA_STAGE_K = 64        # k depth of one TMA stage
WGMMA_STEP_K = 16         # k depth of one wgmma
TMA_ALIGN = 16            # bytes: TMA's base-address and row-pitch unit


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


def wgmma_plan(m: int, n: int, k: int, block_m: int, block_n: int,
               block_k: int) -> dict:
    """The bf16 kernel's geometry, as ``csrc/matmul.cu`` walks it: the
    grid, each block's 128 x 128 tiles (origin within the block), the
    64-deep TMA stages of a tile and its k-blocks, as the kernel folds
    them: a new partial starts at every k16 step ``kk`` with ``kk %
    block_k == 0``.  Raises for what the kernel does not take."""
    if block_k % WGMMA_STEP_K:
        raise ValueError(f"the bf16 tensor-core matmul takes block_k a "
                         f"multiple of {WGMMA_STEP_K} (whole k16 steps a "
                         f"k-block), got block_k={block_k}")
    if n % 8:
        raise ValueError(f"the bf16 tensor-core matmul takes N a multiple "
                         f"of 8 (TMA's 16-byte row pitch), got N={n}")
    starts = [kk for kk in range(0, k, WGMMA_STEP_K) if kk % block_k == 0]
    return {"grid": (n // block_n, m // block_m),
            "tiles": [(tm, tn) for tm in range(0, block_m, WGMMA_TILE[0])
                      for tn in range(0, block_n, WGMMA_TILE[1])],
            "stages": -(-k // WGMMA_STAGE_K),
            "k_blocks": list(zip(starts, starts[1:] + [k]))}


def matmul_route(a: torch.Tensor, b: torch.Tensor, block_k: int) -> str:
    """The kernel a CUDA launch of ``a @ b`` at this ``block_k`` runs,
    decided from the type and shapes before the launch: "simt" for f32;
    for bf16 "wgmma" where the tensor-core kernel takes the shape
    (:func:`wgmma_plan`'s block_k and N rules, both base addresses on
    TMA's 16 bytes), else "ragged" (the CUDA-core kernel on bf16)."""
    route = ROUTES[a.dtype]
    if route == "wgmma" and (block_k % WGMMA_STEP_K or b.shape[1] % 8
                             or a.data_ptr() % TMA_ALIGN
                             or b.data_ptr() % TMA_ALIGN):
        return "ragged"
    return route


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
            block_k: int, route: Optional[str] = None) -> torch.Tensor:
    """Launch one kernel: ``route`` "wgmma" (bf16 only), "ragged" (the
    CUDA-core kernel, bf16 only) or "simt"; by default the route
    :func:`matmul_route` picks."""
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
    route = route or matmul_route(a, b, block_k)
    if route in ("wgmma", "ragged") and a.dtype != torch.bfloat16:
        raise TypeError(f"the {route} matmul route takes bfloat16, got "
                        f"{a.dtype}")
    if route == "wgmma":
        wgmma_plan(m, n, k, block_m, block_n, block_k)
    lib = load_library()
    c = torch.empty(m, n, dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if route == "wgmma":
            code = lib.repro_matmul_wgmma(a.data_ptr(), b.data_ptr(),
                                          c.data_ptr(), m, n, k, block_m,
                                          block_n, block_k, stream)
        else:
            code = lib.repro_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                    DTYPE_CODES[a.dtype], m, n, k, block_m,
                                    block_n, block_k, stream)
    check(code, f"matmul launch ({route})")
    return no_backward("matmul_tiled", c, a, b)


def matmul_simt(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 256,
                block_n: int = 256, block_k: int = 256) -> torch.Tensor:
    """The CUDA-core kernel on CUDA tensors of either type, bf16 included:
    the earlier design's record, timed beside the tensor-core kernel.  No
    entry point calls it, and it counts no launch."""
    (m, k), n = a.shape, b.shape[1]
    return _launch(a.contiguous(), b.contiguous(), min(block_m, m),
                   min(block_n, n), min(block_k, k), route="simt")


def wgmma_probe(a: torch.Tensor, b: torch.Tensor, *, b_mn_major: bool,
                k_steps: int = 1) -> torch.Tensor:
    """One warpgroup product on the card, for the card tests: a (64, 64)
    bf16 (K-major) times b, either (n, 64) K-major (the result is a[:, :16
    k_steps] @ b[:, :16 k_steps].T) or (64, n) MN-major with the transpose
    bit (a[:, :16 k_steps] @ b[:16 k_steps]); n 64 or 128; f32 (64, n)
    out.  The descriptors and swizzled layouts are the kernels'."""
    from repro_torch.kernels.build import check, load_library

    n = b.shape[1] if b_mn_major else b.shape[0]
    if a.shape != (64, 64) or n not in (64, 128) \
            or b.shape != ((64, n) if b_mn_major else (n, 64)) \
            or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 \
            or not (a.is_cuda and b.is_cuda):
        raise ValueError(f"wgmma_probe takes CUDA bf16 a (64, 64) and b "
                         f"(n, 64) or (64, n), n 64 or 128; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty(64, n, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = load_library().repro_wgmma_probe(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), n, int(b_mn_major),
            k_steps, stream)
    check(code, "wgmma probe")
    return no_backward("wgmma_probe", c, a, b)


def matmul_tiled(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 256,
                 block_n: int = 256, block_k: int = 256) -> torch.Tensor:
    """(M, K) @ (K, N) with an f32 accumulator, in a's type: bf16 on the
    card through the tensor-core kernel (or the CUDA-core one, for shapes
    the tensor-core kernel does not take), f32 through the CUDA-core one,
    a CPU tensor through the plain version (fixed by type, shape and
    device: :func:`matmul_route`)."""
    if not kernel_path(a):
        return matmul_plain(a, b, block_m=block_m, block_n=block_n,
                            block_k=block_k)
    (m, k), n = a.shape, b.shape[1]
    a, b, block_k = a.contiguous(), b.contiguous(), min(block_k, k)
    route = matmul_route(a, b, block_k)
    c = _launch(a, b, min(block_m, m), min(block_n, n), block_k, route)
    matmul_tiled.launches += 1
    setattr(matmul_tiled, f"launches_{route}",
            getattr(matmul_tiled, f"launches_{route}") + 1)
    return c


# launches of the CUDA kernels (plain-version calls are not counted): all,
# and by route
matmul_tiled.launches = 0
matmul_tiled.launches_wgmma = 0
matmul_tiled.launches_ragged = 0
matmul_tiled.launches_simt = 0
