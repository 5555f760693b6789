"""Oracle for the tiled matmul kernel, as ``repro.kernels.matmul.ref``
defines it: one library product, in the inputs' type."""
import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)
