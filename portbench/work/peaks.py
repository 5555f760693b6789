"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at its 700 W limit)."""
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 on the CUDA cores
BF16_FLOPS = 989e12        # dense bf16 on the tensor cores


def least_s(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS
            ) -> float:
    """The least time the chip could take: bytes at the memory rate or
    operations at the compute rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)
