"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference and stays as it is; this
package imports nothing of it (nor JAX) and keeps its own copies of the
framework-neutral layers (spaces, plans, profiles, tuners, the TuningDB),
so both compute identical spaces, plans, scores and DB keys.  Every Pallas
kernel on a ported path is a kernel written by hand for Hopper
(``csrc/``), with a plain PyTorch version of the same function beside it.

Ported so far: the paper's tuning loop on the prefix-sum scan
(``repro_torch.kernels.scan.ops.prefix_sum``); see ROADMAP.md for the rest.
"""
