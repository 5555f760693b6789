# Hand-written Hopper kernels (CUDA C++ in repro_torch/csrc) for the hot
# spots the paper tunes.  Each subpackage mirrors repro.kernels: kernel.py
# (the wrapper that launches the CUDA kernel, with its plain PyTorch
# version beside it), ops.py (the tuned entry point, declared with
# @repro_torch.tuning.tuned_kernel), ref.py (the library oracle).
