"""Plain references that decide ``correct``: plain PyTorch, float64 /
complex128 for the prefix operations and float32 with TF32 off for the
model.  Nothing here imports ``jax``, ``repro`` or ``repro_torch``, and
nothing takes what the program made: a driver hands both sides the same
inputs and weights, and the reference works out again everything the
program derives from them.  Each reference also computes its control:
itself at the precision one step below the one the configuration states.
"""
