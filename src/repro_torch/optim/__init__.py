"""Optimizers, schedules, clipping and gradient compression of the port
(``repro.optim``), over trees of tensors in the JAX package's layout
(``models.convert.param_tree``)."""
from repro_torch.optim.adamw import adamw, AdamWState
from repro_torch.optim.adafactor import adafactor, AdafactorState
from repro_torch.optim.schedule import warmup_cosine, constant
from repro_torch.optim.clip import clip_by_global_norm, global_norm
