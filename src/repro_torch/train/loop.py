"""Training loop: data -> train step -> metrics / checkpoints, with the
fault-tolerance hooks wired in (auto-resume, straggler log, watchdog,
injectable failures for tests): the port's ``repro.train.loop``, with an
eager step where JAX compiles one with ``jax.jit``."""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import (FaultInjector, HeartbeatWatchdog,
                                     StragglerDetector)
from repro_torch.train.step import (TrainHParams, init_train_state,
                                    make_train_step)

Tree = Any


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_last: int = 3
    seed: int = 0


def run_training(model: Model, hp: TrainHParams, loop: LoopConfig,
                 data: Iterator[Dict[str, np.ndarray]],
                 state: Optional[Tree] = None,
                 device_put: Optional[Callable] = None,
                 injector: Optional[FaultInjector] = None,
                 log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Returns {"state", "history", "resumed_from", "straggler_events"}.
    Without a ``state``, the model's weights are drawn from ``loop.seed``
    on its device and the newest intact checkpoint, if any, is resumed."""
    step_fn = make_train_step(model, hp)
    device = model.final_norm.device

    ckpt = (CheckpointManager(loop.checkpoint_dir, keep_last=loop.keep_last)
            if loop.checkpoint_dir else None)
    start_step = 0
    if state is None:
        gen = torch.Generator(device=device).manual_seed(loop.seed)
        state = init_train_state(model, hp, gen)
        if ckpt is not None:
            resumed, restored = ckpt.restore_latest(state, device=device)
            if restored is not None:
                state = restored
                start_step = resumed
                log(f"[loop] auto-resumed from step {resumed}")

    straggler = StragglerDetector()
    watchdog = HeartbeatWatchdog()
    history = []
    t_prev = time.perf_counter()
    try:
        for step in range(start_step, loop.total_steps):
            batch = next(data)
            if device_put is not None:
                batch = device_put(batch)
            if injector is not None:
                injector.maybe_fail(step)
            state, metrics = step_fn(state, batch)
            # block on the loss to get a truthful step time
            loss = float(metrics["loss"])
            now = time.perf_counter()
            dt = now - t_prev
            t_prev = now
            watchdog.beat()
            if straggler.observe(step, dt):
                log(f"[loop] straggler at step {step}: {dt:.3f}s "
                    f"(ema {straggler.ema:.3f}s)")
            if step % loop.log_every == 0 or step == loop.total_steps - 1:
                rec = {"step": step, "loss": loss,
                       "accuracy": float(metrics["accuracy"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "step_time_s": dt}
                history.append(rec)
                log(f"[loop] step {step}: loss={loss:.4f} "
                    f"acc={rec['accuracy']:.3f} gnorm={rec['grad_norm']:.2f} "
                    f"dt={dt:.2f}s")
            if ckpt is not None and (step + 1) % loop.checkpoint_every == 0:
                ckpt.save(step + 1, state)
    finally:
        # a crash (e.g. an injected node failure) must not lose an
        # in-flight async checkpoint write: the restart resumes from it
        if ckpt is not None:
            try:
                ckpt.wait()
            except RuntimeError:
                # only suppress while another exception is propagating: a
                # write failure on the normal path must surface
                if sys.exc_info()[0] is None:
                    raise
    if ckpt is not None:
        ckpt.save(loop.total_steps, state)
        ckpt.wait()
    return {"state": state, "history": history, "resumed_from": start_step,
            "straggler_events": straggler.events}
