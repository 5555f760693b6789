"""Reference serving engine: the per-token replay/host-loop baseline.

The PyTorch port of ``repro.serve.reference``: the engine before the
throughput rework, kept as an executable specification.  It prefills a
prompt by replaying it one token at a time through the full-batch decode
step and round-trips tokens/positions/logits through host numpy on every
step — exactly the semantics the optimized engine must reproduce, at
exactly the cost it must beat:

  * ``tests/test_torch_serve_prefill.py`` proves the optimized engine's
    chunk prefill leaves the target slot's cache lanes **bit-identical**
    to this engine's replay, and that decoded tokens match end to end.
  * ``chip_smoke.py``'s ``[serve]`` phase holds the engine's greedy tokens
    to this engine's on a multi-tenant trace and times both.

Scheduling semantics are shared with the optimized engine (same
slot-based lockstep batching, same completion rules, same
submission-order ``run()`` contract, same ``finish_reason``); only the
execution strategy differs.  One deliberate difference: this engine runs
*every* batch lane through every replay/decode step, so inactive lanes'
recurrent/SSM state advances on padding work (harmless for KV caches,
whose stale tail is masked by position, but real cross-request pollution
for state-carrying archs) — the optimized engine lane-masks instead,
which is why state archs are compared one request at a time.

Sampling at ``temperature > 0`` draws on the host with
``np.random.default_rng(seed)``, as in JAX, from the row of logits it is
given.  Like JAX's, ``_decode_step`` hands it the (1, V) row of a
(B, 1, V) decode, which ``Generator.choice`` refuses (``p`` must be
one-dimensional): a run at ``temperature > 0`` raises in both packages.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.serve.engine import (FINISH_LENGTH, FINISH_STOP, Request,
                                      _model_device)


class ReferenceEngine:
    """Seed-semantics engine: O(prompt_len) replay prefill, host-loop decode."""

    def __init__(self, model: Model, *, max_batch: int = 8,
                 max_len: int = 512, temperature: float = 0.0, seed: int = 0,
                 step_timer: Optional[Callable[[], float]] = None,
                 cache_dtype: torch.dtype = torch.float32):
        self.model = model
        self.device = _model_device(model)
        self.max_batch = max_batch
        self.max_len = max_len
        self.temperature = temperature
        self.rng = np.random.default_rng(seed)
        self.cache = model.init_cache(max_batch, max_len, dtype=cache_dtype)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        self.step_timer: Callable[[], float] = step_timer or time.perf_counter
        self._step_index = 0

    # -- public API --
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> int:
        prompt = np.asarray(prompt, np.int32)
        if prompt.size == 0:
            raise ValueError("empty prompt: need at least one token")
        rid = len(self.queue) + len(self.completed) + sum(
            r is not None for r in self.slot_req)
        self.queue.append(Request(rid, prompt, max_new_tokens))
        return rid

    @torch.inference_mode()
    def run(self, max_steps: int = 1000) -> List[Request]:
        """Serve until the queue drains; results in submission order."""
        steps = 0
        while (self.queue or any(self.slot_req)) and steps < max_steps:
            self._admit()
            self._decode_step()
            self._step_index += 1
            steps += 1
        return sorted(self.completed, key=lambda r: r.rid)

    # -- internals --
    def _decode(self, tokens: np.ndarray, poss: np.ndarray) -> torch.Tensor:
        logits, self.cache = self.model.decode_step(
            torch.as_tensor(tokens, device=self.device), self.cache,
            torch.as_tensor(poss, device=self.device))
        return logits

    @torch.inference_mode()
    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None:
                continue
            while self.queue:
                req = self.queue.pop(0)
                if np.asarray(req.prompt).size == 0:
                    req.done = True
                    req.finish_reason = FINISH_STOP
                    self.completed.append(req)
                    continue
                self.slot_req[slot] = req
                # replay prompt through decode to build this slot's cache
                for t, tok in enumerate(req.prompt[:-1]):
                    self._step_slot(slot, int(tok), t)
                self.slot_pos[slot] = len(req.prompt) - 1
                break

    def _step_slot(self, slot: int, token: int, pos: int) -> int:
        """Single-slot step via the batched decode step (other slots run
        their current token as padding work — lockstep batching)."""
        tokens = np.zeros((self.max_batch, 1), np.int32)
        poss = np.maximum(self.slot_pos[:, None], 0).astype(np.int32)
        tokens[slot, 0] = token
        poss[slot, 0] = pos
        logits = self._decode(tokens, poss)
        return int(np.argmax(logits.cpu().numpy()[slot]))

    def _sample(self, logits_row: np.ndarray) -> int:
        if self.temperature <= 0:
            return int(np.argmax(logits_row))
        z = logits_row / self.temperature
        z = z - z.max()
        p = np.exp(z) / np.exp(z).sum()
        return int(self.rng.choice(len(p), p=p))

    def _decode_step(self) -> None:
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return
        tokens = np.zeros((self.max_batch, 1), np.int32)
        poss = np.maximum(self.slot_pos[:, None], 0).astype(np.int32)
        for s in active:
            req = self.slot_req[s]
            last = (req.output[-1] if req.output
                    else int(req.prompt[-1]))
            tokens[s, 0] = last
        logits = self._decode(tokens, poss).cpu().numpy()
        for s in active:
            req = self.slot_req[s]
            nxt = self._sample(logits[s])
            req.output.append(nxt)
            self.slot_pos[s] += 1
            if (len(req.output) >= req.max_new_tokens
                    or self.slot_pos[s] >= self.max_len - 1):
                req.done = True
                req.finish_reason = (
                    FINISH_STOP if len(req.output) >= req.max_new_tokens
                    else FINISH_LENGTH)
                self.completed.append(req)
                self.slot_req[s] = None
