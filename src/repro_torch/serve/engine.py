"""Serving engine: batched chunk prefill + a fused decode loop.

The PyTorch port of ``repro.serve.engine``.  A slot-based
continuous-batching scheduler: the engine owns ``max_batch`` slots, each
slot one lane of the KV/state cache.

* **Prefill** writes a prompt's KV/state into its slot's cache lanes via
  :meth:`repro_torch.models.model.Model.prefill`, a chunk of up to
  ``prefill_chunk`` prompt tokens a call.  All newly admitted slots
  prefill *together* (per-lane write masks let lanes with different
  prompt lengths share the chunk), so a burst of admissions pays
  ``ceil(max(prompt_len) / chunk)`` prefill calls rather than
  ``sum(prompt_len)``.  Per-lane results are bit-identical to the
  per-token replay path (:class:`repro_torch.serve.reference.ReferenceEngine`).
  Chunk lengths stay powers of two, as in JAX (where they bound jit
  retraces), so that ``prefill_calls`` is the JAX engine's on the same
  trace.
* **Decode** is one fused step over device-resident state: tokens,
  positions, per-slot active flags, remaining-token budgets and the
  sampling generator all live on the model's device; sampling (argmax,
  or a Gumbel-max draw at ``temperature > 0``) happens inside the step,
  which emits a (B, 2) int32 row — [token or -1, finish code] — and the
  host reads at most one small transfer per step.  With no listeners the
  rows are harvested in batches of ``harvest_every`` steps (one
  ``torch.stack``, one ``.cpu()``), letting launches run ahead.
* **Admission** pops a :class:`collections.deque` under a
  ``max_prefill_tokens``-per-step budget, so one long prompt cannot
  starve active decoders: prefill yields to decode between chunks.

Inactive/prefilling lanes ride decode and prefill calls as padding work
but are *lane-masked out* of every cache merge, so their recurrent/SSM
state never advances on padding steps; a freed lane is reset to its
*init* value (a batch-1 template: ring-buffer position leaves start at
-2^30, not 0) before its next tenant prefills.

Where the port differs from JAX, by design:

* Weights live in the module (``ServeEngine(model, ...)``, no
  ``params``), and every step runs under ``torch.inference_mode()``.
* There is no donation: the port's ``decode_step`` returns a new cache,
  so a step holds the old and the new cache until the merge.
* At ``temperature > 0`` the draw comes from a ``torch.Generator`` on
  the model's device seeded by ``seed`` (deterministic for a seed, but
  not ``jax.random.categorical``'s stream); ``temperature == 0`` is
  argmax, as in JAX.
* No decode-variant table: JAX jit-traces one step per override
  fragment (``_DecodeVariant``, LRU-capped by ``max_variants``) because
  a traced step bakes its configs in.  An eager step resolves configs on
  every call, so the override provider's fragment, applied around each
  engine step through the thread-local override stack exactly as in
  JAX, reaches the kernels without one.  ``max_variants`` keeps JAX's
  argument check.

Online-tuning hooks (see ``repro_torch.tuning.online``): an injectable
``step_timer``, per-step :class:`StepRecord` reports to listeners (a
timed engine harvests every step, so the duration covers real device
work) and an override provider.  With no listeners the loop takes the
untimed path and never reads the timer.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.models.model import Model, _merge
from repro_torch.tuning.overrides import overrides as _tuning_overrides

FINISH_STOP = "stop"        # produced max_new_tokens naturally
FINISH_LENGTH = "length"    # truncated at the cache ceiling (max_len - 1)
# device-side finish codes in the harvested (B, 2) row; 0 = still going.
# "stop" wins when a request hits both bounds on the same token.
_FINISH_REASONS = {1: FINISH_STOP, 2: FINISH_LENGTH}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (len,) int32
    max_new_tokens: int = 16
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None   # "stop" | "length" once done


@dataclasses.dataclass(frozen=True)
class StepRecord:
    """One timed decode step, as reported to step listeners."""

    index: int          # monotonically increasing decode-step counter
    duration_s: float   # wall-clock (or fake-clock) duration of the step
    active: int         # slots that were occupied during the step


def _model_device(model: Model) -> torch.device:
    return next(model.parameters()).device


def _new_state(batch: int, device: torch.device, seed: int) -> Dict:
    """Fresh device-resident token state; ``gen`` is the sampling stream."""
    return {"tokens": torch.zeros((batch, 1), dtype=torch.int32,
                                  device=device),
            "pos": torch.zeros((batch, 1), dtype=torch.int32, device=device),
            "active": torch.zeros((batch,), dtype=torch.bool, device=device),
            "remaining": torch.zeros((batch,), dtype=torch.int32,
                                     device=device),
            "gen": torch.Generator(device=device).manual_seed(seed)}


def _decode_step(model: Model, temperature: float, max_len: int,
                 cache, state):
    """Fused decode step: decode + sample + bookkeeping.

    Returns the merged cache, the new state and the (B, 2) int32 row —
    [sampled token or -1, finish code] — the only thing the host ever
    needs to read back.
    """
    tokens, pos, active = state["tokens"], state["pos"], state["active"]
    logits, new_cache = model.decode_step(tokens, cache, pos)
    row = logits.reshape((tokens.shape[0], -1))
    if temperature > 0.0:
        # Gumbel-max, the draw jax.random.categorical makes, from the
        # engine's own generator
        u = torch.rand(row.shape, generator=state["gen"], device=row.device)
        gumbel = -torch.log(-torch.log(
            u.clamp_min(torch.finfo(torch.float32).tiny)))
        nxt = torch.argmax(row.float() / temperature + gumbel, dim=-1)
    else:
        nxt = torch.argmax(row, dim=-1)
    nxt = nxt.to(torch.int32)
    act = active.to(torch.int32)
    none = torch.full_like(nxt, -1)
    emitted = torch.where(active, nxt, none)
    new_tokens = torch.where(active, nxt, tokens[:, 0])[:, None]
    new_pos = pos + act[:, None]
    remaining = state["remaining"] - act
    hit_stop = remaining <= 0
    hit_len = new_pos[:, 0] >= max_len - 1
    finished = active & (hit_stop | hit_len)
    codes = torch.where(finished, torch.where(hit_stop, 1, 2), 0).to(
        torch.int32)
    out = torch.stack([emitted, codes], dim=-1)
    # inactive lanes keep their cache/state bit-exactly: padding compute
    # never pollutes a parked or prefilling tenant
    merged = _merge(new_cache, cache, active)
    new_state = {"tokens": new_tokens, "pos": new_pos,
                 "active": active & ~finished, "remaining": remaining,
                 "gen": state["gen"]}
    return merged, new_state, out


def _activate(state: Dict, mask, tok, pos, rem) -> Dict:
    """Full-batch masked update of the token state (one shape whatever the
    admission group's size, as in JAX)."""
    return {"tokens": torch.where(mask[:, None], tok[:, None],
                                  state["tokens"]),
            "pos": torch.where(mask[:, None], pos[:, None], state["pos"]),
            "active": state["active"] | mask,
            "remaining": torch.where(mask, rem, state["remaining"]),
            "gen": state["gen"]}


def _pow2_chunk(need: int, cap: int) -> int:
    """Smallest power-of-two chunk length covering ``need``, capped."""
    c = 1
    while c < need and c < cap:
        c *= 2
    return min(c, cap)


class ServeEngine:
    def __init__(self, model: Model, *, max_batch: int = 8,
                 max_len: int = 512, temperature: float = 0.0, seed: int = 0,
                 step_timer: Optional[Callable[[], float]] = None,
                 prefill_chunk: int = 32, harvest_every: int = 4,
                 max_prefill_tokens: Optional[int] = None,
                 admit_threshold: int = 1, max_variants: int = 8,
                 cache_dtype: torch.dtype = torch.float32):
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if harvest_every < 1:
            raise ValueError(f"harvest_every must be >= 1, got {harvest_every}")
        if not 1 <= admit_threshold <= max_batch:
            raise ValueError(f"admit_threshold must be in [1, {max_batch}], "
                             f"got {admit_threshold}")
        if max_variants < 2:
            # JAX's bound: its table holds the pinned baseline + one live
            # variant
            raise ValueError(f"max_variants must be >= 2, got {max_variants}")
        self.model = model
        self.device = _model_device(model)
        self.max_batch = max_batch
        self.max_len = max_len
        self.temperature = temperature
        self.prefill_chunk = prefill_chunk
        self.harvest_every = harvest_every
        self.max_prefill_tokens = max_prefill_tokens
        # throughput knob: hold admissions until this many slots are free,
        # so co-admitted prompts share prefill chunks (1 = admit eagerly,
        # latency-first)
        self.admit_threshold = admit_threshold
        self.max_variants = max_variants
        self.cache_dtype = cache_dtype
        self.cache = model.init_cache(max_batch, max_len, dtype=cache_dtype)
        self._cache_template = model.init_cache(1, max_len, dtype=cache_dtype)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)
        self._state = _new_state(max_batch, self.device, seed)
        self.queue: Deque[Request] = collections.deque()
        self.completed: List[Request] = []
        # slot -> prompt tokens already written (mid-prefill slots)
        self._prefilling: Dict[int, int] = {}
        self._pending_out: List[torch.Tensor] = []
        # perf counters (read by chip_smoke.py and the tests)
        self.prefill_calls = 0        # Model.prefill calls
        self.host_transfers = 0       # device->host reads (via _fetch)
        # -- step hooks (timing is only paid when a listener is registered)
        self.step_timer: Callable[[], float] = step_timer or time.perf_counter
        self._step_listeners: List[Callable[[StepRecord], None]] = []
        self._override_provider: Optional[
            Callable[[], Optional[Mapping[str, Mapping[str, int]]]]] = None
        self._step_index = 0

    def add_step_listener(self, fn: Callable[[StepRecord], None]) -> None:
        """Register a callback invoked after every timed decode step."""
        self._step_listeners.append(fn)

    def set_override_provider(
            self, fn: Optional[
                Callable[[], Optional[Mapping[str, Mapping[str, int]]]]],
    ) -> None:
        """Install a provider of per-op config overrides, consulted before
        each step and applied (via the thread-local override stack) around
        it — how an online tuner's active trial reaches the kernels."""
        self._override_provider = fn

    # -- public API --
    @torch.inference_mode()
    def warmup(self) -> None:
        """Run the decode step, every prefill chunk length and the
        admission helpers once on throwaway buffers (the kernels' builds
        and the allocator's first blocks land here, not in traffic).
        Engine state, caches and the sampling stream are untouched."""
        cache = self.model.init_cache(self.max_batch, self.max_len,
                                      dtype=self.cache_dtype)
        state = _new_state(self.max_batch, self.device, 0)
        cache, state, out = _decode_step(self.model, self.temperature,
                                         self.max_len, cache, state)
        c = 1
        while True:
            toks = torch.zeros((c, self.max_batch), dtype=torch.int32,
                               device=self.device)
            writes = torch.zeros((c, self.max_batch), dtype=torch.bool,
                                 device=self.device)
            cache = self.model.prefill(toks, cache, toks, writes)
            if c >= self.prefill_chunk:
                break
            c = min(c * 2, self.prefill_chunk)
        mask = torch.zeros((self.max_batch,), dtype=torch.bool,
                           device=self.device)
        zeros = torch.zeros((self.max_batch,), dtype=torch.int32,
                            device=self.device)
        state = _activate(state, mask, zeros, zeros, zeros)
        cache = _merge(self._cache_template, cache, mask)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> int:
        prompt = np.asarray(prompt, np.int32)
        if prompt.size == 0:
            # an empty prompt has no last token to decode from; reject at
            # the door instead of poisoning the batch
            raise ValueError("empty prompt: need at least one token")
        rid = len(self.queue) + len(self.completed) + sum(
            r is not None for r in self.slot_req)
        self.queue.append(Request(rid, prompt, max_new_tokens))
        return rid

    @torch.inference_mode()
    def run(self, max_steps: int = 1000) -> List[Request]:
        """Serve until the queue drains (or ``max_steps``).

        Returns completed requests in **submission order** (ascending
        ``rid``); ``self.completed`` keeps completion order.
        """
        steps = 0
        while (self.queue or any(self.slot_req)) and steps < max_steps:
            ov = self._override_provider() if self._override_provider else None
            ctx = _tuning_overrides(**ov) if ov else contextlib.nullcontext()
            with ctx:
                self._admit()
                active = sum(r is not None for r in self.slot_req)
                if self._step_listeners and active:
                    # timed mode: harvest inside the timed window so the
                    # duration covers the device step (not just its async
                    # launch) — exactly two timer reads per step
                    t0 = self.step_timer()
                    self._dispatch_step()
                    self._harvest()
                    record = StepRecord(self._step_index,
                                        self.step_timer() - t0, active)
                    for listener in self._step_listeners:
                        listener(record)
                else:
                    self._dispatch_step()
                    if len(self._pending_out) >= self.harvest_every:
                        self._harvest()
            self._step_index += 1
            steps += 1
        self._harvest()
        return sorted(self.completed, key=lambda r: r.rid)

    # -- internals --
    def _fetch(self, x: torch.Tensor) -> np.ndarray:
        """The one device->host chokepoint (counted; fake-able in tests)."""
        self.host_transfers += 1
        return x.cpu().numpy()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- harvest: drain emitted tokens back to host ------------------------

    def _harvest(self) -> None:
        if not self._pending_out:
            return
        outs, self._pending_out = self._pending_out, []
        rows = self._fetch(torch.stack(outs))     # (k, B, 2), ONE transfer
        for row in rows:
            for s, req in enumerate(self.slot_req):
                if req is None:
                    continue
                tok, code = int(row[s, 0]), int(row[s, 1])
                if tok < 0:
                    continue        # lane was prefilling / already finished
                req.output.append(tok)
                self.slot_pos[s] += 1
                if code:
                    req.done = True
                    req.finish_reason = _FINISH_REASONS[code]
                    self.completed.append(req)
                    self.slot_req[s] = None

    # -- admission + prefill ----------------------------------------------

    @torch.inference_mode()
    def _admit(self) -> None:
        if self.queue and self._pending_out and (
                len(self._pending_out) >= self.harvest_every
                or not self._any_decoding()):
            # a backlog is waiting on freed slots: sync the host view.
            # (Prefill itself tolerates stale mirrors — padding lanes are
            # write-masked — so no other path forces an early harvest.)
            self._harvest()
        free = [s for s in range(self.max_batch) if self.slot_req[s] is None]
        busy = self.max_batch - len(free)
        # hold admissions until a worthwhile prefill group has formed;
        # with nothing in flight there is no reason (or way) to wait
        want = min(self.admit_threshold, len(self.queue)) if busy else 1
        if not self.queue or len(free) < want:
            self._run_prefill()
            return
        newly: List[int] = []
        for slot in free:
            while self.queue:
                req = self.queue.popleft()
                if np.asarray(req.prompt).size == 0:
                    # hand-built Request bypassing submit(): complete it
                    # empty rather than poisoning the whole batch
                    req.done = True
                    req.finish_reason = FINISH_STOP
                    self.completed.append(req)
                    continue
                self.slot_req[slot] = req
                self.slot_pos[slot] = 0
                self._prefilling[slot] = 0
                newly.append(slot)
                break
        if newly:
            # evict the previous tenant's state from the reused lanes in
            # one merge (stale KV is position-masked anyway, but
            # SSM/recurrent state is not position-indexed)
            mask = np.zeros(self.max_batch, bool)
            mask[newly] = True
            self.cache = _merge(self._cache_template, self.cache,
                                self._tensor(mask))
        self._run_prefill()

    def _run_prefill(self) -> None:
        """Advance all mid-prefill slots, chunked and budgeted.

        Every pending slot shares each chunk (per-lane write masks), so a
        burst of admissions costs ceil(max(prompt_len)/chunk) calls, not
        sum(prompt_len).  At most ``max_prefill_tokens`` prompt tokens are
        written per engine step (always at least one chunk, so long
        prompts keep making progress), then control returns to the decode
        loop — active slots never starve behind a long prompt.
        """
        budget = self.max_prefill_tokens
        spent = 0
        while self._prefilling:
            ready = [s for s, filled in self._prefilling.items()
                     if filled >= len(self.slot_req[s].prompt) - 1]
            if ready:
                self._activate_slots(ready)
            if not self._prefilling:
                break
            if budget is not None and spent >= budget:
                break
            need = {s: len(self.slot_req[s].prompt) - 1 - filled
                    for s, filled in self._prefilling.items()}
            c = _pow2_chunk(max(need.values()), self.prefill_chunk)
            toks = np.zeros((c, self.max_batch), np.int32)
            poss = np.tile(np.maximum(self.slot_pos, 0).astype(np.int32),
                           (c, 1))
            writes = np.zeros((c, self.max_batch), bool)
            for s, n in need.items():
                filled = self._prefilling[s]
                take = min(c, n)
                prompt = self.slot_req[s].prompt
                idx = np.arange(take)
                toks[idx, s] = prompt[filled:filled + take]
                poss[idx, s] = filled + idx
                if take < c:
                    # masked tail steps: hold a valid position, write=False
                    poss[take:, s] = max(filled + take - 1, 0)
                writes[:take, s] = True
                self._prefilling[s] = filled + take
                spent += take
            self.cache = self.model.prefill(
                self._tensor(toks), self.cache, self._tensor(poss),
                self._tensor(writes))
            self.prefill_calls += 1

    def _activate_slots(self, slots: List[int]) -> None:
        """Prompts fully written: arm the lanes to decode from their last
        token, one update for the whole group (a 1-token prompt activates
        with no prefill at all)."""
        mask = np.zeros(self.max_batch, bool)
        toks = np.zeros(self.max_batch, np.int32)
        poss = np.zeros(self.max_batch, np.int32)
        rems = np.zeros(self.max_batch, np.int32)
        for slot in slots:
            req = self.slot_req[slot]
            plen = len(req.prompt)
            self.slot_pos[slot] = plen - 1
            del self._prefilling[slot]
            mask[slot] = True
            toks[slot] = int(req.prompt[-1])
            poss[slot] = plen - 1
            rems[slot] = req.max_new_tokens
        self._state = _activate(self._state, self._tensor(mask),
                                self._tensor(toks), self._tensor(poss),
                                self._tensor(rems))

    # -- decode ------------------------------------------------------------

    def _any_decoding(self) -> bool:
        return any(r is not None and s not in self._prefilling
                   for s, r in enumerate(self.slot_req))

    def _dispatch_step(self) -> None:
        if not self._any_decoding():
            return
        self.cache, self._state, out = _decode_step(
            self.model, self.temperature, self.max_len, self.cache,
            self._state)
        self._pending_out.append(out)
