"""Fault tolerance: step watchdog, straggler detection, elastic re-mesh
(the port's own copy of ``repro.train.fault``, verbatim: plain Python).

On a real pod these hooks pair with the cluster coordinator (preemption
signals, ICI health). In this repo the logic is deterministic and fully
unit-tested with simulated clocks:

  * HeartbeatWatchdog — flags a stalled step when no heartbeat lands within
    `timeout x EMA(step_time)`; the loop responds by checkpoint-and-raise
    (so the job restarts from the last manifest instead of hanging).
  * StragglerDetector — per-step EMA; a step slower than `threshold x EMA`
    is a straggler event. Policy "log" | "abort" (abort -> restart path).
  * ElasticPlan — given a shrunken device set, recompute the largest mesh
    that preserves the model axis (TP cannot shrink without resharding
    weights layouts; the data axis absorbs losses), and report the
    new global batch so the data pipeline can rescale.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple


class StragglerDetector:
    def __init__(self, threshold: float = 2.5, ema_alpha: float = 0.2,
                 warmup_steps: int = 5):
        self.threshold = threshold
        self.alpha = ema_alpha
        self.warmup = warmup_steps
        self.ema: Optional[float] = None
        self.seen = 0
        self.events: List[Tuple[int, float, float]] = []

    def observe(self, step: int, step_time: float) -> bool:
        """Returns True if this step is a straggler."""
        self.seen += 1
        if self.ema is None:
            self.ema = step_time
            return False
        is_straggler = (self.seen > self.warmup
                        and step_time > self.threshold * self.ema)
        if is_straggler:
            self.events.append((step, step_time, self.ema))
        else:
            # stragglers don't poison the EMA
            self.ema = (1 - self.alpha) * self.ema + self.alpha * step_time
        return is_straggler


class HeartbeatWatchdog:
    """Deadline tracker (pure logic — poll() is called by the supervisor)."""

    def __init__(self, timeout_factor: float = 5.0, min_timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.factor = timeout_factor
        self.min_timeout = min_timeout
        self.clock = clock
        self.last_beat = clock()
        self.ema: Optional[float] = None

    def beat(self) -> None:
        now = self.clock()
        dt = now - self.last_beat
        self.ema = dt if self.ema is None else 0.8 * self.ema + 0.2 * dt
        self.last_beat = now

    def deadline(self) -> float:
        base = self.ema if self.ema is not None else self.min_timeout
        return max(self.factor * base, self.min_timeout)

    def poll(self) -> bool:
        """True -> stalled (no heartbeat within the deadline)."""
        return (self.clock() - self.last_beat) > self.deadline()


@dataclasses.dataclass
class ElasticPlan:
    data_axis: int
    model_axis: int
    pod_axis: int
    global_batch: int
    dropped_chips: int


def plan_elastic_remesh(available_chips: int, model_axis: int,
                        target_batch: int, pods: int = 1) -> ElasticPlan:
    """Largest (pod, data, model) mesh from the surviving chips.

    Keeps the model axis fixed (weight layouts stay valid so restore is a
    straight load), shrinks data parallelism to the largest fit, and scales
    the global batch to keep per-replica batch constant.
    """
    if available_chips < model_axis:
        raise ValueError(
            f"cannot keep model_axis={model_axis} with only "
            f"{available_chips} chips; full resharding required")
    per_pod = available_chips // pods
    data = max(per_pod // model_axis, 1)
    used = pods * data * model_axis
    # per-replica batch when healthy: target_batch / (pods*data_healthy)
    new_batch = target_batch * (pods * data) // max(pods * data, 1)
    # keep divisibility: round batch down to a multiple of replicas
    replicas = pods * data
    new_batch = max((target_batch // replicas) * replicas, replicas)
    return ElasticPlan(data_axis=data, model_axis=model_axis, pod_axis=pods,
                       global_batch=new_batch,
                       dropped_chips=available_chips - used)


class FaultInjector:
    """Deterministic failure schedule for tests/examples: raises at the
    configured steps to exercise checkpoint-restart."""

    def __init__(self, fail_at_steps: Tuple[int, ...] = ()):
        self.fail_at = set(fail_at_steps)
        self.fired = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")
