"""The port's distributed-config tuning (``repro_torch.core.
distributed_tuning``) against the JAX package's: JAX's own cases of
``tests/test_distributed_tuning.py`` on the port (the space, the
micro-step overhead, the objective and the tuner with a fake
``analyze_cell``), the numbers equal to JAX's under the ``tpu_v5e``
profile, the h100's 80 GiB memory guard, and the batch protocol's
conformance (``batch_eval`` equal to a sequential loop, as JAX's
``tests/test_objective_conformance.py`` holds for every objective)."""
import os

import jax
import numpy as np
import pytest

from repro.core import distributed_tuning as j_dt
from repro_torch.core import distributed_tuning as t_dt
from repro_torch.core.distributed_tuning import (CompiledRooflineObjective,
                                                 distributed_space,
                                                 micro_step_overhead_s,
                                                 step_time_from_record,
                                                 tune_distributed)
from repro_torch.core.objective import PENALTY_TIME
from repro_torch.hw.profiles import get_profile
from repro_torch.launch import roofline

jax.devices()   # the backend is up before the JAX module sets XLA_FLAGS
_FLAGS = os.environ.get("XLA_FLAGS")
import repro.launch.roofline as j_roofline  # noqa: E402

if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

V5E = get_profile("tpu_v5e")
H100 = get_profile("h100")
GRAD_BYTES_DEV = 8 * 2**20     # ~0.5b params / 256 chips, f32 accumulator


def test_space_enumerable():
    sp = distributed_space("granite-34b", "train_4k", is_moe=False,
                           is_train=True)
    cfgs = sp.enumerate_valid()
    assert len(cfgs) == 2 * 4 * 2 * 1
    sp2 = distributed_space("qwen3-moe-30b-a3b", "train_4k", is_moe=True)
    assert len(sp2.enumerate_valid()) == 2 * 4 * 2 * 3
    assert [dict(c) for c in sp2.enumerate_valid()] == [
        dict(c) for c in j_dt.distributed_space(
            "qwen3-moe-30b-a3b", "train_4k", is_moe=True).enumerate_valid()]


def test_serving_space_has_no_train_knobs():
    sp = distributed_space("gemma-2b", "decode_32k", is_train=False)
    for cfg in sp.enumerate_valid():
        assert cfg["micro_steps"] == 1 and cfg["remat"] == 1


def _fake_record(micro_steps: int) -> dict:
    # per-step bound mildly DECREASING in micro_steps (smaller activation
    # working set)
    t = 1.0e-3 * (1.0 - 4.0e-3 * micro_steps)
    return {"status": "ok", "chips": 256,
            "per_device": {"peak_bytes": 10 * 2**30},
            "roofline": {"compute_s": t, "memory_s": t / 2,
                         "collective_s": t / 4},
            "dominant": "compute_s",
            "step_time_bound_s": t}


@pytest.mark.parametrize("spec", [V5E, H100], ids=["tpu_v5e", "h100"])
def test_micro_step_overhead_charges_accumulation(spec):
    assert micro_step_overhead_s(1, GRAD_BYTES_DEV, spec) == 0.0
    o2 = micro_step_overhead_s(2, GRAD_BYTES_DEV, spec)
    o8 = micro_step_overhead_s(8, GRAD_BYTES_DEV, spec)
    assert 0 < o2 < o8
    # each extra micro step pays at least the grad-shard read-modify-write
    assert o8 >= 7 * 2 * GRAD_BYTES_DEV / spec.hbm_bandwidth


def test_overhead_and_step_time_under_tpu_v5e_equal_repro():
    base = {"sp": 0, "remat": 1, "moe_group": 1024}
    for m in (1, 2, 4, 8):
        assert micro_step_overhead_s(m, GRAD_BYTES_DEV, V5E) == \
            j_dt.micro_step_overhead_s(m, GRAD_BYTES_DEV)
        cfg = dict(base, micro_steps=m)
        assert step_time_from_record(_fake_record(m), cfg, GRAD_BYTES_DEV,
                                     V5E) == \
            j_dt.step_time_from_record(_fake_record(m), cfg, GRAD_BYTES_DEV)


def test_micro_steps_changes_objective_time():
    """Two micro_steps values must produce different objective times."""
    base = {"sp": 0, "remat": 1, "moe_group": 1024}
    rec2, rec8 = _fake_record(2), _fake_record(8)
    t2 = step_time_from_record(rec2, dict(base, micro_steps=2),
                               GRAD_BYTES_DEV)
    t8 = step_time_from_record(rec8, dict(base, micro_steps=8),
                               GRAD_BYTES_DEV)
    assert t2 != t8
    # the accumulation overhead outweighs the small activation-footprint
    # gain the raw bound shows
    assert t8 > t2
    assert rec8["step_time_bound_s"] < rec2["step_time_bound_s"]


def _patch(monkeypatch, fn):
    monkeypatch.setattr(roofline, "analyze_cell",
                        lambda arch, shape, multi_pod=False, arch_cfg=None,
                        hp=None, **kw: fn(hp))
    monkeypatch.setattr(j_roofline, "analyze_cell",
                        lambda arch, shape, multi_pod=False, arch_cfg=None,
                        hp=None: fn(hp))


@pytest.mark.parametrize("spec", [V5E, H100], ids=["tpu_v5e", "h100"])
def test_fixed_objective_changes_tune_distributed_winner(monkeypatch, spec):
    """The objective charges the accumulation cost, so the winner is
    micro_steps=1, not the raw bound's argmin at 8."""
    _patch(monkeypatch, lambda hp: _fake_record(
        hp.micro_steps if hp is not None else 1))
    res = tune_distributed("qwen1.5-0.5b", "train_4k", method="exhaustive",
                           profile=spec)
    broken_winner_micro = max(
        (1, 2, 4, 8), key=lambda m: -_fake_record(m)["step_time_bound_s"])
    assert broken_winner_micro == 8
    assert res.best_config["micro_steps"] == 1
    times_by_micro = {}
    for cfg, t in res.history:
        times_by_micro.setdefault(cfg["micro_steps"], set()).add(round(t, 12))
    assert len({min(v) for v in times_by_micro.values()}) == 4
    if spec is V5E:
        jres = j_dt.tune_distributed("qwen1.5-0.5b", "train_4k",
                                     method="exhaustive")
        assert dict(res.best_config) == dict(jres.best_config)
        assert res.best_time == jres.best_time
        assert [(dict(c), t) for c, t in res.history] == \
            [(dict(c), t) for c, t in jres.history]


def test_hbm_guard_still_penalizes(monkeypatch):
    def oom(peak):
        def fn(hp):
            rec = _fake_record(hp.micro_steps if hp is not None else 1)
            rec["per_device"]["peak_bytes"] = peak
            return rec
        return fn

    sp = distributed_space("qwen1.5-0.5b", "train_4k")
    cfg = sp.enumerate_valid()[0]
    # 32 GiB: over the v5e's 16 GiB as in JAX, inside the h100's 80 GiB
    _patch(monkeypatch, oom(32 * 2**30))
    m = CompiledRooflineObjective(profile=V5E)(sp, cfg)
    jm = j_dt.CompiledRooflineObjective()(sp, cfg)
    assert not m.valid and m.time_s > 60.0
    assert (m.time_s, m.valid) == (jm.time_s, jm.valid)
    assert CompiledRooflineObjective(profile=H100)(sp, cfg).valid
    _patch(monkeypatch, oom(96 * 2**30))
    m = CompiledRooflineObjective(profile=H100)(sp, cfg)
    assert not m.valid and m.time_s == PENALTY_TIME * 96 / 80
    assert t_dt.HBM_BYTES == 80 * 2**30 == H100.hbm_bytes


def test_a_failing_dry_run_gets_the_penalty(monkeypatch):
    def boom(hp):
        raise RuntimeError("dry-run failed")

    _patch(monkeypatch, boom)
    sp = distributed_space("qwen1.5-0.5b", "train_4k")
    m = CompiledRooflineObjective()(sp, sp.enumerate_valid()[0])
    assert (m.time_s, m.valid) == (PENALTY_TIME, False)


def test_batch_eval_bit_identical_to_sequential_loop(monkeypatch):
    """The conformance JAX holds for every objective: batch_eval (and its
    metric form) equal to a sequential __call__ loop, invalid mutants
    clamped, an empty set empty."""
    _patch(monkeypatch, lambda hp: _fake_record(
        hp.micro_steps if hp is not None else 1))
    space = distributed_space("qwen1.5-0.5b", "train_4k")
    rng = np.random.default_rng(20260802)
    cands = space.enumerate_valid()
    cfgs = [dict(cands[int(i)]) for i in rng.permutation(len(cands))[:6]]
    seq = np.array([m.time_s if m.valid else PENALTY_TIME for m in (
        CompiledRooflineObjective()(space, c) for c in cfgs)])
    batched = CompiledRooflineObjective().batch_eval(space, cfgs)
    assert batched.dtype == np.float64 and np.array_equal(seq, batched)
    cols = CompiledRooflineObjective().batch_eval_metrics(space, cfgs)
    assert np.array_equal(cols["time_s"], seq)
    assert len(CompiledRooflineObjective().batch_eval(space, [])) == 0
    assert CompiledRooflineObjective(profile=V5E).signature() != \
        CompiledRooflineObjective(profile=H100).signature()
