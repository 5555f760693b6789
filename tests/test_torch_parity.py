"""The port's numpy layers against the JAX package's: spaces, plans,
analytical scores and cost-model times must be identical — the port keeps
its own copies of that arithmetic, so any drift is a porting bug.

Compared exactly (no tolerance): both sides run the same numpy/Python
arithmetic on the same inputs.
"""
import dataclasses
import importlib

import numpy as np
import pytest

from repro.core import analytical as j_analytical
from repro.core import objective as j_objective
from repro.core import space as j_space
from repro.kernels.blocks import plan as j_plan
from repro_torch.core import analytical as t_analytical
from repro_torch.core import objective as t_objective
from repro_torch.core import space as t_space
from repro_torch.kernels.blocks import plan as t_plan

# the packages' hw/__init__ re-export a ``profiles()`` function that
# shadows the submodule attribute, so fetch the modules themselves
j_profiles = importlib.import_module("repro.hw.profiles")
t_profiles = importlib.import_module("repro_torch.hw.profiles")

PROFILES = ("tpu_v5e", "gpu_sm", "cpu_interpret")
WORKLOADS = [(variant, n, batch) for variant in ("ks", "lf")
             for n in (96, 256, 1024, 4096) for batch in (3, 7, 64)]


TRIDIAG_WORKLOADS = [(variant, n, batch)
                     for variant in ("pcr", "cr", "lf", "wm", "thomas")
                     for n in (2, 96, 100, 256, 1024) for batch in (3, 64)]


def _pair(variant, n, batch, dtype="float32", op="scan"):
    return (j_space.Workload(op=op, n=n, batch=batch, dtype=dtype,
                             variant=variant),
            t_space.Workload(op=op, n=n, batch=batch, dtype=dtype,
                             variant=variant))


def _assert_same(profile, jwl, twl, cfgs=None):
    """The op's space, every plan, score and cost-model time, equal."""
    jp, tp = j_profiles.get_profile(profile), t_profiles.get_profile(profile)
    builder = f"{jwl.op}_space"
    jsp = getattr(j_space, builder)(jwl, jp)
    tsp = getattr(t_space, builder)(twl, tp)
    valid = jsp.enumerate_valid()
    assert valid == tsp.enumerate_valid()
    assert [jsp.encode(c) for c in valid] == [tsp.encode(c) for c in valid]
    jcost, tcost = j_objective.CostModelObjective(jp), \
        t_objective.CostModelObjective(tp)
    assert jcost.signature() == tcost.signature()
    for cfg in (cfgs if cfgs is not None else valid):
        jplan = j_plan.plan_for(jwl, cfg, profile=jp)
        tplan = t_plan.plan_for(twl, cfg, profile=tp)
        assert dataclasses.asdict(jplan) == dataclasses.asdict(tplan), cfg
        assert jplan.resources() == tplan.resources()
        assert j_analytical.score(jsp, cfg).key() \
            == t_analytical.score(tsp, cfg).key()
        jm, tm = jcost(jsp, cfg), tcost(tsp, cfg)
        assert (jm.time_s, jm.valid, jm.metrics, jm.meta) \
            == (tm.time_s, tm.valid, tm.metrics, tm.meta), cfg
    if valid:
        jcols = jcost.batch_eval_metrics(jsp, valid)
        tcols = tcost.batch_eval_metrics(tsp, valid)
        assert sorted(jcols) == sorted(tcols)
        for name in jcols:
            np.testing.assert_array_equal(jcols[name], tcols[name])
        assert j_analytical.AnalyticalTuner().suggest(jsp) \
            == t_analytical.AnalyticalTuner().suggest(tsp)
    return valid


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("variant,n,batch", WORKLOADS)
def test_space_plan_score_cost_identical(profile, variant, n, batch):
    jwl, twl = _pair(variant, n, batch)
    assert _assert_same(profile, jwl, twl)


@pytest.mark.parametrize("profile", PROFILES)
def test_bf16_space_identical(profile):
    jwl, twl = _pair("ks", 1024, 64, dtype="bfloat16")
    assert _assert_same(profile, jwl, twl)


@pytest.mark.parametrize("profile", PROFILES)
def test_multipass_plan_identical(profile):
    """n = 2^16 with tile_n = 256 has 256 column tiles > DEFAULT_SEQ_LIMIT:
    the three-launch plan, on both sides, for every radix and unroll."""
    jwl, twl = _pair("ks", 2 ** 16, 16)
    cfgs = [{"tile_n": 256, "rows_per_program": rows, "radix": radix,
             "unroll": unroll, "in_register": 0}
            for rows in (1, 8) for radix in (2, 4, 8) for unroll in (1, 8)]
    _assert_same(profile, jwl, twl, cfgs)
    plan = t_plan.plan_for(twl, cfgs[0], profile=t_profiles.get_profile(
        profile))
    assert plan.kind == "multipass"
    assert [l.name for l in plan.launches] == ["chunk-scan", "carry-scan",
                                               "apply-entry"]


@pytest.mark.parametrize("radix", range(2, 17))
def test_stage_radices_identical(radix):
    for n in range(1, 400):
        stages = t_plan.stage_radices(n, radix)
        assert stages == j_plan.stage_radices(n, radix)
        assert t_plan.stage_strides(stages) == j_plan.stage_strides(stages)
        assert int(np.prod(stages)) == n


@pytest.mark.parametrize("profile", PROFILES)
def test_shared_profiles_carry_the_jax_values(profile):
    jp, tp = j_profiles.get_profile(profile), t_profiles.get_profile(profile)
    for field in dataclasses.fields(jp):
        assert getattr(tp, field.name) == getattr(jp, field.name), field.name


def test_h100_profile_is_the_port_default(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_HW_PROFILE", raising=False)
    h100 = t_profiles.active_profile()
    assert h100.name == "h100" and h100.sm_count == 132
    # the port's registry is its own: the JAX package never sees h100
    assert "h100" not in j_profiles.profiles()


def test_h100_vmem_budget_fits_the_kernel_footprint():
    """Every config scan_space admits under h100 fits the CUDA kernel's real
    shared memory (an f32 tile + the f32 row carry, whatever the input
    type) and its 32768-element staging limit."""
    h100 = t_profiles.get_profile("h100")
    for dtype in ("float32", "bfloat16"):
        for n, batch in ((96, 2 ** 16), (128, 2 ** 19), (1024, 2 ** 16),
                         (2 ** 15, 2 ** 11), (2 ** 22, 16)):
            wl = t_space.Workload(op="scan", n=n, batch=batch, dtype=dtype,
                                  variant="ks")
            for cfg in t_space.scan_space(wl, h100).enumerate_valid():
                elems = cfg["rows_per_program"] * cfg["tile_n"]
                assert elems <= 32768
                assert 4 * (elems + cfg["rows_per_program"]) <= 232448


@pytest.mark.parametrize("n,batch,kind", [
    (128, 2 ** 19, "fused"), (1024, 2 ** 16, "fused"),
    (4096, 2 ** 14, "fused"), (2 ** 22, 16, "multipass")])
def test_h100_main_path_plans(n, batch, kind):
    """The paper-size workloads chip_smoke.py drives resolve, under h100,
    to fused plans up to n = 4096 and to the multipass driver at 2^22."""
    h100 = t_profiles.get_profile("h100")
    wl = t_space.Workload(op="scan", n=n, batch=batch, variant="ks")
    cfg = t_analytical.AnalyticalTuner().suggest(t_space.scan_space(wl, h100))
    plan = t_plan.plan_for(wl, cfg, profile=h100)
    assert plan.kind == kind
    assert plan.check(h100) == []


def test_other_ops_are_not_ported_yet():
    wl = t_space.Workload(op="fft", n=256, batch=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_space.build_space(wl)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_plan.build_plan(wl, {})


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("variant,n,batch", TRIDIAG_WORKLOADS)
def test_tridiag_space_plan_score_cost_identical(profile, variant, n, batch):
    """tridiag_space, _tridiag_plan, the analytical scores and the
    cost-model times (scalar and batched) for every solver variant."""
    jwl, twl = _pair(variant, n, batch, op="tridiag")
    assert _assert_same(profile, jwl, twl)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("variant", ["pcr", "wm"])
def test_tridiag_bf16_space_identical(profile, variant):
    jwl, twl = _pair(variant, 1024, 64, dtype="bfloat16", op="tridiag")
    assert _assert_same(profile, jwl, twl)


@pytest.mark.parametrize("profile", PROFILES)
def test_linrec_space_plan_score_cost_identical(profile):
    """scan_space's linrec variant (no unroll knob, three resident planes)
    and its multipass plans, on both sides."""
    for n, batch in ((96, 7), (1024, 64), (2 ** 16, 16)):
        jwl, twl = _pair("linrec", n, batch)
        assert _assert_same(profile, jwl, twl)
    jwl, twl = _pair("linrec", 2 ** 16, 16)
    cfgs = [{"tile_n": 256, "rows_per_program": rows, "radix": radix,
             "unroll": 1, "in_register": 0}
            for rows in (1, 8) for radix in (2, 4, 8)]
    _assert_same(profile, jwl, twl, cfgs)
    plan = t_plan.plan_for(twl, cfgs[0], profile=t_profiles.get_profile(
        profile))
    assert plan.kind == "multipass" and plan.launches[0].block_shape[1] == 256


@pytest.mark.parametrize("radix", [2, 3, 4, 8, 16])
def test_wm_chunk_identical(radix):
    for n in range(1, 600):
        assert t_plan.wm_chunk(radix, n) == j_plan.wm_chunk(radix, n)


def test_h100_vmem_budget_fits_the_pcr_kernel():
    """Every config tridiag_space(pcr) admits under h100 fits the CUDA PCR
    kernel: at most 16384 equations a block (two f32 exchange buffers,
    128 KiB of shared memory)."""
    from repro_torch.kernels.tridiag.kernel import MAX_SYSTEM_ELEMS
    h100 = t_profiles.get_profile("h100")
    for dtype in ("float32", "bfloat16"):
        for n, batch in ((96, 2 ** 16), (256, 2 ** 18), (1024, 2 ** 16),
                         (8192, 2 ** 13)):
            wl = t_space.Workload(op="tridiag", n=n, batch=batch,
                                  dtype=dtype, variant="pcr")
            for cfg in t_space.tridiag_space(wl, h100).enumerate_valid():
                assert cfg["rows_per_program"] * n <= MAX_SYSTEM_ELEMS
                assert 2 * 4 * cfg["rows_per_program"] * n <= 232448


@pytest.mark.parametrize("n,batch,kind", [
    (1024, 2 ** 16, "fused"), (2 ** 16, 1024, "fused"),
    (2 ** 22, 16, "multipass")])
def test_h100_linrec_main_path_plans(n, batch, kind):
    """The linrec workloads chip_smoke.py drives (linear_recurrence, and
    the LF sweeps above LF_MULTIPASS_MIN) resolve under h100 to a fused
    plan at n <= 2^16 and the multipass driver at 2^22."""
    h100 = t_profiles.get_profile("h100")
    wl = t_space.Workload(op="scan", n=n, batch=batch, variant="linrec")
    cfg = t_analytical.AnalyticalTuner().suggest(t_space.scan_space(wl, h100))
    plan = t_plan.plan_for(wl, cfg, profile=h100)
    assert plan.kind == kind
    assert plan.check(h100) == []
