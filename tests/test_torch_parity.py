"""The port's numpy layers against the JAX package's: spaces, plans,
analytical scores and cost-model times must be identical — the port keeps
its own copies of that arithmetic, so any drift is a porting bug.

Compared exactly (no tolerance): both sides run the same numpy/Python
arithmetic on the same inputs.
"""
import dataclasses
import importlib
import json
import os

import numpy as np
import pytest

from repro.core import analytical as j_analytical
from repro.core import multikernel as j_multikernel
from repro.core import objective as j_objective
from repro.core import space as j_space
from repro.kernels.blocks import plan as j_plan
from repro_torch.core import analytical as t_analytical
from repro_torch.core import multikernel as t_multikernel
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


def _assert_same(profile, jwl, twl, cfgs=None, builder=None):
    """The op's space, every plan, score and cost-model time, equal."""
    jp, tp = j_profiles.get_profile(profile), t_profiles.get_profile(profile)
    builder = builder or f"{jwl.op}_space"
    jsp = getattr(j_space, builder)(jwl, spec=jp)
    tsp = getattr(t_space, builder)(twl, spec=tp)
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
    # an op neither package registers: every TPU kernel's op is ported
    wl = t_space.Workload(op="sort", n=256, batch=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_space.build_space(wl)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_plan.build_plan(wl, {})


ATTENTION_WORKLOADS = [(n, batch) for n in (128, 256, 384, 2048)
                       for batch in (4, 64)]


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("n,batch", ATTENTION_WORKLOADS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_space_plan_score_cost_identical(profile, n, batch, dtype):
    """attention_space, _attention_plan, the analytical scores and the
    cost-model times (scalar and batched), under the profiles both
    packages share; every block pair is planned, admitted or not."""
    jwl, twl = _pair("flash", n, batch, dtype=dtype, op="attention")
    cfgs = [{"block_q": bq, "block_k": bk, "rows_per_program": 1,
             "radix": 2, "in_register": 0}
            for bq in (128, 1024) for bk in (128, 2048)]
    _assert_same(profile, jwl, twl)
    _assert_same(profile, jwl, twl, cfgs)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("n,batch", [(2816, 8192), (256, 256), (512, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_space_plan_score_cost_identical(profile, n, batch, dtype):
    jwl, twl = _pair("tiled", n, batch, dtype=dtype, op="matmul")
    cfgs = [{"block_m": bm, "block_n": bn, "block_k": bk}
            for bm in (128, 512) for bn in (128, 1024) for bk in (128, 2048)]
    _assert_same(profile, jwl, twl)
    _assert_same(profile, jwl, twl, cfgs)


def test_attention_and_matmul_build_through_the_registry():
    for wl in (t_space.Workload(op="attention", n=2048, batch=64,
                                variant="flash"),
               t_space.Workload(op="matmul", n=2816, batch=8192,
                                variant="tiled")):
        h100 = t_profiles.get_profile("h100")
        space = t_space.build_space(wl, h100)
        cfg = t_analytical.AnalyticalTuner().suggest(space)
        plan = t_plan.build_plan(wl, cfg, profile=h100)
        assert plan.kind == "fused" and plan.launches == ()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [128, 256, 1500, 2048, 4096])
def test_h100_attention_space_fits_the_kernel_footprint(n, dtype):
    """Under h100 the attention space is non-empty at every n >= 128 and
    every admitted config fits the CUDA flash kernel's real shared memory
    (csrc/attention.cu: Q, K, V sub-tiles, the score tile, m, l, alpha) at
    every head dim it takes.  JAX's TPU footprint admits none."""
    h100 = t_profiles.get_profile("h100")
    wl = t_space.Workload(op="attention", n=n, batch=64, dtype=dtype,
                          variant="flash")
    valid = t_space.attention_space(wl, h100).enumerate_valid()
    assert valid
    for cfg in valid:
        for hd in (16, 64, 128, 256):
            assert t_space.flash_smem_bytes(cfg["block_q"], cfg["block_k"],
                                            hd) <= 232448
    jwl = j_space.Workload(op="attention", n=n, batch=64, dtype=dtype,
                           variant="flash")
    jh = dataclasses.replace(j_profiles.get_profile("gpu_sm"), name="h100",
                             vmem_budget=h100.vmem_budget)
    assert j_space.attention_space(jwl, jh).enumerate_valid() == []


def test_h100_matmul_space_admits_every_config():
    """The CUDA matmul stages a fixed 16.5 KB of shared memory whatever its
    blocks, so under h100 every one of the 60 configs is admitted (JAX's
    TPU footprint admits none)."""
    h100 = t_profiles.get_profile("h100")
    wl = t_space.Workload(op="matmul", n=2816, batch=8192, variant="tiled")
    assert len(t_space.matmul_space(wl, h100).enumerate_valid()) == 60


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("variant,n,batch", TRIDIAG_WORKLOADS)
def test_tridiag_space_plan_score_cost_identical(profile, variant, n, batch):
    """tridiag_space, _tridiag_plan, the analytical scores and the
    cost-model times (scalar and batched) for every solver variant."""
    jwl, twl = _pair(variant, n, batch, op="tridiag")
    assert _assert_same(profile, jwl, twl)


@pytest.mark.parametrize("profile", PROFILES)
def test_thomas_plans_no_launch_in_either_package(profile):
    """The Thomas kernel ports no Pallas kernel: JAX's plan for ``thomas``
    launches nothing, and the port's keeps that empty list (its kernel is
    not routed through ``driver.launch``)."""
    jwl, twl = _pair("thomas", 1024, 64, op="tridiag")
    jplan = j_plan.plan_for(jwl, {}, profile=j_profiles.get_profile(profile))
    tplan = t_plan.plan_for(twl, {}, profile=t_profiles.get_profile(profile))
    assert jplan.launches == tplan.launches == ()


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


FFT_WORKLOADS = [(n, batch) for n in (64, 96, 106, 256, 1000, 1024, 4096)
                 for batch in (3, 64)]


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("n,batch", FFT_WORKLOADS)
def test_fft_space_plan_score_cost_identical(profile, n, batch):
    """fft_space, _fft_fused_plan, the analytical scores and the cost-model
    times (scalar and batched)."""
    jwl, twl = _pair("stockham", n, batch, op="fft")
    assert _assert_same(profile, jwl, twl)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("n,batch", [(2 ** 12, 16), (2 ** 16, 8),
                                     (2 ** 20, 4), (2 ** 23, 8)])
def test_large_fft_space_plan_score_cost_identical(profile, n, batch):
    """large_fft_space (its 4096 max_tile default) and the four-step plans
    at the profile's resident cap."""
    jwl, twl = _pair("stockham", n, batch, op="large_fft")
    assert _assert_same(profile, jwl, twl)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("n,tile,max_tile,m", [
    (4096, 64, 64, 2), (4096, 16, 16, 3), (2 ** 16, 256, 512, 2),
    (2 ** 20, 256, 2048, 3), (2 ** 23, 256, 8192, 3),
    (2 ** 23, 4096, 8192, 2), (1000, 2048, 512, 2)])
def test_four_step_plans_with_max_tile_identical(profile, n, tile, max_tile,
                                                 m):
    """_large_fft_plan with an explicit max_tile, down the m = 3
    recursion: identical plans, and passes == the launches the driver
    makes."""
    jwl, twl = _pair("stockham", n, 8, op="large_fft")
    jp, tp = j_profiles.get_profile(profile), t_profiles.get_profile(profile)
    for radix in (2, 4, 8, 16):
        cfg = {"tile_n": tile, "rows_per_program": 2, "radix": radix,
               "unroll": 1, "in_register": 0}
        jplan = j_plan.plan_for(jwl, cfg, profile=jp, max_tile=max_tile)
        tplan = t_plan.plan_for(twl, cfg, profile=tp, max_tile=max_tile)
        assert dataclasses.asdict(jplan) == dataclasses.asdict(tplan)
        assert tplan.passes == len(tplan.launches) == m
        assert tplan.check(tp) == jplan.check(jp)


@pytest.mark.parametrize("profile", PROFILES + ("h100",))
def test_resident_tile_cap_identical(profile):
    tp = t_profiles.get_profile(profile)
    jp = j_profiles.get_profile(profile) if profile != "h100" else None
    for op in ("fft", "large_fft", "scan"):
        for n in (96, 256, 1000, 4096, 8192, 2 ** 16, 2 ** 23):
            twl = t_space.Workload(op=op, n=n, batch=4)
            cap = t_plan.resident_tile_cap(twl, tp)
            assert cap == t_multikernel.max_resident_tile(twl, tp)
            if jp is not None:
                jwl = j_space.Workload(op=op, n=n, batch=4)
                assert cap == j_plan.resident_tile_cap(jwl, jp)
                assert cap == j_multikernel.max_resident_tile(jwl, jp)


def test_num_passes_identical():
    for n in (2, 96, 1000, 2 ** 16, 2 ** 20, 2 ** 23):
        for tile in (2, 16, 256, 4096, 8192):
            assert t_multikernel.num_passes(n, tile) \
                == j_multikernel.num_passes(n, tile)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("n,batch", [(2 ** 16, 1024), (2 ** 20, 64),
                                     (2 ** 23, 8)])
def test_multikernel_identical(profile, monkeypatch, n, batch):
    """analytical_multipass, MultiPassPlan.total_time and
    MultiPassObjective over the large-N space, on both sides, with both
    packages' active profiles set to ``profile``."""
    monkeypatch.setenv("REPRO_HW_PROFILE", profile)
    monkeypatch.setenv("REPRO_TORCH_HW_PROFILE", profile)
    jp, tp = j_profiles.get_profile(profile), t_profiles.get_profile(profile)
    jwl, twl = _pair("stockham", n, batch, op="large_fft")
    jmp = j_multikernel.analytical_multipass(jwl, jp)
    tmp = t_multikernel.analytical_multipass(twl, tp)
    assert (tmp.passes, tmp.tile_n, tmp.m, tmp.method) \
        == (jmp.passes, jmp.tile_n, jmp.m, jmp.method)
    assert dataclasses.asdict(tmp.workload) == dataclasses.asdict(
        jmp.workload)
    jcost, tcost = j_objective.CostModelObjective(jp), \
        t_objective.CostModelObjective(tp)
    assert tmp.total_time(tcost) == jmp.total_time(jcost)
    jobj = j_multikernel.MultiPassObjective(jcost)
    tobj = t_multikernel.MultiPassObjective(tcost)
    jsp = j_space.large_fft_space(jwl, spec=jp)
    tsp = t_space.large_fft_space(twl, spec=tp)
    valid = jsp.enumerate_valid()
    assert valid and valid == tsp.enumerate_valid()
    for cfg in valid:
        jm, tm = jobj(jsp, cfg), tobj(tsp, cfg)
        assert (jm.time_s, jm.valid, jm.meta) == (tm.time_s, tm.valid,
                                                  tm.meta), cfg
    # the default inner objective is the active profile's cost model
    cfg = valid[0]
    assert t_multikernel.MultiPassObjective()(tsp, cfg).time_s \
        == j_multikernel.MultiPassObjective()(jsp, cfg).time_s


def test_h100_vmem_budget_fits_the_fft_kernel():
    """Every config fft_space admits under h100 keeps all its rows resident
    in the CUDA Stockham kernel: two complex f32 buffers of rows * n
    points, plus the per-stage tables, within a block's 227 KB."""
    from repro_torch.kernels.fft.kernel import SMEM_LIMIT
    h100 = t_profiles.get_profile("h100")
    for k in range(6, 14):
        n = 2 ** k
        wl = t_space.Workload(op="fft", n=n, batch=2 ** 26 // n,
                              variant="stockham")
        cfgs = t_space.fft_space(wl, h100).enumerate_valid()
        assert cfgs
        for cfg in cfgs:
            stages = t_plan.stage_radices(n, cfg["radix"])
            smem = 2 * 8 * cfg["rows_per_program"] * n + 12 * sum(stages)
            assert smem <= SMEM_LIMIT, (n, cfg)
    assert t_plan.resident_tile_cap(
        t_space.Workload(op="fft", n=2 ** 23, batch=8), h100) == 8192


@pytest.mark.parametrize("n,kind,m", [
    (256, "fused", 1), (1024, "fused", 1), (4096, "fused", 1),
    (8192, "fused", 1), (2 ** 16, "multipass", 2),
    (2 ** 20, "multipass", 2), (2 ** 23, "multipass", 3)])
def test_h100_fft_main_path_plans(n, kind, m):
    """The paper-size FFT workloads chip_smoke.py drives resolve, under
    h100, to one launch up to n = 8192 and to the four-step driver above
    (the analytical tile 256 at 2^23 recurses: m = 3)."""
    h100 = t_profiles.get_profile("h100")
    batch = 2 ** 26 // n
    cap = t_multikernel.max_resident_tile(
        t_space.Workload(op="fft", n=n, batch=batch), h100)
    op = "fft" if n <= cap else "large_fft"
    wl = t_space.Workload(op=op, n=n, batch=batch, variant="stockham")
    cfg = t_analytical.AnalyticalTuner().suggest(
        t_space.build_space(wl, h100))
    plan = t_plan.plan_for(wl, cfg, profile=h100,
                           max_tile=cap if op == "large_fft" else None)
    assert plan.kind == kind
    assert plan.passes == len(plan.launches) == m
    assert plan.check(h100) == []


SSD_WORKLOADS = [(n, batch) for n in (64, 256, 1024, 2048)
                 for batch in (4, 192)]


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("n,batch", SSD_WORKLOADS)
def test_ssd_space_plan_score_cost_identical(profile, n, batch):
    """scan_space with the fuse knob under op="ssd", _ssd_plan (fused,
    two-phase and three-phase), the analytical scores and the cost-model
    times (scalar and batched)."""
    jwl, twl = _pair("chunked", n, batch, op="ssd")
    valid = _assert_same(profile, jwl, twl, builder="scan_space")
    assert {cfg["fuse"] for cfg in valid} == {0, 1}


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("n,batch", [(64, 32), (256, 32), (2048, 8192),
                                     (8192, 4096), (2 ** 16, 16)])
def test_rglru_space_plan_score_cost_identical(profile, n, batch):
    """linrec_space under op="rglru" (no unroll, the fuse knob) and its
    plans with the unfused gate's extra pass."""
    jwl, twl = _pair("", n, batch, op="rglru")
    jp, tp = j_profiles.get_profile(profile), t_profiles.get_profile(profile)
    jsp, tsp = j_space.linrec_space(jwl, spec=jp), \
        t_space.linrec_space(twl, spec=tp)
    assert jsp.enumerate_valid() == tsp.enumerate_valid()
    assert t_space.build_space(twl, tp).enumerate_valid() \
        == tsp.enumerate_valid()
    jcost, tcost = j_objective.CostModelObjective(jp), \
        t_objective.CostModelObjective(tp)
    valid = tsp.enumerate_valid()
    assert valid and {cfg["unroll"] for cfg in valid} == {1}
    for cfg in valid:
        jplan = j_plan.plan_for(jwl, cfg, profile=jp)
        tplan = t_plan.plan_for(twl, cfg, profile=tp)
        assert dataclasses.asdict(jplan) == dataclasses.asdict(tplan), cfg
        assert tplan.xla_passes == 1 - cfg["fuse"]
        assert j_analytical.score(jsp, cfg).key() \
            == t_analytical.score(tsp, cfg).key()
        jm, tm = jcost(jsp, cfg), tcost(tsp, cfg)
        assert (jm.time_s, jm.metrics, jm.meta) \
            == (tm.time_s, tm.metrics, tm.meta), cfg
    jcols = jcost.batch_eval_metrics(jsp, valid)
    tcols = tcost.batch_eval_metrics(tsp, valid)
    for name in jcols:
        np.testing.assert_array_equal(jcols[name], tcols[name])
    assert j_analytical.AnalyticalTuner().suggest(jsp) \
        == t_analytical.AnalyticalTuner().suggest(tsp)


def _chain_dicts(chain):
    return (dataclasses.asdict(chain.plan),
            [dataclasses.asdict(link) for link in chain.links],
            chain.passes, [dataclasses.asdict(l) for l in chain.launches])


@pytest.mark.parametrize("profile", PROFILES + ("h100",))
@pytest.mark.parametrize("dims", [None, (8, 16), (128, 64)])
@pytest.mark.parametrize("n,chunk", [(512, 128), (384, 128), (128, 128),
                                     (2048, 128), (2048, 2048), (96, 32)])
def test_ssd_chain_plans_identical(profile, dims, n, chunk):
    """plan_for_chain for the SSD chain, with and without the runtime
    state dims, both fuse arms, even, odd and single chunk counts: the same
    links, launches and passes, and ChainPlan.check finds nothing."""
    tp = t_profiles.get_profile(profile)
    jp = j_profiles.get_profile(profile) if profile != "h100" else None
    for fuse in (0, 1):
        cfg = {"tile_n": chunk, "radix": 2, "fuse": fuse}
        twl = t_space.Workload(op="ssd", n=n, batch=192, variant="chunked")
        tchain = t_plan.plan_for_chain(twl, cfg, dims=dims, profile=tp)
        assert tchain.check(tp) == []
        nc = n // chunk
        kinds = [link.kind for link in tchain.links]
        if nc <= 1:
            assert kinds == ["pallas"] and len(tchain.launches) == 1
        elif fuse:
            assert kinds == ["pallas", "fused", "pallas"]
        elif dims is not None and nc % 2:
            assert kinds == ["pallas", "xla", "pallas"]
        if jp is not None:
            jwl = j_space.Workload(op="ssd", n=n, batch=192,
                                   variant="chunked")
            jchain = j_plan.plan_for_chain(jwl, cfg, dims=dims, profile=jp)
            assert _chain_dicts(tchain) == _chain_dicts(jchain)
            assert tchain.check(tp) == jchain.check(jp)


@pytest.mark.parametrize("profile", PROFILES)
def test_single_link_chains_identical(profile):
    """Every other op is a one-link chain around its plan_for plan."""
    jp, tp = j_profiles.get_profile(profile), t_profiles.get_profile(profile)
    for op, variant, n in (("scan", "ks", 1024), ("tridiag", "lf", 256),
                           ("fft", "stockham", 1024)):
        jwl, twl = _pair(variant, n, 64, op=op)
        cfg = t_space.build_space(twl, tp).enumerate_valid()[0]
        assert _chain_dicts(t_plan.plan_for_chain(twl, cfg, profile=tp)) \
            == _chain_dicts(j_plan.plan_for_chain(jwl, cfg, profile=jp))


@pytest.mark.parametrize("op,n,batch,tile_n,fuse,kind", [
    # the session's picks under h100: the SSD at the least modelled chain
    # time, chunks of 128 with phases B + C fused, for the mamba2-130m
    # prefill and a shorter sequence; a fused rglru
    ("ssd", 2048, 8 * 24, 128, 1, "two-phase"),
    ("ssd", 1024, 24, 128, 1, "two-phase"),
    ("rglru", 2048, 8192, 2048, 1, "fused"),
    ("rglru", 8192, 4096, 2048, 1, "fused"),
])
def test_h100_ssd_rglru_picks(op, n, batch, tile_n, fuse, kind):
    h100 = t_profiles.get_profile("h100")
    wl = t_space.Workload(op=op, n=n, batch=batch,
                          variant="chunked" if op == "ssd" else "")
    cfg = t_analytical.AnalyticalTuner().suggest(t_space.build_space(wl,
                                                                     h100))
    assert (cfg["tile_n"], cfg["fuse"]) == (tile_n, fuse)
    if op == "rglru":
        assert (cfg["rows_per_program"], cfg["radix"]) == (4, 2)
    plan = t_plan.plan_for(wl, cfg, profile=h100)
    assert plan.kind == kind and plan.check(h100) == []


def test_h100_ssd_space_admits_chunks_to_16384():
    """The f32 space under h100 admits chunks up to 16384 (vmem_budget
    2^17): the intra kernel has to run every one (it holds no Q x Q tile);
    at mamba2-130m's L = 2048 every power of two from 128."""
    h100 = t_profiles.get_profile("h100")
    wl = t_space.Workload(op="ssd", n=2 ** 16, batch=8, variant="chunked")
    chunks = {c["tile_n"] for c in t_space.build_space(
        wl, h100).enumerate_valid()}
    assert max(chunks) == 16384
    wl = t_space.Workload(op="ssd", n=2048, batch=192, variant="chunked")
    assert {c["tile_n"] for c in t_space.build_space(
        wl, h100).enumerate_valid()} == {128, 256, 512, 1024, 2048}


@pytest.mark.parametrize("n", [256, 512, 2048, 8192])
@pytest.mark.parametrize("batch", [4, 96, 192])
def test_h100_ssd_chain_time_picks(n, batch):
    """Under h100 the SSD ranks by its modelled chain time after the tier:
    chunks shorter than L from 512 up, fused wherever there are several
    chunks, and at fixed passes a longer chunk always models slower.  At
    L = 256 one chunk of 256 stays the pick, as the card's sweep found it
    fastest at rows 4, 96 and 192 (one more launch costs more than the
    intra work it saves)."""
    h100 = t_profiles.get_profile("h100")
    wl = t_space.Workload(op="ssd", n=n, batch=batch, variant="chunked")
    space = t_space.build_space(wl, h100)
    cfg = t_analytical.AnalyticalTuner().suggest(space)
    chunk = min(cfg["tile_n"], n)
    assert (chunk < n) == (n >= 512)
    if n // chunk > 1:
        assert cfg["fuse"] == 1
    by_passes = {}
    for c in space.enumerate_valid():
        res = t_analytical.resources(space, c)
        by_passes.setdefault(res["passes"], {})[min(c["tile_n"], n)] = \
            t_analytical.ssd_chain_time(space, res)
    for times in by_passes.values():
        chunks = sorted(times)
        assert all(times[a] < times[b] for a, b in zip(chunks, chunks[1:]))


# The h100 picks (tile_n, rows_per_program, radix, unroll, in_register) of
# every shape of portbench/configs/bplg-2p26.json, at 2^26 elements a call,
# and of rglru at (2048, 8192): the SSD's chain-time term leaves every
# other op's ranking as it was.
_GRID_PICKS = {
    ("scan", "lf", 128): (128, 64, 2, 8, 1),
    ("scan", "lf", 256): (256, 32, 4, 8, 0),
    ("scan", "lf", 512): (512, 16, 8, 8, 0),
    ("scan", "lf", 1024): (1024, 8, 4, 8, 0),
    ("scan", "lf", 2048): (2048, 4, 2, 8, 0),
    ("scan", "lf", 4096): (2048, 4, 2, 8, 0),
    ("scan", "ks", 128): (128, 64, 2, 8, 1),
    ("scan", "ks", 256): (256, 32, 4, 8, 0),
    ("scan", "ks", 512): (512, 16, 8, 8, 0),
    ("scan", "ks", 1024): (1024, 8, 4, 8, 0),
    ("scan", "ks", 2048): (2048, 4, 2, 8, 0),
    ("scan", "ks", 4096): (2048, 4, 2, 8, 0),
    ("tridiag", "cr", 64): (64, 1, 2, 1, 0),
    ("tridiag", "cr", 128): (128, 1, 2, 1, 0),
    ("tridiag", "cr", 256): (256, 1, 2, 1, 0),
    ("tridiag", "cr", 512): (512, 1, 2, 1, 0),
    ("tridiag", "cr", 1024): (1024, 1, 2, 1, 0),
    ("tridiag", "pcr", 64): (64, 64, 2, 4, 1),
    ("tridiag", "pcr", 128): (128, 32, 2, 4, 1),
    ("tridiag", "pcr", 256): (256, 16, 2, 4, 0),
    ("tridiag", "pcr", 512): (512, 8, 2, 4, 0),
    ("tridiag", "pcr", 1024): (1024, 4, 2, 4, 0),
    ("tridiag", "lf", 64): (64, 1, 2, 1, 0),
    ("tridiag", "lf", 128): (128, 1, 2, 1, 0),
    ("tridiag", "lf", 256): (256, 1, 2, 1, 0),
    ("tridiag", "lf", 512): (512, 1, 2, 1, 0),
    ("tridiag", "lf", 1024): (1024, 1, 2, 1, 0),
    ("tridiag", "wm", 64): (64, 1, 8, 1, 0),
    ("tridiag", "wm", 128): (128, 1, 2, 1, 0),
    ("tridiag", "wm", 256): (256, 1, 4, 1, 0),
    ("tridiag", "wm", 512): (512, 1, 8, 1, 0),
    ("tridiag", "wm", 1024): (1024, 1, 4, 1, 0),
    ("fft", "stockham", 64): (64, 64, 8, 4, 0),
    ("fft", "stockham", 128): (128, 32, 2, 4, 0),
    ("fft", "stockham", 256): (256, 16, 16, 4, 0),
    ("fft", "stockham", 512): (512, 8, 8, 4, 0),
    ("fft", "stockham", 1024): (1024, 4, 4, 4, 0),
    ("fft", "stockham", 2048): (2048, 2, 2, 4, 0),
    ("fft", "stockham", 4096): (4096, 1, 16, 4, 0),
    ("large_fft", "stockham", 8192): (256, 16, 16, 4, 0),
    ("large_fft", "stockham", 65536): (256, 16, 16, 4, 0),
    ("large_fft", "stockham", 1048576): (512, 4, 8, 4, 0),
    ("large_fft", "stockham", 8388608): (256, 8, 16, 4, 0),
}


def _grid_shapes():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "portbench",
                        "configs", "bplg-2p26.json")
    with open(path) as f:
        cfg = json.load(f)
    total = cfg["elements_per_call"]
    return [(fam, variant, n, total // n, d["dtype"])
            for fam, d in cfg["families"].items()
            for variant in d["variants"] for n in d["sizes"]] \
        + [("rglru", "", 2048, 8192, "float32")]


@pytest.mark.parametrize("op,variant,n,batch,dtype", _grid_shapes())
def test_h100_grid_picks_unchanged(op, variant, n, batch, dtype):
    h100 = t_profiles.get_profile("h100")
    wl = t_space.Workload(op=op, n=n, batch=batch, dtype=dtype,
                          variant=variant)
    cfg = t_analytical.AnalyticalTuner().suggest(t_space.build_space(wl,
                                                                     h100))
    if op == "rglru":
        assert cfg == {"tile_n": 2048, "rows_per_program": 4, "radix": 2,
                       "unroll": 1, "in_register": 0, "fuse": 1}
        return
    assert (cfg["tile_n"], cfg["rows_per_program"], cfg["radix"],
            cfg["unroll"], cfg["in_register"]) == _GRID_PICKS[op, variant, n]
