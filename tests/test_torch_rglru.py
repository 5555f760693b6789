"""The port's RG-LRU op on the CPU against the JAX package's.

``rglru`` is a gate -> linrec chain on the scan kernels: ``fuse=1`` hands
the raw input to ``scan_linrec`` / ``scan_linrec_prod`` with
``gate=True`` (the gate in the kernel), ``fuse=0`` computes the gate as a
torch pass first.  A CPU tensor runs the kernels' plain versions through
the same plan; outputs and launch lists are held against the JAX op in
interpret mode, at the shared ``DTYPE_TOL`` (scale 10, as the JAX suite
holds this op).
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import _rng, assert_kernel_close
from repro import tuning as j_tuning
from repro.core.space import Workload as JWorkload
from repro.kernels.blocks import driver as j_driver
from repro.kernels.rglru.ops import rglru as j_rglru
from repro.kernels.rglru.ref import rglru_ref as j_rglru_ref
from repro_torch import tuning as t_tuning
from repro_torch.core.space import Workload as TWorkload
from repro_torch.kernels.blocks import driver as t_driver
from repro_torch.kernels.blocks.plan import plan_for_chain
from repro_torch.kernels.rglru.ops import rglru as t_rglru
from repro_torch.kernels.rglru.ref import rglru_ref as t_rglru_ref

j_hw = importlib.import_module("repro.hw.profiles")
t_hw = importlib.import_module("repro_torch.hw.profiles")

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(tag, B, L, D, dtype="float32"):
    """(a, u) for both packages: a in [0.8, 0.99), u standard normal."""
    rng = _rng(tag)
    a = rng.uniform(0.8, 0.99, size=(B, L, D)).astype(np.float32)
    u = rng.normal(size=(B, L, D)).astype(np.float32)
    return ((jnp.asarray(a).astype(_JNP[dtype]),
             jnp.asarray(u).astype(_JNP[dtype])),
            (torch.from_numpy(a).to(_TORCH[dtype]),
             torch.from_numpy(u).to(_TORCH[dtype])))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _asdicts(launches):
    return [dataclasses.asdict(l) for l in launches]


@pytest.fixture
def pinned(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_HW_PROFILE", "tpu_v5e")
    monkeypatch.setenv("REPRO_TORCH_HW_PROFILE", "tpu_v5e")
    jprev = j_tuning.set_default_session(j_tuning.TunerSession(
        db_path=str(tmp_path / "jax.json"), spec=j_hw.get_profile("tpu_v5e")))
    tprev = t_tuning.set_default_session(t_tuning.TunerSession(
        db_path=str(tmp_path / "torch.json"),
        spec=t_hw.get_profile("tpu_v5e")))
    yield
    j_tuning.set_default_session(jprev)
    t_tuning.set_default_session(tprev)


def _run_both(inputs, config=None):
    (ja, ju), (ta, tu) = inputs
    with j_driver.capture_launches() as jl:
        jh = j_rglru(ja, ju, config=config, interpret=True, use_pallas=True)
    with t_driver.capture_launches() as tl:
        th = t_rglru(ta, tu, config=config)
    return jh, th, list(jl), list(tl)


@pytest.mark.parametrize("fuse", [0, 1])
@pytest.mark.parametrize("B,L,D,cfg,kind,dtype", [
    # one fused launch: rows 8 of (B * D) rows, 1 or 2 column tiles
    (2, 128, 16, {"rows_per_program": 8, "tile_n": 128, "radix": 4},
     "fused", "float32"),
    (2, 256, 16, {"rows_per_program": 8, "tile_n": 128, "radix": 2},
     "fused", "bfloat16"),
    # 2^14 / 128 = 128 column tiles > 64: the three-launch driver
    (1, 2 ** 14, 4, {"rows_per_program": 2, "tile_n": 128, "radix": 4},
     "multipass", "float32"),
])
def test_rglru_matches_repro(pinned, fuse, B, L, D, cfg, kind, dtype):
    """Fused and multipass plans, the gate in the kernel or in torch:
    outputs, launch lists equal to JAX's capture and to the chain plan,
    and the float64 sequential oracle."""
    cfg = dict(cfg, fuse=fuse)
    inputs = _inputs(f"rglru{B}x{L}x{D}", B, L, D, dtype)
    jh, th, jl, tl = _run_both(inputs, cfg)
    assert th.shape == inputs[1][0].shape and th.dtype == _TORCH[dtype]
    assert _asdicts(tl) == _asdicts(jl)
    chain = plan_for_chain(TWorkload(op="rglru", n=L, batch=B * D), cfg)
    assert tuple(tl) == chain.launches
    assert chain.plan.kind == kind
    assert len(tl) == (3 if kind == "multipass" else 1)
    assert chain.plan.xla_passes == 1 - fuse
    assert_kernel_close(_np(th), _np(jh), dtype, scale=10.0)
    ta, tu = inputs[1]
    ref = t_rglru_ref(ta.double(), tu.double())
    assert_kernel_close(_np(th), ref.numpy(), dtype, scale=10.0)


def test_rglru_resolved_config_matches_repro(pinned):
    inputs = _inputs("rglruresolved", 2, 256, 16)
    jh, th, jl, tl = _run_both(inputs)
    assert _asdicts(tl) == _asdicts(jl) and tl
    wl, jwl = TWorkload(op="rglru", n=256, batch=32), \
        JWorkload(op="rglru", n=256, batch=32)
    cfg = t_tuning.default_session().resolve(wl)
    assert cfg == j_tuning.default_session().resolve(jwl) and "fuse" in cfg
    assert_kernel_close(_np(th), _np(jh), "float32", scale=10.0)


def test_rglru_fused_chain_drops_the_gate_pass():
    """Same launches either way; the unfused chain costs one more pass
    over memory (its torch gate), the fused one none."""
    wl = TWorkload(op="rglru", n=256, batch=32)
    cfg = {"tile_n": 128, "rows_per_program": 8, "radix": 2}
    chains = {f: plan_for_chain(wl, dict(cfg, fuse=f)) for f in (0, 1)}
    assert chains[0].launches == chains[1].launches
    assert chains[1].plan.passes < chains[0].plan.passes
    assert [link.kind for link in chains[1].links] == ["fused", "pallas"]
    assert [link.kind for link in chains[0].links] == ["xla", "pallas"]
    for chain in chains.values():
        assert chain.check(t_hw.get_profile("h100")) == []


@pytest.mark.parametrize("L", [1, 7, 64])
def test_rglru_ref_matches_repro(L):
    (ja, ju), (ta, tu) = _inputs(f"rglruref{L}", 2, L, 8)
    assert_kernel_close(_np(t_rglru_ref(ta, tu)), _np(j_rglru_ref(ja, ju)),
                        "float32")
