"""The port's tiled matmul against the JAX package's.

``matmul_plain`` (the CUDA kernel's plain version, which a CPU tensor
runs) against ``matmul_pallas`` in interpret mode over the shapes and
block sizes of ``tests/test_kernels_matmul.py``, f32 and bf16; the
``matmul`` entry point against JAX's with the sessions pinned to one
profile.  Inputs are drawn with numpy and handed to both packages.
Tolerance: ``DTYPE_TOL`` of the input type (both accumulate each k-block's
partial product in f32 and round the output once; only the order of the
sums inside a k-block differs).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import _rng, assert_kernel_close
from repro import tuning as j_tuning
from repro.core.space import Workload as JWorkload
from repro.kernels.matmul.kernel import matmul_pallas
from repro.kernels.matmul.ops import matmul as j_matmul
from repro_torch import tuning as t_tuning
from repro_torch.core.space import Workload, matmul_space
from repro_torch.kernels.matmul import kernel as t_kernel
from repro_torch.kernels.matmul.ops import matmul as t_matmul
from repro_torch.kernels.matmul.ref import matmul_ref

j_hw = importlib.import_module("repro.hw.profiles")
t_hw = importlib.import_module("repro_torch.hw.profiles")

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# tests/test_kernels_matmul.py's sweep
SHAPES = [(256, 256, 256, 128, 128, 128), (256, 384, 512, 128, 256, 128),
          (128, 128, 128, 128, 128, 128), (512, 256, 256, 256, 128, 256)]


def _ab(tag, m, k, n, dtype):
    rng = _rng(tag)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    return ((jnp.asarray(a).astype(_JNP[dtype]),
             jnp.asarray(b).astype(_JNP[dtype])),
            (torch.from_numpy(a).to(_TORCH[dtype]),
             torch.from_numpy(b).to(_TORCH[dtype])))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,bm,bn,bk", SHAPES)
def test_matmul_plain_matches_pallas(m, k, n, bm, bn, bk, dtype):
    (ja, jb), (ta, tb) = _ab(f"mm{m}{k}{n}", m, k, n, dtype)
    want = matmul_pallas(ja, jb, block_m=bm, block_n=bn, block_k=bk,
                         interpret=True)
    got = t_kernel.matmul_plain(ta, tb, block_m=bm, block_n=bn, block_k=bk)
    assert got.dtype == _TORCH[dtype] and got.shape == (m, n)
    assert_kernel_close(_np(got), _np(want), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(256, 384, 512), (384, 256, 128)])
def test_matmul_matches_repro(tmp_path, m, k, n, dtype):
    """The entry point: both sessions (pinned to tpu_v5e, empty DBs)
    resolve the same blocks, fitted to (M, N, K) through ``dims``."""
    jprev = j_tuning.set_default_session(j_tuning.TunerSession(
        db_path=str(tmp_path / "jax.json"),
        spec=j_hw.get_profile("tpu_v5e")))
    tprev = t_tuning.set_default_session(t_tuning.TunerSession(
        db_path=str(tmp_path / "torch.json"),
        spec=t_hw.get_profile("tpu_v5e")))
    try:
        (ja, jb), (ta, tb) = _ab(f"mmentry{m}{k}{n}", m, k, n, dtype)
        want = j_matmul(ja, jb, interpret=True, use_pallas=True)
        got = t_matmul(ta, tb)
        assert_kernel_close(_np(got), _np(want), dtype)
        dims = {"m": m, "k": k}
        assert t_tuning.default_session().resolve(
            Workload(op="matmul", n=n, batch=m, variant="tiled"), dims=dims) \
            == j_tuning.default_session().resolve(
                JWorkload(op="matmul", n=n, batch=m, variant="tiled"),
                dims=dims)
    finally:
        j_tuning.set_default_session(jprev)
        t_tuning.set_default_session(tprev)


def test_matmul_ref_is_one_product():
    (_, _), (ta, tb) = _ab("mmref", 64, 96, 32, "float32")
    torch.testing.assert_close(matmul_ref(ta, tb), ta @ tb)


def test_matmul_rejects_what_the_kernel_does_not_take():
    a, b = torch.zeros(128, 64), torch.zeros(64, 96)
    with pytest.raises(ValueError, match="block_n=64 must divide 96"):
        t_kernel.matmul_tiled(a, b, block_m=64, block_n=64, block_k=64)
    with pytest.raises(ValueError, match=r"\(M, K\) @ \(K, N\)"):
        t_kernel.matmul_tiled(a, torch.zeros(32, 96))
    with pytest.raises(TypeError):
        t_kernel.matmul_tiled(a.double(), b.double())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        t_kernel._launch(a, b, 64, 32, 64)


def test_plain_calls_count_no_launch():
    before = t_kernel.matmul_tiled.launches
    t_kernel.matmul_tiled(torch.zeros(64, 32), torch.zeros(32, 64))
    assert t_kernel.matmul_tiled.launches == before


def test_h100_matmul_space_admits_every_config():
    """Under h100 the kernel's constant shared-memory slab admits all 60
    configs at qwen's MLP shape (JAX's TPU footprint admits none there)."""
    h100 = t_hw.get_profile("h100")
    wl = Workload(op="matmul", n=2816, batch=8192, variant="tiled")
    assert len(matmul_space(wl, h100).enumerate_valid()) == 60


# ---------------------------------------------------------------------------
# The bf16 tensor-core kernel's geometry (csrc/matmul.cu
# matmul_wgmma_kernel), mirrored in Python
# ---------------------------------------------------------------------------

def _fitted_qwen_configs():
    from repro_torch.kernels.matmul.ops import _normalize
    wl = Workload(op="matmul", n=2816, batch=8192, variant="tiled")
    out = []
    for cfg in matmul_space(wl, t_hw.get_profile("h100")).enumerate_valid():
        kw = _normalize(cfg, wl, {"m": 8192, "k": 1024})
        if kw not in out:
            out.append(kw)
    return out


@pytest.mark.parametrize("m,k,n,bm,bn,bk", SHAPES + [
    (96, 64, 80, 32, 16, 64), (512, 1024, 2816, 512, 256, 256),
    (64, 48, 32, 64, 32, 16)] + [(8192, 1024, 2816, c["block_m"],
                                  c["block_n"], c["block_k"])
                                 for c in _fitted_qwen_configs()])
def test_wgmma_k_blocks_are_the_plain_versions(m, k, n, bm, bn, bk):
    """The kernel folds its partial into the accumulator at every k16 step
    that starts a k-block: the same K / block_k k-blocks, in order, as the
    plain version (and the TPU kernel) adds; the tiles cover the block."""
    plan = t_kernel.wgmma_plan(m, n, k, bm, bn, bk)
    assert plan["k_blocks"] == [(k0, k0 + bk) for k0 in range(0, k, bk)]
    assert plan["grid"] == (n // bn, m // bm)
    covered = {(r, c) for tm, tn in plan["tiles"]
               for r in range(tm, tm + 128, 32)
               for c in range(tn, tn + 128, 16)}
    assert all((r, c) in covered for r in range(0, bm, 32)
               for c in range(0, bn, 16))
    assert plan["stages"] * t_kernel.WGMMA_STAGE_K >= k


def test_wgmma_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="block_k a multiple of 16"):
        t_kernel.wgmma_plan(64, 64, 64, 64, 64, 8)
    with pytest.raises(ValueError, match="N a multiple of 8"):
        t_kernel.wgmma_plan(64, 36, 64, 64, 36, 64)


def test_matmul_routes_are_fixed_by_type():
    """bf16 takes the tensor-core kernel, f32 the CUDA-core one; the fixed
    bf16 footprint fits a block's shared memory whatever the blocks."""
    assert t_kernel.ROUTES == {torch.bfloat16: "wgmma",
                               torch.float32: "simt"}
    from repro_torch.core import space as t_space
    assert t_space.MATMUL_WGMMA_SMEM_BYTES <= t_space.CUDA_SMEM_LIMIT
    a, b = torch.zeros(128, 64), torch.zeros(64, 96)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        t_kernel.matmul_simt(a, b, block_m=64, block_n=32, block_k=64)
    before = (t_kernel.matmul_tiled.launches_wgmma,
              t_kernel.matmul_tiled.launches_simt)
    t_kernel.matmul_tiled(a.bfloat16(), b.bfloat16(), block_m=64,
                          block_n=32, block_k=64)
    assert (t_kernel.matmul_tiled.launches_wgmma,
            t_kernel.matmul_tiled.launches_simt) == before
