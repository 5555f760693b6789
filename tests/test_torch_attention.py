"""The port's flash attention against the JAX package's.

``flash_attention_plain`` (the CUDA kernel's plain version, which a CPU
tensor runs) against ``flash_attention_pallas`` in interpret mode over
block sizes, causal and full masks, a local window, queries in the last
slots (Lq < Lk), tiny blocks, head dims 16 ... 256, f32 and bf16; the
``attention`` entry point (tuned block sizes, decode) against JAX's; the
spaces, plans and cost-model times of op "attention".  Inputs are drawn
with numpy and handed to both packages.  Tolerance: ``DTYPE_TOL`` of the
input type (both sides compute in f32 and round the output once; only the
order of the dot products' sums differs).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import _rng, assert_kernel_close
from repro import tuning as j_tuning
from repro.core.space import Workload as JWorkload
from repro.kernels.attention.kernel import flash_attention_pallas
from repro.kernels.attention.ops import attention as j_attention
from repro.kernels.attention.ref import attention_ref as j_attention_ref
from repro_torch import tuning as t_tuning
from repro_torch.core import space as t_space
from repro_torch.core.space import Workload, attention_space, flash_tiles
from repro_torch.kernels.attention import kernel as t_kernel
from repro_torch.kernels.attention.ops import attention as t_attention
from repro_torch.kernels.attention.ref import attention_ref as t_attention_ref

j_hw = importlib.import_module("repro.hw.profiles")
t_hw = importlib.import_module("repro_torch.hw.profiles")

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(tag, BH, lq, lk, d, dtype="float32"):
    rng = _rng(tag)
    arrs = [rng.normal(size=(BH, n, d)).astype(np.float32)
            for n in (lq, lk, lk)]
    return ([jnp.asarray(a).astype(_JNP[dtype]) for a in arrs],
            [torch.from_numpy(a.copy()).to(_TORCH[dtype]) for a in arrs])


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.fixture
def pinned(tmp_path):
    """Both default sessions on tpu_v5e with empty DBs: they resolve the
    same block sizes."""
    jprev = j_tuning.set_default_session(j_tuning.TunerSession(
        db_path=str(tmp_path / "jax.json"),
        spec=j_hw.get_profile("tpu_v5e")))
    tprev = t_tuning.set_default_session(t_tuning.TunerSession(
        db_path=str(tmp_path / "torch.json"),
        spec=t_hw.get_profile("tpu_v5e")))
    yield
    j_tuning.set_default_session(jprev)
    t_tuning.set_default_session(tprev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq,bk", [(128, 128), (64, 256), (256, 64)])
def test_flash_plain_matches_pallas(bq, bk, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(f"flash{bq}{bk}{causal}", 2, 256, 256,
                                      64, dtype)
    want = flash_attention_pallas(jq, jk, jv, block_q=bq, block_k=bk,
                                  causal=causal, interpret=True)
    got = t_kernel.flash_attention_plain(tq, tk, tv, block_q=bq,
                                         block_k=bk, causal=causal)
    assert got.dtype == _TORCH[dtype] and got.shape == tq.shape
    assert_kernel_close(_np(got), _np(want), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bq,bk", [(128, 128), (64, 256)])
def test_flash_plain_local_window_matches_pallas(bq, bk, dtype):
    """Window 128 at L = 512: some rows find every key of their first live
    k-block masked (p = 1 there, wiped by the next rescale: the -1e30 fill,
    not -inf)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(f"window{bq}{bk}", 2, 512, 512, 64,
                                      dtype)
    want = flash_attention_pallas(jq, jk, jv, block_q=bq, block_k=bk,
                                  causal=True, window=128, interpret=True)
    got = t_kernel.flash_attention_plain(tq, tk, tv, block_q=bq, block_k=bk,
                                         causal=True, window=128)
    assert bool(torch.isfinite(got.float()).all())
    assert_kernel_close(_np(got), _np(want), dtype)
    ref = j_attention_ref(jq, jk, jv, causal=True, window=128)
    assert_kernel_close(_np(got), _np(ref), dtype)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_queries_in_the_last_slots(causal, window, dtype):
    """Lq < Lk: the queries are the last Lq positions of the key stream."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(f"lastslots{causal}{window}", 3, 128,
                                      384, 64, dtype)
    want = flash_attention_pallas(jq, jk, jv, block_q=64, block_k=128,
                                  causal=causal, window=window,
                                  interpret=True)
    got = t_kernel.flash_attention_plain(tq, tk, tv, block_q=64,
                                         block_k=128, causal=causal,
                                         window=window)
    assert_kernel_close(_np(got), _np(want), dtype)


@pytest.mark.parametrize("d", [16, 128, 256])
def test_flash_plain_head_dims(d):
    (jq, jk, jv), (tq, tk, tv) = _qkv(f"headdim{d}", 2, 128, 128, d)
    want = flash_attention_pallas(jq, jk, jv, block_q=64, block_k=32,
                                  causal=True, interpret=True)
    got = t_kernel.flash_attention_plain(tq, tk, tv, block_q=64, block_k=32,
                                         causal=True)
    assert_kernel_close(_np(got), _np(want), "float32")


def test_flash_plain_tiny_blocks():
    """Block sizes fit_block shrinks to 4 (a 1500-long memory gives 4)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv("tiny", 2, 12, 20, 64)
    want = flash_attention_pallas(jq, jk, jv, block_q=4, block_k=4,
                                  causal=False, interpret=True)
    got = t_kernel.flash_attention_plain(tq, tk, tv, block_q=4, block_k=4,
                                         causal=False)
    assert_kernel_close(_np(got), _np(want), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lq,lk,causal,window", [
    (256, 256, True, None), (256, 256, False, None), (128, 256, True, None),
    (256, 256, True, 64), (384, 384, True, None)])
def test_attention_matches_repro(pinned, lq, lk, causal, window, dtype):
    """The entry point: both sessions resolve and fit the same block sizes
    (through ``dims``) and run the same flash function."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(f"entry{lq}{lk}{causal}{window}", 4,
                                      lq, lk, 64, dtype)
    want = j_attention(jq, jk, jv, causal=causal, window=window,
                       interpret=True, use_pallas=True)
    got = t_attention(tq, tk, tv, causal=causal, window=window)
    assert_kernel_close(_np(got), _np(want), dtype)
    wl = Workload(op="attention", n=lk, batch=4, variant="flash")
    jwl = JWorkload(op="attention", n=lk, batch=4, variant="flash")
    dims = {"lq": lq, "lk": lk}
    assert t_tuning.default_session().resolve(wl, dims=dims) \
        == j_tuning.default_session().resolve(jwl, dims=dims)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_takes_the_reference(pinned, monkeypatch, dtype):
    """Lq == 1 is the JAX entry point's own rule: the reference, never the
    flash function."""
    (jq, jk, jv), (tq, tk, tv) = _qkv("decode", 4, 1, 300, 64, dtype)

    def boom(*args, **kwargs):
        raise AssertionError("decode reached the flash kernel")

    monkeypatch.setattr(t_kernel, "flash_attention_plain", boom)
    got = t_attention(tq, tk, tv, causal=True)
    want = j_attention(jq, jk, jv, causal=True)
    assert_kernel_close(_np(got), _np(want), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 48)])
def test_attention_ref_matches_repro(causal, window, dtype):
    """The oracle, -inf mask and input-type products included."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(f"ref{causal}{window}", 2, 96, 160,
                                      128, dtype)
    want = j_attention_ref(jq, jk, jv, causal=causal, window=window)
    got = t_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == _TORCH[dtype]
    assert_kernel_close(_np(got), _np(want), dtype)


def test_flash_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(2, 64, 32)
    with pytest.raises(ValueError, match="head_dim"):
        t_kernel.flash_attention(q, q, q, block_q=32, block_k=32)
    q = torch.zeros(2, 64, 64)
    with pytest.raises(ValueError, match="must divide"):
        t_kernel.flash_attention(q, q, q, block_q=48, block_k=32)
    with pytest.raises(TypeError):
        t_kernel.flash_attention(q.double(), q.double(), q.double(),
                                 block_q=32, block_k=32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        t_kernel._launch(q, q, q, 32, 32, True, None)


def test_plain_calls_count_no_launch():
    before = t_kernel.flash_attention.launches
    q = torch.zeros(2, 64, 16)
    t_kernel.flash_attention(q, q, q, block_q=32, block_k=32)
    assert t_kernel.flash_attention.launches == before


def test_flash_tiles_keep_the_score_tile_within_its_budget():
    for bq in (1, 4, 96, 128, 1024):
        for bk in (1, 4, 128, 2048):
            for d in (16, 64, 128, 256):
                qt, kt = flash_tiles(bq, bk, d)
                assert 1 <= qt <= min(bq, 64) and 1 <= kt <= bk
                assert qt * bk <= max(16384, bk)


def test_h100_attention_space_admits_configs_at_every_length():
    h100 = t_hw.get_profile("h100")
    for n in (128, 256, 2048, 4096):
        wl = Workload(op="attention", n=n, batch=64, variant="flash")
        valid = attention_space(wl, h100).enumerate_valid()
        assert valid and all(c["block_q"] <= n and c["block_k"] <= n
                             for c in valid)
    assert len(attention_space(Workload(op="attention", n=2048, batch=64),
                               h100).enumerate_valid()) == 20


# ---------------------------------------------------------------------------
# The bf16 tensor-core kernel's geometry (csrc/attention.cu
# flash_wgmma_kernel), mirrored in Python and held to the TPU's live set
# ---------------------------------------------------------------------------

def _h100_cases():
    """(Lq, Lk, block_q, block_k, causal, window, head_dim): every config of
    the h100 space at n = 2048, causal and full, plus the card's
    attention_kernel_cases shapes: whisper's block_k 4 over 1500 keys,
    recurrentgemma's 2048 window at L = 4096, queries in the last slots."""
    h100 = t_hw.get_profile("h100")
    space = attention_space(Workload(op="attention", n=2048, batch=64,
                                     variant="flash"), h100)
    cases = [(2048, 2048, c["block_q"], c["block_k"], causal, None, 64)
             for c in space.enumerate_valid() for causal in (True, False)]
    return cases + [(64, 1500, 64, 4, False, None, 64),
                    (4096, 4096, 256, 512, True, 2048, 256),
                    (512, 2048, 128, 256, True, None, 64),
                    (512, 2048, 256, 128, True, 1024, 128),
                    (128, 384, 64, 128, True, None, 16)]


@pytest.mark.parametrize("lq,lk,bq,bk,causal,window,d", _h100_cases())
def test_wgmma_steps_cover_exactly_the_live_blocks(lq, lk, bq, bk, causal,
                                                   window, d):
    """Per query block, the kernel's steps (kt keys from k_start, keys past
    k_end scoring -inf) process exactly the keys of the TPU's live
    k-blocks: the live set is one run, so block_k stays the knob that
    decides which keys count."""
    offset = lk - lq
    kt = t_space.flash_wgmma_geometry(d)["kt"]
    for qi in range(lq // bq):
        k_start, k_end, starts = t_kernel.wgmma_steps(
            lk, bq, bk, qi, offset, causal, window, d)
        live = {key for ki in range(lk // bk)
                if t_kernel._live(qi, ki, bq, bk, offset, causal, window)
                for key in range(ki * bk, (ki + 1) * bk)}
        stepped = {key for s in starts for key in range(s, s + kt)
                   if key < k_end}
        assert stepped == live
        assert starts == list(range(k_start, k_end, kt))
        assert kt >= 16 and kt % 16 == 0


@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_flash_wgmma_footprint_fits_at_every_head_dim(d):
    geo = t_space.flash_wgmma_geometry(d)
    assert geo["smem"] == t_space.flash_wgmma_smem_bytes(d) \
        <= t_space.CUDA_SMEM_LIMIT
    # S (64 x kt) and O (64 x dp) f32 in a warpgroup's registers: kt / 2 +
    # dp / 2 a thread, at most 160
    assert geo["kt"] // 2 + geo["dp"] // 2 <= 160
    assert geo["dp"] % 64 == 0 and geo["stages"] >= 2


@pytest.mark.parametrize("n", [128, 256, 1500, 2048, 4096])
def test_h100_attention_space_keeps_its_members(n):
    """Admitting by both kernels' footprints keeps every config the f32
    kernel's footprint admitted: the bf16 kernel's is fixed per head dim
    and fits at all of them."""
    h100 = t_hw.get_profile("h100")
    wl = Workload(op="attention", n=n, batch=64, variant="flash")
    space = attention_space(wl, h100)
    f32_only = [c for c in space.enumerate_all() if c["block_k"] <= n
                and c["block_q"] <= n
                and max(t_space.flash_smem_bytes(c["block_q"], c["block_k"],
                                                 hd)
                        for hd in t_space.FLASH_HEAD_DIMS)
                <= t_space.CUDA_SMEM_LIMIT]
    assert space.enumerate_valid() == f32_only
    for cfg in f32_only:
        for hd in t_space.FLASH_HEAD_DIMS:
            assert t_space.flash_wgmma_smem_bytes(hd) \
                <= t_space.CUDA_SMEM_LIMIT
            assert t_space.flash_smem_bytes(cfg["block_q"], cfg["block_k"],
                                            hd) <= t_space.CUDA_SMEM_LIMIT


def test_flash_routes_are_fixed_by_type():
    assert t_kernel.ROUTES == {torch.bfloat16: "wgmma",
                               torch.float32: "simt"}
    q = torch.zeros(2, 64, 64)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        t_kernel._launch(q, q, q, 64, 64, True, None, route="wgmma")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        t_kernel.flash_attention_simt(q, q, q, block_q=64, block_k=64)
    before = (t_kernel.flash_attention.launches_wgmma,
              t_kernel.flash_attention.launches_simt)
    t_kernel.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(),
                             block_q=64, block_k=64)
    assert (t_kernel.flash_attention.launches_wgmma,
            t_kernel.flash_attention.launches_simt) == before
