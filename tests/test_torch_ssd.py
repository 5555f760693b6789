"""The port's SSD chain and Mamba-2 block on the CPU against the JAX
package's.

A CPU tensor runs the CUDA kernels' plain versions (``ssd_intra``,
``ssd_state_apply``, ``ssd_apply_entry``, and the linrec trio for phase B)
through the same chain plan, so this is where their arithmetic and their
launch lists are held against the Pallas kernels, run in interpret mode.
Inputs are made with numpy and handed to both packages; tolerances are the
shared ``DTYPE_TOL`` at scale 10, as the JAX suite holds its SSD op.
"""
import dataclasses
import importlib
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import _rng, assert_kernel_close
from repro import tuning as j_tuning
from repro.configs.mamba2_130m import CONFIG as J_MAMBA
from repro.core.space import Workload as JWorkload
from repro.kernels.blocks import driver as j_driver
from repro.kernels.ssd import ref as j_ref
from repro.kernels.ssd.kernel import (ssd_apply_entry_pallas,
                                      ssd_intra_pallas,
                                      ssd_state_apply_pallas)
from repro.kernels.ssd.ops import ssd as j_ssd
from repro.models.ssm import init_ssd_block, ssd_block
from repro.models.ssm import init_ssd_cache as j_init_ssd_cache
from repro_torch import tuning as t_tuning
from repro_torch.configs.mamba2_130m import CONFIG as T_MAMBA
from repro_torch.core.space import Workload as TWorkload
from repro_torch.kernels.blocks import driver as t_driver
from repro_torch.kernels.blocks.plan import plan_for_chain as t_plan_for_chain
from repro_torch.kernels.ssd import kernel as t_kernel
from repro_torch.kernels.ssd import ref as t_ref
from repro_torch.kernels.ssd.ops import ssd as t_ssd
from repro_torch.models.convert import load_params, state_dict_from_params
from repro_torch.models.ssm import SSDBlock, init_ssd_cache

j_hw = importlib.import_module("repro.hw.profiles")
t_hw = importlib.import_module("repro_torch.hw.profiles")

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(arr, dtype="float32"):
    arr = np.asarray(arr, np.float32)
    return (jnp.asarray(arr).astype(_JNP[dtype]),
            torch.from_numpy(arr.copy()).to(_TORCH[dtype]))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _asdicts(launches):
    return [dataclasses.asdict(l) for l in launches]


def _ssd_inputs(tag, B=2, L=256, H=2, P=16, S=8, dtype="float32",
                strong=False):
    """(x, a, b, c) for both packages, as the JAX suite draws them: x
    normal, a in [0.85, 0.999) (times 0.01 for a strong decay), b and c
    normal x 0.3."""
    rng = _rng(tag)
    x = rng.normal(size=(B, L, H, P))
    a = rng.uniform(0.85, 0.999, size=(B, L, H)) * (0.01 if strong else 1.0)
    b = rng.normal(size=(B, L, S)) * 0.3
    c = rng.normal(size=(B, L, S)) * 0.3
    pairs = [_both(v, dtype) for v in (x, a, b, c)]
    return tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)


@pytest.fixture
def pinned(monkeypatch, tmp_path):
    """Both packages on tpu_v5e: active profiles and default sessions
    (empty DBs), so they resolve the same configs and build the same
    chains."""
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


# ---------------------------------------------------------------------------
# The three kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

KERNEL_CASES = [
    # B, H, L, P, S, chunk: nc = 1, 3 (odd) and 4; (S, P) both ways round
    (2, 2, 64, 16, 8, 64),
    (1, 3, 96, 8, 16, 32),
    (2, 2, 256, 16, 8, 64),
    (1, 2, 128, 8, 16, 32),
]


def _rows(xj, aj, bj, cj, xt, at, bt, ct):
    """The kernels' (BH, L, .) layout: JAX pre-broadcasts b and c to every
    head, the port reads them per sequence (G = B)."""
    B, L, H, P = xt.shape
    S = bt.shape[-1]
    jx = jnp.transpose(xj, (0, 2, 1, 3)).reshape(B * H, L, P)
    ja = jnp.transpose(aj, (0, 2, 1)).reshape(B * H, L)
    jb = jnp.broadcast_to(bj[:, None], (B, H, L, S)).reshape(B * H, L, S)
    jc = jnp.broadcast_to(cj[:, None], (B, H, L, S)).reshape(B * H, L, S)
    tx = xt.permute(0, 2, 1, 3).reshape(B * H, L, P)
    ta = at.permute(0, 2, 1).reshape(B * H, L)
    return (jx, ja, jb, jc), (tx, ta, bt, ct)


@pytest.mark.parametrize("dtype,strong", [("float32", False),
                                          ("bfloat16", False),
                                          ("float32", True)])
@pytest.mark.parametrize("B,H,L,P,S,chunk", KERNEL_CASES)
def test_ssd_intra_plain_matches_pallas(dtype, strong, B, H, L, P, S, chunk):
    """Kernel 8: y_intra, a_chunk and state, with the per-sequence b / c of
    the port against the broadcast ones of the Pallas kernel."""
    (jx, ja, jb, jc), (tx, ta, tb, tc) = _rows(*_ssd_inputs(
        f"intra{B}{H}{L}{P}{S}{chunk}", B, L, H, P, S, dtype, strong)[0],
        *_ssd_inputs(f"intra{B}{H}{L}{P}{S}{chunk}", B, L, H, P, S, dtype,
                     strong)[1])
    jy, jac, jst = ssd_intra_pallas(jx, ja, jb, jc, chunk=chunk,
                                    interpret=True)
    ty, tac, tst = t_kernel.ssd_intra(tx, ta, tb, tc, chunk=chunk)
    assert ty.dtype == tx.dtype and tac.dtype == tst.dtype == torch.float32
    assert tac.shape == (B * H, L // chunk)
    assert tst.shape == (B * H, L // chunk, S, P)
    assert_kernel_close(_np(ty), _np(jy), dtype, scale=10.0)
    assert_kernel_close(_np(tac), _np(jac), dtype, scale=10.0)
    assert_kernel_close(_np(tst), _np(jst), dtype, scale=10.0)
    if strong:
        assert np.isfinite(_np(ty)).all() and np.isfinite(_np(tst)).all()
    # the shared b / c read per sequence equals the broadcast layout
    rep = (t_kernel._groups(tb, B * H).to(tb.dtype),
           t_kernel._groups(tc, B * H).to(tc.dtype))
    for got, want in zip(t_kernel.ssd_intra_plain(tx, ta, *rep, chunk=chunk),
                         (ty, tac, tst)):
        assert torch.equal(got, want)


def _apply_inputs(tag, BH, L, P, S, chunk, dtype):
    rng = _rng(tag)
    nc = L // chunk
    y = rng.normal(size=(BH, L, P))
    a = rng.uniform(0.85, 0.999, size=(BH, L))
    c = rng.normal(size=(BH, L, S)) * 0.3
    ac = rng.uniform(0.1, 0.9, size=(BH, nc)).astype(np.float32)
    st = rng.normal(size=(BH, nc, S, P)).astype(np.float32)
    pairs = [_both(v, dtype) for v in (y, a, c)]
    return ([p[0] for p in pairs] + [jnp.asarray(ac), jnp.asarray(st)],
            [p[1] for p in pairs] + [torch.from_numpy(ac),
                                     torch.from_numpy(st)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,L,P,S,chunk", [(3, 96, 16, 8, 32),
                                            (2, 256, 8, 16, 64),
                                            (4, 128, 16, 8, 128)])
def test_ssd_state_apply_plain_matches_pallas(dtype, BH, L, P, S, chunk):
    """Kernel 9: the fused carry over nc = 3, 4 and 1 chunks."""
    (jy, ja, jc, jac, jst), (ty, ta, tc, tac, tst) = _apply_inputs(
        f"stateapply{BH}{L}{chunk}", BH, L, P, S, chunk, dtype)
    want = ssd_state_apply_pallas(jy, ja, jc, jac, jst, chunk=chunk,
                                  interpret=True)
    got = t_kernel.ssd_state_apply(ty, ta, tc, tac, tst, chunk=chunk)
    assert got.dtype == ty.dtype and got.shape == ty.shape
    assert_kernel_close(_np(got), _np(want), dtype, scale=10.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,L,P,S,chunk", [(3, 96, 16, 8, 32),
                                            (2, 256, 8, 16, 64)])
def test_ssd_apply_entry_plain_matches_pallas(dtype, BH, L, P, S, chunk):
    """Kernel 10: each chunk's entry state applied, chunks independent."""
    (jy, ja, jc, _, jst), (ty, ta, tc, _, tst) = _apply_inputs(
        f"applyentry{BH}{L}{chunk}", BH, L, P, S, chunk, dtype)
    want = ssd_apply_entry_pallas(jy, ja, jc, jst, chunk=chunk,
                                  interpret=True)
    got = t_kernel.ssd_apply_entry(ty, ta, tc, tst, chunk=chunk)
    assert got.dtype == ty.dtype
    assert_kernel_close(_np(got), _np(want), dtype, scale=10.0)


def test_fused_apply_is_the_unfused_apply_of_the_scanned_carry():
    """ssd_state_apply equals ssd_apply_entry fed the entry states its own
    carry walks through (h_j = a_chunk_j h_{j-1} + state_j, one fma)."""
    _, (ty, ta, tc, tac, tst) = _apply_inputs("fusedvsentry", 2, 160, 8, 4,
                                              32, "float32")
    h = torch.zeros_like(tst[:, 0])
    entries = []
    for j in range(tst.shape[1]):
        entries.append(h)
        h = t_kernel._fma(tac[:, j, None, None], h, tst[:, j])
    entry = torch.stack(entries, dim=1)
    assert torch.equal(t_kernel.ssd_state_apply(ty, ta, tc, tac, tst,
                                                chunk=32),
                       t_kernel.ssd_apply_entry(ty, ta, tc, entry, chunk=32))


def test_plain_fma_rounds_once():
    """The plain versions' fused multiply-add rounds x * y + acc once, as
    __fmaf_rn does, where one f64 add and a rounding to f32 would round
    twice: x * y + acc = 1 + 3 * 2^-24 - 2^-60 (just below the tie between
    1 + 2^-23 and 1 + 2^-22) rounds to 1 + 2^-23; through float64 it lands
    on the tie and goes to the even 1 + 2^-22."""
    x = torch.tensor([2.0 ** -12 * (1 + 2.0 ** -18)])
    y = torch.tensor([2.0 ** -12 * (1 - 2.0 ** -18)])
    acc = torch.tensor([1 + 2.0 ** -23])
    assert t_kernel._fma(x, y, acc).item() == 1 + 2.0 ** -23
    assert (x.double() * y.double() + acc.double()).float().item() \
        == 1 + 2.0 ** -22
    # and the exact product-sum, rounded once, on random and subnormal
    # operands
    rng = _rng("plainfma")
    xs = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    ys = torch.from_numpy((rng.normal(size=4096)
                           * 2.0 ** rng.integers(-140, 20, 4096))
                          .astype(np.float32))
    cs = torch.from_numpy((rng.normal(size=4096)
                           * 2.0 ** rng.integers(-140, 20, 4096))
                          .astype(np.float32))
    got = t_kernel._fma(xs, ys, cs)
    for g, xv, yv, cv in zip(got.tolist(), xs.tolist(), ys.tolist(),
                             cs.tolist()):
        exact = Fraction(xv) * Fraction(yv) + Fraction(cv)
        lo, hi = np.nextafter(np.float32(g), np.float32(-np.inf)), \
            np.nextafter(np.float32(g), np.float32(np.inf))
        # no f32 neighbour of the result is nearer the exact value
        assert abs(Fraction(float(g)) - exact) <= abs(Fraction(float(lo))
                                                      - exact)
        assert abs(Fraction(float(g)) - exact) <= abs(Fraction(float(hi))
                                                      - exact)


@pytest.mark.parametrize("call,err", [
    (lambda x, a, b: t_kernel.ssd_intra(x, a, b, b, chunk=48), ValueError),
    (lambda x, a, b: t_kernel.ssd_intra(x, a, b[:1, :32], b[:1, :32],
                                        chunk=32), ValueError),
    (lambda x, a, b: t_kernel.ssd_intra(x, a, torch.cat([b, b[:1]]),
                                        torch.cat([b, b[:1]]), chunk=32),
     ValueError),                                   # 3 groups !| 4 rows
    (lambda x, a, b: t_kernel.ssd_intra(x.double(), a.double(), b.double(),
                                        b.double(), chunk=32), TypeError),
    (lambda x, a, b: t_kernel.ssd_intra(x, a.bfloat16(), b, b, chunk=32),
     TypeError),
    (lambda x, a, b: t_kernel.ssd_state_apply(
        x, a, b, torch.zeros(4, 3), torch.zeros(4, 2, 8, 16), chunk=32),
     ValueError),
    (lambda x, a, b: t_kernel.ssd_apply_entry(
        x, a, b, torch.zeros(4, 2, 8, 16, dtype=torch.float64), chunk=32),
     ValueError),
])
def test_ssd_kernels_reject_what_they_do_not_take(call, err):
    x, a, b = torch.randn(4, 64, 16), torch.rand(4, 64), torch.randn(2, 64, 8)
    with pytest.raises(err):
        call(x, a, b)


# ---------------------------------------------------------------------------
# The ssd op: outputs and launch lists against the JAX package's
# ---------------------------------------------------------------------------

def _run_both(inputs, config=None):
    (jx, ja, jb, jc), (tx, ta, tb, tc) = inputs
    with j_driver.capture_launches() as jl:
        jy = j_ssd(jx, ja, jb, jc, config=config, interpret=True,
                   use_pallas=True)
    with t_driver.capture_launches() as tl:
        ty = t_ssd(tx, ta, tb, tc, config=config)
    return jy, ty, list(jl), list(tl)


@pytest.mark.parametrize("fuse", [0, 1])
@pytest.mark.parametrize("L,chunk,dtype", [
    (512, 128, "float32"), (384, 128, "float32"), (128, 128, "float32"),
    (192, 64, "bfloat16")])
def test_ssd_matches_repro(pinned, fuse, L, chunk, dtype):
    """nc = 4, 3 (odd: the unfused phase B takes the associative-scan
    reference, the fused carry walks it), 1 (the intra kernel alone) and 3
    at chunk 64: outputs, launch lists equal to JAX's capture and to the
    chain plan, and the float64 sequential oracle."""
    inputs = _ssd_inputs(f"ssdop{L}{chunk}", L=L, dtype=dtype)
    cfg = {"tile_n": chunk, "radix": 2, "fuse": fuse}
    jy, ty, jl, tl = _run_both(inputs, cfg)
    assert ty.shape == inputs[1][0].shape and ty.dtype == _TORCH[dtype]
    assert _asdicts(tl) == _asdicts(jl)
    tx, _, tb, _ = inputs[1]
    B, _, H, P = tx.shape
    wl = TWorkload(op="ssd", n=L, batch=B * H, variant="chunked")
    assert tuple(tl) == t_plan_for_chain(wl, cfg, dims=(tb.shape[-1],
                                                        P)).launches
    nc = L // chunk
    names = [l.name for l in tl]
    if nc == 1:
        assert names == ["ssd"]
    elif fuse:
        assert names == ["ssd-intra", "ssd-state-apply"]
    else:
        assert names == ["ssd-intra"] + (["scan"] if nc % 2 == 0 else []) \
            + ["ssd-apply"]
    assert_kernel_close(_np(ty), _np(jy), dtype, scale=10.0)
    ref = t_ref.ssd_ref(*(v.double() for v in inputs[1]))
    assert_kernel_close(_np(ty), ref.numpy(), dtype, scale=10.0)


def test_ssd_resolved_config_matches_repro(pinned):
    """No config: both sessions resolve the same chunk / radix / fuse under
    tpu_v5e and run the same chain."""
    inputs = _ssd_inputs("ssdresolved", L=512)
    jy, ty, jl, tl = _run_both(inputs)
    assert _asdicts(tl) == _asdicts(jl) and tl
    wl = TWorkload(op="ssd", n=512, batch=4, variant="chunked")
    jwl = JWorkload(op="ssd", n=512, batch=4, variant="chunked")
    assert t_tuning.default_session().resolve(wl) \
        == j_tuning.default_session().resolve(jwl)
    assert_kernel_close(_np(ty), _np(jy), "float32", scale=10.0)


def test_ssd_override_reaches_embedded_phase_b(pinned):
    """The enclosing resolution is threaded into the embedded phase-B
    linrec block: a radix in ssd(config=...) or overrides(ssd=...) flips
    its stage decomposition, in both packages alike."""
    inputs = _ssd_inputs("ssdradix", L=512)
    for radix, stages in ((2, (2, 2)), (4, (4,))):
        _, ty, jl, tl = _run_both(inputs, {"tile_n": 128, "radix": radix,
                                           "fuse": 0})
        assert _asdicts(tl) == _asdicts(jl)
        assert [l.stages for l in tl if l.name == "scan"] == [stages]
    with j_tuning.overrides(ssd={"tile_n": 128, "radix": 4, "fuse": 0}), \
            t_tuning.overrides(ssd={"tile_n": 128, "radix": 4, "fuse": 0}):
        _, _, jl, tl = _run_both(inputs)
    assert _asdicts(tl) == _asdicts(jl)
    assert [l.stages for l in tl if l.name == "scan"] == [(4,)]


def test_ssd_strong_decay_stays_finite(pinned):
    """a x 0.01: the within-chunk decays underflow to 0 and nothing
    overflows (masked pairs never reach the exp)."""
    inputs = _ssd_inputs("ssdstrong", L=256, strong=True)
    for fuse in (0, 1):
        jy, ty, _, _ = _run_both(inputs, {"tile_n": 64, "fuse": fuse})
        assert np.isfinite(_np(ty)).all()
        assert_kernel_close(_np(ty), _np(jy), "float32", scale=10.0)


@pytest.mark.parametrize("chunk", [64, 128])
def test_ssd_refs_match_repro(chunk):
    (jx, ja, jb, jc), (tx, ta, tb, tc) = _ssd_inputs(f"ssdref{chunk}")
    assert_kernel_close(_np(t_ref.ssd_chunked_ref(tx, ta, tb, tc,
                                                  chunk=chunk)),
                        _np(j_ref.ssd_chunked_ref(jx, ja, jb, jc,
                                                  chunk=chunk)), "float32")
    assert_kernel_close(_np(t_ref.ssd_ref(tx, ta, tb, tc)),
                        _np(j_ref.ssd_ref(jx, ja, jb, jc)), "float32")


# ---------------------------------------------------------------------------
# The Mamba-2 block on mamba2_130m.reduced()
# ---------------------------------------------------------------------------

def test_mamba2_config_matches_repro():
    assert dataclasses.asdict(T_MAMBA) == dataclasses.asdict(J_MAMBA)
    assert dataclasses.asdict(T_MAMBA.reduced()) \
        == dataclasses.asdict(J_MAMBA.reduced())


def _blocks(seed):
    cfg = J_MAMBA.reduced()
    params = init_ssd_block(jax.random.PRNGKey(seed), cfg, jnp.float32)
    block = load_params(SSDBlock(T_MAMBA.reduced()),
                        jax.tree.map(np.asarray, params))
    return cfg, params, block


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_block_prefill_matches_repro(pinned, dtype):
    cfg, params, block = _blocks(0)
    x = _rng("blockprefill").normal(size=(2, 128, cfg.d_model)).astype(
        np.float32)
    jy, _ = ssd_block(params, jnp.asarray(x), cfg,
                      compute_dtype=_JNP[dtype])
    with torch.no_grad():
        ty, cache = block(torch.from_numpy(x), compute_dtype=_TORCH[dtype])
    assert cache is None and ty.dtype == _TORCH[dtype]
    assert_kernel_close(_np(ty), _np(jy), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_block_decode_step_matches_repro(dtype):
    """One token with a cache (a random conv window and state): the O(1)
    step's output and both new cache entries."""
    cfg, params, block = _blocks(1)
    rng = _rng("blockdecode")
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    jcache = j_init_ssd_cache(cfg, 3)
    conv = rng.normal(size=jcache["conv"].shape).astype(np.float32)
    state = rng.normal(size=jcache["state"].shape).astype(np.float32)
    jy, jnew = ssd_block(params, jnp.asarray(x), cfg,
                         cache={"conv": jnp.asarray(conv),
                                "state": jnp.asarray(state)},
                         compute_dtype=_JNP[dtype])
    tcache = init_ssd_cache(T_MAMBA.reduced(), 3)
    assert all(tuple(tcache[k].shape) == jcache[k].shape for k in tcache)
    with torch.no_grad():
        ty, tnew = block(torch.from_numpy(x),
                         cache={"conv": torch.from_numpy(conv),
                                "state": torch.from_numpy(state)},
                         compute_dtype=_TORCH[dtype])
    assert_kernel_close(_np(ty), _np(jy), dtype)
    assert_kernel_close(_np(tnew["state"]), _np(jnew["state"]), dtype)
    assert_kernel_close(_np(tnew["conv"]), _np(jnew["conv"]), dtype)


def test_ssd_block_parameters_carry_the_jax_names():
    cfg, params, block = _blocks(2)
    flat = state_dict_from_params(jax.tree.map(np.asarray, params))
    assert sorted(block.state_dict()) == sorted(flat) == sorted(
        ["in_proj.w", "conv_w", "a_log", "dt_bias", "norm_scale",
         "out_proj.w"])
    for key, value in block.state_dict().items():
        assert torch.equal(value, flat[key])
    with pytest.raises(KeyError):
        load_params(SSDBlock(T_MAMBA.reduced()), {"in_proj": params["in_proj"]})


def test_ssd_block_init_draws_at_the_jax_scales():
    """SSDBlock.init (the card's weights, no JAX there): the JAX init's
    shapes, types and scales."""
    cfg = T_MAMBA.reduced()
    block = SSDBlock.init(cfg, torch.Generator().manual_seed(0))
    params = init_ssd_block(jax.random.PRNGKey(0), J_MAMBA.reduced(),
                            jnp.float32)
    for key, value in state_dict_from_params(
            jax.tree.map(np.asarray, params)).items():
        mine = block.state_dict()[key]
        assert mine.shape == value.shape and mine.dtype == value.dtype, key
        assert abs(float(mine.std()) - float(value.std())) \
            <= 0.25 * float(value.std()) + 1e-6, key
    # log(linspace(1, 16, H)): the two packages' linspace may round apart
    np.testing.assert_allclose(_np(block.a_log), np.asarray(params["a_log"]),
                               rtol=1e-6, atol=1e-6)
