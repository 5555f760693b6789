"""The port's optimizers, schedules, clipping and gradient compression
(``repro_torch.optim``) against the JAX package's (``repro.optim``).

Both packages get the same numpy inputs, drawn from seeds.  The
optimizers run three steps on the same params and grads (a leaf stacked
over two layers, a top-level vector and a bf16 matrix): params and state
at f32 ``DTYPE_TOL``.  The int8 compression is exactly equal, and so are
the schedules' warm-up and the clip where the norm's sums are exact in
any order; the cosine branch differs by the libraries' f32 ``cos`` alone
(a bound derived in its test), and the clip of normal grads by XLA's and
torch's order of summation (``DTYPE_TOL``).  The JAX package's own cases
of ``tests/test_optim.py``
follow, on the port.  ``psum_compressed`` in a group of one equals JAX's
single-participant result, and over a gloo group of four processes on
the CPU equals JAX's four-participant ``vmap`` over the pod axis at f32
``DTYPE_TOL``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import _rng, assert_kernel_close
from repro import optim as j_optim
from repro.optim import compression as j_comp
from repro_torch import optim as t_optim
from repro_torch.optim import compression as t_comp
from repro_torch.optim.tree import flatten_with_path, tree_map


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jax(tree):
    return jax.tree.map(lambda a: jnp.asarray(a), tree)


def _torch(tree):
    def conv(a):
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.asarray(a).view(np.uint16).copy()
                                    ).view(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return tree_map(conv, jax.tree.map(np.asarray, tree))


def _params(seed):
    rng = _rng(f"optim-params{seed}")
    return {"blocks": {"ln1": rng.normal(size=(2, 16)).astype(np.float32),
                       "w": rng.normal(size=(2, 16, 8)).astype(np.float32)},
            "final_norm": rng.normal(size=(16,)).astype(np.float32),
            "embed": jnp.asarray(rng.normal(size=(12, 16)), jnp.bfloat16)}


def _grads(params, step):
    rng = _rng(f"optim-grads{step}")
    return jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape) * 0.1, p.dtype),
        _jax(params))


def _close(got, want):
    got, want = dict(flatten_with_path(got)), dict(flatten_with_path(want))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == _torch(want[key]).dtype, key
        assert_kernel_close(_np(got[key]), _np(want[key]), "float32")


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}), ("adamw", {"weight_decay": 0.0}),
    ("adafactor", {}), ("adafactor", {"weight_decay": 0.1})])
def test_optimizer_steps_match_repro(name, kw):
    """Three steps: the stacked (2, d) ln1 decays under AdamW (two axes)
    and factors under Adafactor; the top-level vector does neither."""
    lr = j_optim.warmup_cosine(1e-2, 1, 10)
    j_init, j_update = getattr(j_optim, name)(lr, **kw)
    t_init, t_update = getattr(t_optim, name)(
        t_optim.warmup_cosine(1e-2, 1, 10), **kw)
    params = _jax(_params(0))
    jstate, tparams = j_init(params), _torch(params)
    tstate = t_init(tparams)
    _close(tuple(tstate), tuple(jstate))
    for step in range(3):
        g = _grads(params, step)
        params, jstate = j_update(g, jstate, params)
        tparams, tstate = t_update(_torch(g), tstate, tparams)
        _close(tparams, params)
        _close(tuple(tstate), tuple(jstate))
    assert int(tstate.count) == int(jstate.count) == 3
    assert tstate.count.dtype == torch.int32


def test_adamw_decays_stacked_leaves_as_repro_does():
    """``p.ndim >= 2`` on the stacked tree: the (2, d) norm scale decays,
    the top-level vector does not (zero grads isolate the decay)."""
    _, update = t_optim.adamw(1.0, weight_decay=0.5)
    params = _torch(_params(1))
    zeros = tree_map(torch.zeros_like, params)
    new, _ = update(zeros, t_optim.adamw(1.0)[0](params), params)
    assert torch.equal(new["final_norm"], params["final_norm"])
    assert torch.allclose(new["blocks"]["ln1"], params["blocks"]["ln1"] * 0.5)


def test_schedules_equal_repro():
    """The warm-up and every f32 operation equal; the cosine's f32 ``cos``
    is the two libraries' own (XLA's CPU cos and torch's each miss the
    correctly rounded value by one ulp at some arguments: at (3e-4, 10,
    100) XLA's at step 42, torch's at 12, 80, 82 and 98).  The cosine
    branch is peak * (floor + 0.45 (1 + cos)): one ulp of |cos| <= 1 (at
    most 2^-24 apart) moves it by peak * 0.45 * 2^-24, and its three
    roundings after the cos by one ulp of the result each."""
    for args in ((3e-4, 10, 100), (1.0, 0, 5), (2e-3, 7, 7)):
        jl, tl = j_optim.warmup_cosine(*args), t_optim.warmup_cosine(*args)
        for step in range(0, 130):
            want = np.float32(jl(jnp.asarray(step, jnp.int32)))
            got = tl(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            if step < args[1] or step >= args[2]:   # no cos, or cos(pi)
                assert np.float32(got) == want, (args, step)
            else:
                bound = args[0] * 0.45 * 2.0 ** -24 + 3 * np.spacing(want)
                assert abs(np.float32(got) - want) <= bound, (args, step)
    got = t_optim.constant(3e-4)(torch.tensor(5, dtype=torch.int32))
    assert np.float32(got) == np.float32(
        j_optim.constant(3e-4)(jnp.asarray(5)))


def _dyadic(seed):
    """Leaves of k / 64, |k| <= 256: every partial sum of their squares is
    exact in f32, so any order of summation gives the same norm."""
    rng = _rng(f"dyadic{seed}")
    return jax.tree.map(
        lambda p: jnp.asarray(rng.integers(-256, 257, size=p.shape) / 64.0,
                              p.dtype), _jax(_params(seed)))


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_equals_repro_exactly(max_norm):
    """The norm in f32 and each grad back in its own type (bf16 too):
    exactly JAX's where the sums are exact in any order."""
    grads = _dyadic(2)
    jc, jn = j_optim.clip_by_global_norm(grads, max_norm)
    tc, tn = t_optim.clip_by_global_norm(_torch(grads), max_norm)
    assert np.float32(tn) == np.float32(jn)
    assert np.float32(t_optim.global_norm(_torch(grads))) \
        == np.float32(j_optim.global_norm(grads))
    for (key, got), (_, want) in zip(flatten_with_path(tc),
                                     flatten_with_path(_torch(jc))):
        assert got.dtype == want.dtype, key
        assert torch.equal(got, want), key


def test_clip_of_normal_grads_matches_repro():
    """Normal grads: XLA and torch sum each leaf's squares in another
    order, so the norm may differ in its last bits; DTYPE_TOL."""
    grads = _jax(_params(3))
    jc, jn = j_optim.clip_by_global_norm(grads, 1.0)
    tc, tn = t_optim.clip_by_global_norm(_torch(grads), 1.0)
    assert_kernel_close(_np(tn), _np(jn), "float32")
    _close(tc, jc)


def test_compression_equals_repro_exactly():
    rng = _rng("compress")
    g = rng.normal(size=(3, 257)).astype(np.float32)
    err = (rng.normal(size=(3, 257)) * 1e-3).astype(np.float32)
    # ties at .5 of the scale: round half to even in both
    g[0, :4] = np.float32([0.5, 1.5, 2.5, -0.5]) * (127.0 / 2.5)
    jq, js, je = j_comp.compress(jnp.asarray(g), jnp.zeros_like(g))
    tq, ts, te = t_comp.compress(torch.from_numpy(g), torch.zeros(3, 257))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert np.float32(ts) == np.float32(js)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    tree = {"a": g, "b": {"c": jnp.asarray(g[:2, :64], jnp.bfloat16)}}
    errs = {"a": err, "b": {"c": err[:2, :64]}}
    jd, jerr = j_comp.ef_roundtrip(_jax(tree), _jax(errs))
    td, terr = t_comp.ef_roundtrip(_torch(_jax(tree)), _torch(_jax(errs)))
    for got, want in ((td, jd), (terr, jerr)):
        for (key, a), (_, b) in zip(flatten_with_path(got),
                                    flatten_with_path(_torch(want))):
            assert a.dtype == b.dtype and torch.equal(a, b), key
    np.testing.assert_array_equal(
        t_comp.decompress(tq, ts, torch.bfloat16).float().numpy(),
        np.asarray(j_comp.decompress(jq, js, jnp.bfloat16), np.float32))
    zero = t_comp.init_error(_torch(_jax(tree)))
    assert zero["b"]["c"].dtype == torch.float32
    assert not zero["a"].any()


def _jax_psum(rows):
    """JAX's psum_compressed with one participant a row of ``rows``."""
    return np.asarray(jax.vmap(lambda v: j_comp.psum_compressed(v, "pod"),
                               axis_name="pod")(jnp.asarray(rows)))


def test_psum_compressed_alone_equals_repro():
    x = _rng("psum_single").normal(size=(5, 33)).astype(np.float32)
    got = t_comp.psum_compressed(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _jax_psum(x[None])[0])


_PSUM_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.optim.compression import psum_compressed


def run(rank, store, inputs, out):
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=4)
    try:
        x = torch.from_numpy(np.load(inputs)[rank])
        np.save(out + f".{rank}.npy", psum_compressed(x).numpy())
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    mp.spawn(run, args=tuple(sys.argv[1:4]), nprocs=4)
"""


def test_psum_compressed_over_four_gloo_ranks_equals_repro(tmp_path):
    import subprocess
    import sys

    x = _rng("psum_pod").normal(size=(4, 3, 130)).astype(np.float32)
    x[2] *= 9.0                     # one rank sets the common grid
    np.save(tmp_path / "x.npy", x)
    script = tmp_path / "worker.py"
    script.write_text(_PSUM_WORKER)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "store"),
         str(tmp_path / "x.npy"), str(tmp_path / "out")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = _jax_psum(x)
    for rank in range(4):
        got = np.load(tmp_path / f"out.{rank}.npy")
        assert_kernel_close(got, want[rank], "float32")


# --- the JAX package's own cases (tests/test_optim.py), on the port ---

def _quadratic_descends(make_opt):
    init, update = make_opt
    params = {"w": torch.tensor([3.0, -2.0, 1.5]), "b": torch.tensor(4.0)}
    state = init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    l0 = float(loss(params))
    for _ in range(60):
        grads = {k: 2 * v for k, v in params.items()}
        params, state = update(grads, state, params)
    return l0, float(loss(params))


def test_adamw_descends():
    l0, l1 = _quadratic_descends(t_optim.adamw(0.1, weight_decay=0.0))
    assert l1 < l0 * 0.05


def test_adafactor_descends():
    l0, l1 = _quadratic_descends(t_optim.adafactor(0.3))
    assert l1 < l0 * 0.3


def test_adafactor_state_is_factored():
    init, _ = t_optim.adafactor(0.1)
    st = init({"w": torch.zeros(64, 32)})
    assert st.vr["w"].shape == (64,)
    assert st.vc["w"].shape == (32,)


def test_warmup_cosine_shape():
    lr = t_optim.warmup_cosine(1.0, 10, 100)
    assert float(lr(torch.tensor(0))) == pytest.approx(0.0)
    assert float(lr(torch.tensor(10))) == pytest.approx(1.0, rel=0.1)
    assert float(lr(torch.tensor(100))) == pytest.approx(0.1, rel=0.05)


def test_clip_by_global_norm():
    clipped, norm = t_optim.clip_by_global_norm({"a": torch.full((4,), 10.0)},
                                                1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(t_optim.global_norm(clipped)) == pytest.approx(1.0,
                                                                rel=1e-4)


def test_compression_roundtrip_bounded():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(256,))
                         .astype(np.float32))
    q, s, _ = t_comp.compress(g, torch.zeros_like(g))
    deq = t_comp.decompress(q, s)
    assert float(torch.max(torch.abs(deq - g))) <= float(s) + 1e-9


def test_error_feedback_accumulates():
    """With error feedback the bias of repeated quantization vanishes in
    aggregate."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    err = torch.zeros_like(g_true)
    total = torch.zeros_like(g_true)
    for _ in range(50):
        applied, errs = t_comp.ef_roundtrip({"g": g_true}, {"g": err})
        err = errs["g"]
        total += applied["g"]
    np.testing.assert_allclose((total / 50).numpy(), g_true.numpy(),
                               atol=1e-3)
