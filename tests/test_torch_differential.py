"""The port's differential table (``repro_torch.evaluation.differential``)
held against the JAX package's (``tests/conftest.py`` ``_KERNEL_TABLE``).

Coverage is opt-out-proof, as ``test_kernels_differential.py`` makes it for
the JAX package: every ``registered_kernels()`` entry point of the port
must have a row, so a tuned entry point added without one fails here.
Each case feeds the same numpy inputs to the JAX entry point, run as its
runner in ``conftest.py`` runs it (Pallas in interpret mode, the JAX
session's tpu_v5e configs), and to the port's entry point on CPU tensors
with ``config=None`` (the port session's h100 configs, the kernels' plain
versions): the outputs agree at DTYPE_TOL x the row's scale, the
tolerance the JAX table holds each entry point to against its reference.
``chip_smoke.py`` ``[differential]`` runs the same table on the card.
"""
import numpy as np
import pytest
import torch

from conftest import _KERNEL_TABLE, kernel_ops_entries
from repro_torch.core.space import Workload
from repro_torch.evaluation import differential as diff
from repro_torch.hw.profiles import get_profile
from repro_torch.kernels.matmul import kernel as mm_kernel
from repro_torch.tuning import (TunerSession, default_session,
                                set_default_session)
from repro_torch.tuning import registry as t_registry

CASES = list(diff.cases())
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The SSD plain versions run thousands of small float64 ops; beside
    other busy test workers torch's thread pool only slows them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def h100_session(tmp_path_factory):
    """The port resolves as on the card: a default session under h100, on
    an empty DB of its own."""
    path = tmp_path_factory.mktemp("differential") / "tuning_db.json"
    previous = set_default_session(TunerSession(db_path=str(path),
                                                spec=get_profile("h100")))
    yield
    set_default_session(previous)


# ---------------------------------------------------------------------------
# Coverage
# ---------------------------------------------------------------------------

def test_table_covers_every_registered_entry_point():
    assert diff.missing_rows() == []
    assert diff.registered_entries() == sorted(
        {"prefix_sum", "linear_recurrence", "solve", "fft", "ssd", "rglru",
         "attention", "matmul"})


def test_an_entry_point_without_a_row_fails_coverage(monkeypatch):
    spec = t_registry.get_kernel("matmul")
    monkeypatch.setitem(t_registry._KERNELS, "new_entry",
                        t_registry.KernelSpec(op="matmul",
                                              entry_name="new_entry",
                                              space=spec.space,
                                              kernel=spec.kernel))
    assert diff.missing_rows() == ["new_entry"]


def test_table_holds_every_row_of_the_jax_table():
    """Every JAX row, at its dtypes and shapes; the port adds one row, the
    bf16 matmul at a prime N."""
    assert set(diff.TABLE) == set(kernel_ops_entries()) | {"matmul_prime_n"}
    for entry, (_, dtypes, shapes) in _KERNEL_TABLE.items():
        row = diff.TABLE[entry]
        assert (row.dtypes, tuple(row.shapes)) == (tuple(dtypes),
                                                   tuple(shapes)), entry
    assert len(CASES) == 42


def test_inputs_are_seeded_and_typed():
    for entry, dtype, batch, n in CASES:
        first = diff.TABLE[entry].make(batch, n)
        again = diff.TABLE[entry].make(batch, n)
        assert first.keys() == again.keys()
        for key in first:
            assert np.array_equal(first[key], again[key])
            assert first[key].dtype in (np.float32, np.complex64)


# ---------------------------------------------------------------------------
# The JAX entry points, as conftest.py's runners call them
# ---------------------------------------------------------------------------

def _jax(entry, inputs, dtype, n):
    import jax.numpy as jnp

    from repro.kernels.attention.ops import attention
    from repro.kernels.fft.ops import fft
    from repro.kernels.matmul.ops import matmul
    from repro.kernels.rglru.ops import rglru
    from repro.kernels.scan.ops import linear_recurrence, prefix_sum
    from repro.kernels.ssd.ops import ssd
    from repro.kernels.tridiag import ops as tridiag

    t = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in inputs.items()}
    radix = {"prefix_sum_radix3": 3, "prefix_sum_radix8": 8,
             "linear_recurrence_radix8": 8, "fft_radix3": 3,
             "fft_radix8": 8}.get(entry)
    if entry.startswith("prefix_sum"):
        cfg = {"radix": radix, "tile_n": n} if radix else None
        return prefix_sum(t["x"], config=cfg, interpret=True,
                          use_pallas=True)
    if entry.startswith("linear_recurrence"):
        cfg = {"radix": radix, "tile_n": n} if radix else None
        return linear_recurrence(t["a"], t["b"], config=cfg, interpret=True,
                                 use_pallas=True)
    if entry.startswith("solve_"):
        return tridiag.solve(t["a"], t["b"], t["c"], t["d"],
                             variant=entry[len("solve_"):])
    if entry.startswith("fft"):
        return fft(t["x"], config={"radix": radix} if radix else None,
                   interpret=True)
    if entry.startswith("matmul"):
        return matmul(t["a"], t["b"], interpret=True, use_pallas=True)
    if entry == "ssd":
        return ssd(t["x"], t["a"], t["b"], t["c"], interpret=True)
    if entry == "ssd_fused":
        cfg = {"tile_n": min(128, n), "radix": 2}
        return jnp.stack([
            ssd(t["x"], t["a"], t["b"], t["c"], config=dict(cfg, fuse=fuse),
                interpret=True, use_pallas=True) for fuse in (1, 0)])
    if entry == "rglru":
        return rglru(t["a"], t["u"], interpret=True)
    if entry == "rglru_fused":
        cfg = {"tile_n": min(128, n), "rows_per_program": 8, "radix": 2}
        return jnp.stack([
            rglru(t["a"], t["u"], config=dict(cfg, fuse=fuse),
                  interpret=True, use_pallas=True) for fuse in (1, 0)])
    if entry == "attention":
        return attention(t["q"], t["k"], t["v"], causal=True, interpret=True,
                         use_pallas=True)
    raise AssertionError(f"no JAX call for {entry}")


def _numpy(out) -> torch.Tensor:
    out = np.array(out)
    if not np.iscomplexobj(out):
        out = out.astype(np.float32)
    return torch.from_numpy(out)


@pytest.mark.parametrize("entry,dtype,batch,n", CASES,
                         ids=[f"{e}-{d}-b{b}-n{n}" for e, d, b, n in CASES])
def test_case_matches_the_jax_entry_point(entry, dtype, batch, n):
    row = diff.TABLE[entry]
    inputs = row.make(batch, n)
    got, configs = diff.run_case(entry, diff.tensors(inputs, dtype, CPU))
    want = _numpy(_jax(entry, inputs, dtype, n))
    assert tuple(got.shape) == tuple(want.shape)
    ok, err = diff.close(got.float() if dtype == "bfloat16" else got, want,
                         dtype, row.scale)
    assert ok, f"{entry} {dtype} b{batch} n{n}: max err {err:.3e}"
    if entry.endswith("_fused"):
        assert diff.close(got[0], got[1], dtype, row.scale)[0]
    # replaying the configs the call resolved gives the same call
    again, replayed = diff.run_case(entry, diff.tensors(inputs, dtype, CPU),
                                    configs)
    assert replayed == configs and torch.equal(again, got)


def test_close_is_the_tests_assert_kernel_close():
    from conftest import assert_kernel_close
    ref = torch.linspace(-3, 3, 64, dtype=torch.float64)
    for dtype, (rtol, atol) in diff.DTYPE_TOL.items():
        if dtype == "complex64":
            continue
        inside = ref + 0.9 * (atol * 3 + rtol * ref.abs())
        outside = ref + 1.1 * (atol * 3 + rtol * ref.abs())
        assert diff.close(inside, ref, dtype)[0]
        assert_kernel_close(inside.numpy(), ref.numpy(), dtype)
        assert not diff.close(outside, ref, dtype)[0]
        with pytest.raises(AssertionError):
            assert_kernel_close(outside.numpy(), ref.numpy(), dtype)


# ---------------------------------------------------------------------------
# The bf16 matmul repair, on the host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(33, 65, 96), (55, 65, 128),
                                   (33, 65, 97)])
def test_bf16_matmul_at_the_tables_shapes_takes_a_route_that_accepts_it(
        m, k, n):
    """Under h100, the config ``matmul`` resolves at K = 65 has block_k 65
    (and at N = 97 block_n 97): the tensor-core kernel's plan refuses it,
    so the route is the CUDA-core kernel's, whose launch takes it."""
    assert default_session().spec.name == "h100"
    cfg = default_session().resolve(
        Workload(op="matmul", n=n, batch=m, variant="tiled"),
        dims={"m": m, "k": k})
    a = torch.zeros(m, k, dtype=torch.bfloat16)
    b = torch.zeros(k, n, dtype=torch.bfloat16)
    assert mm_kernel.matmul_route(a, b, cfg["block_k"]) == "ragged"
    with pytest.raises(ValueError):
        mm_kernel.wgmma_plan(m, n, k, cfg["block_m"], cfg["block_n"],
                             cfg["block_k"])
    mm_kernel._check_args(a, b, cfg["block_m"], cfg["block_n"],
                          cfg["block_k"])
    assert m // cfg["block_m"] <= 65535
    # f32 keeps the CUDA-core route, and qwen's MLP shape the tensor cores
    assert mm_kernel.matmul_route(a.float(), b.float(),
                                  cfg["block_k"]) == "simt"
    big_a = torch.zeros(64, 1024, dtype=torch.bfloat16)
    big_b = torch.zeros(1024, 2816, dtype=torch.bfloat16)
    assert mm_kernel.matmul_route(big_a, big_b, 256) == "wgmma"


def test_a_base_address_off_tma_alignment_takes_the_ragged_route():
    buf = torch.zeros(64 * 64 + 8, dtype=torch.bfloat16)
    a = buf[1:1 + 64 * 64].view(64, 64)      # 2 bytes past an aligned start
    b = torch.zeros(64, 64, dtype=torch.bfloat16)
    assert a.data_ptr() % 16 and mm_kernel.matmul_route(a, b, 64) == "ragged"
    aligned = buf[8:8 + 64 * 64].view(64, 64)   # 16 bytes past it
    assert mm_kernel.matmul_route(aligned, b, 64) == "wgmma"


def test_the_ragged_route_counts_nothing_on_the_cpu():
    fn = mm_kernel.matmul_tiled
    before = (fn.launches, fn.launches_wgmma, fn.launches_ragged,
              fn.launches_simt)
    a = torch.randn(33, 65).bfloat16()
    b = torch.randn(65, 97).bfloat16()
    out = fn(a, b, block_m=33, block_n=97, block_k=65)
    assert torch.equal(out, mm_kernel.matmul_plain(a, b, block_m=33,
                                                   block_n=97, block_k=65))
    assert (fn.launches, fn.launches_wgmma, fn.launches_ragged,
            fn.launches_simt) == before
