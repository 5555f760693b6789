"""Kernel 10 (``ssd_apply_entry``, the unfused SSD phase C): its route and
the tiled kernel's schedule, replayed on the CPU.

The tiled kernel (``csrc/ssd.cu`` ``ssd_apply_entry_tiled_kernel``) gives
each (row, chunk, panel of 128 t rows) a block: one warp sums the
decay chain from the chunk's start to the panel's last row (32 positions
at a time, eight groups of 32 a load) and writes exp(la) of the panel's
rows; the consumer warps own 16 rows each, a lane an 8 x 4 tile (rows
r + 2 i, r = 16 w + ty; columns 4 tx + jj, the lanes past P reading the
last four) of c . entry, one fused multiply-add chain in ascending k, four
k a 128-bit load; then out = y + acc * exp(la).  ``replay_apply_entry``
walks that schedule in torch with ``_fma`` for each ``__fmaf_rn`` and must
equal ``ssd_apply_entry_plain`` bit for bit; mutations of its index maps
and of the chain's start must not.  The route is a pure function of (P,
S, chunk), held here; on the CPU the wrapper runs the plain version and
counts no launch, and a forced route needs CUDA tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import _rng, assert_kernel_close
from repro.kernels.ssd.kernel import ssd_apply_entry_pallas
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd.kernel import (_fma, _groups, ssd_apply_entry,
                                            ssd_apply_entry_plain,
                                            ssd_apply_entry_route)

PANEL = 128              # t rows of a block (csrc/ssd.cu kEntryRows)
WARP_ROWS = 16           # t rows of a consumer warp (csrc/ssd.cu kWarpRows)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The replays are thousands of small torch ops.  Beside other busy
    test processes, torch's pool of threads makes each of them wait (one
    replay took 42.6 s with 8 threads and 1.2 s with one, next to five
    processes multiplying matrices on an 8-core host), so this module runs
    on one thread, as each op here fits one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(tag, BH, G, L, P, S, chunk, dtype, strong):
    """y, a, c in ``dtype`` and the entry states (f32), from numpy."""
    rng = _rng(f"applyentry{tag}{BH}{G}{L}{P}{S}{chunk}{strong}")
    y = rng.normal(size=(BH, L, P))
    a = rng.uniform(0.85, 0.999, size=(BH, L)) * (0.01 if strong else 1.0)
    c = rng.normal(size=(G, L, S)) * 0.3
    e = rng.normal(size=(BH, L // chunk, S, P))
    t = [torch.from_numpy(v.astype(np.float32)) for v in (y, a, c, e)]
    return [v.to(dtype) for v in t[:3]] + t[3:]


def _rows(w, ty, i):
    return w * WARP_ROWS + ty + 2 * i


def _cols(tx, jj, P):
    return torch.clamp(4 * tx, max=P - 4) + jj


def replay_apply_entry(y, a, c, entry, chunk, rows_of=_rows, cols_of=_cols,
                       chain_from_panel=False):
    """The tiled kernel's schedule on the CPU, all (row, chunk) blocks of a
    panel at once.  ``rows_of`` / ``cols_of`` map a lane's tile to the rows
    and columns its products read (the writes keep the kernel's map), and
    ``chain_from_panel`` restarts the chain at the panel: the mutations."""
    BH, L, P = y.shape
    S = c.shape[-1]
    Q, nc = chunk, L // chunk
    yf = y.to(torch.float32).reshape(BH, nc, Q, P)
    cf = _groups(c, BH).reshape(BH, nc, Q, S)
    lg = torch.log(torch.clamp_min(a.to(torch.float32), 1e-30)) \
        .reshape(BH, nc, Q)
    out = torch.full((BH, nc, Q, P), float("nan"))
    warps = PANEL // WARP_ROWS
    w = torch.arange(warps)[:, None, None, None, None]   # (w, ty, i, tx, jj)
    ty = torch.arange(2)[None, :, None, None, None]
    i = torch.arange(8)[None, None, :, None, None]
    tx = torch.arange(16)[None, None, None, :, None]
    jj = torch.arange(4)[None, None, None, None, :]
    shape = (warps, 2, 8, 16, 4)
    t_write = _rows(w, ty, i).expand(shape)
    p_write = (4 * tx + jj).expand(shape)
    t_read = rows_of(w, ty, i).expand(shape)
    p_read = cols_of(tx, jj, P).expand(shape)
    for t0 in range(0, Q, PANEL):
        rows = min(PANEL, Q - t0)
        # the chain warp: la from the chunk's start, 8 x 32 positions a load
        am = torch.empty(BH, nc, PANEL)
        run = torch.zeros(BH, nc)
        start = t0 if chain_from_panel else 0
        for base in range(start, t0 + rows, 256):
            for m in range(8):
                b = base + 32 * m
                for k in range(min(32, t0 + rows - b)):
                    run = run + lg[..., b + k]
                    if b + k >= t0:
                        am[..., b + k - t0] = torch.exp(run)
        # the consumers: rows past the chunk read zeros (their outputs are
        # never written)
        cpan = torch.zeros(BH, nc, PANEL, S)
        cpan[:, :, :rows] = cf[:, :, t0:t0 + rows]
        acc = torch.zeros((BH, nc) + shape)
        for k in range(0, S, 4):
            for kk in range(4):
                cv = cpan[:, :, t_read, k + kk]
                ev = entry[:, :, k + kk][:, :, p_read]
                acc = _fma(cv, ev, acc)
        keep = (t_write < rows) & (p_write < P)
        ypan = torch.zeros(BH, nc, PANEL, P)
        ypan[:, :, :rows] = yf[:, :, t0:t0 + rows]
        amul = am[:, :, t_write.clamp(max=PANEL - 1)]
        val = ypan[:, :, t_write, p_write.clamp(max=P - 1)] + acc * amul
        out[:, :, t0 + t_write[keep], p_write[keep]] = val[:, :, keep]
    return out.reshape(BH, L, P).to(y.dtype)


CASES = [
    # BH, G, L, P, S, chunk: chunk 64, 100 (a ragged panel), 128 and 256
    # (two panels); nc 1, 3 and 16; (S, P) = (16, 8), (8, 16), (128, 64);
    # c shared by the rows of a group (G < BH)
    (2, 1, 64, 8, 16, 64),
    (2, 2, 192, 16, 8, 64),
    (2, 1, 1024, 8, 16, 64),
    (2, 1, 384, 64, 128, 128),
    (2, 1, 2048, 8, 16, 128),
    (1, 1, 256, 64, 128, 256),
    (2, 1, 768, 16, 8, 256),
    (2, 1, 300, 8, 16, 100),
]


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("BH,G,L,P,S,chunk", CASES)
def test_tiled_schedule_replays_the_plain_version(BH, G, L, P, S, chunk,
                                                  strong):
    y, a, c, e = _inputs("replay", BH, G, L, P, S, chunk, torch.float32,
                         strong)
    got = replay_apply_entry(y, a, c, e, chunk)
    want = ssd_apply_entry_plain(y, a, c, e, chunk=chunk)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("BH,G,L,P,S,chunk,strong", [
    (2, 1, 384, 16, 8, 128, False),
    (1, 1, 256, 64, 128, 256, False),
    (2, 2, 192, 16, 8, 64, False),
    (2, 1, 1024, 8, 16, 64, True),
    (2, 1, 300, 8, 16, 100, False)])
def test_tiled_schedule_replays_the_plain_version_in_bf16(
        BH, G, L, P, S, chunk, strong):
    """bf16 rows: y, c and out rounded, the products in f32."""
    y, a, c, e = _inputs("bf16", BH, G, L, P, S, chunk, torch.bfloat16,
                         strong)
    got = replay_apply_entry(y, a, c, e, chunk)
    want = ssd_apply_entry_plain(y, a, c, e, chunk=chunk)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("mutation", [
    {"rows_of": lambda w, ty, i: w * WARP_ROWS + 8 * ty + i},
    {"cols_of": lambda tx, jj, P: torch.clamp(4 * tx, max=P - 4) + 3 - jj},
    {"chain_from_panel": True}])
def test_a_mutated_schedule_fails_the_replay(mutation):
    """The replay sees the tile's row map, its column map and where the
    decay chain starts (chunk 256: two panels)."""
    y, a, c, e = _inputs("mutant", 1, 1, 256, 64, 128, 256, torch.float32,
                         False)
    want = ssd_apply_entry_plain(y, a, c, e, chunk=256)
    assert torch.equal(replay_apply_entry(y, a, c, e, 256), want)
    assert not torch.equal(replay_apply_entry(y, a, c, e, 256, **mutation),
                           want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_replay_matches_pallas(dtype):
    """The replayed schedule against the JAX kernel in interpret mode, at
    the shared tolerance (c broadcast to the rows, the JAX layout)."""
    y, a, c, e = _inputs("pallas", 2, 2, 256, 16, 8, 64,
                         {"float32": torch.float32,
                          "bfloat16": torch.bfloat16}[dtype], False)
    jy, ja, jc = (jnp.asarray(v.float().numpy()).astype(dtype)
                  for v in (y, a, c))
    want = ssd_apply_entry_pallas(jy, ja, jc, jnp.asarray(e.numpy()),
                                  chunk=64, interpret=True)
    got = replay_apply_entry(y, a, c, e, 64)
    assert_kernel_close(got.float().numpy(),
                        np.asarray(want.astype(jnp.float32)), dtype,
                        scale=10.0)


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,S,chunk,route", [
    (64, 128, 128, "tiled"), (64, 128, 1024, "tiled"),
    (64, 128, 4096, "tiled"), (16, 8, 64, "tiled"), (8, 16, 100, "tiled"),
    (64, 128, 1, "tiled"),
    (70, 130, 100, "block"),     # the ragged case: P, S not % 8
    (64, 130, 128, "block"),     # S not a multiple of 8
    (68, 128, 128, "block"),     # P not a multiple of 8
    (64, 256, 128, "block"),     # S above 128
    (128, 128, 128, "block"),    # P above the block's 64 columns
])
def test_the_route_is_a_function_of_the_shapes(P, S, chunk, route):
    assert ssd_apply_entry_route(P, S, chunk) == route


def test_cpu_calls_count_no_launch_and_forced_routes_raise():
    """On the CPU the wrapper runs the plain version (no launch counted on
    either route); a forced route, through the wrapper or the launcher,
    needs CUDA tensors."""
    y, a, c, e = _inputs("cpu", 2, 1, 128, 8, 16, 64, torch.float32, False)
    fn = ssd_apply_entry
    before = (fn.launches, fn.launches_tiled, fn.launches_block)
    assert torch.equal(fn(y, a, c, e, chunk=64),
                       ssd_apply_entry_plain(y, a, c, e, chunk=64))
    assert (fn.launches, fn.launches_tiled, fn.launches_block) == before
    for route in ("tiled", "block"):
        with pytest.raises(ValueError):
            fn(y, a, c, e, chunk=64, route=route)
        with pytest.raises(ValueError):
            ssd_kernel._launch_apply("ssd_apply_entry", y, a, c, 64, None, e,
                                     False, route=route)
    with pytest.raises(ValueError):
        ssd_kernel._launch_apply("ssd_apply_entry", y, a, c, 64, None, e,
                                 False, route="warp")
