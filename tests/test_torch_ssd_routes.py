"""Which kernel an SSD phase-A, fused phase-B + C or unfused phase-C launch
runs on the card, decided by the shapes, and the tiled kernels' schedules
replayed (kernel 10's in ``test_torch_ssd_apply_entry.py``).

``ssd_intra`` (kernel 8), ``ssd_state_apply`` (kernel 9) and
``ssd_apply_entry`` (kernel 10) each have two CUDA kernels: the tiled
kernel, redesigned for Hopper, and the earlier block kernel for the shapes
the tiled one does not take.  The choice is a pure function of (P, S,
chunk) (``ssd_intra_route``, ``ssd_state_apply_route``,
``ssd_apply_entry_route``), so it is held here on the CPU: every admitted
h100 ssd config at the Mamba-2 block's shapes (n = 2048) and the tuning
loop's (n = 1024) goes to the tiled kernels; ragged shapes go to the
block kernels.  On the CPU the wrappers run their plain versions and count
no launch on either route; a forced route needs CUDA tensors.

The tiled kernels split the work by index algebra: 128-row t panels, the
heaviest first; 64-row s tiles; warps of 16 t rows whose lanes hold 8 x 4
register tiles (t = r0 + ty + 2 i, s = s0 + tx + 16 j); a warp's scores
through its own shared rows (column 8 ty + i); the warp skips of the
masked triangle; the chunk state from the last panel's tiles; and, for
kernel 9, 128-row panels of 32-column slices, consumer tiles t = tg +
32 i, p = 4 pg + jj, and the carry in the registers of the lanes that own
k = tg + 32 m.  ``replay_intra`` and ``replay_state_apply`` walk that
schedule in torch, with the kernels' order of operations (``_fma`` for
each ``__fmaf_rn``), and must equal the plain versions bit for bit: the
algebra is checked here before the card runs it.
"""
import importlib

import numpy as np
import pytest
import torch

from conftest import _rng
from repro_torch.core.space import Workload, build_space
from repro_torch.kernels.blocks.plan import plan_for_chain
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd.kernel import (_fma, _groups, ssd_apply_entry,
                                            ssd_apply_entry_route,
                                            ssd_intra, ssd_intra_plain,
                                            ssd_intra_route, ssd_state_apply,
                                            ssd_state_apply_plain,
                                            ssd_state_apply_route)
from repro_torch.kernels.ssd.ops import _normalize, ssd

H100 = importlib.import_module("repro_torch.hw.profiles").get_profile("h100")
MAMBA_ROWS = 8 * 24            # mamba2-130m's prefill: 8 sequences x 24 heads
MAMBA_P, MAMBA_S = 64, 128     # its head dim and state

# the tiled kernels' geometry (csrc/ssd.cu)
PANEL, S_TILE, WARP_ROWS, WARPS = 128, 64, 16, 8
APPLY_ROWS, SLICE = 128, 32


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


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------

def _ssd_launches(n):
    """(chunk, launch name) of every launch of every admitted h100 ssd
    config's chain plan at n, for the block's rows and widths."""
    wl = Workload(op="ssd", n=n, batch=MAMBA_ROWS, variant="chunked")
    out = []
    for cfg in build_space(wl, H100).enumerate_valid():
        knobs = _normalize(cfg, wl)
        plan = plan_for_chain(wl, {"tile_n": knobs["chunk"],
                                   "radix": knobs["radix"],
                                   "fuse": knobs["fuse"]},
                              dims=(MAMBA_S, MAMBA_P))
        out += [(knobs["chunk"], launch.name) for launch in plan.launches]
    return out


ROUTE_OF = {"ssd-intra": ssd_intra_route,
            "ssd-state-apply": ssd_state_apply_route,
            "ssd-apply": ssd_apply_entry_route}


@pytest.mark.parametrize("n,configs", [(1024, 600), (2048, 696)])
def test_every_h100_ssd_config_takes_the_tiled_kernels(n, configs):
    """Every phase-A, fused-apply and unfused-apply launch of every
    admitted config at mamba2-130m's (P, S) = (64, 128), chunks 128 ...
    n."""
    wl = Workload(op="ssd", n=n, batch=MAMBA_ROWS, variant="chunked")
    assert len(build_space(wl, H100).enumerate_valid()) == configs
    launches = _ssd_launches(n)
    assert {chunk for chunk, _ in launches} \
        == {2 ** e for e in range(7, n.bit_length())}
    routed = [(chunk, name) for chunk, name in launches if name in ROUTE_OF]
    assert {name for _, name in routed} == set(ROUTE_OF)
    assert {ROUTE_OF[name](MAMBA_P, MAMBA_S, chunk)
            for chunk, name in routed} == {"tiled"}


@pytest.mark.parametrize("P,S,chunk", [
    (16, 8, 64), (8, 16, 128), (64, 128, 256), (64, 128, 2048),
    (16, 8, 96), (8, 16, 100), (64, 128, 1)])
def test_the_kernel_tests_shapes_take_the_tiled_kernels(P, S, chunk):
    assert ssd_intra_route(P, S, chunk) == "tiled"
    assert ssd_state_apply_route(P, S, chunk) == "tiled"


@pytest.mark.parametrize("P,S,chunk,intra,apply", [
    (70, 130, 100, "block", "block"),     # the ragged case: P, S not % 8
    (64, 130, 128, "block", "block"),     # S not a multiple of 8
    (68, 128, 128, "block", "block"),     # P not a multiple of 8
    (64, 256, 128, "block", "block"),     # S above 128
    (128, 128, 128, "block", "tiled"),    # P above phase A's 64
    (64, 128, 4096, "block", "tiled"),    # a chunk above phase A's 2048
])
def test_shapes_the_tiled_kernels_do_not_take_go_to_the_block_kernels(
        P, S, chunk, intra, apply):
    assert ssd_intra_route(P, S, chunk) == intra
    assert ssd_state_apply_route(P, S, chunk) == apply


def _counts():
    return tuple(getattr(fn, f"launches{r}")
                 for fn in (ssd_intra, ssd_state_apply, ssd_apply_entry)
                 for r in ("", "_tiled", "_block"))


@pytest.mark.parametrize("fuse", [0, 1])
def test_cpu_ssd_calls_count_no_launch_on_either_route(fuse):
    rng = _rng(f"ssdroutecpu{fuse}")
    B, L, H, P, S = 1, 256, 2, 8, 16
    x = torch.from_numpy(rng.normal(size=(B, L, H, P)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.85, 0.999, size=(B, L, H))
                         .astype(np.float32))
    b, c = (torch.from_numpy(rng.normal(size=(B, L, S)).astype(np.float32))
            for _ in range(2))
    before = _counts()
    y = ssd(x, a, b, c, config={"tile_n": 64, "radix": 2, "fuse": fuse})
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert _counts() == before


@pytest.mark.parametrize("route", ["tiled", "block"])
def test_forced_routes_need_a_card(route):
    """A forced route on a CPU tensor raises (the wrappers and the
    uncounted launchers alike): it never runs the plain version."""
    x, a, b, c, y, ac, st = _intra_inputs("forced", 2, 1, 128, 8, 16, 64,
                                          torch.float32, False)
    with pytest.raises(ValueError):
        ssd_intra(x, a, b, c, chunk=64, route=route)
    with pytest.raises(ValueError):
        ssd_kernel._launch_intra(x, a, b, c, 64, route=route)
    with pytest.raises(ValueError):
        ssd_state_apply(y, a, c, ac, st, chunk=64, route=route)
    with pytest.raises(ValueError):
        ssd_kernel._launch_apply("ssd_state_apply", y, a, c, 64, ac, st,
                                 True, route=route)
    with pytest.raises(ValueError):
        ssd_apply_entry(y, a, c, st, chunk=64, route=route)
    with pytest.raises(ValueError):
        ssd_kernel._launch_apply("ssd_apply_entry", y, a, c, 64, None, st,
                                 False, route=route)


def test_an_unknown_route_is_refused():
    x, a, b, c, *_ = _intra_inputs("unknown", 2, 1, 128, 8, 16, 64,
                                   torch.float32, False)
    with pytest.raises(ValueError):
        ssd_kernel._launch_intra(x, a, b, c, 64, route="warp")


# ---------------------------------------------------------------------------
# The tiled schedules, replayed
# ---------------------------------------------------------------------------

def _intra_inputs(tag, BH, G, L, P, S, chunk, dtype, strong):
    """x, a, b, c as the kernel tests draw them, plus random y_intra and
    state and the a_chunk of a (kernel 9's inputs), all from numpy."""
    rng = _rng(f"ssdroutes{tag}{BH}{L}{P}{S}{chunk}{strong}")
    x = rng.normal(size=(BH, L, P))
    a = rng.uniform(0.85, 0.999, size=(BH, L)) * (0.01 if strong else 1.0)
    b = rng.normal(size=(G, L, S)) * 0.3
    c = rng.normal(size=(G, L, S)) * 0.3
    y = rng.normal(size=(BH, L, P))
    st = rng.normal(size=(BH, L // chunk, S, P))
    ac = np.prod(a.reshape(BH, L // chunk, chunk), axis=-1)
    t = [torch.from_numpy(v.astype(np.float32)) for v in
         (x, a, b, c, y, ac, st)]
    return [v.to(dtype) for v in t[:5]] + t[5:]


def _chain(lg, n):
    """The warp chain: la over positions 0 .. n - 1 of lg (.., Q), 32 at a
    time, every step one f32 add in ascending order."""
    la = torch.empty_like(lg[..., :n])
    run = torch.zeros_like(lg[..., 0])
    for base in range(0, n, 32):
        for i in range(min(32, n - base)):
            run = run + lg[..., base + i]
            la[..., base + i] = run
    return la


def replay_intra(x, a, b, c, chunk, record=None):
    """Kernel 8's tiled schedule on the CPU: per 128-row t panel (all rows
    and chunks at once), the s tiles of 64 in order, the warps that do not
    skip the tile, their lanes' 8 x 4 score tiles (an fma chain in k, four
    k a load), the decay and mask, the warp's score rows, the y loop up to
    the warp's last row, and in the last panel the state.  ``record``
    (a dict) gets, per (t, s) pair, how often it entered y and the order."""
    BH, L, P = x.shape
    S = b.shape[-1]
    Q, nc = chunk, L // chunk
    xf = x.to(torch.float32).reshape(BH, nc, Q, P)
    bf = _groups(b, BH).reshape(BH, nc, Q, S)
    cf = _groups(c, BH).reshape(BH, nc, Q, S)
    lg = torch.log(torch.clamp_min(a.to(torch.float32), 1e-30)) \
        .reshape(BH, nc, Q)
    y = torch.full((BH, nc, Q, P), float("nan"))
    a_chunk = state = None
    ty = torch.arange(2)[:, None]                    # lane rows: ty, i
    i8 = torch.arange(8)[None, :]
    tx = torch.arange(16)[:, None]                   # lane columns: tx, j
    j4 = torch.arange(4)[None, :]
    if record is not None:
        record["visits"] = torch.zeros(Q, Q, dtype=torch.int64)
        record["last_s"] = torch.full((Q,), -1, dtype=torch.int64)
        record["masked_nonzero"] = 0
    panels = -(-Q // PANEL)
    for panel in reversed(range(panels)):            # the heaviest first
        t0 = panel * PANEL
        t_end = min(t0 + PANEL, Q)
        last = t_end == Q
        la = _chain(lg, t_end)
        la_pad = torch.cat([la, torch.zeros(BH, nc, panels * PANEL - t_end)],
                           dim=-1)
        if last:
            end = la[..., Q - 1:Q]
            dec = torch.exp(end - la)
            a_chunk = torch.exp(end[..., 0])
            sacc = torch.zeros(BH, nc, 16, 8, 16, 4)    # kq, i, px, jj
        yacc = {}
        for n in range(-(-t_end // S_TILE)):
            s0 = n * S_TILE
            for w in range(WARPS):
                r0 = t0 + w * WARP_ROWS
                if r0 >= t_end or s0 >= r0 + WARP_ROWS:
                    continue                         # the warp skips the tile
                t = r0 + ty + 2 * i8                 # (2, 8)
                s = s0 + tx + 16 * j4                # (16, 4)
                tc, sc_ = t.clamp(max=Q - 1), s.clamp(max=Q - 1)
                sc = torch.zeros(BH, nc, 2, 8, 16, 4)
                for k in range(0, S, 4):
                    for kk in range(4):
                        cv = cf[:, :, tc, k + kk][..., :, :, None, None]
                        bv = bf[:, :, sc_, k + kk][..., None, None, :, :]
                        sc = _fma(cv, bv, sc)
                lt = la_pad[:, :, t][..., :, :, None, None]
                ls = la_pad[:, :, s.clamp(max=panels * PANEL - 1)][
                    ..., None, None, :, :]
                keep = (s[None, None, :, :] <= t[:, :, None, None])
                sc = torch.where(keep, sc * torch.exp(lt - ls),
                                 torch.zeros_like(sc))
                # the warp's score rows: row tx + 16 j, column 8 ty + i
                scw = torch.empty(BH, nc, S_TILE, 16)
                rows = (tx + 16 * j4)[None, None, :, :].expand(2, 8, 16, 4)
                cols = (8 * ty + i8)[:, :, None, None].expand(2, 8, 16, 4)
                scw[:, :, rows, cols] = sc
                acc = yacc.setdefault(w, torch.zeros(BH, nc, 2, 8, 16, 4))
                sn = min(S_TILE, r0 + WARP_ROWS - s0, t_end - s0)
                for sl in range(sn):
                    sv = scw[:, :, sl, 8 * ty + i8][..., None, None]
                    xv = xf[:, :, s0 + sl, (4 * tx + j4).clamp(max=P - 1)][
                        ..., None, None, :, :]
                    acc = _fma(sv, xv, acc)
                    if record is not None:
                        for tt in t.flatten().tolist():
                            if tt >= t_end:
                                continue
                            ss = s0 + sl
                            record["visits"][tt, ss] += 1
                            if ss > tt:
                                col = 8 * ((tt - r0) % 2) + (tt - r0) // 2
                                record["masked_nonzero"] += int(
                                    (scw[:, :, sl, col] != 0).sum())
                            else:
                                assert ss > record["last_s"][tt]
                                record["last_s"][tt] = ss
                yacc[w] = acc
            if last:
                for sl in range(min(S_TILE, Q - s0)):
                    kk = 8 * torch.arange(16)[:, None] + i8  # (16, 8)
                    bw = bf[:, :, s0 + sl, kk.clamp(max=S - 1)] \
                        * dec[:, :, s0 + sl, None, None]
                    pp = (4 * tx + j4).clamp(max=P - 1)      # (16, 4)
                    xv = xf[:, :, s0 + sl, pp]
                    sacc = _fma(bw[..., :, :, None, None],
                                xv[..., None, None, :, :], sacc)
        for w, acc in yacc.items():
            r0 = t0 + w * WARP_ROWS
            for tyy in range(2):
                for i in range(8):
                    tt = r0 + tyy + 2 * i
                    if tt < t_end:
                        y[:, :, tt] = acc[:, :, tyy, i].reshape(
                            BH, nc, 64)[..., :P]
        if last:
            state = sacc.reshape(BH, nc, 128, 64)[:, :, :S, :P]
    return y.reshape(BH, L, P).to(x.dtype), a_chunk, state


def replay_state_apply(y_intra, a, c, a_chunk, state, chunk):
    """Kernel 9's tiled schedule on the CPU: per (row, 32-column slice),
    the chunks in order in 128-row panels; the producer's exp(la) chain
    carried over a chunk's panels; the consumers' 4 x 4 tiles (t = tg +
    32 i, p = 4 pg + jj) of the dot with the carry; at a chunk's end the
    carry advanced in the lanes that own k = tg + 32 m and written back."""
    BH, L, P = y_intra.shape
    S = c.shape[-1]
    Q, nc = chunk, L // chunk
    yf = y_intra.to(torch.float32).reshape(BH, nc, Q, P)
    cf = _groups(c, BH).reshape(BH, nc, Q, S)
    lg = torch.log(torch.clamp_min(a.to(torch.float32), 1e-30)) \
        .reshape(BH, nc, Q)
    out = torch.full((BH, nc, Q, P), float("nan"))
    tg = torch.arange(32)[:, None]                   # (32, 4): tg, i / m
    i4 = torch.arange(4)[None, :]
    pg = torch.arange(8)[:, None]                    # (8, 4): pg, jj
    j4 = torch.arange(4)[None, :]
    panels = -(-Q // APPLY_ROWS)
    for p0 in range(0, P, SLICE):
        pw = min(SLICE, P - p0)
        pcols = (p0 + 4 * pg + j4).clamp(max=P - 1)  # (8, 4)
        h_s = torch.zeros(BH, S, 8, 4)                # by (k, pg, jj)
        hr = torch.zeros(BH, 32, 4, 8, 4)             # (tg, m, pg, jj)
        kown = tg + 32 * i4                          # (32, 4): k = tg + 32 m
        for j in range(nc):
            run = None
            for q in range(panels):
                t0 = q * APPLY_ROWS
                rows = min(APPLY_ROWS, Q - t0)
                # the producer: exp(la) of the panel, the chain carried
                seg = lg[:, j, t0:t0 + rows]
                la = torch.empty_like(seg)
                run = torch.zeros(BH) if q == 0 else run
                for base in range(0, rows, 32):
                    for i in range(min(32, rows - base)):
                        run = run + seg[:, base + i]
                        la[:, base + i] = run
                am = torch.exp(la)
                # the consumers
                t = tg + 32 * i4                     # (32, 4)
                tc = (t0 + t).clamp(max=Q - 1)
                acc = torch.zeros(BH, 32, 4, 8, 4)
                for k in range(0, S, 4):
                    for kk in range(4):
                        cv = cf[:, j, tc, k + kk][..., None, None]
                        hv = h_s[:, k + kk][:, None, None]
                        acc = _fma(cv, hv, acc)
                tt = t0 + t[:, :, None, None].expand(32, 4, 8, 4)
                pp = (p0 + 4 * pg + j4)[None, None].expand(32, 4, 8, 4)
                keep = ((t < rows)[:, :, None, None]
                        & (4 * pg < pw)[None, None, :, :]).expand(32, 4, 8, 4)
                yv = yf[:, j][:, tc][..., pcols]
                val = yv + acc * am[:, (t).clamp(max=rows - 1)][..., None,
                                                              None]
                out[:, j, tt[keep], pp[keep]] = val[:, keep]
                if q == panels - 1 and j + 1 < nc:
                    sv = state[:, j][:, kown.clamp(max=S - 1)][
                        ..., pcols]                  # (BH, 32, 4, 8, 4)
                    hr = _fma(a_chunk[:, j, None, None, None, None], hr, sv)
                    ks = kown.flatten()              # k of (tg, m)
                    h_s[:, ks[ks < S]] = hr.reshape(BH, 128, 8, 4)[
                        :, ks < S]
    return out.reshape(BH, L, P).to(y_intra.dtype)


INTRA_CASES = [
    # BH, G, L, P, S, chunk: chunk 64, 128, 256 (and a ragged 100), nc 1 /
    # 3 / 16, (S, P) = (16, 8), (8, 16) and (128, 64), shared b / c
    (2, 1, 64, 8, 16, 64),
    (2, 2, 192, 16, 8, 64),
    (2, 1, 1024, 8, 16, 64),
    (2, 1, 128, 64, 128, 128),
    (2, 2, 384, 16, 8, 128),
    (2, 1, 2048, 8, 16, 128),
    (1, 1, 256, 64, 128, 256),
    (2, 1, 768, 8, 16, 256),
    (2, 1, 300, 8, 16, 100),
]


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("BH,G,L,P,S,chunk", INTRA_CASES)
def test_intra_tiled_schedule_replays_the_plain_version(BH, G, L, P, S,
                                                        chunk, strong):
    x, a, b, c, *_ = _intra_inputs("intra", BH, G, L, P, S, chunk,
                                   torch.float32, strong)
    record = {}
    got = replay_intra(x, a, b, c, chunk, record=record)
    want = ssd_intra_plain(x, a, b, c, chunk=chunk)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)
    # every (t, s <= t) pair entered y once, in ascending s; the pairs
    # above the diagonal that a warp walked carried a zero score
    visits = record["visits"]
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    assert bool((visits[tri] == 1).all())
    assert bool((visits[~tri] <= 1).all())
    assert record["masked_nonzero"] == 0
    assert torch.equal(record["last_s"], torch.arange(chunk))


@pytest.mark.parametrize("BH,G,L,P,S,chunk", [(2, 1, 384, 16, 8, 128),
                                              (1, 1, 256, 64, 128, 256)])
def test_intra_tiled_schedule_replays_the_plain_version_bf16(BH, G, L, P, S,
                                                             chunk):
    x, a, b, c, *_ = _intra_inputs("intrabf16", BH, G, L, P, S, chunk,
                                   torch.bfloat16, False)
    for g, w in zip(replay_intra(x, a, b, c, chunk),
                    ssd_intra_plain(x, a, b, c, chunk=chunk)):
        assert g.dtype == w.dtype and torch.equal(g, w)


APPLY_CASES = [
    # BH, G, L, P, S, chunk: nc 1 / 3 / 16, 128-row panels walked in two
    # (chunk 256) and a ragged panel (chunk 100); P over two slices (64)
    (2, 1, 64, 8, 16, 64),
    (2, 2, 192, 16, 8, 64),
    (2, 1, 1024, 8, 16, 64),
    (2, 1, 384, 64, 128, 128),
    (2, 1, 768, 16, 8, 256),
    (2, 1, 300, 8, 16, 100),
]


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("BH,G,L,P,S,chunk", APPLY_CASES)
def test_state_apply_tiled_schedule_replays_the_plain_version(
        BH, G, L, P, S, chunk, strong):
    _, a, _, c, y, ac, st = _intra_inputs("apply", BH, G, L, P, S, chunk,
                                          torch.float32, strong)
    got = replay_state_apply(y, a, c, ac, st, chunk)
    want = ssd_state_apply_plain(y, a, c, ac, st, chunk=chunk)
    assert torch.equal(got, want)


def test_state_apply_tiled_schedule_replays_the_plain_version_bf16():
    _, a, _, c, y, ac, st = _intra_inputs("applybf16", 2, 1, 384, 16, 8,
                                          128, torch.bfloat16, False)
    got = replay_state_apply(y, a, c, ac, st, 128)
    want = ssd_state_apply_plain(y, a, c, ac, st, chunk=128)
    assert got.dtype == want.dtype and torch.equal(got, want)
