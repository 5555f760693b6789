"""The plain references against float64 at tiny sizes, and the control
coming out above every limit where the program comes out below."""
import math

import pytest
import torch

from portbench.drivers.ops import laplacian_system
from portbench.reference import mamba2 as ref_model
from portbench.reference import prefix_ops as ref


def test_scan_reference():
    x = torch.randn(3, 17, dtype=torch.float64)
    want = torch.stack([torch.tensor([float(sum(r[:j + 1]))
                                      for j in range(17)]) for r in x])
    assert torch.allclose(ref.scan(x.float()), want.to(torch.float64),
                          atol=1e-6)


def test_tridiag_reference_against_a_dense_solve():
    gen = torch.Generator().manual_seed(3)
    a, b, c, d = (v.view(4, 16) for v in laplacian_system(64, gen))
    x = ref.tridiag(a, b, c, d)
    mat = torch.zeros(4, 16, 16, dtype=torch.float64)
    idx = torch.arange(16)
    mat[:, idx, idx] = b.double()
    mat[:, idx[1:], idx[:-1]] = a[:, 1:].double()
    mat[:, idx[:-1], idx[1:]] = c[:, :-1].double()
    want = torch.linalg.solve(mat, d.double()[..., None])[..., 0]
    assert torch.allclose(x, want, rtol=1e-10, atol=1e-10)


def test_fft_reference_is_the_dft():
    x = torch.randn(2, 12, dtype=torch.complex128)
    j = torch.arange(12, dtype=torch.float64)
    w = torch.exp(-2j * math.pi * j[:, None] * j[None, :] / 12)
    assert torch.allclose(ref.fft(x), x @ w, atol=1e-10)


def test_control_is_on_bfloat16():
    x = torch.randn(2, 64)
    got = ref.control("scan", (x,))
    assert torch.equal(got, got.to(torch.bfloat16).to(got.dtype))


def test_ssd_reference_against_the_sequential_recurrence():
    gen = torch.Generator().manual_seed(5)
    L, H, P, S = 24, 3, 4, 5
    x = torch.randn(L, H, P, generator=gen, dtype=torch.float64)
    a = torch.rand(L, H, generator=gen, dtype=torch.float64) * 0.5 + 0.5
    b = torch.randn(L, S, generator=gen, dtype=torch.float64)
    c = torch.randn(L, S, generator=gen, dtype=torch.float64)
    h = torch.zeros(H, S, P, dtype=torch.float64)
    want = []
    for t in range(L):
        h = a[t][:, None, None] * h + b[t][None, :, None] * x[t][:, None, :]
        want.append(torch.einsum("s,hsp->hp", c[t], h))
    want = torch.stack(want)
    for chunk in (4, 8, 24):
        got = ref_model.ssd(x.float(), a.float(), b.float(), c.float(),
                            chunk=chunk)
        assert torch.allclose(got.double(), want, rtol=1e-4, atol=1e-4)


def _forward64(w, tokens, cfg):
    """The same model in float64 with the recurrence run step by step."""
    d_inner, h, p, s = ref_model.dims(cfg)
    eps, k = cfg["rms_norm_eps"], cfg["d_conv"]

    def rms(x, scale):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
            * (1.0 + scale.double())
    x = w["embed"][tokens].double() * math.sqrt(cfg["d_model"])
    L = x.shape[0]
    for i in range(cfg["n_layer"]):
        z_all = rms(x, w["ln"][i]) @ w["in_proj"][i].double()
        xs, z, bc, dt_raw = torch.split(z_all, [d_inner, d_inner, 2 * s, h],
                                        -1)
        u = torch.cat([xs, bc], -1)
        u = torch.cat([u.new_zeros(k - 1, u.shape[1]), u])
        conv = sum(u[j:j + L] * w["conv"][i].double()[j] for j in range(k))
        conv = conv * torch.sigmoid(conv)
        xs, b, c = torch.split(conv, [d_inner, s, s], -1)
        dt = torch.nn.functional.softplus(dt_raw + w["dt_bias"][i].double())
        a = torch.exp(-torch.exp(w["a_log"][i].double()) * dt)
        xs = xs.view(L, h, p)
        state = torch.zeros(h, s, p, dtype=torch.float64)
        ys = []
        for t in range(L):
            state = a[t][:, None, None] * state \
                + b[t][None, :, None] * xs[t][:, None, :]
            ys.append(torch.einsum("s,hsp->hp", c[t], state))
        y = torch.stack(ys).reshape(L, d_inner)
        y = rms(y * z * torch.sigmoid(z), w["norm"][i])
        x = x + y @ w["out_proj"][i].double()
    return rms(x, w["final_norm"]) @ w["embed"].double().t()


def test_model_reference_against_float64(small_prefill):
    config, _ = small_prefill
    gen = torch.Generator().manual_seed(7)
    w = ref_model.draw(config, gen)
    tokens = torch.randint(0, config["vocab_size"], (40,), generator=gen)
    got, cond = ref_model.forward(w, tokens, config)
    want = _forward64(w, tokens, config)
    err = (got.double() - want).abs().max() / want.abs().max()
    assert err < 1e-5
    assert cond.shape == (40,) and bool((cond > 0).all())
    assert float(cond.min()) <= 1.0    # no more than the median position


def test_weights_repeat_under_a_seed(small_prefill):
    config, _ = small_prefill
    a = ref_model.draw(config, torch.Generator().manual_seed(2**31 + 9))
    b = ref_model.draw(config, torch.Generator().manual_seed(2**31 + 9))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["embed"].dtype == torch.bfloat16
    assert a["a_log"].dtype == torch.float32


@pytest.mark.parametrize("cell", ["bplg.grid", "mamba2.prefill"])
def test_control_fails_where_the_program_passes(bench, cell, small_grid,
                                                small_prefill, three_blocks):
    """The control in the program's place comes out above a limit on every
    seed tried; the program's own outputs below every limit."""
    from portbench import control, timing
    config, traffic = small_grid if cell == "bplg.grid" else small_prefill
    limits = bench.limits(bench.cell(cell))
    lines, _ = control.readings(bench, cell, [1, 2**31 + 3, 12],
                                0.4, timing.Device(torch.device("cpu")),
                                lambda msg: None, config=config,
                                traffic=traffic)
    for line in lines:
        assert all(line["program"][k] <= limits[k] for k in limits), line
        assert any(line["control"][k] > limits[k] for k in limits), line
