"""The port's activations and gated MLP against ``repro.models.layers``.

``gelu`` (geglu / gelu) rounds to the input type after each operation of
``x * (0.5 * (1 + tanh(c * (x + 0.044715 x^3))))``, where XLA's expansion
of ``jax.nn.gelu(approximate=True)`` rounds: in bf16 it is bit-equal to
JAX on 10^6 values of 3 N(0, 1); in f32 the two tanh implementations
differ by a few ulps, held to 1e-6 of the output's magnitude.  The gated
``MLP`` with each activation, reduced widths, JAX's weights, at
``DTYPE_TOL``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import _rng, assert_kernel_close
from repro.models import layers as j_layers
from repro_torch.models import layers as t_layers

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.fixture(scope="module")
def gelu_inputs():
    return (3.0 * np.random.default_rng(0).standard_normal(10 ** 6)) \
        .astype(np.float32)


@pytest.mark.parametrize("act", ["gelu", "geglu"])
def test_gelu_bf16_is_bit_equal_to_jax(gelu_inputs, act):
    x = gelu_inputs
    want = _np(j_layers._act(act, jnp.asarray(x).astype(jnp.bfloat16)))
    got = t_layers._act(act, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), want)


def test_gelu_f32_matches_jax(gelu_inputs):
    x = gelu_inputs
    want = _np(j_layers._act("gelu", jnp.asarray(x)))
    got = _np(t_layers.gelu(torch.from_numpy(x)))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["geglu", "gelu", "swiglu"])
def test_mlp_matches_repro(activation, dtype):
    """The gated MLP at reduced width (d_model 64, d_ff 176, 2 x 16
    tokens), f32 weights from numpy, compute in ``dtype``."""
    rng = _rng(f"mlp-{activation}-{dtype}")
    d_model, d_ff = 64, 176
    ws = {name: (rng.standard_normal(shape) / np.sqrt(shape[0]))
          .astype(np.float32)
          for name, shape in (("wi", (d_model, d_ff)), ("wu", (d_model, d_ff)),
                              ("wo", (d_ff, d_model)))}
    x = rng.standard_normal((2, 16, d_model)).astype(np.float32)
    want = j_layers.mlp({k: {"w": jnp.asarray(w)} for k, w in ws.items()},
                        jnp.asarray(x).astype(_JNP[dtype]), activation,
                        _JNP[dtype])
    p = t_layers.MLP(d_model, d_ff, torch.float32)
    with torch.no_grad():
        for name, w in ws.items():
            getattr(p, name).w.copy_(torch.from_numpy(w))
        got = t_layers.mlp(p, torch.from_numpy(x).to(_TORCH[dtype]),
                           activation, _TORCH[dtype])
    assert got.dtype == _TORCH[dtype]
    assert_kernel_close(_np(got), _np(want), dtype)
