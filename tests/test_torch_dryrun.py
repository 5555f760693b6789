"""The port's dry-run tools (``repro_torch.launch``: ``params``,
``inputs``, ``op_cost``, ``dryrun``) against the JAX package's.

  * the analytic parameter counts and MODEL_FLOPS, ``shape_applicable``,
    and the input stand-ins' shapes and dtypes (the decode cache
    included), equal for every arch x shape;
  * ``analyze_ops`` against ``analyze_jaxpr`` on the reduced dense, ssm and
    moe configs at a 4 x 64 prefill and train step: ``dot_count`` and the
    dot FLOPs (summed over the jaxpr's dot_generals here) exactly; the
    total FLOPs within 15% and the bytes within a factor of 2.  The totals
    differ by construction, not by error: the port counts torch's ops
    (``_softmax`` whole, the optimizer's and the cross-entropy's ops as
    torch dispatches them, masks built by ``arange`` comparisons) where
    JAX counts XLA's primitives, and JAX's bytes add each ``lax.scan``'s
    stacked inputs and outputs once, which a Python loop over layers has
    no counterpart for;
  * ``lower_cell`` on those reduced configs on a fake (4, 2) mesh (train,
    prefill, decode): ``status == "ok"``, JAX's record keys, argument
    bytes equal to the shard bytes computed from JAX's own specs on
    ``AbstractMesh((4, 2))`` over JAX's ``eval_shape`` state and batch,
    and the fallbacks equal to JAX's;
  * the skip rule (``long_500k`` on a full-attention arch);
  * the one-hot embedding of a distributed step: bit-equal to the gather
    in f32, equal to JAX's ``embed(..., one_hot=True)``, and a forward
    with ``batch_axes`` set on plain tensors bit-equal to one without.
"""
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from conftest import _rng
from repro import tuning as j_tuning
from repro.configs import base as j_base
from repro.distributed import sharding as j_sh
from repro.launch import inputs as j_inputs
from repro.launch import jaxpr_cost as j_cost
from repro.launch import params as j_params
from repro.models import layers as j_layers
from repro.models.model import build_model as j_build
from repro.train import step as j_step
from repro_torch import tuning as t_tuning
from repro_torch.configs.base import SHAPES, ShapeConfig, all_archs, get_arch
from repro_torch.configs.base import shape_applicable
from repro_torch.launch import inputs as t_inputs
from repro_torch.launch import params as t_params
from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.mesh import fake_world, make_fake_mesh
from repro_torch.launch.op_cost import analyze_ops
from repro_torch.launch.roofline import model_flops
from repro_torch.models import layers as t_layers
from repro_torch.models.convert import load_params
from repro_torch.models.model import Model
from repro_torch.train import step as t_step

jax.devices()   # the backend is up before the JAX launch modules set XLA_FLAGS
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as j_dryrun  # noqa: E402
from repro.launch import roofline as j_roof  # noqa: E402

if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

FAMILIES = ["qwen1.5-0.5b", "mamba2-130m", "qwen2-moe-a2.7b"]
# JAX's measured dot_generals at 4 x 64 (prefill, train)
JAX_DOTS = {"qwen1.5-0.5b": (19, 57), "mamba2-130m": (19, 57),
            "qwen2-moe-a2.7b": (37, 101)}
# the keys of JAX's dry-run record (src/repro/launch/dryrun.py)
RECORD_KEYS = {"arch", "shape", "mesh", "status", "lower_s", "compile_s",
               "flops", "bytes_accessed", "per_device",
               "sharding_fallbacks"}
PER_DEVICE_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
                   "peak_bytes"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _pinned(tmp_path_factory):
    """Both default sessions on tpu_v5e with empty DBs: the SSD chunk is
    resolved alike in both packages."""
    tmp = tmp_path_factory.mktemp("sessions")
    jprev = j_tuning.set_default_session(j_tuning.TunerSession(
        db_path=str(tmp / "jax.json"),
        spec=__import__("repro.hw.profiles",
                        fromlist=["x"]).get_profile("tpu_v5e")))
    tprev = t_tuning.set_default_session(t_tuning.TunerSession(
        db_path=str(tmp / "torch.json"),
        spec=__import__("repro_torch.hw.profiles",
                        fromlist=["x"]).get_profile("tpu_v5e")))
    yield
    j_tuning.set_default_session(jprev)
    t_tuning.set_default_session(tprev)


@pytest.fixture(scope="module")
def world():
    """A fake world of 8 ranks for the module, torn down after it."""
    with fake_world(8):
        yield make_fake_mesh((4, 2), ("data", "model"))
    assert not torch.distributed.is_initialized()


def _jcfg(arch, reduced=True):
    j_base._load_all()
    cfg = j_base._REGISTRY[arch]
    return cfg.reduced() if reduced else cfg


# --- parameter counts, MODEL_FLOPS, the skip rule, the stand-ins ---

@pytest.mark.parametrize("arch", all_archs())
def test_param_counts_and_model_flops_equal_repro(arch):
    jcfg, tcfg = _jcfg(arch, False), get_arch(arch)
    assert t_params.active_param_count(tcfg) == \
        j_params.active_param_count(jcfg)
    assert t_params.total_param_count(tcfg) == \
        j_params.total_param_count(jcfg)
    if tcfg.family == "audio":
        assert t_params.audio_split_params(tcfg) == \
            j_params.audio_split_params(jcfg)
    for shape in SHAPES:
        assert model_flops(arch, shape) == j_roof.model_flops(arch, shape)
        assert shape_applicable(tcfg, SHAPES[shape]) == \
            j_base.shape_applicable(jcfg, j_base.SHAPES[shape])


def _struct(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _jstruct(s):
    return tuple(s.shape), str(s.dtype)


def _tree_structs(tree, fn):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_structs(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_structs(v, fn) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", all_archs())
def test_input_specs_equal_repro(arch, shape_name):
    jcfg, tcfg = _jcfg(arch, False), get_arch(arch)
    shape, jshape = SHAPES[shape_name], j_base.SHAPES[shape_name]
    mode = t_inputs.fake_mode()
    if shape.kind == "decode":
        jin, jcache = j_inputs.decode_input_specs(jcfg, jshape)
        tin, tcache = t_inputs.decode_input_specs(tcfg, shape, mode)
        assert _tree_structs(t_inputs.stacked_cache(tcache, mode),
                             _struct) == _tree_structs(jcache, _jstruct)
    elif shape.kind == "train":
        jin = j_inputs.train_input_specs(jcfg, jshape)
        tin = t_inputs.train_input_specs(tcfg, shape, mode)
    else:
        jin = j_inputs.prefill_input_specs(jcfg, jshape)
        tin = t_inputs.prefill_input_specs(tcfg, shape, mode)
    assert _tree_structs(tin, _struct) == _tree_structs(jin, _jstruct)


@pytest.mark.parametrize("arch", [a for a in all_archs()
                                  if not get_arch(a).sub_quadratic])
def test_long_context_on_full_attention_is_skipped_as_in_repro(arch):
    # the skip returns before any mesh or model is built, in both packages
    for multi_pod in (False, True):
        got = lower_cell(arch, "long_500k", multi_pod=multi_pod)
        assert got["status"] == "skipped"
        assert got == j_dryrun.lower_cell(arch, "long_500k",
                                          multi_pod=multi_pod)


# --- analyze_ops against analyze_jaxpr ---

def _jax_dot_flops(jaxpr, mult=1.0):
    total = 0.0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            total += mult * j_cost._dot_flops(eqn)
            continue
        inner = mult * eqn.params.get("length", 1) \
            if eqn.primitive.name == "scan" else mult
        for sub in j_cost._sub_jaxprs(eqn):
            total += _jax_dot_flops(sub.jaxpr if hasattr(sub, "jaxpr")
                                    else sub, inner)
    return total


KIND_SHAPES = {"prefill": ShapeConfig("p64", 64, 4, "prefill"),
               "train": ShapeConfig("t64", 64, 4, "train")}


def _jax_cost(arch, kind):
    cfg = _jcfg(arch)
    model = j_build(cfg)
    jshape = j_base.ShapeConfig("x", 64, 4, kind)
    if kind == "train":
        hp = j_step.TrainHParams()
        args = (jax.eval_shape(lambda: j_step.init_train_state(
            model, hp, jax.random.PRNGKey(0))),
            j_inputs.train_input_specs(cfg, jshape))
        fn = j_step.make_train_step(model, hp)
    else:
        args = (jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0))),
                j_inputs.prefill_input_specs(cfg, jshape))
        fn = j_step.make_prefill_step(model)
    cost = j_cost.analyze_jaxpr(fn, *args)
    cost["dot_flops"] = _jax_dot_flops(jax.make_jaxpr(fn)(*args).jaxpr)
    return cost


def _port_cost(arch, kind):
    cfg = get_arch(arch).reduced()
    mode = t_inputs.fake_mode()
    model = t_inputs.fake_model(cfg, mode)
    shape = KIND_SHAPES[kind]
    if kind == "train":
        hp = t_step.TrainHParams()
        state = t_inputs.abstract_train_state(model, hp, mode)
        batch = t_inputs.train_input_specs(cfg, shape, mode)
        return analyze_ops(t_step.make_train_step(model, hp), state, batch)
    batch = t_inputs.prefill_input_specs(cfg, shape, mode)
    step = t_step.make_prefill_step(model)
    # the parameters are entry arguments, as JAX's step takes them
    return analyze_ops(lambda params, batch: step(batch),
                       list(model.parameters()), batch)


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_analyze_ops_counts_the_dots_of_analyze_jaxpr(arch, kind):
    j, t = _jax_cost(arch, kind), _port_cost(arch, kind)
    assert j["dot_count"] == JAX_DOTS[arch][kind == "train"]
    assert t["dot_count"] == j["dot_count"]
    assert t["dot_flops"] == j["dot_flops"]
    assert abs(t["flops"] / j["flops"] - 1.0) < 0.15, (t, j)
    assert 0.5 < t["bytes"] / j["bytes"] < 2.0, (t, j)


# --- lower_cell on a fake (4, 2) mesh against JAX's specs ---

def _jax_mesh():
    try:
        return AbstractMesh((4, 2), ("data", "model"))
    except TypeError:
        return AbstractMesh((("data", 4), ("model", 2)))


def _shard_bytes(tree, specs, sizes):
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        n = 1
        for dim, size in enumerate(leaf.shape):
            entry = tuple(spec)[dim] if dim < len(tuple(spec)) else None
            axes = entry if isinstance(entry, tuple) else \
                (() if entry is None else (entry,))
            n *= size // math.prod(sizes[a] for a in axes)
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def _jax_argument_bytes(arch, kind):
    """The per-device argument bytes of JAX's cell on (4, 2), from its own
    specs, and its fallbacks."""
    mesh, sizes = _jax_mesh(), {"data": 4, "model": 2}
    cfg = dataclasses.replace(_jcfg(arch), model_axis_size=2,
                              batch_axes=("data",), batch_shards=4)
    model = j_build(cfg)
    shape = j_base.ShapeConfig("x", 64, 4, kind)
    d = j_sh.ShardingDecisions()
    if kind == "train":
        state = jax.eval_shape(lambda: j_step.init_train_state(
            model, j_step.TrainHParams(), jax.random.PRNGKey(0)))
        sspecs = j_sh.train_state_specs(state, mesh, d)
        batch = j_inputs.train_input_specs(cfg, shape)
        return (_shard_bytes(state, sspecs, sizes)
                + _shard_bytes(batch, j_sh.batch_specs(
                    batch, mesh, axes=cfg.batch_axes), sizes)), d.fallbacks
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    total = _shard_bytes(params, j_sh.param_specs(params, mesh, d), sizes)
    if kind == "prefill":
        batch = j_inputs.prefill_input_specs(cfg, shape)
        return total + _shard_bytes(batch, j_sh.batch_specs(batch, mesh),
                                    sizes), d.fallbacks
    inputs, cache = j_inputs.decode_input_specs(cfg, shape)
    total += _shard_bytes(cache, j_sh.cache_specs(cache, mesh), sizes)
    return total + _shard_bytes(inputs, j_sh.batch_specs(inputs, mesh),
                                sizes), d.fallbacks


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_lower_cell_on_a_fake_mesh_matches_repro_specs(world, arch, kind):
    shape = ShapeConfig(f"{kind}_64", 64, 4, kind)
    rec = lower_cell(arch, shape.name, arch_cfg=get_arch(arch).reduced(),
                     mesh=world, shape=shape)
    assert rec["status"] == "ok"
    assert set(rec) == RECORD_KEYS
    assert set(rec["per_device"]) == PER_DEVICE_KEYS
    want, fallbacks = _jax_argument_bytes(arch, kind)
    assert rec["per_device"]["argument_bytes"] == want
    assert rec["sharding_fallbacks"] == fallbacks
    pd = rec["per_device"]
    assert pd["peak_bytes"] == pd["argument_bytes"] + pd["temp_bytes"]
    assert pd["temp_bytes"] > 0 and rec["flops"] > 0
    assert rec["mesh"] == "4x2"


# --- the one-hot embedding ---

def test_one_hot_embedding_equals_the_gather_and_repro():
    rng = _rng("embed_one_hot")
    table = rng.standard_normal((97, 16)).astype(np.float32)
    tokens = rng.integers(0, 97, size=(3, 11)).astype(np.int32)
    emb = t_layers.Embedding(97, 16, torch.float32, "cpu")
    with torch.no_grad():
        emb.table.copy_(torch.from_numpy(table))
    tt = torch.from_numpy(tokens)
    oh = t_layers.embed(emb, tt, torch.float32, one_hot=True)
    assert torch.equal(oh, t_layers.embed(emb, tt, torch.float32))
    want = j_layers.embed({"table": jnp.asarray(table)}, jnp.asarray(tokens),
                          jnp.float32, one_hot=True)
    np.testing.assert_array_equal(oh.detach().numpy(), np.asarray(want))


def test_forward_with_batch_axes_equals_forward_without():
    cfg = get_arch("qwen1.5-0.5b").reduced()
    jcfg = _jcfg("qwen1.5-0.5b")
    params = j_build(jcfg).init(jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, params)
    tokens = torch.from_numpy(
        _rng("batch_axes_fwd").integers(0, cfg.vocab, (2, 16)))
    logits = {}
    for axes in ((), ("data",)):
        model = Model(dataclasses.replace(cfg, batch_axes=axes,
                                          batch_shards=1 if axes else 0,
                                          model_axis_size=1 if axes else 0),
                      device="cpu")
        load_params(model, params)
        with torch.no_grad():
            logits[axes] = model(tokens)[0]
    assert torch.equal(logits[()], logits[("data",)])
