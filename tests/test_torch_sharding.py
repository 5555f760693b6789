"""The port's sharding rules (``repro_torch.distributed.sharding``)
against the JAX package's (``repro.distributed.sharding``).

Specs are compared as tuples, leaf by leaf: every parameter of all ten
archs at full width (the port's tree is ``param_tree`` of a model on the
``meta`` device, JAX's ``jax.eval_shape`` of ``model.init``), on both
production mesh shapes, with ``pure_dp`` on and off, together with the
fallbacks each side records; then the train state (AdamW, Adafactor,
int8 error feedback), the batches and the decode caches of the reduced
configs.  The port's specs take a plain ``MeshShape`` as JAX's take an
``AbstractMesh``, so none of this needs a process group.  The JAX
package's own cases of ``tests/test_sharding.py`` follow, on the port, and
``shardings_from_specs`` on a fake (4, 2) mesh."""
import dataclasses

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as JP

from repro.configs import base as j_base
from repro.distributed import sharding as j_sh
from repro.launch import inputs as j_inputs
from repro.models.model import build_model as j_build
from repro.train import step as j_step
from repro_torch.configs.base import SHAPES, ShapeConfig, all_archs, get_arch
from repro_torch.distributed import sharding as t_sh
from repro_torch.distributed.sharding import P, ShardingDecisions
from repro_torch.launch import inputs as t_inputs
from repro_torch.launch.mesh import MeshShape, fake_world, make_fake_mesh
from repro_torch.models.convert import param_tree
from repro_torch.models.model import Model
from repro_torch.train import step as t_step

MESH_SHAPES = {"16x16": ((16, 16), ("data", "model")),
               "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jmesh(sizes, names):
    try:  # newer jax: AbstractMesh(axis_sizes, axis_names)
        return AbstractMesh(tuple(sizes), tuple(names))
    except TypeError:  # older jax: AbstractMesh(((name, size), ...))
        return AbstractMesh(tuple(zip(names, sizes)))


MESH = MeshShape((16, 16), ("data", "model"))


def _canon(x):
    """A spec tree of either package as nested dicts / lists of tuples."""
    if isinstance(x, (JP, P)):
        return ("spec", tuple(x))
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _canon(v) for f, v in zip(x._fields, x)}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    assert x is None, x
    return None


def _jax_params(cfg):
    model = j_build(cfg)
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("mesh_name", sorted(MESH_SHAPES))
@pytest.mark.parametrize("arch", all_archs())
def test_param_specs_equal_repro_at_full_width(arch, mesh_name):
    sizes, names = MESH_SHAPES[mesh_name]
    j_base._load_all()
    jparams = _jax_params(j_base._REGISTRY[arch])
    tparams = param_tree(Model(get_arch(arch), device="meta"))
    for pure_dp in (False, True):
        jd, td = j_sh.ShardingDecisions(), ShardingDecisions()
        jspecs = j_sh.param_specs(jparams, _jmesh(sizes, names), jd,
                                  pure_dp=pure_dp)
        tspecs = t_sh.param_specs(tparams, MeshShape(sizes, names), td,
                                  pure_dp=pure_dp)
        assert _canon(tspecs) == _canon(jspecs)
        assert td.fallbacks == jd.fallbacks
        assert td.hits == jd.hits


def _reduced_pair(arch, **kw):
    j_base._load_all()
    jcfg = dataclasses.replace(j_base._REGISTRY[arch].reduced(), **kw)
    tcfg = dataclasses.replace(get_arch(arch).reduced(), **kw)
    return jcfg, tcfg


@pytest.mark.parametrize("hp_kw", [
    {}, {"optimizer": "adafactor"}, {"grad_compression": "int8_ef"}],
    ids=["adamw", "adafactor", "int8_ef"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-130m",
                                  "qwen2-moe-a2.7b"])
def test_train_state_specs_equal_repro(arch, hp_kw):
    jcfg, tcfg = _reduced_pair(arch)
    jmodel = j_build(jcfg)
    jstate = jax.eval_shape(lambda: j_step.init_train_state(
        jmodel, j_step.TrainHParams(**hp_kw), jax.random.PRNGKey(0)))
    tstate = t_step.init_train_state(Model(tcfg, device="meta"),
                                     t_step.TrainHParams(**hp_kw))
    for sizes, names in MESH_SHAPES.values():
        jd, td = j_sh.ShardingDecisions(), ShardingDecisions()
        js = j_sh.train_state_specs(jstate, _jmesh(sizes, names), jd)
        ts = t_sh.train_state_specs(tstate, MeshShape(sizes, names), td)
        assert _canon(ts) == _canon(js)
        assert td.fallbacks == jd.fallbacks


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-130m",
                                  "qwen2-moe-a2.7b", "whisper-large-v3",
                                  "recurrentgemma-9b"])
def test_batch_and_cache_specs_equal_repro(arch, shape_name):
    jcfg, tcfg = _reduced_pair(arch)
    # the reduced configs at a short sequence; the batch keeps the cell's
    shape = dataclasses.replace(SHAPES[shape_name], seq_len=64)
    jshape = j_base.ShapeConfig(shape.name, 64, shape.global_batch,
                                shape.kind)
    mode = t_inputs.fake_mode()
    for sizes, names in MESH_SHAPES.values():
        jm, tm = _jmesh(sizes, names), MeshShape(sizes, names)
        if shape.kind == "decode":
            jin, jcache = j_inputs.decode_input_specs(jcfg, jshape)
            tin, tcache = t_inputs.decode_input_specs(tcfg, shape, mode)
            assert _canon(t_sh.cache_specs(
                t_inputs.stacked_cache(tcache, mode), tm)) == \
                _canon(j_sh.cache_specs(jcache, jm))
        else:
            fn = "train_input_specs" if shape.kind == "train" \
                else "prefill_input_specs"
            jin = getattr(j_inputs, fn)(jcfg, jshape)
            tin = getattr(t_inputs, fn)(tcfg, shape, mode)
        assert _canon(t_sh.batch_specs(tin, tm)) == \
            _canon(j_sh.batch_specs(jin, jm))
        axes = ("data", "model")
        assert _canon(t_sh.batch_specs(tin, tm, axes=axes)) == \
            _canon(j_sh.batch_specs(jin, jm, axes=axes))
        assert tuple(t_sh.batch_spec(tm, 2)) == tuple(j_sh.batch_spec(jm, 2))


def test_shardings_from_specs_places_on_a_fake_mesh():
    from torch.distributed.tensor import Replicate, Shard

    with fake_world(8):
        mesh = make_fake_mesh((4, 2), ("data", "model"))
        specs = {"a": P("data", "model"), "b": P("model", None),
                 "c": [P(("data", "model"), None), P()],
                 "d": P(None, ("model", "data"))}
        got = t_sh.shardings_from_specs(specs, mesh)
    assert got == {"a": [Shard(0), Shard(1)],
                   "b": [Replicate(), Shard(0)],
                   "c": [[Shard(0), Shard(0)], [Replicate(), Replicate()]],
                   "d": [Shard(1), Shard(1)]}
    assert not torch.distributed.is_initialized()


# --- the JAX package's own cases (tests/test_sharding.py), on the port ---

def test_attention_weights_2d_sharded():
    spec = t_sh.spec_for_leaf("blocks/attn/wq/w", (1024, 2048), MESH, False)
    assert spec == P("data", "model")
    spec = t_sh.spec_for_leaf("blocks/attn/wo/w", (2048, 1024), MESH, False)
    assert spec == P("model", "data")


def test_nondivisible_falls_back_replicated():
    d = ShardingDecisions()
    spec = t_sh.spec_for_leaf("blocks/attn/wk/w", (1024, 24), MESH, False, d)
    assert spec == P("data", None)     # 24 not divisible by 16
    assert d.fallbacks


def test_embed_vocab_on_model():
    spec = t_sh.spec_for_leaf("embed/table", (256000, 2048), MESH, False)
    assert spec == P("model", "data")


def test_norm_scales_replicated():
    assert t_sh.spec_for_leaf("blocks/ln1", (2048,), MESH, False) == P()


def test_moe_experts_on_model():
    spec = t_sh.spec_for_leaf("blocks/moe/wi", (128, 2048, 768), MESH,
                              False)
    assert spec == P("model", "data", None)


def test_scanned_params_get_leading_none():
    cfg = get_arch("qwen1.5-0.5b").reduced()
    params = param_tree(Model(cfg, device="meta"))
    specs = t_sh.param_specs(params, MESH)
    wq = specs["blocks"]["attn"]["wq"]["w"]
    assert tuple(wq)[0] is None        # stacked group dim unsharded
    assert len(tuple(wq)) == 3


def test_shape_config_cells_equal_repro():
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in j_base.SHAPES.items()}
    assert ShapeConfig("x", 1, 2, "train") == ShapeConfig("x", 1, 2, "train")
