"""The port's checkpoint manager (``repro_torch.train.checkpoint``)
against the JAX package's: a checkpoint written by either package
restores in the other with equal keys, hashes and values (f32, as the
reduced configs train); a bf16 train state round-trips bit-exactly in
the port, while the JAX package's own auto-resume raises on the same
bf16 checkpoint (``np.load`` returns its ``ml_dtypes`` leaves as raw
``|V2`` records, which ``jnp.asarray`` refuses); and the JAX package's
own cases of ``tests/test_checkpoint.py`` on the port."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.models.model import Model as JModel
from repro.train import checkpoint as j_ckpt
from repro.train import loop as j_loop
from repro.train import step as j_step
from repro_torch.models.convert import train_state_from_jax
from repro_torch.optim import AdamWState
from repro_torch.optim.tree import flatten_with_path, tree_map
from repro_torch.train.checkpoint import CheckpointManager


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:010d}",
                           "manifest.json")) as f:
        return json.load(f)


def _jax_state(dtype="float32", optimizer="adamw"):
    j_base._load_all()
    cfg = dataclasses.replace(j_base._REGISTRY["qwen1.5-0.5b"].reduced(),
                              param_dtype=dtype)
    hp = j_step.TrainHParams(optimizer=optimizer,
                             grad_compression="int8_ef")
    model = JModel(cfg)
    return model, hp, j_step.init_train_state(model, hp,
                                              jax.random.PRNGKey(3))


def _bits(t):
    if t.dtype == torch.bfloat16:
        t = t.view(torch.uint16)
    return t.numpy().tobytes()


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_a_jax_checkpoint_restores_in_the_port(tmp_path, optimizer):
    _, _, state = _jax_state(optimizer=optimizer)
    j_ckpt.CheckpointManager(str(tmp_path), async_write=False).save(5, state)
    like = train_state_from_jax(jax.tree.map(np.asarray, state))
    m = CheckpointManager(str(tmp_path))
    assert m.latest_step() == 5
    got = m.restore(5, like)
    want = dict(flatten_with_path(like))
    assert [k for k, _ in flatten_with_path(got)] == list(want)
    assert "opt/count" in want and "params/blocks/attn/wq/w" in want
    for key, leaf in flatten_with_path(got):
        assert leaf.dtype == want[key].dtype, key
        assert torch.equal(leaf, want[key]), key


def test_a_port_checkpoint_restores_in_jax(tmp_path):
    """Same manifest (keys, files, shapes, dtypes, hashes) and values."""
    _, _, state = _jax_state()
    j_ckpt.CheckpointManager(str(tmp_path / "jax"),
                             async_write=False).save(2, state)
    port = train_state_from_jax(jax.tree.map(np.asarray, state))
    CheckpointManager(str(tmp_path / "port"), async_write=False).save(2, port)
    assert _manifest(tmp_path / "port", 2) == _manifest(tmp_path / "jax", 2)
    like = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), state)
    got = j_ckpt.CheckpointManager(str(tmp_path / "port")).restore(2, like)
    for (key, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(state)[0]):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(key))


def test_a_bf16_state_round_trips_bit_exactly(tmp_path):
    """The manifest says "bfloat16" and hashes the 16-bit patterns, as the
    JAX package writes them; the port reads its own and JAX's files."""
    _, _, state = _jax_state("bfloat16")
    port = train_state_from_jax(jax.tree.map(np.asarray, state))
    assert port["params"]["embed"]["table"].dtype == torch.bfloat16
    m = CheckpointManager(str(tmp_path / "port"))
    m.save(4, port)
    m.wait()
    j_ckpt.CheckpointManager(str(tmp_path / "jax"),
                             async_write=False).save(4, state)
    assert _manifest(tmp_path / "port", 4) == _manifest(tmp_path / "jax", 4)
    entry = _manifest(tmp_path / "port", 4)["leaves"]["params/embed/table"]
    assert entry["dtype"] == "bfloat16"
    for directory in ("port", "jax"):
        got = CheckpointManager(str(tmp_path / directory)).restore(4, port)
        for (key, a), (_, b) in zip(flatten_with_path(got),
                                    flatten_with_path(port)):
            assert a.dtype == b.dtype, key
            assert _bits(a) == _bits(b), key


def test_jax_auto_resume_raises_on_its_own_bf16_checkpoint(tmp_path):
    """A fault in the reference: ``run_training`` finds the checkpoint,
    restores ``|V2`` leaves and cannot make arrays of them."""
    model, hp, state = _jax_state("bfloat16")
    hp = dataclasses.replace(hp, grad_compression="none")
    state = {k: v for k, v in state.items() if k != "ef_err"}
    j_ckpt.CheckpointManager(str(tmp_path), async_write=False).save(1, state)
    like = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), state)
    _, restored = j_ckpt.CheckpointManager(str(tmp_path)).restore_latest(like)
    assert restored["params"]["embed"]["table"].dtype.str == "|V2"
    loop = j_loop.LoopConfig(total_steps=2, checkpoint_dir=str(tmp_path))
    with pytest.raises(TypeError, match="not a valid JAX array type"):
        j_loop.run_training(model, hp, loop, iter(()), log=lambda *_: None)
    port = CheckpointManager(str(tmp_path)).restore(
        1, train_state_from_jax(jax.tree.map(np.asarray, state)))
    assert port["params"]["embed"]["table"].dtype == torch.bfloat16


def test_restore_onto_a_device(tmp_path):
    m = CheckpointManager(str(tmp_path), async_write=False)
    m.save(1, _state(2.0))
    got = m.restore(1, _state(), device=torch.device("cpu"))
    assert got["params"]["w"].device.type == "cpu"
    assert got["step"].dtype == torch.int64
    step, got = m.restore_latest(_state(), device="cpu")
    assert step == 1 and float(got["params"]["w"][0, 0]) == 2.0


def test_named_tuple_states_keep_their_field_paths(tmp_path):
    state = {"opt": AdamWState({"w": torch.ones(2)}, {"w": torch.zeros(2)},
                               torch.tensor(3, dtype=torch.int32)),
             "step": torch.tensor(3, dtype=torch.int32)}
    m = CheckpointManager(str(tmp_path), async_write=False)
    m.save(3, state)
    assert sorted(_manifest(tmp_path, 3)["leaves"]) == [
        "opt/count", "opt/mu/w", "opt/nu/w", "step"]
    got = m.restore(3, state)
    assert isinstance(got["opt"], AdamWState)
    assert int(got["opt"].count) == 3


# --- the JAX package's own cases (tests/test_checkpoint.py), on the port ---

def _state(v=1.0):
    return {"params": {"w": torch.full((4, 4), v), "b": torch.zeros(4)},
            "step": torch.tensor(7)}


def _like():
    return {"params": {"w": np.zeros((4, 4)), "b": np.zeros((4,))},
            "step": np.asarray(0)}


def test_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path), async_write=False)
    m.save(10, _state(3.0))
    out = m.restore(10, _like())
    np.testing.assert_allclose(out["params"]["w"].numpy(), 3.0)
    assert int(out["step"]) == 7


def test_async_write_then_wait(tmp_path):
    m = CheckpointManager(str(tmp_path), async_write=True)
    m.save(1, _state())
    m.wait()
    assert m.latest_step() == 1


def test_corruption_detected_and_skipped(tmp_path):
    m = CheckpointManager(str(tmp_path), async_write=False, keep_last=10)
    m.save(1, _state(1.0))
    m.save(2, _state(2.0))
    # corrupt step 2's first leaf
    leaf = os.path.join(str(tmp_path), "step_0000000002", "leaf_00000.npy")
    np.save(leaf, np.load(leaf) + 99)
    with pytest.raises(IOError):
        m.restore(2, _like())
    # auto-resume falls back to the newest intact checkpoint
    step, out = m.restore_latest(_like())
    assert step == 1
    np.testing.assert_allclose(out["params"]["w"].numpy(), 1.0)


def test_partial_write_never_visible(tmp_path):
    m = CheckpointManager(str(tmp_path), async_write=False)
    os.makedirs(os.path.join(str(tmp_path), "step_0000000099.tmp"))
    assert m.latest_step() is None      # tmp dirs are not checkpoints


def test_keep_last_prunes(tmp_path):
    m = CheckpointManager(str(tmp_path), async_write=False, keep_last=2)
    for s in [1, 2, 3, 4]:
        m.save(s, _state(float(s)))
    assert m.all_steps() == [3, 4]


def test_shape_mismatch_raises(tmp_path):
    m = CheckpointManager(str(tmp_path), async_write=False)
    m.save(1, _state())
    like = {"params": {"w": np.zeros((8, 8)), "b": np.zeros((4,))},
            "step": np.asarray(0)}
    with pytest.raises(ValueError):
        m.restore(1, like)


def test_checkpoint_restores_across_remesh(tmp_path):
    """Elastic scaling (``tests/test_elastic_restore.py``, on the port): a
    checkpoint written under one device layout restores into a shrunken
    one — global shapes are layout-invariant, so the values come back bit
    for bit and the shrunken mesh's specs are recomputed from the restored
    shapes (equal to JAX's on the same mesh)."""
    from jax.sharding import AbstractMesh

    from repro.distributed import sharding as j_sh
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed import sharding as t_sh
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.model import Model
    from repro_torch.train.fault import plan_elastic_remesh
    from repro_torch.train.step import TrainHParams, init_train_state

    cfg = get_arch("qwen1.5-0.5b").reduced()
    state = init_train_state(Model(cfg, device="cpu"), TrainHParams(),
                             torch.Generator().manual_seed(0))
    m = CheckpointManager(str(tmp_path), async_write=False)
    m.save(3, state)

    # losing a host: plan the shrunken mesh, then restore the same global
    # state (shapes unchanged -> straight load, placed under the new layout)
    plan = plan_elastic_remesh(available_chips=224, model_axis=16,
                               target_batch=256)
    assert plan.data_axis == 14
    like = tree_map(torch.zeros_like, state)
    step, restored = m.restore_latest(like)
    assert step == 3
    for (key, a), (_, b) in zip(flatten_with_path(state),
                                flatten_with_path(restored)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b), key

    sizes, names = (plan.data_axis, 16), ("data", "model")
    specs = t_sh.train_state_specs(restored, MeshShape(sizes, names))
    assert specs == t_sh.train_state_specs(state, MeshShape(sizes, names))
    jparams = tree_map(lambda t: np.zeros(t.shape, np.float32),
                       state["params"])
    try:
        jmesh = AbstractMesh(sizes, names)
    except TypeError:
        jmesh = AbstractMesh(tuple(zip(names, sizes)))
    want = j_sh.param_specs(jparams, jmesh)
    got = _spec_leaves(specs["params"])
    assert [k for k, _ in got] == [k for k, _ in _spec_leaves(want)]
    for (key, g), (_, w) in zip(got, _spec_leaves(want)):
        assert tuple(g) == tuple(w), key


def _spec_leaves(tree, prefix=""):
    """(path, spec) of a spec tree of either package, keys sorted."""
    from jax.sharding import PartitionSpec

    from repro_torch.distributed.sharding import P
    if isinstance(tree, (P, PartitionSpec)):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _spec_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _spec_leaves(v, f"{prefix}/{i}")]
    return []
