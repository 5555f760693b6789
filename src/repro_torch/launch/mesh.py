"""Production and host meshes (``repro.launch.mesh``) on torch's
``DeviceMesh``.

The JAX dry-run asks XLA for 512 host placeholder devices before jax
starts.  Here a *fake world* takes their place: a process group of the
``"fake"`` backend (``torch.testing._internal.distributed.fake_pg``) in
which this process is rank 0 of ``world_size`` ranks and every collective
returns at once without moving data.  A ``DeviceMesh`` over it shards
DTensors exactly as the production mesh would, so a step run on fake
tensors places, redistributes and counts as one rank of the deployment.

A world is explicit and torn down after use: ``fake_world(n)`` starts one
(or reuses the one a caller started, so nested calls such as
``tune_distributed``'s evaluations share it) and destroys it at the
outermost exit.  ``make_production_mesh`` and ``make_host_mesh`` start a
world when none is up; ``release_world()`` ends a world they started.

Spec functions (``distributed.sharding``) take a ``DeviceMesh`` or a plain
:class:`MeshShape` (axis names and sizes, JAX's ``AbstractMesh``), so
specs can be checked without any process group.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.tuning.dispatch import resolve_device


class MeshShape:
    """Axis names and sizes of a mesh, without devices (JAX's
    ``AbstractMesh``): ``axis_names`` and ``shape[name]``."""

    def __init__(self, sizes: Sequence[int], names: Sequence[str]):
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for {len(names)} axes")
        self.axis_names: Tuple[str, ...] = tuple(names)
        self.shape: Dict[str, int] = dict(zip(names, (int(s) for s in sizes)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"MeshShape({tuple(self.shape.values())}, {self.axis_names})"


def mesh_shape(mesh) -> MeshShape:
    """The :class:`MeshShape` of a ``DeviceMesh`` (or of a MeshShape)."""
    if isinstance(mesh, MeshShape):
        return mesh
    names = mesh.mesh_dim_names
    return MeshShape(tuple(mesh.shape), names)


def mesh_tag(mesh) -> str:
    """"16x16", "2x16x16": the record's name for a mesh."""
    return "x".join(str(s) for s in mesh_shape(mesh).shape.values())


# the world this module started: None, or [world_size, backend, depth]
_WORLD: Optional[list] = None


def _start_world(world_size: int, backend: str, acquire: bool) -> None:
    """Start a world of ``world_size`` ranks when none is up (one use);
    ``acquire`` adds a use to the world this module started."""
    import torch.distributed as dist

    global _WORLD
    if dist.is_initialized():
        if dist.get_world_size() != world_size or (
                _WORLD is not None and _WORLD[1] != backend):
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is up; "
                f"a mesh of {world_size} needs its own world (leave the "
                f"other one first)")
        if acquire and _WORLD is not None:
            _WORLD[2] += 1
        return
    if backend == "fake":
        # imported here only: loading repro_torch never loads
        # torch.testing._internal
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    else:
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=0,
                            world_size=world_size)
    _WORLD = [world_size, backend, 1]


def release_world() -> None:
    """End one use of the world this module started; the last use destroys
    its process group.  A group the caller started is left alone."""
    import torch.distributed as dist

    global _WORLD
    if _WORLD is None:
        return
    _WORLD[2] -= 1
    if _WORLD[2] <= 0:
        _WORLD = None
        if dist.is_initialized():
            dist.destroy_process_group()


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A fake process group of ``world_size`` ranks (this process is rank
    0) for the duration of the block; nested blocks of the same size
    reuse it."""
    _start_world(world_size, "fake", acquire=True)
    try:
        yield
    finally:
        release_world()


def make_fake_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` over a fake world of its size (started
    when none is up)."""
    from torch.distributed.device_mesh import init_device_mesh

    _start_world(math.prod(shape), "fake", acquire=False)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """(16,16) ("data","model") single pod; (2,16,16) ("pod","data","model")
    for the 2-pod = 512-chip deployment, over a fake world of that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, axes)


def make_host_mesh(model_axis: int = 1, device: str = "cuda"):
    """Degenerate mesh over the host's real devices: this process's device,
    (1, 1) on one H100, over a world of one rank (or over the ranks of a
    group the caller started, one process a device).  On the card unless
    the caller asks for the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if dev.type == "cuda" and not dist.is_initialized():
        torch.cuda.set_device(dev.index or 0)
    _start_world(dist.get_world_size() if dist.is_initialized() else 1,
                 "nccl" if dev.type == "cuda" else "gloo", acquire=False)
    n = dist.get_world_size()
    data = max(n // model_axis, 1)
    return init_device_mesh(dev.type, (data, model_axis),
                            mesh_dim_names=("data", "model"))


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes the global batch shards over."""
    names = mesh_shape(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, name: str) -> int:
    ms = mesh_shape(mesh)
    if name not in ms.axis_names:
        return 1
    return ms.shape[name]
