"""Multi-pod dry-run: place and run every (arch x shape x mesh) cell's step
on fake tensors over a fake world (``repro.launch.dryrun``).

JAX lowers and compiles each cell for 512 host placeholder devices.  Here
the cell's step runs as rank 0 of a fake process group of the mesh's size
(``launch.mesh.fake_world``): the model's parameters, the train state and
the inputs are DTensors placed by ``distributed.sharding``'s specs, their
local shards fake tensors (``launch.inputs``), so nothing is allocated and
nothing computed, while DTensor's sharding propagation redistributes
exactly as the deployment would.  The step is the port's own
(``train.step``): ``make_train_step`` / ``make_prefill_step`` /
``make_decode_step`` over a model built from the cell's configuration with
the mesh's hints set (``batch_axes``, ``model_axis_size``, ...), so the
distribution hints in ``models`` apply.  Outputs go back to their specs,
as JAX's ``out_shardings`` put them: the new train state (and so the
gradients, FSDP's reduce-scatter, ``distributed.hints.place_grads``) and
the decode cache.

The record has JAX's keys; here they mean:

  lower_s          seconds to build the fake model, state and inputs and
                   place them on the mesh (JAX: trace and lower);
  compile_s        seconds of the fake step (JAX: compile);
  flops,           ``launch.op_cost`` counts of the step (global, as the
  bytes_accessed   jaxpr walk) over the mesh's devices: per device;
  per_device       argument_bytes: the local shard bytes of the state (or
                   parameters and cache) and the batch; output_bytes: the
                   local bytes of the outputs; temp_bytes: the peak of the
                   bytes the step's local ops hold (``DeviceTracker``; in a
                   train step plus the model's own copy of its parameters,
                   which the port's step keeps beside the state's tree);
                   peak_bytes: argument + temp, as in JAX;
  sharding_fallbacks  ``ShardingDecisions.fallbacks``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --shape train_4k [--multi-pod] [--out artifacts/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import (ModelConfig, SHAPES, ShapeConfig,
                                      all_archs, get_arch, shape_applicable)
from repro_torch.distributed.sharding import (P, ShardingDecisions,
                                              batch_specs, cache_specs,
                                              map_specs, param_specs,
                                              placements_for,
                                              train_state_specs, zip_specs)
from repro_torch.launch.inputs import (abstract_train_state,
                                       decode_input_specs, fake_mode,
                                       fake_model, prefill_input_specs,
                                       stacked_cache, train_input_specs)
from repro_torch.launch.mesh import (batch_axes as mesh_batch_axes,
                                     fake_world, make_production_mesh,
                                     mesh_shape, mesh_tag)
from repro_torch.launch.op_cost import (DeviceTracker, OpCounter,
                                        argument_bytes)
from repro_torch.models.convert import param_tree
from repro_torch.optim.tree import tree_leaves
from repro_torch.train.step import (TrainHParams, make_decode_step,
                                    make_prefill_step, make_train_step)

# per-arch training hyperparameter overrides: gradient accumulation keeps
# the biggest models' activation working set inside device memory (a
# standard production lever)
_HP_OVERRIDES = {
    "llama-3.2-vision-90b": TrainHParams(micro_steps=4),
    "granite-34b": TrainHParams(micro_steps=2),
}

_STACKED = ("blocks", "enc_blocks")


def to_dtensor(t: torch.Tensor, mesh, spec, mode) -> torch.Tensor:
    """A DTensor of ``t``'s global shape and type placed by ``spec``, its
    local shard a fresh fake tensor of ``mode``."""
    from torch.distributed.tensor import DTensor, Shard

    placements = placements_for(spec, mesh)
    local = list(t.shape)
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            local[pl.dim] //= mesh.size(m)
    with mode:
        shard = torch.empty(local, dtype=t.dtype, device=t.device)
    return DTensor.from_local(shard, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def place_tree(tree, specs, mesh, mode):
    """Every leaf of ``tree`` as a DTensor placed by its spec."""
    return zip_specs(lambda s, t: to_dtensor(t, mesh, s, mode), specs, tree)


def _strip(specs):
    """Stacked leaves' specs without their group dim: one group's."""
    return map_specs(lambda s: P(*tuple(s)[1:]), specs)


def _place_module(module: nn.Module, specs, mesh, mode,
                  skip=()) -> None:
    if isinstance(module, nn.ModuleList):
        for child, sub in zip(module, specs):
            _place_module(child, sub, mesh, mode)
        return
    for name, p in list(module._parameters.items()):
        if p is not None:
            module._parameters[name] = nn.Parameter(
                to_dtensor(p, mesh, specs[name], mode),
                requires_grad=p.requires_grad)
    for name, child in module._modules.items():
        if child is not None and name not in skip:
            _place_module(child, specs[name], mesh, mode)


def place_model(model: nn.Module, pspecs, mesh, mode) -> None:
    """Replace each parameter of ``model`` by a DTensor placed by its spec
    in ``pspecs`` (the spec tree of ``param_tree(model)``: a group's
    parameters take their stacked spec without the group dim)."""
    stacked = [k for k in _STACKED
               if isinstance(getattr(model, k, None), nn.ModuleList)]
    for key in stacked:
        group_specs = _strip(pspecs[key])
        for group in getattr(model, key):
            _place_module(group, group_specs, mesh, mode)
    _place_module(model, pspecs, mesh, mode, skip=stacked)


def _local_bytes(tree) -> int:
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = getattr(t, "_local_tensor", t)
            total += loc.numel() * loc.element_size()
    return total


def _redistribute(tree, specs, mesh):
    """The step's outputs on their specs (JAX's ``out_shardings``)."""
    from torch.distributed.tensor import DTensor

    def one(s, t):
        if not isinstance(t, DTensor):
            return t
        return t.redistribute(mesh, placements_for(s, mesh))

    return zip_specs(one, specs, tree)


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               hp: Optional[TrainHParams] = None,
               arch_cfg: Optional[ModelConfig] = None,
               return_artifacts: bool = False, *, mesh=None,
               shape: Optional[ShapeConfig] = None) -> Dict[str, Any]:
    """Place and run one cell's step; returns the dry-run record.

    ``mesh`` (default: the production mesh in a fake world of its size)
    and ``shape`` (default: ``SHAPES[shape_name]``) let a caller run a
    cell on another mesh, such as the host's (``make_host_mesh``)."""
    cfg = arch_cfg or get_arch(arch)
    shape = shape or SHAPES[shape_name]
    tag = mesh_tag(mesh) if mesh is not None else \
        ("2x16x16" if multi_pod else "16x16")
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "mesh": tag, "reason": why}
    world = contextlib.nullcontext() if mesh is not None else \
        fake_world(512 if multi_pod else 256)
    with world:
        mesh = mesh if mesh is not None else \
            make_production_mesh(multi_pod=multi_pod)
        return _lower(arch, shape_name, shape, cfg, mesh, tag, hp,
                      return_artifacts)


def _lower(arch, shape_name, shape, cfg, mesh, tag, hp, return_artifacts):
    from torch.distributed.tensor.experimental import implicit_replication

    ms = mesh_shape(mesh)
    baxes = mesh_batch_axes(mesh)
    if cfg.pure_dp:
        baxes = baxes + ("model",)
    bshards = 1
    for a in baxes:
        bshards *= ms.shape[a]
    cfg = dataclasses.replace(
        cfg, model_axis_size=0 if cfg.pure_dp else ms.shape["model"],
        batch_axes=baxes, batch_shards=bshards)
    hp = hp or _HP_OVERRIDES.get(arch, TrainHParams())
    decisions = ShardingDecisions()
    mode = fake_mode()
    device = mesh.device_type
    t0 = time.time()

    model = fake_model(cfg, mode, device)
    out_specs = None
    extra = 0
    if shape.kind == "train":
        state = abstract_train_state(model, hp, mode)
        sspecs = train_state_specs(state, mesh, decisions,
                                   pure_dp=cfg.pure_dp)
        batch = train_input_specs(cfg, shape, mode, device)
        bspecs = batch_specs(batch, mesh, axes=cfg.batch_axes)
        # the step writes the state's tree into the model's parameters
        place_model(model, param_specs(state["params"], mesh,
                                       pure_dp=cfg.pure_dp), mesh, mode)
        extra = _local_bytes(list(model.parameters()))
        args = (place_tree(state, sspecs, mesh, mode),
                place_tree(batch, bspecs, mesh, mode))
        step = make_train_step(model, hp)
        out_specs = (sspecs, None)
    elif shape.kind == "prefill":
        pspecs = param_specs(param_tree(model), mesh, decisions)
        place_model(model, pspecs, mesh, mode)
        batch = prefill_input_specs(cfg, shape, mode, device)
        args = (place_tree(batch, batch_specs(batch, mesh), mesh, mode),)
        step = make_prefill_step(model)
    else:  # decode
        pspecs = param_specs(param_tree(model), mesh, decisions)
        inputs, cache = decode_input_specs(cfg, shape, mode, device, model)
        cspecs = _strip(cache_specs(stacked_cache(cache, mode), mesh))
        place_model(model, pspecs, mesh, mode)
        ispecs = batch_specs(inputs, mesh)
        inputs = place_tree(inputs, ispecs, mesh, mode)
        cache = [place_tree(c, cspecs, mesh, mode) for c in cache]
        args = (inputs["token"], cache, inputs["pos"])
        if "memory" in inputs:
            args = args + (inputs["memory"],)
        step = make_decode_step(model)
        out_specs = (None, [cspecs] * len(cache))
    params = list(model.parameters())
    arg_bytes = _local_bytes(args) + (
        0 if shape.kind == "train" else _local_bytes(params))
    t_lower = time.time() - t0

    t0 = time.time()
    tracker, counter = DeviceTracker(mode), OpCounter()
    tracker.ignore((args, params))
    with tracker, counter, implicit_replication():
        out = step(*args)
        if out_specs is not None:
            out = tuple(_redistribute(o, s, mesh) if s is not None else o
                        for o, s in zip(out, out_specs))
    t_compile = time.time() - t0

    chips = ms.size
    cost = dict(counter.acc)
    cost["bytes"] += argument_bytes(args) + (
        0 if shape.kind == "train" else argument_bytes(params))
    temp = tracker.peak_bytes + extra
    record = {
        "arch": arch, "shape": shape_name, "mesh": tag,
        "status": "ok",
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "flops": cost["flops"] / chips,
        "bytes_accessed": cost["bytes"] / chips,
        "per_device": {
            "argument_bytes": arg_bytes,
            "output_bytes": _local_bytes(out),
            "temp_bytes": temp,
            "peak_bytes": arg_bytes + temp,
        },
        "sharding_fallbacks": decisions.fallbacks,
    }
    if return_artifacts:
        record["op_cost"] = cost
        record["_collectives"] = list(tracker.collectives)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in all_archs():
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    results = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}|{shape}|{'2x16x16' if mp else '16x16'}"
            try:
                rec = lower_cell(arch, shape, multi_pod=mp)
            except Exception as e:  # a failure here is a bug in the system
                rec = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if mp else "16x16",
                       "status": "FAILED", "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
            results.append(rec)
            status = rec["status"]
            extra = (f" peak={rec['per_device']['peak_bytes']/2**30:.2f}GiB"
                     f" flops={rec['flops']:.3e}"
                     if status == "ok" else rec.get("reason",
                                                    rec.get("error", "")))
            print(f"[dryrun] {tag}: {status}{extra}", flush=True)
            path = os.path.join(args.out,
                                f"{arch}_{shape}_{rec['mesh']}.json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = len(results) - n_ok - n_skip
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
