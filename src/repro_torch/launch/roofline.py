"""Roofline analysis from dry-run records (``repro.launch.roofline``).

Per (arch x shape x mesh) cell:
    compute term    = FLOPs per device / the profile's peak bf16 rate
    memory term     = bytes per device / the profile's HBM bandwidth
    collective term = collective wire bytes per device / its link bandwidth

The FLOPs and bytes are ``launch.op_cost``'s counts of the step (global,
divided by the mesh's devices), as JAX's roofline divides its jaxpr
counts.  JAX parses its collectives from the optimized HLO; here there is
no HLO, and the dry-run's ``DeviceTracker`` records each collective the
DTensor step issues on this device: its kind, its result bytes and its
group size.  Each is scaled by JAX's ring multiplier
(:func:`collective_wire_bytes`, as ``_collective_wire_bytes``: all-gather,
reduce-scatter, all-to-all (n-1)/n of the result; all-reduce 2(n-1)/n;
permute 1).

The rates come from a hardware profile: ``h100`` by default (989e12 FLOP/s,
3.35e12 B/s, 450e9 B/s NVLink); ``tpu_v5e`` gives JAX's numbers exactly.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline --arch X --shape Y \\
      [--multi-pod] [--profile h100]
  PYTHONPATH=src python -m repro_torch.launch.roofline --all
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.configs.base import SHAPES, all_archs, get_arch
from repro_torch.hw.profiles import HardwareProfile, get_profile

def collective_wire_bytes(kind: str, out_bytes: float,
                          group_size: int) -> float:
    """Wire bytes of one collective on a ring, from its result's bytes on
    this device and its group's size (JAX's ``_collective_wire_bytes``)."""
    frac = (group_size - 1) / max(group_size, 1)
    if kind == "all-reduce":
        return 2 * frac * out_bytes
    if kind == "collective-permute":
        return float(out_bytes)
    return frac * out_bytes


def summarize_collectives(collectives: Iterable[Tuple[str, int, int]]
                          ) -> Dict[str, Any]:
    """Per-device wire bytes, by kind, and the count of collectives."""
    per_kind: Dict[str, float] = {}
    count = 0
    for kind, out_bytes, group in collectives:
        per_kind[kind] = per_kind.get(kind, 0.0) + \
            collective_wire_bytes(kind, out_bytes, group)
        count += 1
    return {"per_device_wire_bytes": sum(per_kind.values()),
            "per_kind": per_kind, "count": count,
            "count_by_kind": {k: sum(1 for c in collectives if c[0] == k)
                              for k in per_kind}}


def model_flops(arch: str, shape_name: str, cfg=None, shape=None) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for train; the
    2*N*D forward-only version for prefill; 2*N_active*D per decode token.
    Enc-dec splits by token stream: decoder params x decoder tokens +
    encoder params x frame count."""
    cfg = cfg or get_arch(arch)
    shape = shape or SHAPES[shape_name]
    # active params: embeddings excluded (matmul-active weights only)
    from repro_torch.launch.params import (active_param_count,
                                           audio_split_params)
    mult = 6.0 if shape.kind == "train" else 2.0
    dec_tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
    if cfg.family == "audio":
        enc_p, dec_p = audio_split_params(cfg)
        enc_tokens = (shape.global_batch * cfg.enc_len
                      if shape.kind != "decode" else 0)
        return mult * (dec_p * dec_tokens + enc_p * enc_tokens)
    return mult * active_param_count(cfg) * dec_tokens


def _profile(profile) -> HardwareProfile:
    if profile is None:
        return get_profile("h100")
    return get_profile(profile) if isinstance(profile, str) else profile


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float, chips: int,
                   profile=None) -> Dict[str, float]:
    spec = _profile(profile)
    return {
        "compute_s": flops_per_dev / spec.peak_bf16_flops,
        "memory_s": bytes_per_dev / spec.hbm_bandwidth,
        "collective_s": coll_bytes_per_dev / spec.ici_link_bandwidth,
    }


def analyze_cell(arch: str, shape_name: str, multi_pod: bool = False,
                 arch_cfg=None, hp=None, profile=None, *, mesh=None,
                 shape=None) -> Dict[str, Any]:
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import mesh_shape

    spec = _profile(profile)
    rec = lower_cell(arch, shape_name, multi_pod=multi_pod,
                     return_artifacts=True, arch_cfg=arch_cfg, hp=hp,
                     mesh=mesh, shape=shape)
    if rec["status"] != "ok":
        return rec
    coll = summarize_collectives(rec.pop("_collectives"))
    chips = mesh_shape(mesh).size if mesh is not None else \
        (512 if multi_pod else 256)
    oc = rec.get("op_cost") or {}
    flops_dev = oc.get("flops", 0.0) / chips
    bytes_dev = oc.get("bytes", 0.0) / chips
    terms = roofline_terms(flops_dev, bytes_dev,
                           coll["per_device_wire_bytes"], chips, spec)
    dominant = max(terms, key=terms.get)
    mf = model_flops(arch, shape_name, cfg=arch_cfg, shape=shape)
    rec.update({
        "chips": chips,
        "profile": spec.name,
        "collectives": coll,
        "roofline": terms,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": mf / oc["flops"] if oc.get("flops") else 0,
        "step_time_bound_s": max(terms.values()),
        "mfu_upper_bound": (mf / chips / spec.peak_bf16_flops)
        / max(max(terms.values()), 1e-12),
    })
    return rec


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--profile", default="h100")
    ap.add_argument("--out", default="artifacts/roofline_torch")
    args = ap.parse_args(argv)

    cells: List[Tuple[str, str]] = []
    if args.all:
        for arch in all_archs():
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    os.makedirs(args.out, exist_ok=True)
    failed = 0
    for arch, shape in cells:
        try:
            rec = analyze_cell(arch, shape, multi_pod=args.multi_pod,
                               profile=args.profile)
        except Exception as e:
            import traceback
            rec = {"arch": arch, "shape": shape, "status": "FAILED",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-1500:]}
        tag = f"{arch}|{shape}"
        if rec["status"] == "ok":
            t = rec["roofline"]
            print(f"[roofline] {tag}: comp={t['compute_s']*1e3:.2f}ms "
                  f"mem={t['memory_s']*1e3:.2f}ms "
                  f"coll={t['collective_s']*1e3:.2f}ms "
                  f"dom={rec['dominant']} "
                  f"useful={rec['useful_flops_ratio']:.2f} "
                  f"mfu_ub={rec['mfu_upper_bound']:.3f}", flush=True)
        else:
            failed += rec["status"] == "FAILED"
            print(f"[roofline] {tag}: {rec['status']} "
                  f"{rec.get('reason', rec.get('error',''))}", flush=True)
        mesh_tag = "2x16x16" if args.multi_pod else "16x16"
        with open(os.path.join(args.out, f"{arch}_{shape}_{mesh_tag}.json"),
                  "w") as f:
            json.dump(rec, f, indent=1)
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
