"""Prefill requests through the port's ``Model`` for a stack of Mamba-2 and
attention mixers each followed by a dropless MoE (the "hybrid_moe"
family: granite-4.0-h-small): each request one forward over ``prompts``
prompts of L tokens, the logits synchronized; a closed loop with one
client.

The model is built from the configuration file's widths and layers over
the port's registered config, with the flash kernel on (``use_pallas``).
Its weights are drawn from the seed on the device by the reference's
``draw``, one tensor at a time, straight into the model's parameters: the
model holds them once, and after the window the reference reads the
model's own tensors, one layer at a time in float32.  Token ids, the kept
logits and the requests are as in ``drivers.prefill``.  The check also
reads the MoE's counters (``repro_torch.telemetry.moe_counts``):
``moe_dropped``, the assignments no expert product was handed over the
whole run; and it checks each MoE layer on its own (``moe_err``): the
logits' check cannot see a fault in a few experts, since the bf16
program's routing differs from the float32 reference's at near-ties in
about a fifth of (token, layer) pairs at the published widths, which
moves the logits about as much.  The window's record is a "prefill"
record, so the prefill readers apply; the traced stretch also times each
MoE layer by CUDA events (its forward pre-hook and hook).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from portbench import traffic as gen_traffic
from portbench.drivers.prefill import POOL, _forward, _loop, _tokens
from portbench.reference import granite4h as ref
from portbench.work import granite4h as work_model

TRACED = 3                 # requests the profiler sees, at the least
ROWS = 2048                # positions a block of the check's differences
PROBE = 4096               # tokens of each MoE layer's own check
QUANTILE = 0.99            # of the tokens' errors in that check
# the published settings the port's hybrid_moe family runs, and no other
RUNS = {"position_embedding_type": "nope", "mamba_n_groups": 1,
        "mamba_conv_bias": True, "mamba_proj_bias": False,
        "attention_bias": False, "hidden_act": "silu",
        "normalization_function": "rmsnorm", "tie_word_embeddings": True}


def port_config(config: Dict):
    """The port's ``HybridMoEConfig`` at the configuration file's widths
    and layers, the flash kernel on."""
    from repro_torch.configs.base import get_arch
    port = get_arch(config["port_arch"])
    for key, value in RUNS.items():
        if config[key] != value:
            raise ValueError(f"the port runs {key} = {value!r}, not "
                             f"{config[key]!r}")
    n = ref.dims(config)
    if config["mamba_n_heads"] * config["mamba_d_head"] != n["d_inner"]:
        raise ValueError("mamba_n_heads * mamba_d_head must be "
                         "mamba_expand * hidden_size")
    layers = config["num_hidden_layers"]
    period = len(port.block_pattern)
    if layers % period or tuple(ref.layer_kinds(config)) \
            != port.block_pattern * (layers // period):
        raise ValueError(f"the layers held must be whole periods of "
                         f"{port.block_pattern}")
    return dataclasses.replace(
        port, n_layers=layers, d_model=n["d"], n_heads=n["q_heads"],
        n_kv_heads=n["kv_heads"], head_dim=n["attn_head_dim"],
        vocab=n["vocab"], n_experts=n["experts"], moe_top_k=n["top_k"],
        d_ff_expert=n["expert"], d_ff_shared=n["shared"],
        ssm_state=config["mamba_d_state"], ssm_head_dim=n["head_dim"],
        ssm_expand=config["mamba_expand"], conv_width=n["conv"],
        norm_eps=config["rms_norm_eps"],
        embedding_multiplier=config["embedding_multiplier"],
        residual_multiplier=config["residual_multiplier"],
        attention_multiplier=config["attention_multiplier"],
        logits_scaling=config["logits_scaling"],
        param_dtype=config["param_dtype"],
        compute_dtype=config["compute_dtype"], use_pallas=True,
        remat="none")


def weights(model) -> Dict:
    """The model's parameters as the reference reads its weights (no
    copies)."""
    w = {"embed": model.embed.table.detach(),
         "final_norm": model.final_norm.detach(), "layers": []}
    for group in model.blocks:
        for layer in group.blocks:
            moe = layer.moe
            lw = {"ln1": layer.ln1, "ln2": layer.ln2,
                  "router": moe.router.w, "wi": moe.wi, "wu": moe.wu,
                  "wo": moe.wo, "shared_wi": moe.shared.wi.w,
                  "shared_wu": moe.shared.wu.w,
                  "shared_wo": moe.shared.wo.w}
            if hasattr(layer, "ssd"):
                s = layer.ssd
                lw.update(in_proj=s.in_proj.w, conv=s.conv_w,
                          conv_bias=s.conv_b, a_log=s.a_log,
                          dt_bias=s.dt_bias, d_skip=s.d_skip,
                          norm=s.norm_scale, out_proj=s.out_proj.w)
            else:
                a = layer.attn
                lw.update(wq=a.wq.w, wk=a.wk.w, wv=a.wv.w, attn_out=a.wo.w)
            w["layers"].append({k: v.detach() for k, v in lw.items()})
    return w


def load(w: Dict, drawn) -> None:
    """Copy each drawn tensor into its place in ``w``, shape for shape."""
    with torch.no_grad():
        for i, name, value in drawn:
            param = w[name] if i is None else w["layers"][i][name]
            if param.shape != value.shape:
                raise ValueError(f"shape {tuple(value.shape)} for {name} of "
                                 f"{tuple(param.shape)}")
            param.copy_(value)


def setup(config: Dict, traffic: Dict, seed: int, dev, log) -> Dict:
    cfg = port_config(config)
    from repro_torch import telemetry
    from repro_torch.models.model import Model
    counted = gen_traffic.expand(traffic["mix"])
    t = time.perf_counter()
    gen = dev.generator(seed)
    model = Model(cfg, device=dev.device)
    w = weights(model)
    load(w, ref.draw(config, gen))
    pool = torch.randint(0, config["vocab_size"], (POOL,), generator=gen,
                         device=dev.device)
    state = {"config": config, "traffic": traffic, "seed": seed, "dev": dev,
             "counted": counted, "weights": w, "model": model, "pool": pool,
             "prompts": traffic["prompts"], "samples": {}}
    log(f"[portbench] set-up: model, weights and token pool "
        f"{time.perf_counter() - t:.3f} s")
    telemetry.reset_moe_counts()
    t = time.perf_counter()
    for item, _ in counted:
        _forward(state, _tokens(state, item["length"], 0))
    dev.sync()
    log(f"[portbench] set-up: warm-up {time.perf_counter() - t:.3f} s")
    from repro_torch.core.space import Workload
    from repro_torch.tuning import default_session
    session = default_session()
    n = ref.dims(config)
    for item, _ in counted:
        B, L = state["prompts"], item["length"]
        log(f"[portbench] resolved ssd L={L}: " + str(session.resolve(
            Workload(op="ssd", n=L, batch=B * n["heads"],
                     variant="chunked"))))
        if model.cfg.use_pallas:
            log(f"[portbench] resolved attention L={L}: " + str(
                session.resolve(Workload(op="attention", n=L,
                                         batch=B * n["q_heads"],
                                         variant="flash"),
                                dims={"lq": L, "lk": L})))
    state["sample_from"] = int(gen_traffic.rng(seed, 2).integers(
        gen_traffic.block_size(counted)))
    state["offsets"] = gen_traffic.rng(seed, 3)
    return state


def window(state: Dict, seconds: float, timed_calls: bool) -> Dict:
    schedule = gen_traffic.schedule(state["counted"], state["seed"])
    state["schedule"] = schedule
    start = time.time()
    t0 = time.perf_counter()
    block = gen_traffic.block_size(state["counted"])
    out = _loop(state, gen_traffic.timed(schedule, seconds, block),
                keep=True)
    window_s = time.perf_counter() - t0
    config, B = state["config"], state["prompts"]
    ok = [L for L, done in zip(out["lengths"], out["done"]) if done]
    by_length = {}
    for L, t in zip(out["lengths"], out["latency_s"]):
        by_length.setdefault(L, []).append(t * 1e3)
    return {"driver": "prefill", "window_start": start,
            "window_s": window_s, "attempted": len(out["lengths"]),
            "failed": len(out["lengths"]) - len(ok), "tokens": B * sum(ok),
            "latency_s": out["latency_s"], "lengths": out["lengths"],
            "flops": sum(work_model.flops(config, B, L) for L in ok),
            "ms_by_length": {L: [len(v), float(np.median(v))]
                             for L, v in sorted(by_length.items())}}


def trace(state: Dict) -> None:
    """Whole blocks of the schedule after the window, ``TRACED`` requests
    or more, under the profiler; CUDA events around each MoE layer."""
    from repro_torch.models.moe import DroplessMoE
    dev = state["dev"]
    n = gen_traffic.block_size(state["counted"])
    n *= -(-TRACED // n)
    items = [next(state["schedule"]) for _ in range(n)]
    layers = [m for m in state["model"].modules()
              if isinstance(m, DroplessMoE)]
    pairs = []

    def before(module, args):
        pairs.append((dev.event(), dev.event()))
        pairs[-1][0].record()

    def after(module, args, out):
        pairs[-1][1].record()

    hooks = [h for m in layers for h in (m.register_forward_pre_hook(before),
                                         m.register_forward_hook(after))]
    try:
        _loop(state, items, keep=False)
    finally:
        for h in hooks:
            h.remove()
    dev.sync()
    per = len(layers)
    B = state["prompts"]
    state["trace_calls"] = [
        {"length": item["length"],
         "moe_least_s": per * work_model.moe_least(state["config"],
                                                   B * item["length"]),
         "moe_device_s": sum(s.elapsed_time(e) for s, e in
                             pairs[j * per:(j + 1) * per]) / 1e3}
        for j, (_, item) in enumerate(items)]


def moe_err(state: Dict, control: bool) -> float:
    """Each MoE layer on a probe drawn from the seed in bf16 (PROBE tokens
    of N(0, 1), a post-norm input's scale), through the program's
    ``DroplessMoE`` (with ``control``, the reference's MoE one precision
    step below) against the float32 reference's MoE on the same values:
    the router sees the same input on both sides, so the routing agrees
    but for float32 ties.  The largest, over the layers, of the QUANTILE
    of the tokens' |got - want| / |want|."""
    from repro_torch.models.moe import DroplessMoE
    config, w, dev = state["config"], state["weights"], state["dev"]
    gen = dev.generator(int(gen_traffic.rng(state["seed"], 4).integers(
        1 << 62)))
    u = torch.randn(PROBE, config["hidden_size"], generator=gen,
                    device=dev.device).to(getattr(torch,
                                                  config["compute_dtype"]))
    layers = [] if control else [m for m in state["model"].modules()
                                 if isinstance(m, DroplessMoE)]
    worst = 0.0
    with torch.inference_mode(), ref.exact_f32():
        for i, lw in enumerate(w["layers"]):
            want = ref.moe(lw, u.float(), config)
            have = ref.moe(lw, u.float(), config, ref._fp8, ref._bf16) \
                if control else layers[i](u, u.dtype).float()
            err = (have - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(
                1e-30)
            worst = max(worst, float(torch.quantile(err, QUANTILE)))
    return worst


def judge(state: Dict, control: bool) -> Dict[str, float]:
    """The kept logits against the float32 reference, prompt by prompt,
    as ``drivers.prefill.judge`` reads them: ``logits_err``, the median
    position's |got - want| / |want|, and ``logits_max_err``, the widest
    logit error over the largest |want|, each position's weighted by its
    conditioning below 1 (``reference.granite4h.forward``); with
    ``control`` the control's logits in the program's place.  And
    ``moe_dropped``: the assignments the MoE's expert products were not
    handed over the whole run, from the program's counters; and
    ``moe_err``, each MoE layer checked on its own (``moe_err``)."""
    from repro_torch import telemetry
    out = {"logits_err": 0.0, "logits_max_err": 0.0,
           "moe_dropped": float(telemetry.moe_counts()["dropped"]),
           "moe_err": moe_err(state, control)}
    state.pop("model", None)
    if state["dev"].cuda:
        torch.cuda.empty_cache()
    config, w = state["config"], state["weights"]
    detail = state["per_length"] = {}
    for item, _ in state["counted"]:
        L = item["length"]
        if L in state["samples"]:
            off, got = state["samples"][L]
        elif control:
            off, got = 0, None
        else:
            return {k: float("inf") for k in out}
        tokens = _tokens(state, L, off)
        for b in range(state["prompts"]):
            with torch.inference_mode():
                want, cond = ref.forward(w, tokens[b], config)
                have = ref.forward(w, tokens[b], config, control=True)[0] \
                    if control else got[b]
                pos, top = [], 0.0
                for r in range(0, L, ROWS):
                    diff = have[r:r + ROWS].float() - want[r:r + ROWS]
                    pos.append(diff.norm(dim=-1) / want[r:r + ROWS].norm(
                        dim=-1).clamp_min(1e-30))
                    top = max(top, float((diff.abs().amax(-1) * cond[
                        r:r + ROWS].clamp(max=1.0)).max()))
                med = float(torch.cat(pos).median())
                top /= float(want.abs().max())
                del want, have
            row = detail.setdefault(L, {"median": 0.0, "max": 0.0})
            row["median"] = max(row["median"], med)
            row["max"] = max(row["max"], top)
            out["logits_err"] = max(out["logits_err"], med)
            out["logits_max_err"] = max(out["logits_max_err"], top)
    return out
