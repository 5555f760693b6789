"""Prefill requests through the port's ``Model`` (``repro_torch.models
.model``): each request one forward over ``prompts`` prompts of L tokens,
the logits synchronized; a closed loop with one client.

The weights are drawn from the seed on the device by the reference's
``draw`` and copied into the port's ``Model`` (built from the
configuration file's widths over the port's registered config); the
reference gets the same tensors.  Token ids are uniform over the
vocabulary's ``vocab_size`` ids (the embedding's padding rows are never
read): each request reads B x L of them from a pool made in set-up,
at an offset drawn from the seed.  The logits of one request of every L,
the first at or after a request drawn from the seed, are kept and judged
against the float32 reference once the window has closed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from portbench import traffic as gen_traffic
from portbench.reference import mamba2 as ref
from portbench.work import mamba2 as work_model
from portbench.work import ssd as work_ssd

POOL = 1 << 22             # token ids drawn in set-up
TRACED = 10                # requests the profiler sees, at the least


def port_config(config: Dict):
    """The port's ``ModelConfig`` at the configuration file's sizes."""
    from repro_torch.configs.base import get_arch
    if config["ngroups"] != 1:
        raise ValueError("the port's SSD block shares b and c over all "
                         "heads (one group)")
    if config["d_intermediate"]:
        raise ValueError("the port's ssm groups run no MLP here")
    return dataclasses.replace(
        get_arch(config["port_arch"]), n_layers=config["n_layer"],
        d_model=config["d_model"], vocab=ref.vocab_rows(config),
        ssm_state=config["d_state"], ssm_head_dim=config["headdim"],
        ssm_expand=config["expand"], conv_width=config["d_conv"],
        norm_eps=config["rms_norm_eps"],
        param_dtype=config["param_dtype"],
        compute_dtype=config["compute_dtype"])


def load(model, w: Dict[str, torch.Tensor]) -> None:
    """Copy the drawn weights into the port's parameters, shape for
    shape."""
    def put(param, value):
        if param.shape != value.shape:
            raise ValueError(f"shape {tuple(value.shape)} for a parameter "
                             f"of {tuple(param.shape)}")
        param.copy_(value)

    with torch.no_grad():
        put(model.embed.table, w["embed"])
        put(model.final_norm, w["final_norm"])
        for i, blk in enumerate(model.blocks):
            put(blk.ln, w["ln"][i])
            s = blk.ssd
            put(s.in_proj.w, w["in_proj"][i])
            put(s.conv_w, w["conv"][i])
            put(s.a_log, w["a_log"][i])
            put(s.dt_bias, w["dt_bias"][i])
            put(s.norm_scale, w["norm"][i])
            put(s.out_proj.w, w["out_proj"][i])


def setup(config: Dict, traffic: Dict, seed: int, dev, log) -> Dict:
    from repro_torch.models.model import Model
    counted = gen_traffic.expand(traffic["mix"])
    t = time.perf_counter()
    gen = dev.generator(seed)
    w = ref.draw(config, gen)
    model = Model(port_config(config), device=dev.device)
    load(model, w)
    pool = torch.randint(0, config["vocab_size"], (POOL,), generator=gen,
                         device=dev.device)
    state = {"config": config, "traffic": traffic, "seed": seed, "dev": dev,
             "counted": counted, "weights": w, "model": model, "pool": pool,
             "prompts": traffic["prompts"], "samples": {}}
    log(f"[portbench] set-up: weights, model and token pool "
        f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    for item, _ in counted:
        _forward(state, _tokens(state, item["length"], 0))
    dev.sync()
    log(f"[portbench] set-up: warm-up {time.perf_counter() - t:.3f} s")
    from repro_torch.core.space import Workload
    from repro_torch.tuning import default_session
    session = default_session()
    log(f"[portbench] tuning DB entries: {session.stats()['db_entries']}")
    _, heads, _, _ = work_model.dims(config)
    for item, _ in counted:
        wl = Workload(op="ssd", n=item["length"],
                      batch=state["prompts"] * heads, variant="chunked")
        log(f"[portbench] resolved ssd L={item['length']}: "
            f"{session.resolve(wl)}")
    state["sample_from"] = int(gen_traffic.rng(seed, 2).integers(
        gen_traffic.block_size(counted)))
    state["offsets"] = gen_traffic.rng(seed, 3)
    return state


def _tokens(state: Dict, length: int, offset: int) -> torch.Tensor:
    n = state["prompts"] * length
    return state["pool"][offset:offset + n].view(state["prompts"], length)


def _forward(state: Dict, tokens: torch.Tensor) -> torch.Tensor:
    with torch.inference_mode():
        logits, _ = state["model"](tokens)
    return logits


def _loop(state: Dict, items, keep: bool) -> Dict:
    dev = state["dev"]
    lengths, latency, done = [], [], []
    offsets = state["offsets"]
    for i, item in items:
        L = item["length"]
        off = int(offsets.integers(POOL - state["prompts"] * L + 1))
        tokens = _tokens(state, L, off)
        t = time.perf_counter()
        try:
            logits = _forward(state, tokens)
            dev.sync()
        except RuntimeError:
            logits = None
        latency.append(time.perf_counter() - t)
        lengths.append(L)
        done.append(logits is not None)
        if keep and logits is not None and i >= state["sample_from"] \
                and L not in state["samples"]:
            state["samples"][L] = (off, logits)
    return {"lengths": lengths, "latency_s": latency, "done": done}


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
    or more, under the profiler: a trace of one short request would be
    mostly the profiler's own start and stop."""
    n = gen_traffic.block_size(state["counted"])
    n *= -(-TRACED // n)
    items = [next(state["schedule"]) for _ in range(n)]
    _loop(state, items, keep=False)
    config, B = state["config"], state["prompts"]
    _, heads, p, s = work_model.dims(config)
    state["trace_calls"] = [
        {"length": item["length"],
         "ssd_least_s": config["n_layer"] * work_ssd.least(
             B, item["length"], heads, p, s)} for _, item in items]


def judge(state: Dict, control: bool) -> Dict[str, float]:
    """The kept logits against the float32 reference, prompt by prompt;
    the worst prompt's two numbers.  ``logits_err``: the median over
    positions of |got - want| / |want| (norms over the vocabulary).
    ``logits_max_err``: the largest |got - want| of one logit, as a share
    of the largest |want|, each position's weighted by its conditioning
    in the reference (``reference.mamba2.forward``) where that is below 1:
    a position whose gated norm divides by a tenth of the usual root mean
    square magnifies rounding about tenfold, in any program.  With
    ``control`` the control's logits take the program's place.  An L of
    the mix with no kept request reads infinity."""
    state.pop("model", None)
    if state["dev"].cuda:
        torch.cuda.empty_cache()
    config, w = state["config"], state["weights"]
    out = {"logits_err": 0.0, "logits_max_err": 0.0}
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
                    if control else got[b].float()
                diff = have - want
                pos = diff.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
                med = float(pos.median())
                top = float((diff.abs().amax(-1) * cond.clamp(max=1.0)).max()
                            / want.abs().max())
            row = detail.setdefault(L, {"median": 0.0, "max": 0.0})
            row["median"] = max(row["median"], med)
            row["max"] = max(row["max"], top)
            out["logits_err"] = max(out["logits_err"], med)
            out["logits_max_err"] = max(out["logits_max_err"], top)
    return out
