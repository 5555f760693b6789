"""Tuned SSD op: the chunked state-space dual as a planned chain.

``ssd(x, a, b, c)`` with shapes (B, L, H, P), (B, L, H), (B, L, S),
(B, L, S), as ``repro.kernels.ssd.ops.ssd``.  The chunk length comes from
the TunerSession (op="ssd" shares the scan space; tile_n -> chunk).

The op executes the intra -> linrec -> apply chain the planner lays out
(``plan_for_chain``): unfused (``fuse=0``), phase B runs on the shared
``driver.linrec_rows`` building block with the enclosing resolution
threaded into it (``ssd(config=...)`` and ``overrides(ssd=...)`` reach its
radix); fused (``fuse=1``), phases B + C are the sequential
``ssd_state_apply`` launch whose carry holds the inter-chunk state (odd
chunk counts need no fallback).  One chunk (nc <= 1) is the intra kernel
alone.  Every launch is recorded against the chain plan, so
``capture_launches`` traces equal ``chain.launches``.

A CUDA tensor runs the hand-written kernels (``csrc/ssd.cu``, and
``csrc/linrec.cu`` for phase B); a CPU tensor runs their plain versions
through the same chain.  ``b`` and ``c`` are shared by a sequence's heads
(n_groups = 1): the kernels read them per sequence, where the JAX op
broadcasts them to every head first.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import telemetry
from repro_torch.core.space import Workload, fit_block, scan_space
from repro_torch.kernels.blocks import driver
from repro_torch.kernels.blocks.plan import plan_for_chain
from repro_torch.kernels.ssd.kernel import (ssd_apply_entry, ssd_intra,
                                            ssd_state_apply)
from repro_torch.kernels.ssd.ref import ssd_chunked_ref
from repro_torch.tuning import default_session, tuned_kernel


def _normalize(cfg, wl, dims=None):
    """Launch knobs: the chunk length (tuned tile_n fit to L), the radix
    the chain threads into the embedded phase-B scan, and the chain-fusion
    boundary."""
    return {"chunk": fit_block(cfg.get("tile_n", 128), wl.n),
            "radix": cfg.get("radix", 2),
            "fuse": cfg.get("fuse", 0)}


@tuned_kernel("ssd", space=scan_space, kernel=ssd_intra,
              reference=ssd_chunked_ref, normalize=_normalize,
              variants=("chunked",))
@telemetry.spanned("repro.entry.ssd")
def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        config: Optional[dict] = None) -> torch.Tensor:
    B, L, H, P = x.shape
    S = b.shape[-1]
    wl = Workload(op="ssd", n=L, batch=B * H, variant="chunked")
    cfg = default_session().resolve(wl, config=config)
    chunk = cfg["chunk"]
    radix = int(cfg.get("radix", 2))
    fuse = int(cfg.get("fuse", 0))
    # the chain plan (exact: the runtime state dims pin the embedded
    # phase-B launches) — what the conformance tests compare traces to
    chain = plan_for_chain(
        wl, {"tile_n": chunk, "radix": radix, "fuse": fuse}, dims=(S, P))

    # (BH, L, ...) rows; b and c stay (B, L, S), read per sequence
    xbh = x.permute(0, 2, 1, 3).reshape(B * H, L, P)
    abh = a.permute(0, 2, 1).reshape(B * H, L)

    y_intra, a_chunk, state = driver.launch(
        ssd_intra, chain.launches[0], xbh, abh, b, c, chunk=chunk)
    nc = L // chunk
    if nc <= 1:
        # single chunk: the entry state is identically zero — the intra
        # kernel alone is the answer (the plan's one-launch "fused" kind)
        return y_intra.reshape(B, H, L, P).permute(0, 2, 1, 3)

    if fuse:
        # phases B + C in one sequential launch: its (S, P) carry is the
        # inter-chunk recurrence state
        y = driver.launch(ssd_state_apply, chain.launches[-1], y_intra, abh,
                          c, a_chunk, state, chunk=chunk)
        return y.reshape(B, H, L, P).permute(0, 2, 1, 3)

    # phase B: inter-chunk linear recurrence (rows = BH*S*P, length nc) on
    # the shared carry-chain building block — the tuned scan kernels where
    # the (op="scan", variant="linrec") space has a config for nc, the
    # associative-scan reference otherwise (odd nc).  The enclosing
    # resolution is threaded in: the embedded block runs under the chain's
    # radix.
    a_rows = a_chunk[:, None, None, :].expand(B * H, S, P, nc)
    s_rows = state.permute(0, 2, 3, 1)                   # (BH, S, P, nc)
    h = driver.linrec_rows(a_rows.reshape(-1, nc), s_rows.reshape(-1, nc),
                           config={"tile_n": nc, "radix": radix})
    h = h.reshape(B * H, S, P, nc)
    entry = torch.cat([torch.zeros_like(h[..., :1]), h[..., :-1]], dim=-1)
    entry = entry.permute(0, 3, 1, 2)                    # (BH, nc, S, P)

    y = driver.launch(ssd_apply_entry, chain.launches[-1], y_intra, abh, c,
                      entry, chunk=chunk)
    return y.reshape(B, H, L, P).permute(0, 2, 1, 3)
