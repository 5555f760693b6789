"""End-to-end training driver: a ~100M-parameter decoder LM for a few
hundred steps with checkpointing + fault tolerance.

    PYTHONPATH=src python examples_torch/train_lm.py                 # host preset
    PYTHONPATH=src python examples_torch/train_lm.py --preset 100m   # full 100M
    PYTHONPATH=src python examples_torch/train_lm.py --device cpu --steps 20

The counterpart of ``examples/train_lm.py``, on the card unless
``--device cpu``.  Checkpoints go to ``--ckpt`` (default: a fresh
temporary directory); one that already holds checkpoints is resumed.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
from typing import Any, Callable, Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import Batcher, DataConfig
from repro_torch.models.model import build_model
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.step import TrainHParams
from repro_torch.tuning import resolve_device


def preset_100m() -> ModelConfig:
    """~100M params: 12L x 512 x 8H, d_ff 2048, 32k vocab."""
    return ModelConfig(arch="lm-100m", family="dense", n_layers=12,
                       d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
                       d_ff=2048, vocab=32768, activation="swiglu",
                       param_dtype="float32", compute_dtype="float32",
                       remat="none")


def preset_host() -> ModelConfig:
    """~14M params: runs a few hundred steps in minutes on a CPU host."""
    return dataclasses.replace(preset_100m(), n_layers=4, d_model=256,
                               n_heads=4, head_dim=64, n_kv_heads=4,
                               d_ff=1024, vocab=8192, arch="lm-14m")


def train(cfg: ModelConfig, *, steps: int = 200, batch: int = 8,
          seq: int = 128, ckpt: Optional[str] = None, device: str = "cuda",
          state=None, log: Callable[[str], None] = print) -> Dict[str, Any]:
    """``run_training`` on ``cfg`` with the example's schedule and loop;
    ``state`` (a train state on the device) replaces the loop's seeded
    draw and the resume.  Returns the loop's result."""
    model = build_model(cfg, device=resolve_device(device))
    hp = TrainHParams(peak_lr=1e-3, warmup_steps=20, total_steps=steps,
                      z_weight=0.0)
    data = iter(Batcher(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                   global_batch=batch)))
    loop = LoopConfig(total_steps=steps, log_every=10,
                      checkpoint_every=50, checkpoint_dir=ckpt)
    out = run_training(model, hp, loop, data, state=state, log=log)
    h0, h1 = out["history"][0], out["history"][-1]
    log(f"[train_lm] loss {h0['loss']:.3f} -> {h1['loss']:.3f} over "
        f"{steps} steps (resumed_from={out['resumed_from']})")
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="host", choices=["host", "100m"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = preset_host() if args.preset == "host" else preset_100m()
    ckpt = args.ckpt or tempfile.mkdtemp(prefix="train_lm_ckpt_")
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, ckpt=ckpt,
          device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
