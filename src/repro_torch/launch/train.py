"""Training driver of the port (``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 20                       # full width, on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --reduced --device cpu --steps 100 --batch 8 --seq 256 --ckpt /tmp/ckpt

The named arch trains at its full width on the card (``--device cuda``,
the default; an error without CUDA), or at ``--reduced`` width, with
weights drawn from the loop's seed.  Gradients through a CUDA kernel
raise (neither package has a backward for one): on the card a model
trains on the plain-op path (``use_pallas`` off, the configs' default),
and the ssm and hybrid archs, whose forward reaches a kernel there, train
on the CPU.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.configs.base import get_arch
from repro_torch.data.pipeline import Batcher, DataConfig
from repro_torch.models.model import build_model
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.step import TrainHParams
from repro_torch.tuning import resolve_device


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro-steps", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=resolve_device(args.device))
    hp = TrainHParams(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps, micro_steps=args.micro_steps)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    loop = LoopConfig(total_steps=args.steps, checkpoint_dir=args.ckpt,
                      checkpoint_every=args.ckpt_every)
    out = run_training(model, hp, loop, iter(Batcher(data_cfg)))
    final = out["history"][-1] if out["history"] else {}
    print(f"[train] done: {final}")


if __name__ == "__main__":
    main()
