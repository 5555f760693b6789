"""Fault-tolerance demo: a training job killed mid-run by an injected node
failure auto-resumes from the newest intact checkpoint.

    PYTHONPATH=src python examples_torch/fault_tolerant_train.py             # the card
    PYTHONPATH=src python examples_torch/fault_tolerant_train.py --device cpu

The counterpart of ``examples/fault_tolerant_train.py``: the host preset
of this directory's ``train_lm.py``, 30 steps, a checkpoint every 10, a
node failure injected at step 17.  Checkpoints go to ``--ckpt`` (default:
a fresh temporary directory), which must hold none yet: the demo starts
from scratch.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Callable, Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import Batcher, DataConfig
from repro_torch.models.model import build_model
from repro_torch.train.fault import FaultInjector
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.step import TrainHParams
from repro_torch.tuning import resolve_device
from train_lm import preset_host

INJECTED = "injected node failure"    # FaultInjector's message


def run(ckpt: str, device: str = "cuda", cfg: Optional[ModelConfig] = None,
        log: Callable[[str], None] = print) -> Dict:
    """The job, its death and its restart; ``cfg`` replaces the host
    preset.  Returns the failure's message, the step the restart resumed
    from and the restart's history."""
    if os.path.isdir(ckpt) and os.listdir(ckpt):
        raise ValueError(f"{ckpt} is not empty: the demo starts from no "
                         f"checkpoint")
    dev = resolve_device(device)
    cfg = cfg if cfg is not None else preset_host()
    hp = TrainHParams(peak_lr=1e-3, warmup_steps=5, total_steps=30,
                      z_weight=0.0)
    loop = LoopConfig(total_steps=30, checkpoint_dir=ckpt,
                      checkpoint_every=10, log_every=10)
    inj = FaultInjector(fail_at_steps=(17,))

    def data():
        return iter(Batcher(DataConfig(vocab=cfg.vocab, seq_len=64,
                                       global_batch=4)))

    died = None
    try:
        run_training(build_model(cfg, device=dev), hp, loop, data(),
                     injector=inj, log=log)
    except RuntimeError as e:
        if INJECTED not in str(e):
            raise               # a real fault, not the demo's
        died = str(e)
        log(f"[fault demo] job died: {e}")

    log("[fault demo] restarting (auto-resume from latest checkpoint)...")
    out = run_training(build_model(cfg, device=dev), hp, loop, data(),
                       injector=inj, log=log)
    log(f"[fault demo] resumed from step {out['resumed_from']}, "
        f"finished at step {out['history'][-1]['step']}")
    return {"died": died, "resumed_from": out["resumed_from"],
            "history": out["history"]}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default=None,
                    help="an empty checkpoint directory (default: a fresh "
                         "temporary one)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(args.ckpt or tempfile.mkdtemp(prefix="fault_demo_ckpt_"),
        args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
