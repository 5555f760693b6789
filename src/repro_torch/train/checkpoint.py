"""Checkpointing with manifests, async writes and auto-resume: the port's
``repro.train.checkpoint``, with the same layout and contract.

Layout per step:
    <dir>/step_<n>.tmp/ -> (atomic rename) -> <dir>/step_<n>/
        manifest.json    leaf paths, shapes, dtypes, content hashes
        <leaf-id>.npy    one file per leaf

  * writes land in a .tmp dir and are renamed only after the manifest is
    fsync'd, so a crash mid-write never leaves a "latest" checkpoint that
    fails to load;
  * ``latest_step`` only considers directories with a manifest; each
    leaf's hash (``sha256`` of its bytes, 16 hex digits) is checked on
    load, and ``restore_latest`` skips a checkpoint that fails;
  * async mode serializes and writes on a worker thread; ``wait()`` joins
    (before the next save and at exit);
  * ``keep_last`` prunes old checkpoints after a successful save.

The keys are the JAX package's paths (``params/blocks/attn/wq/w``,
``opt/mu/...``, ``opt/count``, ``step``), in its flattening order
(``optim.tree``).  numpy has no bfloat16: a bf16 leaf is written as its
16-bit patterns (a ``uint16`` array) with ``"bfloat16"`` as the
manifest's dtype, so its bytes and hash are the ones the JAX package
writes (an ``ml_dtypes`` array there), and on restore the manifest's
dtype decides how the bits are read: a JAX-written bf16 leaf (which
``np.load`` returns as raw ``|V2`` records) and a port-written one load
alike.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.tree import flatten_with_path, tree_map_with_path

Tree = Any

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16, "float64": torch.float64,
                 "int8": torch.int8, "int32": torch.int32,
                 "int64": torch.int64, "uint8": torch.uint8,
                 "bool": torch.bool}


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host array and its dtype's name (bf16 as its bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.uint16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if dtype not in _TORCH_DTYPES:
        raise ValueError(f"unsupported checkpoint dtype {dtype!r}")
    return torch.from_numpy(np.array(arr, dtype=dtype))


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 async_write: bool = True):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.keep_last = keep_last
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---------- save ----------
    def save(self, step: int, state: Tree) -> None:
        self.wait()
        # on the host before the worker starts: the next step overwrites
        # the device tensors
        host = [(k, *_host(v)) for k, v in flatten_with_path(state)]
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def _write_guarded(self, step: int, host) -> None:
        try:
            self._write(step, host)
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def _write(self, step: int, host) -> None:
        tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for i, (key, arr, dtype) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype,
                "sha256": hashlib.sha256(arr.tobytes()).hexdigest()[:16],
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._prune()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {err!r}")

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---------- load ----------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Tree, verify: bool = True,
                device: Optional[torch.device] = None) -> Tree:
        """Restore into the structure of ``like`` (tensors or arrays) as
        tensors of the manifest's dtypes, on ``device`` (the CPU by
        default)."""
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)

        def load(key, leaf):
            ent = manifest["leaves"].get(key)
            if ent is None:
                raise KeyError(f"checkpoint {step} missing leaf {key!r}")
            arr = np.load(os.path.join(d, ent["file"]))
            if verify:
                h = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
                if h != ent["sha256"]:
                    raise IOError(f"checkpoint corruption in {key!r}")
            want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
                else np.shape(leaf)
            if list(arr.shape) != list(want):
                raise ValueError(
                    f"shape mismatch for {key!r}: ckpt {arr.shape} vs "
                    f"model {tuple(want)} (elastic re-mesh requires "
                    f"matching global shapes)")
            t = _from_host(arr, ent["dtype"])
            return t if device is None else t.to(device)

        return tree_map_with_path(load, like)

    def restore_latest(self, like: Tree,
                       device: Optional[torch.device] = None
                       ) -> Tuple[Optional[int], Optional[Tree]]:
        """Auto-resume: the newest checkpoint that loads cleanly; corrupt
        ones are skipped (a damaged checkpoint must not wedge the
        restart)."""
        for step in reversed(self.all_steps()):
            try:
                return step, self.restore(step, like, device=device)
            except (IOError, KeyError, ValueError, json.JSONDecodeError):
                continue
        return None, None
