"""Deterministic synthetic LM data pipeline with prefix-sum packing: the
port's ``repro.data.pipeline``, its numpy verbatim, so both packages
yield the same token streams.

Documents of power-law lengths are drawn from a seeded generator, then
packed into fixed-length training rows. Packing offsets are computed with
the *tuned scan primitive* (prefix sum of document lengths) — the paper's
kernel dogfooded by the framework's own input path.

The pipeline is host-side numpy (per-host sharding by host id), yielding
already-padded (tokens, targets, mask) batches.

``use_kernel_scan=True`` runs the port's ``prefix_sum`` on the train
device (on the card, the ``scan_add`` kernel); otherwise it runs on a CPU
tensor, through the kernel's plain version.  The lengths are padded with
zeros to a power of two first: the scan spaces admit no config for most
lengths (an odd document count, say), on which the JAX package's kernel
path raises; trailing zeros leave the offsets as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.kernels.scan.ops import prefix_sum
from repro_torch.tuning.dispatch import resolve_device


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    bos_id: int = 1
    pad_id: int = 0


class SyntheticCorpus:
    """Infinite deterministic document stream (zipf-ish unigrams so the
    loss curve is non-trivial: frequent tokens are learnable)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        self.rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, host_id]))
        self.n_hosts = n_hosts
        # fixed zipf weights over the vocab
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        self.probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    def documents(self) -> Iterator[np.ndarray]:
        cfg = self.cfg
        while True:
            length = int(np.clip(self.rng.pareto(1.5) * cfg.mean_doc_len * 0.5
                                 + 16, 16, 4 * cfg.mean_doc_len))
            # first-order structure: next token correlated with previous
            toks = self.rng.choice(cfg.vocab, size=length, p=self.probs)
            shift = np.roll(toks, 1)
            mix = self.rng.random(length) < 0.3
            toks = np.where(mix, (shift * 31 + 7) % cfg.vocab, toks)
            toks[0] = cfg.bos_id
            yield toks.astype(np.int32)


def _offsets(lens: np.ndarray, device) -> np.ndarray:
    """Inclusive prefix sums of a (1, n) f32 row through ``prefix_sum`` on
    ``device``, over the row padded with zeros to a power of two."""
    n = lens.shape[1]
    padded = np.zeros((1, max(2, 1 << (n - 1).bit_length())), np.float32)
    padded[:, :n] = lens
    x = torch.from_numpy(padded).to(resolve_device(str(device)))
    return prefix_sum(x).cpu().numpy()[0, :n]


def pack_documents(docs, seq_len: int, batch: int, pad_id: int = 0,
                   use_kernel_scan: bool = False, device="cuda"
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy sequential packing of docs into (batch, seq_len+1) rows.

    Row boundaries come from the prefix sum of document lengths — computed
    with the tuned scan op on ``device`` when requested (the plain version
    on the CPU otherwise).
    """
    rows = np.full((batch, seq_len + 1), pad_id, np.int32)
    seg = np.zeros((batch, seq_len + 1), np.int32)
    lengths = []
    chunks = []
    total = 0
    while total < batch * (seq_len + 1):
        d = next(docs)
        chunks.append(d)
        lengths.append(len(d))
        total += len(d)
    lens = np.asarray(lengths, np.float32)[None, :]
    offsets = _offsets(lens, device if use_kernel_scan else "cpu")
    starts = np.concatenate([[0], offsets[:-1]]).astype(np.int64)
    stream = np.concatenate(chunks)[: batch * (seq_len + 1)]
    rows = stream.reshape(batch, seq_len + 1).astype(np.int32)
    # segment ids from document starts (for packed-attention masks)
    doc_marks = np.zeros(batch * (seq_len + 1), np.int32)
    valid = starts[starts < batch * (seq_len + 1)].astype(np.int64)
    doc_marks[valid] = 1
    seg = np.cumsum(doc_marks).reshape(batch, seq_len + 1).astype(np.int32)
    return rows, seg, offsets


class Batcher:
    """Yields {tokens, targets, mask} host arrays of the global batch shard
    owned by this host."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        self.corpus = SyntheticCorpus(cfg, host_id, n_hosts)
        self.docs = self.corpus.documents()
        self.local_batch = cfg.global_batch // n_hosts

    def __iter__(self):
        return self

    def __next__(self):
        cfg = self.cfg
        rows, seg, _ = pack_documents(self.docs, cfg.seq_len,
                                      self.local_batch, cfg.pad_id)
        tokens = rows[:, :-1]
        targets = rows[:, 1:]
        mask = ((targets != cfg.pad_id)
                & (seg[:, 1:] == seg[:, :-1])).astype(np.float32)
        return {"tokens": tokens, "targets": targets, "mask": mask}
