"""The port's data pipeline (``repro_torch.data.pipeline``) against the
JAX package's: the same documents, packed rows, offsets and batches from
the same seeds (its numpy is a verbatim copy), the packing offsets
through the port's ``prefix_sum`` (the plain version on the CPU), and
the JAX package's own cases of ``tests/test_data.py`` on the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as j_pipe
from repro.kernels.scan.ops import prefix_sum as j_prefix_sum
from repro_torch.data import pipeline as t_pipe


def _cfg(mod, **kw):
    base = dict(vocab=512, seq_len=64, global_batch=4, seed=7)
    base.update(kw)
    return mod.DataConfig(**base)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("host_id", [0, 1])
def test_batches_equal_repro(seed, host_id):
    """Three batches for two seeds and two hosts, element for element."""
    jb = j_pipe.Batcher(_cfg(j_pipe, seed=seed), host_id=host_id, n_hosts=2)
    tb = t_pipe.Batcher(_cfg(t_pipe, seed=seed), host_id=host_id, n_hosts=2)
    for _ in range(3):
        want, got = next(jb), next(tb)
        assert sorted(got) == sorted(want) == ["mask", "targets", "tokens"]
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("use_kernel_scan", [False, True])
def test_packing_equals_repro(use_kernel_scan):
    """Rows, segment ids and offsets of the JAX reference path; the port's
    kernel path on the CPU runs the same plain version."""
    cfg = _cfg(j_pipe, seq_len=128)
    want = j_pipe.pack_documents(j_pipe.SyntheticCorpus(cfg).documents(),
                                 cfg.seq_len, 3)
    got = t_pipe.pack_documents(
        t_pipe.SyntheticCorpus(_cfg(t_pipe, seq_len=128)).documents(),
        cfg.seq_len, 3, use_kernel_scan=use_kernel_scan, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_odd_document_counts_pack(monkeypatch):
    """The lengths reach ``prefix_sum`` padded to a power of two, so any
    document count packs (the scan spaces admit no config at 3, 5, 7 ...;
    the JAX package's kernel path raises there)."""
    calls = []
    real = t_pipe.prefix_sum
    monkeypatch.setattr(t_pipe, "prefix_sum",
                        lambda x: calls.append(tuple(x.shape)) or real(x))
    for count in (1, 3, 5, 7, 69):
        docs = iter([np.full(10, i + 1, np.int32) for i in range(count)])
        rows, _, offsets = t_pipe.pack_documents(docs, 10 * count - 1, 1,
                                                 use_kernel_scan=True,
                                                 device="cpu")
        np.testing.assert_array_equal(offsets, 10.0 * np.arange(1, count + 1))
        assert rows.shape == (1, 10 * count)
    assert calls == [(1, 2), (1, 4), (1, 8), (1, 8), (1, 128)]
    with pytest.raises(ValueError, match="no valid config"):
        j_prefix_sum(jnp.ones((1, 3), jnp.float32), interpret=True)


def test_kernel_scan_runs_on_the_named_device(monkeypatch):
    seen = []
    real = t_pipe.prefix_sum
    monkeypatch.setattr(t_pipe, "prefix_sum",
                        lambda x: seen.append(x.device.type) or real(x))
    cfg = _cfg(t_pipe)
    docs = t_pipe.SyntheticCorpus(cfg).documents()
    t_pipe.pack_documents(docs, cfg.seq_len, 2, use_kernel_scan=True,
                          device=torch.device("cpu"))
    t_pipe.pack_documents(docs, cfg.seq_len, 2)
    assert seen == ["cpu", "cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_pipe.pack_documents(docs, cfg.seq_len, 2, use_kernel_scan=True,
                              device="cuda")


# --- the JAX package's own cases (tests/test_data.py), on the port ---

def test_deterministic_across_instances():
    b1 = next(iter(t_pipe.Batcher(_cfg(t_pipe))))
    b2 = next(iter(t_pipe.Batcher(_cfg(t_pipe))))
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])


def test_different_hosts_differ():
    b1 = next(iter(t_pipe.Batcher(_cfg(t_pipe), host_id=0, n_hosts=2)))
    b2 = next(iter(t_pipe.Batcher(_cfg(t_pipe), host_id=1, n_hosts=2)))
    assert not np.array_equal(b1["tokens"], b2["tokens"])


def test_shapes_and_mask():
    batch = next(iter(t_pipe.Batcher(_cfg(t_pipe))))
    assert batch["tokens"].shape == (4, 64)
    assert batch["targets"].shape == (4, 64)
    assert set(np.unique(batch["mask"])) <= {0.0, 1.0}
    # targets are tokens shifted by one
    rows = np.concatenate([batch["tokens"], batch["targets"][:, -1:]], axis=1)
    np.testing.assert_array_equal(rows[:, 1:-1], batch["targets"][:, :-1])


def test_packing_offsets_are_prefix_sums():
    cfg = _cfg(t_pipe)
    docs = t_pipe.SyntheticCorpus(cfg).documents()
    _, _, offsets = t_pipe.pack_documents(docs, cfg.seq_len, 2)
    diffs = np.diff(np.concatenate([[0.0], offsets]))
    assert (diffs > 0).all()          # doc lengths positive
    assert offsets[-1] >= 2 * (cfg.seq_len + 1)
