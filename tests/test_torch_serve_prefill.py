"""Prefill/replay differential on the port: ``ServeEngine`` against the
port's ``ReferenceEngine``, the counterparts of ``tests/test_serve_prefill.py``.

* cache differential — after admitting one prompt, the target slot's cache
  lanes are bit-identical to the reference's per-token replay, across the
  dense KV cache (f32 and bf16 cache), the SSM state and the hybrid's
  RG-LRU state and local-attention cache (a ring buffer where the window
  is shorter than ``max_len``), at odd and chunk-boundary prompt lengths;
* output differential — greedy runs decode the reference's tokens and
  finish reasons (state archs one request at a time: the reference's
  padding steps advance every lane's state);
* the prefill-call count, the one-transfer-per-step contract and the
  prefill budget.

The reduced configs in f32 with JAX's weights (``load_params``).  The
port's caches are per-group lists with the batch on axis 0 of every leaf.
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.models.model import build_model as j_build_model
from repro_torch.configs.base import get_arch
from repro_torch.models.convert import load_params
from repro_torch.models.model import Model
from repro_torch.serve import ReferenceEngine, ServeEngine

CACHE_CASES = [
    ("qwen1.5-0.5b", torch.float32),
    ("qwen1.5-0.5b", torch.bfloat16),
    ("mamba2-130m", torch.float32),
    ("recurrentgemma-9b", torch.float32),
]

_BUILT = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small decode steps: one torch thread (see test_torch_serve)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def built(arch: str):
    """The port's reduced model with JAX's weights (PRNGKey(0))."""
    if arch not in _BUILT:
        j_base._load_all()
        jm = j_build_model(j_base._REGISTRY[arch].reduced())
        params = jm.init(jax.random.PRNGKey(0))
        _BUILT[arch] = load_params(Model(get_arch(arch).reduced(),
                                         device="cpu"),
                                   jax.tree.map(np.asarray, params))
    return _BUILT[arch]


def leaves(cache):
    if isinstance(cache, dict):
        return [t for k in sorted(cache) for t in leaves(cache[k])]
    if isinstance(cache, list):
        return [t for item in cache for t in leaves(item)]
    return [cache]


def assert_lane_bitwise_equal(cache_a, cache_b, lane_a: int,
                              lane_b: int) -> None:
    la, lb = leaves(cache_a), leaves(cache_b)
    assert len(la) == len(lb) and la
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype
        assert torch.equal(a[lane_a], b[lane_b])


def _prefilled(arch, prompt, *, max_batch=3, max_len=32, chunk=8,
               dtype=torch.float32):
    model = built(arch)
    eng = ServeEngine(model, max_batch=max_batch, max_len=max_len,
                      prefill_chunk=chunk, cache_dtype=dtype)
    eng.submit(prompt, max_new_tokens=4)
    eng._admit()                       # prefill only, no decode steps
    ref = ReferenceEngine(model, max_batch=max_batch, max_len=max_len,
                          cache_dtype=dtype)
    ref.submit(prompt, max_new_tokens=4)
    ref._admit()
    return eng, ref


@pytest.mark.parametrize("arch,dtype", CACHE_CASES,
                         ids=[f"{a}-{str(d).split('.')[-1]}"
                              for a, d in CACHE_CASES])
@pytest.mark.parametrize("plen", [1, 2, 7, 9, 12])
def test_prefill_cache_bit_identical_to_replay(arch, dtype, plen):
    """plen 1 (no prefill at all), 2 (one write), 7 (odd tail), 9 (a full
    chunk), 12 (chunk boundary + tail), at prefill_chunk 8."""
    vocab = get_arch(arch).reduced().vocab
    prompt = np.random.default_rng(plen).integers(
        0, vocab, size=plen).astype(np.int32)
    eng, ref = _prefilled(arch, prompt, dtype=dtype)
    assert eng.slot_pos[0] == ref.slot_pos[0] == plen - 1
    assert_lane_bitwise_equal(eng.cache, ref.cache, 0, 0)
    assert eng.prefill_calls == math.ceil((plen - 1) / 8)


@pytest.mark.parametrize("plen", [33, 40])
def test_prefill_ring_buffer_bit_identical_to_replay(plen):
    """recurrentgemma's reduced window (32) below max_len: the attention
    cache is a ring buffer whose position leaf starts at -2^30; prompts
    past the window wrap it, through pow2 chunks with masked tails."""
    vocab = get_arch("recurrentgemma-9b").reduced().vocab
    prompt = np.random.default_rng(plen).integers(
        0, vocab, size=plen).astype(np.int32)
    eng, ref = _prefilled("recurrentgemma-9b", prompt, max_len=64)
    ring = [t for t in leaves(eng.cache) if t.dtype == torch.int32]
    assert ring and all(t.shape[1] == 32 for t in ring)
    assert_lane_bitwise_equal(eng.cache, ref.cache, 0, 0)
    assert eng.prefill_calls == math.ceil((plen - 1) / 8)


def test_prefill_chunk_one_matches_replay():
    prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
    eng, ref = _prefilled("qwen1.5-0.5b", prompt, max_batch=2, chunk=1)
    assert eng.prefill_calls == len(prompt) - 1
    assert_lane_bitwise_equal(eng.cache, ref.cache, 0, 0)


def test_batched_prefill_group_shares_dispatches():
    model = built("qwen1.5-0.5b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, size=n).astype(np.int32)
               for n in (13, 7, 2)]
    eng = ServeEngine(model, max_batch=3, max_len=32, prefill_chunk=4)
    for p in prompts:
        eng.submit(p)
    eng._admit()
    assert eng.prefill_calls == math.ceil((13 - 1) / 4)   # 3, not 12+6+1
    for lane, p in enumerate(prompts):
        ref = ReferenceEngine(model, max_batch=3, max_len=32)
        ref.submit(p)
        ref._admit()
        assert_lane_bitwise_equal(eng.cache, ref.cache, lane, 0)


def test_lane_reset_restores_init_values():
    """A freed lane is reset to its init value from the batch-1 template —
    the ring buffer's -2^30 positions, not zeros — before its next tenant
    prefills."""
    model = built("recurrentgemma-9b")
    eng = ServeEngine(model, max_batch=2, max_len=64, prefill_chunk=8)
    eng.submit(np.arange(1, 20, dtype=np.int32), max_new_tokens=2)
    eng.run()
    fresh = model.init_cache(2, 64, dtype=torch.float32)
    used = leaves(eng.cache)
    assert any(not torch.equal(a[0], b[0])
               for a, b in zip(used, leaves(fresh)))
    eng.submit(np.asarray([5], np.int32), max_new_tokens=2)
    eng._admit()                       # slot 0 reused; 1-token prompt
    for a, b in zip(leaves(eng.cache), leaves(fresh)):
        assert torch.equal(a[0], b[0])


@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen1.5-0.5b"])
def test_padding_lanes_keep_their_cache(arch):
    """Lanes that ride decode steps as padding — one never admitted, one
    mid-prefill under a token budget — keep their cache bit-exactly: the
    empty lane its init value, the prefilling lane what the reference's
    replay of the prompt written so far leaves."""
    model = built(arch)
    rng = np.random.default_rng(6)
    short = rng.integers(0, model.cfg.vocab, size=3).astype(np.int32)
    long = rng.integers(0, model.cfg.vocab, size=30).astype(np.int32)
    eng = ServeEngine(model, max_batch=3, max_len=64, prefill_chunk=4,
                      max_prefill_tokens=4, harvest_every=1)
    eng.submit(short, max_new_tokens=20)
    eng.run(max_steps=2)               # lane 0 decoding
    eng.submit(long, max_new_tokens=2)
    eng.run(max_steps=3)               # lane 1 mid-prefill, lane 2 empty
    filled = eng._prefilling[1]
    assert 0 < filled < len(long) - 1
    fresh = model.init_cache(3, 64, dtype=torch.float32)
    for a, b in zip(leaves(eng.cache), leaves(fresh)):
        assert torch.equal(a[2], b[2])
    ref = ReferenceEngine(model, max_batch=3, max_len=64)
    ref.submit(long[:filled + 1])
    ref._admit()
    assert_lane_bitwise_equal(eng.cache, ref.cache, 1, 0)


# ---------------------------------------------------------------------------
# Output differential
# ---------------------------------------------------------------------------

def test_dense_multi_request_outputs_match_reference():
    model = built("qwen1.5-0.5b")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, model.cfg.vocab, size=n).astype(np.int32)
               for n in (6, 1, 11, 3)]
    eng = ServeEngine(model, max_batch=4, max_len=64, prefill_chunk=4)
    ref = ReferenceEngine(model, max_batch=4, max_len=64)
    for p in prompts:
        eng.submit(p, max_new_tokens=5)
        ref.submit(p, max_new_tokens=5)
    de, dr = eng.run(), ref.run()
    assert [r.output for r in de] == [r.output for r in dr]
    assert [r.finish_reason for r in de] == [r.finish_reason for r in dr]


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_state_arch_outputs_match_reference(arch):
    model = built(arch)
    prompt = np.random.default_rng(3).integers(
        0, model.cfg.vocab, size=9).astype(np.int32)
    eng = ServeEngine(model, max_batch=1, max_len=32, prefill_chunk=4)
    ref = ReferenceEngine(model, max_batch=1, max_len=32)
    eng.submit(prompt, max_new_tokens=6)
    ref.submit(prompt, max_new_tokens=6)
    de, dr = eng.run(), ref.run()
    assert de[0].output == dr[0].output
    assert de[0].finish_reason == dr[0].finish_reason


def test_lane_reuse_does_not_leak_state():
    model = built("mamba2-130m")
    rng = np.random.default_rng(4)
    first = rng.integers(0, model.cfg.vocab, size=5).astype(np.int32)
    second = rng.integers(0, model.cfg.vocab, size=7).astype(np.int32)
    eng = ServeEngine(model, max_batch=1, max_len=32, prefill_chunk=4)
    eng.submit(first, max_new_tokens=4)
    eng.submit(second, max_new_tokens=4)
    reused = {r.rid: r for r in eng.run()}
    solo = ServeEngine(model, max_batch=1, max_len=32, prefill_chunk=4)
    solo.submit(second, max_new_tokens=4)
    assert reused[1].output == solo.run()[0].output


# ---------------------------------------------------------------------------
# Host-transfer contract
# ---------------------------------------------------------------------------

def test_steady_state_decode_single_transfer_per_step():
    model = built("qwen1.5-0.5b")
    eng = ServeEngine(model, max_batch=4, max_len=64, harvest_every=4)
    fetched = []
    real_fetch = eng._fetch

    def counting_fetch(x):
        arr = real_fetch(x)
        fetched.append(arr.shape)
        return arr

    eng._fetch = counting_fetch
    rng = np.random.default_rng(5)
    for _ in range(4):
        eng.submit(rng.integers(0, model.cfg.vocab, size=6).astype(np.int32),
                   max_new_tokens=16)
    assert len(eng.run()) == 4
    steps = eng._step_index
    assert len(fetched) <= steps
    assert len(fetched) <= steps // eng.harvest_every + 2
    assert all(s[-1] == 2 and s[-2] == 4 for s in fetched)
    assert eng.host_transfers == len(fetched)


def test_timed_engine_harvests_every_step():
    model = built("qwen1.5-0.5b")
    ticks = iter(range(10_000))
    eng = ServeEngine(model, max_batch=2, max_len=64,
                      step_timer=lambda: float(next(ticks)))
    records = []
    eng.add_step_listener(records.append)
    eng.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=5)
    eng.run()
    assert records
    assert eng.host_transfers <= eng._step_index
    # each timed step read its own row: one transfer per decode step
    assert eng.host_transfers == len(records)


# ---------------------------------------------------------------------------
# Prefill budget
# ---------------------------------------------------------------------------

def test_prefill_budget_lets_decoders_progress():
    model = built("qwen1.5-0.5b")
    eng = ServeEngine(model, max_batch=2, max_len=128, prefill_chunk=8,
                      max_prefill_tokens=8, harvest_every=1)
    short = np.asarray([5, 3], np.int32)
    long = np.arange(1, 70, dtype=np.int32) % model.cfg.vocab
    eng.submit(short, max_new_tokens=40)
    eng.run(max_steps=2)               # short is admitted and decoding
    eng.submit(long, max_new_tokens=2)
    eng.run(max_steps=4)
    assert eng._prefilling             # the long prompt is mid-prefill...
    short_req = next(r for r in eng.slot_req if r is not None
                     and len(r.prompt) == 2)
    assert len(short_req.output) >= 5  # ...while short kept decoding
    done = eng.run(max_steps=10_000)
    assert len(done) == 2
    solo = ServeEngine(model, max_batch=2, max_len=128, prefill_chunk=8)
    solo.submit(long, max_new_tokens=2)
    assert done[1].output == solo.run()[0].output
