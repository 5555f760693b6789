"""The port's serving stack against the JAX package's.

``repro_torch.serve`` (``ServeEngine``, ``ReferenceEngine``, the synthetic
traces) held against ``repro.serve`` on the same seeded inputs: the
traces field for field; the engine's greedy tokens, finish reasons,
``prefill_calls`` and ``host_transfers`` on the reduced qwen1.5-0.5b
(multi-request traces), mamba2-130m and recurrentgemma-9b (single
requests: the reference engine's padding steps advance other lanes'
state), all f32 with JAX's weights loaded through
``models.convert.load_params``; the reference engine at temperature 0
and its host sampler at 0.7.  Then the counterparts of
``tests/test_serve.py``'s behaviour tests on the port alone, the seeded
sampling stream and ``warmup()``.  Tokens are compared exactly: every
decode step's top-2 logit margin is asserted above the packages' f32
logit difference, so an argmax can only agree or be a fault.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.models.model import build_model as j_build_model
from repro.serve import ReferenceEngine as JReferenceEngine
from repro.serve import ServeEngine as JServeEngine
from repro.serve import trace as j_trace
from repro_torch.configs.base import get_arch
from repro_torch.models.convert import load_params
from repro_torch.models.model import Model
from repro_torch.serve import (FINISH_LENGTH, FINISH_STOP, ReferenceEngine,
                               Request, ServeEngine, StepRecord)
from repro_torch.serve import trace as t_trace

QWEN, MAMBA, RGEMMA = "qwen1.5-0.5b", "mamba2-130m", "recurrentgemma-9b"
# the packages' f32 logits differ by ~1e-6 of their scale; a greedy token
# is compared exactly only where its top-2 margin is far above that
MARGIN = 1e-4

_BUILT = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Thousands of small decode steps: one torch thread each (beside other
    busy test processes a pool of threads makes every small op wait)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def built(arch: str):
    """(JAX model, its params, the port's model with them), reduced, f32."""
    if arch not in _BUILT:
        j_base._load_all()
        jm = j_build_model(j_base._REGISTRY[arch].reduced())
        params = jm.init(jax.random.PRNGKey(0))
        tm = load_params(Model(get_arch(arch).reduced(), device="cpu"),
                         jax.tree.map(np.asarray, params))
        _BUILT[arch] = (jm, params, tm)
    return _BUILT[arch]


def _assert_margins(tm, requests, max_len):
    """Replay each request's prompt and outputs through the port's
    decode_step alone (B = 1) and assert every emitted token's top-2
    margin exceeds MARGIN: no near-tie could flip an argmax between the
    packages."""
    for req in requests:
        seq = list(req.prompt) + list(req.output)
        with torch.inference_mode():
            cache = tm.init_cache(1, max_len, dtype=torch.float32)
            for t in range(len(seq) - 1):
                lg, cache = tm.decode_step(torch.tensor([[seq[t]]]), cache,
                                           torch.tensor([[t]]))
                if t >= len(req.prompt) - 1:
                    top = torch.topk(lg.reshape(-1), 2).values
                    assert float(top[0] - top[1]) > MARGIN, \
                        f"near-tie at request {req.rid}, position {t}"


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("horizon,vocab", [(1, 512), (12, 512),
                                           (40, 151936)])
def test_synthetic_trace_matches_repro(seed, horizon, vocab):
    jt = j_trace.synthetic_trace(j_trace.default_tenants(), horizon=horizon,
                                 vocab=vocab, seed=seed)
    tt = t_trace.synthetic_trace(t_trace.default_tenants(), horizon=horizon,
                                 vocab=vocab, seed=seed)
    assert len(tt) == len(jt)
    for a, b in zip(tt, jt):
        assert (a.tenant, a.arrival, a.max_new_tokens) \
            == (b.tenant, b.arrival, b.max_new_tokens)
        assert a.prompt.dtype == b.prompt.dtype == np.int32
        np.testing.assert_array_equal(a.prompt, b.prompt)
    assert t_trace.trace_summary(tt) == j_trace.trace_summary(jt)


def test_trace_arguments_checked_as_in_repro():
    assert [vars(s) for s in t_trace.default_tenants()] \
        == [vars(s) for s in j_trace.default_tenants()]
    assert t_trace.trace_summary([]) == j_trace.trace_summary([])
    for mod in (t_trace, j_trace):
        with pytest.raises(ValueError, match="horizon"):
            mod.synthetic_trace(mod.default_tenants(), horizon=0, vocab=8)
        with pytest.raises(ValueError, match="vocab"):
            mod.synthetic_trace(mod.default_tenants(), horizon=1, vocab=0)
        with pytest.raises(ValueError, match="rate"):
            mod.TenantSpec("x", rate=-1.0, prompt_len=(1, 2), max_new=(1, 2))
        with pytest.raises(ValueError, match="bad range"):
            mod.TenantSpec("x", rate=1.0, prompt_len=(3, 2), max_new=(1, 2))


# ---------------------------------------------------------------------------
# The engines against JAX's
# ---------------------------------------------------------------------------

def _qwen_trace_prompts(vocab):
    trace = t_trace.synthetic_trace(t_trace.default_tenants(), horizon=5,
                                    vocab=vocab, seed=0)
    return [(r.prompt, r.max_new_tokens) for r in trace]


ENGINE_CASES = {
    # a multi-tenant trace through 4 lanes: admissions in groups, lane
    # reuse, prompts of 6 ... 64 tokens, chunked prefill
    "qwen-trace": (QWEN, dict(max_batch=4, max_len=80, prefill_chunk=8,
                              admit_threshold=2), None),
    "qwen-eager": (QWEN, dict(max_batch=3, max_len=80, prefill_chunk=16,
                              harvest_every=2), None),
    # a prompt that fills 10 of 16 positions: finish reason "length"
    "qwen-length": (QWEN, dict(max_batch=2, max_len=16),
                    [(np.arange(1, 11, dtype=np.int32), 50),
                     (np.asarray([3, 1, 4], np.int32), 5)]),
    "mamba2": (MAMBA, dict(max_batch=1, max_len=32, prefill_chunk=4),
               [(np.arange(9, dtype=np.int32) * 37 % 512, 6)]),
    # 40 prompt tokens + 6 through the reduced arch's 32-slot ring buffer
    "recurrentgemma": (RGEMMA, dict(max_batch=1, max_len=64,
                                    prefill_chunk=8),
                       [(np.arange(40, dtype=np.int32) * 11 % 512, 6)]),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_serve_engine_matches_repro(case):
    arch, kwargs, prompts = ENGINE_CASES[case]
    jm, params, tm = built(arch)
    if prompts is None:
        prompts = _qwen_trace_prompts(jm.cfg.vocab)
    je = JServeEngine(jm, params, **kwargs)
    te = ServeEngine(tm, **kwargs)
    # the prefill chunk lengths, in order (JAX's through its jitted fn)
    chunks = {"jax": [], "torch": []}
    jprefill, tprefill = je._decode.prefill, tm.prefill

    def jspy(params, cache, toks, *rest):
        chunks["jax"].append(toks.shape[0])
        return jprefill(params, cache, toks, *rest)

    def tspy(toks, *rest):
        chunks["torch"].append(toks.shape[0])
        return tprefill(toks, *rest)

    je._decode.prefill = jspy
    tm.prefill = tspy
    try:
        _run_both(je, te, prompts)
    finally:
        del tm.prefill
    assert chunks["torch"] == chunks["jax"]
    assert all(c & (c - 1) == 0 for c in chunks["torch"])
    _assert_margins(tm, sorted(te.completed, key=lambda r: r.rid),
                    kwargs["max_len"])


def _run_both(je, te, prompts):
    for prompt, new in prompts:
        assert je.submit(prompt, max_new_tokens=new) \
            == te.submit(prompt, max_new_tokens=new)
    jd, td = je.run(), te.run()
    assert [r.rid for r in td] == [r.rid for r in jd]
    assert [r.output for r in td] == [r.output for r in jd]
    assert [r.finish_reason for r in td] == [r.finish_reason for r in jd]
    assert [r.rid for r in te.completed] == [r.rid for r in je.completed]
    assert te.prefill_calls == je.prefill_calls
    assert te.host_transfers == je.host_transfers
    assert te._step_index == je._step_index
    np.testing.assert_array_equal(te.slot_pos, je.slot_pos)


@pytest.mark.parametrize("case", ["qwen-trace", "qwen-length",
                                  "recurrentgemma"])
def test_reference_engine_matches_repro(case):
    arch, kwargs, prompts = ENGINE_CASES[case]
    jm, params, tm = built(arch)
    if prompts is None:
        prompts = _qwen_trace_prompts(jm.cfg.vocab)
    kw = {k: kwargs[k] for k in ("max_batch", "max_len")}
    je, te = JReferenceEngine(jm, params, **kw), ReferenceEngine(tm, **kw)
    for prompt, new in prompts:
        je.submit(prompt, max_new_tokens=new)
        te.submit(prompt, max_new_tokens=new)
    jd, td = je.run(), te.run()
    assert [r.output for r in td] == [r.output for r in jd]
    assert [r.finish_reason for r in td] == [r.finish_reason for r in jd]
    assert te._step_index == je._step_index


def test_reference_sampler_matches_repro_at_temperature():
    """The host sampler draws from np.random.default_rng(seed) as JAX's
    does: the same f32 rows give the same tokens."""
    jm, params, tm = built(QWEN)
    je = JReferenceEngine(jm, params, max_batch=1, max_len=32,
                          temperature=0.7, seed=5)
    te = ReferenceEngine(tm, max_batch=1, max_len=32, temperature=0.7,
                         seed=5)
    rows = np.random.default_rng(11).normal(
        scale=3.0, size=(64, jm.cfg.vocab)).astype(np.float32)
    got = [te._sample(r) for r in rows]
    assert got == [je._sample(r) for r in rows]
    assert len(set(got)) > 1


def test_reference_run_at_temperature_raises_as_in_repro():
    """Both reference engines hand the sampler a (1, V) row, which
    Generator.choice refuses: a run above temperature 0 raises in both."""
    jm, params, tm = built(QWEN)
    for eng in (JReferenceEngine(jm, params, max_batch=2, max_len=32,
                                 temperature=0.7),
                ReferenceEngine(tm, max_batch=2, max_len=32,
                                temperature=0.7)):
        eng.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=2)
        with pytest.raises(ValueError, match="1-dimensional"):
            eng.run()


# ---------------------------------------------------------------------------
# Behaviour (tests/test_serve.py's, on the port)
# ---------------------------------------------------------------------------

def _direct_greedy(tm, prompt, n, max_len):
    with torch.inference_mode():
        cache = tm.init_cache(1, max_len, dtype=torch.float32)
        for t in range(len(prompt) - 1):
            _, cache = tm.decode_step(torch.tensor([[int(prompt[t])]]),
                                      cache, torch.tensor([[t]]))
        out, cur, pos = [], int(prompt[-1]), len(prompt) - 1
        for _ in range(n):
            lg, cache = tm.decode_step(torch.tensor([[cur]]), cache,
                                       torch.tensor([[pos]]))
            cur = int(torch.argmax(lg[0, 0]))
            out.append(cur)
            pos += 1
    return out


def test_single_request():
    _, _, tm = built(QWEN)
    eng = ServeEngine(tm, max_batch=2, max_len=64)
    eng.submit(np.asarray([1, 5, 9], np.int32), max_new_tokens=4)
    done = eng.run()
    assert len(done) == 1 and len(done[0].output) == 4
    assert all(0 <= t < tm.cfg.vocab for t in done[0].output)


def test_continuous_batching_mixed_lengths():
    _, _, tm = built(QWEN)
    eng = ServeEngine(tm, max_batch=2, max_len=64)
    rng = np.random.default_rng(0)
    for i in range(5):   # more requests than slots -> queueing
        eng.submit(rng.integers(0, tm.cfg.vocab, size=3 + i),
                   max_new_tokens=3)
    done = eng.run()
    assert len(done) == 5 and all(len(r.output) == 3 for r in done)


@pytest.mark.parametrize("prompt", [[2, 7, 11], [7]])
def test_greedy_matches_direct_decode(prompt):
    """A 1-token prompt needs no prefill: decode starts from it at 0."""
    _, _, tm = built(QWEN)
    eng = ServeEngine(tm, max_batch=1, max_len=32)
    eng.submit(np.asarray(prompt, np.int32), max_new_tokens=4)
    assert eng.run()[0].output == _direct_greedy(tm, prompt, 4, 32)


def test_empty_prompt_rejected():
    _, _, tm = built(QWEN)
    eng = ServeEngine(tm, max_batch=2, max_len=64)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(np.asarray([], np.int32))
    eng.submit(np.asarray([3, 1], np.int32), max_new_tokens=2)
    done = eng.run()
    assert len(done) == 1 and len(done[0].output) == 2


def test_handcrafted_empty_request_drained_not_crashing():
    _, _, tm = built(QWEN)
    eng = ServeEngine(tm, max_batch=2, max_len=64)
    eng.queue.append(Request(0, np.asarray([], np.int32), 4))
    eng.submit(np.asarray([5], np.int32), max_new_tokens=2)
    done = eng.run()
    assert len(done) == 2
    empty = next(r for r in done if r.prompt.size == 0)
    assert empty.done and empty.output == [] \
        and empty.finish_reason == FINISH_STOP
    assert len(next(r for r in done if r.prompt.size == 1).output) == 2


def test_run_returns_submission_order():
    _, _, tm = built(QWEN)
    eng = ServeEngine(tm, max_batch=2, max_len=64)
    eng.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=8)
    for i in range(3):
        eng.submit(np.asarray([4 + i], np.int32), max_new_tokens=2)
    done = eng.run()
    assert [r.rid for r in done] == [0, 1, 2, 3]
    assert [r.rid for r in eng.completed] != [0, 1, 2, 3]
    assert len(done[0].output) == 8


def test_step_timer_injectable_and_listeners_fire():
    _, _, tm = built(QWEN)

    class FakeClock:
        t = 0.0

        def __call__(self):
            self.t += 0.5e-3          # every timer read advances 0.5ms
            return self.t

    eng = ServeEngine(tm, max_batch=2, max_len=64, step_timer=FakeClock())
    records = []
    eng.add_step_listener(records.append)
    eng.submit(np.asarray([1, 5], np.int32), max_new_tokens=3)
    eng.submit(np.asarray([2], np.int32), max_new_tokens=3)
    assert len(eng.run()) == 2
    assert records and all(isinstance(r, StepRecord) for r in records)
    assert all(abs(r.duration_s - 0.5e-3) < 1e-12 for r in records)
    assert [r.index for r in records] == sorted({r.index for r in records})
    assert all(1 <= r.active <= 2 for r in records)


def test_untimed_engine_has_no_hook_state():
    _, _, tm = built(QWEN)

    def exploding_timer():
        raise AssertionError("timer must not be read without listeners")

    eng = ServeEngine(tm, max_batch=2, max_len=64, step_timer=exploding_timer)
    eng.submit(np.asarray([3, 1], np.int32), max_new_tokens=2)
    done = eng.run()
    assert len(done) == 1 and len(done[0].output) == 2


def test_finish_reason_stop_vs_length():
    _, _, tm = built(QWEN)
    eng = ServeEngine(tm, max_batch=2, max_len=64)
    eng.submit(np.asarray([3, 1, 4], np.int32), max_new_tokens=5)
    done = eng.run()
    assert done[0].finish_reason == FINISH_STOP and len(done[0].output) == 5
    eng = ServeEngine(tm, max_batch=2, max_len=16)
    eng.submit(np.arange(1, 11, dtype=np.int32), max_new_tokens=50)
    done = eng.run()
    assert done[0].finish_reason == FINISH_LENGTH
    assert len(done[0].output) == 6


def test_admit_threshold_batches_admissions():
    _, _, tm = built(QWEN)
    eng = ServeEngine(tm, max_batch=4, max_len=64, prefill_chunk=8,
                      admit_threshold=4)
    rng = np.random.default_rng(7)
    for n in (9, 5, 8, 3):
        eng.submit(rng.integers(0, tm.cfg.vocab, size=n).astype(np.int32),
                   max_new_tokens=3)
    done = eng.run()
    assert [r.rid for r in done] == [0, 1, 2, 3]
    assert all(len(r.output) == 3 for r in done)
    assert eng.prefill_calls == 1


def test_argument_checks_as_in_repro():
    jm, params, tm = built(QWEN)
    for bad, match in ((dict(prefill_chunk=0), "prefill_chunk"),
                       (dict(harvest_every=0), "harvest_every"),
                       (dict(admit_threshold=3), "admit_threshold"),
                       (dict(max_variants=1), "max_variants")):
        with pytest.raises(ValueError, match=match):
            JServeEngine(jm, params, max_batch=2, **bad)
        with pytest.raises(ValueError, match=match):
            ServeEngine(tm, max_batch=2, **bad)


def test_override_provider_reaches_each_step(monkeypatch):
    """The provider's fragment is live on the override stack around every
    engine step (no variant table: an eager step resolves configs on each
    call), and gone outside it."""
    from repro_torch.tuning.overrides import active_overrides

    _, _, tm = built(QWEN)
    seen = []
    real = tm.decode_step

    def spy(*args, **kwargs):
        seen.append(active_overrides("attention"))
        return real(*args, **kwargs)

    monkeypatch.setattr(tm, "decode_step", spy)
    frags = iter([{"block_q": 128}, {"block_q": 256}] * 50)
    current = {}

    def provider():
        current["frag"] = next(frags)
        return {"attention": current["frag"]}

    eng = ServeEngine(tm, max_batch=2, max_len=64)
    eng.set_override_provider(provider)
    eng.submit(np.asarray([3, 1, 4], np.int32), max_new_tokens=4)
    eng.run()
    assert seen and seen[0] == {"block_q": 128}
    assert {frozenset(s.items()) for s in seen} \
        == {frozenset({"block_q": 128}.items()),
            frozenset({"block_q": 256}.items())}
    assert active_overrides("attention") is None


# ---------------------------------------------------------------------------
# Sampling stream and warmup
# ---------------------------------------------------------------------------

def _sampled(tm, seed, temperature, warmup=False):
    eng = ServeEngine(tm, max_batch=3, max_len=48, temperature=temperature,
                      seed=seed, prefill_chunk=4)
    if warmup:
        eng.warmup()
    rng = np.random.default_rng(3)
    for n in (5, 2, 9, 4):
        eng.submit(rng.integers(0, tm.cfg.vocab, size=n).astype(np.int32),
                   max_new_tokens=8)
    return [r.output for r in eng.run()]


def test_same_seed_same_sampled_tokens():
    """Above temperature 0 the draw comes from the engine's seeded
    generator: the same seed gives the same tokens, another seed others,
    and a near-uniform temperature leaves the greedy path."""
    _, _, tm = built(QWEN)
    a = _sampled(tm, seed=3, temperature=0.7)
    assert a == _sampled(tm, seed=3, temperature=0.7)
    hot = _sampled(tm, seed=3, temperature=50.0)
    assert hot == _sampled(tm, seed=3, temperature=50.0)
    assert hot != _sampled(tm, seed=4, temperature=50.0)
    assert hot != _sampled(tm, seed=3, temperature=0.0)


def _snapshot(eng):
    def flat(x):
        if isinstance(x, dict):
            return [t for k in sorted(x) for t in flat(x[k])]
        if isinstance(x, list):
            return [t for item in x for t in flat(item)]
        return [x.clone()]
    state = {k: v.clone() for k, v in eng._state.items() if k != "gen"}
    return (flat(eng.cache), state, eng._state["gen"].get_state().clone(),
            eng.slot_pos.copy(), eng.prefill_calls, eng.host_transfers,
            eng._step_index, list(eng._pending_out))


def test_warmup_leaves_state_untouched():
    _, _, tm = built(RGEMMA)
    eng = ServeEngine(tm, max_batch=2, max_len=64, prefill_chunk=8,
                      temperature=0.7, seed=9)
    before = _snapshot(eng)
    eng.warmup()
    after = _snapshot(eng)
    assert len(before[0]) == len(after[0])
    for a, b in zip(before[0], after[0]):
        assert torch.equal(a, b)
    for key in before[1]:
        assert torch.equal(before[1][key], after[1][key])
    assert torch.equal(before[2], after[2])
    np.testing.assert_array_equal(before[3], after[3])
    assert before[4:] == after[4:]
    # and the sampling stream a run draws from is the one it had
    _, _, qm = built(QWEN)
    assert _sampled(qm, seed=3, temperature=0.7, warmup=True) \
        == _sampled(qm, seed=3, temperature=0.7)
