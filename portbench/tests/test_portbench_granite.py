"""granite4h.prefill_16k at small sizes on the CPU: the port's Model against
the plain reference (float32 tight; bf16 at the repo's bf16 tolerance with
the router's choices replayed into the reference, since a near-tie at the
k-th expert flips between bf16 and float32), whole runs and their line,
the planted faults that must read false, the control reading false where
the program passes (and on bplg.large_fft), the new readers, the new files
loading nothing of JAX, and the work model at the published widths."""
import dataclasses
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from portbench import harness, timing
from portbench.drivers import hybrid_prefill as hp
from portbench.reference import granite4h as ref
from portbench.work import granite4h as work
from portbench.work.peaks import BF16_FLOPS

CPU = timing.Device(torch.device("cpu"))
CELL = "granite4h.prefill_16k"
NEW = ("moe_host_ms.granite", "moe_roofline.granite",
       "expert_load_max_pct.granite")


@pytest.fixture
def small_granite(bench, monkeypatch):
    """granite4h.prefill_16k's configuration narrowed (one period of ten
    layers, hidden size 64, 8 experts of 32, 2 a token) and a mix of 1
    prompt of 32 tokens; hybrid_prefill's model with the plain-op attention
    (the flash op's plain version takes 128 tokens or more, and
    tests/test_torch_granite.py holds the two paths equal)."""
    config = bench.config(bench.cell(CELL))
    config.update(hidden_size=64, num_attention_heads=4,
                  num_key_value_heads=2, mamba_n_heads=8, mamba_d_head=16,
                  mamba_d_state=16, num_local_experts=8,
                  num_experts_per_tok=2, intermediate_size=32,
                  shared_intermediate_size=64, vocab_size=256,
                  num_hidden_layers=10)
    traffic = bench.traffic(bench.cell(CELL))
    traffic["mix"] = [{"length": 32, "weight": 1}]
    real = hp.port_config
    monkeypatch.setattr(hp, "port_config", lambda c: dataclasses.replace(
        real(c), use_pallas=False))
    return config, traffic


@pytest.fixture
def small_large_fft(bench):
    """bplg.large_fft's mix at 2^14 elements a call, N 8192 and 16384
    (the fused kernel's largest and the four-step driver's smallest)."""
    config = bench.config(bench.cell("bplg.large_fft"))
    config["elements_per_call"] = 1 << 14
    config["families"]["large_fft"]["sizes"] = [8192, 16384]
    return config, bench.traffic(bench.cell("bplg.large_fft"))


@pytest.fixture(autouse=True)
def counters():
    from repro_torch import telemetry
    telemetry.reset_moe_counts()
    telemetry.clear()
    yield telemetry
    telemetry.reset_moe_counts()
    telemetry.clear()


class _Torch(types.SimpleNamespace):
    """``torch`` with some of its functions replaced."""

    def __getattr__(self, name):
        return getattr(torch, name)


def _model(config, dtype, seed):
    config = dict(config, param_dtype=dtype, compute_dtype=dtype)
    from repro_torch.models.model import Model
    model = Model(hp.port_config(config), device="cpu")
    w = hp.weights(model)
    gen = torch.Generator().manual_seed(seed)
    hp.load(w, ref.draw(config, gen))
    return config, model, w, gen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_matches_the_reference(small_granite, monkeypatch, dtype):
    """Two prompts through the port's Model against the reference prompt
    by prompt: float32 within 2e-5 of the largest logit (the repo's float32
    tolerance, DTYPE_TOL); bf16 within the repo's bf16 tolerance (2e-2
    relative and 2e-2 of the largest logit), the reference replaying the
    experts the program chose."""
    from repro_torch.models import moe as t_moe
    config, model, w, gen = _model(small_granite[0], dtype, seed=1)
    tokens = torch.randint(0, config["vocab_size"], (2, 32), generator=gen)
    chosen = []

    def topk_kept(x, k, dim=-1):
        out = torch.topk(x, k, dim=dim)
        chosen.append(out[1])
        return out
    monkeypatch.setattr(t_moe, "torch", _Torch(topk=topk_kept))
    with torch.no_grad():
        got, _ = model(tokens)
    monkeypatch.undo()
    assert len(chosen) == config["num_hidden_layers"]
    for b in range(2):
        if dtype == "float32":
            want, cond = ref.forward(w, tokens[b], config)
            err = (got[b] - want).abs().max() / want.abs().max()
            assert float(err) < 2e-5
            continue
        replay = iter(chosen)

        def topk_replayed(x, k, dim=-1, b=b, replay=replay):
            idx = next(replay).view(2, 32, k)[b]
            return x.gather(-1, idx), idx
        monkeypatch.setattr(ref, "torch", _Torch(topk=topk_replayed))
        want, cond = ref.forward(w, tokens[b], config)
        monkeypatch.undo()
        torch.testing.assert_close(got[b].float(), want, rtol=2e-2,
                                   atol=2e-2 * float(want.abs().max()))
        assert cond.shape == (32,) and float(cond.min()) <= 1.0


def test_weights_repeat_under_a_seed_and_load_once(small_granite):
    config = small_granite[0]
    a = ref.collect(ref.draw(config, torch.Generator().manual_seed(2**31 + 9)))
    b = ref.collect(ref.draw(config, torch.Generator().manual_seed(2**31 + 9)))
    assert torch.equal(a["embed"], b["embed"])
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a["layers"],
                                                        b["layers"])
               for k in x)
    assert [sorted(lw) == sorted(a["layers"][0]) for lw in a["layers"]] \
        .count(False) == 1                          # the attention layer
    assert a["embed"].dtype == torch.bfloat16
    assert a["layers"][0]["d_skip"].dtype == torch.float32
    _, model, w, _ = _model(config, "bfloat16", seed=3)
    ptrs = {p.data_ptr() for p in model.parameters()}
    assert {t.data_ptr() for lw in w["layers"] for t in lw.values()} <= ptrs
    assert sum(len(lw) for lw in w["layers"]) + 2 == \
        len(list(model.parameters()))


def run(bench, config, traffic, trace=False):
    return harness.run_cell(bench, CELL, 2**31 + 17, 0.4, trace, CPU,
                            timing.process_start(), config=config,
                            traffic=traffic)


@pytest.mark.parametrize("trace", [False, True])
def test_run_line(bench, small_granite, three_blocks, monkeypatch, trace):
    monkeypatch.setattr(hp, "TRACED", 1)
    result = run(bench, *small_granite, trace=trace)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["checks"]) == {"logits_err", "logits_max_err",
                                     "moe_dropped", "moe_err"}
    assert result["checks"]["moe_dropped"]["value"] == 0
    if trace:
        assert set(NEW) | {"mfu.prefill", "forward_host_ms.prefill"} \
            <= set(result["metrics"])
        load = result["metrics"]["expert_load_max_pct.granite"]["value"]
        assert 100.0 <= load <= 100.0 * 8
    else:
        assert set(result["metrics"]) == {"setup_s", "prefill_tokens_per_s",
                                          "prefill_p95_ms"}


def _expert_zeroed(monkeypatch):
    from repro_torch.models import moe as t_moe
    real = t_moe.grouped_mm

    def grouped(x, w, ends):
        out = real(x, w, ends)
        out[:int(ends[0])] = 0
        return out
    monkeypatch.setattr(t_moe, "grouped_mm", grouped)


def _no_d_skip(monkeypatch):
    """The program's D left out: the model's blocks get zeros while the
    reference keeps the drawn D."""
    from repro_torch.models.ssm import SSDBlock
    real = hp.weights

    def weights(model):
        w = real(model)
        for m in model.modules():
            if isinstance(m, SSDBlock):
                m.d_skip = torch.nn.Parameter(torch.zeros_like(m.d_skip))
        return w
    monkeypatch.setattr(hp, "weights", weights)


def _assignment_dropped(monkeypatch):
    from repro_torch.models import moe as t_moe
    real = t_moe.expert_ends

    def ends(sorted_e, n):
        out = real(sorted_e, n).clone()
        out[-1] -= 1
        return out
    monkeypatch.setattr(t_moe, "expert_ends", ends)


@pytest.mark.parametrize("fault", [_expert_zeroed, _no_d_skip,
                                   _assignment_dropped])
def test_faults_are_caught(bench, small_granite, monkeypatch, fault,
                           three_blocks):
    fault(monkeypatch)
    result = run(bench, *small_granite)
    assert result["correct"] is False
    assert all(c["value"] < float("inf") for c in result["checks"].values())


@pytest.mark.parametrize("metric", NEW)
def test_new_readers_with_nothing_to_read(metric, monkeypatch):
    read = harness.reader(metric)
    assert read({"driver": "ops", "trace_calls": [1]}) is None
    assert read({"driver": "prefill", "trace_calls": [{"length": 32}]}) \
        is None
    # the parent program: no MoE counters, or no telemetry module at all
    from repro_torch import telemetry
    monkeypatch.delattr(telemetry, "moe_counts")
    assert read({"driver": "prefill", "trace_calls": [{"length": 32}]}) \
        is None
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "telemetry")
    assert read({"driver": "prefill", "trace_calls": [{"length": 32}]}) \
        is None


def test_moe_roofline_reads_the_events():
    read = harness.reader("moe_roofline.granite")
    calls = [{"length": 8, "moe_least_s": 1.0, "moe_device_s": 4.0}] * 3
    assert read({"driver": "prefill", "trace_calls": calls}) == 25.0


def test_work_at_the_published_widths(bench):
    """The cut's 16.31B parameters (32.6 GB in bf16), about 9.6 GFLOP a
    token at 16384 tokens (the MoE about 47%, the Mamba-2 mixers about
    39%), and an MoE layer bound by its operations."""
    config = bench.config(bench.cell(CELL))
    assert round(work.params(config) / 1e9, 2) == 16.31
    L = 16384
    total = work.flops(config, 1, L)
    assert total / L == pytest.approx(9.57e9, rel=0.01)
    moe = 20 * 2 * work.moe_active_params(config) * L
    assert moe / total == pytest.approx(0.474, abs=0.01)
    nbytes, ops = work.moe_work(config, L)
    assert work.moe_least(config, L) == ops / BF16_FLOPS
    assert nbytes == pytest.approx(1.67e9, rel=0.01)
    assert ops == pytest.approx(3.72e12, rel=0.01)
    cfg = hp.port_config(config)
    assert (cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.moe_top_k,
            cfg.d_ff_expert, cfg.d_ff_shared, cfg.use_pallas) == \
        (20, 4096, 72, 10, 768, 1536, True)


def test_the_published_config_is_kept(bench):
    """Every key of the published config.json at its value but the layers
    held, and a configuration the port cannot run refused."""
    config = bench.config(bench.cell(CELL))
    published = config["published"]
    assert {k for k in published if config[k] != published[k]} == \
        {"num_hidden_layers"}
    assert (published["num_hidden_layers"], config["num_hidden_layers"]) \
        == (40, 20)
    for key, value in (("position_embedding_type", "rope"),
                       ("mamba_n_groups", 2), ("num_hidden_layers", 15)):
        with pytest.raises(ValueError):
            hp.port_config(dict(config, **{key: value}))
    assert dataclasses.asdict(hp.port_config(config))["arch"] == \
        "granite-4.0-h-small"


@pytest.mark.parametrize("cell,small", [(CELL, "small_granite"),
                                        ("bplg.large_fft", "small_large_fft")])
def test_control_fails_where_the_program_passes(bench, cell, small, request,
                                                three_blocks):
    """The control in the program's place comes out above a limit on every
    seed tried; the program's own outputs below every limit."""
    from portbench import control
    config, traffic = request.getfixturevalue(small)
    limits = bench.limits(bench.cell(cell))
    lines, _ = control.readings(bench, cell, [1, 2**31 + 3, 12], 0.4, CPU,
                                lambda msg: None, config=config,
                                traffic=traffic)
    for line in lines:
        assert all(line["program"][k] <= limits[k] for k in limits), line
        assert any(line["control"][k] > limits[k] for k in limits), line


def test_new_files_load_nothing_of_jax():
    """The new driver, reference, work model and readers in a fresh
    process: the port is loaded, JAX and the JAX package are not."""
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "from portbench import harness\n"
        "from portbench.reference import granite4h\n"
        "import portbench.drivers.hybrid_prefill, portbench.work.granite4h\n"
        "from repro_torch.models.moe import DroplessMoE\n"
        "for m in %r:\n"
        "    harness.reader(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    ) % (os.path.join(harness.ROOT, "src"), harness.ROOT, NEW)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr
    tops = {m.split(".")[0] for m in json.loads(proc.stdout.splitlines()[-1])}
    assert "repro_torch" in tops
    assert not tops & set(harness.FORBIDDEN)
