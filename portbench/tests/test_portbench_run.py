"""Whole runs on the CPU at small sizes (the harness's look for a card
skipped): the result line's keys, ``correct`` true for the program and
false with the timed path broken underneath; run.py without a card."""
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness, timing

CPU = timing.Device(torch.device("cpu"))


def run(bench, cell, config, traffic, trace=False, seconds=0.4):
    return harness.run_cell(bench, cell, 2**31 + 17, seconds, trace, CPU,
                            timing.process_start(), config=config,
                            traffic=traffic)


@pytest.mark.parametrize("trace", [False, True])
def test_grid_run_line(bench, small_grid, trace, three_blocks):
    result = run(bench, "bplg.grid", *small_grid, trace=trace)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert set(result) <= {"correct", "attempted", "failed", "metrics",
                           "device", "breakdown", "checks"}
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    names = set(result["metrics"])
    if trace:
        assert {"host_us_per_call.bplg", "mfu.bplg"} <= names
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert names == {"setup_s", "gelem_per_s"}
    assert set(result["checks"]) == {"scan_err", "tridiag_err", "fft_err"}
    json.dumps(result)


def test_prefill_run_line(bench, small_prefill, three_blocks):
    result = run(bench, "mamba2.prefill", *small_prefill, seconds=0.6)
    assert set(result) == {"correct", "attempted", "failed", "metrics",
                           "device", "checks"}
    assert result["correct"] is True
    assert set(result["metrics"]) == {"setup_s", "prefill_tokens_per_s",
                                      "prefill_p95_ms"}


def _wrap_entry(monkeypatch, fault):
    from portbench.drivers import ops
    real = ops._entry

    def entry(family):
        call = real(family)
        return lambda ins, variant: fault(call(ins, variant), ins)
    monkeypatch.setattr(ops, "_entry", entry)


def _half_rows(out, ins):
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def _one_altered(out, ins):
    out = out.clone()
    flat = out.view(-1)
    flat[flat.numel() // 3] += 0.01 * float(flat.abs().max())
    return out


def _unchanged(out, ins):
    return ins[-1].clone().to(out.dtype)


@pytest.mark.parametrize("fault", [_half_rows, _one_altered, _unchanged])
def test_grid_faults_are_caught(bench, small_grid, monkeypatch, fault,
                                three_blocks):
    _wrap_entry(monkeypatch, fault)
    result = run(bench, "bplg.grid", *small_grid)
    assert result["correct"] is False
    assert all(c["value"] < float("inf") for c in result["checks"].values())


def _state_unchanged(monkeypatch):
    from repro_torch.models import ssm
    monkeypatch.setattr(ssm, "ssd_op", lambda x, a, b, c: torch.zeros_like(x))


def _half_batch(monkeypatch):
    from repro_torch.models.model import Model
    real = Model.forward

    def forward(self, tokens, memory=None):
        half = tokens.shape[0] // 2
        logits, aux = real(self, tokens[:half], memory)
        return torch.cat([logits, torch.zeros_like(logits)]), aux
    monkeypatch.setattr(Model, "forward", forward)


def _logit_altered(monkeypatch):
    from repro_torch.models.model import Model
    real = Model.forward

    def forward(self, tokens, memory=None):
        logits, aux = real(self, tokens, memory)
        logits[0, -1, 0] += 0.5 * float(logits.abs().max())
        return logits, aux
    monkeypatch.setattr(Model, "forward", forward)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _logit_altered])
def test_prefill_faults_are_caught(bench, small_prefill, monkeypatch, fault,
                                   three_blocks):
    fault(monkeypatch)
    result = run(bench, "mamba2.prefill", *small_prefill, seconds=0.6)
    assert result["correct"] is False
    # caught by the fault, not by an output that never came
    assert all(c["value"] < float("inf") for c in result["checks"].values())


def test_run_without_a_card_prints_nothing(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(harness.ROOT, "portbench", "run.py"),
         "--workload", "bplg.grid", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_run_on_card(bench, cuda_device, small_grid):
    """On the card: the grid at 2^12 elements a call through the kernels."""
    result = harness.run_cell(bench, "bplg.grid", 3, 0.5, False,
                              timing.Device(cuda_device),
                              timing.process_start(), config=small_grid[0],
                              traffic=small_grid[1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_time_ms_on_card(cuda_device):
    x = torch.ones(1 << 20, device=cuda_device)
    assert timing.time_ms(lambda: x.add_(1.0), 10) > 0


def test_run_keeps_bytecode_inside_the_checkout(monkeypatch):
    import importlib
    run = importlib.import_module("portbench.run")
    monkeypatch.setattr(sys, "pycache_prefix", None)
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    run.keep_bytecode()
    assert sys.pycache_prefix == os.path.join(harness.ROOT, ".portbench_cache",
                                              "pyc")
    assert sys.dont_write_bytecode is False
