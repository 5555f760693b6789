"""Fixtures of the benchmark's CPU tests: the repository's ``src`` and root
on ``sys.path``, one torch thread a module, small configurations."""
import itertools
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for _path in (os.path.join(ROOT, "src"), ROOT):
    if _path not in sys.path:
        sys.path.insert(0, _path)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def bench():
    from portbench import harness
    return harness.Benchmark(ROOT)


@pytest.fixture
def small_grid(bench):
    """bplg.grid's configuration and mix at 2^12 elements a call."""
    config = bench.config(bench.cell("bplg.grid"))
    config["elements_per_call"] = 1 << 12
    config["families"]["scan"]["sizes"] = [128, 512]
    config["families"]["tridiag"]["sizes"] = [64]
    config["families"]["fft"]["sizes"] = [64, 256]
    return config, bench.traffic(bench.cell("bplg.grid"))


@pytest.fixture
def small_prefill(bench):
    """mamba2.prefill's configuration narrowed (2 layers, d_model 64) and
    a mix of 2 prompts of 32 or 64 tokens."""
    config = bench.config(bench.cell("mamba2.prefill"))
    config.update(n_layer=2, d_model=64, vocab_size=256, d_state=16,
                  headdim=16)
    traffic = bench.traffic(bench.cell("mamba2.prefill"))
    traffic["prompts"] = 2
    traffic["mix"] = [{"length": 32, "weight": 1},
                      {"length": 64, "weight": 1}]
    return config, traffic


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture
def three_blocks(monkeypatch):
    """Windows of exactly three blocks of the schedule, whatever the
    clock: every kept output (drawn within the first two) is then due,
    on a CPU as busy as a test run's."""
    from portbench import traffic
    monkeypatch.setattr(traffic, "timed", lambda schedule, seconds, block:
                        itertools.islice(schedule, 3 * block))
