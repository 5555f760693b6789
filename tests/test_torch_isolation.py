"""The port stands alone: no JAX, nothing of the JAX package and nothing
of its benchmarks in ``src/repro_torch``, ``examples_torch`` or
``chip_smoke.py``, and no path that quietly sends a tensor meant for the
card anywhere else."""
import ast
import importlib.util
import os
import subprocess
import sys

import pytest
import torch

from conftest import DTYPE_TOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
EXAMPLES = os.path.join(ROOT, "examples_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _port_files():
    out = [SMOKE]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    out += [os.path.join(EXAMPLES, f) for f in os.listdir(EXAMPLES)
            if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    return module in ("jax", "repro", "ml_dtypes", "benchmarks") \
        or module.startswith(("jax.", "repro.", "ml_dtypes.", "benchmarks."))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{os.path.relpath(path, ROOT)}:{node.lineno} " \
                        f"imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch, repro_torch.kernels.scan.ops, "
            "repro_torch.kernels.tridiag.ops, repro_torch.kernels.fft.ops, "
            "repro_torch.kernels.fft.ref, repro_torch.core.multikernel, "
            "repro_torch.launch.tune, "
            "repro_torch.evaluation, repro_torch.kernels.build, "
            "repro_torch.kernels.ssd.ops, repro_torch.kernels.ssd.ref, "
            "repro_torch.kernels.rglru.ops, repro_torch.kernels.rglru.ref, "
            "repro_torch.configs.base, repro_torch.configs.mamba2_130m, "
            "repro_torch.models.ssm, repro_torch.models.convert, "
            "repro_torch.kernels.attention.ops, "
            "repro_torch.kernels.matmul.ops, repro_torch.models.model, "
            "repro_torch.configs.qwen15_05b, repro_torch.models.moe, "
            "repro_torch.models.recurrent, repro_torch.serve, "
            "repro_torch.serve.engine, repro_torch.serve.reference, "
            "repro_torch.serve.trace, repro_torch.tuning.online, "
            "repro_torch.launch.serve, repro_torch.optim, "
            "repro_torch.optim.compression, repro_torch.train.step, "
            "repro_torch.train.loop, repro_torch.train.checkpoint, "
            "repro_torch.train.fault, repro_torch.data.pipeline, "
            "repro_torch.launch.train, repro_torch.analysis, "
            "repro_torch.evaluation.differential\n"
            "repro_torch.analysis.run_lint(invariants=False)\n"
            "repro_torch.configs.base.all_archs()\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro', "
            "'ml_dtypes') or m.startswith(('jax.', 'repro.', "
            "'ml_dtypes.')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_to_run_without_cuda():
    """No card: a non-zero exit and no result line."""
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['chip_smoke.py']\n"
            "runpy.run_path(%r, run_name='__main__')\n" % SMOKE)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_refuses_to_run_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(SMOKE).read())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_holds_kernels_to_the_tests_tolerances():
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for dtype, tol in smoke.DTYPE_TOL.items():
        assert tol == DTYPE_TOL[dtype]


def test_entry_points_ask_for_the_card_by_default(monkeypatch):
    from repro_torch.tuning.dispatch import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_a_tensor_off_the_cpu_never_reaches_a_plain_version():
    """A non-CPU tensor goes to the CUDA kernel or raises: here (no card)
    a meta tensor raises in every wrapper rather than falling back."""
    from repro_torch.kernels.blocks.driver import apply_add, apply_linrec
    from repro_torch.kernels.scan.kernel import (_launch, _launch_linrec,
                                                 scan_add, scan_linrec,
                                                 scan_linrec_prod)
    from repro_torch.kernels.scan.ops import linear_recurrence, prefix_sum
    from repro_torch.kernels.tridiag.kernel import pcr
    from repro_torch.kernels.tridiag.ops import solve
    x = torch.empty(4, 64, device="meta")
    meta = "no kernel for tensors on meta"
    for call in (lambda: scan_linrec(x, x, rows_per_program=2, tile_n=64,
                                     stages=(2,) * 6),
                 lambda: scan_linrec_prod(x, x, rows_per_program=2,
                                          stages=(2,) * 6),
                 lambda: linear_recurrence(x, x),
                 lambda: apply_linrec(x, x, torch.empty(4, 1, device="meta"),
                                      rows=2),
                 lambda: pcr(x, x, x, x, rows_per_program=2),
                 lambda: solve(x, x, x, x, variant="pcr")):
        with pytest.raises(ValueError, match=meta):
            call()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _launch_linrec(torch.rand(4, 64), torch.rand(4, 64), 2, 64, (2,) * 6,
                       False, False)
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        scan_add(x, rows_per_program=2, tile_n=64, stages=(2,) * 6)
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        prefix_sum(x)
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        apply_add(torch.empty(4, 64, device="meta"),
                  torch.empty(4, 1, device="meta"), rows=2)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        _launch(torch.randn(4, 64), 2, 64, (2,) * 6, 1)


def test_an_fft_off_the_cpu_never_reaches_a_plain_version():
    """The FFT wrapper, both entry points and the four-step driver raise
    for a meta tensor rather than falling back to fft_plain or torch.fft."""
    from repro_torch.core.space import Workload
    from repro_torch.kernels.blocks.driver import four_step_fft
    from repro_torch.kernels.blocks.plan import plan_for
    from repro_torch.kernels.fft import kernel
    from repro_torch.kernels.fft.ops import fft, ifft
    x = torch.empty(4, 64, dtype=torch.complex64, device="meta")
    plan = plan_for(Workload(op="large_fft", n=64, batch=4,
                             variant="stockham"),
                    {"tile_n": 8, "radix": 2, "rows_per_program": 1},
                    max_tile=8)
    meta = "no kernel for tensors on meta"
    for call in (lambda: kernel.fft_stockham(x, rows_per_program=2,
                                             stages=(4, 4, 4)),
                 lambda: fft(x), lambda: ifft(x),
                 lambda: four_step_fft(x, plan, inverse=False)):
        with pytest.raises(ValueError, match=meta):
            call()
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        kernel._launch(torch.zeros(4, 64, dtype=torch.complex64), 2,
                       (4, 4, 4), False, 1)


def test_the_ssd_chain_off_the_cpu_never_reaches_a_plain_version():
    """The three SSD wrappers, the ssd and rglru entry points and the
    Mamba-2 block raise for a meta tensor rather than running a plain
    version; the launch helpers refuse CPU tensors."""
    from repro_torch.configs.mamba2_130m import CONFIG
    from repro_torch.kernels.rglru.ops import rglru
    from repro_torch.kernels.ssd import kernel
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.models.ssm import SSDBlock
    meta = "no kernel for tensors on meta"
    x = torch.empty(4, 64, 16, device="meta")
    a = torch.empty(4, 64, device="meta")
    b = torch.empty(2, 64, 8, device="meta")
    ac = torch.empty(4, 2, device="meta")
    st = torch.empty(4, 2, 8, 16, device="meta")
    for call in (lambda: kernel.ssd_intra(x, a, b, b, chunk=32),
                 lambda: kernel.ssd_state_apply(x, a, b, ac, st, chunk=32),
                 lambda: kernel.ssd_apply_entry(x, a, b, st, chunk=32),
                 lambda: ssd(torch.empty(2, 64, 2, 16, device="meta"),
                             torch.empty(2, 64, 2, device="meta"), b, b),
                 lambda: rglru(torch.empty(2, 64, 8, device="meta"),
                               torch.empty(2, 64, 8, device="meta")),
                 lambda: SSDBlock(CONFIG.reduced(), device="meta")(
                     torch.empty(2, 64, 64, device="meta"),
                     compute_dtype=torch.float32)):
        with pytest.raises(ValueError, match=meta):
            call()
    cpu = (torch.randn(4, 64, 16), torch.rand(4, 64), torch.randn(2, 64, 8))
    with pytest.raises(ValueError, match="need CUDA tensors"):
        kernel._launch_intra(*cpu, cpu[2], 32)
    with pytest.raises(ValueError, match="need CUDA tensors"):
        kernel._launch_apply("ssd_apply_entry", cpu[0], cpu[1], cpu[2], 32,
                             None, torch.zeros(4, 2, 8, 16), False)


def test_the_ssd_source_is_built():
    from repro_torch.kernels import build
    assert "ssd.cu" in build.SOURCES
    assert os.path.exists(os.path.join(build.CSRC, "ssd.cu"))


def test_a_missing_compiler_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises; nothing is loaded in its place."""
    from repro_torch.kernels import build
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    monkeypatch.delenv("CUDACXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_ROOT", str(tmp_path / "build"))
    build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library()


def test_every_cuda_source_is_built():
    """Each source under csrc/ is compiled into the kernel library: every
    .cu file by its own nvcc call, every .cuh header through a source that
    includes it (and into the build's hash, so an edit rebuilds)."""
    from repro_torch.kernels import build
    csrc = os.path.join(PORT, "csrc")
    files = os.listdir(csrc)
    assert sorted(build.SOURCES) == sorted(f for f in files
                                           if f.endswith(".cu"))
    assert sorted(build.HEADERS) == sorted(f for f in files
                                           if f.endswith(".cuh"))
    texts = [open(os.path.join(csrc, f)).read() for f in build.SOURCES]
    for header in build.HEADERS:
        assert any(f'#include "{header}"' in t for t in texts), header


def test_bfloat16_spaces_build_without_jax():
    """numpy names bfloat16 only once ml_dtypes (which JAX imports) is
    loaded; the port's bf16 spaces and plans must not depend on that."""
    code = ("import sys\n"
            "from repro_torch.core.space import Workload, scan_space, "
            "tridiag_space\n"
            "from repro_torch.hw.profiles import dtype_bytes\n"
            "from repro_torch.kernels.blocks.plan import plan_for\n"
            "assert dtype_bytes('bfloat16') == 2\n"
            "for op, fn, v in (('scan', scan_space, 'linrec'), "
            "('tridiag', tridiag_space, 'pcr')):\n"
            "    wl = Workload(op=op, n=1024, batch=64, dtype='bfloat16', "
            "variant=v)\n"
            "    cfgs = fn(wl).enumerate_valid()\n"
            "    assert cfgs and plan_for(wl, cfgs[-1]).launches\n"
            "assert 'ml_dtypes' not in sys.modules and 'jax' not in "
            "sys.modules\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_attention_and_matmul_off_the_cpu_never_reach_a_plain_version():
    """The flash and matmul wrappers, their entry points and a dense model
    on the flash path raise for a meta tensor rather than running a plain
    version; the launch helpers refuse CPU tensors."""
    import dataclasses

    from repro_torch.configs.qwen15_05b import CONFIG
    from repro_torch.kernels.attention import kernel as flash
    from repro_torch.kernels.attention.ops import attention
    from repro_torch.kernels.matmul import kernel as mm
    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.models.model import Model
    meta = "no kernel for tensors on meta"
    q = torch.empty(4, 128, 16, device="meta")
    a = torch.empty(64, 32, device="meta")
    cfg = dataclasses.replace(CONFIG.reduced(), use_pallas=True)
    for call in (lambda: flash.flash_attention(q, q, q, block_q=32,
                                               block_k=32),
                 lambda: attention(q, q, q),
                 lambda: mm.matmul_tiled(a, a.T.contiguous()),
                 lambda: matmul(a, a.T.contiguous()),
                 lambda: Model(cfg, device="meta")(
                     torch.zeros(2, 128, dtype=torch.long, device="meta"))):
        with pytest.raises(ValueError, match=meta):
            call()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash._launch(torch.zeros(4, 64, 16), torch.zeros(4, 64, 16),
                      torch.zeros(4, 64, 16), 32, 32, True, None)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mm._launch(torch.zeros(64, 32), torch.zeros(32, 64), 32, 32, 32)


@pytest.mark.parametrize("source", ["attention.cu", "matmul.cu"])
def test_the_attention_and_matmul_sources_are_built(source):
    from repro_torch.kernels import build
    assert source in build.SOURCES
    assert os.path.exists(os.path.join(build.CSRC, source))


def test_a_dtensor_never_reaches_a_kernel():
    """A distributed step lowers the plain-op path: an entry point handed a
    DTensor raises at its kernel's wrapper, before any launch, rather than
    gathering or running on the local shard."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.kernels.scan.ops import prefix_sum
    from repro_torch.launch.mesh import fake_world, make_fake_mesh

    with fake_world(2):
        mesh = make_fake_mesh((2,), ("data",))
        x = distribute_tensor(torch.ones(4, 256), mesh, [Replicate()])
        a = distribute_tensor(torch.ones(64, 64), mesh, [Replicate()])
        with pytest.raises(TypeError, match="DTensor reached a kernel"):
            prefix_sum(x)
        with pytest.raises(TypeError, match="DTensor reached a kernel"):
            matmul(a, a)
    assert not torch.distributed.is_initialized()


def test_importing_the_port_loads_no_fake_process_group():
    """The fake world's module (torch.testing._internal.distributed) loads
    only inside the functions that build a fake world."""
    code = ("import sys, torch\n"
            "before = set(sys.modules)\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.roofline, "
            "repro_torch.launch.mesh, repro_torch.launch.inputs, "
            "repro_torch.launch.op_cost, repro_torch.launch.params, "
            "repro_torch.distributed.sharding, "
            "repro_torch.core.distributed_tuning, repro_torch.models.model\n"
            "new = sorted(m for m in set(sys.modules) - before\n"
            "             if m.startswith(('torch.testing._internal', 'jax',"
            " 'repro.')) or m == 'repro')\n"
            "assert not new, new\n"
            "assert 'torch.testing._internal.distributed.fake_pg' "
            "not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_host_mesh_asks_for_the_card_by_default(monkeypatch):
    from repro_torch.launch.mesh import make_host_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_a_real_dtensor_in_a_block_raises_at_the_kernel(family):
    """Only a step with no real data (fake tensors: the dry-run) lowers the
    SSD block's and the RG-LRU's plain references; a DTensor holding real
    data goes on to the kernel's wrapper, which refuses it."""
    import dataclasses

    from torch.distributed.tensor import (Replicate, distribute_module,
                                          distribute_tensor)

    from repro_torch.configs.base import get_arch
    from repro_torch.launch.mesh import make_host_mesh, release_world
    from repro_torch.models.recurrent import RecurrentBlock
    from repro_torch.models.ssm import SSDBlock

    arch = "mamba2-130m" if family == "ssm" else "recurrentgemma-9b"
    # use_pallas: the RG-LRU reaches its entry point on the CPU only so
    cfg = dataclasses.replace(get_arch(arch).reduced(), use_pallas=True)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    mesh = make_host_mesh(device="cpu")
    try:
        assert tuple(mesh.shape) == (1, 1)
        if family == "ssm":
            block = SSDBlock(cfg, torch.float32, device="cpu")
            run = lambda b, h: b(h, compute_dtype=torch.float32)  # noqa: E731
        else:
            block = RecurrentBlock(cfg, torch.float32, device="cpu")
            run = lambda b, h: b(h, cfg,  # noqa: E731
                                 compute_dtype=torch.float32)
        block.reset(gen)
        with torch.no_grad():
            y, _ = run(block, x)       # plain tensors: the plan's versions
            assert torch.isfinite(y).all()
            block = distribute_module(block, mesh)
            xd = distribute_tensor(x, mesh, [Replicate(), Replicate()])
            with pytest.raises(TypeError, match="DTensor reached a kernel"):
                run(block, xd)
    finally:
        release_world()
    assert not torch.distributed.is_initialized()
