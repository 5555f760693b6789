"""Nothing the benchmark loads is JAX or the JAX package (top-level module
names compared whole), and the references load nothing of the port."""
import ast
import os
import subprocess
import sys

import pytest

from portbench import harness

PB = os.path.join(harness.ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def sources():
    for dirpath, _, files in os.walk(PB):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    for path in sources():
        assert not set(imported_tops(path)) & FORBIDDEN, path


def test_references_import_nothing_of_the_port():
    ref = os.path.join(PB, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = set(imported_tops(os.path.join(ref, f)))
            assert not tops & (FORBIDDEN | {"repro_torch"}), f


def test_loaded_modules_in_a_fresh_process():
    """Import the harness, its drivers (and through their set-up paths the
    port's entry points and Model), every metric reader, the traffic
    generator and the references; then read sys.modules."""
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "from portbench import harness, traffic, readers, control\n"
        "from portbench.reference import prefix_ops, mamba2\n"
        "import portbench.drivers.ops, portbench.drivers.prefill\n"
        "for f in ('scan', 'tridiag', 'fft'):\n"
        "    portbench.drivers.ops._entry(f)\n"
        "from repro_torch.models.model import Model\n"
        "b = harness.Benchmark()\n"
        "for m in b.spec['end_to_end'] + b.spec['per_layer']:\n"
        "    harness.reader(m['name'])\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    ) % (os.path.join(harness.ROOT, "src"), harness.ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr
    import json
    tops = {m.split(".")[0] for m in json.loads(proc.stdout.splitlines()[-1])}
    assert "repro_torch" in tops
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("name,flagged", [("repro.kernels", True),
                                          ("jax", True), ("jaxlib.x", True),
                                          ("repro_torch.x", False),
                                          ("reprox", False)])
def test_forbidden_modules_compares_whole_names(monkeypatch, name, flagged):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name.split(".")[0] in harness.forbidden_modules()) == flagged
