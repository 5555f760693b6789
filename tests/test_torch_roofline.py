"""The port's roofline (``repro_torch.launch.roofline``) against the JAX
package's (``repro.launch.roofline``): the three terms under the
``tpu_v5e`` profile equal JAX's v5e constants, the collective multipliers
equal ``_collective_wire_bytes`` on HLO lines written with the same
shapes and group sizes, and ``analyze_cell`` on the reduced dense train
cell over a fake (4, 2) mesh counts both FSDP's all-gathers and its
gradients' reduce-scatters."""
import math
import os

import jax
import pytest
import torch

from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.hw.profiles import get_profile
from repro_torch.launch import roofline as t_roof
from repro_torch.launch.mesh import fake_world, make_fake_mesh

jax.devices()   # the backend is up before the JAX module sets XLA_FLAGS
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import roofline as j_roof  # noqa: E402

if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("counts", [(1.5e15, 2.5e11, 3.0e9, 256),
                                    (7.0e12, 1.0e9, 0.0, 512),
                                    (0.0, 0.0, 1.0, 1)])
def test_roofline_terms_under_tpu_v5e_equal_repro(counts):
    assert t_roof.roofline_terms(*counts, profile="tpu_v5e") == \
        j_roof.roofline_terms(*counts)


def test_roofline_terms_default_to_the_h100():
    terms = t_roof.roofline_terms(989e12, 3.35e12, 450e9, 1)
    assert terms == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0}
    h100 = get_profile("h100")
    assert (h100.peak_bf16_flops, h100.hbm_bandwidth,
            h100.ici_link_bandwidth) == (989e12, 3.35e12, 450e9)


_DT = {"f32": 4, "bf16": 2, "s32": 4}


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("dtype,shape", [("f32", (64, 128)),
                                         ("bf16", (16, 4, 1024)),
                                         ("s32", (8,))])
@pytest.mark.parametrize("group", [2, 4, 16])
def test_collective_multipliers_equal_repro(kind, dtype, shape, group):
    dims = ",".join(map(str, shape))
    ids = ",".join(map(str, range(group)))
    line = (f"  %c.1 = {dtype}[{dims}]{{0}} {kind}({dtype}[{dims}]{{0}} %p),"
            f" replica_groups={{{{{ids}}}}}, dimensions={{0}}")
    out_bytes = math.prod(shape) * _DT[dtype]
    got = t_roof.collective_wire_bytes(
        kind, out_bytes, group if kind != "collective-permute" else 2)
    assert got == j_roof._collective_wire_bytes(line, kind)


def test_analyze_cell_counts_fsdp_gathers_and_scatters():
    shape = ShapeConfig("train_64", 64, 4, "train")
    with fake_world(8):
        mesh = make_fake_mesh((4, 2), ("data", "model"))
        rec = t_roof.analyze_cell(
            "qwen1.5-0.5b", shape.name,
            arch_cfg=get_arch("qwen1.5-0.5b").reduced(), mesh=mesh,
            shape=shape)
    assert not torch.distributed.is_initialized()
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert rec["profile"] == "h100"
    coll = rec["collectives"]
    assert coll["count_by_kind"]["all-gather"] > 0
    assert coll["count_by_kind"]["reduce-scatter"] > 0
    assert coll["per_kind"]["reduce-scatter"] > 0
    terms = rec["roofline"]
    assert all(math.isfinite(v) and v > 0 for v in terms.values())
    assert rec["dominant"] == max(terms, key=terms.get)
    assert rec["step_time_bound_s"] == max(terms.values())
    assert 0 < rec["mfu_upper_bound"] and 0 < rec["useful_flops_ratio"]
