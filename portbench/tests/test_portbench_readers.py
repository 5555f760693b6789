"""Metric readers: the port's kernels found in its sources, not listed,
and ``ssd_roofline`` over the device time of every one of them."""
import pytest

from portbench import harness, readers

SSD = ("void (anonymous namespace)::ssd_intra_tiled_kernel<float>("
       "CUtensorMap_st, CUtensorMap_st, float const*, long long, int)")
GEMM = ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_"
        "warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas")


@pytest.mark.parametrize("name, bare", [
    (SSD, "ssd_intra_tiled_kernel"),
    (GEMM, GEMM),
    ("void at::native::elementwise_kernel<128, 4>(int, Op)",
     "elementwise_kernel"),
    ("Memcpy DtoD (Device -> Device)", "DtoD"),
])
def test_kernel_name(name, bare):
    assert readers.kernel_name(name) == bare


def test_port_kernels_come_from_the_sources():
    found = readers.port_kernels()
    for k in ("ssd_intra_tiled_kernel", "ssd_state_apply_tiled_kernel",
              "linrec_warp_kernel", "fft_pow2_kernel", "pcr_warp_kernel"):
        assert k in found
    assert readers.is_port_kernel(SSD)
    assert not readers.is_port_kernel(GEMM)


def test_a_new_kernel_is_found_without_an_edit(tmp_path):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "fused.cu").write_text(
        "template <int C>\n__global__ void __launch_bounds__(C == 16 ? 512\n"
        "    : 256, 1)\n    ssd_fused_kernel(const float* x) {}\n")
    (tmp_path / "tri.py").write_text(
        "import triton\n\n@triton.jit\ndef ssd_chunk_kernel(x_ptr):\n"
        "    pass\n")
    assert readers.port_kernels(str(tmp_path)) == {"ssd_fused_kernel",
                                                  "ssd_chunk_kernel"}


def test_ssd_roofline_counts_every_port_kernel():
    read = harness.reader("ssd_roofline")
    record = {"driver": "prefill",
              "trace_calls": [{"ssd_least_s": 0.01}, {"ssd_least_s": 0.01}],
              "trace": {"device_ops": {SSD: [24, 0.3], GEMM: [2, 1.0],
                                       "void linrec_warp_kernel<float, 4>(int)":
                                       [4, 0.1]}}}
    assert read(record) == pytest.approx(100 * 0.02 / 0.4)
    record["trace"]["device_ops"] = {GEMM: [2, 1.0]}
    assert read(record) is None
