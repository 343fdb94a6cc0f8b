"""The trace arithmetic on a synthetic Chrome trace: busy time is the union
of kernels, copies and memsets, GPU user annotations do not count, and each
idle gap is labelled with the host operation it falls in."""
import pytest

from benchmark import trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev("aten::conv", "cpu_op", 0.0, 40.0),
    ev("cudaLaunchKernel", "cuda_runtime", 1.0, 2.0),
    ev("aten::item", "cpu_op", 40.0, 60.0),
    ev("cudaStreamSynchronize", "cuda_runtime", 41.0, 58.0),
    # an annotation spanning everything: not device work
    ev("Optimizer.step#AdamW.step", "gpu_user_annotation", 0.0, 100.0),
    ev("void conv3x3_igemm::hopper::conv3x3_wgmma<64, 128, true>(bf16 const*)", "kernel",
       10.0, 20.0),
    # overlaps the first kernel by 5 us
    ev("void at::native::vectorized_elementwise_kernel<4, float>(int)", "kernel", 25.0, 10.0),
    ev("sm90_xmma_wgrad_implicit_gemm_bf16", "kernel", 50.0, 10.0),
    ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 62.0, 4.0),
    ev("void moments_kernel<__nv_bfloat16, 8, true>(float*)", "kernel", 66.0, 2.0),
]


def test_busy_is_the_union_and_annotations_are_left_out():
    s = trace.summarize(EVENTS, window_s=100e-6)
    # [10, 35) + [50, 60) + [62, 68)
    assert s.busy_s == pytest.approx(41e-6)
    assert s.n_device_ops == 5
    assert s.group_s["conv"] == pytest.approx(20e-6)
    assert s.group_s["elementwise"] == pytest.approx(10e-6)
    assert s.group_s["library"] == pytest.approx(10e-6)
    assert s.group_s["memcpy"] == pytest.approx(4e-6)
    assert s.group_s["moments"] == pytest.approx(2e-6)
    assert "other" not in s.group_s


def test_idle_gaps_by_host_label():
    s = trace.summarize(EVENTS, window_s=100e-6)
    # [35, 50): the host in aten::item's synchronize; [60, 62) under 10 us;
    # the window's ends [0, 10) and [68, 100)
    assert s.idle_s["aten::item / cudaStreamSynchronize"] == pytest.approx(15e-6 + 32e-6)
    assert s.idle_s[f"gaps under {trace.SHORT_GAP_US:g} us"] == pytest.approx(2e-6)
    assert s.idle_s["aten::conv"] == pytest.approx(10e-6)
    assert sum(s.idle_s.values()) + s.busy_s == pytest.approx(100e-6)
    b = s.breakdown()
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["device_ops"][0] == ["conv3x3_igemm::hopper::conv3x3_wgmma<64, 128, true>",
                                  pytest.approx(20e-6)]


@pytest.mark.parametrize("name,group", [
    ("void conv3x3_igemm::hopper::conv3x3_wgmma<64, 64, false>(x)", "conv"),
    ("void conv3x3_stem::stem_kernel<1, true>(x)", "conv"),
    ("void conv3x3_tf32x3<64, true>(x)", "conv"),
    ("void at::native::reduce_kernel<128, 4>(x)", "elementwise"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<x>(y)", "elementwise"),
    ("void at::native::multi_tensor_apply_kernel<x>(y)", "elementwise"),
    ("implicit_convolveNd_sgemm<__nv_bfloat16, 3>", "library"),
    ("cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm>", "library"),
    ("nvjet_tst_32x512_64x3_1x2_h_ssched_bz_TNN", "library"),
    ("some_new_kernel", "other"),
])
def test_kernel_groups(name, group):
    assert trace.kernel_group(name) == group


def test_union_of_nested_and_disjoint_intervals():
    total, merged = trace.union_us([(0, 10), (2, 3), (10, 12), (20, 25), (21, 30)])
    assert total == 22 and merged == [(0, 12), (20, 30)]
