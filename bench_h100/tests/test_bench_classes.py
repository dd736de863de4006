"""The kernel-name classifier on names from the port's profiler tables on
the H100 (phases 14 and 19 of chip_smoke.py, and the benchmark's traces)."""

import pytest

from bench_h100.harness.trace import classify, load_classes, reduce_events

NAMES = [
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda"
     "(at::TensorIteratorBase&)::{lambda()#3}", "norm_eltwise"),
    ("void cudnn::batchnorm_bwtr_nhwc_semiPersist<float, float, float, 512, 16, 3, 4, 1, 0, "
     "true, 2>(cudnn::NhwcBatchNormBwdParams<float, float>)", "norm_eltwise"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::"
     "native::CUDAFunctor_add<float> >", "norm_eltwise"),
    ("void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16, __nv_bfloat16, float, "
     "true, false, (cudnnKernelDataType_t)0>", "norm_eltwise"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda"
     "(at::TensorIteratorBase&)::{lambda(float)#1}", "norm_eltwise"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x256x64_"
     "warpgroupsize2x1x1_g1_execute_segment_k_off_kernel__5x_cudnn", "conv_gemm"),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc_nhwc_tilesize32x32x8_"
     "stage3_warpsize1x2x1_g1_ffma_execute_kernel__5x_cudnn", "conv_gemm"),
    ("void cudnn::detail::dgrad2d_alg1_1<float, 0, 5, 6, 4, 3, 4, false, true>(int, int, int, "
     "float const*, int, float const*", "conv_gemm"),
    ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n_tilesize32x64x8_stage3_warpsize2x2x1_ffma_"
     "aligna8_alignc8_execute_kernel__5x_cublas", "conv_gemm"),
    ("upsample_softmax_flip_kernel(__nv_bfloat16 const*, __nv_bfloat16*, int4 const*)", "stitch"),
    ("void psa_wgmma_kernel<2, false>(PsaParams)", "psa"),
    ("psa_da_tf32x3_kernel(PsaDaParams)", "psa"),
    ("psa_pack_bf16_kernel", "psa"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy"),
    ("void at::native::(anonymous namespace)::nll_loss2d_forward_kernel<float>", "other"),
]


@pytest.mark.parametrize("name,cls", NAMES)
def test_classify(name, cls):
    assert classify(name, load_classes()) == cls


def test_reduce_events_union_gaps_and_labels():
    events = [("k_conv sm90_xmma", True, 10.0, 30.0), ("elementwise_kernel", True, 20.0, 40.0),
              ("psa_wgmma_kernel", True, 60.0, 70.0), ("bench.readback", False, 35.0, 65.0),
              ("cudaMemcpyAsync", False, 45.0, 55.0)]
    t = reduce_events(events, 0.0, window_s=100e-6)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.class_s["psa"] == pytest.approx(10e-6)
    assert t.class_count == {"conv_gemm": 1, "norm_eltwise": 1, "psa": 1}
    assert [round(s * 1e6) for _, s in t.gaps] == [30, 20, 10]
    assert t.gaps[1][0] == "bench.readback / cudaMemcpyAsync"
    assert t.gaps[0][0] == "no host operation"
