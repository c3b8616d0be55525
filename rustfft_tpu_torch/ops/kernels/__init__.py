"""Hand-written CUDA kernels, one per JAX-package Pallas kernel ported so
far, each beside its plain torch version: the whole-transform kernels
(lanepack; dense: the whole DFT as one product; fused: the one-pass mid
band; large, largepad, large2f, large3: two and three passes), the
convolution cores of the prime path (conv: one pass, conv_radix: two
passes, convlarge: the fused large Bluestein) and the permutation
(permute)."""


def launch_counters():
    """The launch counter of every ported kernel's wrapper, by name: each
    wrapper adds one to its `.launches` where it launches its kernel on a
    CUDA tensor and nowhere else (the tools' own forms, the stamped kernels
    and permute_rows, are left out).  The one set that chip_smoke.py and
    tools/torch_inspect_plan.py zero before a call and read after it."""
    from . import conv, conv_radix, convlarge, dense, fused, lanepack, large, large2f, large3
    from . import largepad, permute

    return {"lanepack_pipe_fft": lanepack.lanepack_pipe_fft,
            "lanepack_chain_fft": lanepack.lanepack_chain_fft,
            "large_col_stage": large.large_col_stage,
            "large_row_stage": large.large_row_stage,
            "conv_fft": conv.conv_fft,
            "conv_chain_fft": conv.conv_chain_fft,
            "conv_col_stage": conv_radix.conv_col_stage,
            "conv_row_stage": conv_radix.conv_row_stage,
            "permute": permute.permute,
            "large2f_col_stage": large2f.large2f_col_stage,
            "large3_col_stage": large3.large3_col_stage,
            "large3_p2": large3.large3_p2,
            "radix_fft": fused.radix_fft,
            "two_stage_fft": fused.two_stage_fft,
            "two_stage_cluster_fft": fused.two_stage_cluster_fft,
            "three_stage_fft": fused.three_stage_fft,
            "dense_fft": dense.dense_fft,
            "dense_chain_fft": dense.dense_chain_fft,
            "largepad_col_stage": largepad.largepad_col_stage,
            "largepad_row_stage": largepad.largepad_row_stage,
            "bconv_row_stage": convlarge.bconv_row_stage,
            "bconv_out_stage": convlarge.bconv_out_stage,
            "bconv_col_tile": convlarge.bconv_col_tile,
            "bconv_row_tile": convlarge.bconv_row_tile,
            "bconv_out_tile": convlarge.bconv_out_tile,
            "conv_radix_pass1": conv_radix.conv_radix_pass1,
            "conv_radix_pass2": conv_radix.conv_radix_pass2,
            "conv_radix_pass1_gauss": conv_radix.conv_radix_pass1_gauss,
            "conv_radix_pass2_gauss": conv_radix.conv_radix_pass2_gauss,
            "large_col_stage_gauss": large.large_col_stage_gauss,
            "large_row_stage_gauss": large.large_row_stage_gauss,
            "conv_col_stage_gauss": conv_radix.conv_col_stage_gauss,
            "conv_row_stage_gauss": conv_radix.conv_row_stage_gauss}
