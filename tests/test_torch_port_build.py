"""The port's kernel registry: every CUDA source under
sgtapose_tpu_torch/csrc is built and bound by ops/build.py, its C entry point
is the one the binding names, and every kernel's module keeps a plain
PyTorch version beside its CUDA wrapper (the CPU path and the card's
reference)."""

import importlib
import re

import pytest

from sgtapose_tpu_torch.ops import build

# kernel -> (module, plain version, CUDA wrapper)
KERNEL_MODULES = {
    "biased_attention": ("sgtapose_tpu_torch.ops.attention_kernel", "plain_biased_attention",
                         "biased_attention_cuda"),
    "deform_sample": ("sgtapose_tpu_torch.models.deform_conv", "plain_deform_sample",
                      "deform_sample_cuda"),
    "deform_conv": ("sgtapose_tpu_torch.models.deform_conv", "plain_deform_conv",
                    "deform_conv_cuda"),
    "biased_attention_bf16": ("sgtapose_tpu_torch.ops.attention_kernel",
                              "plain_biased_attention_bf16", "biased_attention_bf16_cuda"),
    # one wrapper launches the float32 or the bf16 kernel by dtype
    "deform_conv_bf16": ("sgtapose_tpu_torch.models.deform_conv", "plain_deform_conv",
                         "deform_conv_cuda"),
    "biased_attention_bwd": ("sgtapose_tpu_torch.ops.attention_kernel",
                             "plain_biased_attention_backward", "biased_attention_bwd_cuda"),
    "deform_sample_bwd": ("sgtapose_tpu_torch.models.deform_conv", "plain_deform_sample_backward",
                          "deform_sample_bwd_cuda"),
    "deform_conv_dgrad": ("sgtapose_tpu_torch.models.deform_conv", "plain_deform_conv_dgrad",
                          "deform_conv_dgrad_cuda"),
    "biased_attention_tiled": ("sgtapose_tpu_torch.ops.attention_kernel", "plain_biased_attention",
                               "biased_attention_tiled_cuda"),
    # bf16 training's backward kernels; the DCN wrappers launch the float32
    # or the bf16 kernel by dtype
    "biased_attention_bwd_bf16": ("sgtapose_tpu_torch.ops.attention_kernel",
                                  "plain_biased_attention_backward_bf16", "biased_attention_bwd_bf16_cuda"),
    "deform_conv_dgrad_bf16": ("sgtapose_tpu_torch.models.deform_conv", "plain_deform_conv_dgrad",
                               "deform_conv_dgrad_cuda"),
    "deform_sample_bf16": ("sgtapose_tpu_torch.models.deform_conv", "plain_deform_sample",
                           "deform_sample_cuda"),
    # the row-split path has its own kernel behind the backward's wrapper;
    # the weight gradient's wrapper launches the float32 or the bf16 kernel
    "biased_attention_bwd_rows": ("sgtapose_tpu_torch.ops.attention_kernel", "rows_biased_attention_backward",
                                  "biased_attention_bwd_cuda"),
    "deform_conv_wgrad": ("sgtapose_tpu_torch.models.deform_conv", "plain_deform_conv_wgrad",
                          "deform_conv_wgrad_cuda"),
    "deform_conv_wgrad_bf16": ("sgtapose_tpu_torch.models.deform_conv", "plain_deform_conv_wgrad",
                               "deform_conv_wgrad_cuda"),
    # the no-bias instantiations (bias=None) behind the same forward
    # wrappers, and the no-bias backward's own wrapper
    "biased_attention_nobias": ("sgtapose_tpu_torch.ops.attention_kernel", "plain_biased_attention",
                                "biased_attention_cuda"),
    "biased_attention_nobias_bf16": ("sgtapose_tpu_torch.ops.attention_kernel", "plain_biased_attention_bf16",
                                     "biased_attention_bf16_cuda"),
    "biased_attention_bwd_nobias": ("sgtapose_tpu_torch.ops.attention_kernel",
                                    "plain_biased_attention_backward", "attention_bwd_nobias_cuda"),
    "biased_attention_bwd_nobias_bf16": ("sgtapose_tpu_torch.ops.attention_kernel",
                                         "plain_biased_attention_backward_bf16", "attention_bwd_nobias_cuda"),
    # the key-tiled wrapper launches the float32 or the bf16 kernel by dtype;
    # bf16 training's row-split path is behind the bf16 backward's wrapper
    "biased_attention_tiled_bf16": ("sgtapose_tpu_torch.ops.attention_kernel", "key_tiled_attention_bf16",
                                    "biased_attention_tiled_cuda"),
    "biased_attention_bwd_rows_bf16": ("sgtapose_tpu_torch.ops.attention_kernel",
                                       "rows_biased_attention_backward_bf16", "biased_attention_bwd_bf16_cuda"),
    # the yardsticks of the no-bias kernels, each behind its own wrapper
    "biased_attention_nobias_rowtile": ("sgtapose_tpu_torch.ops.attention_kernel", "plain_biased_attention",
                                        "attention_nobias_rowtile_cuda"),
    "biased_attention_nobias_rowtile_bf16": ("sgtapose_tpu_torch.ops.attention_kernel",
                                             "plain_biased_attention_bf16", "attention_nobias_rowtile_cuda"),
    "biased_attention_bwd_nobias_cluster": ("sgtapose_tpu_torch.ops.attention_kernel",
                                            "plain_biased_attention_backward", "attention_bwd_nobias_cluster_cuda"),
    "biased_attention_bwd_nobias_cluster_bf16": ("sgtapose_tpu_torch.ops.attention_kernel",
                                                 "plain_biased_attention_backward_bf16",
                                                 "attention_bwd_nobias_cluster_cuda"),
    "int8_conv": ("sgtapose_tpu_torch.ops.int8_conv", "plain_int8_conv", "int8_conv_cuda"),
    # int8 serving's site kernels: the convolution that quantizes x inside,
    # and the max|x| reduction of a dynamic scale
    "int8_conv_fused": ("sgtapose_tpu_torch.ops.int8_conv", "plain_int8_site", "int8_site_cuda"),
    "int8_absmax": ("sgtapose_tpu_torch.ops.int8_conv", "plain_int8_absmax", "int8_absmax_cuda"),
}


def test_every_source_is_registered():
    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    assert sorted(set(build.KERNEL_SOURCES.values())) == sources
    assert set(build._SIGNATURES) == set(build.KERNEL_SOURCES) == set(build.launch_counts())


@pytest.mark.parametrize("name", sorted(build.KERNEL_SOURCES))
def test_entry_point_matches_source(name):
    src = (build.CSRC / build.KERNEL_SOURCES[name]).read_text()
    fn_name, argtypes = build._SIGNATURES[name]
    entry_points = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert fn_name in entry_points
    assert len(entry_points[fn_name].split(",")) == len(argtypes)


@pytest.mark.parametrize("name", sorted(build.KERNEL_SOURCES))
def test_every_kernel_has_its_plain_version(name):
    module, plain, wrapper = KERNEL_MODULES[name]
    mod = importlib.import_module(module)
    assert callable(getattr(mod, plain)) and callable(getattr(mod, wrapper))
    names = {getattr(mod, a, None)
             for a in ("KERNEL", "KERNEL_BF16", "KERNEL_TILED", "CONV_KERNEL", "CONV_KERNEL_BF16", "BWD_KERNEL",
                      "DGRAD_KERNEL", "BWD_KERNEL_BF16", "DGRAD_KERNEL_BF16", "BWD_KERNEL_ROWS", "WGRAD_KERNEL",
                      "WGRAD_KERNEL_BF16", "KERNEL_NOBIAS", "KERNEL_NOBIAS_BF16", "BWD_KERNEL_NOBIAS",
                      "BWD_KERNEL_NOBIAS_BF16", "KERNEL_TILED_BF16", "BWD_KERNEL_ROWS_BF16",
                      "KERNEL_NOBIAS_ROWTILE", "KERNEL_NOBIAS_ROWTILE_BF16", "BWD_KERNEL_NOBIAS_CLUSTER",
                      "BWD_KERNEL_NOBIAS_CLUSTER_BF16", "KERNEL_FUSED", "KERNEL_ABSMAX")}
    assert name in names
