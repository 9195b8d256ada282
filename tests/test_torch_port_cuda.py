"""Card-only checks of the port's CUDA kernels against their plain PyTorch
versions at the flagship shapes (chip_smoke.py runs the same comparisons as
part of the main path). They need an NVIDIA GPU and nvcc, and skip without a
GPU; run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(`--noconftest`: the suite's conftest imports jax, which the card's machine
need not have.)
"""

import pytest
import torch

from sgtapose_tpu_torch.models import deform_conv
from sgtapose_tpu_torch.ops import attention_kernel, build

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,d", [(1183, 4), (343, 8), (63, 16), (100, 8), (1, 4), (33, 8), (1183, 8)])
def test_biased_attention_kernel_matches_plain(dev, n, d):
    """B = 2; n = 33, 100, 343 and 1183 give bias spans that start off a
    16-byte line."""
    g = torch.Generator(device=dev).manual_seed(n)
    q, k, v = (torch.randn(2, 8, n, d, generator=g, device=dev) for _ in range(3))
    bias = 0.1 * torch.randn(8, n, n, generator=g, device=dev)
    before = build.launch_counts()["biased_attention"]
    out = attention_kernel.fused_biased_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert build.launch_counts()["biased_attention"] == before + 1
    ref = attention_kernel.plain_biased_attention(q, k, v, bias)
    assert (out - ref).abs().max().item() <= 2e-4


@pytest.mark.parametrize("H,C", [(15, 512), (30, 256), (60, 128), (120, 64), (9, 6)])
def test_deform_sample_kernel_matches_plain(dev, H, C):
    g = torch.Generator(device=dev).manual_seed(H)
    feat = torch.randn(1, H, H, C, generator=g, device=dev)
    offsets = torch.rand(1, H, H, 18, generator=g, device=dev) * 6 - 3
    masks = torch.rand(1, H, H, 9, generator=g, device=dev)
    out = deform_conv.deform_sample(feat, offsets, masks)
    torch.cuda.synchronize()
    ref = deform_conv.plain_deform_sample(feat, offsets, masks)
    assert (out - ref).abs().max().item() <= 1e-5


def test_biased_attention_kernel_unaligned_bias_base(dev):
    """A bias view whose first float is not on a 16-byte line."""
    n, d = 343, 8
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(2, 8, n, d, generator=g, device=dev) for _ in range(3))
    store = 0.1 * torch.randn(8 * n * n + 1, generator=g, device=dev)
    bias = store[1:].view(8, n, n)
    assert bias.data_ptr() % 16 != 0
    out = attention_kernel.fused_biased_attention(q, k, v, bias)
    torch.cuda.synchronize()
    ref = attention_kernel.plain_biased_attention(q, k, v, bias)
    assert (out - ref).abs().max().item() <= 2e-4


# (H, W, C, O): the decoder's 16 nodes at 480x480 by input shape and output
# width, and one ragged shape (C % 4 != 0, O below one tile)
DCN_SHAPES = [(15, 15, 512, 256), (30, 30, 256, 256), (30, 30, 256, 128), (30, 30, 256, 64),
              (60, 60, 128, 128), (60, 60, 128, 64), (120, 120, 64, 64), (9, 11, 6, 5)]


@pytest.mark.parametrize("H,W,C,O", DCN_SHAPES)
def test_deform_conv_kernel_matches_plain(dev, H, W, C, O):
    g = torch.Generator(device=dev).manual_seed(H * W + O)
    x = torch.randn(1, H, W, C, generator=g, device=dev)
    om = torch.cat([torch.rand(1, H, W, 18, generator=g, device=dev) * 6 - 3,
                    2 * torch.randn(1, H, W, 9, generator=g, device=dev)], dim=-1)
    weight = torch.randn(O, 9 * C, generator=g, device=dev) / (9 * C) ** 0.5
    bias = torch.randn(O, generator=g, device=dev)
    before = build.launch_counts()["deform_conv"]
    out = deform_conv.deform_conv(x, om, weight, bias)
    torch.cuda.synchronize()
    assert build.launch_counts()["deform_conv"] == before + 1
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = deform_conv.plain_deform_conv(x, om, weight, bias)
    assert out.shape == (1, H, W, O)
    assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
