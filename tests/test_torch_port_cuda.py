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


@pytest.mark.parametrize("n,d", [(1183, 4), (343, 8), (63, 16), (100, 8)])
def test_biased_attention_kernel_matches_plain(dev, n, d):
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
