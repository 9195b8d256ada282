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


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("H,W,C,O", DCN_SHAPES)
def test_deform_conv_kernel_matches_plain(dev, H, W, C, O, B):
    """B = 2: the second image's corners are read from its own map."""
    g = torch.Generator(device=dev).manual_seed(H * W + O + B)
    x = torch.randn(B, H, W, C, generator=g, device=dev)
    om = torch.cat([torch.rand(B, H, W, 18, generator=g, device=dev) * 6 - 3,
                    2 * torch.randn(B, H, W, 9, generator=g, device=dev)], dim=-1)
    weight = torch.randn(O, 9 * C, generator=g, device=dev) / (9 * C) ** 0.5
    bias = torch.randn(O, generator=g, device=dev)
    before = build.launch_counts()["deform_conv"]
    out = deform_conv.deform_conv(x, om, weight, bias)
    torch.cuda.synchronize()
    assert build.launch_counts()["deform_conv"] == before + 1
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = deform_conv.plain_deform_conv(x, om, weight, bias)
    assert out.shape == (B, H, W, O)
    assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())


# bf16 serving: the kernels hold against their plain bf16 versions. Both sides
# compute in float32 from the same bf16 inputs; a bf16 rounding (of the q.k
# logit, of a sampled DCN element, of a DCN output) may land on the other side
# of a rounding boundary when the float32 sums are taken in another order, so
# the bars allow a few bf16 units in the last place (2^-8 relative).
ATTN_BF16_ATOL = 1e-3
DCN_BF16_REL = 8e-3  # of max(1, max|ref|): two bf16 ulps at the top of the range


@pytest.mark.parametrize("q_bf16", [True, False], ids=["q_bf16", "q_f32"])
@pytest.mark.parametrize("n,d,B", [(1183, 4, 2), (343, 8, 2), (63, 16, 2), (100, 8, 2), (1, 4, 2),
                                   (33, 8, 2), (1183, 4, 8), (343, 8, 8), (63, 16, 8)])
def test_biased_attention_bf16_kernel_matches_plain(dev, n, d, B, q_bf16):
    """B = 2, and B = 8 at the flagship shapes (the batched runner's fuse
    over 8 videos); the first tied layer's q is bf16, the later layers'
    float32."""
    g = torch.Generator(device=dev).manual_seed(n + d + B)
    q, k, v = (torch.randn(B, 8, n, d, generator=g, device=dev) for _ in range(3))
    bias = (0.1 * torch.randn(8, n, n, generator=g, device=dev)).to(torch.bfloat16)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    if q_bf16:
        q = q.to(torch.bfloat16)
    before = build.launch_counts()["biased_attention_bf16"]
    out = attention_kernel.fused_biased_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert build.launch_counts()["biased_attention_bf16"] == before + 1
    assert out.dtype == torch.float32
    ref = attention_kernel.plain_biased_attention_bf16(q, k, v, bias)
    assert (out - ref).abs().max().item() <= ATTN_BF16_ATOL


def test_biased_attention_bf16_kernel_unaligned_bias_base(dev):
    """A bf16 bias view whose first element is 2 bytes into a 16-byte line."""
    n, d = 343, 8
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn(2, 8, n, d, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    store = (0.1 * torch.randn(8 * n * n + 1, generator=g, device=dev)).to(torch.bfloat16)
    bias = store[1:].view(8, n, n)
    assert bias.data_ptr() % 16 != 0
    out = attention_kernel.fused_biased_attention(q, k, v, bias)
    torch.cuda.synchronize()
    ref = attention_kernel.plain_biased_attention_bf16(q, k, v, bias)
    assert (out - ref).abs().max().item() <= ATTN_BF16_ATOL


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("H,W,C,O", DCN_SHAPES)
def test_deform_conv_bf16_kernel_matches_plain(dev, H, W, C, O, B):
    """B = 2: the second image's corners are read from its own map (the
    batched runner's fuse runs the decoder over a batch of videos)."""
    g = torch.Generator(device=dev).manual_seed(H * W + O + 1 + B)
    bf16 = torch.bfloat16
    x = torch.randn(B, H, W, C, generator=g, device=dev).to(bf16)
    om = torch.cat([torch.rand(B, H, W, 18, generator=g, device=dev) * 6 - 3,
                    2 * torch.randn(B, H, W, 9, generator=g, device=dev)], dim=-1).to(bf16)
    weight = (torch.randn(O, 9 * C, generator=g, device=dev) / (9 * C) ** 0.5).to(bf16)
    bias = torch.randn(O, generator=g, device=dev).to(bf16)
    before = build.launch_counts()["deform_conv_bf16"]
    out = deform_conv.deform_conv(x, om, weight, bias)
    torch.cuda.synchronize()
    assert build.launch_counts()["deform_conv_bf16"] == before + 1
    ref = deform_conv.plain_deform_conv(x, om, weight, bias)
    assert out.shape == (B, H, W, O) and out.dtype == bf16
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= DCN_BF16_REL * max(1.0, ref.float().abs().max().item())


def test_deform_conv_bf16_kernel_unaligned_base(dev):
    """x and weight starting 2 bytes into a 16-byte line take the scalar-load
    variant."""
    H, W, C, O = 30, 30, 64, 64
    g = torch.Generator(device=dev).manual_seed(11)
    bf16 = torch.bfloat16
    xs = torch.randn(H * W * C + 1, generator=g, device=dev).to(bf16)
    x = xs[1:].view(1, H, W, C)
    om = torch.cat([torch.rand(1, H, W, 18, generator=g, device=dev) * 6 - 3,
                    2 * torch.randn(1, H, W, 9, generator=g, device=dev)], dim=-1).to(bf16)
    ws = (torch.randn(O * 9 * C + 1, generator=g, device=dev) / (9 * C) ** 0.5).to(bf16)
    weight = ws[1:].view(O, 9 * C)
    bias = torch.randn(O, generator=g, device=dev).to(bf16)
    assert x.data_ptr() % 16 != 0 and weight.data_ptr() % 16 != 0
    out = deform_conv.deform_conv(x, om, weight, bias)
    torch.cuda.synchronize()
    ref = deform_conv.plain_deform_conv(x, om, weight, bias)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= DCN_BF16_REL * max(1.0, ref.float().abs().max().item())


def test_kernels_refuse_other_dtypes(dev):
    x = torch.randn(1, 9, 9, 8, device=dev, dtype=torch.float16)
    om = torch.zeros(1, 9, 9, 27, device=dev, dtype=torch.float16)
    w = torch.zeros(8, 72, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        deform_conv.deform_conv(x, om, w, torch.zeros(8, device=dev, dtype=torch.float16))
    q = torch.randn(1, 8, 63, 16, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        attention_kernel.fused_biased_attention(q, q, q, torch.zeros(8, 63, 63, device=dev,
                                                                     dtype=torch.float16))
