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


@pytest.mark.parametrize("n,d,B", [(7098, 4, 1), (2058, 8, 1), (2058, 8, 2), (3000, 16, 1), (100, 8, 2),
                                   (1, 4, 1), (33, 32, 2)])
def test_biased_attention_tiled_kernel_matches_plain(dev, n, d, B):
    """The key-tiled kernel at a 42-keypoint model's levels 0 and 1 and at
    ragged n; the autograd Function routes n beyond the shared-memory kernel
    to it. A bias of scale 3 makes a lane's max grow from chunk to chunk."""
    g = torch.Generator(device=dev).manual_seed(n + d)
    q, k, v = (torch.randn(B, 8, n, d, generator=g, device=dev) for _ in range(3))
    bias = 3.0 * torch.randn(8, n, n, generator=g, device=dev)
    before = build.launch_counts()
    out = attention_kernel.biased_attention_tiled_cuda(q, k, v, bias)
    torch.cuda.synchronize()
    ref = attention_kernel.plain_biased_attention(q, k, v, bias)
    assert (out - ref).abs().max().item() <= 2e-4
    routed = attention_kernel.fused_biased_attention(q, k, v, bias)
    tiled = not attention_kernel.fits_smem(n, d)
    after = build.launch_counts()
    assert after["biased_attention_tiled"] == before["biased_attention_tiled"] + 1 + tiled
    assert after["biased_attention"] == before["biased_attention"] + (not tiled)
    assert (routed - ref).abs().max().item() <= 2e-4


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
# the concat baseline's decoder (SGTAPoseCat, every width doubled) at 480x480
CAT_DCN_SHAPES = [(15, 15, 1024, 512), (30, 30, 512, 512), (30, 30, 512, 256), (30, 30, 512, 128),
                  (60, 60, 256, 256), (60, 60, 256, 128), (120, 120, 128, 128)]
DCN_SHAPES = [(15, 15, 512, 256), (30, 30, 256, 256), (30, 30, 256, 128), (30, 30, 256, 64),
              (60, 60, 128, 128), (60, 60, 128, 64), (120, 120, 64, 64), (9, 11, 6, 5)] + CAT_DCN_SHAPES


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


@pytest.mark.parametrize("q_bf16", [True, False], ids=["q_bf16", "q_f32"])
@pytest.mark.parametrize("n,d,B", [(7098, 4, 1), (7098, 4, 2), (2058, 8, 1), (100, 8, 2), (1, 4, 1),
                                   (33, 32, 2)])
def test_biased_attention_tiled_bf16_kernel_matches_plain(dev, n, d, B, q_bf16):
    """The bf16 key-tiled kernel at a 42-keypoint model's level 0 (which the
    autograd Function routes to it) and at level 1 and ragged n (which fit
    the bf16 shared-memory kernel); a bias of scale 3 makes a lane's max
    grow from chunk to chunk."""
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(n + d + B + 1)
    q = torch.randn(B, 8, n, d, generator=g, device=dev).to(bf if q_bf16 else torch.float32)
    k, v = (torch.randn(B, 8, n, d, generator=g, device=dev).to(bf) for _ in range(2))
    bias = (3.0 * torch.randn(8, n, n, generator=g, device=dev)).to(bf)
    before = build.launch_counts()
    out = attention_kernel.biased_attention_tiled_cuda(q, k, v, bias)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    ref = attention_kernel.plain_biased_attention_bf16(q, k, v, bias)
    assert (out - ref).abs().max().item() <= ATTN_BF16_ATOL
    routed = attention_kernel.fused_biased_attention(q, k, v, bias)
    tiled = not attention_kernel.fits_smem(n, d, 2)
    after = build.launch_counts()
    assert after["biased_attention_tiled_bf16"] == before["biased_attention_tiled_bf16"] + 1 + tiled
    assert after["biased_attention_bf16"] == before["biased_attention_bf16"] + (not tiled)
    assert after["biased_attention_tiled"] == before["biased_attention_tiled"]
    assert (routed - ref).abs().max().item() <= ATTN_BF16_ATOL


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


# Backward kernels (float32 training) against their plain versions. The
# attention backward recomputes the probabilities with the fast exp2 and sums
# in another order: within 1e-4 of max(1, max|ref|) per gradient. The DCN
# backward kernels add into the feature gradient with float atomics (an order
# that changes from run to run), the data gradient after a 3xTF32 product:
# within 1e-4 of max(1, max|ref|).
BWD_REL = 1e-4


def _rel_err(a, b):
    return (a - b).abs().max().item() / max(1.0, b.abs().max().item())


@pytest.mark.parametrize("n,d,B", [(1183, 4, 8), (343, 8, 8), (63, 16, 8), (100, 8, 2), (33, 8, 2),
                                   (1, 4, 2), (63, 16, 1), (63, 16, 9), (100, 8, 8), (378, 16, 2),
                                   (378, 16, 8), (200, 8, 3), (384, 16, 1)])
def test_biased_attention_bwd_kernel_matches_plain(dev, n, d, B):
    """The flagship shapes at the training batch of 8, and ragged n; n <= 100
    takes the cluster path (B = 9: a rank sums two batch elements); (378,
    16) is a 42-keypoint model's level 2 at the --depth training batch (the
    row-split path, its own kernel and launch count), as are (343, 8), the
    ragged (200, 8) and (384, 16), the row-split path's largest n at d = 16;
    (1183, 4) takes the two passes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(n * d + B)
    q, k, v, dout = (torch.randn(B, 8, n, d, generator=g, device=dev) for _ in range(4))
    bias = 0.3 * torch.randn(8, n, n, generator=g, device=dev)
    out = attention_kernel.plain_biased_attention(q, k, v, bias)
    name = "biased_attention_bwd_rows" if attention_kernel.bwd_path(n, d) == "rows" else "biased_attention_bwd"
    before = build.launch_counts()[name]
    got = attention_kernel.biased_attention_bwd_cuda(q, k, v, bias, out, dout)
    torch.cuda.synchronize()
    assert build.launch_counts()[name] == before + 1
    ref = attention_kernel.plain_biased_attention_backward(q, k, v, bias, out, dout)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert a.shape == b.shape, name
        assert _rel_err(a, b) <= BWD_REL, (name, _rel_err(a, b))
    again = attention_kernel.biased_attention_bwd_cuda(q, k, v, bias, out, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: reproducible


def test_row_split_attention_bwd_yardstick_matches_plain(dev):
    """A 42-keypoint level 2 through the two-pass path, the row-split
    path's yardstick, and through the row-split path: both hold against the
    plain version, each under its own launch count."""
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v, dout = (torch.randn(2, 8, 378, 16, generator=g, device=dev) for _ in range(4))
    bias = 0.3 * torch.randn(8, 378, 378, generator=g, device=dev)
    out = attention_kernel.plain_biased_attention(q, k, v, bias)
    ref = attention_kernel.plain_biased_attention_backward(q, k, v, bias, out, dout)
    for path, name in (("two_pass", "biased_attention_bwd"), ("rows", "biased_attention_bwd_rows")):
        before = build.launch_counts()
        got = attention_kernel.biased_attention_bwd_cuda(q, k, v, bias, out, dout, path=path)
        torch.cuda.synchronize()
        after = build.launch_counts()
        assert {kn: after[kn] - before[kn] for kn in after if after[kn] != before[kn]} == {name: 1}
        for a, b in zip(got, ref):
            assert _rel_err(a, b) <= BWD_REL, (path, _rel_err(a, b))
    with pytest.raises(ValueError, match="path"):
        attention_kernel.biased_attention_bwd_cuda(q, k, v, bias, out, dout, path="cluster")


@pytest.mark.parametrize("H,W,C", [(15, 15, 512), (30, 30, 256), (60, 60, 128), (120, 120, 64), (9, 11, 6)])
def test_deform_sample_bwd_kernel_matches_plain(dev, H, W, C):
    """The decoder's input shapes at the training batch of 8, and a ragged
    one; offsets reach 3 px, so samples leave the map."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B = 8 if C > 6 else 2
    g = torch.Generator(device=dev).manual_seed(H * C)
    feat = torch.randn(B, H, W, C, generator=g, device=dev)
    offsets = torch.rand(B, H, W, 18, generator=g, device=dev) * 6 - 3
    masks = torch.rand(B, H, W, 9, generator=g, device=dev)
    grad = torch.randn(B, H, W, 9 * C, generator=g, device=dev)
    before = build.launch_counts()["deform_sample_bwd"]
    dfeat, dom = deform_conv.deform_sample_bwd_cuda(feat, offsets, masks, grad)
    torch.cuda.synchronize()
    assert build.launch_counts()["deform_sample_bwd"] == before + 1
    rf, roff, rmask = deform_conv.plain_deform_sample_backward(feat, offsets, masks, grad)
    assert _rel_err(dfeat, rf) <= BWD_REL
    assert _rel_err(dom[..., :18], roff) <= BWD_REL
    assert _rel_err(dom[..., 18:], rmask * masks * (1 - masks)) <= BWD_REL


def test_training_gradients_reach_every_parameter_on_the_card(dev):
    """A DCN module and an attention layer (dropout off) on the card: outputs
    carry a grad_fn, and every parameter gets a non-zero gradient equal to
    the CPU's (plain versions), within 1e-4 of max(1, max|cpu grad|)."""
    import copy

    from sgtapose_tpu_torch.models.attention import TransformerEncoderLayer, set_dropout_rate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)
    dcn = deform_conv.DeformConv2d(16, 24)
    layer = TransformerEncoderLayer(16, 4, 63, n_heads=8)
    set_dropout_rate(layer, 0.0)
    with torch.no_grad():
        for p in list(dcn.parameters()) + list(layer.parameters()):
            p.add_(0.3 * torch.randn(p.shape, generator=gen))
    x = torch.randn(2, 16, 12, 12, generator=gen)
    tokens = [torch.randn(2, 63, 16, generator=gen) for _ in range(2)]
    for mod, args in ((dcn, (x,)), (layer, (tokens[0], tokens[1], tokens[1]))):
        mod_gpu = copy.deepcopy(mod).to(dev).train()
        mod.train()
        out_cpu = mod(*args)
        before = build.launch_counts()
        out_gpu = mod_gpu(*[a.to(dev) for a in args])
        assert out_gpu.grad_fn is not None
        w = torch.randn(out_cpu.shape, generator=gen)
        (out_cpu * w).sum().backward()
        (out_gpu * w.to(dev)).sum().backward()
        torch.cuda.synchronize()
        after = build.launch_counts()
        for bwd in (("deform_conv_dgrad", "deform_conv_wgrad") if mod is dcn else ("biased_attention_bwd",)):
            assert after[bwd] == before[bwd] + 1
        assert after["deform_sample"] == before["deform_sample"]
        for (name, p), q in zip(mod.named_parameters(), mod_gpu.parameters()):
            assert q.grad is not None and q.grad.abs().max().item() > 0, name
            assert _rel_err(q.grad.cpu(), p.grad) <= BWD_REL, (name, _rel_err(q.grad.cpu(), p.grad))


# (B, H, W, C, O, offset span): the decoder's nodes at the training batch of
# 8 (15x15 splits its channel chunks over a cluster), a ragged shape (C and O
# not multiples of 4: the scalar-load variant), zero offsets (flax's init)
# and offsets beyond the kernel's halo tile
DGRAD_SHAPES = [(8, 15, 15, 512, 256, 3.0), (8, 30, 30, 256, 128, 3.0), (8, 60, 60, 128, 64, 3.0),
                (8, 120, 120, 64, 64, 3.0), (2, 9, 11, 6, 5, 3.0), (2, 30, 30, 64, 64, 0.0),
                (2, 30, 30, 64, 64, 12.0), (1, 17, 23, 20, 36, 5.0)]
DGRAD_SHAPES += [(8, H, W, C, O, 3.0) for H, W, C, O in CAT_DCN_SHAPES]


@pytest.mark.parametrize("B,H,W,C,O,span", DGRAD_SHAPES)
def test_deform_conv_dgrad_kernel_matches_plain(dev, B, H, W, C, O, span):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(H * C + O)
    x = torch.randn(B, H, W, C, generator=g, device=dev)
    om = torch.cat([(torch.rand(B, H, W, 18, generator=g, device=dev) * 2 - 1) * span,
                    2 * torch.randn(B, H, W, 9, generator=g, device=dev)], dim=-1)
    weight = torch.randn(O, 9 * C, generator=g, device=dev) / (9 * C) ** 0.5
    dy = torch.randn(B, H, W, O, generator=g, device=dev)
    before = build.launch_counts()["deform_conv_dgrad"]
    dx, dom = deform_conv.deform_conv_dgrad_cuda(x, om, weight, dy)
    torch.cuda.synchronize()
    assert build.launch_counts()["deform_conv_dgrad"] == before + 1
    rdx, rdom = deform_conv.plain_deform_conv_dgrad(x, om, weight, dy)
    assert _rel_err(dx, rdx) <= BWD_REL, _rel_err(dx, rdx)
    assert _rel_err(dom, rdom) <= BWD_REL, _rel_err(dom, rdom)
    _, again = deform_conv.deform_conv_dgrad_cuda(x, om, weight, dy)
    assert torch.equal(dom, again)  # dom has no atomics: reproducible


def test_infer_cli_on_the_card_matches_the_cpu(dev, tmp_path):
    """`cli.infer.main` with --device cuda against --device cpu at the tiny
    config (64x64, 3x3 windows), on 2 synthetic videos of 2 frames written by
    the port's writer, weights seeded with the hm bias at 0 so the heatmaps
    sit mid-range and some peaks decode: the kernels launch once per frame
    and layer on the card and never on the CPU; frame 0 of each video (frame
    1's prior PnP on random-weight detections is the degenerate EPnP case)
    has debug heatmap blends within 2 uint8 levels, the same sentinel
    pattern and keypoints within 0.05 px."""
    import json
    import os

    import numpy as np
    from PIL import Image

    from sgtapose_tpu_torch.cli import infer
    from sgtapose_tpu_torch.data import synthetic
    from sgtapose_tpu_torch.infer.detector import KP_SENTINEL
    from sgtapose_tpu_torch.train import trainer

    synthetic.write_synthetic_dataset(str(tmp_path / "syn"), n_videos=2, n_frames=2, seed=2)
    argv = ["--dataset", str(tmp_path / "syn"), "--input_res", "64", "--kernel_list", "3,3,3,1,1,1",
            "--track", "--debug", "1"]
    state = trainer.create_train_state(infer.make_config(infer.parse_args(argv)), 0, device="cpu")
    with torch.no_grad():
        state.model.hm.Conv_1.bias.zero_()
    trainer.save_checkpoint(str(tmp_path / "m.pt"), state)
    det = {}
    for device in ("cuda", "cpu"):
        build.reset_launch_counts()
        out = str(tmp_path / device)
        infer.main(argv + ["--ckpt", str(tmp_path / "m.pt"), "--output_dir", out, "--device", device])
        torch.cuda.synchronize()
        counts = {k: v for k, v in build.launch_counts().items() if v}
        expect = {"biased_attention": 9 * 4, "deform_conv": 16 * 4} if device == "cuda" else {}
        assert counts == expect, (device, counts)
        with open(f"{out}/dt_and_gt.json") as f:
            det[device] = np.asarray(json.load(f)["detections"])[[0, 2]]
    names = sorted(os.listdir(tmp_path / "cpu" / "debug"))
    assert names == sorted(os.listdir(tmp_path / "cuda" / "debug")) and len(names) == 4 * 3
    for name in names:  # {video}_{frame}_{kind}.png: frame 0's heatmap blends
        if not name.endswith("_generic.png") and name.split("_")[1] == "0000":
            a, b = (np.asarray(Image.open(tmp_path / d / "debug" / name)).astype(np.int16)
                    for d in ("cuda", "cpu"))
            assert np.abs(a - b).max() <= 2, name
    va, vb = (det["cuda"] > KP_SENTINEL).all(-1), (det["cpu"] > KP_SENTINEL).all(-1)
    assert (va == vb).all() and va.any(), (det["cuda"], det["cpu"])
    assert np.abs(det["cuda"][va] - det["cpu"][vb]).max() <= 0.05, (det["cuda"], det["cpu"])


# bf16 training's backward kernels against their plain bf16 versions: both
# compute in float32 from the same bf16 inputs and round each output once,
# but a rounding (of a q.k logit or its cotangent, of an output) can fall on
# the other side of a bf16 boundary when float32 sums run in another order:
# within two bf16 units in the last place at the top of the range,
# 2^-6 of max(1, max|ref|) per output.
BWD_BF16_REL = 2.0 ** -6
# The bf16 row-split backward (kernel B) rounds each output once, like its
# plain version in the rows order: one bf16 unit in the last place of an
# output, at most 2^-7 of its magnitude, per output 2^-7 of max|ref| (no
# floor of 1: these gradients lie well below 1).
ROWS_BWD_BF16_REL = 2.0 ** -7


def _rel_err_of_max(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


@pytest.mark.parametrize("q_bf16", [True, False], ids=["q_bf16", "q_f32"])
@pytest.mark.parametrize("n,d,B", [(63, 16, 8), (100, 8, 8), (63, 16, 1), (63, 16, 9), (33, 8, 2), (1, 4, 2)])
def test_biased_attention_bwd_bf16_kernel_matches_plain(dev, n, d, B, q_bf16):
    """The flagship's level 2 at the training batch of 8 (the only level
    whose backward training runs), ragged n on the cluster path; every output
    the same bit for bit in two runs."""
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(n * d + B + 7)
    q = torch.randn(B, 8, n, d, generator=g, device=dev).to(bf if q_bf16 else torch.float32)
    k, v = (torch.randn(B, 8, n, d, generator=g, device=dev).to(bf) for _ in range(2))
    bias = (0.3 * torch.randn(8, n, n, generator=g, device=dev)).to(bf)
    dout = torch.randn(B, 8, n, d, generator=g, device=dev)
    out = attention_kernel.plain_biased_attention_bf16(q, k, v, bias)
    before = build.launch_counts()["biased_attention_bwd_bf16"]
    got = attention_kernel.biased_attention_bwd_bf16_cuda(q, k, v, bias, out, dout)
    torch.cuda.synchronize()
    assert build.launch_counts()["biased_attention_bwd_bf16"] == before + 1
    ref = attention_kernel.plain_biased_attention_backward_bf16(q, k, v, bias, out, dout)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel_err(a.float(), b.float()) <= BWD_BF16_REL, (name, _rel_err(a.float(), b.float()))
    again = attention_kernel.biased_attention_bwd_bf16_cuda(q, k, v, bias, out, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # autograd routes a bf16 backward to the kernel
    qs = q.detach().clone().requires_grad_()
    attention_kernel.fused_biased_attention(qs, k, v, bias).backward(dout)
    assert build.launch_counts()["biased_attention_bwd_bf16"] == before + 3


@pytest.mark.parametrize("q_bf16", [True, False], ids=["q_bf16", "q_f32"])
@pytest.mark.parametrize("n,d,B", [(378, 16, 1), (378, 16, 2), (378, 16, 8), (200, 8, 3), (343, 8, 2)])
def test_biased_attention_bwd_rows_bf16_kernel_matches_plain(dev, n, d, B, q_bf16):
    """bf16 training's row-split path at a 42-keypoint model's level 2
    (--bf16 --depth at batch 2, and 1 and 8) and ragged n, against its plain
    version in the rows order; every output the same bit for bit in two
    runs; autograd routes a bf16 backward at these (n, d) to it."""
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(n * d + B + 11)
    q = torch.randn(B, 8, n, d, generator=g, device=dev).to(bf if q_bf16 else torch.float32)
    k, v = (torch.randn(B, 8, n, d, generator=g, device=dev).to(bf) for _ in range(2))
    bias = (0.3 * torch.randn(8, n, n, generator=g, device=dev)).to(bf)
    dout = torch.randn(B, 8, n, d, generator=g, device=dev)
    out = attention_kernel.plain_biased_attention_bf16(q, k, v, bias)
    before = build.launch_counts()
    got = attention_kernel.biased_attention_bwd_bf16_cuda(q, k, v, bias, out, dout)
    torch.cuda.synchronize()
    ref = attention_kernel.rows_biased_attention_backward_bf16(q, k, v, bias, out, dout)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        err = _rel_err_of_max(a.float(), b.float())
        assert err <= ROWS_BWD_BF16_REL, (name, err)
    again = attention_kernel.biased_attention_bwd_bf16_cuda(q, k, v, bias, out, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    qs = q.detach().clone().requires_grad_()
    attention_kernel.fused_biased_attention(qs, k, v, bias).backward(dout)
    after = build.launch_counts()
    assert after["biased_attention_bwd_rows_bf16"] == before["biased_attention_bwd_rows_bf16"] + 3
    assert after["biased_attention_bwd_bf16"] == before["biased_attention_bwd_bf16"]


def test_biased_attention_bwd_bf16_raises_beyond_the_cluster_path(dev):
    """Beyond the cluster and row-split paths (a 42-keypoint model's levels
    0 and 1, which feed no head, and the flagship's level 0) the two-pass
    path is float32 only: the bf16 backward raises there."""
    bf = torch.bfloat16
    q, k, v = (torch.randn(1, 8, 1183, 4, device=dev).to(bf) for _ in range(3))
    bias = torch.zeros(8, 1183, 1183, device=dev, dtype=bf)
    out = torch.zeros(1, 8, 1183, 4, device=dev)
    with pytest.raises(NotImplementedError, match="row-split"):
        attention_kernel.biased_attention_bwd_bf16_cuda(q, k, v, bias, out, out)


@pytest.mark.parametrize("H,W,C,B", [(15, 15, 512, 8), (30, 30, 256, 8), (60, 60, 128, 8), (120, 120, 64, 8),
                                     (9, 11, 6, 2)])
def test_deform_sample_bf16_kernel_matches_plain(dev, H, W, C, B):
    """The decoder's input shapes at the training batch of 8 and a ragged
    one (the scalar variant); offsets reach 3 px; the same bit for bit in
    two runs."""
    g = torch.Generator(device=dev).manual_seed(H * C + 1)
    feat = torch.randn(B, H, W, C, generator=g, device=dev).to(torch.bfloat16)
    offsets = torch.rand(B, H, W, 18, generator=g, device=dev) * 6 - 3
    masks = torch.rand(B, H, W, 9, generator=g, device=dev)
    before = build.launch_counts()["deform_sample_bf16"]
    out = deform_conv.deform_sample(feat, offsets, masks)
    torch.cuda.synchronize()
    assert build.launch_counts()["deform_sample_bf16"] == before + 1
    ref = deform_conv.plain_deform_sample(feat, offsets, masks)
    assert out.dtype == ref.dtype == torch.bfloat16
    assert _rel_err(out.float(), ref.float()) <= DCN_BF16_REL
    assert torch.equal(out, deform_conv.deform_sample(feat, offsets, masks))


@pytest.mark.parametrize("B,H,W,C,O,span", DGRAD_SHAPES)
def test_deform_conv_dgrad_bf16_kernel_matches_plain(dev, B, H, W, C, O, span):
    """The bf16 data gradient at the float32 kernel's shapes (O = 5 and 36:
    not whole 8-output chunks, the scalar-load variant); dom the same bit for
    bit in two runs (dx is added with float atomics before its rounding)."""
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(H * C + O + 3)
    x = torch.randn(B, H, W, C, generator=g, device=dev).to(bf)
    om = torch.cat([(torch.rand(B, H, W, 18, generator=g, device=dev) * 2 - 1) * span,
                    2 * torch.randn(B, H, W, 9, generator=g, device=dev)], dim=-1).to(bf)
    weight = (torch.randn(O, 9 * C, generator=g, device=dev) / (9 * C) ** 0.5).to(bf)
    dy = torch.randn(B, H, W, O, generator=g, device=dev).to(bf)
    before = build.launch_counts()["deform_conv_dgrad_bf16"]
    dx, dom = deform_conv.deform_conv_dgrad_cuda(x, om, weight, dy)
    torch.cuda.synchronize()
    assert build.launch_counts()["deform_conv_dgrad_bf16"] == before + 1
    rdx, rdom = deform_conv.plain_deform_conv_dgrad(x, om, weight, dy)
    assert dx.dtype == dom.dtype == torch.bfloat16
    assert _rel_err(dx.float(), rdx.float()) <= BWD_BF16_REL, _rel_err(dx.float(), rdx.float())
    assert _rel_err(dom.float(), rdom.float()) <= BWD_BF16_REL, _rel_err(dom.float(), rdom.float())
    _, again = deform_conv.deform_conv_dgrad_cuda(x, om, weight, dy)
    assert torch.equal(dom, again)


def test_bf16_training_gradients_on_the_card(dev):
    """A DCN module and an attention layer with bf16 parameters (dropout
    off) on the card: every parameter gets a bf16 gradient through one
    launch of each bf16 backward kernel, as close to the CPU's float32
    gradient as the CPU's bf16 (plain versions) is: within 2x that gap plus
    2^-6 of max(1, max|float32 grad|). (The offsets come out of a bf16
    convolution, so card and CPU bf16 can sample on either side of a pixel
    boundary; the offset conv's gradient then moves by as much as bf16
    itself moves it.)"""
    import copy

    from sgtapose_tpu_torch.models.attention import TransformerEncoderLayer, set_dropout_rate

    gen = torch.Generator().manual_seed(6)
    dcn = deform_conv.DeformConv2d(16, 24)
    layer = TransformerEncoderLayer(16, 4, 63, n_heads=8)
    set_dropout_rate(layer, 0.0)
    with torch.no_grad():
        for p in list(dcn.parameters()) + list(layer.parameters()):
            p.add_(0.3 * torch.randn(p.shape, generator=gen))
    x = torch.randn(2, 16, 12, 12, generator=gen)
    tokens = [torch.randn(2, 63, 16, generator=gen) for _ in range(2)]
    for mod, args in ((dcn, (x,)), (layer, (tokens[0], tokens[1], tokens[1]))):
        w = torch.randn(mod(*args).shape, generator=gen)
        grads = {}
        for where, dtype in (("cpu32", torch.float32), ("cpu16", torch.bfloat16), ("card16", torch.bfloat16)):
            m = copy.deepcopy(mod).to(dtype).train()
            a = [t.to(dtype) for t in args]
            if where == "card16":
                m, a = m.to(dev), [t.to(dev) for t in a]
                before = build.launch_counts()
            (m(*a).float() * w.to(a[0].device)).sum().backward()
            if where == "card16":
                torch.cuda.synchronize()
                after = build.launch_counts()
                for bwd in (("deform_conv_dgrad_bf16", "deform_conv_wgrad_bf16") if mod is dcn
                            else ("biased_attention_bwd_bf16",)):
                    assert after[bwd] == before[bwd] + 1
                assert after["deform_sample_bf16"] == before["deform_sample_bf16"]
            grads[where] = {n: p.grad.float().cpu() for n, p in m.named_parameters()}
            assert all(p.grad.dtype == dtype for p in m.parameters())
        for name, ref in grads["cpu32"].items():
            gap = _rel_err(grads["cpu16"][name], ref)
            err = _rel_err(grads["card16"][name], ref)
            assert err <= 2 * gap + 2.0 ** -6, (name, err, gap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,W,C,O,span", DGRAD_SHAPES)
def test_deform_conv_wgrad_kernel_matches_plain(dev, B, H, W, C, O, span, dtype):
    """The weight gradient at the data gradient's shapes (O = 5: the bf16
    scalar-pair variant), against the plain version at the
    kernel's split of the pixels: float32 within BWD_REL (3xTF32, sums in
    another order), bf16 within BWD_BF16_REL; dW the same bit for bit in two
    runs (the splits are added in a fixed order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(H * C + O + 5)
    x = torch.randn(B, H, W, C, generator=g, device=dev).to(dtype)
    offsets = (torch.rand(B, H, W, 18, generator=g, device=dev) * 2 - 1) * span
    masks = torch.sigmoid(2 * torch.randn(B, H, W, 9, generator=g, device=dev))
    dy = torch.randn(B, H, W, O, generator=g, device=dev).to(dtype)
    name = "deform_conv_wgrad" if dtype == torch.float32 else "deform_conv_wgrad_bf16"
    before = build.launch_counts()[name]
    dw = deform_conv.deform_conv_wgrad_cuda(x, offsets, masks, dy)
    torch.cuda.synchronize()
    assert build.launch_counts()[name] == before + 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = deform_conv.wgrad_splits(B * H * W, C, O, dtype, sms)
    ref = deform_conv.plain_deform_conv_wgrad(x, offsets, masks, dy, splits)
    assert dw.dtype == ref.dtype == dtype and dw.shape == (O, 9 * C)
    bar = BWD_REL if dtype == torch.float32 else BWD_BF16_REL
    assert _rel_err(dw.float(), ref.float()) <= bar, _rel_err(dw.float(), ref.float())
    assert torch.equal(dw, deform_conv.deform_conv_wgrad_cuda(x, offsets, masks, dy))


GLOBAL_DIMS = (4, 8, 16, 32, 64, 128)  # SGTAPoseGlobal's head dim per level, n = 28


@pytest.mark.parametrize("bf16,q_bf16", [(False, False), (True, True), (True, False)],
                         ids=["f32", "bf16_q_bf16", "bf16_q_f32"])
@pytest.mark.parametrize("B", [1, 8, 9])
@pytest.mark.parametrize("d", GLOBAL_DIMS)
def test_attention_nobias_kernel_matches_plain(dev, d, B, bf16, q_bf16):
    """The no-bias forward at the global variant's (28, d), B = 1 (serving),
    8 (training) and a ragged 9; routed by fused_biased_attention(..., None)."""
    g = torch.Generator(device=dev).manual_seed(d + B)
    q, k, v = (torch.randn(B, 8, 28, d, generator=g, device=dev) for _ in range(3))
    name = "biased_attention_nobias_bf16" if bf16 else "biased_attention_nobias"
    if bf16:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        q = q.to(torch.bfloat16 if q_bf16 else torch.float32)
    before = build.launch_counts()[name]
    out = attention_kernel.fused_biased_attention(q, k, v, None)
    torch.cuda.synchronize()
    assert build.launch_counts()[name] == before + 1
    if bf16:
        ref = attention_kernel.plain_biased_attention_bf16(q, k, v, None)
        assert (out - ref).abs().max().item() <= ATTN_BF16_ATOL
    else:
        ref = attention_kernel.plain_biased_attention(q, k, v, None)
        assert (out - ref).abs().max().item() <= 2e-4


@pytest.mark.parametrize("bf16,q_bf16", [(False, False), (True, True), (True, False)],
                         ids=["f32", "bf16_q_bf16", "bf16_q_f32"])
@pytest.mark.parametrize("B", [8, 9, 1])
@pytest.mark.parametrize("d", GLOBAL_DIMS)
def test_attention_bwd_nobias_kernel_matches_plain(dev, d, B, bf16, q_bf16):
    """The no-bias backward (cluster path, no dbias) at the global variant's
    (28, d); every output the same bit for bit in two runs; autograd routes
    a no-bias backward to it."""
    g = torch.Generator(device=dev).manual_seed(d * B + 3)
    q, k, v = (torch.randn(B, 8, 28, d, generator=g, device=dev) for _ in range(3))
    name = "biased_attention_bwd_nobias_bf16" if bf16 else "biased_attention_bwd_nobias"
    if bf16:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        q = q.to(torch.bfloat16 if q_bf16 else torch.float32)
        out = attention_kernel.plain_biased_attention_bf16(q, k, v, None)
    else:
        out = attention_kernel.plain_biased_attention(q, k, v, None)
    dout = torch.randn(B, 8, 28, d, generator=g, device=dev)
    before = build.launch_counts()[name]
    got = attention_kernel.attention_bwd_nobias_cuda(q, k, v, out, dout)
    torch.cuda.synchronize()
    assert build.launch_counts()[name] == before + 1
    plain = (attention_kernel.plain_biased_attention_backward_bf16 if bf16
             else attention_kernel.plain_biased_attention_backward)
    ref = plain(q, k, v, None, out, dout)
    assert ref[3] is None
    bar = BWD_BF16_REL if bf16 else BWD_REL
    for nm, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, nm
        assert _rel_err(a.float(), b.float()) <= bar, (nm, _rel_err(a.float(), b.float()))
    again = attention_kernel.attention_bwd_nobias_cuda(q, k, v, out, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    qs = q.detach().clone().requires_grad_()
    attention_kernel.fused_biased_attention(qs, k, v, None).backward(dout)
    assert build.launch_counts()[name] == before + 3


def _nobias_inputs(dev, B, d, mode, seed, n=28):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(B, 8, n, d, generator=g, device=dev) for _ in range(4))
    if mode != "f32":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        q = q.to(torch.bfloat16 if mode == "bf16_q_bf16" else torch.float32)
    return q, k, v, dout


@pytest.mark.parametrize("mode", ["f32", "bf16_q_bf16", "bf16_q_f32"])
@pytest.mark.parametrize("B", [1, 4, 8, 9])
@pytest.mark.parametrize("d", GLOBAL_DIMS)
def test_nobias_kernels_match_their_yardsticks(dev, d, B, mode):
    """The latency-first no-bias forward and backward against their plain
    versions and against the kernels they replaced (the yardsticks, which
    only such a comparison launches), at the global variant's (28, d);
    reruns the same bit for bit."""
    q, k, v, dout = _nobias_inputs(dev, B, d, mode, 31 * d + B)
    bf16 = mode != "f32"
    names = ("biased_attention_nobias_rowtile_bf16", "biased_attention_bwd_nobias_cluster_bf16") if bf16 else \
        ("biased_attention_nobias_rowtile", "biased_attention_bwd_nobias_cluster")
    before = build.launch_counts()
    kern = attention_kernel.biased_attention_bf16_cuda if bf16 else attention_kernel.biased_attention_cuda
    out = kern(q, k, v, None)
    yard = attention_kernel.attention_nobias_rowtile_cuda(q, k, v)
    torch.cuda.synchronize()
    plain = attention_kernel.plain_biased_attention_bf16 if bf16 else attention_kernel.plain_biased_attention
    ref = plain(q, k, v, None)
    tol = ATTN_BF16_ATOL if bf16 else 2e-4
    assert (out - ref).abs().max().item() <= tol
    assert (out - yard).abs().max().item() <= tol
    assert torch.equal(out, kern(q, k, v, None))
    got = attention_kernel.attention_bwd_nobias_cuda(q, k, v, ref, dout)
    yard = attention_kernel.attention_bwd_nobias_cluster_cuda(q, k, v, ref, dout)
    plain = (attention_kernel.plain_biased_attention_backward_bf16 if bf16
             else attention_kernel.plain_biased_attention_backward)
    want = plain(q, k, v, None, ref, dout)
    bar = BWD_BF16_REL if bf16 else BWD_REL
    for nm, a, y, w in zip(("dq", "dk", "dv"), got, yard, want):
        assert a.dtype == y.dtype == w.dtype, nm
        assert _rel_err(a.float(), w.float()) <= bar, (nm, _rel_err(a.float(), w.float()))
        assert _rel_err(a.float(), y.float()) <= bar, (nm, _rel_err(a.float(), y.float()))
    again = attention_kernel.attention_bwd_nobias_cuda(q, k, v, ref, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    after = build.launch_counts()
    assert all(after[nm] == before[nm] + 1 for nm in names)


@pytest.mark.parametrize("n", [1, 5, 33, 70, 163, 192])
@pytest.mark.parametrize("d", GLOBAL_DIMS)
def test_nobias_kernels_at_other_n(dev, d, n):
    """The no-bias kernels off the global variant's n = 28: one token, fewer
    keys than a warp has lanes, and beyond 32 (a lane takes up to 6 keys):
    the forward wherever it takes n (up to NOBIAS_MAX_TOKENS, within its
    shared memory), the backward wherever bwd_path says "cluster"; float32
    and bf16 with a bf16 q, against the plain versions."""
    fwd = n <= attention_kernel.NOBIAS_MAX_TOKENS
    bwd = attention_kernel.bwd_path(n, d, bias=False) == "cluster"
    for mode in ("f32", "bf16_q_bf16"):
        q, k, v, dout = _nobias_inputs(dev, 2, d, mode, n + d, n=n)
        bf16 = mode != "f32"
        plain = attention_kernel.plain_biased_attention_bf16 if bf16 else attention_kernel.plain_biased_attention
        ref = plain(q, k, v, None)
        if fwd and attention_kernel.nobias_fwd_smem_bytes(n, d, q.element_size(), k.element_size()) <= 227 * 1024:
            kern = attention_kernel.biased_attention_bf16_cuda if bf16 else attention_kernel.biased_attention_cuda
            out = kern(q, k, v, None)
            torch.cuda.synchronize()
            assert (out - ref).abs().max().item() <= (ATTN_BF16_ATOL if bf16 else 2e-4), mode
        if bwd:
            got = attention_kernel.attention_bwd_nobias_cuda(q, k, v, ref, dout)
            torch.cuda.synchronize()
            plain_bwd = (attention_kernel.plain_biased_attention_backward_bf16 if bf16
                         else attention_kernel.plain_biased_attention_backward)
            want = plain_bwd(q, k, v, None, ref, dout)
            for nm, a, b in zip(("dq", "dk", "dv"), got, want):
                assert _rel_err(a.float(), b.float()) <= (BWD_BF16_REL if bf16 else BWD_REL), (mode, nm)


@pytest.mark.parametrize("d", [64, 128])
def test_attention_kernel_refuses_a_bias_at_the_global_dims(dev, d):
    """The kernels take a bias at head dims up to 32 only (no model runs a
    biased attention at 64 or 128): it raises, in float32 and bf16."""
    q = torch.randn(1, 8, 28, d, device=dev)
    bias = torch.zeros(8, 28, 28, device=dev)
    with pytest.raises(ValueError, match="up to 32"):
        attention_kernel.fused_biased_attention(q, q, q, bias)
    kv, bias = q.to(torch.bfloat16), bias.to(torch.bfloat16)
    with pytest.raises(ValueError, match="up to 32"):
        attention_kernel.fused_biased_attention(q, kv, kv, bias)


# (N, H, W, C, O, kernel, stride) of int8 sites: flagship trunk and head
# shapes, the stems' C_in 3 and 1, ragged ones (C % 16 != 0, O below a tile)
INT8_SHAPES = [(2, 60, 60, 64, 64, 3, 1), (2, 120, 120, 32, 64, 3, 2), (2, 96, 96, 3, 16, 7, 1),
               (2, 96, 96, 1, 16, 7, 1), (1, 30, 30, 4608, 256, 1, 1), (1, 120, 120, 64, 256, 3, 1),
               (3, 9, 11, 24, 5, 3, 2), (1, 7, 5, 40, 70, 1, 1)]
# and the sites the redesign splits K at (the DCN's contractions at 15x15
# and 30x30), the level-5 3x3, and both full-size stems
INT8_SITE_SHAPES = INT8_SHAPES + [(1, 15, 15, 4608, 256, 1, 1), (1, 30, 30, 2304, 256, 1, 1),
                                  (2, 15, 15, 512, 512, 3, 1), (2, 480, 480, 3, 16, 7, 1),
                                  (2, 480, 480, 1, 16, 7, 1)]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N,H,W,C,O,k,s", INT8_SHAPES)
def test_int8_conv_kernel_matches_plain(dev, N, H, W, C, O, k, s, out_dtype):
    """PR 14's kernel (the yardstick, on s8 operands): s32 accumulators and
    outputs bit for bit, with and without a bias."""
    from sgtapose_tpu_torch.ops import int8_conv

    g = torch.Generator(device=dev).manual_seed(N * H + C + O)
    x_q = torch.randint(-127, 128, (N, H, W, C), generator=g, device=dev, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (O, k, k, C), generator=g, device=dev, dtype=torch.int8)
    qw = int8_conv.pack_weight(w_q, torch.rand(O, generator=g, device=dev) * 1e-3)
    a_scale = torch.rand(N, generator=g, device=dev) * 0.1
    for bias in (None, torch.randn(O, generator=g, device=dev).to(out_dtype)):
        before = build.launch_counts()["int8_conv"]
        out, acc = int8_conv.int8_conv_cuda(x_q, qw, a_scale, bias, s, k // 2, out_dtype, return_acc=True)
        torch.cuda.synchronize()
        assert build.launch_counts()["int8_conv"] == before + 1
        ref, ref_acc = int8_conv.plain_int8_conv(x_q, qw, a_scale, bias, s, k // 2, out_dtype, return_acc=True)
        assert torch.equal(acc, ref_acc)
        assert torch.equal(out, ref)


def _int8_site_operands(dev, N, H, W, C, O, k, dtype, seed):
    from sgtapose_tpu_torch.models import layers

    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(N, H, W, C, generator=g, device=dev) * 2).to(dtype)
    w = torch.randn(O, C, k, k, generator=g, device=dev) / (k * k * C) ** 0.5
    qw = layers._cached_weight(torch.nn.Module(), w, k, k)
    bias = (0.1 * torch.randn(O, generator=g, device=dev)).to(dtype)
    return x, qw, bias, float(x.float().abs().max()) * 0.8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N,H,W,C,O,k,s", INT8_SITE_SHAPES)
def test_int8_site_kernel_matches_plain(dev, N, H, W, C, O, k, s, dtype):
    """The site's kernels (the activation quantized inside) against
    `plain_int8_site`: outputs and s32 accumulators bit for bit, static and
    dynamic scales (a static max below the data's: x_q clips), per video
    with groups 2, with and without a bias; one int8_conv_fused launch, and
    one int8_absmax more where the scale is dynamic."""
    from sgtapose_tpu_torch.ops import int8_conv

    x, qw, bias, a_max = _int8_site_operands(dev, N, H, W, C, O, k, dtype, N * H + C + O)
    cases = [(None, 1, None), (a_max, 1, bias), (None, 1, bias)] + ([(None, 2, bias)] if N % 2 == 0 else [])
    for case_max, groups, b in cases:
        build.reset_launch_counts()
        out, acc = int8_conv.int8_site_cuda(x, qw, case_max, groups, b, s, k // 2, return_acc=True)
        torch.cuda.synchronize()
        counts = {kn: n for kn, n in build.launch_counts().items() if n}
        assert counts == {"int8_conv_fused": 1, **({"int8_absmax": 1} if case_max is None else {})}
        ref, ref_acc = int8_conv.plain_int8_site(x, qw, case_max, groups, b, s, k // 2, return_acc=True)
        assert torch.equal(acc, ref_acc), (case_max, groups)
        assert out.dtype == dtype and torch.equal(out, ref), (case_max, groups)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N,H,W,C,O,k,s", [(2, 60, 60, 64, 128, 3, 1), (2, 30, 30, 24, 40, 3, 2),
                                           (1, 9, 11, 600, 8, 3, 1)])
def test_int8_site_a_producers_give_the_same_bits(dev, N, H, W, C, O, k, s, dtype):
    """Every A producer the site allows (gather; vec where C % 16 == 0;
    patch where it fits): the plain version's accumulators and outputs,
    with a dynamic scale per video."""
    from sgtapose_tpu_torch.ops import int8_conv

    x, qw, bias, _ = _int8_site_operands(dev, N, H, W, C, O, k, dtype, C + O)
    ref, ref_acc = int8_conv.plain_int8_site(x, qw, None, N, bias, s, k // 2, return_acc=True)
    modes = ["gather"] + (["vec"] if C % 16 == 0 else [])
    modes += ["patch"] if int8_conv.a_mode(C, k, k, s, 1000, aligned=False) == "patch" else []
    assert len(modes) > 1 or C == 600  # C = 600: only the gather mode
    for mode in modes:
        out, acc = int8_conv.int8_site_cuda(x, qw, None, N, bias, s, k // 2, return_acc=True, mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(acc, ref_acc) and torch.equal(out, ref), mode


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_site_quantizes_near_ties_as_plain(dev, dtype):
    """x at and a few units in the last place around (j + 1/2) a_scale, where
    the kernel's product by the reciprocal of the scale falls within 2^-12 of
    a half-integer and it takes the exact quotient: x_q, so the accumulators
    and outputs, bit for bit, in the vec and the patch modes."""
    from sgtapose_tpu_torch.models import layers
    from sgtapose_tpu_torch.ops import int8_conv

    a_max = 100.0
    s = torch.tensor(a_max / 127.0, dtype=torch.float32)
    j = torch.arange(-130, 130, dtype=torch.float32) + 0.5
    ties = (j * s).repeat_interleave(9)  # and 4 units in the last place to either side
    ties = (ties.view(torch.int32) + torch.arange(-4, 5, dtype=torch.int32).repeat(260)).view(torch.float32)
    for C, k in ((16, 3), (3, 7)):
        x = ties[torch.randperm(ties.numel(), generator=torch.Generator().manual_seed(C))]
        x = x[:(x.numel() // (C * 36)) * C * 36].reshape(1, -1, 6, C).to(dtype).to(dev)
        w = torch.randn(32, C, k, k, generator=torch.Generator().manual_seed(1)).to(dev)
        qw = layers._cached_weight(torch.nn.Module(), w, k, k)
        out, acc = int8_conv.int8_site_cuda(x, qw, a_max, 1, None, 1, k // 2, return_acc=True)
        ref, ref_acc = int8_conv.plain_int8_site(x, qw, a_max, 1, None, 1, k // 2, return_acc=True)
        assert torch.equal(acc, ref_acc) and torch.equal(out, ref)


@pytest.mark.parametrize("N,H,W,C,O", [(1, 15, 15, 4608, 256), (1, 30, 30, 2304, 64), (2, 15, 15, 512, 512)])
def test_int8_site_split_on_and_off_gives_the_same_bits(dev, N, H, W, C, O):
    """Split-K over 1, 2, 5 and 8 ranks of a cluster, and the plan's own
    split: the same accumulators and outputs."""
    from sgtapose_tpu_torch.ops import int8_conv

    k = 3 if C == 512 else 1
    x, qw, bias, _ = _int8_site_operands(dev, N, H, W, C, O, k, torch.bfloat16, C + O)
    p = int8_conv.plan(N * H * W, O, qw.q.shape[1], int8_conv._sm_count(x.device), 2)
    assert p.splits > 1
    ref, ref_acc = int8_conv.int8_site_cuda(x, qw, None, 1, bias, 1, k // 2, return_acc=True, splits=1)
    for splits in (2, 5, 8, None):
        out, acc = int8_conv.int8_site_cuda(x, qw, None, 1, bias, 1, k // 2, return_acc=True, splits=splits)
        torch.cuda.synchronize()
        assert torch.equal(acc, ref_acc) and torch.equal(out, ref), splits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 480, 480, 3), (1, 15, 15, 4608), (3, 7, 5, 3), (2, 1, 1, 1), (16, 30, 30, 256)])
def test_int8_absmax_matches_amax(dev, shape, dtype):
    """The reduction's slot maxima equal the plain version's, and their max
    per sample equals torch.amax of |x|, exactly (also at spans that start
    off a 16-byte line: 3 x 7 x 5 elements a sample)."""
    from sgtapose_tpu_torch.ops import int8_conv

    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g, device=dev) * 3).to(dtype)
    for slots in (None, 1, 7):
        part = int8_conv.int8_absmax_cuda(x, slots)
        torch.cuda.synchronize()
        assert torch.equal(part, int8_conv.plain_int8_absmax(x, part.shape[1]))
        assert torch.equal(part.amax(dim=1), x.float().abs().reshape(shape[0], -1).amax(dim=1))


def test_int8_site_launch_budget(dev):
    """One launch a static site, two a dynamic one, and no other CUDA
    kernel on the route (no cast, division, rounding, clamp, copy or fill),
    from the launch counters and from torch.profiler's device kernels."""
    from torch.profiler import ProfilerActivity, profile

    from sgtapose_tpu_torch.ops import int8_conv

    for dtype in (torch.bfloat16, torch.float32):
        x, qw, bias, a_max = _int8_site_operands(dev, 2, 30, 30, 256, 256, 3, dtype, 0)
        for case_max, expect in ((a_max, {"int8_conv_fused": 1}),
                                 (None, {"int8_absmax": 1, "int8_conv_fused": 1})):
            int8_conv.int8_site(x, qw, case_max, 1, bias, 1, 1)  # built and warm
            torch.cuda.synchronize()
            build.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                int8_conv.int8_site(x, qw, case_max, 1, bias, 1, 1)
                torch.cuda.synchronize()
            assert {kn: n for kn, n in build.launch_counts().items() if n} == expect
            events = list(prof.events())
            # every kernel launch the host made (the launch API's events), and what ran on the device
            launches = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU
                        and ("LaunchKernel" in e.name or e.name == "cuLaunchKernel")]
            kernels = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
            assert len(launches) == len(expect), launches
            assert kernels and all("int8_" in name for name in kernels), kernels


def test_int8_scales_divide_as_jax_on_the_card(dev):
    """The weight and activation scales on the card equal the CPU's (JAX's)
    bit for bit at maxima where a multiplication by the rounded reciprocal
    of 127, what PyTorch's CUDA division by a Python number does, misses the
    quotient by one unit in the last place."""
    from sgtapose_tpu_torch.models import layers

    m = torch.tensor([6.4589409828186035, 0.7103605270385742, 5.68433952331543])
    assert not torch.equal((m.to(dev) / 127.0).cpu(), m / 127.0)  # the CUDA division by a number
    w = torch.eye(3)[:, :, None, None] * m[:, None, None, None]  # (O, C, 1, 1), max|w| of channel o is m[o]
    for got, ref in zip(layers.weight_quant(w.to(dev)), layers.weight_quant(w)):
        assert torch.equal(got.cpu(), ref)
    x = m[:, None, None, None].expand(3, 2, 2, 1).contiguous()
    assert torch.equal(layers.activation_scale(x.to(dev), groups=3).cpu(), layers.activation_scale(x, groups=3))


def test_int8_serving_reaches_the_kernel_at_every_site(dev):
    """A full-width bf16 forward under int8 (batch 1, 96x96), dynamic
    scales: one int8_conv_fused and one int8_absmax launch per site (57),
    none of PR 14's int8_conv, the DCN's columns from the bf16 sampler (16),
    no fused DCN; with min_ch 64 the gated sites run float."""
    from sgtapose_tpu_torch.config import ModelConfig
    from sgtapose_tpu_torch.models import layers
    from sgtapose_tpu_torch.models.sgta import create_model
    from sgtapose_tpu_torch.utils.precision import bf16_inference_model

    model = bf16_inference_model(create_model(ModelConfig(input_res=(96, 96)), device=dev))
    g = torch.Generator(device=dev).manual_seed(0)
    inputs = [torch.randn(1, 96, 96, c, generator=g, device=dev).to(torch.bfloat16) for c in (3, 3, 1, 1)]
    inputs += [torch.rand(1, 24, 24, 7, generator=g, device=dev).to(torch.bfloat16) for _ in range(2)]
    for min_ch, sites in ((0, 57), (64, None)):
        build.reset_launch_counts()
        with torch.no_grad(), layers.quantized("int8", min_ch=min_ch):
            out = model(*inputs)
        torch.cuda.synchronize()
        counts = build.launch_counts()
        assert all(torch.isfinite(v.float()).all() for v in out.values())
        assert counts["deform_sample_bf16"] == 16 and counts["deform_conv_bf16"] == 0 and counts["int8_conv"] == 0
        assert counts["int8_absmax"] == counts["int8_conv_fused"]
        assert counts["int8_conv_fused"] == sites if sites else 16 < counts["int8_conv_fused"] < 57
