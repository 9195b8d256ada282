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
                                   (1, 4, 2), (63, 16, 1), (63, 16, 9), (100, 8, 8)])
def test_biased_attention_bwd_kernel_matches_plain(dev, n, d, B):
    """The flagship shapes at the training batch of 8, and ragged n; n <= 100
    takes the cluster path (B = 9: a rank sums two batch elements)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(n * d + B)
    q, k, v, dout = (torch.randn(B, 8, n, d, generator=g, device=dev) for _ in range(4))
    bias = 0.3 * torch.randn(8, n, n, generator=g, device=dev)
    out = attention_kernel.plain_biased_attention(q, k, v, bias)
    before = build.launch_counts()["biased_attention_bwd"]
    got = attention_kernel.biased_attention_bwd_cuda(q, k, v, bias, out, dout)
    torch.cuda.synchronize()
    assert build.launch_counts()["biased_attention_bwd"] == before + 1
    ref = attention_kernel.plain_biased_attention_backward(q, k, v, bias, out, dout)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert a.shape == b.shape, name
        assert _rel_err(a, b) <= BWD_REL, (name, _rel_err(a, b))
    again = attention_kernel.biased_attention_bwd_cuda(q, k, v, bias, out, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: reproducible


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
        bwd = "deform_conv_dgrad" if mod is dcn else "biased_attention_bwd"
        assert after[bwd] == before[bwd] + 1
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
