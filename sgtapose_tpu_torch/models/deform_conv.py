"""Modulated deformable convolution (DCNv2), NHWC.

Counterpart of `sgtapose_tpu/models/deform_conv.py` (`deform_sample_batch`,
`DeformConv2d`). A 3x3 offset/mask conv gives 27 channels: for row-major tap
k, channels (2k, 2k+1) are the (dy, dx) offsets and channel 18+k the mask
logit. The 9 taps are sampled bilinearly at (p + tap + offset) with zero
padding, scaled by sigmoid(mask), and contracted with the kernel weights in
one (9*C_in -> C_out) product whose input is tap-major (index k*C + c).

On the card `DeformConv2d` runs one fused kernel (sampling, contraction and
bias as an implicit GEMM on the tensor cores), `csrc/deform_conv.cu`, whose
design has two instantiations chosen by dtype: float32 (wgmma in 3xTF32) and
bf16 serving (wgmma bf16 with float32 accumulators); any other dtype raises. CPU tensors take the plain version
`plain_deform_conv`, which follows each kernel's arithmetic. In bf16 the
kernel forms each sampled element in float32 from the bf16 inputs and rounds
it once to bf16, and rounds the float32 product plus bias once; the JAX
module rounds after every corner product and sum, and adds a bf16 bias to a
bf16 product (`sgtapose_tpu/models/deform_conv.py:92-99`).
The sampler alone, `csrc/deform_sample.cu`, stays for the training slice's
weight gradient, which needs the sampled columns; the detector does not
launch it. Its plain version (a mirror of the JAX `_sample_pieces`) serves
CPU tensors.
Forward only (the JAX custom VJP `_dsb_bwd` belongs to the training slice).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from sgtapose_tpu_torch.ops import build

KERNEL = "deform_sample"
CONV_KERNEL = "deform_conv"
CONV_KERNEL_BF16 = "deform_conv_bf16"


def plain_deform_sample(feat: torch.Tensor, offsets: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """feat (B,H,W,C), offsets (B,H,W,18) as (dy, dx) per tap, masks (B,H,W,9)
    already sigmoided -> (B,H,W,9*C). Zero padding outside the map."""
    B, H, W, C = feat.shape
    dev = feat.device
    gy = torch.arange(H, dtype=torch.float32, device=dev)[:, None, None]
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, :, None]
    taps = torch.arange(9, device=dev)
    ky = (taps // 3 - 1).to(torch.float32)[None, None, :]
    kx = (taps % 3 - 1).to(torch.float32)[None, None, :]

    off = offsets.reshape(B, H, W, 9, 2)
    y = (gy + ky)[None] + off[..., 0]  # (B,H,W,9)
    x = (gx + kx)[None] + off[..., 1]
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    fy = y - y0
    fx = x - x0
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)

    flat = feat.reshape(B, H * W, C)
    out = None
    for dy, dx, wy, wx in ((0, 0, 1 - fy, 1 - fx), (0, 1, 1 - fy, fx),
                           (1, 0, fy, 1 - fx), (1, 1, fy, fx)):
        yi = y0i + dy
        xi = x0i + dx
        valid = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)).to(torch.float32)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C)).reshape(B, H, W, 9, C)
        term = vals * (wy * wx * valid)[..., None]
        out = term if out is None else out + term
    return (out * masks[..., None]).reshape(B, H, W, 9 * C)


def deform_sample_cuda(feat: torch.Tensor, offsets: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA sampling kernel on the current stream (CUDA tensors)."""
    if feat.dim() != 4:
        raise ValueError(f"feat must be (B,H,W,C), got {tuple(feat.shape)}")
    B, H, W, C = feat.shape
    if tuple(offsets.shape) != (B, H, W, 18) or tuple(masks.shape) != (B, H, W, 9):
        raise ValueError(
            f"offsets/masks must be (B,H,W,18)/(B,H,W,9) for feat {tuple(feat.shape)}, "
            f"got {tuple(offsets.shape)}/{tuple(masks.shape)}")
    for name, t in (("feat", feat), ("offsets", offsets), ("masks", masks)):
        if t.device.type != "cuda" or t.device != feat.device:
            raise ValueError(f"{name} must be a CUDA tensor on {feat.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((B, H, W, 9 * C), dtype=torch.float32, device=feat.device)
    fn = build.kernel_fn(KERNEL)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(feat.data_ptr(), offsets.data_ptr(), masks.data_ptr(), out.data_ptr(),
                 B, H, W, C, stream)
    build.check(KERNEL, err)
    build.count_launch(KERNEL)
    return out


def deform_sample(feat: torch.Tensor, offsets: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """9-tap modulated deformable sampling (see module docstring). CUDA
    tensors go through the kernel (or raise); CPU tensors take the plain
    version."""
    if feat.device.type == "cpu":
        return plain_deform_sample(feat, offsets, masks)
    return deform_sample_cuda(feat, offsets, masks)


def plain_deform_conv(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """x (B,H,W,C), om (B,H,W,27) the raw offset/mask conv output, weight
    (O, 9C) with input index k*C + c, bias (O,) -> (B,H,W,O). bf16 inputs
    follow the bf16 kernel: the sampled columns formed in float32 and rounded
    once to bf16, the product and bias in float32, rounded once."""
    if x.dtype == torch.bfloat16:
        f32, bf16 = torch.float32, torch.bfloat16
        flat = plain_deform_sample(x.to(f32), om[..., :18].to(f32),
                                   torch.sigmoid(om[..., 18:27].to(f32))).to(bf16)
        return torch.nn.functional.linear(flat.to(f32), weight.to(f32), bias.to(f32)).to(bf16)
    flat = plain_deform_sample(x, om[..., :18], torch.sigmoid(om[..., 18:27]))
    return torch.nn.functional.linear(flat, weight, bias)


def deform_conv_cuda(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """Launch the fused DCN kernel of x's dtype (float32 or bf16; all four
    tensors share it) on the current stream (CUDA tensors)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bf16, got {x.dtype}")
    name = CONV_KERNEL if x.dtype == torch.float32 else CONV_KERNEL_BF16
    if x.dim() != 4:
        raise ValueError(f"x must be (B,H,W,C), got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if weight.dim() != 2 or weight.shape[1] != 9 * C:
        raise ValueError(f"weight must be (O, 9*C) = (O, {9 * C}), got {tuple(weight.shape)}")
    O = weight.shape[0]
    if tuple(om.shape) != (B, H, W, 27) or tuple(bias.shape) != (O,):
        raise ValueError(f"om/bias must be (B,H,W,27)/(O,) for x {tuple(x.shape)} and O={O}, "
                         f"got {tuple(om.shape)}/{tuple(bias.shape)}")
    for label, t in (("x", x), ("om", om), ("weight", weight), ("bias", bias)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{label} must be a CUDA tensor on {x.device}, got {t.device}")
        if t.dtype != x.dtype:
            raise ValueError(f"{label} must be {x.dtype} like x, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    M = B * H * W
    if M * max(C, 27) >= 2 ** 31 or M * O >= 2 ** 31:
        raise ValueError(f"x {tuple(x.shape)} with O={O} exceeds the kernel's 32-bit offsets")
    out = torch.empty((B, H, W, O), dtype=x.dtype, device=x.device)
    fn = build.kernel_fn(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), om.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 B, H, W, C, O, stream)
    build.check(name, err)
    build.count_launch(name)
    return out


def deform_conv(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """Modulated deformable conv from the offset/mask conv's raw output (see
    `plain_deform_conv`). CUDA tensors go through the fused kernel of their
    dtype, float32 or bf16 (or raise); CPU tensors take the plain version.
    Any other dtype raises on both."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"deform_conv runs float32 or bf16, got {x.dtype}")
    if x.device.type == "cpu":
        return plain_deform_conv(x, om, weight, bias)
    return deform_conv_cuda(x, om, weight, bias)


class DeformConv2d(nn.Module):
    """DCNv2: 3x3 modulated deformable conv, stride 1, pad 1, one group.

    Takes and returns NCHW tensors (channels_last memory keeps the NHWC views
    the fused kernel reads and writes free of copies). `conv_offset_mask` starts at zero, so
    the initial op is a plain 3x3 conv with 0.5 masks, as in the JAX module.
    """

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv_offset_mask = nn.Conv2d(in_features, 27, 3, padding=1)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)
        # the (9*C_in -> O) contraction; input index k*C_in + c
        self.kernel = nn.Linear(9 * in_features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        om = self.conv_offset_mask(x).permute(0, 2, 3, 1).contiguous()  # (B,H,W,27)
        out = deform_conv(x.permute(0, 2, 3, 1).contiguous(), om, self.kernel.weight, self.kernel.bias)
        return out.permute(0, 3, 1, 2)
