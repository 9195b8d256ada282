"""The int8 convolution of int8 serving: s8 x s8 -> s32, then JAX's rescale.

Counterpart of the convolution in `sgtapose_tpu/models/layers.py:_int8_conv`
(an XLA conv on the TPU). `int8_conv` takes operands already quantized
(`models/layers.py` quantizes them): x_q (N, H, W, C) int8 NHWC, a
`QuantWeight` (the (O, KH, KW, C) int8 weight packed as (O, Kp) with K = KH
KW C zero-padded to Kp, a multiple of 32, and its per-output-channel
float32 scales), the per-image activation scales a_scale (N,), and returns
(N, Ho, Wo, O) in `out_dtype`:

    acc = conv(x_q, w_q)                                  exact int32
    out = (float32(acc) * (w_scale[o] * a_scale[n])).to(out_dtype)
    out = out + bias                                      in out_dtype

CUDA tensors launch the hand-written kernel `csrc/int8_conv.cu` (or raise);
CPU tensors take `plain_int8_conv`, which accumulates exactly in float64
(|acc| < 127^2 K << 2^53) and casts to int32. The DCN's (9C -> O)
contraction runs here as a 1x1 conv over its (B, H, W, 9C) columns.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from sgtapose_tpu_torch.ops import build

KERNEL = "int8_conv"
K_STEP = 32  # the kernel's K step: one mma.m16n8k32


class QuantWeight(NamedTuple):
    """A quantized conv weight: q (O, Kp) int8, K = kh kw c in (ky, kx, c)
    order zero-padded to Kp; scale (O,) float32."""

    q: torch.Tensor
    scale: torch.Tensor
    kh: int
    kw: int
    c: int

    def unpacked(self) -> torch.Tensor:
        """(O, kh, kw, c) int8."""
        K = self.kh * self.kw * self.c
        return self.q[:, :K].reshape(-1, self.kh, self.kw, self.c)


def pack_weight(w_q: torch.Tensor, scale: torch.Tensor) -> QuantWeight:
    """QuantWeight of w_q (O, kh, kw, c), integer values in [-127, 127] of
    any dtype, and its scales (O,)."""
    O, kh, kw, c = w_q.shape
    K = kh * kw * c
    Kp = -(-K // K_STEP) * K_STEP
    q = torch.zeros((O, Kp), dtype=torch.int8, device=w_q.device)
    q[:, :K] = w_q.reshape(O, K).to(torch.int8)
    return QuantWeight(q, scale.to(torch.float32).contiguous(), kh, kw, c)


def out_size(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def epilogue(acc: torch.Tensor, w_scale: torch.Tensor, a_scale: torch.Tensor,
             bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's epilogue on acc (N, Ho, Wo, O) int32: float32(acc) times
    the float32 product w_scale[o] a_scale[n], cast to out_dtype, plus the
    bias in out_dtype."""
    scale = w_scale[None, :] * a_scale[:, None]  # (N, O) float32
    out = (acc.to(torch.float32) * scale[:, None, None, :]).to(out_dtype)
    return out if bias is None else out + bias.to(out_dtype)


def plain_int8_conv(x_q: torch.Tensor, qw: QuantWeight, a_scale: torch.Tensor, bias: Optional[torch.Tensor],
                    stride: int, pad: int, out_dtype: torch.dtype, return_acc: bool = False):
    """The kernel's function in plain PyTorch (see the module docstring):
    exact int32 accumulators from a float64 convolution."""
    w = qw.unpacked().permute(0, 3, 1, 2).to(torch.float64)
    acc = F.conv2d(x_q.permute(0, 3, 1, 2).to(torch.float64), w, None, stride, pad)
    acc = acc.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()
    out = epilogue(acc, qw.scale, a_scale, bias, out_dtype)
    return (out, acc) if return_acc else out


def int8_conv_cuda(x_q: torch.Tensor, qw: QuantWeight, a_scale: torch.Tensor, bias: Optional[torch.Tensor],
                   stride: int, pad: int, out_dtype: torch.dtype, return_acc: bool = False):
    """Launch `csrc/int8_conv.cu` on the current stream (CUDA tensors)."""
    if x_q.dim() != 4 or x_q.dtype != torch.int8:
        raise ValueError(f"x_q must be (N,H,W,C) int8, got {tuple(x_q.shape)} {x_q.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bf16, got {out_dtype}")
    N, H, W, C = x_q.shape
    O, Kp = qw.q.shape
    if qw.c != C or Kp % K_STEP or Kp < qw.kh * qw.kw * C:
        raise ValueError(f"weight (O={O}, {qw.kh}x{qw.kw}x{qw.c}, Kp={Kp}) does not fit x_q {tuple(x_q.shape)}")
    checks = [("x_q", x_q, torch.int8, (N, H, W, C)), ("w", qw.q, torch.int8, (O, Kp)),
              ("w_scale", qw.scale, torch.float32, (O,)), ("a_scale", a_scale, torch.float32, (N,))]
    if bias is not None:
        checks.append(("bias", bias, out_dtype, (O,)))
    for label, t, dtype, shape in checks:
        if t.device.type != "cuda" or t.device != x_q.device:
            raise ValueError(f"{label} must be a CUDA tensor on {x_q.device}, got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{label} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    Ho, Wo = out_size(H, qw.kh, stride, pad), out_size(W, qw.kw, stride, pad)
    if N * H * W * C >= 2 ** 31 or N * Ho * Wo * O >= 2 ** 31:
        raise ValueError(f"x_q {tuple(x_q.shape)} with O={O} exceeds the kernel's 32-bit indices")
    out = torch.empty((N, Ho, Wo, O), dtype=out_dtype, device=x_q.device)
    acc = torch.empty((N, Ho, Wo, O), dtype=torch.int32, device=x_q.device) if return_acc else None
    fn = build.kernel_fn(KERNEL)
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x_q.data_ptr(), qw.q.data_ptr(), qw.scale.data_ptr(), a_scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 None if acc is None else acc.data_ptr(), N, H, W, C, O, qw.kh, qw.kw, stride, pad, Ho, Wo, Kp,
                 int(out_dtype == torch.bfloat16), stream)
    build.check(KERNEL, err)
    build.count_launch(KERNEL)
    return (out, acc) if return_acc else out


def int8_conv(x_q: torch.Tensor, qw: QuantWeight, a_scale: torch.Tensor, bias: Optional[torch.Tensor],
              stride: int, pad: int, out_dtype: torch.dtype, return_acc: bool = False):
    """The int8 convolution (module docstring): CUDA tensors through the
    kernel (or raise), CPU tensors through `plain_int8_conv`."""
    if x_q.device.type == "cpu":
        return plain_int8_conv(x_q, qw, a_scale, bias, stride, pad, out_dtype, return_acc)
    return int8_conv_cuda(x_q, qw, a_scale, bias, stride, pad, out_dtype, return_acc)
