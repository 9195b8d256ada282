"""The int8 convolution of int8 serving: the activation quantized, s8 x s8
-> s32, then JAX's rescale.

Counterpart of `sgtapose_tpu/models/layers.py:_int8_conv` (an XLA function
on the TPU: `_quantize_operands` for the activation, the s8 conv, the
rescale). `int8_site` takes the site's activation x (N, H, W, C) NHWC in
float32 or bf16, a `QuantWeight` (the (O, KH, KW, C) int8 weight packed as
(O, Kp) with K = KH KW C zero-padded to Kp, a multiple of 32, and its
per-output-channel float32 scales), the static activation max `a_max` (or
None: dynamic) and `groups`, and returns (N, Ho, Wo, O) in x's dtype:

    a_scale = activation_scale(x, a_max, groups)          (N,) float32
    x_q = clamp(round(float32(x) / a_scale[n]), -127, 127)
    acc = conv(x_q, w_q)                                  exact int32
    out = (float32(acc) * (w_scale[o] * a_scale[n])).to(x.dtype)
    out = out + bias                                      in x's dtype

CUDA tensors launch the hand-written kernels of `csrc/int8_conv_fused.cu`
(or raise): `int8_conv_fused`, which quantizes x inside, once a site, after
`int8_absmax` (the per-sample max|x|) where the scale is dynamic; `plan`
picks its N tile and its split of K. CPU tensors take `plain_int8_site`,
whose convolution `plain_int8_conv` accumulates exactly in float64
(|acc| < 127^2 K << 2^53) and casts to int32. The DCN's (9C -> O)
contraction runs as a 1x1 site over its (B, H, W, 9C) columns.

PR 14's route, PyTorch's quantize ops then `csrc/int8_conv.cu` on s8
operands (`int8_conv_cuda`), stays as the kernels' yardstick, on no path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from sgtapose_tpu_torch.ops import build

KERNEL = "int8_conv"  # PR 14's kernel: the yardstick
KERNEL_FUSED = "int8_conv_fused"
KERNEL_ABSMAX = "int8_absmax"
K_STEP = 32  # the packing of K: one mma.m16n8k32 (PR 14's kernel) or wgmma k32 step

# int8_conv_fused's tiling (csrc/int8_conv_fused.cu): 64 output pixels a
# block, N tiles of 64 output channels or 16 where O <= 16, K in stages of
# 128 bytes, split-K over at most 8 blocks of a cluster
TILE_M = 64
TILE_N = (16, 64)
K_STAGE = 128
MAX_SPLITS = 8
MAX_VIDEOS = 64  # per-video dynamic scales the kernel holds
# the A producer's modes (`a_mode`): "vec", x's raw rows by cp.async where
# C % 16 == 0 (a 16-element chunk is one tap's channels), quantized a stage
# at a time; "patch", a block's input patch (`patch_tile`, `patch_bytes`)
# quantized once into shared memory and A read from it through a tap table:
# the stems and the 3x3 sites whose patch fits; "gather", element by element
MODES = {"gather": 0, "vec": 1, "patch": 2}
PATCH_BYTES = 32768
PATCH_K = 4608


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
    """Launch PR 14's kernel `csrc/int8_conv.cu` on the current stream
    (CUDA tensors, x_q quantized already): the yardstick of the site's
    kernels, on no path."""
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


def video_scales(partial_max: torch.Tensor, groups: int) -> torch.Tensor:
    """The dynamic scales (N,) from per-sample partial maxima (N, slots), as
    `int8_conv_fused` forms them in its prologue: each video's max (sample n
    is video n % groups), floored at 1e-12, over 127, in float32."""
    N = partial_max.shape[0]
    per_video = partial_max.reshape(N // groups, groups, -1).amax(dim=(0, 2))
    return div127(per_video.clamp_min(1e-12)).repeat(N // groups)


def div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as an IEEE division on any device, as JAX divides. (With a
    Python number as the divisor, PyTorch's CUDA division multiplies by its
    rounded reciprocal, which can miss the quotient by one unit in the last
    place; a tensor divisor keeps the true division.)"""
    return t / torch.full_like(t, 127.0)


def absmax_slots(per_sample: int) -> int:
    """Blocks (slots) of `int8_absmax` per sample: one per 4096 elements, at
    most 128."""
    return max(1, min(128, -(-per_sample // 4096)))


def slot_spans(per_sample: int, slots: int):
    """The element span [lo, hi) of each slot of a sample, as the kernel cuts it."""
    return [(per_sample * s // slots, per_sample * (s + 1) // slots) for s in range(slots)]


def plain_int8_absmax(x: torch.Tensor, slots: int) -> torch.Tensor:
    """`int8_absmax`'s partial maxima (N, slots) float32: max|x| over each
    slot's span of each sample (0 for an empty span)."""
    N = x.shape[0]
    flat = x.detach().reshape(N, -1).to(torch.float32).abs()
    cols = [flat[:, lo:hi].amax(dim=1) if hi > lo else flat.new_zeros(N)
            for lo, hi in slot_spans(flat.shape[1], slots)]
    return torch.stack(cols, dim=1)


class Plan(NamedTuple):
    """How `int8_conv_fused` covers a site: an N tile of tile_n channels,
    tiles_m x tiles_n output tiles, `steps` K stages of K_STAGE bytes, each
    tile's stages split over `splits` blocks of a cluster."""

    tile_n: int
    tiles_m: int
    tiles_n: int
    steps: int
    splits: int


def blocks_per_sm(dtype: torch.dtype, mode: str) -> int:
    """Block slots an SM offers the split planner: two in the patch and
    gather modes and with bf16 x in the vec mode, else one (the vec mode's
    raw ring holds 16 KB a stage in bf16, 32 KB in float32). A patch block
    may share its SM with two others (its launch bounds), but every rank of
    a split refills the whole patch: on the card the 30x30 3x3 sites ran
    0.028 ms at 2 ranks and 0.043 at 3."""
    return 2 if mode != "vec" or dtype == torch.bfloat16 else 1


def patch_tile(Wo: int):
    """(TW, TR): a patch-mode block's tile, TW columns x TR output rows: 64
    columns of one row on maps at least 64 wide, else 64 // Wo whole rows."""
    return (TILE_M, 1) if Wo >= TILE_M else (Wo, TILE_M // Wo)


def patch_bytes(C: int, kh: int, kw: int, stride: int, Wo: int) -> int:
    """Bytes of a patch-mode block's quantized input patch: ((TR - 1)
    stride + kh) rows x ((TW - 1) stride + kw) columns x C."""
    TW, TR = patch_tile(Wo)
    return ((TR - 1) * stride + kh) * ((TW - 1) * stride + kw) * C


def a_mode(C: int, kh: int, kw: int, stride: int, Wo: int, aligned: bool = True) -> str:
    """The A producer's mode of a site (MODES): the patch where it and its
    tap table fit and the site is a 3x3 or 7x7 (each input quantized about
    kh times where the vec mode quantizes it kh kw times) or C % 16 != 0
    (the stems); else "vec" where C % 16 == 0 and x is aligned; else
    "gather"."""
    vec = C % 16 == 0 and aligned
    fits = kh * kw * C <= PATCH_K and patch_bytes(C, kh, kw, stride, Wo) <= PATCH_BYTES
    if fits and (kh * kw > 1 or not vec):
        return "patch"
    return "vec" if vec else "gather"


def plan(M: int, O: int, Kp: int, sms: int, per_sm: int, tiles_m: Optional[int] = None) -> Plan:
    """The N tile and the split of K for M output pixels (in tiles_m tiles of
    TILE_M, by default ceil(M / TILE_M); the patch mode's by `patch_tile`),
    O channels and a packed K of Kp: no split where the tiles fill the
    card's block slots (sms x per_sm); else as many ranks as leave no slot
    idle, at most MAX_SPLITS and at most one per K stage."""
    tile_n = TILE_N[0] if O <= TILE_N[0] else TILE_N[1]
    tiles_m = -(-M // TILE_M) if tiles_m is None else tiles_m
    tiles_n, steps = -(-O // tile_n), -(-Kp // K_STAGE)
    splits = max(1, min(MAX_SPLITS, steps, (sms * per_sm) // (tiles_m * tiles_n)))
    return Plan(tile_n, tiles_m, tiles_n, steps, splits)


def split_ranges(steps: int, splits: int):
    """The K stages [begin, end) of each rank, as the kernel cuts them."""
    return [(steps * r // splits, steps * (r + 1) // splits) for r in range(splits)]


def site_plan(x: torch.Tensor, qw: QuantWeight, stride: int, pad: int, mode: Optional[str] = None):
    """(mode, Plan) of `int8_conv_fused` at a site on the card: the A
    producer's mode (`a_mode`, unless given) and the plan."""
    N, H, W, C = x.shape
    Ho, Wo = out_size(H, qw.kh, stride, pad), out_size(W, qw.kw, stride, pad)
    mode = a_mode(C, qw.kh, qw.kw, stride, Wo, x.data_ptr() % 16 == 0) if mode is None else mode
    TW, TR = patch_tile(Wo)
    p = plan(N * Ho * Wo, qw.q.shape[0], qw.q.shape[1], _sm_count(x.device), blocks_per_sm(x.dtype, mode),
             N * -(-Ho // TR) * -(-Wo // TW) if mode == "patch" else None)
    return mode, p


def plain_int8_site(x: torch.Tensor, qw: QuantWeight, a_max: Optional[float], groups: int,
                    bias: Optional[torch.Tensor], stride: int, pad: int, return_acc: bool = False):
    """The whole site in plain PyTorch (module docstring): the activation's
    scale and quantization as the sites define them
    (`models/layers.py:activation_scale`, `activation_quant`), then
    `plain_int8_conv`; out in x's dtype."""
    from sgtapose_tpu_torch.models import layers

    a_scale = layers.activation_scale(x, a_max, groups)
    x_q = layers.activation_quant(x, a_scale).to(torch.int8)
    return plain_int8_conv(x_q, qw, a_scale, bias, stride, pad, x.dtype, return_acc)


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def _check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be (N,H,W,C) float32 or bf16, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC (an NCHW activation in channels_last memory)")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernels' 32-bit indices")


def int8_absmax_cuda(x: torch.Tensor, slots: Optional[int] = None) -> torch.Tensor:
    """Launch `int8_absmax` (csrc/int8_conv_fused.cu): the partial maxima
    (N, slots) float32 of |x| (`plain_int8_absmax`)."""
    _check_cuda(x)
    N = x.shape[0]
    per_sample = x.numel() // N
    slots = absmax_slots(per_sample) if slots is None else slots
    partial = torch.empty((N, slots), dtype=torch.float32, device=x.device)
    fn = build.kernel_fn(KERNEL_ABSMAX)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), partial.data_ptr(), N, per_sample, slots, int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
    build.check(KERNEL_ABSMAX, err)
    build.count_launch(KERNEL_ABSMAX)
    return partial


def int8_site_cuda(x: torch.Tensor, qw: QuantWeight, a_max: Optional[float], groups: int,
                   bias: Optional[torch.Tensor], stride: int, pad: int, return_acc: bool = False,
                   splits: Optional[int] = None, mode: Optional[str] = None):
    """Launch the site on the current stream (CUDA tensors): `int8_absmax`
    then `int8_conv_fused` with a dynamic scale, `int8_conv_fused` alone
    with a static one. `splits` and `mode` override the plan's choices (the
    card tests hold every split and A producer to the same bits)."""
    _check_cuda(x)
    N, H, W, C = x.shape
    O, Kp = qw.q.shape
    if qw.c != C or Kp % K_STEP or Kp < qw.kh * qw.kw * C:
        raise ValueError(f"weight (O={O}, {qw.kh}x{qw.kw}x{qw.c}, Kp={Kp}) does not fit x {tuple(x.shape)}")
    if groups < 1 or N % groups or (a_max is None and groups > MAX_VIDEOS):
        raise ValueError(f"groups {groups} must divide the batch {N} and be at most {MAX_VIDEOS}")
    checks = [("w", qw.q, torch.int8, (O, Kp)), ("w_scale", qw.scale, torch.float32, (O,))]
    if bias is not None:
        checks.append(("bias", bias, x.dtype, (O,)))
    for label, t, dtype, shape in checks:
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous {dtype} {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    Ho, Wo = out_size(H, qw.kh, stride, pad), out_size(W, qw.kw, stride, pad)
    if N * Ho * Wo * O >= 2 ** 31:
        raise ValueError(f"x {tuple(x.shape)} with O={O} exceeds the kernels' 32-bit indices")
    mode, p = site_plan(x, qw, stride, pad, mode)
    if splits is not None:
        if not 1 <= splits <= min(MAX_SPLITS, p.steps):
            raise ValueError(f"splits must be in 1..{min(MAX_SPLITS, p.steps)}, got {splits}")
        p = p._replace(splits=splits)
    out = torch.empty((N, Ho, Wo, O), dtype=x.dtype, device=x.device)
    acc = torch.empty((N, Ho, Wo, O), dtype=torch.int32, device=x.device) if return_acc else None
    partial, slots, a_static = None, 0, 0.0
    if a_max is None:
        partial = int8_absmax_cuda(x)
        slots = partial.shape[1]
    else:
        a_static = max(a_max, 1e-12) / 127.0  # rounded to float32 by the C call
    fn = build.kernel_fn(KERNEL_FUSED)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), qw.q.data_ptr(), qw.scale.data_ptr(), None if partial is None else partial.data_ptr(),
                 slots, groups, a_static, None if bias is None else bias.data_ptr(), out.data_ptr(),
                 None if acc is None else acc.data_ptr(), N, H, W, C, O, qw.kh, qw.kw, stride, pad, Ho, Wo, Kp,
                 int(x.dtype == torch.bfloat16), p.tile_n, MODES[mode], p.splits,
                 torch.cuda.current_stream().cuda_stream)
    build.check(KERNEL_FUSED, err)
    build.count_launch(KERNEL_FUSED)
    return (out, acc) if return_acc else out


def int8_site(x: torch.Tensor, qw: QuantWeight, a_max: Optional[float], groups: int, bias: Optional[torch.Tensor],
              stride: int, pad: int, return_acc: bool = False):
    """One int8 site (module docstring): CUDA tensors through the kernels
    (or raise), CPU tensors through `plain_int8_site`."""
    if x.device.type == "cpu":
        return plain_int8_site(x, qw, a_max, groups, bias, stride, pad, return_acc)
    return int8_site_cuda(x, qw, a_max, groups, bias, stride, pad, return_acc)
