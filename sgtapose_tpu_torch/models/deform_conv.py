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
`deform_conv` is a `torch.autograd.Function`, differentiable in float32
and in bf16 (bf16 training). Its backward, the counterpart of the JAX custom VJP
`_dsb_bwd` / `_bwd_core` plus the 1x1 contraction's gradient that XLA
derives: the data gradients (dx and the gradient of the raw offset/mask conv
output) in one kernel, `csrc/deform_conv_bwd.cu` (`deform_conv_dgrad`: the
columns' cotangent dY W formed on the tensor cores and added into dx through
a shared-memory halo tile, never written to device memory); the weight
gradient in another, `csrc/deform_conv_wgrad.cu` (`deform_conv_wgrad`: dY^T
A as an implicit GEMM on the tensor cores, the columns A sampled into
shared memory and never written to device memory, the pixels split over
blocks whose partials a second launch adds in a fixed order); the bias
gradient a plain sum. The unfused routes stay as wrappers the card is timed
against, and the backward launches neither: for the data gradient the
product dY W then `csrc/deform_sample_bwd.cu`; for the weight gradient the
sampler `csrc/deform_sample.cu` then `torch.matmul`. CPU tensors take the
plain versions (the sampler mirrors the JAX `_sample_pieces`, its backward
`_bwd_core`; `tiled_deform_scatter` mirrors the data-gradient kernel's halo
split, `plain_deform_conv_wgrad` the weight-gradient kernel's split of the
pixels).

int8 serving and quantization-aware training (`models/layers.py`) contract
the sampled columns through the quantizable site instead of the fused
kernel: `deform_columns` launches the sampler (`deform_sample` /
`deform_sample_bf16`) forward and the sampling backward of x's dtype
(`deform_sample_bwd` / `deform_sample_bwd_bf16`), which share a lane layout
(`csrc/dcn_columns.cuh`). The designs they replaced stay as yardsticks on
no path (`deform_sample_flat_cuda`, `deform_sample_bwd_warp_cuda`).

`dcn_chunks` (`DeformConv2d(chunks=)`, JAX's `deform_sample_batch_chunked`)
forms the columns, their backward and the weight gradient's columns in row
slabs of `pick_chunks(H, chunks)` where the port forms them with plain ops
(CPU tensors), global rows kept (JAX's `_sample_pieces` row offset): the same
numbers, the (B,H,W,9,C) corner temps cut by the slab count. The kernels
hold no such temps, so on the card chunks changes nothing.

bf16 backward: dx and d(om) from the bf16 data-gradient kernel
`deform_conv_dgrad_bf16` (`csrc/deform_conv_dgrad_bf16.cu`: dY W per 8x8
pixel tile and 64-channel chunk on bf16 tensor cores with float32
accumulators, scattered from shared memory with float4 atomics into float32
sums, each output rounded once to bf16; the float32 kernel's bf16
instantiation it replaced stays as the yardstick `deform_conv_dgrad_halo_cuda`,
on no path); dW = dY^T A from the bf16
instantiation of the weight-gradient kernel (float32 coordinates and masks,
each column element formed in float32 and rounded once, as the fused
forward and the bf16 sampler form them; bf16 tensor cores with float32
accumulators, dW rounded once); db = dY summed in float32, rounded once. The plain bf16
forms compute in float32 from the bf16 inputs and round each output once.
The JAX module under bf16 parameters rounds inside `_bwd_core` after every
product and sum instead (the same bounded deviation as the forward's).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from sgtapose_tpu_torch.models import layers
from sgtapose_tpu_torch.ops import build

KERNEL = "deform_sample"
CONV_KERNEL = "deform_conv"
CONV_KERNEL_BF16 = "deform_conv_bf16"
BWD_KERNEL = "deform_sample_bwd"
DGRAD_KERNEL = "deform_conv_dgrad"
KERNEL_BF16 = "deform_sample_bf16"
DGRAD_KERNEL_BF16 = "deform_conv_dgrad_bf16"
WGRAD_KERNEL = "deform_conv_wgrad"
WGRAD_KERNEL_BF16 = "deform_conv_wgrad_bf16"
BWD_KERNEL_BF16 = "deform_sample_bwd_bf16"
# the designs the columns' kernels replaced, their yardsticks on no path:
# the flat sampler (one thread per 4 channels of a (pixel, tap)) and the
# warp-per-item backward (one warp per (pixel, tap), scalar atomics)
KERNEL_FLAT = "deform_sample_flat"
KERNEL_FLAT_BF16 = "deform_sample_flat_bf16"
BWD_KERNEL_WARP = "deform_sample_bwd_warp"
# the design bf16 training's data gradient replaced (the float32 kernel's
# bf16 instantiation: a halo tile of x, a weight layout launch), its
# yardstick on no path
DGRAD_KERNEL_HALO_BF16 = "deform_conv_dgrad_halo_bf16"
# the weight-gradient kernel's output and channel tile, and the blocks an SM
# holds at once (csrc/deform_conv_wgrad.cu: BO, BC; 128 registers a thread)
WGRAD_TILE, WGRAD_BLOCKS_PER_SM = 64, 2
# the data-gradient kernel's pixel tile side and the offsets its shared-memory
# halo tile covers (csrc/deform_conv_bwd.cu: T, HALO)
DGRAD_TILE, DGRAD_HALO = 8, 3


def dgrad_scratch_floats(C: int, O: int, bf16: bool = False) -> int:
    """32-bit words of the float32 data-gradient kernel's pre-tiled weight
    (and of its bf16 instantiation, the yardstick `deform_conv_dgrad_halo_cuda`):
    float32, a tf32 hi and lo plane of 9 x 16 channels x 32 outputs (4608
    words each) per 16-channel chunk and 32-output step; bf16, one plane of
    9 x 16 channels x 64 outputs (4608 words) per chunk and 64-output step
    (csrc/deform_conv_bwd.cu: CC, bk, B_TILE)."""
    if bf16:
        return -(-C // 16) * -(-O // 64) * 4608
    return -(-C // 16) * -(-O // 32) * 2 * 4608


def pick_chunks(H: int, chunks: int) -> int:
    """The row slabs of `dcn_chunks`: the largest divisor of H that is <=
    chunks (JAX's `_pick_chunks`), so the slabs tile H exactly."""
    for s in range(min(chunks, H), 0, -1):
        if H % s == 0:
            return s
    return 1


def _tap_grid(B: int, r0: int, Hs: int, W: int, offsets: torch.Tensor):
    """Sample coordinates of output rows r0 .. r0 + Hs - 1 (JAX's
    `_sample_pieces`: global rows, so slabs concatenate to the whole map):
    (y0i, x0i, fy, fx), each (B, Hs, W, 9)."""
    dev = offsets.device
    gy = torch.arange(r0, r0 + Hs, dtype=torch.float32, device=dev)[:, None, None]
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, :, None]
    taps = torch.arange(9, device=dev)
    ky = (taps // 3 - 1).to(torch.float32)[None, None, :]
    kx = (taps % 3 - 1).to(torch.float32)[None, None, :]
    off = offsets.reshape(B, Hs, W, 9, 2)
    y = (gy + ky)[None] + off[..., 0]  # (B,Hs,W,9)
    x = (gx + kx)[None] + off[..., 1]
    y0, x0 = torch.floor(y), torch.floor(x)
    return y0.to(torch.int64), x0.to(torch.int64), y - y0, x - x0


def _corners(y0i, x0i, fy, fx, H: int, W: int):
    """The 4 bilinear corners: (flat index into the map (clamped), the
    weight with validity folded in, d(weight)/dy and d(weight)/dx before
    validity, validity), each (B, Hs, W, 9)."""
    out = []
    for dy, dx, w, cy, cx in ((0, 0, (1 - fy) * (1 - fx), -(1 - fx), -(1 - fy)),
                              (0, 1, (1 - fy) * fx, -fx, 1 - fy),
                              (1, 0, fy * (1 - fx), 1 - fx, -fy),
                              (1, 1, fy * fx, fx, fy)):
        yi, xi = y0i + dy, x0i + dx
        valid = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)).to(torch.float32)
        out.append((yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1), w * valid, cy, cx, valid))
    return out


def _gather(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat (B, H*W, C) at idx (B, Hs, W, 9) -> (B, Hs, W, 9, C)."""
    B, C = flat.shape[0], flat.shape[-1]
    return torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C)).reshape(idx.shape + (C,))


def plain_deform_sample(feat: torch.Tensor, offsets: torch.Tensor, masks: torch.Tensor,
                        chunks: int = 1) -> torch.Tensor:
    """feat (B,H,W,C), offsets (B,H,W,18) as (dy, dx) per tap, masks (B,H,W,9)
    already sigmoided -> (B,H,W,9*C). Zero padding outside the map. A bf16
    feat (the bf16 sampler's form: offsets and masks float32) is sampled in
    float32 and each output element rounded once to bf16. chunks > 1 forms
    the output in `pick_chunks(H, chunks)` row slabs (`dcn_chunks`): the
    (B,Hs,W,9,C) corner temps shrink by the slab count, every number is the
    same."""
    if feat.dtype == torch.bfloat16:
        return plain_deform_sample(feat.to(torch.float32), offsets, masks, chunks).to(torch.bfloat16)
    B, H, W, C = feat.shape
    S = pick_chunks(H, chunks)
    Hs = H // S
    flat = feat.reshape(B, H * W, C)
    slabs = []
    for r0 in range(0, H, Hs):
        rows = slice(r0, r0 + Hs)
        out = None
        for idx, w, _, _, _ in _corners(*_tap_grid(B, r0, Hs, W, offsets[:, rows]), H, W):
            term = _gather(flat, idx) * w[..., None]
            out = term if out is None else out + term
        slabs.append((out * masks[:, rows, ..., None]).reshape(B, Hs, W, 9 * C))
    return slabs[0] if S == 1 else torch.cat(slabs, dim=1)


def _launch_sampler(names, feat: torch.Tensor, offsets: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Launch the sampling kernel names[0] (float32 feat) or names[1] (bf16
    feat) on the current stream (CUDA tensors, offsets and masks float32)."""
    if feat.dim() != 4:
        raise ValueError(f"feat must be (B,H,W,C), got {tuple(feat.shape)}")
    B, H, W, C = feat.shape
    if tuple(offsets.shape) != (B, H, W, 18) or tuple(masks.shape) != (B, H, W, 9):
        raise ValueError(
            f"offsets/masks must be (B,H,W,18)/(B,H,W,9) for feat {tuple(feat.shape)}, "
            f"got {tuple(offsets.shape)}/{tuple(masks.shape)}")
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feat must be float32 or bf16, got {feat.dtype}")
    name = names[feat.dtype == torch.bfloat16]
    for label, t, dtype in (("feat", feat, feat.dtype), ("offsets", offsets, torch.float32),
                            ("masks", masks, torch.float32)):
        if t.device.type != "cuda" or t.device != feat.device:
            raise ValueError(f"{label} must be a CUDA tensor on {feat.device}, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{label} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    out = torch.empty((B, H, W, 9 * C), dtype=feat.dtype, device=feat.device)
    fn = build.kernel_fn(name)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(feat.data_ptr(), offsets.data_ptr(), masks.data_ptr(), out.data_ptr(),
                 B, H, W, C, stream)
    build.check(name, err)
    build.count_launch(name)
    return out


def deform_sample_cuda(feat: torch.Tensor, offsets: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA sampling kernel of feat's dtype on the current stream
    (CUDA tensors): float32, or bf16 feat and out with float32 offsets and
    masks."""
    return _launch_sampler((KERNEL, KERNEL_BF16), feat, offsets, masks)


def deform_sample_flat_cuda(feat: torch.Tensor, offsets: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """`deform_sample_cuda` through the flat design the samplers replaced,
    their yardstick on no path."""
    return _launch_sampler((KERNEL_FLAT, KERNEL_FLAT_BF16), feat, offsets, masks)


def wgrad_step_pixels(dtype: torch.dtype) -> int:
    """Pixels per K step of the weight-gradient kernel: one 128-byte chunk
    row, 32 float32 or 64 bf16 elements."""
    return 64 if dtype == torch.bfloat16 else 32


def wgrad_splits(M: int, C: int, O: int, dtype: torch.dtype, sms: int) -> int:
    """The weight-gradient kernel's split of the M pixels into contiguous
    ranges of whole K steps, for the (O / 64) x 9 x (C / 64) tiles on `sms`
    SMs at WGRAD_BLOCKS_PER_SM blocks each: the fewest splits whose waves of
    blocks per unit of work, ceil(tiles x splits / slots) / splits, come
    within 5 % of the least, at most 64 splits and none shorter than 8
    steps."""
    steps = -(-M // wgrad_step_pixels(dtype))
    tiles = -(-O // WGRAD_TILE) * 9 * -(-C // WGRAD_TILE)
    slots = WGRAD_BLOCKS_PER_SM * sms
    cost = {s: -(-tiles * s // slots) / s for s in range(1, max(1, min(64, steps // 8)) + 1)}
    best = min(cost.values())
    return min(s for s, c in cost.items() if c <= 1.05 * best)


def plain_deform_conv_wgrad(feat: torch.Tensor, offsets: torch.Tensor, masks: torch.Tensor,
                            dy: torch.Tensor, splits: int = 1, chunks: int = 1) -> torch.Tensor:
    """The weight gradient dW (O, 9C) = sum over pixels of dy[p, o] A[p, k*C +
    c] of the columns A = `plain_deform_sample(feat, offsets, masks)`, in the
    kernel's order: the pixels cut into `splits` contiguous ranges of whole K
    steps (`wgrad_step_pixels`), a float32 product per range, the ranges'
    sums added in order. bf16 feat and dy (the bf16 kernel's form; offsets
    and masks float32): A rounded once to bf16, the products and sums in
    float32, dW rounded once. chunks: the columns' row slabs
    (`plain_deform_sample`)."""
    B, H, W, C = feat.shape
    O = dy.shape[-1]
    M = B * H * W
    f32 = torch.float32
    cols = plain_deform_sample(feat, offsets, masks, chunks).reshape(M, 9 * C).to(f32)
    dy2 = dy.reshape(M, O).to(f32)
    kp = wgrad_step_pixels(feat.dtype)
    steps = -(-M // kp)
    dw = None
    for r in range(splits):
        lo, hi = steps * r // splits * kp, min(M, steps * (r + 1) // splits * kp)
        part = dy2[lo:hi].t() @ cols[lo:hi]
        dw = part if dw is None else dw + part
    return dw.to(feat.dtype)


def deform_conv_wgrad_cuda(feat: torch.Tensor, offsets: torch.Tensor, masks: torch.Tensor,
                           dy: torch.Tensor) -> torch.Tensor:
    """Launch the weight-gradient kernel of feat's dtype (float32, or bf16
    feat and dy with float32 offsets and masks) on the current stream (CUDA
    tensors): dW (O, 9C) of `plain_deform_conv_wgrad` at the split count
    `wgrad_splits` picks for the card, in feat's dtype."""
    if feat.dim() != 4 or dy.dim() != 4:
        raise ValueError(f"feat and dy must be (B,H,W,C) and (B,H,W,O), got {tuple(feat.shape)}, {tuple(dy.shape)}")
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feat must be float32 or bf16, got {feat.dtype}")
    B, H, W, C = feat.shape
    O = dy.shape[-1]
    expect = {"offsets": (B, H, W, 18), "masks": (B, H, W, 9), "dy": (B, H, W, O)}
    for label, t, dtype in (("feat", feat, feat.dtype), ("offsets", offsets, torch.float32),
                            ("masks", masks, torch.float32), ("dy", dy, feat.dtype)):
        if label in expect and tuple(t.shape) != expect[label]:
            raise ValueError(f"{label} must be {expect[label]} for feat {tuple(feat.shape)}, got {tuple(t.shape)}")
        if t.device.type != "cuda" or t.device != feat.device:
            raise ValueError(f"{label} must be a CUDA tensor on {feat.device}, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{label} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    M = B * H * W
    sms = torch.cuda.get_device_properties(feat.device).multi_processor_count
    splits = wgrad_splits(M, C, O, feat.dtype, sms)
    if M * max(C, O) >= 2 ** 31 or splits * O * 9 * C >= 2 ** 31:
        raise ValueError(f"feat {tuple(feat.shape)} with O={O} exceeds the kernel's 32-bit offsets")
    name = WGRAD_KERNEL_BF16 if feat.dtype == torch.bfloat16 else WGRAD_KERNEL
    part = torch.empty((splits, O, 9 * C), dtype=torch.float32, device=feat.device)
    dw = torch.empty((O, 9 * C), dtype=feat.dtype, device=feat.device)
    fn = build.kernel_fn(name)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(feat.data_ptr(), offsets.data_ptr(), masks.data_ptr(), dy.data_ptr(), part.data_ptr(),
                 dw.data_ptr(), B, H, W, C, O, splits, stream)
    build.check(name, err)
    build.count_launch(name)
    return dw


def plain_deform_sample_backward(feat: torch.Tensor, offsets: torch.Tensor, masks: torch.Tensor,
                                 grad: torch.Tensor, chunks: int = 1):
    """A mirror of the JAX `_bwd_core`: the gradients (dfeat (B,H,W,C),
    doffsets (B,H,W,18), dmask (B,H,W,9)) of `plain_deform_sample` given
    grad (B,H,W,9C), with validity folded into the bilinear weights and
    their derivatives. chunks > 1 works in row slabs (`dcn_chunks`), with
    the same numbers: doffsets and dmask are per output pixel, and dfeat's
    additions reach each of its elements in the same order (corner by
    corner, output rows in order; the slabs of one corner add in row order,
    and different images never add into the same element)."""
    B, H, W, C = feat.shape
    S = pick_chunks(H, chunks)
    Hs = H // S
    flat = feat.reshape(B, H * W, C)
    batch_base = (torch.arange(B, device=feat.device) * (H * W))[:, None]

    def slab(r0):
        rows = slice(r0, r0 + Hs)
        g9 = grad[:, rows].reshape(B, Hs, W, 9, C)
        dsamp = g9 * masks[:, rows, ..., None]
        return g9, dsamp, _corners(*_tap_grid(B, r0, Hs, W, offsets[:, rows]), H, W)

    doffsets, dmask = [], []
    for r0 in range(0, H, Hs):
        g9, dsamp, corners = whole = slab(r0)
        samp = dval_dy = dval_dx = 0.0
        for idx, wv, cy, cx, valid in corners:
            vals = _gather(flat, idx)
            samp = samp + vals * wv[..., None]
            dval_dy = dval_dy + vals * (cy * valid)[..., None]
            dval_dx = dval_dx + vals * (cx * valid)[..., None]
        dmask.append((samp * g9).sum(-1))
        doffsets.append(torch.stack([(dsamp * dval_dy).sum(-1), (dsamp * dval_dx).sum(-1)], dim=-1)
                        .reshape(B, Hs, W, 18))
    dfeat = torch.zeros(B * H * W, C, dtype=feat.dtype, device=feat.device)
    for corner in range(4):
        for r0 in range(0, H, Hs):
            # one slab is the whole map: nothing to recompute
            _, dsamp, corners = whole if S == 1 else slab(r0)
            idx, wv = corners[corner][:2]
            dfeat.index_add_(0, (idx.reshape(B, -1) + batch_base).reshape(-1), (dsamp * wv[..., None]).reshape(-1, C))
    return dfeat.reshape(B, H, W, C), torch.cat(doffsets, dim=1), torch.cat(dmask, dim=1)


def plain_deform_sample_bwd(feat: torch.Tensor, offsets: torch.Tensor, masks: torch.Tensor,
                            grad: torch.Tensor, chunks: int = 1):
    """The sampling backward in the kernels' form: (dfeat (B,H,W,C), dom
    (B,H,W,27)) in feat's dtype, dom the gradient of the raw offset/mask conv
    output whose last 9 channels' sigmoid is `masks`. bf16 feat and grad
    (offsets and masks float32): the float32 formulas from the widened
    inputs, each output rounded once to bf16. chunks: row slabs."""
    f32 = torch.float32
    dfeat, doffsets, dmask = plain_deform_sample_backward(feat.to(f32), offsets, masks, grad.to(f32), chunks)
    dom = torch.cat([doffsets, dmask * masks * (1 - masks)], dim=-1)
    return dfeat.to(feat.dtype), dom.to(feat.dtype)


def _launch_sample_bwd(name: str, feat: torch.Tensor, offsets: torch.Tensor, masks: torch.Tensor,
                       grad: torch.Tensor):
    """Launch the sampling backward `name` on the current stream (CUDA
    tensors; feat and grad of one dtype, offsets and masks float32)."""
    if feat.dim() != 4:
        raise ValueError(f"feat must be (B,H,W,C), got {tuple(feat.shape)}")
    B, H, W, C = feat.shape
    expect = {"offsets": (B, H, W, 18), "masks": (B, H, W, 9), "grad": (B, H, W, 9 * C)}
    for label, t, dtype in (("feat", feat, feat.dtype), ("offsets", offsets, torch.float32),
                            ("masks", masks, torch.float32), ("grad", grad, feat.dtype)):
        if label in expect and tuple(t.shape) != expect[label]:
            raise ValueError(f"{label} must be {expect[label]} for feat {tuple(feat.shape)}, got {tuple(t.shape)}")
        if t.device.type != "cuda" or t.device != feat.device:
            raise ValueError(f"{label} must be a CUDA tensor on {feat.device}, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{label} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    bf16 = feat.dtype == torch.bfloat16
    dom = torch.empty((B, H, W, 27), dtype=feat.dtype, device=feat.device)
    # the scatter adds into dfeat (float32), or, in bf16, into float32 sums
    # the launch rounds once into dx
    dfeat = torch.empty_like(feat) if bf16 else torch.zeros_like(feat)
    sums = [torch.zeros(feat.shape, dtype=torch.float32, device=feat.device)] if bf16 else []
    fn = build.kernel_fn(name)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in [feat, offsets, masks, grad] + sums + [dfeat, dom]), B, H, W, C, stream)
    build.check(name, err)
    build.count_launch(name)
    return dfeat, dom


def deform_sample_bwd_cuda(feat: torch.Tensor, offsets: torch.Tensor, masks: torch.Tensor,
                           grad: torch.Tensor):
    """Launch the CUDA sampling backward of feat's dtype on the current stream
    (CUDA tensors): (dfeat (B,H,W,C), dom (B,H,W,27)) of
    `plain_deform_sample_bwd`, in feat's dtype: float32, or bf16 feat and
    grad with float32 offsets and masks (bf16 dx and dom, each rounded once
    from float32)."""
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feat must be float32 or bf16, got {feat.dtype}")
    return _launch_sample_bwd(BWD_KERNEL_BF16 if feat.dtype == torch.bfloat16 else BWD_KERNEL,
                              feat, offsets, masks, grad)


def deform_sample_bwd_warp_cuda(feat: torch.Tensor, offsets: torch.Tensor, masks: torch.Tensor,
                                grad: torch.Tensor):
    """`deform_sample_bwd_cuda` in float32 through the warp-per-item kernel
    it replaced, its yardstick on no path."""
    if feat.dtype != torch.float32:
        raise ValueError(f"feat must be float32, got {feat.dtype}")
    return _launch_sample_bwd(BWD_KERNEL_WARP, feat, offsets, masks, grad)


def deform_sample(feat: torch.Tensor, offsets: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """9-tap modulated deformable sampling (see module docstring). CUDA
    tensors go through the kernel (or raise); CPU tensors take the plain
    version."""
    if feat.device.type == "cpu":
        return plain_deform_sample(feat, offsets, masks)
    return deform_sample_cuda(feat, offsets, masks)


def sample_inputs(om: torch.Tensor):
    """(offsets (B,H,W,18), masks (B,H,W,9)) of the raw offset/mask conv
    output, in float32 (a bf16 om widened exactly, the mask sigmoid taken in
    float32, as the bf16 kernels form them)."""
    f32 = torch.float32
    return om[..., :18].to(f32).contiguous(), torch.sigmoid(om[..., 18:27].to(f32)).contiguous()


def plain_deform_conv(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, chunks: int = 1) -> torch.Tensor:
    """x (B,H,W,C), om (B,H,W,27) the raw offset/mask conv output, weight
    (O, 9C) with input index k*C + c, bias (O,) -> (B,H,W,O). bf16 inputs
    follow the bf16 kernel: the sampled columns formed in float32 and rounded
    once to bf16, the product and bias in float32, rounded once. chunks: the
    columns' row slabs (`plain_deform_sample`)."""
    if x.dtype == torch.bfloat16:
        f32, bf16 = torch.float32, torch.bfloat16
        flat = plain_deform_sample(x.to(f32), *sample_inputs(om), chunks).to(bf16)
        return torch.nn.functional.linear(flat.to(f32), weight.to(f32), bias.to(f32)).to(bf16)
    flat = plain_deform_sample(x, om[..., :18], torch.sigmoid(om[..., 18:27]), chunks)
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


def plain_deform_conv_dgrad(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor,
                            dy: torch.Tensor, chunks: int = 1):
    """The data gradients (dx (B,H,W,C), dom (B,H,W,27)) of `plain_deform_conv`
    given dy (B,H,W,O): the columns' cotangent dy W, the sampling backward,
    and the mask logits' sigmoid derivative. bf16 inputs (the bf16 kernel's
    form): the float32 formulas from the widened inputs, dx and dom rounded
    once to bf16. chunks: the sampling backward's row slabs."""
    if x.dtype == torch.bfloat16:
        f32 = torch.float32
        dx, dom = plain_deform_conv_dgrad(x.to(f32), om.to(f32), weight.to(f32), dy.to(f32), chunks)
        return dx.to(torch.bfloat16), dom.to(torch.bfloat16)
    B, H, W, C = x.shape
    masks = torch.sigmoid(om[..., 18:27])
    dcols = (dy.reshape(-1, weight.shape[0]) @ weight).reshape(B, H, W, 9 * C)
    dx, doffsets, dmask = plain_deform_sample_backward(x, om[..., :18], masks, dcols, chunks)
    return dx, torch.cat([doffsets, dmask * masks * (1 - masks)], dim=-1)


def _launch_dgrad(name: str, x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                  wsplit: bool):
    """Launch the data-gradient kernel `name` on the current stream: (dx,
    dom) in x's dtype, after checking that x (B,H,W,C), om (B,H,W,27), weight
    (O, 9C) and dy (B,H,W,O) are contiguous CUDA tensors of x's dtype on one
    device within the kernels' 32-bit indices. The scatter adds into dx
    (float32), or, in bf16, into float32 sums the launch rounds once into
    dx; wsplit: the float32 design's pre-tiled weight scratch goes before
    dy."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B,H,W,C), got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if weight.dim() != 2 or weight.shape[1] != 9 * C:
        raise ValueError(f"weight must be (O, 9*C) = (O, {9 * C}), got {tuple(weight.shape)}")
    O = weight.shape[0]
    expect = {"om": (B, H, W, 27), "dy": (B, H, W, O)}
    for label, t in (("x", x), ("om", om), ("weight", weight), ("dy", dy)):
        if label in expect and tuple(t.shape) != expect[label]:
            raise ValueError(f"{label} must be {expect[label]} for x {tuple(x.shape)}, got {tuple(t.shape)}")
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{label} must be a CUDA tensor on {x.device}, got {t.device}")
        if t.dtype != x.dtype:
            raise ValueError(f"{label} must be {x.dtype} like x, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    if B * H * W >= 2 ** 31 or O * 9 * C >= 2 ** 31:
        raise ValueError(f"x {tuple(x.shape)} with O={O} exceeds the kernel's 32-bit indices")
    bf16 = x.dtype == torch.bfloat16
    dom = torch.empty((B, H, W, 27), dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x) if bf16 else torch.zeros_like(x)
    sums = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)] if bf16 else []
    scratch = [torch.empty(dgrad_scratch_floats(C, O, bf16), dtype=torch.float32, device=x.device)] if wsplit else []
    fn = build.kernel_fn(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in [x, om, weight] + scratch + [dy] + sums + [dx, dom]), B, H, W, C, O, stream)
    build.check(name, err)
    build.count_launch(name)
    return dx, dom


def deform_conv_dgrad_cuda(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor,
                           dy: torch.Tensor):
    """Launch the fused data-gradient kernel of x's dtype (float32 or bf16;
    all four tensors share it) on the current stream (CUDA tensors): (dx,
    dom) of `plain_deform_conv_dgrad`, in x's dtype. float32:
    `deform_conv_dgrad` (csrc/deform_conv_bwd.cu); bf16:
    `deform_conv_dgrad_bf16` (csrc/deform_conv_dgrad_bf16.cu, dcols = dY W on
    bf16 tensor cores and scattered from shared memory with float4
    atomics)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bf16, got {x.dtype}")
    if x.dtype == torch.bfloat16:
        return _launch_dgrad(DGRAD_KERNEL_BF16, x, om, weight, dy, wsplit=False)
    return _launch_dgrad(DGRAD_KERNEL, x, om, weight, dy, wsplit=True)


def deform_conv_dgrad_halo_cuda(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor,
                                dy: torch.Tensor):
    """`deform_conv_dgrad_cuda` in bf16 through the design it replaced (the
    float32 kernel's bf16 instantiation, with its weight layout launch and
    its halo tile of x), the yardstick on no path."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bf16, got {x.dtype}")
    return _launch_dgrad(DGRAD_KERNEL_HALO_BF16, x, om, weight, dy, wsplit=True)


def tiled_deform_scatter(feat: torch.Tensor, offsets: torch.Tensor, masks: torch.Tensor,
                         grad: torch.Tensor, tile: int = DGRAD_TILE, halo: int = DGRAD_HALO):
    """The data-gradient kernel's scatter of dfeat in plain PyTorch: each
    output pixel belongs to a tile x tile block of its image, whose halo tile
    of side tile + 2 halo + 3 starts at the block's corner minus (1 + halo).
    A corner inside the halo adds into the block's halo tile (the kernel
    gathers each cell's contributions from a list sorted by cell), which is
    then added into dfeat; a corner outside it adds into dfeat directly. Returns
    (dfeat (B,H,W,C), the share of the non-zero contributions that went
    through the halo tiles); dfeat equals that of
    `plain_deform_sample_backward` up to the order of the additions."""
    B, H, W, C = feat.shape
    dev = feat.device
    hs = tile + 2 * halo + 3
    ty, tx = -(-H // tile), -(-W // tile)
    py = torch.arange(H, device=dev)[:, None, None].expand(H, W, 9)
    px = torch.arange(W, device=dev)[None, :, None].expand(H, W, 9)
    taps = torch.arange(9, device=dev)
    off = offsets.reshape(B, H, W, 9, 2)
    y = (py + taps // 3 - 1).to(torch.float32)[None] + off[..., 0]
    x = (px + taps % 3 - 1).to(torch.float32)[None] + off[..., 1]
    y0, x0 = torch.floor(y), torch.floor(x)
    fy, fx = y - y0, x - x0
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    # the block of each output pixel and its halo origin
    hy0 = (py // tile) * tile - 1 - halo
    hx0 = (px // tile) * tile - 1 - halo
    bimg = torch.arange(B, device=dev)[:, None, None, None]
    block = (bimg * ty + (py // tile)[None]) * tx + (px // tile)[None]
    dsamp = grad.reshape(B, H, W, 9, C) * masks[..., None]
    dfeat = torch.zeros(B * H * W, C, dtype=feat.dtype, device=dev)
    tiles = torch.zeros(B * ty * tx * hs * hs, C, dtype=feat.dtype, device=dev)
    in_halo = total = 0
    for dy, dx, w in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                      (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yi, xi = y0i + dy, x0i + dx
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W) & (w != 0)
        hy, hx = yi - hy0[None], xi - hx0[None]
        inside = valid & (hy >= 0) & (hy < hs) & (hx >= 0) & (hx < hs)
        outside = valid & ~inside
        upd = dsamp * w[..., None]
        gidx = (bimg * H + yi.clamp(0, H - 1)) * W + xi.clamp(0, W - 1)
        dfeat.index_add_(0, gidx[outside], upd[outside])
        tidx = (block.expand_as(hy) * hs + hy.clamp(0, hs - 1)) * hs + hx.clamp(0, hs - 1)
        tiles.index_add_(0, tidx[inside], upd[inside])
        in_halo += int(inside.sum())
        total += int(valid.sum())
    # flush: every halo cell inside the map into dfeat
    cell = torch.arange(hs, device=dev)
    by = torch.arange(ty, device=dev) * tile - 1 - halo
    bx = torch.arange(tx, device=dev) * tile - 1 - halo
    cy = (by[:, None, None, None] + cell[None, None, :, None]).expand(ty, tx, hs, hs)
    cx = (bx[None, :, None, None] + cell[None, None, None, :]).expand(ty, tx, hs, hs)
    keep = ((cy >= 0) & (cy < H) & (cx >= 0) & (cx < W))[None].expand(B, -1, -1, -1, -1)
    gidx = (bimg[..., None] * H + cy.clamp(0, H - 1)[None]) * W + cx.clamp(0, W - 1)[None]
    dfeat.index_add_(0, gidx[keep], tiles.reshape(B, ty, tx, hs, hs, C)[keep])
    return dfeat.reshape(B, H, W, C), in_halo / max(total, 1)


def deform_conv_backward(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                         chunks: int = 1):
    """Gradients (dx, dom, dweight, dbias) of `plain_deform_conv` given dy
    (B,H,W,O), in x's dtype, float32 or bf16 (module docstring). CUDA tensors
    launch the data-gradient and the weight-gradient kernels of their dtype
    (or raise; they hold no column temps, so chunks changes nothing there);
    CPU tensors take the plain versions, in `chunks` row slabs. dbias is a
    plain sum."""
    O = weight.shape[0]
    dy2 = dy.reshape(-1, O)
    if x.dtype == torch.bfloat16:
        # float32 coordinates and masks, as the bf16 fused forward forms them
        offsets, masks = sample_inputs(om)
        dbias = dy2.sum(0, dtype=torch.float32).to(dy.dtype)
    else:
        offsets = om[..., :18].contiguous()
        masks = torch.sigmoid(om[..., 18:27]).contiguous()
        dbias = dy2.sum(0)
    if x.device.type == "cpu":
        dweight = plain_deform_conv_wgrad(x, offsets, masks, dy, chunks=chunks)
        dx, dom = plain_deform_conv_dgrad(x, om, weight, dy, chunks)
    else:
        dweight = deform_conv_wgrad_cuda(x, offsets, masks, dy)
        dx, dom = deform_conv_dgrad_cuda(x, om, weight, dy)
    return dx, dom, dweight, dbias


class _DeformConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, om, weight, bias, chunks):
        ctx.save_for_backward(x, om, weight)
        ctx.chunks = chunks
        if x.device.type == "cpu":
            return plain_deform_conv(x, om, weight, bias, chunks)
        return deform_conv_cuda(x, om, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        x, om, weight = ctx.saved_tensors
        return deform_conv_backward(x, om, weight, dy.contiguous(), ctx.chunks) + (None,)


def deform_conv(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, chunks: int = 1) -> torch.Tensor:
    """Modulated deformable conv from the offset/mask conv's raw output (see
    `plain_deform_conv`), differentiable in float32 and bf16. CUDA tensors go through
    the fused kernel of their dtype, float32 or bf16, and the backward
    kernels (or raise); CPU tensors take the plain versions, which form the
    columns in `chunks` row slabs. Any other dtype raises on both."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"deform_conv runs float32 or bf16, got {x.dtype}")
    return _DeformConv.apply(x, om, weight, bias, chunks)


class _DeformSample(torch.autograd.Function):
    """The sampled columns (B,H,W,9C) of x and the raw offset/mask conv
    output om, differentiable: CUDA tensors launch the sampler
    (`deform_sample` / `deform_sample_bf16`) forward and the sampling
    backward of x's dtype (`deform_sample_bwd` / `deform_sample_bwd_bf16`:
    bf16 x and cotangent read as they are, the gradients formed in float32
    and rounded once), CPU tensors the plain versions in `chunks` row
    slabs."""

    @staticmethod
    def forward(ctx, x, om, chunks):
        offsets, masks = sample_inputs(om)
        ctx.save_for_backward(x, offsets, masks)
        ctx.chunks, ctx.om_dtype = chunks, om.dtype
        if x.device.type == "cpu":
            return plain_deform_sample(x, offsets, masks, chunks)
        return deform_sample_cuda(x, offsets, masks)

    @staticmethod
    def backward(ctx, g):
        x, offsets, masks = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        if x.device.type == "cpu":
            dx, dom = plain_deform_sample_bwd(x, offsets, masks, g, ctx.chunks)
        else:
            dx, dom = deform_sample_bwd_cuda(x, offsets, masks, g)
        return dx, dom.to(ctx.om_dtype), None


def deform_columns(x: torch.Tensor, om: torch.Tensor, chunks: int = 1) -> torch.Tensor:
    """The DCN's sampled columns (B,H,W,9C) of x (B,H,W,C) and the raw
    offset/mask conv output om (B,H,W,27), in x's dtype (bf16: each element
    formed in float32 and rounded once), differentiable (`_DeformSample`):
    what the int8 modes contract with their quantizable 1x1."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"deform_columns runs float32 or bf16, got {x.dtype}")
    return _DeformSample.apply(x, om, chunks)


class DeformConv2d(nn.Module):
    """DCNv2: 3x3 modulated deformable conv, stride 1, pad 1, one group.

    Takes and returns NCHW tensors (channels_last memory keeps the NHWC views
    the fused kernel reads and writes free of copies). `conv_offset_mask` starts at zero, so
    the initial op is a plain 3x3 conv with 0.5 masks, as in the JAX module.

    Under a quantization mode (`models/layers.py`) the (9C -> O) contraction
    is a quantizable site, as the JAX module's `Conv` over its sampled
    columns: "int8" and "int8_train" form the columns (`deform_columns`) and
    contract them through the site (min_ch reads in_ch as 9C); "int8_calib"
    records the columns' max|x| and runs the float DCN; a site gated by
    min_ch runs the float DCN. chunks (`dcn_chunks`) forms the columns in
    row slabs where the port forms them with plain ops (CPU tensors); the
    kernels hold no (B,H,W,9,C) temps, so on the card it changes nothing.
    """

    def __init__(self, in_features: int, features: int, chunks: int = 1):
        super().__init__()
        self.chunks = chunks
        self.conv_offset_mask = nn.Conv2d(in_features, 27, 3, padding=1)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)
        # the (9*C_in -> O) contraction; input index k*C_in + c
        self.kernel = nn.Linear(9 * in_features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        om = self.conv_offset_mask(x).permute(0, 2, 3, 1).contiguous()  # (B,H,W,27)
        xh = x.permute(0, 2, 3, 1).contiguous()
        weight, bias = self.kernel.weight, self.kernel.bias
        action, a_max = layers.take_site(*weight.shape)
        if action == "calib":
            layers.record(deform_columns(xh, om, self.chunks))
        if action in (None, "calib"):
            out = deform_conv(xh, om, weight, bias, self.chunks)
        else:
            out = layers.quantized_linear(self, deform_columns(xh, om, self.chunks), weight, bias, action, a_max)
        return out.permute(0, 3, 1, 2)
