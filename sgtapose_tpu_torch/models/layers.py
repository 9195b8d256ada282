"""The quantizable convolution: int8 serving and quantization-aware training.

Counterpart of `sgtapose_tpu/models/layers.py`. `Conv2d` is an `nn.Conv2d`
(same parameters, same state_dict keys) that switches execution under the
`quantized(mode)` context:

  "int8"        s8 x s8 -> s32 (`ops/int8_conv.py:int8_site`: on the card
                the hand-written kernels, which quantize the activation
                themselves, one launch a static site and two a dynamic
                one): per-output-channel weight scales max|w| / 127 and a
                per-tensor activation scale, dynamic (max|x| / 127 in float32,
                on the device: no host sync) or static (a calibrated max,
                max(a_max, 1e-12) / 127 in double, rounded once to float32);
                rounding half to even, x_q clipped to +-127; the accumulators
                rescaled in float32, cast to the input dtype, then the bias;
  "int8_train"  straight-through fake quantization: a float32 conv of the
                dequantized operands, gradients as if no rounding happened;
  "int8_calib"  float execution that records each site's max|x| (a device
                tensor) in call order, for `calibrate`.

The sites are the JAX package's `layers.Conv` calls: the trunk's and the
decoder's convs (`models/dla.py`), the heads' 3x3 (`models/sgta.py`), and
the DCN's (9C -> O) contraction over its sampled columns
(`models/deform_conv.py`, which calls `take_site` and `quantized_linear`).
The offset/mask conv, the heads' output conv, the up-convs and attention
stay float. `min_ch` quantizes a site only where min(out_ch, in_ch) of its
weight is at least min_ch (in_ch 9C at the DCN); a gated site still consumes
its static scale, so one calibration serves any threshold.

Scales follow the JAX runners: a forward under one `quantized` context
consumes the static scales from the first, and a dynamic scale is the max
over the whole tensor the site sees, except that `groups` = V (the port's
batched runner, V videos stepped together where JAX vmaps one video's
runner) takes it per video: sample n belongs to video n % V.

The quantized int8 weight of a module is cached on it, keyed on the
weight's tensor and version, so an optimizer step or a `load_state_dict`
re-quantizes it.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgtapose_tpu_torch.ops import int8_conv as int8_ops

MODES = ("int8", "int8_train", "int8_calib")
_MODE: dict = {"mode": None, "scales": None, "i": 0, "record": None, "min_ch": 0, "groups": 1}


def quant_mode() -> Optional[str]:
    return _MODE["mode"]


@contextmanager
def quantized(mode: str = "int8", scales=None, min_ch: int = 0, groups: int = 1):
    """Run the quantizable sites inside the context in `mode` (module
    docstring). scales: the per-site activation maxima of `calibrate` (int8
    only; None: dynamic scales). Yields the mode's state; under "int8_calib"
    its "record" lists the sites' maxima."""
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")
    prev = dict(_MODE)
    _MODE.update(mode=mode, scales=scales, i=0, min_ch=min_ch, groups=groups,
                 record=[] if mode == "int8_calib" else None)
    try:
        yield _MODE
    finally:
        _MODE.update(prev)


def quantized_apply(apply_fn: Callable, mode: str = "int8", scales=None, min_ch: int = 0) -> Callable:
    """apply_fn run under `quantized` on every call, so each call consumes
    scales[0 .. n_sites - 1] in call order, as `calibrate` recorded them."""

    def wrapped(*args, **kwargs):
        with quantized(mode, scales=scales, min_ch=min_ch):
            return apply_fn(*args, **kwargs)

    return wrapped


@torch.no_grad()
def calibrate(apply_fn: Callable, inputs_list) -> List[float]:
    """Run apply_fn(*inputs) under "int8_calib" for each tuple; return the
    per-site running max of |x| in call order (Python floats). Raises
    ValueError when two calls hit different numbers of sites."""
    maxes: list = []
    for inputs in inputs_list:
        with quantized("int8_calib") as st:
            apply_fn(*inputs)
            rec = st["record"]
        if maxes and len(rec) != len(maxes):
            raise ValueError(f"calibration call hit {len(rec)} conv sites, expected {len(maxes)} — "
                             "apply_fn is not call-order stable")
        maxes = list(rec) if not maxes else [torch.maximum(a, b) for a, b in zip(maxes, rec)]
    return [float(m) for m in maxes]


def take_site(out_ch: int, in_ch: int) -> Tuple[Optional[str], Optional[float]]:
    """The bookkeeping of one eligible site: (action, a_max). action is None
    (run in float: no mode, or gated by min_ch), "calib", "int8" or "fake";
    a_max is the site's static activation max under "int8" with scales (one
    consumed per site, gated or not), else None."""
    mode = _MODE["mode"]
    if mode is None:
        return None, None
    if mode == "int8_calib":
        return "calib", None
    a_max = None
    if mode == "int8" and _MODE["scales"] is not None:
        a_max = float(_MODE["scales"][_MODE["i"]])
        _MODE["i"] += 1
    if min(out_ch, in_ch) < _MODE["min_ch"]:
        return None, None
    return ("fake" if mode == "int8_train" else "int8"), a_max


def record(x: torch.Tensor) -> None:
    """Under "int8_calib": append the site's max|x| (float32 device scalar)."""
    _MODE["record"].append(x.detach().to(torch.float32).abs().amax())


def weight_quant(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w_q, w_scale) of a weight with the output channel first, in float32:
    w_scale = max(max|w| over the other axes / 127, 1e-12), keepdims;
    w_q = round(w / w_scale), half to even (not clipped: |w_q| <= 127)."""
    w = w.to(torch.float32)
    w_scale = int8_ops.div127(w.abs().amax(dim=tuple(range(1, w.dim())), keepdim=True)).clamp_min(1e-12).detach()
    return torch.round(w / w_scale), w_scale


def activation_scale(x: torch.Tensor, a_max: Optional[float] = None, groups: int = 1) -> torch.Tensor:
    """The per-sample activation scales (N,) float32 of x (batch first):
    static, max(a_max, 1e-12) / 127 in double rounded to float32; dynamic,
    max(max|x|, 1e-12) / 127 in float32, over the whole tensor, or per video
    with groups = V (sample n of video n % V), as `int8_conv_fused` forms it
    (`ops/int8_conv.py:video_scales`)."""
    N = x.shape[0]
    if a_max is not None:
        return torch.full((N,), max(a_max, 1e-12) / 127.0, dtype=torch.float32, device=x.device)
    per_sample = x.detach().to(torch.float32).abs().reshape(N, -1).amax(dim=1)
    return int8_ops.video_scales(per_sample[:, None], groups)


def activation_quant(x: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    """x_q = clip(round(x / a_scale), -127, 127) in float32 (a_scale per
    sample, broadcast over the other axes)."""
    s = a_scale.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.clamp(torch.round(x.to(torch.float32) / s), -127, 127)


def _quantize_operands(x: torch.Tensor, w: torch.Tensor, a_max: Optional[float] = None, groups: int = 1):
    """JAX's `_quantize_operands`: (x_q, w_q, x, w, a_scale, w_scale), all
    float32; a_scale (N,) per sample, w_scale (O, 1, ...)."""
    w_q, w_scale = weight_quant(w)
    a_scale = activation_scale(x, a_max, groups)
    return activation_quant(x, a_scale), w_q, x.to(torch.float32), w.to(torch.float32), a_scale, w_scale


def _cached_weight(owner: nn.Module, w: torch.Tensor, kh: int, kw: int) -> int8_ops.QuantWeight:
    """owner's quantized int8 weight of w ((O, C, kh, kw), or (O, C) with
    kh = kw = 1), re-quantized when w is another tensor or was modified."""
    key = (id(w), w._version, w.data_ptr(), w.dtype, w.device, tuple(w.shape))
    cached = owner.__dict__.get("_int8_weight")
    if cached is None or cached[0] != key:
        with torch.no_grad():
            w_q, w_scale = weight_quant(w)
            w_q = w_q.reshape(w.shape[0], -1, kh, kw).permute(0, 2, 3, 1)
            cached = (key, int8_ops.pack_weight(w_q, w_scale.reshape(-1)))
        owner.__dict__["_int8_weight"] = cached
    return cached[1]


def _fake(xf, x_q, a_scale, wf, w_q, w_scale):
    """The straight-through operands: x + sg(x_q a_scale - x), and w alike."""
    s = a_scale.reshape((-1,) + (1,) * (xf.dim() - 1))
    return xf + (x_q * s - xf).detach(), wf + (w_q * w_scale - wf).detach()


def quantized_conv(owner: nn.Module, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                   stride: int, padding: int, action: str, a_max: Optional[float]) -> torch.Tensor:
    """A conv site (x NCHW, weight (O, C, kh, kw)) under "int8" or "fake"
    (`take_site`); returns NCHW in x's dtype (channels_last memory)."""
    groups = _MODE["groups"]
    if action == "fake":
        x_q, w_q, xf, wf, a_scale, w_scale = _quantize_operands(x, weight, a_max, groups)
        x_fq, w_fq = _fake(xf, x_q, a_scale, wf, w_q, w_scale)
        y = F.conv2d(x_fq, w_fq, None, stride, padding).to(x.dtype)
        return y if bias is None else y + bias.to(x.dtype)[None, :, None, None]
    qw = _cached_weight(owner, weight, weight.shape[2], weight.shape[3])
    out = int8_ops.int8_site(x.permute(0, 2, 3, 1), qw, a_max, groups, None if bias is None else bias.to(x.dtype),
                             stride, padding)
    return out.permute(0, 3, 1, 2)


def quantized_linear(owner: nn.Module, cols: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                     action: str, a_max: Optional[float]) -> torch.Tensor:
    """The DCN's contraction site, a 1x1 conv over cols (B, H, W, 9C) with
    weight (O, 9C), under "int8" or "fake"; returns (B, H, W, O) in cols'
    dtype."""
    groups = _MODE["groups"]
    if action == "fake":
        x_q, w_q, xf, wf, a_scale, w_scale = _quantize_operands(cols, weight, a_max, groups)
        x_fq, w_fq = _fake(xf, x_q, a_scale, wf, w_q, w_scale)
        y = F.linear(x_fq, w_fq).to(cols.dtype)
        return y if bias is None else y + bias.to(cols.dtype)
    qw = _cached_weight(owner, weight, 1, 1)
    return int8_ops.int8_site(cols, qw, a_max, groups, None if bias is None else bias.to(cols.dtype), 1, 0)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` whose execution switches under `quantized()` (module
    docstring). Parameters and state_dict keys are nn.Conv2d's. Only plain
    convs are sites (one group, no dilation), as in JAX."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.groups != 1 or self.dilation != (1, 1):
            return super().forward(x)
        action, a_max = take_site(self.out_channels, self.in_channels)
        if action is None:
            return super().forward(x)
        if action == "calib":
            record(x)
            return super().forward(x)
        return quantized_conv(self, x, self.weight, self.bias, self.stride[0], self.padding[0], action, a_max)
