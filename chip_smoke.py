#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`sgtapose_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit (nvidia-smi) and the float32 settings
     (TF32 off for cuDNN convolutions and matmuls, so the float32 path is
     float32);
  2. build every CUDA kernel from sgtapose_tpu_torch/csrc (one nvcc per
     source, all started together, sm_90a);
  3. the float32 biased-attention kernel against its plain PyTorch version at
     the flagship shapes plus a ragged n (and the key-tiled float32 kernel at
     a 42-keypoint model's levels 0 and 1), with kernel (cold, and warm: 3
     back-to-back launches without an L2 flush, as the 3 tied layers run;
     clean: the flush read back, so no dirty lines are left to write back) /
     plain / library (F.scaled_dot_product_attention, a yardstick the port
     never calls) times;
  4. the DCN sampling kernel (off the detector path since the fused kernel;
     the training backward recomputes the columns with it) and the DCN
     sampling backward against their plain versions at every decoder input
     shape at the training batch of 8, and one ragged shape (the backward
     no longer launches deform_sample_bwd: it is the yardstick of 4b);
 4b. the float32 DCN data gradient `deform_conv_dgrad` (the training
     backward's dx and offset/mask gradient in one kernel) against its plain
     version at every decoder node at the training batch of 8 and one ragged
     shape, with offsets at zero, within its halo tile (+-3 px) and beyond
     it (+-12 px), dom the same bit for bit in two runs; kernel / unfused
     pair (dY W with TF32 off, then deform_sample_bwd) / the pair's product
     alone / plain times at +-3, the kernel's at zero offsets;
  5. the float32 fused DCN kernel against its plain version at the decoder
     shapes and one ragged shape, with kernel / unfused pair (the sampler,
     then torch.addmm with TF32 off) / plain times;
  6. the bf16 biased-attention kernel against its plain bf16 version at the
     flagship shapes (q bf16, as on the first tied layer, and q float32, as
     on the other two) plus a ragged n, at batch 1 (the single-video
     runners) and at the batched runner's batch of 8 videos: cold / warm /
     clean / plain times and SDPA in bf16 with a float mask as the
     yardstick;
  7. the bf16 fused DCN kernel against its plain bf16 version at the decoder
     shapes, at batch 1 and 8, and the ragged shape: kernel / plain times
     (no library call computes the same function);
  8. one full-width SGTAPose forward (480x480, DCN decoder, seeded weights
     with the zero-initialised parameters perturbed) in float32 on the card
     and on the CPU (plain versions), then the same weights in bf16
     (utils/precision.bf16_inference_model) on the card and on the CPU, and
     card bf16 against card float32, heads compared;
  9. the float32 exact streaming detector on a 16-frame synthetic 640x360
     video, teacher-forced then closed-loop; then the bf16 serving runners on
     the same video: the exact detector (the JAX benchmark's headline), the
     feature-cache runner with the PnP warm start (its fast path), and the
     batched runner over 8 videos (its production fill, aggregate fps). Each
     run: kernel launch counts from the wrappers' counters (reset just before
     the run) asserted per frame step, finite outputs of the expected shapes,
     per-stage times (CUDA events around each stage, so a stage's time
     includes the host's launch gaps inside it), fps, and from torch.profiler
     over 2 frames the CUDA launches per stage, the device kernel time per
     frame step (busy share against the unprofiled step time) and the device
     time of each hand-written kernel. The feature-cache runner's trunk stage
     must launch exactly what one trunk call on one frame launches;
 10. the eval harness (eval/analysis.py, PnP and weighted refinement batched
     over frames on the card) on the bf16 exact run's detections, and on
     the ground truth with 0.5 px of noise, whose scores are known;
 11. training (float32, the train_demo path): the attention backward
     kernel against its plain version at every flagship (n, d) at the
     training batch of 8, at level 2 and a ragged (100, 8) also at batch 1
     and 2 (the cluster path), every output the same bit for bit in two
     runs, with cold / plain times, bounds and SDPA's backward as the
     yardstick;
     one full-width train-step gradient (480x480, batch 1, dropout off) on
     the card and on the CPU in float32, both held against a CPU float64
     reference (GRAD_WORST_TOL, GRAD_L2_TOL); the same gradient with
     BatchNorm in eval mode and the DCN offset/mask convs perturbed, so
     non-zero offsets go through deform_conv_dgrad in the network's
     backward, card float32 against CPU float64 (EVAL_GRAD_WORST_TOL,
     EVAL_GRAD_L2_TOL); 5 steps of `train/trainer.train_step` at 480x480,
     batch 8 on one fixed batch (the loss must fall); then
     `cli/train_demo.main` for 20 steps on fresh batches with stage times
     (batch build with the PnP priors, forward, backward, optimizer) and
     launch counts asserted per step (16 deform_conv_dgrad, 0
     deform_sample_bwd, 3 attention backward), its eval of the trained
     weights (bf16 exact runner, 1 video of 8 frames) and its checkpoint
     (--ckpt_out into a temporary directory); device time per kernel per
     step from torch.profiler;
 12. the inference CLI, `cli/infer.main --device cuda` at the flagship
     config, on datasets written by the port's own writers: (A) synthetic,
     2 videos x 4 frames (640x360), the phase-11 checkpoint, --rf
     --multi_frame 2 --track --debug 1: 9 biased_attention and 16
     deform_conv launches per frame and no other kernel, every artifact
     (CSVs, analysis text, dt_and_gt.json, both multiframe CSVs, tracks.json,
     the 3 debug images per frame), the CLI's fps and stage times; (B)
     DREAM-real, 2 videos x 3 frames, the second at twice the resolution:
     two runners, every frame's ground truth counted; (C) 42-keypoint depth,
     4 frames, random weights: per frame 3 biased_attention (level 2), 6
     biased_attention_tiled (levels 0 and 1 exceed the shared-memory
     kernel) and 16 deform_conv; then the card against the CPU
     (--device cpu) on a 2-frame copy of the first video, with the
     checkpoint and with its hm bias at 0 (peaks decode; frame 0 only):
     sentinel patterns and track ids equal, keypoints within CLI_KP_TOL px,
     debug heatmap blends within CLI_BLEND_TOL levels;
 13. a `{"kernels": [...]}` line, the card line, and last the device line
     `{"ok": true, "device": {...}}`.

The detector runs of phase 9 take 8 frames each (16 before the training
phases were added, to keep the script inside half its time limit).

Kernel times are CUDA-event times of single launches with the 50 MB L2
flushed before each (the detector reads each weight once per frame); the
per-kernel entries of the kernels line are per-frame sums over the shapes one
frame launches (per-step sums over one training step's shapes for the
sampler and the backward kernels). Bounds (H100 SXM data sheet): the larger of bytes over
3.35 TB/s and operations over the rate of the instructions used, 67 TFLOP/s
for float32 FMAs, 165 TFLOP/s (495 / 3) for 3xTF32 and 989 TFLOP/s for dense
bf16 on the tensor cores. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32X3_OPS_PER_S = 495e12 / 3
BF16_OPS_PER_S = 989e12
T_FRAMES = 8
N_VIDEOS = 8  # the batched runner's video batch
TRAIN_BATCH = 8  # train_demo's default batch
FIXED_STEPS, TRAIN_STEPS = 5, 20
ATTN_TOL = 2e-4  # the JAX package's Pallas-vs-XLA bar
DCN_TOL = 1e-5  # same float32 arithmetic; only FMA contraction may differ
# fused DCN vs plain, relative to max(1, max|ref|): a 9C-long sum in another
# order, plus 3xTF32's dropped lo*lo term (~2^-22 of each product)
DCN_CONV_REL_TOL = 1e-4
FORWARD_REL_TOL = 1e-4  # card vs CPU heads, relative to max(1, max|CPU head|)
# bf16 kernels vs their plain bf16 versions: both compute in float32 from the
# same bf16 inputs, but a bf16 rounding (of a q.k logit, a sampled DCN
# element, a DCN output) can fall on the other side of a rounding boundary
# when float32 sums run in another order: a few bf16 units in the last place
ATTN_BF16_TOL = 1e-3
DCN_BF16_REL_TOL = 8e-3  # of max(1, max|ref|): two bf16 ulps at the top of the range
# bf16 forward, heads compared. Card bf16 vs card float32 within 1 % of
# max(1, max|head|): the cost of bf16 serving (H100 readings: hm 0.48 % of
# its max, reg and tracking 0.07 % and 0.09 % of 1). Card bf16 vs CPU bf16
# (the same arithmetic in another order) within 4 bf16 units in the last
# place at the CPU head's largest value: the heads are bf16 before they are
# cast back, and rounding differences early in the network carry through
# (H100 readings: hm 1, reg 2.75, tracking 2 units).
BF16_VS_F32_REL_TOL = 1e-2
BF16_CARD_VS_CPU_ULPS = 4
# backward kernels vs their plain versions, relative to max(1, max|ref|) per
# gradient: the attention recomputes P with the fast exp2 and sums in another
# order; the DCN adds into dfeat with float atomics (order varies per run)
BWD_REL_TOL = 1e-4
# a full-width train step's parameter gradients are held against a float64
# reference (autograd through the plain versions on the CPU): train-mode
# BatchNorm normalises by batch statistics, which amplifies float32 rounding
# layer by layer, so float32 gradients are only as good as float32 allows
# here. H100 readings at 480x480, batch 1 (PERF.md, PR 4): the card's worst
# tensor 6.4 % of its largest reference gradient, 0.19 % over all gradients
# in L2; the CPU's float32 53 % and 12 %. Bars for the card:
GRAD_WORST_TOL = 0.2
GRAD_L2_TOL = 0.01
# The same whole-model gradient with BatchNorm in eval mode (running
# statistics: nothing amplifies float32 rounding) and the DCN offset/mask
# convs perturbed (offsets of a few pixels, some samples out of bounds), so
# non-zero offsets go through deform_conv_dgrad inside the network's
# backward: card float32 against CPU float64, per tensor relative to its
# largest reference gradient, and over all gradients in L2:
EVAL_GRAD_WORST_TOL = 1e-3
EVAL_GRAD_L2_TOL = 1e-4
# phase 12, the inference CLI on the card: synthetic videos x frames (run A),
# DREAM-real videos x frames (run B, the second video at twice the
# resolution), depth frames (run C, 42 classes); card vs CPU on 2 frames:
# keypoints within CLI_KP_TOL px where valid, the debug heatmap blends
# within CLI_BLEND_TOL uint8 levels
CLI_VIDEOS, CLI_FRAMES = 2, 4
REAL_VIDEOS, REAL_FRAMES = 2, 3
DEPTH_FRAMES, DEPTH_CLASSES = 4, 42
CLI_KP_TOL = 0.05
CLI_BLEND_TOL = 2
# (H, C_in, C_out, nodes per frame) of the 16 decoder DCN nodes at 480x480
DCN_NODES = [(15, 512, 256, 1), (30, 256, 256, 1), (30, 256, 128, 2), (30, 256, 64, 1),
             (60, 128, 128, 2), (60, 128, 64, 4), (120, 64, 64, 5)]
RAGGED_DCN = (9, 6, 5, 0)  # 9x11 map, C % 8 != 0, O below one tile; off the path
# device function of each kernel, as the profiler names it
DEVICE_NAMES = {"biased_attention": "biased_attention_kernel", "deform_conv": "deform_conv_kernel",
                "deform_sample": "deform_sample_kernel",
                "biased_attention_bf16": "biased_attention_bf16_kernel",
                "deform_conv_bf16": "deform_conv_bf16_kernel",
                "biased_attention_bwd": "biased_attention_bwd_", "deform_sample_bwd": "deform_sample_bwd_kernel",
                "deform_conv_dgrad": "deform_conv_dgrad_kernel",
                "biased_attention_tiled": "biased_attention_tiled_kernel"}
TRAIN_STAGES = ("batch", "forward", "backward", "optimizer")
STAGE_NAMES = ("pnp", "render", "trunk", "fuse", "decode")


def rel_err(a, b) -> float:
    """max|a - b| / max(1, max|b|)."""
    return (a - b).abs().max().item() / max(1.0, b.abs().max().item())


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import torch.nn.functional as F

    from sgtapose_tpu_torch.config import Config
    from sgtapose_tpu_torch.core import geometry
    from sgtapose_tpu_torch.data import synthetic
    from sgtapose_tpu_torch.eval.analysis import analyze_sequence_results
    from sgtapose_tpu_torch.infer import detector as det_lib
    from sgtapose_tpu_torch.models import deform_conv
    from sgtapose_tpu_torch.models.sgta import create_model
    from sgtapose_tpu_torch.ops import attention_kernel, build
    from sgtapose_tpu_torch.utils.precision import bf16_inference_model

    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = card.splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; float32 with "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    report = {"card": card}
    t_start = time.perf_counter()

    # ---- 2. build -------------------------------------------------------
    build.build_all()
    print(f"build: {build.BUILD_INFO['seconds']:.1f} s for {build.BUILD_INFO['compiled']} "
          f"into {build.BUILD_INFO['dir']}")
    for name, log in build.BUILD_INFO["logs"].items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    report["build_seconds"] = build.BUILD_INFO["seconds"]

    flush = torch.empty(128 * 2 ** 20 // 4, dtype=torch.float32, device=dev)  # > 50 MB L2
    flush_sum = torch.empty(1, dtype=torch.float32, device=dev)

    def cold_ms(fn, iters=20, warmup=3, clean=False):
        """Mean CUDA-event time of one call, L2 flushed before each. A ~1 ms
        device sleep ahead of the start event lets the host enqueue the whole
        call first, so the events bracket device work, not launch overhead.
        The flush writes 128 MB, which leaves the L2 full of dirty lines that
        a streaming kernel must also write back; `clean` reads the buffer
        back first, so the L2 holds clean lines only."""
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            flush.zero_()
            if clean:
                torch.sum(flush, dim=0, keepdim=True, out=flush_sum)
            torch.cuda._sleep(2_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / iters

    def warm_ms(fn, reps=3, iters=20):
        """Mean time of one call within `reps` back-to-back calls after one
        L2 flush: later calls find their inputs in L2."""
        fn()
        total = 0.0
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(reps):
                fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e) / reps
        return total / iters

    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = Config()
    n_layers = cfg.model.num_decoder_layers
    h = cfg.model.n_heads

    # ---- 3. float32 attention kernel vs plain ----------------------------
    attn_rows = []
    shapes = []
    for i in range(3):
        kernel = cfg.model.kernel_list[i]
        n = cfg.model.num_classes * cfg.model.k_list[i] * (1 + 2 * (kernel // 2)) ** 2
        shapes.append((n, 4 * 2 ** i, n_layers))  # (n, d, launches per frame)
    shapes.append((100, 8, 0))  # ragged n, not on the main path
    for n, d, per_frame in shapes:
        q, k, v = (torch.randn(1, h, n, d, generator=gen, device=dev) for _ in range(3))
        bias = 0.1 * torch.randn(h, n, n, generator=gen, device=dev)
        out = attention_kernel.biased_attention_cuda(q, k, v, bias)
        torch.cuda.synchronize()
        ref = attention_kernel.plain_biased_attention(q, k, v, bias)
        err = (out - ref).abs().max().item()
        if not math.isfinite(err) or err > ATTN_TOL:
            raise AssertionError(f"attention kernel n={n} d={d}: max abs err {err} > {ATTN_TOL}")
        n_bytes = 4 * (4 * h * n * d + h * n * n)
        b_ms, b_by = bound_ms(n_bytes, h * n * n * (4 * d + 4))
        row = dict(n=n, d=d, per_frame=per_frame, max_abs_err=err,
                   ms=cold_ms(lambda: attention_kernel.biased_attention_cuda(q, k, v, bias)),
                   warm_ms=warm_ms(lambda: attention_kernel.biased_attention_cuda(q, k, v, bias)),
                   clean_ms=cold_ms(lambda: attention_kernel.biased_attention_cuda(q, k, v, bias),
                                    clean=True),
                   plain_ms=cold_ms(lambda: attention_kernel.plain_biased_attention(q, k, v, bias)),
                   library_ms=cold_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)),
                   bound_ms=b_ms, bound_by=b_by)
        attn_rows.append(row)
        print("attention " + json.dumps(row))
    report["attention_shapes"] = attn_rows

    # the key-tiled float32 kernel at a 42-keypoint model's levels 0 and 1
    # (n beyond the shared-memory kernel), as phase 12's depth run launches it
    tiled_rows = []
    for i in range(2):
        kernel = cfg.model.kernel_list[i]
        n, d = DEPTH_CLASSES * cfg.model.k_list[i] * (1 + 2 * (kernel // 2)) ** 2, 4 * 2 ** i
        q, k, v = (torch.randn(1, h, n, d, generator=gen, device=dev) for _ in range(3))
        bias = 0.1 * torch.randn(h, n, n, generator=gen, device=dev)
        if attention_kernel.fits_smem(n, d):
            raise AssertionError(f"(n, d) = {(n, d)} fits the shared-memory kernel; expected the tiled one")
        out = attention_kernel.biased_attention_tiled_cuda(q, k, v, bias)
        torch.cuda.synchronize()
        ref = attention_kernel.plain_biased_attention(q, k, v, bias)
        err = (out - ref).abs().max().item()
        if not math.isfinite(err) or err > ATTN_TOL:
            raise AssertionError(f"tiled attention kernel n={n} d={d}: max abs err {err} > {ATTN_TOL}")
        b_ms, b_by = bound_ms(4 * (4 * h * n * d + h * n * n), h * n * n * (4 * d + 4))
        row = dict(n=n, d=d, per_frame=n_layers, max_abs_err=err,
                   ms=cold_ms(lambda: attention_kernel.biased_attention_tiled_cuda(q, k, v, bias)),
                   plain_ms=cold_ms(lambda: attention_kernel.plain_biased_attention(q, k, v, bias), iters=5),
                   library_ms=cold_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias), iters=5),
                   bound_ms=b_ms, bound_by=b_by)
        tiled_rows.append(row)
        print("attention_tiled " + json.dumps(row))
        del q, k, v, bias, out, ref
    report["attention_tiled_shapes"] = tiled_rows

    # ---- 4. DCN sampling kernel and its backward vs plain -------------------
    # at the training batch: a training step launches the sampler (the
    # backward's recompute of the columns) and deform_sample_bwd once per
    # decoder node; the detector launches neither
    dcn_shapes = {}
    for H, C, _, nodes in DCN_NODES + [RAGGED_DCN]:
        dcn_shapes[(H, C)] = dcn_shapes.get((H, C), 0) + nodes
    dcn_rows, dcn_bwd_rows = [], []
    for (H, C), per_step in dcn_shapes.items():
        B, W = (TRAIN_BATCH, H) if per_step else (2, H + 2)
        feat = torch.randn(B, H, W, C, generator=gen, device=dev)
        offsets = torch.rand(B, H, W, 18, generator=gen, device=dev) * 6 - 3
        masks = torch.rand(B, H, W, 9, generator=gen, device=dev)
        out = deform_conv.deform_sample_cuda(feat, offsets, masks)
        torch.cuda.synchronize()
        ref = deform_conv.plain_deform_sample(feat, offsets, masks)
        err = (out - ref).abs().max().item()
        if not math.isfinite(err) or err > DCN_TOL:
            raise AssertionError(f"DCN kernel B={B} H={H} C={C}: max abs err {err} > {DCN_TOL}")
        M = B * H * W
        b_ms, b_by = bound_ms(4 * M * (C + 18 + 9 + 9 * C), M * 9 * C * 9)
        row = dict(B=B, H=H, W=W, C=C, per_step=per_step, max_abs_err=err,
                   ms=cold_ms(lambda: deform_conv.deform_sample_cuda(feat, offsets, masks)),
                   plain_ms=cold_ms(lambda: deform_conv.plain_deform_sample(feat, offsets, masks)),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
        dcn_rows.append(row)
        print("deform_sample " + json.dumps(row))

        grad = torch.randn(B, H, W, 9 * C, generator=gen, device=dev)
        dfeat, dom = deform_conv.deform_sample_bwd_cuda(feat, offsets, masks, grad)
        torch.cuda.synchronize()
        rf, roff, rmask = deform_conv.plain_deform_sample_backward(feat, offsets, masks, grad)
        errs = {name: rel_err(a, r) for name, a, r in (
            ("dfeat", dfeat, rf), ("doffsets", dom[..., :18], roff),
            ("dmask_logits", dom[..., 18:], rmask * masks * (1 - masks)))}
        if not all(math.isfinite(e) and e <= BWD_REL_TOL for e in errs.values()):
            raise AssertionError(f"deform_sample_bwd B={B} H={H} C={C}: rel errors {errs} > {BWD_REL_TOL}")
        # read feat, offsets, masks, grad once, write dfeat and dom once; ~34
        # FLOPs per (pixel, tap, channel) with the 4 atomic adds
        b_ms, b_by = bound_ms(4 * M * (C + 18 + 9 + 9 * C + C + 27), M * 9 * C * 34)
        row = dict(B=B, H=H, W=W, C=C, per_step=per_step, rel_err=errs,
                   max_abs_err=max((dfeat - rf).abs().max().item(), (dom[..., :18] - roff).abs().max().item()),
                   ms=cold_ms(lambda: deform_conv.deform_sample_bwd_cuda(feat, offsets, masks, grad)),
                   plain_ms=cold_ms(lambda: deform_conv.plain_deform_sample_backward(feat, offsets, masks, grad)),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
        dcn_bwd_rows.append(row)
        print("deform_sample_bwd " + json.dumps(row))
        del feat, offsets, masks, grad, out, ref, dfeat, dom, rf, roff, rmask
    report["deform_sample_shapes"] = dcn_rows
    report["deform_sample_bwd_shapes"] = dcn_bwd_rows

    # ---- 4b. float32 DCN data gradient (deform_conv_dgrad) vs plain -------
    # the training backward's dx and d(om) at every decoder node at the
    # training batch, offsets at zero (flax's init), within the kernel's halo
    # tile (+-3) and beyond it (+-12); times at +-3 against the unfused pair
    # it replaced (dY W with TF32 off, then deform_sample_bwd), the kernel's
    # alone at zero offsets
    dgrad_rows = []
    for (H, C, O, per_step), span in [(node, span) for node in DCN_NODES + [RAGGED_DCN]
                                      for span in (0.0, 3.0, 12.0)]:
        B, W = (TRAIN_BATCH, H) if per_step else (2, H + 2)
        x = torch.randn(B, H, W, C, generator=gen, device=dev)
        om = torch.cat([(torch.rand(B, H, W, 18, generator=gen, device=dev) * 2 - 1) * span,
                        2 * torch.randn(B, H, W, 9, generator=gen, device=dev)], dim=-1)
        weight = torch.randn(O, 9 * C, generator=gen, device=dev) / math.sqrt(9 * C)
        dy = torch.randn(B, H, W, O, generator=gen, device=dev)
        dx, dom = deform_conv.deform_conv_dgrad_cuda(x, om, weight, dy)
        torch.cuda.synchronize()
        rdx, rdom = deform_conv.plain_deform_conv_dgrad(x, om, weight, dy)
        errs = {"dx": rel_err(dx, rdx), "dom": rel_err(dom, rdom)}
        if not all(math.isfinite(e) and e <= BWD_REL_TOL for e in errs.values()):
            raise AssertionError(f"deform_conv_dgrad B={B} H={H} C={C} O={O} offsets +-{span}: "
                                 f"rel errors {errs} > {BWD_REL_TOL}")
        if not torch.equal(dom, deform_conv.deform_conv_dgrad_cuda(x, om, weight, dy)[1]):
            raise AssertionError(f"deform_conv_dgrad H={H} C={C} O={O}: two runs give another dom")
        M = B * H * W
        # read dY, x, om and the weight once, write dx and dom once; the
        # product's 2 M O 9C operations at the 3xTF32 rate (the scatter's
        # float32 work, ~34 FLOPs per (pixel, tap, channel), not counted)
        b_ms, b_by = bound_ms(4 * (M * O + 2 * M * C + 2 * M * 27 + O * 9 * C), 2 * M * O * 9 * C,
                              TF32X3_OPS_PER_S)
        row = dict(B=B, H=H, W=W, C=C, O=O, offsets=span, per_step=per_step if span == 3.0 else 0,
                   rel_err=errs, max_abs_err=max((dx - rdx).abs().max().item(), (dom - rdom).abs().max().item()),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if span == 0.0:
            row["ms"] = cold_ms(lambda: deform_conv.deform_conv_dgrad_cuda(x, om, weight, dy))
        if span == 3.0:
            offsets = om[..., :18].contiguous()
            masks = torch.sigmoid(om[..., 18:]).contiguous()

            def matmul():
                return (dy.view(-1, O) @ weight).view(B, H, W, 9 * C)

            def pair():
                return deform_conv.deform_sample_bwd_cuda(x, offsets, masks, matmul())

            row.update(ms=cold_ms(lambda: deform_conv.deform_conv_dgrad_cuda(x, om, weight, dy)),
                       matmul_ms=cold_ms(matmul), pair_ms=cold_ms(pair),
                       plain_ms=cold_ms(lambda: deform_conv.plain_deform_conv_dgrad(x, om, weight, dy),
                                        iters=5, warmup=1))
        dgrad_rows.append(row)
        print("deform_conv_dgrad " + json.dumps(row))
        del x, om, weight, dy, dx, dom, rdx, rdom
    report["deform_conv_dgrad_shapes"] = dgrad_rows

    def dcn_inputs(H, W, C, O, dtype, B=1):
        x = torch.randn(B, H, W, C, generator=gen, device=dev)
        om = torch.cat([torch.rand(B, H, W, 18, generator=gen, device=dev) * 6 - 3,
                        2 * torch.randn(B, H, W, 9, generator=gen, device=dev)], dim=-1)
        weight = torch.randn(O, 9 * C, generator=gen, device=dev) / math.sqrt(9 * C)
        bias_o = torch.randn(O, generator=gen, device=dev)
        return tuple(t.to(dtype) for t in (x, om, weight, bias_o))

    # ---- 5. float32 fused DCN kernel vs plain -----------------------------
    conv_rows = []
    for H, C, O, per_frame in DCN_NODES + [RAGGED_DCN]:
        W = H + 2 if per_frame == 0 else H
        x, om, weight, bias_o = dcn_inputs(H, W, C, O, torch.float32)
        out = deform_conv.deform_conv_cuda(x, om, weight, bias_o)
        torch.cuda.synchronize()
        ref = deform_conv.plain_deform_conv(x, om, weight, bias_o)
        err = (out - ref).abs().max().item()
        bar = DCN_CONV_REL_TOL * max(1.0, ref.abs().max().item())
        if not math.isfinite(err) or err > bar:
            raise AssertionError(f"deform_conv H={H} W={W} C={C} O={O}: max abs err {err} > {bar}")
        offsets = om[..., :18].contiguous()
        masks = torch.sigmoid(om[..., 18:]).contiguous()

        def pair():
            flat = deform_conv.deform_sample_cuda(x, offsets, masks)
            return torch.addmm(bias_o, flat.view(-1, 9 * C), weight.t())

        M = H * W
        b_ms, b_by = bound_ms(4 * (M * C + M * 27 + O * 9 * C + O + M * O), 2 * M * O * 9 * C,
                              TF32X3_OPS_PER_S)
        row = dict(H=H, W=W, C=C, O=O, per_frame=per_frame, max_abs_err=err, bar=bar,
                   ms=cold_ms(lambda: deform_conv.deform_conv_cuda(x, om, weight, bias_o)),
                   pair_ms=cold_ms(pair),
                   plain_ms=cold_ms(lambda: deform_conv.plain_deform_conv(x, om, weight, bias_o)),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
        conv_rows.append(row)
        print("deform_conv " + json.dumps(row))
    report["deform_conv_shapes"] = conv_rows

    # ---- 6. bf16 attention kernel vs plain bf16 ---------------------------
    # per frame each level runs its 3 tied layers: q bf16 on the first, q
    # float32 (from the float32 LayerNorm) on the other two; the batched
    # runner's fuse launches each at batch 8 (those rows stay out of the
    # per-frame sums)
    attn16_rows = []
    cases = [(n, d, per_frame, B, q_dtype) for n, d, per_frame in shapes for B in (1, N_VIDEOS)
             for q_dtype in (bf16, torch.float32) if per_frame or B == 1]
    for n, d, per_frame, B, q_dtype in cases:
        q = torch.randn(B, h, n, d, generator=gen, device=dev).to(q_dtype)
        k, v = (torch.randn(B, h, n, d, generator=gen, device=dev).to(bf16) for _ in range(2))
        bias = (0.1 * torch.randn(h, n, n, generator=gen, device=dev)).to(bf16)
        out = attention_kernel.biased_attention_bf16_cuda(q, k, v, bias)
        torch.cuda.synchronize()
        ref = attention_kernel.plain_biased_attention_bf16(q, k, v, bias)
        err = (out - ref).abs().max().item()
        if out.dtype != torch.float32 or not math.isfinite(err) or err > ATTN_BF16_TOL:
            raise AssertionError(f"bf16 attention B={B} n={n} d={d} q {q_dtype}: max abs err "
                                 f"{err} > {ATTN_BF16_TOL} (or out {out.dtype})")
        n_bytes = B * (q.element_size() + 2 * 2 + 4) * h * n * d + 2 * h * n * n
        b_ms, b_by = bound_ms(n_bytes, B * h * n * n * (4 * d + 4))
        q16 = q.to(bf16)
        q_per_frame = 0 if B > 1 else (per_frame // 3 if q_dtype == bf16 else per_frame - per_frame // 3)

        def run():
            return attention_kernel.biased_attention_bf16_cuda(q, k, v, bias)

        row = dict(B=B, n=n, d=d, q_dtype=str(q_dtype).replace("torch.", ""), per_frame=q_per_frame,
                   max_abs_err=err, ms=cold_ms(run), warm_ms=warm_ms(run),
                   clean_ms=cold_ms(run, clean=True),
                   plain_ms=cold_ms(lambda: attention_kernel.plain_biased_attention_bf16(q, k, v, bias)),
                   library_ms=cold_ms(lambda: F.scaled_dot_product_attention(q16, k, v, attn_mask=bias)),
                   bound_ms=b_ms, bound_by=b_by)
        attn16_rows.append(row)
        print("attention_bf16 " + json.dumps(row))
    report["attention_bf16_shapes"] = attn16_rows

    # ---- 7. bf16 fused DCN kernel vs plain bf16 ---------------------------
    # (the batched runner's fuse launches each node at batch 8)
    conv16_rows = []
    cases = [(node, B) for B in (1, N_VIDEOS) for node in DCN_NODES] + [(RAGGED_DCN, 1)]
    for (H, C, O, per_frame), B in cases:
        W = H + 2 if per_frame == 0 else H
        per_frame = per_frame if B == 1 else 0
        x, om, weight, bias_o = dcn_inputs(H, W, C, O, bf16, B)
        out = deform_conv.deform_conv_cuda(x, om, weight, bias_o)
        torch.cuda.synchronize()
        ref = deform_conv.plain_deform_conv(x, om, weight, bias_o)
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        bar = DCN_BF16_REL_TOL * max(1.0, ref_max)
        if out.dtype != bf16 or not math.isfinite(err) or err > bar:
            raise AssertionError(f"bf16 deform_conv B={B} H={H} W={W} C={C} O={O}: max abs err {err} > {bar}")
        M = B * H * W
        b_ms, b_by = bound_ms(2 * (M * C + M * 27 + O * 9 * C + O + M * O), 2 * M * O * 9 * C,
                              BF16_OPS_PER_S)
        row = dict(B=B, H=H, W=W, C=C, O=O, per_frame=per_frame, max_abs_err=err,
                   rel_err=err / max(1.0, ref_max), bar=bar,
                   ms=cold_ms(lambda: deform_conv.deform_conv_cuda(x, om, weight, bias_o)),
                   plain_ms=cold_ms(lambda: deform_conv.plain_deform_conv(x, om, weight, bias_o)),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
        conv16_rows.append(row)
        print("deform_conv_bf16 " + json.dumps(row))
    report["deform_conv_bf16_shapes"] = conv16_rows

    # ---- 8. full-width forward: card vs CPU, float32 and bf16 ------------
    model_cpu = create_model(cfg.model, device="cpu", seed=0)
    nodes = sorted((m.kernel.in_features // 9, m.kernel.out_features) for m in model_cpu.modules()
                   if isinstance(m, deform_conv.DeformConv2d))
    expect_nodes = sorted((C, O) for _, C, O, n in DCN_NODES for _ in range(n))
    if nodes != expect_nodes:
        raise AssertionError(f"decoder DCN nodes (C_in, C_out) {nodes}, expected {expect_nodes}")
    perturb_zero_init(model_cpu, torch.Generator().manual_seed(1))
    model = copy.deepcopy(model_cpu).to(dev)
    H, W = cfg.model.input_res
    Ho, Wo = cfg.model.output_res
    g = torch.Generator().manual_seed(2)
    centers = torch.rand(7, 2, generator=g) * torch.tensor([Wo - 10.0, Ho - 10.0]) + 5.0
    cls = geometry.render_gaussian_heatmap(centers, torch.ones(7), Ho, Wo, per_class=True)
    inputs = [torch.randn(1, H, W, 3, generator=g), torch.randn(1, H, W, 3, generator=g),
              torch.rand(1, H, W, 1, generator=g), torch.rand(1, H, W, 1, generator=g),
              cls.permute(1, 2, 0)[None].contiguous(), cls.roll(3, dims=2).permute(1, 2, 0)[None].contiguous()]
    no_launches = {name: 0 for name in build.KERNEL_SOURCES}
    per_frame_launches = dict(no_launches, biased_attention=3 * n_layers, deform_conv=16)
    per_frame_launches16 = dict(no_launches, biased_attention_bf16=3 * n_layers, deform_conv_bf16=16)
    with torch.no_grad():
        t0 = time.perf_counter()
        out_cpu = model_cpu(*inputs)
        cpu_s = time.perf_counter() - t0
        build.reset_launch_counts()
        out_gpu = model(*[x.to(dev) for x in inputs])
        torch.cuda.synchronize()
        fwd_counts = build.launch_counts()
    fwd = {"cpu_seconds": cpu_s, "launches": fwd_counts}
    for key in ("hm", "reg", "tracking"):
        a, b = out_gpu[key].cpu(), out_cpu[key]
        if a.shape != (1, Ho, Wo, b.shape[-1]) or not torch.isfinite(a).all():
            raise AssertionError(f"forward {key}: shape {tuple(a.shape)} or non-finite values")
        scale = max(1.0, b.abs().max().item())
        err = (a - b).abs().max().item()
        fwd[key] = {"max_abs_err": err, "max_abs_cpu": b.abs().max().item()}
        if err > FORWARD_REL_TOL * scale:
            raise AssertionError(f"forward {key}: card vs CPU max abs err {err} > {FORWARD_REL_TOL} x {scale}")
    if fwd_counts != per_frame_launches:
        raise AssertionError(f"forward launch counts {fwd_counts}, expected {per_frame_launches}")
    print("forward 480x480 dcn card vs cpu: " + json.dumps(fwd))
    report["forward"] = fwd

    # bf16 serving: the same weights cast to bf16, inputs cast as the JAX
    # package's make_bf16_apply casts them, heads back to float32
    model16 = bf16_inference_model(model)
    model16_cpu = bf16_inference_model(model_cpu)
    del model_cpu
    with torch.no_grad():
        t0 = time.perf_counter()
        out16_cpu = {k: v.float() for k, v in model16_cpu(*[x.to(bf16) for x in inputs]).items()}
        cpu16_s = time.perf_counter() - t0
        build.reset_launch_counts()
        out16_gpu = {k: v.float() for k, v in model16(*[x.to(dev, bf16) for x in inputs]).items()}
        torch.cuda.synchronize()
        fwd16_counts = build.launch_counts()
    del model16_cpu
    fwd16 = {"cpu_seconds": cpu16_s, "launches": fwd16_counts}
    for key in ("hm", "reg", "tracking"):
        a, b, f32 = out16_gpu[key].cpu(), out16_cpu[key], out_gpu[key].cpu()
        if a.shape != f32.shape or not torch.isfinite(a).all():
            raise AssertionError(f"bf16 forward {key}: shape {tuple(a.shape)} or non-finite values")
        scale = max(1.0, f32.abs().max().item())
        vs_f32 = (a - f32).abs().max().item()
        vs_cpu = (a - b).abs().max().item()
        fwd16[key] = {"card_vs_cpu_max_abs_err": vs_cpu, "bf16_vs_f32_max_abs_err": vs_f32,
                      "cpu_bf16_vs_card_f32_max_abs_err": (b - f32).abs().max().item(),
                      "max_abs_f32": f32.abs().max().item()}
        ulp = 2.0 ** (math.floor(math.log2(max(b.abs().max().item(), 1e-30))) - 7)
        fwd16[key]["bf16_ulp_at_cpu_max"] = ulp
        fwd16[key]["card_vs_cpu_ulps"] = vs_cpu / ulp
        if vs_f32 > BF16_VS_F32_REL_TOL * scale or vs_cpu > BF16_CARD_VS_CPU_ULPS * ulp:
            raise AssertionError(f"bf16 forward {key}: card bf16 vs card f32 {vs_f32} (bar "
                                 f"{BF16_VS_F32_REL_TOL} x {scale}), card vs CPU bf16 {vs_cpu} "
                                 f"(bar {BF16_CARD_VS_CPU_ULPS} x {ulp})")
    if fwd16_counts != per_frame_launches16:
        raise AssertionError(f"bf16 forward launch counts {fwd16_counts}, expected {per_frame_launches16}")
    print("forward 480x480 dcn bf16 card vs cpu and vs f32: " + json.dumps(fwd16))
    report["forward_bf16"] = fwd16

    # ---- 9. the streaming detectors on the card ---------------------------
    projs, raw, pos_cam = synthetic.make_sequence(torch.Generator().manual_seed(3), T_FRAMES,
                                                  return_pos_cam=True, device=dev)
    images, _, _ = det_lib.preprocess_frames(raw, cfg)
    x3d = synthetic.skeleton(dev)[None].expand(T_FRAMES, -1, -1).contiguous()
    K = synthetic.camera_K(dev)
    raw_hw = (synthetic.RAW_H, synthetic.RAW_W)
    timer = StageTimer()

    def drive(name, detector, video, steps, per_step, expect_shapes, n_streams=1):
        """Warm up on 2 frames, then one timed run with the launch counters
        reset just before it; then 2 profiled frames."""
        sub = slice_frames(video, 2, batched=n_streams > 1)
        detector(sub)
        torch.cuda.synchronize()
        timer.reset()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = detector(video)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = build.launch_counts()
        expect = {k: n * steps for k, n in per_step.items()}
        if counts != expect:
            raise AssertionError(f"{name}: launch counts {counts}, expected {expect}")
        check_result(res, expect_shapes)
        kps = res.detected_kps
        run = {"frame_steps": steps, "streams": n_streams, "wall_s": wall,
               "fps": n_streams * steps / wall, "stage_ms_per_step": timer.per_frame_ms(steps),
               "launches": counts,
               "valid_detections": int((kps > det_lib.KP_SENTINEL).all(-1).sum())}
        prof = profile_frames(detector, sub, torch)
        prof["device_busy_share"] = prof["device_kernel_ms_per_frame"] / (1e3 * wall / steps)
        run["profiled"] = prof
        print(f"detector {name}: " + json.dumps(run))
        return run, res

    K_, Hin, Win = cfg.model.num_classes, H, W
    single_shapes = {"detected_kps": (T_FRAMES, K_, 2), "scores": (T_FRAMES, K_),
                     "tracking": (T_FRAMES, K_, 2)}
    debug_shapes = dict(single_shapes, debug_hm=(T_FRAMES, Ho, Wo, K_),
                        debug_pre_hm=(T_FRAMES, Hin, Win, 1))
    runs = {}
    detector = det_lib.make_video_detector(model, cfg, K, raw_hw, device=dev, debug_outputs=True,
                                           stage_timer=timer)
    videos = {
        "teacher_forced": det_lib.VideoFrames(images=images, x3d=x3d, teacher_kps=projs),
        "closed_loop": det_lib.VideoFrames(images=images, x3d=x3d, init_kps=projs[0]),
    }
    for name, video in videos.items():
        runs[name], _ = drive(name, detector, video, T_FRAMES, per_frame_launches, debug_shapes)
    main_counts = runs["teacher_forced"]["launches"]
    runs["profiled_frame"] = runs["teacher_forced"]["profiled"]

    # bf16 serving runners
    warm_cfg = dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer, pnp_warm_start=True))
    closed = videos["closed_loop"]
    exact16 = det_lib.make_video_detector(model16, cfg, K, raw_hw, device=dev, stage_timer=timer)
    runs["bf16_exact"], res16 = drive("bf16_exact", exact16, closed, T_FRAMES, per_frame_launches16,
                                      single_shapes)
    counts16 = runs["bf16_exact"]["launches"]
    cached16 = det_lib.make_cached_video_detector(model16, warm_cfg, K, raw_hw, device=dev,
                                                  stage_timer=timer)
    runs["bf16_cached_warm_start"], _ = drive("bf16_cached_warm_start", cached16, closed, T_FRAMES,
                                              per_frame_launches16, single_shapes)
    # the cached runner's trunk stage launches what ONE trunk call launches
    one_trunk = trunk_launches(model16, images[:1], torch)
    cached_trunk = runs["bf16_cached_warm_start"]["profiled"]["launches_per_frame_by_stage"]["trunk"]
    exact_trunk = runs["bf16_exact"]["profiled"]["launches_per_frame_by_stage"]["trunk"]
    runs["bf16_cached_warm_start"]["one_trunk_call_launches"] = one_trunk
    if cached_trunk != one_trunk:
        raise AssertionError(f"cached runner: trunk stage launches {cached_trunk} per frame, one "
                             f"trunk call launches {one_trunk}")
    print(f"cached trunk: {cached_trunk} launches per frame = one trunk call ({one_trunk}); "
          f"the exact runner's trunk stage: {exact_trunk}")
    # 8 distinct videos, each closed-loop from its own initial keypoints
    vids = [synthetic.make_sequence(torch.Generator().manual_seed(10 + v), T_FRAMES, device=dev)
            for v in range(N_VIDEOS)]
    bprojs = torch.stack([p for p, _ in vids])
    bimages, _, _ = det_lib.preprocess_frames(torch.stack([r for _, r in vids]), cfg)
    bvideo = det_lib.VideoFrames(images=bimages, x3d=x3d[None].expand(N_VIDEOS, -1, -1, -1),
                                 init_kps=bprojs[:, 0])
    batched16 = det_lib.make_batched_video_detector(model16, cfg, K, raw_hw, device=dev,
                                                    stage_timer=timer)
    runs["bf16_batched_8_videos"], _ = drive(
        "bf16_batched_8_videos", batched16, bvideo, T_FRAMES, per_frame_launches16,
        {k: (N_VIDEOS,) + s for k, s in single_shapes.items()}, n_streams=N_VIDEOS)
    report["detector"] = runs

    # ---- 10. the eval harness on the card ---------------------------------
    # the bf16 exact run's detections (random weights: few or none), then
    # the ground truth with 0.5 px of seeded noise, whose scores are known:
    # every in-frame keypoint found within a pixel on average, every PnP
    # solved, ADD below the 6 cm of the ADD AUC (on the CPU: mean 1.3 cm,
    # max 3.1 cm; depth is the weak direction of a 0.5 m arm at 2.4 m)
    gt = projs.cpu().numpy()
    noisy = gt + 0.5 * torch.randn(gt.shape, generator=torch.Generator().manual_seed(5)).numpy()
    report["eval"] = {}
    for name, det in (("bf16_exact_run", res16.detected_kps.cpu().numpy()), ("gt_plus_0.5px", noisy)):
        t0 = time.perf_counter()
        ev = analyze_sequence_results(det.astype("float32"), gt, pos_cam.cpu().numpy(), K.cpu().numpy(),
                                      (synthetic.RAW_W, synthetic.RAW_H), rf=True, device=dev)
        evr = {"seconds": time.perf_counter() - t0, "keypoint_metrics": ev["keypoint_metrics"],
               "pnp_metrics": ev["pnp_metrics"]}
        if ev["adds"].shape != (T_FRAMES,) or not all(math.isfinite(a) for a in ev["adds"].tolist()):
            raise AssertionError(f"eval {name}: ADD {ev['adds']}")
        print(f"eval harness on {name}: " + json.dumps(evr))
        report["eval"][name] = evr
    kp, pm = report["eval"]["gt_plus_0.5px"]["keypoint_metrics"], report["eval"]["gt_plus_0.5px"]["pnp_metrics"]
    if (kp["num_found_gt_inframe"] != kp["num_gt_inframe"] or kp["l2_error_mean_px"] > 1.0
            or pm["num_pnp_found"] != T_FRAMES or pm["add_mean"] > 0.03 or pm["add_max"] > 0.06):
        raise AssertionError(f"eval harness on noisy ground truth: {kp} {pm}")

    # ---- 11. training; 12. the inference CLI on its checkpoint -------------
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ckpt = os.path.join(work, "train_demo.pt")
        train = training_phase(torch, dev, gen, cfg, cold_ms, no_launches, ckpt)
        report["training"] = train
        cli = cli_phase(torch, ckpt, work, no_launches)
        report["cli"] = cli
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 13. kernels line --------------------------------------------------
    def per_frame(rows, key, unit="per_frame"):
        """Sum over the shapes one frame (or one training step) runs."""
        vals = [r[key] for r in rows if r[unit]]
        if any(v is None for v in vals):
            return None
        return sum(r[key] * r[unit] for r in rows if r[unit])

    rates = {"biased_attention": "67 TFLOP/s float32 FMA", "deform_sample": "67 TFLOP/s float32 FMA",
             "deform_conv": "165 TFLOP/s 3xTF32 (495 / 3)",
             "biased_attention_bf16": "67 TFLOP/s float32 FMA",
             "deform_conv_bf16": "989 TFLOP/s dense bf16"}
    kernels = []
    for name, rows, source, replaces, counts, prof in (
        ("biased_attention", attn_rows, "sgtapose_tpu_torch/csrc/biased_attention.cu",
         "sgtapose_tpu/ops/attention_kernel.py:108", main_counts, runs["teacher_forced"]),
        ("biased_attention_bf16", attn16_rows, "sgtapose_tpu_torch/csrc/biased_attention.cu",
         "sgtapose_tpu/ops/attention_kernel.py:108", counts16, runs["bf16_exact"]),
        ("deform_conv", conv_rows, "sgtapose_tpu_torch/csrc/deform_conv.cu",
         "sgtapose_tpu/models/deform_conv.py:329", main_counts, runs["teacher_forced"]),
        ("deform_conv_bf16", conv16_rows, "sgtapose_tpu_torch/csrc/deform_conv.cu",
         "sgtapose_tpu/models/deform_conv.py:329", counts16, runs["bf16_exact"]),
    ):
        bounds = [r["bound_by"] for r in rows if r["per_frame"]]
        bound_by = max(set(bounds), key=bounds.count)
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name],
            "launches_per_frame": counts[name] // T_FRAMES,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": per_frame(rows, "ms"), "plain_ms": per_frame(rows, "plain_ms"),
            "bound_ms": per_frame(rows, "bound_ms"), "bound_by": bound_by,
            "bound_rate": "3.35 TB/s HBM" if bound_by == "bytes" else rates[name],
            "library_ms": per_frame(rows, "library_ms"),
            "profiled_ms_per_frame": prof["profiled"]["kernel_ms_per_frame"][name],
        }
        if name.startswith("biased_attention"):
            entry["warm_ms"] = per_frame(rows, "warm_ms")
            entry["clean_ms"] = per_frame(rows, "clean_ms")
        if name == "deform_conv":
            entry["pair_ms"] = per_frame(rows, "pair_ms")
        if name.startswith("deform_conv"):
            entry["library_ms_note"] = "no single PyTorch call computes this function"
        kernels.append(entry)
    # the key-tiled attention, read from phase 12's depth run (per frame of a
    # 42-keypoint model)
    depth_launches = cli["depth"]["launches"]["biased_attention_tiled"]
    kernels.append({
        "name": "biased_attention_tiled", "route": "cuda", "source": "sgtapose_tpu_torch/csrc/biased_attention.cu",
        "replaces": "sgtapose_tpu/ops/attention_kernel.py:108", "launches": depth_launches,
        "launches_per_frame": depth_launches // DEPTH_FRAMES,
        "max_abs_err": max(r["max_abs_err"] for r in tiled_rows),
        "ms": per_frame(tiled_rows, "ms"), "plain_ms": per_frame(tiled_rows, "plain_ms"),
        "bound_ms": per_frame(tiled_rows, "bound_ms"), "bound_by": tiled_rows[0]["bound_by"],
        "bound_rate": "3.35 TB/s HBM" if tiled_rows[0]["bound_by"] == "bytes" else rates["biased_attention"],
        "library_ms": per_frame(tiled_rows, "library_ms"),
        "shapes_note": "levels 0 and 1 of a 42-keypoint model (phase 12's depth run), per frame"})
    # the training kernels, read from the train_demo run (per step)
    # (deform_sample_bwd launches 0 times per step since deform_conv_dgrad;
    # its per-step sums are those of the route it was on, for comparison)
    rates.update(biased_attention_bwd="67 TFLOP/s float32 FMA", deform_sample_bwd="67 TFLOP/s float32 FMA",
                 deform_conv_dgrad="165 TFLOP/s 3xTF32 (495 / 3)")
    for name, rows, source, replaces in (
        ("deform_sample", dcn_rows, "sgtapose_tpu_torch/csrc/deform_sample.cu",
         "sgtapose_tpu/models/deform_conv.py:104"),
        ("biased_attention_bwd", train["attention_bwd_shapes"], "sgtapose_tpu_torch/csrc/biased_attention_bwd.cu",
         "sgtapose_tpu/ops/attention_kernel.py:145"),
        ("deform_conv_dgrad", dgrad_rows, "sgtapose_tpu_torch/csrc/deform_conv_bwd.cu",
         "sgtapose_tpu/models/deform_conv.py:188"),
        ("deform_sample_bwd", dcn_bwd_rows, "sgtapose_tpu_torch/csrc/deform_sample_bwd.cu",
         "sgtapose_tpu/models/deform_conv.py:130"),
    ):
        bounds = [r["bound_by"] for r in rows if r["per_step"]]
        bound_by = max(set(bounds), key=bounds.count)
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train["launches"][name],
            "launches_per_step": train["launches"][name] // TRAIN_STEPS,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": per_frame(rows, "ms", "per_step"), "plain_ms": per_frame(rows, "plain_ms", "per_step"),
            "bound_ms": per_frame(rows, "bound_ms", "per_step"), "bound_by": bound_by,
            "bound_rate": "3.35 TB/s HBM" if bound_by == "bytes" else rates[name],
            "library_ms": per_frame(rows, "library_ms", "per_step"),
            "profiled_ms_per_step": train["profiled"]["kernel_ms_per_step"][name],
        }
        if name == "deform_conv_dgrad":
            entry["pair_ms"] = per_frame(rows, "pair_ms", "per_step")
            entry["matmul_ms"] = per_frame(rows, "matmul_ms", "per_step")
            entry["ms_zero_offsets"] = sum(
                r["ms"] * n for r in rows if r["offsets"] == 0.0
                for H_, C_, O_, n in DCN_NODES if (r["H"], r["C"], r["O"]) == (H_, C_, O_))
            entry["offsets_note"] = "ms, pair_ms, plain_ms at offsets in [-3, 3] px"
        if name == "deform_sample_bwd":
            entry["note"] = "off the path since deform_conv_dgrad; ms summed over the 16 nodes it ran on"
        if name.startswith("deform"):
            entry["library_ms_note"] = "no single PyTorch call computes this function"
        else:
            entry["library_ms_note"] = "backward of F.scaled_dot_product_attention with a float mask"
        kernels.append(entry)
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"chip_smoke: {report['seconds']:.1f} s after the card check")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def training_phase(torch, dev, gen, cfg, cold_ms, no_launches, ckpt):
    """Phase 11 (module docstring): the attention backward kernel against
    its plain version, the full-width gradients card vs CPU (train mode and
    eval mode), the fixed-batch steps, the train_demo run with its eval
    (its trained state saved to `ckpt`), and a profiled step."""
    import copy

    import torch.nn.functional as F

    from sgtapose_tpu_torch.cli import train_demo
    from sgtapose_tpu_torch.data import pipeline, synthetic
    from sgtapose_tpu_torch.models.attention import set_dropout_rate
    from sgtapose_tpu_torch.models.sgta import create_model
    from sgtapose_tpu_torch.ops import attention_kernel, build
    from sgtapose_tpu_torch.train import trainer
    from sgtapose_tpu_torch.train.loss import sgta_loss
    from sgtapose_tpu_torch.train.phases import model_inputs

    out = {}
    h = cfg.model.n_heads
    n_layers = cfg.model.num_decoder_layers
    # (n, d, backward launches per step): levels 0 and 1 feed no head (the
    # decoder starts at level 2), so autograd runs only level 2's backward,
    # once per tied layer
    # level 2 and the ragged (100, 8) take the cluster path, also at B = 1, 2
    shapes = []
    for i in range(3):
        kernel = cfg.model.kernel_list[i]
        n = cfg.model.num_classes * cfg.model.k_list[i] * (1 + 2 * (kernel // 2)) ** 2
        shapes.append((n, 4 * 2 ** i, n_layers if i == 2 else 0, TRAIN_BATCH))
        if i == 2:
            shapes += [(n, 16, 0, 1), (n, 16, 0, 2)]
    shapes += [(100, 8, 0, B) for B in (1, 2, TRAIN_BATCH)]  # ragged n, not on the main path
    rows = []
    for n, d, per_step, B in shapes:
        q, k, v, dout = (torch.randn(B, h, n, d, generator=gen, device=dev) for _ in range(4))
        bias = 0.3 * torch.randn(h, n, n, generator=gen, device=dev)
        o = attention_kernel.biased_attention_cuda(q, k, v, bias)
        got = attention_kernel.biased_attention_bwd_cuda(q, k, v, bias, o, dout)
        torch.cuda.synchronize()
        ref = attention_kernel.plain_biased_attention_backward(q, k, v, bias, o, dout)
        errs = {name: rel_err(a, r) for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref)}
        if not all(math.isfinite(e) and e <= BWD_REL_TOL for e in errs.values()):
            raise AssertionError(f"attention backward n={n} d={d} B={B}: rel errors {errs} > {BWD_REL_TOL}")
        again = attention_kernel.biased_attention_bwd_cuda(q, k, v, bias, o, dout)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"attention backward n={n} d={d} B={B}: two runs differ (no atomics: "
                                 "dbias must be the same bit for bit)")
        # SDPA with a float mask that requires grad: its backward alone
        qs, ks, vs, bs = (t.detach().clone().requires_grad_() for t in (q, k, v, bias))
        y = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bs)
        # read the bias and q, k, v, O, dO once, write dbias and dq, dk, dv
        # once; ~10d + 5 FLOPs per (b, head, i, j) (S and dP recomputed, dS,
        # three d-long products)
        b_ms, b_by = bound_ms(4 * (2 * h * n * n + 8 * B * h * n * d), B * h * n * n * (10 * d + 5))
        row = dict(n=n, d=d, B=B, per_step=per_step, rel_err=errs, dbias_bitwise_equal=True,
                   path="cluster" if attention_kernel.bwd_uses_cluster(n, d) else "two_pass",
                   max_abs_err=max((a - r).abs().max().item() for a, r in zip(got, ref)),
                   ms=cold_ms(lambda: attention_kernel.biased_attention_bwd_cuda(q, k, v, bias, o, dout)),
                   plain_ms=cold_ms(lambda: attention_kernel.plain_biased_attention_backward(q, k, v, bias, o, dout)),
                   library_ms=cold_ms(lambda: y.backward(dout, retain_graph=True)),
                   bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        print("attention_bwd " + json.dumps(row))
        del q, k, v, dout, bias, o, got, again, ref, qs, ks, vs, bs, y
    out["attention_bwd_shapes"] = rows

    # one full-width train-step gradient (480x480, batch 1, dropout off):
    # card float32 and CPU float32 against a CPU float64 reference; seeded
    # weights with the zero-initialised ones perturbed, except the DCN
    # offset/mask convs, kept at flax's zero init (offsets of a few pixels
    # make float32 train-mode gradients far noisier on either device)
    model_cpu = create_model(cfg.model, device="cpu", seed=0)
    perturb_zero_init(model_cpu, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for name, p in model_cpu.named_parameters():
            if "conv_offset_mask" in name:
                p.zero_()
    set_dropout_rate(model_cpu, 0.0)
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    model_64 = copy.deepcopy(model_cpu).double()
    raw = synthetic.make_raw_batch(torch.Generator().manual_seed(6), 1, device="cpu")
    batch_cpu = pipeline.make_batch_fn(cfg, synthetic.camera_K())(torch.Generator().manual_seed(7), raw)
    batch_64 = {k: v.double() if v.is_floating_point() else v for k, v in batch_cpu.items()}
    grads = {}
    for where, model, batch in (("card", model_gpu, {k: v.to(dev) for k, v in batch_cpu.items()}),
                                ("cpu", model_cpu, batch_cpu), ("cpu_float64", model_64, batch_64)):
        t0 = time.perf_counter()
        counts0 = build.launch_counts()
        with plain_autograd() if where == "cpu_float64" else contextlib.nullcontext():
            model.train()
            loss, _ = sgta_loss(model(*model_inputs("PlanA_win", batch)), batch)
            loss.backward()
        if where == "card":
            torch.cuda.synchronize()
            launched = {kn: c - counts0[kn] for kn, c in build.launch_counts().items()}
        out[f"grad_{where}_seconds"] = time.perf_counter() - t0
        grads[where] = {name: p.grad.double().cpu() for name, p in model.named_parameters() if p.grad is not None}
    expect = dict(no_launches, biased_attention=3 * n_layers, biased_attention_bwd=n_layers,
                  deform_conv=16, deform_sample=16, deform_conv_dgrad=16)
    if launched != expect:
        raise AssertionError(f"gradient step launches {launched}, expected {expect}")
    ref = grads["cpu_float64"]
    if not set(grads["card"]) == set(grads["cpu"]) == set(ref):
        raise AssertionError("card, CPU and reference reach different parameters")
    live = [name for name, g in ref.items() if g.abs().max().item() > 1e-6]
    cmp = {where: grad_errors(grads[where], ref, live) for where in ("card", "cpu")}
    out["grad_vs_float64"] = dict(cmp, tensors=len(live), bars=[GRAD_WORST_TOL, GRAD_L2_TOL],
                                  input="480x480, batch 1")
    print("train-step gradient 480x480 batch 1 vs float64: " + json.dumps(out["grad_vs_float64"])
          + f" (card {out['grad_card_seconds']:.2f} s, cpu {out['grad_cpu_seconds']:.1f} s, "
          f"float64 {out['grad_cpu_float64_seconds']:.1f} s)")
    worst = cmp["card"]["worst"][0][1]
    if not math.isfinite(worst) or worst > GRAD_WORST_TOL or not cmp["card"]["l2"] <= GRAD_L2_TOL:
        raise AssertionError(f"train-step gradients, card vs float64: {cmp['card']} (bars {GRAD_WORST_TOL} "
                             f"per tensor, {GRAD_L2_TOL} in L2)")
    out["grad_eval_mode_vs_float64"] = eval_mode_gradient_check(torch, dev, cfg, batch_cpu, no_launches)
    del model_cpu, model_gpu, model_64, grads, batch_cpu, batch_64

    # the train_demo path, float32, 480x480, batch 8: FIXED_STEPS steps on one
    # fixed batch (the loss must fall), through the entry points a user calls
    argv = ["--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH), "--eval_videos", "1",
            "--eval_frames", "8", "--log_every", "5", "--ckpt_out", ckpt]
    args = train_demo.parse_args(argv)
    tcfg = train_demo.make_config(args)
    state = trainer.create_train_state(tcfg, args.seed, max_iters=FIXED_STEPS, device=dev)
    raw = synthetic.make_raw_batch(train_demo.step_generator(args.seed, 0, 0), TRAIN_BATCH, device=dev)
    fixed = pipeline.make_batch_fn(tcfg, synthetic.camera_K())(train_demo.step_generator(args.seed, 0, 1), raw)
    losses = [trainer.train_step(state, fixed)["tot"].item() for _ in range(FIXED_STEPS)]
    out["fixed_batch_losses"] = losses
    print(f"fixed batch, {FIXED_STEPS} steps: losses {losses}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"fixed-batch training: losses {losses} are not finite or do not fall")

    # a profiled step on the fixed batch: device time per kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            trainer.train_step(state, fixed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    events = list(prof.events())
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3 / 2
    out["profiled"] = {
        "kernel_ms_per_step": {name: sum(e.time_range.elapsed_us() for e in device if fn in e.name) / 1e3 / 2
                               for name, fn in DEVICE_NAMES.items()},
        "device_kernel_ms_per_step": device_ms, "profiled_wall_ms_per_step": wall_ms,
        "device_busy_share": device_ms / wall_ms,
        "launches_per_step": len(_launch_events(events)) / 2}
    print("profiled train step: " + json.dumps(out["profiled"]))
    del state, fixed, raw

    # train_demo.main: TRAIN_STEPS steps on fresh batches, then its eval
    timer = StageTimer()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_demo.main(argv, stage_timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    stage_ms = timer.per_frame_ms(TRAIN_STEPS)
    expect = {"biased_attention": 3 * n_layers, "biased_attention_bwd": n_layers, "deform_conv": 16,
              "deform_sample": 16, "deform_conv_dgrad": 16, "deform_sample_bwd": 0}
    per_step = {kn: counts[kn] / TRAIN_STEPS for kn in expect}
    if per_step != expect:
        raise AssertionError(f"train_demo launches per step {per_step}, expected {expect}")
    if counts["biased_attention_bf16"] != 3 * n_layers * 8 or counts["deform_conv_bf16"] != 16 * 8:
        raise AssertionError(f"train_demo eval launches {counts}: expected the bf16 kernels once per frame")
    losses = [e["tot"] for e in res["logged"]]
    ev = res["results"]
    if not all(math.isfinite(x) for x in losses) or ev["adds"].shape != (8,) or not all(
            math.isfinite(a) for a in ev["adds"].tolist()):
        raise AssertionError(f"train_demo: losses {losses}, eval ADD {ev['adds']}")
    train_ms = sum(stage_ms[st] for st in TRAIN_STAGES)
    out["train_demo"] = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "wall_s_with_setup_and_eval": wall,
                         "stage_ms_per_step": stage_ms, "step_ms": train_ms,
                         "steps_per_s": 1e3 / train_ms, "launches": counts,
                         "launches_per_step": per_step, "logged": res["logged"],
                         "eval": {"fps": res["fps"], "keypoint_metrics": ev["keypoint_metrics"],
                                  "pnp_metrics": ev["pnp_metrics"]},
                         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["launches"] = counts
    print("train_demo 480x480 batch 8: " + json.dumps(out["train_demo"]))
    return out


def grad_errors(got, ref, live):
    """Worst 3 tensors by max|got - ref| / max|ref|, and the L2 error over
    all `live` tensors relative to the reference's L2 norm."""
    errs = {name: ((got[name] - ref[name]).abs().max() / ref[name].abs().max()).item() for name in live}
    l2 = math.sqrt(sum(((got[n] - ref[n]) ** 2).sum().item() for n in live)
                   / sum((ref[n] ** 2).sum().item() for n in live))
    return {"worst": sorted(errs.items(), key=lambda kv: -kv[1])[:3], "l2": l2}


def eval_mode_gradient_check(torch, dev, cfg, batch_cpu, no_launches):
    """0b of phase 11: the loss's parameter gradients at 480x480, batch 1,
    BatchNorm in eval mode (running statistics), seeded weights with the
    zero-initialised ones perturbed, DCN offset/mask convs included: the
    card in float32 against the CPU in float64 (plain versions), at
    EVAL_GRAD_WORST_TOL per tensor and EVAL_GRAD_L2_TOL in L2."""
    from sgtapose_tpu_torch.models.sgta import create_model
    from sgtapose_tpu_torch.ops import build
    from sgtapose_tpu_torch.train.loss import sgta_loss
    from sgtapose_tpu_torch.train.phases import model_inputs

    model_64 = create_model(cfg.model, device="cpu", seed=0)
    perturb_zero_init(model_64, torch.Generator().manual_seed(1))
    model_gpu = copy.deepcopy(model_64).to(dev).eval()
    model_64 = model_64.double().eval()
    batch_64 = {k: v.double() if v.is_floating_point() else v for k, v in batch_cpu.items()}
    grads, seconds = {}, {}
    for where, model, batch in (("card", model_gpu, {k: v.to(dev) for k, v in batch_cpu.items()}),
                                ("cpu_float64", model_64, batch_64)):
        t0 = time.perf_counter()
        build.reset_launch_counts()
        with plain_autograd() if where == "cpu_float64" else contextlib.nullcontext():
            loss, _ = sgta_loss(model(*model_inputs("PlanA_win", batch)), batch)
            loss.backward()
        if where == "card":
            torch.cuda.synchronize()
            launched = build.launch_counts()
        seconds[where] = time.perf_counter() - t0
        grads[where] = {name: p.grad.double().cpu() for name, p in model.named_parameters() if p.grad is not None}
    expect = dict(no_launches, biased_attention=9, biased_attention_bwd=3, deform_conv=16, deform_sample=16,
                  deform_conv_dgrad=16)
    if launched != expect:
        raise AssertionError(f"eval-mode gradient launches {launched}, expected {expect}")
    ref = grads["cpu_float64"]
    if set(grads["card"]) != set(ref):
        raise AssertionError("card and reference reach different parameters")
    live = [name for name, g in ref.items() if g.abs().max().item() > 1e-6]
    res = dict(grad_errors(grads["card"], ref, live), tensors=len(live), seconds=seconds,
               bars=[EVAL_GRAD_WORST_TOL, EVAL_GRAD_L2_TOL], input="480x480, batch 1, BN eval mode",
               offset_grad_max=max(ref[n].abs().max().item() for n in live if "conv_offset_mask" in n))
    # the layers in network order: where the error enters
    res["by_module"] = {}
    for name in live:
        mod = name.rsplit(".", 2)[0]
        e = ((grads["card"][name] - ref[name]).abs().max() / ref[name].abs().max()).item()
        res["by_module"][mod] = max(res["by_module"].get(mod, 0.0), e)
    print("eval-mode gradient 480x480 batch 1, offsets perturbed, card vs float64: "
          + json.dumps({k: v for k, v in res.items() if k != "by_module"}))
    worst = res["worst"][0][1]
    if not math.isfinite(worst) or worst > EVAL_GRAD_WORST_TOL or not res["l2"] <= EVAL_GRAD_L2_TOL:
        top = sorted(res["by_module"].items(), key=lambda kv: -kv[1])[:8]
        raise AssertionError(f"eval-mode gradients, card vs float64: worst {res['worst']}, L2 {res['l2']} "
                             f"(bars {EVAL_GRAD_WORST_TOL} per tensor, {EVAL_GRAD_L2_TOL} in L2); "
                             f"by module: {top}")
    return res


def upscale_second_video(root, set_name) -> None:
    """Make a DREAM-real set mixed-resolution: the second video's frames
    upscaled 2x, their projected keypoints scaled to match."""
    from PIL import Image

    set_dir = os.path.join(root, set_name)
    with open(os.path.join(root, "dream_real_info", f"{set_name}_split_info.json")) as fh:
        split = json.load(fh)
    for img_rel, js_rel in zip(split["img_paths"][1], split["json_paths"][1]):
        path = os.path.join(set_dir, img_rel)
        im = Image.open(path)
        im.resize((im.width * 2, im.height * 2), Image.BILINEAR).save(path)
        with open(os.path.join(set_dir, js_rel)) as fh:
            blob = json.load(fh)
        for kp in blob["objects"][0]["keypoints"]:
            kp["projected_location"] = [2 * x for x in kp["projected_location"]]
        with open(os.path.join(set_dir, js_rel), "w") as fh:
            json.dump(blob, fh)


def cli_phase(torch, ckpt, work, no_launches):
    """Phase 12 (module docstring): `cli.infer.main` on the card at the
    flagship config on datasets the port's writers put in `work`: synthetic
    with the phase-11 checkpoint and --rf --multi_frame 2 --track --debug 1,
    DREAM-real at two resolutions, 42-keypoint depth with random weights,
    each with its launches asserted per frame and its files checked; then
    the card against the CPU on a 2-frame copy of the first video."""
    import numpy as np
    from PIL import Image

    from sgtapose_tpu_torch.cli import infer
    from sgtapose_tpu_torch.data import synthetic
    from sgtapose_tpu_torch.infer.detector import KP_SENTINEL
    from sgtapose_tpu_torch.ops import build

    out = {}
    syn, real, depth, syn2 = (os.path.join(work, d) for d in ("syn", "real", "depth", "syn2"))
    t0 = time.perf_counter()
    synthetic.write_synthetic_dataset(syn, CLI_VIDEOS, CLI_FRAMES, seed=4)
    synthetic.write_real_dataset(real, "panda-mixed", REAL_VIDEOS, REAL_FRAMES, seed=5)
    upscale_second_video(real, "panda-mixed")
    synthetic.write_depth_dataset(depth, "panda-depth", DEPTH_FRAMES, seed=6)
    os.makedirs(os.path.join(syn2, "00000"))
    for f in range(2):
        for suffix in ("_color.png", "_meta.json"):
            shutil.copy(os.path.join(syn, "00000", f"{f:04d}{suffix}"), os.path.join(syn2, "00000"))
    out["write_seconds"] = time.perf_counter() - t0

    def run(name, argv, frames, per_frame, device="cuda"):
        """One CLI run, the launch counters reset just before it and read
        just after; the launches asserted per frame (card runs)."""
        out_dir = os.path.join(work, "out_" + name)
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = infer.main(argv + ["--output_dir", out_dir, "--device", device])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = build.launch_counts()
        expect = dict(no_launches, **{k: n * frames for k, n in per_frame.items()})
        if counts != expect:
            raise AssertionError(f"cli {name}: launch counts {counts}, expected {expect}")
        rec = {"frames": frames, "wall_s_with_setup_and_eval": wall, "launches": counts,
               "timing": res["timing"], "keypoint_metrics": res["keypoint_metrics"],
               "pnp_metrics": res["pnp_metrics"]}
        for key in ("multiframe_pnp_metrics", "multiframe_pnp_real_metrics"):
            if key in res:
                rec[key] = res[key]
        print(f"cli {name}: " + json.dumps(rec))
        return res, rec, out_dir

    flagship = {"biased_attention": 9, "deform_conv": 16}
    n_syn = CLI_VIDEOS * CLI_FRAMES
    res, out["synthetic"], out_dir = run(
        "synthetic", ["--dataset", syn, "--ckpt", ckpt, "--rf", "--multi_frame", "2", "--track", "--debug", "1"],
        n_syn, flagship)
    need = ["syn_keypoints.csv", "syn_pnp_results.csv", "syn_analysis_results.txt", "dt_and_gt.json",
            "syn_2_pnp_results.csv", "syn_2_real_pnp_results.csv", "tracks.json"]
    missing = [f for f in need if not os.path.exists(os.path.join(out_dir, f))]
    debug = {f"{v:05d}_{f:04d}_{kind}.png" for v in range(CLI_VIDEOS) for f in range(CLI_FRAMES)
             for kind in ("generic", "pred_hm", "pre_hm")}
    if missing or set(os.listdir(os.path.join(out_dir, "debug"))) != debug:
        raise AssertionError(f"cli synthetic: missing {missing} or debug images "
                             f"{sorted(os.listdir(os.path.join(out_dir, 'debug')))}")
    with open(os.path.join(out_dir, "dt_and_gt.json")) as f:
        dt = json.load(f)
    det = np.asarray(dt["detections"])
    with open(os.path.join(out_dir, "tracks.json")) as f:
        tracks = json.load(f)
    if (len(dt["names"]) != n_syn or det.shape != (n_syn, 7, 2) or not np.isfinite(det).all()
            or sorted(tracks) != [f"{v:05d}" for v in range(CLI_VIDEOS)]
            or any(np.asarray(t).shape != (CLI_FRAMES, 7) for t in tracks.values())
            or "multiframe_pnp_metrics" not in res):
        raise AssertionError(f"cli synthetic: detections {det.shape}, tracks {sorted(tracks)}")
    print(f"cli synthetic: {res['timing']['fps']:.2f} fps, stage seconds per video "
          + json.dumps(res["timing"]["stage_s"]))

    n_real = REAL_VIDEOS * REAL_FRAMES
    res, out["real_mixed"], _ = run(
        "real_mixed", ["--dataset", real, "--is_real", "panda-mixed", "--robot", "panda", "--ckpt", ckpt],
        n_real, flagship)
    km = res["keypoint_metrics"]
    if res["timing"]["runners"] != 2 or km["num_gt_inframe"] + km["num_gt_outframe"] != n_real * 7:
        raise AssertionError(f"cli real: {res['timing']} runners, GT counts {km}")

    res, out["depth"], _ = run(
        "depth", ["--dataset", depth, "--is_real", "panda-depth", "--depth"], DEPTH_FRAMES,
        {"biased_attention": 3, "biased_attention_tiled": 6, "deform_conv": 16})
    km = res["keypoint_metrics"]
    if km["num_gt_inframe"] + km["num_gt_outframe"] != DEPTH_FRAMES * DEPTH_CLASSES:
        raise AssertionError(f"cli depth: GT counts {km}")

    # card against CPU on a 2-frame copy of the first synthetic video: with
    # the phase-11 checkpoint, and with its hm bias at 0 (the heatmaps sit
    # mid-range and peaks decode); there only frame 0 is held to the
    # keypoint bar, since frame 1's prior PnP on such detections is the
    # degenerate EPnP case (ROADMAP Queue 3)
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    payload["model"]["hm.Conv_1.bias"].zero_()
    ckpt_hm0 = os.path.join(work, "hm_bias_0.pt")
    torch.save(payload, ckpt_hm0)
    out["card_vs_cpu"] = {}
    for tag, weights, frames in (("train_demo", ckpt, [0, 1]), ("hm_bias_0", ckpt_hm0, [0])):
        argv = ["--dataset", syn2, "--ckpt", weights, "--track", "--debug", "1", "--max_videos", "1"]
        side = {}
        for device in ("cuda", "cpu"):
            _, rec, out_dir = run(f"two_frames_{tag}_{device}", argv, 2, flagship if device == "cuda" else {},
                                  device)
            with open(os.path.join(out_dir, "dt_and_gt.json")) as f:
                rec["det"] = np.asarray(json.load(f)["detections"])[frames]
            with open(os.path.join(out_dir, "tracks.json")) as f:
                rec["tracks"] = json.load(f)["00000"]
            rec["dir"] = out_dir
            side[device] = rec
        a, b = side["cuda"]["det"], side["cpu"]["det"]
        va, vb = (a > KP_SENTINEL).all(-1), (b > KP_SENTINEL).all(-1)
        kp_err = float(np.abs(a[va] - b[vb]).max()) if va.any() and (va == vb).all() else 0.0
        tracks_equal = [side["cuda"]["tracks"][f] for f in frames] == [side["cpu"]["tracks"][f] for f in frames]
        blend_err = 0
        for name in sorted(os.listdir(os.path.join(side["cpu"]["dir"], "debug"))):
            # {video}_{frame}_{kind}.png: the heatmap blends of the compared frames
            if not name.endswith("_generic.png") and int(name.split("_")[1]) in frames:
                imgs = [np.asarray(Image.open(os.path.join(side[d]["dir"], "debug", name))).astype(np.int16)
                        for d in ("cuda", "cpu")]
                blend_err = max(blend_err, int(np.abs(imgs[0] - imgs[1]).max()))
        cmp = {"frames_compared": frames, "valid_detections": int(va.sum()), "keypoint_max_abs_err_px": kp_err,
               "blend_max_abs_err": blend_err, "tracks_equal": tracks_equal,
               "cpu_wall_s": side["cpu"]["wall_s_with_setup_and_eval"]}
        out["card_vs_cpu"][tag] = cmp
        print(f"cli card vs cpu, 2 frames, {tag}: " + json.dumps(cmp))
        if (va != vb).any() or kp_err > CLI_KP_TOL or blend_err > CLI_BLEND_TOL or not tracks_equal:
            raise AssertionError(f"cli card vs cpu ({tag}): {cmp} (bars {CLI_KP_TOL} px, {CLI_BLEND_TOL} levels)")
    return out


@contextlib.contextmanager
def plain_autograd():
    """Route the DCN and the attention through torch autograd of their plain
    versions (their autograd Functions and kernels run float32 only), for a
    float64 reference on the CPU."""
    from sgtapose_tpu_torch.models import attention, deform_conv
    from sgtapose_tpu_torch.ops import attention_kernel

    saved = deform_conv.deform_conv, attention.fused_biased_attention
    deform_conv.deform_conv = deform_conv.plain_deform_conv
    attention.fused_biased_attention = attention_kernel.plain_biased_attention
    try:
        yield
    finally:
        deform_conv.deform_conv, attention.fused_biased_attention = saved


def perturb_zero_init(model, gen) -> None:
    """Seeded noise where flax starts at zero or symmetric (pos_embed, the
    DCN offset/mask convs, the bilinear up-convs) and on the BN statistics,
    so every kernel input carries signal: offsets of a few pixels, some out of
    bounds."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if name.endswith("pos_embed") or name.endswith(".up.weight"):
                p.add_(0.1 * noise)
            elif "conv_offset_mask" in name:
                p.add_(noise / math.sqrt(p[0].numel()) if name.endswith("weight") else noise)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.add_(0.1 * torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.mul_(torch.exp(0.3 * torch.randn(b.shape, generator=gen)))


def slice_frames(video, frames, batched=False):
    """The first `frames` frames of a video (time is axis 1 when batched)."""
    return video.__class__(*(None if x is None else
                             (x if (f == "init_kps") else (x[:, :frames] if batched else x[:frames]))
                             for f, x in zip(video._fields, video)))


def check_result(res, expect) -> None:
    import torch

    for field, shape in expect.items():
        t = getattr(res, field)
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            raise AssertionError(f"detector {field}: shape {tuple(t.shape)} (expected {shape}) "
                                 "or non-finite values")


class StageTimer:
    """stage_timer for the detector: CUDA events around each stage."""

    def __init__(self):
        self.events = []

    def reset(self):
        self.events = []

    def __call__(self, name):
        import contextlib

        import torch

        @contextlib.contextmanager
        def span():
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            yield
            e.record()
            self.events.append((name, s, e))

        return span()

    def per_frame_ms(self, frames):
        out = {}
        for name, s, e in self.events:
            e.synchronize()
            out[name] = out.get(name, 0.0) + s.elapsed_time(e) / frames
        return out


def _launch_events(events):
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CPU and
            ("LaunchKernel" in e.name or e.name == "cuLaunchKernel")]


def trunk_launches(model, image, torch):
    """CUDA launches of one trunk call on one frame (inputs cast to the
    model's dtype, as the runners cast them), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    dt = next(model.parameters()).dtype
    hm = torch.zeros(image.shape[:-1] + (1,), device=image.device)
    with torch.no_grad():
        model.trunk(image.to(dt), hm.to(dt))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.trunk(image.to(dt), hm.to(dt))
            torch.cuda.synchronize()
    return len(_launch_events(list(prof.events())))


def profile_frames(detector, video, torch):
    """CUDA launches per stage and device busy time over the frames of
    `video` (2), from torch.profiler (launch API calls inside each stage's
    range)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    frames = video.images.shape[-4]
    saved = detector.stage_timer
    detector.stage_timer = record_function
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            detector(video)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        detector.stage_timer = saved
    events = list(prof.events())
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    stages = [e for e in cpu if e.name in STAGE_NAMES]
    launches = _launch_events(events)
    per_stage = {}
    for st in stages:
        lo, hi = st.time_range.start, st.time_range.end
        n = sum(1 for e in launches if lo <= e.time_range.start <= hi)
        per_stage[st.name] = per_stage.get(st.name, 0) + n / frames
    # device kernels run on one stream, so their durations do not overlap
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in STAGE_NAMES]
    device_us = sum(e.time_range.elapsed_us() for e in device)
    kernel_ms = {name: sum(e.time_range.elapsed_us() for e in device if fn in e.name) / 1e3 / frames
                 for name, fn in DEVICE_NAMES.items()}
    return {"frames": frames, "launches_per_frame_by_stage": per_stage,
            "kernel_ms_per_frame": kernel_ms,
            "launches_per_frame": len(launches) / frames,
            "device_kernel_ms_per_frame": device_us / 1e3 / frames,
            "profiled_wall_ms_per_frame": wall_ms / frames}


if __name__ == "__main__":
    sys.exit(main())
