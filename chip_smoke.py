#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`sgtapose_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit (nvidia-smi) and the float32 settings
     (TF32 off for cuDNN convolutions and matmuls, so the float32 path is
     float32);
  2. build every CUDA kernel from sgtapose_tpu_torch/csrc (one nvcc per
     source, all started together, sm_90a); the launch floor: an empty
     launch (a one-element zero_()) timed cold and warm as the kernels are,
     printed on its own line;
  3. the float32 biased-attention kernel against its plain PyTorch version at
     the flagship shapes plus a ragged n (and the key-tiled float32 kernel at
     a 42-keypoint model's levels 0 and 1), with kernel (cold, and warm: 3
     back-to-back launches without an L2 flush, as the 3 tied layers run;
     clean: the flush read back, so no dirty lines are left to write back) /
     plain / library (F.scaled_dot_product_attention, a yardstick the port
     never calls) times;
  4. the DCN columns of the QAT path and of a float32 model's int8 serving
     (the fused paths launch neither: they are the yardsticks of 4b and 4c):
     the sampler `deform_sample` and its backward `deform_sample_bwd`
     against their plain versions at every decoder input shape at the
     training batch of 8 and one ragged shape, the backward with offsets at
     zero, +-3 and +-12 px, dom the same bit for bit in two runs; cold
     times at +-3 in turns (yardstick, kernel, kernel, yardstick) against
     the designs they replaced (`deform_sample_flat`, the warp-per-item
     `deform_sample_bwd_warp`), plain times;
 4b. the float32 DCN data gradient `deform_conv_dgrad` (the training
     backward's dx and offset/mask gradient in one kernel) against its plain
     version at every decoder node at the training batch of 8 and one ragged
     shape, with offsets at zero, within its halo tile (+-3 px) and beyond
     it (+-12 px), dom the same bit for bit in two runs; kernel / unfused
     pair (dY W with TF32 off, then deform_sample_bwd) / the pair's product
     alone / plain times at +-3, the kernel's at zero offsets;
 4c. the DCN weight gradient `deform_conv_wgrad` (dY^T A with the sampler
     fused in) in float32 and bf16 against its plain version at the
     kernel's split of the pixels, at every decoder node at the training
     batch of 8 and one ragged shape, offsets at zero, +-3 and +-12 px, dW
     the same bit for bit in two runs; kernel / unfused pair (the sampler,
     then dY^T A; float32 with TF32 off) / the pair's product alone / plain
     times at +-3, the kernel's at zero offsets;
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
     over 1 frame the CUDA launches per stage, the device kernel time per
     frame step (busy share against the unprofiled step time) and the device
     time of each hand-written kernel. The feature-cache runner's trunk stage
     must launch exactly what one trunk call on one frame launches;
 10. the eval harness (eval/analysis.py, PnP and weighted refinement batched
     over frames on the card) on the bf16 exact run's detections, and on
     the ground truth with 0.5 px of noise, whose scores are known;
 11. training (float32, the train_demo path): the attention backward
     kernel against its plain version at every flagship (n, d) at the
     training batch of 8, at level 2 and a ragged (100, 8) also at batch 1
     and 2 (the cluster path), and at a 42-keypoint model's level 2, (378,
     16), at phase 13's --depth batch of 2 and at 8, and a ragged (200, 8) at
     3 (the row-split path, with the two-pass path timed beside as its
     yardstick), every output the same bit for bit in two runs, with cold /
     plain times, bounds and SDPA's backward as the yardstick;
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
     launch counts asserted per step (16 deform_conv_dgrad, 16
     deform_conv_wgrad, 0 deform_sample and deform_sample_bwd, 3 attention
     backward), its eval of the trained
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
 13. the training CLI, `cli/train.main --device cuda` at the flagship
     config, on sets the port's writers make: (A) synthetic, 2 videos x 6
     frames (640x360), a validation video of 5 frames, batch 4, --lr_step 2
     --log_every 1 --image_log_every 1, 2 epochs; then --resume from epoch
     2's checkpoint with --num_epochs 1 (the JAX CLI's epoch loop restarts
     at 1: one more epoch, numbered 1; the step goes on from 4 to 6 at 0.1x
     the learning rate); then `cli/infer.main` on that resumed epoch's
     checkpoint; (B)
     --depth, 42 joints, 6 frames, batch 2, 1 epoch. Launches asserted one
     call at a time: per train step 9 biased_attention, 3 attention
     backward, 16 deform_conv, 16 deform_conv_dgrad, 16 deform_conv_wgrad (B:
     3 biased_attention and 6 biased_attention_tiled, the backward's 3 on
     its row-split path, biased_attention_bwd_rows), per mosaic or
     validation forward 9 (B: 3 + 6 tiled)
     attention and 16 deform_conv, and nothing else; the checkpoints,
     metrics.jsonl records and viz/ images checked; ms per step by stage
     (loader wait, batch build, forward, backward, optimizer) from CUDA
     events, steps/s, validation seconds, peak device memory, and the
     hand-written kernels' device ms per step from torch.profiler over the
     resumed run's steps;
 14. bf16 mixed-precision training (`train_step(bf16=True)`: bf16
     parameters, activations and inputs; float32 masters, loss, gradients,
     BatchNorm statistics and Adam moments): (a) the three bf16 backward
     kernels against their plain versions at the training shapes, every
     output the same bit for bit in two runs (but the data gradient's dx,
     added with float atomics before its rounding: reruns counted), with
     cold / plain times, bounds and SDPA's bf16 backward as the attention's
     yardstick: the attention backward at level 2, batch 8, q bf16 and q
     float32, and a ragged (100, 8); `deform_conv_dgrad_bf16` and its
     yardstick `deform_conv_dgrad_halo_bf16` (the float32 design's bf16
     instantiation, on no path) at every decoder node at batch 8 with
     offsets at 0, +-3 and +-12 px and one ragged shape, timed at +-3 in
     turns with the yardstick and the bf16 unfused pair (dY W in bf16, then
     `deform_sample_bwd_bf16`), the sum over the 16 nodes against
     DGRAD_BF16_TARGET_MS; the bf16 DCN columns: `deform_sample_bf16` (also the
     yardstick of 4c's bf16 rows) at every decoder input shape at batch 8
     (a QAT step) and 1 (an int8 frame), `deform_sample_bwd_bf16` at batch
     8 with offsets at 0, +-3 and +-12 px, dom the same bit for bit in two
     runs, times in turns against the flat bf16 sampler and against the
     route the backward replaced (x and g widened, the warp kernel, the
     gradients rounded); (b)
     one 480x480 bf16 gradient, batch 1, BatchNorm in eval mode, the DCN
     offset/mask convs perturbed, card against CPU bf16 (plain versions)
     and against phase 11's CPU float64 (BF16_GRAD_* bars); (c) 5 bf16
     `train_step`s at 480x480, batch 8 on one fixed batch (the loss must
     fall; launches asserted per step: 9 biased_attention_bf16, 3
     biased_attention_bwd_bf16, 16 deform_conv_bf16, 16
     deform_conv_dgrad_bf16, 16 deform_conv_wgrad_bf16, no float32 network
     kernel and no yardstick; everything float32 after) and a profiled
     step; (d)
     `cli/train_demo.main --bf16` for 20 steps (no eval: phase 11 runs it),
     the same launches asserted per step, stage times, steps/s and peak
     device memory; (e) `cli/train.main --bf16` for 1 epoch on phase 13's (A) set
     with validation and mosaics, which run the float32 parameters;
 15. the arch zoo at 480x480 with seeded weights: (a) the exact runner over
     4 frames for the global variant (`--arch dlapa_34`, PlanA), the
     window-dense one (dlapawd_34), the concat baseline (dlapacat_34,
     PlanACAT, its decoder at double width), the ablation in its 3 wirings
     and the single-frame model in the CenterTrack and CenterNet wirings,
     and the bf16 exact runner for the global variant: fps, stage times and
     launches asserted per frame (18 no-bias attention launches per global
     frame); (b) the no-bias attention kernels (`csrc/attention_nobias.cu`;
     float32, and bf16 with a bf16 or a float32 q) against their plain
     versions and against the kernels they replaced, their yardsticks (on
     no path), at the global variant's (28, d), d = 4 ... 128: the forward
     at batch 1, 4 and 8, the backward at 4 and 8, every output the same bit
     for bit in two runs; cold and warm times in turns (yardstick, new, new,
     yardstick), plain / SDPA times and bounds; (c) `cli/train.main` for
     one epoch on phase 13 (A)'s set at batch 4 for the global variant
     (float32 and --bf16), the
     three-frame variant (--phase PlanA_three, three-frame windows) and the
     concat baseline (--phase PlanACAT, the DCN backward at its
     double-width decoder), with launches asserted per step, stage times, steps/s and peak memory; the
     global variant's eval-mode 480x480 gradient card vs CPU float64 at
     phase 11's bars; (d) phase 11's checkpoint through `cli/convert.py`
     (its template state on the card) to a reference-format .pth and back (the same tensors bit for bit, the
     same keypoints), then `cli/train.main --init_backbone` (at lr 0) from
     the port's own ImageNet-format export of its trunk;
 16. the DREAM baselines (no hand-written kernel runs: every launch counter
     asserted 0 in each run): (a) DreamHourglass and ResnetSimple (resnet101
     depth) at 480x480 in float32, card against CPU at phase 8's bar, with
     the card's batch-1 forward time; (b) `infer/dream_detector.py` on a
     16-frame synthetic 640x360 video for both archs, with and without
     flip_test: ms per frame by stage (host preprocess, forward, decode,
     host conversion), fps, and the device's busy share from torch.profiler;
     (c) `cli/infer.main --is_ct false --arch dreamhourglass --flip_test` on
     phase 12's synthetic set, its fps and seconds per video by stage; (d)
     `cli/train.main --phase Dream --arch dreamhourglass` for one epoch on
     phase 13 (A)'s set at batch 4, float32 and --bf16: ms per step by
     stage, steps/s, peak memory; (e) the Dream phase's eval-mode 480x480 gradient card against
     CPU float64 at phase 11's bars;
 17. `--bf16 --depth` and multi-GPU serving: (a) the bf16 key-tiled
     forward (kernel A) against its plain bf16 version at a 42-keypoint
     model's level 0, (7098, 4), at batch 1 and 2, q bf16 and q float32, with
     cold / warm / clean / plain times, bounds and SDPA in bf16 with a float
     mask as the yardstick; (b) the bf16 shared-memory kernel the same way at
     level 1, (2058, 8), which fits it in bf16; (c) the bf16 row-split
     backward (kernel B) against its plain version at level 2, (378, 16), at
     batch 1, 2 and 8 and a ragged (200, 8), q bf16 and float32, every output
     the same bit for bit in two runs, SDPA's bf16 backward as the
     yardstick; (d) a full-width 42-keypoint model (480x480, DCN decoder,
     seeded weights) in bf16: one forward card against CPU bf16 at phase 8's
     bar, then the bf16 exact runner over 4 frames of a 42-keypoint video,
     launches asserted per frame (3 of A, 6 of the bf16 shared-memory kernel,
     16 deform_conv_bf16, no float32 kernel), fps and ms by stage; (e)
     `cli/train.main --depth --bf16` for one epoch on phase 13 (B)'s set at
     batch 2: launches asserted per call (a step: 3 of A, 6 bf16
     shared-memory, 3 of B, the bf16 DCN kernels; a mosaic forward: the
     float32 kernels), ms a step by stage, steps/s, peak memory; (f)
     `infer/detector.make_sharded_video_detector` as one rank (no process
     group) on phase 9's 8-video batch, its launches asserted and its
     results held to the batched runner's;
 18. int8 serving, QAT and the DCN memory knobs: (a) int8 serving's site
     kernels (csrc/int8_conv_fused.cu: `int8_conv_fused`, which quantizes
     the activation itself, and `int8_absmax`, the dynamic scale's max|x|)
     at each of the 57 quantizable sites of one flagship frame (480x480,
     the bf16 model with static scales calibrated on
     `eval/synthetic_eval.calibration_inputs`: the trunk at batch 2, the
     heads at 120x120, the DCN's contractions over its columns) on the
     activations the frame produced, static and dynamic, s32 accumulators
     and outputs bit for bit against `plain_int8_site`; the launch budget
     at all 57 sites (one launch a static site, two a dynamic one, and no
     other device kernel, from torch.profiler); cold times in turns with
     PR 14's route (PyTorch's quantize ops + `int8_conv`, csrc/int8_conv.cu,
     held bit for bit against `plain_int8_conv`), warm times, PR 14's
     kernel alone, the plain versions, and the yardsticks: torch._int_mm
     on the s8 operands at the 1x1 sites, im2col + torch._int_mm at the
     3x3 and 7x7 ones, cuDNN's bf16 F.conv2d at all,
     torch.linalg.vector_norm(ord=inf) for the reduction, summed per
     frame and per site class (stems, 3x3, trunk 1x1, DCN); (b) the bf16
     exact and feature-cache runners on phase 9's video, each with static
     and dynamic scales and with min_ch 0 and 64 (static at 0 and dynamic at
     64, and the other way round),
     launches asserted per frame (int8_conv_fused once per ungated site,
     int8_absmax as often with dynamic scales, deform_sample_bf16 16 times,
     deform_conv_bf16 never), fps and ms by stage, and the bf16 exact
     runner without int8 beside them (trunk and fuse ms); the batched
     runner under dynamic int8 over MANY_VIDEOS (65) copies of the video
     for 2 frames (one scale per video at every site; launches asserted),
     and a dynamic site at `groups` 65 and 130 over 130 samples (a 3x3, the
     DCN's 1x1 over 9C columns, a 1x1 on a 1x1 map: 64 images a block), bit
     for bit with its plain version, two launches each; the CUDA launches
     of one network forward (torch.profiler) in bf16, int8 static and
     dynamic, and int8 static through PR 14's route; one static-scale
     int8 forward card against CPU, within
     INT8_CARD_VS_CPU x the card's own int8-vs-bf16 gap; (c)
     `cli/infer.main --quant int8 --quant_static --quant_min_ch 64` on
     phase 12's synthetic set with phase 11's checkpoint (calibration and
     serving launches asserted), `cli/train_demo.main --quant_train` for
     QAT_STEPS steps at batch 8 and its int8 eval (launches asserted per
     step: the sampler and its backward, no fused DCN kernel), the same
     with --bf16 (16 deform_sample_bf16 and 16 deform_sample_bwd_bf16 a
     step, no float32 network kernel; a 2-frame eval), and
     `cli/train.main` for one epoch of phase 13 (A)'s set plain, with
     --dcn_chunks 4 and with --dcn_remat (its DCN forward launched twice a
     step): losses against (A)'s first epoch, peak memory beside it;
 19. a `{"kernels": [...]}` line, the card line, and last the device line
     `{"ok": true, "device": {...}}`.

The detector runs of phase 9 take 8 frames each (16 before the training
phases were added, to keep the script inside half its time limit).

Kernel times are CUDA-event times of single launches with the 50 MB L2
flushed before each (the detector reads each weight once per frame); the
per-kernel entries of the kernels line are per-frame sums over the shapes one
frame launches (per-step sums over one training step's shapes for the
sampler and the backward kernels; per --depth step for the row-split
attention backward). Bounds (H100 SXM data sheet): the larger of bytes over
3.35 TB/s and operations over the rate of the instructions used, 67 TFLOP/s
for float32 FMAs, 165 TFLOP/s (495 / 3) for 3xTF32, 989 TFLOP/s for dense
bf16 and 1,979 TOP/s for dense int8 on the tensor cores. Details go to
chiprun_out/chip_smoke.json.
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
# phase 14, bf16 training. The bf16 backward kernels against their plain bf16
# versions: both compute in float32 from the same bf16 inputs and round each
# output once, but a rounding can fall on the other side of a bf16 boundary
# when float32 sums run in another order: two bf16 units in the last place
# at the top of the range, 2^-6 of max(1, max|ref|) per output
BWD_BF16_REL_TOL = 2.0 ** -6
# the bf16 data gradient's target: ms summed over the 16 decoder nodes of a
# step at batch 8, offsets in [-3, 3] px, cold
DGRAD_BF16_TARGET_MS = 3.5
# Kernel B (the bf16 row-split backward) and its plain version round the same
# float32 values once to bf16, summed in other orders: a rounding that falls
# on the other side of a boundary moves an output by one bf16 unit in the
# last place, at most 2^-7 of that output's magnitude. Per output, 2^-7 of
# max|ref| (no floor of 1: these gradients lie well below 1)
ROWS_BWD_BF16_REL_TOL = 2.0 ** -7
# The 480x480 bf16 gradient (batch 1, BatchNorm in eval mode, the DCN
# offset/mask convs perturbed), per tensor relative to its largest reference
# gradient, and over all gradients in L2: card bf16 against CPU bf16 (plain
# versions; the same rounding points, other summation orders, so samples
# near a pixel boundary can fall on either side of it), and card bf16
# against CPU float64 (the cost of bf16 itself). Readings on an H100 80GB
# HBM3 at 700 W (PERF.md §6): card vs CPU bf16 15.8 % worst, 2.9 % in L2;
# card vs float64 30.0 % and 3.3 %; CPU bf16 vs float64 27.3 % and 2.4 %.
# Bars:
BF16_GRAD_VS_CPU_WORST_TOL = 0.5
BF16_GRAD_VS_CPU_L2_TOL = 0.05
BF16_GRAD_VS_F64_WORST_TOL = 0.5
BF16_GRAD_VS_F64_L2_TOL = 0.05
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
# phase 13, the training CLI on the card: (A) synthetic training videos x
# frames at batch 4 (10 pairs: 2 steps an epoch), a validation video of 5
# frames (4 pairs: one batch), 2 epochs with the step decay at epoch 2, then
# a resume for 1 more epoch; (B) --depth, 6 frames (5 pairs) at batch 2, 1 epoch
TRAIN_CLI_VIDEOS, TRAIN_CLI_FRAMES, TRAIN_CLI_VAL_FRAMES = 2, 6, 5
TRAIN_CLI_BATCH, TRAIN_CLI_DEPTH_BATCH, TRAIN_CLI_DEPTH_FRAMES = 4, 2, 6
CLI_STAGES = ("loader", "batch", "forward", "backward", "optimizer")
# (H, C_in, C_out, nodes per frame) of the 16 decoder DCN nodes at 480x480
DCN_NODES = [(15, 512, 256, 1), (30, 256, 256, 1), (30, 256, 128, 2), (30, 256, 64, 1),
             (60, 128, 128, 2), (60, 128, 64, 4), (120, 64, 64, 5)]
RAGGED_DCN = (9, 6, 5, 0)  # 9x11 map, C % 8 != 0, O below one tile; off the path
# device functions of each kernel, as the profiler names them (a substring;
# each bf16 instantiation has a __global__ name of its own, and the bf16
# data gradient's two launches, kernel and dx rounding, share the prefix
# deform_conv_dgrad_bf16_, its yardstick's three deform_conv_dgrad_halo_bf16_;
# the weight gradient's two, kernel and split sum, deform_conv_wgrad_ or
# deform_conv_bf16_wgrad_)
DEVICE_NAMES = {"biased_attention": "biased_attention_kernel", "deform_conv": "deform_conv_kernel",
                "deform_sample": "deform_sample_kernel",
                "biased_attention_bf16": "biased_attention_bf16_kernel",
                "deform_conv_bf16": "deform_conv_bf16_kernel",
                "biased_attention_bwd": "biased_attention_bwd_", "deform_sample_bwd": "deform_sample_bwd_kernel",
                "deform_conv_dgrad": "deform_conv_dgrad_kernel",
                "biased_attention_tiled": "biased_attention_tiled_kernel",
                "biased_attention_bwd_bf16": "biased_attention_bf16_bwd_kernel",
                "deform_conv_dgrad_bf16": "deform_conv_dgrad_bf16_",
                "deform_sample_bf16": "deform_sample_bf16_kernel",
                "biased_attention_bwd_rows": "biased_attention_rows_bwd_kernel",
                "deform_conv_wgrad": "deform_conv_wgrad_", "deform_conv_wgrad_bf16": "deform_conv_bf16_wgrad_",
                "biased_attention_nobias": "nobias_attention_fwd_kernel",
                "biased_attention_nobias_bf16": "nobias_attention_fwd_bf16_kernel",
                "biased_attention_bwd_nobias": "nobias_attention_bwd_kernel",
                "biased_attention_bwd_nobias_bf16": "nobias_attention_bwd_bf16_kernel",
                "biased_attention_nobias_rowtile": "attention_nobias_kernel",
                "biased_attention_nobias_rowtile_bf16": "attention_nobias_bf16_kernel",
                "biased_attention_bwd_nobias_cluster": "attention_bwd_nobias_kernel",
                "biased_attention_bwd_nobias_cluster_bf16": "attention_bwd_nobias_bf16_kernel",
                "biased_attention_tiled_bf16": "biased_attention_tiled_bf16_kernel",
                "biased_attention_bwd_rows_bf16": "biased_attention_rows_bf16_bwd_kernel",
                "deform_conv_dgrad_halo_bf16": "deform_conv_dgrad_halo_bf16_"}


def kernel_device_ms(events, kernel: str) -> float:
    """Device ms of `kernel`'s functions among profiler events."""
    return sum(e.time_range.elapsed_us() for e in events if DEVICE_NAMES[kernel] in e.name) / 1e3


TRAIN_STAGES = ("batch", "forward", "backward", "optimizer")
STAGE_NAMES = ("pnp", "render", "trunk", "fuse", "decode")


def shape_sum(rows, key, unit="per_frame"):
    """Sum over the shapes one frame (or one training step) runs."""
    vals = [r[key] for r in rows if r[unit]]
    if any(v is None for v in vals):
        return None
    return sum(r[key] * r[unit] for r in rows if r[unit])


def rel_err(a, b) -> float:
    """max|a - b| / max(1, max|b|)."""
    return (a - b).abs().max().item() / max(1.0, b.abs().max().item())


def rel_err_of_max(a, b) -> float:
    """max|a - b| / max|b|."""
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


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
    phase_starts = {}  # phase -> seconds after the card check at its start

    def mark(phase):
        phase_starts[phase] = time.perf_counter() - t_start

    # ---- 2. build -------------------------------------------------------
    mark("2")
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

    # the launch floor: an empty launch (a one-element zero_) timed as the
    # kernels are, below which no small kernel's time can fall
    one = torch.zeros(1, device=dev)
    report["launch_floor"] = {"cold_ms": cold_ms(one.zero_), "warm_ms": warm_ms(one.zero_),
                              "note": "a one-element zero_() under cold_ms / warm_ms"}
    print("launch floor: " + json.dumps(report["launch_floor"]))

    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = Config()
    n_layers = cfg.model.num_decoder_layers
    h = cfg.model.n_heads
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # ---- 3. float32 attention kernel vs plain ----------------------------
    mark("3")
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
    mark("4")
    # at the training batch: the QAT path's DCN columns (16 launches of each
    # a step) and the routes deform_conv_wgrad (4c) and deform_conv_dgrad
    # (4b) replaced; the sampler at offsets in [-3, 3], the backward also at
    # zero and +-12 px (dom the same bit for bit in two runs); times at +-3
    # against the designs they replaced (the flat sampler, the warp-per-item backward),
    # in turns: yardstick, kernel, kernel, yardstick
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
        flat_err = (deform_conv.deform_sample_flat_cuda(feat, offsets, masks) - ref).abs().max().item()
        if not all(math.isfinite(e) and e <= DCN_TOL for e in (err, flat_err)):
            raise AssertionError(f"DCN kernel B={B} H={H} C={C}: max abs err {err} (flat {flat_err}) > {DCN_TOL}")
        M = B * H * W
        b_ms, b_by = bound_ms(4 * M * (C + 18 + 9 + 9 * C), M * 9 * C * 9)
        flat_a, new_a, new_b, flat_b = (cold_ms(lambda: f(feat, offsets, masks)) for f in (
            deform_conv.deform_sample_flat_cuda, deform_conv.deform_sample_cuda, deform_conv.deform_sample_cuda,
            deform_conv.deform_sample_flat_cuda))
        row = dict(B=B, H=H, W=W, C=C, per_step=per_step, max_abs_err=err, ms=(new_a + new_b) / 2,
                   flat_ms=(flat_a + flat_b) / 2, flat_max_abs_err=flat_err,
                   plain_ms=cold_ms(lambda: deform_conv.plain_deform_sample(feat, offsets, masks)),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
        dcn_rows.append(row)
        print("deform_sample " + json.dumps(row))

        grad = torch.randn(B, H, W, 9 * C, generator=gen, device=dev)
        for span in (0.0, 3.0, 12.0):
            offs = offsets / 3 * span
            dfeat, dom = deform_conv.deform_sample_bwd_cuda(feat, offs, masks, grad)
            torch.cuda.synchronize()
            rf, rdom = deform_conv.plain_deform_sample_bwd(feat, offs, masks, grad)
            errs = {"dfeat": rel_err(dfeat, rf), "dom": rel_err(dom, rdom)}
            if not all(math.isfinite(e) and e <= BWD_REL_TOL for e in errs.values()):
                raise AssertionError(f"deform_sample_bwd B={B} H={H} C={C} offsets +-{span}: rel errors {errs} "
                                     f"> {BWD_REL_TOL}")
            if not torch.equal(dom, deform_conv.deform_sample_bwd_cuda(feat, offs, masks, grad)[1]):
                raise AssertionError(f"deform_sample_bwd H={H} C={C} offsets +-{span}: two runs give another dom")
            # read feat, offsets, masks, grad once, write dfeat and dom once; ~34
            # FLOPs per (pixel, tap, channel) with the 4 atomic adds
            b_ms, b_by = bound_ms(4 * M * (C + 18 + 9 + 9 * C + C + 27), M * 9 * C * 34)
            row = dict(B=B, H=H, W=W, C=C, offsets=span, per_step=per_step if span == 3.0 else 0, rel_err=errs,
                       dom_bitwise_rerun=True,
                       max_abs_err=max((dfeat - rf).abs().max().item(), (dom - rdom).abs().max().item()),
                       library_ms=None, bound_ms=b_ms, bound_by=b_by)
            if span == 3.0:
                wf, wdom = deform_conv.deform_sample_bwd_warp_cuda(feat, offs, masks, grad)
                warp_err = max(rel_err(wf, rf), rel_err(wdom, rdom))
                if not warp_err <= BWD_REL_TOL:
                    raise AssertionError(f"deform_sample_bwd_warp H={H} C={C}: rel error {warp_err}")
                row["warp_max_abs_err"] = max((wf - rf).abs().max().item(), (wdom - rdom).abs().max().item())
                del wf, wdom
                warp_a, new_a, new_b, warp_b = (cold_ms(lambda: f(feat, offs, masks, grad)) for f in (
                    deform_conv.deform_sample_bwd_warp_cuda, deform_conv.deform_sample_bwd_cuda,
                    deform_conv.deform_sample_bwd_cuda, deform_conv.deform_sample_bwd_warp_cuda))
                row.update(ms=(new_a + new_b) / 2, warp_ms=(warp_a + warp_b) / 2,
                           plain_ms=cold_ms(lambda: deform_conv.plain_deform_sample_bwd(feat, offs, masks, grad),
                                            iters=5, warmup=1))
            dcn_bwd_rows.append(row)
            print("deform_sample_bwd " + json.dumps(row))
            del dfeat, dom, rf, rdom
        del feat, offsets, masks, grad, out, ref
    report["deform_sample_shapes"] = dcn_rows
    report["deform_sample_bwd_shapes"] = dcn_bwd_rows

    # ---- 4b. float32 DCN data gradient (deform_conv_dgrad) vs plain -------
    mark("4b")
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

    # ---- 4c. DCN weight gradient (deform_conv_wgrad), float32 and bf16 ----
    mark("4c")
    # dW of every decoder node at the training batch and of the ragged
    # shape, offsets at zero, +-3 and +-12 px, against the plain version at
    # the kernel's split of the pixels, dW the same bit for bit in two runs;
    # times at +-3 against the route it replaced (the sampler, then dY^T A;
    # float32 with TF32 off), that route's product alone and the plain
    # version, the kernel's alone at zero offsets
    wgrad_rows = {torch.float32: [], bf16: []}
    for dt in (torch.float32, bf16):
        tol = BWD_REL_TOL if dt == torch.float32 else BWD_BF16_REL_TOL
        rate = TF32X3_OPS_PER_S if dt == torch.float32 else BF16_OPS_PER_S
        for (H, C, O, per_step), span in [(node, span) for node in DCN_NODES + [RAGGED_DCN]
                                          for span in (0.0, 3.0, 12.0)]:
            B, W = (TRAIN_BATCH, H) if per_step else (2, H + 2)
            x = torch.randn(B, H, W, C, generator=gen, device=dev).to(dt)
            offsets = (torch.rand(B, H, W, 18, generator=gen, device=dev) * 2 - 1) * span
            masks = torch.sigmoid(2 * torch.randn(B, H, W, 9, generator=gen, device=dev))
            dy = torch.randn(B, H, W, O, generator=gen, device=dev).to(dt)
            dw = deform_conv.deform_conv_wgrad_cuda(x, offsets, masks, dy)
            torch.cuda.synchronize()
            M = B * H * W
            splits = deform_conv.wgrad_splits(M, C, O, dt, sms)
            ref = deform_conv.plain_deform_conv_wgrad(x, offsets, masks, dy, splits)
            err = rel_err(dw.float(), ref.float())
            if dw.dtype != dt or not math.isfinite(err) or err > tol:
                raise AssertionError(f"deform_conv_wgrad {dt} B={B} H={H} C={C} O={O} offsets +-{span}: "
                                     f"rel error {err} > {tol} (or dtype {dw.dtype})")
            if not torch.equal(dw, deform_conv.deform_conv_wgrad_cuda(x, offsets, masks, dy)):
                raise AssertionError(f"deform_conv_wgrad {dt} H={H} C={C} O={O}: two runs give another dW")
            # x, dY (the working type) and the float32 offsets and masks read
            # once, dW written once; the product's 2 M O 9C operations at the
            # 3xTF32 or dense bf16 rate
            es = dw.element_size()
            b_ms, b_by = bound_ms(es * (M * C + M * O + O * 9 * C) + 4 * M * 27, 2 * M * O * 9 * C, rate)
            row = dict(dtype=str(dt).replace("torch.", ""), B=B, H=H, W=W, C=C, O=O, offsets=span, splits=splits,
                       per_step=per_step if span == 3.0 else 0, rel_err=err, bitwise_equal_rerun=True,
                       max_abs_err=(dw.float() - ref.float()).abs().max().item(),
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)

            def kernel():
                return deform_conv.deform_conv_wgrad_cuda(x, offsets, masks, dy)

            if span == 0.0:
                row["ms"] = cold_ms(kernel)
            if span == 3.0:
                cols = deform_conv.deform_sample_cuda(x, offsets, masks).view(-1, 9 * C)

                def pair():
                    return dy.view(-1, O).t() @ deform_conv.deform_sample_cuda(x, offsets, masks).view(-1, 9 * C)

                row.update(ms=cold_ms(kernel), pair_ms=cold_ms(pair),
                           matmul_ms=cold_ms(lambda: dy.view(-1, O).t() @ cols),
                           plain_ms=cold_ms(lambda: deform_conv.plain_deform_conv_wgrad(x, offsets, masks, dy),
                                            iters=3, warmup=1))
                del cols
            wgrad_rows[dt].append(row)
            print("deform_conv_wgrad " + json.dumps(row))
            del x, offsets, masks, dy, dw, ref
    report["deform_conv_wgrad_shapes"] = wgrad_rows[torch.float32]
    report["deform_conv_wgrad_bf16_shapes"] = wgrad_rows[bf16]

    def dcn_inputs(H, W, C, O, dtype, B=1):
        x = torch.randn(B, H, W, C, generator=gen, device=dev)
        om = torch.cat([torch.rand(B, H, W, 18, generator=gen, device=dev) * 6 - 3,
                        2 * torch.randn(B, H, W, 9, generator=gen, device=dev)], dim=-1)
        weight = torch.randn(O, 9 * C, generator=gen, device=dev) / math.sqrt(9 * C)
        bias_o = torch.randn(O, generator=gen, device=dev)
        return tuple(t.to(dtype) for t in (x, om, weight, bias_o))

    # ---- 5. float32 fused DCN kernel vs plain -----------------------------
    mark("5")
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
    mark("6")
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
    mark("7")
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
    mark("8")
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
    mark("9")
    projs, raw, pos_cam = synthetic.make_sequence(torch.Generator().manual_seed(3), T_FRAMES,
                                                  return_pos_cam=True, device=dev)
    images, _, _ = det_lib.preprocess_frames(raw, cfg)
    x3d = synthetic.skeleton(dev)[None].expand(T_FRAMES, -1, -1).contiguous()
    K = synthetic.camera_K(dev)
    raw_hw = (synthetic.RAW_H, synthetic.RAW_W)
    timer = StageTimer()

    def drive(name, detector, video, steps, per_step, expect_shapes, n_streams=1):
        """Warm up on 2 frames, then one timed run with the launch counters
        reset just before it; then 1 profiled frame (the profiler's trace
        of a frame step, ~12k launches, takes tens of seconds to read
        back, `profile_s`)."""
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
        prof = profile_frames(detector, slice_frames(video, 1, batched=n_streams > 1), torch)
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
    runs["bf16_batched_8_videos"], batched16_res = drive(
        "bf16_batched_8_videos", batched16, bvideo, T_FRAMES, per_frame_launches16,
        {k: (N_VIDEOS,) + s for k, s in single_shapes.items()}, n_streams=N_VIDEOS)
    report["detector"] = runs

    # ---- 10. the eval harness on the card ---------------------------------
    mark("10")
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
    mark("11")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ckpt = os.path.join(work, "train_demo.pt")
        ref64 = {}
        train = training_phase(torch, dev, gen, cfg, cold_ms, no_launches, ckpt, ref64)
        report["training"] = train
        mark("12")
        cli = cli_phase(torch, ckpt, work, no_launches)
        report["cli"] = cli
        # ---- 13. the training CLI ------------------------------------------
        mark("13")
        train_cli = train_cli_phase(torch, work, no_launches)
        report["train_cli"] = train_cli
        # ---- 14. bf16 training ---------------------------------------------
        mark("14")
        bf16_train = bf16_training_phase(torch, dev, gen, cfg, cold_ms, no_launches, work, ref64)
        report["bf16_training"] = bf16_train
        # ---- 15. the arch zoo ----------------------------------------------
        mark("15")
        zoo = zoo_phase(torch, dev, gen, cfg, cold_ms, warm_ms, no_launches, work, ckpt, ref64)
        report["zoo"] = zoo
        # ---- 16. the DREAM baselines ---------------------------------------
        mark("16")
        report["dream"] = dream_phase(torch, dev, cfg, cold_ms, no_launches, work, ref64)
        del ref64
        # ---- 17. --bf16 --depth; multi-GPU serving as one rank ---------------
        mark("17")
        serving = {"model": model16, "K": K, "raw_hw": raw_hw, "videos": bvideo, "batched_result": batched16_res,
                   "per_frame_launches": per_frame_launches16}
        report["bf16_depth"] = bf16_depth_phase(torch, dev, gen, cfg, cold_ms, warm_ms, no_launches, work, serving)
        del serving
        # ---- 18. int8 serving, QAT, the DCN memory knobs ---------------------
        mark("18")
        report["int8"] = int8_phase(torch, dev, cfg, cold_ms, warm_ms, no_launches, work, ckpt, train_cli)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 19. kernels line --------------------------------------------------
    mark("19")
    per_frame = shape_sum

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
        if name in ("biased_attention", "deform_conv"):
            entry["train_cli_launches_per_step"] = train_cli["synthetic"]["launches_per_step"][name]
            entry["train_cli_profiled_ms_per_step"] = train_cli["resumed"]["kernel_ms_per_step_profiled"][name]
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
        "train_cli_depth_launches_per_step": train_cli["depth"]["launches_per_step"]["biased_attention_tiled"],
        "shapes_note": "levels 0 and 1 of a 42-keypoint model (phase 12's depth run), per frame"})
    # the training kernels, read from the train_demo run (per step)
    # (deform_sample_bwd launches 0 times per step since deform_conv_dgrad;
    # its per-step sums are those of the route it was on, for comparison)
    rates.update(biased_attention_bwd="67 TFLOP/s float32 FMA", deform_sample_bwd="67 TFLOP/s float32 FMA",
                 deform_conv_dgrad="165 TFLOP/s 3xTF32 (495 / 3)", deform_conv_wgrad="165 TFLOP/s 3xTF32 (495 / 3)")
    for name, rows, source, replaces in (
        ("deform_sample", dcn_rows, "sgtapose_tpu_torch/csrc/deform_sample.cu",
         "sgtapose_tpu/models/deform_conv.py:104"),
        ("biased_attention_bwd", train["attention_bwd_shapes"], "sgtapose_tpu_torch/csrc/biased_attention_bwd.cu",
         "sgtapose_tpu/ops/attention_kernel.py:145"),
        ("deform_conv_dgrad", dgrad_rows, "sgtapose_tpu_torch/csrc/deform_conv_bwd.cu",
         "sgtapose_tpu/models/deform_conv.py:188"),
        ("deform_sample_bwd", dcn_bwd_rows, "sgtapose_tpu_torch/csrc/deform_sample_bwd.cu",
         "sgtapose_tpu/models/deform_conv.py:130"),
        ("deform_conv_wgrad", wgrad_rows[torch.float32], "sgtapose_tpu_torch/csrc/deform_conv_wgrad.cu",
         "sgtapose_tpu/models/deform_conv.py:349"),
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
        entry["train_cli_launches_per_step"] = train_cli["synthetic"]["launches_per_step"].get(name, 0)
        entry["train_cli_profiled_ms_per_step"] = train_cli["resumed"]["kernel_ms_per_step_profiled"][name]
        if name == "biased_attention_bwd":
            depth = [r for r in rows if r["depth_per_step"]]
            entry["depth_two_pass_yardstick"] = {
                "ms": per_frame(depth, "two_pass_ms", "depth_per_step"), "shape": [(r["n"], r["d"], r["B"]) for r in depth],
                "launches_per_depth_step": train_cli["depth"]["launches"][name] / train_cli["depth"]["steps"],
                "note": "the two-pass path at a 42-keypoint level 2, per --depth step: the row-split path's yardstick"}
        if name in ("deform_conv_dgrad", "deform_conv_wgrad"):
            entry["pair_ms"] = per_frame(rows, "pair_ms", "per_step")
            entry["matmul_ms"] = per_frame(rows, "matmul_ms", "per_step")
            entry["ms_zero_offsets"] = sum(
                r["ms"] * n for r in rows if r["offsets"] == 0.0
                for H_, C_, O_, n in DCN_NODES if (r["H"], r["C"], r["O"]) == (H_, C_, O_))
            entry["offsets_note"] = "ms, pair_ms, plain_ms at offsets in [-3, 3] px"
        if name.startswith("deform"):
            entry["library_ms_note"] = "no single PyTorch call computes this function"
        else:
            entry["library_ms_note"] = "backward of F.scaled_dot_product_attention with a float mask"
        kernels.append(entry)
    # the row-split attention backward, read from phase 13's --depth run (per
    # --depth step: level 2 of a 42-keypoint model at batch 2)
    rows = [r for r in train["attention_bwd_shapes"] if r["path"] == "rows"]
    depth = [r for r in rows if r["depth_per_step"]]
    name = "biased_attention_bwd_rows"
    kernels.append({
        "name": name, "route": "cuda", "source": "sgtapose_tpu_torch/csrc/biased_attention_bwd.cu",
        "replaces": "sgtapose_tpu/ops/attention_kernel.py:145", "launches": train_cli["depth"]["launches"][name],
        "launches_per_depth_step": train_cli["depth"]["launches"][name] / train_cli["depth"]["steps"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_frame(depth, "ms", "depth_per_step"), "plain_ms": per_frame(depth, "plain_ms", "depth_per_step"),
        "bound_ms": per_frame(depth, "bound_ms", "depth_per_step"), "bound_by": depth[0]["bound_by"],
        "bound_rate": "3.35 TB/s HBM" if depth[0]["bound_by"] == "bytes" else "67 TFLOP/s float32 FMA",
        "library_ms": per_frame(depth, "library_ms", "depth_per_step"),
        "library_ms_note": "backward of F.scaled_dot_product_attention with a float mask",
        "two_pass_ms": per_frame(depth, "two_pass_ms", "depth_per_step"),
        "ms_per_launch": {f"{r['n']},{r['d']},B={r['B']}": r["ms"] for r in rows},
        "train_cli_profiled_ms_per_step": train_cli["resumed"]["kernel_ms_per_step_profiled"][name],
        "shapes_note": "level 2 of a 42-keypoint model at phase 13's --depth batch of 2, per --depth step"})
    bf16_train["deform_conv_wgrad_bf16_shapes"] = wgrad_rows[bf16]
    kernels += bf16_kernel_rows(bf16_train, per_frame)
    kernels = column_kernel_rows(kernels, report, bf16_train, per_frame)
    kernels += int8_kernel_rows(report["int8"])
    kernels += zoo_kernel_rows(zoo, per_frame, report["launch_floor"])
    # the bf16 forward's shared-memory kernel at a 42-keypoint level 1,
    # (2058, 8), as phase 17's 42-keypoint bf16 run launches it
    level1 = report["bf16_depth"]["attention_bf16_level1_shapes"]
    next(e for e in kernels if e["name"] == "biased_attention_bf16")["depth_level1"] = {
        "shape": [level1[0]["n"], level1[0]["d"]], "launches_per_42kp_frame": n_layers,
        **{key: per_frame(level1, key) for key in ("ms", "warm_ms", "clean_ms", "plain_ms", "bound_ms", "library_ms")},
        "max_abs_err": max(r["max_abs_err"] for r in level1), "bound_by": level1[0]["bound_by"],
        "kernel_a_ms": per_frame(level1, "tiled_ms"), "kernel_a_max_abs_err": max(r["tiled_max_abs_err"] for r in level1),
        "kernel_a_note": "kernel A (biased_attention_tiled_bf16) on the same inputs, the route not taken",
        "shapes_note": "level 1 of a 42-keypoint bf16 model, per frame (3 tied layers)"}
    kernels += bf16_depth_kernel_rows(report["bf16_depth"], per_frame)
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    ends = list(phase_starts.values())[1:] + [report["seconds"]]
    report["phase_seconds"] = {p: e - s for (p, s), e in zip(phase_starts.items(), ends)}
    print("phase seconds " + json.dumps(report["phase_seconds"]))
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"chip_smoke: {report['seconds']:.1f} s after the card check")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def training_phase(torch, dev, gen, cfg, cold_ms, no_launches, ckpt, keep):
    """Phase 11 (module docstring): the attention backward kernel against
    its plain version, the full-width gradients card vs CPU (train mode and
    eval mode), the fixed-batch steps, the train_demo run with its eval
    (its trained state saved to `ckpt`), and a profiled step. `keep`: see
    `eval_mode_gradient_check`."""
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
    # level 2 and the ragged (100, 8) take the cluster path, also at B = 1, 2;
    # level 2 of a 42-keypoint model, (378, 16), takes the row-split path at
    # phase 13's --depth batch of 2 (its 3 launches per --depth step are
    # counted in `depth_per_step`) and at 8, as does a ragged (200, 8) at 3;
    # the row-split rows time the two-pass path, their yardstick, beside
    shapes = []
    for i in range(3):
        kernel = cfg.model.kernel_list[i]
        n = cfg.model.num_classes * cfg.model.k_list[i] * (1 + 2 * (kernel // 2)) ** 2
        shapes.append((n, 4 * 2 ** i, n_layers if i == 2 else 0, TRAIN_BATCH, 0))
        if i == 2:
            shapes += [(n, 16, 0, 1, 0), (n, 16, 0, 2, 0)]
    shapes += [(DEPTH_CLASSES * 9, 16, 0, TRAIN_CLI_DEPTH_BATCH, n_layers), (DEPTH_CLASSES * 9, 16, 0, TRAIN_BATCH, 0),
               (200, 8, 0, 3, 0)]
    shapes += [(100, 8, 0, B, 0) for B in (1, 2, TRAIN_BATCH)]  # ragged n, not on the main path
    rows = []
    for n, d, per_step, B, depth_per_step in shapes:
        q, k, v, dout = (torch.randn(B, h, n, d, generator=gen, device=dev) for _ in range(4))
        bias = 0.3 * torch.randn(h, n, n, generator=gen, device=dev)
        o = attention_kernel.biased_attention_cuda(q, k, v, bias)
        path = attention_kernel.bwd_path(n, d)
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
        row = dict(n=n, d=d, B=B, per_step=per_step, depth_per_step=depth_per_step, rel_err=errs,
                   dbias_bitwise_equal=True, path=path,
                   max_abs_err=max((a - r).abs().max().item() for a, r in zip(got, ref)),
                   ms=cold_ms(lambda: attention_kernel.biased_attention_bwd_cuda(q, k, v, bias, o, dout)),
                   plain_ms=cold_ms(lambda: attention_kernel.plain_biased_attention_backward(q, k, v, bias, o, dout)),
                   library_ms=cold_ms(lambda: y.backward(dout, retain_graph=True)),
                   bound_ms=b_ms, bound_by=b_by)
        if path == "rows":
            row["two_pass_ms"] = cold_ms(
                lambda: attention_kernel.biased_attention_bwd_cuda(q, k, v, bias, o, dout, path="two_pass"))
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
                  deform_conv=16, deform_conv_wgrad=16, deform_conv_dgrad=16)
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
    out["grad_eval_mode_vs_float64"] = eval_mode_gradient_check(torch, dev, cfg, batch_cpu, no_launches, keep)
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
        "kernel_ms_per_step": {name: kernel_device_ms(device, name) / 2 for name in DEVICE_NAMES},
        "device_kernel_ms_per_step": device_ms, "profiled_wall_ms_per_step": wall_ms,
        "device_busy_share": device_ms / wall_ms,
        "launches_per_step": len(_launch_events(events)) / 2}
    print("profiled train step: " + json.dumps(out["profiled"]))
    del state, fixed, raw

    # train_demo.main: TRAIN_STEPS steps on fresh batches, then its eval
    # (peak memory from here: phase 14 reads bf16 training's the same way)
    timer = StageTimer()
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_demo.main(argv, stage_timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    stage_ms = timer.per_frame_ms(TRAIN_STEPS)
    expect = {"biased_attention": 3 * n_layers, "biased_attention_bwd": n_layers, "deform_conv": 16,
              "deform_conv_wgrad": 16, "deform_conv_dgrad": 16, "deform_sample": 0, "deform_sample_bwd": 0}
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


def eval_mode_gradient_check(torch, dev, cfg, batch_cpu, no_launches, keep, phase="PlanA_win", expect=None):
    """0b of phase 11: the loss's parameter gradients at 480x480, batch 1,
    BatchNorm in eval mode (running statistics), seeded weights with the
    zero-initialised ones perturbed, DCN offset/mask convs included: the
    card in float32 against the CPU in float64 (plain versions), at
    EVAL_GRAD_WORST_TOL per tensor and EVAL_GRAD_L2_TOL in L2. The float64
    gradients and the batch are left in `keep` (a dict, unless None) for
    phase 14's bf16 gradient. Phase 15 runs it for the global variant
    (cfg.model.arch, `phase`'s inputs, the launches `expect`)."""
    from sgtapose_tpu_torch.models.sgta import create_model
    from sgtapose_tpu_torch.ops import build
    from sgtapose_tpu_torch.train.loss import sgta_loss
    from sgtapose_tpu_torch.train.phases import model_inputs, model_wiring

    model_cfg, tracking = model_wiring(cfg.model, phase)
    model_64 = create_model(model_cfg, device="cpu", seed=0, tracking=tracking)
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
            loss, _ = sgta_loss(model(*model_inputs(phase, batch)), batch)
            loss.backward()
        if where == "card":
            torch.cuda.synchronize()
            launched = build.launch_counts()
        seconds[where] = time.perf_counter() - t0
        grads[where] = {name: p.grad.double().cpu() for name, p in model.named_parameters() if p.grad is not None}
    expect = expect or dict(no_launches, biased_attention=9, biased_attention_bwd=3, deform_conv=16,
                            deform_conv_wgrad=16, deform_conv_dgrad=16)
    if launched != expect:
        raise AssertionError(f"eval-mode gradient launches {launched}, expected {expect}")
    ref = grads["cpu_float64"]
    if keep is not None:
        keep.update(grads=ref, batch=batch_cpu)
    if set(grads["card"]) != set(ref):
        raise AssertionError("card and reference reach different parameters")
    live = [name for name, g in ref.items() if g.abs().max().item() > 1e-6]
    res = dict(grad_errors(grads["card"], ref, live), tensors=len(live), seconds=seconds,
               bars=[EVAL_GRAD_WORST_TOL, EVAL_GRAD_L2_TOL], input="480x480, batch 1, BN eval mode",
               offset_grad_max=max((ref[n].abs().max().item() for n in live if "conv_offset_mask" in n), default=None))
    # the layers in network order: where the error enters
    res["by_module"] = {}
    for name in live:
        mod = name.rsplit(".", 2)[0]
        e = ((grads["card"][name] - ref[name]).abs().max() / ref[name].abs().max()).item()
        res["by_module"][mod] = max(res["by_module"].get(mod, 0.0), e)
    print(f"eval-mode gradient {cfg.model.arch} {phase} 480x480 batch 1, offsets perturbed, card vs float64: "
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


def train_cli_phase(torch, work, no_launches):
    """Phase 13 (module docstring): `cli.train.main --device cuda` at the
    flagship config on sets the port's writers put in `work`. (A) synthetic,
    with validation, the step decay and the image log: 2 epochs, then a
    resume for 1 more epoch (numbered 1 again, as the JAX CLI numbers it),
    then `cli.infer.main` on its checkpoint; (B)
    --depth, 42 joints, 1 epoch. The launches of every train step, mosaic
    forward and validation forward are asserted one call at a time, the
    artifacts checked; ms per step by stage from CUDA events, the
    hand-written kernels' device ms per step from torch.profiler over the
    resumed run's steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sgtapose_tpu_torch.cli import infer, train as train_cli
    from sgtapose_tpu_torch.data import synthetic
    from sgtapose_tpu_torch.ops import attention_kernel, build
    from sgtapose_tpu_torch.train import trainer

    out = {}
    syn, val, depth = (os.path.join(work, d) for d in ("train_syn", "train_val", "train_depth"))
    synthetic.write_synthetic_dataset(syn, TRAIN_CLI_VIDEOS, TRAIN_CLI_FRAMES, seed=7)
    synthetic.write_synthetic_dataset(val, 1, TRAIN_CLI_VAL_FRAMES, seed=8)
    synthetic.write_depth_dataset(depth, "panda-depth", TRAIN_CLI_DEPTH_FRAMES, seed=9)
    if attention_kernel.bwd_path(DEPTH_CLASSES * 9, 16) != "rows":
        raise AssertionError("a 42-keypoint level 2 (378, 16) should take the row-split backward")

    # launches of each call of the trainer's entry points the CLI makes
    calls, lrs = [], []
    profiling = {"on": False, "kernel_ms": {}, "steps": 0}
    real = {name: getattr(trainer, name) for name in ("train_step", "predict_step", "eval_predict_step")}

    def counted(name):
        def call(*args, **kw):
            if name == "train_step":
                state = args[0]
                lrs.append((state.step, state.schedule(state.schedule_count)))
            before = build.launch_counts()
            if name == "train_step" and profiling["on"]:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    res = real[name](*args, **kw)
                    torch.cuda.synchronize()
                dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
                for kn in DEVICE_NAMES:
                    profiling["kernel_ms"][kn] = profiling["kernel_ms"].get(kn, 0.0) + kernel_device_ms(dev_events, kn)
                profiling["steps"] += 1
            else:
                res = real[name](*args, **kw)
            after = build.launch_counts()
            calls.append((name, {kn: after[kn] - before[kn] for kn in after}))
            return res
        return call

    step_expect = dict(no_launches, biased_attention=9, biased_attention_bwd=3, deform_conv=16,
                       deform_conv_dgrad=16, deform_conv_wgrad=16)
    fwd_expect = dict(no_launches, biased_attention=9, deform_conv=16)

    def run(name, argv, expect):
        """One CLI run, the counters reset just before it and read just
        after, every call's launches asserted; returns (result, record)."""
        calls.clear()
        timer = StageTimer()
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train_cli.main(argv + ["--device", "cuda"], stage_timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = build.launch_counts()
        by_kind = {}
        for kind, launched in calls:
            if launched != expect[kind]:
                raise AssertionError(f"train cli {name}: a {kind} call launched {launched}, expected {expect[kind]}")
            by_kind[kind] = by_kind.get(kind, 0) + 1
        total = {kn: sum(launched[kn] for _, launched in calls) for kn in counts}
        if counts != total or not by_kind.get("train_step"):
            raise AssertionError(f"train cli {name}: launches {counts} outside the trainer's calls {total}")
        steps = by_kind["train_step"]
        stage_ms = timer.per_frame_ms(steps)
        step_ms = sum(stage_ms.get(st, 0.0) for st in CLI_STAGES)
        rec = {"steps": steps, "calls": by_kind, "wall_s_with_setup": wall, "launches": counts,
               "launches_per_step": {kn: sum(launched[kn] for kind, launched in calls if kind == "train_step")
                                     / steps for kn in counts if expect["train_step"][kn]},
               "stage_ms_per_step": {st: stage_ms.get(st, 0.0) for st in CLI_STAGES},
               "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
               "validation_s": [s_.elapsed_time(e_) / 1e3 for n_, s_, e_ in timer.events if n_ == "validation"],
               # one entry per call: a run's first step pays first-use costs
               # (cuDNN's choices at a new batch size, Adam's moments)
               "stage_ms_by_call": {st: [s_.elapsed_time(e_) for n_, s_, e_ in timer.events if n_ == st]
                                    for st in CLI_STAGES},
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"train cli {name}: " + json.dumps(rec))
        return res, rec

    for name in real:
        setattr(trainer, name, counted(name))
    try:
        # (A) train 2 epochs with validation, then resume for --num_epochs 1
        exp = os.path.join(work, "train_exp")
        argv = ["--dataset", syn, "--val_dataset", val, "--output_dir", exp, "--batch_size", str(TRAIN_CLI_BATCH),
                "--lr_step", "2", "--log_every", "1", "--image_log_every", "1"]
        expect = {"train_step": step_expect, "predict_step": fwd_expect, "eval_predict_step": fwd_expect}
        res, out["synthetic"] = run("synthetic", argv + ["--num_epochs", "2"], expect)
        iters = res["iters_per_epoch"]
        if iters != 2 or res["state"].step != 4 or out["synthetic"]["calls"] != {
                "train_step": 4, "predict_step": 4, "eval_predict_step": 2}:
            raise AssertionError(f"train cli synthetic: {iters} iterations an epoch, step {res['state'].step}, "
                                 f"calls {out['synthetic']['calls']}")
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        loss_keys = {"tot", "hm", "reg", "tracking"}
        kp_keys = {"kp_found_inframe", "kp_missing_inframe", "kp_l2_mean_px", "kp_pck_auc_12px"}
        train_recs = [r for r in recs if r["prefix"] == "train"]
        val_recs = [r for r in recs if r["prefix"] == "val"]
        if ([r["step"] for r in train_recs] != [1, 2, 3, 4] or [r["step"] for r in val_recs] != [2, 4]
                or any(set(r) != {"ts", "step", "prefix"} | loss_keys for r in train_recs)
                or any(set(r) != {"ts", "step", "prefix"} | loss_keys | kp_keys for r in val_recs)
                or not all(math.isfinite(r[k]) for r in recs for k in loss_keys)
                or any(r["kp_found_inframe"] + r["kp_missing_inframe"] != TRAIN_CLI_BATCH * 7 for r in val_recs)):
            raise AssertionError(f"train cli synthetic: metrics.jsonl records {recs}")
        out["synthetic"]["records"] = recs
        profiling["on"] = True
        res, out["resumed"] = run("resumed", argv + ["--num_epochs", "1", "--resume",
                                                     os.path.join(exp, "ckpt", "epoch_2.pt")], expect)
        profiling["on"] = False
        state = res["state"]
        base = train_cli.parse_args(["--dataset", syn]).lr
        lr_last = state.optimizer.param_groups[0]["lr"]
        if (state.step != 6 or [s for s, _ in lrs] != list(range(6))
                or any(abs(lr - base) > 1e-6 * base for _, lr in lrs[:4])
                or any(abs(lr - 0.1 * base) > 1e-6 * base for _, lr in lrs[4:] + [(None, lr_last)])):
            raise AssertionError(f"train cli resume: step {state.step}, learning rates {lrs}")
        out["resumed"]["learning_rates"] = lrs
        ckpts = sorted(os.listdir(os.path.join(exp, "ckpt")))
        viz = sorted(os.listdir(os.path.join(exp, "viz")))
        if ckpts != ["epoch_1.pt", "epoch_2.pt"] or viz != [
                f"train_mosaic_{st:07d}.png" for st in range(1, 7)]:
            raise AssertionError(f"train cli: checkpoints {ckpts}, images {viz}")
        out["resumed"]["kernel_ms_per_step_profiled"] = {kn: ms / profiling["steps"]
                                                         for kn, ms in profiling["kernel_ms"].items()}
        print("train cli resumed, profiled kernel ms per step: "
              + json.dumps(out["resumed"]["kernel_ms_per_step_profiled"]))
        del res, state

        # (B) --depth: 42 joints; levels 0 and 1 through the key-tiled kernel,
        # level 2's backward on the row-split path
        depth_step = dict(step_expect, biased_attention=3, biased_attention_tiled=6, biased_attention_bwd=0,
                          biased_attention_bwd_rows=3)
        depth_fwd = dict(fwd_expect, biased_attention=3, biased_attention_tiled=6)
        res, out["depth"] = run("depth", ["--dataset", os.path.join(depth, "panda-depth"), "--depth", "--output_dir",
                                          os.path.join(work, "train_depth_exp"), "--num_epochs", "1",
                                          "--batch_size", str(TRAIN_CLI_DEPTH_BATCH), "--log_every", "1",
                                          "--image_log_every", "1"],
                                {"train_step": depth_step, "predict_step": depth_fwd})
        if res["state"].step != 2 or out["depth"]["calls"] != {"train_step": 2, "predict_step": 2}:
            raise AssertionError(f"train cli depth: step {res['state'].step}, calls {out['depth']['calls']}")
        del res
    finally:
        for name, fn in real.items():
            setattr(trainer, name, fn)

    # train then infer: the resumed run's last checkpoint through the
    # inference CLI on the validation video
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = infer.main(["--dataset", val, "--ckpt", os.path.join(exp, "ckpt", "epoch_1.pt"), "--output_dir",
                      os.path.join(work, "train_infer"), "--device", "cuda"])
    torch.cuda.synchronize()
    counts = build.launch_counts()
    expect = dict(fwd_expect, biased_attention=9 * TRAIN_CLI_VAL_FRAMES, deform_conv=16 * TRAIN_CLI_VAL_FRAMES)
    km = res["keypoint_metrics"]
    if counts != expect or km["num_gt_inframe"] + km["num_gt_outframe"] != TRAIN_CLI_VAL_FRAMES * 7:
        raise AssertionError(f"train then infer: launches {counts} (expected {expect}), GT counts {km}")
    out["infer"] = {"seconds": time.perf_counter() - t0, "launches": counts, "keypoint_metrics": km,
                    "pnp_metrics": res["pnp_metrics"]}
    print("train cli, then infer on the resumed epoch's checkpoint: " + json.dumps(out["infer"]))
    return out


def column_kernel_rows(kernels, report, bf16_train, per_frame):
    """The kernels-line entries of the DCN columns' kernels (the int8 and
    QAT paths): launches from phase 18's runs (the float32 and bf16 QAT
    steps, the bf16 int8 frames, the float32 int8 CLI), the yardsticks'
    times from the same turns (phase 4: float32; phase 14: bf16), and the
    yardsticks' own entries (on no path, 0 launches)."""
    int8 = report["int8"]
    qat, qat16 = int8["qat"]["launches_per_step"], int8["qat_bf16"]["launches_per_step"]
    serving = int8["runners"]["exact_static"]["launches_per_frame"]
    dcn_rows, dcn_bwd_rows = report["deform_sample_shapes"], report["deform_sample_bwd_shapes"]
    rows16 = bf16_train["deform_sample_bf16_shapes"]
    bwd16 = bf16_train["deform_sample_bwd_bf16_shapes"]
    by_name = {e["name"]: e for e in kernels}

    e = by_name["deform_sample"]
    e.update(launches=QAT_STEPS * qat["deform_sample"], qat_launches_per_step=qat["deform_sample"],
             fused_launches_per_step=e.pop("launches_per_step"),
             int8_infer_cli_launches=int8["infer_cli"]["launches"]["deform_sample"],
             flat_ms=per_frame(dcn_rows, "flat_ms", "per_step"),
             note="the DCN's columns on the QAT path and the int8 paths of a float32 model (cli/infer --quant "
                  "int8); off the fused paths; ms per QAT step (16 nodes, batch 8), flat_ms the flat design it "
                  "replaced, timed in turns")
    e = by_name["deform_sample_bwd"]
    e.update(launches=QAT_STEPS * qat["deform_sample_bwd"], qat_launches_per_step=qat["deform_sample_bwd"],
             fused_launches_per_step=e.pop("launches_per_step"), warp_ms=per_frame(dcn_bwd_rows, "warp_ms", "per_step"),
             max_abs_err=max(r["max_abs_err"] for r in dcn_bwd_rows),
             note="the DCN columns' backward on the QAT path; off the fused path (deform_conv_dgrad); ms per QAT "
                  "step (16 nodes, batch 8, offsets in [-3, 3]), warp_ms the warp-per-item design it replaced, "
                  "timed in turns; checked at offsets 0, +-3 and +-12 px, dom the same bit for bit in two runs")
    e = by_name["deform_sample_bf16"]
    e.update(launches=serving["deform_sample_bf16"] * T_FRAMES, int8_serving_launches_per_frame=serving[
                 "deform_sample_bf16"], qat_bf16_launches_per_step=qat16["deform_sample_bf16"],
             flat_ms=per_frame(rows16, "flat_ms", "per_step"),
             ms_per_int8_frame=per_frame(rows16, "ms", "per_frame"),
             flat_ms_per_int8_frame=per_frame(rows16, "flat_ms", "per_frame"),
             plain_ms_per_int8_frame=per_frame(rows16, "plain_ms", "per_frame"),
             bound_ms_per_int8_frame=per_frame(rows16, "bound_ms", "per_frame"),
             note="the DCN's columns of bf16 int8 serving (16 a frame) and bf16 QAT (16 a step); ms per QAT step "
                  "(batch 8), ms_per_int8_frame at batch 1; flat_ms the flat design it replaced, timed in turns")
    bounds = [r["bound_by"] for r in bwd16 if r["per_step"]]
    entry16 = {
        "name": "deform_sample_bwd_bf16", "route": "cuda", "source": "sgtapose_tpu_torch/csrc/deform_sample_bwd.cu",
        "replaces": "sgtapose_tpu/models/deform_conv.py:130", "launches": QAT_STEPS * qat16["deform_sample_bwd_bf16"],
        "qat_bf16_launches_per_step": qat16["deform_sample_bwd_bf16"],
        "max_abs_err": max(r["max_abs_err"] for r in bwd16),
        "ms": per_frame(bwd16, "ms", "per_step"), "plain_ms": per_frame(bwd16, "plain_ms", "per_step"),
        "bound_ms": per_frame(bwd16, "bound_ms", "per_step"), "bound_by": max(set(bounds), key=bounds.count),
        "bound_rate": "3.35 TB/s HBM", "library_ms": None,
        "library_ms_note": "no single PyTorch call computes this function",
        "widened_route_ms": per_frame(bwd16, "widened_route_ms", "per_step"),
        "note": "the DCN columns' backward of bf16 QAT (train_demo --quant_train --bf16), per step (16 nodes, batch "
                "8, offsets in [-3, 3]); widened_route_ms the route it replaced (x and g widened to float32, the "
                "warp-per-item kernel, the gradients rounded), timed in turns"}
    yardsticks = []
    for name, rows, key, source, replaces, note in (
        ("deform_sample_bwd_warp", [r for r in dcn_bwd_rows if r["offsets"] == 3.0], "warp", "deform_sample_bwd.cu", "sgtapose_tpu/models/deform_conv.py:130",
         "the yardstick of deform_sample_bwd (one warp per (pixel, tap), scalar atomics), on no path"),
        ("deform_sample_flat", dcn_rows, "flat", "deform_sample.cu", "sgtapose_tpu/models/deform_conv.py:104",
         "the yardstick of deform_sample (one thread per 4 channels, coordinates in every thread), on no path"),
        ("deform_sample_flat_bf16", rows16, "flat", "deform_sample.cu", "sgtapose_tpu/models/deform_conv.py:104",
         "the yardstick of deform_sample_bf16 (one thread per 4 channels, 8-byte loads and stores), on no path"),
    ):
        live = [r for r in rows if r["per_step"]]
        yardsticks.append({
            "name": name, "route": "cuda", "source": f"sgtapose_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": 0, "max_abs_err": max(r[f"{key}_max_abs_err"] for r in rows),
            "ms": per_frame(rows, f"{key}_ms", "per_step"), "plain_ms": per_frame(rows, "plain_ms", "per_step"),
            "bound_ms": per_frame(rows, "bound_ms", "per_step"), "bound_by": live[0]["bound_by"],
            "bound_rate": "3.35 TB/s HBM", "library_ms": None,
            "library_ms_note": "no single PyTorch call computes this function", "note": note + "; ms per QAT step"})
    i = kernels.index(by_name["deform_sample_bf16"]) + 1
    return kernels[:i] + [entry16] + kernels[i:] + yardsticks


def bf16_kernel_rows(bf16_train, per_step_sum):
    """The kernels-line entries of phase 14's three bf16 backward kernels:
    launches from its train_demo --bf16 run, times and bounds summed over
    one training step's shapes."""
    out = []
    for name, rows, source, replaces, rate, library_note in (
        ("biased_attention_bwd_bf16", bf16_train["attention_bwd_bf16_shapes"],
         "sgtapose_tpu_torch/csrc/biased_attention_bwd.cu", "sgtapose_tpu/ops/attention_kernel.py:145",
         "67 TFLOP/s float32 FMA", "backward of F.scaled_dot_product_attention in bf16 with a float mask"),
        ("deform_conv_dgrad_bf16", bf16_train["deform_conv_dgrad_bf16_shapes"],
         "sgtapose_tpu_torch/csrc/deform_conv_dgrad_bf16.cu", "sgtapose_tpu/models/deform_conv.py:188",
         "989 TFLOP/s dense bf16", "no single PyTorch call computes this function; pair_ms: the bf16 unfused "
         "pair (dY W in bf16, then deform_sample_bwd_bf16)"),
        ("deform_sample_bf16", bf16_train["deform_sample_bf16_shapes"],
         "sgtapose_tpu_torch/csrc/deform_sample.cu", "sgtapose_tpu/models/deform_conv.py:104",
         "67 TFLOP/s float32 FMA", "no single PyTorch call computes this function"),
        ("deform_conv_wgrad_bf16", bf16_train["deform_conv_wgrad_bf16_shapes"],
         "sgtapose_tpu_torch/csrc/deform_conv_wgrad.cu", "sgtapose_tpu/models/deform_conv.py:349",
         "989 TFLOP/s dense bf16", "no single PyTorch call computes this function"),
    ):
        bounds = [r["bound_by"] for r in rows if r["per_step"]]
        bound_by = max(set(bounds), key=bounds.count)
        launches = bf16_train["launches"][name]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "launches_per_step": launches / TRAIN_STEPS, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": per_step_sum(rows, "ms", "per_step"), "plain_ms": per_step_sum(rows, "plain_ms", "per_step"),
            "bound_ms": per_step_sum(rows, "bound_ms", "per_step"), "bound_by": bound_by,
            "bound_rate": "3.35 TB/s HBM" if bound_by == "bytes" else rate,
            "library_ms": per_step_sum(rows, "library_ms", "per_step"), "library_ms_note": library_note,
            "profiled_ms_per_step": bf16_train["profiled"]["kernel_ms_per_step"][name],
            "train_cli_launches_per_step": bf16_train["train_cli"]["launches"][name] / 2,
            "shapes_note": "bf16 training (train_demo --bf16, 480x480, batch 8), per step"})
        if name == "deform_conv_wgrad_bf16":
            out[-1].update(pair_ms=per_step_sum(rows, "pair_ms", "per_step"),
                           matmul_ms=per_step_sum(rows, "matmul_ms", "per_step"))
        if name == "deform_sample_bf16":
            out[-1]["note"] = "off the path since deform_conv_wgrad_bf16; ms summed over the 16 nodes it ran on"
        if name == "deform_conv_dgrad_bf16":
            entry, pair_ms = out[-1], per_step_sum(rows, "pair_ms", "per_step")
            entry.update(pair_ms=pair_ms, matmul_ms=per_step_sum(rows, "matmul_ms", "per_step"),
                         halo_ms=per_step_sum(rows, "halo_ms", "per_step"), target_ms=DGRAD_BF16_TARGET_MS,
                         target_met=entry["ms"] <= DGRAD_BF16_TARGET_MS, beats_pair=entry["ms"] < pair_ms,
                         ms_zero_offsets=sum(r["ms"] * n for r in rows if r["offsets"] == 0.0
                                             for H_, C_, O_, n in DCN_NODES if (r["H"], r["C"], r["O"]) == (H_, C_, O_)),
                         offsets_note="ms, halo_ms, pair_ms, plain_ms at offsets in [-3, 3] px, timed in turns")
            # the design it replaced, timed in turns with it on the same inputs
            launches = bf16_train["launches"]["deform_conv_dgrad_halo_bf16"]
            out.append({
                "name": "deform_conv_dgrad_halo_bf16", "route": "cuda",
                "source": "sgtapose_tpu_torch/csrc/deform_conv_bwd.cu",
                "replaces": "sgtapose_tpu/models/deform_conv.py:188", "launches": launches,
                "launches_per_step": launches / TRAIN_STEPS,
                "max_abs_err": max(r["halo_max_abs_err"] for r in rows),
                "ms": entry["halo_ms"], "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
                "bound_by": entry["bound_by"], "bound_rate": entry["bound_rate"], "library_ms": None,
                "library_ms_note": "no single PyTorch call computes this function",
                "note": "the bf16 instantiation of the float32 design (halo tile, weight layout launch), the "
                        "yardstick of deform_conv_dgrad_bf16 on no path; ms per bf16 step over the 16 nodes"})
    return out


def _counting_calls(trainer, names, calls):
    """Wrap the trainer's entry points `names` so each call appends (name,
    the launches it made) to `calls`; returns the originals to restore."""
    from sgtapose_tpu_torch.ops import build

    real = {name: getattr(trainer, name) for name in names}

    def counted(name):
        def call(*args, **kw):
            before = build.launch_counts()
            res = real[name](*args, **kw)
            after = build.launch_counts()
            calls.append((name, {kn: after[kn] - before[kn] for kn in after}))
            return res
        return call

    for name in names:
        setattr(trainer, name, counted(name))
    return real


def _bf16_sample_bwd_rows(torch, deform_conv, cold_ms, gen, dev, feat, offsets, masks, per_step):
    """Phase 14's rows of `deform_sample_bwd_bf16` at one shape (bf16 feat,
    offsets in [-3, 3]): offsets at 0, +-3 and +-12 px against the plain
    bf16 form, dom the same bit for bit in two runs; times at +-3 in turns
    against the route it replaced (widen, the warp-per-item kernel, round)."""
    bf = torch.bfloat16
    B, H, W, C = feat.shape
    M = B * H * W
    grad = torch.randn(B, H, W, 9 * C, generator=gen, device=dev).to(bf)
    rows = []
    for span in (0.0, 3.0, 12.0):
        offs = offsets / 3 * span
        dx, dom = deform_conv.deform_sample_bwd_cuda(feat, offs, masks, grad)
        torch.cuda.synchronize()
        rdx, rdom = deform_conv.plain_deform_sample_bwd(feat, offs, masks, grad)
        errs = {"dx": rel_err(dx.float(), rdx.float()), "dom": rel_err(dom.float(), rdom.float())}
        if dx.dtype != bf or dom.dtype != bf or not all(
                math.isfinite(e) and e <= BWD_BF16_REL_TOL for e in errs.values()):
            raise AssertionError(f"deform_sample_bwd_bf16 B={B} H={H} C={C} offsets +-{span}: rel errors {errs} "
                                 f"> {BWD_BF16_REL_TOL}")
        if not torch.equal(dom, deform_conv.deform_sample_bwd_cuda(feat, offs, masks, grad)[1]):
            raise AssertionError(f"deform_sample_bwd_bf16 H={H} C={C} offsets +-{span}: two runs give another dom")
        # feat, grad (2 bytes), offsets and masks (float32) read once, dx and
        # dom (2 bytes) written once; ~34 FLOPs per (pixel, tap, channel)
        b_ms, b_by = bound_ms(2 * M * (C + 9 * C + C + 27) + 4 * M * 27, M * 9 * C * 34)
        row = dict(B=B, H=H, W=W, C=C, offsets=span, per_step=per_step if span == 3.0 else 0, rel_err=errs,
                   dom_bitwise_rerun=True,
                   max_abs_err=max((dx.float() - rdx.float()).abs().max().item(),
                                   (dom.float() - rdom.float()).abs().max().item()),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
        if span == 3.0:
            def widened():
                d32, o32 = deform_conv.deform_sample_bwd_warp_cuda(feat.float(), offs, masks, grad.float())
                return d32.to(bf), o32.to(bf)

            old_a, new_a, new_b, old_b = (cold_ms(f) for f in (
                widened, lambda: deform_conv.deform_sample_bwd_cuda(feat, offs, masks, grad),
                lambda: deform_conv.deform_sample_bwd_cuda(feat, offs, masks, grad), widened))
            row.update(ms=(new_a + new_b) / 2, widened_route_ms=(old_a + old_b) / 2,
                       plain_ms=cold_ms(lambda: deform_conv.plain_deform_sample_bwd(feat, offs, masks, grad),
                                        iters=5, warmup=1))
        rows.append(row)
        print("deform_sample_bwd_bf16 " + json.dumps(row))
        del dx, dom, rdx, rdom
    return rows


def bf16_training_phase(torch, dev, gen, cfg, cold_ms, no_launches, work, ref64):
    """Phase 14 (module docstring): bf16 mixed-precision training. (a) the
    three bf16 backward kernels against their plain versions at the
    training shapes, bit for bit in two runs (dx of the data gradient is
    added with float atomics before its rounding: its reruns are counted);
    (b) the 480x480 bf16 gradient, card against CPU bf16 and CPU float64
    (`ref64`: phase 11's float64 gradients and batch); (c) 5 bf16 train steps on a
    fixed batch, launches per step, float32 state, a profiled step; (d)
    `train_demo.main --bf16`, 20 steps (no eval), launches per step;
    (e) `cli/train.main --bf16` for 1 epoch with validation and mosaics (in
    float32) on phase 13's (A) set in `work`."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sgtapose_tpu_torch.cli import train as train_cli, train_demo
    from sgtapose_tpu_torch.data import pipeline, synthetic
    from sgtapose_tpu_torch.models import deform_conv
    from sgtapose_tpu_torch.models.sgta import create_model
    from sgtapose_tpu_torch.ops import attention_kernel, build
    from sgtapose_tpu_torch.train import trainer
    from sgtapose_tpu_torch.train.loss import sgta_loss
    from sgtapose_tpu_torch.train.phases import model_inputs
    from sgtapose_tpu_torch.utils.precision import bf16_forward

    bf = torch.bfloat16
    out = {}
    h = cfg.model.n_heads
    n_layers = cfg.model.num_decoder_layers
    t_phase = time.perf_counter()

    # ---- (a) the bf16 backward kernels against their plain versions -------
    # level 2 at the training batch: its 3 tied layers a step, q bf16 on the
    # first and float32 (after the float32 LayerNorm) on the other two; a
    # ragged (100, 8) off the path
    kernel = cfg.model.kernel_list[2]
    n2 = cfg.model.num_classes * cfg.model.k_list[2] * (1 + 2 * (kernel // 2)) ** 2
    attn_rows = []
    for n, d, q_dtype, per_step in ((n2, 16, bf, 1), (n2, 16, torch.float32, n_layers - 1),
                                    (100, 8, bf, 0), (100, 8, torch.float32, 0)):
        B = TRAIN_BATCH
        q = torch.randn(B, h, n, d, generator=gen, device=dev).to(q_dtype)
        k, v = (torch.randn(B, h, n, d, generator=gen, device=dev).to(bf) for _ in range(2))
        bias = (0.3 * torch.randn(h, n, n, generator=gen, device=dev)).to(bf)
        dout = torch.randn(B, h, n, d, generator=gen, device=dev)
        o = attention_kernel.biased_attention_bf16_cuda(q, k, v, bias)
        got = attention_kernel.biased_attention_bwd_bf16_cuda(q, k, v, bias, o, dout)
        torch.cuda.synchronize()
        ref = attention_kernel.plain_biased_attention_backward_bf16(q, k, v, bias, o, dout)
        names = ("dq", "dk", "dv", "dbias")
        errs = {name: rel_err(a.float(), r.float()) for name, a, r in zip(names, got, ref)}
        if any(a.dtype != r.dtype for a, r in zip(got, ref)) or not all(
                math.isfinite(e) and e <= BWD_BF16_REL_TOL for e in errs.values()):
            raise AssertionError(f"bf16 attention backward n={n} d={d} q {q_dtype}: rel errors {errs} > "
                                 f"{BWD_BF16_REL_TOL} (or dtypes {[a.dtype for a in got]})")
        again = attention_kernel.biased_attention_bwd_bf16_cuda(q, k, v, bias, o, dout)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"bf16 attention backward n={n} d={d}: two runs differ (no atomics)")
        # SDPA in bf16 with a float mask that requires grad: its backward alone
        qs, ks, vs, bs = (t.detach().clone().requires_grad_() for t in (q.to(bf), k, v, bias))
        y = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bs)
        dy16 = dout.to(bf)
        # read the bias, q, k, v, O and dO once, write dbias, dq, dk and dv
        # once, each at its own width (q and dq bf16 or float32, O and dO
        # float32, the rest bf16); ~10d + 5 float32 FLOPs per (b, head, i, j)
        qb = q.element_size()
        b_ms, b_by = bound_ms(2 * 2 * h * n * n + B * h * n * d * (2 * qb + 2 * 4 + 4 * 2),
                              B * h * n * n * (10 * d + 5))
        row = dict(n=n, d=d, B=B, q_dtype=str(q_dtype).replace("torch.", ""), per_step=per_step, rel_err=errs,
                   bitwise_equal_rerun=True,
                   max_abs_err=max((a.float() - r.float()).abs().max().item() for a, r in zip(got, ref)),
                   ms=cold_ms(lambda: attention_kernel.biased_attention_bwd_bf16_cuda(q, k, v, bias, o, dout)),
                   plain_ms=cold_ms(lambda: attention_kernel.plain_biased_attention_backward_bf16(
                       q, k, v, bias, o, dout)),
                   library_ms=cold_ms(lambda: y.backward(dy16, retain_graph=True)),
                   bound_ms=b_ms, bound_by=b_by)
        attn_rows.append(row)
        print("attention_bwd_bf16 " + json.dumps(row))
        del q, k, v, bias, dout, o, got, again, ref, qs, ks, vs, bs, y
    out["attention_bwd_bf16_shapes"] = attn_rows

    # the data gradient at every decoder node at the training batch, offsets
    # at zero, +-3 and +-12 px, against its plain version and the design it
    # replaced (the yardstick deform_conv_dgrad_halo_bf16, on no path); times
    # at +-3 in turns against the yardstick and the bf16 unfused pair (dY W
    # in bf16, then deform_sample_bwd_bf16): pair, yardstick, kernel, kernel,
    # yardstick, pair; the kernel's alone at zero offsets
    dgrad_rows = []
    for (H, C, O, per_step), span in [(node, span) for node in DCN_NODES + [RAGGED_DCN]
                                      for span in (0.0, 3.0, 12.0)]:
        B, W = (TRAIN_BATCH, H) if per_step else (2, H + 2)
        x = torch.randn(B, H, W, C, generator=gen, device=dev).to(bf)
        om = torch.cat([(torch.rand(B, H, W, 18, generator=gen, device=dev) * 2 - 1) * span,
                        2 * torch.randn(B, H, W, 9, generator=gen, device=dev)], dim=-1).to(bf)
        weight = (torch.randn(O, 9 * C, generator=gen, device=dev) / math.sqrt(9 * C)).to(bf)
        dy = torch.randn(B, H, W, O, generator=gen, device=dev).to(bf)
        dx, dom = deform_conv.deform_conv_dgrad_cuda(x, om, weight, dy)
        torch.cuda.synchronize()
        rdx, rdom = deform_conv.plain_deform_conv_dgrad(x, om, weight, dy)
        hdx, hdom = deform_conv.deform_conv_dgrad_halo_cuda(x, om, weight, dy)
        errs = {"dx": rel_err(dx.float(), rdx.float()), "dom": rel_err(dom.float(), rdom.float())}
        halo_errs = {"dx": rel_err(hdx.float(), rdx.float()), "dom": rel_err(hdom.float(), rdom.float())}
        if dx.dtype != bf or dom.dtype != bf or not all(math.isfinite(e) and e <= BWD_BF16_REL_TOL
                                                          for e in list(errs.values()) + list(halo_errs.values())):
            raise AssertionError(f"bf16 deform_conv_dgrad B={B} H={H} C={C} O={O} offsets +-{span}: "
                                 f"rel errors {errs} (yardstick {halo_errs}) > {BWD_BF16_REL_TOL}")
        dx2, dom2 = deform_conv.deform_conv_dgrad_cuda(x, om, weight, dy)
        if not torch.equal(dom, dom2):
            raise AssertionError(f"bf16 deform_conv_dgrad H={H} C={C} O={O}: two runs give another dom")
        M = B * H * W
        # dY, x, om and the weight read once, dx and dom written once, 2
        # bytes an element; the product's 2 M O 9C operations at the dense
        # bf16 rate (the float32 scatter not counted)
        b_ms, b_by = bound_ms(2 * (M * O + 2 * M * C + 2 * M * 27 + O * 9 * C), 2 * M * O * 9 * C, BF16_OPS_PER_S)
        row = dict(B=B, H=H, W=W, C=C, O=O, offsets=span, per_step=per_step if span == 3.0 else 0, rel_err=errs,
                   dx_rerun_elements_differing=int((dx != dx2).sum().item()),
                   max_abs_err=max((dx.float() - rdx.float()).abs().max().item(),
                                   (dom.float() - rdom.float()).abs().max().item()),
                   halo_rel_err=halo_errs,
                   halo_max_abs_err=max((hdx.float() - rdx.float()).abs().max().item(),
                                        (hdom.float() - rdom.float()).abs().max().item()),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if span == 0.0:
            row["ms"] = cold_ms(lambda: deform_conv.deform_conv_dgrad_cuda(x, om, weight, dy))
        if span == 3.0:
            offsets, masks = deform_conv.sample_inputs(om)

            def matmul():
                return (dy.view(-1, O) @ weight).view(B, H, W, 9 * C)

            def pair():
                return deform_conv.deform_sample_bwd_cuda(x, offsets, masks, matmul())

            def new():
                return deform_conv.deform_conv_dgrad_cuda(x, om, weight, dy)

            def halo():
                return deform_conv.deform_conv_dgrad_halo_cuda(x, om, weight, dy)

            t = [cold_ms(f) for f in (pair, halo, new, new, halo, pair)]
            row.update(ms=(t[2] + t[3]) / 2, halo_ms=(t[1] + t[4]) / 2, pair_ms=(t[0] + t[5]) / 2,
                       matmul_ms=cold_ms(matmul),
                       plain_ms=cold_ms(lambda: deform_conv.plain_deform_conv_dgrad(x, om, weight, dy),
                                        iters=5, warmup=1))
        dgrad_rows.append(row)
        print("deform_conv_dgrad_bf16 " + json.dumps(row))
        del x, om, weight, dy, dx, dom, dx2, dom2, rdx, rdom, hdx, hdom
    out["deform_conv_dgrad_bf16_shapes"] = dgrad_rows

    # the bf16 DCN columns of bf16 QAT and bf16 int8 serving (the sampler
    # also the route deform_conv_wgrad_bf16 replaced, its yardstick): the
    # sampler at every decoder input shape at batch 8 (a QAT step) and 1
    # (an int8 frame), the backward at batch 8 with offsets at 0, +-3 and
    # +-12 px, each against its plain bf16 form, the same bit for bit in two
    # runs (dom; the sampler's columns); times at +-3 in turns against the
    # designs they replaced: the flat sampler, and for the backward the
    # route it replaced (x and g widened to float32, the warp-per-item kernel, the
    # gradients rounded)
    sample_shapes = {}
    for H, C, _, nodes in DCN_NODES + [RAGGED_DCN]:
        sample_shapes[(H, C)] = sample_shapes.get((H, C), 0) + nodes
    sample_rows, sample_bwd_rows = [], []
    for (H, C), per_step in sample_shapes.items():
        for B in ((TRAIN_BATCH, 1) if per_step else (2,)):
            W = H if per_step else H + 2
            feat = torch.randn(B, H, W, C, generator=gen, device=dev).to(bf)
            offsets = torch.rand(B, H, W, 18, generator=gen, device=dev) * 6 - 3
            masks = torch.rand(B, H, W, 9, generator=gen, device=dev)
            cols = deform_conv.deform_sample_cuda(feat, offsets, masks)
            torch.cuda.synchronize()
            ref = deform_conv.plain_deform_sample(feat, offsets, masks)
            err = rel_err(cols.float(), ref.float())
            if cols.dtype != bf or not math.isfinite(err) or err > DCN_BF16_REL_TOL:
                raise AssertionError(f"bf16 deform_sample B={B} H={H} C={C}: rel err {err} > {DCN_BF16_REL_TOL}")
            if not torch.equal(cols, deform_conv.deform_sample_cuda(feat, offsets, masks)):
                raise AssertionError(f"bf16 deform_sample H={H} C={C}: two runs differ")
            M = B * H * W
            # feat (2 bytes), offsets and masks (float32) read once, the columns
            # written once (2 bytes); ~9 FLOPs per output element
            b_ms, b_by = bound_ms(2 * M * C + 4 * M * 27 + 2 * M * 9 * C, M * 9 * C * 9)
            flat_a, new_a, new_b, flat_b = (cold_ms(lambda: f(feat, offsets, masks)) for f in (
                deform_conv.deform_sample_flat_cuda, deform_conv.deform_sample_cuda, deform_conv.deform_sample_cuda,
                deform_conv.deform_sample_flat_cuda))
            flat = deform_conv.deform_sample_flat_cuda(feat, offsets, masks)
            row = dict(B=B, H=H, W=W, C=C, per_step=per_step if B == TRAIN_BATCH else 0,
                       per_frame=per_step if B == 1 else 0, rel_err=err, bitwise_equal_rerun=True,
                       flat_bitwise_equal=bool(torch.equal(cols, flat)),
                       flat_max_abs_err=(flat.float() - ref.float()).abs().max().item(),
                       max_abs_err=(cols.float() - ref.float()).abs().max().item(),
                       ms=(new_a + new_b) / 2, flat_ms=(flat_a + flat_b) / 2,
                       plain_ms=cold_ms(lambda: deform_conv.plain_deform_sample(feat, offsets, masks)),
                       library_ms=None, bound_ms=b_ms, bound_by=b_by)
            sample_rows.append(row)
            print("deform_sample_bf16 " + json.dumps(row))
            if B != 1:
                sample_bwd_rows += _bf16_sample_bwd_rows(torch, deform_conv, cold_ms, gen, dev, feat, offsets, masks,
                                                         per_step)
            del feat, offsets, masks, cols, ref
    out["deform_sample_bf16_shapes"] = sample_rows
    out["deform_sample_bwd_bf16_shapes"] = sample_bwd_rows
    out["kernel_checks_seconds"] = time.perf_counter() - t_phase

    # ---- (b) the 480x480 bf16 gradient: card vs CPU bf16 and CPU float64 ----
    model_cpu = create_model(cfg.model, device="cpu", seed=0)
    perturb_zero_init(model_cpu, torch.Generator().manual_seed(1))
    model_cpu.eval()
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    batch_cpu = ref64["batch"]
    grads, seconds = {}, {}
    for where, model, batch in (("card", model_gpu, {k: v.to(dev) for k, v in batch_cpu.items()}),
                                ("cpu_bf16", model_cpu, batch_cpu)):
        t0 = time.perf_counter()
        build.reset_launch_counts()
        heads = bf16_forward(model, [x.to(bf) for x in model_inputs("PlanA_win", batch)])
        loss, _ = sgta_loss({k: v.float() for k, v in heads.items()}, batch)
        loss.backward()
        if where == "card":
            torch.cuda.synchronize()
            launched = build.launch_counts()
        seconds[where] = time.perf_counter() - t0
        grads[where] = {name: p.grad.double().cpu() for name, p in model.named_parameters() if p.grad is not None}
    step_launches = dict(no_launches, biased_attention_bf16=3 * n_layers, biased_attention_bwd_bf16=n_layers,
                         deform_conv_bf16=16, deform_conv_dgrad_bf16=16, deform_conv_wgrad_bf16=16,
                         deform_conv_dgrad_halo_bf16=0)
    if launched != step_launches:
        raise AssertionError(f"bf16 gradient launches {launched}, expected {step_launches}")
    ref = ref64["grads"]
    if not set(grads["card"]) == set(grads["cpu_bf16"]) == set(ref):
        raise AssertionError("card, CPU and reference reach different parameters")
    live = [name for name, g in ref.items() if g.abs().max().item() > 1e-6]
    cmp = {"card_vs_cpu_bf16": grad_errors(grads["card"], grads["cpu_bf16"], live),
           "card_vs_float64": grad_errors(grads["card"], ref, live),
           "cpu_bf16_vs_float64": grad_errors(grads["cpu_bf16"], ref, live)}
    out["grad_bf16"] = dict(cmp, tensors=len(live), seconds=seconds, input="480x480, batch 1, BN eval mode",
                            bars={"vs_cpu_bf16": [BF16_GRAD_VS_CPU_WORST_TOL, BF16_GRAD_VS_CPU_L2_TOL],
                                  "vs_float64": [BF16_GRAD_VS_F64_WORST_TOL, BF16_GRAD_VS_F64_L2_TOL]})
    print("bf16 gradient 480x480 batch 1, BN eval mode: " + json.dumps(out["grad_bf16"]))
    for key, (worst_tol, l2_tol) in (("card_vs_cpu_bf16", (BF16_GRAD_VS_CPU_WORST_TOL, BF16_GRAD_VS_CPU_L2_TOL)),
                                     ("card_vs_float64", (BF16_GRAD_VS_F64_WORST_TOL, BF16_GRAD_VS_F64_L2_TOL))):
        worst = cmp[key]["worst"][0][1]
        if not math.isfinite(worst) or worst > worst_tol or not cmp[key]["l2"] <= l2_tol:
            raise AssertionError(f"bf16 gradient {key}: {cmp[key]} (bars {worst_tol} per tensor, {l2_tol} in L2)")
    del model_cpu, model_gpu, grads, ref, heads, loss

    # ---- (c) bf16 steps on one fixed batch ----------------------------------
    # no eval: it is phase 11's (the bf16 exact runner on the float32
    # masters), and the script keeps inside half its time limit
    argv = ["--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH), "--eval_videos", "0", "--log_every", "5",
            "--bf16"]
    args = train_demo.parse_args(argv)
    tcfg = train_demo.make_config(args)
    state = trainer.create_train_state(tcfg, args.seed, max_iters=FIXED_STEPS, device=dev)
    raw = synthetic.make_raw_batch(train_demo.step_generator(args.seed, 0, 0), TRAIN_BATCH, device=dev)
    fixed = pipeline.make_batch_fn(tcfg, synthetic.camera_K())(train_demo.step_generator(args.seed, 0, 1), raw)
    losses = []
    for _ in range(FIXED_STEPS):
        build.reset_launch_counts()
        losses.append(trainer.train_step(state, fixed, bf16=True)["tot"].item())
        torch.cuda.synchronize()
        if build.launch_counts() != step_launches:
            raise AssertionError(f"bf16 step launches {build.launch_counts()}, expected {step_launches}")
    out["fixed_batch_losses"] = losses
    print(f"bf16 fixed batch, {FIXED_STEPS} steps: losses {losses}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"bf16 fixed-batch training: losses {losses} are not finite or do not fall")
    dtypes = {str(t.dtype) for t in state.model.state_dict().values() if t.is_floating_point()}
    dtypes |= {str(v.dtype) for p in state.model.parameters() for key, v in state.optimizer.state[p].items()
               if key != "step"}
    if dtypes != {"torch.float32"}:
        raise AssertionError(f"bf16 training left masters, statistics or Adam moments in {dtypes}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            trainer.train_step(state, fixed, bf16=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    events = list(prof.events())
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms_step = sum(e.time_range.elapsed_us() for e in device) / 1e3 / 2
    out["profiled"] = {"kernel_ms_per_step": {name: kernel_device_ms(device, name) / 2 for name in DEVICE_NAMES},
                       "device_kernel_ms_per_step": device_ms_step, "profiled_wall_ms_per_step": wall_ms,
                       "device_busy_share": device_ms_step / wall_ms,
                       "launches_per_step": len(_launch_events(events)) / 2}
    print("profiled bf16 train step: " + json.dumps(out["profiled"]))
    del state, fixed, raw

    # ---- (d) train_demo.main --bf16: 20 steps on fresh batches -------------
    calls = []
    real = _counting_calls(trainer, ("train_step",), calls)
    timer = StageTimer()
    try:
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train_demo.main(argv, stage_timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in real.items():
            setattr(trainer, name, fn)
    counts = build.launch_counts()
    if len(calls) != TRAIN_STEPS or any(launched != step_launches for _, launched in calls):
        raise AssertionError(f"train_demo --bf16: per-step launches {[c for _, c in calls]}, expected "
                             f"{TRAIN_STEPS} x {step_launches}")
    expect = {kn: n * TRAIN_STEPS for kn, n in step_launches.items()}
    if counts != expect:
        raise AssertionError(f"train_demo --bf16 launches {counts}, expected {expect}")
    losses = [e["tot"] for e in res["logged"]]
    if not all(math.isfinite(x) for x in losses) or res["results"] is not None:
        raise AssertionError(f"train_demo --bf16: losses {losses}")
    stage_ms = timer.per_frame_ms(TRAIN_STEPS)
    train_ms = sum(stage_ms[st] for st in TRAIN_STAGES)
    out["train_demo"] = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "wall_s_with_setup": wall,
                         "stage_ms_per_step": stage_ms, "step_ms": train_ms, "steps_per_s": 1e3 / train_ms,
                         "launches": counts, "launches_per_step": step_launches, "logged": res["logged"],
                         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["launches"] = counts
    print("train_demo --bf16 480x480 batch 8: " + json.dumps(out["train_demo"]))
    del res

    # ---- (e) cli/train.main --bf16 on phase 13's (A) set, 1 epoch -----------
    syn, val = os.path.join(work, "train_syn"), os.path.join(work, "train_val")
    exp = os.path.join(work, "train_bf16_exp")
    calls = []
    real = _counting_calls(trainer, ("train_step", "predict_step", "eval_predict_step"), calls)
    timer = StageTimer()
    try:
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train_cli.main(["--dataset", syn, "--val_dataset", val, "--output_dir", exp, "--batch_size",
                              str(TRAIN_CLI_BATCH), "--num_epochs", "1", "--log_every", "1", "--image_log_every",
                              "1", "--bf16", "--device", "cuda"], stage_timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in real.items():
            setattr(trainer, name, fn)
    # validation and the mosaics run the float32 parameters
    fwd32 = dict(no_launches, biased_attention=3 * n_layers, deform_conv=16)
    expect = {"train_step": step_launches, "predict_step": fwd32, "eval_predict_step": fwd32}
    by_kind = {}
    for kind, launched in calls:
        if launched != expect[kind]:
            raise AssertionError(f"train cli --bf16: a {kind} call launched {launched}, expected {expect[kind]}")
        by_kind[kind] = by_kind.get(kind, 0) + 1
    counts = build.launch_counts()
    total = {kn: sum(launched[kn] for _, launched in calls) for kn in counts}
    if counts != total or by_kind != {"train_step": 2, "predict_step": 2, "eval_predict_step": 1}:
        raise AssertionError(f"train cli --bf16: calls {by_kind}, launches {counts} (in the calls: {total})")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if ([r["prefix"] for r in recs] != ["train", "train", "val"] or not os.path.exists(
            os.path.join(exp, "ckpt", "epoch_1.pt"))
            or not all(math.isfinite(r[k]) for r in recs for k in ("tot", "hm", "reg", "tracking"))):
        raise AssertionError(f"train cli --bf16: records {recs}")
    stage_ms = timer.per_frame_ms(2)
    step_ms = sum(stage_ms.get(st, 0.0) for st in CLI_STAGES)
    out["train_cli"] = {"steps": 2, "calls": by_kind, "wall_s_with_setup": wall, "launches": counts,
                        "stage_ms_per_step": {st: stage_ms.get(st, 0.0) for st in CLI_STAGES},
                        "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
                        "validation_s": [s_.elapsed_time(e_) / 1e3 for n_, s_, e_ in timer.events
                                         if n_ == "validation"],
                        "stage_ms_by_call": {st: [s_.elapsed_time(e_) for n_, s_, e_ in timer.events if n_ == st]
                                             for st in CLI_STAGES},
                        "records": recs, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("train cli --bf16: " + json.dumps(out["train_cli"]))
    out["seconds"] = time.perf_counter() - t_phase
    return out


# phase 15, the arch zoo: (arch, phase, launches per frame of the exact
# runner) of every variant served, 4 frames each at 480x480
ZOO_FRAMES = 4
ZOO_SERVING = [("dlapa_34", "PlanA", dict(biased_attention_nobias=18, deform_conv=16)),
               ("dlapawd_34", "PlanA_win", dict(biased_attention=9, deform_conv=16)),
               ("dlapacat_34", "PlanACAT", dict(deform_conv=16)),
               ("dlaabla_34", "ablation_shared_repro", dict(deform_conv=16)),
               ("dlaabla_34", "ablation_shared", dict(deform_conv=16)),
               ("dlaabla_34", "ablation_wo_shared", dict(deform_conv=16)),
               ("dlaseg_34", "CenterTrack", dict(deform_conv=16)),
               ("dlaseg_34", "CenterNet", dict(deform_conv=16))]
GLOBAL_DIMS = (4, 8, 16, 32, 64, 128)  # SGTAPoseGlobal's head dim per level
GLOBAL_TOKENS = 28
ZOO_TRAIN_BATCH = 4  # phase 13 (A)'s batch
# the no-bias kernels' cases: float32, and bf16 k and v with a bf16 q (the
# first tied layer) or a float32 q (the other two)
NOBIAS_MODES = ("float32", "bfloat16", "bf16_k_v_float32_q")


def zoo_phase(torch, dev, gen, cfg, cold_ms, warm_ms, no_launches, work, ckpt, ref64):
    """Phase 15 (module docstring): the arch zoo on the card. (a) the exact
    runner over ZOO_FRAMES frames for every variant and phase of
    ZOO_SERVING, and the bf16 exact runner for the global variant, launches
    asserted per frame; (b) the no-bias attention kernels against their plain
    versions at the global variant's (28, d), forward at B = 1, 4, 8 and the
    backward at B = 4, 8, float32 and bf16, with cold / plain / SDPA times and
    bounds; (c) `cli/train.main` for one epoch on phase 13 (A)'s set at batch
    4 for the global variant (float32 and --bf16), the three-frame variant
    (three-frame windows) and the concat baseline (its double-width
    decoder's DCN backward), launches asserted per step, and the global
    variant's eval-mode 480x480 gradient card vs CPU float64 at phase 11's
    bars; (d) phase 11's checkpoint through `cli/convert.py` on the card to
    a .pth and back (the same tensors bit for bit, the same keypoints), then
    `cli/train.main --init_backbone` from the port's own ImageNet-format
    export of its trunk."""
    import torch.nn.functional as F

    from sgtapose_tpu_torch.cli import convert as convert_cli, train as train_cli
    from sgtapose_tpu_torch.data import synthetic
    from sgtapose_tpu_torch.infer import detector as det_lib
    from sgtapose_tpu_torch.models.sgta import create_model
    from sgtapose_tpu_torch.ops import attention_kernel as ak, build
    from sgtapose_tpu_torch.train.phases import model_wiring
    from sgtapose_tpu_torch.utils import torch_convert
    from sgtapose_tpu_torch.utils.precision import bf16_inference_model

    out = {}
    t_phase = time.perf_counter()
    h = cfg.model.n_heads
    n_layers = cfg.model.num_decoder_layers
    bf16 = torch.bfloat16

    # ---- (a) serving every variant ---------------------------------------
    projs, raw, _ = synthetic.make_sequence(torch.Generator().manual_seed(21), ZOO_FRAMES,
                                            return_pos_cam=True, device=dev)
    images, _, _ = det_lib.preprocess_frames(raw, cfg)
    x3d = synthetic.skeleton(dev)[None].expand(ZOO_FRAMES, -1, -1).contiguous()
    video = det_lib.VideoFrames(images=images, x3d=x3d, teacher_kps=projs)
    K, raw_hw = synthetic.camera_K(dev), (synthetic.RAW_H, synthetic.RAW_W)
    K_ = cfg.model.num_classes
    shapes = {"detected_kps": (ZOO_FRAMES, K_, 2), "scores": (ZOO_FRAMES, K_), "tracking": (ZOO_FRAMES, K_, 2)}
    timer = StageTimer()
    serving = {}
    runs = list(ZOO_SERVING) + [("dlapa_34", "PlanA",
                                 dict(biased_attention_nobias_bf16=18, deform_conv_bf16=16), "bf16")]
    for arch, phase, per_frame, *dtype in runs:
        name = f"{arch}/{phase}" + ("/bf16" if dtype else "")
        model_cfg, tracking = model_wiring(dataclasses.replace(cfg.model, arch=arch), phase)
        zcfg = dataclasses.replace(cfg, model=model_cfg)
        model = create_model(model_cfg, device=dev, seed=0, tracking=tracking)
        if dtype:
            model = bf16_inference_model(model)
        detector = det_lib.make_video_detector(model, zcfg, K, raw_hw, device=dev, stage_timer=timer, phase=phase)
        detector(slice_frames(video, 2))  # first use
        torch.cuda.synchronize()
        timer.reset()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = detector(video)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = build.launch_counts()
        expect = dict(no_launches, **{k: n * ZOO_FRAMES for k, n in per_frame.items()})
        if counts != expect:
            raise AssertionError(f"zoo serving {name}: launch counts {counts}, expected {expect}")
        check_result(res, shapes)
        run = {"fps": ZOO_FRAMES / wall, "wall_s": wall, "stage_ms_per_frame": timer.per_frame_ms(ZOO_FRAMES),
               "launches": {k: v for k, v in counts.items() if v},
               "valid_detections": int((res.detected_kps > det_lib.KP_SENTINEL).all(-1).sum())}
        print(f"zoo serving {name}: " + json.dumps(run))
        serving[name] = run
        del model, detector
    out["serving"] = serving

    # ---- (b) the no-bias kernels against their plain versions and the ------
    # kernels they replaced (the yardsticks), timed in turns: yardstick,
    # new, new, yardstick
    n = GLOBAL_TOKENS
    fwd_rows, bwd_rows = [], []
    rel = lambda a, b: rel_err(a.float(), b.float())  # noqa: E731
    for mode in NOBIAS_MODES:
        bf = mode != "float32"
        el, el_q = (2 if bf else 4), (2 if mode == "bfloat16" else 4)
        # per global frame (step) a level launches the first tied layer with
        # a bf16 q and the other two with a float32 q (their LayerNorm)
        layers = n_layers if not bf else (1 if mode == "bfloat16" else n_layers - 1)
        if bf:
            kern, plain = ak.biased_attention_bf16_cuda, ak.plain_biased_attention_bf16
            plain_bwd, tol, bwd_tol = ak.plain_biased_attention_backward_bf16, ATTN_BF16_TOL, BWD_BF16_REL_TOL
        else:
            kern, plain = ak.biased_attention_cuda, ak.plain_biased_attention
            plain_bwd, tol, bwd_tol = ak.plain_biased_attention_backward, ATTN_TOL, BWD_REL_TOL
        for d in GLOBAL_DIMS:
            for B in (1, 4, 8):
                q, k, v, dout = (torch.randn(B, h, n, d, generator=gen, device=dev) for _ in range(4))
                if bf:
                    k, v = k.to(bf16), v.to(bf16)
                    q = q.to(bf16) if mode == "bfloat16" else q
                new = lambda: kern(q, k, v, None)  # noqa: E731
                yard = lambda: ak.attention_nobias_rowtile_cuda(q, k, v)  # noqa: E731
                got, old = new(), yard()
                torch.cuda.synchronize()
                ref = plain(q, k, v, None)
                err, old_err = (got - ref).abs().max().item(), (old - ref).abs().max().item()
                if not all(math.isfinite(e) and e <= tol for e in (err, old_err)):
                    raise AssertionError(f"no-bias attention {mode} d={d} B={B}: max abs err {err}, "
                                         f"yardstick {old_err} > {tol}")
                if not torch.equal(got, new()):
                    raise AssertionError(f"no-bias attention {mode} d={d} B={B}: reruns differ")
                cold = [cold_ms(yard), cold_ms(new), cold_ms(new), cold_ms(yard)]
                warm = [warm_ms(yard), warm_ms(new), warm_ms(new), warm_ms(yard)]
                b_ms, b_by = bound_ms(B * h * n * d * (el_q + 2 * el + 4), B * h * n * n * (4 * d + 4))
                row = dict(dtype="bfloat16" if bf else "float32", q_dtype="bfloat16" if mode == "bfloat16" else "float32", n=n, d=d, B=B,
                           per_frame=layers if B == 1 else 0, max_abs_err=err, yardstick_max_abs_err=old_err,
                           ms=(cold[1] + cold[2]) / 2, yardstick_ms=(cold[0] + cold[3]) / 2,
                           warm_ms=(warm[1] + warm[2]) / 2, yardstick_warm_ms=(warm[0] + warm[3]) / 2,
                           plain_ms=cold_ms(lambda: plain(q, k, v, None)),
                           library_ms=cold_ms(lambda: F.scaled_dot_product_attention(q.to(k.dtype), k, v)),
                           bound_ms=b_ms, bound_by=b_by)
                fwd_rows.append(row)
                print("attention_nobias " + json.dumps(row))
                if B == 1:
                    continue
                # the backward at the training batches; per step at phase 13's
                # batch of 4, levels 2-5 (levels 0 and 1 feed no head)
                new = lambda: ak.attention_bwd_nobias_cuda(q, k, v, ref, dout)  # noqa: E731
                yard = lambda: ak.attention_bwd_nobias_cluster_cuda(q, k, v, ref, dout)  # noqa: E731
                got, old = new(), yard()
                torch.cuda.synchronize()
                want = plain_bwd(q, k, v, None, ref, dout)
                err = max(rel(a, b) for a, b in zip(got, want[:3]))
                old_err = max(rel(a, b) for a, b in zip(old, want[:3]))
                if not all(math.isfinite(e) and e <= bwd_tol for e in (err, old_err)):
                    raise AssertionError(f"no-bias attention backward {mode} d={d} B={B}: rel err {err}, "
                                         f"yardstick {old_err} > {bwd_tol}")
                if not all(torch.equal(a, b) for a, b in zip(got, new())):
                    raise AssertionError(f"no-bias attention backward {mode} d={d} B={B}: reruns differ")
                leaves = [t.detach().clone().to(k.dtype).requires_grad_() for t in (q, k, v)]
                sd_out = F.scaled_dot_product_attention(*leaves)

                def sdpa_bwd():
                    torch.autograd.grad(sd_out, leaves, dout.to(sd_out.dtype), retain_graph=True)

                cold = [cold_ms(yard), cold_ms(new), cold_ms(new), cold_ms(yard)]
                warm = [warm_ms(yard), warm_ms(new), warm_ms(new), warm_ms(yard)]
                b_ms, b_by = bound_ms(B * h * n * d * (2 * el_q + 4 * el + 8), B * h * n * n * (10 * d + 5))
                row = dict(dtype="bfloat16" if bf else "float32", q_dtype="bfloat16" if mode == "bfloat16" else "float32", n=n, d=d, B=B,
                           per_step=layers if (B == ZOO_TRAIN_BATCH and d >= 16) else 0,
                           max_abs_err=err, yardstick_max_abs_err=old_err,
                           ms=(cold[1] + cold[2]) / 2, yardstick_ms=(cold[0] + cold[3]) / 2,
                           warm_ms=(warm[1] + warm[2]) / 2, yardstick_warm_ms=(warm[0] + warm[3]) / 2,
                           plain_ms=cold_ms(lambda: plain_bwd(q, k, v, None, ref, dout)),
                           library_ms=cold_ms(sdpa_bwd), bound_ms=b_ms, bound_by=b_by)
                bwd_rows.append(row)
                print("attention_bwd_nobias " + json.dumps(row))
    out["nobias_forward_shapes"], out["nobias_backward_shapes"] = fwd_rows, bwd_rows

    # ---- (c) training the zoo through cli/train ----------------------------
    syn = os.path.join(work, "train_syn")  # phase 13 (A)'s set
    step16 = dict(deform_conv=16, deform_conv_dgrad=16, deform_conv_wgrad=16)
    trains = [("global", ["--arch", "dlapa_34", "--phase", "PlanA"],
               dict(step16, biased_attention_nobias=18, biased_attention_bwd_nobias=12)),
              ("three", ["--arch", "dlapawd3_34", "--phase", "PlanA_three"],
               dict(step16, biased_attention=18, biased_attention_bwd=6)),
              # the DCN kernels' backward at the double-width decoder (C up to 1024)
              ("cat", ["--arch", "dlapacat_34", "--phase", "PlanACAT"], step16),
              ("global_bf16", ["--arch", "dlapa_34", "--phase", "PlanA", "--bf16"],
               dict(biased_attention_nobias_bf16=18, biased_attention_bwd_nobias_bf16=12, deform_conv_bf16=16,
                    deform_conv_dgrad_bf16=16, deform_conv_wgrad_bf16=16, deform_conv_dgrad_halo_bf16=0))]
    out["train_cli"] = {}
    for name, flags, per_step in trains:
        timer = StageTimer()
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train_cli.main(["--dataset", syn, "--output_dir", os.path.join(work, f"zoo_{name}"),
                              "--num_epochs", "1", "--batch_size", str(ZOO_TRAIN_BATCH), "--log_every", "1",
                              "--image_log_every", "0", "--device", "cuda"] + flags, stage_timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = res["state"].step
        counts = build.launch_counts()
        expect = dict(no_launches, **{k: c * steps for k, c in per_step.items()})
        if steps != 2 or counts != expect:
            raise AssertionError(f"zoo train cli {name}: {steps} steps, launches {counts}, expected {expect}")
        stage_ms = timer.per_frame_ms(steps)
        step_ms = sum(stage_ms.get(st, 0.0) for st in CLI_STAGES)
        rec = {"steps": steps, "wall_s_with_setup": wall, "launches": {k: v for k, v in counts.items() if v},
               "stage_ms_per_step": {st: stage_ms.get(st, 0.0) for st in CLI_STAGES}, "step_ms": step_ms,
               "steps_per_s": 1e3 / step_ms, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "model": type(res["state"].model).__name__}
        print(f"zoo train cli {name}: " + json.dumps(rec))
        out["train_cli"][name] = rec
        del res
    gcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, arch="dlapa_34"))
    out["global_grad_eval_mode_vs_float64"] = eval_mode_gradient_check(
        torch, dev, gcfg, ref64["batch"], no_launches, None, phase="PlanA",
        expect=dict(no_launches, biased_attention_nobias=18, biased_attention_bwd_nobias=12, deform_conv=16,
                    deform_conv_wgrad=16, deform_conv_dgrad=16))

    # ---- (d) the converter on the card -------------------------------------
    pth, back = os.path.join(work, "flagship.pth"), os.path.join(work, "flagship_back.pt")
    t0 = time.perf_counter()
    convert_cli.main(["--ckpt", ckpt, "--out_pth", pth])
    report = convert_cli.main(["--torch_ckpt", pth, "--out", back])
    if not report["device"].startswith("cuda"):
        raise AssertionError(f"converter: its template state is on {report['device']}, not the card")
    if report["missing"] or report["mismatched"] or report["unused_ref_keys"]:
        raise AssertionError(f"converter round trip: {report}")
    first = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    second = torch.load(back, map_location="cpu", weights_only=True)["model"]
    differ = [k for k in first if not torch.equal(first[k], second[k])]
    if set(first) != set(second) or differ:
        raise AssertionError(f"converter round trip: tensors differ: {differ[:5]}")
    kps = []
    for path in (ckpt, back):
        model = create_model(cfg.model, device=dev, seed=0)
        model.load_state_dict(torch.load(path, map_location=dev, weights_only=True)["model"])
        kps.append(det_lib.make_video_detector(model.eval(), cfg, K, raw_hw, device=dev)(video).detected_kps)
    if not torch.equal(kps[0], kps[1]):
        raise AssertionError("converter round trip: the keypoints differ")
    conv = {"seconds": time.perf_counter() - t0, "n_converted": report["n_converted"],
            "valid_detections": int((kps[0] > det_lib.KP_SENTINEL).all(-1).sum())}
    # --init_backbone from the port's own ImageNet-format export of that
    # checkpoint's trunk, at lr 0: the trunk's convolutions stay the donor's
    donor = create_model(cfg.model, device="cpu", seed=0)
    donor.load_state_dict(first)
    inet = os.path.join(work, "dla34_imagenet.pth")
    torch.save({k: torch.from_numpy(v) for k, v in torch_convert.export_imagenet_dla34(donor).items()}, inet)
    build.reset_launch_counts()
    res = train_cli.main(["--dataset", syn, "--output_dir", os.path.join(work, "zoo_init"), "--num_epochs", "1",
                          "--batch_size", str(ZOO_TRAIN_BATCH), "--image_log_every", "0", "--lr", "0",
                          "--init_backbone", inet, "--device", "cuda"])
    torch.cuda.synchronize()
    got = res["state"].model.state_dict()
    convs = [k for k, t in first.items() if k.startswith("base.") and t.dim() == 4]
    if not convs or not all(torch.equal(got[k].cpu(), first[k]) for k in convs):
        raise AssertionError("--init_backbone: the trunk's convolutions are not the donor's")
    conv["init_backbone_steps"] = res["state"].step
    conv["init_backbone_launches"] = {k: v for k, v in build.launch_counts().items() if v}
    print("zoo converter: " + json.dumps(conv))
    out["converter"] = conv
    out["seconds"] = time.perf_counter() - t_phase
    return out


DREAM_FRAMES = 16  # phase 9's synthetic 640x360 video at its earlier length
DREAM_ARCHS = ("dreamhourglass", "resnetsimple")


def dream_phase(torch, dev, cfg, cold_ms, no_launches, work, ref64):
    """Phase 16 (module docstring): the DREAM baselines on the card, where
    no hand-written kernel runs (every counter stays 0, asserted per run).
    (a) DreamHourglass and ResnetSimple (resnet101 depth) at 480x480, float32,
    card against the CPU, heads at phase 8's bar; (b) `make_dream_detector`
    on a 16-frame synthetic 640x360 video for both archs with and without
    flip_test: ms per stage (host preprocess, forward, decode, host
    conversion, the port's StageTimer: the device synchronised at each
    edge), fps, and the device's busy share from torch.profiler over one
    more run; (c) `cli/infer.main --is_ct false --arch dreamhourglass
    --flip_test` on phase 12's synthetic set; (d) `cli/train.main --phase
    Dream --arch dreamhourglass` for one epoch on phase 13 (A)'s set at batch
    4, float32 and --bf16; (e) the Dream phase's eval-mode 480x480 gradient, card against CPU
    float64, at phase 11's bars."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sgtapose_tpu_torch.cli import infer as infer_cli, train as train_cli
    from sgtapose_tpu_torch.data import synthetic
    from sgtapose_tpu_torch.infer.dream_detector import make_dream_detector
    from sgtapose_tpu_torch.models.sgta import create_model
    from sgtapose_tpu_torch.ops import build
    from sgtapose_tpu_torch.utils.profiling import StageTimer as SyncedTimer

    out = {}
    t_phase = time.perf_counter()

    def assert_no_launches(what):
        counts = build.launch_counts()
        if counts != no_launches:
            raise AssertionError(f"DREAM {what}: hand-written kernels launched: "
                                 f"{ {k: v for k, v in counts.items() if v} }")

    # ---- (a) full-width forward, card vs CPU -------------------------------
    H, W = cfg.model.input_res
    image = torch.randn(1, H, W, 3, generator=torch.Generator().manual_seed(31))
    out["forward"] = {}
    for arch in DREAM_ARCHS:
        mcfg = dataclasses.replace(cfg.model, arch=arch)
        model_cpu = create_model(mcfg, device="cpu", seed=0)
        perturb_zero_init(model_cpu, torch.Generator().manual_seed(1))
        model = copy.deepcopy(model_cpu).to(dev)
        with torch.no_grad():
            t0 = time.perf_counter()
            ref = model_cpu(image)["hm"]
            cpu_s = time.perf_counter() - t0
            build.reset_launch_counts()
            got = model(image.to(dev))["hm"]
            torch.cuda.synchronize()
            assert_no_launches(f"{arch} forward")
            x1 = image.to(dev)
            ms = cold_ms(lambda: model(x1), iters=5, warmup=1)
            macs = conv_macs(torch, model, x1)
        got = got.cpu()
        down = 4 if arch == "dreamhourglass" else 2
        if got.shape != (1, H // down, W // down, cfg.model.num_classes) or not torch.isfinite(got).all():
            raise AssertionError(f"DREAM {arch} forward: shape {tuple(got.shape)} or non-finite values")
        scale = max(1.0, ref.abs().max().item())
        err = (got - ref).abs().max().item()
        n_params = sum(p.numel() for p in model.parameters())
        b_ms, b_by = bound_ms(4 * n_params, 2 * macs)
        rec = {"hm_shape": list(got.shape), "max_abs_err": err, "max_abs_cpu": ref.abs().max().item(),
               "cpu_seconds": cpu_s, "card_ms_batch1": ms, "params_m": n_params / 1e6, "conv_gmac": macs / 1e9,
               "bound_ms": b_ms, "bound_by": b_by, "bound_note": "2 x MACs at 67 TFLOP/s float32 FMA; weights "
               "read once at 3.35 TB/s"}
        print(f"DREAM forward {arch} 480x480 card vs cpu: " + json.dumps(rec))
        if err > FORWARD_REL_TOL * scale:
            raise AssertionError(f"DREAM {arch} forward: card vs CPU max abs err {err} > {FORWARD_REL_TOL} x {scale}")
        out["forward"][arch] = rec
        del model_cpu, model

    # ---- (b) the single-frame detector -------------------------------------
    _, raw, _ = synthetic.make_sequence(torch.Generator().manual_seed(3), DREAM_FRAMES, return_pos_cam=True,
                                        device=dev)
    frames = raw.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    raw_wh = (synthetic.RAW_W, synthetic.RAW_H)
    out["detector"] = {}
    for arch in DREAM_ARCHS:
        mcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, arch=arch))
        model = create_model(mcfg.model, device=dev, seed=0)
        for flip in (False, True):
            name = f"{arch}" + ("/flip_test" if flip else "")
            timer = SyncedTimer(dev)
            det = make_dream_detector(model, mcfg, raw_wh, flip_test=flip, device=dev, stage_timer=timer.stage)
            det(frames)  # first use
            timer.totals.clear()
            timer.counts.clear()
            build.reset_launch_counts()
            t0 = time.perf_counter()
            kps, scores = det(frames)
            wall = time.perf_counter() - t0
            assert_no_launches(f"detector {name}")
            K = cfg.model.num_classes
            if kps.shape != (DREAM_FRAMES, K, 2) or scores.shape != (DREAM_FRAMES, K) or not (
                    np.isfinite(kps).all() and np.isfinite(scores).all()):
                raise AssertionError(f"DREAM detector {name}: shapes {kps.shape} {scores.shape} or non-finite")
            # the device's busy share over one more run, unsynchronised
            plain = make_dream_detector(model, mcfg, raw_wh, flip_test=flip, device=dev)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                plain(frames)
                torch.cuda.synchronize()
                prof_wall_ms = (time.perf_counter() - t1) * 1e3
            device_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                            if e.device_type == DeviceType.CUDA) / 1e3
            stage_ms = {k: v * 1e3 / DREAM_FRAMES for k, v in timer.summary().items()}
            rec = {"frames": DREAM_FRAMES, "fps": DREAM_FRAMES / wall, "wall_ms": wall * 1e3,
                   "stage_ms_per_frame": stage_ms, "profiled_wall_ms": prof_wall_ms,
                   "device_kernel_ms": device_ms, "busy_share": device_ms / prof_wall_ms,
                   "valid_detections": int((kps[..., 0] > -999.0).sum())}
            print(f"DREAM detector {name}: " + json.dumps(rec))
            out["detector"][name] = rec
        del model

    # ---- (c) the inference CLI, --is_ct false --flip_test ------------------
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = infer_cli.main(["--dataset", os.path.join(work, "syn"), "--output_dir", os.path.join(work, "dream_infer"),
                          "--is_ct", "false", "--arch", "dreamhourglass", "--flip_test", "--device", "cuda"])
    torch.cuda.synchronize()
    assert_no_launches("cli/infer --is_ct false --flip_test")
    km = res["keypoint_metrics"]
    if km["num_gt_inframe"] + km["num_gt_outframe"] != CLI_VIDEOS * CLI_FRAMES * cfg.model.num_classes:
        raise AssertionError(f"DREAM cli/infer: {km}")
    out["infer_cli"] = {"wall_s_with_setup": time.perf_counter() - t0, "fps": res["timing"]["fps"],
                        "frames": res["timing"]["frames"], "stage_s_per_video": res["timing"]["stage_s"]}
    print("DREAM cli/infer --is_ct false --flip_test: " + json.dumps(out["infer_cli"]))

    # ---- (d) the training CLI, --phase Dream (float32 and --bf16) ---------
    out["train_cli"] = {}
    for name, flags in (("float32", []), ("bf16", ["--bf16"])):
        timer = StageTimer()
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train_cli.main(["--dataset", os.path.join(work, "train_syn"), "--output_dir",
                              os.path.join(work, f"dream_{name}"), "--phase", "Dream", "--arch", "dreamhourglass",
                              "--num_epochs", "1", "--batch_size", str(TRAIN_CLI_BATCH), "--log_every", "1",
                              "--image_log_every", "0", "--device", "cuda"] + flags, stage_timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert_no_launches(f"cli/train --phase Dream {name}")
        state = res["state"]
        steps = state.step
        if steps != 2 or type(state.model).__name__ != "DreamHourglass" or not all(
                torch.isfinite(p).all() for p in state.model.parameters()):
            raise AssertionError(f"DREAM cli/train {name}: {steps} steps of {type(state.model).__name__}")
        stage_ms = timer.per_frame_ms(steps)
        step_ms = sum(stage_ms.get(st, 0.0) for st in CLI_STAGES)
        rec = {"steps": steps, "batch": TRAIN_CLI_BATCH, "wall_s_with_setup": wall,
               "stage_ms_per_step": {st: stage_ms.get(st, 0.0) for st in CLI_STAGES}, "step_ms": step_ms,
               "steps_per_s": 1e3 / step_ms, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"DREAM cli/train --phase Dream {name}: " + json.dumps(rec))
        out["train_cli"][name] = rec
        del res, state

    # ---- (e) the Dream phase's eval-mode gradient vs float64 ---------------
    dcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, arch="dreamhourglass"))
    out["grad_eval_mode_vs_float64"] = eval_mode_gradient_check(torch, dev, dcfg, ref64["batch"], no_launches, None,
                                                                phase="Dream", expect=no_launches)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"DREAM phase: {out['seconds']:.1f} s")
    return out


# phase 17, --bf16 --depth: a 42-keypoint model's attention in bf16 (kernel
# A, the bf16 key-tiled forward, at level 0; the bf16 shared-memory kernel at
# levels 1 and 2; kernel B, the bf16 row-split backward, at level 2), its
# bf16 serving over BF16_DEPTH_FRAMES frames and `cli/train --bf16 --depth`;
# then multi-GPU serving as one rank
BF16_DEPTH_FRAMES = 4


def bf16_depth_phase(torch, dev, gen, cfg, cold_ms, warm_ms, no_launches, work, serving):
    """Phase 17 (module docstring). `serving`: phase 9's bf16 flagship model,
    camera, raw frame size, 8-video batch and the batched runner's result on
    it, for (f)."""
    import torch.nn.functional as F

    from sgtapose_tpu_torch.cli import train as train_cli
    from sgtapose_tpu_torch.core import geometry
    from sgtapose_tpu_torch.data import synthetic
    from sgtapose_tpu_torch.infer import detector as det_lib
    from sgtapose_tpu_torch.models.sgta import create_model
    from sgtapose_tpu_torch.ops import attention_kernel, build
    from sgtapose_tpu_torch.train import trainer
    from sgtapose_tpu_torch.utils.precision import bf16_inference_model

    bf = torch.bfloat16
    out = {}
    h = cfg.model.n_heads
    n_layers = cfg.model.num_decoder_layers
    t_phase = time.perf_counter()
    levels = []
    for i in range(3):
        kernel = cfg.model.kernel_list[i]
        levels.append((DEPTH_CLASSES * cfg.model.k_list[i] * (1 + 2 * (kernel // 2)) ** 2, 4 * 2 ** i))
    (n0, d0), (n1, d1), (n2, d2) = levels
    if (attention_kernel.fits_smem(n0, d0, 2) or not attention_kernel.fits_smem(n1, d1, 2)
            or attention_kernel.bwd_path(n2, d2) != "rows"):
        raise AssertionError(f"42-keypoint levels {levels}: expected level 0 beyond the bf16 shared-memory kernel, "
                             "level 1 within it, level 2's backward on the row-split path")

    # ---- (a), (b) the bf16 forwards at level 0 (kernel A) and level 1 -------
    # batch 1 (serving: per frame, q bf16 on the first tied layer, float32
    # after the float32 LayerNorm on the others) and the --depth batch of 2
    # (per --bf16 --depth step)
    fwd_rows = {"tiled": [], "smem": []}
    for (n, d), which, wrapper in (((n0, d0), "tiled", attention_kernel.biased_attention_tiled_cuda),
                                   ((n1, d1), "smem", attention_kernel.biased_attention_bf16_cuda)):
        for B in (1, TRAIN_CLI_DEPTH_BATCH):
            for q_dtype in (bf, torch.float32):
                q = torch.randn(B, h, n, d, generator=gen, device=dev).to(q_dtype)
                k, v = (torch.randn(B, h, n, d, generator=gen, device=dev).to(bf) for _ in range(2))
                bias = (0.1 * torch.randn(h, n, n, generator=gen, device=dev)).to(bf)
                o = wrapper(q, k, v, bias)
                torch.cuda.synchronize()
                ref = attention_kernel.plain_biased_attention_bf16(q, k, v, bias)
                err = (o - ref).abs().max().item()
                if o.dtype != torch.float32 or not math.isfinite(err) or err > ATTN_BF16_TOL:
                    raise AssertionError(f"bf16 attention ({which}) B={B} n={n} d={d} q {q_dtype}: max abs err "
                                         f"{err} > {ATTN_BF16_TOL} (or out {o.dtype})")
                layers = 1 if q_dtype == bf else n_layers - 1
                b_ms, b_by = bound_ms(B * (q.element_size() + 2 * 2 + 4) * h * n * d + 2 * h * n * n,
                                      B * h * n * n * (4 * d + 4))
                q16 = q.to(bf)

                def run():
                    return wrapper(q, k, v, bias)

                row = dict(B=B, n=n, d=d, q_dtype=str(q_dtype).replace("torch.", ""),
                           per_frame=layers if B == 1 else 0, per_step=layers if B == TRAIN_CLI_DEPTH_BATCH else 0,
                           max_abs_err=err, ms=cold_ms(run), warm_ms=warm_ms(run), clean_ms=cold_ms(run, clean=True),
                           plain_ms=cold_ms(lambda: attention_kernel.plain_biased_attention_bf16(q, k, v, bias),
                                            iters=5),
                           library_ms=cold_ms(lambda: F.scaled_dot_product_attention(q16, k, v, attn_mask=bias),
                                              iters=5),
                           bound_ms=b_ms, bound_by=b_by)
                if which == "smem":
                    # kernel A on the same inputs, the route's alternative
                    # at a shape that fits the shared-memory kernel
                    o_a = attention_kernel.biased_attention_tiled_cuda(q, k, v, bias)
                    torch.cuda.synchronize()
                    err_a = (o_a - ref).abs().max().item()
                    if o_a.dtype != torch.float32 or not math.isfinite(err_a) or err_a > ATTN_BF16_TOL:
                        raise AssertionError(f"bf16 key-tiled attention B={B} n={n} d={d} q {q_dtype}: max abs err "
                                             f"{err_a} > {ATTN_BF16_TOL} (or out {o_a.dtype})")
                    row.update(tiled_max_abs_err=err_a, tiled_ms=cold_ms(
                        lambda: attention_kernel.biased_attention_tiled_cuda(q, k, v, bias)))
                    del o_a
                fwd_rows[which].append(row)
                print(f"attention_bf16 42-keypoint {which} " + json.dumps(row))
                del q, k, v, bias, o, ref, q16
    out["attention_tiled_bf16_shapes"], out["attention_bf16_level1_shapes"] = fwd_rows["tiled"], fwd_rows["smem"]

    # ---- (c) kernel B against its plain version -----------------------------
    # level 2 at B = 1, the --depth batch of 2 (per step) and 8, and a
    # ragged (200, 8); every output the same bit for bit in two runs
    bwd_rows = []
    for n, d, B in ((n2, d2, 1), (n2, d2, TRAIN_CLI_DEPTH_BATCH), (n2, d2, TRAIN_BATCH), (200, 8, 3)):
        if attention_kernel.bwd_path(n, d) != "rows":
            raise AssertionError(f"({n}, {d}) should take the row-split backward")
        for q_dtype in (bf, torch.float32):
            q = torch.randn(B, h, n, d, generator=gen, device=dev).to(q_dtype)
            k, v = (torch.randn(B, h, n, d, generator=gen, device=dev).to(bf) for _ in range(2))
            bias = (0.3 * torch.randn(h, n, n, generator=gen, device=dev)).to(bf)
            dout = torch.randn(B, h, n, d, generator=gen, device=dev)
            o = attention_kernel.biased_attention_bf16_cuda(q, k, v, bias)
            got = attention_kernel.biased_attention_bwd_bf16_cuda(q, k, v, bias, o, dout)
            torch.cuda.synchronize()
            ref = attention_kernel.rows_biased_attention_backward_bf16(q, k, v, bias, o, dout)
            names = ("dq", "dk", "dv", "dbias")
            errs = {name: rel_err_of_max(a.float(), r.float()) for name, a, r in zip(names, got, ref)}
            if any(a.dtype != r.dtype for a, r in zip(got, ref)) or not all(
                    math.isfinite(e) and e <= ROWS_BWD_BF16_REL_TOL for e in errs.values()):
                raise AssertionError(f"bf16 row-split backward n={n} d={d} B={B} q {q_dtype}: errors {errs} > "
                                     f"{ROWS_BWD_BF16_REL_TOL} of max|ref| (or dtypes {[a.dtype for a in got]})")
            again = attention_kernel.biased_attention_bwd_bf16_cuda(q, k, v, bias, o, dout)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"bf16 row-split backward n={n} d={d} B={B}: two runs differ (no atomics)")
            qs, ks, vs, bs = (t.detach().clone().requires_grad_() for t in (q.to(bf), k, v, bias))
            y = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bs)
            dy16 = dout.to(bf)
            qb = q.element_size()
            # as phase 14 (a): the bias, q, k, v, O and dO read once, dbias, dq,
            # dk and dv written once; ~10d + 5 float32 FLOPs per (b, head, i, j)
            b_ms, b_by = bound_ms(2 * 2 * h * n * n + B * h * n * d * (2 * qb + 2 * 4 + 4 * 2),
                                  B * h * n * n * (10 * d + 5))
            layers = 1 if q_dtype == bf else n_layers - 1
            row = dict(n=n, d=d, B=B, q_dtype=str(q_dtype).replace("torch.", ""),
                       per_step=layers if (n, d, B) == (n2, d2, TRAIN_CLI_DEPTH_BATCH) else 0, rel_err_of_max=errs,
                       bitwise_equal_rerun=True,
                       max_abs_err=max((a.float() - r.float()).abs().max().item() for a, r in zip(got, ref)),
                       ms=cold_ms(lambda: attention_kernel.biased_attention_bwd_bf16_cuda(q, k, v, bias, o, dout)),
                       plain_ms=cold_ms(lambda: attention_kernel.rows_biased_attention_backward_bf16(
                           q, k, v, bias, o, dout), iters=5),
                       library_ms=cold_ms(lambda: y.backward(dy16, retain_graph=True), iters=5),
                       bound_ms=b_ms, bound_by=b_by)
            bwd_rows.append(row)
            print("attention_bwd_rows_bf16 " + json.dumps(row))
            del q, k, v, bias, dout, o, got, again, ref, qs, ks, vs, bs, y
    out["attention_bwd_rows_bf16_shapes"] = bwd_rows
    out["kernel_checks_seconds"] = time.perf_counter() - t_phase

    # ---- (d) bf16 serving of a 42-keypoint model ----------------------------
    cfg42 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, num_classes=DEPTH_CLASSES))
    model_cpu = create_model(cfg42.model, device="cpu", seed=0)
    perturb_zero_init(model_cpu, torch.Generator().manual_seed(1))
    model16 = bf16_inference_model(copy.deepcopy(model_cpu).to(dev))
    model16_cpu = bf16_inference_model(model_cpu)
    del model_cpu
    H, W = cfg.model.input_res
    Ho, Wo = cfg.model.output_res
    g = torch.Generator().manual_seed(12)
    centers = torch.rand(DEPTH_CLASSES, 2, generator=g) * torch.tensor([Wo - 10.0, Ho - 10.0]) + 5.0
    cls = geometry.render_gaussian_heatmap(centers, torch.ones(DEPTH_CLASSES), Ho, Wo, per_class=True)
    inputs = [torch.randn(1, H, W, 3, generator=g), torch.randn(1, H, W, 3, generator=g),
              torch.rand(1, H, W, 1, generator=g), torch.rand(1, H, W, 1, generator=g),
              cls.permute(1, 2, 0)[None].contiguous(), cls.roll(3, dims=2).permute(1, 2, 0)[None].contiguous()]
    frame_launches = dict(no_launches, biased_attention_tiled_bf16=n_layers, biased_attention_bf16=2 * n_layers,
                          deform_conv_bf16=16)
    with torch.no_grad():
        t0 = time.perf_counter()
        heads_cpu = {k: v.float() for k, v in model16_cpu(*[x.to(bf) for x in inputs]).items()}
        cpu_s = time.perf_counter() - t0
        build.reset_launch_counts()
        heads = {k: v.float() for k, v in model16(*[x.to(dev, bf) for x in inputs]).items()}
        torch.cuda.synchronize()
        counts = build.launch_counts()
    del model16_cpu
    if counts != frame_launches:
        raise AssertionError(f"42-keypoint bf16 forward launches {counts}, expected {frame_launches}")
    fwd = {"cpu_seconds": cpu_s, "launches": counts}
    for key in ("hm", "reg", "tracking"):
        a, b = heads[key].cpu(), heads_cpu[key]
        if a.shape != (1, Ho, Wo, b.shape[-1]) or not torch.isfinite(a).all():
            raise AssertionError(f"42-keypoint bf16 forward {key}: shape {tuple(a.shape)} or non-finite values")
        ulp = 2.0 ** (math.floor(math.log2(max(b.abs().max().item(), 1e-30))) - 7)
        vs_cpu = (a - b).abs().max().item()
        fwd[key] = {"card_vs_cpu_max_abs_err": vs_cpu, "bf16_ulp_at_cpu_max": ulp, "card_vs_cpu_ulps": vs_cpu / ulp}
        if vs_cpu > BF16_CARD_VS_CPU_ULPS * ulp:
            raise AssertionError(f"42-keypoint bf16 forward {key}: card vs CPU bf16 {vs_cpu} "
                                 f"(bar {BF16_CARD_VS_CPU_ULPS} x {ulp})")
    if heads["hm"].shape[-1] != DEPTH_CLASSES:
        raise AssertionError(f"42-keypoint heads {heads['hm'].shape}")
    print("forward 480x480 42-keypoint bf16 card vs cpu: " + json.dumps(fwd))
    out["forward_bf16"] = fwd
    del heads, heads_cpu

    T = BF16_DEPTH_FRAMES
    raw_hw = (synthetic.RAW_H, synthetic.RAW_W)
    projs, raw = synthetic.make_sequence(torch.Generator().manual_seed(30), T, n_kp=DEPTH_CLASSES, device=dev)
    images, _, _ = det_lib.preprocess_frames(raw, cfg42)
    x3d = synthetic.robot_skeleton(DEPTH_CLASSES, dev)[None].expand(T, -1, -1).contiguous()
    video = det_lib.VideoFrames(images=images, x3d=x3d, init_kps=projs[0])
    timer = StageTimer()
    exact = det_lib.make_video_detector(model16, cfg42, synthetic.camera_K(dev), raw_hw, device=dev,
                                        stage_timer=timer)
    exact(slice_frames(video, 2))
    torch.cuda.synchronize()
    timer.reset()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = exact(video)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    expect = {kn: n * T for kn, n in frame_launches.items()}
    if counts != expect:
        raise AssertionError(f"42-keypoint bf16 exact runner launches {counts}, expected {expect}")
    check_result(res, {"detected_kps": (T, DEPTH_CLASSES, 2), "scores": (T, DEPTH_CLASSES),
                       "tracking": (T, DEPTH_CLASSES, 2)})
    out["serving"] = {"frames": T, "wall_s": wall, "fps": T / wall, "stage_ms_per_frame": timer.per_frame_ms(T),
                      "launches": counts,
                      "valid_detections": int((res.detected_kps > det_lib.KP_SENTINEL).all(-1).sum())}
    print("detector 42-keypoint bf16 exact: " + json.dumps(out["serving"]))
    del model16, exact, res, video, images, raw

    # ---- (e) cli/train.main --depth --bf16 on phase 13 (B)'s set ------------
    calls = []
    real = _counting_calls(trainer, ("train_step", "predict_step"), calls)
    timer = StageTimer()
    exp = os.path.join(work, "train_depth_bf16_exp")
    try:
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train_cli.main(["--dataset", os.path.join(work, "train_depth", "panda-depth"), "--depth", "--bf16",
                              "--output_dir", exp, "--num_epochs", "1", "--batch_size", str(TRAIN_CLI_DEPTH_BATCH),
                              "--log_every", "1", "--image_log_every", "1", "--device", "cuda"], stage_timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in real.items():
            setattr(trainer, name, fn)
    # the train step in bf16; the mosaics' forward on the float32 parameters
    step_expect = dict(no_launches, biased_attention_tiled_bf16=n_layers, biased_attention_bf16=2 * n_layers,
                       biased_attention_bwd_rows_bf16=n_layers, deform_conv_bf16=16, deform_conv_dgrad_bf16=16,
                       deform_conv_wgrad_bf16=16, deform_conv_dgrad_halo_bf16=0)
    fwd32 = dict(no_launches, biased_attention=n_layers, biased_attention_tiled=2 * n_layers, deform_conv=16)
    expect = {"train_step": step_expect, "predict_step": fwd32}
    by_kind = {}
    for kind, launched in calls:
        if launched != expect[kind]:
            raise AssertionError(f"train cli --bf16 --depth: a {kind} call launched {launched}, expected "
                                 f"{expect[kind]}")
        by_kind[kind] = by_kind.get(kind, 0) + 1
    counts = build.launch_counts()
    total = {kn: sum(launched[kn] for _, launched in calls) for kn in counts}
    if counts != total or by_kind != {"train_step": 2, "predict_step": 2} or res["state"].step != 2:
        raise AssertionError(f"train cli --bf16 --depth: calls {by_kind}, launches {counts} (in the calls: {total})")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if (res["state"].model.cfg.num_classes != DEPTH_CLASSES or not os.path.exists(os.path.join(exp, "ckpt", "epoch_1.pt"))
            or not all(math.isfinite(r[k]) for r in recs for k in ("tot", "hm", "reg", "tracking"))):
        raise AssertionError(f"train cli --bf16 --depth: records {recs}")
    stage_ms = timer.per_frame_ms(2)
    step_ms = sum(stage_ms.get(st, 0.0) for st in CLI_STAGES)
    out["train_cli"] = {"steps": 2, "batch": TRAIN_CLI_DEPTH_BATCH, "calls": by_kind, "wall_s_with_setup": wall,
                        "launches": counts, "stage_ms_per_step": {st: stage_ms.get(st, 0.0) for st in CLI_STAGES},
                        "stage_ms_by_call": {st: [s_.elapsed_time(e_) for n_, s_, e_ in timer.events if n_ == st]
                                             for st in CLI_STAGES},
                        "step_ms": step_ms, "steps_per_s": 1e3 / step_ms, "records": recs,
                        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("train cli --bf16 --depth: " + json.dumps(out["train_cli"]))
    del res

    # ---- (f) make_sharded_video_detector as one rank ------------------------
    sharded = det_lib.make_sharded_video_detector(serving["model"], cfg, serving["K"], serving["raw_hw"], device=dev)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = sharded(serving["videos"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    expect = {kn: n * T_FRAMES for kn, n in serving["per_frame_launches"].items()}
    if counts != expect:
        raise AssertionError(f"sharded runner, one rank: launches {counts}, expected {expect}")
    ref = serving["batched_result"]
    diffs = {f: (getattr(res, f) - getattr(ref, f)).abs().max().item() for f in ("detected_kps", "scores", "tracking")}
    equal = all(torch.equal(getattr(res, f), getattr(ref, f)) for f in diffs)
    if not all(math.isfinite(x) and x <= 1e-4 for x in diffs.values()):
        raise AssertionError(f"sharded runner, one rank, vs the batched runner: max abs differences {diffs}")
    out["sharded_one_rank"] = {"videos": N_VIDEOS, "frames": T_FRAMES, "wall_s": wall,
                               "fps": N_VIDEOS * T_FRAMES / wall, "launches": counts,
                               "max_abs_diff_vs_batched": diffs, "bitwise_equal_to_batched": equal}
    print("sharded runner, one rank, 8 videos: " + json.dumps(out["sharded_one_rank"]))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"bf16 --depth phase: {out['seconds']:.1f} s")
    return out


def bf16_depth_kernel_rows(depth, per_sum):
    """The kernels-line entries of phase 17's kernels A and B: A per frame of
    the 42-keypoint bf16 exact run (its launches), B per --bf16 --depth step
    of the CLI run (its launches)."""
    tiled = depth["attention_tiled_bf16_shapes"]
    rows = depth["attention_bwd_rows_bf16_shapes"]
    note_fwd = "F.scaled_dot_product_attention in bf16 with a float mask"
    a_launches = depth["serving"]["launches"]["biased_attention_tiled_bf16"]
    b_launches = depth["train_cli"]["launches"]["biased_attention_bwd_rows_bf16"]
    return [
        {"name": "biased_attention_tiled_bf16", "route": "cuda", "source": "sgtapose_tpu_torch/csrc/biased_attention.cu",
         "replaces": "sgtapose_tpu/ops/attention_kernel.py:108", "launches": a_launches,
         "launches_per_frame": a_launches / depth["serving"]["frames"],
         "max_abs_err": max(r["max_abs_err"] for r in tiled),
         "ms": per_sum(tiled, "ms"), "warm_ms": per_sum(tiled, "warm_ms"), "clean_ms": per_sum(tiled, "clean_ms"),
         "plain_ms": per_sum(tiled, "plain_ms"), "bound_ms": per_sum(tiled, "bound_ms"),
         "bound_by": tiled[0]["bound_by"], "bound_rate": "3.35 TB/s HBM" if tiled[0]["bound_by"] == "bytes"
         else "67 TFLOP/s float32 FMA", "library_ms": per_sum(tiled, "library_ms"), "library_ms_note": note_fwd,
         "ms_per_depth_step": per_sum(tiled, "ms", "per_step"),
         "train_cli_launches_per_step": depth["train_cli"]["launches"]["biased_attention_tiled_bf16"] / 2,
         "shapes_note": "level 0 of a 42-keypoint model, (7098, 4), bf16, per frame (3 tied layers)"},
        {"name": "biased_attention_bwd_rows_bf16", "route": "cuda",
         "source": "sgtapose_tpu_torch/csrc/biased_attention_bwd.cu",
         "replaces": "sgtapose_tpu/ops/attention_kernel.py:145", "launches": b_launches,
         "launches_per_depth_step": b_launches / depth["train_cli"]["steps"],
         "max_abs_err": max(r["max_abs_err"] for r in rows),
         "ms": per_sum(rows, "ms", "per_step"), "plain_ms": per_sum(rows, "plain_ms", "per_step"),
         "bound_ms": per_sum(rows, "bound_ms", "per_step"), "bound_by": rows[2]["bound_by"],
         "bound_rate": "3.35 TB/s HBM" if rows[2]["bound_by"] == "bytes" else "67 TFLOP/s float32 FMA",
         "library_ms": per_sum(rows, "library_ms", "per_step"),
         "library_ms_note": "backward of F.scaled_dot_product_attention in bf16 with a float mask",
         "ms_per_launch": {f"{r['n']},{r['d']},B={r['B']},q={r['q_dtype']}": r["ms"] for r in rows},
         "shapes_note": "level 2 of a 42-keypoint model, (378, 16), at --bf16 --depth's batch of 2, per step"},
    ]


# phase 18, int8 serving, QAT and the DCN memory knobs: train_demo
# --quant_train steps at the training batch, and the int8 forward card
# against CPU within the larger of INT8_CARD_VS_CPU x the card's own
# int8-vs-bf16 gap of each head (the CPU tests measure the two frameworks'
# int8 heads at up to 1.1x that gap: an activation within float rounding of
# an int8 rounding boundary moves one x_q by a step, which the later sites
# carry on) and phase 8's bf16 bar, BF16_CARD_VS_CPU_ULPS bf16 units at the
# head's largest value (the heads are bf16 before they are cast back: the
# hm head's int8 gap is itself one bf16 unit at its -4.6 prior bias)
INT8_OPS_PER_S = 1979e12
QAT_STEPS = 3
QAT_BF16_EVAL_FRAMES = 2
INT8_CARD_VS_CPU = 1.5
MANY_VIDEOS = 65  # past the 64 per-video scales int8_conv_fused once held in shared memory


def quant_sites(torch, model, min_ch: int) -> int:
    """The model's quantizable sites with min(out_ch, in_ch) >= min_ch, each
    called once per frame by the exact and the feature-cache runners."""
    from sgtapose_tpu_torch.models import deform_conv, layers

    n = 0
    for m in model.modules():
        if isinstance(m, layers.Conv2d):
            n += min(m.out_channels, m.in_channels) >= min_ch
        elif isinstance(m, deform_conv.DeformConv2d):
            n += min(m.kernel.weight.shape) >= min_ch
    return n


def _int_mm_yardstick(torch, x_q, qw, stride, pad):
    """The library yardstick of an int8 site on the same s8 operands: one
    torch._int_mm at a 1x1 site, the pair im2col (pad, unfold views, one
    copy) + torch._int_mm at a 3x3 or 7x7 one; None where _int_mm refuses
    the shapes (K or O not a multiple of 8)."""
    import torch.nn.functional as F

    N, H, W, C = x_q.shape
    K = qw.kh * qw.kw * C
    w = qw.q[:, :K].t()  # (K, O), column-major
    if qw.kh == 1 and stride == 1 and pad == 0:
        a = x_q.reshape(-1, C)
        return lambda: torch._int_mm(a, w)

    def pair():
        xp = F.pad(x_q, (0, 0, pad, pad, pad, pad))
        cols = xp.unfold(1, qw.kh, stride).unfold(2, qw.kw, stride).permute(0, 1, 2, 4, 5, 3).reshape(-1, K)
        return torch._int_mm(cols, w)

    return pair


def int8_phase(torch, dev, cfg, cold_ms, warm_ms, no_launches, work, ckpt, train_cli_run):
    """Phase 18 (module docstring): (a) the int8 kernel against its plain
    version at every site of one flagship frame, timed with its yardsticks;
    (b) the bf16 exact and feature-cache runners under int8, launches
    asserted per frame, and one int8 forward card against CPU; (c) the
    inference CLI with --quant int8 --quant_static --quant_min_ch 64,
    train_demo --quant_train, and cli/train with --dcn_chunks 4 and
    --dcn_remat against the same run without them."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sgtapose_tpu_torch.cli import infer, train as train_cli, train_demo
    from sgtapose_tpu_torch.data import synthetic
    from sgtapose_tpu_torch.eval.synthetic_eval import calibration_inputs, make_bf16_apply
    from sgtapose_tpu_torch.infer import detector as det_lib
    from sgtapose_tpu_torch.models import layers
    from sgtapose_tpu_torch.models.sgta import create_model
    from sgtapose_tpu_torch.ops import build, int8_conv
    from sgtapose_tpu_torch.train import trainer
    from sgtapose_tpu_torch.utils.precision import bf16_inference_model

    out = {}
    t_phase = time.perf_counter()
    bf = torch.bfloat16
    model_cpu = create_model(cfg.model, device="cpu", seed=0)
    perturb_zero_init(model_cpu, torch.Generator().manual_seed(1))
    model16_cpu = bf16_inference_model(model_cpu)
    model16 = bf16_inference_model(model_cpu).to(dev)
    del model_cpu
    H, W = cfg.model.input_res
    Ho, Wo = cfg.model.output_res
    g = torch.Generator().manual_seed(2)
    inputs = [torch.randn(1, H, W, 3, generator=g), torch.randn(1, H, W, 3, generator=g),
              torch.rand(1, H, W, 1, generator=g), torch.rand(1, H, W, 1, generator=g),
              torch.rand(1, Ho, Wo, 7, generator=g), torch.rand(1, Ho, Wo, 7, generator=g)]
    inputs16 = [x.to(bf) for x in inputs]
    calib = calibration_inputs(cfg, device=dev)
    n_calib = len(calib)  # the inference CLI calibrates on as many frames
    scales = layers.calibrate(make_bf16_apply(model16), calib)
    n_sites = {min_ch: quant_sites(torch, model16, min_ch) for min_ch in (0, 64)}
    if len(scales) != n_sites[0] or n_sites[0] != 57:
        raise AssertionError(f"int8: {len(scales)} calibrated scales, {n_sites[0]} sites; expected 57")
    out["sites"] = {str(k): v for k, v in n_sites.items()}

    # ---- (a) the site kernels at every site of one frame --------------------
    calls = []
    real = int8_conv.int8_site

    def recording(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    int8_conv.int8_site = recording
    try:
        with torch.no_grad(), layers.quantized("int8", scales=scales):
            model16(*[x.to(dev) for x in inputs16])
    finally:
        int8_conv.int8_site = real
    torch.cuda.synchronize()
    if len(calls) != 57:
        raise AssertionError(f"int8: {len(calls)} int8_site calls in one forward, expected 57")
    shapes = {}
    for x, qw, a_max, groups, bias, stride, pad in calls:
        # the frame's static scale, and the dynamic one on the same activation
        for case_max in (a_max, None):
            got, acc = int8_conv.int8_site_cuda(x, qw, case_max, groups, bias, stride, pad, return_acc=True)
            ref, ref_acc = int8_conv.plain_int8_site(x, qw, case_max, groups, bias, stride, pad, return_acc=True)
            torch.cuda.synchronize()
            if not (torch.equal(acc, ref_acc) and torch.equal(got, ref)):
                raise AssertionError(f"int8_conv_fused x {tuple(x.shape)} w {tuple(qw.q.shape)} {qw.kh}x{qw.kw} "
                                     f"s{stride} a_max {case_max}: accumulators or outputs differ from the plain version")
        key = (tuple(x.shape), tuple(qw.q.shape), qw.kh, stride, pad, bias is not None)
        shapes.setdefault(key, [0, (x, qw, a_max, groups, bias, stride, pad)])[0] += 1
    # the launch budget at all 57 sites: one launch a static site, two a
    # dynamic one, no other CUDA kernel (torch.profiler's device kernels)
    budget = {}
    for name, dynamic in (("static", False), ("dynamic", True)):
        build.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for x, qw, a_max, groups, bias, stride, pad in calls:
                int8_conv.int8_site(x, qw, None if dynamic else a_max, groups, bias, stride, pad)
            torch.cuda.synchronize()
        counts = {kn: n for kn, n in build.launch_counts().items() if n}
        events = list(prof.events())
        launches = len(_launch_events(events))  # every kernel launch the host made, of any kind
        names = sorted({e.name for e in events if e.device_type == DeviceType.CUDA})
        expect = {"int8_conv_fused": 57, **({"int8_absmax": 57} if dynamic else {})}
        if counts != expect or launches != sum(expect.values()) or not all(
                "int8_conv_fused" in n or "int8_absmax_kernel" in n for n in names):
            raise AssertionError(f"int8 launch budget {name}: counters {counts}, {launches} launches, device kernels "
                                 f"{names}, expected {expect}")
        budget[name] = {"launches_per_site": launches / 57, "device_kernel_names": len(names)}
    out["launch_budget"] = budget
    print("int8 launch budget at the 57 sites: " + json.dumps(budget))

    def pr14_route(x, qw, a_max, groups, bias, stride, pad):
        """PR 14's route, the yardstick: PyTorch's quantize ops, then PR
        14's kernel on the s8 operands."""
        a_scale = layers.activation_scale(x, a_max, groups)
        x_q = layers.activation_quant(x, a_scale).to(torch.int8).contiguous()
        return int8_conv.int8_conv_cuda(x_q, qw, a_scale, bias, stride, pad, x.dtype)

    rows = []
    for (xs, ws, k, stride, pad, has_bias), (count, args) in shapes.items():
        x, qw, a_max, groups, bias, stride, pad = args
        N, Hs, Ws, C = xs
        O = ws[0]
        Ho_, Wo_ = int8_conv.out_size(Hs, k, stride, pad), int8_conv.out_size(Ws, k, stride, pad)
        M, K = N * Ho_ * Wo_, k * k * C
        a_scale = layers.activation_scale(x, a_max, groups)
        x_q = layers.activation_quant(x, a_scale).to(torch.int8).contiguous()
        io = 4 * O + (x.element_size() * O if has_bias else 0) + M * O * x.element_size()
        b_ms, b_by = bound_ms(x.numel() * x.element_size() + O * K + io, 2 * M * O * K, INT8_OPS_PER_S)
        old_b_ms, old_b_by = bound_ms(x_q.numel() + O * K + io + 4 * N, 2 * M * O * K, INT8_OPS_PER_S)
        slots = int8_conv.absmax_slots(x.numel() // N)
        red_b_ms, _ = bound_ms(x.numel() * x.element_size() + 4 * N * slots, 0, INT8_OPS_PER_S)
        plan = int8_conv.site_plan(x, qw, stride, pad)
        kern = lambda: int8_conv.int8_site_cuda(x, qw, a_max, groups, bias, stride, pad)  # noqa: E731
        route = lambda: pr14_route(x, qw, a_max, groups, bias, stride, pad)  # noqa: E731
        # in turns: route, kernel, kernel, route
        route_a, new_a, new_b, route_b = (cold_ms(f, iters=10) for f in (route, kern, kern, route))
        yard = _int_mm_yardstick(torch, x_q, qw, stride, pad)
        try:
            yard_ms = cold_ms(yard, iters=10)
        except RuntimeError as e:  # _int_mm's shape rules (K, O multiples of 8)
            yard_ms, yard_note = None, str(e).splitlines()[0][:120]
        else:
            yard_note = None
        x16 = x.to(bf).permute(0, 3, 1, 2)
        w16 = qw.unpacked().to(bf).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        flat = x.reshape(N, -1)
        row = {"x": list(xs), "dtype": str(x.dtype).replace("torch.", ""), "O": O, "kernel": k, "stride": stride,
               "bias": has_bias, "per_frame": count, "max_abs_err": 0.0, "bitwise": True,
               "mode": plan[0], "splits": plan[1].splits,
               "ms": (new_a + new_b) / 2, "warm_ms": warm_ms(kern, iters=10),
               "dynamic_ms": cold_ms(lambda: int8_conv.int8_site_cuda(x, qw, None, groups, bias, stride, pad),
                                     iters=10),
               "route_ms": (route_a + route_b) / 2,
               "pr14_kernel_ms": cold_ms(lambda: int8_conv.int8_conv_cuda(x_q, qw, a_scale, bias, stride, pad, x.dtype),
                                         iters=10),
               "pr14_bound_ms": old_b_ms, "pr14_bound_by": old_b_by,
               "pr14_plain_ms": cold_ms(lambda: int8_conv.plain_int8_conv(x_q, qw, a_scale, bias, stride, pad, x.dtype),
                                        iters=2, warmup=1),
               "plain_ms": cold_ms(lambda: int8_conv.plain_int8_site(x, qw, a_max, groups, bias, stride, pad),
                                   iters=2, warmup=1),
               "library_ms": yard_ms if k == 1 else None, "pair_ms": yard_ms if k > 1 else None,
               "int_mm_note": yard_note,
               "cudnn_bf16_ms": cold_ms(lambda: F.conv2d(x16, w16, None, stride, pad), iters=10),
               "bound_ms": b_ms, "bound_by": b_by,
               "absmax_ms": cold_ms(lambda: int8_conv.int8_absmax_cuda(x), iters=10),
               "absmax_plain_ms": cold_ms(lambda: int8_conv.plain_int8_absmax(x, slots), iters=2, warmup=1),
               "absmax_library_ms": cold_ms(lambda: torch.linalg.vector_norm(flat, ord=math.inf, dim=1), iters=10),
               "absmax_bound_ms": red_b_ms,
               "class": "stem" if C <= 4 else ("3x3" if k > 1 else ("dcn" if has_bias else "1x1"))}
        part = int8_conv.int8_absmax_cuda(x)
        if not torch.equal(part.amax(dim=1), flat.float().abs().amax(dim=1)):
            raise AssertionError(f"int8_absmax x {tuple(xs)}: the maxima differ from torch.amax")
        got, acc = int8_conv.int8_conv_cuda(x_q, qw, a_scale, bias, stride, pad, x.dtype, return_acc=True)
        ref, ref_acc = int8_conv.plain_int8_conv(x_q, qw, a_scale, bias, stride, pad, x.dtype, return_acc=True)
        if not (torch.equal(acc, ref_acc) and torch.equal(got, ref)):
            raise AssertionError(f"int8_conv (PR 14's kernel) x_q {tuple(xs)}: differs from plain_int8_conv")
        rows.append(row)
        print("int8_conv_fused " + json.dumps(row))
    out["int8_conv_shapes"] = rows
    del calls, shapes
    keys = ("ms", "warm_ms", "dynamic_ms", "route_ms", "pr14_kernel_ms", "pr14_bound_ms", "pr14_plain_ms", "plain_ms",
            "bound_ms",
            "cudnn_bf16_ms", "library_ms", "pair_ms", "absmax_ms", "absmax_plain_ms", "absmax_library_ms",
            "absmax_bound_ms")
    sums = {key: sum(r[key] * r["per_frame"] for r in rows if r[key] is not None) for key in keys}
    sums["kernel_ms_at_1x1_sites"] = sum(r["ms"] * r["per_frame"] for r in rows if r["kernel"] == 1)
    sums["pr14_kernel_ms_at_1x1_sites"] = sum(r["pr14_kernel_ms"] * r["per_frame"] for r in rows if r["kernel"] == 1)
    sums["by_class"] = {cls: {key: sum(r[key] * r["per_frame"] for r in rows if r["class"] == cls)
                              for key in ("ms", "warm_ms", "dynamic_ms", "route_ms", "pr14_kernel_ms",
                                          "cudnn_bf16_ms", "bound_ms")}
                        for cls in ("stem", "3x3", "1x1", "dcn")}
    for cls in ("1x1", "dcn"):
        sums["by_class"][cls]["int_mm_ms"] = sum(r["library_ms"] * r["per_frame"] for r in rows
                                                 if r["class"] == cls and r["library_ms"] is not None)
    out["int8_conv_per_frame"] = sums
    print("int8_conv_fused per frame: " + json.dumps(sums))

    # ---- (b) the int8 runners on phase 9's video; card vs CPU forward -----
    projs, raw, _ = synthetic.make_sequence(torch.Generator().manual_seed(3), T_FRAMES, return_pos_cam=True,
                                            device=dev)
    images, _, _ = det_lib.preprocess_frames(raw, cfg)
    x3d = synthetic.skeleton(dev)[None].expand(T_FRAMES, -1, -1).contiguous()
    video = det_lib.VideoFrames(images=images, x3d=x3d, init_kps=projs[0])
    K, raw_hw = synthetic.camera_K(dev), (synthetic.RAW_H, synthetic.RAW_W)
    warm_cfg = dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer, pnp_warm_start=True))
    timer = StageTimer()
    shapes_ok = {"detected_kps": (T_FRAMES, 7, 2), "scores": (T_FRAMES, 7), "tracking": (T_FRAMES, 7, 2)}
    out["runners"] = {}
    # each runner with static and dynamic scales, min_ch 0 and 64, and the
    # bf16 exact runner without int8 beside them (trunk and fuse ms)
    for name, cached, static, min_ch in (("exact_static", False, True, 0), ("exact_dynamic_min_ch64", False, False, 64),
                                         ("cached_dynamic", True, False, 0), ("cached_static_min_ch64", True, True, 64),
                                         ("bf16_exact", False, None, None)):
        make = det_lib.make_cached_video_detector if cached else det_lib.make_video_detector
        quant = {} if static is None else {"quant": "int8", "quant_scales": scales if static else None,
                                           "quant_min_ch": min_ch}
        detector = make(model16, warm_cfg if cached else cfg, K, raw_hw, device=dev, stage_timer=timer, **quant)
        detector(slice_frames(video, 2))
        torch.cuda.synchronize()
        timer.reset()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = detector(video)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = build.launch_counts()
        # int8: the DCN's columns from the bf16 sampler, one int8_conv_fused a
        # site and, with dynamic scales, one int8_absmax; bf16: the fused DCN
        per_frame = (dict(no_launches, biased_attention_bf16=9, deform_conv_bf16=16) if static is None else
                     dict(no_launches, biased_attention_bf16=9, deform_sample_bf16=16, int8_conv_fused=n_sites[min_ch],
                          int8_absmax=0 if static else n_sites[min_ch]))
        expect = {kn: n * T_FRAMES for kn, n in per_frame.items()}
        if counts != expect:
            raise AssertionError(f"int8 runner {name}: launches {counts}, expected {expect}")
        check_result(res, shapes_ok)
        run = {"frames": T_FRAMES, "wall_s": wall, "fps": T_FRAMES / wall,
               "stage_ms_per_frame": timer.per_frame_ms(T_FRAMES),
               "launches_per_frame": {kn: n // T_FRAMES for kn, n in counts.items() if n},
               "valid_detections": int((res.detected_kps > det_lib.KP_SENTINEL).all(-1).sum())}
        out["runners"][name] = run
        print(f"int8 runner {name}: " + json.dumps(run))
    trunk_fuse = {name: {st: out["runners"][name]["stage_ms_per_frame"][st] for st in ("trunk", "fuse")}
                  for name in ("exact_static", "bf16_exact")}
    trunk_fuse["int8_minus_bf16_ms"] = sum(trunk_fuse["exact_static"].values()) - sum(trunk_fuse["bf16_exact"].values())
    out["trunk_fuse_vs_bf16"] = trunk_fuse
    print("int8 static vs bf16, trunk and fuse ms a frame: " + json.dumps(trunk_fuse))
    # the batched runner over MANY_VIDEOS videos (more than 64) under
    # dynamic int8: one scale per video at every site (`groups` 65); and a
    # dynamic site at `groups` 65 and 130 (130 samples) bit for bit with
    # its plain version, two launches each
    frames = 2
    short = slice_frames(video, frames)
    many = det_lib.VideoFrames(images=short.images[None].expand(MANY_VIDEOS, *short.images.shape).contiguous(),
                               x3d=short.x3d[None].expand(MANY_VIDEOS, *short.x3d.shape).contiguous(),
                               init_kps=short.init_kps[None].expand(MANY_VIDEOS, *short.init_kps.shape).contiguous())
    batched = det_lib.make_batched_video_detector(model16, cfg, K, raw_hw, device=dev, quant="int8")
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = batched(many)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    expect = {kn: n * frames for kn, n in dict(no_launches, biased_attention_bf16=9, deform_sample_bf16=16,
                                                  int8_conv_fused=57, int8_absmax=57).items()}
    if counts != expect:
        raise AssertionError(f"int8 batched runner over {MANY_VIDEOS} videos: launches {counts}, expected {expect}")
    check_result(res, {k: (MANY_VIDEOS, frames) + v[1:] for k, v in shapes_ok.items()})
    out["batched_many_videos"] = {"videos": MANY_VIDEOS, "frames": frames, "wall_s": wall,
                                  "launches_per_frame": {kn: n // frames for kn, n in counts.items() if n}}
    print("int8 batched runner, dynamic scales: " + json.dumps(out["batched_many_videos"]))
    gs = torch.Generator(device=dev).manual_seed(65)
    many_sites = []
    for kh, C, O, side in ((3, 64, 64, 15), (1, 9 * 64, 64, 8)):
        N = 2 * MANY_VIDEOS
        x = (torch.randn(N, side, side, C, generator=gs, device=dev)
             * (1 + 3 * torch.rand(N, 1, 1, 1, generator=gs, device=dev))).to(bf)
        w_q = torch.randint(-127, 128, (O, kh, kh, C), generator=gs, device=dev)
        qw = int8_conv.pack_weight(w_q, torch.rand(O, generator=gs, device=dev) / 100 + 1e-3)
        bias = (0.1 * torch.randn(O, generator=gs, device=dev)).to(bf)
        for groups in (MANY_VIDEOS, N):
            build.reset_launch_counts()
            got, acc = int8_conv.int8_site_cuda(x, qw, None, groups, bias, 1, kh // 2, return_acc=True)
            torch.cuda.synchronize()
            counts = {kn: n for kn, n in build.launch_counts().items() if n}
            ref, ref_acc = int8_conv.plain_int8_site(x, qw, None, groups, bias, 1, kh // 2, return_acc=True)
            if counts != {"int8_absmax": 1, "int8_conv_fused": 1} or not (
                    torch.equal(acc, ref_acc) and torch.equal(got, ref)):
                raise AssertionError(f"int8 site {kh}x{kh} x {tuple(x.shape)} groups {groups}: launches {counts}, "
                                     "or accumulators or outputs differ from the plain version")
            many_sites.append({"x": list(x.shape), "kernel": kh, "O": O, "groups": groups, "bitwise": True,
                               "launches": counts})
    out["many_videos_sites"] = many_sites
    print("int8 dynamic sites beyond 64 videos: " + json.dumps(many_sites))
    del many, res
    # CUDA launches of one network forward (trunk, fuse, heads) from
    # torch.profiler: bf16, int8 static and dynamic, and int8 static through
    # PR 14's route (PyTorch's quantize ops and its kernel)
    fwd_launches = {}
    dev_inputs16 = [t.to(dev) for t in inputs16]
    for name, quant, route in (("bf16", None, None), ("int8_static", scales, None), ("int8_dynamic", "dynamic", None),
                               ("int8_static_pr14_route", scales, pr14_route)):
        if route is not None:
            int8_conv.int8_site = route
        try:
            with torch.no_grad():
                for profiled in (False, True):  # once to warm up, once under the profiler
                    ctx = (contextlib.nullcontext() if quant is None else
                           layers.quantized("int8", scales=None if quant == "dynamic" else quant))
                    prof_ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled
                                else contextlib.nullcontext())
                    with prof_ctx as prof, ctx:
                        model16(*dev_inputs16)
                        torch.cuda.synchronize()
        finally:
            int8_conv.int8_site = real
        fwd_launches[name] = len(_launch_events(list(prof.events())))
    fwd_launches["pr14_route_minus_int8_static"] = fwd_launches["int8_static_pr14_route"] - fwd_launches["int8_static"]
    out["forward_launches"] = fwd_launches
    print("int8 forward CUDA launches (torch.profiler): " + json.dumps(fwd_launches))
    # one static-scale int8 forward, card against CPU, against the card's int8 error
    with torch.no_grad():
        fwd = make_bf16_apply(model16, quant="int8", quant_scales=scales)
        card_q = fwd(*[x.to(dev) for x in inputs])
        card_f = make_bf16_apply(model16)(*[x.to(dev) for x in inputs])
        t0 = time.perf_counter()
        cpu_q = make_bf16_apply(model16_cpu, quant="int8", quant_scales=scales)(*inputs)
        cpu_s = time.perf_counter() - t0
    cmp = {"cpu_seconds": cpu_s}
    for key in ("hm", "reg", "tracking"):
        gap = (card_q[key] - card_f[key]).abs().max().item()
        err = (card_q[key].cpu() - cpu_q[key]).abs().max().item()
        ulp = 2.0 ** (math.floor(math.log2(cpu_q[key].abs().max().item())) - 7)
        bar = max(INT8_CARD_VS_CPU * gap, BF16_CARD_VS_CPU_ULPS * ulp)
        cmp[key] = {"card_vs_cpu": err, "card_int8_vs_bf16": gap, "bar": bar}
        if not (0 < gap < 0.1 and math.isfinite(err) and err <= bar):
            raise AssertionError(f"int8 forward {key}: card vs CPU {err}, card int8 vs bf16 {gap} (bar {bar})")
    out["forward_card_vs_cpu"] = cmp
    print("int8 forward 480x480 card vs cpu: " + json.dumps(cmp))
    # (c)'s peak memory is read beside phase 13's: drop what (a) and (b) hold
    del model16_cpu, cpu_q, model16, card_q, card_f, video, images, raw, calib

    # ---- (c) the CLIs and the knobs -----------------------------------------
    syn = os.path.join(work, "syn")  # phase 12's set: CLI_VIDEOS x CLI_FRAMES
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = infer.main(["--dataset", syn, "--ckpt", ckpt, "--output_dir", os.path.join(work, "int8_infer"),
                      "--quant", "int8", "--quant_static", "--quant_min_ch", "64", "--device", "cuda"])
    torch.cuda.synchronize()
    counts = build.launch_counts()
    frames = CLI_VIDEOS * CLI_FRAMES
    # calibration (float32 model): the float DCN and the columns it records; serving: int8
    expect = dict(no_launches, biased_attention=9 * (n_calib + frames), deform_conv=16 * n_calib,
                  deform_sample=16 * (n_calib + frames), int8_conv_fused=n_sites[64] * frames)
    km = res["keypoint_metrics"]
    if counts != expect or km["num_gt_inframe"] + km["num_gt_outframe"] != frames * 7:
        raise AssertionError(f"int8 infer cli: launches {counts} (expected {expect}), GT counts {km}")
    out["infer_cli"] = {"seconds": time.perf_counter() - t0, "launches": counts, "fps": res["timing"]["fps"],
                        "stage_s": res["timing"]["stage_s"], "keypoint_metrics": km}
    print("int8 infer cli: " + json.dumps(out["infer_cli"]))

    step_calls = []
    real_calls = _counting_calls(trainer, ("train_step",), step_calls)
    try:
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train_demo.main(["--steps", str(QAT_STEPS), "--batch", str(TRAIN_BATCH), "--eval_videos", "1",
                               "--eval_frames", str(T_FRAMES), "--log_every", "1", "--quant_train",
                               "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in real_calls.items():
            setattr(trainer, name, fn)
    counts = build.launch_counts()
    qat_step = dict(no_launches, biased_attention=9, biased_attention_bwd=3, deform_sample=16, deform_sample_bwd=16)
    evals = dict(no_launches, biased_attention_bf16=9 * T_FRAMES, deform_sample_bf16=16 * T_FRAMES,
                 int8_conv_fused=57 * T_FRAMES, int8_absmax=57 * T_FRAMES)  # dynamic scales
    if (len(step_calls) != QAT_STEPS or any(launched != qat_step for _, launched in step_calls)
            or counts != {kn: evals[kn] + QAT_STEPS * qat_step[kn] for kn in counts}
            or not all(math.isfinite(r["tot"]) for r in res["logged"])):
        raise AssertionError(f"train_demo --quant_train: step launches {step_calls}, launches {counts}")
    km = res["results"]["keypoint_metrics"]
    out["qat"] = {"steps": QAT_STEPS, "batch": TRAIN_BATCH, "wall_s_with_eval": wall, "logged": res["logged"],
                  "launches_per_step": {kn: n for kn, n in qat_step.items() if n}, "eval_fps": res["fps"],
                  "eval_keypoint_metrics": km, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("train_demo --quant_train: " + json.dumps(out["qat"]))
    del res
    # bf16 QAT (--quant_train --bf16): the bf16 columns and their bf16
    # backward, no float32 network kernel; a short int8 eval
    step_calls.clear()
    real_calls = _counting_calls(trainer, ("train_step",), step_calls)
    try:
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train_demo.main(["--steps", str(QAT_STEPS), "--batch", str(TRAIN_BATCH), "--eval_videos", "1",
                               "--eval_frames", str(QAT_BF16_EVAL_FRAMES), "--log_every", "1", "--quant_train",
                               "--bf16", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in real_calls.items():
            setattr(trainer, name, fn)
    counts = build.launch_counts()
    qat16_step = dict(no_launches, biased_attention_bf16=9, biased_attention_bwd_bf16=3, deform_sample_bf16=16,
                      deform_sample_bwd_bf16=16)
    evals = dict(no_launches, biased_attention_bf16=9 * QAT_BF16_EVAL_FRAMES,
                 deform_sample_bf16=16 * QAT_BF16_EVAL_FRAMES, int8_conv_fused=57 * QAT_BF16_EVAL_FRAMES,
                 int8_absmax=57 * QAT_BF16_EVAL_FRAMES)
    if (len(step_calls) != QAT_STEPS or any(launched != qat16_step for _, launched in step_calls)
            or counts != {kn: evals[kn] + QAT_STEPS * qat16_step[kn] for kn in counts}
            or not all(math.isfinite(r["tot"]) for r in res["logged"])):
        raise AssertionError(f"train_demo --quant_train --bf16: step launches {step_calls}, launches {counts}")
    out["qat_bf16"] = {"steps": QAT_STEPS, "batch": TRAIN_BATCH, "wall_s_with_eval": wall, "logged": res["logged"],
                       "launches_per_step": {kn: n for kn, n in qat16_step.items() if n},
                       "eval_frames": QAT_BF16_EVAL_FRAMES, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("train_demo --quant_train --bf16: " + json.dumps(out["qat_bf16"]))
    del res

    step_expect = dict(no_launches, biased_attention=9, biased_attention_bwd=3, deform_conv=16,
                       deform_conv_dgrad=16, deform_conv_wgrad=16)
    # phase 13 (A)'s set and schedule, without validation and mosaics
    base = ["--dataset", os.path.join(work, "train_syn"), "--batch_size", str(TRAIN_CLI_BATCH), "--num_epochs", "1",
            "--lr_step", "2", "--log_every", "1", "--image_log_every", "0", "--device", "cuda"]
    knobs = {}
    for name, flags in (("plain", []), ("dcn_chunks_4", ["--dcn_chunks", "4"]), ("dcn_remat", ["--dcn_remat"])):
        step_calls.clear()
        real_calls = _counting_calls(trainer, ("train_step",), step_calls)
        exp = os.path.join(work, f"knobs_{name}")
        try:
            build.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = train_cli.main(base + ["--output_dir", exp] + flags)
            torch.cuda.synchronize()
        finally:
            for fn_name, fn in real_calls.items():
                setattr(trainer, fn_name, fn)
        # remat runs each DCN forward again in the backward
        expect = dict(step_expect, deform_conv=32) if name == "dcn_remat" else step_expect
        if not step_calls or any(launched != expect for _, launched in step_calls):
            raise AssertionError(f"train cli {name}: step launches {step_calls}, expected {expect}")
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            losses = [r["tot"] for r in map(json.loads, f) if r["prefix"] == "train"]
        knobs[name] = {"seconds": time.perf_counter() - t0, "steps": len(step_calls), "losses": losses,
                       "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del res
    ref = [r["tot"] for r in train_cli_run["synthetic"]["records"] if r["prefix"] == "train"][:len(knobs["plain"]["losses"])]
    knobs["phase13_A_losses"] = ref
    knobs["phase13_A_peak_memory_gb"] = train_cli_run["synthetic"]["peak_memory_gb"]
    for name in ("plain", "dcn_chunks_4", "dcn_remat"):
        got = knobs[name]["losses"]
        # the first step's loss: the same forward; later steps: the DCN data
        # gradient's float atomics add in another order in every run
        if len(got) != len(ref) or abs(got[0] - ref[0]) > 1e-6 * abs(ref[0]) or any(
                abs(a - b) > 1e-4 * abs(b) for a, b in zip(got, ref)):
            raise AssertionError(f"train cli {name}: losses {got}, phase 13 (A) {ref}")
    out["dcn_knobs"] = knobs
    print("train cli knobs: " + json.dumps(knobs))
    out["seconds"] = time.perf_counter() - t_phase
    return out


def int8_kernel_rows(int8):
    """The kernels-line entries of int8 serving's site kernels and of their
    yardstick: launches from the int8 exact runners (static scales at every
    site; dynamic ones at min_ch 64 for the reduction), per-frame sums of
    (a)'s 57 sites."""
    rows = int8["int8_conv_shapes"]
    s = int8["int8_conv_per_frame"]
    runs = int8["runners"]
    static, dynamic = runs["exact_static"]["launches_per_frame"], runs["exact_dynamic_min_ch64"]["launches_per_frame"]
    shapes_note = ("the 57 sites of one flagship frame at 480x480 (trunk at batch 2), bf16, per frame; accumulators "
                   "and outputs bit for bit against the plain version")

    def bound_of(key):
        bounds = [r[key] for r in rows]
        return max(set(bounds), key=bounds.count)

    conv_by = bound_of("bound_by")
    old_by = bound_of("pr14_bound_by")
    rate = {"bytes": "3.35 TB/s HBM", "operations": "1979 TOP/s dense int8"}
    return [
        {"name": "int8_conv_fused", "route": "cuda", "source": "sgtapose_tpu_torch/csrc/int8_conv_fused.cu",
         "replaces": "sgtapose_tpu/models/layers.py:155", "launches": static.get("int8_conv_fused", 0) * T_FRAMES,
         "launches_per_frame": static.get("int8_conv_fused", 0), "max_abs_err": max(r["max_abs_err"] for r in rows),
         "ms": s["ms"], "warm_ms": s["warm_ms"], "dynamic_ms": s["dynamic_ms"],
         "dynamic_note": "int8_absmax + int8_conv_fused, the two launches of a dynamic-scale site",
         "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": conv_by, "bound_rate": rate[conv_by],
         "library_ms": None,
         "library_ms_note": ("no single PyTorch call computes the 3x3 and 7x7 sites; torch._int_mm at the 1x1 sites "
                             "(on s8 operands) sums to library_ms_1x1_sites beside kernel_ms_at_1x1_sites"),
         "library_ms_1x1_sites": s["library_ms"], "kernel_ms_at_1x1_sites": s["kernel_ms_at_1x1_sites"],
         "pair_ms": s["pair_ms"], "pair_note": "im2col + torch._int_mm at the 3x3 and 7x7 sites it takes",
         "cudnn_bf16_ms": s["cudnn_bf16_ms"], "cudnn_note": "F.conv2d in bf16 at the same sites, for the record",
         "yardstick": "PR 14's route: PyTorch's quantize ops + int8_conv", "yardstick_ms": s["route_ms"],
         "pr14_kernel_ms": s["pr14_kernel_ms"], "by_class": s["by_class"],
         "launch_budget": int8["launch_budget"], "forward_launches": int8["forward_launches"],
         "ms_per_launch": {f"{r['x']},O={r['O']},k={r['kernel']},s={r['stride']}": r["ms"] for r in rows},
         "shapes_note": shapes_note + ", static scales as the frame ran (the activation quantized inside)"},
        {"name": "int8_absmax", "route": "cuda", "source": "sgtapose_tpu_torch/csrc/int8_conv_fused.cu",
         "replaces": "sgtapose_tpu/models/layers.py:139", "launches": dynamic.get("int8_absmax", 0) * T_FRAMES,
         "launches_per_frame": dynamic.get("int8_absmax", 0), "max_abs_err": 0.0,
         "ms": s["absmax_ms"], "plain_ms": s["absmax_plain_ms"], "bound_ms": s["absmax_bound_ms"],
         "bound_by": "bytes", "bound_rate": rate["bytes"], "library_ms": s["absmax_library_ms"],
         "library_ms_note": "torch.linalg.vector_norm(x.reshape(N, -1), ord=inf, dim=1)",
         "shapes_note": ("the dynamic scale's per-sample max|x| at the 57 sites of one frame (launches: the exact runner "
                         "with dynamic scales at min_ch 64); slot maxima against the plain version, their max against "
                         "torch.amax, exactly")},
        {"name": "int8_conv", "route": "cuda", "source": "sgtapose_tpu_torch/csrc/int8_conv.cu",
         "replaces": "sgtapose_tpu/models/layers.py:155", "launches": static.get("int8_conv", 0) * T_FRAMES,
         "max_abs_err": 0.0, "ms": s["pr14_kernel_ms"], "plain_ms": s["pr14_plain_ms"], "bound_ms": s["pr14_bound_ms"],
         "bound_by": old_by, "bound_rate": rate[old_by], "library_ms": None,
         "library_ms_note": "torch._int_mm at the 1x1 sites: library_ms_1x1_sites",
         "library_ms_1x1_sites": s["library_ms"], "kernel_ms_at_1x1_sites": s["pr14_kernel_ms_at_1x1_sites"],
         "note": ("on no path since PR 15: PR 14's kernel on s8 operands (PyTorch's quantize ops before it), the "
                  "yardstick of int8_conv_fused, launched only by phase 18 (a)'s comparison"),
         "shapes_note": shapes_note.replace("bf16, ", "s8 operands of the bf16 activations, ")},
    ]


def conv_macs(torch, model, x) -> int:
    """Multiply-adds of the model's convolutions (transposed ones included)
    in one forward of x, counted from their output shapes."""
    macs = []

    def hook(mod, inp, out):
        # a conv: each output takes (in / groups) k k products; a transposed
        # conv: each input scatters into (out / groups) k k outputs
        macs.append(out.numel() * mod.weight[0].numel() if isinstance(mod, torch.nn.Conv2d)
                    else inp[0].numel() * mod.weight[0].numel())

    convs = [m for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    handles = [m.register_forward_hook(hook) for m in convs]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return sum(macs)


def zoo_kernel_rows(zoo, per_step_sum, floor):
    """The kernels-line entries of the no-bias attention kernels and of
    their yardsticks: the forward per frame of the exact runner at batch 1
    (3 tied layers at each of the 6 levels), read from (a)'s runs; the
    backward per step of (c)'s global-variant CLI runs at batch 4 (levels
    2-5). The yardsticks' launches are those of the same runs (0), their
    times from (b)'s comparison; `floor` is the empty launch's cold and warm
    ms, times the launches of a frame or step."""
    kernels = []
    for name, yard, dtype, rows, unit, launches, note in (
        ("biased_attention_nobias", "biased_attention_nobias_rowtile", "float32", zoo["nobias_forward_shapes"],
         "per_frame", zoo["serving"]["dlapa_34/PlanA"]["launches"], "F.scaled_dot_product_attention without a mask"),
        ("biased_attention_nobias_bf16", "biased_attention_nobias_rowtile_bf16", "bfloat16",
         zoo["nobias_forward_shapes"], "per_frame", zoo["serving"]["dlapa_34/PlanA/bf16"]["launches"],
         "F.scaled_dot_product_attention in bf16"),
        ("biased_attention_bwd_nobias", "biased_attention_bwd_nobias_cluster", "float32",
         zoo["nobias_backward_shapes"], "per_step", zoo["train_cli"]["global"]["launches"],
         "backward of F.scaled_dot_product_attention"),
        ("biased_attention_bwd_nobias_bf16", "biased_attention_bwd_nobias_cluster_bf16", "bfloat16",
         zoo["nobias_backward_shapes"], "per_step", zoo["train_cli"]["global_bf16"]["launches"],
         "backward of F.scaled_dot_product_attention in bf16"),
    ):
        rows = [r for r in rows if r["dtype"] == dtype]
        main = [r for r in rows if r[unit]]
        bounds = [r["bound_by"] for r in main]
        bound_by = max(set(bounds), key=bounds.count)
        per_launches = sum(r[unit] for r in main)
        common = {
            "route": "cuda", "replaces": "sgtapose_tpu/ops/attention_kernel.py:" + ("145" if "bwd" in name else "108"),
            "plain_ms": per_step_sum(rows, "plain_ms", unit), "bound_ms": per_step_sum(rows, "bound_ms", unit),
            "bound_by": bound_by, "bound_rate": "3.35 TB/s HBM" if bound_by == "bytes" else "67 TFLOP/s float32 FMA",
            "library_ms": per_step_sum(rows, "library_ms", unit), "library_ms_note": note,
            "launch_floor_ms": {"cold": floor["cold_ms"] * per_launches, "warm": floor["warm_ms"] * per_launches},
            "shapes_note": ("the global variant's (28, d), d = 4 ... 128, batch 1, per frame" if unit == "per_frame"
                            else "the global variant's levels 2-5, (28, d), d = 16 ... 128, batch 4, per step")
            + ("; bf16: per level 1 launch with a bf16 q, 2 with a float32 q" if dtype == "bfloat16" else "")}
        kernels.append({
            "name": name, "source": "sgtapose_tpu_torch/csrc/attention_nobias.cu", "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": per_step_sum(rows, "ms", unit), "warm_ms": per_step_sum(rows, "warm_ms", unit),
            "yardstick": yard, "yardstick_ms": per_step_sum(rows, "yardstick_ms", unit),
            "yardstick_warm_ms": per_step_sum(rows, "yardstick_warm_ms", unit),
            "ms_per_launch": {f"d={r['d']},B={r['B']},q={r['q_dtype']}": r["ms"] for r in rows}, **common})
        kernels.append({
            "name": yard, "source": "sgtapose_tpu_torch/csrc/biased_attention" + ("_bwd" if "bwd" in name else "") + ".cu",
            "launches": launches.get(yard, 0), "max_abs_err": max(r["yardstick_max_abs_err"] for r in rows),
            "ms": per_step_sum(rows, "yardstick_ms", unit), "warm_ms": per_step_sum(rows, "yardstick_warm_ms", unit),
            "note": f"on no path: the yardstick of {name}, launched only by phase 15 (b)'s comparison",
            "ms_per_launch": {f"d={r['d']},B={r['B']},q={r['q_dtype']}": r["yardstick_ms"] for r in rows}, **common})
    return kernels


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
    `video`, from torch.profiler (launch API calls inside each stage's
    range); `profile_s`, the seconds from the start of the profiled call to
    the end of this function."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    frames = video.images.shape[-4]
    saved = detector.stage_timer
    detector.stage_timer = record_function
    t_start = time.perf_counter()
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
    kernel_ms = {name: kernel_device_ms(device, name) / frames for name in DEVICE_NAMES}
    return {"frames": frames, "launches_per_frame_by_stage": per_stage,
            "kernel_ms_per_frame": kernel_ms,
            "launches_per_frame": len(launches) / frames,
            "device_kernel_ms_per_frame": device_us / 1e3 / frames,
            "profiled_wall_ms_per_frame": wall_ms / frames, "profile_s": time.perf_counter() - t_start}


if __name__ == "__main__":
    sys.exit(main())
