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
     the flagship shapes plus a ragged n, with kernel (cold, and warm: 3
     back-to-back launches without an L2 flush, as the 3 tied layers run;
     clean: the flush read back, so no dirty lines are left to write back) /
     plain / library (F.scaled_dot_product_attention, a yardstick the port
     never calls) times;
  4. the DCN sampling kernel (off the detector path since the fused kernel;
     kept for the training slice) against its plain version at every decoder
     shape;
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
 11. a `{"kernels": [...]}` line, the card line, and last the device line
     `{"ok": true, "device": {...}}`.

Kernel times are CUDA-event times of single launches with the 50 MB L2
flushed before each (the detector reads each weight once per frame); the
per-kernel entries of the kernels line are per-frame sums over the shapes one
frame launches. Bounds (H100 SXM data sheet): the larger of bytes over
3.35 TB/s and operations over the rate of the instructions used, 67 TFLOP/s
for float32 FMAs, 165 TFLOP/s (495 / 3) for 3xTF32 and 989 TFLOP/s for dense
bf16 on the tensor cores. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32X3_OPS_PER_S = 495e12 / 3
BF16_OPS_PER_S = 989e12
T_FRAMES = 16
N_VIDEOS = 8  # the batched runner's video batch
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
# (H, C_in, C_out, nodes per frame) of the 16 decoder DCN nodes at 480x480
DCN_NODES = [(15, 512, 256, 1), (30, 256, 256, 1), (30, 256, 128, 2), (30, 256, 64, 1),
             (60, 128, 128, 2), (60, 128, 64, 4), (120, 64, 64, 5)]
RAGGED_DCN = (9, 6, 5, 0)  # 9x11 map, C % 8 != 0, O below one tile; off the path
# device function of each kernel, as the profiler names it
DEVICE_NAMES = {"biased_attention": "biased_attention_kernel", "deform_conv": "deform_conv_kernel",
                "deform_sample": "deform_sample_kernel",
                "biased_attention_bf16": "biased_attention_bf16_kernel",
                "deform_conv_bf16": "deform_conv_bf16_kernel"}
STAGE_NAMES = ("pnp", "render", "trunk", "fuse", "decode")


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

    # ---- 4. DCN sampling kernel vs plain ----------------------------------
    # (H, C_in) of the 16 decoder DCN nodes at 480x480 and how many per frame
    # (the sampler alone is no longer launched on the detector path)
    dcn_shapes = {}
    for H, C, _, nodes in DCN_NODES:
        dcn_shapes[(H, C)] = dcn_shapes.get((H, C), 0) + nodes
    dcn_rows = []
    for (H, C), per_frame in dcn_shapes.items():
        feat = torch.randn(1, H, H, C, generator=gen, device=dev)
        offsets = torch.rand(1, H, H, 18, generator=gen, device=dev) * 6 - 3
        masks = torch.rand(1, H, H, 9, generator=gen, device=dev)
        out = deform_conv.deform_sample_cuda(feat, offsets, masks)
        torch.cuda.synchronize()
        ref = deform_conv.plain_deform_sample(feat, offsets, masks)
        err = (out - ref).abs().max().item()
        if not math.isfinite(err) or err > DCN_TOL:
            raise AssertionError(f"DCN kernel H={H} C={C}: max abs err {err} > {DCN_TOL}")
        n_bytes = 4 * H * H * (C + 18 + 9 + 9 * C)
        b_ms, b_by = bound_ms(n_bytes, H * H * 9 * C * 9)
        row = dict(H=H, W=H, C=C, per_frame=per_frame, max_abs_err=err,
                   ms=cold_ms(lambda: deform_conv.deform_sample_cuda(feat, offsets, masks)),
                   plain_ms=cold_ms(lambda: deform_conv.plain_deform_sample(feat, offsets, masks)),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
        dcn_rows.append(row)
        print("deform_sample " + json.dumps(row))
    report["attention_shapes"] = attn_rows
    report["deform_sample_shapes"] = dcn_rows

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
    per_frame_launches = {"biased_attention": 3 * n_layers, "deform_conv": 16, "deform_sample": 0,
                          "biased_attention_bf16": 0, "deform_conv_bf16": 0}
    per_frame_launches16 = {"biased_attention": 0, "deform_conv": 0, "deform_sample": 0,
                            "biased_attention_bf16": 3 * n_layers, "deform_conv_bf16": 16}
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

    # ---- 11. kernels line --------------------------------------------------
    def per_frame(rows, key):
        """Sum over the shapes one frame runs (for the sampler: the shapes
        of the 16 DCN nodes it served before the fused kernel)."""
        vals = [r[key] for r in rows if r["per_frame"]]
        if any(v is None for v in vals):
            return None
        return sum(r[key] * r["per_frame"] for r in rows if r["per_frame"])

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
        ("deform_sample", dcn_rows, "sgtapose_tpu_torch/csrc/deform_sample.cu",
         "sgtapose_tpu/models/deform_conv.py:104", main_counts, runs["teacher_forced"]),
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
        if name.startswith("deform_conv") or name == "deform_sample":
            entry["library_ms_note"] = "no single PyTorch call computes this function"
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
