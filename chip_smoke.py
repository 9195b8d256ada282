#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`sgtapose_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit (nvidia-smi) and the float32 settings
     (TF32 off for cuDNN convolutions and matmuls: this slice runs float32);
  2. build every CUDA kernel from sgtapose_tpu_torch/csrc (one nvcc per
     source, all started together, sm_90a);
  3. the biased-attention kernel against its plain PyTorch version at the
     flagship shapes plus a ragged n, with kernel (cold, and warm: 3
     back-to-back launches without an L2 flush, as the 3 tied layers run;
     clean: the flush read back, so no dirty lines are left to write back) /
     plain / library (F.scaled_dot_product_attention, a yardstick the port
     never calls) times;
  4. the DCN sampling kernel (off the detector path since the fused kernel;
     kept for the training slice) against its plain version at every decoder
     shape;
  5. the fused DCN kernel against its plain version at the 4 decoder input
     shapes with each of their output widths, and one ragged shape, with
     kernel / unfused pair (the sampler, then torch.addmm with TF32 off) /
     plain times;
  6. one full-width SGTAPose forward (480x480, DCN decoder, seeded weights
     with the zero-initialised parameters perturbed) on the card and on the
     CPU (plain versions), heads compared;
  7. the flagship streaming detector on a 16-frame synthetic 640x360 video,
     teacher-forced then closed-loop: kernel launch counts per frame from the
     wrappers' counters (reset just before each run), finite outputs of the
     expected shapes, per-stage times (CUDA events around each stage, so a
     stage's time includes the host's launch gaps inside it), fps, and from
     torch.profiler over 2 frames the CUDA launches per stage, the device
     kernel time per frame (busy share against the unprofiled frame time)
     and the device time per frame of each hand-written kernel;
  8. a `{"kernels": [...]}` line, the card line, and last the device line
     `{"ok": true, "device": {...}}`.

Kernel times are CUDA-event times of single launches with the 50 MB L2
flushed before each (the detector reads each weight once per frame); the
per-kernel entries of the kernels line are per-frame sums over the shapes one
frame launches. Bounds (H100 SXM data sheet): the larger of bytes over
3.35 TB/s and operations over the rate of the instructions used, 67 TFLOP/s
for float32 FMAs, 165 TFLOP/s (495 / 3) for 3xTF32 on the tensor cores.
Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32X3_OPS_PER_S = 495e12 / 3
T_FRAMES = 16
ATTN_TOL = 2e-4  # the JAX package's Pallas-vs-XLA bar
DCN_TOL = 1e-5  # same float32 arithmetic; only FMA contraction may differ
# fused DCN vs plain, relative to max(1, max|ref|): a 9C-long sum in another
# order, plus 3xTF32's dropped lo*lo term (~2^-22 of each product)
DCN_CONV_REL_TOL = 1e-4
FORWARD_REL_TOL = 1e-4  # card vs CPU heads, relative to max(1, max|CPU head|)
# (H, C_in, C_out, nodes per frame) of the 16 decoder DCN nodes at 480x480
DCN_NODES = [(15, 512, 256, 1), (30, 256, 256, 1), (30, 256, 128, 2), (30, 256, 64, 1),
             (60, 128, 128, 2), (60, 128, 64, 4), (120, 64, 64, 5)]
# device function of each kernel, as the profiler names it
DEVICE_NAMES = {"biased_attention": "biased_attention_kernel", "deform_conv": "deform_conv_kernel",
                "deform_sample": "deform_sample_kernel"}


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
    from sgtapose_tpu_torch.infer import detector as det_lib
    from sgtapose_tpu_torch.models import deform_conv
    from sgtapose_tpu_torch.models.sgta import create_model
    from sgtapose_tpu_torch.ops import attention_kernel, build

    dev = torch.device("cuda", 0)
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

    # ---- 3. attention kernel vs plain -----------------------------------
    attn_rows = []
    shapes = []
    for i in range(3):
        kernel = cfg.model.kernel_list[i]
        n = cfg.model.num_classes * cfg.model.k_list[i] * (1 + 2 * (kernel // 2)) ** 2
        shapes.append((n, 4 * 2 ** i, n_layers))  # (n, d, launches per frame)
    shapes.append((100, 8, 0))  # ragged n, not on the main path
    for n, d, per_frame in shapes:
        h = cfg.model.n_heads
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

    # ---- 5. fused DCN kernel vs plain -------------------------------------
    conv_rows = []
    for H, C, O, per_frame in DCN_NODES + [(9, 6, 5, 0)]:  # + a ragged shape, off the path
        W = H + 2 if per_frame == 0 else H
        x = torch.randn(1, H, W, C, generator=gen, device=dev)
        om = torch.cat([torch.rand(1, H, W, 18, generator=gen, device=dev) * 6 - 3,
                        2 * torch.randn(1, H, W, 9, generator=gen, device=dev)], dim=-1)
        weight = torch.randn(O, 9 * C, generator=gen, device=dev) / math.sqrt(9 * C)
        bias_o = torch.randn(O, generator=gen, device=dev)
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

    # ---- 6. full-width forward: card vs CPU -------------------------------
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
    per_frame_launches = {"biased_attention": 3 * n_layers, "deform_conv": 16, "deform_sample": 0}
    if fwd_counts != per_frame_launches:
        raise AssertionError(f"forward launch counts {fwd_counts}, expected {per_frame_launches}")
    print("forward 480x480 dcn card vs cpu: " + json.dumps(fwd))
    report["forward"] = fwd
    del model_cpu

    # ---- 7. the streaming detector on the card ----------------------------
    projs, raw, _ = synthetic.make_sequence(torch.Generator().manual_seed(3), T_FRAMES, device=dev)
    images, _, _ = det_lib.preprocess_frames(raw, cfg)
    x3d = synthetic.skeleton(dev)[None].expand(T_FRAMES, -1, -1).contiguous()
    K = synthetic.camera_K(dev)
    raw_hw = (synthetic.RAW_H, synthetic.RAW_W)
    videos = {
        "teacher_forced": det_lib.VideoFrames(images=images, x3d=x3d, teacher_kps=projs),
        "closed_loop": det_lib.VideoFrames(images=images, x3d=x3d, init_kps=projs[0]),
    }
    timer = StageTimer()
    detector = det_lib.make_video_detector(model, cfg, K, raw_hw, device=dev, debug_outputs=True,
                                           stage_timer=timer)
    detector(det_lib.VideoFrames(images=images[:2], x3d=x3d[:2], teacher_kps=projs[:2]))  # warm-up
    torch.cuda.synchronize()
    runs = {}
    main_counts = None
    for name, video in videos.items():
        timer.reset()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = detector(video)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = build.launch_counts()
        expect = {name: n * T_FRAMES for name, n in per_frame_launches.items()}
        if counts != expect:
            raise AssertionError(f"{name}: launch counts {counts}, expected {expect}")
        if main_counts is None:
            main_counts = counts
        check_result(res, cfg, T_FRAMES)
        kps = res.detected_kps
        n_valid = int((kps > det_lib.KP_SENTINEL).all(-1).sum())
        runs[name] = {"frames": T_FRAMES, "wall_s": wall, "fps": T_FRAMES / wall,
                      "stage_ms_per_frame": timer.per_frame_ms(T_FRAMES), "launches": counts,
                      "valid_detections": n_valid}
        print(f"detector {name}: " + json.dumps(runs[name]))
    prof = profile_frame(detector, videos["teacher_forced"], torch)
    # busy share against the unprofiled frame time (the profiler slows the host)
    prof["device_busy_share"] = prof["device_kernel_ms_per_frame"] / (
        1e3 * runs["teacher_forced"]["wall_s"] / T_FRAMES)
    runs["profiled_frame"] = prof
    print("detector profiled frames: " + json.dumps(runs["profiled_frame"]))
    report["detector"] = runs

    # ---- 8. kernels line ---------------------------------------------------
    def per_frame(rows, key):
        """Sum over the shapes one frame runs (for the sampler: the shapes
        of the 16 DCN nodes it served before the fused kernel)."""
        vals = [r[key] for r in rows if r["per_frame"]]
        if any(v is None for v in vals):
            return None
        return sum(r[key] * r["per_frame"] for r in rows if r["per_frame"])

    rates = {"biased_attention": "67 TFLOP/s float32 FMA", "deform_sample": "67 TFLOP/s float32 FMA",
             "deform_conv": "165 TFLOP/s 3xTF32 (495 / 3)"}
    kernels = []
    for name, rows, source, replaces in (
        ("biased_attention", attn_rows, "sgtapose_tpu_torch/csrc/biased_attention.cu",
         "sgtapose_tpu/ops/attention_kernel.py:108"),
        ("deform_conv", conv_rows, "sgtapose_tpu_torch/csrc/deform_conv.cu",
         "sgtapose_tpu/models/deform_conv.py:329"),
        ("deform_sample", dcn_rows, "sgtapose_tpu_torch/csrc/deform_sample.cu",
         "sgtapose_tpu/models/deform_conv.py:104"),
    ):
        bounds = [r["bound_by"] for r in rows if r["per_frame"]]
        bound_by = max(set(bounds), key=bounds.count)
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_counts[name],
            "launches_per_frame": main_counts[name] // T_FRAMES,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": per_frame(rows, "ms"), "plain_ms": per_frame(rows, "plain_ms"),
            "bound_ms": per_frame(rows, "bound_ms"), "bound_by": bound_by,
            "bound_rate": "3.35 TB/s HBM" if bound_by == "bytes" else rates[name],
            "library_ms": per_frame(rows, "library_ms"),
            "profiled_ms_per_frame": prof["kernel_ms_per_frame"][name],
        }
        if name == "biased_attention":
            entry["warm_ms"] = per_frame(rows, "warm_ms")
            entry["clean_ms"] = per_frame(rows, "clean_ms")
        if name == "deform_conv":
            entry["pair_ms"] = per_frame(rows, "pair_ms")
        kernels.append(entry)
    report["kernels"] = kernels
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
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


def check_result(res, cfg, T) -> None:
    import torch

    K = cfg.model.num_classes
    Ho, Wo = cfg.model.output_res
    H, W = cfg.model.input_res
    expect = {"detected_kps": (T, K, 2), "scores": (T, K), "tracking": (T, K, 2),
              "debug_hm": (T, Ho, Wo, K), "debug_pre_hm": (T, H, W, 1)}
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


def profile_frame(detector, video, torch):
    """CUDA launches per stage and device busy time over 2 teacher-forced
    frames, from torch.profiler (launch API calls inside each stage's range)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    frames = 2
    sub = video._replace(images=video.images[:frames], x3d=video.x3d[:frames],
                         teacher_kps=video.teacher_kps[:frames])
    saved = detector.stage_timer
    detector.stage_timer = record_function
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            detector(sub)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        detector.stage_timer = saved
    events = list(prof.events())
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    stages = [e for e in cpu if e.name in ("pnp", "render", "trunk", "fuse", "decode")]
    launches = [e for e in cpu if "LaunchKernel" in e.name or e.name == "cuLaunchKernel"]
    per_stage = {}
    for st in stages:
        lo, hi = st.time_range.start, st.time_range.end
        n = sum(1 for e in launches if lo <= e.time_range.start <= hi)
        per_stage[st.name] = per_stage.get(st.name, 0) + n / frames
    # device kernels run on one stream, so their durations do not overlap
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in
              ("pnp", "render", "trunk", "fuse", "decode")]
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
