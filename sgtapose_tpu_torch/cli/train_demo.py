"""Training demonstration on the card: train the flagship model on
synthetic sequences made on the device, then run the streaming detector on
held-out synthetic videos and report keypoint and ADD metrics. No dataset.

Counterpart of `sgtapose_tpu/cli/train_demo.py`:

  python -m sgtapose_tpu_torch.cli.train_demo --steps 20 --batch 8 --eval_videos 1 --eval_frames 8

  python -m sgtapose_tpu_torch.cli.train_demo --steps 600 --batch 8 --bf16

Training runs float32 (TF32 off for matmuls and convolutions), or with
--bf16 bf16 mixed precision (bf16 parameters, activations and model inputs;
float32 masters, loss, gradients and BatchNorm statistics:
`train/trainer.train_step`), through the hand-written forward and backward
kernels of its dtype; the eval runs the trained weights in bf16, as the JAX
CLI does. Each step draws its raw batch and its augmentation from
generators seeded from (seed + 1, step). --init_backbone X.pth loads a
bare ImageNet DLA-34 state dict into the trunk (with --init_backbone_stem
also into the image stem; `utils/torch_convert.convert_imagenet_dla34`).
--quant_train fine-tunes with quantization-aware training (every step under
`models/layers.quantized("int8_train")`: straight-through fake-quantized
convs) and evaluates the exact (and with --eval_cache the feature-cache)
runner under int8 serving. --dcn_chunks N and --dcn_remat are the DCN
decoder's memory knobs (`models/dla.py:DeformNode`; numbers unchanged).
--fused_attention is accepted and changes nothing: the port always runs its
attention kernel, which computes the JAX default (einsum) form, under
--bf16 too. Checkpoints are `torch.save` files
(`train/trainer.py:save_checkpoint`).
"""

from __future__ import annotations

import argparse
import contextlib
import time

import torch

from sgtapose_tpu_torch import resolve_device
from sgtapose_tpu_torch.config import Config, ModelConfig, TrainConfig
from sgtapose_tpu_torch.data import pipeline, synthetic
from sgtapose_tpu_torch.infer import detector as det_lib
from sgtapose_tpu_torch.models import layers
from sgtapose_tpu_torch.train import trainer
from sgtapose_tpu_torch.utils import torch_convert
from sgtapose_tpu_torch.utils.precision import bf16_inference_model


def parse_args(argv=None):
    p = argparse.ArgumentParser("sgtapose_tpu_torch train_demo")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mixed-precision training (float32 masters, loss and gradients)")
    p.add_argument("--input_res", type=int, default=480)
    p.add_argument("--dla_node", default="dcn")
    p.add_argument("--fused_attention", action="store_true",
                   help="accepted; the port always runs its attention kernel, which computes the "
                        "JAX default (einsum) form, also under --bf16")
    p.add_argument("--dcn_chunks", type=int, default=1,
                   help="form the DCN's sampled columns in N row slabs (memory knob; numbers unchanged)")
    p.add_argument("--dcn_remat", action="store_true",
                   help="recompute the DCN nodes in the backward (memory knob; numbers unchanged)")
    p.add_argument("--eval_frames", type=int, default=16)
    p.add_argument("--eval_videos", type=int, default=4)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--seed", type=int, default=317)
    p.add_argument("--schedule_iters", type=int, default=None,
                   help="learning-rate schedule horizon when it should differ from --steps")
    p.add_argument("--ckpt_out", default=None, help="save the trained state (torch.save) here")
    p.add_argument("--ckpt_every", type=int, default=0,
                   help="with --ckpt_out, also save every N steps to <ckpt_out>_stepN")
    p.add_argument("--init_ckpt", default=None,
                   help="warm-start the model (parameters and BN statistics) from a checkpoint; "
                        "fresh optimizer and schedule")
    p.add_argument("--resume_step", type=int, default=0,
                   help="with --init_ckpt: continue the parent run's schedule and batch stream from this step")
    p.add_argument("--init_backbone", default=None,
                   help="ImageNet DLA-34 .pth (a bare state_dict) to initialise the trunk from")
    p.add_argument("--init_backbone_stem", action="store_true",
                   help="also copy the ImageNet base_layer into the image stem")
    p.add_argument("--reg_weight", type=float, default=0.01)
    p.add_argument("--quant_train", action="store_true",
                   help="quantization-aware training (fake-quantized convs), then an int8 serving eval")
    p.add_argument("--cache_prior", action="store_true",
                   help="condition the pre pass on a PnP-reprojection prior (the feature-cache "
                        "runner's input distribution)")
    p.add_argument("--eval_cache", action="store_true",
                   help="also evaluate the feature-cache runner")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def step_generator(seed: int, step: int, stream: int) -> torch.Generator:
    """The CPU generator of one step's raw batch (stream 0) or augmentation
    draws (stream 1)."""
    return torch.Generator().manual_seed(((seed + 1) * 1_000_003 + step) * 2 + stream)


def make_config(args) -> Config:
    return Config(
        model=ModelConfig(input_res=(args.input_res, args.input_res), dla_node=args.dla_node,
                          dcn_chunks=args.dcn_chunks, dcn_remat=args.dcn_remat),
        train=TrainConfig(lr=args.lr, warmup_iters=min(100, (args.schedule_iters or args.steps) // 4)),
    )


def train_loop(state, cfg: Config, args, device, stage_timer=None):
    """args.steps steps on fresh batches; returns the loss terms of the
    logged steps. Each step's batch draws from the stream of the run's
    step, args.resume_step + it, so a warm start at --resume_step S goes on
    with the batches a run from step 0 would draw from step S (the JAX CLI
    draws from `it`, replaying the parent run's first batches).
    stage_timer: optional fn(name) -> context manager around "batch" (raw
    batch and augmentation, the PnP priors included) and the train step's
    stages."""
    timed = stage_timer or (lambda name: contextlib.nullcontext())
    batch_fn = pipeline.make_batch_fn(cfg, synthetic.camera_K(), cache_prior=args.cache_prior)
    # --quant_train: every step runs its forward and backward fake-quantized
    quant = (lambda: layers.quantized("int8_train")) if args.quant_train else contextlib.nullcontext
    logged = []
    t0 = time.time()
    for it in range(args.steps):
        with timed("batch"):
            step = args.resume_step + it
            raw = synthetic.make_raw_batch(step_generator(args.seed, step, 0), args.batch, device=device)
            batch = batch_fn(step_generator(args.seed, step, 1), raw)
        with quant():
            stats = trainer.train_step(state, batch, reg_weight=args.reg_weight, bf16=args.bf16,
                                       stage_timer=stage_timer)
        if it % args.log_every == 0 or it == args.steps - 1:
            s = {k: v.item() for k, v in stats.items()}
            logged.append(dict(step=it, **s))
            print(f"step {it}: " + " ".join(f"{k}={v:.5f}" for k, v in s.items())
                  + f"  ({time.time() - t0:.0f}s)", flush=True)
        if args.ckpt_out and args.ckpt_every and it > 0 and it % args.ckpt_every == 0:
            trainer.save_checkpoint(f"{args.ckpt_out}_step{it}", state)
            print(f"saved checkpoint -> {args.ckpt_out}_step{it}", flush=True)
    return logged


def evaluate(model, cfg: Config, args, device, cached: bool = False):
    """The bf16 copy of the trained weights through the exact (or, with
    cached, the feature-cache) runner on held-out synthetic videos, under
    int8 serving (dynamic scales) with --quant_train: (results of
    `analyze_sequence_results`, fps)."""
    from sgtapose_tpu_torch.eval.synthetic_eval import evaluate_runner, make_eval_videos

    model16 = bf16_inference_model(model.eval())
    raw_hw = (synthetic.RAW_H, synthetic.RAW_W)
    make = det_lib.make_cached_video_detector if cached else det_lib.make_video_detector
    run = make(model16, cfg, synthetic.camera_K(device), raw_hw, device=device,
               quant="int8" if args.quant_train else None)
    vids = make_eval_videos(args.eval_videos, args.eval_frames, args.seed, device=device)
    return evaluate_runner(run, cfg, vids, device=device)


def main(argv=None, stage_timer=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    # float32 training (and bf16 training's float32 parts) means float32:
    # cuDNN convolutions default to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = make_config(args)
    state = trainer.create_train_state(cfg, args.seed, max_iters=args.schedule_iters or args.steps,
                                       device=dev)
    if args.init_ckpt:
        payload = torch.load(args.init_ckpt, map_location=dev, weights_only=True)
        state.model.load_state_dict(payload["model"])
        print(f"warm-started the model from {args.init_ckpt}")
        if args.resume_step:
            trainer.resume_schedule_state(state, args.resume_step)
            print(f"schedule resumed at step {args.resume_step}", flush=True)
    if args.init_backbone:
        report = torch_convert.convert_imagenet_dla34(torch_convert.load_torch_checkpoint(args.init_backbone),
                                                      state.model, map_stem=args.init_backbone_stem)
        print(f"ImageNet trunk init from {args.init_backbone}: {report['n_converted']} tensors")

    print(f"training {args.steps} steps, batch {args.batch}, {'bf16' if args.bf16 else 'float32'}"
          f"{', int8 QAT' if args.quant_train else ''}, on {dev}")
    t0 = time.time()
    logged = train_loop(state, cfg, args, dev, stage_timer=stage_timer)
    print(f"training done in {time.time() - t0:.0f}s")
    if args.ckpt_out:
        trainer.save_checkpoint(args.ckpt_out, state)
        print(f"saved checkpoint -> {args.ckpt_out}")

    if args.eval_videos <= 0:
        print("eval skipped (--eval_videos 0)")
        return {"state": state, "logged": logged, "results": None}

    results, fps = evaluate(state.model, cfg, args, dev)
    n_frames = args.eval_videos * args.eval_frames
    print(f"eval inference: {n_frames} frames ({fps:.1f} fps)")
    km, pm = results["keypoint_metrics"], results["pnp_metrics"]
    print(f"found in-frame: {km['num_found_gt_inframe']}/{km['num_gt_inframe']}")
    print(f"PCK AUC@12px: {km['l2_error_auc']}")
    print(f"L2 mean px: {km['l2_error_mean_px']}")
    print(f"ADD AUC@0.06m: {pm['add_auc']}")
    print(f"ADD mean m: {pm['add_mean']}")
    if args.eval_cache:
        resc, fpsc = evaluate(state.model, cfg, args, dev, cached=True)
        kmc, pmc = resc["keypoint_metrics"], resc["pnp_metrics"]
        print(f"[cache path] eval inference: {n_frames} frames ({fpsc:.1f} fps)")
        print(f"[cache path] PCK AUC@12px: {kmc['l2_error_auc']}")
        print(f"[cache path] ADD AUC@0.06m: {pmc['add_auc']}")
        results["cache_path"] = resc
    return {"state": state, "logged": logged, "results": results, "fps": fps}


if __name__ == "__main__":
    main()
