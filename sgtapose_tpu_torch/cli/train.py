"""Training on datasets read from disk.

Counterpart of `sgtapose_tpu/cli/train.py`:

  python -m sgtapose_tpu_torch.cli.train --dataset DIR [--add_dataset DIR] \\
      [--val_dataset DIR] --output_dir OUT [--num_epochs 20] [--depth] ...

Host threads only read files (`data/loader.py:SeqBatchLoader`); each batch
goes to the card on the main thread, where `data/pipeline.py` augments it
and renders its priors; `train/trainer.train_step` runs the float32 step, or
with --bf16 the bf16 mixed-precision step, through the hand-written forward
and backward kernels (--device, default cuda, which raises without a card).
Validation and the training mosaics run the float32 parameters under --bf16
too, as the JAX CLI's `eval_predict_step` and `predict_step` do. Per epoch: a checkpoint
output_dir/ckpt/epoch_{e}.pt (`trainer.save_checkpoint`, what `cli/infer.py
--ckpt` reads) and, with --val_dataset, the validation loss and keypoint
metrics (`trainer.validate`) in metrics.jsonl; every --image_log_every
iterations a training mosaic under viz/.

--resume restores the step, the schedule count and Adam from a checkpoint of
this CLI; the epoch loop then runs epochs 1 to --num_epochs, as the JAX CLI
does (`sgtapose_tpu/cli/train.py:267-269`, `:307`), each epoch's checkpoint
written under its loop number (a resumed run writes epoch_1.pt again, ...);
with --lr_step the schedule, a function of the step, replays the decay.

Randomness: the weights come from --seed, dropout from (seed + 1, step),
each step's augmentation draws from (seed + 2, step); validation batches are
augmented with one fixed seed per batch (the JAX CLI's PRNGKey(0)).

Several processes (--coordinator host:port --num_processes N --process_id
I, a tcp:// rendezvous, or --multihost under a launcher's env://) are
data-parallel ranks (`parallel/mesh.py`): --batch_size per rank, each rank on
a disjoint equal slice of the pairs, one step over the global batch; rank 0
writes logs and checkpoints; validation and image logs are skipped, as in
the JAX CLI.

--arch and --phase pick the model and its inputs as the JAX CLI's do
(`train/phases.py`; an ablation_* phase also sets the ablation's wiring):
--phase PlanA_three trains the three-frame model on three-frame windows
(`data/discovery.find_ndds_seq_triples_in_dir`, `data/loader.TripleBatchLoader`,
`data/pipeline.make_batch_fn_three`) and refuses --depth, whose sets are
two-frame. --phase Dream trains a DREAM baseline (--arch dreamhourglass) on
the current image with the heatmap loss alone, no hand-written kernel on its
path (with --bf16 through the same bf16 parameter view, cuDNN's bf16
convolutions); ResnetSimple's map is at input/2, the targets at input/4, so
--arch resnetsimple raises ValueError at its first loss, where the JAX step
fails on the shapes. --init_backbone X.pth loads a bare ImageNet DLA-34
state dict into the trunk (`utils/torch_convert.convert_imagenet_dla34`;
with --init_backbone_stem also into the image stem) before --resume.

--bf16 --depth trains a 42-keypoint model in bf16: on the card its level 0
attention runs the bf16 key-tiled forward, levels 1 and 2 the bf16
shared-memory one, and level 2's backward the bf16 row-split path.

--dcn_chunks N and --dcn_remat are the DCN decoder's memory knobs
(`models/dla.py:DeformNode`): N row slabs where the port forms the sampled
columns with plain ops (on the card the fused kernels hold no such temps),
and the DCN recomputed in the backward; neither changes a number. An orbax
checkpoint directory as --resume raises with the two commands that convert
it (`cli/convert.py`).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from sgtapose_tpu_torch import resolve_device
from sgtapose_tpu_torch.cli.infer import FLAGSHIP_ARCH, orbax_route
from sgtapose_tpu_torch.config import (IMAGE_MEAN, IMAGE_STD, KEYPOINT_NAMES, SYNTHETIC_CAMERA_K, Config,
                                       MeshConfig, ModelConfig, TrainConfig)
from sgtapose_tpu_torch.data.discovery import (find_depth_seq_data_in_dir, find_ndds_seq_data_in_dir,
                                               find_ndds_seq_triples_in_dir)
from sgtapose_tpu_torch.data.loader import SeqBatchLoader, TripleBatchLoader
from sgtapose_tpu_torch.data.pipeline import make_batch_fn, make_batch_fn_three
from sgtapose_tpu_torch.parallel import mesh
from sgtapose_tpu_torch.train import trainer
from sgtapose_tpu_torch.train.schedule import step_decay_schedule
from sgtapose_tpu_torch.utils import torch_convert
from sgtapose_tpu_torch.utils.logging import MetricsLogger
from sgtapose_tpu_torch.utils.visualize import training_debug_mosaic


def parse_args(argv=None):
    p = argparse.ArgumentParser("sgtapose_tpu_torch train")
    p.add_argument("--dataset", required=True, help="training data dir (NDDS seq format)")
    p.add_argument("--add_dataset", default=None, help="optional second dir to concat")
    p.add_argument("--val_dataset", default=None)
    p.add_argument("--output_dir", default="exp/default")
    p.add_argument("--robot", default="panda_synthetic")
    p.add_argument("--object_name", default=None,
                   help="'ROBOT NAME' tag in the meta jsons (default: --robot)")
    p.add_argument("--arch", default=FLAGSHIP_ARCH,
                   help="dlapawdl3new_34 (the flagship), dlapa_34, dlapawd_34, dlapawd3_34, dlapawd3shared_34, "
                        "dlapacat_34, dlaabla_34, dlaseg_34, dreamhourglass (--phase Dream)")
    p.add_argument("--num_epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=4, help="per rank")
    p.add_argument("--lr", type=float, default=1.25e-4)
    p.add_argument("--seed", type=int, default=317)
    p.add_argument("--hm_disturb", type=float, default=0.75)
    p.add_argument("--lost_disturb", type=float, default=0.2)
    p.add_argument("--fp_disturb", type=float, default=0.1)
    p.add_argument("--fp_disturb_active", action="store_true",
                   help="actually inject false-positive prior blobs (inert by default, as the "
                        "reference's live renderer)")
    p.add_argument("--input_res", type=int, default=480)
    p.add_argument("--dla_node", default="dcn", choices=["dcn", "conv"])
    p.add_argument("--dcn_chunks", type=int, default=1,
                   help="form the DCN's sampled columns in N row slabs (memory knob; numbers unchanged)")
    p.add_argument("--dcn_remat", action="store_true",
                   help="recompute the DCN nodes in the backward (memory knob; numbers unchanged)")
    p.add_argument("--kernel_list", default="12,6,3,1,1,1",
                   help="per-level attention window sizes")
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel ranks (one card each); must equal the number of processes")
    p.add_argument("--coordinator", default=None,
                   help="several processes: rendezvous address host:port (with --num_processes, "
                        "--process_id)")
    p.add_argument("--multihost", action="store_true",
                   help="join a run a launcher set up (env:// rendezvous)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--num_workers", type=int, default=4, help="loader IO threads")
    p.add_argument("--depth", action="store_true",
                   help="42-joint depth-variant training (flat png+json dir)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mixed-precision training (float32 masters, loss and gradients; "
                        "validation in float32)")
    p.add_argument("--phase", default="PlanA_win",
                   help="training phase (train/phases.py): PlanA_win | PlanA_three | PlanA | PlanACAT | "
                        "ablation_* | CenterTrack | CenterNet | Dream")
    p.add_argument("--resume", default=None,
                   help="checkpoint file of this CLI (restores the step, the schedule count and Adam)")
    p.add_argument("--init_backbone", default=None,
                   help="ImageNet DLA-34 .pth (a bare state_dict) to initialise the trunk from")
    p.add_argument("--init_backbone_stem", action="store_true",
                   help="also copy the ImageNet base_layer into the image stem")
    p.add_argument("--lr_step", default=None,
                   help="comma-separated epoch milestones for 0.1x step decay instead of "
                        "warmup+poly (a resumed run replays the decay from its step)")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--image_log_every", type=int, default=250,
                   help="training mosaic (input | GT hm | pred hm) interval; 0 disables")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def build_config(args) -> Config:
    return Config(
        model=ModelConfig(arch=args.arch, input_res=(args.input_res, args.input_res),
                          num_classes=42 if args.depth else len(KEYPOINT_NAMES[args.robot]),
                          dla_node=args.dla_node, dcn_chunks=args.dcn_chunks, dcn_remat=args.dcn_remat,
                          kernel_list=tuple(int(x) for x in args.kernel_list.split(","))),
        train=TrainConfig(lr=args.lr, seed=args.seed, hm_disturb=args.hm_disturb,
                          lost_disturb=args.lost_disturb, fp_disturb=args.fp_disturb,
                          fp_disturb_active=args.fp_disturb_active),
        mesh=MeshConfig(num_devices=args.num_devices),
        robot=args.robot,
    )


def batch_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of the augmentation draws of step `step`: the
    stream (seed + 2, step)."""
    return torch.Generator().manual_seed((seed + 2) * 1_000_003 + step)


def to_device(raw, device: torch.device):
    """A loader batch (a numpy RawSample or RawSampleThree) as tensors on
    `device`: through pinned memory, copied without blocking, onto a card."""
    if device.type != "cuda":
        return type(raw)(*(torch.from_numpy(a) for a in raw))
    return type(raw)(*(torch.from_numpy(a).pin_memory().to(device, non_blocking=True) for a in raw))


def _timed_batches(batches, timed):
    """The items of `batches`, the wait for each inside timed("loader")."""
    it = iter(batches)
    while True:
        with timed("loader"):
            raw = next(it, None)
        if raw is None:
            return
        yield raw


def main(argv=None, stage_timer=None):
    """Train; returns {"state", "iters_per_epoch"}. stage_timer: optional
    fn(name) -> context manager around "loader" (the wait for the next
    loader batch), "batch" (to the card, augmentation, priors), the train
    step's "forward", "backward" and "optimizer", and "validation"."""
    args = parse_args(argv)
    if args.coordinator and (args.num_processes is None or args.process_id is None):
        raise SystemExit("--coordinator requires both --num_processes and --process_id")
    dev = resolve_device(args.device)
    if args.multihost or args.coordinator:
        mesh.initialize_multihost(args.coordinator, args.num_processes, args.process_id, dev)
        dev = mesh.local_device(dev)
    world, rank = mesh.world_size(), mesh.rank()
    cfg = build_config(args)
    try:
        mesh.check_num_devices(cfg.mesh.num_devices)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    # float32 training (and bf16 training's float32 parts) means float32:
    # cuDNN convolutions default to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timed = stage_timer or (lambda name: contextlib.nullcontext())
    rank0 = rank == 0
    logger = MetricsLogger(args.output_dir if rank0 else None, resume=bool(args.resume))
    print(f"ranks={world} batch per rank={args.batch_size} global batch={args.batch_size * world} on {dev}")

    three = args.phase == "PlanA_three"
    if args.depth and three:
        raise SystemExit("--depth cannot be combined with --phase PlanA_three: the 42-joint depth dataset is "
                         "a 2-frame format")
    if args.depth:
        discover = find_depth_seq_data_in_dir
    elif three:
        discover = find_ndds_seq_triples_in_dir
    else:
        discover = find_ndds_seq_data_in_dir
    pairs = discover(args.dataset)
    if args.add_dataset:
        pairs = pairs + discover(args.add_dataset)
    if world > 1:
        pairs = mesh.shard(pairs, world, rank)
    print(f"train pairs: {len(pairs)} (this rank)")

    camera_K = np.asarray(SYNTHETIC_CAMERA_K)
    if args.depth:
        object_name, kp_names = args.object_name or "Franka_Emika_Panda", []
    else:
        object_name, kp_names = args.object_name or args.robot, KEYPOINT_NAMES[args.robot]
    loader_cls = TripleBatchLoader if three else SeqBatchLoader
    loader = loader_cls(pairs, cfg, camera_K, object_name, kp_names, args.batch_size, seed=args.seed,
                        num_workers=args.num_workers, depth=args.depth)
    val_loader = None
    if args.val_dataset:
        val_loader = loader_cls(discover(args.val_dataset), cfg, camera_K, object_name, kp_names,
                                args.batch_size, shuffle=False, num_workers=args.num_workers, depth=args.depth)

    iters_per_epoch = len(loader)
    schedule = None
    if args.lr_step:
        schedule = step_decay_schedule(cfg.train.lr, [int(e) for e in args.lr_step.split(",")], iters_per_epoch)
    state = trainer.create_train_state(cfg, args.seed, max_iters=max(iters_per_epoch * args.num_epochs, 1),
                                       device=dev, phase=args.phase, schedule=schedule)
    state.seed = args.seed + 1  # the dropout stream
    if args.init_backbone:
        report = torch_convert.convert_imagenet_dla34(torch_convert.load_torch_checkpoint(args.init_backbone),
                                                      state.model, map_stem=args.init_backbone_stem)
        print(f"ImageNet trunk init from {args.init_backbone}: {report['n_converted']} tensors")
    if args.resume:
        path = os.path.abspath(args.resume)
        if os.path.isdir(path):
            raise NotImplementedError(orbax_route("--resume", args.resume))
        trainer.load_checkpoint(path, state)
        print(f"resumed from {args.resume} at step {state.step}")

    batch_fn = make_batch_fn_three(cfg, camera_K) if three else make_batch_fn(cfg, camera_K)
    mean = torch.tensor(IMAGE_MEAN)
    std = torch.tensor(IMAGE_STD)

    def log_mosaic(batch, step):
        one = {k: v[:1] for k, v in batch.items()}
        pred = trainer.predict_step(state, one, phase=args.phase)
        img = ((one["cur_img"][0].cpu() * std + mean) * 255.0).numpy()
        mosaic = training_debug_mosaic(img, one["gt_belief_maps"][0].cpu().numpy(), pred["hm"][0].cpu().numpy())
        logger.log_image(step, "train_mosaic", mosaic)

    for epoch in range(1, args.num_epochs + 1):
        t0 = time.time()
        for it, raw in enumerate(_timed_batches(loader.epoch(epoch), timed)):
            with timed("batch"):
                batch = batch_fn(batch_generator(args.seed, state.step), to_device(raw, dev))
            stats = trainer.train_step(state, batch, bf16=args.bf16, phase=args.phase, stage_timer=stage_timer)
            if it % args.log_every == 0:
                s = {k: v.item() for k, v in stats.items()}
                logger.log(state.step, s)
                print(f"epoch {epoch} it {it}/{iters_per_epoch} " + " ".join(f"{k}={v:.5f}" for k, v in s.items()),
                      flush=True)
            if args.image_log_every and it % args.image_log_every == 0 and world == 1:
                log_mosaic(batch, state.step)
        ckpt = os.path.join(os.path.abspath(args.output_dir), "ckpt", f"epoch_{epoch}.pt")
        if rank0:
            os.makedirs(os.path.dirname(ckpt), exist_ok=True)
            trainer.save_checkpoint(ckpt, state)
        mesh.barrier()
        print(f"epoch {epoch} done in {time.time() - t0:.1f}s -> {ckpt}", flush=True)

        if val_loader is not None and world > 1:
            print("validation skipped under several ranks (the keypoint metrics would need the "
                  "ranks' decoded coordinates gathered)")
        elif val_loader is not None:
            with timed("validation"):
                # every batch augmented with the same fixed draws
                val_batches = (batch_fn(torch.Generator().manual_seed(0), to_device(raw, dev))
                               for raw in val_loader.epoch(0))
                val = trainer.validate(state, val_batches, cfg, phase=args.phase)
            logger.log(state.step, val, prefix="val")
            print(f"epoch {epoch} val: {val}", flush=True)

    logger.close()
    if args.multihost or args.coordinator:
        mesh.shutdown()
    return {"state": state, "iters_per_epoch": iters_per_epoch}


if __name__ == "__main__":
    main()
