"""Checkpoint converter: reference-format `.pth` <-> the port's checkpoints.

Counterpart of `sgtapose_tpu/cli/convert.py`:

  reference -> port:  python -m sgtapose_tpu_torch.cli.convert \\
                          --torch_ckpt model_20.pth --out converted.pt
  port -> reference:  python -m sgtapose_tpu_torch.cli.convert \\
                          --ckpt exp/ckpt/epoch_20.pt --out_pth exported.pth

A port checkpoint is a `train/trainer.save_checkpoint` file: what
`cli/infer.py --ckpt` and `cli/train.py --resume` read (a converted one
carries a fresh Adam state at step 0). The reference format is {epoch,
state_dict}; a `.pth` exported by the JAX package (`python -m
sgtapose_tpu.cli.convert --ckpt DIR --out_pth X.pth`) is one too, which is
how a JAX (orbax) checkpoint reaches the port: the port cannot read orbax
directories. The conversion is `utils/torch_convert.py`; this module builds
the arch's train state as the template on --device (default cuda, which
raises without a card; cpu runs on the host), loads or saves it there, and
does the file I/O.
"""

from __future__ import annotations

import argparse
import json
import os

from sgtapose_tpu_torch.config import Config, ModelConfig
from sgtapose_tpu_torch.train import trainer
from sgtapose_tpu_torch.utils import torch_convert as tc


def parse_args(argv=None):
    p = argparse.ArgumentParser("sgtapose_tpu_torch convert")
    p.add_argument("--torch_ckpt", default=None,
                   help="reference-format .pth to ingest ({epoch, state_dict, ...} or a bare state_dict)")
    p.add_argument("--ckpt", default=None, help="port checkpoint (train/trainer.save_checkpoint) to export")
    p.add_argument("--out", default=None, help="port checkpoint to write (reference -> port)")
    p.add_argument("--out_pth", default=None, help=".pth to write (port -> reference)")
    p.add_argument("--arch", default="dlapawdl3new_34")
    p.add_argument("--ablation_mode", default="shared_repro",
                   help="for --arch dlaabla_34: shared_repro | shared | wo_shared (wo_shared carries a "
                        "second trunk, base1)")
    p.add_argument("--dla_node", default="dcn", choices=["dcn", "conv"])
    p.add_argument("--kernel_list", default="12,6,3,1,1,1")
    p.add_argument("--num_classes", type=int, default=7)
    p.add_argument("--no_bgr_flip", action="store_true",
                   help="skip the image stems' BGR -> RGB channel flip (on by default: the reference "
                        "trains on cv2 BGR frames, the port's loaders feed RGB)")
    p.add_argument("--lenient", action="store_true",
                   help="keep going on missing or mismatched tensors (reported); default strict")
    p.add_argument("--report_out", default=None, help="write the conversion report json here")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return p.parse_args(argv)


def template_state(args) -> trainer.TrainState:
    """A fresh train state of the arch (with --ablation_mode's wiring) on
    --device, the shape template (parameter shapes do not depend on the
    input resolution)."""
    cfg = Config(model=ModelConfig(arch=args.arch, input_res=(64, 64), num_classes=args.num_classes,
                                   dla_node=args.dla_node,
                                   kernel_list=tuple(int(x) for x in args.kernel_list.split(",")),
                                   ablation_mode=args.ablation_mode))
    return trainer.create_train_state(cfg, 0, max_iters=1, device=args.device)


def main(argv=None):
    args = parse_args(argv)
    arch = tc.arch_key(args.arch, args.ablation_mode)
    if args.torch_ckpt:
        if not args.out:
            raise SystemExit("--torch_ckpt needs --out (a port checkpoint file)")
        sd = tc.load_torch_checkpoint(args.torch_ckpt)
        state = template_state(args)
        report = tc.convert_state_dict(sd, state.model, bgr_to_rgb=not args.no_bgr_flip,
                                       strict=not args.lenient, dla_node=args.dla_node, arch=arch)
        trainer.save_checkpoint(os.path.abspath(args.out), state)
        report["device"] = str(next(state.model.parameters()).device)
        print(f"converted {report['n_converted']} tensors on {report['device']} -> {args.out}")
        if report["missing"] or report["mismatched"] or report["unused_ref_keys"]:
            print(f"report: missing={len(report['missing'])} mismatched={len(report['mismatched'])} "
                  f"unused={len(report['unused_ref_keys'])}")
        if args.report_out:
            with open(args.report_out, "w") as f:
                json.dump(report, f, indent=1, default=str)
        return report
    if args.ckpt:
        if not args.out_pth:
            raise SystemExit("--ckpt needs --out_pth (.pth path)")
        path = os.path.abspath(args.ckpt)
        if os.path.isdir(path):
            raise SystemExit(f"--ckpt {args.ckpt} is a directory (an orbax checkpoint of the JAX package?): "
                             "export it with `python -m sgtapose_tpu.cli.convert --ckpt DIR --out_pth X.pth`")
        state = template_state(args)
        trainer.load_checkpoint(path, state)
        sd = tc.export_state_dict(state.model, dla_node=args.dla_node, arch=arch,
                                  bgr_to_rgb=not args.no_bgr_flip)
        tc.save_torch_checkpoint(args.out_pth, sd, epoch=state.step)
        print(f"exported {len(sd)} tensors -> {args.out_pth}")
        return sd
    raise SystemExit("pass --torch_ckpt (reference -> port) or --ckpt (port -> reference)")


if __name__ == "__main__":
    main()
