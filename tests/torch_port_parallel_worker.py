"""One process of the data-parallel parity test (test_torch_port_parallel.py):
`trainer.train_step`s of the tiny model with dropout on, either alone on
the global batch of 2 (world 1) or as rank R of 2 on its row of it (a gloo
process group over tcp://localhost:PORT): one step of a fresh train state
for each of MODES, each float64 (the default), float32 or bf16 mixed
precision (float32 masters, `train_step(bf16=True)`), with a `_bn_eval`
suffix BatchNorm held in eval mode. Saves the gradients after the
all-reduce, the BatchNorm running statistics before and after the step, the
Adam moments, the parameters after the update and the loss terms (of the
modes but float64, those the test reads: SAVED) to
OUT_DIR/wWORLD_rRANK_MODE.pt.

    python tests/torch_port_parallel_worker.py WORLD RANK PORT OUT_DIR [MODE,...]

Imports no JAX: the batch is seeded numpy draws.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sgtapose_tpu_torch.config import ModelConfig  # noqa: E402
from sgtapose_tpu_torch.models import attention as tattn, deform_conv as tdcn  # noqa: E402
from sgtapose_tpu_torch.ops import attention_kernel as tak  # noqa: E402
from sgtapose_tpu_torch.parallel import mesh  # noqa: E402
from sgtapose_tpu_torch.train import trainer  # noqa: E402
from sgtapose_tpu_torch.train.schedule import warmup_poly_schedule  # noqa: E402

GLOBAL_BATCH, RES, SEED = 2, 64, 5
# what test_torch_port_parallel.py reads of each mode but float64 (which it
# reads whole): every dict but stats and the statistics is the model's size
SAVED = {"bf16": ("stats", "buffers", "buffers0", "params"), "float32": ("stats", "buffers"),
         "bf16_bn_eval": ("stats", "grads", "exp_avg", "params"), "float32_bn_eval": ("stats", "grads", "exp_avg")}
CFG = ModelConfig(input_res=(RES, RES), kernel_list=(3, 3, 3, 1, 1, 1))


def global_batch():
    """The global batch of random numpy tensors (as torch_port_common's
    random_train_batch, in float64)."""
    rs = np.random.RandomState(SEED)
    Ho = RES // 4
    B = GLOBAL_BATCH
    return {
        "cur_img": rs.randn(B, RES, RES, 3), "pre_img": rs.randn(B, RES, RES, 3),
        "pre_hm": rs.rand(B, RES, RES, 1), "repro_hm": rs.rand(B, RES, RES, 1),
        "pre_hm_cls": rs.rand(B, Ho, Ho, 7), "repro_hm_cls": rs.rand(B, Ho, Ho, 7),
        "gt_belief_maps": rs.rand(B, Ho, Ho, 7),
        "kp_int": rs.randint(0, Ho, (B, 7, 2)).astype(np.int32),
        "reg_target": rs.rand(B, 7, 2), "tracking_target": rs.randn(B, 7, 2),
    }


def one_step(world: int, rank: int, mode: str) -> dict:
    """One train step of a fresh train state in `mode` (float64, float32 or
    bf16; a `_bn_eval` suffix holds every BatchNorm in eval mode through the
    step's `model.train()`); its results to save."""
    from sgtapose_tpu_torch.config import Config
    from sgtapose_tpu_torch.models.dla import BatchNorm

    dtype_name, bn_eval = mode.removesuffix("_bn_eval"), mode.endswith("_bn_eval")
    cfg = Config(model=CFG)
    state = trainer.create_train_state(cfg, seed=0, device="cpu",
                                       schedule=warmup_poly_schedule(1e-3, 20, 4))
    if dtype_name == "float64":
        state.model.double()
    state.step = state.schedule_count = 3  # a learning rate past the warmup's first step
    b = GLOBAL_BATCH // world
    dtype = torch.float64 if dtype_name == "float64" else torch.float32
    batch = {k: torch.from_numpy(v[rank * b:(rank + 1) * b]) for k, v in global_batch().items()}
    batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    model = state.model
    buffers = lambda: {n: t.clone() for n, t in model.state_dict().items() if n.endswith(("running_mean", "running_var"))}
    buffers0 = buffers()
    train = BatchNorm.train
    if bn_eval:
        BatchNorm.train = lambda self, mode=True: torch.nn.Module.train(self, False)
    try:
        stats = trainer.train_step(state, batch, bf16=dtype_name == "bf16")
    finally:
        BatchNorm.train = train
    opt = state.optimizer.state
    return {
        "stats": {k: v.item() for k, v in stats.items()},
        "grads": {n: p.grad for n, p in model.named_parameters()},
        "buffers": buffers(),
        "buffers0": buffers0,
        "exp_avg": {n: opt[p]["exp_avg"] for n, p in model.named_parameters()},
        "exp_avg_sq": {n: opt[p]["exp_avg_sq"] for n, p in model.named_parameters()},
        "params": {n: p.detach() for n, p in model.named_parameters()},
    }


def main(world: int, rank: int, port: int, out_dir: str, modes: str = "float64") -> None:
    torch.set_num_threads(2)
    if modes == "float64":
        # float64 through autograd of the plain versions (the kernels'
        # autograd Functions run float32 and bf16), as
        # test_torch_port_train_f64.py runs it
        tdcn.deform_conv = tdcn.plain_deform_conv
        tattn.fused_biased_attention = tak.plain_biased_attention
    if world > 1:
        mesh.initialize_multihost(f"localhost:{port}", world, rank, device="cpu")
    for mode in modes.split(","):
        res = one_step(world, rank, mode)
        res = {k: res[k] for k in SAVED.get(mode, res)}
        torch.save(res, os.path.join(out_dir, f"w{world}_r{rank}_{mode}.pt"))
    mesh.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], *sys.argv[5:])
