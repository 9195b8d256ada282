"""The trainer: one optimizer step of a phase's model (float32, or bf16
mixed precision), evaluation and prediction forwards, and checkpoints.

Counterpart of `sgtapose_tpu/train/trainer.py` on one device. The JAX
TrainState (step, params, batch_stats, optax Adam state) becomes a
`TrainState` holding the model (its BatchNorm buffers are the batch_stats), a
`torch.optim.Adam`, the learning-rate schedule with its own count, the step,
and the dropout generator. `train_step` updates the state in place.

Adam: optax's `adam(schedule)` and torch's Adam make the same update,
lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps). optax applies
`schedule(count)` and then increments the count, so update t (from 0) uses
schedule(t): under warmup the first update runs at base * 1e-6. The trainer
sets the learning rate of each update to schedule(schedule_count) before
`optimizer.step()` and increments the count after, the same sequence.
Dropout draws from a generator on the model's device reseeded from
(seed, step) at each step, as the JAX step folds the step into its key.

bf16 (`train_step(bf16=True)`), as the JAX step does it
(`sgtapose_tpu/train/trainer.py:166-196`): the forward runs bf16 parameters
(a differentiable cast of the float32 masters, `utils/precision.bf16_forward`),
bf16 activations and the phase's model inputs cast to bf16; the heads are
cast to float32 before the loss; the loss, the gradients, Adam and the
masters stay float32; BatchNorm's running statistics are never cast and are
float32 after the step. Evaluation runs the float32 parameters, as the JAX
`eval_step` does.

Under several data-parallel ranks (`parallel/mesh.py`) `train_step` is the
JAX mesh step over the global batch: BatchNorm and dropout act on the global
batch inside the model, the gradients and the returned loss terms are the
ranks' means. `validate` is the training CLI's per-epoch validation.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn as nn

from sgtapose_tpu_torch.config import Config
from sgtapose_tpu_torch.decode.peaks import decode_heatmaps_batch
from sgtapose_tpu_torch.eval.metrics import keypoint_metrics
from sgtapose_tpu_torch.models.attention import set_dropout_generator
from sgtapose_tpu_torch.models.sgta import create_model
from sgtapose_tpu_torch.parallel import mesh
from sgtapose_tpu_torch.train.loss import sgta_loss
from sgtapose_tpu_torch.train.phases import loss_weights, model_inputs, model_wiring
from sgtapose_tpu_torch.train.schedule import warmup_poly_schedule
from sgtapose_tpu_torch.utils.precision import bf16_forward


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]
    dropout_generator: torch.Generator
    seed: int
    step: int = 0
    schedule_count: int = 0  # optax's scale_by_schedule count


def example_batch(cfg: Config, batch_size: int = 1, device="cuda") -> Dict[str, torch.Tensor]:
    """A zero batch with the training pipeline's shapes (NHWC)."""
    H, W = cfg.model.input_res
    Ho, Wo = cfg.model.output_res
    C = cfg.model.num_classes
    B = batch_size

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "cur_img": z(B, H, W, 3), "pre_img": z(B, H, W, 3),
        "pre_hm": z(B, H, W, 1), "repro_hm": z(B, H, W, 1),
        "pre_hm_cls": z(B, Ho, Wo, C), "repro_hm_cls": z(B, Ho, Wo, C),
        "pre_origin_hm": z(B, H, W, 1),
        "ppre_img": z(B, H, W, 3), "ppre_hm": z(B, H, W, 1), "ppre_hm_cls": z(B, Ho, Wo, C),
        "gt_belief_maps": z(B, Ho, Wo, C), "kp_int": z(B, C, 2, dtype=torch.int32),
        "reg_target": z(B, C, 2), "tracking_target": z(B, C, 2),
    }


def create_train_state(cfg: Config, seed: int, max_iters: int = 100000, device="cuda",
                       phase: str = "PlanA_win", schedule=None) -> TrainState:
    """The model of cfg.model.arch wired for `phase` (`phases.model_wiring`;
    the counterpart of JAX's `create_train_state_for_phase`, the flagship's
    PlanA_win by default), weights drawn from `seed`, in train mode on
    `device`; Adam (b1 0.9, b2 0.999, eps 1e-8) and the warmup-poly
    schedule of cfg.train over `max_iters` steps unless `schedule` is
    given."""
    model_cfg, tracking = model_wiring(cfg.model, phase)
    model = create_model(model_cfg, device=device, seed=seed, tracking=tracking).train()
    if schedule is None:
        schedule = warmup_poly_schedule(cfg.train.lr, max_iters, cfg.train.warmup_iters,
                                        power=cfg.train.poly_power)
    optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)
    generator = torch.Generator(device=next(model.parameters()).device)
    set_dropout_generator(model, generator)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule,
                      dropout_generator=generator, seed=seed)


def resume_schedule_state(state: TrainState, step: int) -> TrainState:
    """Continue a parent run's learning-rate schedule from `step` after a
    params-only warm start: the step and the schedule count advance to
    `step`; Adam's bias-correction count stays where it is (0 for fresh
    moments), so the first updates are not run at the stale count's larger
    size."""
    state.step = step
    state.schedule_count = step
    return state


def dropout_seed(seed: int, step: int) -> int:
    """The dropout generator's seed at `step` of a run seeded with `seed`."""
    return (seed * (1 << 32) + step) % (1 << 63)


def _timed(stage_timer, name):
    return stage_timer(name) if stage_timer is not None else contextlib.nullcontext()


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], hm_weight: float = 1.0,
               reg_weight: float = 0.01, tracking_weight: float = 0.0, bf16: bool = False,
               phase: str = "PlanA_win", stage_timer=None) -> Dict[str, torch.Tensor]:
    """One optimizer step, in place: forward in train mode (batch
    statistics; the BN running averages update), the loss, backward, the
    learning rate of this update from the schedule, Adam. float32, or with
    bf16=True bf16 mixed precision (module docstring). Returns the loss
    terms {"tot", "hm", "reg", "tracking"} (float32, detached, on the
    device). stage_timer: optional fn(name) -> context manager around the
    stages "forward", "backward" and "optimizer"."""
    weights = loss_weights(phase, hm_weight, reg_weight, tracking_weight)
    model = state.model.train()
    state.dropout_generator.manual_seed(dropout_seed(state.seed, state.step))
    inputs = model_inputs(phase, batch)
    with _timed(stage_timer, "forward"):
        if bf16:
            out = bf16_forward(model, [x.to(torch.bfloat16) for x in inputs])
        else:
            out = model(*inputs)
        total, stats = sgta_loss({k: v.to(torch.float32) for k, v in out.items()}, batch, **weights)
    with _timed(stage_timer, "backward"):
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        # optax updates every parameter: where the loss does not reach one
        # (levels 0 and 1 feed no head), its zero gradient still moves it by
        # its Adam moments; torch's Adam skips a parameter without a grad
        # (float32 zeros under bf16 too: the masters are float32)
        for p in state.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        mesh.all_reduce_mean_([p.grad for p in state.model.parameters()])
    with _timed(stage_timer, "optimizer"):
        lr = state.schedule(state.schedule_count)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
    state.schedule_count += 1
    state.step += 1
    stats = {k: v.detach() for k, v in stats.items()}
    terms = list(stats.values())
    mesh.all_reduce_mean_(terms)
    return dict(zip(stats, terms))


@torch.no_grad()
def _eval_forward(state: TrainState, batch, phase: str):
    return state.model.eval()(*model_inputs(phase, batch))


def _prediction_heads(out) -> Dict[str, torch.Tensor]:
    """Sigmoided heatmaps, reg and tracking in float32."""
    return {"hm": torch.sigmoid(out["hm"].to(torch.float32)), "reg": out["reg"].to(torch.float32),
            "tracking": out["tracking"].to(torch.float32)}


def eval_step(state: TrainState, batch, phase: str = "PlanA_win") -> Dict[str, torch.Tensor]:
    """Validation forward (running statistics, no dropout) and loss terms."""
    out = _eval_forward(state, batch, phase)
    _, stats = sgta_loss({k: v.to(torch.float32) for k, v in out.items()}, batch, **loss_weights(phase))
    return stats


def predict_step(state: TrainState, batch, phase: str = "PlanA_win") -> Dict[str, torch.Tensor]:
    """Inference forward: the decodable heads."""
    return _prediction_heads(_eval_forward(state, batch, phase))


def eval_predict_step(state: TrainState, batch, phase: str = "PlanA_win"
                      ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Loss terms and decodable heads from one validation forward."""
    out = _eval_forward(state, batch, phase)
    out_f32 = {k: v.to(torch.float32) for k, v in out.items()}
    _, stats = sgta_loss(out_f32, batch, **loss_weights(phase))
    return stats, _prediction_heads(out_f32)


def validate(state: TrainState, batches: Iterable[Dict[str, torch.Tensor]], cfg: Config,
             phase: str = "PlanA_win") -> Dict[str, float]:
    """The training CLI's validation: per batch one `eval_predict_step`, the
    heads decoded with the `cfg.infer` settings, detections and ground truth
    (kp_int + reg_target) in input pixels (x down_ratio). Returns the mean
    loss terms over the batches and, over all frames and keypoints,
    `keypoint_metrics`' counts of found and missing in-frame keypoints,
    mean L2 error (-1.0 when there is none) and PCK AUC at 12 px (0.0 when
    there is none). No batch: an empty dict."""
    vals, det_all, gt_all = [], [], []
    ratio = float(cfg.model.down_ratio)
    inf = cfg.infer
    for batch in batches:
        stats, pred = eval_predict_step(state, batch, phase)
        vals.append({k: v.item() for k, v in stats.items()})
        dec = decode_heatmaps_batch(pred["hm"], pred["reg"], pred["tracking"], max_peaks=inf.max_peaks,
                                    peak_thresh=inf.peak_thresh, ambiguity_gap=inf.ambiguity_gap,
                                    peak_offset=inf.peak_offset, sigma=inf.peak_sigma, ref_sort=inf.ref_sort,
                                    coord_mode=inf.decode_coord)
        det_all.append(dec.coords.cpu().numpy() * ratio)
        gt = batch["kp_int"].cpu().numpy().astype(np.float32) + batch["reg_target"].cpu().numpy()
        gt_all.append(gt * ratio)
    if not vals:
        return {}
    mean = {k: float(np.mean([v[k] for v in vals])) for k in vals[0]}
    H, W = cfg.model.input_res
    km = keypoint_metrics(np.concatenate(det_all).reshape(-1, 2), np.concatenate(gt_all).reshape(-1, 2), (W, H))
    mean.update({
        "kp_found_inframe": km["num_found_gt_inframe"],
        "kp_missing_inframe": km["num_missing_gt_inframe"],
        "kp_l2_mean_px": km["l2_error_mean_px"] or -1.0,
        "kp_pck_auc_12px": km["l2_error_auc"] or 0.0,
    })
    return mean


def save_checkpoint(path: str, state: TrainState) -> None:
    """torch.save of {step, schedule_count, model, optimizer}."""
    torch.save({"step": state.step, "schedule_count": state.schedule_count,
                "model": state.model.state_dict(), "optimizer": state.optimizer.state_dict()}, path)


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore a `save_checkpoint` payload into `state` (in place, tensors on
    the model's device) and return it."""
    payload = torch.load(path, map_location=next(state.model.parameters()).device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    state.schedule_count = int(payload["schedule_count"])
    return state
