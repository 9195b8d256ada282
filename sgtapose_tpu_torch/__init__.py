"""sgtapose_tpu_torch — PyTorch/CUDA port of the sgtapose_tpu streaming
detector for NVIDIA Hopper (H100).

The JAX package `sgtapose_tpu` is the reference; this package imports none of
it (nor jax/flax) and keeps its own copy of what it needs. Layout mirrors the
JAX package:

  config.py   model/inference dataclasses (same defaults as the reference)
  core/       geometry, masked EPnP + LM PnP solver (batched over videos or
              frames), the eval harness's weighted refinement
  models/     DLA-34 trunk, DCNv2 decoder, windowed cross-attention, SGTAPose
  ops/        hand-written CUDA kernels (csrc/*.cu: forward in float32 and
              bf16, backward in float32): the nvcc build, the ctypes
              bindings and the launch counters
  decode/     peak finding + sub-pixel decode (batched over videos)
  infer/      streaming video detectors: exact, feature-cache, batched; the
              tracker's association pass
  eval/       metrics, set-level analysis, the synthetic-video harness
  data/       synthetic sequences and the on-disk fixture writers, the
              dataset loaders, the training-batch pipeline
  train/      loss, schedules, phases, the float32 trainer
  cli/        train_demo, infer (datasets on disk)
  utils/      flax-variable and train-state loader, bf16 serving (precision.py),
              the debug images (debugger.py, visualize.py), StageTimer

A bf16 model (`utils.precision.bf16_inference_model`) serves as the JAX
package's `bf16_inference_variables` + `make_bf16_apply` do: bf16 weights and
activations through the network, float32 for decode and geometry.

Public entry points run on the card (device="cuda") unless the caller asks
for the CPU; they raise when CUDA is missing instead of falling back.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; raises if CUDA is asked for but
    unavailable (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sgtapose_tpu_torch: device='cuda' requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return dev
