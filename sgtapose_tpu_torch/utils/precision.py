"""Mixed precision for serving: bf16 parameters and activations on the
convolution and attention path, float32 for decode and geometry.

Counterpart of `sgtapose_tpu/utils/precision.py`. The JAX package casts every
floating leaf of the variable tree, BatchNorm statistics included, and flax
computes each layer in the promoted dtype of its input and parameters; the
port casts the module's floating parameters and buffers the same way (integer
buffers such as BatchNorm's `num_batches_tracked` stay as they are), and its
layers promote likewise (`models/attention.py`).
"""

from __future__ import annotations

import copy
from typing import Any

import torch
import torch.nn as nn


def cast_floating(obj: Any, dtype: torch.dtype) -> Any:
    """Cast the floating tensors of `obj` to `dtype`: a module's parameters
    and buffers (in place, as `nn.Module.to` does), or the floating tensors
    of a tensor, list or tuple (new containers). Integer and bool tensors and
    non-tensors are returned as they are."""
    if isinstance(obj, nn.Module):
        return obj.to(dtype)  # casts floating parameters and buffers only
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(cast_floating(v, dtype) for v in obj)
    return obj


def bf16_inference_model(model: nn.Module) -> nn.Module:
    """A bf16 copy of `model` for serving (`model` itself is left as it is)."""
    return cast_floating(copy.deepcopy(model), torch.bfloat16)


def param_dtype(model: nn.Module) -> torch.dtype:
    """The dtype of the model's floating parameters (the serving dtype)."""
    return next(p for p in model.parameters() if p.is_floating_point()).dtype
