"""Carry a flax `SGTAPose` variable tree into the port's `SGTAPose`.

`variables` is the flax `{"params": ..., "batch_stats": ...}` tree with numpy
(or array-like) leaves. The port's submodules carry the flax module names, so
a flax leaf `a/b/<name>` lands on the torch module `a.b`; the leaf name and
the module type decide the layout change:

  Conv kernel   (kh, kw, I, O)      -> Conv2d weight (O, I, kh, kw)
  Dense kernel  (I, O)              -> Linear weight (O, I)
  DCN 1x1 kernel (1, 1, 9C, O)      -> Linear weight (O, 9C); the 9C axis is
                                       tap-major (k*C + c) on both sides
  up-conv kernel (k, k, 1, C)       -> ConvTranspose2d weight (C, 1, k, k),
                                       rotated by 180 degrees (the flax op is
                                       an lhs-dilated conv, which correlates
                                       with the flipped transposed-conv kernel)
  scale / bias / pos_embed          -> weight / bias / pos_embed
  batch_stats mean / var            -> running_mean / running_var

Strict in both directions: a flax leaf with no port tensor, a port tensor no
leaf sets, or a shape mismatch raises.

`load_flax_train_state` carries a whole JAX train state across the same way:
the variables into the model, optax Adam's moments mu / nu (trees shaped like
the params) and their count into torch Adam's exp_avg / exp_avg_sq / step,
and the schedule count and step into the port's TrainState.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _target(model: nn.Module, collection: str, path: tuple):
    """(torch state name, layout transform) for one flax leaf."""
    *mod_path, leaf = path
    mod = model.get_submodule(".".join(mod_path))
    pre = "".join(f"{m}." for m in mod_path)
    if collection == "batch_stats":
        attr = {"mean": "running_mean", "var": "running_var"}[leaf]
        return f"{pre}{attr}", None
    if leaf == "kernel":
        if isinstance(mod, nn.ConvTranspose2d):
            return f"{pre}weight", lambda w: w[::-1, ::-1].transpose(3, 2, 0, 1)
        if isinstance(mod, nn.Conv2d):
            return f"{pre}weight", lambda w: w.transpose(3, 2, 0, 1)
        if isinstance(mod, nn.Linear):
            return f"{pre}weight", lambda w: w.reshape(-1, w.shape[-1]).T
        raise KeyError(path)
    if leaf == "scale":
        return f"{pre}weight", None
    if leaf in ("bias", "pos_embed"):
        return f"{pre}{leaf}", None
    raise KeyError(path)


def _convert(model: nn.Module, trees: Mapping[str, Mapping], targets: Mapping[str, torch.Tensor]
             ) -> Dict[str, np.ndarray]:
    """{port tensor name: array in the port's layout} for every leaf of the
    flax trees (collection -> tree); raises on a leaf with no target, a
    target no leaf sets, or a shape mismatch."""
    out: Dict[str, np.ndarray] = {}
    for collection, tree in trees.items():
        for path, value in _flatten(tree).items():
            where = f"flax leaf {collection}/{'/'.join(path)}"
            try:
                key, tf = _target(model, collection, path)
            except (AttributeError, KeyError) as e:
                raise KeyError(f"{where} has no port tensor") from e
            if key not in targets:
                raise KeyError(f"{where} -> {key}: no such port tensor")
            arr = np.ascontiguousarray(tf(value) if tf is not None else value)
            if tuple(arr.shape) != tuple(targets[key].shape):
                raise ValueError(f"{key}: {where} gives {arr.shape}, port expects {tuple(targets[key].shape)}")
            if key in out:
                raise ValueError(f"{key} set twice")
            out[key] = arr
    missing = sorted(set(targets) - set(out))
    if missing:
        raise KeyError(f"{len(missing)} port tensors not set by the flax tree: {missing[:8]}")
    return out


@torch.no_grad()
def load_flax_variables(model: nn.Module, variables: Mapping) -> None:
    """Set every parameter and BatchNorm statistic of `model` from the flax
    variable tree (see module docstring); raises on any unused leaf, unset
    tensor or shape mismatch."""
    state = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    trees = {c: variables.get(c, {}) for c in ("params", "batch_stats")}
    for key, arr in _convert(model, trees, state).items():
        state[key].copy_(torch.from_numpy(arr).to(state[key].dtype))


@torch.no_grad()
def load_flax_train_state(state, flax_state: Mapping) -> None:
    """Set the port's TrainState (`train/trainer.py`) from a JAX train state
    given as {"params", "batch_stats", "mu", "nu", "adam_count",
    "schedule_count", "step"}: the variables as `load_flax_variables` sets
    them, Adam's first and second moments (trees shaped like "params") and
    its bias-correction count into every parameter's torch Adam state, the
    schedule count and the step. Strict like `load_flax_variables`."""
    model = state.model
    load_flax_variables(model, flax_state)
    params = dict(model.named_parameters())
    moments = {name: _convert(model, {"params": flax_state[leaf]}, params)
               for name, leaf in (("exp_avg", "mu"), ("exp_avg_sq", "nu"))}
    count = float(np.asarray(flax_state["adam_count"]))
    for key, p in params.items():
        state.optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            **{name: torch.from_numpy(m[key]).to(p.device, p.dtype) for name, m in moments.items()},
        }
    state.schedule_count = int(np.asarray(flax_state["schedule_count"]))
    state.step = int(np.asarray(flax_state["step"]))
