"""Carry a flax variable tree into the port's model (any arch of
`models/sgta.build_model`), and back (`export_flax_variables`).

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
leaf sets, or a shape mismatch raises. `export_flax_variables` is the exact
inverse: the model's tensors as a flax tree, which `load_flax_variables`
carries back bit for bit (`utils/torch_convert.py` maps reference state
dicts through it).

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


def _nest(flat: Mapping[tuple, np.ndarray]) -> Dict:
    out: Dict = {}
    for path, value in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return out


def _flax_leaf(model: nn.Module, name: str, value: np.ndarray):
    """(collection, flax path, array in flax's layout) of one port tensor,
    or None for a tensor flax has no leaf for (num_batches_tracked)."""
    *mod_path, attr = name.split(".")
    mod = model.get_submodule(".".join(mod_path))
    path = tuple(mod_path)
    if attr in ("running_mean", "running_var"):
        return "batch_stats", path + ({"running_mean": "mean", "running_var": "var"}[attr],), value
    if attr == "num_batches_tracked":
        return None
    if attr == "weight":
        if isinstance(mod, nn.ConvTranspose2d):
            return "params", path + ("kernel",), value.transpose(2, 3, 1, 0)[::-1, ::-1]
        if isinstance(mod, nn.Conv2d):
            return "params", path + ("kernel",), value.transpose(2, 3, 1, 0)
        if isinstance(mod, nn.Linear):
            parent = model.get_submodule(".".join(mod_path[:-1])) if len(mod_path) > 1 else model
            kernel = value.T
            if type(parent).__name__ == "DeformConv2d":  # the 1x1 (1, 1, 9C, O) contraction
                kernel = kernel.reshape(1, 1, *kernel.shape)
            return "params", path + ("kernel",), kernel
        return "params", path + ("scale",), value  # BatchNorm / LayerNorm
    if attr in ("bias", "pos_embed"):
        return "params", path + (attr,), value
    raise KeyError(f"port tensor {name} has no flax leaf")


@torch.no_grad()
def export_flax_variables(model: nn.Module) -> Dict[str, Dict]:
    """The model's parameters and BatchNorm statistics as a flax variable
    tree {"params", "batch_stats"} of float32 numpy arrays in flax's layout
    (the inverse of `load_flax_variables`)."""
    flat: Dict[str, Dict[tuple, np.ndarray]] = {"params": {}, "batch_stats": {}}
    for name, t in model.state_dict().items():
        leaf = _flax_leaf(model, name, t.detach().to("cpu", torch.float32).numpy())
        if leaf is not None:
            collection, path, arr = leaf
            flat[collection][path] = np.ascontiguousarray(arr)
    return {c: _nest(f) for c, f in flat.items()}
