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


@torch.no_grad()
def load_flax_variables(model: nn.Module, variables: Mapping) -> None:
    """Set every parameter and BatchNorm statistic of `model` from the flax
    variable tree (see module docstring); raises on any unused leaf, unset
    tensor or shape mismatch."""
    state = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    seen = set()
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})).items():
            try:
                key, tf = _target(model, collection, path)
            except (AttributeError, KeyError) as e:
                raise KeyError(f"flax leaf {collection}/{'/'.join(path)} has no port tensor") from e
            if key not in state:
                raise KeyError(f"flax leaf {collection}/{'/'.join(path)} -> {key}: no such port tensor")
            arr = np.ascontiguousarray(tf(value) if tf is not None else value)
            if tuple(arr.shape) != tuple(state[key].shape):
                raise ValueError(f"{key}: flax {collection}/{'/'.join(path)} gives {arr.shape}, "
                                 f"port expects {tuple(state[key].shape)}")
            if key in seen:
                raise ValueError(f"{key} set twice")
            state[key].copy_(torch.from_numpy(arr).to(state[key].dtype))
            seen.add(key)
    missing = sorted(set(state) - seen)
    if missing:
        raise KeyError(f"{len(missing)} port tensors not set by the flax tree: {missing[:8]}")
