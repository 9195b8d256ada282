"""Reference-format `.pth` state dicts <-> the port's models.

Counterpart of `sgtapose_tpu/utils/torch_convert.py`, with the port's own copy
of its mapping (flax path -> reference name and layout transform, `_flag_map`
and `_add_dla_trunk`). A state dict converts through the flax tree the port's
model exports (`utils/weights.export_flax_variables`: its shapes and, for what
the dict does not set, its current values) and is loaded back
(`load_flax_variables`), so the port gets, tensor for tensor, what the JAX
converter gives flax:

  conv     reference (O, I, kh, kw)  -> flax (kh, kw, I, O)
  linear   (O, I)                    -> (I, O)
  DCN main (O, I, 3, 3)              -> the 1x1 contraction (1, 1, 9I, O),
                                        tap-major
  up-conv  ConvTranspose2d (C, 1, k, k) -> (k, k, 1, C), rotated by 180 degrees
  BN       weight / bias / running_mean / running_var -> scale / bias, mean / var
  3-channel image stems: the input channels flipped (the reference trains on
           cv2's BGR frames, the port's loaders feed RGB)

The reference's weight-tied transformer serializes layers.0/1/2 as copies;
layers.0 is read, and export writes all three. `module.` prefixes are
stripped. Known-unused reference tensors (the dead base_layer /
repro_hm_layer, ImageNet fc, the dead tree projections, the wh head, the
tied copies) are not reported. Strict by default: a missing or mismatched
tensor raises; strict=False reports them (and keeps the model's value).

Archs with a mapping: dlapawdl3new (both dla_node), dlapa, dlapawd, dlapacat,
dlaabla and dlaabla_wo_shared (the wo_shared ablation's second trunk). The
ImageNet DLA-34 release format (a bare trunk) converts into `base`
(`convert_imagenet_dla34`, with map_stem also into the image stem) and
exports from it (`export_imagenet_dla34`).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from sgtapose_tpu_torch.utils.weights import _nest, export_flax_variables, load_flax_variables

def _conv(w):
    return np.transpose(w, (2, 3, 1, 0))


def _linear(w):
    return np.transpose(w)


def _dcn_main(w):
    o, i, kh, kw = w.shape
    return np.transpose(w, (2, 3, 1, 0)).reshape(1, 1, kh * kw * i, o)


def _up(w):
    return np.transpose(w, (2, 3, 1, 0))[::-1, ::-1].copy()


def _inv_conv(w):
    return np.transpose(w, (3, 2, 0, 1))


def _inv_linear(w):
    return np.transpose(w)


def _inv_dcn_main(w):
    _, _, ki, o = w.shape
    return np.transpose(w.reshape(3, 3, ki // 9, o), (3, 2, 0, 1))


def _inv_up(w):
    return np.transpose(w[::-1, ::-1], (3, 2, 0, 1)).copy()


_INVERSE = {_conv: _inv_conv, _linear: _inv_linear, _dcn_main: _inv_dcn_main, _up: _inv_up}
Mapping_ = Dict[str, Tuple[str, Optional[Callable]]]


def _basic_block(ref: str) -> Mapping_:
    return {
        "ConvBnAct_0/Conv_0/kernel": (f"{ref}.conv1.weight", _conv),
        "ConvBnAct_0/BatchNorm_0": (f"{ref}.bn1", None),
        "Conv_0/kernel": (f"{ref}.conv2.weight", _conv),
        "BatchNorm_0": (f"{ref}.bn2", None),
    }


def _add_leaf_tree(m: Mapping_, our: str, ref: str, has_project: bool) -> None:
    for tree in ("tree1", "tree2"):
        for sub, (rname, tf) in _basic_block(f"{ref}.{tree}").items():
            m[f"{our}/{tree}/{sub}"] = (rname, tf)
    m[f"{our}/root/Conv_0/kernel"] = (f"{ref}.root.conv.weight", _conv)
    m[f"{our}/root/BatchNorm_0"] = (f"{ref}.root.bn", None)
    if has_project:
        m[f"{our}/project_conv/kernel"] = (f"{ref}.project.0.weight", _conv)
        m[f"{our}/project_bn"] = (f"{ref}.project.1", None)


def _add_dla_trunk(m: Mapping_, our_base: str, ref_base: str) -> None:
    """One DLA-34 trunk; ref_base "" maps a bare (ImageNet release) dict."""
    pre = ref_base + "." if ref_base else ""
    for lvl in (0, 1):
        m[f"{our_base}/level{lvl}/Conv_0/kernel"] = (f"{pre}level{lvl}.0.weight", _conv)
        m[f"{our_base}/level{lvl}/BatchNorm_0"] = (f"{pre}level{lvl}.1", None)
    _add_leaf_tree(m, f"{our_base}/level2", f"{pre}level2", True)
    _add_leaf_tree(m, f"{our_base}/level5", f"{pre}level5", True)
    for lvl in (3, 4):
        _add_leaf_tree(m, f"{our_base}/level{lvl}/tree1", f"{pre}level{lvl}.tree1", True)
        _add_leaf_tree(m, f"{our_base}/level{lvl}/tree2", f"{pre}level{lvl}.tree2", False)


def _flag_map(dla_node: str = "dcn", arch: str = "dlapawdl3new") -> Mapping_:
    """flax path -> (reference name or BN prefix, transform) for `arch`."""
    m: Mapping_ = {}
    dec = "" if arch == "dlapawdl3new" else "decoder/"
    m["pre_img_stem/Conv_0/kernel"] = ("base.pre_img_layer.0.weight", _conv)
    m["pre_img_stem/BatchNorm_0"] = ("base.pre_img_layer.1", None)
    m["pre_hm_stem/Conv_0/kernel"] = ("base.pre_hm_layer.0.weight", _conv)
    m["pre_hm_stem/BatchNorm_0"] = ("base.pre_hm_layer.1", None)
    _add_dla_trunk(m, "base", "base")
    if arch == "dlaabla_wo_shared":
        m["cur_img_stem/Conv_0/kernel"] = ("base1.pre_img_layer.0.weight", _conv)
        m["cur_img_stem/BatchNorm_0"] = ("base1.pre_img_layer.1", None)
        _add_dla_trunk(m, "base1", "base1")

    def add_deform(our: str, ref: str):
        if dla_node == "conv":
            m[f"{our}/conv/kernel"] = (f"{ref}.conv.0.weight", _conv)
            m[f"{our}/BatchNorm_0"] = (f"{ref}.conv.1", None)
            return
        m[f"{our}/conv/conv_offset_mask/kernel"] = (f"{ref}.conv.conv_offset_mask.weight", _conv)
        m[f"{our}/conv/conv_offset_mask/bias"] = (f"{ref}.conv.conv_offset_mask.bias", None)
        m[f"{our}/conv/kernel/kernel"] = (f"{ref}.conv.weight", _dcn_main)
        m[f"{our}/conv/kernel/bias"] = (f"{ref}.conv.bias", None)
        m[f"{our}/BatchNorm_0"] = (f"{ref}.actf.0", None)

    for ida, js in {"ida_0": (1,), "ida_1": (1, 2), "ida_2": (1, 2, 3)}.items():
        for j in js:
            add_deform(f"{dec}dla_up/{ida}/proj_{j}", f"dla_up.{ida}.proj_{j}")
            add_deform(f"{dec}dla_up/{ida}/node_{j}", f"dla_up.{ida}.node_{j}")
            m[f"{dec}dla_up/{ida}/up_{j}/kernel"] = (f"dla_up.{ida}.up_{j}.weight", _up)
    for j in (1, 2):
        add_deform(f"{dec}ida_up/proj_{j}", f"ida_up.proj_{j}")
        add_deform(f"{dec}ida_up/node_{j}", f"ida_up.node_{j}")
        m[f"{dec}ida_up/up_{j}/kernel"] = (f"ida_up.up_{j}.weight", _up)
    for head in ("hm", "reg", "tracking"):
        m[f"{dec}{head}/Conv_0/kernel"] = (f"{head}.0.weight", _conv)
        m[f"{dec}{head}/Conv_0/bias"] = (f"{head}.0.bias", None)
        m[f"{dec}{head}/Conv_1/kernel"] = (f"{head}.2.weight", _conv)
        m[f"{dec}{head}/Conv_1/bias"] = (f"{head}.2.bias", None)

    def add_transformer(i: int, our: str, pos_embed: bool):
        ref = f"transformer.{i}.layers.0"  # weight-tied: layers.0
        for proj in ("w_q", "w_k", "w_v"):
            m[f"{our}/cross_attn/{proj}/kernel"] = (f"{ref}.cross_attn.{proj}.weight", _linear)
        m[f"{our}/cross_attn/fc/kernel"] = (f"{ref}.cross_attn.fc.weight", _linear)
        m[f"{our}/cross_attn/fc/bias"] = (f"{ref}.cross_attn.fc.bias", None)
        if pos_embed:
            m[f"{our}/cross_attn/pos_embed"] = (f"{ref}.cross_attn.pos_embed", None)
        for ln in ("norm1", "norm3"):
            m[f"{our}/{ln}/scale"] = (f"{ref}.{ln}.weight", None)
            m[f"{our}/{ln}/bias"] = (f"{ref}.{ln}.bias", None)
        for lin in ("linear1", "linear2"):
            m[f"{our}/{lin}/kernel"] = (f"{ref}.{lin}.weight", _linear)
            m[f"{our}/{lin}/bias"] = (f"{ref}.{lin}.bias", None)

    def add_cat_layer(i: int, our: str):
        m[f"{our}/fc1/kernel"] = (f"cat_layer.{i}.0.weight", _linear)
        m[f"{our}/fc1/bias"] = (f"cat_layer.{i}.0.bias", None)
        m[f"{our}/fc2/kernel"] = (f"cat_layer.{i}.2.weight", _linear)
        m[f"{our}/fc2/bias"] = (f"cat_layer.{i}.2.bias", None)

    if arch == "dlapacat":
        return m
    if arch == "dlapawdl3new":
        for i in range(3):
            add_transformer(i, f"transformer_{i}/layer", pos_embed=True)
        for i in range(6):
            add_cat_layer(i, f"cat_layer_{i}")
        return m
    if arch == "dlapa":
        for i in range(6):
            add_transformer(i, f"transformer_{i}/layer", pos_embed=False)
            add_cat_layer(i, f"cat_layer_{i}")
        return m
    if arch == "dlapawd":
        for i in range(3):
            add_transformer(i, f"attn_{i}/transformer/layer", pos_embed=True)
            add_cat_layer(i, f"attn_{i}/cat_layer")
        for i in range(3, 6):
            add_cat_layer(i, f"cat_layer_{i}/mlp")
        return m
    if arch in ("dlaabla", "dlaabla_wo_shared"):
        for i in range(6):
            add_cat_layer(i, f"cat_layer_{i}/mlp")
        return m
    raise ValueError(f"no converter mapping for arch: {arch}")


_BN_PARAM = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}
_BGR_PATHS = ("pre_img_stem/Conv_0/kernel", "cur_img_stem/Conv_0/kernel")


def _flat_paths(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flat_paths(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def _resolve(mapping: Mapping_, our_path: str):
    """(reference name, transform) of a flax path, or None when unmapped."""
    if our_path in mapping:
        return mapping[our_path]
    head, leaf = our_path.rsplit("/", 1)
    if head in mapping and leaf in {**_BN_PARAM, **_BN_STATS}:
        return mapping[head][0] + "." + (_BN_PARAM.get(leaf) or _BN_STATS.get(leaf)), None
    return None


def _strip(state_dict: Mapping) -> Dict[str, np.ndarray]:
    return {re.sub(r"^module\.", "", k): np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in state_dict.items()}


def _convert_into(model: nn.Module, sd: Dict[str, np.ndarray], mapping: Mapping_, bgr_paths, strict: bool,
                  unused_filter) -> Dict:
    """Load the mapped tensors of `sd` into `model` through its flax tree;
    returns the report {missing, mismatched, unused_ref_keys, n_converted}."""
    template = export_flax_variables(model)
    used, missing, mismatched = set(), [], []
    trees = {}
    for collection, tree in template.items():
        flat = {}
        for path, leaf in _flat_paths(tree).items():
            flat[tuple(path.split("/"))] = leaf
            hit = _resolve(mapping, path)
            if hit is None:
                continue
            ref, tf = hit
            if ref not in sd:
                missing.append((path, ref))
                continue
            w = sd[ref] if tf is None else tf(sd[ref])
            if path in bgr_paths:
                w = w[:, :, ::-1, :]
            if tuple(w.shape) != tuple(leaf.shape):
                mismatched.append((path, ref, tuple(w.shape), tuple(leaf.shape)))
                continue
            used.add(ref)
            flat[tuple(path.split("/"))] = np.asarray(w, np.float32)
        trees[collection] = _nest(flat)
    report = {"missing": missing, "mismatched": mismatched,
              "unused_ref_keys": sorted(k for k in sd if k not in used and unused_filter(k)),
              "n_converted": len(used)}
    if strict and (missing or mismatched):
        raise ValueError(f"conversion incomplete: {report}")
    load_flax_variables(model, trees)
    return report


def convert_state_dict(state_dict: Mapping, model: nn.Module, bgr_to_rgb: bool = True, strict: bool = True,
                       dla_node: str = "dcn", arch: str = "dlapawdl3new") -> Dict:
    """Load a reference-format state dict of `arch` (a name `_flag_map` maps;
    `module.` prefixes stripped) into `model` in place; returns the report.
    strict raises on a missing or mismatched tensor; else they keep the
    model's values and are listed."""
    sd = _strip(state_dict)

    def unused_filter(k):
        return (not k.startswith(("base.base_layer", "base.repro_hm_layer", "base.fc", "base1.base_layer",
                                  "base1.repro_hm_layer", "base1.fc", "base1.pre_hm_layer"))
                and ".project." not in k.replace("tree1.project", "")
                and not re.search(r"transformer\.\d\.layers\.[12]\.", k)
                and not k.startswith("wh")
                and "num_batches_tracked" not in k)

    return _convert_into(model, sd, _flag_map(dla_node, arch), _BGR_PATHS if bgr_to_rgb else (), strict,
                         unused_filter)


def convert_imagenet_dla34(state_dict: Mapping, model: nn.Module, map_stem: bool = False,
                           strict: bool = True) -> Dict:
    """Load a bare ImageNet DLA-34 state dict (base_layer.*, level0..5.*,
    fc.*) into the model's `base` trunk (map_stem: base_layer also into the
    image stem `pre_img_stem`), in place; every other tensor keeps its
    value. No channel flip (ImageNet weights are RGB). Returns the report."""
    sd = _strip(state_dict)
    m: Mapping_ = {}
    _add_dla_trunk(m, "base", "")
    if map_stem:
        m["pre_img_stem/Conv_0/kernel"] = ("base_layer.0.weight", _conv)
        m["pre_img_stem/BatchNorm_0"] = ("base_layer.1", None)

    def unused_filter(k):
        return (not k.startswith(("fc.", "base_layer."))
                and ".project." not in k.replace("tree1.project", "")
                and ".downsample." not in k and "num_batches_tracked" not in k)

    return _convert_into(model, sd, m, (), strict, unused_filter)


def _export(model: nn.Module, mapping: Mapping_, bgr_paths) -> Dict[str, np.ndarray]:
    flat = {}
    for tree in export_flax_variables(model).values():
        flat.update(_flat_paths(tree))
    sd: Dict[str, np.ndarray] = {}
    for our_path, w in flat.items():
        hit = _resolve(mapping, our_path)
        if hit is None:
            continue
        ref, tf = hit
        if our_path in bgr_paths:
            w = w[:, :, ::-1, :]
        sd[ref] = np.ascontiguousarray((w if tf is None else _INVERSE[tf](w)).astype(np.float32))
    return sd


def export_state_dict(model: nn.Module, dla_node: str = "dcn", arch: str = "dlapawdl3new",
                      bgr_to_rgb: bool = True) -> Dict[str, np.ndarray]:
    """The model as a reference-format state dict of `arch` (the inverse of
    `convert_state_dict`): the tied transformer layers written as
    layers.0/1/2, the image stems flipped back to BGR (bgr_to_rgb); the
    reference's dead tensors are not written."""
    sd = _export(model, _flag_map(dla_node, arch), _BGR_PATHS if bgr_to_rgb else ())
    for name in [k for k in sd if ".layers.0." in k]:
        for i in (1, 2):
            sd[name.replace(".layers.0.", f".layers.{i}.")] = sd[name]
    return sd


def export_imagenet_dla34(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's `base` trunk as a bare ImageNet-format DLA-34 state dict
    (the inverse of `convert_imagenet_dla34` without map_stem)."""
    m: Mapping_ = {}
    _add_dla_trunk(m, "base", "")
    sd = _export(model, m, ())
    if not sd:
        raise ValueError("the model has no `base` DLA-34 trunk")
    return sd


def arch_key(arch: str, ablation_mode: str = "shared_repro") -> str:
    """The mapping's name for a model arch (the wo_shared ablation carries a
    second trunk and maps as dlaabla_wo_shared)."""
    base = arch.split("_")[0]
    return "dlaabla_wo_shared" if base == "dlaabla" and ablation_mode == "wo_shared" else base


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reference .pth ({epoch, state_dict, ...} or a bare state dict) as
    numpy arrays (a trusted file: the whole pickle is loaded, as the
    reference's own loader does)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k: (v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in sd.items()}


def save_torch_checkpoint(path: str, sd: Mapping[str, np.ndarray], epoch: int = 0) -> None:
    """Write a reference-format {epoch, state_dict} .pth."""
    torch.save({"epoch": epoch,
                "state_dict": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}}, path)
