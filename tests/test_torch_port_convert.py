"""Port parity of checkpoint conversion on the CPU (`utils/torch_convert.py`,
`cli/convert.py`), from state dicts the JAX package's exporters write from
seeded flax variables (no reference checkout):

  * for every arch JAX's `_flag_map` maps, and both dla_nodes of the
    flagship, the port's `convert_state_dict` of JAX's `export_state_dict`
    sets the port's model bit for bit as `load_flax_variables` does from the
    same tree, with JAX's report;
  * the port's `export_state_dict` read by JAX's `convert_state_dict`
    returns the flax tree bit for bit;
  * the BGR flip and the `module.` prefix, the strict default and the
    lenient report, as JAX;
  * `convert_imagenet_dla34` (with and without map_stem) against JAX's on
    one `export_imagenet_dla34` dict, and the port's export of it;
  * `cli/convert.py`: port checkpoint -> .pth -> port checkpoint, equal
    forwards; and the migration route: a JAX orbax train state -> JAX's
    `cli.convert --out_pth` -> the port's `cli.convert --torch_ckpt` -> the
    port's forward equals the JAX forward (HEAD_ATOL).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from sgtapose_tpu.models.sgta import create_model as jax_create_model
from sgtapose_tpu.train.phases import model_inputs as jax_model_inputs
from sgtapose_tpu.utils import torch_convert as jtc
from sgtapose_tpu_torch.cli import convert as tconv
from sgtapose_tpu_torch.models.sgta import build_model
from sgtapose_tpu_torch.train import trainer as ttrainer
from sgtapose_tpu_torch.train.phases import model_inputs as port_model_inputs
from sgtapose_tpu_torch.utils import torch_convert as ttc
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import jax_cfg, phase_batch, phase_cfgs, seeded_flax_variables

HEAD_ATOL = 1e-3
TINY_KERNELS = ["--kernel_list", "3,3,3,1,1,1"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module: its tests run beside other test
    processes on the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
# (mapping name, arch, dla_node, phase)
CASES = [("dlapawdl3new", "dlapawdl3new_34", "dcn", "PlanA_win"),
         ("dlapawdl3new", "dlapawdl3new_34", "conv", "PlanA_win"),
         ("dlapa", "dlapa_34", "dcn", "PlanA"), ("dlapawd", "dlapawd_34", "dcn", "PlanA_win"),
         ("dlapacat", "dlapacat_34", "dcn", "PlanACAT"), ("dlaabla", "dlaabla_34", "dcn", "ablation_shared_repro"),
         ("dlaabla_wo_shared", "dlaabla_34", "dcn", "ablation_wo_shared")]
IDS = [f"{c[0]}-{c[2]}" for c in CASES]


@functools.lru_cache(maxsize=None)
def _case(case_id):
    """(flax variables, port config) of one case."""
    key, arch, node, phase = CASES[IDS.index(case_id)]
    jcfg, pcfg, _ = phase_cfgs(arch, phase, dla_node=node)
    module = jax_create_model(jcfg)
    variables = seeded_flax_variables(module, jax_model_inputs(phase, phase_batch()), seed=IDS.index(case_id))
    return variables, pcfg


def _port(case_id, variables=None):
    """A new port model of the case: the case's flax variables loaded, or
    `variables`, or (False) none."""
    variables_, pcfg = _case(case_id)
    model = build_model(pcfg)
    if variables is not False:
        load_flax_variables(model, variables if variables is not None else variables_)
    return model


@functools.lru_cache(maxsize=None)
def _loaded(case_id):
    """`_port(case_id)`, built once (read only)."""
    return _port(case_id)


def _equal_models(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    return [k for k in sa if not torch.equal(sa[k], sb[k])]


@pytest.mark.parametrize("case_id", IDS)
def test_convert_matches_load_flax_variables(case_id):
    key, _, node, _ = CASES[IDS.index(case_id)]
    variables, _ = _case(case_id)
    sd = jtc.export_state_dict(variables["params"], variables["batch_stats"], dla_node=node, arch=key)
    model = _port(case_id, variables=False)
    report = ttc.convert_state_dict({"module." + k: v for k, v in sd.items()}, model, dla_node=node, arch=key)
    assert _equal_models(model, _loaded(case_id)) == []
    _, _, ref = jtc.convert_state_dict(sd, variables["params"], variables["batch_stats"], dla_node=node, arch=key)
    assert report == ref
    assert report["n_converted"] == len(sd) - sum(".layers.1." in k or ".layers.2." in k for k in sd)
    assert not report["missing"] and not report["mismatched"] and not report["unused_ref_keys"]


@pytest.mark.parametrize("case_id", IDS)
def test_export_reads_back_in_jax(case_id):
    key, _, node, _ = CASES[IDS.index(case_id)]
    variables, _ = _case(case_id)
    sd = ttc.export_state_dict(_loaded(case_id), dla_node=node, arch=key)
    assert set(sd) == set(jtc.export_state_dict(variables["params"], variables["batch_stats"], dla_node=node,
                                                 arch=key))
    params, stats, report = jtc.convert_state_dict(sd, variables["params"], variables["batch_stats"],
                                                   dla_node=node, arch=key)
    for a, b in zip(jax.tree_util.tree_leaves((params, stats)),
                    jax.tree_util.tree_leaves((variables["params"], variables["batch_stats"]))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not report["missing"] and not report["mismatched"]


def test_bgr_flip_prefix_strict_and_lenient():
    case_id = "dlaabla_wo_shared-dcn"  # two 3-channel image stems
    variables, _ = _case(case_id)
    sd = jtc.export_state_dict(variables["params"], variables["batch_stats"], arch="dlaabla_wo_shared",
                               bgr_to_rgb=False)
    model = _port(case_id, variables=False)
    ttc.convert_state_dict(sd, model, bgr_to_rgb=False, arch="dlaabla_wo_shared")
    assert _equal_models(model, _loaded(case_id)) == []
    flipped = _port(case_id, variables=False)
    ttc.convert_state_dict(sd, flipped, arch="dlaabla_wo_shared")  # the default flips BGR -> RGB
    for stem in ("pre_img_stem", "cur_img_stem"):
        w, f = getattr(model, stem).Conv_0.weight, getattr(flipped, stem).Conv_0.weight
        assert torch.equal(f, w.flip(1))
    assert torch.equal(flipped.pre_hm_stem.Conv_0.weight, model.pre_hm_stem.Conv_0.weight)

    bad = dict(sd)
    del bad["hm.0.weight"]
    bad["reg.2.bias"] = np.zeros(3, np.float32)
    bad["extra.weight"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="conversion incomplete"):
        ttc.convert_state_dict(bad, _port(case_id, variables=False), arch="dlaabla_wo_shared", bgr_to_rgb=False)
    lenient = _port(case_id, variables=False)
    before = lenient.state_dict()["decoder.hm.Conv_0.weight"].clone()
    report = ttc.convert_state_dict(bad, lenient, arch="dlaabla_wo_shared", bgr_to_rgb=False, strict=False)
    _, _, ref = jtc.convert_state_dict(bad, variables["params"], variables["batch_stats"], arch="dlaabla_wo_shared",
                                       bgr_to_rgb=False, strict=False)
    assert report == ref
    assert report["missing"] == [("decoder/hm/Conv_0/kernel", "hm.0.weight")]
    assert [m[:2] for m in report["mismatched"]] == [("decoder/reg/Conv_1/bias", "reg.2.bias")]
    assert report["unused_ref_keys"] == ["extra.weight", "reg.2.bias"]  # a mismatched tensor is unused too
    assert torch.equal(lenient.state_dict()["decoder.hm.Conv_0.weight"], before)  # kept
    with pytest.raises(ValueError, match="no converter mapping"):
        ttc.convert_state_dict(sd, lenient, arch="dlapawd3")


@pytest.mark.parametrize("map_stem", [False, True], ids=["trunk", "trunk_and_stem"])
def test_imagenet_dla34_matches_jax(map_stem):
    donor, _ = _case("dlapa-dcn")
    sd = jtc.export_imagenet_dla34(donor["params"], donor["batch_stats"])
    sd["base_layer.0.weight"] = np.random.RandomState(3).randn(16, 3, 7, 7).astype(np.float32)
    for k in ("weight", "bias", "running_mean", "running_var"):
        sd[f"base_layer.1.{k}"] = np.random.RandomState(4).rand(16).astype(np.float32)
    sd["fc.weight"] = np.zeros((1000, 512, 1, 1), np.float32)
    variables, _ = _case("dlapawdl3new-dcn")
    params, stats, ref = jtc.convert_imagenet_dla34(sd, variables["params"], variables["batch_stats"],
                                                    map_stem=map_stem)
    model = _port("dlapawdl3new-dcn")
    report = ttc.convert_imagenet_dla34(sd, model, map_stem=map_stem)
    assert report == ref
    assert _equal_models(model, _port("dlapawdl3new-dcn", {"params": params, "batch_stats": stats})) == []
    assert set(ttc.export_imagenet_dla34(model)) == {k for k in sd if not k.startswith(("fc.", "base_layer."))}
    for k, v in ttc.export_imagenet_dla34(model).items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)


def test_cli_convert_round_trip(tmp_path):
    """A port checkpoint -> .pth -> a port checkpoint: the same tensors and
    the same forward; a directory as --ckpt names JAX's converter; the
    default device is the card (no CPU fallback)."""
    args = ["--arch", "dlapa_34", "--device", "cpu"] + TINY_KERNELS
    state = tconv.template_state(tconv.parse_args(args))
    variables, _ = _case("dlapa-dcn")
    load_flax_variables(state.model, variables)
    state.step = 12
    ckpt, pth, back = (str(tmp_path / n) for n in ("a.pt", "a.pth", "b.pt"))
    ttrainer.save_checkpoint(ckpt, state)
    tconv.main(["--ckpt", ckpt, "--out_pth", pth] + args)
    blob = torch.load(pth, weights_only=True)
    assert blob["epoch"] == 12 and "transformer.5.layers.2.cross_attn.w_q.weight" in blob["state_dict"]
    report = tconv.main(["--torch_ckpt", pth, "--out", back] + args)
    assert report["n_converted"] > 0 and not report["missing"] and report["device"] == "cpu"
    model = _port("dlapa-dcn", variables=False)
    model.load_state_dict(torch.load(back, weights_only=True)["model"])
    assert _equal_models(model.eval(), _loaded("dlapa-dcn")) == []
    batch = phase_batch(seed=9)
    with torch.no_grad():
        a = model(*[torch.from_numpy(x) for x in port_model_inputs("PlanA", batch)])
        b = _loaded("dlapa-dcn").eval()(*[torch.from_numpy(x) for x in port_model_inputs("PlanA", batch)])
    for k in a:
        assert torch.equal(a[k], b[k])
    (tmp_path / "orbax").mkdir()
    with pytest.raises(SystemExit, match="sgtapose_tpu.cli.convert"):
        tconv.main(["--ckpt", str(tmp_path / "orbax"), "--out_pth", pth] + args)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cuda'"):
            tconv.main(["--torch_ckpt", pth, "--out", back, "--arch", "dlapa_34"] + TINY_KERNELS)


def test_migration_route_from_a_jax_checkpoint(tmp_path, monkeypatch):
    """An orbax train state of the JAX package -> JAX's `cli.convert
    --out_pth` -> the port's `cli.convert --torch_ckpt` -> `cli/infer.py`'s
    model loader; the port's forward equals the JAX forward."""
    pytest.importorskip("orbax.checkpoint")
    import jax.numpy as jnp

    from sgtapose_tpu.cli import convert as jconv
    from sgtapose_tpu.train import trainer as jtrainer
    from sgtapose_tpu_torch.cli import infer as tinfer

    import optax

    args = ["--arch", "dlapa_34"] + TINY_KERNELS
    variables, pcfg = _case("dlapa-dcn")

    def template(_args):
        """The JAX CLI's template train state, built from the seeded tree
        (its own flax init of the model runs op by op for about a minute on
        this CPU; the tree's shapes are the same)."""
        tx = optax.adam(1e-3)
        return jtrainer.TrainState(step=jnp.int32(0), params=variables["params"],
                                   batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
                                   apply_fn=None, tx=tx)

    monkeypatch.setattr(jconv, "_template_state", template)
    jstate = template(None)
    orbax_dir, pth, ckpt = (str(tmp_path / n) for n in ("orbax", "x.pth", "c.pt"))
    jtrainer.save_checkpoint(orbax_dir, jstate)
    oargs = tinfer.parse_args(["--dataset", ".", "--ckpt", orbax_dir, "--arch", "dlapa_34", "--phase", "PlanA",
                               "--device", "cpu"] + TINY_KERNELS)
    with pytest.raises(NotImplementedError, match="sgtapose_tpu.cli.convert --ckpt"):
        tinfer.load_model(oargs, tinfer.make_config(oargs), torch.device("cpu"))
    jconv.main(["--ckpt", orbax_dir, "--out_pth", pth] + args)
    tconv.main(["--torch_ckpt", pth, "--out", ckpt, "--device", "cpu"] + args)
    iargs = tinfer.parse_args(["--dataset", ".", "--ckpt", ckpt, "--arch", "dlapa_34", "--phase", "PlanA",
                               "--input_res", "64", "--device", "cpu"] + TINY_KERNELS)
    model = tinfer.load_model(iargs, tinfer.make_config(iargs), torch.device("cpu"))
    batch = phase_batch(seed=11)
    ref = jax.jit(jax_create_model(dataclasses.replace(jax_cfg(), arch="dlapa_34")).apply)(
        variables, *[jnp.asarray(x) for x in jax_model_inputs("PlanA", batch)])
    with torch.no_grad():
        out = model(*[torch.from_numpy(x) for x in port_model_inputs("PlanA", batch)])
    for k in ("hm", "reg", "tracking"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=HEAD_ATOL, err_msg=k)
