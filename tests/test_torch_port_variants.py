"""Port parity of the arch zoo on the CPU: every variant of
`models/variants.py` and `CenterNetSingle` against its flax module (64x64
input, full channel widths, 7 keypoints), with the same seeded numpy weights
carried through `utils/weights.load_flax_variables`; the loader's strictness
for each; the arch factory; the global variant's index helpers id for id;
the no-bias attention's plain versions against JAX's einsum MHA and its
autodiff.

Bars: heads <= HEAD_ATOL (the flagship's, tests/test_torch_port_model.py);
the index helpers exact; the no-bias attention float32 forward 2e-4 and
backward 1e-5 of max(1, max|ref|), bf16 as tests/test_torch_port_train_bf16.py
holds the biased one, widened for the larger d, where float32 sums of
bf16 products in another order cross bf16 rounding boundaries: the forward
1e-5 of JAX's bf16 or 0.5x its gap to JAX float32, each gradient within
0.3x the gap between JAX bf16 and JAX float32 or one bf16 rounding (2^-8 of
the largest); with a bf16 q where a logit's rounding differs (by one bf16
unit, in under 1 % of logits, checked), each gradient within twice JAX
bf16's gap of JAX float32.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.models import attention as jattn
from sgtapose_tpu.models.sgta import create_model as jax_create_model
from sgtapose_tpu.train.phases import model_inputs as jax_model_inputs
from sgtapose_tpu_torch.models import attention as tattn
from sgtapose_tpu_torch.models import variants
from sgtapose_tpu_torch.models.sgta import CenterNetSingle, SGTAPose, build_model, create_model
from sgtapose_tpu_torch.ops import attention_kernel as tak
from sgtapose_tpu_torch.train.phases import model_inputs as port_model_inputs, model_wiring
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import phase_batch, phase_cfgs, port_cfg, seeded_flax_variables

HEAD_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module: its tests run beside other test
    processes on the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# (id, arch, phase): the phase picks the inputs (and the ablation mode)
CASES = [
    ("global", "dlapa_34", "PlanA"),
    ("window_dense", "dlapawd_34", "PlanA_win"),
    ("cat", "dlapacat_34", "PlanACAT"),
    ("ablation_shared_repro", "dlaabla_34", "ablation_shared_repro"),
    ("ablation_shared", "dlaabla_34", "ablation_shared"),
    ("ablation_wo_shared", "dlaabla_34", "ablation_wo_shared"),
    ("three", "dlapawd3_34", "PlanA_three"),
    ("three_shared_ca", "dlapawd3shared_34", "PlanA_three"),
    ("centertrack", "dlaseg_34", "CenterTrack"),
    ("centernet", "dlaseg_34", "CenterNet"),
]
IDS = [c[0] for c in CASES]


@functools.lru_cache(maxsize=None)
def _flax_case(case_id):
    """(jitted flax apply, numpy variables) of one case (one compile for
    both prior settings)."""
    _, arch, phase = CASES[IDS.index(case_id)]
    jcfg, _, _ = phase_cfgs(arch, phase)
    module = jax_create_model(jcfg)
    inputs = jax_model_inputs(phase, phase_batch(seed=0))
    return jax.jit(module.apply), seeded_flax_variables(module, inputs, seed=IDS.index(case_id))


@functools.lru_cache(maxsize=None)
def _port_model(case_id):
    """The case's port model with the flax variables loaded (read only)."""
    _, arch, phase = CASES[IDS.index(case_id)]
    _, pcfg, tracking = phase_cfgs(arch, phase)
    model = build_model(pcfg, tracking).eval()
    load_flax_variables(model, _flax_case(case_id)[1])
    return model


@pytest.mark.parametrize("zero_priors", [False, True], ids=["priors", "cold"])
@pytest.mark.parametrize("case_id", IDS)
def test_variant_forward_matches_flax(case_id, zero_priors):
    """cold: every prior zero, as on a video's first frame (ties in every
    top-k, duplicate scatter ids)."""
    _, arch, phase = CASES[IDS.index(case_id)]
    apply, variables = _flax_case(case_id)
    batch = phase_batch(seed=3, zero_priors=zero_priors)
    ref = apply(variables, *[jnp.asarray(a) for a in jax_model_inputs(phase, batch)])
    with torch.no_grad():
        out = _port_model(case_id)(*[torch.from_numpy(a) for a in port_model_inputs(phase, batch)])
    for key in ("hm", "reg", "tracking"):
        assert out[key].shape == ref[key].shape, key
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=HEAD_ATOL, err_msg=key)


@pytest.mark.parametrize("case_id", IDS)
def test_variant_loader_is_strict(case_id):
    _, variables = _flax_case(case_id)
    model = _port_model(case_id)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert n_leaves == sum(1 for k in model.state_dict() if not k.endswith("num_batches_tracked"))
    # the loader checks every leaf before it writes one
    before = {k: v.clone() for k, v in model.state_dict().items()}
    short = copy.deepcopy(variables)
    del short["params"]["base"]["level0"]["Conv_0"]["kernel"]
    with pytest.raises(KeyError, match="not set"):
        load_flax_variables(model, short)
    extra = copy.deepcopy(variables)
    extra["params"]["extra_layer"] = {"kernel": np.zeros((4, 4), np.float32)}
    with pytest.raises(KeyError, match="no port tensor"):
        load_flax_variables(model, extra)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_create_model_dispatches_every_arch():
    """Every name of the JAX factory builds its variant on the asked
    device, the DREAM baselines included; an unknown name raises
    ValueError."""
    expect = {"dlapawdl3new_34": SGTAPose, "dlapa_34": variants.SGTAPoseGlobal,
              "dlapawd_34": variants.SGTAPoseWindowDense, "dlaabla_34": variants.SGTAPoseAblation,
              "dlapawd3_34": variants.SGTAPoseThree, "dlapawthree_34": variants.SGTAPoseThree,
              "dlapawd3shared_34": variants.SGTAPoseThree, "dlapacat_34": variants.SGTAPoseCat,
              "dlaseg_34": CenterNetSingle, "centernet_34": CenterNetSingle, "dla_34": CenterNetSingle}
    for arch, cls in expect.items():
        model = build_model(dataclasses.replace(port_cfg(), arch=arch))
        assert type(model) is cls, arch
    assert build_model(dataclasses.replace(port_cfg(), arch="dlapawd3shared_34")).shared_ca
    single = dataclasses.replace(port_cfg(), arch="dlaseg_34")
    assert hasattr(build_model(*model_wiring(single, "CenterTrack")), "pre_hm_stem")
    assert not hasattr(build_model(*model_wiring(single, "CenterNet")), "pre_hm_stem")
    ablation = dataclasses.replace(port_cfg(), arch="dlaabla_34")
    for phase, mode in (("ablation_wo_shared", "wo_shared"), ("ablation_shared", "shared"), ("PlanA", "shared_repro")):
        assert build_model(*model_wiring(ablation, phase)).mode == mode, phase
    for arch, name in (("dreamhourglass_34", "DreamHourglass"), ("resnetsimple_34", "ResnetSimple")):
        assert type(build_model(dataclasses.replace(port_cfg(), arch=arch))).__name__ == name
    with pytest.raises(ValueError, match="unknown arch"):
        build_model(dataclasses.replace(port_cfg(), arch="dlapawglobal_34"))
    with pytest.raises(ValueError, match="ablation_mode"):
        build_model(dataclasses.replace(port_cfg(), arch="dlaabla_34", ablation_mode="both"))
    model = create_model(dataclasses.replace(port_cfg(), arch="dlapa_34"), device="cpu", seed=0)
    assert not model.training and torch.all(model.decoder.hm.Conv_1.bias == port_cfg().prior_bias)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            create_model(dataclasses.replace(port_cfg(), arch="dlapa_34"))


# ------------------------------------------------- the global variant's ids ---


def test_flat_fractions_and_ids_at_every_index():
    """Every flat index of a 480x480 prior (its top-k is all of them, in
    index order) as fractions, then as ids at every level's (Hf, Wf): the
    float32 quotient and product truncate as JAX's do."""
    H = W = 480
    hm = -np.arange(H * W, dtype=np.float32).reshape(1, H, W, 1)
    ref = jattn.topk_flat_fractions(jnp.asarray(hm), H * W)
    port = tattn.topk_flat_fractions(torch.from_numpy(hm), H * W)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    for i in range(6):
        hf = H >> i
        r = np.asarray(jattn.flat_ids_from_fractions(ref, hf, hf))
        p = tattn.flat_ids_from_fractions(port, hf, hf).numpy()
        np.testing.assert_array_equal(p, r, err_msg=str(hf))
    # the quirk is real: at 15x15 some ids differ from an exact idx * 225 // 230400
    exact = (np.arange(H * W, dtype=np.int64) * 225) // (H * W)
    assert (tattn.flat_ids_from_fractions(port, 15, 15).numpy()[0] != exact).any()


@pytest.mark.parametrize("k", [28, 5])
def test_flat_fractions_tie_order(k):
    """A prior that is mostly zero with a few equal blobs: its top 28 are
    mostly ties, which both take lowest index first."""
    rs = np.random.RandomState(k)
    hm = np.zeros((2, 64, 64, 1), np.float32)
    hm[0, 10:13, 20:23] = 1.0
    hm[1, rs.randint(0, 64, 9), rs.randint(0, 64, 9)] = 0.5
    ref = jattn.topk_flat_fractions(jnp.asarray(hm), k)
    port = tattn.topk_flat_fractions(torch.from_numpy(hm), k)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    for hf in (64, 32, 16, 8, 4, 2):
        np.testing.assert_array_equal(tattn.flat_ids_from_fractions(port, hf, hf).numpy(),
                                      np.asarray(jattn.flat_ids_from_fractions(ref, hf, hf)))


# ------------------------------------------------------ no-bias attention ---


def _jax_mha(q, k, v):
    """The JAX default attention without a position bias
    (`sgtapose_tpu/models/attention.py:174-180`, bias None)."""
    energy = jnp.einsum("bhid,bhjd->bhij", q, k) / jnp.sqrt(jnp.float32(q.shape[-1]))
    return jnp.einsum("bhij,bhjd->bhid", jax.nn.softmax(energy, axis=-1), v)


def _gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("d", [4, 8, 16, 32, 64, 128])
def test_nobias_attention_float32_matches_jax(d):
    rs = np.random.RandomState(d)
    q, k, v, g = (rs.randn(2, 8, 28, d).astype(np.float32) for _ in range(4))
    out, vjp = jax.vjp(_jax_mha, *(jnp.asarray(a) for a in (q, k, v)))
    ref = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o = tak.plain_biased_attention(tq, tk, tv, None)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=2e-4)
    got = tak.plain_biased_attention_backward(tq, tk, tv, None, o, torch.from_numpy(g))
    assert got[3] is None
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        r = np.asarray(r)
        assert np.abs(a.numpy() - r).max() <= 1e-5 * max(1.0, np.abs(r).max()), name
    # the autograd Function routes bias None to the plain versions on the CPU
    leaves = [t.detach().clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(tak.fused_biased_attention(*leaves, None), leaves, torch.from_numpy(g))
    for a, b in zip(got, auto):
        assert torch.equal(a, b)


@pytest.mark.parametrize("q_bf16", [True, False], ids=["q_bf16", "q_f32"])
@pytest.mark.parametrize("d", [4, 8, 16, 32, 64, 128])
def test_nobias_attention_bf16_matches_jax(d, q_bf16):
    rs = np.random.RandomState(50 + d)
    q, k, v, g = (rs.randn(2, 8, 28, d).astype(np.float32) for _ in range(4))
    qj = jnp.asarray(q).astype(jnp.bfloat16 if q_bf16 else jnp.float32)
    kj, vj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (k, v))
    out, vjp = jax.vjp(_jax_mha, qj, kj, vj)
    ref = vjp(jnp.asarray(g))
    ref32 = jax.vjp(_jax_mha, *(jnp.asarray(a) for a in (q, k, v)))[1](jnp.asarray(g))
    tq = torch.from_numpy(_np(qj).copy()).to(torch.bfloat16 if q_bf16 else torch.float32)
    tk, tv = (torch.from_numpy(_np(a).copy()).to(torch.bfloat16) for a in (kj, vj))
    o = tak.plain_biased_attention_bf16(tq, tk, tv, None)
    # with a bf16 q the q.k logit is rounded to bf16, and a float32 sum in
    # another order can fall on the other side of a rounding (a logit moves
    # by one bf16 unit): half the forward's own gap to float32 (measured
    # up to 0.43x at d = 64)
    gap_fwd = _gap(_np(out), np.asarray(_jax_mha(*(jnp.asarray(a) for a in (q, k, v)))))
    assert o.dtype == torch.float32 and _gap(o.numpy(), _np(out)) <= max(1e-5, 0.5 * gap_fwd)
    got = tak.plain_biased_attention_backward_bf16(tq, tk, tv, None, o, torch.from_numpy(g))
    assert got[3] is None
    flipped = False
    if q_bf16:
        # the bf16 logits: the same but where float32 sums in another order
        # fall on the other side of a rounding, by one bf16 unit, in few
        # places; a row with such a logit moves its gradients by as much as
        # bf16 itself does, so the bar there is the gap itself
        lj = _np(jnp.einsum("bhid,bhjd->bhij", qj, kj))
        lt = torch.einsum("bhid,bhjd->bhij", tq.float(), tk.float()).to(torch.bfloat16).float().numpy()
        diff = lj != lt
        assert diff.mean() < 0.01
        assert (np.abs(lj - lt)[diff] <= 2.0 ** -7 * np.abs(lj)[diff]).all()
        flipped = bool(diff.any())
    for name, a, r, r32 in zip(("dq", "dk", "dv"), got, ref, ref32):
        assert str(a.dtype).replace("torch.", "") == str(r.dtype), name
        gap = _gap(_np(r), np.asarray(r32))
        assert gap > 1e-3, name  # bf16 did round
        if flipped:
            # held to float32 as JAX's bf16 is: within twice its gap
            assert _gap(a.float().numpy(), np.asarray(r32)) <= 2 * gap, name
            continue
        # each output is rounded once to bf16, after float32 sums in another
        # order: one rounding may differ (2^-8 of the largest), which is
        # most of the gap where only that rounding separates bf16 from
        # float32 (dv with a float32 q)
        bar = max(0.3 * gap, 2.0 ** -8)
        assert _gap(a.float().numpy(), _np(r)) <= bar, (name, _gap(a.float().numpy(), _np(r)), gap)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_kernel_check_takes_a_bias_up_to_head_dim_32(bf16):
    """The kernels' argument check, run before every launch: the global
    variant's head dims 64 and 128 take no bias (no model runs a biased
    attention there); up to 32 a bias passes."""
    dt = torch.bfloat16 if bf16 else torch.float32
    for d in (4, 8, 16, 32, 64, 128):
        q = torch.zeros(1, 8, 28, d)
        kv, bias = q.to(dt), torch.zeros(8, 28, 28, dtype=dt)
        tak._check(q, kv, kv, None, bf16=bf16)
        if d <= tak.BIASED_HEAD_DIM_MAX:
            tak._check(q, kv, kv, bias, bf16=bf16)
        else:
            with pytest.raises(ValueError, match="up to 32"):
                tak._check(q, kv, kv, bias, bf16=bf16)
