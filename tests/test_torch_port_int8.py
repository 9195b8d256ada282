"""Port parity: int8 serving and quantization-aware training
(`sgtapose_tpu_torch/models/layers.py`, `ops/int8_conv.py`) against the
JAX package's `models/layers.py` on the CPU, on the same numpy inputs.

1. Each quantizable site kind (1x1; 3x3 at stride 1 and 2; 7x7 with C_in 3
   and the heatmap stem's 1; the DCN's 1x1 over its 9C columns), with and
   without bias, float32 and bf16, dynamic and static scales: the port's
   x_q, w_q, int32 accumulators (`plain_int8_conv`, exact) and outputs
   against flax's `layers.Conv` under `quantized("int8")` and JAX's own
   s8 x s8 -> s32 conv, bit for bit.
2. `calibrate` over the tiny SGTAPose: the same 57 sites and maxima (1e-6
   relative; maxima are exact, so only the float forward's rounding before a
   site can move them).
3. The tiny SGTAPose under "int8": dynamic, static, min_ch 64 and an
   impossible min_ch (the float output exactly, on both sides). The trunk's
   six levels within 1e-4 of JAX's (float32 rounding: no x_q of these
   inputs lies near a rounding boundary there). The heads are held against
   JAX's own int8-vs-float gap on the same inputs (max ~3e-3 here, mean
   ~7e-4; JAX bounds the max by 0.05 in tests/test_model.py): in the
   decoder, where the DCN's sampling adds float32 differences of 1e-6, an
   activation within 1e-6 of a rounding boundary moves its x_q by one step
   (~1e-3 at that site's output), which moves later sites' inputs further
   (2 x_q of 147456 differ at the first 16x16 DCN, 2350 at the fourth), so
   at the heads the two int8 outputs are two draws of the same quantization
   noise. Bars: the port's own mean gap within 0.8-1.25x JAX's (the same
   noise: measured 0.97-1.0x), the port against JAX within 1.5x JAX's max
   gap (measured up to 1.1x) and within JAX's mean gap on average
   (measured 0.5-0.75x).
4. One "int8_train" step (dropout off): loss terms and every gradient
   against JAX's. In train mode the two differ far beyond the float32
   step's bars (tests/test_torch_port_train.py): train-mode BatchNorm on
   2x2-16x16 maps amplifies float32 rounding, and the fake quantization
   turns each difference that crosses a rounding boundary into a whole step
   (JAX's own QAT gradient is 1.46 of the norm from its float one there).
   So the step is compared with BatchNorm in eval mode, as the bf16 step
   tests do: loss terms within the float32 bar (1e-4 relative) or a
   quarter of JAX's own QAT-vs-float gap of that term (reg: measured 0.11x);
   gradients in L2 within the float32 bar, 0.03, and 0.8x JAX's QAT gap
   (0.033; measured 0.71x), which the port's float step (1.0x) fails; the
   worst tensor, relative to its largest gradient, within JAX's own worst
   QAT-vs-float tensor (0.57; measured 0.42).
"""

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax

from sgtapose_tpu.models import layers as jlayers
from sgtapose_tpu.train import loss as jloss, schedule as jsched, trainer as jtrainer
from sgtapose_tpu.train.phases import loss_weights as jax_loss_weights
from sgtapose_tpu_torch.config import Config as PortConfig
from sgtapose_tpu_torch.models import dla as tdla, layers as tlayers
from sgtapose_tpu_torch.models.attention import set_dropout_rate
from sgtapose_tpu_torch.models.sgta import SGTAPose
from sgtapose_tpu_torch.ops import int8_conv as tint8
from sgtapose_tpu_torch.train import schedule as tsched, trainer as ttrainer
from sgtapose_tpu_torch.utils import weights as tweights
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import (adam_state, flax_model_and_variables, model_inputs, no_dropout, port_cfg,
                               random_train_batch, train_variables)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# (C_in, C_out, kernel, stride) of each site kind; "dcn" is the DCN's 1x1
# contraction over (B, H, W, 9C) columns of C = 16
SITES = {"1x1": (64, 48, 1, 1), "3x3": (16, 32, 3, 1), "3x3_s2": (32, 64, 3, 2), "7x7_c3": (3, 16, 7, 1),
         "7x7_c1": (1, 16, 7, 1), "dcn": (144, 24, 1, 1)}


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("kind", list(SITES))
def test_int8_site_matches_jax(kind, bias, dtype, static):
    C, O, k, s = SITES[kind]
    pad = k // 2
    rs = np.random.RandomState(len(kind) * 7 + C)
    x = rs.randn(2, 11, 13, C).astype(np.float32)
    w = (rs.randn(k, k, C, O) / np.sqrt(k * k * C)).astype(np.float32)
    b = (0.1 * rs.randn(O)).astype(np.float32)
    # a static max below the data's: clipping at +-127 engages
    a_max = float(np.abs(x).max()) * 0.8 if static else None
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    jx, jw, jb = (jnp.asarray(a).astype(jdt) for a in (x, w, b))

    mod = jlayers.Conv(O, kernel_size=(k, k), strides=(s, s), padding=pad, use_bias=bias, dtype=jdt,
                       param_dtype=jdt)
    params = {"kernel": jw, **({"bias": jb} if bias else {})}
    with jlayers.quantized("int8", scales=None if a_max is None else [a_max]):
        ref = np.asarray(mod.apply({"params": params}, jx).astype(jnp.float32))
    dn = lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    jx_q, jw_q, *_ = jlayers._quantize_operands(jx, jw, dn, a_max=a_max)
    ref_acc = np.asarray(lax.conv_general_dilated(
        jx_q.astype(jnp.int8), jw_q.astype(jnp.int8), (s, s), [(pad, pad)] * 2, dimension_numbers=dn,
        preferred_element_type=jnp.int32))

    tx = _t(x).to(tdt)  # NHWC
    tw = _t(w).permute(3, 2, 0, 1).contiguous().to(tdt)  # (O, C, kh, kw)
    tb = _t(b).to(tdt) if bias else None
    owner = torch.nn.Module()
    with torch.no_grad(), tlayers.quantized("int8", scales=None if a_max is None else [a_max]):
        action, site_max = tlayers.take_site(O, C)
        assert action == "int8" and site_max == a_max
        if kind == "dcn":  # the DCN's site: a (9C -> O) linear weight over NHWC columns
            out = tlayers.quantized_linear(owner, tx, tw.reshape(O, C), tb, action, a_max)
        else:
            conv = tlayers.Conv2d(C, O, k, s, pad, bias=bias).to(tdt)
            conv.weight.copy_(tw)
            if bias:
                conv.bias.copy_(tb)
            tlayers._MODE["i"] = 0  # the module consumes the site's scale itself
            out = conv(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            owner = conv
    np.testing.assert_array_equal(out.to(torch.float32).numpy(), ref)
    assert out.dtype == tdt

    # the operands and the accumulators
    x_q, w_q, *_ = tlayers._quantize_operands(tx, tw.permute(0, 2, 3, 1), a_max)
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(jx_q))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q).transpose(3, 0, 1, 2))
    qw = tlayers._cached_weight(owner, tw if kind != "dcn" else tw.reshape(O, C), k, k)
    np.testing.assert_array_equal(qw.unpacked().numpy(), np.asarray(jw_q).transpose(3, 0, 1, 2))
    a_scale = tlayers.activation_scale(tx, a_max)
    out2, acc = tint8.plain_int8_conv(x_q.to(torch.int8), qw, a_scale, tb, s, pad, tdt, return_acc=True)
    np.testing.assert_array_equal(acc.numpy(), ref_acc)
    np.testing.assert_array_equal(out2.to(torch.float32).numpy(), ref)


def test_int8_conv_cuda_rejects_cpu_tensors_and_the_weight_cache_follows_the_weight():
    qw = tint8.pack_weight(torch.ones(4, 3, 3, 8), torch.ones(4))
    assert qw.q.shape == (4, 96) and qw.q[:, 72:].abs().sum() == 0  # K = 72 padded to 96
    with pytest.raises(ValueError):
        tint8.int8_conv_cuda(torch.zeros(1, 5, 5, 8, dtype=torch.int8), qw, torch.ones(1), None, 1, 1,
                             torch.float32)
    conv = tlayers.Conv2d(8, 4, 3, padding=1, bias=False)
    first = tlayers._cached_weight(conv, conv.weight, 3, 3)
    assert tlayers._cached_weight(conv, conv.weight, 3, 3) is first
    with torch.no_grad():
        conv.weight.mul_(2.0)  # an optimizer step or load_state_dict modifies the weight in place
    second = tlayers._cached_weight(conv, conv.weight, 3, 3)
    assert second is not first and torch.equal(second.q, first.q) and torch.equal(second.scale, 2 * first.scale)


def test_quant_modes_and_the_gate_bookkeeping():
    with pytest.raises(ValueError):
        tlayers.quantized("fp4").__enter__()
    assert tlayers.quant_mode() is None
    wrapped = tlayers.quantized_apply(lambda: (tlayers.quant_mode(), tlayers.take_site(16, 16)), "int8",
                                      scales=[1.0, 2.0], min_ch=32)
    # a gated site runs float but consumes its scale (so one calibration serves any min_ch)
    assert wrapped() == ("int8", (None, None)) and tlayers.quant_mode() is None
    with tlayers.quantized("int8", scales=[1.0, 2.0], min_ch=32) as st:
        assert tlayers.take_site(16, 64) == (None, None) and tlayers.take_site(32, 288) == ("int8", 2.0)
        assert st["i"] == 2
    with tlayers.quantized("int8_train", min_ch=32):
        assert tlayers.take_site(64, 64) == ("fake", None)
    assert tlayers.quant_mode() is None


def _port_model(variables):
    model = SGTAPose(port_cfg("dcn")).eval()
    load_flax_variables(model, variables)
    return model


def _jax_site_maxima(flax_model, variables, inputs):
    """The per-site max|x| of one JAX forward under "int8_calib" (what
    `calibrate` records on each call), from one jitted trace."""

    def run(*a):
        with jlayers.quantized("int8_calib") as st:
            flax_model.apply(variables, *a)
            return list(st["record"])

    return np.asarray(jax.jit(run)(*[jnp.asarray(a) for a in inputs]))


def test_calibrate_matches_jax():
    flax_model, variables = flax_model_and_variables("dcn")
    inputs = [model_inputs(seed) for seed in (0, 1)]
    ref = np.maximum(*(_jax_site_maxima(flax_model, variables, a) for a in inputs))
    model = _port_model(variables)
    port = tlayers.calibrate(model, [tuple(_t(a) for a in inp) for inp in inputs])
    assert len(port) == len(ref) == 57  # 38 trunk convs, 16 DCN contractions, 3 head 3x3s
    np.testing.assert_allclose(port, ref, rtol=1e-6)
    assert tlayers.quant_mode() is None
    sites = iter([1, 2])

    def unstable():
        for _ in range(next(sites)):
            tlayers.record(torch.ones(1))

    with pytest.raises(ValueError, match="call-order stable"):
        tlayers.calibrate(unstable, [(), ()])


@pytest.fixture(scope="module")
def model_case():
    flax_model, variables = flax_model_and_variables("dcn")
    inputs = model_inputs(3)
    model = _port_model(variables)
    scales = tlayers.calibrate(model, [tuple(_t(a) for a in model_inputs(s)) for s in (0, 1)])
    jin = [jnp.asarray(a) for a in inputs]
    ref_f = jax.jit(lambda v, *a: flax_model.apply(v, *a))(variables, *jin)
    with torch.no_grad():
        port_f = model(*[_t(a) for a in inputs])
    return flax_model, variables, model, inputs, scales, ref_f, port_f


@pytest.mark.parametrize("static,min_ch", [(False, 0), (True, 0), (True, 64), (True, 10 ** 9)],
                         ids=["dynamic", "static", "static_min_ch64", "static_gate_all"])
def test_model_int8_matches_jax(model_case, static, min_ch):
    flax_model, variables, model, inputs, scales, ref_f, port_f = model_case
    scales = scales if static else None
    apply = jlayers.quantized_apply(lambda v, *a: flax_model.apply(v, *a), "int8", scales=scales, min_ch=min_ch)
    ref_q = jax.jit(apply)(variables, *[jnp.asarray(a) for a in inputs])
    port_apply = tlayers.quantized_apply(model, "int8", scales=scales, min_ch=min_ch)
    with torch.no_grad():
        port_q = port_apply(*[_t(a) for a in inputs])
    for key in ("hm", "reg", "tracking"):
        rq, rf = np.asarray(ref_q[key]), np.asarray(ref_f[key])
        pq, pf = port_q[key].numpy(), port_f[key].numpy()
        if min_ch == 10 ** 9:  # nothing quantized: the float forward exactly
            np.testing.assert_array_equal(pq, pf)
            np.testing.assert_array_equal(rq, rf)
            continue
        gap, mean_gap, port_gap = np.abs(rq - rf).max(), np.abs(rq - rf).mean(), np.abs(pq - pf).mean()
        assert 0 < gap < 0.05 and 0.8 * mean_gap <= port_gap <= 1.25 * mean_gap, (key, mean_gap, port_gap)
        err = np.abs(pq - rq)
        assert err.max() <= 1.5 * gap and err.mean() <= mean_gap, (key, err.max(), gap, err.mean(), mean_gap)
    if min_ch == 64:  # a different subset of sites from min_ch 0, within the same error
        with torch.no_grad():
            port_all = tlayers.quantized_apply(model, "int8", scales=scales)(*[_t(a) for a in inputs])
        assert any((port_all[k] != port_q[k]).any() for k in port_q)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_trunk_int8_matches_jax(model_case, static):
    """The trunk's sites alone (38 of them, one batch of [pre; cur] as in
    the exact runner): its six levels against JAX's within 1e-4."""
    from sgtapose_tpu.models.sgta import SGTAPose as JaxSGTAPose

    flax_model, variables, model, inputs, scales, _, _ = model_case
    scales = scales if static else None
    imgs = np.concatenate([inputs[1], inputs[0]])
    hms = np.concatenate([inputs[2], inputs[3]])
    ref = jax.jit(jlayers.quantized_apply(lambda v, *a: flax_model.apply(v, *a, method=JaxSGTAPose.trunk),
                                          "int8", scales=scales))(variables, jnp.asarray(imgs), jnp.asarray(hms))
    with torch.no_grad(), tlayers.quantized("int8", scales=scales) as st:
        port = model.trunk(_t(imgs), _t(hms))
        assert st["i"] == (38 if static else 0)
    for r, p in zip(ref, port):
        assert np.abs(p.numpy() - np.asarray(r)).max() <= 1e-4


def test_int8_train_step_matches_jax(monkeypatch):
    """One "int8_train" step of the tiny model, dropout off, BatchNorm in
    eval mode (module docstring): JAX's loss and gradients under
    `quantized("int8_train")` and without (the gap), the port's
    `train_step` under the same context and without."""
    LR, MAX_ITERS, WARMUP, ADAM_COUNT, SCHED_COUNT = 1e-3, 20, 4, 5, 7
    flax_model, variables = train_variables()
    tx = optax.adam(jsched.warmup_poly_schedule(LR, MAX_ITERS, WARMUP))
    mu, nu = adam_state(variables["params"])
    adam, sched = tx.init(variables["params"])
    opt_state = (adam._replace(count=jnp.int32(ADAM_COUNT), mu=mu, nu=nu),
                 sched._replace(count=jnp.int32(SCHED_COUNT)))
    state = jtrainer.TrainState(step=jnp.int32(SCHED_COUNT), params=variables["params"],
                                batch_stats=variables["batch_stats"], opt_state=opt_state,
                                apply_fn=flax_model.apply, tx=tx)
    batch = random_train_batch(5)

    def step(params, batch):
        def loss_fn(params):
            out, _ = jtrainer.model_forward(state, params, batch, train=False,
                                            rngs={"dropout": jax.random.PRNGKey(0)})
            total, stats = jloss.sgta_loss({k: v.astype(jnp.float32) for k, v in out.items()}, batch,
                                           **jax_loss_weights("PlanA_win"))
            return total, stats

        (_, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return stats, grads

    def both(params, batch):  # the float step and the int8_train step in one trace
        float_step = step(params, batch)
        with jlayers.quantized("int8_train"):
            return float_step, step(params, batch)

    with fnn.intercept_methods(no_dropout):
        jax_f, jax_q = jax.tree_util.tree_map(
            np.asarray, jax.jit(both)(state.params, {k: jnp.asarray(v) for k, v in batch.items()}))

    monkeypatch.setattr(tdla.BatchNorm, "train", lambda self, mode=True: torch.nn.Module.train(self, False))
    port = {}
    for quant in (False, True):
        pstate = ttrainer.create_train_state(PortConfig(model=port_cfg("dcn")), seed=0, max_iters=MAX_ITERS,
                                             device="cpu",
                                             schedule=tsched.warmup_poly_schedule(LR, MAX_ITERS, WARMUP))
        tweights.load_flax_train_state(pstate, {
            "params": variables["params"], "batch_stats": variables["batch_stats"], "mu": mu, "nu": nu,
            "adam_count": ADAM_COUNT, "schedule_count": SCHED_COUNT, "step": SCHED_COUNT})
        set_dropout_rate(pstate.model, 0.0)
        with tlayers.quantized("int8_train") if quant else contextlib.nullcontext():
            stats = ttrainer.train_step(pstate, {k: _t(v) for k, v in batch.items()})
        named = dict(pstate.model.named_parameters())
        port[quant] = (stats, {k: p.grad.numpy() for k, p in named.items() if p.grad is not None})
    ref_q = tweights._convert(pstate.model, {"params": jax_q[1]}, named)
    ref_f = tweights._convert(pstate.model, {"params": jax_f[1]}, named)
    live = [k for k, g in ref_q.items() if np.abs(g).max() > 1e-7]

    def l2(a, b):
        num = sum(((a[k] - b[k]).astype(np.float64) ** 2).sum() for k in live)
        return np.sqrt(num / sum((b[k].astype(np.float64) ** 2).sum() for k in live))

    for k in ("tot", "hm", "reg", "tracking"):
        r, gap = np.float64(jax_q[0][k]), abs(np.float64(jax_q[0][k]) - np.float64(jax_f[0][k]))
        err = abs(port[True][0][k].item() - r)
        assert err <= 1e-4 * abs(r) or err <= 0.25 * gap, (k, err, r, gap)
    gap = l2(ref_f, ref_q)
    assert l2(port[True][1], ref_q) <= min(0.03, 0.8 * gap), (l2(port[True][1], ref_q), gap)
    assert l2(port[False][1], ref_q) > 0.8 * gap  # the control: the port's float step fails the bar
    worst = max((np.abs(port[True][1][k] - ref_q[k]).max() / np.abs(ref_q[k]).max(), k) for k in live)
    jworst = max((np.abs(ref_f[k] - ref_q[k]).max() / np.abs(ref_q[k]).max(), k) for k in live)
    assert worst[0] <= jworst[0], (worst, jworst)
