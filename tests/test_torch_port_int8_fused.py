"""Port parity: the int8 site as the redesigned kernels compute it
(`sgtapose_tpu_torch/ops/int8_conv.py`: `int8_site`, `plan`,
`plain_int8_absmax`, `video_scales`) against the JAX package's
`models/layers.py:_int8_conv` on the CPU, on the same numpy inputs.

1. `plain_int8_site` (the activation's scale and quantization, then the s8
   conv and JAX's rescale) bit for bit against flax's `layers.Conv` under
   `quantized("int8")`: a 7x7 stem (C_in 3), a 3x3 at stride 1 and 2, and
   the DCN's 1x1 over 9C columns, in float32 and bf16, static and dynamic
   scales, `groups` 1 and 2 (JAX run per video), and an all-zero input
   (the 1e-12 floor of the scale).
2. The split planner: every K stage covered exactly once, at most 8 ranks,
   no split where the tiles fill the card's block slots.
3. The ranks' partial sums, emulated in int64, add up to the unsplit
   accumulators.
4. The kernel's dynamic scale, from its reduction's slot maxima (the max
   taken on the float bits as unsigned ints, as its atomicMax does), equals
   `activation_scale` for groups 1, 2 and 4.
5. The weight packing the kernel reads round-trips through `unpacked`.
6. The scales divide by 127 as JAX does (`div127`), also where a
   multiplication by the rounded reciprocal would miss by one unit.
7. The kernel's division-free quotient (`csrc/int8_conv_fused.cu:quotient`:
   RN(v r), the FMA residual, RN(q + e r)), emulated in exact rational
   arithmetic, equals the IEEE quotient at random, bf16 and near-tie inputs.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from sgtapose_tpu.models import layers as jlayers
from sgtapose_tpu_torch.models import layers as tlayers
from sgtapose_tpu_torch.ops import int8_conv as tint8


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# (C_in, C_out, kernel, stride): a stem, the 3x3 kinds, the DCN's contraction
# over (B, H, W, 9C) columns of C = 16
SITES = {"7x7_c3": (3, 16, 7, 1), "3x3": (16, 32, 3, 1), "3x3_s2": (32, 64, 3, 2), "dcn": (144, 24, 1, 1)}


def _jax_site(x, w, b, k, s, jdt, a_max):
    """flax's layers.Conv under quantized("int8") on NHWC x, float32 out."""
    mod = jlayers.Conv(w.shape[-1], kernel_size=(k, k), strides=(s, s), padding=k // 2, use_bias=True, dtype=jdt,
                       param_dtype=jdt)
    params = {"kernel": jnp.asarray(w).astype(jdt), "bias": jnp.asarray(b).astype(jdt)}
    with jlayers.quantized("int8", scales=None if a_max is None else [a_max]):
        return np.asarray(mod.apply({"params": params}, jnp.asarray(x).astype(jdt)).astype(jnp.float32))


def _port_site(x, w, b, k, s, tdt, a_max, groups, return_acc=False):
    O, C = w.shape[-1], w.shape[-2]
    tw = _t(w).permute(3, 2, 0, 1).contiguous().to(tdt)  # (O, C, kh, kw)
    qw = tlayers._cached_weight(torch.nn.Module(), tw, k, k)
    assert qw.q.shape[1] % tint8.K_STEP == 0 and qw.c == C and qw.scale.shape == (O,)
    return tint8.int8_site(_t(x).to(tdt), qw, a_max, groups, _t(b).to(tdt), s, k // 2, return_acc)


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("kind", list(SITES))
def test_plain_site_matches_jax(kind, dtype):
    """Static and dynamic scales with groups 1, and dynamic per video with
    groups 2 (samples 0, 2 and 1, 3 are two videos; JAX runs each video's
    samples on their own); the s32 accumulators against JAX's s8 conv."""
    C, O, k, s = SITES[kind]
    rs = np.random.RandomState(len(kind) + C)
    x = rs.randn(4, 9, 11, C).astype(np.float32)
    x[1] *= 3.0  # the second video's own range
    w = (rs.randn(k, k, C, O) / np.sqrt(k * k * C)).astype(np.float32)
    b = (0.1 * rs.randn(O)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    a_max = float(np.abs(x).max()) * 0.8  # below the data's max: x_q clips
    for case_max in (None, a_max):
        out, acc = _port_site(x, w, b, k, s, tdt, case_max, 1, return_acc=True)
        assert out.dtype == tdt
        np.testing.assert_array_equal(out.to(torch.float32).numpy(), _jax_site(x, w, b, k, s, jdt, case_max))
        jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
        dn = lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
        jx_q, jw_q, *_ = jlayers._quantize_operands(jx, jw, dn, a_max=case_max)
        ref_acc = lax.conv_general_dilated(jx_q.astype(jnp.int8), jw_q.astype(jnp.int8), (s, s),
                                           [(k // 2, k // 2)] * 2, dimension_numbers=dn,
                                           preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(ref_acc))
    got = _port_site(x, w, b, k, s, tdt, None, 2).to(torch.float32).numpy()
    for v in range(2):
        np.testing.assert_array_equal(got[v::2], _jax_site(x[v::2], w, b, k, s, jdt, None))
    assert not np.array_equal(got[::2], _jax_site(x, w, b, k, s, jdt, None)[::2])  # the scales differ


def test_plain_site_all_zero_input_matches_jax():
    """x = 0: the dynamic scale is 1e-12 / 127, x_q = 0, the output the bias."""
    C, O, k, s = SITES["3x3"]
    rs = np.random.RandomState(0)
    x = np.zeros((2, 6, 7, C), np.float32)
    w = (rs.randn(k, k, C, O) / np.sqrt(k * k * C)).astype(np.float32)
    b = (0.1 * rs.randn(O)).astype(np.float32)
    for groups in (1, 2):
        out, acc = _port_site(x, w, b, k, s, torch.float32, None, groups, return_acc=True)
        assert not acc.any()
        np.testing.assert_array_equal(out.numpy(), _jax_site(x, w, b, k, s, jnp.float32, None))
    np.testing.assert_array_equal(tlayers.activation_scale(_t(x), groups=2).numpy(),
                                  np.full(2, np.float32(1e-12) / np.float32(127), np.float32))


# (M, O, Kp) of the flagship's 57 sites at 480x480 (N = 2 for the trunk, 1
# for the decoder's DCN), a few ragged ones, and the extremes
PLAN_SITES = [(460800, 16, 160), (460800, 16, 64), (460800, 16, 160), (115200, 32, 160), (28800, 64, 32),
              (28800, 64, 288), (28800, 64, 576), (28800, 64, 128), (7200, 128, 64), (7200, 128, 576),
              (7200, 128, 1152), (7200, 128, 256), (7200, 128, 448), (1800, 256, 128), (1800, 256, 1152),
              (1800, 256, 2304), (1800, 256, 512), (1800, 256, 896), (450, 512, 256), (450, 512, 2304),
              (450, 512, 4608), (450, 512, 1280), (225, 256, 4608), (900, 256, 2304), (900, 128, 2304),
              (3600, 128, 1152), (3600, 64, 1152), (14400, 64, 576), (900, 64, 2304), (14400, 256, 576),
              (99, 5, 224), (35, 70, 64), (1, 1, 32), (1, 4096, 32), (10 ** 7, 512, 4608)]


@pytest.mark.parametrize("sms,per_sm", [(132, 2), (132, 1), (114, 2)])
def test_split_planner_covers_every_stage_once(sms, per_sm):
    for M, O, Kp in PLAN_SITES:
        p = tint8.plan(M, O, Kp, sms, per_sm)
        assert p.tile_n == (16 if O <= 16 else 64)
        assert p.tiles_m * tint8.TILE_M >= M > (p.tiles_m - 1) * tint8.TILE_M
        assert p.tiles_n * p.tile_n >= O > (p.tiles_n - 1) * p.tile_n
        assert p.steps * tint8.K_STAGE >= Kp > (p.steps - 1) * tint8.K_STAGE
        assert 1 <= p.splits <= min(tint8.MAX_SPLITS, p.steps)
        tiles = p.tiles_m * p.tiles_n
        if tiles >= sms * per_sm:
            assert p.splits == 1  # the tiles alone fill the card's block slots
        else:
            assert tiles * p.splits <= sms * per_sm  # no more blocks than slots
            assert p.splits == tint8.MAX_SPLITS or p.splits == p.steps or tiles * (p.splits + 1) > sms * per_sm
        for splits in range(1, min(tint8.MAX_SPLITS, p.steps) + 1):
            ranges = tint8.split_ranges(p.steps, splits)
            covered = [st for lo, hi in ranges for st in range(lo, hi)]
            assert covered == list(range(p.steps)) and all(hi > lo for lo, hi in ranges)
    # the redesign splits the small maps' long K: the 15x15 DCN at K 4608 over 8 ranks
    assert tint8.plan(225, 256, 4608, 132, 2).splits == 8 and tint8.plan(460800, 16, 160, 132, 2).splits == 1


def test_a_producer_modes():
    """The patch for the stems and the 3x3 sites whose patch fits (64
    columns of one output row, or 64 // Wo whole rows), vec for the 1x1
    sites and the 3x3 ones whose patch is too large, else the gather."""
    assert tint8.patch_tile(480) == (64, 1) and tint8.patch_tile(30) == (30, 2) and tint8.patch_tile(15) == (15, 4)
    assert tint8.patch_bytes(256, 3, 3, 1, 30) == 4 * 32 * 256  # rows (2 - 1) + 3, columns 29 + 3
    assert tint8.a_mode(3, 7, 7, 1, 480) == tint8.a_mode(1, 7, 7, 1, 480) == "patch"
    assert tint8.a_mode(16, 3, 3, 1, 480) == tint8.a_mode(256, 3, 3, 1, 30) == "patch"
    assert tint8.a_mode(512, 3, 3, 1, 15) == tint8.a_mode(4608, 1, 1, 1, 15) == tint8.a_mode(64, 1, 1, 1, 120) == "vec"
    assert tint8.a_mode(24, 1, 1, 1, 9) == "patch" and tint8.a_mode(24, 1, 1, 1, 9, aligned=False) == "patch"
    assert tint8.a_mode(600, 3, 3, 1, 11) == tint8.a_mode(40, 7, 7, 2, 64) == "gather"  # K or the patch too large
    for mode in ("vec", "patch", "gather"):
        assert tint8.blocks_per_sm(torch.bfloat16, mode) == 2
        assert tint8.blocks_per_sm(torch.float32, mode) == (1 if mode == "vec" else 2)


@pytest.mark.parametrize("N,H,W,C,O,k,s", [(1, 5, 6, 288, 24, 1, 1), (2, 7, 5, 40, 70, 3, 2),
                                           (1, 9, 9, 3, 16, 7, 1)])
def test_split_partial_sums_add_up_to_the_unsplit_accumulators(N, H, W, C, O, k, s):
    """Each rank's sum over its K stages (int64, as the kernel's s32 adds
    them exactly), over every split the kernel allows: the sum of the
    partials equals plain_int8_conv's accumulators."""
    rs = np.random.RandomState(C + O)
    x_q = _t(rs.randint(-127, 128, (N, H, W, C)).astype(np.int8))
    qw = tint8.pack_weight(_t(rs.randint(-127, 128, (O, k, k, C))), torch.ones(O))
    _, acc = tint8.plain_int8_conv(x_q, qw, torch.ones(N), None, s, k // 2, torch.float32, return_acc=True)
    Kp = qw.q.shape[1]
    # im2col in (ky, kx, c) order, zero-padded to whole stages
    xp = torch.nn.functional.pad(x_q.to(torch.int64), (0, 0, k // 2, k // 2, k // 2, k // 2))
    cols = xp.unfold(1, k, s).unfold(2, k, s).permute(0, 1, 2, 4, 5, 3).reshape(-1, k * k * C)
    steps = -(-Kp // tint8.K_STAGE)
    cols = torch.nn.functional.pad(cols, (0, steps * tint8.K_STAGE - cols.shape[1]))
    w = torch.nn.functional.pad(qw.q.to(torch.int64), (0, steps * tint8.K_STAGE - Kp))
    for splits in range(1, min(tint8.MAX_SPLITS, steps) + 1):
        total = torch.zeros(cols.shape[0], O, dtype=torch.int64)
        for lo, hi in tint8.split_ranges(steps, splits):
            ks = slice(lo * tint8.K_STAGE, hi * tint8.K_STAGE)
            total += cols[:, ks] @ w[:, ks].T
        assert torch.equal(total.reshape(acc.shape), acc.to(torch.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_scale_formula_matches_activation_scale(dtype):
    """The kernel's route to a dynamic scale: slot maxima of |x| per sample
    (`plain_int8_absmax`, the reduction's spans), their max per video taken
    on the float bits as unsigned ints (the conv's shared-memory atomicMax),
    then max(., 1e-12) / 127 in float32 (`video_scales`): equal to
    `activation_scale` for groups 1, 2 and 4."""
    rs = np.random.RandomState(1)
    x = _t(rs.randn(8, 5, 7, 3).astype(np.float32) * rs.rand(8, 1, 1, 1).astype(np.float32) * 4).to(dtype)
    per_sample = x[0].numel()
    for slots in (1, 7, tint8.absmax_slots(per_sample), per_sample + 3):
        part = tint8.plain_int8_absmax(x, slots)
        assert part.shape == (8, slots)
        spans = tint8.slot_spans(per_sample, slots)
        assert spans[0][0] == 0 and spans[-1][1] == per_sample and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        for groups in (1, 2, 4):
            bits = part.numpy().view(np.uint32).reshape(8 // groups, groups, slots).max(axis=(0, 2))
            per_video = bits.view(np.float32)
            kernel = np.tile(np.maximum(per_video, np.float32(1e-12)) / np.float32(127), 8 // groups)
            ref = tlayers.activation_scale(x, groups=groups)
            np.testing.assert_array_equal(kernel, ref.numpy())
            assert torch.equal(tint8.video_scales(part, groups), ref)


def test_weight_packing_round_trips():
    """The kernel reads PR 14's packing (O, Kp): K = kh kw c in (ky, kx, c)
    order, zero from K to Kp; stages past Kp are zero-filled in the kernel."""
    rs = np.random.RandomState(2)
    for O, kh, c in ((16, 7, 3), (16, 7, 1), (256, 1, 4608), (5, 3, 24)):
        w_q = _t(rs.randint(-127, 128, (O, kh, kh, c)).astype(np.int8))
        qw = tint8.pack_weight(w_q, torch.ones(O))
        K = kh * kh * c
        assert qw.q.shape == (O, -(-K // tint8.K_STEP) * tint8.K_STEP) and not qw.q[:, K:].any()
        assert torch.equal(qw.unpacked(), w_q)


def test_scales_divide_by_127_as_jax():
    """div127 is the IEEE quotient JAX takes (jnp.max(...) / 127.0) at
    maxima where a multiplication by the rounded reciprocal misses it (what
    PyTorch's CUDA division by a Python number computes); the weight and
    activation scales take it."""
    m = np.array([6.4589409828186035, 0.7103605270385742, 5.68433952331543], np.float32)
    assert (m * (np.float32(1) / np.float32(127)) != m / np.float32(127)).all()
    np.testing.assert_array_equal(tint8.div127(_t(m)).numpy(), np.asarray(jnp.asarray(m) / 127.0))
    w = np.eye(3, dtype=np.float32)[:, :, None, None] * m[:, None, None, None]
    _, w_scale = tlayers.weight_quant(_t(w))
    np.testing.assert_array_equal(w_scale.reshape(-1).numpy(), m / np.float32(127))
    x = _t(np.broadcast_to(m[:, None, None, None], (3, 2, 2, 1)).copy())
    np.testing.assert_array_equal(tlayers.activation_scale(x, groups=3).numpy(), m / np.float32(127))


def _rn32(value: Fraction) -> np.float32:
    """value rounded to the nearest float32, ties to even (normal range)."""
    if value == 0:
        return np.float32(0.0)
    mag = abs(value)
    e = mag.numerator.bit_length() - mag.denominator.bit_length()
    e += 1 if mag >= Fraction(2) ** (e + 1) else (-1 if mag < Fraction(2) ** e else 0)
    n = round(mag / Fraction(2) ** (e - 23))  # 24 bits, half to even
    return np.float32((1 if value > 0 else -1) * n * 2.0 ** (e - 23))


def _kernel_quotient(v, s, r) -> np.float32:
    """quotient(v, s, r) of the kernel, each fmul / fma rounded once."""
    F = lambda a: Fraction(float(a))  # noqa: E731
    q = _rn32(F(v) * F(r))
    e = _rn32(F(v) - F(q) * F(s))  # fma(-q, s, v)
    return _rn32(F(e) * F(r) + F(q))  # fma(e, r, q)


def test_kernel_quotient_is_the_ieee_quotient():
    """A float32 scale (static: rounded from a double; dynamic: a float32
    max / 127) and its correctly rounded reciprocal; x random, bf16-valued
    and within 3 units in the last place of (k + 1/2) s, where x_q turns."""
    rs = np.random.RandomState(3)
    n = 0
    for trial in range(6):
        amax = np.float32(rs.rand() * 10.0 ** rs.uniform(-3, 3))
        s = np.float32(np.float64(amax) / 127.0) if trial % 2 else amax / np.float32(127)
        r = np.float32(1) / s
        ties = ((rs.randint(-130, 130, 120) + np.float32(0.5)) * s).astype(np.float32)
        ties = (ties.view(np.int32) + rs.randint(-3, 4, 120).astype(np.int32)).view(np.float32)
        rand = (rs.randn(120) * amax).astype(np.float32)
        bf = torch.from_numpy(rand * 0.7).to(torch.bfloat16).float().numpy()
        for x in (ties[np.isfinite(ties)], rand, bf):
            ref = x / s  # numpy's float32 division: IEEE, round to nearest even
            got = np.array([_kernel_quotient(a, s, r) for a in x], np.float32)
            np.testing.assert_array_equal(got, ref)
            n += x.size
    assert n > 2000
