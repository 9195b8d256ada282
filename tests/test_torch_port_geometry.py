"""Port parity: core/geometry.py and data/synthetic.py against the JAX
package on the same numpy inputs. Bars: unit-scale values <= 1e-5
elementwise (float32 sums in another order); pixel coordinates and 0-255
images <= 1e-3 (a few float32 ulps at 640 px); heatmap renders at integer
centres exact (same windows, same exp of integer arguments), sub-pixel
renders <= 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.core import geometry as jg
from sgtapose_tpu.data import synthetic as jsyn
from sgtapose_tpu_torch.core import geometry as tg
from sgtapose_tpu_torch.data import synthetic as tsyn

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol, rtol=1e-6)


@pytest.mark.parametrize("rot,inv", [(0.0, False), (17.5, False), (-30.0, True)])
def test_affine_transform_family(rot, inv):
    rs = np.random.RandomState(0)
    c = np.array([320.0, 180.0], np.float32)
    s = np.float32(640.0)
    Mj = jg.get_affine_transform(c, s, rot, (128, 96), shift=(0.05, -0.1), inv=inv)
    Mt = tg.get_affine_transform(c, s, rot, (128, 96), shift=(0.05, -0.1), inv=inv)
    _close(Mt, Mj, atol=1e-4)
    _close(tg.invert_affine(Mt), jg.invert_affine(jnp.asarray(Mt.numpy())), atol=1e-4)
    pts = (rs.rand(9, 2) * [700, 400] - [30, 20]).astype(np.float32)
    M = np.asarray(Mj)
    _close(tg.affine_points(_t(pts), _t(M)), jg.affine_points(pts, M), atol=1e-3)
    _close(tg.affine_transform_and_clip(_t(pts), _t(M), 128, 96, 640, 360),
           jg.affine_transform_and_clip(pts, M, 128, 96, 640, 360), atol=1e-3)


def test_warp_and_normalize():
    rs = np.random.RandomState(1)
    img = (rs.rand(2, 36, 64, 3) * 255).astype(np.float32)
    M = np.asarray(jg.get_affine_transform(np.array([32.0, 18.0]), 64.0, 0.0, (48, 48)))
    port = tg.normalize_image(tg.warp_affine(_t(img), _t(M), (48, 48)), (0.5,) * 3, (0.5,) * 3)
    for i in range(2):
        ref = jg.normalize_image(jg.warp_affine(jnp.asarray(img[i]), M, (48, 48)), (0.5,) * 3, (0.5,) * 3)
        _close(port[i], ref, atol=1e-4)


@pytest.mark.parametrize("per_class,subpixel", [(False, False), (True, False), (False, True)])
def test_render_gaussian_heatmap_exact(per_class, subpixel):
    rs = np.random.RandomState(2)
    # some centres near/over the border: those must not be drawn
    centers = np.concatenate([rs.rand(6, 2) * [40, 30], [[2.5, 10.0], [39.9, 5.0], [-3.2, 4.0]]])
    centers = centers.astype(np.float32)
    conf = rs.rand(9).astype(np.float32)
    ref = jg.render_gaussian_heatmap(centers, conf, 30, 40, per_class=per_class, subpixel=subpixel)
    port = tg.render_gaussian_heatmap(_t(centers), _t(conf), 30, 40, per_class=per_class,
                                      subpixel=subpixel)
    if subpixel:
        # fractional exponents: the two exp implementations differ by an ulp
        _close(port, ref, atol=1e-6)
    else:
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_prior_renders_exact():
    rs = np.random.RandomState(3)
    kps = (rs.rand(7, 2) * [640, 360]).astype(np.float32)
    kps[2] = -999.999 * 4  # a missing keypoint lands outside the raw frame
    Mi = np.asarray(jg.get_affine_transform(np.array([320.0, 180.0]), 640.0, 0.0, (64, 64)))
    Mo = np.asarray(jg.get_affine_transform(np.array([320.0, 180.0]), 640.0, 0.0, (16, 16)))
    np.testing.assert_array_equal(
        tg.render_prior_heatmap(_t(kps), _t(Mi), 64, 64, 640, 360).numpy(),
        np.asarray(jg.render_prior_heatmap(kps, Mi, 64, 64, 640, 360)))
    np.testing.assert_array_equal(
        tg.render_prior_heatmap_cls(_t(kps), _t(Mo), 16, 16, 640, 360).numpy(),
        np.asarray(jg.render_prior_heatmap_cls(kps, Mo, 16, 16, 640, 360)))


def test_quaternions_and_projection():
    rs = np.random.RandomState(4)
    K = np.asarray(jsyn.camera_K())
    for _ in range(4):
        q = rs.randn(4).astype(np.float32)
        R = jg.quat_to_matrix(jnp.asarray(q))
        _close(tg.quat_to_matrix(_t(q)), R)
        qj = np.asarray(jg.matrix_to_quat(R))
        qt = tg.matrix_to_quat(_t(R)).numpy()
        _close(qt * np.sign(qt[0]), qj * np.sign(qj[0]))
        x3d = rs.randn(7, 3).astype(np.float32) * 0.3
        t = np.array([0.1, -0.2, 2.0], np.float32)
        _close(tg.project_points(_t(x3d), _t(R), _t(t), _t(K)),
               jg.project_points(x3d, R, t, K), atol=1e-3)
        _close(tg.transform_points(_t(x3d), _t(R), _t(t)), jg.transform_points(x3d, R, t))


def test_synthetic_frames_match():
    """Same pose motion -> same projections and the same rendered frames."""
    rs = np.random.RandomState(5)
    q0 = rs.randn(4).astype(np.float32)
    t0 = np.array([0.05, -0.1, 2.4], np.float32)
    dq = (rs.randn(4) * 0.01).astype(np.float32)
    dt = (rs.randn(3) * 0.01).astype(np.float32)
    projs, imgs, pos = tsyn.sequence_from_motion(_t(q0), _t(t0), _t(dq), _t(dt), 3)
    np.testing.assert_array_equal(tsyn.skeleton().numpy(), np.asarray(jsyn.SKELETON))
    K = jsyn.camera_K()
    for f in range(3):
        q = q0 + dq * f
        q = q / np.linalg.norm(q)
        R = jg.quat_to_matrix(jnp.asarray(q))
        p = jg.project_points(jsyn.SKELETON, R, jnp.asarray(t0 + dt * f), K)
        _close(projs[f], p, atol=1e-3)
        _close(pos[f], jg.transform_points(jsyn.SKELETON, R, jnp.asarray(t0 + dt * f)))
        # render from identical projections: exact up to the einsum's sum order
        _close(tsyn.render_frame(_t(p)), jsyn.render_frame(p), atol=1e-3)
    assert imgs.shape == (3, tsyn.RAW_H, tsyn.RAW_W, 3)


def test_make_sequence_seeded_and_on_request_device():
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    a = tsyn.make_sequence(g1, 2, device="cpu")
    b = tsyn.make_sequence(g2, 2, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[1].min() >= 0 and a[1].max() <= 255
