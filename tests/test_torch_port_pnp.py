"""Port parity: core/pnp.py (masked EPnP + LM, DLT/canonical fallback, warm
start, reprojection prior) against the JAX solver on the same numpy inputs.

Bars: `success` equal; the solved pose's reprojection of all points within
0.01 px of JAX's (the JAX-vs-cv2 bar of the JAX package). Eigen/singular
vector signs differ between the backends, so intermediate vectors are not
compared, only poses through their reprojections.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.core import geometry as jg
from sgtapose_tpu.core import pnp as jpnp
from sgtapose_tpu.data import synthetic as jsyn
from sgtapose_tpu_torch.core import geometry as tg
from sgtapose_tpu_torch.core import pnp as tpnp

K = np.asarray(jsyn.camera_K())
REPROJ_BAR = 0.01  # px


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax_solver(warm: bool):
    if warm:
        return jax.jit(lambda x3d, x2d, v, q, t, u: jpnp.solve_pnp(x3d, x2d, K, v, init=(q, t, u)))
    return jax.jit(lambda x3d, x2d, v: jpnp.solve_pnp(x3d, x2d, K, v))


def _problem(seed, n_masked=0, noise=0.0, outlier=0.0):
    """A synthetic-camera pose of the 7-keypoint skeleton, its projections
    (optionally noisy, one optionally displaced), and a valid mask."""
    rs = np.random.RandomState(seed)
    q = rs.randn(4).astype(np.float32)
    q /= np.linalg.norm(q)
    R = np.asarray(jg.quat_to_matrix(jnp.asarray(q)))
    x3d = np.asarray(jsyn.SKELETON) + (rs.randn(7, 3) * 0.02).astype(np.float32)
    t = (np.array([0.0, 0.0, 2.4]) - R @ x3d.mean(0) + rs.randn(3) * 0.1).astype(np.float32)
    x2d = np.asarray(jg.project_points(x3d, R, t, K)) + (rs.randn(7, 2) * noise)
    x2d[3] += outlier
    valid = np.ones(7, bool)
    valid[rs.choice(7, n_masked, replace=False)] = False
    return x3d.astype(np.float32), x2d.astype(np.float32), valid, q, t


def _reproj(quat, trans, x3d, mod):
    R = mod.quat_to_matrix(quat)
    return np.asarray(mod.project_points(x3d, R, trans, K if mod is jg else _t(K)))


def _compare(jres, tres, x3d):
    assert bool(jres.success) == bool(tres.success)
    pj = _reproj(jres.quat, jres.trans, x3d, jg)
    pt = _reproj(tres.quat, tres.trans, _t(x3d), tg)
    assert np.abs(pj - pt).max() < REPROJ_BAR, np.abs(pj - pt).max()


@pytest.mark.parametrize("n_masked", [0, 1, 2, 3])
@pytest.mark.parametrize("noise", [0.0, 1.0])
def test_solve_pnp_matches_jax(n_masked, noise):
    for seed in range(3):
        x3d, x2d, valid, _, _ = _problem(100 * n_masked + seed, n_masked, noise)
        jres = _jax_solver(False)(x3d, x2d, valid)
        tres = tpnp.solve_pnp(_t(x3d), _t(x2d), _t(K), _t(valid))
        assert bool(tres.success)
        _compare(jres, tres, x3d)


def test_fallback_branch_matches_jax():
    """One far outlier keeps the EPnP-started LM above 3 px mean
    reprojection, so the DLT/canonical fallback decides the pose."""
    x3d, x2d, valid, _, _ = _problem(7, 0, 0.5, outlier=250.0)
    x3d_t, x2d_t, w = _t(x3d), _t(x2d), torch.ones(7)
    R0, t0 = tpnp.epnp_init(x3d_t, x2d_t, _t(K), w)
    qa, ta = tpnp.refine_pose_lm(x3d_t, x2d_t, _t(K), w, tg.matrix_to_quat(R0), t0)
    err_a = np.linalg.norm(_reproj(qa, ta, x3d_t, tg) - x2d, axis=1).mean()
    assert err_a > 3.0  # the fallback branch is taken
    _compare(_jax_solver(False)(x3d, x2d, valid), tpnp.solve_pnp(x3d_t, x2d_t, _t(K), _t(valid)), x3d)


def test_too_few_points_fails_like_jax():
    x3d, x2d, valid, _, _ = _problem(11, n_masked=4)
    jres = _jax_solver(False)(x3d, x2d, valid)
    tres = tpnp.solve_pnp(_t(x3d), _t(x2d), _t(K), _t(valid))
    assert not bool(jres.success) and not bool(tres.success)
    np.testing.assert_array_equal(tres.quat.numpy(), [1, 0, 0, 0])


@pytest.mark.parametrize("use_init", [True, False])
def test_warm_start_matches_jax(use_init):
    x3d, x2d, valid, q, t = _problem(21, 1, 0.5)
    q0 = (q + np.random.RandomState(0).randn(4) * 0.02).astype(np.float32)
    t0 = (t + 0.02).astype(np.float32)
    jres = _jax_solver(True)(x3d, x2d, valid, q0, t0, np.bool_(use_init))
    tres = tpnp.solve_pnp(_t(x3d), _t(x2d), _t(K), _t(valid),
                          init=(_t(q0), _t(t0), torch.tensor(use_init)))
    _compare(jres, tres, x3d)


def test_reprojection_prior_matches_jax():
    x3d, x2d, valid, _, _ = _problem(31, 2, 1.0)
    nxt = x3d + 0.01
    ok_j, est_j, _ = jpnp.pnp_reprojection_prior(x3d, x2d, nxt, K, valid)
    ok_t, est_t, _ = tpnp.pnp_reprojection_prior(_t(x3d), _t(x2d), _t(nxt), _t(K), _t(valid))
    assert bool(ok_j) == bool(ok_t)
    assert np.abs(np.asarray(est_j) - est_t.numpy()).max() < REPROJ_BAR


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm_start"])
def test_batched_prior_matches_jax_vmap(warm):
    """pnp_reprojection_prior_batch over 5 consistent problems (0-4 masked
    rows, one with too few points) against JAX's vmap of the same solve: each
    problem keeps its own mask, warm start and success at the same bars."""
    probs = [_problem(40 + i, n_masked=i, noise=0.5) for i in range(5)]
    x3d, x2d, valid, q, t = (np.stack(a) for a in zip(*probs))
    nxt = x3d + 0.01
    use = np.array([True, False, True, False, True])
    q0 = (q + 0.02).astype(np.float32)

    def jax_one(a, b, c, v, qq, tt, u):
        return jpnp.pnp_reprojection_prior(a, b, c, K, v, init=(qq, tt, u) if warm else None)

    ok_j, est_j, res_j = jax.jit(jax.vmap(jax_one))(x3d, x2d, nxt, valid, q0, t, use)
    init = (_t(q0), _t(t), _t(use)) if warm else None
    ok_t, est_t, res_t = tpnp.pnp_reprojection_prior_batch(_t(x3d), _t(x2d), _t(nxt), _t(K), _t(valid),
                                                           init=init)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert list(ok_t.numpy()) == [True, True, True, True, False]
    ok = ok_t.numpy()
    assert np.abs(np.asarray(est_j)[ok] - est_t.numpy()[ok]).max() < REPROJ_BAR
    for i in range(5):  # each problem as the single solve gives it
        one = tpnp.pnp_reprojection_prior(_t(x3d[i]), _t(x2d[i]), _t(nxt[i]), _t(K), _t(valid[i]),
                                          init=None if init is None else tuple(a[i] for a in init))
        assert bool(one[0]) == bool(ok[i])
        if ok[i]:
            assert np.abs(one[1].numpy() - est_t[i].numpy()).max() < REPROJ_BAR


def test_register_gn_matches_jax():
    """The eval harness's weighted refinement from a perturbed start, on a
    noisy problem: the refined pose's reprojection within the PnP bar."""
    x3d, x2d, valid, q, t = _problem(51, 0, 1.0)
    q0 = (q + 0.01).astype(np.float32)
    t0 = (t + 0.01).astype(np.float32)
    w = np.exp(-5.0 * np.random.RandomState(1).rand(7, 1).repeat(2, 1)).astype(np.float32)
    qj, tj = jpnp.register_gn(jnp.asarray(x2d), jnp.asarray(x3d), jnp.asarray(q0), jnp.asarray(t0),
                              jnp.asarray(w), jnp.asarray(K))
    qt, tt = tpnp.register_gn(_t(x2d), _t(x3d), _t(q0), _t(t0), _t(w), _t(K))
    pj = _reproj(qj / jnp.linalg.norm(qj), tj, x3d, jg)
    pt = _reproj(qt / qt.norm(), tt, _t(x3d), tg)
    assert np.abs(pj - pt).max() < REPROJ_BAR
