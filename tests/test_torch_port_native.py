"""Port parity of the host-side leftovers against the JAX package on the
CPU: the float64 C++ LM refiner (`native/`, the same source, built by each
package into its own directory), `core/pnp.reprojection_weights`, the config
tree's `MeshConfig` / `default_config`, and `utils/seeding.set_random_seed`.

Bars: `lm_refine` equal to JAX's within 1e-12 (the same float64 C++ on the
same inputs; only the two builds could differ); `reprojection_weights` within
1e-4 of JAX's (weights in [0, 1]; the float32 projection of a ~300 px
coordinate carries 3e-5 px of rounding, which moves w = exp(-5 r^2) by up to
10 |r| w times that, measured 2e-5 at |r| ~ 0.5 px); the configs and the
seeded host draws equal.
"""

import dataclasses
import os
import random
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu import config as jconfig, native as jnative
from sgtapose_tpu.core import pnp as jpnp
from sgtapose_tpu.utils.seeding import set_random_seed as jax_set_random_seed
from sgtapose_tpu_torch import config as tconfig, native as tnative
from sgtapose_tpu_torch.core import pnp as tpnp
from sgtapose_tpu_torch.utils.seeding import set_random_seed

K = np.array([[502.30, 0.0, 319.75], [0.0, 502.30, 179.75], [0.0, 0.0, 1.0]])


def _pose(rs, n=7):
    """A pose, n points in front of the camera, their projections (float64)."""
    q = rs.randn(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    t = np.array([0.1, -0.05, 1.5]) + rs.rand(3) * 0.3
    x3d = (rs.rand(n, 3) - 0.5) * 0.6
    uvw = (x3d @ R.T + t) @ K.T
    return q, t, x3d, uvw[:, :2] / uvw[:, 2:3]


@pytest.mark.parametrize("n,noise", [(7, 0.0), (7, 2.0), (42, 1.0)])
def test_lm_refine_matches_jax(n, noise):
    """From a perturbed start, with per-coordinate weights; 42 points as a
    42-keypoint model's refinement has."""
    rs = np.random.RandomState(n + int(noise))
    q, t, x3d, x2d = _pose(rs, n)
    x2d = x2d + noise * rs.randn(*x2d.shape)
    q0 = q + 0.05 * rs.randn(4)
    q0 /= np.linalg.norm(q0)
    t0 = t + 0.05 * rs.randn(3)
    w = rs.rand(n, 2) + 0.5
    got = tnative.lm_refine(x2d, x3d, q0, t0, w, K)
    ref = jnative.lm_refine(x2d, x3d, q0, t0, w, K)
    for a, b in zip(got, ref):
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert np.abs(got[1] - t0).max() > 1e-6  # it moved


def test_lm_refine_builds_into_the_port_and_bounds_n():
    assert tnative.available()
    so = tnative.build()
    assert so.startswith(os.path.dirname(os.path.abspath(tnative.__file__)) + os.sep)
    assert not so.startswith(os.path.dirname(os.path.abspath(jnative.__file__)) + os.sep)
    with open(tnative._SRC, "rb") as a, open(os.path.join(os.path.dirname(jnative.__file__), "lm_solver.cpp"),
                                              "rb") as b:
        assert a.read() == b.read()  # a byte copy
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ignored = subprocess.run(["git", "check-ignore", "-q", os.path.relpath(so, root)], cwd=root)
    assert ignored.returncode == 0  # the library is never committed
    assert tnative.MAX_N == jnative.MAX_N
    with pytest.raises(ValueError, match="at most"):
        tnative.lm_refine(np.zeros((tnative.MAX_N + 1, 2)), np.zeros((tnative.MAX_N + 1, 3)), np.eye(4)[0],
                          np.zeros(3), np.ones((tnative.MAX_N + 1, 2)), K)


@pytest.mark.parametrize("with_valid", [False, True])
def test_reprojection_weights_matches_jax(with_valid):
    rs = np.random.RandomState(5)
    q, t, x3d, x2d = (a.astype(np.float32) for a in _pose(rs))
    x2d = x2d + rs.randn(*x2d.shape).astype(np.float32) * 0.4
    valid = np.array([1, 1, 0, 1, 1, 1, 0], bool) if with_valid else None
    kf = K.astype(np.float32)
    ref = np.asarray(jpnp.reprojection_weights(*(jnp.asarray(a) for a in (x2d, x3d, q, t, kf)),
                                               valid=None if valid is None else jnp.asarray(valid)))
    got = tpnp.reprojection_weights(*(torch.from_numpy(a) for a in (x2d, x3d, q, t, kf)),
                                    valid=None if valid is None else torch.from_numpy(valid))
    assert got.shape == (7, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    assert 0.0 < ref.min() < ref.max() <= 1.0 or with_valid
    if with_valid:
        assert (got.numpy()[~valid] == 0).all()


def test_mesh_config_and_default_config_match_jax():
    """JAX's MeshConfig less `data_axis`, the name of a mesh axis, which a
    process group does not have."""
    assert [(f.name, f.default) for f in dataclasses.fields(tconfig.MeshConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(jconfig.MeshConfig) if f.name != "data_axis"]
    jmesh = dataclasses.asdict(jconfig.default_config().mesh)
    assert jmesh.pop("data_axis") == "data"
    assert dataclasses.asdict(tconfig.default_config().mesh) == jmesh
    assert tconfig.default_config() == tconfig.Config()
    # the config tree's top-level fields are JAX's
    assert {f.name for f in dataclasses.fields(tconfig.Config)} == {f.name for f in dataclasses.fields(jconfig.Config)}


def test_set_random_seed_matches_jax(monkeypatch):
    """The host draws after seeding equal JAX's; torch's global generator is
    seeded too, and the returned generator starts where it does."""
    monkeypatch.setenv("PYTHONHASHSEED", "0")
    draws = []
    for seed_fn in (jax_set_random_seed, set_random_seed):
        gen = seed_fn(123)
        draws.append((random.random(), np.random.rand(3).tolist(), os.environ["PYTHONHASHSEED"]))
    assert draws[0] == draws[1] and draws[1][2] == "123"
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 123
    set_random_seed(123)
    assert torch.equal(torch.rand(3), torch.rand(3, generator=torch.Generator().manual_seed(123)))
