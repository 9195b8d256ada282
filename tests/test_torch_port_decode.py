"""Port parity: decode/peaks.py against the JAX decode on gaussian belief
maps with 0, 1 and 2 peaks per class (some at sub-pixel centres near the
border), for every coord_mode and both ref_sorts.

Bars: validity and integer peaks equal; coordinates <= 1e-4 px; scores and
the blurred map <= 1e-5 (sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.core import geometry as jg
from sgtapose_tpu.decode import peaks as jpeaks
from sgtapose_tpu_torch.decode import peaks as tpeaks

H = W = 40
# per class: list of (x, y, confidence)
PEAKS = [
    [],                                         # no peak
    [(20.0, 17.0, 0.95)],                       # one peak
    [(1.3, 22.6, 0.9)],                         # one peak at the left border
    [(10.0, 10.0, 0.95), (30.0, 28.0, 0.5)],    # two, unambiguous
    [(8.0, 30.0, 0.9), (31.0, 9.0, 0.8)],       # two, ambiguous -> missing
    [(24.4, 12.7, 0.8)],                        # sub-pixel centre
    [(38.6, 38.2, 0.85), (5.0, 5.0, 0.2)],      # bottom-right corner + weak one
]


def _maps(seed=0):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    hm = np.zeros((H, W, len(PEAKS)), np.float32)
    for c, peaks in enumerate(PEAKS):
        for x, y, conf in peaks:
            g = conf * np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * 2.0 ** 2))
            hm[..., c] = np.maximum(hm[..., c], g)
    hm = np.clip(hm, 1e-4, 1 - 1e-4).astype(np.float32)
    reg = rs.rand(H, W, 2).astype(np.float32)
    trk = rs.randn(H, W, 2).astype(np.float32)
    return hm, reg, trk


def test_gaussian_blur_symmetric_padding_matches():
    hm, _, _ = _maps()
    ref = np.asarray(jpeaks.gaussian_blur(jnp.asarray(hm), 3.0))
    np.testing.assert_allclose(tpeaks.gaussian_blur(torch.from_numpy(hm), 3.0).numpy(), ref, atol=1e-5)


def test_rendered_prior_maps_decode_alike():
    """Maps drawn by the prior renderer (integer centres, plateau-free)."""
    rs = np.random.RandomState(3)
    centers = np.array([[12.0, 9.0], [30.0, 25.0], [6.0, 33.0]], np.float32)
    conf = np.array([0.9, 0.6, 0.95], np.float32)
    hm = np.asarray(jg.render_gaussian_heatmap(centers, conf, H, W, per_class=True)).transpose(1, 2, 0)
    hm = np.clip(hm, 1e-4, 1 - 1e-4).astype(np.float32)
    reg = rs.rand(H, W, 2).astype(np.float32)
    ref = jpeaks.decode_heatmaps(jnp.asarray(hm), jnp.asarray(reg), jnp.asarray(reg))
    port = tpeaks.decode_heatmaps(torch.from_numpy(hm), torch.from_numpy(reg), torch.from_numpy(reg))
    np.testing.assert_array_equal(port.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(port.coords.numpy(), np.asarray(ref.coords), atol=1e-4)


@pytest.mark.parametrize("coord_mode", ["reg", "avg", "logquad", "mean"])
@pytest.mark.parametrize("ref_sort", ["score", "y"])
def test_decode_heatmaps_matches_jax(coord_mode, ref_sort):
    hm, reg, trk = _maps()
    ref = jpeaks.decode_heatmaps(jnp.asarray(hm), jnp.asarray(reg), jnp.asarray(trk),
                                 ref_sort=ref_sort, coord_mode=coord_mode)
    port = tpeaks.decode_heatmaps(torch.from_numpy(hm), torch.from_numpy(reg), torch.from_numpy(trk),
                                  ref_sort=ref_sort, coord_mode=coord_mode)
    valid = np.asarray(ref.valid)
    assert valid.any() and not valid.all()
    np.testing.assert_array_equal(port.valid.numpy(), valid)
    np.testing.assert_array_equal(port.coords_int.numpy(), np.asarray(ref.coords_int))
    np.testing.assert_allclose(port.coords.numpy(), np.asarray(ref.coords), atol=1e-4)
    np.testing.assert_allclose(port.scores.numpy(), np.asarray(ref.scores), atol=1e-5)
    np.testing.assert_allclose(port.tracking.numpy(), np.asarray(ref.tracking), atol=1e-6)
