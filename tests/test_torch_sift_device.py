"""The port's detector (panovlm_tpu_torch/ops/sift_device.py) against the
JAX package's on-device SIFT on the same synthetic panoramas (128 x 256,
1024 features).

Not bit-exact by construction: the Gaussian pyramid, the DoG threshold
tests and the top-k selection run the same float32 arithmetic in another
order, so a keypoint whose response sits within rounding of a threshold or
of the k-th score can flip. Stated tolerances: at least 95 % of the JAX
stage's valid keypoints have a port keypoint within 0.01 px, and on those
the descriptors agree to within 1e-3 in the median element and 0.05 in the
largest (an orientation-histogram peak that flips moves a whole
descriptor).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from panovlm_tpu.ops import sift_device as jsd
from panovlm_tpu_torch.ops import sift_device as tsd

from synthetic import render_panorama

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def panos():
    return np.stack([render_panorama(np.array([0.3 * i, 0.1, 0.2 * i]), 128, 256)[0]
                     for i in range(2)])


def _nearest(a, b):
    """For each row of a (n,2), the index of and distance to the nearest b."""
    d = np.linalg.norm(a[:, None] - b[None], axis=-1)
    j = np.argmin(d, axis=1)
    return j, d[np.arange(len(a)), j]


@pytest.mark.parametrize("root_sift", [True, False])
def test_detect_and_describe_matches_jax(panos, root_sift):
    uv_t, desc_t, val_t, _ = (x.numpy() for x in tsd.detect_and_describe(
        torch.from_numpy(panos), num_features=1024, root_sift=root_sift))
    for b in range(len(panos)):
        uv_j, desc_j, val_j, _ = (np.asarray(x) for x in jsd.detect_and_describe(
            jnp.asarray(panos[b]), num_features=1024, root_sift=root_sift))
        assert val_j.sum() > 200
        assert abs(int(val_t[b].sum()) - int(val_j.sum())) <= 0.05 * val_j.sum()
        j, dist = _nearest(uv_j[val_j], uv_t[b][val_t[b]])
        near = dist < 0.01
        assert near.mean() >= 0.95, near.mean()
        err = np.abs(desc_j[val_j][near] - desc_t[b][val_t[b]][j[near]])
        assert np.median(err) < 1e-3 and err.max() < 0.05, (np.median(err), err.max())


def test_batch_entry_and_mask(panos):
    mask = np.ones((128, 256), bool)
    mask[:, :128] = False
    uv, desc, fm = tsd.extract_sift_device_batch(panos, num_features=512, mask=mask,
                                                 chunk=1)
    assert uv.shape == (2, 512, 2) and desc.shape == (2, 512, 128) and fm.shape == (2, 512)
    assert fm.any(axis=1).all()
    assert (uv[fm][:, 0] > 127).all()            # detections only where the mask is set
    np.testing.assert_allclose(np.linalg.norm(desc[fm], axis=1), 1.0, atol=1e-4)
