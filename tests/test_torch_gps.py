"""The port's GPS helpers (panovlm_tpu_torch/utils/gps.py) and the GPS
modes of its pair proposal against the JAX package's on the same inputs.
Every function is numpy and scipy in both packages: the results must be
equal bit for bit."""

import numpy as np
import pytest

from panovlm_tpu.models import sfm as jsfm
from panovlm_tpu.utils import gps as jgps
from panovlm_tpu_torch.models import sfm as tsfm
from panovlm_tpu_torch.utils import gps as tgps

FILES = {
    "names": "f0.jpg 0 0 0\nf1.jpg 1.5 0.25 -0.125\n\nf2.jpg 3e0 1 2\n",
    "no names": "0 0 0\n  1.5 0.25 -0.125  \n3 1 2\n",
    "non-finite": "a 0 0 0\nb nan 1 2\nc 1 inf 0\nd 4 5 6\n",
    "malformed": "a 0 0 0\nb one two three\nc 1 2\nd 7 8 9 10\n",
}


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


@pytest.mark.parametrize("case", sorted(FILES))
def test_read_gps_equals_jax(case, tmp_path):
    path = tmp_path / "gps.txt"
    path.write_text(FILES[case])
    xyz_j, names_j = jgps.read_gps(str(path))
    xyz_t, names_t = tgps.read_gps(str(path))
    _same(xyz_t, xyz_j)
    assert names_t == names_j


def _track(seed, n=60):
    rng = np.random.default_rng(seed)
    xyz = np.cumsum(rng.normal(size=(n, 3)) * [1.0, 1.0, 0.1], axis=0)
    xyz[n // 3] = np.inf                     # a frame without a fix
    return xyz


@pytest.mark.parametrize("seed", [0, 1])
def test_gps_functions_equal_jax(seed):
    xyz = _track(seed)
    fin = np.isfinite(xyz).all(1)
    for radius, per in ((5.0, 10), (7.0, 15)):
        for a, b in zip(tgps.gps_pairs(xyz, radius, per), jgps.gps_pairs(xyz, radius, per)):
            _same(a, b)
    pi, pj = jgps.gps_pairs(xyz, 7.0, 15)
    _same(tgps.scale_from_gps(xyz, pi, pj), jgps.scale_from_gps(xyz, pi, pj))
    aa = np.random.default_rng(seed + 10).normal(size=(len(xyz), 3)).astype(np.float32)
    _same(tgps.init_translation_gps(xyz[fin], aa[fin]), jgps.init_translation_gps(xyz[fin], aa[fin]))
    rng = np.random.default_rng(seed + 20)
    src = xyz[fin]
    from scipy.spatial.transform import Rotation as ScR
    dst = 1.7 * src @ ScR.from_rotvec(rng.normal(size=3)).as_matrix().T + rng.normal(size=3)
    dst += rng.normal(size=dst.shape) * 0.01
    for with_scale in (True, False):
        for a, b in zip(tgps.umeyama(src, dst, with_scale), jgps.umeyama(src, dst, with_scale)):
            _same(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("methods", [8, 16, 2 | 8, 4 | 16, 2 | 4 | 8 | 16])
def test_init_image_pairs_gps_modes_equal_jax(methods):
    rng = np.random.default_rng(3)
    n = 90
    xyz = _track(4, n)
    emb = rng.normal(size=(n, 32)).astype(np.float32)
    cfg_j, cfg_t = jsfm.SfMConfig(contiguous_window=3), tsfm.SfMConfig(contiguous_window=3)
    for gps in (xyz, None):
        want = jsfm.init_image_pairs(n, cfg_j, embeddings=emb, gps_xyz=gps, methods=methods)
        got = tsfm.init_image_pairs(n, cfg_t, embeddings=emb, gps_xyz=gps, methods=methods)
        for a, b in zip(got, want):
            _same(a, b)
        assert len(got[0]) > 0
