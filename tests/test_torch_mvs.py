"""The port's MVS post-processing (models/mvs.py), LiDAR depth init
(utils/depth_completion.py) and voxel grid (sensors/velodyne.py) against
the JAX package on the same seeded inputs.

Tolerances: integer-label and comparison-only functions (segments, sky
gate) are exact; gap filling within 1e-6; depth completion within 1e-5
(exp in the bilateral weights); the voxel grid within 1e-5 (scatter-add
order); the filter's u16 outputs equal on >= 99.5% of pixels (a sampled
neighbour depth that rounds differently can flip a support or occlusion
test near its threshold); the fused cloud with the same voxels within
1e-4 m and 1e-5 in colour.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panovlm_tpu.models import mvs as jmvs
from panovlm_tpu.sensors import velodyne as jvd
from panovlm_tpu.utils import depth_completion as jdc
from panovlm_tpu_torch.models import mvs as tmvs
from panovlm_tpu_torch.sensors import velodyne as tvd
from panovlm_tpu_torch.utils import depth_completion as tdc

from synthetic import make_scan, render_panorama

torch.set_num_threads(2)
H, W = 48, 96
CENTERS = ((0.0, 0.4, 0.0), (0.7, 0.4, 0.2), (-0.5, 0.2, -0.4), (0.2, 0.6, -0.7))


@pytest.fixture(scope="module")
def views():
    grays, depths = zip(*[render_panorama(np.array(c), H, W) for c in CENTERS])
    poses = np.zeros((4, 6), np.float32)
    poses[:, 3:] = -np.asarray(CENTERS, np.float32)
    rng = np.random.default_rng(0)
    noisy = np.stack(depths) * rng.uniform(0.995, 1.005, (4, H, W)).astype(np.float32)
    noisy[rng.uniform(size=noisy.shape) < 0.15] = 0.0        # holes
    confs = rng.uniform(-0.2, 0.95, size=(4, H, W)).astype(np.float32)
    return dict(grays=np.stack(grays), depths=noisy, confs=confs, poses=poses)


def test_remove_small_segments_and_gap_interpolation_match_jax(views):
    d = views["depths"][0]
    ref = np.asarray(jmvs.remove_small_segments(jnp.asarray(d), 0.01, 20))
    out = tmvs.remove_small_segments(torch.from_numpy(d), 0.01, 20).numpy()
    np.testing.assert_array_equal(out, ref)
    assert 0 < (ref > 0).sum() < (d > 0).sum()
    np.testing.assert_allclose(tmvs.gap_interpolation(torch.from_numpy(ref)).numpy(),
                               np.asarray(jmvs.gap_interpolation(jnp.asarray(ref))),
                               atol=1e-6)


def test_filter_depth_maps_matches_packed_jax_path(views):
    nei = jmvs.select_neighbor_views(views["poses"], 3)
    np.testing.assert_array_equal(tmvs.select_neighbor_views(views["poses"], 3), nei)
    cfg = jmvs.MVSConfig(n_neighbors=3)
    jd, jc = jmvs.filter_depth_maps(views["depths"], views["confs"], views["poses"], nei, cfg)
    td, tc = tmvs.filter_depth_maps(views["depths"], views["confs"], views["poses"], nei,
                                    tmvs.MVSConfig(n_neighbors=3))
    assert td.dtype == np.float32 and td.shape == (4, H, W)
    q = lambda a, s, o: np.round((a + o) * s).astype(np.int64)   # the u16 grid
    assert (jd > 0).mean() > 0.1
    for a, b, s, o in ((td, jd, 256.0, 0.0), (tc, jc, 16384.0, 1.0)):
        np.testing.assert_array_equal(q(a, s, o) / s - o, a)      # on the grid
        assert np.mean(q(a, s, o) == q(np.asarray(b), s, o)) >= 0.995


def test_fuse_depth_maps_matches_jax(views):
    rgb = np.stack([views["grays"]] * 3, -1)
    rgb[..., 2] = np.clip(rgb[..., 2] * 1.3, 0, 1)
    d = np.stack([render_panorama(np.array(c), H, W)[1] for c in CENTERS])
    pts, cols, msk = jmvs.fuse_depth_maps(d, None, rgb, views["poses"], jmvs.MVSConfig())
    m = np.asarray(msk)
    ref_p, ref_c = np.asarray(pts)[m], np.asarray(cols)[m]
    out_p, out_c = tmvs.fuse_depth_maps(d, rgb, views["poses"])
    assert len(out_p) == len(ref_p) > 300
    np.testing.assert_allclose(out_p, ref_p, atol=1e-4)
    np.testing.assert_allclose(out_c, ref_c, atol=1e-5)


def test_sky_gate_matches_jax():
    rgb = np.random.default_rng(1).uniform(size=(5000, 3)).astype(np.float32)
    rgb[:50] = [0.55, 0.7, 0.95]
    ref = np.asarray(jmvs._is_sky_color(jnp.asarray(rgb)))
    np.testing.assert_array_equal(tmvs._is_sky_color(torch.from_numpy(rgb)).numpy(), ref)
    assert ref.any()


def test_depth_completion_matches_jax():
    rng = np.random.default_rng(2)
    scans = [make_scan(origin=o, rng=rng, h_steps=600) for o in ((0, 0, 0), (0.4, -0.2, 0.1))]
    cap = max(len(s) for s in scans)
    pts = np.zeros((2, cap, 3), np.float32)
    msk = np.zeros((2, cap), bool)
    for i, s in enumerate(scans):
        pts[i, :len(s)], msk[i, :len(s)] = s[:, :3] @ np.float32([[1, 0, 0], [0, 0, -1], [0, 1, 0]]).T, True
    T = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    T[1, :3, 3] = [0.05, -0.02, 0.1]
    ref = np.asarray(jdc.compute_depth_images(jnp.asarray(pts), jnp.asarray(msk),
                                              jnp.asarray(T), 64, 128, max_depth=10.0))
    out = tdc.compute_depth_images(torch.from_numpy(pts), torch.from_numpy(msk),
                                   torch.from_numpy(T), 64, 128, max_depth=10.0).numpy()
    assert (ref > 0).mean() > 0.3
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_voxel_downsample_matches_jax(weighted):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-2, 2, size=(6000, 3)).astype(np.float32)
    msk = rng.uniform(size=6000) > 0.2
    aux = rng.uniform(size=(6000, 3)).astype(np.float32)
    w = rng.uniform(1, 5, size=6000).astype(np.float32) if weighted else None
    ref = jvd.voxel_downsample(jnp.asarray(pts), jnp.asarray(msk), aux=jnp.asarray(aux),
                               leaf=0.3, weights=None if w is None else jnp.asarray(w),
                               return_counts=True)
    out = tvd.voxel_downsample(torch.from_numpy(pts), torch.from_numpy(msk),
                               aux=torch.from_numpy(aux), leaf=0.3,
                               weights=None if w is None else torch.from_numpy(w),
                               return_counts=True)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    for a, b in zip((out[0], out[2], out[3]), (ref[0], ref[2], ref[3])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
