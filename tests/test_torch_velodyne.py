"""LiDAR frontend of the port (panovlm_tpu_torch/sensors/velodyne.py and
lidar_lines.py) against the JAX package on two synthetic VLP-16 scans
(tests/synthetic.make_trajectory_scans, 900 azimuth steps), on the same
numpy inputs.

Tolerance: masks, indices and int buffers bit-exact; gathered coordinates
(sharp, less_sharp, flat, less_flat) exact; computed floats (line fits) within
rtol 1e-5, atol 1e-6 — the PCA fits sum over points in another order. No mask
flips on these scans: the port evaluates every decision's float expression as
XLA compiles it (panovlm_tpu_torch/ops/exact.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic
from panovlm_tpu.sensors import lidar_lines as jll
from panovlm_tpu.sensors import velodyne as jvd
from panovlm_tpu_torch.sensors import lidar_lines as tll
from panovlm_tpu_torch.sensors import velodyne as tvd

torch.set_num_threads(2)

GATHERED = ("sharp", "less_sharp", "flat", "less_flat")


@pytest.fixture(scope="module")
def scans():
    raw, _ = synthetic.make_trajectory_scans(n_scans=2, h_steps=900)
    pads = [jvd.pad_points(jvd.preprocess_cloud(s)[0], 16384) for s in raw]
    return np.stack([p for p, _ in pads]), np.stack([m for _, m in pads])


@pytest.fixture(scope="module")
def both(scans):
    pts, msk = scans
    jf = jax.jit(jax.vmap(lambda p, m: jvd.extract_features(p, m)[0]))(pts, msk)
    tf = tvd.extract_features(torch.from_numpy(pts), torch.from_numpy(msk))
    return {k: np.asarray(getattr(jf, k)) for k in jf._fields}, \
        {k: v.numpy() for k, v in tf.items()}


def _check(name, a, b):
    assert a.shape == b.shape, name
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer) or name in GATHERED:
        bad = np.argwhere(a != b)
        assert len(bad) == 0, f"{name}: {len(bad)} mismatches, first at {bad[:5].tolist()}"
    else:
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=name)


def test_extract_features_matches_jax(both):
    jf, tf = both
    assert set(jf) == set(tf)
    assert jf["less_sharp_mask"].sum() > 50 and jf["line_mask"].sum() > 3
    for k in jf:
        _check(k, jf[k], tf[k])


def test_extract_lines_matches_jax(both):
    """extract_lines on the JAX package's own edge buffers."""
    jf, _ = both
    pts = jf["less_sharp"]
    mask = jf["less_sharp_mask"] | (jf["less_sharp_row"] >= 0)
    rows = jf["less_sharp_row"]
    ref = jax.vmap(jll.extract_lines)(jnp.asarray(pts), jnp.asarray(mask),
                                      jnp.asarray(rows))
    out = tll.extract_lines(torch.from_numpy(pts), torch.from_numpy(mask),
                            torch.from_numpy(rows))
    for k in ("mask", "point_label", "points", "dirs", "endpoints"):
        _check(k, np.asarray(ref[k]), out[k].numpy())


@pytest.mark.parametrize("l,seed", [(0, 0), (3, 7), (63, 12345)])
def test_hyp_priorities_bit_equal(l, seed):
    ref = np.asarray(jll._hyp_priorities(1024, 4096, l, seed)).astype(np.int64)
    out = tll._hyp_priorities(1024, 4096, l, seed).numpy()
    assert (ref == out).all()


def test_decimation_hash_bit_equal():
    cell = np.arange(16 * 1800, dtype=np.int32)
    ref = np.asarray((jnp.asarray(cell).astype(jnp.uint32) * jnp.uint32(2654435761))
                     .astype(jnp.float32) * jnp.float32(1.0 / 4294967296.0))
    out = tvd._decimation_hash(torch.from_numpy(cell)).numpy()
    assert (ref == out).all()


def test_range_image_and_curvature_stages_match_jax(scans):
    pts, msk = scans
    img = jvd.build_range_image(pts[0], msk[0])
    timg = tvd.build_range_image(torch.from_numpy(pts[:1]), torch.from_numpy(msk[:1]))
    for k in ("range", "xyz", "valid"):
        assert (np.asarray(img[k]) == timg[k][0].numpy()).all(), k
    _, keep = jvd.segment_range_image(img["range"], img["valid"])
    tkeep = tvd.segment_range_image(timg["range"], timg["valid"])
    assert (np.asarray(keep) == tkeep[0].numpy()).all()
    img = dict(img, ground=jvd.mark_ground(img) & img["valid"])
    seq = jvd.compact_rows(img)
    tseq = {k: torch.from_numpy(np.array(v))[None] for k, v in seq.items()}
    curv, m, wok = jvd.adaptive_curvature(seq)
    tcurv, tm, twok = tvd.adaptive_curvature(tseq)
    assert (np.asarray(curv) == tcurv[0].numpy()).all()
    assert (np.asarray(m) == tm[0].numpy()).all()
    assert (np.asarray(wok) == twok[0].numpy()).all()
