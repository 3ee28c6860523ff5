"""The port's line-track modules against the JAX package's, on the same
seeded inputs:

  * ops/lbd: the gradients equal jnp.gradient's bit for bit (one-sided on
    the border, not zero); line_band_descriptors(_batch) on rendered
    panoramas within 1e-4 per element, with 99.5 % of the elements within
    1e-5 (the JAX function gives up to 3.9e-5 between its jitted and its
    op-by-op evaluation there: float32 rounding of the arc sampling is
    amplified by the support region's lever); the population std matters
    (correction=1 moves them by more than 1e-4); lbd_distance_matrix
    within 1e-5;
  * match_image_lines_pair with and without descriptors: equal index
    arrays, with no candidate within 1e-4 deg of the 3 deg gate;
  * native/lk against cv2.calcOpticalFlowPyrLK at cv2's defaults on
    textured, shifted, rotated and rendered pairs with points up to 5 px
    outside the image: the status equal, the positions within 0.01 px where
    it is 1 (and bit-equal on these inputs);
  * filter_matches_optical_flow, image_line_tracks and
    camera_lidar_track_associate: equal outputs (the track ids and the
    association arrays bit for bit, as the edge and set orders are JAX's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panovlm_tpu.models import line_tracks as jlt
from panovlm_tpu.ops import lbd as jlbd
from panovlm_tpu.utils import panorama_line as jpl
from panovlm_tpu_torch.models import line_tracks as tlt
from panovlm_tpu_torch.native import lk
from panovlm_tpu_torch.ops import lbd as tlbd
from panovlm_tpu_torch.utils import panorama_line as tpl

from synthetic import render_panorama
from test_camera_lidar import arcs_from_world_lines, make_line_scene

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

H, W = 256, 512


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def panos():
    """Two rendered panoramas (float [0, 1]) a short step apart, their arcs
    (the JAX function's, cap 64) and JAX's jitted descriptors."""
    gs = [np.clip(render_panorama(np.array([x, 0.4, z]), H, W)[0], 0, 1).astype(np.float32)
          for x, z in ((0.0, 0.0), (0.05, 0.02))]
    u8 = [(g * 255).astype(np.uint8) for g in gs]
    arcs = [jpl.extract_panorama_lines(g, cap=64, with_descriptors=False) for g in u8]
    batch = {k: np.stack([a[k] for a in arcs]) for k in arcs[0]}
    gf = np.stack(u8).astype(np.float32) / 255.0
    batch["desc"] = np.asarray(jlbd.line_band_descriptors_batch(
        jnp.asarray(gf), jnp.asarray(batch["e1"]), jnp.asarray(batch["e2"]),
        jnp.asarray(batch["mask"])))
    return dict(grays=gs, u8=u8, gf=gf, batch=batch)


def test_gradients_are_jnp_gradient():
    g = np.random.default_rng(0).random((40, 64)).astype(np.float32)
    gx, gy = tlbd._gradients(_t(g))
    jgx, jgy = jlbd._gradients(jnp.asarray(g))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jgy))
    # one-sided on the border, not zero as the JAX docstring says
    np.testing.assert_array_equal(gx[:, 0].numpy(), g[:, 1] - g[:, 0])
    np.testing.assert_array_equal(gy[-1].numpy(), g[-1] - g[-2])


def test_line_band_descriptors_match_jax(panos):
    b = panos["batch"]
    assert b["mask"].sum(1).min() > 10
    out = tlbd.line_band_descriptors_batch(_t(panos["gf"]), _t(b["e1"]), _t(b["e2"]),
                                           _t(b["mask"])).numpy()
    d = np.abs(out - b["desc"])
    assert d.max() <= 1e-4 and (d <= 1e-5).mean() >= 0.995, (d.max(), (d <= 1e-5).mean())
    norms = np.linalg.norm(out, axis=-1)
    np.testing.assert_allclose(norms[b["mask"]], 1.0, atol=1e-5)
    assert (norms[~b["mask"]] == 0).all()
    one = tlbd.line_band_descriptors(_t(panos["gf"][1]), _t(b["e1"][1]), _t(b["e2"][1]),
                                     _t(b["mask"][1])).numpy()
    np.testing.assert_array_equal(one, out[1])


def test_line_band_descriptors_need_the_population_std(panos, monkeypatch):
    b = panos["batch"]
    std = torch.Tensor.std
    monkeypatch.setattr(torch.Tensor, "std", lambda x, dim, correction: std(x, dim=dim,
                                                                             correction=1))
    out = tlbd.line_band_descriptors(_t(panos["gf"][0]), _t(b["e1"][0]), _t(b["e2"][0]),
                                     _t(b["mask"][0])).numpy()
    assert np.abs(out - b["desc"][0]).max() > 1e-4      # beyond the tolerance above


def test_lbd_distance_matrix_matches_jax(panos):
    d = panos["batch"]["desc"]
    ref = np.asarray(jlbd.lbd_distance_matrix(jnp.asarray(d[0]), jnp.asarray(d[1])))
    out = tlbd.lbd_distance_matrix(_t(d[0]), _t(d[1])).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    assert out.shape == (64, 64) and (ref < 0.5).sum() > 10


def test_extract_panorama_lines_batch_with_descriptors(panos):
    out = tpl.extract_panorama_lines_batch(panos["grays"], cap=64, with_descriptors=True,
                                           num_threads=2, device="cpu")
    b = panos["batch"]
    np.testing.assert_array_equal(out["mask"], b["mask"])
    ref = tlbd.line_band_descriptors_batch(_t(panos["gf"]), _t(out["e1"]), _t(out["e2"]),
                                           _t(out["mask"])).numpy()
    np.testing.assert_array_equal(out["desc"], ref)
    assert np.abs(out["desc"] - b["desc"]).max() <= 1e-4


def _gate_margin(ai, aj, pose_i, pose_j):
    """Smallest |normal angle - 3 deg| over the valid candidate pairs (deg),
    in float64."""
    from scipy.spatial.transform import Rotation as ScR
    R_ij = ScR.from_rotvec(pose_i[:3]).as_matrix() @ ScR.from_rotvec(pose_j[:3]).as_matrix().T
    n_j_in_i = aj["normal"].astype(np.float64) @ R_ij.T
    ang = np.degrees(np.arccos(np.clip(np.abs(n_j_in_i @ ai["normal"].T), -1, 1)))
    valid = aj["mask"][:, None] & ai["mask"][None, :]
    return np.abs(ang - 3.0)[valid].min()


def _match_both(ai, aj, pose_i, pose_j):
    ref = np.asarray(jlt.match_image_lines_pair({k: jnp.asarray(v) for k, v in ai.items()},
                                                {k: jnp.asarray(v) for k, v in aj.items()},
                                                jnp.asarray(pose_i), jnp.asarray(pose_j)))
    out = tlt.match_image_lines_pair({k: _t(v) for k, v in ai.items()},
                                     {k: _t(v) for k, v in aj.items()}, _t(pose_i), _t(pose_j))
    return ref, out.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_image_lines_pair_matches_jax(seed):
    """Geometric matching on seeded line scenes (no descriptors)."""
    rng = np.random.default_rng(seed)
    starts, ends = make_line_scene(rng, n_lines=16)
    pose0 = np.zeros(6, np.float32)
    pose1 = np.concatenate([rng.normal(size=3) * 0.02, rng.normal(size=3) * 0.1]
                           ).astype(np.float32)
    a0, a1 = arcs_from_world_lines(starts, ends, pose0), arcs_from_world_lines(starts, ends, pose1)
    assert _gate_margin(a0, a1, pose0, pose1) > 1e-4
    ref, out = _match_both(a0, a1, pose0, pose1)
    np.testing.assert_array_equal(out, ref)
    assert (ref >= 0).sum() >= 5


def test_match_image_lines_pair_with_descriptors_matches_jax(panos):
    b = panos["batch"]
    ai = {k: v[0] for k, v in b.items()}
    aj = {k: v[1] for k, v in b.items()}
    pose = np.zeros(6, np.float32)
    assert _gate_margin(ai, aj, pose, pose) > 1e-4
    ref, out = _match_both(ai, aj, pose, pose)
    np.testing.assert_array_equal(out, ref)
    assert (ref >= 0).sum() >= 5
    # the descriptors decide: the geometric ranking alone matches differently
    geo, _ = _match_both({k: v for k, v in ai.items() if k != "desc"},
                         {k: v for k, v in aj.items() if k != "desc"}, pose, pose)
    assert (geo != ref).any()


def _lk_cases():
    rng = np.random.default_rng(0)
    tex = cv2.GaussianBlur((rng.random((300, 400)) * 255).astype(np.uint8), (0, 0), 1.5)
    sharp = (np.kron(rng.random((75, 100)), np.ones((4, 4))) * 255).astype(np.uint8)
    rot = cv2.warpAffine(sharp, cv2.getRotationMatrix2D((200, 150), 4.0, 1.02), (400, 300),
                         borderMode=cv2.BORDER_REFLECT)
    g1, g2 = (render_panorama(np.array([x, 0.4, z]), H, W)[0] for x, z in ((0, 0), (0.05, 0.02)))
    pano = [(g * 255).astype(np.uint8) for g in (g1, g2)]

    def pts(h, w, n=1500):   # up to 5 px outside the image
        return np.stack([rng.uniform(-5, w + 5, n), rng.uniform(-5, h + 5, n)],
                        1).astype(np.float32)
    return {"textured shift": (tex, np.roll(tex, (3, -5), (0, 1)), pts(300, 400)),
            "sharp shift": (sharp, np.roll(sharp, (1, -2), (0, 1)), pts(300, 400)),
            "sharp rotated": (sharp, rot, pts(300, 400)),
            "panorama": (pano[0], pano[1], pts(H, W))}


@pytest.mark.parametrize("case", ["textured shift", "sharp shift", "sharp rotated", "panorama"])
def test_lk_matches_cv2(case):
    a, b, p = _lk_cases()[case]
    ref, st_ref, _ = cv2.calcOpticalFlowPyrLK(a, b, p.reshape(-1, 1, 2), None)
    ref, st_ref = ref.reshape(-1, 2), st_ref.ravel().astype(bool)
    out, st = lk.track(a, b, p)
    np.testing.assert_array_equal(st, st_ref)
    assert 0.5 < st.mean()
    d = np.abs(out - ref)[st]
    assert d.max() <= 0.01 and (d == 0).all(1).mean() >= 0.99, (d.max(), (d == 0).mean())


def test_lk_rejects_images_too_small_for_the_window():
    with pytest.raises(ValueError, match="too small"):
        lk.track(np.zeros((20, 64), np.uint8), np.zeros((20, 64), np.uint8),
                 np.zeros((1, 2), np.float32))


def _filter_case():
    """tests/test_aux_components.py::test_optical_flow_filter_rejects_wrong_
    line_match: the port's arcs of a rendered pair, matched geometrically."""
    g1, _ = render_panorama(np.array([0.0, 0.4, 0.0]), H, W)
    g2, _ = render_panorama(np.array([0.05, 0.4, 0.02]), H, W)
    a1 = tpl.extract_panorama_lines((g1 * 255).astype(np.uint8), cap=64)
    a2 = tpl.extract_panorama_lines((g2 * 255).astype(np.uint8), cap=64)
    pose = np.zeros(6, np.float32)
    m = tlt.match_image_lines_pair({k: _t(v) for k, v in a1.items()},
                                   {k: _t(v) for k, v in a2.items()}, _t(pose), _t(pose)).numpy()
    return g1.astype(np.float32), g2.astype(np.float32), a1, a2, m


def test_filter_matches_optical_flow_matches_jax():
    g1, g2, a1, a2, m = _filter_case()
    good = np.nonzero(m >= 0)[0]
    assert len(good) >= 3
    for px in (20.0, 60.0):
        ref = jlt.filter_matches_optical_flow(a2, a1, g2, g1, m, max_median_px=px)
        stats = {}
        out = tlt.filter_matches_optical_flow(a2, a1, g2, g1, m, max_median_px=px, stats=stats)
        np.testing.assert_array_equal(out, ref)
        assert stats["lk_points"] == 10 * len(good) and 0 < stats["lk_ok"] <= stats["lk_points"]
    kept = ref[good] >= 0
    assert kept.mean() > 0.5
    # a match corrupted to a non-collinear line of frame 1 is rejected by both
    row = good[kept][0]
    wrong = next(i for i in np.nonzero(a1["mask"])[0]
                 if abs(a1["normal"][i] @ a1["normal"][m[row]]) < 0.7)
    bad = m.copy()
    bad[row] = wrong
    ref = jlt.filter_matches_optical_flow(a2, a1, g2, g1, bad, max_median_px=20.0)
    out = tlt.filter_matches_optical_flow(a2, a1, g2, g1, bad, max_median_px=20.0)
    np.testing.assert_array_equal(out, ref)
    assert out[row] == -1


def test_image_line_tracks_match_jax_geometric():
    """tests/test_aux_components.py::test_image_line_tracks's scene, over
    four frames with a window of 2."""
    rng = np.random.default_rng(0)
    starts, ends = make_line_scene(rng, n_lines=12)
    poses = np.zeros((4, 6), np.float32)
    poses[:, :3] = rng.normal(size=(4, 3)) * 0.02
    poses[:, 3:] = rng.normal(size=(4, 3)) * 0.05
    arcs = [arcs_from_world_lines(starts, ends, p) for p in poses]
    batch = {k: np.stack([a[k] for a in arcs]) for k in arcs[0]}
    for min_length in (2, 3):
        ref = jlt.image_line_tracks({k: jnp.asarray(v) for k, v in batch.items()}, poses,
                                    window=2, min_length=min_length)
        out = tlt.image_line_tracks({k: _t(v) for k, v in batch.items()}, _t(poses),
                                    window=2, min_length=min_length)
        np.testing.assert_array_equal(out, ref)
        assert (out >= 0).sum() >= 20


def test_image_line_tracks_match_jax_with_descriptors_and_flow(panos):
    """Three rendered frames: LBD-ranked matches filtered by the LK flow."""
    b = dict(panos["batch"])
    g3 = np.clip(render_panorama(np.array([0.1, 0.4, 0.04]), H, W)[0], 0, 1).astype(np.float32)
    u8 = (g3 * 255).astype(np.uint8)
    a3 = jpl.extract_panorama_lines(u8, cap=64, with_descriptors=False)
    a3["desc"] = np.asarray(jlbd.line_band_descriptors(
        jnp.asarray(u8.astype(np.float32) / 255.0), jnp.asarray(a3["e1"]),
        jnp.asarray(a3["e2"]), jnp.asarray(a3["mask"])))
    b = {k: np.concatenate([v, a3[k][None]]) for k, v in b.items()}
    grays = panos["grays"] + [g3]
    poses = np.zeros((3, 6), np.float32)
    ref = jlt.image_line_tracks(b, poses, window=1, min_length=3, grays=grays)
    stats = {}
    out = tlt.image_line_tracks({k: _t(v) for k, v in b.items()}, _t(poses), window=1,
                                min_length=3, grays=grays, stats=stats)
    np.testing.assert_array_equal(out, ref)
    assert (out >= 0).sum() >= 9 and stats["lk_points"] > 0


def _track_associate_case():
    """tests/test_camera_lidar.py::test_camera_lidar_track_associate_votes_
    and_distributes."""
    P, Ls, Li = 4, 6, 5
    fi = np.array([0, 0, 1, 1], np.int32)
    li = np.array([0, 1, 0, 1], np.int32)
    mask = np.zeros((P, Ls), bool)
    img_line = np.zeros((P, Ls), np.int32)
    mask[0, 2], img_line[0, 2] = True, 1
    mask[0, 4], img_line[0, 4] = True, 3
    img_track = np.full((5, Li), -1, np.int64)
    img_track[0, 1] = img_track[1, 2] = 0
    img_track[0, 3] = img_track[2, 0] = img_track[2, 1] = img_track[3, 0] = img_track[4, 0] = 1
    lid_track = np.full((5, Ls), -1, np.int64)
    lid_track[0, 2] = lid_track[1, 0] = 0
    lid_track[0, 4] = lid_track[2, 0] = lid_track[2, 1] = lid_track[3, 0] = lid_track[4, 0] = 1
    return {"mask": mask, "img_line": img_line}, fi, li, img_track, lid_track


def _shared_slot_case():
    """Two validated track pairs that touch the same LiDAR-line slot: image
    tracks 0 and 1 both meet LiDAR track 0 on frame 0 and scan 0; the set
    order of the validated pairs decides which image line fills it."""
    fi = np.array([0, 0, 1, 1], np.int32)
    li = np.array([0, 1, 0, 1], np.int32)
    mask = np.zeros((4, 4), bool)
    img_line = np.zeros((4, 4), np.int32)
    mask[0, 1], img_line[0, 1] = True, 0      # image track 0 <-> LiDAR track 0
    mask[3, 2], img_line[3, 2] = True, 3      # image track 1 <-> LiDAR track 0
    img_track = np.full((2, 5), -1, np.int64)
    img_track[0, 0] = img_track[1, 1] = 0
    img_track[0, 2] = img_track[1, 3] = 1
    lid_track = np.full((2, 4), -1, np.int64)
    lid_track[0, 1] = lid_track[1, 2] = 0
    return {"mask": mask, "img_line": img_line}, fi, li, img_track, lid_track


@pytest.mark.parametrize("case", [_track_associate_case, _shared_slot_case])
def test_camera_lidar_track_associate_matches_jax(case):
    assoc, fi, li, it, lt = case()
    ref_m, ref_l = jlt.camera_lidar_track_associate(assoc, fi, li, it, lt)
    out_m, out_l = tlt.camera_lidar_track_associate({k: _t(v) for k, v in assoc.items()},
                                                    _t(fi), _t(li), _t(it), _t(lt))
    np.testing.assert_array_equal(out_m, ref_m)
    np.testing.assert_array_equal(out_l, ref_l)
    assert out_m.sum() == 4
    if case is _shared_slot_case:
        # both pairs validated and distributed; every slot is claimed by
        # both image tracks, and the set order decides which line it keeps
        assert out_m[0, 1] and out_m[3, 2] and out_m[1, 2] and out_m[2, 1]
