"""The port's camera-LiDAR modules against the JAX package's, on the same
seeded numpy inputs:

  * solver/residuals plane2plane_global and plane_iou, and their
    calibration variants plane2plane_relative and plane_relative_iou:
    values (rtol 1e-5, atol 1e-6), and their Jacobians through the port's
    torch.func path against jax.jacrev (atol 1e-4);
  * models/camera_lidar associate_by_angle_pair on the cases of
    tests/test_camera_lidar.py (true pose, wrong pose): masks, picks and
    votes exactly equal;
  * models/sfm filter_tracks_too_far: the kept set exactly equal;
  * joint_optimize on a line scene small enough that the single-device JAX
    solve stays below its chunk size (64 padded pairs x 128 points), where
    the reference's F1 does not fire: camera and LiDAR poses within 2e-4
    (rad and m) of the JAX result, and the LiDAR poses at least halved in
    error as test_joint_optimize_improves_lidar_poses requires; the same
    bound with the line-track modes: use_image_track on that scene, and
    use_lidar_track alone and with the other two on it with the LiDAR
    lines' directions filled in, so that the line-to-line associations
    make LiDAR line tracks and the gate keeps lines;
  * the LiDAR line tracks of the JAX joint loop's padded pair list (pairs
    padded to 64 with (0, 0), scan 0 associated with itself) equal those
    of the unpadded list that the port uses, and the port's;
  * calibrate (T within 1e-4) and perturb_calibration_search (the same
    pair count, T within 1e-5) on the scenes of tests/test_camera_lidar.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScR

from panovlm_tpu.models import camera_lidar as jcl
from panovlm_tpu.models import sfm as jsfm
from panovlm_tpu.solver import residuals as jres
from panovlm_tpu_torch.models import camera_lidar as tcl
from panovlm_tpu_torch.models import sfm as tsfm
from panovlm_tpu_torch.solver import residuals as tres

from test_camera_lidar import (arcs_from_world_lines, lidar_feats_from_world_lines,
                               make_line_scene)

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


def _pose(rng, n, rot=0.2, trans=1.0):
    return np.concatenate([rng.normal(size=(n, 3)) * rot, rng.normal(size=(n, 3)) * trans],
                          1).astype(np.float32)


def _residual_inputs(rng, n=64):
    pr, pn = _pose(rng, n), _pose(rng, n)
    plane = rng.normal(size=(n, 3)).astype(np.float32)
    plane /= np.linalg.norm(plane, axis=1, keepdims=True)
    a = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    b = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    mid_ref = rng.normal(size=(n, 3)).astype(np.float32)
    mid_ref /= np.linalg.norm(mid_ref, axis=1, keepdims=True)
    plane4 = np.concatenate([plane, rng.normal(size=(n, 1)).astype(np.float32) * 0.1], 1)
    half = rng.uniform(0.0, 0.3, n).astype(np.float32)
    # the calibration variants: one small pose T_cl, LiDAR points 1-3 m out
    pcl = _pose(rng, n, rot=0.05, trans=0.1)
    near = (a / np.linalg.norm(a, axis=1, keepdims=True) * 2.0).astype(np.float32)
    return {"plane2plane_global": (pr, pn, plane, a, b),
            "plane_iou": (pr, pn, plane4, a, mid_ref, half),
            "plane2plane_relative": (pcl, plane, a, b),
            "plane_relative_iou": (pcl, plane4, near, mid_ref, half)}


@pytest.mark.parametrize("name", ["plane2plane_global", "plane_iou", "plane2plane_relative",
                                  "plane_relative_iou"])
def test_cl_residuals_match_jax(name):
    args = _residual_inputs(np.random.default_rng(5))[name]
    ref = np.asarray(jax.vmap(getattr(jres, name))(*map(jnp.asarray, args)))
    out = torch.vmap(getattr(tres, name))(*map(_t, args)).numpy()
    assert (ref > 0).mean() > 0.3
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    # Jacobians w.r.t. the poses, as the LM solver takes them
    argnums = (0,) if name.endswith("relative") or name.endswith("relative_iou") else (0, 1)
    jref = jax.vmap(jax.jacrev(getattr(jres, name), argnums=argnums))(*map(jnp.asarray, args))
    jout = torch.vmap(torch.func.jacrev(getattr(tres, name), argnums=argnums))(*map(_t, args))
    for a, b in zip(jout, jref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


def _assoc_pair(arcs, feats, R, t):
    ref = jcl.associate_by_angle_pair({k: jnp.asarray(v) for k, v in arcs.items()},
                                      {k: jnp.asarray(v) for k, v in feats.items()},
                                      jnp.asarray(R), jnp.asarray(t))
    out = tcl.associate_by_angle_pair({k: _t(v) for k, v in arcs.items()},
                                      {k: _t(v) for k, v in feats.items()},
                                      _t(R), _t(t))
    return ref, out


@pytest.mark.parametrize("case", ["true_pose", "wrong_pose"])
def test_associate_by_angle_pair_matches_jax(case):
    rng = np.random.default_rng(0)
    starts, ends = make_line_scene(rng)
    pose_c = np.zeros(6, np.float32)
    if case == "true_pose":
        pose_l = np.concatenate([[0.01, -0.02, 0.005], [0.1, 0.05, -0.08]]).astype(np.float32)
        arcs = arcs_from_world_lines(starts, ends, pose_c)
        feats = lidar_feats_from_world_lines(starts, ends, pose_l, rng)
        Rj, tj = jcl.relative_cl(jnp.asarray(pose_c), jnp.asarray(pose_l))
        Rt, tt = tcl.relative_cl(_t(pose_c), _t(pose_l))
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-6)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-6)
        ref, out = _assoc_pair(arcs, feats, np.asarray(Rj), np.asarray(tj))
        assert np.asarray(ref["mask"]).sum() >= len(starts) - 1
    else:
        pose_l = np.zeros(6, np.float32)
        arcs = arcs_from_world_lines(starts, ends, pose_c)
        feats = lidar_feats_from_world_lines(starts, ends, pose_l, rng)
        R_bad = ScR.from_rotvec([0.4, 0.3, -0.5]).as_matrix().astype(np.float32)
        t_bad = np.asarray([0.5, -0.4, 0.3], np.float32)
        ref, out = _assoc_pair(arcs, feats, R_bad, t_bad)
    for k in ("mask", "img_line", "votes"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_associate_all_cl_is_the_pairwise_association():
    rng = np.random.default_rng(1)
    starts, ends = make_line_scene(rng, n_lines=12)
    cams = np.zeros((3, 6), np.float32)
    cams[:, 3] = [0.0, 0.2, 0.4]
    lids = cams.copy()
    lids[:, 3] += 0.05
    arcs = [arcs_from_world_lines(starts, ends, c) for c in cams]
    feats = [lidar_feats_from_world_lines(starts, ends, lp, rng) for lp in lids]
    ab = {k: _t(np.stack([a[k] for a in arcs])) for k in arcs[0]}
    lb = {k: _t(np.stack([f[k] for f in feats])) for k in feats[0]}
    fi, li = tcl._cl_pairs(3, 3, 3)
    jfi, jli = jcl._cl_pairs(3, 3, 3)
    np.testing.assert_array_equal(fi, jfi)
    np.testing.assert_array_equal(li, jli)
    out = tcl.associate_all_cl(ab, lb, _t(cams), _t(lids), fi, li)
    for k, (f, l) in enumerate(zip(fi, li)):
        R, t = tcl.relative_cl(_t(cams[f]), _t(lids[l]))
        one = tcl.associate_by_angle_pair({q: _t(v) for q, v in arcs[f].items()},
                                          {q: _t(v) for q, v in feats[l].items()}, R, t)
        for q in ("mask", "img_line", "votes"):
            np.testing.assert_array_equal(out[q][k].numpy(), one[q].numpy())
    assert out["mask"].sum() > 20


def test_filter_tracks_too_far_matches_jax():
    rng = np.random.default_rng(2)
    n, T, L = 8, 300, 5
    # cameras ~1 m apart, 50 m from the world origin (the float32 hazard
    # that the per-track centring guards against)
    poses = np.concatenate([rng.normal(size=(n, 3)) * 0.01,
                            50.0 + rng.normal(size=(n, 3)) * 0.5], 1).astype(np.float32)
    track_img = np.stack([rng.choice(n, L, replace=False) for _ in range(T)]).astype(np.int32)
    track_mask = rng.random((T, L)) < 0.8
    track_mask[:, :2] = True
    R = ScR.from_rotvec(poses[:, :3]).as_matrix()
    C = -np.einsum("nji,nj->ni", R, poses[:, 3:])
    X = (C.mean(0) + rng.normal(size=(T, 3)) * rng.choice([0.5, 3.0, 60.0], (T, 1))
         ).astype(np.float32)
    ok = rng.random(T) < 0.9
    ref = np.asarray(jsfm.filter_tracks_too_far(poses, track_img, track_mask, X, ok, 8.0,
                                                chunk=128))
    out = tsfm.filter_tracks_too_far(_t(poses), _t(track_img), _t(track_mask), _t(X),
                                     _t(ok), 8.0, chunk=128).numpy()
    assert 0.2 < ref.mean() < 0.8
    np.testing.assert_array_equal(out, ref)


def _small_joint_scene(rng, P=128, pts_per_line=8, n_lines=14):
    """make_joint_scene of tests/test_camera_lidar.py with 128 LiDAR point
    slots, so that the JAX solve (64 padded pairs) stays below its chunk."""
    import test_camera_lidar as tc
    old = tc.P_CAP
    tc.P_CAP = P
    try:
        starts, ends = make_line_scene(rng, n_lines=n_lines)
        cam_gt = np.zeros((3, 6), np.float32)
        cam_gt[:, 3] = np.arange(3) * 0.2
        lid_gt = cam_gt.copy()
        lid_gt[:, 3] += 0.05
        arcs = [arcs_from_world_lines(starts, ends, c) for c in cam_gt]
        feats = [lidar_feats_from_world_lines(starts, ends, lp, rng, pts_per_line=pts_per_line)
                 for lp in lid_gt]
    finally:
        tc.P_CAP = old
    arc_batch = {k: np.stack([a[k] for a in arcs]) for k in arcs[0]}
    lidar_batch = {k: np.stack([f[k] for f in feats]) for k in feats[0]}
    for k, shape in [("flat", (3, 64, 3)), ("flat_mask", (3, 64)), ("flat_ground", (3, 64)),
                     ("flat_row", (3, 64)), ("less_flat", (3, 128, 3)),
                     ("less_flat_mask", (3, 128)), ("less_flat_ground", (3, 128)),
                     ("less_flat_row", (3, 128)), ("less_sharp_row", (3, P)),
                     ("line_points", (3, 16, 3)), ("line_dirs", (3, 16, 3)),
                     ("sharp", (3, 16, 3)), ("sharp_mask", (3, 16))]:
        dt = bool if k.endswith("mask") or k.endswith("ground") else (
            np.int32 if k.endswith("row") else np.float32)
        lidar_batch[k] = np.zeros(shape, dt)
    pts3d = rng.uniform(-3, 3, (60, 3)).astype(np.float32)
    pts3d[np.linalg.norm(pts3d, axis=1) < 1.0] += 2.0
    bearings = np.zeros((3, 60, 3), np.float32)
    for i in range(3):
        pc = pts3d @ ScR.from_rotvec(cam_gt[i, :3]).as_matrix().T + cam_gt[i, 3:]
        bearings[i] = pc / np.linalg.norm(pc, axis=1, keepdims=True)
    lid0 = lid_gt.copy()
    lid0[:, :3] += rng.normal(size=(3, 3)).astype(np.float32) * 0.01
    lid0[:, 3:] += rng.normal(size=(3, 3)).astype(np.float32) * 0.03
    return dict(arc_batch=arc_batch, lidar_batch=lidar_batch, cam_gt=cam_gt, lid_gt=lid_gt,
                lid0=lid0, timg=np.tile(np.arange(3), (60, 1)).astype(np.int32),
                tfeat=np.tile(np.arange(60)[:, None], (1, 3)).astype(np.int32),
                tmask=np.ones((60, 3), bool), bearings=bearings, pts3d=pts3d)


def _joint_both(s, **kw):
    """joint_optimize of the JAX package and of the port on scene s."""
    args = (s["cam_gt"], s["lid0"], s["timg"], s["tfeat"], s["tmask"], s["bearings"],
            s["pts3d"], np.ones(60, bool))
    cam_j, lid_j, _, _ = jcl.joint_optimize(
        {k: jnp.asarray(v) for k, v in s["arc_batch"].items()},
        {k: jnp.asarray(v) for k, v in s["lidar_batch"].items()}, *args, jcl.JointConfig(**kw))
    cam_t, lid_t, pts_t, infos_t = tcl.joint_optimize(
        {k: _t(v) for k, v in s["arc_batch"].items()},
        {k: _t(v) for k, v in s["lidar_batch"].items()}, *args, tcl.JointConfig(**kw))
    np.testing.assert_allclose(lid_t.numpy(), np.asarray(lid_j), atol=2e-4, rtol=0)
    np.testing.assert_allclose(cam_t.numpy(), np.asarray(cam_j), atol=2e-4, rtol=0)
    assert torch.isfinite(pts_t).all()
    return lid_t.numpy(), infos_t


# 5 LM iterations: one program of the JAX solve's 5-iteration chunks
# (solve_lm_chunked); both solves have converged by then
_JOINT_KW = dict(num_iteration_joint=1, lidar_weight=0.01, camera_lidar_weight=5.0,
                 max_lm_iters=5)


def test_joint_optimize_matches_jax():
    s = _small_joint_scene(np.random.default_rng(0))
    lid, infos = _joint_both(s, **_JOINT_KW)
    assert len(infos) == 1 and infos[0]["line_pairs"] > 20
    err0 = np.abs(s["lid0"] - s["lid_gt"]).max()
    assert np.abs(lid - s["lid_gt"]).max() < 0.5 * err0
    # use_image_track: the arcs gated by image-line tracks of 3 frames
    lid, infos = _joint_both(s, **_JOINT_KW, use_image_track=True)
    c = infos[0]
    assert 0 < c["image_lines_tracked"] < c["image_lines"] and c["line_pairs"] > 20
    assert np.abs(lid - s["lid_gt"]).max() < 0.7 * err0


def _with_lidar_lines(rng):
    """_small_joint_scene with fewer, denser lines (8 x 16 points, still
    128 slots) and each LiDAR line's point and unit direction (scan frame)
    filled in from its endpoints, so that the line-to-line association
    links the lines of neighbouring scans."""
    s = _small_joint_scene(rng, pts_per_line=16, n_lines=8)
    lb = dict(s["lidar_batch"])
    ends = lb["line_endpoints"]
    d = ends[:, :, 1] - ends[:, :, 0]
    n = np.linalg.norm(d, axis=-1, keepdims=True)
    lb["line_points"] = (0.5 * (ends[:, :, 0] + ends[:, :, 1])).astype(np.float32)
    lb["line_dirs"] = np.where(n > 0, d / np.maximum(n, 1e-12), 0).astype(np.float32)
    return dict(s, lidar_batch=lb)


@pytest.mark.parametrize("modes", ["lidar", "all"])
def test_joint_optimize_track_modes_match_jax(modes):
    s = _with_lidar_lines(np.random.default_rng(0))
    kw = dict(_JOINT_KW, use_lidar_track=True)
    if modes == "all":
        kw.update(use_image_track=True, use_track_associate=True)
    lid, infos = _joint_both(s, **kw)
    c = infos[0]
    assert 0 < c["lidar_lines_tracked"] <= c["lidar_lines"], c
    if modes == "all":
        assert c["line_pairs_tracked"] > 0 and c["line_pairs"] == c["line_pairs_tracked"]
    err0 = np.abs(s["lid0"] - s["lid_gt"]).max()
    assert np.abs(lid - s["lid_gt"]).max() < 0.7 * err0


def test_lidar_line_tracks_ignore_the_padded_pairs():
    """The JAX joint loop pads its LiDAR pairs to 64 with (0, 0) pairs and
    builds the line tracks on the padded list (camera_lidar.py:274-296):
    scan 0 associated with itself gives only self-edges, so the tracks are
    those of the unpadded list, which the port uses, and the port's own."""
    from panovlm_tpu.models import association as jassoc
    from panovlm_tpu.models import line_tracks as jlt
    from panovlm_tpu.models.lidar_odometry import _pad_pairs
    from panovlm_tpu_torch.models import association as tassoc
    from panovlm_tpu_torch.models import line_tracks as tlt
    s = _with_lidar_lines(np.random.default_rng(0))
    lb, poses = s["lidar_batch"], s["lid_gt"]
    pr, pn = tassoc.find_neighbors(_t(poses), np.ones(3, bool))
    pr_p, pn_p, _ = _pad_pairs(pr, pn)
    jb = {k: jnp.asarray(v) for k, v in lb.items()}
    pad = jassoc.associate_all_pairs(jb, jnp.asarray(poses), pr_p, pn_p)["l2l"]
    tid_pad = jlt.lidar_line_tracks(pad, pr_p, pn_p, 3, 16)
    m = len(pr)
    self_r = np.asarray(pad["seg_r"])[m:][np.asarray(pad["mask"])[m:]]
    self_n = np.nonzero(np.asarray(pad["mask"])[m:])[1]
    np.testing.assert_array_equal(self_r, self_n)          # only self-edges
    tid = jlt.lidar_line_tracks({k: np.asarray(v)[:m] for k, v in pad.items()}, pr, pn, 3, 16)
    np.testing.assert_array_equal(tid_pad, tid)
    port = tassoc.associate_all_pairs({k: _t(v) for k, v in lb.items()}, _t(poses), _t(pr),
                                      _t(pn))["l2l"]
    out = tlt.lidar_line_tracks({k: v.numpy() for k, v in port.items()}, pr, pn, 3, 16)
    np.testing.assert_array_equal(out, tid)
    assert (tid >= 0).sum() >= 15


def _calibration_scene(seed, noise):
    from test_camera_lidar import arcs_from_world_lines, lidar_feats_from_world_lines
    rng = np.random.default_rng(seed)
    starts, ends = make_line_scene(rng, n_lines=14)
    pose = np.zeros(6, np.float32)
    return (arcs_from_world_lines(starts, ends, pose),
            lidar_feats_from_world_lines(starts, ends, pose, rng, noise=noise))


def test_calibrate_matches_jax():
    """test_calibrate_recovers_extrinsic's scene and start."""
    arcs, feats = _calibration_scene(0, 0.001)
    T0 = np.eye(4)
    T0[:3, :3] = ScR.from_rotvec([0.02, -0.015, 0.01]).as_matrix()
    T0[:3, 3] = [0.03, -0.02, 0.04]
    ref, _ = jcl.calibrate({k: jnp.asarray(v) for k, v in arcs.items()},
                           {k: jnp.asarray(v) for k, v in feats.items()}, T0)
    out, info = tcl.calibrate(arcs, feats, T0, device="cpu")
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    assert np.degrees(np.linalg.norm(ScR.from_matrix(out[:3, :3]).as_rotvec())) < 0.2
    assert info["final_cost"] < info["initial_cost"]


def test_perturb_calibration_search_matches_jax():
    """test_perturb_calibration_search's scene and start."""
    arcs, feats = _calibration_scene(0, 0.003)
    T0 = np.eye(4)
    T0[:3, :3] = ScR.from_euler("xyz", [1.2, -0.9, 0.7], degrees=True).as_matrix()
    T0[:3, 3] = [0.06, -0.04, 0.05]
    ref, n_ref = jcl.perturb_calibration_search({k: jnp.asarray(v) for k, v in arcs.items()},
                                                {k: jnp.asarray(v) for k, v in feats.items()},
                                                T0, max_iterations=8)
    out, n_out = tcl.perturb_calibration_search(arcs, feats, T0, max_iterations=8, device="cpu")
    assert n_out == n_ref
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    n0 = int(tcl.associate_by_angle_pair({k: _t(v) for k, v in arcs.items()},
                                         {k: _t(v) for k, v in feats.items()},
                                         _t(T0[:3, :3].astype(np.float32)),
                                         _t(T0[:3, 3].astype(np.float32)))["mask"].sum())
    assert n_out >= n0
