"""Camera-LiDAR joint optimization — the port of
`panovlm_tpu/models/camera_lidar.py` (joint_optimization/CameraLidarOptimizer
and CameraLidarLineAssociate of the reference): the MAPPING mode with its
line-track modes, and the CALIBRATION mode.

  * associate_by_angle_pair: image lines (great-circle planes through the
    camera centre) against LiDAR line segments. The (image line x LiDAR
    point) angle tests are dense; a point votes for its segment when it
    lies within 3 deg of the image line's plane and inside its arc scope; a
    segment is accepted when more than half its points vote, the two
    planes agree within 3 deg, its midpoint lies within 1.5 deg of the
    plane and inside the arc, and the pick is one-to-one by votes.
  * associate_all_cl: every (frame, scan) pair in chunks of pairs (plain
    torch; the votes are an int64 scatter, so the picks are deterministic).
  * joint_optimize (CameraLidarOptimizer.cpp:177-298): num_iteration_joint
    rounds of re-association and one LM problem over camera poses, LiDAR
    poses and points: camera-LiDAR line residuals (Plane2Plane_Global +
    PlaneIOU, weight camera_lidar_weight), camera reprojection (weight
    camera_weight) and the LiDAR odometry families (weight lidar_weight);
    the first camera is fixed. The points are eliminated by the Schur tier
    of `solver/lm.py`, since only the reprojection block touches them. The
    line-track modes (AssociateLineMulti's flags, CameraLidarOptimizer.cpp:
    331-671) gate the association each round: use_image_track keeps the
    image lines on image-line tracks (models/line_tracks.py, matched with
    the LBD descriptors when the arcs carry them and filtered by LK flow
    when the frames are given), use_lidar_track the LiDAR lines on tracks
    of the round's line-to-line associations, and use_track_associate (with
    both) replaces the association by the track-level one.
  * perturb_calibration_search (AssociateRandomDisturbance,
    CameraLidarLineAssociate.cpp:477-622) and calibrate (CALIBRATION,
    CameraLidarOptimizer.cpp:32-87): the extrinsic T_cl of one frame/scan
    pair, by a grid search over 3^6 perturbations and an LM solve.

The JAX module's chunked and sharded solves are TPU and multi-chip
workarounds and are not carried over. Unlike the JAX module, the LiDAR pair
list is not padded to a multiple of 64 with (0, 0) pairs; the LiDAR line
tracks of the padded list are the same (tests/test_torch_camera_lidar.py).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import se3
from ..solver import residuals
from ..solver.lm import LMOptions, ResidualBlock, solve_lm
from ..utils.membudget import device_chunk
from . import association, lidar_odometry

log = logging.getLogger("panovlm")

OFF_PLANE_DEG = 3.0        # point voting gate
PLANE_PLANE_DEG = 3.0      # line-pair plane angle gate
MID_OFF_PLANE_DEG = 1.5    # midpoint off-plane gate
ARC_SLACK = 1.1            # arc-scope slack factor

_FEATS = ("less_sharp", "less_sharp_mask", "point_to_segment", "line_endpoints",
          "line_mask")
_ARCS = ("normal", "mid", "arc", "mask")


def relative_cl(pose_c, pose_l):
    """T_cl from world poses [aa_*w, t_*w]: p_c = R_cl p_l + t_cl."""
    R_cw = se3.exp_so3(pose_c[..., :3])
    R_lw = se3.exp_so3(pose_l[..., :3])
    R_cl = R_cw @ R_lw.transpose(-1, -2)
    t_cl = pose_c[..., 3:] - torch.einsum("...ij,...j->...i", R_cl, pose_l[..., 3:])
    return R_cl, t_cl


def _unit(v):
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)


def _deg(x):
    return x * (180.0 / math.pi)


def _in_arc(v_unit, ndp, arcs):
    """Angle between v's projection into each image line's plane and the
    line's mid ray, within half the arc (with slack). v_unit (B, X, 3),
    ndp (B, Li, X) -> (B, Li, X)."""
    proj = _unit(v_unit[:, None] - ndp[..., None] * arcs["normal"][:, :, None])
    cos_mid = torch.einsum("blxk,blk->blx", proj, arcs["mid"])
    return torch.arccos(torch.clamp(cos_mid, -1, 1)) <= (arcs["arc"][..., None] / 2) * ARC_SLACK


def associate_batch(arcs, feats, R_cl, t_cl):
    """associate_by_angle_pair over a leading batch of B pairs: arcs values
    (B, Li, ...), feats values (B, ...), R_cl (B,3,3), t_cl (B,3)."""
    n_img = arcs["normal"]                               # (B, Li, 3) camera frame
    pts_l = feats["less_sharp"]                          # (B, P, 3) LiDAR frame
    pmask = feats["less_sharp_mask"]
    seg_raw = feats["point_to_segment"]
    seg = torch.clamp_min(seg_raw, 0).long()
    seg_valid = seg_raw >= 0
    ends = feats["line_endpoints"]                       # (B, Ls, 2, 3)
    lmask = feats["line_mask"]
    B, Ls = ends.shape[:2]
    Li = n_img.shape[1]

    p_n = _unit(torch.einsum("bpk,bjk->bpj", pts_l, R_cl) + t_cl[:, None])
    ndp = torch.einsum("blk,bpk->blp", n_img, p_n)
    off_plane = _deg(torch.abs(torch.arcsin(torch.clamp(ndp, -1, 1))))
    vote = ((off_plane <= OFF_PLANE_DEG) & _in_arc(p_n, ndp, arcs)
            & (pmask & seg_valid)[:, None] & arcs["mask"][..., None])
    votes = torch.zeros((B, Li, Ls), dtype=torch.int64, device=pts_l.device)
    votes.scatter_add_(2, seg[:, None].expand(B, Li, seg.shape[1]), vote.long())
    seg_size = torch.zeros((B, Ls), dtype=torch.int64, device=pts_l.device)
    seg_size.scatter_add_(1, seg, (pmask & seg_valid).long())
    majority = votes * 2 > seg_size[:, None]

    e_c = torch.einsum("bsek,bik->bsei", ends, R_cl) + t_cl[:, None, None]
    n_lidar = _unit(torch.linalg.cross(e_c[:, :, 0], e_c[:, :, 1], dim=-1))
    pp_cos = torch.abs(torch.einsum("blk,bsk->bls", n_img, n_lidar))
    pp_ok = _deg(torch.arccos(torch.clamp(pp_cos, -1, 1))) <= PLANE_PLANE_DEG
    m_n = _unit(0.5 * (e_c[:, :, 0] + e_c[:, :, 1]))
    m_ndp = torch.einsum("blk,bsk->bls", n_img, m_n)
    mid_off = _deg(torch.abs(torch.arcsin(torch.clamp(m_ndp, -1, 1)))) <= MID_OFF_PLANE_DEG

    ok = (majority & pp_ok & mid_off & _in_arc(m_n, m_ndp, arcs)
          & lmask[:, None] & arcs["mask"][..., None])
    votes = torch.where(ok, votes, torch.zeros_like(votes))
    # one-to-one: each segment's best image line must pick it back
    best_v = torch.amax(votes, dim=1)                    # (B, Ls)
    best_img = torch.argmax(votes, dim=1)
    col_best = torch.argmax(votes, dim=2)                # (B, Li)
    accept = (best_v > 0) & (torch.gather(col_best, 1, best_img)
                             == torch.arange(Ls, device=votes.device))
    return {"mask": accept, "img_line": best_img.to(torch.int32),
            "endpoints_l": ends, "votes": best_v}


def associate_by_angle_pair(arcs, lidar_feats, R_cl, t_cl):
    """One (image, scan) association. arcs: padded arc dict (normal/e1/e2/
    mid/arc/mask, Li arcs). lidar_feats: one scan's features (less_sharp
    (P,3) + mask + point_to_segment, line_endpoints (Ls,2,3) + line_mask).
    Returns per LiDAR segment: mask, img_line (Ls,), endpoints_l
    (Ls,2,3), votes."""
    out = associate_batch({k: arcs[k][None] for k in _ARCS},
                          {k: lidar_feats[k][None] for k in _FEATS},
                          R_cl[None], t_cl[None])
    return {k: v[0] for k, v in out.items()}


class JointConfig(NamedTuple):
    num_iteration_joint: int = 1
    neighbor_size_joint: int = 3
    camera_weight: float = 1.0
    lidar_weight: float = 1.0
    camera_lidar_weight: float = 1.0
    angle_residual: bool = True
    normalize_distance: bool = True
    ba_huber_deg: float = 4.0
    max_lm_iters: int = 30
    # restrict the line association to lines on multi-view tracks
    # (AssociateLineMulti's use_image_track / use_lidar_track flags and
    # Image/LidarMaskByTrack, CameraLidarOptimizer.cpp:331-671)
    use_image_track: bool = False
    use_lidar_track: bool = False
    min_track_length: int = 3
    # vote (image track, LiDAR track) pairs and distribute the validated
    # ones to every pair (AssociateTrack, CameraLidarTrackAssociate.cpp:
    # 103-204); only with both track kinds on
    use_track_associate: bool = False
    # solve as under a process group (`joint_optimize(group=)`) without one:
    # no Schur elimination, every block's rows in `parallel.shard_blocks`'
    # chunks, exact costs; the single-process counterpart of the group path
    sharded_solve: bool = False


def _cl_pairs(n_frames, n_lidars, k):
    """Each image associates with its k temporal LiDAR neighbours
    (AssociateLineMulti, CameraLidarOptimizer.cpp:331-384)."""
    fi, li = [], []
    for f in range(n_frames):
        for d in range(-k // 2, k // 2 + 1):
            l = f + d
            if 0 <= l < n_lidars:
                fi.append(f)
                li.append(l)
    return np.asarray(fi, np.int32), np.asarray(li, np.int32)


def associate_all_cl(arc_batch, lidar_batch, cam_poses, lidar_poses, fi, li):
    """Associate every (frame fi[k], scan li[k]) pair, in chunks of pairs
    sized to a quarter of the free device memory. Returns the stacked
    per-pair outputs of associate_by_angle_pair."""
    dev = cam_poses.device
    fi = torch.as_tensor(fi, device=dev).long()
    li = torch.as_tensor(li, device=dev).long()
    Li = arc_batch["normal"].shape[1]
    P = lidar_batch["less_sharp"].shape[1]
    Ls = lidar_batch["line_endpoints"].shape[1]
    # the (Li, P) and (Li, Ls) temporaries of one pair, ~16 float words each
    chunk = device_chunk(64 * Li * (P + Ls), dev)
    outs = []
    for c0 in range(0, fi.shape[0], chunk):
        f, l = fi[c0:c0 + chunk], li[c0:c0 + chunk]
        R_cl, t_cl = relative_cl(cam_poses[f], lidar_poses[l])
        outs.append(associate_batch({k: arc_batch[k][f] for k in _ARCS},
                                    {k: lidar_batch[k][l] for k in _FEATS}, R_cl, t_cl))
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def build_cl_blocks(cl_assoc, arc_batch, fi, li, weight,
                    cam_group="cam", lidar_group="lidar"):
    """Camera-LiDAR residual blocks (AddCameraLidarResidual,
    util/Optimization.cpp:564-607): Plane2Plane_Global + PlaneIOU per
    accepted line pair, Huber(2 deg)."""
    P, Ls = cl_assoc["mask"].shape
    dev = cl_assoc["mask"].device
    fi = torch.as_tensor(fi, device=dev).long()
    li = torch.as_tensor(li, device=dev).long()
    f_flat = fi.repeat_interleave(Ls)
    l_flat = li.repeat_interleave(Ls)
    mask = cl_assoc["mask"].reshape(-1)
    img_line = cl_assoc["img_line"].long()
    n_img = torch.take_along_dim(arc_batch["normal"][fi], img_line[..., None], dim=1)
    mid_img = torch.take_along_dim(arc_batch["mid"][fi], img_line[..., None], dim=1)
    arc_img = torch.take_along_dim(arc_batch["arc"][fi], img_line, dim=1)
    ends = cl_assoc["endpoints_l"]                       # (P, Ls, 2, 3)
    mids_l = 0.5 * (ends[..., 0, :] + ends[..., 1, :])
    plane4 = torch.cat([n_img, torch.zeros_like(n_img[..., :1])], dim=-1)
    w = torch.full((P * Ls,), weight, dtype=torch.float32, device=dev)
    scale = float(np.radians(2.0))
    return (
        ResidualBlock(residuals.plane2plane_global, (cam_group, lidar_group),
                      (f_flat, l_flat),
                      (n_img.reshape(-1, 3), ends[..., 0, :].reshape(-1, 3),
                       ends[..., 1, :].reshape(-1, 3)),
                      w, mask, loss="huber", loss_scale=scale, name="plane2plane"),
        ResidualBlock(residuals.plane_iou, (cam_group, lidar_group), (f_flat, l_flat),
                      (plane4.reshape(-1, 4), mids_l.reshape(-1, 3),
                       mid_img.reshape(-1, 3), arc_img.reshape(-1) / 2.0),
                      w, mask, loss="huber", loss_scale=scale, name="plane_iou"),
    )


def joint_optimize(arc_batch, lidar_batch, cam_poses0, lidar_poses0,
                   track_img, track_feat, track_mask, bearings, points0,
                   point_ok, cfg: JointConfig = JointConfig(), lidar_valid=None, grays=None,
                   tr=None, group=None):
    """JointOptimize, MAPPING mode (CameraLidarOptimizer.cpp:177-298).
    arc_batch / lidar_batch: stacked dicts of tensors on the working
    device (arc_batch with "desc" when the image-line matching should use
    the descriptors); the tracks (T, L), bearings (N, F, 3), points (T, 3)
    and point_ok (T,) tensors or arrays; poses (N, 6) [aa_*w, t_*w]; grays:
    optional per-frame float [0, 1] images, which filter the image-line
    matches by LK flow (MatchPanoramaLine, PanoramaLineMatch.cpp:48-118).
    With a TimeReport `tr`, the image-line tracks are timed as its phase
    "image line tracks". group: a `parallel.sharding.DataGroup`; the
    association stays replicated (every rank runs it whole, as the JAX
    package does under a mesh), each rank keeps its chunks of every
    residual family's rows (`parallel.shard_blocks`) and the solve sums
    over the ranks, without the Schur elimination (dense or PCG by the
    parameter count, as JAX's sharded solve); `cfg.sharded_solve` solves
    so without a group, and gives the group's bits. Returns (cam_poses,
    lidar_poses, points, infos), one info dict per round, with the line
    counts before and after the track gates and the LK points tracked; the
    same on every rank."""
    from ..parallel import replicated, shard_blocks
    from . import line_tracks
    dev = arc_batch["normal"].device

    def on_dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                               device=dev, dtype=dtype)

    cam_poses = on_dev(cam_poses0, torch.float32)
    lidar_poses = on_dev(lidar_poses0, torch.float32)
    points = on_dev(points0, torch.float32)
    cam_poses, lidar_poses, points = replicated((cam_poses, lidar_poses, points), group)
    point_ok = on_dev(point_ok, torch.bool)
    n_frames, n_lidars = cam_poses.shape[0], lidar_poses.shape[0]
    lidar_valid = (np.ones(n_lidars, bool) if lidar_valid is None
                   else np.asarray(lidar_valid, bool))
    fi, li = _cl_pairs(n_frames, n_lidars, cfg.neighbor_size_joint)

    # the camera reprojection block (fixed across rounds)
    track_img = on_dev(track_img).long()
    T, L = track_img.shape
    obs_t = torch.arange(T, device=dev).repeat_interleave(L)
    obs_img = track_img.reshape(-1)
    obs_mask = on_dev(track_mask, torch.bool).reshape(-1) & point_ok[obs_t]
    b_obs = on_dev(bearings, torch.float32)[obs_img, on_dev(track_feat).long().reshape(-1)]
    cam_block = ResidualBlock(
        residuals.reproj_chordal, ("cam", "pts"), (obs_img, obs_t), (b_obs,),
        torch.full((T * L,), cfg.camera_weight, dtype=torch.float32, device=dev),
        obs_mask, loss="huber", loss_scale=float(np.radians(cfg.ba_huber_deg)),
        name="cam_reproj")

    fixed = {"cam": torch.zeros((n_frames, 6), dtype=torch.bool, device=dev),
             "lidar": torch.zeros((n_lidars, 6), dtype=torch.bool, device=dev),
             "pts": (~point_ok)[:, None].repeat(1, 3)}
    fixed["cam"][0] = True                                 # first camera fixed
    track_assoc = cfg.use_track_associate and cfg.use_image_track and cfg.use_lidar_track

    infos = []
    for _ in range(cfg.num_iteration_joint):
        pr, pn = association.find_neighbors(lidar_poses, lidar_valid)
        pair_r = torch.as_tensor(pr, device=dev)
        pair_n = torch.as_tensor(pn, device=dev)
        l_assoc = association.associate_all_pairs(lidar_batch, lidar_poses, pair_r, pair_n)
        counts = {}
        ab, lb = arc_batch, lidar_batch
        if cfg.use_image_track:
            with tr.phase("image line tracks") if tr is not None else contextlib.nullcontext():
                tid_img = line_tracks.image_line_tracks(
                    arc_batch, cam_poses, window=cfg.neighbor_size_joint,
                    min_length=cfg.min_track_length, grays=grays, stats=counts)
            ab = dict(arc_batch, mask=arc_batch["mask"] & torch.as_tensor(tid_img >= 0,
                                                                           device=dev))
            counts.update(image_lines=int(arc_batch["mask"].sum()),
                          image_lines_tracked=int(ab["mask"].sum()))
            log.info("image track gate: %d of %d lines survive",
                     counts["image_lines_tracked"], counts["image_lines"])
        if cfg.use_lidar_track:
            tid_l = line_tracks.lidar_line_tracks(
                {k: v.cpu().numpy() for k, v in l_assoc["l2l"].items() if k in ("mask", "seg_r")},
                pr, pn, n_lidars, lidar_batch["line_mask"].shape[1],
                min_length=cfg.min_track_length)
            lb = dict(lidar_batch, line_mask=lidar_batch["line_mask"]
                      & torch.as_tensor(tid_l >= 0, device=dev))
            counts.update(lidar_lines=int(lidar_batch["line_mask"].sum()),
                          lidar_lines_tracked=int(lb["line_mask"].sum()))
            log.info("lidar track gate: %d of %d lines survive",
                     counts["lidar_lines_tracked"], counts["lidar_lines"])
        cl_assoc = associate_all_cl(ab, lb, cam_poses, lidar_poses, fi, li)
        if track_assoc:
            m2, l2 = line_tracks.camera_lidar_track_associate(cl_assoc, fi, li, tid_img, tid_l)
            counts.update(line_pairs_untracked=int(cl_assoc["mask"].sum()),
                          line_pairs_tracked=int(m2.sum()))
            log.info("track associate: %d -> %d line pairs", counts["line_pairs_untracked"],
                     counts["line_pairs_tracked"])
            cl_assoc = dict(cl_assoc, mask=torch.as_tensor(m2, device=dev),
                            img_line=torch.as_tensor(l2, device=dev))
        blocks = (build_cl_blocks(cl_assoc, ab, fi, li, cfg.camera_lidar_weight)
                  + (cam_block,)
                  + lidar_odometry.build_blocks(
                      l_assoc, pair_r, pair_n, angle_residual=cfg.angle_residual,
                      normalize_distance=cfg.normalize_distance,
                      weight=cfg.lidar_weight, group="lidar"))
        sharded = group is not None or cfg.sharded_solve
        out, info = solve_lm({"cam": cam_poses, "lidar": lidar_poses, "pts": points},
                             shard_blocks(blocks, group) if sharded else blocks, fixed,
                             LMOptions(max_iters=cfg.max_lm_iters, exact_costs=sharded),
                             schur=None if sharded else "pts", group=group)
        cam_poses, lidar_poses, points = out["cam"], out["lidar"], out["pts"]
        infos.append({"line_pairs": int(cl_assoc["mask"].sum()), "lidar_pairs": len(pr),
                      **counts,
                      **{k: (v if k in ("tier", "cg_iterations") else float(v))
                         for k, v in info.items()}})
        log.info("joint round %d: %d camera-LiDAR line pairs, cost %.6g -> %.6g "
                 "in %d LM iterations", len(infos), infos[-1]["line_pairs"],
                 infos[-1]["initial_cost"], infos[-1]["final_cost"], info["iterations"])
    return cam_poses, lidar_poses, points, infos


# the 3^6 extrinsic perturbations {-1, 0, 1} per degree of freedom, in the
# JAX module's order (itertools.product), and the unperturbed one's index
_DELTAS = np.asarray(list(itertools.product((-1.0, 0.0, 1.0), repeat=6)), np.float32)
_CENTER = int(np.nonzero((_DELTAS == 0).all(1))[0][0])
_SEARCH_CHUNK = 81


def _pair_inputs(arcs, lidar_feats, device):
    """One frame/scan pair's arc and feature dicts on `device`."""
    def on(a):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a, device=device)
    return ({k: on(arcs[k]) for k in _ARCS}, {k: on(lidar_feats[k]) for k in _FEATS})


def _split_T(T_cl, device):
    """(R, t, [log R, t]) float32 of a 4x4 T_cl."""
    T = torch.as_tensor(np.asarray(T_cl, np.float32), device=device)
    return T[:3, :3], T[:3, 3], torch.cat([se3.log_so3(T[:3, :3]), T[:3, 3]])


def perturb_calibration_search(arcs, lidar_feats, T_cl0, rot_step_deg: float = 0.5,
                               trans_step: float = 0.05, max_iterations: int = 15,
                               device="cuda"):
    """Extrinsic grid search (AssociateRandomDisturbance,
    CameraLidarLineAssociate.cpp:477-622): T_cl is perturbed over the 3^6
    grid of {-step, 0, +step} per degree of freedom, every candidate is
    associated, and the one with the most line pairs, then the least mean
    plane-line misalignment, is kept. When the centre wins the step halves;
    a second stall ends the search. The candidates are scored 81 at a time
    on `device`. arcs / lidar_feats: one frame's arc dict and one scan's
    features (arrays or tensors). Returns (T_cl (4, 4), n_pairs)."""
    a1, f1 = _pair_inputs(arcs, lidar_feats, device)
    deltas = torch.as_tensor(_DELTAS, device=device)
    C = _SEARCH_CHUNK
    ab = {k: v[None].expand(C, *v.shape) for k, v in a1.items()}
    fb = {k: v[None].expand(C, *v.shape) for k, v in f1.items()}

    def score_all(pose, steps):
        ns, mis = [], []
        for c0 in range(0, len(deltas), C):
            p = pose + deltas[c0:c0 + C] * steps                       # (C, 6)
            R = se3.exp_so3(p[:, :3])
            assoc = associate_batch(ab, fb, R, p[:, 3:])
            n = assoc["mask"].sum(dim=1)
            # misalignment of the accepted pairs: the LiDAR direction should
            # lie in the image line's plane (|cos| to its normal 0)
            n_img = torch.take_along_dim(ab["normal"], assoc["img_line"].long()[..., None], dim=1)
            ends = assoc["endpoints_l"]
            dir_c = _unit(torch.einsum("bij,blj->bli", R, ends[:, :, 1] - ends[:, :, 0]))
            m = torch.abs(torch.sum(n_img * dir_c, dim=-1))
            ns.append(n)
            mis.append(torch.sum(torch.where(assoc["mask"], m, torch.zeros_like(m)), dim=1)
                       / torch.clamp_min(n, 1))
        return torch.cat(ns).cpu().numpy(), torch.cat(mis).cpu().numpy()

    pose = _split_T(T_cl0, device)[2].cpu().numpy()
    steps = np.array([np.radians(rot_step_deg)] * 3 + [trans_step] * 3, np.float32)
    scale = 1.0
    best_n = -1
    for _ in range(max_iterations):
        ns, mis = score_all(torch.as_tensor(pose, device=device),
                            torch.as_tensor(steps * scale, device=device))
        k = int(np.lexsort((mis, -ns))[0])   # most pairs, then least misaligned
        if ns[k] > best_n or (ns[k] == best_n and k != _CENTER):
            improved = k != _CENTER and ns[k] >= best_n
            best_n = max(best_n, int(ns[k]))
            pose = pose + _DELTAS[k] * steps * scale
        else:
            improved = False
        if not improved:
            if scale < 1.0:
                break
            scale *= 0.5
    T = np.eye(4)
    T[:3, :3] = se3.exp_so3(torch.as_tensor(pose[:3])).numpy()
    T[:3, 3] = pose[3:]
    return T, best_n


def calibrate(arcs, lidar_feats, T_cl0, max_iters: int = 30, device="cuda"):
    """CALIBRATION mode (CameraLidarOptimizer.cpp:32-87, :212-232): T_cl
    refined from one frame/scan pair's line associations at T_cl0 by LM
    over Plane2Plane_Relative and PlaneRelativeIOU (Huber 2 deg), on
    `device`. Returns (T_cl (4, 4) float64, info)."""
    from scipy.spatial.transform import Rotation as ScR
    a1, f1 = _pair_inputs(arcs, lidar_feats, device)
    R0, t0, pose0 = _split_T(T_cl0, device)
    assoc = associate_by_angle_pair(a1, f1, R0, t0)
    Ls = assoc["mask"].shape[0]
    img_line = assoc["img_line"].long()
    n_img = a1["normal"][img_line]
    mid_img = a1["mid"][img_line]
    arc_img = a1["arc"][img_line]
    ends = assoc["endpoints_l"]
    mids_l = 0.5 * (ends[:, 0] + ends[:, 1])
    plane4 = torch.cat([n_img, torch.zeros_like(n_img[:, :1])], dim=1)
    w = torch.ones((Ls,), dtype=torch.float32, device=device)
    idx = (torch.zeros((Ls,), dtype=torch.long, device=device),)
    scale = float(np.radians(2.0))
    blocks = (
        ResidualBlock(residuals.plane2plane_relative, ("tcl",), idx,
                      (n_img, ends[:, 0], ends[:, 1]), w, assoc["mask"],
                      loss="huber", loss_scale=scale),
        ResidualBlock(residuals.plane_relative_iou, ("tcl",), idx,
                      (plane4, mids_l, mid_img, arc_img / 2.0), w, assoc["mask"],
                      loss="huber", loss_scale=scale),
    )
    out, info = solve_lm({"tcl": pose0[None]}, blocks, None, LMOptions(max_iters=max_iters))
    pose = out["tcl"][0].cpu().numpy()
    T = np.eye(4)
    T[:3, :3] = ScR.from_rotvec(pose[:3]).as_matrix()
    T[:3, 3] = pose[3:]
    return T, info
