"""Pair-set surgery — the port of panovlm_tpu/pair_surgery.py: operator
tools that patch the persisted match-pair artifacts of `init_camera_pose`
in place instead of recomputing the stage (the reference's SfM test harness,
sfm/SfM_test.cpp: ReComputePairs :7-41, SetToStraightMotion :83-153,
AddPair :155-249, PrintRelativePose :251-269, PrintGlobalPose :272-292).

The verbs read `<frame_path>/frames_sift.npz` and patch
`<match_pair_path>/match_pairs.npz` (and, for set_straight_motion,
`rel_poses.npz`). The rows they add are flagged `extra`, so that the stage's
row cache (pipeline._match_pairs_cached) keeps them on its next run although
the pair proposer would not emit them. New rows are matched on the device
through `models/sfm.match_all_pairs`: on the card one launch of the fused
descriptor search (csrc/knn_desc.cu) per 16 pairs.

CLI:  python -m panovlm_tpu_torch add_pair <config.txt> <i> <j>
      python -m panovlm_tpu_torch recompute_pairs <config.txt> <i1> <i2>
      python -m panovlm_tpu_torch set_straight_motion <config.txt> <start> <end> <len>
      python -m panovlm_tpu_torch dump_relative_poses <config.txt> [out.txt]
      python -m panovlm_tpu_torch dump_global_poses <config.txt> [out.txt]
each with --device cuda|cpu (default cuda).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
from scipy.spatial.transform import Rotation as ScR

from . import device as device_mod
from .config import Config
from .io import artifacts

log = logging.getLogger("panovlm")


def _load_state(cfg: Config):
    """The persisted artifacts surgery operates on; both must exist."""
    mpath = os.path.join(cfg.match_pair_path, "match_pairs.npz")
    fpath = os.path.join(cfg.frame_path, "frames_sift.npz")
    for p in (mpath, fpath):
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"{p} not found — run init_camera_pose first; pair surgery "
                f"patches its persisted artifacts")
    mc = artifacts.load_npz(mpath)
    fs = artifacts.load_npz(fpath)
    if int(mc["num_sift"]) != fs["uv"].shape[1]:
        raise ValueError("match_pairs.npz and frames_sift.npz disagree on "
                         "the feature cap — stale artifacts")
    return mpath, mc, fs


def _match_rows(cfg: Config, fs: dict, pi, pj, max_matches: int, device):
    """Match pairs (pi, pj) on `device` as the stage does. Returns numpy
    idx (P, K, 2), mask (P, K), dist (P, K) and pair_ok (P,)."""
    from .models import sfm as sfm_mod
    from .pipeline import _sfm_config

    scfg = _sfm_config(cfg, int(fs["uv"].shape[1]))._replace(max_matches=max_matches)
    mm = sfm_mod.match_all_pairs(torch.as_tensor(fs["desc"], device=device),
                                 torch.as_tensor(fs["fmask"], device=device),
                                 np.asarray(pi, np.int32), np.asarray(pj, np.int32), scfg)
    return {k: v.cpu().numpy() for k, v in mm.items()}


def _upsert(mc: dict, pi_new, pj_new, mm, extra_new, drop=None):
    """Rows keyed by (i, j): the stored rows in their order, without those
    dropped or replaced, then the new rows."""
    keep = np.ones(len(mc["pi"]), bool) if drop is None else ~drop
    newkey = {(int(a), int(b)) for a, b in zip(pi_new, pj_new)}
    for r in np.nonzero(keep)[0]:
        if (int(mc["pi"][r]), int(mc["pj"][r])) in newkey:
            keep[r] = False
    cextra = mc["extra"].astype(bool) if "extra" in mc else np.zeros(len(mc["pi"]), bool)
    return dict(
        pi=np.concatenate([mc["pi"][keep], np.asarray(pi_new, mc["pi"].dtype)]),
        pj=np.concatenate([mc["pj"][keep], np.asarray(pj_new, mc["pj"].dtype)]),
        num_sift=mc["num_sift"],
        idx=np.concatenate([mc["idx"][keep], mm["idx"]]),
        mask=np.concatenate([mc["mask"][keep], mm["mask"]]),
        pair_ok=np.concatenate([mc["pair_ok"][keep], mm["pair_ok"]]),
        extra=np.concatenate([cextra[keep], np.asarray(extra_new, bool)]))


def add_pair(cfg: Config, i: int, j: int, device="cuda"):
    """AddPair (SfM_test.cpp:155-249): match one extra image pair and upsert
    it into the persisted pair set, flagged `extra`. Returns the new
    match_pairs.npz contents."""
    device = device_mod.resolve(device)
    if i == j:
        raise ValueError("add_pair needs two distinct frames")
    i, j = (int(i), int(j)) if i < j else (int(j), int(i))
    mpath, mc, fs = _load_state(cfg)
    n = len(fs["uv"])
    if not (0 <= i < n and 0 <= j < n):
        raise ValueError(f"frame ids must be in [0, {n})")
    mm = _match_rows(cfg, fs, [i], [j], int(mc["idx"].shape[1]), device)
    out = _upsert(mc, [i], [j], mm, [True])
    artifacts.save_npz(mpath, **out)
    log.info("add_pair(%d, %d): %d matches, pair_ok=%s — %d pairs total",
             i, j, int(mm["mask"].sum()), bool(mm["pair_ok"][0]), len(out["pi"]))
    return out


def recompute_pairs(cfg: Config, idx1: int, idx2: int, device="cuda"):
    """ReComputePairs (SfM_test.cpp:7-41): drop every persisted pair whose
    two frames both lie in [idx1, idx2] and replace them with the freshly
    matched full quadratic pair set over that range, flagged `extra`."""
    device = device_mod.resolve(device)
    mpath, mc, fs = _load_state(cfg)
    n = len(fs["uv"])
    idx1, idx2 = int(idx1), min(int(idx2), n - 1)
    if idx1 < 0:
        raise ValueError(f"frame ids must be in [0, {n})")
    if idx1 > idx2:
        raise ValueError("need idx1 <= idx2")
    inside = ((mc["pi"] >= idx1) & (mc["pi"] <= idx2)
              & (mc["pj"] >= idx1) & (mc["pj"] <= idx2))
    a, b = np.triu_indices(idx2 - idx1 + 1, k=1)
    pi_new, pj_new = (a + idx1).astype(np.int32), (b + idx1).astype(np.int32)
    mm = _match_rows(cfg, fs, pi_new, pj_new, int(mc["idx"].shape[1]), device)
    out = _upsert(mc, pi_new, pj_new, mm, np.ones(len(pi_new), bool), drop=inside)
    artifacts.save_npz(mpath, **out)
    log.info("recompute_pairs(%d, %d): dropped %d rows, rematched %d — %d pairs total",
             idx1, idx2, int(inside.sum()), len(pi_new), len(out["pi"]))
    return out


def _working_size(cfg: Config):
    """(H, W) of the frames the persisted uv are in: the first image's shape
    through the config's `scale` pyramid (pyrDown halves with ceil
    rounding), as images.load_images gives it."""
    from .io import images
    from .pipeline import _list_files
    H, W = images.read_image(_list_files(cfg.image_path, ("jpg", "jpeg", "png"))[0]).shape[:2]
    for _ in range(-cfg.scale if cfg.scale < 0 else 0):
        H, W = (H + 1) // 2, (W + 1) // 2
    for _ in range(cfg.scale if cfg.scale > 0 else 0):
        H, W = H * 2, W * 2
    return H, W


def set_straight_motion(cfg: Config, start: int, end: int, length: int, device="cuda"):
    """SetToStraightMotion (SfM_test.cpp:83-153): replace every persisted
    pair whose two frames both lie in [start, end] with forced straight-
    motion pairs (idx1 in [start, end), idx2 in (idx1, idx1 + length]),
    freshly matched; their rows of rel_poses.npz get the forced pose (R = I,
    unit t_21 = -z) and its CheckRT-triangulated points, keyed by the
    matches' fingerprints, so the next stage run takes them as they are."""
    from .ops import epipolar, spherical
    from .pipeline import _match_row_fp

    device = device_mod.resolve(device)
    mpath, mc, fs = _load_state(cfg)
    n = len(fs["uv"])
    start, end, length = int(start), min(int(end), n - 1), int(length)
    if not (0 <= start < end and length >= 1):
        raise ValueError("need 0 <= start < end and length >= 1")
    pairs = [(i1, i2) for i1 in range(start, end)
             for i2 in range(i1 + 1, min(i1 + length, end) + 1)]
    pi_new = np.asarray([p[0] for p in pairs], np.int32)
    pj_new = np.asarray([p[1] for p in pairs], np.int32)
    inside = ((mc["pi"] >= start) & (mc["pi"] <= end)
              & (mc["pj"] >= start) & (mc["pj"] <= end))
    K = int(mc["idx"].shape[1])
    mm = _match_rows(cfg, fs, pi_new, pj_new, K, device)
    out = _upsert(mc, pi_new, pj_new, mm, np.ones(len(pi_new), bool), drop=inside)
    artifacts.save_npz(mpath, **out)

    # the forced poses' triangulation, all rows at once on the device
    P = len(pi_new)
    bearings = spherical.image_to_cam(torch.as_tensor(fs["uv"], device=device),
                                      *_working_size(cfg))
    idx = torch.as_tensor(mm["idx"], dtype=torch.int64, device=device)
    pi_t = torch.as_tensor(pi_new, dtype=torch.int64, device=device)
    pj_t = torch.as_tensor(pj_new, dtype=torch.int64, device=device)
    b1 = bearings[pi_t[:, None], idx[..., 0]]
    b2 = bearings[pj_t[:, None], idx[..., 1]]
    R_I = torch.eye(3, device=device).expand(P, 3, 3)
    t_u = torch.tensor([0.0, 0.0, -1.0], device=device).expand(P, 3)
    n_good, good, pts = epipolar.check_rt(R_I, t_u, b1, b2,
                                          torch.as_tensor(mm["mask"], device=device))
    good = good.cpu().numpy()
    rows = dict(pi=pi_new, pj=pj_new, fp=_match_row_fp(mm["idx"], mm["mask"]),
                rel_aa=np.zeros((P, 3), np.float32),
                rel_t=np.tile(np.float32([[0.0, 0.0, -1.0]]), (P, 1)),
                n_inliers=n_good.cpu().numpy().astype(np.int32), ok=np.ones(P, bool),
                tri_points=np.where(good[..., None], pts.cpu().numpy(), 0.0).astype(np.float32),
                tri_mask=good)
    rcache = os.path.join(cfg.match_pair_path, "rel_poses.npz")
    if os.path.exists(rcache):
        rc = artifacts.load_npz(rcache)
        if rc["tri_points"].shape[1] == K:
            newkey = {(int(a), int(b)) for a, b in zip(pi_new, pj_new)}
            keep = np.asarray([(int(a), int(b)) not in newkey
                               for a, b in zip(rc["pi"], rc["pj"])], bool)
            rows = {k: np.concatenate([rc[k][keep], rows[k]]) for k in rows}
    artifacts.save_npz(rcache, **rows)
    log.info("set_straight_motion(%d, %d, %d): %d forced pairs (dropped %d), rel-pose "
             "rows written", start, end, length, P, int(inside.sum()))
    return out


def dump_relative_poses(cfg: Config, out_path: str | None = None, device="cuda"):
    """PrintRelativePose (SfM_test.cpp:251-269): each persisted pair's
    relative pose as t_12 and the axis-angle of R_12 (degrees)."""
    device_mod.resolve(device)
    rcache = os.path.join(cfg.match_pair_path, "rel_poses.npz")
    if not os.path.exists(rcache):
        raise FileNotFoundError(f"{rcache} not found — run init_camera_pose")
    rc = artifacts.load_npz(rcache)
    out_path = out_path or os.path.join(cfg.sfm_result_path, "relative_poses.txt")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        for r in range(len(rc["pi"])):
            R_21 = ScR.from_rotvec(np.asarray(rc["rel_aa"][r], np.float64)).as_matrix()
            t_12 = -R_21.T @ np.asarray(rc["rel_t"][r], np.float64)
            f.write(f"pair : {int(rc['pi'][r])} {int(rc['pj'][r])} "
                    f"{'good' if bool(rc['ok'][r]) else 'bad'}\n")
            f.write(f"{t_12[0]} {t_12[1]} {t_12[2]}\n")
            ax, deg = _axis_degrees(R_21.T)
            f.write(f"{ax[0]} {ax[1]} {ax[2]} {deg}\n")
    log.info("dump_relative_poses: %d pairs -> %s", len(rc["pi"]), out_path)
    return out_path


def _axis_degrees(R):
    rv = ScR.from_matrix(R).as_rotvec()
    ang = np.linalg.norm(rv)
    return (rv / ang if ang > 1e-12 else np.array([1.0, 0, 0])), np.degrees(ang)


def dump_global_poses(cfg: Config, out_path: str | None = None, device="cuda"):
    """PrintGlobalPose (SfM_test.cpp:272-292): each frame's rotation relative
    to the first valid frame's as axis-angle (degrees)."""
    device_mod.resolve(device)
    pose_txt = os.path.join(cfg.sfm_result_path, "camera_pose_final.txt")
    if not os.path.exists(pose_txt):
        raise FileNotFoundError(f"{pose_txt} not found — run init_camera_pose")
    R_wc, _, _, ok = artifacts.read_pose_t(pose_txt)
    out_path = out_path or os.path.join(cfg.sfm_result_path, "global_poses.txt")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    R_w0 = R_wc[int(np.argmax(ok))]
    with open(out_path, "w") as f:
        for i in range(len(R_wc)):
            ax, deg = _axis_degrees((R_wc[i].T @ R_w0).T)
            f.write(f"frame : {i}, rotation : {ax[0]} {ax[1]} {ax[2]} {deg}\n")
    log.info("dump_global_poses: %d frames -> %s", len(R_wc), out_path)
    return out_path
