"""Multi-scan LiDAR odometry — ported from `panovlm_tpu/models/lidar_odometry.py`
(the reference's EstimatePose, LidarOdometry.cpp:116-187): up to
num_iteration_lidar rounds of neighbour search -> association of every pair
-> one LM solve over all scan poses, stopping early when the cost drops by
less than 1 %. The pair list is not padded (PyTorch has no recompilation to
avoid), so every pair of a round is a real pair.

With a process group (`estimate_poses(..., group=)`) the pairs of a round
are associated, and their rows evaluated by the solver, in `PAIR_CHUNKS`
chunks of consecutive pairs, each on its own, so that a pair's rows get
the same bits wherever its chunk is computed (`solver/lm.py`); each rank
takes the contiguous chunks of `process_slice`'s split of them, and the LM
solve sums over the ranks' observations exactly, costs included. The
poses are then the same bits at every world size, and without a group
under `OdometryConfig.sharded_solve`. The single process by default
associates every pair of a round in one call and sums its costs as
floats: the joint stage downstream turns on the last bits of its poses,
and the sharded layout moved the Room chain's joint LiDAR error past its
bound (PERF.md, section 6).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops import se3
from ..solver import residuals
from ..solver.lm import LMOptions, ResidualBlock, solve_lm
from . import association
from .line_tracks import l2l_track_gate, lidar_line_tracks


def stack_features(feats_list) -> dict:
    """Stack per-scan feature dicts into one batch dict with a scan axis."""
    return {k: torch.stack([f[k] for f in feats_list]) for k in feats_list[0]}


def build_blocks(assoc, pair_r, pair_n, *, angle_residual=True,
                 normalize_distance=True, weight=1.0, point_to_line=True,
                 line_to_line=True, point_to_plane=True, group: str = "poses",
                 chunk_pairs: int = 0):
    """Flatten per-pair association outputs into ResidualBlocks
    (util/Optimization.cpp residual assembly): Huber(2 deg) for angle
    residuals, Huber(0.2 m) for metric ones; point-to-line only between
    consecutive scans (:475). chunk_pairs > 0: the solver evaluates the
    rows of that many pairs at a time."""
    blocks = []
    loss_scale = np.radians(2.0) if angle_residual else 0.2

    def family(fn, data, scale, name, mask):
        P = mask.shape[1]
        n = mask.numel()
        blocks.append(ResidualBlock(
            fn, (group, group),
            (pair_r.repeat_interleave(P), pair_n.repeat_interleave(P)),
            tuple(d.reshape(n, -1) for d in data),
            torch.full((n,), weight, dtype=torch.float32, device=mask.device),
            mask.reshape(-1), loss="huber", loss_scale=scale, name=name,
            run_length=P, chunk=chunk_pairs * P))

    if point_to_line:
        p2l = assoc["p2l"]
        fn = (functools.partial(residuals.point2line_angle,
                                normalize_distance=normalize_distance)
              if angle_residual else residuals.point2line_meter)
        consecutive = torch.abs(pair_r - pair_n) <= 1
        family(fn, (p2l["point"], p2l["line_pt"], p2l["line_dir"]),
               loss_scale, "point2line", p2l["mask"] & consecutive[:, None])
    if point_to_plane:
        p2p = assoc["p2p"]
        fn = (functools.partial(residuals.point2plane_angle,
                                normalize_distance=normalize_distance)
              if angle_residual else residuals.point2plane_meter)
        family(fn, (p2p["point"], p2p["plane"]), loss_scale,
               "point2plane", p2p["mask"])
    if line_to_line:
        l2l = assoc["l2l"]
        family(residuals.line2line_angle, (l2l["dir_r"], l2l["dir_n"]),
               np.radians(2.0), "line2line", l2l["mask"])
    return tuple(blocks)


class OdometryConfig(NamedTuple):
    num_iteration_lidar: int = 5
    angle_residual: bool = True
    normalize_distance: bool = True
    point_to_line: bool = True
    line_to_line: bool = True
    point_to_plane: bool = True
    lidar_weight: float = 1.0
    neighbors_k: int = 6
    max_lm_iters: int = 20            # SetOptionsLidar max_num_iterations
    use_line_tracks: bool = True      # gate l2l by LineTracks (len >= 3)
    # associate and solve as under a process group (PAIR_CHUNKS pair chunks,
    # exact costs) without one: the single-process counterpart of the group
    sharded_solve: bool = False


# a round's pairs are associated and solved in this many chunks, split over
# the ranks of a group (at most this many ranks get pairs)
PAIR_CHUNKS = 4


def _cat_assoc(parts):
    if len(parts) == 1:
        return parts[0]
    return {fam: {k: torch.cat([p[fam][k] for p in parts]) for k in parts[0][fam]}
            for fam in parts[0]}


def _associate_chunks(batch, poses, pr, pn, q: int, group):
    """The round's pairs (pr, pn) associated q at a time, each chunk of q
    consecutive pairs on its own; with a group, only this rank's chunks
    (`process_slice` over the chunks). Returns (assoc, ids): the rows, and
    the index in (pr, pn) of each."""
    from ..parallel.multihost import process_slice
    n = len(pr)
    k = (process_slice(-(-n // q), group.rank, group.world) if group is not None
         else slice(0, -(-n // q)))
    ids = np.arange(k.start * q, min(k.stop * q, n))
    dev = poses.device

    def assoc(c0, c1):
        return association.associate_all_pairs(
            batch, poses, torch.as_tensor(pr[c0:c1], device=dev),
            torch.as_tensor(pn[c0:c1], device=dev))
    if not len(ids):
        # a rank without a chunk (more ranks than chunks): pair 0's rows, none kept
        return {fam: {key: v[:0] for key, v in d.items()}
                for fam, d in assoc(0, 1).items()}, ids
    return _cat_assoc([assoc(c0, min(c0 + q, n))
                       for c0 in range(int(ids[0]), int(ids[-1]) + 1, q)]), ids


def _gather_l2l(assoc, ids, n_pairs: int, group):
    """Every pair's line-to-line mask and matched reference line, in the
    order of the round's pair list, on every rank: the line-track gate
    needs them all."""
    mine = (ids, assoc["l2l"]["mask"].cpu().numpy(), assoc["l2l"]["seg_r"].cpu().numpy())
    if group is None:
        return {"mask": mine[1], "seg_r": mine[2]}
    L = mine[1].shape[1]
    out = {"mask": np.zeros((n_pairs, L), bool),
           "seg_r": np.zeros((n_pairs, L), mine[2].dtype)}
    for rid, mask, seg in group.all_gather_object(mine):
        out["mask"][rid], out["seg_r"][rid] = mask, seg
    return out


def estimate_poses(batch, poses0, valid, cfg: OdometryConfig = OdometryConfig(),
                   group=None):
    """EstimatePose: outer re-association rounds around the LM solve.
    batch: stacked feature dict on the working device; poses0 (N, 6)
    [aa_lw, t_lw]; valid (N,) bool numpy. group: a
    `parallel.sharding.DataGroup` to split the pairs and the solve's
    observations over (every rank passes the whole batch). Returns (poses
    (N, 6) tensor, infos list of per-round dicts), the same on every
    rank."""
    from ..parallel import replicated
    sharded = group is not None or cfg.sharded_solve
    dev = batch["less_sharp"].device
    poses = replicated(torch.as_tensor(np.asarray(poses0, np.float32), device=dev), group)
    fixed = torch.zeros(poses.shape, dtype=torch.bool, device=dev)
    fixed[int(np.argmax(np.asarray(valid)))] = True
    infos = []
    prev_cost = None
    for _ in range(cfg.num_iteration_lidar):
        pr_np, pn_np = association.find_neighbors(poses, valid, k=cfg.neighbors_k)
        if sharded:
            q = max(1, -(-len(pr_np) // PAIR_CHUNKS))    # pairs per chunk
            assoc, ids = _associate_chunks(batch, poses, pr_np, pn_np, q, group)
        else:
            q, ids = 0, np.arange(len(pr_np))
            assoc = association.associate_all_pairs(
                batch, poses, torch.as_tensor(pr_np, device=dev),
                torch.as_tensor(pn_np, device=dev))
        pair_r = torch.as_tensor(pr_np[ids], device=dev)
        pair_n = torch.as_tensor(pn_np[ids], device=dev)
        if cfg.line_to_line and cfg.use_line_tracks:
            l2l = _gather_l2l(assoc, ids, len(pr_np), group)
            tid = lidar_line_tracks(l2l, pr_np, pn_np, poses.shape[0],
                                    batch["line_mask"].shape[1])
            gate = l2l_track_gate(l2l, pr_np, pn_np, tid)[ids]
            assoc["l2l"]["mask"] = assoc["l2l"]["mask"] & torch.from_numpy(gate).to(dev)
        blocks = build_blocks(
            assoc, pair_r, pair_n, angle_residual=cfg.angle_residual,
            normalize_distance=cfg.normalize_distance, weight=cfg.lidar_weight,
            point_to_line=cfg.point_to_line, line_to_line=cfg.line_to_line,
            point_to_plane=cfg.point_to_plane, chunk_pairs=q)
        out, info = solve_lm({"poses": poses}, blocks, {"poses": fixed},
                             LMOptions(max_iters=cfg.max_lm_iters, exact_costs=sharded),
                             group=group)
        poses = out["poses"]
        cost = float(info["final_cost"])
        infos.append({"pairs": len(pr_np), "initial_cost": float(info["initial_cost"]),
                      "final_cost": cost, "iterations": info["iterations"],
                      "tier": info["tier"], "cg_iterations": info["cg_iterations"]})
        # early stop: < 1 % relative cost improvement (LidarOdometry.cpp:164-183)
        if prev_cost is not None and prev_cost > 0 and (prev_cost - cost) / prev_cost < 0.01:
            break
        prev_cost = cost
    return poses, infos


def undistort_scan(pts, frac, pose_i, pose_next):
    """Per-point slerp undistortion (UndistortLidars, LidarOdometry.cpp:
    189-263) for a batch of scans: interpolate each point's world pose
    between its scan's and the next scan's, then re-express it in the scan's
    own frame. pts (B,P,3), frac (B,P), pose_* (B,6)."""
    R_i_lw = se3.exp_so3(pose_i[:, :3])
    R_n_lw = se3.exp_so3(pose_next[:, :3])
    R_i_wl, t_i_wl = se3.invert_pose(R_i_lw, pose_i[:, 3:])
    R_n_wl, t_n_wl = se3.invert_pose(R_n_lw, pose_next[:, 3:])
    q_i = se3.matrix_to_quat(R_i_wl)[:, None].expand(*pts.shape[:2], 4)
    q_n = se3.matrix_to_quat(R_n_wl)[:, None].expand(*pts.shape[:2], 4)
    R_t = se3.quat_to_matrix(se3.quat_slerp(q_i, q_n, frac[..., None]))
    t_t = (1 - frac)[..., None] * t_i_wl[:, None] + frac[..., None] * t_n_wl[:, None]
    p_w = torch.einsum("bnij,bnj->bni", R_t, pts) + t_t
    return torch.einsum("bij,bnj->bni", R_i_lw, p_w) + pose_i[:, None, 3:]
