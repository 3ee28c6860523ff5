"""World poses <-> solver parameters, and LiDAR poses from camera poses:
the port's copy of `world_to_params`, `params_to_world` and
`set_lidar_pose` from panovlm_tpu/utils/poses.py (util/Util.{h,cpp} of the
reference). A pose in world form is (R_wf, t_wf); its solver parameters are
[aa_fw, t_fw] (axis-angle and translation of the inverse). Frame i is at
time i * data_gap_time, scan j at j * data_gap_time + time_offset."""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as ScR, Slerp


def world_to_params(R_w, t_w):
    """(R_wf, t_wf) world poses -> solver params [aa_fw, t_fw]."""
    R_fw = np.swapaxes(np.asarray(R_w), -1, -2)
    t_fw = -np.einsum("nij,nj->ni", R_fw, np.asarray(t_w))
    aa = ScR.from_matrix(R_fw).as_rotvec()
    return np.concatenate([aa, t_fw], axis=1).astype(np.float32)


def params_to_world(params):
    """solver params [aa_fw, t_fw] -> (R_wf, t_wf) world poses."""
    p = np.asarray(params, np.float64)
    R_fw = ScR.from_rotvec(p[:, :3]).as_matrix()
    R_wf = np.swapaxes(R_fw, -1, -2)
    t_wf = -np.einsum("nij,nj->ni", R_wf, p[:, 3:])
    return R_wf, t_wf


def _interp_poses(R_list, t_list, valid, times, query_times):
    """Slerp/lerp world poses at query times, skipping invalid poses.
    Returns (R (Q,3,3), t (Q,3), ok (Q,))."""
    idx = np.nonzero(valid)[0]
    if len(idx) == 0:
        q = len(query_times)
        return np.tile(np.eye(3), (q, 1, 1)), np.zeros((q, 3)), np.zeros(q, bool)
    tt = np.asarray(times)[idx]
    sl = Slerp(tt, ScR.from_matrix(np.asarray(R_list)[idx]))
    ts = np.asarray(t_list)[idx]
    q = np.clip(query_times, tt[0], tt[-1])
    R_q = sl(q).as_matrix()
    t_q = np.stack([np.interp(q, tt, ts[:, k]) for k in range(3)], axis=1)
    ok = (np.asarray(query_times) >= tt[0] - 1e-9) & \
         (np.asarray(query_times) <= tt[-1] + 1e-9)
    return R_q, t_q, ok


def set_lidar_pose(R_wc, t_wc, frame_valid, T_cl, n_lidars,
                   data_gap_time: float = 0.1, time_offset: float = 0.0):
    """SetLidarPose (util/Util.cpp): T_wl = T_wc * T_cl at each scan's time.
    Returns (R_wl (L,3,3), t_wl (L,3), ok (L,))."""
    t_frame = np.arange(len(R_wc)) * data_gap_time
    t_lidar = np.arange(n_lidars) * data_gap_time + time_offset
    R_q, t_q, ok = _interp_poses(R_wc, t_wc, frame_valid, t_frame, t_lidar)
    T_cl = np.asarray(T_cl)
    return (R_q @ T_cl[:3, :3], np.einsum("qij,j->qi", R_q, T_cl[:3, 3]) + t_q, ok)
