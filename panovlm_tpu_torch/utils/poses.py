"""World poses <-> solver parameters: the port's copy of
`world_to_params` and `params_to_world` from panovlm_tpu/utils/poses.py
(util/Util.{h,cpp} of the reference). A pose in world form is (R_wf, t_wf);
its solver parameters are [aa_fw, t_fw] (axis-angle and translation of the
inverse)."""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as ScR


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
