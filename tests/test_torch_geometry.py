"""SO(3) and geometry helpers of the port (panovlm_tpu_torch/ops/se3.py,
geometry.py) against the JAX package on seeded random inputs.

Tolerance: atol 2e-5 on rotations and quaternions (float32; transcendental
functions round differently in XLA and PyTorch); 1e-4 on log maps,
undistorted points and fitted lines and planes (sums over points run in
another order). Fitted directions and normals must agree in sign too, since
the port's eigh3x3 is the same analytic construction (not
torch.linalg.eigh).
Eigenvalues: atol 5e-4 — the trigonometric method resolves a near-degenerate
pair of small eigenvalues only to ~1e-4 of the largest in float32, in both
packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panovlm_tpu.ops import geometry as jgeo
from panovlm_tpu.ops import se3 as jse3
from panovlm_tpu_torch.models import lidar_odometry as todo
from panovlm_tpu_torch.ops import geometry as tgeo
from panovlm_tpu_torch.ops import se3 as tse3

torch.set_num_threads(2)

ATOL = 2e-5


def _rotvecs(rng, n=256):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w[: n // 4] *= 1e-5          # Taylor branch
    w[n // 4: n // 2] *= 0.3
    w[n // 2:] /= np.linalg.norm(w[n // 2:], axis=1, keepdims=True)
    w[n // 2:] *= rng.uniform(0.5, np.pi - 0.05, (n - n // 2, 1)).astype(np.float32)
    return w


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def test_so3_maps_match_jax():
    w = _rotvecs(np.random.default_rng(0))
    R_j = jse3.exp_so3(jnp.asarray(w))
    R_t = tse3.exp_so3(torch.from_numpy(w))
    _close(R_t, R_j)
    _close(tse3.hat(torch.from_numpy(w)), jse3.hat(jnp.asarray(w)))
    _close(tse3.log_so3(R_t), jse3.log_so3(R_j), atol=1e-4)
    q_t, q_j = tse3.matrix_to_quat(R_t), jse3.matrix_to_quat(R_j)
    _close(q_t, q_j)
    _close(tse3.quat_to_matrix(q_t), jse3.quat_to_matrix(q_j))
    Ri_t, ti_t = tse3.invert_pose(R_t, torch.from_numpy(w))
    Ri_j, ti_j = jse3.invert_pose(R_j, jnp.asarray(w))
    _close(Ri_t, Ri_j)
    _close(ti_t, ti_j)


def test_slerp_and_undistort_match_jax():
    rng = np.random.default_rng(1)
    w = _rotvecs(rng, 64)
    q0 = jse3.matrix_to_quat(jse3.exp_so3(jnp.asarray(w)))
    q1 = jse3.matrix_to_quat(jse3.exp_so3(jnp.asarray(w[::-1].copy())))
    t = rng.uniform(0, 1, (64, 1)).astype(np.float32)
    _close(tse3.quat_slerp(torch.tensor(np.asarray(q0)), torch.tensor(np.asarray(q1)),
                           torch.from_numpy(t)),
           jse3.quat_slerp(q0, q1, jnp.asarray(t)))
    from panovlm_tpu.models import lidar_odometry as jodo
    pts = rng.normal(size=(2, 500, 3)).astype(np.float32) * 4
    frac = rng.uniform(0, 0.5, (2, 500)).astype(np.float32)
    pose_i = np.concatenate([w[:2] * 0.1, rng.normal(size=(2, 3))], 1).astype(np.float32)
    pose_n = pose_i + rng.normal(size=(2, 6)).astype(np.float32) * 0.05
    out = todo.undistort_scan(*(torch.from_numpy(a) for a in (pts, frac, pose_i, pose_n)))
    for b in range(2):
        ref = jodo.undistort_scan(pts[b], frac[b], pose_i[b], pose_n[b])
        _close(out[b], ref, atol=1e-4)


@pytest.mark.parametrize("fit", ["line", "plane"])
def test_fits_match_jax(fit):
    rng = np.random.default_rng(2 if fit == "line" else 3)
    L, P = 32, 40
    base = rng.normal(size=(L, 1, 3)).astype(np.float32)
    d = rng.normal(size=(L, 1, 3)).astype(np.float32)
    s = rng.uniform(-1, 1, (L, P, 1)).astype(np.float32)
    if fit == "line":
        pts = base + s * d + rng.normal(size=(L, P, 3)).astype(np.float32) * 0.01
    else:
        e = rng.normal(size=(L, 1, 3)).astype(np.float32)
        s2 = rng.uniform(-1, 1, (L, P, 1)).astype(np.float32)
        pts = base + s * d + s2 * e + rng.normal(size=(L, P, 3)).astype(np.float32) * 0.005
    mask = rng.random((L, P)) > 0.3
    jp, jm, tp, tm = jnp.asarray(pts), jnp.asarray(mask), torch.from_numpy(pts), torch.from_numpy(mask)
    if fit == "line":
        ref, out = jgeo.fit_line_pca(jp, jm), tgeo.fit_line_pca(tp, tm)
        keys = ("point", "dir", "eigvals")
    else:
        ref, out = jgeo.fit_plane_lsq(jp, jm, 0.03), tgeo.fit_plane_lsq(tp, tm, 0.03)
        keys = ("normal", "d", "centroid", "eigvals", "max_dist")
    for k in keys:
        _close(out[k], ref[k], atol=5e-4 if k == "eigvals" else 1e-4)
    assert (out["ok"].numpy() == np.asarray(ref["ok"])).all()


def test_angles_and_line_distance_match_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(64, 64, 3)).astype(np.float32)
    b = rng.normal(size=(64, 64, 3)).astype(np.float32)
    _close(tgeo.line_angle_between(torch.from_numpy(a), torch.from_numpy(b), degrees=True),
           jgeo.line_angle_between(jnp.asarray(a), jnp.asarray(b), degrees=True), atol=1e-3)
    u = b / np.linalg.norm(b, axis=-1, keepdims=True)
    _close(tgeo.point_to_line_distance(torch.from_numpy(a), torch.zeros(3), torch.from_numpy(u)),
           jgeo.point_to_line_distance(jnp.asarray(a), jnp.zeros(3), jnp.asarray(u)))
    ev = np.abs(rng.normal(size=(64, 3))).astype(np.float32)
    _close(tgeo.line_straightness(torch.from_numpy(ev)), jgeo.line_straightness(jnp.asarray(ev)),
           atol=1e-2)
