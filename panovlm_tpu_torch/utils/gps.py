"""GPS helpers — the port's copy of panovlm_tpu/utils/gps.py: pair
proposal, translation-scale priors, the GPS translation init and Umeyama
alignment (numpy and scipy on the host, so the same bits as the JAX
package's).

Reference touchpoints: GPS pair proposal (InitImagePairs GPS/GPS_VLAD mode,
sfm/SfM.cpp:49-168), SetTranslationScaleGPS (:681-702),
init_translation_GPS (EstimateGlobalTranslation, :1047-1344), and the
GPS<->SfM Umeyama check (SfM_test.cpp:528-568).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as ScR


def read_gps(path: str):
    """Read a GPS file (util/FileIO.cpp:134-166): per line `[name] x y z`
    (last three tokens are xyz); non-finite rows become +inf. Returns
    (xyz (N,3) float64, names list or None)."""
    xyz, names = [], []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            if len(toks) == 4:
                names.append(toks[0])
            try:
                v = [float(t) for t in toks[-3:]]
            except ValueError:
                continue
            xyz.append(v if all(np.isfinite(v)) else [np.inf] * 3)
    return np.asarray(xyz, np.float64), (names if names else None)


def gps_pairs(gps_xyz, radius: float = 5.0, max_per_frame: int = 10):
    """Pairs (i < j) among each frame's max_per_frame nearest GPS positions
    within radius, sorted. Returns (pi, pj) int32."""
    g = np.asarray(gps_xyz)
    n = len(g)
    d = np.linalg.norm(g[:, None] - g[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    pairs = set()
    for i in range(n):
        for j in np.argsort(d[i])[:max_per_frame]:
            if d[i, j] < radius:
                pairs.add((min(i, int(j)), max(i, int(j))))
    ordered = sorted(pairs)
    return (np.array([p[0] for p in ordered], np.int32),
            np.array([p[1] for p in ordered], np.int32))


def scale_from_gps(gps_xyz, pi, pj):
    """SetTranslationScaleGPS (SfM.cpp:681-702): pair scale = |GPS_j - GPS_i|."""
    g = np.asarray(gps_xyz)
    return np.linalg.norm(g[np.asarray(pj)] - g[np.asarray(pi)], axis=1).astype(np.float32)


def init_translation_gps(gps_xyz, aa_global):
    """init_translation_GPS: world camera centres from GPS -> t_cw params."""
    R_cw = ScR.from_rotvec(np.asarray(aa_global)).as_matrix()
    return (-np.einsum("nij,nj->ni", R_cw, np.asarray(gps_xyz))).astype(np.float32)


def umeyama(src, dst, with_scale: bool = True):
    """Umeyama similarity alignment src -> dst. Returns (s, R, t) with
    dst ~ s R src + t (the GPS<->SfM consistency check)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    U, S, Vt = np.linalg.svd(cov)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = (S * np.diag(D)).sum() / ((sc ** 2).sum() / len(src)) if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s
