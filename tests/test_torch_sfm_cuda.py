"""The port's SfM path on the card against the same code on the CPU (whose
CPU path tests/test_torch_sfm.py holds against the JAX package). Marked
`cuda`: they skip where torch.cuda.is_available() is false. No jax import
and no conftest fixtures, so they run on a machine without JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_sfm_cuda.py

Tolerances: matching through the descriptor kernel (card) and the plain
version (CPU) accepts the same set of matches (no ratio-test near-tie on
this scene) at squared distances within 2e-6; their order by distance may
differ. Both form |q|^2 + |t|^2 - 2 q.t, whose terms are near 1 for unit
descriptors, so a squared distance of ~1e-4 carries the rounding of those
terms (a few ulp of 2, i.e. several 1e-7) and the kernel
sums q.t in another order; the 400 match distances of a pair lie within
that rounding of each other. Relative poses from the same
matches and draws agree within 1e-3 rad / 1e-3 (batched SVD, eigh and 3x3
inverses run on cuSOLVER / in another order on the card); the
Schur global BA within 1e-3; device SIFT puts at least 95 % of keypoints
within 0.01 px of the CPU's. Device SIFT, the VLAD proposal and matching
give the same bits on two runs (ROADMAP F8).
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScR

from panovlm_tpu_torch.models import sfm, vlad
from panovlm_tpu_torch.ops import sift_device
from panovlm_tpu_torch.utils import tracks

torch.set_num_threads(2)

N_FRAMES, N_POINTS = 6, 400


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from panovlm_tpu_torch.device import resolve
    return resolve("cuda")


def _scene():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-4, 4, (N_POINTS, 3))
    pts[:, 1] *= 0.4
    aa = np.cumsum(rng.normal(size=(N_FRAMES, 3)) * 0.02, axis=0)
    aa[0] = 0
    C = np.cumsum(rng.normal(size=(N_FRAMES, 3)) * [0.25, 0.05, 0.25], axis=0)
    C[0] = 0
    R = ScR.from_rotvec(aa).as_matrix()
    t = -np.einsum("nij,nj->ni", R, C)
    b = np.einsum("nij,pj->npi", R, pts) + t[:, None]
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    b += rng.normal(size=b.shape) * 5e-4
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    dgt = rng.normal(size=(N_POINTS, 128))
    desc = dgt[None] + rng.normal(size=(N_FRAMES, N_POINTS, 128)) * 0.01
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    cfg = sfm.SfMConfig(contiguous_window=3, max_matches=512, ransac_hypotheses=200,
                        match_max_dist_factor=10.0)
    poses = np.concatenate([aa, t], 1).astype(np.float32)
    return (b.astype(np.float32), desc.astype(np.float32),
            np.ones((N_FRAMES, N_POINTS), bool), poses, cfg)


@pytest.mark.cuda
def test_matching_relative_poses_and_ba_card_vs_cpu(cuda_device):
    bear, desc, fmask, poses, cfg = _scene()
    pi, pj = sfm.init_image_pairs(N_FRAMES, cfg)
    m = {}
    for dev in ("cpu", cuda_device):
        out = sfm.match_all_pairs(torch.from_numpy(desc).to(dev),
                                  torch.from_numpy(fmask).to(dev), pi, pj, cfg)
        m[str(dev)] = {k: v.cpu().numpy() for k, v in out.items()}
    m_c, m_g = m["cpu"], m[str(cuda_device)]
    for k in ("mask", "pair_ok"):
        np.testing.assert_array_equal(m_g[k], m_c[k])
    for p in range(len(pi)):
        rows_c = {tuple(r): d for r, d in zip(m_c["idx"][p][m_c["mask"][p]],
                                              m_c["dist"][p][m_c["mask"][p]])}
        rows_g = {tuple(r): d for r, d in zip(m_g["idx"][p][m_g["mask"][p]],
                                              m_g["dist"][p][m_g["mask"][p]])}
        assert rows_g.keys() == rows_c.keys()
        np.testing.assert_allclose(np.square([rows_g[r] for r in rows_c]),
                                   np.square(list(rows_c.values())), rtol=0, atol=2e-6)
    r = {}
    for dev in ("cpu", cuda_device):
        rel = sfm.relative_poses(torch.from_numpy(bear).to(dev),
                                 torch.from_numpy(m_c["idx"]).to(dev),
                                 torch.from_numpy(m_c["mask"]).to(dev), pi, pj, cfg)
        r[str(dev)] = {k: v.cpu().numpy() for k, v in rel.items()}
    r_c, r_g = r["cpu"], r[str(cuda_device)]
    np.testing.assert_array_equal(r_g["ok"], r_c["ok"])
    assert r_c["ok"].all()
    np.testing.assert_allclose(r_g["rel_aa"], r_c["rel_aa"], atol=1e-3)
    np.testing.assert_allclose(r_g["rel_t"], r_c["rel_t"], atol=1e-3)

    pm = [(int(a), int(b), m_c["idx"][k][m_c["mask"][k]]) for k, (a, b) in enumerate(zip(pi, pj))]
    timg, tfeat, tmask = tracks.build_tracks(pm, [N_POINTS] * N_FRAMES, min_length=3)
    p0 = poses.copy()
    p0[1:] += 0.01
    X, ok = sfm.estimate_structure(torch.from_numpy(p0), torch.from_numpy(bear),
                                   torch.from_numpy(timg), torch.from_numpy(tfeat),
                                   torch.from_numpy(tmask), cfg)
    args = (p0, X.numpy(), timg, tfeat, tmask, bear, ok.numpy(), np.ones(N_FRAMES, bool), cfg)
    pc, Xc, _ = sfm.global_ba(*args, device="cpu")
    pg, Xg, _ = sfm.global_ba(*args, device=cuda_device)
    np.testing.assert_allclose(pg, pc, atol=1e-3)


@pytest.mark.cuda
def test_device_sift_card_vs_cpu(cuda_device):
    import synthetic
    gray = synthetic.render_panorama(np.array([0.3, 0.1, 0.2]), 256, 512)[0]
    res = {}
    for dev in ("cpu", cuda_device):
        uv, desc, val, _ = sift_device.detect_and_describe(
            torch.from_numpy(gray).to(dev), num_features=2048)
        res[str(dev)] = (uv.cpu().numpy(), desc.cpu().numpy(), val.cpu().numpy())
    (uv_c, d_c, v_c), (uv_g, d_g, v_g) = res["cpu"], res[str(cuda_device)]
    a, b = uv_c[v_c], uv_g[v_g]
    dist = np.linalg.norm(a[:, None] - b[None], axis=-1).min(axis=1)
    assert (dist < 0.01).mean() >= 0.95


@pytest.mark.cuda
def test_device_sift_vlad_and_matching_are_reproducible(cuda_device):
    import synthetic
    grays = np.stack([synthetic.render_panorama(np.array([0.3 * i, 0.1, 0.2]), 128, 256)[0]
                      for i in range(4)])
    cfg = sfm.SfMConfig(contiguous_window=2, max_matches=512)
    runs = []
    for _ in range(2):
        uv, desc, fm = sift_device.extract_sift_device_batch(grays, num_features=1024,
                                                             device=cuda_device)
        d, m = torch.from_numpy(desc).to(cuda_device), torch.from_numpy(fm).to(cuda_device)
        pi, pj, emb = vlad.vlad_pairs(d, m, n_neighbors=2, n_centers=16, sample=2000)
        mm = sfm.match_all_pairs(d, m, pi, pj, cfg)
        runs.append([uv, desc, fm, pi, pj, emb] + [v.cpu().numpy() for v in mm.values()])
    for a, b in zip(*runs):
        assert np.array_equal(a, b)
