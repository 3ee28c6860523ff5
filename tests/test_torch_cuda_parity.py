"""The port on the card against the port on the CPU (whose CPU path the
other test_torch_*.py files hold against the JAX package). Marked `cuda`:
they skip where torch.cuda.is_available() is false. No jax import and no
conftest fixtures, so they run on a machine without JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_parity.py

Association: identical features and poses through the CUDA KNN kernels
(card) and the plain versions (CPU); masks exact, floats within atol 1e-4
(plane fits take eigenvectors of covariances summed in another order on
the card; the JAX parity test of association uses the same bound). LM:
the dense solve of __graft_entry__._synthetic_problem on both devices;
poses within 1e-5.
Extraction is not compared bit for bit here: atan2 and arccos differ in
the last bit between the card and the CPU, which can move one range-image
cell (measured: 1 cell in 86,400 on three 1800-azimuth scans).
"""

import numpy as np
import pytest
import torch

import synthetic
from __graft_entry__ import _synthetic_problem
from panovlm_tpu_torch.models import association
from panovlm_tpu_torch.sensors import velodyne as vd
from panovlm_tpu_torch.solver import lm, residuals

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from panovlm_tpu_torch.device import resolve
    return resolve("cuda")


@pytest.mark.cuda
def test_association_on_the_card_matches_the_cpu(cuda_device):
    scans, _ = synthetic.make_trajectory_scans(n_scans=3, h_steps=900)
    pads = [vd.pad_points(vd.preprocess_cloud(s)[0], 16384) for s in scans]
    feats = vd.extract_features(torch.from_numpy(np.stack([p for p, _ in pads])),
                                torch.from_numpy(np.stack([m for _, m in pads])))
    poses = torch.zeros(3, 6)
    poses[:, 3] = -0.15 * torch.arange(3)
    poses[1:, :3] += 0.002
    pr, pn = torch.tensor([0, 1, 1, 2]), torch.tensor([1, 0, 2, 1])
    cpu = association.associate_all_pairs(feats, poses, pr, pn)
    gpu = association.associate_all_pairs(
        {k: v.to(cuda_device) for k, v in feats.items()}, poses.to(cuda_device),
        pr.to(cuda_device), pn.to(cuda_device))
    for fam, out in cpu.items():
        mask = out["mask"]
        assert mask.any(), fam
        assert torch.equal(gpu[fam]["mask"].cpu(), mask), fam
        for key, val in out.items():
            if val.dtype.is_floating_point:
                torch.testing.assert_close(gpu[fam][key].cpu()[mask], val[mask],
                                           rtol=0, atol=1e-4)
            else:
                assert torch.equal(gpu[fam][key].cpu()[mask], val[mask]), (fam, key)


@pytest.mark.cuda
def test_dense_lm_on_the_card_matches_the_cpu(cuda_device):
    poses0, fixed, pair_r, pair_n, pts_n, pl_r = _synthetic_problem()
    n = len(pair_r)

    def solve(dev):
        t = lambda a: torch.from_numpy(a).to(dev)
        blk = lm.ResidualBlock(residuals.point2plane_meter, ("poses", "poses"),
                               (t(pair_r), t(pair_n)), (t(pts_n), t(pl_r)),
                               torch.ones(n, device=dev),
                               torch.ones(n, dtype=torch.bool, device=dev),
                               loss="huber", loss_scale=0.2)
        out, info = lm.solve_lm({"poses": t(poses0)}, (blk,), {"poses": t(fixed)},
                                lm.LMOptions(max_iters=5))
        return out["poses"].cpu(), info

    p_cpu, i_cpu = solve(torch.device("cpu"))
    p_gpu, i_gpu = solve(cuda_device)
    torch.testing.assert_close(p_gpu, p_cpu, rtol=0, atol=1e-5)
    assert i_gpu["iterations"] == i_cpu["iterations"]
