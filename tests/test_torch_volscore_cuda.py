"""The plane-sweep NCC kernel (panovlm_tpu_torch/csrc/volscore.cu) against
its plain PyTorch version, on the card. Marked `cuda`: the tests skip where
torch.cuda.is_available() is false. This file imports neither jax nor the
test conftest's fixtures, so it runs on a machine without JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_volscore_cuda.py

Tolerance: atol 2e-4 on the costs in [0, 2], the bound the JAX package holds
its Pallas kernel to against the XLA path (tests/test_mvs.py). The kernel
and the plain version take the same two slices with the same weights, and
the kernel rounds each operation as the plain version's CUDA kernels do
(csrc/volscore.cu), so on the H100 they agree bit for bit. Two launches
on the same inputs must agree bit for bit (no atomics, fixed order).
"""

import numpy as np
import pytest
import torch

from panovlm_tpu_torch.ops import patchmatch as pm
from panovlm_tpu_torch.ops import spherical
from panovlm_tpu_torch.ops import volscore as vs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from panovlm_tpu_torch.device import resolve
    return resolve("cuda")


def _inputs(dev, V, C, D, H, W, seed=0):
    rng = np.random.default_rng(seed)
    rays = spherical.pixel_ray_grid(H, W, dev)
    vols = torch.from_numpy(rng.uniform(size=(V, D, H, W)).astype(np.float32)
                            ).to(dev).to(torch.bfloat16)
    gray = torch.from_numpy(rng.uniform(size=(H, W)).astype(np.float32)).to(dev)
    depth = torch.from_numpy(rng.uniform(1, 5, size=(C, H, W)).astype(np.float32)).to(dev)
    n_raw = torch.from_numpy(rng.normal(size=(C, H, W, 3)).astype(np.float32)).to(dev)
    nrm = pm.random_normals(n_raw, rays).permute(0, 3, 1, 2).contiguous()
    return vols, depth, nrm, rays.permute(2, 0, 1).contiguous(), gray


@pytest.mark.cuda
@pytest.mark.parametrize("hw,step,stride", [(4, 2, 1), (3, 1, 1), (3, 1, 4)])
def test_volscore_kernel_matches_plain_version(cuda_device, hw, step, stride):
    V, C, D, H, W = 3, 4, 16, 40, 96
    vols, depth, nrm, rays, gray = _inputs(cuda_device, V, C, D, H, W)
    cfg = pm.PatchMatchConfig(ncc_half_window=hw, ncc_step=step, min_depth=0.5,
                              max_depth=10.0, sweep_slices=D)
    inv0, inv_step = pm._inv_grid(cfg, stride)
    sub = vols[:, ::stride]
    offsets = pm._patch_offsets(cfg)
    n0 = vs.volscore.launches
    out = vs.volscore(sub, depth, nrm, rays, gray, offsets, inv0, inv_step,
                      cfg.min_depth, cfg.max_depth)
    assert vs.volscore.launches == n0 + 1
    ref = vs.volscore_reference(sub, depth, nrm, rays, gray, offsets, inv0,
                                inv_step, cfg.min_depth, cfg.max_depth)
    torch.cuda.synchronize()
    assert out.shape == (V, C, H, W)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-4)


@pytest.mark.cuda
def test_volscore_rejects_what_the_kernel_does_not_take(cuda_device):
    vols, depth, nrm, rays, gray = _inputs(cuda_device, 1, 1, 4, 8, 16)
    with pytest.raises(TypeError):
        vs.volscore(vols.float(), depth, nrm, rays, gray, [(0, 0)], 0.1, 0.1, 0.5, 10.0)
    with pytest.raises(ValueError):
        vs.volscore(vols, depth, nrm.transpose(2, 3), rays, gray, [(0, 0)],
                    0.1, 0.1, 0.5, 10.0)


@pytest.mark.cuda
@pytest.mark.parametrize("V, C, D, H, W, hw, step, stride", [
    (4, 3, 12, 21, 45, 6, 2, 1),    # ragged 32 x 8 tiles in both axes
    (2, 9, 12, 37, 83, 3, 1, 3),    # the ranking kernel shape (V <= 2), strided slices
    (3, 2, 12, 5, 7, 6, 3, 1),      # window wider than the image: rows and columns wrap twice
    (4, 2, 64, 21, 45, 3, 1, 1),    # slab over 100 KB: slices read from device memory
    (6, 2, 12, 21, 45, 3, 1, 1),    # more views than one pass holds: two view chunks
])
def test_volscore_ragged_tiles_wrap_and_determinism(cuda_device, V, C, D, H, W, hw, step,
                                                    stride):
    vols, depth, nrm, rays, gray = _inputs(cuda_device, V, C, D, H, W, seed=H)
    cfg = pm.PatchMatchConfig(ncc_half_window=hw, ncc_step=step, min_depth=0.5,
                              max_depth=10.0, sweep_slices=D)
    inv0, inv_step = pm._inv_grid(cfg, stride)
    args = (vols[:, ::stride], depth, nrm, rays, gray, pm._patch_offsets(cfg), inv0,
            inv_step, cfg.min_depth, cfg.max_depth)
    out = vs.volscore(*args)
    again = vs.volscore(*args)
    ref = vs.volscore_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-4)
