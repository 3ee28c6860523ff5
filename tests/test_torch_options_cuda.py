"""The last four options of the port on the card against the port on the
CPU (whose CPU path tests/test_torch_odometry_options.py and
tests/test_torch_mvs_options.py hold against the JAX package). Marked
`cuda`: they skip where torch.cuda.is_available() is false. No jax import
and no conftest fixtures, so they run on a machine without JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_options_cuda.py

Ring repair, hysteresis and method-2 extraction decide in integers: card
and CPU bit-equal. Exact per-plane sampling (sweep_slices = 0) runs the
same float ops on both devices, whose atan2, acos, exp and reductions
round otherwise in the last bits: half the rays differ by up to 4.8e-7,
and where a texel ray grazes the candidate plane its depth lambda differs
by up to 1.5 (the first card run, 96 x 192). NCC on nearly flat patches
and arccos next to 1 amplify those bits (one float step of a cosine next
to 1 is up to 0.0099 of the geometric penalty, 0.002 of the cost). The
bounds, every pixel within 0.05 and: photometric scoring 99.5 % of the
pixels within 1e-4 and 99.9 % within 1e-3 (measured 99.54 and 99.99 %);
with the geometric term 99 % within 1e-3 (measured 99.65 %); one step
with the geometric term, fewer than 1 % of the pixels picking another
plane (measured 0.07 %) and 98 % of the others' costs within 1e-3
(measured 98.75 %); the largest differences measured 0.0020-0.0024 (an
NVIDIA H100 80GB HBM3 at 700 W; -s prints the shares). Two runs on the
card bit-equal (no atomics).
"""

import numpy as np
import pytest
import torch

import synthetic
from panovlm_tpu_torch.models import mvs
from panovlm_tpu_torch.ops import patchmatch as pm
from panovlm_tpu_torch.ops import spherical
from panovlm_tpu_torch.ops import volscore as vs
from panovlm_tpu_torch.sensors import velodyne as vd
from ring_scans import jittered_scan, probe

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from panovlm_tpu_torch.device import resolve
    return resolve("cuda")


def _padded(clouds, cap):
    pads = [vd.pad_points(c, cap) for c in clouds]
    return (torch.from_numpy(np.stack([p for p, _ in pads])),
            torch.from_numpy(np.stack([m for _, m in pads])))


@pytest.mark.cuda
def test_ring_repair_on_the_card_matches_the_cpu(cuda_device):
    pts, expect = probe()
    clouds = [pts, jittered_scan(0), jittered_scan(1)]
    p, m = _padded(clouds, 12288)
    cpu = vd.repair_ring_conflicts(p, m)
    gpu = vd.repair_ring_conflicts(p.to(cuda_device), m.to(cuda_device))
    again = vd.repair_ring_conflicts(p.to(cuda_device), m.to(cuda_device))
    assert torch.equal(gpu, again)
    assert torch.equal(gpu.cpu(), cpu)
    np.testing.assert_array_equal(gpu[0, :len(expect)].cpu().numpy(), expect)


@pytest.mark.cuda
def test_hysteresis_on_the_card_matches_the_cpu(cuda_device):
    rng = np.random.default_rng(3)
    loose = torch.from_numpy(rng.random((4, 16, 1800)) < 0.1)
    strict = loose & torch.from_numpy(rng.random((4, 16, 1800)) < 0.15)
    keep, lab = vd.combine_edges_hysteresis(strict, loose)
    gk, gl = vd.combine_edges_hysteresis(strict.to(cuda_device), loose.to(cuda_device))
    assert keep.any() and torch.equal(gk.cpu(), keep) and torch.equal(gl.cpu(), lab)


@pytest.mark.cuda
def test_method2_repair_extraction_on_the_card_matches_the_cpu(cuda_device):
    raw, _ = synthetic.make_trajectory_scans(n_scans=2, h_steps=900)
    p, m = _padded([vd.preprocess_cloud(s)[0] for s in raw], 16384)
    kw = dict(method=2, repair_rings=True)
    cpu = vd.extract_features(p, m, **kw)
    gpu = vd.extract_features(p.to(cuda_device), m.to(cuda_device), **kw)
    again = vd.extract_features(p.to(cuda_device), m.to(cuda_device), **kw)
    assert cpu["less_sharp_mask"].sum() > 50
    for k, v in cpu.items():
        assert torch.equal(gpu[k], again[k]), k
        if v.dtype.is_floating_point and k not in ("sharp", "less_sharp", "flat", "less_flat"):
            torch.testing.assert_close(gpu[k].cpu(), v, rtol=1e-5, atol=1e-6, msg=k)
        else:
            assert torch.equal(gpu[k].cpu(), v), k


# ----------------------------------------------------------------------------
# exact per-plane sampling on 4 panoramas of the synthetic room
# ----------------------------------------------------------------------------

H, W = 96, 192
CENTERS = ((0.0, 0.4, 0.0), (0.7, 0.4, 0.2), (-0.5, 0.2, -0.4), (0.2, 0.6, -0.7))


def _scene(dev):
    grays, depths = zip(*[synthetic.render_panorama(np.array(c), H, W) for c in CENTERS])
    poses = np.zeros((4, 6), np.float32)
    poses[:, 3:] = -np.asarray(CENTERS, np.float32)
    cfg = pm.PatchMatchConfig(ncc_half_window=3, ncc_step=1, min_depth=0.4, max_depth=8.0,
                              sweep_slices=0)
    R, t = mvs.relative_to_neighbors(poses, 0, np.array([1, 2, 3]), dev)
    rays = spherical.pixel_ray_grid(H, W, dev)
    qs = [spherical.quantize_u8(torch.from_numpy(g.astype(np.float32)).to(dev))
          for g in grays[1:]]
    nd = spherical.quantize_u16(torch.from_numpy(np.stack(depths[1:]).astype(np.float32)
                                                 * 1.02).to(dev))
    views = pm.pack_views(torch.stack([q for q, _ in qs]), [s for _, s in qs], rays, R, nd)
    rng = np.random.default_rng(5)
    depth = torch.from_numpy((depths[0] * rng.uniform(0.8, 1.25, (H, W))).astype(np.float32))
    n_raw = torch.from_numpy(rng.normal(size=(H, W, 3)).astype(np.float32))
    normal = pm.random_normals(n_raw.to(dev), rays)
    gray = torch.from_numpy(grays[0].astype(np.float32)).to(dev)
    return dict(gray=gray, rays=rays, R=R, t=t, views=views, cfg=cfg, depth=depth.to(dev),
                normal=normal)


def _draws(cfg, dev):
    g = torch.Generator().manual_seed(7)
    return {k: ([x.to(dev) for x in v] if isinstance(v, list) else v.to(dev))
            for k, v in pm.draw_step(g, spherical.pixel_ray_grid(H, W), cfg).items()}


def _close(out, ref, tol, share, label):
    """Every pixel within 0.05 and `share` of them within `tol`; prints
    (with -s) and the messages give the shares within 1e-4, 2e-4 and 1e-3."""
    d = (out.cpu() - ref).abs()
    shares = {t: float((d <= t).float().mean()) for t in (1e-4, 2e-4, 1e-3)}
    print(f"\n{label}: largest difference {float(d.max()):.3g}, shares within 1e-4, "
          f"2e-4, 1e-3: {shares}")
    assert d.max() <= 0.05, (float(d.max()), shares)
    assert shares[tol] >= share, shares


def _cost(s, views):
    return pm.multiview_cost(s["gray"], s["rays"], s["depth"][None], s["normal"][None],
                             s["R"], s["t"], s["cfg"], pm._patch_offsets(s["cfg"]), views)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("geometric", [False, True])
def test_exact_scoring_on_the_card_matches_the_cpu(cuda_device, geometric):
    cpu, gpu = _scene("cpu"), _scene(cuda_device)
    pick = (lambda v: v) if geometric else (lambda v: v._replace(depth_q=None))
    n0 = vs.volscore.launches
    c_cpu, c_gpu = _cost(cpu, pick(cpu["views"])), _cost(gpu, pick(gpu["views"]))
    assert torch.equal(c_gpu, _cost(gpu, pick(gpu["views"])))
    assert vs.volscore.launches == n0
    if geometric:
        _close(c_gpu, c_cpu, 1e-3, 0.99, "scoring with the geometric term")
    else:
        _close(c_gpu, c_cpu, 1e-4, 0.995, "photometric scoring")
        _close(c_gpu, c_cpu, 1e-3, 0.999, "photometric scoring")


@pytest.mark.cuda
def test_exact_step_on_the_card_matches_the_cpu(cuda_device):
    cpu, gpu = _scene("cpu"), _scene(cuda_device)
    c_cpu = _cost(cpu, cpu["views"])

    def step(s, dev):
        fixed = torch.zeros((H, W), dtype=torch.bool, device=dev)
        return pm.sequential_step(s["gray"], s["rays"], s["depth"], s["normal"],
                                  c_cpu.to(dev), s["R"], s["t"], fixed, s["cfg"], 0,
                                  s["views"], draws=_draws(s["cfg"], dev))

    n0 = vs.volscore.launches
    d_cpu, n_cpu, k_cpu = step(cpu, "cpu")
    d_gpu, n_gpu, k_gpu = step(gpu, cuda_device)
    d_2, n_2, k_2 = step(gpu, cuda_device)
    assert torch.equal(d_gpu, d_2) and torch.equal(n_gpu, n_2) and torch.equal(k_gpu, k_2)
    assert vs.volscore.launches == n0
    differ = ((d_gpu.cpu() - d_cpu).abs() > 1e-4 * d_cpu) \
        | ((n_gpu.cpu() - n_cpu).abs().amax(-1) > 1e-4)
    print(f"\none step: share of pixels on another plane {float(differ.float().mean()):.4g}")
    assert differ.float().mean() < 0.01, differ.float().mean()
    assert (d_cpu != cpu["depth"].cpu()).float().mean() > 0.1
    _close(k_gpu[~differ.to(cuda_device)], k_cpu[~differ], 1e-3, 0.98,
           "one step, the other pixels' costs")
