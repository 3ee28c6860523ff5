"""The port's spherical camera model and samplers (ops/spherical.py) against
panovlm_tpu/ops/spherical.py on the same seeded inputs.

Tolerances: ray grids and projections within 2e-5 (atan2/sin/cos differ in
the last bits between XLA and PyTorch, pixel coordinates carry W/2pi of
that); quantised values exactly equal; samples within 1e-4 of the packed
JAX samplers (the same taps, float weights); the LiDAR splat equal except
where a pixel-boundary floor/ceil flips (at most 0.1% of pixels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panovlm_tpu.ops import spherical as jsp
from panovlm_tpu_torch.ops import spherical as tsp

torch.set_num_threads(2)
H, W = 32, 64


def _uv(rng, n=4000):
    """Sample positions over the panorama, the seam and both poles included."""
    uv = np.stack([rng.uniform(-3, W + 3, n), rng.uniform(-2, H + 2, n)], -1)
    uv[:20, 1] = np.linspace(-1, 0.6, 20)          # north pole rows
    uv[20:40, 1] = np.linspace(H - 0.6, H + 1, 20)  # south pole rows
    return uv.astype(np.float32)


def test_ray_grid_and_projection_match_jax():
    rays_t = tsp.pixel_ray_grid(H, W).numpy()
    rays_j = np.asarray(jsp.pixel_ray_grid(H, W))
    np.testing.assert_allclose(rays_t, rays_j, atol=2e-6)
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(500, 3)).astype(np.float32) * 3
    np.testing.assert_allclose(tsp.cam_to_image(torch.from_numpy(pts), H, W).numpy(),
                               np.asarray(jsp.cam_to_image(jnp.asarray(pts), H, W)),
                               atol=2e-5)


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(H, W)).astype(np.float32)
    uv = _uv(rng)
    np.testing.assert_allclose(
        tsp.bilinear_sample(torch.from_numpy(img), torch.from_numpy(uv)).numpy(),
        np.asarray(jsp.bilinear_sample(jnp.asarray(img), jnp.asarray(uv))), atol=1e-6)


def test_u8_sampler_matches_packed_jax_sampler():
    rng = np.random.default_rng(2)
    img = rng.uniform(0.05, 0.9, size=(H, W)).astype(np.float32)
    uv = _uv(rng)
    packed, scale_j = jsp.pack_bilinear_u8(jnp.asarray(img))
    q, scale_t = tsp.quantize_u8(torch.from_numpy(img))
    assert float(scale_t) == float(scale_j)
    bytes0 = np.asarray(packed).view(np.uint8).reshape(H, W, 4)[..., 0]
    np.testing.assert_array_equal(q.numpy().astype(np.uint8), bytes0)
    ref = np.asarray(jsp.bilinear_sample_packed_u8(packed, scale_j, jnp.asarray(uv)))
    out = tsp.sample_u8(q, scale_t, torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("scale,offset", [(256.0, 0.0), (16384.0, 1.0)])
def test_u16_sampler_matches_packed_jax_sampler(scale, offset):
    rng = np.random.default_rng(3)
    img = (rng.uniform(0.3, 8.0, size=(H, W)) if offset == 0
           else rng.uniform(-1, 1, size=(H, W))).astype(np.float32)
    img[rng.uniform(size=(H, W)) < 0.1] = 0.0
    uv = _uv(rng)
    packed, _ = jsp.pack_bilinear_u16(jnp.asarray(img) + offset, scale)
    ref = np.asarray(jsp.bilinear_sample_packed_u16(packed, scale, jnp.asarray(uv)))
    q = tsp.quantize_u16(torch.from_numpy(img), scale, offset)
    out = tsp.sample_u16(q, scale, torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4 * max(1.0, 256.0 / scale))


def test_depth_splat_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(3000, 3)).astype(np.float32)
    pts *= rng.uniform(0.5, 6, size=(3000, 1)).astype(np.float32) / np.linalg.norm(
        pts, axis=1, keepdims=True)
    mask = rng.uniform(size=3000) > 0.1
    ref = np.asarray(jsp.project_points_to_depth_pano(jnp.asarray(pts), jnp.asarray(mask),
                                                      48, 96, size=3))
    out = tsp.project_points_to_depth_pano(torch.from_numpy(pts), torch.from_numpy(mask),
                                           48, 96, size=3).numpy()
    assert (out > 0).mean() > 0.3
    assert np.mean(out != ref) <= 1e-3, np.mean(out != ref)
