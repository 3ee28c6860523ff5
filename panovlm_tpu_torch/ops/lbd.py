"""Line band descriptors of panoramic line arcs — the port of
`panovlm_tpu/ops/lbd.py` (the reference's OpenCV LBD,
util/PanoramaLine.cpp:39-74, matched in joint_optimization/
PanoramaLineMatch.cpp:33-58).

S points are sampled along each line's great-circle arc; around them a
line support region of n_bands x band_width pixel rows runs parallel to the
projected arc. The image gradients, sampled bilinearly there, are projected
on the local tangent and normal and half-wave rectified into 4 channels;
each band is described by the Gaussian-weighted mean and the population std
of those channels, giving 8 * n_bands floats, L2-normalised, clipped at 0.4
and normalised again. The tangent frame is taken per sample from the
projected arc, with the longitude wrap.

Plain torch on the tensors' device. Float32 throughout, with the JAX
module's order of operations where it decides the last bits.
"""

from __future__ import annotations

import torch

from . import spherical


def _gradients(gray):
    """(gx, gy) of `jnp.gradient`: central differences inside, one-sided
    differences on the border rows and columns."""
    gy, gx = torch.gradient(gray)
    return gx, gy


def _bilinear(img, u, v):
    """Bilinear sample with the longitude wrapped on u and v clamped to
    [0, H - 1.001]."""
    H, W = img.shape
    u = torch.remainder(u, W)
    v = torch.clamp(v, 0.0, H - 1.001)
    u0 = torch.floor(u).to(torch.int32)
    v0 = torch.floor(v).to(torch.int32)
    u1 = torch.remainder(u0 + 1, W)
    v1 = torch.clamp_max(v0 + 1, H - 1)
    fu = u - u0
    fv = v - v0
    u0, v0, u1, v1 = u0.long(), v0.long(), u1.long(), v1.long()
    return (img[v0, u0] * (1 - fu) * (1 - fv) + img[v0, u1] * fu * (1 - fv)
            + img[v1, u0] * (1 - fu) * fv + img[v1, u1] * fu * fv)


def _normalize(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def line_band_descriptors(gray, e1, e2, mask, n_bands: int = 9, band_width: int = 7,
                          n_samples: int = 24):
    """Descriptors for the great-circle arcs of one panorama. gray (H, W)
    float; e1/e2 (L, 3) unit endpoint rays; mask (L,). Returns
    (L, 8 * n_bands) float32, zero rows where mask is False."""
    H, W = gray.shape
    dev = gray.device
    gx, gy = _gradients(gray.to(torch.float32))
    rows_total = n_bands * band_width
    # the Gaussian weight across the support region (LBD's global weight)
    r_off = torch.arange(rows_total, dtype=torch.float32, device=dev) - (rows_total - 1) / 2.0
    w_g = torch.exp(-0.5 * (r_off / (0.5 * rows_total)) ** 2)
    # jnp.linspace(0, 1, S) on XLA:CPU: i times the float32 reciprocal of S - 1
    t_s = (torch.arange(n_samples, dtype=torch.float32, device=dev)
           * torch.tensor(1.0 / (n_samples - 1), dtype=torch.float32, device=dev))

    # the arcs, slerped: (L, S, 3)
    cosw = torch.clamp(torch.sum(e1 * e2, dim=-1), -1.0, 1.0)
    theta = torch.arccos(cosw)[:, None, None]
    sinw = torch.clamp_min(torch.sin(theta), 1e-6)
    pts = (torch.sin((1 - t_s)[None, :, None] * theta) * e1[:, None]
           + torch.sin(t_s[None, :, None] * theta) * e2[:, None]) / sinw
    uv = spherical.cam_to_image(_normalize(pts), H, W)             # (L, S, 2)
    # the pixel-space tangent, with the longitude wrap
    d_uv = torch.roll(uv, -1, dims=1) - torch.roll(uv, 1, dims=1)
    du = torch.remainder(d_uv[..., 0] + W / 2, W) - W / 2
    tang = torch.stack([du, d_uv[..., 1]], dim=-1)
    tang = tang / (torch.linalg.vector_norm(tang, dim=-1, keepdim=True) + 1e-9)
    nrml = torch.stack([-tang[..., 1], tang[..., 0]], dim=-1)

    # the support region: (L, R, S) sample positions
    u_s = uv[:, None, :, 0] + r_off[None, :, None] * nrml[:, None, :, 0]
    v_s = uv[:, None, :, 1] + r_off[None, :, None] * nrml[:, None, :, 1]
    g_x = _bilinear(gx, u_s, v_s)
    g_y = _bilinear(gy, u_s, v_s)
    g_d = g_x * tang[:, None, :, 0] + g_y * tang[:, None, :, 1]
    g_n = g_x * nrml[:, None, :, 0] + g_y * nrml[:, None, :, 1]
    feat = torch.stack([torch.clamp_min(g_n, 0), torch.clamp_min(-g_n, 0),
                        torch.clamp_min(g_d, 0), torch.clamp_min(-g_d, 0)], dim=-1)
    feat = feat * w_g[None, :, None, None]                           # (L, R, S, 4)
    bands = feat.reshape(-1, n_bands, band_width * n_samples, 4)
    mean = bands.mean(dim=2)                                         # (L, B, 4)
    std = bands.std(dim=2, correction=0)                             # population std
    desc = torch.cat([mean, std], dim=-1).reshape(mean.shape[0], -1)
    desc = torch.clamp(_normalize(desc), 0.0, 0.4)                   # SIFT-style hat
    desc = _normalize(desc)
    return torch.where(mask[:, None], desc, torch.zeros_like(desc)).to(torch.float32)


def line_band_descriptors_batch(grays, e1, e2, mask, n_bands: int = 9,
                                band_width: int = 7, n_samples: int = 24):
    """All frames: grays (N, H, W) float, e1/e2 (N, L, 3), mask (N, L) ->
    (N, L, 8 * n_bands). One frame at a time, so that each frame's gradient
    and support-region tensors stay one frame in size; no host sync."""
    return torch.stack([line_band_descriptors(g, a, b, m, n_bands, band_width, n_samples)
                        for g, a, b, m in zip(grays, e1, e2, mask)])


def lbd_distance_matrix(desc_i, desc_j):
    """(Lj, Li) L2 distances in the matmul form |a|^2 + |b|^2 - 2 a.b,
    clamped at 0 (full float32 products: device.resolve keeps TF32 off)."""
    d2 = (torch.sum(desc_j * desc_j, -1)[:, None] + torch.sum(desc_i * desc_i, -1)[None, :]
          - 2 * desc_j @ desc_i.T)
    return torch.sqrt(torch.clamp_min(d2, 0.0))
