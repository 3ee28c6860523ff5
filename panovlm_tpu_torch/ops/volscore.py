"""Plane-sweep NCC scoring — the wrapper of the CUDA kernel in
`csrc/volscore.cu`, and its plain PyTorch version.

`volscore` replaces `panovlm_tpu/ops/pallas/volscore.py:_kernel` (driven by
`score_candidates`) and computes what its oracle, the XLA vol path of
`panovlm_tpu/ops/patchmatch.py:ncc_cost`, computes: the weighted-NCC cost
(1 - NCC, 2.0 where invalid) of C candidate planes per pixel against V
plane-sweep volumes, over T texel offsets. On a CUDA tensor it launches the
kernel or raises; on a CPU tensor it calls `volscore_reference`. Launches
are counted in `volscore.launches`.

The kernel (csrc/volscore.cu) stages each 32 x 8 pixel tile's rays and gray
with their halo in shared memory, and computes every quantity once at the
level it depends on: the bilateral factor per (pixel, texel), the plane
depth, slice coordinate and the gray moments per (candidate, pixel, texel),
only the hat sample and its three moments per (view, candidate, pixel,
texel), with the block's slab of the volume staged in shared memory where
it fits (the MVS stage's 16-slice sweep). The texel offsets travel by value
in the launch (a host array, cached per offset list), so a launch copies
nothing from the host to the card. The kernel takes at most 256 offsets
within +-16 of the pixel.

Inputs: vols (V,D,H,W) bfloat16 with unit column stride and row stride W
(a slice subset such as vols[:, ::4] is taken as it is, through its
strides); depth (C,H,W), nrm (C,3,H,W), rays (3,H,W), gray (H,W) float32
contiguous; offsets, the T (dv, du) texel offsets. The volume's slices sit
at inverse depth inv0 + k * inv_step, k = 0..D-1. Returns (V,C,H,W) float32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_TEXELS = 256   # csrc/volscore.cu MAX_T
MAX_HALO = 16      # csrc/volscore.cu MAX_HALO
_offset_arrays: dict = {}   # offsets tuple -> ctypes int32 array of (dv, du)


def _offset_array(offsets):
    arr = _offset_arrays.get(offsets)
    if arr is None:
        flat = [x for dv_du in offsets for x in dv_du]
        arr = _offset_arrays[offsets] = (ctypes.c_int * len(flat))(*flat)
    return arr


def _check(vols, depth, nrm, rays, gray, offsets):
    if vols.dim() != 4 or vols.dtype != torch.bfloat16:
        raise TypeError(f"vols must be (V,D,H,W) bfloat16, got "
                        f"{tuple(vols.shape)} {vols.dtype}")
    V, D, H, W = vols.shape
    C = depth.shape[0]
    want = {"depth": (depth, (C, H, W)), "nrm": (nrm, (C, 3, H, W)),
            "rays": (rays, (3, H, W)), "gray": (gray, (H, W))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    if not offsets:
        raise ValueError("no texel offsets")
    devices = {x.device for x in (vols, depth, nrm, rays, gray)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    dev = vols.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not all(x.is_contiguous() for x in (depth, nrm, rays, gray)):
            raise ValueError("the kernel takes contiguous depth/nrm/rays/gray")
        if vols.stride(3) != 1 or vols.stride(2) != W:
            raise ValueError("the kernel takes volumes with contiguous (H,W) slices")
        if len(offsets) > MAX_TEXELS or max(max(abs(a), abs(b)) for a, b in offsets) > MAX_HALO:
            raise ValueError(f"the kernel takes at most {MAX_TEXELS} texel offsets "
                             f"within +-{MAX_HALO}")
        if (max(V * C, 3 * C) * H * W >= 2**31 or H > 8 * 65535
                or (D - 1) * vols.stride(1) + H * W >= 2**31):
            raise ValueError("the kernel indexes with 32-bit offsets and takes "
                             "H <= 524280: inputs too large")
    return dev


def clamp_den(d):
    """The plane-depth denominator kept 1e-6 away from 0, sign kept."""
    small = torch.abs(d) < 1e-6
    return torch.where(small, torch.sign(d) * 1e-6 + 1e-12, d)


def volscore_reference(vols, depth, nrm, rays, gray, offsets, inv0: float,
                       inv_step: float, dmin: float, dmax: float,
                       sigma_color: float = 0.2):
    """Plain PyTorch version of `volscore`: ncc_cost's vol path per view,
    a loop over texels with (C,H,W) temporaries only. Like the oracle, the
    slice coordinate is rolled to the texel, the volume is read in place
    (hat weights: the two bracketing slices) and the result rolled back."""
    V, D = vols.shape[:2]
    rho = depth * torch.sum(nrm * rays[None], dim=1)              # (C,H,W)
    outs = []
    for v in range(V):
        vol = vols[v]
        zero = torch.zeros_like(depth)
        sw, sx, sy, sxx, syy, sxy = (zero.clone() for _ in range(6))
        for dv, du in offsets:
            r_t = torch.roll(rays, (-dv, -du), dims=(1, 2))
            lam = rho / clamp_den(torch.sum(nrm * r_t[None], dim=1))
            sigma = (1.0 / torch.clamp_min(lam, 1e-6) - inv0) / inv_step
            sigma = torch.clamp(sigma, 0.0, D - 1)
            sig_t = torch.roll(sigma, (dv, du), dims=(1, 2))
            i0 = torch.floor(sig_t)
            f = sig_t - i0
            i0 = i0.to(torch.int64)
            vol_c = vol[None].expand(sig_t.shape[0], *vol.shape)
            lo = torch.gather(vol_c, 1, i0[:, None])[:, 0].float()
            hi = torch.gather(vol_c, 1, torch.clamp(i0 + 1, max=D - 1)[:, None])[:, 0].float()
            s = torch.roll((1.0 - f) * lo + f * hi, (-dv, -du), dims=(1, 2))
            i_t = torch.roll(gray, (-dv, -du), dims=(0, 1))
            w = torch.exp(-((i_t - gray) ** 2) / (2 * sigma_color ** 2)) * (lam > 0)
            sw += w
            sx += w * i_t
            sy += w * s
            sxx += w * i_t * i_t
            syy += w * s * s
            sxy += w * i_t * s
        outs.append(ncc_cost_from_moments(sw, sx, sy, sxx, syy, sxy, depth, dmin, dmax))
    return torch.stack(outs)


def ncc_cost_from_moments(sw, sx, sy, sxx, syy, sxy, depth, dmin: float, dmax: float):
    """1 - weighted NCC from the weighted moments of the reference (x) and
    neighbour (y) texels, 2.0 where the weights vanish or the depth lies
    outside (dmin, dmax): the tail of the JAX package's ncc_cost."""
    eps = 1e-6
    mx = sx / (sw + eps)
    my = sy / (sw + eps)
    vx = sxx / (sw + eps) - mx * mx
    vy = syy / (sw + eps) - my * my
    cov = sxy / (sw + eps) - mx * my
    ncc = torch.clamp(cov / torch.sqrt(torch.clamp_min(vx * vy, eps * eps)), -1.0, 1.0)
    valid = (sw > 1e-3) & (depth > dmin) & (depth < dmax)
    return torch.where(valid, 1.0 - ncc, torch.full_like(ncc, 2.0))


def volscore(vols, depth, nrm, rays, gray, offsets, inv0: float,
             inv_step: float, dmin: float, dmax: float,
             sigma_color: float = 0.2):
    """NCC cost (V,C,H,W) of C candidate planes against V sweep volumes."""
    offsets = tuple((int(dv), int(du)) for dv, du in offsets)
    dev = _check(vols, depth, nrm, rays, gray, offsets)
    if dev.type == "cpu":
        return volscore_reference(vols, depth, nrm, rays, gray, offsets, inv0,
                                  inv_step, dmin, dmax, sigma_color)
    lib = _build.load()
    V, D, H, W = vols.shape
    C = depth.shape[0]
    out = torch.empty((V, C, H, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.volscore_launch(
            vols.data_ptr(), vols.stride(0), vols.stride(1), depth.data_ptr(),
            nrm.data_ptr(), rays.data_ptr(), gray.data_ptr(),
            _offset_array(offsets), len(offsets), V, C, D, H, W,
            float(inv0), 1.0 / inv_step, float(dmin), float(dmax),
            1.0 / (2 * sigma_color ** 2), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"volscore kernel launch failed: cudaError {rc}")
    volscore.launches += 1
    return out


volscore.launches = 0
