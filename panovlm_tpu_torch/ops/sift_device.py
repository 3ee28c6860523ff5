"""SIFT on the card — the port of panovlm_tpu/ops/sift_device.py, the
port's detector (the machine with the card has no cv2, so the host cv2
SIFT of the JAX stage cannot run there).

Batched over frames: 2x bilinear upsample (cv2's firstOctave = -1),
separable Gaussian pyramid by shift-and-add with edge padding, 26-neighbour
DoG extrema with contrast and edge rejection (OpenCV's constants), per-octave
top-k, 36-bin orientation voting and the 4x4x8 descriptor with trilinear
binning, L2 / clip 0.2 / L2 and optional RootSIFT. Same outputs as the JAX
module: uv (F,2) full-resolution pixels (x, y), desc (F,128), valid (F,).

The JAX module samples the gradient images through u16 "packed quads" (a
TPU gather trick); the port keeps their quantization (round((d + 2) *
16383.75), read back as q / 16383.75 - 2) and samples the quantized image
bilinearly, which gives the same four taps. Top-k ties keep the lower index,
as `lax.top_k` does (stable descending sort). The TPU chunking of the frame
axis (2 frames above 4096 features) exists for TPU memory; here a chunk of
frames is sized for the card (`frame_chunk`).

The orientation histogram and the descriptor bins are scattered sums; they
are summed exactly (`exact.scatter_sum`, int64 fixed point), so the descriptors are the same on every run: float
`scatter_add_` on the card adds with atomics in a varying order (ROADMAP
F8).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import exact

CONTRAST_THRESHOLD = 0.04
EDGE_RATIO = 10.0
N_SPLIT = 3
SIGMA0 = 1.6
N_ORI_BINS = 36
DESC_WIDTH = 4
DESC_BINS = 8
DESC_SCALE = 3.0
GRAD_SCALE = 16383.75


def _gauss_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img, sigma: float):
    """Separable Gaussian blur of (..., H, W): edge padding, taps added in
    order."""
    radius = max(1, int(math.ceil(3.0 * sigma)))
    k = _gauss_kernel1d(sigma, radius)

    def conv_last(x):
        W = x.shape[-1]
        xp = torch.cat([x[..., :1].expand(*x.shape[:-1], radius), x,
                        x[..., -1:].expand(*x.shape[:-1], radius)], dim=-1)
        acc = torch.zeros_like(x)
        for i, ki in enumerate(k):
            acc = acc + float(ki) * xp[..., i:i + W]
        return acc

    x = conv_last(img)
    return conv_last(x.transpose(-1, -2)).transpose(-1, -2)


def _octave_candidates(dog, per_octave: int, mask):
    """Extrema of one octave's DoG stack dog (B, S+2, H, W). Returns
    (score (B,K), yx (B,K,2) octave coords, scale_idx (B,K), valid (B,K))."""
    B, S2, H, W = dog.shape
    mid = dog[:, 1:-1]
    is_max = torch.ones_like(mid, dtype=torch.bool)
    is_min = torch.ones_like(mid, dtype=torch.bool)
    for ds in (-1, 0, 1):
        layer = dog[:, 1 + ds:S2 - 1 + ds]
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                nb = torch.roll(layer, (dy, dx), dims=(2, 3))
                is_max &= mid > nb
                is_min &= mid < nb
    resp = torch.abs(mid)
    ok = (is_max | is_min) & (resp > 0.5 * CONTRAST_THRESHOLD / N_SPLIT)
    r = torch.roll
    dxx = r(mid, -1, 3) + r(mid, 1, 3) - 2 * mid
    dyy = r(mid, -1, 2) + r(mid, 1, 2) - 2 * mid
    dxy = 0.25 * (r(mid, (-1, -1), (2, 3)) + r(mid, (1, 1), (2, 3))
                  - r(mid, (-1, 1), (2, 3)) - r(mid, (1, -1), (2, 3)))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    ok &= (det > 0) & (tr * tr * EDGE_RATIO < (EDGE_RATIO + 1.0) ** 2 * det)
    yy = torch.arange(H, device=dog.device)[:, None]
    xx = torch.arange(W, device=dog.device)[None, :]
    b = 8
    ok &= ((yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b))[None, None]
    if mask is not None:
        ok &= mask[:, None]
    score = torch.where(ok, resp, torch.full_like(resp, -math.inf)).reshape(B, -1)
    k = min(per_octave, score.shape[1])
    top_v, top_i = torch.sort(score, dim=1, descending=True, stable=True)
    top_v, top_i = top_v[:, :k], top_i[:, :k]
    s_idx = top_i // (H * W)
    y = (top_i % (H * W)) // W
    x = top_i % W
    flat = mid.reshape(B, -1)

    def g(dy, dx):
        return torch.gather(flat, 1, s_idx * (H * W) + torch.clamp(y + dy, 0, H - 1) * W
                            + torch.clamp(x + dx, 0, W - 1))
    c = g(0, 0)
    offs = []
    for (ay, ax), (by, bx) in (((0, 1), (0, -1)), ((1, 0), (-1, 0))):
        p, m = g(ay, ax), g(by, bx)
        curv = p + m - 2 * c
        offs.append(torch.clamp(torch.where(torch.abs(curv) > 1e-12,
                                            -0.5 * (p - m) / (curv + 1e-12),
                                            torch.zeros_like(c)), -0.5, 0.5))
    off_x, off_y = offs
    yx = torch.stack([y + off_y, x + off_x], dim=-1)
    return top_v, yx, s_idx, torch.isfinite(top_v)


def _quantized_gradients(gimg):
    """Central differences of (B,H,W) with clamped borders, quantized as the
    JAX module's u16 packing stores them."""
    right = torch.cat([gimg[..., 1:], gimg[..., -1:]], dim=-1)
    left = torch.cat([gimg[..., :1], gimg[..., :-1]], dim=-1)
    down = torch.cat([gimg[..., 1:, :], gimg[..., -1:, :]], dim=-2)
    up = torch.cat([gimg[..., :1, :], gimg[..., :-1, :]], dim=-2)

    def q(d):
        qi = torch.clamp(torch.round((d + 2.0) * GRAD_SCALE), 0, 65535)
        return exact.div_const(qi, GRAD_SCALE) - 2.0
    return q(right - left), q(down - up)


def _sample(img, y, x):
    """Bilinear sample of img (B,H,W) at y, x (B, ...), clamped inside."""
    B, H, W = img.shape
    y = torch.clamp(y, 0.0, H - 1.001)
    x = torch.clamp(x, 0.0, W - 1.001)
    y0, x0 = torch.floor(y), torch.floor(x)
    fy, fx = y - y0, x - x0
    base = (y0.long() * W + x0.long()).reshape(B, -1)
    flat = img.reshape(B, -1)

    def tap(o):
        return torch.gather(flat, 1, base + o).reshape(y.shape)
    return (tap(0) * (1 - fy) * (1 - fx) + tap(1) * (1 - fy) * fx
            + tap(W) * fy * (1 - fx) + tap(W + 1) * fy * fx)


def _orientation_and_descriptor(gimg, yx, sigma, root_sift: bool):
    """Dominant orientation + 4x4x8 descriptor of keypoints yx (B,K,2) with
    scale sigma (B,K) on the Gaussian layer gimg (B,H,W). Returns (B,K,128)."""
    B, K = sigma.shape
    G = 16
    dev = gimg.device
    grid = torch.arange(G, dtype=torch.float32, device=dev) - (G - 1) / 2.0
    gy, gx = torch.meshgrid(grid, grid, indexing="ij")
    gdx, gdy = _quantized_gradients(gimg)
    step = (DESC_SCALE * sigma * DESC_WIDTH / G)[..., None, None]
    sy = yx[..., 0, None, None] + gy * step
    sx = yx[..., 1, None, None] + gx * step
    dx = _sample(gdx, sy, sx)
    dy = _sample(gdy, sy, sx)
    mag = torch.sqrt(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx)
    magw = mag * torch.exp(-(gy ** 2 + gx ** 2) / (2.0 * (0.5 * G) ** 2))

    bins = torch.clamp(torch.floor((ang + math.pi) / (2 * math.pi) * N_ORI_BINS),
                       0, N_ORI_BINS - 1).long()
    hist = exact.scatter_sum(N_ORI_BINS, [(bins.reshape(B, K, -1), magw.reshape(B, K, -1))])
    hist = exact.div_const(torch.roll(hist, 1, 2) + hist + torch.roll(hist, -1, 2), 3.0)
    peak = torch.argmax(hist, dim=2, keepdim=True)
    hl = torch.gather(hist, 2, (peak - 1) % N_ORI_BINS)[..., 0]
    hc = torch.gather(hist, 2, peak)[..., 0]
    hr = torch.gather(hist, 2, (peak + 1) % N_ORI_BINS)[..., 0]
    den = hl - 2 * hc + hr
    off = torch.clamp(torch.where(torch.abs(den) > 1e-12, 0.5 * (hl - hr) / (den + 1e-12),
                                  torch.zeros_like(den)), -0.5, 0.5)
    theta = ((peak[..., 0].to(torch.float32) + 0.5 + off) / N_ORI_BINS * 2 * math.pi
             - math.pi)[..., None, None]

    ct, st = torch.cos(theta), torch.sin(theta)
    ry = -st * gx + ct * gy
    rx = ct * gx + st * gy
    rang = exact.mod(ang - theta + math.pi, 2 * math.pi) - math.pi
    cyf = (ry / G + 0.5) * DESC_WIDTH - 0.5
    cxf = (rx / G + 0.5) * DESC_WIDTH - 0.5
    obf = (rang + math.pi) / (2 * math.pi) * DESC_BINS - 0.5
    cy0, cx0, ob0 = torch.floor(cyf), torch.floor(cxf), torch.floor(obf)
    fy, fx, fo = cyf - cy0, cxf - cx0, obf - ob0

    def corners():
        for dy_ in (0, 1):
            wy = 1 - fy if dy_ == 0 else fy
            iy = (cy0 + dy_).long()
            in_y = (iy >= 0) & (iy < DESC_WIDTH)
            for dx_ in (0, 1):
                wx = 1 - fx if dx_ == 0 else fx
                ix = (cx0 + dx_).long()
                in_x = (ix >= 0) & (ix < DESC_WIDTH)
                for do_ in (0, 1):
                    wo = 1 - fo if do_ == 0 else fo
                    io = torch.remainder(ob0.long() + do_, DESC_BINS)
                    w8 = magw * wy * wx * wo * (in_y & in_x)
                    idx = ((torch.clamp(iy, 0, DESC_WIDTH - 1) * DESC_WIDTH
                            + torch.clamp(ix, 0, DESC_WIDTH - 1)) * DESC_BINS + io)
                    yield idx.reshape(B, K, -1), w8.reshape(B, K, -1)
    d = exact.scatter_sum(DESC_WIDTH * DESC_WIDTH * DESC_BINS, corners())
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-12)
    d = torch.clamp_max(d, 0.2)
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-12)
    if root_sift:
        d = torch.sqrt(d / (torch.sum(d, dim=-1, keepdim=True) + 1e-12))
    return d


def detect_and_describe(gray, num_features: int = 2048, n_octaves: int = 4,
                        root_sift: bool = True, mask=None):
    """SIFT features of a batch of images gray (B,H,W) float in [0,1] (or
    one (H,W) image). mask: optional (H,W) bool detection mask. Returns (uv
    (B,F,2) pixel coords (x, y), desc (B,F,128), valid (B,F), response
    (B,F)), F = num_features, without the batch axis for one image."""
    single = gray.dim() == 2
    if single:
        gray = gray[None]
    B, H, W = gray.shape
    dev = gray.device
    up = F.interpolate(gray[:, None], size=(2 * H, 2 * W), mode="bilinear",
                       align_corners=False)[:, 0]
    base = _blur(up, SIGMA0)
    mask_o = None if mask is None else \
        mask.to(dev).repeat_interleave(2, 0).repeat_interleave(2, 1)[None]
    sigmas = [SIGMA0 * (2.0 ** (s / N_SPLIT)) for s in range(N_SPLIT + 3)]
    scores, uvs, valids, descs = [], [], [], []
    img_o = base
    for o in range(n_octaves):
        Ho, Wo = img_o.shape[-2:]
        if Ho < 32 or Wo < 32:
            break
        gauss = [img_o]
        for s in range(1, N_SPLIT + 3):
            inc = math.sqrt(max(sigmas[s] ** 2 - sigmas[s - 1] ** 2, 1e-6))
            gauss.append(_blur(gauss[-1], inc))
        gstack = torch.stack(gauss, dim=1)                    # (B, S+3, Ho, Wo)
        sc, yx, s_idx, val = _octave_candidates(gstack[:, 1:] - gstack[:, :-1],
                                                num_features, mask_o)
        ksig = torch.tensor(sigmas, dtype=torch.float32, device=dev)[s_idx + 1]
        descs.append(_orientation_and_descriptor(gstack[:, 1], yx, ksig, root_sift))
        scale = float(1 << o) * 0.5
        uvs.append(torch.stack([yx[..., 1], yx[..., 0]], dim=-1) * scale - 0.25)
        scores.append(torch.where(val, sc, torch.full_like(sc, -math.inf)))
        valids.append(val)
        img_o = img_o[:, ::2, ::2]
        mask_o = None if mask_o is None else mask_o[:, ::2, ::2]
    if not scores:
        out = (torch.zeros((B, num_features, 2), device=dev),
               torch.zeros((B, num_features, 128), device=dev),
               torch.zeros((B, num_features), dtype=torch.bool, device=dev),
               torch.zeros((B, num_features), device=dev))
    else:
        score = torch.cat(scores, dim=1)
        k = min(num_features, score.shape[1])
        top_v, top_i = torch.sort(score, dim=1, descending=True, stable=True)
        top_v, top_i = top_v[:, :k], top_i[:, :k]
        uv = torch.gather(torch.cat(uvs, 1), 1, top_i[..., None].expand(B, k, 2))
        desc = torch.gather(torch.cat(descs, 1), 1, top_i[..., None].expand(B, k, 128))
        valid = torch.gather(torch.cat(valids, 1), 1, top_i) & torch.isfinite(top_v)
        resp = torch.where(valid, top_v, torch.zeros_like(top_v))
        pad = num_features - k
        out = (F.pad(uv, (0, 0, 0, pad)), F.pad(desc, (0, 0, 0, pad)),
               F.pad(valid, (0, pad)), F.pad(resp, (0, pad)))
    return tuple(o[0] for o in out) if single else out


def frame_chunk(device: torch.device) -> int:
    """Frames per detection batch: 8 on the card (about 1.3 GB of
    descriptor temporaries per frame at 8096 features), 2 on the CPU."""
    return 8 if torch.device(device).type == "cuda" else 2


def extract_sift_device_batch(grays, num_features: int = 2048, root_sift: bool = True,
                              mask=None, device="cpu", chunk: int | None = None):
    """grays (N,H,W) float [0,1] numpy -> numpy (uv (N,F,2), desc (N,F,128),
    fmask (N,F)), `chunk` frames per batch on `device`."""
    device = torch.device(device)
    chunk = chunk or frame_chunk(device)
    m = None if mask is None else torch.as_tensor(np.asarray(mask), device=device)
    outs = []
    for c0 in range(0, len(grays), chunk):
        g = torch.as_tensor(np.asarray(grays[c0:c0 + chunk], np.float32), device=device)
        uv, desc, val, _ = detect_and_describe(g, num_features=num_features,
                                               root_sift=root_sift, mask=m)
        outs.append((uv.cpu().numpy(), desc.cpu().numpy(), val.cpu().numpy()))
    return (np.concatenate([o[0] for o in outs]).astype(np.float32),
            np.concatenate([o[1] for o in outs]).astype(np.float32),
            np.concatenate([o[2] for o in outs]))
