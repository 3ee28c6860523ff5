"""Panoramic image lines: LSD detection, great-circle fusion and line band
descriptors — the port's copy of `panovlm_tpu/utils/panorama_line.py`
(util/PanoramaLine.{h,cpp} of the reference).

A 2D segment on an equirectangular image is an arc of a great circle,
described by the unit normal of the plane through its endpoint rays and the
camera centre. Fragments of one physical edge are fused by that normal,
arc adjacency or overlap and an endpoint NCC test, then filtered by arc
length. Detection is the port's own LSD (`native/lsd.cpp`), which gives
cv2's segments; the fusion is host numpy, as in the JAX package. The
descriptors (`ops/lbd.py`) run in torch on the device asked for, on the
uint8 image scaled to [0, 1].
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .tracks import UnionFind

log = logging.getLogger("panovlm")

_KEYS = ("normal", "e1", "e2", "mid", "arc")


def detect_lsd(gray: np.ndarray, lat_band_deg: float = 70.0,
               mask: np.ndarray | None = None, min_pixel_len: float = 20.0):
    """LSD segments on a uint8 panorama, kept where both endpoints lie in
    |lat| < lat_band_deg, at least min_pixel_len long, and (with a mask)
    starting on a usable pixel (PanoramaLine.cpp:34-101). Returns (L, 4)
    [u1 v1 u2 v2] float32."""
    from ..native import lsd
    segs = lsd.detect(gray)
    H, W = gray.shape[:2]
    v_lo = H * (0.5 - lat_band_deg / 180.0)
    v_hi = H * (0.5 + lat_band_deg / 180.0)
    keep = ((segs[:, 1] > v_lo) & (segs[:, 1] < v_hi)
            & (segs[:, 3] > v_lo) & (segs[:, 3] < v_hi))
    length = np.hypot(segs[:, 2] - segs[:, 0], segs[:, 3] - segs[:, 1])
    keep &= length >= min_pixel_len
    if mask is not None:
        my = np.clip(segs[:, 1].astype(int), 0, H - 1)
        mx = np.clip(segs[:, 0].astype(int), 0, W - 1)
        keep &= mask[my, mx] > 0
    return segs[keep]


def _image_to_cam_np(uv, rows, cols):
    """Pixel (u, v) -> unit camera ray (the numpy form of
    ops.spherical.image_to_cam)."""
    u, v = uv[..., 0], uv[..., 1]
    lon = (2.0 * u / cols - 1.0) * np.pi
    lat = (0.5 - v / rows) * np.pi
    cy = np.cos(lat)
    return np.stack([cy * np.sin(lon), -np.sin(lat), cy * np.cos(lon)], axis=-1)


def segments_to_arcs(segs: np.ndarray, rows: int, cols: int):
    """2D segments -> great-circle arcs: normal (L,3) unit plane normals,
    e1/e2 (L,3) endpoint rays, mid (L,3) midpoint rays, arc (L,) arc angle
    in radians."""
    if len(segs) == 0:
        z = np.zeros((0, 3), np.float32)
        return {"normal": z, "e1": z, "e2": z, "mid": z,
                "arc": np.zeros((0,), np.float32)}
    e1 = _image_to_cam_np(segs[:, :2], rows, cols)
    e2 = _image_to_cam_np(segs[:, 2:], rows, cols)
    n = np.cross(e1, e2)
    nn = np.linalg.norm(n, axis=1, keepdims=True)
    ok = nn[:, 0] > 1e-9
    n = np.where(ok[:, None], n / np.maximum(nn, 1e-12), 0.0)
    mid = e1 + e2
    mid /= np.linalg.norm(mid, axis=1, keepdims=True) + 1e-12
    arc = np.arccos(np.clip((e1 * e2).sum(1), -1.0, 1.0))
    return {"normal": n.astype(np.float32), "e1": e1.astype(np.float32),
            "e2": e2.astype(np.float32), "mid": mid.astype(np.float32),
            "arc": arc.astype(np.float32)}


def _cam_to_image_np(xyz, rows, cols):
    """Inverse of _image_to_cam_np: unit rays -> pixel (u, v)."""
    lat = np.arcsin(np.clip(-xyz[..., 1], -1.0, 1.0))
    lon = np.arctan2(xyz[..., 0], xyz[..., 2])
    u = (lon / np.pi + 1.0) * cols / 2.0
    v = (0.5 - lat / np.pi) * rows
    return np.stack([u, v], axis=-1)


def endpoint_ncc(gray: np.ndarray, uv1: np.ndarray, uv2: np.ndarray,
                 half_window: int = 21):
    """Zero-mean NCC of the (2w+1)^2 patches around each point pair
    (ComputeNCC, util/PanoramaLine.h:96-97): rows clamped, longitude
    wrapped. uv1/uv2 (Q, 2) -> (Q,)."""
    H, W = gray.shape[:2]
    g = gray.astype(np.float32)
    w = half_window
    dy, dx = np.mgrid[-w:w + 1, -w:w + 1]

    def patches(uv):
        yy = np.clip(np.round(uv[:, 1]).astype(np.int64)[:, None, None] + dy, 0, H - 1)
        xx = np.mod(np.round(uv[:, 0]).astype(np.int64)[:, None, None] + dx, W)
        return g[yy, xx].reshape(len(uv), -1)

    p1 = patches(np.atleast_2d(uv1))
    p2 = patches(np.atleast_2d(uv2))
    p1 = p1 - p1.mean(1, keepdims=True)
    p2 = p2 - p2.mean(1, keepdims=True)
    den = np.sqrt((p1 * p1).sum(1) * (p2 * p2).sum(1))
    return (p1 * p2).sum(1) / np.maximum(den, 1e-9)


def fuse_arcs(arcs: dict, angle_thresh_deg: float = 2.0,
              gap_deg: float = 4.0, gray: np.ndarray | None = None,
              ncc_gap_deg: float = 12.0, ncc_threshold: float = -0.2,
              ncc_floor: float = -0.4, ncc_half_window: int = 21):
    """Merge fragments on one great circle (the reference's Fuse* family).
    Fragments connect when their normals agree within angle_thresh_deg
    and their arcs overlap; disjoint fragments connect when, without
    `gray`, their nearest endpoints lie within gap_deg, or, with `gray`,
    within max(gap_deg, ncc_gap_deg) and the endpoint patch NCCs pass
    FuseFarLines' test (max >= ncc_threshold, min >= ncc_floor;
    util/PanoramaLine.cpp:661-703). Each connected group is refitted: the
    normal is the smallest eigenvector of its arc-weighted endpoint
    scatter, the endpoints its extreme angular positions. Returns a dict
    with the keys of segments_to_arcs."""
    n = arcs["normal"]
    L = len(n)
    if L == 0:
        return arcs
    cos_t = np.cos(np.radians(angle_thresh_deg))
    same_plane = np.abs(n @ n.T) >= cos_t
    E = np.stack([arcs["e1"], arcs["e2"]], axis=1)  # (L,2,3)
    dots = np.einsum("iak,jbk->iajb", E, E).reshape(L, 2, L, 2)
    min_gap = np.arccos(np.clip(dots, -1, 1)).min(axis=(1, 3))
    mid_dot = np.einsum("ik,jk->ij", arcs["mid"], arcs["mid"])
    mid_ang = np.arccos(np.clip(mid_dot, -1, 1))
    half_sum = 0.5 * (arcs["arc"][:, None] + arcs["arc"][None, :])
    overlap = mid_ang <= half_sum
    if gray is None:
        connect = same_plane & ((min_gap <= np.radians(gap_deg)) | overlap)
    else:
        near = min_gap <= np.radians(max(gap_deg, ncc_gap_deg))
        cand = same_plane & near & ~overlap
        ii, jj = np.nonzero(np.triu(cand, 1))
        ncc_ok = np.zeros((L, L), bool)
        if len(ii):
            H, W = gray.shape[:2]
            uv = _cam_to_image_np(E, rows=H, cols=W)            # (L, 2, 2)
            a = np.repeat(uv[ii], 2, axis=1).reshape(-1, 2)     # i e1,e1,e2,e2
            b = np.tile(uv[jj], (1, 2, 1)).reshape(-1, 2)       # j e1,e2,e1,e2
            s = endpoint_ncc(gray, a, b, ncc_half_window).reshape(-1, 4)
            good = (s.max(1) >= ncc_threshold) & (s.min(1) >= ncc_floor)
            ncc_ok[ii[good], jj[good]] = True
            ncc_ok |= ncc_ok.T
        connect = (same_plane & overlap) | ncc_ok
    uf = UnionFind(L)
    ii, jj = np.nonzero(connect)
    for a, b in zip(ii, jj):
        if a < b:
            uf.union(int(a), int(b))
    roots = np.array([uf.find(i) for i in range(L)])
    out = {k: [] for k in _KEYS}
    for r in np.unique(roots):
        grp = np.nonzero(roots == r)[0]
        if len(grp) == 1:
            for k in _KEYS:
                out[k].append(arcs[k][grp[0]])
            continue
        pts = E[grp].reshape(-1, 3)
        w = np.repeat(arcs["arc"][grp], 2)[:, None]
        _, evecs = np.linalg.eigh((pts * w).T @ pts)
        nrm = evecs[:, 0]
        nrm /= np.linalg.norm(nrm) + 1e-12
        ref = pts[0] - (pts[0] @ nrm) * nrm
        ref /= np.linalg.norm(ref) + 1e-12
        t2 = np.cross(nrm, ref)
        proj = pts - (pts @ nrm)[:, None] * nrm
        proj /= np.linalg.norm(proj, axis=1, keepdims=True) + 1e-12
        ang = np.arctan2(proj @ t2, proj @ ref)
        a_lo, a_hi = ang.min(), ang.max()
        e1 = np.cos(a_lo) * ref + np.sin(a_lo) * t2
        e2 = np.cos(a_hi) * ref + np.sin(a_hi) * t2
        mid = e1 + e2
        mid /= np.linalg.norm(mid) + 1e-12
        out["normal"].append(nrm.astype(np.float32))
        out["e1"].append(e1.astype(np.float32))
        out["e2"].append(e2.astype(np.float32))
        out["mid"].append(mid.astype(np.float32))
        out["arc"].append(np.float32(a_hi - a_lo))
    return {k: np.stack(v) if v else np.zeros((0, 3) if k != "arc" else (0,), np.float32)
            for k, v in out.items()}


def filter_arcs(arcs: dict, min_arc_deg: float = 3.0):
    """Arc-length filter (PanoramaLine.cpp:103-160)."""
    keep = arcs["arc"] >= np.radians(min_arc_deg)
    return {k: v[keep] for k, v in arcs.items()}


def pad_arcs(arcs: dict, cap: int):
    """Pad to `cap` arcs. Returns the padded dict plus "mask"."""
    L = min(len(arcs["arc"]), cap)
    out = {}
    for k in ("normal", "e1", "e2", "mid"):
        buf = np.zeros((cap, 3), np.float32)
        buf[:L] = arcs[k][:L]
        out[k] = buf
    arc = np.zeros((cap,), np.float32)
    arc[:L] = arcs["arc"][:L]
    out["arc"] = arc
    mask = np.zeros((cap,), bool)
    mask[:L] = True
    out["mask"] = mask
    return out


def _to_u8(gray: np.ndarray) -> np.ndarray:
    """A [0, 1] float panorama as the JAX stage hands it to LSD (truncated)."""
    if gray.dtype == np.uint8:
        return gray
    return (np.clip(gray, 0.0, 1.0) * 255).astype(np.uint8)


def _descriptors(grays, arcs, device):
    """LBD of the padded arcs (N, cap, ...) on `device`: (N, cap, 72)
    float32 numpy."""
    import torch
    from ..ops import lbd

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return lbd.line_band_descriptors_batch(dev(grays), dev(arcs["e1"]), dev(arcs["e2"]),
                                           dev(arcs["mask"])).cpu().numpy()


def extract_panorama_lines(gray: np.ndarray, cap: int = 128,
                           mask: np.ndarray | None = None,
                           with_descriptors: bool = False, device="cuda"):
    """Detect + fuse for one uint8 panorama (PanoramaLine::Detect/Fuse):
    the padded arc dict, longest arc first. with_descriptors adds "desc",
    the line band descriptor of each arc (ops/lbd.py), computed on `device`
    from the image as float (uint8 scaled to [0, 1])."""
    H, W = gray.shape[:2]
    arcs = segments_to_arcs(detect_lsd(gray, mask=mask), H, W)
    arcs = filter_arcs(fuse_arcs(arcs, gray=gray))
    order = np.argsort(-arcs["arc"])
    out = pad_arcs({k: v[order] for k, v in arcs.items()}, cap)
    if with_descriptors:
        gf = gray.astype(np.float32)
        if gray.dtype == np.uint8:
            gf /= 255.0
        out["desc"] = _descriptors(gf[None], {k: v[None] for k, v in out.items()}, device)[0]
    return out


def extract_panorama_lines_batch(grays, cap: int = 128,
                                 mask: np.ndarray | None = None,
                                 with_descriptors: bool = False,
                                 num_threads: int = -1, device="cuda"):
    """Detect + fuse for a stack of same-size panoramas (uint8, or float in
    [0, 1]), frame-parallel on `num_threads` threads (all cores when <= 0;
    the reference's OpenMP image-line loop, CameraLidarOptimizer.cpp:
    89-149): the LSD call releases the GIL, and so do the fusion's large
    numpy operations. Returns stacked arrays: normal/e1/e2/mid (N, cap, 3),
    arc/mask (N, cap), and with_descriptors desc (N, cap, 72), computed on
    `device` in one pass over the frames from the uint8 images scaled to
    [0, 1]."""
    from ..native import lsd
    lsd.get()                                  # build once, before the threads
    gray_u8 = [_to_u8(g) for g in grays]
    workers = num_threads if num_threads > 0 else (os.cpu_count() or 1)
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=max(1, min(workers, len(gray_u8)))) as pool:
        arc_list = list(pool.map(lambda g: extract_panorama_lines(g, cap, mask), gray_u8))
    out = {k: np.stack([a[k] for a in arc_list]) for k in arc_list[0]}
    t1 = time.time()
    if with_descriptors:
        out["desc"] = _descriptors(np.stack(gray_u8).astype(np.float32) / 255.0, out, device)
    log.info("image lines: LSD + fusion of %d frames on %d threads %.2f s, descriptors %.2f s",
             len(gray_u8), workers, t1 - t0, time.time() - t1)
    return out
