"""Spherical PatchMatch — the port of panovlm_tpu/ops/patchmatch.py: the
plane-sweep path (sweep_slices > 0) and exact per-plane sampling
(sweep_slices = 0, the JAX package's default).

Replaces the per-pixel loops of mvs/MVS.cpp (reference): ScorePixel
(:774-923, warp + weighted NCC + best-2 neighbour mean), InterpolatePixel
(:1923-1935, plane-induced depth), PerturbDepthNormal3 (:1254-1317),
PropagateCheckerBoard (:1098-1127) and PropagateSequential (:1057-1096, as
the JAX package's log-shift sweeps).

Hypotheses are per-pixel planes (depth d along the pixel ray + unit normal
n); a texel's depth on the plane is lambda_t = d (n.r_p) / (n.r_t). On the
sweep path all warp samples of a pass are taken once, into a (V, D, H, W)
bfloat16 volume per neighbour view (`build_sweep_volume`); candidates are
then scored by the CUDA kernel of ops/volscore.py, the geometric term and
the best-2 view mean stay plain torch (as they are XLA outside the kernel
in JAX). On the exact path (`pack_views`) every texel of every candidate
plane is warped into each neighbour and sampled there, batched over the
candidates in plain torch, as JAX computes it in XLA outside any kernel.

Sampling follows the JAX package's default packed path: neighbour grays are
u8-quantised with a per-view scale, neighbour depths u16-quantised (x256),
read with the packed samplers' pole clamp (ops/spherical.py).

Random draws (ROADMAP F5): `_pm_step` and `init_depth_normal` take their
draws as an optional argument (`draw_step` / `draw_init` make them from a
torch.Generator), so a test can inject the JAX package's jax.random draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import spherical
from .volscore import clamp_den, ncc_cost_from_moments, volscore

# sweep slices sampled together in build_sweep_volume: bounds its
# (chunk, H, W, 3) float32 temporaries
_SLICE_CHUNK = 8


class PatchMatchConfig(NamedTuple):
    ncc_half_window: int = 5         # reference default 11 (full res)
    ncc_step: int = 2
    min_depth: float = 0.1
    max_depth: float = 20.0
    sigma_color: float = 0.2         # bilateral NCC weight
    n_perturb: int = 2
    perturb_frac: float = 0.15
    prop_offsets: tuple = ((0, 1), (0, -1), (1, 0), (-1, 0),
                           (0, 3), (0, -3), (3, 0), (-3, 0))
    geom_weight: float = 0.2         # geometric-consistency pass weight
    geom_max_angle_deg: float = 2.0
    smooth_bonus: float = 0.95       # NCC smoothness bonus (MVS.h:82-86); 1 disables
    prune_candidates: int = 2        # pre-rank on sparse texels, full-score the best k
    prune_texels: int = 5            # 5 = centre + corners, 9 = + edge midpoints
    prune_views: int = 2             # views used for pre-ranking (0 = all)
    sweep_slices: int = 0            # inverse-depth slices of the sweep volume;
                                     # 0 = exact per-plane sampling
    prune_slice_stride: int = 4      # pre-ranking reads every k-th slice


def check_config(cfg: PatchMatchConfig):
    """Both paths draw random depths log-uniform in [min_depth, max_depth],
    and the sweep slices are uniform in 1/depth: min_depth must be > 0."""
    if not cfg.min_depth > 0:
        raise ValueError(
            f"min_depth = {cfg.min_depth}: the random depths are log-uniform "
            "and the sweep slices uniform in 1/depth, both need min_depth > 0 "
            "(ROADMAP F7)")


def _patch_offsets(cfg: PatchMatchConfig):
    hw, st = cfg.ncc_half_window, cfg.ncc_step
    return [(dv, du) for dv in range(-hw, hw + 1, st)
            for du in range(-hw, hw + 1, st)]


def _cheap_offsets(cfg: PatchMatchConfig):
    """Sparse texel subset for candidate pre-ranking: centre + the window's
    corners (prune_texels=5) or + edge midpoints (9)."""
    hw = cfg.ncc_half_window
    five = [(0, 0), (-hw, -hw), (-hw, hw), (hw, -hw), (hw, hw)]
    if cfg.prune_texels <= 5:
        return five
    return five + [(-hw, 0), (0, -hw), (0, hw), (hw, 0)]


def _roll2(img, dv, du):
    """img[(y + dv) % H, (x + du) % W] (jnp.roll of -dv, -du)."""
    return torch.roll(img, (-dv, -du), dims=(0, 1))


def _inv_grid(cfg: PatchMatchConfig, stride: int = 1):
    """(inv0, inv_step) of a volume that holds every stride-th slice."""
    inv0 = 1.0 / cfg.max_depth
    return inv0, (1.0 / cfg.min_depth - inv0) / max(cfg.sweep_slices - 1, 1) * stride


def sweep_inv_depths(cfg: PatchMatchConfig, device="cpu"):
    """The D inverse-depth slice positions (uniform in 1/d, far to near)."""
    return torch.linspace(1.0 / cfg.max_depth, 1.0 / cfg.min_depth,
                          cfg.sweep_slices, device=device)


def build_sweep_volume(q_nei, scales, rays, R_nr, t_nr, cfg: PatchMatchConfig,
                       nei_depths_q=None):
    """Plane-sweep sample volume: vol[v, s, y, x] = neighbour v's gray where
    the ray of reference pixel (y, x) at slice depth lambda_s lands.

    q_nei (V,H,W): spherical.quantize_u8 grays with their scales (V,);
    nei_depths_q None or (V,H,W) spherical.quantize_u16 depths (x256).
    Returns (V,D,H,W) bfloat16, or (vols, dvols) with the neighbour depth
    sampled at the same positions when nei_depths_q is given."""
    V, H, W = q_nei.shape
    D = cfg.sweep_slices
    lam = 1.0 / sweep_inv_depths(cfg, rays.device)
    vols = torch.empty((V, D, H, W), dtype=torch.bfloat16, device=rays.device)
    dvols = None if nei_depths_q is None else torch.empty_like(vols)
    for v in range(V):
        rr = torch.einsum("ij,hwj->hwi", R_nr[v], rays)
        for s0 in range(0, D, _SLICE_CHUNK):
            x_n = lam[s0:s0 + _SLICE_CHUNK, None, None, None] * rr + t_nr[v]
            uv = spherical.cam_to_image(x_n, H, W)
            vols[v, s0:s0 + _SLICE_CHUNK] = spherical.sample_u8(q_nei[v], scales[v], uv)
            if dvols is not None:
                dvols[v, s0:s0 + _SLICE_CHUNK] = spherical.sample_u16(
                    nei_depths_q[v], 256.0, uv)
    return vols if dvols is None else (vols, dvols)


class PackedViews(NamedTuple):
    """The neighbour views of exact per-plane sampling (sweep_slices = 0),
    read as the JAX package's packed path reads them: u8-quantised grays q
    (V,H,W) with their scales (V,), the geometric pass's u16-quantised
    depths (V,H,W) or None, and each view's rotated rays R_nr r (V,H,W,3)."""
    q: torch.Tensor
    scales: torch.Tensor
    depth_q: torch.Tensor | None
    rays_rot: torch.Tensor

    def head(self, k: int) -> "PackedViews":
        """The first k views (the nearest, in the neighbour table's order)."""
        return PackedViews(self.q[:k], self.scales[:k],
                           None if self.depth_q is None else self.depth_q[:k],
                           self.rays_rot[:k])


def pack_views(q_nei, scales, rays, R_nr, nei_depths_q=None) -> PackedViews:
    """PackedViews from spherical.quantize_u8 grays q_nei (V,H,W) and their
    scales, and spherical.quantize_u16 depths (V,H,W) or None."""
    return PackedViews(q_nei, torch.stack([torch.as_tensor(sc, device=rays.device)
                                           for sc in scales]),
                       nei_depths_q, torch.einsum("vij,hwj->vhwi", R_nr, rays))


def _vol_interp(vol, sigma):
    """Hat-weighted interpolation over the slice axis of vol (D,H,W) at
    per-pixel slice coordinates sigma (...,H,W) in [0, D-1]: the two
    bracketing slices (the oracle sums all D hat weights, at most two of
    which are nonzero). Returns float32 (...,H,W)."""
    D = vol.shape[0]
    i0 = torch.floor(sigma)
    f = sigma - i0
    i0 = i0.to(torch.int64)
    lead = sigma.shape[:-2]
    v = vol.reshape(D, -1)
    flat = torch.arange(v.shape[1], device=vol.device).expand(*lead, -1)
    lo = v[i0.reshape(*lead, -1), flat].reshape(sigma.shape).float()
    hi = v[torch.clamp(i0 + 1, max=D - 1).reshape(*lead, -1), flat].reshape(sigma.shape).float()
    return (1.0 - f) * lo + f * hi


def random_normals(n_raw, rays):
    """Normalise raw Gaussian draws (...,H,W,3) into unit normals facing
    the camera (n . ray < 0)."""
    n = n_raw / (torch.linalg.vector_norm(n_raw, dim=-1, keepdim=True) + 1e-12)
    flip = torch.sum(n * rays, dim=-1, keepdim=True) > 0
    return torch.where(flip, -n, n)


def geometric_cost(rays, depth, R_nr, t_nr, cfg: PatchMatchConfig, dvol=None,
                   vol_stride: int = 1, depth_q=None):
    """Geometric-consistency penalty (MVS.cpp:126-153, 858-896) for depth
    maps (...,H,W): project the hypothesis into the neighbour, read the
    neighbour's depth from its depth sweep volume dvol (D,H,W), or, exact,
    from its u16-quantised depth map depth_q (H,W) where the point lands,
    back-project and take the angular error in the reference view."""
    X = depth[..., None] * rays
    x_n = torch.einsum("ij,...j->...i", R_nr, X) + t_nr
    if dvol is not None:
        inv0, inv_step = _inv_grid(cfg, vol_stride)
        sigma = (1.0 / torch.clamp_min(depth, 1e-6) - inv0) / inv_step
        d_n = _vol_interp(dvol, torch.clamp(sigma, 0.0, dvol.shape[0] - 1))
    else:
        d_n = spherical.sample_u16(depth_q, 256.0,
                                   spherical.cam_to_image(x_n, *depth_q.shape))
    r_n = x_n / (torch.linalg.vector_norm(x_n, dim=-1, keepdim=True) + 1e-12)
    X_back = torch.einsum("ji,...j->...i", R_nr, d_n[..., None] * r_n - t_nr)
    r_back = X_back / (torch.linalg.vector_norm(X_back, dim=-1, keepdim=True) + 1e-12)
    cosv = torch.clamp(torch.sum(r_back * rays, dim=-1), -1.0, 1.0)
    pen = torch.clamp(torch.rad2deg(torch.arccos(cosv)) / cfg.geom_max_angle_deg, max=1.0)
    return torch.where(d_n > cfg.min_depth, pen, torch.ones_like(pen))


def ncc_exact(gray_ref, rays, cd, cn, rays_rot, t_nr, q, scale, offsets,
              cfg: PatchMatchConfig):
    """Weighted-NCC cost (C,H,W) of a candidate stack cd (C,H,W), cn
    (C,H,W,3) against one neighbour view by exact per-plane sampling (the
    JAX ncc_cost without a volume): each texel's ray is cut with the
    candidate plane, the point moved into the neighbour (rays_rot = R_nr r,
    (H,W,3), plus t_nr) and its u8-quantised gray q (H,W) sampled there."""
    H, W = gray_ref.shape
    rho = cd * torch.sum(cn * rays, dim=-1)
    sw, sx, sy, sxx, syy, sxy = (torch.zeros_like(cd) for _ in range(6))
    for dv, du in offsets:
        lam = rho / clamp_den(torch.sum(cn * _roll2(rays, dv, du), dim=-1))
        x_n = lam[..., None] * _roll2(rays_rot, dv, du) + t_nr
        s = spherical.sample_u8(q, scale, spherical.cam_to_image(x_n, H, W))
        i_t = _roll2(gray_ref, dv, du)
        w = torch.exp(-((i_t - gray_ref) ** 2) / (2 * cfg.sigma_color ** 2)) * (lam > 0)
        sw = sw + w
        sx = sx + w * i_t
        sy = sy + w * s
        sxx = sxx + w * i_t * i_t
        syy = syy + w * s * s
        sxy = sxy + w * i_t * s
    return ncc_cost_from_moments(sw, sx, sy, sxx, syy, sxy, cd, cfg.min_depth,
                                 cfg.max_depth)


def multiview_cost(gray_ref, rays, cd, cn, R_nr, t_nr, cfg: PatchMatchConfig,
                   offsets, vols, dvols=None, vol_stride: int = 1):
    """Cost (C,H,W) of a candidate stack cd (C,H,W), cn (C,H,W,3) over the
    neighbour views, reduced to the mean of each pixel's best two views
    (MVS.cpp:905-918; JAX multiview_cost / _score_stack_kernel). vols is
    either the sweep volumes (V,D,H,W) (the volscore NCC plus, with dvols,
    the weighted geometric term) or the views' PackedViews (exact sampling,
    ncc_exact plus, with its depths, the weighted geometric term)."""
    if isinstance(vols, PackedViews):
        costs = []
        for v in range(vols.q.shape[0]):
            c = ncc_exact(gray_ref, rays, cd, cn, vols.rays_rot[v], t_nr[v], vols.q[v],
                          vols.scales[v], offsets, cfg)
            if vols.depth_q is not None:
                c = c + cfg.geom_weight * geometric_cost(
                    rays, cd, R_nr[v], t_nr[v], cfg, depth_q=vols.depth_q[v])
            costs.append(c)
        return _best_two_mean(torch.stack(costs))
    inv0, inv_step = _inv_grid(cfg, vol_stride)
    nrm = cn.permute(0, 3, 1, 2).contiguous()
    costs = volscore(vols, cd.contiguous(), nrm,
                     rays.permute(2, 0, 1).contiguous(), gray_ref, offsets,
                     inv0, inv_step, cfg.min_depth, cfg.max_depth,
                     cfg.sigma_color)                                # (V,C,H,W)
    if dvols is not None:
        geom = torch.stack([geometric_cost(rays, cd, R_nr[v], t_nr[v], cfg,
                                           dvols[v], vol_stride)
                            for v in range(dvols.shape[0])])
        costs = costs + cfg.geom_weight * geom
    return _best_two_mean(costs)


def _best_two_mean(costs):
    """Mean of the two smallest of costs (V,C,H,W) over the views."""
    if costs.shape[0] == 1:
        return costs[0]
    # the two smallest over the short view axis by two min-reductions:
    # torch.topk along a leading axis of 2-4 views took 16 ms a call at the
    # Room shape, half the device time of the stage (PERF.md)
    m1, i1 = torch.min(costs, dim=0)
    m2 = torch.min(costs.scatter(0, i1[None], math.inf), dim=0).values
    return (m1 + m2) / 2


def plane_induced(rays, depth, normal, dv, du):
    """Propagate a neighbour pixel's plane: its (d, n) induces a depth at
    the current pixel (InterpolatePixel, MVS.cpp:1923-1935)."""
    d_q = _roll2(depth, dv, du)
    n_q = _roll2(normal, dv, du)
    r_q = _roll2(rays, dv, du)
    rho = d_q * torch.sum(n_q * r_q, dim=-1)
    denom = torch.sum(n_q * rays, dim=-1)
    d_p = rho / torch.where(torch.abs(denom) < 1e-6, torch.full_like(denom, 1e-6), denom)
    return d_p, n_q


def smoothness_factor(rays, depth, normal, cand_d, cand_n, cfg: PatchMatchConfig):
    """Multiplicative cost bonus (<= 1) where a candidate plane (...,H,W)
    agrees with the current 4-neighbour depths/normals (ScorePixel
    close_neighbors, MVS.cpp:844-856; constants MVS.h:82-86)."""
    if cfg.smooth_bonus >= 1.0:
        return torch.ones_like(cand_d)
    bonus_d = 1.0 - cfg.smooth_bonus
    bonus_n = (1.0 - cfg.smooth_bonus) * 0.96
    sigma_d = -1.0 / (2.0 * 0.02 ** 2)
    sigma_n = -1.0 / (2.0 * 0.22 ** 2)
    rho = cand_d * torch.sum(cand_n * rays, dim=-1)          # n . X0
    factor = torch.ones_like(cand_d)
    safe_d = torch.clamp_min(cand_d, 1e-6)
    for dv, du in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        d_q = _roll2(depth, dv, du)
        n_q = _roll2(normal, dv, du)
        X_q = d_q[..., None] * _roll2(rays, dv, du)
        dd = torch.abs(torch.sum(cand_n * X_q, dim=-1) - rho) / safe_d
        f_d = torch.exp(dd * dd * sigma_d)
        da = torch.arccos(torch.clamp(torch.sum(cand_n * n_q, dim=-1), -1.0, 1.0))
        f_n = torch.exp(da * da * sigma_n)
        f = (1.0 - bonus_d * f_d) * (1.0 - bonus_n * f_n)
        factor = factor * torch.where(d_q > 0, f, torch.ones_like(f))
    return factor


def _log_uniform(u, cfg: PatchMatchConfig):
    lo, hi = math.log(cfg.min_depth), math.log(cfg.max_depth)
    return torch.exp(lo + (hi - lo) * u)


def draw_init(gen, rays, cfg: PatchMatchConfig):
    """init_depth_normal's draws: {"d_rand": log-uniform depth (H,W),
    "n_rand": raw Gaussian normals (H,W,3)}."""
    H, W = rays.shape[:2]
    u = torch.rand((H, W), generator=gen, device=rays.device)
    return {"d_rand": _log_uniform(u, cfg),
            "n_rand": torch.randn((H, W, 3), generator=gen, device=rays.device)}


def draw_step(gen, rays, cfg: PatchMatchConfig):
    """_pm_step's draws: per perturbation a uniform (H,W) ("pert_u") and raw
    Gaussian normals (H,W,3) ("pert_n"); the log-uniform restart depth
    ("d_rand") and raw restart normals ("n_rand")."""
    H, W = rays.shape[:2]
    dev = rays.device
    out = {"pert_u": [], "pert_n": []}
    for _ in range(cfg.n_perturb):
        out["pert_u"].append(torch.rand((H, W), generator=gen, device=dev))
        out["pert_n"].append(torch.randn((H, W, 3), generator=gen, device=dev))
    out["d_rand"] = _log_uniform(torch.rand((H, W), generator=gen, device=dev), cfg)
    out["n_rand"] = torch.randn((H, W, 3), generator=gen, device=dev)
    return out


def _pm_step(gray_ref, rays, depth, normal, cost, R_nr, t_nr, fixed_depth,
             cfg: PatchMatchConfig, prop_offsets, active, vols, dvols=None,
             draws=None, gen=None):
    """Shared PatchMatch update (ProcessPixel, MVS.cpp:719-772): active
    pixels test propagated + perturbed + random candidates, pre-ranked on
    sparse texels, and keep the argmin-cost plane. vols, dvols: the sweep
    volumes, or the neighbours' PackedViews and None (exact sampling).
    Returns (depth, normal, cost)."""
    if draws is None:
        draws = draw_step(gen, rays, cfg)
    cands_d, cands_n = [depth], [normal]
    for dv, du in prop_offsets:
        d_p, n_p = plane_induced(rays, depth, normal, dv, du)
        cands_d.append(d_p)
        cands_n.append(n_p)
    # conf-tiered perturbations (PerturbDepthNormal3, MVS.cpp:1254-1317)
    tier = torch.where(cost <= 0.11, 0.25, torch.where(cost <= 0.22, 0.5, 1.0))
    for i in range(cfg.n_perturb):
        sc = tier * (0.5 ** i)
        scale = 1.0 + cfg.perturb_frac * sc * (draws["pert_u"][i] * 2 - 1)
        cands_d.append(torch.clamp(depth * scale, cfg.min_depth, cfg.max_depth))
        n_pert = normal + draws["pert_n"][i] * 0.5 * sc[..., None]
        n_pert = n_pert / (torch.linalg.vector_norm(n_pert, dim=-1, keepdim=True) + 1e-12)
        flip = torch.sum(n_pert * rays, dim=-1, keepdim=True) > 0
        cands_n.append(torch.where(flip, -n_pert, n_pert))
    # random restart where the current estimate is bad (thConfRand tier)
    bad = cost >= 0.495
    cands_d.append(torch.where(bad, draws["d_rand"], depth))
    cands_n.append(torch.where(bad[..., None], random_normals(draws["n_rand"], rays),
                               normal))
    cd = torch.stack(cands_d)
    cn = torch.stack(cands_n)

    if cfg.prune_candidates and cd.shape[0] > cfg.prune_candidates:
        # pre-rank every candidate on the sparse texel set against the
        # nearest views and every k-th slice, full-score only the best k
        V = R_nr.shape[0]
        vk = min(cfg.prune_views, V) if cfg.prune_views else V
        ps = max(cfg.prune_slice_stride, 1)
        if isinstance(vols, PackedViews):
            views_c, dvols_c = vols.head(vk), None
        else:
            views_c = vols[:vk, ::ps]
            dvols_c = None if dvols is None else dvols[:vk, ::ps]
        cheap = multiview_cost(gray_ref, rays, cd, cn, R_nr[:vk], t_nr[:vk], cfg,
                               _cheap_offsets(cfg), views_c, dvols_c, ps)
        cheap = cheap * smoothness_factor(rays, depth, normal, cd, cn, cfg)
        sel_d, sel_n = [], []
        for _ in range(cfg.prune_candidates):
            idx = torch.argmin(cheap, dim=0)                          # (H,W)
            sel_d.append(torch.gather(cd, 0, idx[None])[0])
            sel_n.append(torch.gather(cn, 0, idx[None, ..., None].expand(1, *cn.shape[1:]))[0])
            cheap = cheap.scatter(0, idx[None], math.inf)
        cd = torch.stack(sel_d)
        cn = torch.stack(sel_n)

    costs = multiview_cost(gray_ref, rays, cd, cn, R_nr, t_nr, cfg,
                           _patch_offsets(cfg), vols, dvols)
    costs = costs * smoothness_factor(rays, depth, normal, cd, cn, cfg)
    c_min, best_idx = torch.min(costs, dim=0)
    d_best = torch.gather(cd, 0, best_idx[None])[0]
    n_best = torch.gather(cn, 0, best_idx[None, ..., None].expand(1, *cn.shape[1:]))[0]
    better = (c_min < cost) & active
    best_d = torch.where(better, d_best, depth)
    best_n = torch.where(better[..., None], n_best, normal)
    best_c = torch.where(better, c_min, cost)
    # keep_lidar_constant: depth pinned, plane/normal/cost still update
    return torch.where(fixed_depth, depth, best_d), best_n, best_c


def _sequential_offsets(direction: int, max_shift: int = 32):
    """Log-shift sweep sources: offset (dv, du) sources the plane from
    (v+dv, u+du), so TL->BR (direction 0, left/up sources) is negative."""
    sign = -1 if direction == 0 else 1
    offsets = []
    k = 1
    while k <= max_shift:
        offsets.append((0, sign * k))   # along-row
        offsets.append((sign * k, 0))   # along-column
        k *= 2
    return tuple(offsets)


def checkerboard_step(gray_ref, rays, depth, normal, cost, R_nr, t_nr,
                      fixed_depth, cfg: PatchMatchConfig, parity: int, vols,
                      dvols=None, draws=None, gen=None):
    """One red/black half-iteration (PropagateCheckerBoard, MVS.cpp:723-767)."""
    H, W = depth.shape
    yy, xx = torch.meshgrid(torch.arange(H, device=depth.device),
                            torch.arange(W, device=depth.device), indexing="ij")
    active = ((yy + xx) % 2) == parity
    return _pm_step(gray_ref, rays, depth, normal, cost, R_nr, t_nr,
                    fixed_depth, cfg, cfg.prop_offsets, active, vols, dvols,
                    draws, gen)


def sequential_step(gray_ref, rays, depth, normal, cost, R_nr, t_nr,
                    fixed_depth, cfg: PatchMatchConfig, direction: int, vols,
                    dvols=None, draws=None, gen=None, max_shift: int = 32):
    """Directional sweep (PropagateSequential, MVS.cpp:682-720) as log-shift
    relaxation: candidates from offsets 1, 2, 4, ..., max_shift along the
    sweep direction. direction 0 = TL->BR, 1 = BR->TL."""
    active = torch.ones(depth.shape, dtype=torch.bool, device=depth.device)
    return _pm_step(gray_ref, rays, depth, normal, cost, R_nr, t_nr,
                    fixed_depth, cfg, _sequential_offsets(direction, max_shift),
                    active, vols, dvols, draws, gen)


def run_patchmatch(gray_ref, rays, depth0, normal0, fixed, R_nr, t_nr, vols,
                   dvols, cfg: PatchMatchConfig, n_iterations: int,
                   propagate: int = 1, gen=None):
    """Per-image PatchMatch as the JAX run_patchmatch does it: initial
    scoring, then 2 * n_iterations half-steps (propagate 2: sequential
    sweeps with alternating direction; else checkerboard parity i % 2),
    on the sweep volumes vols, dvols or, exact, on PackedViews vols (dvols
    None). Returns (depth, normal, conf)."""
    cost = multiview_cost(gray_ref, rays, depth0[None], normal0[None], R_nr,
                          t_nr, cfg, _patch_offsets(cfg), vols, dvols)[0]
    cost = cost * smoothness_factor(rays, depth0, normal0, depth0, normal0, cfg)
    depth, normal = depth0, normal0
    for i in range(2 * n_iterations):
        if propagate == 2:
            depth, normal, cost = sequential_step(
                gray_ref, rays, depth, normal, cost, R_nr, t_nr, fixed, cfg,
                i % 2, vols, dvols, gen=gen)
        else:
            depth, normal, cost = checkerboard_step(
                gray_ref, rays, depth, normal, cost, R_nr, t_nr, fixed, cfg,
                i % 2, vols, dvols, gen=gen)
    return depth, normal, torch.clamp(1.0 - cost, -1.0, 1.0)
