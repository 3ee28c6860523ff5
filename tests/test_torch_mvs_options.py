"""MVS's two options in the port: SfM-point neighbour selection
(`mvs_neighbor_selection = 1`, models/mvs.select_neighbor_sfm) and exact
per-plane sampling (`mvs_sweep_slices = 0`, ops/patchmatch.PackedViews),
against the JAX package on the same numpy inputs, then both through the
port's `joint_mvs` stage.

  * select_neighbor_sfm: the same table, every entry (host float64 in both
    packages, on the same float32 Rodrigues rotations).
  * The exact ncc_cost, geometric_cost and multiview_cost against the JAX
    package's packed-view path (sweep_slices = 0): the bounds of
    tests/test_torch_patchmatch.py, 99.9 % of the pixels within 2e-4
    photometric, 99 % within 1e-3 with the geometric term, every pixel
    within 0.05 (NCC on nearly flat patches and arccos next to 1 amplify
    last-bit differences of the warp).
  * One exact step with the JAX draws injected (ROADMAP F5): fewer than 2 %
    of the pixels pick another plane, the rest meet the bounds above.
    One view's NCC alone: 99.8 % within 2e-4 (97 % of its pixels differ in
    the last bits, as the warped positions do; on a few nearly flat or
    badly matched patches that reaches 0.044). The geometric penalty alone
    is compared through its cosine (four float steps next to 1: one step
    is up to 0.0099 of the penalty).
  * The stage, on the dataset of tests/test_torch_mvs_stage.py (4 frames at
    128 x 256, the Room MVS keys) with both options at once, cut to one
    iteration and ncc_step 2 (the exact path samples every texel of every
    candidate: ~30 s on two CPU threads for the port, ~36 s for the JAX
    stage), run through both packages' joint_mvs on the same inputs and
    held as that module holds the two stages: the port's table is the JAX
    function's on the same points.npz and poses, both medians of the
    relative depth error < 0.08 and within 0.03 of each other, and the
    port's coverage at least COVERAGE_SHARE of the JAX stage's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panovlm_tpu import pipeline as jpipeline
from panovlm_tpu.config import load_config as jload_config
from panovlm_tpu.models import mvs as jmvs
from panovlm_tpu.ops import patchmatch as jpm
from panovlm_tpu.ops import spherical as jsp
from panovlm_tpu_torch import pipeline as tpipeline
from panovlm_tpu_torch.config import load_config
from panovlm_tpu_torch.io import artifacts
from panovlm_tpu_torch.models import mvs as tmvs
from panovlm_tpu_torch.ops import patchmatch as tpm
from panovlm_tpu_torch.ops import se3
from panovlm_tpu_torch.ops import spherical as tsp
from panovlm_tpu_torch.ops import volscore as tvs
from panovlm_tpu_torch.utils import depth_completion
from panovlm_tpu_torch.utils import poses as pose_util

from synthetic import make_dataset, render_panorama
from test_torch_mvs_stage import COVERAGE_SHARE, ROOM_MVS_KEYS, _joint_poses, _median_rel_error

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ----------------------------------------------------------------------------
# SFM_POINTS neighbour selection
# ----------------------------------------------------------------------------

def test_select_neighbor_sfm_on_the_loop_case():
    """tests/test_mvs.py's loop case: the co-visible view, not the nearest
    centre; a view that shares nothing gets -1."""
    poses = np.zeros((3, 6), np.float32)
    poses[1, 3:] = [-0.3, 0.0, 0.0]
    poses[2, 3:] = [-2.0, 0.0, 0.0]
    rng = np.random.default_rng(0)
    pts = np.array([1.0, 0.0, 5.0]) + rng.normal(size=(30, 3)) * 0.3
    track_img = np.tile(np.array([0, 2], np.int32), (30, 1))
    track_mask = np.ones((30, 2), bool)
    out = tmvs.select_neighbor_sfm(poses, pts, track_img, track_mask, 1)
    np.testing.assert_array_equal(out, [[2], [-1], [0]])
    np.testing.assert_array_equal(
        out, jmvs.select_neighbor_sfm(poses, pts, track_img, track_mask, 1))
    assert tmvs.select_neighbor_views(poses, 1)[0, 0] == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_select_neighbor_sfm_matches_jax_on_seeded_tracks(seed):
    """12 views on a circle, 600 tracks of 2-5 views among neighbouring
    ones; views 10 and 11 see no track, so their rows are all -1 and the
    stage's merge falls back to the KNN picks there."""
    rng = np.random.default_rng(seed)
    n, L = 12, 5
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    C = np.stack([3 * np.cos(ang), 0.2 * rng.normal(size=n), 3 * np.sin(ang)], 1)
    rvec = rng.normal(size=(n, 3)) * 0.3
    Rm = se3.exp_so3(torch.as_tensor(rvec, dtype=torch.float32)).double().numpy()
    poses = np.concatenate([rvec, -np.einsum("nij,nj->ni", Rm, C)], 1).astype(np.float32)
    T = 600
    pts = rng.normal(size=(T, 3)) * 1.5
    first = rng.integers(0, n - 2, T)
    track_img = (first[:, None] + np.arange(L)[None]) % (n - 2)
    track_mask = np.arange(L)[None] < rng.integers(2, L + 1, T)[:, None]
    out = tmvs.select_neighbor_sfm(poses, pts, track_img, track_mask, 4)
    ref = jmvs.select_neighbor_sfm(poses, pts, track_img, track_mask, 4)
    np.testing.assert_array_equal(out, ref)
    assert (out[10:] == -1).all() and (out[:10] >= 0).all()
    knn = tmvs.select_neighbor_views(poses, 4)
    merged = np.where(out >= 0, out, knn)
    np.testing.assert_array_equal(merged[10:], knn[10:])
    assert (merged[:10] != knn[:10]).any()


# ----------------------------------------------------------------------------
# exact per-plane sampling: a small scene of 4 panoramas of the synthetic room
# ----------------------------------------------------------------------------

H, W = 48, 96
CENTERS = ((0.0, 0.4, 0.0), (0.7, 0.4, 0.2), (-0.5, 0.2, -0.4), (0.2, 0.6, -0.7))
NEI = np.array([1, 2, 3])


@pytest.fixture(scope="module")
def scene():
    grays, depths = zip(*[render_panorama(np.array(c), H, W) for c in CENTERS])
    poses = np.zeros((4, 6), np.float32)
    poses[:, 3:] = -np.asarray(CENTERS, np.float32)     # R = I -> t_cw = -C
    cfg = jpm.PatchMatchConfig(ncc_half_window=3, ncc_step=1, min_depth=0.4,
                               max_depth=8.0, sweep_slices=0)
    grays, depths = np.stack(grays), np.stack(depths)
    rays = jsp.pixel_ray_grid(H, W)
    R, t = jmvs.relative_to_neighbors(poses, 0, NEI)
    nd = jax.vmap(lambda d: jsp.pack_bilinear_u16(d)[0])(jnp.asarray(depths[NEI] * 1.02))
    jax_side = dict(views=jpm.pack_views(jnp.asarray(grays[NEI])), nd=nd, R=R, t=t,
                    rays=rays, cfg=cfg)
    tcfg = tpm.PatchMatchConfig(**{k: v for k, v in cfg._asdict().items()
                                   if k in tpm.PatchMatchConfig._fields})
    Rt, tt = tmvs.relative_to_neighbors(poses, 0, NEI)
    trays = tsp.pixel_ray_grid(H, W)
    qs = [tsp.quantize_u8(_t(g)) for g in grays[NEI]]
    q = torch.stack([a for a, _ in qs])
    scales = [s for _, s in qs]
    nd_q = tsp.quantize_u16(_t(depths[NEI] * 1.02))
    port_side = dict(views=tpm.pack_views(q, scales, trays, Rt), cfg=tcfg, R=Rt, t=tt,
                     rays=trays,
                     views_geo=tpm.pack_views(q, scales, trays, Rt, nd_q))
    rng = np.random.default_rng(5)
    depth = (depths[0] * rng.uniform(0.8, 1.25, (H, W))).astype(np.float32)
    normal = np.asarray(jpm.random_normals(jax.random.PRNGKey(1), rays))
    return dict(grays=grays, depth=depth, normal=normal, jax=jax_side, port=port_side)


def _assert_costs_close(out, ref, geometric, share=0.999):
    d = np.abs(out - ref)
    assert d.max() <= 0.05, d.max()
    if geometric:
        assert np.mean(d <= 1e-3) >= 0.99, np.mean(d <= 1e-3)
    else:
        assert np.mean(d <= 2e-4) >= share, np.mean(d <= 2e-4)


def test_exact_ncc_and_geometric_cost_match_jax(scene):
    j, p = scene["jax"], scene["port"]
    gray = scene["grays"][0]
    offsets = jpm._patch_offsets(j["cfg"])
    d, n = scene["depth"], scene["normal"]
    for v in range(len(NEI)):
        ref = jpm.ncc_cost(jnp.asarray(gray), j["views"].packed[v], j["rays"], jnp.asarray(d),
                           jnp.asarray(n), j["R"][v], j["t"][v], j["cfg"], offsets,
                           j["views"].scales[v])
        out = tpm.ncc_exact(_t(gray), p["rays"], _t(d)[None], _t(n)[None],
                            p["views"].rays_rot[v], p["t"][v], p["views"].q[v],
                            p["views"].scales[v], offsets, p["cfg"])[0]
        _assert_costs_close(out.numpy(), np.asarray(ref), False, share=0.998)
        assert np.mean(np.asarray(ref) < 2.0) > 0.9
        gref = jpm.geometric_cost(j["rays"], jnp.asarray(d), j["nd"][v], j["R"][v],
                                  j["t"][v], j["cfg"])
        gout = tpm.geometric_cost(p["rays"], _t(d), p["R"][v], p["t"][v], p["cfg"],
                                  depth_q=p["views_geo"].depth_q[v])
        _assert_penalties_close(gout.numpy(), np.asarray(gref), p["cfg"].geom_max_angle_deg)
        assert 0.05 < np.mean(np.asarray(gref) < 1.0)


def _assert_penalties_close(out, ref, max_angle_deg):
    """The geometric penalty is arccos(c) / max_angle of a cosine c next to
    1, where one float step of c is up to 0.0099 of the penalty: compare
    the cosines, within four float32 steps below 1 (4 x 2^-24; the
    penalty's own float32 rounding adds under a tenth of a step); a
    penalty clipped at 1 on one side only lies at the clip on the other."""
    cos_o = np.cos(np.radians(out.astype(np.float64) * max_angle_deg))
    cos_r = np.cos(np.radians(ref.astype(np.float64) * max_angle_deg))
    both = (out < 1) & (ref < 1)
    assert np.abs(cos_o - cos_r)[both].max() <= 4.1 * 2.0 ** -24, \
        np.abs(cos_o - cos_r)[both].max()
    one = (out < 1) != (ref < 1)
    assert np.minimum(out, ref)[one].min(initial=1.0) > 0.99


@pytest.mark.parametrize("geometric", [False, True])
def test_exact_multiview_cost_matches_jax(scene, geometric):
    j, p = scene["jax"], scene["port"]
    gray = scene["grays"][0]
    d, n = scene["depth"], scene["normal"]
    ref = jpm.multiview_cost(jnp.asarray(gray), j["views"], j["rays"], jnp.asarray(d),
                             jnp.asarray(n), j["R"], j["t"], j["cfg"],
                             j["nd"] if geometric else None)
    n0 = tvs.volscore.launches
    out = tpm.multiview_cost(_t(gray), p["rays"], _t(d)[None], _t(n)[None], p["R"], p["t"],
                             p["cfg"], tpm._patch_offsets(p["cfg"]),
                             p["views_geo"] if geometric else p["views"])[0]
    assert tvs.volscore.launches == n0
    _assert_costs_close(out.numpy(), np.asarray(ref), geometric)


def _jax_draws(key, cfg):
    keys = jax.random.split(key, cfg.n_perturb + 2)
    lo, hi = np.log(cfg.min_depth), np.log(cfg.max_depth)
    return {
        "pert_u": [_t(jax.random.uniform(keys[i], (H, W))) for i in range(cfg.n_perturb)],
        "pert_n": [_t(jax.random.normal(jax.random.fold_in(keys[i], 7), (H, W, 3)))
                   for i in range(cfg.n_perturb)],
        "d_rand": _t(jnp.exp(jax.random.uniform(keys[-1], (H, W), minval=lo, maxval=hi))),
        "n_rand": _t(jax.random.normal(keys[-2], (H, W, 3))),
    }


@pytest.mark.parametrize("mode", ["sequential", "checkerboard_geometric"])
def test_one_exact_step_with_injected_draws_matches_jax(scene, mode):
    geo = mode == "checkerboard_geometric"
    j, p = scene["jax"], scene["port"]
    gray = jnp.asarray(scene["grays"][0])
    depth, normal = scene["depth"], jnp.asarray(scene["normal"])
    nd = j["nd"] if geo else None
    views_t = p["views_geo"] if geo else p["views"]
    cost = jpm.multiview_cost(gray, j["views"], j["rays"], jnp.asarray(depth), normal,
                              j["R"], j["t"], j["cfg"], nd)
    fixed = np.zeros((H, W), bool)
    fixed[::7, ::5] = True
    key = jax.random.PRNGKey(11)
    args = (gray, j["views"], j["rays"], jnp.asarray(depth), normal, cost, j["R"], j["t"],
            key, jnp.asarray(fixed), j["cfg"])
    targs = (_t(gray), p["rays"], _t(depth), _t(normal), _t(cost), p["R"], p["t"],
             torch.from_numpy(fixed), p["cfg"])
    draws = _jax_draws(key, j["cfg"])
    n0 = tvs.volscore.launches
    if geo:
        jd, jn, jc = jpm.checkerboard_step(*args, 1, nd)
        td, tn, tc = tpm.checkerboard_step(*targs, 1, views_t, draws=draws)
    else:
        jd, jn, jc = jpm.sequential_step(*args, 0)
        td, tn, tc = tpm.sequential_step(*targs, 0, views_t, draws=draws)
    assert tvs.volscore.launches == n0
    jd, jn = np.asarray(jd), np.asarray(jn)
    differ = (np.abs(td.numpy() - jd) > 1e-4 * jd) | (np.abs(tn.numpy() - jn).max(-1) > 1e-4)
    assert np.mean(differ) < 0.02, np.mean(differ)
    assert np.mean(jd != depth) > 0.1                      # the step moved planes
    np.testing.assert_array_equal(td.numpy()[fixed], depth[fixed])
    _assert_costs_close(tc.numpy()[~differ], np.asarray(jc)[~differ], geo)


def test_min_depth_zero_raises_f7_on_the_exact_path():
    with pytest.raises(ValueError, match="F7"):
        tpm.check_config(tpm.PatchMatchConfig(min_depth=0.0, sweep_slices=0))
    with pytest.raises(ValueError, match="F7"):
        tpm.check_config(tpm.PatchMatchConfig(min_depth=0.0, sweep_slices=64))
    assert tpm.PatchMatchConfig().sweep_slices == jpm.PatchMatchConfig().sweep_slices == 0
    tpm.check_config(tpm.PatchMatchConfig())


# ----------------------------------------------------------------------------
# both options through the stage
# ----------------------------------------------------------------------------

def _sfm_points(gt, H_, W_, per_frame=150, seed=0):
    """SfM-style tracks from the ground truth: pixels of each frame lifted
    with its rendered depth, each seen by the frames whose render of that
    direction lies within 3 % of the point's distance."""
    rng = np.random.default_rng(seed)
    n = len(gt["C"])
    rays = tsp.pixel_ray_grid(H_, W_).numpy()
    depths = [render_panorama(gt["C"][i], H_, W_, R_wc=gt["R_wc"][i])[1] for i in range(n)]
    pts = []
    for i in range(n):
        ok = np.argwhere(np.isfinite(depths[i]) & (depths[i] > 0))
        for y, x in ok[rng.choice(len(ok), per_frame, replace=False)]:
            pts.append(gt["C"][i] + gt["R_wc"][i] @ (depths[i][y, x] * rays[y, x]))
    pts = np.asarray(pts)
    seen = np.zeros((len(pts), n), bool)
    for j in range(n):
        x_c = (pts - gt["C"][j]) @ gt["R_wc"][j]
        uv = tsp.cam_to_image(torch.from_numpy(x_c.astype(np.float32)), H_, W_).numpy()
        u = np.clip(uv[:, 0].astype(int), 0, W_ - 1)
        v = np.clip(uv[:, 1].astype(int), 0, H_ - 1)
        dist = np.linalg.norm(x_c, axis=1)
        seen[:, j] = np.abs(depths[j][v, u] - dist) < 0.03 * dist
    track_img = np.tile(np.arange(n, dtype=np.int32), (len(pts), 1))
    return pts, track_img, seen


def _dataset(tmp_path_factory, name, n_frames):
    """A make_dataset Room set at 128 x 256 with the Room MVS keys, its
    ground-truth joint poses and SfM-style tracks in result/sfm/points.npz.
    Returns (root, ground truth)."""
    root = str(tmp_path_factory.mktemp(name) / "data")
    cfg_path, gt = make_dataset(root, n_frames=n_frames, H=128, W=256, h_steps=900,
                                config_overrides=ROOM_MVS_KEYS)
    cfg = load_config(cfg_path)
    os.makedirs(cfg.joint_result_path)
    _joint_poses(cfg, gt)
    pts, track_img, track_mask = _sfm_points(gt, 128, 256)
    os.makedirs(cfg.sfm_result_path)
    np.savez(os.path.join(cfg.sfm_result_path, "points.npz"), points=pts,
             track_img=track_img, track_mask=track_mask)
    return root, gt


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    return _dataset(tmp_path_factory, "mvs_options", 4)


# both options at once, cut to one iteration and ncc_step 2 (module docstring)
BOTH = dict(mvs_neighbor_selection=1, mvs_sweep_slices=0, mvs_num_iterations=1, ncc_step=2)


def _config(load, stage, name, **keys):
    """The `stage` fixture's config, loaded by either package's load_config,
    with MVS outputs of its own under `name` and `keys` set."""
    root, _ = stage
    cfg = load(os.path.join(root, "config.txt"))
    cfg.mvs_data_path = os.path.join(root, name, "mvs_data")
    cfg.mvs_result_path = os.path.join(root, name, "mvs")
    for k in ("depth", "conf", "normal"):
        setattr(cfg, f"mvs_{k}_path", os.path.join(cfg.mvs_data_path, k))
    for k, v in keys.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def both(stage):
    """The port's and the JAX package's joint_mvs with both options on the
    `stage` dataset; the port's run keeps the arguments of its
    select_neighbor_sfm call, the table it filtered with and its volscore
    launches."""
    tables, used = [], []
    select, filt = tmvs.select_neighbor_sfm, tmvs.filter_depth_maps

    def keep(*a, **k):
        tables.append((a, select(*a, **k)))
        return tables[-1][1]

    n0 = tvs.volscore.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmvs, "select_neighbor_sfm", keep)
        mp.setattr(tmvs, "filter_depth_maps",
                   lambda *a, **k: used.append(np.array(a[3])) or filt(*a, **k))
        depths_t, _ = tpipeline.joint_mvs(_config(load_config, stage, "port", **BOTH),
                                          device="cpu")
    launches = tvs.volscore.launches - n0
    depths_j, _ = jpipeline.joint_mvs(_config(jload_config, stage, "jax", **BOTH))
    return dict(port=depths_t, jax=np.asarray(depths_j), tables=tables, used=used,
                launches=launches)


def test_stage_with_both_options(stage, both):
    """SfM-point neighbours and exact sampling in one run: the table the
    stage filters with is the SfM table, the JAX function's on the same
    inputs, with KNN picks where it has -1; no volscore launch; the port's
    depth maps held to the JAX stage's as tests/test_torch_mvs_stage.py
    holds them."""
    root, gt = stage
    assert both["launches"] == 0
    assert len(both["tables"]) == 1
    args, table = both["tables"][0]
    assert (table >= 0).any()
    np.testing.assert_array_equal(table, jmvs.select_neighbor_sfm(*args))
    cfg = load_config(os.path.join(root, "config.txt"))
    R_c, t_c, _, c_ok = artifacts.read_pose_t(os.path.join(cfg.joint_result_path,
                                                           "camera_pose_joint.txt"))
    knn = tmvs.select_neighbor_views(pose_util.world_to_params(R_c, t_c), 4, c_ok)
    np.testing.assert_array_equal(both["used"][0], np.where(table >= 0, table, knn))
    med_j, cov_j = _median_rel_error(both["jax"], gt)
    med_t, cov_t = _median_rel_error(both["port"], gt)
    assert med_j < 0.08, med_j
    assert med_t < 0.08, med_t
    assert abs(med_t - med_j) < 0.03, (med_t, med_j)
    assert cov_t >= COVERAGE_SHARE * cov_j, (cov_t, cov_j)


def test_missing_points_npz_falls_back_to_knn(stage, caplog, monkeypatch):
    """Without result/sfm/points.npz the stage warns and keeps the KNN
    table; it is stopped at its LiDAR depth init, which follows."""
    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop

    monkeypatch.setattr(depth_completion, "compute_depth_images", stop)
    cfg = _config(load_config, stage, "fallback", mvs_neighbor_selection=1,
                  sfm_result_path=os.path.join(stage[0], "no_sfm"))
    with caplog.at_level("WARNING", logger="panovlm"), pytest.raises(Stop):
        tpipeline.joint_mvs(cfg, device="cpu")
    assert "no_sfm/points.npz missing; using KNN" in caplog.text


# ----------------------------------------------------------------------------
# SfM-point neighbours on a chain: the witness for chip_smoke.py's phase 14
# (a) floors (SFM_NEIGHBOUR_MIN_COVERAGE)
# ----------------------------------------------------------------------------

def _coverage(cfg, n, depths, gt):
    """{kind: (median relative depth error, coverage)} of a run's returned
    (post-processed) and filtered depth maps."""
    filt = np.stack([np.load(os.path.join(cfg.mvs_depth_path, f"{i:06d}_filter.npy")) / 256.0
                     for i in range(n)])
    return {"post-processed": _median_rel_error(np.asarray(depths), gt),
            "filtered": _median_rel_error(filt, gt)}


def test_sfm_neighbours_widen_the_baselines(tmp_path_factory):
    """A 10-frame chain of the same generator (0.22 m steps), the configs'
    sweep at one iteration and ncc_step 2. The SfM score saturates at 10 deg
    of parallax, so its neighbours lie farther than the camera-centre KNN's
    and the JAX stage's coverage falls with them: what chip_smoke.py's
    phase 14 (a) meets on its 48-frame chain. The port's run with SfM-point
    neighbours is held to the JAX stage's with them as
    tests/test_torch_mvs_stage.py holds the two stages, on the returned and
    on the filtered depth maps; its table is the JAX function's. Run with -s
    to print the numbers."""
    n = 10
    stage_ = _dataset(tmp_path_factory, "mvs_chain", n)
    root, gt = stage_
    keys = dict(mvs_num_iterations=1, ncc_step=2)
    tables = []
    select = tmvs.select_neighbor_sfm
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmvs, "select_neighbor_sfm",
                   lambda *a, **k: tables.append((a, select(*a, **k))) or tables[-1][1])
        cfg = _config(load_config, stage_, "port", mvs_neighbor_selection=1, **keys)
        port = _coverage(cfg, n, tpipeline.joint_mvs(cfg, device="cpu")[0], gt)
    runs = {}
    for name, sel in (("knn", 2), ("sfm", 1)):
        cfg = _config(jload_config, stage_, f"jax_{name}", mvs_neighbor_selection=sel, **keys)
        runs[name] = _coverage(cfg, n, jpipeline.joint_mvs(cfg)[0], gt)
    (args, table), = tables
    np.testing.assert_array_equal(table, jmvs.select_neighbor_sfm(*args))
    poses = np.asarray(args[0], np.float64)
    R = se3.exp_so3(torch.as_tensor(args[0][:, :3], dtype=torch.float32)).double().numpy()
    C = -np.einsum("nji,nj->ni", R, poses[:, 3:])
    knn = tmvs.select_neighbor_views(args[0], 4)
    merged = np.where(table >= 0, table, knn)
    base = {k: float(np.linalg.norm(C[:, None] - C[t], axis=-1).mean())
            for k, t in (("knn", knn), ("sfm", merged))}
    print(f"\nmean neighbour baseline (m): {base}; JAX stage {runs}; port, SfM points {port}")
    assert (merged != knn).any(1).sum() >= n // 2
    assert base["sfm"] > 1.5 * base["knn"], base
    for kind in ("post-processed", "filtered"):
        (med_j, cov_j), (med_t, cov_t) = runs["sfm"][kind], port[kind]
        assert runs["sfm"][kind][1] < runs["knn"][kind][1], (kind, runs)
        assert med_j < 0.08 and med_t < 0.08, (kind, med_j, med_t)
        assert abs(med_t - med_j) < 0.03, (kind, med_t, med_j)
        assert cov_t >= COVERAGE_SHARE * cov_j, (kind, cov_t, cov_j)
