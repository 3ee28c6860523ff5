"""The port's LSD (`panovlm_tpu_torch/native/lsd.cpp`) against cv2's
createLineSegmentDetector(), and the port's arc fusion
(`panovlm_tpu_torch/utils/panorama_line.py`) against the JAX package's.

LSD: segments are matched one-to-one in cv2's order. The bar is that at
least 95 % of cv2's segments have a counterpart within 0.5 px (max over the
four coordinates) and at most 5 % of the port's are extra; the port
reproduces cv2's integer front end and seed order, so on these images the
two agree to 1e-3 px, and the test holds that too.

Fusion: detect_lsd's filters around the port's LSD give the JAX
function's segments (1e-3 px); segments_to_arcs, fuse_arcs (with the
endpoint NCC test), filter_arcs and pad_arcs fed the same cv2 segments
agree with the JAX
functions to 1e-6 (normals, rays, arcs; the same float32 numpy code), and
extract_panorama_lines end to end (the port's LSD against cv2's inside the
JAX function, with_descriptors=False) gives the same number of arcs with
normals, mids and spans within 1e-5; with descriptors, the JAX package's
LBD of the same arcs within 1e-4.
"""

import numpy as np
import pytest
import torch

from panovlm_tpu_torch.native import lsd
from panovlm_tpu_torch.utils import panorama_line as tpl

from synthetic import render_panorama

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)


def _pano(H, W, origin=(0.3, -0.2, 0.1)):
    g, _ = render_panorama(origin, H, W)
    return np.clip(g * 255, 0, 255).astype(np.uint8)


def _rectangles():
    img = np.full((240, 320), 40, np.uint8)
    rng = np.random.default_rng(3)
    for _ in range(12):
        x0, y0 = rng.integers(0, 280), rng.integers(0, 200)
        w, h = rng.integers(20, 120, 2)
        img[y0:y0 + h, x0:x0 + w] = rng.integers(60, 250)
    return img


def _cv2_segments(img):
    out = cv2.createLineSegmentDetector().detect(img)[0]
    return np.zeros((0, 4), np.float32) if out is None else out.reshape(-1, 4)


def _match(ref, mine, tol):
    """Greedy one-to-one matching by max coordinate distance (either
    endpoint order). Returns per-ref distance of its match (inf: none) and
    the number of unmatched port segments."""
    used = np.zeros(len(mine), bool)
    dist = np.full(len(ref), np.inf)
    if len(mine):
        flip = mine[:, [2, 3, 0, 1]]
        D = np.minimum(np.abs(ref[:, None] - mine[None]).max(-1),
                       np.abs(ref[:, None] - flip[None]).max(-1))
        for i in np.argsort(D.min(1)):
            j = np.argmin(np.where(used, np.inf, D[i]))
            if not used[j] and D[i, j] <= tol:
                used[j] = True
                dist[i] = D[i, j]
    return dist, int((~used).sum())


@pytest.mark.parametrize("name", ["pano128x256", "pano256x512", "rectangles"])
def test_lsd_matches_cv2(name):
    img = {"pano128x256": lambda: _pano(128, 256), "pano256x512": lambda: _pano(256, 512),
           "rectangles": _rectangles}[name]()
    ref = _cv2_segments(img)
    mine = lsd.detect(img)
    assert len(ref) > 20
    dist, extra = _match(ref, mine, 0.5)
    assert np.isfinite(dist).mean() >= 0.95, np.isfinite(dist).mean()
    assert extra <= 0.05 * len(mine), extra
    # the goal: the same segments, in the same order, to ~1e-3 px
    assert len(ref) == len(mine)
    np.testing.assert_allclose(mine, ref, atol=1e-3, rtol=0)


def test_lsd_is_reentrant_and_handles_flat_images():
    from concurrent.futures import ThreadPoolExecutor
    imgs = [_pano(128, 256, (0.1 * i, 0.0, 0.0)) for i in range(3)]
    with ThreadPoolExecutor(3) as pool:
        outs = list(pool.map(lsd.detect, imgs))
    for a, b in zip(outs, imgs):
        np.testing.assert_array_equal(a, lsd.detect(b))
    assert lsd.detect(np.zeros((64, 64), np.uint8)).shape == (0, 4)


def _jax_pl():
    from panovlm_tpu.utils import panorama_line as jpl
    return jpl


def test_fusion_matches_jax_on_cv2_segments():
    jpl = _jax_pl()
    img = _pano(256, 512)
    H, W = img.shape
    segs_j = jpl.detect_lsd(img)
    # the band, length and mask filters around the port's own LSD
    np.testing.assert_allclose(tpl.detect_lsd(img), segs_j, atol=1e-3, rtol=0)
    a_j, a_t = jpl.segments_to_arcs(segs_j, H, W), tpl.segments_to_arcs(segs_j, H, W)
    for k in a_j:
        np.testing.assert_allclose(a_t[k], a_j[k], atol=1e-6, rtol=0)
    f_j, f_t = jpl.fuse_arcs(a_j, gray=img), tpl.fuse_arcs(a_t, gray=img)
    assert len(f_j["arc"]) == len(f_t["arc"]) < len(a_j["arc"])
    for k in f_j:
        np.testing.assert_allclose(f_t[k], f_j[k], atol=1e-6, rtol=0)
    g_j, g_t = jpl.filter_arcs(f_j), tpl.filter_arcs(f_t)
    p_j, p_t = jpl.pad_arcs(g_j, 128), tpl.pad_arcs(g_t, 128)
    for k in p_j:
        np.testing.assert_allclose(p_t[k], p_j[k], atol=1e-6, rtol=0)
    # without the gray image: the geometric gap criterion
    f_j, f_t = jpl.fuse_arcs(a_j), tpl.fuse_arcs(a_t)
    for k in f_j:
        np.testing.assert_allclose(f_t[k], f_j[k], atol=1e-6, rtol=0)


def test_extract_panorama_lines_matches_jax():
    jpl = _jax_pl()
    imgs = [_pano(256, 512, (0.2 * i - 0.2, 0.1, 0.0)) for i in range(2)]
    H, W = imgs[0].shape
    mask = np.ones((H, W), bool)
    mask[:, : W // 8] = False
    # float [0, 1] panoramas as both stages load them, back to uint8 as the
    # JAX batch does before its LSD
    grays = [g.astype(np.float32) / 255.0 for g in imgs]
    u8 = [(np.clip(g, 0.0, 1.0) * 255).astype(np.uint8) for g in grays]
    ref = {k: np.stack([jpl.extract_panorama_lines(g, cap=96, mask=mask,
                                                   with_descriptors=False)[k] for g in u8])
           for k in ("normal", "mid", "arc", "mask", "e1", "e2")}
    out = tpl.extract_panorama_lines_batch(grays, cap=96, mask=mask, num_threads=2)
    np.testing.assert_array_equal(out["mask"], ref["mask"])
    assert ref["mask"].sum(1).min() > 10
    for k in ("normal", "mid", "arc", "e1", "e2"):
        np.testing.assert_allclose(out[k], ref[k], atol=1e-5, rtol=0)
    # with descriptors: the same arcs, and the JAX package's LBD of them
    # within the tolerance of tests/test_torch_line_tracks.py (1e-4)
    import jax.numpy as jnp
    from panovlm_tpu.ops import lbd as jlbd
    one = tpl.extract_panorama_lines(imgs[0], cap=96, mask=mask, with_descriptors=True,
                                     device="cpu")
    for k in ("normal", "mid", "arc", "mask", "e1", "e2"):
        np.testing.assert_array_equal(one[k], out[k][0])
    ref_desc = np.asarray(jlbd.line_band_descriptors(
        jnp.asarray(imgs[0].astype(np.float32) / 255.0), jnp.asarray(one["e1"]),
        jnp.asarray(one["e2"]), jnp.asarray(one["mask"])))
    assert one["desc"].shape == (96, 72)
    np.testing.assert_allclose(one["desc"], ref_desc, atol=1e-4, rtol=0)
