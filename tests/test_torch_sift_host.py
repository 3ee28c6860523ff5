"""The port's host SIFT (native/sift.cpp, utils/sift.extract_sift) against
cv2 5.0 and against the JAX package's extract_sift.

The port replays cv2's SIFT with the arithmetic of OpenCV's x86 AVX2 build
and without Intel IPP. cv2 takes that path with OPENCV_CPU_DISABLE=
AVX512-SKX and cv2.ipp.setUseIPP(False) (one thread: with IPP off, cv2's
own multithreaded SIFT is not deterministic), which cv2 reads when it is
imported, so the references come from a subprocess (`_reference`): cv2's
keypoints and descriptors, and the JAX extract_sift, on the same seeded
images. Held bit for bit there: pt, size, angle, response, octave, the
descriptors, their order, and extract_sift with the grid distribution and
RootSIFT on and off.

In this process cv2 runs as the JAX stage runs it: its defaults, which on
a CPU with AVX-512 take OpenCV's AVX512-SKX SIFT code and IPP's exp and
magnitude. Those move some angles by a few ulps and, where a descriptor
value sits at a rounding half, that value by one level. Held there: the
same number of keypoints, every one with a twin within 1e-3 px and 0.1 deg,
twins' descriptors within one level and at least 99.5 % of them equal.
cv2's own AVX2 path against its SSE path, measured the same way (both
without IPP) on the 720 x 1440 disk image of this file: 6,324 of 6,327
keypoints with a twin (99.95 %), 98.5 % of the twins with equal
descriptors, one twin more than one level apart. The tolerance here is
tighter than that.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from panovlm_tpu_torch.native import sift as native_sift
from panovlm_tpu_torch.utils import sift as port_sift

from synthetic import render_panorama

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

cv2 = pytest.importorskip("cv2")


def _panorama():
    gray, _ = render_panorama(np.array([0.3, 0.1, -0.2]), 180, 360)
    return np.clip(gray * 255, 0, 255).astype(np.uint8)


def _mask(h, w):
    m = np.full((h, w), 255, np.uint8)
    m[:200, :300] = 0
    m[500:, 1000:] = 0
    m[300:360, :] = 0
    return m


def _cases():
    disks = chip_smoke.random_disks(0, 720, 1440, 5000)
    # name: (image, mask, nfeatures for cv2, num_features for extract_sift,
    # its (grid_distribute, root_sift) cases: all four where the grid
    # distribution cuts, the stage's own elsewhere)
    every = ((0, 0), (0, 1), (1, 0), (1, 1))
    return {
        "panorama": (_panorama(), None, 0, 256, every),
        "disks": (disks, None, 0, 8096, ((1, 1),)),
        "disks_mask": (disks, _mask(720, 1440), 16192, 8096, ((1, 1), (0, 0))),
        "flat": (np.full((180, 360), 77, np.uint8), None, 0, 2048, ((1, 1),)),
        "retain_best": (disks, None, 2000, 1000, every),
    }


CASES = list(_cases())

_REFERENCE = textwrap.dedent("""
    import sys
    import numpy as np
    import cv2
    cv2.ipp.setUseIPP(False)
    cv2.setNumThreads(1)
    sys.path.insert(0, sys.argv[3])
    from panovlm_tpu.utils import sift as J
    z = np.load(sys.argv[1])
    out = {}
    for name in z["names"]:
        img = z[name + "/img"]
        mask = z[name + "/mask"] if name + "/mask" in z else None
        k, d = cv2.SIFT_create(nfeatures=int(z[name + "/nf"])).detectAndCompute(img, mask)
        out[name + "/kp"] = np.array([(p.pt[0], p.pt[1], p.size, p.angle, p.response)
                                      for p in k], np.float32).reshape(-1, 5)
        out[name + "/octave"] = np.array([p.octave for p in k], np.int32)
        out[name + "/desc"] = np.zeros((0, 128), np.float32) if d is None else d
        for grid, root in z[name + "/combos"]:
            r = J.extract_sift(img, int(z[name + "/F"]), bool(root), mask, bool(grid))
            for key, v in zip(("uv", "desc", "resp"), r):
                out[f"{name}/jax/{grid}{root}/{key}"] = v
    probe = np.asarray(z["probe"])
    k, d = cv2.SIFT_create().detectAndCompute(probe, None)
    out["probe/kp"] = np.array([(p.pt[0], p.pt[1], p.size, p.angle, p.response) for p in k],
                               np.float32)
    out["probe/octave"] = np.array([p.octave for p in k], np.int32)
    out["probe/desc"] = d
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def reference(cases, tmp_path_factory):
    d = tmp_path_factory.mktemp("sift_ref")
    inp = {"names": np.array(CASES), "probe": chip_smoke.sift_probe_image()}
    for name, (img, mask, nf, F, combos) in cases.items():
        inp[name + "/img"], inp[name + "/nf"], inp[name + "/F"] = img, nf, F
        inp[name + "/combos"] = np.array(combos)
        if mask is not None:
            inp[name + "/mask"] = mask
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, OPENCV_CPU_DISABLE="AVX512-SKX")
    subprocess.run([sys.executable, "-c", _REFERENCE, str(d / "in.npz"), str(d / "out.npz"), REPO],
                   check=True, env=env, timeout=300)
    return dict(np.load(d / "out.npz"))


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def _cv2_default(img, mask, nf):
    k, d = cv2.SIFT_create(nfeatures=nf).detectAndCompute(img, mask)
    kp = np.array([(p.pt[0], p.pt[1], p.size, p.angle, p.response) for p in k],
                  np.float32).reshape(-1, 5)
    return kp, np.zeros((0, 128), np.float32) if d is None else d


def _twins(kp, desc, kp_ref, desc_ref):
    """(keypoints of kp with a twin in kp_ref within 1e-3 px and 0.1 deg,
    twins with equal descriptors, twins within one level)."""
    from scipy.spatial import cKDTree
    if len(kp_ref) == 0:
        return 0, 0, 0
    tree = cKDTree(kp_ref[:, :2].astype(np.float64))
    n = eq = one = 0
    for i in range(len(kp)):
        for j in tree.query_ball_point(kp[i, :2].astype(np.float64), 1e-3):
            if abs((float(kp[i, 3]) - float(kp_ref[j, 3]) + 180) % 360 - 180) < 0.1:
                diff = np.abs(desc[i] - desc_ref[j]).max()
                n, eq, one = n + 1, eq + int(diff == 0), one + int(diff <= 1)
                break
    return n, eq, one


@pytest.mark.parametrize("name", CASES)
def test_host_sift_gives_cv2_and_the_jax_extract_sift(name, cases, reference):
    img, mask, nf, F, combos = cases[name]
    # two frames on 4 threads and the first again on 1: the result does not
    # depend on the thread count
    (kp, octave, desc), second = native_sift.detect_and_compute(
        np.stack([img, img[::-1]]), mask, nf, threads=4)
    (kp1, octave1, desc1), = native_sift.detect_and_compute(img, mask, nf, threads=1)
    for a, b in ((kp, kp1), (octave, octave1), (desc, desc1)):
        assert np.array_equal(_bits(a), _bits(b))
    assert len(second[0]) > 0 or name == "flat"

    # cv2's AVX2 path without IPP: bit for bit, in cv2's order
    kp_r, oct_r, desc_r = (reference[f"{name}/{k}"] for k in ("kp", "octave", "desc"))
    assert kp.shape == kp_r.shape, (kp.shape, kp_r.shape)
    assert np.array_equal(_bits(kp), _bits(kp_r))
    assert np.array_equal(octave, oct_r)
    assert np.array_equal(_bits(desc), _bits(desc_r.astype(np.float32)))
    if name == "flat":
        assert len(kp) == 0
    if name == "retain_best":   # the cut keeps nf (plus its ties) of many more
        assert nf <= len(kp) < len(reference["disks/kp"]) and len(reference["disks/kp"]) > 3 * nf
    if name == "disks":
        assert 5000 < len(kp) < 8000

    # cv2 as the JAX stage runs it here (its defaults): within the tolerance
    kp_d, desc_d = _cv2_default(img, mask, nf)
    assert len(kp_d) == len(kp)
    n, eq, one = _twins(kp, desc, kp_d, desc_d)
    assert n == len(kp) and one == n and eq >= 0.995 * n, (n, eq, one, len(kp))

    # the JAX extract_sift (grid distribution, RootSIFT) on cv2's AVX2 path
    for grid, root in combos:
        got = port_sift.extract_sift(img, F, bool(root), mask, bool(grid))
        for key, v in zip(("uv", "desc", "resp"), got):
            ref = reference[f"{name}/jax/{grid}{root}/{key}"]
            assert v.shape == ref.shape and v.dtype == ref.dtype, (grid, root, key)
            assert np.array_equal(_bits(v), _bits(ref)), (grid, root, key)


def test_the_embedded_probe_digest_is_cv2s(reference):
    """chip_smoke.SIFT_PROBE_SHA256 is what cv2 gives on the probe image,
    and what the port gives here."""
    want = chip_smoke.sift_digest(reference["probe/kp"], reference["probe/octave"],
                                  reference["probe/desc"])
    assert want == chip_smoke.SIFT_PROBE_SHA256
    (kp, octave, desc), = native_sift.detect_and_compute(chip_smoke.sift_probe_image())
    assert chip_smoke.sift_digest(kp, octave, desc) == want


def test_embedded_gaussian_kernels_are_cv2s():
    """The six kernels that sift.cpp embeds are getGaussianKernel's for the
    pyramid's sigmas, and the blur is cv2.GaussianBlur on float bit for bit
    (widths that are and are not multiples of 8 and 4, images smaller than
    the kernel)."""
    import math
    s = np.float32(1.6)
    sig = [float(np.sqrt(np.maximum(s * s - np.float32(1.0), np.float32(0.01))))]
    k = math.pow(2.0, 1.0 / 3)
    for i in range(1, 6):
        prev = math.pow(k, i - 1) * 1.6
        sig.append(math.sqrt((prev * k) ** 2 - prev * prev))
    assert np.allclose(sig, native_sift.BLUR_SIGMAS, rtol=0, atol=0)
    rng = np.random.default_rng(0)
    for h, w in ((64, 128), (45, 90), (23, 45), (5, 11), (37, 77), (20, 203)):
        img = rng.uniform(0, 255, (h, w)).astype(np.float32)
        for which, sigma in enumerate(native_sift.BLUR_SIGMAS):
            ref = cv2.GaussianBlur(img, (0, 0), sigma, sigmaY=sigma)
            got = native_sift.gaussian_blur(img, which)
            assert np.array_equal(_bits(got), _bits(ref)), (h, w, which)


@pytest.mark.parametrize("n", [5, 15, 16, 17, 40, 1000])
def test_hal_functions_are_cv2s(n):
    """exp32f, fastAtan2 (degrees) and magnitude32f against cv2.exp,
    cv2.phase and cv2.magnitude without IPP, on fewer and more than the 16
    values of one SIMD step."""
    rng = np.random.default_rng(n)
    x = rng.uniform(-10, 0, n).astype(np.float32)
    X = rng.normal(0, 30, n).astype(np.float32)
    Y = rng.normal(0, 30, n).astype(np.float32)
    X[: n // 4] = 0
    use = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        refs = (cv2.exp(x).ravel(), cv2.phase(X, Y, angleInDegrees=True).ravel(),
                cv2.magnitude(X, Y).ravel())
    finally:
        cv2.ipp.setUseIPP(use)
    got = (native_sift.exp32f(x), native_sift.fast_atan2(Y, X), native_sift.magnitude(X, Y))
    for g, r in zip(got, refs):
        assert np.array_equal(_bits(g), _bits(r))


def test_u8_frames_survive_the_jax_stages_float_round_trip():
    """The JAX stage hands cv2 (g * 255).astype(uint8) of g = v / 255 in
    float32; that is v for every 8-bit level, so the port passes the loaded
    bytes."""
    v = np.arange(256, dtype=np.uint8)
    g = v.astype(np.float32) / 255.0
    assert np.array_equal((g * 255).astype(np.uint8), v)


def test_pool_workers_rule():
    cores = os.cpu_count() or 1
    assert port_sift.pool_workers(-1) == cores and port_sift.pool_workers(0) == cores
    assert port_sift.pool_workers(1) == 1
    assert port_sift.pool_workers(10 ** 6) == cores


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (8, 8), (17, 23), (40, 9)])
def test_images_too_small_for_a_pyramid(shape):
    """Images whose doubled short side leaves cv2 no octave, or one or two:
    the same keypoints as cv2, no crash."""
    img = np.random.default_rng(shape[0]).integers(0, 256, shape).astype(np.uint8)
    kp_d, _ = _cv2_default(img, None, 0)
    (kp, _, desc), = native_sift.detect_and_compute(img)
    assert kp.shape == kp_d.shape and desc.shape == (len(kp), 128)
    assert np.array_equal(_bits(kp[:, [0, 1, 2, 4]]), _bits(kp_d[:, [0, 1, 2, 4]]))
