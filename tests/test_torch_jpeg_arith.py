"""Arithmetic-coded (SOF9, SOF10) and lossless (SOF3) JPEG files, which no
tool here writes, made by tests/image_forge.py (its QM encoder in
tests/arith_forge.cpp, written from T.81 Annex D and jcarith.c, shares no
code with native/jpeg.cpp), against cv2.imread, bit for bit, in colour
(BGR -> RGB) and gray:

  * arithmetic: sequential (interleaved and split over scans) and
    progressive (libjpeg's simple progression, with successive
    approximation; a spectral-selection script; a three-step refinement
    script) files at every sampling SAMPLING covers, with one, three and
    four components (CMYK, YCCK), with and without restarts, and DAC
    conditioning other than the defaults (L, U, Kx at their extremes). A
    complete file decodes to the bits of the Huffman-coded baseline file of
    the same coefficients;
  * the same files cut after each scan, at every byte of two small files
    (inside scan headers too) and at random points in their data; single
    bit flips; random bytes as scan data (the spectral and magnitude
    overflows after which libjpeg leaves the rest of a restart interval);
  * lossless: predictors 1-7 x point transforms 0-2 x restart intervals of
    0, one and two rows; precisions 2-16; one, three and four components
    under each colour-space marker; sampled components; split scans; cut
    and corrupted files; SOF11. What cv2 does with each kind is asserted
    too (LOSSLESS_KINDS): the port gives its bits where it gives an image
    and raises Cv2Refuses where it gives none.
"""

import numpy as np
import pytest
import torch

from panovlm_tpu_torch.io import jpeg
from panovlm_tpu_torch.native import jpeg as native_jpeg

import image_forge as forge
from test_torch_image_formats import SCRIPTS, SIZES, SIZE_IDS, _assert_like_cv2, _cv2_read, \
    _image, _scan_ends

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

SAMPLINGS = {"444": ((1, 1), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
             "420": ((2, 2), (1, 1), (1, 1)), "440": ((1, 2), (1, 1), (1, 1)),
             "411": ((4, 1), (1, 1), (1, 1))}
FOUR_SAMPLINGS = (((1, 1),) * 4, ((2, 2), (1, 1), (1, 1), (2, 2)))
DACS = ({"dc": {0: (0, 0), 1: (2, 5), 2: (15, 15)}, "ac": {0: 1, 1: 63, 2: 0}},
        {"dc": {0: (3, 3), 1: (0, 15)}, "ac": {0: 20, 1: 5}})


def _like_cv2_or_none(tmp_path, data: bytes, tag):
    """The port's bits where cv2 gives an image; where it gives none, the
    port raises ValueError (corrupt) or Cv2Refuses (a kind cv2 refuses)."""
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(data)
    for color in (True, False):
        ref = _cv2_read(path, color)
        if ref is None:
            with pytest.raises((ValueError, native_jpeg.Cv2Refuses)):
                native_jpeg.decode(data, color)
            continue
        out = native_jpeg.decode(data, color)
        assert out.shape == ref.shape, (tag, color)
        np.testing.assert_array_equal(out, ref, err_msg=f"{tag} color={color}")


def _cuts(data: bytes, n: int, seed: int):
    """Seeded cut points in the entropy-coded data of the file's scans."""
    start = data.index(b"\xff\xda")
    return np.random.default_rng(seed).integers(start, len(data) - 1, n)


def _flips(data: bytes, n: int, seed: int):
    """Copies of the file with one bit flipped past its first scan header."""
    rng = np.random.default_rng(seed)
    start = data.index(b"\xff\xda") + 12
    out = []
    for i in rng.integers(start, len(data) - 2, n):
        b = bytearray(data)
        b[i] ^= 1 << int(rng.integers(8))
        out.append((int(i), bytes(b)))
    return out


# ----------------------------------------------------------------------------
# arithmetic coding
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("sampling", list(SAMPLINGS))
@pytest.mark.parametrize("hw", SIZES, ids=SIZE_IDS)
def test_arithmetic_colour_like_cv2(sampling, hw, tmp_path):
    """Three components: a sequential file (one scan, and split over two),
    the simple progression and a spectral script, with restart intervals
    of 0 and 2 MCUs, each cut after each scan. A complete file decodes to
    the Huffman baseline file's bits."""
    img = _image(*hw, 31)
    comps, q = forge.plane_components([img[..., i] for i in range(3)], SAMPLINGS[sampling])
    w, h = hw[1], hw[0]
    base = native_jpeg.decode(forge.jpeg_bytes(comps, w, h, q, [("seq", [0, 1, 2])]), True)
    for scans in ([("seq", [0, 1, 2])], [("seq", [1]), ("seq", [0, 2])],
                  forge.SIMPLE_PROGRESSION_3, forge.spectral_script(3)):
        for rst in (0, 2):
            data = forge.jpeg_bytes(comps, w, h, q, scans, restart=rst, arithmetic=True)
            assert (b"\xff\xc9" if scans[0][0] == "seq" else b"\xff\xca") in data
            _assert_like_cv2(tmp_path, data, ".jpg", (sampling, len(scans), rst))
            np.testing.assert_array_equal(native_jpeg.decode(data, True), base)
            for k, end in enumerate(_scan_ends(data)[:-1]):
                _like_cv2_or_none(tmp_path, data[:end], (sampling, len(scans), rst, "cut", k))


@pytest.mark.parametrize("script", ["simple", "spectral", "refine", "partial"])
@pytest.mark.parametrize("hw", SIZES[1:], ids=SIZE_IDS[1:])
def test_arithmetic_progressive_scripts_like_cv2(script, hw, tmp_path):
    """The port encoder's coefficients (4:2:0, quality 90) under
    test_torch_image_formats' scripts (successive approximation over three
    steps, coefficients never sent), restarts of 0 and 3 MCUs, cut after
    each scan (block smoothing as libjpeg does it)."""
    img = _image(*hw, 32)
    comps, q, w, h = forge.port_components(img, 90)
    scans = {"simple": forge.SIMPLE_PROGRESSION_3,
             "spectral": forge.spectral_script(3)}.get(script) or SCRIPTS[script]
    base = native_jpeg.decode(jpeg.encode(img, 90), True)
    for rst in (0, 3):
        data = forge.jpeg_bytes(comps, w, h, q, scans, restart=rst, arithmetic=True)
        _assert_like_cv2(tmp_path, data, ".jpg", (script, rst))
        if script != "partial":
            np.testing.assert_array_equal(native_jpeg.decode(data, True), base)
        for k, end in enumerate(_scan_ends(data)[:-1]):
            _like_cv2_or_none(tmp_path, data[:end], (script, rst, "cut", k))


@pytest.mark.parametrize("hw", SIZES, ids=SIZE_IDS)
def test_arithmetic_gray_like_cv2(hw, tmp_path):
    """One component: sequential, simple progression and spectral script,
    restarts of 0 and 4 blocks; the baseline file's bits."""
    g = _image(*hw, 33)[..., 1]
    comps, q, w, h = forge.port_components(g, 90)
    base = native_jpeg.decode(jpeg.encode(g, 90), False)
    for scans in ([("seq", [0])], forge.SIMPLE_PROGRESSION_1, forge.spectral_script(1)):
        for rst in (0, 4):
            data = forge.jpeg_bytes(comps, w, h, q, scans, restart=rst, arithmetic=True)
            _assert_like_cv2(tmp_path, data, ".jpg", (len(scans), rst))
            np.testing.assert_array_equal(native_jpeg.decode(data, False), base)


@pytest.mark.parametrize("hw", SIZES[1:], ids=SIZE_IDS[1:])
def test_arithmetic_cmyk_ycck_like_cv2(hw, tmp_path):
    """Four components (no Adobe marker and transform 0: CMYK; transform
    2: YCCK), interleaved sequential and progressive, two samplings."""
    cmyk = np.concatenate([_image(*hw, 34), _image(*hw, 35)[..., :1]], axis=2)
    for sampling in FOUR_SAMPLINGS:
        comps, q = forge.plane_components([cmyk[..., i] for i in range(4)], sampling)
        for adobe in (None, 0, 2):
            for scans in ([("seq", [0, 1, 2, 3])],
                          [("dc", [0, 1, 2, 3], 0, 1)] + [("ac", i, 1, 63, 0, 0) for i in range(4)]
                          + [("dc", [0, 1, 2, 3], 1, 0)]):
                data = forge.jpeg_bytes(comps, hw[1], hw[0], q, scans, restart=1, jfif=False,
                                        adobe=adobe, arithmetic=True)
                _assert_like_cv2(tmp_path, data, ".jpg", (sampling, adobe, len(scans)))


@pytest.mark.parametrize("dac", range(len(DACS)))
def test_arithmetic_dac_conditioning_like_cv2(dac, tmp_path):
    """DAC segments with L = U = 0, L = U = 15, L < U, Kx = 0, 1, 20 and
    63 in different table slots, sequential and progressive, restarts of 0
    and 5 MCUs: cv2's bits, and the baseline file's."""
    img = _image(129, 257, 36)
    comps, q, w, h = forge.port_components(img, 85)
    base = native_jpeg.decode(jpeg.encode(img, 85), True)
    for scans in ([("seq", [0, 1, 2])], forge.SIMPLE_PROGRESSION_3):
        for rst in (0, 5):
            data = forge.jpeg_bytes(comps, w, h, q, scans, restart=rst, arithmetic=True,
                                    dac=DACS[dac])
            assert b"\xff\xcc" in data
            _assert_like_cv2(tmp_path, data, ".jpg", (len(scans), rst))
            np.testing.assert_array_equal(native_jpeg.decode(data, True), base)


@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
def test_arithmetic_cut_at_every_byte_like_cv2(progressive, tmp_path):
    """A 37 x 53 gray file cut at each byte from its first scan header on:
    past the end libjpeg's source reads EOI markers (FF D9 ...), also as
    the bytes of a cut scan header, and the decoder reads zero bytes after
    a marker."""
    g = _image(37, 53, 37)[..., 0]
    comps, q, w, h = forge.port_components(g, 90)
    scans = forge.SIMPLE_PROGRESSION_1 if progressive else [("seq", [0])]
    data = forge.jpeg_bytes(comps, w, h, q, scans, restart=4, arithmetic=True)
    for cut in range(data.index(b"\xff\xda"), len(data)):
        _like_cv2_or_none(tmp_path, data[:cut], cut)


@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
@pytest.mark.parametrize("rst", [0, 5])
def test_arithmetic_cut_and_flipped_like_cv2(progressive, rst, tmp_path):
    """A 129 x 257 colour file cut at 12 points in its data, 24 copies with
    one bit flipped (a new marker ends a scan early, a restart marker
    goes missing), and the file with random bytes for its scan data."""
    comps, q, w, h = forge.port_components(_image(129, 257, 38), 90)
    scans = forge.SIMPLE_PROGRESSION_3 if progressive else [("seq", [0, 1, 2])]
    data = forge.jpeg_bytes(comps, w, h, q, scans, restart=rst, arithmetic=True)
    for cut in _cuts(data, 12, rst + progressive):
        _like_cv2_or_none(tmp_path, data[:cut], ("cut", int(cut)))
    for i, flipped in _flips(data, 24, 10 + rst + progressive):
        _like_cv2_or_none(tmp_path, flipped, ("flip", i))
    head = data[:data.index(b"\xff\xda") + 14]
    noise = np.random.default_rng(rst).integers(0, 255, 6000).astype(np.uint8).tobytes()
    _like_cv2_or_none(tmp_path, head + noise + b"\xff\xd9", "random data")


# ----------------------------------------------------------------------------
# lossless
# ----------------------------------------------------------------------------

W, H = 53, 37


@pytest.mark.parametrize("predictor", forge.LOSSLESS_PREDICTORS)
def test_lossless_gray_like_cv2(predictor, tmp_path):
    """An 8-bit gray file at point transforms 0-2 and restart intervals of
    0, one and two rows: cv2's gray read is the samples >> Pt << Pt, and
    the port's is cv2's; cv2 gives no colour read (libjpeg converts no
    gray to colour in lossless mode)."""
    planes = forge.lossless_planes(W, H, [(1, 1)], 8, predictor)
    for pt in range(3):
        for rst in (0, W, 2 * W):
            data = forge.lossless_bytes(planes, W, H, predictor=predictor, pt=pt, restart=rst)
            path = str(tmp_path / "l.jpg")
            with open(path, "wb") as f:
                f.write(data)
            ref = _cv2_read(path, False)
            np.testing.assert_array_equal(ref, (planes[0] >> pt) << pt)
            np.testing.assert_array_equal(native_jpeg.decode(data, False), ref)
            assert _cv2_read(path, True) is None
            with pytest.raises(native_jpeg.Cv2Refuses, match="lossless"):
                native_jpeg.decode(data, True)


# kind -> (lossless_bytes arguments, (cv2 gives a colour image, a gray one))
LOSSLESS_KINDS = {
    "3 components, ids 1 2 3": ({"n": 3}, (True, False)),
    "3 components, ids R G B": ({"n": 3, "ids": [82, 71, 66]}, (True, False)),
    "3 components, ids 4 5 6": ({"n": 3, "ids": [4, 5, 6]}, (True, False)),
    "3 components, JFIF": ({"n": 3, "jfif": True}, (False, False)),
    "3 components, Adobe 0": ({"n": 3, "adobe": 0}, (True, False)),
    "3 components, Adobe 1": ({"n": 3, "adobe": 1}, (False, False)),
    "4 components": ({"n": 4}, (True, True)),
    "4 components, Adobe 0": ({"n": 4, "adobe": 0}, (True, True)),
    "4 components, Adobe 2 (YCCK)": ({"n": 4, "adobe": 2}, (False, False)),
    "sampled 2x1": ({"sampling": [(2, 1), (1, 1), (1, 1)]}, (True, False)),
    "sampled 2x2": ({"sampling": [(2, 2), (1, 1), (1, 1)], "predictor": 6}, (True, False)),
    "sampled 1x2": ({"sampling": [(1, 2), (1, 1), (1, 1)], "restart": W}, (True, False)),
    "sampled chroma 2x2": ({"sampling": [(1, 1), (2, 2), (1, 1)]}, (True, False)),
    "sampled 2x2 JFIF": ({"sampling": [(2, 2), (1, 1), (1, 1)], "jfif": True}, (False, False)),
    "gray sampled 2x2": ({"sampling": [(2, 2)]}, (False, True)),
    "CMYK sampled": ({"sampling": [(2, 2), (1, 1), (1, 1), (2, 2)], "predictor": 7},
                     (True, True)),
    "3 scans": ({"n": 3, "scans": [[0], [1], [2]]}, (True, False)),
    "2 scans, restarts": ({"n": 3, "scans": [[2], [0, 1]], "restart": W, "predictor": 4},
                          (True, False)),
    "split sampled scans": ({"sampling": [(2, 2), (1, 1), (1, 1)], "scans": [[0], [1], [2]],
                             "predictor": 5}, (True, False)),
    "restart not a whole row": ({"restart": 7}, (False, False)),
    "lossless arithmetic (SOF11)": ({"sof": 0xCB}, (False, False)),
    "hierarchical lossless (SOF7)": ({"sof": 0xC7}, (False, False)),
    **{f"{p}-bit": ({"precision": p, "predictor": 4}, (False, p <= 8)) for p in range(2, 17)},
}


@pytest.mark.parametrize("kind", list(LOSSLESS_KINDS))
def test_lossless_kinds_like_cv2(kind, tmp_path):
    """What cv2 gives for each kind (asserted), and the port's bits where it
    gives an image (the samples themselves for the 8-bit and lower files
    it reads in full)."""
    kw, (color_ok, gray_ok) = LOSSLESS_KINDS[kind]
    kw = dict(kw)
    n = kw.pop("n", None)
    sampling = kw.pop("sampling", [(1, 1)] * (n or 1))
    precision = kw.get("precision", 8)
    planes = forge.lossless_planes(W, H, sampling, precision, len(kind))
    data = forge.lossless_bytes(planes, W, H, sampling=sampling, **kw)
    path = str(tmp_path / "l.jpg")
    with open(path, "wb") as f:
        f.write(data)
    for color, ok in ((True, color_ok), (False, gray_ok)):
        ref = _cv2_read(path, color)
        assert (ref is not None) == ok, (kind, color)
        if ref is None:
            with pytest.raises((native_jpeg.Cv2Refuses, ValueError)):
                native_jpeg.decode(data, color)
            continue
        np.testing.assert_array_equal(native_jpeg.decode(data, color), ref,
                                      err_msg=f"{kind} color={color}")
        if not color and len(sampling) == 1:
            np.testing.assert_array_equal(ref, planes[0])
        if color and len(sampling) == 3 and set(sampling) == {(1, 1)}:
            np.testing.assert_array_equal(ref, np.stack(planes, -1))


@pytest.mark.parametrize("rst", [0, 2 * W])
def test_lossless_cut_and_corrupt_like_cv2(rst, tmp_path):
    """A gray and an RGB file cut at 12 points in their data (the rest of
    the restart interval predicts 2^(P-1)) and with 12 single-bit flips."""
    for n, color in ((1, False), (3, True)):
        planes = forge.lossless_planes(W, H, [(1, 1)] * n, 8, n)
        data = forge.lossless_bytes(planes, W, H, predictor=5, pt=1, restart=rst)
        for cut in _cuts(data, 12, rst + n):
            _like_cv2_or_none(tmp_path, data[:cut], ("cut", n, int(cut)))
        for i, flipped in _flips(data, 12, rst + n):
            _like_cv2_or_none(tmp_path, flipped, ("flip", n, i))
