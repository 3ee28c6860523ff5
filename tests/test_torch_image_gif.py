"""GIF (native/gif.cpp, OpenCV 5.0's own GIF decoder replayed) against
cv2.imread, bit for bit, in gray and in colour (BGR -> RGB), on files
tests/image_forge.py writes (gif_bytes and its parts; cv2 writes none of
these kinds):

  * every variant at 1 x 1, 7 x 13, 37 x 53 and 129 x 257: palettes of 2
    to 256 entries, each minimum code size cv2 takes (2 to 11), global and
    local palettes and none, frames at an offset on a larger screen,
    transparency (the index equal to the background and not), interlace,
    several frames, a deferred clear, 87a, extensions, short sub-blocks;
    interlace at every height class;
  * the rules of OpenCV's decoder on odd files, each asserted against
    cv2's own outcome: an image, no image (the port raises Cv2Refuses or
    ValueError), or cv2.imread raising (Cv2Raises);
  * 20 files cut at every byte and 1,200 bit-flipped copies: the port
    gives an image exactly where cv2 does, with its bits;
  * a logical screen over 2^30 pixels: cv2.imread raises, and the port
    raises Cv2Raises without allocating it;
  * forged LZW codes (past the table, strings past the frame, random
    codes) through the decoder built with AddressSanitizer: no read or
    write past a buffer, and the port's outcome;
  * load_mask against the JAX package's (cv2-based) on GIF masks;
  * the forge's two LZW coders write the same codes;
  * chip_smoke.py phase 16 (j)'s probes, their digests recomputed with cv2.
"""

import base64
import hashlib
import shutil
import subprocess
import tracemalloc
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from panovlm_tpu import pipeline as jpipe
from panovlm_tpu.config import Config
from panovlm_tpu_torch import native
from panovlm_tpu_torch.io import images
from panovlm_tpu_torch.native import gif

import chip_smoke as cs
import image_forge as forge

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

SIZES = ((1, 1), (7, 13), (37, 53), (129, 257))


def _cv2_read(path, color):
    """cv2.imread's outcome: the image (RGB for a colour read), None where it
    gives none, "raises" where it raises."""
    try:
        img = cv2.imread(str(path), cv2.IMREAD_COLOR if color else cv2.IMREAD_GRAYSCALE)
    except cv2.error:
        return "raises"
    if img is None:
        return None
    return np.ascontiguousarray(img[..., ::-1]) if color else img


def _port_read(data: bytes, color: bool):
    """The port's outcome on the same bytes, as _cv2_read gives cv2's."""
    if images.image_format(data[:64]) != "GIF":
        return None
    try:
        return gif.decode(data, color)
    except native.Cv2Raises:
        return "raises"
    except (native.Cv2Refuses, ValueError):
        return None


def _outcome(x):
    return x.shape if isinstance(x, np.ndarray) else x


def _same_as_cv2(path, data: bytes, tag):
    """Both reads of data (written to path) against cv2's; returns cv2's
    colour outcome."""
    path.write_bytes(data)
    outcome = None
    for color in (True, False):
        ref, out = _cv2_read(path, color), _port_read(data, color)
        assert _outcome(out) == _outcome(ref), (tag, color)
        if isinstance(ref, np.ndarray):
            assert out.dtype == np.uint8, tag
            np.testing.assert_array_equal(out, ref, err_msg=f"{tag} color={color}")
        if color:
            outcome = _outcome(ref)
    return outcome


def _pal(rng, n):
    return rng.integers(0, 256, (n, 3))


def _blocky(rng, h, w, levels):
    """Indices in runs of 4 (long LZW strings), some single pixels."""
    b = np.repeat(rng.integers(0, levels, (h, (w + 3) // 4)), 4, axis=1)[:, :w]
    b[rng.random((h, w)) < 0.2] = rng.integers(0, levels)
    return b.astype(np.uint8)


# ----------------------------------------------------------------------------
# every variant at every size
# ----------------------------------------------------------------------------

def _entries(n):
    return lambda r, h, w: forge.gif_bytes(r.integers(0, n, (h, w)), _pal(r, n))


def _min_code(m):
    n = min(1 << m, 256)
    return lambda r, h, w: forge.gif_bytes(_blocky(r, h, w, n), _pal(r, n), min_code=m)


def _offset(r, h, w, **kw):
    """The frame one pixel in from the left and two from the top of a screen
    3 wider and 4 taller."""
    return forge.gif_bytes(_blocky(r, h, w, 16), _pal(r, 16), screen=(w + 3, h + 4),
                           offset=(1, 2), **kw)


def _frames(r, h, w):
    """A second frame (with its own GCE, local palette, offset) and a third."""
    pal = _pal(r, 16)
    after = (forge.gif_gce(2, 1) + forge.gif_image(_blocky(r, h, w, 4), 0, 0, _pal(r, 4))
             + forge.gif_gce(None, 3) + forge.gif_image(_blocky(r, 1, 1, 16)))
    return forge.gif_bytes(_blocky(r, h, w, 16), pal, after=after)


EXTENSIONS = (forge.gif_extension(0xFF, [b"NETSCAPE2.0", b"\x01\x00\x00"])
              + forge.gif_extension(0xFE, [b"a comment", b"in two sub-blocks"])
              + forge.gif_extension(0x01, [bytes(12), b"plain text"])
              + forge.gif_extension(0xFF, [b"XMP DataXMP", b"<x/>" * 20])
              + forge.gif_extension(0x7C, [b"unknown label"]))

KINDS = {
    **{f"{n}-entry palette": _entries(n) for n in (2, 3, 4, 16, 100, 256)},
    **{f"minimum code size {m}": _min_code(m) for m in range(2, 12)},
    "local palette, no global one": lambda r, h, w: forge.gif_bytes(
        _blocky(r, h, w, 16), None, local=_pal(r, 16)),
    "local palette over a longer global one": lambda r, h, w: forge.gif_bytes(
        _blocky(r, h, w, 64), _pal(r, 64), local=_pal(r, 8)),
    "no palette (index 1 white, v gray)": lambda r, h, w: forge.gif_bytes(
        _blocky(r, h, w, 256), None),
    "offset frame on a background": lambda r, h, w: _offset(r, h, w, bg=5),
    "offset frame, no global palette (black)": lambda r, h, w: forge.gif_bytes(
        _blocky(r, h, w, 16), None, local=_pal(r, 16), screen=(w + 2, h + 1), offset=(2, 1),
        bg=200),
    "transparent index the background": lambda r, h, w: _offset(r, h, w, bg=3, transparent=3),
    "transparent index not the background": lambda r, h, w: _offset(r, h, w, bg=3,
                                                                     transparent=7),
    "transparent, no offset": lambda r, h, w: forge.gif_bytes(
        _blocky(r, h, w, 16), _pal(r, 16), bg=9, transparent=0),
    "interlaced": lambda r, h, w: forge.gif_bytes(_blocky(r, h, w, 256), _pal(r, 256),
                                                  interlace=True),
    "interlaced offset frame": lambda r, h, w: _offset(r, h, w, interlace=True),
    "several frames": _frames,
    "deferred clear": lambda r, h, w: forge.gif_bytes(r.integers(0, 256, (h, w)), _pal(r, 256),
                                                      deferred=True),
    "87a": lambda r, h, w: forge.gif_bytes(_blocky(r, h, w, 4), _pal(r, 4), version=b"87a"),
    "extensions": lambda r, h, w: forge.gif_bytes(_blocky(r, h, w, 16), _pal(r, 16),
                                                  before=EXTENSIONS, after=EXTENSIONS),
    "sub-blocks of 1 byte": lambda r, h, w: forge.gif_bytes(_blocky(r, h, w, 16), _pal(r, 16),
                                                            block=1),
    "sub-blocks of 254 bytes": lambda r, h, w: forge.gif_bytes(r.integers(0, 256, (h, w)),
                                                               _pal(r, 256), block=254),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_variant_reads_like_cv2(tmp_path, kind):
    """The variant at every size: cv2's bits in both reads."""
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    for h, w in SIZES:
        data = KINDS[kind](rng, h, w)
        assert images.image_format(data[:64]) == "GIF"
        assert _same_as_cv2(tmp_path / "x.gif", data, (kind, h, w)) is not None, (kind, h, w)


def test_interlace_at_every_height_class(tmp_path):
    """Interlaced frames of 1 to 17 rows (every row count modulo 8, twice)
    and of 64, 65 and 71 rows."""
    rng = np.random.default_rng(8)
    for h in list(range(1, 18)) + [64, 65, 71]:
        data = forge.gif_bytes(rng.integers(0, 16, (h, 5)), _pal(rng, 16), interlace=True)
        assert _same_as_cv2(tmp_path / "x.gif", data, h) == (h, 5, 3)


def test_the_deferred_clear_fills_the_table(tmp_path):
    """The deferred-clear files go on past 4096 entries without a clear code
    (so the decoder reads codes from a full table), and a file whose table
    fills and is cleared reads too."""
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 256, (129, 257)).astype(np.uint8)
    codes = forge.gif_codes(idx.tobytes(), 8, deferred=True)
    assert len(codes) > 4096 and codes.count(256) == 1
    assert forge.gif_codes(idx.tobytes(), 8).count(256) > 1
    for deferred in (True, False):
        data = forge.gif_bytes(idx, _pal(rng, 256), deferred=deferred)
        assert _same_as_cv2(tmp_path / "x.gif", data, deferred) == (129, 257, 3)


# ----------------------------------------------------------------------------
# the rules of OpenCV's decoder on odd files
# ----------------------------------------------------------------------------

def _codes(codes, min_code=2, w=3, h=1, pal=((9, 9, 9), (1, 2, 3), (4, 5, 6), (7, 8, 9))):
    """A 1-row file whose frame holds the packed codes as they are."""
    return (forge.gif_screen(w, h, pal) + forge.gif_image(np.zeros((h, w)), data=forge.gif_pack(
        codes, min_code), min_code=min_code) + b"\x3b")


def _odd_files():
    r = np.random.default_rng(12)
    idx = _blocky(r, 5, 7, 4)
    pal = _pal(r, 4)
    base = forge.gif_bytes(idx, pal)
    second = forge.gif_image(idx, 0, 0, None)
    image, none, raises = (5, 7, 3), None, "raises"
    return {
        # the header and the walk to the trailer
        "87a": (forge.gif_bytes(idx, pal, version=b"87a"), image),
        "a logical screen of 0 x 0": (forge.gif_screen(0, 0, pal) + forge.gif_image(idx) + b";",
                                      none),
        "a frame reaching past the screen": (forge.gif_bytes(idx, pal, screen=(7, 5),
                                                             offset=(1, 0)), none),
        "a background index past the global palette": (forge.gif_bytes(idx, pal, bg=4), none),
        "a background index past 255 entries, no global palette": (
            forge.gif_bytes(idx, None, local=pal, bg=250, screen=(8, 6), offset=(1, 1)),
            (6, 8, 3)),
        "a block introducer 0x99": (forge.gif_screen(7, 5, pal) + b"\x99" + second + b";", none),
        "a block introducer 0x00 before the trailer": (base[:-1] + b"\x00;", none),
        "no trailer": (base[:-1], none),
        "a cut second frame": (forge.gif_bytes(idx, pal, after=second[:-3]), none),
        "a bit flipped in the second frame's data": (
            forge.gif_bytes(idx, pal, after=second[:16] + bytes([second[16] ^ 4]) + second[17:]),
            image),
        "bytes after the trailer": (base + b"\x21\xf9junk", image),
        "no frame": (forge.gif_screen(7, 5, pal) + b";", none),
        # extensions
        "NETSCAPE, comment and plain text extensions": (forge.gif_bytes(idx, pal, before=(
            forge.gif_extension(0xFF, [b"NETSCAPE2.0", b"\x01\x05\x00"])
            + forge.gif_extension(0xFE, [b"c" * 255, b"d"])
            + forge.gif_extension(0x01, [bytes(12), b"t"]))), image),
        "NETSCAPE with a 3-byte sub-block not opening with 1": (forge.gif_bytes(
            idx, pal, before=forge.gif_extension(0xFF, [b"NETSCAPE2.0", b"\x02\x05\x00"])), image),
        "another application's 3-byte sub-block": (forge.gif_bytes(
            idx, pal, before=forge.gif_extension(0xFF, [b"XMP DataXMP", b"\x01\x02\x00"])), none),
        "another application's 4-byte sub-block": (forge.gif_bytes(
            idx, pal, before=forge.gif_extension(0xFF, [b"XMP DataXMP", b"\x01\x02\x00\x00"])),
            image),
        "a graphic control extension of 5 bytes": (forge.gif_bytes(
            idx, pal, before=forge.gif_extension(0xF9, [b"\x01\x00\x00\x02\x00"])), none),
        "a graphic control extension of 5 bytes before the second frame": (forge.gif_bytes(
            idx, pal, after=forge.gif_extension(0xF9, [b"\x01\x00\x00\x02\x00"]) + second), image),
        "two graphic control extensions, the last without transparency": (forge.gif_bytes(
            idx, pal, before=forge.gif_gce(2) + forge.gif_gce(None)), image),
        **{f"disposal method {d}": (forge.gif_bytes(idx, pal, disposal=d),
                                    image if d <= 3 else none) for d in range(8)},
        "disposal method 7 before the second frame": (forge.gif_bytes(
            idx, pal, after=forge.gif_gce(None, 7) + second), image),
        # palettes
        "no palette at all": (forge.gif_bytes(np.array([[0, 1, 2, 3, 200]]), None, screen=(6, 2),
                                               offset=(1, 1)), (2, 6, 3)),
        "an index past both palettes": (forge.gif_bytes(np.array([[0, 5]]), pal[:2],
                                                        local=pal[:2]), none),
        "a transparent index past both palettes": (forge.gif_bytes(
            np.array([[0, 5]]), pal[:2], transparent=5), (1, 2, 3)),
        # LZW
        **{f"minimum code size {m}": (forge.gif_bytes(idx, pal, min_code=m),
                                      image if 2 <= m <= 11 else none) for m in (1, 12)},
        "literals of 9 bits past 255": (_codes([512, 257, 258, 3, 513], 9), (1, 3, 3)),
        "a code past the next entry": (_codes([4, 0, 7, 5]), none),
        "the code of the next entry": (_codes([4, 1, 6, 5]), (1, 3, 3)),
        "no clear code first": (_codes([1, 2, 3, 5]), (1, 3, 3)),
        "no end-of-information code": (_codes([4, 1, 2, 3]), (1, 3, 3)),
        "codes after the end-of-information code": (_codes([4, 1, 5, 2, 3, 5]), (1, 3, 3)),
        "a clear code in the middle": (_codes([4, 1, 4, 2, 3, 5]), (1, 3, 3)),
        "a code after the last pixel": (_codes([4, 1, 2, 3, 0, 5]), none),
        "codes that end short": (_codes([4, 1, 2, 5]), none),
        "a string past the last pixel": (_codes([4, 1, 2, 6, 5]), none),
        "an empty sub-block in the data": (
            forge.gif_screen(3, 1, pal) + b"\x2c" + bytes(8) + b"\x00\x02\x00"
            + forge.gif_sub_blocks(forge.gif_pack([4, 1, 2, 3, 5], 2)) + b";", none),
        # sizes
        "a screen of 65535 x 16385 (over 2^30 pixels)": (
            forge.gif_screen(65535, 16385, pal) + forge.gif_image(idx) + b";", raises),
    }


ODD = _odd_files()


@pytest.mark.parametrize("name", list(ODD))
def test_odd_file_gives_cv2s_outcome(tmp_path, name):
    """cv2's outcome is the one listed (an image of that shape, no image, or
    cv2.imread raising), and the port's is cv2's, with its bits."""
    data, want = ODD[name]
    assert _same_as_cv2(tmp_path / "x.gif", data, name) == want


def test_screen_over_the_limit_raises_without_allocating(tmp_path):
    """A logical screen of 65535 x 16385 pixels (a 9-byte frame in it): the
    JAX package's load_mask raises as cv2.imread does, and the port's
    read_image and load_mask raise Cv2Raises before any buffer of the
    screen's size is allocated (numpy's allocations stay under 1 MiB)."""
    path = tmp_path / "mask.png"
    path.write_bytes(ODD["a screen of 65535 x 16385 (over 2^30 pixels)"][0])
    with pytest.raises(cv2.error):
        jpipe.load_mask(Config(mask_path=str(path)), 4, 8)
    for read in (lambda: images.read_image(str(path), True),
                 lambda: images.load_mask(str(path), 4, 8)):
        tracemalloc.start()
        try:
            with pytest.raises(native.Cv2Raises):
                read()
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        assert peak < 1 << 20, peak


# ----------------------------------------------------------------------------
# cut and corrupted files
# ----------------------------------------------------------------------------

def _cut_files():
    r = np.random.default_rng(21)
    h, w = 4, 6
    b = _blocky(r, h, w, 8)
    pal = _pal(r, 8)
    return {
        "8 colours": forge.gif_bytes(b, pal),
        "256 colours": forge.gif_bytes(r.integers(0, 256, (3, 5)), _pal(r, 256)),
        "interlaced": forge.gif_bytes(b, pal, interlace=True),
        "local palette": forge.gif_bytes(b, None, local=pal),
        "local over global": forge.gif_bytes(b, pal, local=pal[:2]),
        "no palette": forge.gif_bytes(b, None),
        "offset, background, transparency": forge.gif_bytes(b, pal, screen=(8, 7), offset=(1, 2),
                                                            bg=3, transparent=int(b[0, 0])),
        "87a, 2 colours": forge.gif_bytes(b % 2, pal[:2], version=b"87a"),
        "minimum code size 2": forge.gif_bytes(b % 4, pal[:4], min_code=2),
        "minimum code size 9": forge.gif_bytes(b, pal, min_code=9),
        "minimum code size 11": forge.gif_bytes(b, pal, min_code=11),
        "two frames": forge.gif_bytes(b, pal, after=forge.gif_gce(1, 2)
                                      + forge.gif_image(b[:2, :3], 1, 1)),
        "NETSCAPE and comment": forge.gif_bytes(b, pal, before=forge.gif_extension(
            0xFF, [b"NETSCAPE2.0", b"\x01\x00\x00"]) + forge.gif_extension(0xFE, [b"hi"])),
        "another application": forge.gif_bytes(b, pal, before=forge.gif_extension(
            0xFF, [b"XMP DataXMP", b"\x05\x02\x01\x00"])),
        "graphic control, disposal 3": forge.gif_bytes(b, pal, transparent=2, disposal=3),
        "sub-blocks of 3 bytes": forge.gif_bytes(b, pal, block=3),
        "codes after the end-of-information code": _codes([4, 1, 5, 2, 3, 5]),
        "codes of the next entry": _codes([4, 1, 6, 1, 7, 5], w=7),
        "a clear code in the middle": _codes([4, 3, 6, 4, 2, 6, 5], w=6),
        "plain text and an unknown extension": forge.gif_bytes(b, pal, before=forge.gif_extension(
            0x01, [bytes(12), b"x"]) + forge.gif_extension(0x33, [b"yz"])),
    }


CUT_FILES = _cut_files()


def test_twenty_files():
    assert len(CUT_FILES) == 20 and all(len(d) < 1000 for d in CUT_FILES.values())


@pytest.mark.parametrize("name", list(CUT_FILES))
def test_cut_at_every_byte_like_cv2(tmp_path, name):
    """The whole file reads; every shorter one gives what cv2 gives (no
    image once the trailer is gone)."""
    data = CUT_FILES[name]
    assert _same_as_cv2(tmp_path / "x.gif", data, name) is not None
    for k in range(len(data)):
        _same_as_cv2(tmp_path / "x.gif", data[:k], (name, k))


FUZZ_FILES = ("8 colours", "interlaced", "local over global", "offset, background, transparency",
              "minimum code size 9", "two frames", "another application",
              "codes after the end-of-information code")


@pytest.mark.parametrize("name", FUZZ_FILES)
def test_bit_flips_like_cv2(tmp_path, name):
    """150 copies with 1-3 bits flipped anywhere after the signature:
    cv2's image or no image, and the port's the same."""
    data = CUT_FILES[name]
    rng = np.random.default_rng(len(name))
    for i in range(150):
        b = bytearray(data)
        for _ in range(rng.integers(1, 4)):
            b[rng.integers(6, len(b))] ^= 1 << int(rng.integers(0, 8))
        _same_as_cv2(tmp_path / "x.gif", bytes(b), (name, i))


def test_decodes_on_threads_alike():
    """No shared state: the same files decoded on 8 threads at once give the
    bits of one thread."""
    jobs = [(d, c) for d in CUT_FILES.values() for c in (True, False)]
    ref = [_port_read(d, c) for d, c in jobs]
    with ThreadPoolExecutor(max_workers=8) as ex:
        for _ in range(4):
            for a, b in zip(ex.map(lambda j: _port_read(*j), jobs), ref):
                np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------------
# forged LZW codes under AddressSanitizer
# ----------------------------------------------------------------------------

_DRIVER = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
extern "C" int pv_gif_info(const unsigned char*, long, int, int*, int*, char*, int);
extern "C" int pv_gif_decode(const unsigned char*, long, int, unsigned char*, char*, int);
// each file's return codes (colour, gray) into buffers of exactly the
// image's size, so that a write past the image is a heap overflow
int main(int argc, char** argv) {
  for (int i = 1; i < argc; i++) {
    FILE* f = fopen(argv[i], "rb");
    std::vector<unsigned char> d;
    for (int c; (c = fgetc(f)) != EOF;) d.push_back((unsigned char)c);
    fclose(f);
    for (int color = 1; color >= 0; color--) {
      char err[256];
      int h = 0, w = 0;
      int rc = pv_gif_info(d.data(), (long)d.size(), color, &h, &w, err, 256);
      if (!rc) {
        unsigned char* out = (unsigned char*)malloc((size_t)h * w * (color ? 3 : 1));
        rc = pv_gif_decode(d.data(), (long)d.size(), color, out, err, 256);
        free(out);
      }
      printf("%d ", rc);
    }
    printf("\n");
  }
}
"""


def _past_the_table(codes, min_code):
    """The stream with a code one above the next free entry inserted at
    every position where that code fits the width there."""
    clear = 1 << min_code
    out, nxt, bits = [], clear + 1, min_code + 1
    for k, code in enumerate(codes):
        if 0 < k and nxt + 1 < 1 << bits:
            out.append(codes[:k] + [nxt + 1] + codes[k:])
        if code in (clear, clear + 1):
            nxt, bits = clear + 1, min_code + 1
            continue
        nxt = min(nxt + 1, 4096)
        if nxt == 1 << bits and bits < 12:
            bits += 1
    return out


def _forged_streams():
    """(files, outcomes): files whose LZW codes reach past the table (a
    code above the next entry at every position of a valid stream), long
    strings into frames of 1 to 3 pixels and a full table into frames that
    end before the codes do (and one they fill exactly), and random codes
    of every width; the return code each must give (2 for no image, 0 for
    an image, None where only the port's outcome is known)."""
    rng = np.random.default_rng(31)
    pal = _pal(rng, 16)
    files, want = [], []
    for codes in _past_the_table(forge.gif_codes(_blocky(rng, 6, 9, 16).tobytes(), 4), 4):
        files.append(_codes(codes, 4, 9, 6, pal))
        want.append(2)
    run = forge.gif_codes(bytes(4096), 2)   # strings of 1, 2, 3, ... zeros
    long_run = forge.gif_codes(bytes(200_000), 2, deferred=True)
    full = forge.gif_codes(rng.integers(0, 4, 30_000).astype(np.uint8).tobytes(), 2, True)
    for codes, w, h, rc in ((run, 1, 1, 2), (run, 2, 1, 2), (run, 3, 1, 2), (long_run, 3, 1, 2),
                            (long_run, 500, 400, 0), (long_run, 499, 400, 2),
                            (full[:-1] + [4095] * 50 + [5], 100, 300, 2)):
        files.append(_codes(codes, 2, w, h))
        want.append(rc)
    for i in range(300):
        m = int(rng.integers(2, 12))
        codes = [1 << m] + [int(c) for c in rng.integers(0, 1 << min(12, m + 3), 60)]
        files.append(_codes(codes, m, int(rng.integers(1, 8)), int(rng.integers(1, 8))))
        want.append(None)
    return files, want


def test_forged_codes_stay_inside_the_frame_under_asan(tmp_path):
    """gif.cpp built with -fsanitize=address,undefined (which aborts on the
    first read or write past a buffer, or undefined shift) decodes every
    forged stream into a buffer of exactly the image's size: the driver
    ends cleanly, and each file's outcome is the port's. A code past the
    table gives no image, and so does a string past the frame's last pixel,
    without a byte written after the frame."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    src = tmp_path / "driver.cpp"
    src.write_text(_DRIVER)
    exe = tmp_path / "driver"
    subprocess.run(["g++", "-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
                    "-fno-sanitize-recover=all", "-I", str(gif._SRC.parent), str(src),
                    str(gif._SRC), "-o", str(exe)], check=True, capture_output=True, timeout=120)
    files, want = _forged_streams()
    assert want.count(2) > 40
    files += [d for d, outcome in ODD.values() if outcome != "raises"] + list(CUT_FILES.values())
    paths = []
    for i, data in enumerate(files):
        p = tmp_path / f"{i:04d}.gif"
        p.write_bytes(data)
        paths.append(str(p))
    out = subprocess.run([str(exe), *paths], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and not out.stderr, out.stderr[-4000:]
    rcs = [tuple(map(int, line.split())) for line in out.stdout.splitlines()]
    assert len(rcs) == len(files)
    for i, (data, (rc_color, rc_gray)) in enumerate(zip(files, rcs)):
        if i < len(want) and want[i] is not None:
            assert rc_color == rc_gray == want[i], i
        for color, rc in ((True, rc_color), (False, rc_gray)):
            port = _port_read(data, color)
            assert (rc == 0) == isinstance(port, np.ndarray), (i, rc, _outcome(port))


# ----------------------------------------------------------------------------
# masks against the JAX package, the forge
# ----------------------------------------------------------------------------

def _tripod(h, w):
    m = np.full((h, w), 200, np.uint8)
    m[h - h // 4:] = 0
    m[h // 2:, w // 2 - 2:w // 2 + 2] = 0
    m[1, 1] = 0
    return m


def _mask_files(h=30, w=61):
    on = (_tripod(h, w) > 0).astype(np.uint8)
    two = [[0, 0, 0], [255, 255, 255]]
    return {
        "2-entry palette": forge.gif_bytes(on, two),
        "interlaced, 87a": forge.gif_bytes(on, two, interlace=True, version=b"87a"),
        "no palette (1 white)": forge.gif_bytes(on, None),
        "frame on a white background": forge.gif_bytes(on[:-3, 2:], two, bg=1, screen=(w, h),
                                                       offset=(2, 0)),
        "masked pixels transparent on a black background": forge.gif_bytes(
            1 + on, [[0, 0, 0], [90, 0, 0], [0, 200, 0]], transparent=1, bg=0),
    }


@pytest.mark.parametrize("name", list(_mask_files()))
def test_gif_mask_matches_jax_package(tmp_path, name):
    """Each mask named mask.png, at its own size and nearest-resized up and
    down, as the JAX package's load_mask (cv2.imread + cv2.resize) gives
    it."""
    path = tmp_path / "mask.png"
    path.write_bytes(_mask_files()[name])
    for H, W in ((30, 61), (60, 122), (13, 29), (720, 1440)):
        ref = jpipe.load_mask(Config(mask_path=str(path)), H, W)
        out = images.load_mask(str(path), H, W)
        assert ref is not None and out is not None and out.dtype == bool
        np.testing.assert_array_equal(out, ref)
        assert not out.all()


def test_forge_coders_write_the_same_codes():
    """gif_lzw's C++ coder (inputs over 64 KiB) and gif_pack(gif_codes(...))
    give the same bytes, with and without the deferred clear, at minimum
    code sizes 2 and 8."""
    rng = np.random.default_rng(41)
    for m in (2, 8):
        data = _blocky(rng, 300, 301, 1 << m).tobytes()
        assert len(data) > 1 << 16
        for deferred in (False, True):
            assert forge.gif_lzw(data, m, deferred) == forge.gif_pack(
                forge.gif_codes(data, m, deferred), m)


# ----------------------------------------------------------------------------
# chip_smoke.py phase 16 (j)'s probes
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(cs.GIF_PROBES))
def test_smoke_gif_probes_are_cv2s(name, tmp_path):
    """Each probe under 2 KB of base64 (the deferred-clear one, whose table
    fills, under 9 KB), its digests those of cv2.imread of the file (colour
    in RGB order, gray; None where cv2 gives no image), and the port's
    decoder gives them."""
    b64, digests = cs.GIF_PROBES[name]
    assert len(b64) < (9000 if name == "deferred clear" else 2048), len(b64)
    path = tmp_path / "probe"
    path.write_bytes(base64.b64decode(b64))
    for kind in ("color", "gray"):
        ref = _cv2_read(path, kind == "color")
        assert not isinstance(ref, str), kind
        want = None if ref is None else hashlib.sha256(ref.tobytes()).hexdigest()
        assert want == digests[kind], kind
    cs.check_gif_probes(names=(name,))
