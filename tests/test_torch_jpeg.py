"""The port's baseline JPEG encoder (panovlm_tpu_torch/io/jpeg.py, ROADMAP
F10) against cv2.imwrite at its defaults (quality 95, 4:2:0), both decoded
by cv2.imdecode: on the SfM stage's depth visualisation (a 128 x 256 depth
colour map blended with the panorama), a gray panorama and a colour crop
of odd size (partial MCUs), the decoded images differ by at most 0.5 in
mean absolute value and 8 at any pixel. The quantisation and Huffman
tables are cv2's byte for byte.
"""

import struct

import numpy as np
import pytest
import torch

from panovlm_tpu_torch.io import jpeg
from panovlm_tpu_torch.utils import visualization as viz

from synthetic import render_panorama

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)


def _images():
    gray, depth = render_panorama((0.3, -0.2, 0.1), 128, 256)
    color = viz.depth_to_color(depth, 10.0)                       # BGR, as the stage
    blend = (0.5 * color + 0.5 * (gray[..., None] * 255)).astype(np.uint8)
    return {"depth_blend": blend, "gray": (gray * 255).astype(np.uint8),
            "odd_crop": blend[:77, :203]}


def _segments(data: bytes):
    out, i = {}, 2
    while i < len(data):
        marker, length = struct.unpack(">HH", data[i:i + 4])
        out.setdefault(marker, []).append(data[i + 4:i + 2 + length])
        if marker == 0xFFDA:
            break
        i += 2 + length
    return out


@pytest.mark.parametrize("name", ["depth_blend", "gray", "odd_crop"])
def test_jpeg_decodes_like_cv2_encoding(name, tmp_path):
    img = _images()[name]
    path = str(tmp_path / "depth_0.jpg")
    # the stage hands the encoder RGB; cv2.imwrite takes BGR
    jpeg.write_jpeg(path, img[..., ::-1] if img.ndim == 3 else img)
    mine = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    ok, ref = cv2.imencode(".jpg", img)
    assert ok
    ref_img = cv2.imdecode(ref, cv2.IMREAD_UNCHANGED)
    assert mine.shape == img.shape
    diff = np.abs(mine.astype(np.int64) - ref_img.astype(np.int64))
    assert diff.mean() <= 0.5 and diff.max() <= 8, (diff.mean(), diff.max())
    with open(path, "rb") as f:
        seg_m = _segments(f.read())
    seg_r = _segments(ref.tobytes())
    for marker in (0xFFDB, 0xFFC4):      # quantisation and Huffman tables
        assert b"".join(seg_m[marker]) == b"".join(seg_r[marker]), hex(marker)


def test_jpeg_rejects_other_inputs():
    with pytest.raises(ValueError):
        jpeg.encode(np.zeros((8, 8), np.float32))
    with pytest.raises(ValueError):
        jpeg.encode(np.zeros((8, 8, 4), np.uint8))
