"""The operation counts behind chip_smoke.py's bounds, on hand-worked
shapes: K3 (each operation counted once at the level of the indices its
value depends on) and K1 at D = 128 (the fused search: 3xTF32 tensor-core
products plus an fp32 epilogue), with the PR 3 counts beside them. Exact
integer counts; the bounds in ms to 1e-3 relative (the published peaks)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def test_volscore_operations_per_level():
    # V=2 views, C=3 candidates, T=5 texels, a 2 x 4 image (8 pixels)
    assert cs.volscore_ops(2, 3, 5, 2, 4) == {
        "pixel texel": 8 * 5 * 4,                      # 160
        "candidate pixel texel": 3 * 8 * 5 * 23,       # 2760
        "view candidate pixel texel": 6 * 8 * 5 * 9,   # 2160
        "candidate pixel": 3 * 8 * 14,                 # 336
        "view candidate pixel": 6 * 8 * 15,            # 720
    }
    # bf16 volume 2*16*8*2, depth + normals 3*8*16, rays + gray 8*16, costs 6*8*4
    assert cs._volscore_bytes(2, 16, 3, 2, 4) == 512 + 384 + 128 + 192


def test_volscore_bounds_at_the_room_full_scoring_shape():
    # V=4, C=2, T=49, D=64 at 720 x 1440: 49*4 + 2*49*23 + 8*49*9 + 2*14 +
    # 8*15 = 6126 operations per pixel against the PR 3 count's
    # 8 * (49 * 36 + 21) = 14280; the bytes (volume 512, depth + normals 32,
    # rays + gray 16, costs 32 per pixel) bound the recounted work
    HW = 720 * 1440
    assert sum(cs.volscore_ops(4, 2, 49, 720, 1440).values()) == 6126 * HW
    ms, by = cs._volscore_bound(4, 64, 2, 49, 720, 1440)
    assert by == "bytes" and ms == pytest.approx(HW * 592 / 3.35e12 * 1e3, rel=1e-9)
    ms3, by3 = cs._volscore_bound(4, 64, 2, 49, 720, 1440, pr3=True)
    assert by3 == "operations" and ms3 == pytest.approx(0.2210, rel=1e-3)


def test_knn_mutual_work_and_bounds():
    # B=1, Q=2, T=3, D=8: bytes (2+3)*(32+1) + 2*2*8 + 3*8; tensor-core
    # operations 2*3*8*6; fp32 operations 2*3*6 + (2+3)*2*8
    assert cs.knn_mutual_work(1, 2, 3, 8) == (165 + 32 + 24, 288, 36 + 80)
    # the Room matching batch: 16 pairs of 8096 x 8096 at D = 128
    ms, by = cs.knn_mutual_bound(16, 8096, 8096, 128)
    assert by == "operations" and ms == pytest.approx(1.6271 + 0.0949, rel=1e-3)
    ms3, by3 = cs.knn_mutual_bound(16, 8096, 8096, 128, pr3=True)
    assert by3 == "operations" and ms3 == pytest.approx(2 * 4.1008, rel=1e-3)
