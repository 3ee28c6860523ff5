"""The operation counts behind chip_smoke.py's bounds, on hand-worked
shapes: K3 (each operation counted once at the level of the indices its
value depends on) and K1 at D = 128 (the fused search: 3xTF32 tensor-core
products plus an fp32 epilogue), with the earlier counts beside them; K1/K2
(the masks and the valid points read, every query's outputs written, 3D+3
operations per valid pair and one more with the ring minimum; the
earlier count of every point and pair beside it). Exact integer counts; the
bounds in ms to 1e-3 relative (the published peaks)."""

import os
import sys

import pytest
import torch

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


def test_knn_valid_pairs_and_bounds():
    # batch element 0: 2 of 3 queries and 3 of 4 targets valid; element 1:
    # 1 query and all 4 targets -> 3 valid queries, 7 valid targets and
    # 2*3 + 1*4 = 10 valid pairs of 24
    qm = torch.tensor([[True, False, True], [False, True, False]])
    tm = torch.tensor([[True, True, False, True], [True, True, True, True]])
    valid = cs.knn_valid_counts(qm, tm)
    assert valid == (3, 7, 10)
    # bytes: 2 x (3 + 4) mask bytes, 12 bytes for each of the 10 valid
    # points, 3 queries x 2 slots x 8 bytes per element; 12 operations a pair
    n_bytes = 2 * 7 + 10 * 12 + 2 * 3 * 2 * 8
    ms, by = cs._knn_bound(2, 3, 4, 3, 2, False, valid)
    assert by == "bytes" and ms == pytest.approx(n_bytes / 3.35e12 * 1e3, rel=1e-12)
    # with the ring: a 4-byte ring id per valid point, 4 more output slots
    ms, by = cs._knn_bound(2, 3, 4, 3, 2, True, valid)
    assert ms == pytest.approx((2 * 7 + 10 * 16 + 2 * 3 * 6 * 8) / 3.35e12 * 1e3, rel=1e-12)
    # the earlier count (bound_ms_pr4): every point's 13 (17 with the ring) bytes
    ms4, _ = cs._knn_bound(2, 3, 4, 3, 2, False)
    assert ms4 == pytest.approx((2 * 7 * 13 + 2 * 3 * 2 * 8) / 3.35e12 * 1e3, rel=1e-12)
    ms4, _ = cs._knn_bound(2, 3, 4, 3, 2, True)
    assert ms4 == pytest.approx((2 * 7 * 17 + 2 * 3 * 6 * 8) / 3.35e12 * 1e3, rel=1e-12)
    # K1 at the stage's shape, 1,024 queries and targets with ~9.5 % of each
    # valid: the outputs of every query set the bound, not the pairs
    B, n = 3674, 97
    valid = (B * n, B * n, B * n * n)
    ms, by = cs._knn_bound(B, 1024, 1024, 3, 5, False, valid)
    n_bytes = B * 2048 + 2 * B * n * 12 + B * 1024 * 5 * 8
    assert by == "bytes" and ms == pytest.approx(n_bytes / 3.35e12 * 1e3, rel=1e-12)
    # the stage's K2 shape: 3,500 pairs of Q=512, T=4096; 75 % of the queries
    # and 92 % of the targets valid against the earlier count of every pair
    pairs = 3500 * 384 * 3768
    ms, by = cs._knn_bound(3500, 512, 4096, 3, 10, True, (3500 * 384, 3500 * 3768, pairs))
    assert by == "operations" and ms == pytest.approx(pairs * 13 / 67e12 * 1e3, rel=1e-12)
    ms4, by4 = cs._knn_bound(3500, 512, 4096, 3, 10, True)
    assert by4 == "operations" and ms4 == pytest.approx(1.4233, rel=1e-3)
