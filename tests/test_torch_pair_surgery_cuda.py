"""Pair surgery and the translation-averaging methods on the card against
the CPU (marked `cuda`: they skip where torch.cuda.is_available() is
false). No jax and no conftest fixtures, so they run on the machine with
the card:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_pair_surgery_cuda.py

recompute_pairs on the card (the fused descriptor search, csrc/knn_desc.cu)
writes the CPU run's pairs and flags, with each row's matches equal as a
set; chordal, lud, bata and l1 on the seeded graph of
tests/test_torch_translation_averaging.py give the CPU's translations and
scales within 1e-4 from the same DLT init, and a second card run the same
bits.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from sfm_graphs import planted_features, translation_graph  # noqa: E402

torch.set_num_threads(2)
N, CAP = 16, 512


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from panovlm_tpu_torch.device import resolve
    return resolve("cuda")


def _tree(root):
    """frames_sift.npz of 16 frames of planted features and the stage's
    match_pairs.npz for a contiguous window of 2, matched on the CPU."""
    from panovlm_tpu_torch import pipeline
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.io import artifacts
    uv, desc, fmask = planted_features(np.random.default_rng(0), N, CAP)
    artifacts.save_npz(os.path.join(root, "frames", "frames_sift.npz"),
                       uv=uv, desc=desc, fmask=fmask)
    path = os.path.join(root, "config.txt")
    with open(path, "w") as f:
        f.write(f"result_path = {root}/result\nframe_path = {root}/frames\n"
                f"match_pair_path = {root}/pairs\nnum_sift = {CAP}\n")
    cfg = load_config(path)
    pi = np.asarray([i for i in range(N) for j in range(i + 1, min(i + 3, N))], np.int32)
    pj = np.asarray([j for i in range(N) for j in range(i + 1, min(i + 3, N))], np.int32)
    pipeline._match_pairs_cached(cfg, pipeline._sfm_config(cfg, CAP), CAP,
                                 torch.from_numpy(desc), torch.from_numpy(fmask), pi, pj)
    return path


def _sorted_rows(idx, mask):
    key = np.where(mask[..., None], idx, np.iinfo(np.int32).max)
    return np.stack([key[r][np.lexsort((key[r, :, 1], key[r, :, 0]))]
                     for r in range(len(idx))])


@pytest.mark.cuda
def test_recompute_pairs_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    from panovlm_tpu_torch import pair_surgery
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.io import artifacts
    from panovlm_tpu_torch.ops import knn as knn_mod
    cpu = _tree(str(tmp_path / "cpu"))
    card = str(tmp_path / "card" / "config.txt")
    shutil.copytree(os.path.dirname(cpu), os.path.dirname(card))
    with open(card) as f:
        text = f.read().replace(str(tmp_path / "cpu"), str(tmp_path / "card"))
    with open(card, "w") as f:
        f.write(text)
    pair_surgery.recompute_pairs(load_config(cpu), 0, N - 1, device="cpu")
    knn_mod.knn_mutual.launches = 0
    pair_surgery.recompute_pairs(load_config(card), 0, N - 1, device=cuda_device)
    n_pairs = N * (N - 1) // 2
    assert knn_mod.knn_mutual.launches == -(-n_pairs // 16)
    got = artifacts.load_npz(os.path.join(str(tmp_path / "card"), "pairs", "match_pairs.npz"))
    want = artifacts.load_npz(os.path.join(str(tmp_path / "cpu"), "pairs", "match_pairs.npz"))
    for k in ("pi", "pj", "extra", "pair_ok"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["pair_ok"].sum() > len(got["pair_ok"]) // 2     # 119 of 120 on the CPU
    np.testing.assert_array_equal(_sorted_rows(got["idx"], got["mask"]),
                                  _sorted_rows(want["idx"], want["mask"]))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["chordal", "lud", "bata", "l1"])
def test_methods_on_the_card_equal_the_cpu(cuda_device, method, monkeypatch):
    """Both start from the CPU's DLT (its global scale is rounding-bound,
    tests/test_torch_translation_averaging.py)."""
    from panovlm_tpu_torch.models import translation_averaging as ta
    aa, C, pi, pj, rel_aa, u, scale = translation_graph()
    scales = scale.copy()
    scales[::4] = -1.0
    args = (aa, pi, pj, rel_aa, u, scales)
    dlt = ta.translation_averaging_dlt(*args[:5], device="cpu")
    monkeypatch.setattr(ta, "translation_averaging_dlt",
                        lambda *a, **k: tuple(x.copy() for x in dlt))
    t_c, s_c = ta.translation_averaging(*args, method=method, device="cpu")
    t_g, s_g = ta.translation_averaging(*args, method=method, device=cuda_device)
    assert np.abs(t_g - t_c).max() < 1e-4 and np.abs(s_g - s_c).max() < 1e-4
    t_2, s_2 = ta.translation_averaging(*args, method=method, device=cuda_device)
    assert t_2.tobytes() == t_g.tobytes() and s_2.tobytes() == s_g.tobytes()
