"""The port's pair surgery (panovlm_tpu_torch/pair_surgery.py) against the
JAX package's (panovlm_tpu/pair_surgery.py). The fixture of
tests/test_pair_surgery.py (6 frames of 64 planted features, a contiguous
pair window of 2, matched by the JAX stage's row cache) is written into
two trees; each package runs each verb on its own tree.

Tolerances, each stated at its assertion:
  * match_pairs.npz: pi, pj, extra and pair_ok equal; each row's matches
    equal as a set (the port's match slots may be ordered otherwise within
    a row, tests/test_torch_sfm.py::test_match_all_pairs_matches_jax), and
    the match distances within 1e-5;
  * rel_poses.npz of set_straight_motion: pi, pj, ok, rel_aa, rel_t,
    n_inliers and, after the same sort of each row's slots, tri_mask equal
    and tri_points within 1e-5 (float32 triangulation in another order);
  * the dump files: the same lines, numbers within 1e-6;
  * the errors: the same exception types.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from panovlm_tpu import pair_surgery as jsurgery
from panovlm_tpu.config import load_config as jload
from panovlm_tpu.pipeline import _match_pairs_cached as j_match_pairs_cached
from panovlm_tpu.pipeline import _sfm_config as j_sfm_config
from panovlm_tpu_torch import device as device_mod
from panovlm_tpu_torch import pair_surgery as tsurgery
from panovlm_tpu_torch import pipeline as tpipeline
from panovlm_tpu_torch.__main__ import main as torch_main
from panovlm_tpu_torch.config import load_config as tload
from panovlm_tpu_torch.io import artifacts, images

from sfm_graphs import planted_features

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, CAP = 6, 64


def _write_config(root):
    path = os.path.join(root, "config.txt")
    with open(path, "w") as f:
        f.write(f"image_path = {root}/images\nresult_path = {root}/result\n"
                f"frame_path = {root}/frames\nmatch_pair_path = {root}/pairs\n"
                f"num_sift = {CAP}\n")
    return path


@pytest.fixture
def trees(tmp_path):
    """Two copies of one stage state: frames_sift.npz, match_pairs.npz of the
    contiguous window (the JAX stage's row cache), one 64 x 128 PNG frame,
    camera_pose_final.txt."""
    from scipy.spatial.transform import Rotation as ScR
    root = str(tmp_path / "jax")
    uv, desc, fmask = planted_features(np.random.default_rng(0), N, CAP)
    artifacts.save_npz(os.path.join(root, "frames", "frames_sift.npz"),
                       uv=uv, desc=desc, fmask=fmask)
    cfg_path = _write_config(root)
    cfg = jload(cfg_path)
    pi = np.asarray([i for i in range(N) for j in range(i + 1, min(i + 3, N))], np.int32)
    pj = np.asarray([j for i in range(N) for j in range(i + 1, min(i + 3, N))], np.int32)
    j_match_pairs_cached(cfg, j_sfm_config(cfg, CAP), CAP, desc, fmask, pi, pj)
    os.makedirs(os.path.join(root, "images"))
    images.write_png(os.path.join(root, "images", "000000.png"), np.zeros((64, 128), np.uint8))
    R = np.stack([ScR.from_euler("y", 10 * i, degrees=True).as_matrix() for i in range(N)])
    artifacts.export_pose_t(os.path.join(cfg.sfm_result_path, "camera_pose_final.txt"), R,
                            np.zeros((N, 3)))
    port = str(tmp_path / "port")
    shutil.copytree(root, port)
    return dict(jax=cfg, port=tload(_write_config(port)), path_t=os.path.join(port, "config.txt"),
                pi=pi, pj=pj, desc=desc, fmask=fmask)


def _npz(cfg, name):
    return artifacts.load_npz(os.path.join(cfg.match_pair_path, name))


def _row_order(idx, mask):
    """Each row's slots sorted by (valid first, i, j)."""
    key = np.where(mask[..., None], idx, np.iinfo(np.int32).max)
    return np.stack([np.lexsort((key[r, :, 1], key[r, :, 0])) for r in range(len(idx))])


def _same_match_pairs(cfg_t, cfg_j):
    got, want = _npz(cfg_t, "match_pairs.npz"), _npz(cfg_j, "match_pairs.npz")
    assert sorted(got) == sorted(want)
    for k in ("pi", "pj", "extra", "pair_ok", "num_sift"):
        np.testing.assert_array_equal(got[k], want[k])
    og, ow = _row_order(got["idx"], got["mask"]), _row_order(want["idx"], want["mask"])
    take = lambda a, o: np.take_along_axis(a, o if a.ndim == 2 else o[..., None], axis=1)
    np.testing.assert_array_equal(take(got["mask"], og), take(want["mask"], ow))
    np.testing.assert_array_equal(take(got["idx"], og) * take(got["mask"], og)[..., None],
                                  take(want["idx"], ow) * take(want["mask"], ow)[..., None])
    return got, want


VERBS = {"add_pair": (5, 0), "recompute_pairs": (1, 4), "set_straight_motion": (0, 3, 2)}


@pytest.mark.parametrize("verb", sorted(VERBS))
def test_verbs_write_the_jax_artifacts(trees, verb):
    out_j = getattr(jsurgery, verb)(trees["jax"], *VERBS[verb])
    out_t = getattr(tsurgery, verb)(trees["port"], *VERBS[verb], device="cpu")
    assert sorted(out_t) == sorted(out_j)
    got, _ = _same_match_pairs(trees["port"], trees["jax"])
    assert got["extra"].sum() > 0
    if verb != "set_straight_motion":
        return
    rt, rj = _npz(trees["port"], "rel_poses.npz"), _npz(trees["jax"], "rel_poses.npz")
    assert sorted(rt) == sorted(rj)
    for k in ("pi", "pj", "ok", "rel_aa", "rel_t", "n_inliers"):
        np.testing.assert_array_equal(rt[k], rj[k])
    # the rows' slots in the order of each package's own matches
    mp_t, mp_j = _npz(trees["port"], "match_pairs.npz"), _npz(trees["jax"], "match_pairs.npz")
    rows = [int(np.nonzero((mp_t["pi"] == a) & (mp_t["pj"] == b))[0][0])
            for a, b in zip(rt["pi"], rt["pj"])]
    og = _row_order(mp_t["idx"][rows], mp_t["mask"][rows])
    ow = _row_order(mp_j["idx"][rows], mp_j["mask"][rows])
    np.testing.assert_array_equal(np.take_along_axis(rt["tri_mask"], og, 1),
                                  np.take_along_axis(rj["tri_mask"], ow, 1))
    assert np.abs(np.take_along_axis(rt["tri_points"], og[..., None], 1)
                  - np.take_along_axis(rj["tri_points"], ow[..., None], 1)).max() < 1e-5


def test_match_rows_distances_match_jax(trees):
    pi, pj = np.triu_indices(N, k=1)
    fs = artifacts.load_npz(os.path.join(trees["jax"].frame_path, "frames_sift.npz"))
    want = jsurgery._match_rows(trees["jax"], fs, pi, pj, CAP)
    got = tsurgery._match_rows(trees["port"], fs, pi, pj, CAP, torch.device("cpu"))
    np.testing.assert_array_equal(got["pair_ok"], np.asarray(want["pair_ok"]))
    og = _row_order(got["idx"], got["mask"])
    ow = _row_order(np.asarray(want["idx"]), np.asarray(want["mask"]))
    dist_t = np.take_along_axis(got["dist"], og, 1)
    dist_j = np.take_along_axis(np.asarray(want["dist"]), ow, 1)
    valid = np.take_along_axis(got["mask"], og, 1)
    assert valid.sum() > 0
    assert np.abs(dist_t - dist_j)[valid].max() < 1e-5


def _numbers(path):
    with open(path) as f:
        return [line.replace(",", " ").split() for line in f]


@pytest.mark.parametrize("dump", ["dump_relative_poses", "dump_global_poses"])
def test_dumps_match_jax(trees, dump):
    jsurgery.set_straight_motion(trees["jax"], 0, 3, 2)
    tsurgery.set_straight_motion(trees["port"], 0, 3, 2, device="cpu")
    path_j = getattr(jsurgery, dump)(trees["jax"])
    path_t = getattr(tsurgery, dump)(trees["port"], device="cpu")
    assert os.path.relpath(path_t, trees["port"].result_path) == \
        os.path.relpath(path_j, trees["jax"].result_path)
    lines_t, lines_j = _numbers(path_t), _numbers(path_j)
    assert len(lines_t) == len(lines_j) > 0
    for a, b in zip(lines_t, lines_j):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            try:
                assert abs(float(x) - float(y)) < 1e-6, (a, b)
            except ValueError:
                assert x == y


ERRORS = [
    ("add_pair", (2, 2), ValueError),
    ("add_pair", (0, 6), ValueError),
    ("recompute_pairs", (-1, 3), ValueError),
    ("recompute_pairs", (4, 2), ValueError),
    ("set_straight_motion", (3, 3, 2), ValueError),
    ("set_straight_motion", (0, 3, 0), ValueError),
]


@pytest.mark.parametrize("verb,args,exc", ERRORS)
def test_errors_match_jax(trees, verb, args, exc):
    with pytest.raises(exc):
        getattr(jsurgery, verb)(trees["jax"], *args)
    with pytest.raises(exc):
        getattr(tsurgery, verb)(trees["port"], *args, device="cpu")


@pytest.mark.parametrize("verb,args", [("add_pair", (0, 1)), ("recompute_pairs", (0, 1)),
                                       ("set_straight_motion", (0, 1, 1)),
                                       ("dump_relative_poses", ()), ("dump_global_poses", ())])
def test_missing_artifacts_raise_after_resolving_the_device(tmp_path, monkeypatch, verb, args):
    """On a tree without artifacts both packages raise FileNotFoundError; the
    port's verb has turned its device into a torch.device through
    device.resolve first (ROADMAP F11: a library caller gets the CPU math
    set up as the CLI does)."""
    from panovlm_tpu.config import Config as JConfig
    from panovlm_tpu_torch.config import Config as TConfig
    kw = dict(frame_path=str(tmp_path / "f"), match_pair_path=str(tmp_path / "p"),
              result_path=str(tmp_path / "r"))
    with pytest.raises(FileNotFoundError):
        getattr(jsurgery, verb)(JConfig(**kw), *args)
    calls = []
    resolve = device_mod.resolve
    monkeypatch.setattr(device_mod, "resolve", lambda d: calls.append(d) or resolve(d))
    with pytest.raises(FileNotFoundError):
        getattr(tsurgery, verb)(TConfig(**kw), *args, device="cpu")
    assert calls == ["cpu"]


def test_stage_functions_resolve_their_device(monkeypatch):
    """Each stage function of pipeline.py goes through device.resolve."""
    calls = []

    class Stop(Exception):
        pass

    def fake(d):
        calls.append(d)
        raise Stop()
    monkeypatch.setattr(device_mod, "resolve", fake)
    from panovlm_tpu_torch.config import Config
    for stage in ("init_camera_pose", "init_lidar_pose", "joint_optimization",
                  "colorize_lidar_map", "joint_mvs"):
        with pytest.raises(Stop):
            getattr(tpipeline, stage)(Config(), device="cpu")
    assert calls == ["cpu"] * 5


@pytest.mark.parametrize("verb", ["add_pair", "recompute_pairs", "set_straight_motion",
                                  "dump_relative_poses", "dump_global_poses"])
def test_cli_runs_each_verb(trees, verb):
    """python -m panovlm_tpu_torch <verb> <config> ... --device cpu, in
    process; the same artifacts as the JAX verb's."""
    args = {"add_pair": ["5", "0"], "recompute_pairs": ["1", "4"],
            "set_straight_motion": ["0", "3", "2"]}.get(verb, [])
    if verb.startswith("dump"):
        jsurgery.set_straight_motion(trees["jax"], 0, 3, 2)
        tsurgery.set_straight_motion(trees["port"], 0, 3, 2, device="cpu")
    else:
        getattr(jsurgery, verb)(trees["jax"], *map(int, args))
    assert torch_main([verb, trees["path_t"], *args, "--device", "cpu"]) == 0
    if verb.startswith("dump"):
        name = "relative_poses.txt" if "relative" in verb else "global_poses.txt"
        path_t = os.path.join(trees["port"].sfm_result_path, name)
        path_j = os.path.join(trees["jax"].sfm_result_path, name)
        getattr(jsurgery, verb)(trees["jax"])
        assert len(_numbers(path_t)) == len(_numbers(path_j)) > 0
    else:
        _same_match_pairs(trees["port"], trees["jax"])


def test_cli_module_and_its_usage_errors(trees):
    """`python -m panovlm_tpu_torch` in a subprocess writes the dump; a
    verb with the wrong arguments exits 2 with its usage."""
    out = subprocess.run([sys.executable, "-m", "panovlm_tpu_torch", "dump_global_poses",
                          trees["path_t"], str(os.path.join(trees["port"].result_path, "g.txt")),
                          "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert len(open(os.path.join(trees["port"].result_path, "g.txt")).readlines()) == N
    for argv in (["add_pair", trees["path_t"], "1"], ["add_pair", trees["path_t"], "a", "b"],
                 ["dump_global_poses", trees["path_t"], "x", "y"],
                 ["init_camera_pose", trees["path_t"], "1"]):
        with pytest.raises(SystemExit) as e:
            torch_main(argv + ["--device", "cpu"])
        assert e.value.code == 2


def test_the_stage_cache_keeps_the_surgery_rows(trees, monkeypatch):
    """After add_pair and recompute_pairs, the port's _match_pairs_cached
    on the proposer's pairs matches nothing, reuses every row and appends
    the extra ones in their stored order, as the JAX function does."""
    from panovlm_tpu_torch.models import sfm as tsfm
    tsurgery.add_pair(trees["port"], 5, 0, device="cpu")
    tsurgery.recompute_pairs(trees["port"], 1, 4, device="cpu")
    jsurgery.add_pair(trees["jax"], 5, 0)
    jsurgery.recompute_pairs(trees["jax"], 1, 4)
    args = (CAP, trees["desc"], trees["fmask"], trees["pi"], trees["pj"])
    pi_j, pj_j, m_j = j_match_pairs_cached(trees["jax"], j_sfm_config(trees["jax"], CAP), *args)
    stored = _npz(trees["port"], "match_pairs.npz")
    monkeypatch.setattr(tsfm, "match_all_pairs", lambda *a, **k: pytest.fail("re-matched"))
    pi_t, pj_t, m_t = tpipeline._match_pairs_cached(
        trees["port"], tpipeline._sfm_config(trees["port"], CAP), CAP,
        torch.from_numpy(trees["desc"]), torch.from_numpy(trees["fmask"]),
        trees["pi"], trees["pj"])
    np.testing.assert_array_equal(pi_t, pi_j)
    np.testing.assert_array_equal(pj_t, pj_j)
    np.testing.assert_array_equal(m_t["pair_ok"], np.asarray(m_j["pair_ok"]))
    assert {(0, 5), (1, 3), (1, 4), (2, 4)} <= set(zip(pi_t.tolist(), pj_t.tolist()))
    rows = {(int(a), int(b)): r for r, (a, b) in enumerate(zip(stored["pi"], stored["pj"]))}
    for k, (a, b) in enumerate(zip(pi_t, pj_t)):
        np.testing.assert_array_equal(m_t["idx"][k], stored["idx"][rows[(int(a), int(b))]])
    # the rewritten cache flags only the pairs the proposer does not emit
    assert stored["extra"].sum() == 7
    _same_match_pairs(trees["port"], trees["jax"])
    assert _npz(trees["port"], "match_pairs.npz")["extra"].sum() == 2   # (0, 5), (1, 4)
