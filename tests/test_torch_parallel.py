"""The port's multi-rank path (`panovlm_tpu_torch/parallel/`, the group
argument of `solve_lm`, `estimate_poses`, `joint_optimize` and the stages)
on the CPU over gloo, mirroring tests/test_parallel.py.

One spawn per world size (1, 2 and 4 ranks, `tests/torch_ranks.py`) runs
every case on every rank, and the test functions read its results; two
more single ranks run the stage and the port without a group. The module
fixture starts them all at once and computes the JAX package's references
meanwhile. Each rank joins its group through a file store with a 120 s
timeout, and each spawn is joined with a deadline that kills its ranks and
fails the tests that read it: a hang fails tests, it does not run into the
suite's clock.

What is held, and to what:
  * every output of the group path is the same bits at world sizes 1, 2
    and 4 (rows evaluated in chunks that every world size shares, summed
    exactly by `ops/exact.py`, whatever the split);
  * the sharded solve of test_parallel.py's plane problem within 5e-5 of
    the port without a group (whose costs are float sums) and of the JAX
    package's sharded solve (on the 8-device CPU mesh of
    tests/conftest.py);
  * the halo association (8 scans, window 2, both directions): the JAX
    function's pair list and valid mask on a mesh of the same size, and
    rows bit-equal to the port's `associate_all_pairs` on the same pairs;
  * `estimate_poses` on test_parallel.py's 8 scans: bit for bit the port
    without a group solving as a group does (`OdometryConfig.
    sharded_solve`: the same pair chunks, exact costs), and within 2e-4 of
    the port's default single-process run; against the JAX package's
    `mesh=make_mesh()` run,
    test_torch_odometry.py's bounds (5 mm, 0.1 deg per scan: the JAX side
    associates with XLA's packed-key KNN, ROADMAP F3; its single-device
    side is F1-red);
  * `joint_optimize` on make_joint_scene's arguments: bit for bit the port
    without a group solving as a group does (`JointConfig.sharded_solve`);
    within 2e-3 of the port's own single-rank solve, which eliminates the
    points, and of the JAX package's sharded `joint_optimize` on the
    8-device CPU mesh (the tolerance of test_parallel.py's joint test);
  * `joint_mvs` on a 4-frame 64 x 128 dataset: every artifact and the fused
    cloud bit-equal at every world size;
  * `init_lidar_pose` through `python -m torch.distributed.run
    --nproc-per-node 2 ... --device cpu`: pose files equal to the 1-rank
    group's.
"""

import glob
import os
import pickle
import shutil
import socket
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import make_dataset, make_trajectory_scans
from test_camera_lidar import make_joint_scene
from test_torch_mvs_stage import ROOM_MVS_KEYS, _joint_poses
from test_torch_odometry import _seed_sfm_poses
from panovlm_tpu.config import load_config as jload_config
from panovlm_tpu.models import camera_lidar as jcl
from panovlm_tpu.models import lidar_odometry as jlo
from panovlm_tpu.parallel import halo as jhalo
from panovlm_tpu.parallel import make_mesh as jmake_mesh
from panovlm_tpu.parallel import multihost as jmultihost
from panovlm_tpu.parallel import replicated as jreplicated
from panovlm_tpu.parallel import shard_leading_axis as jshard
from panovlm_tpu.sensors import velodyne as jvd
from panovlm_tpu.solver import LMOptions as JLMOptions
from panovlm_tpu.solver import ResidualBlock as JResidualBlock
from panovlm_tpu.solver import residuals as jres
from panovlm_tpu.solver import solve_lm as jsolve_lm
from panovlm_tpu_torch import interop
from panovlm_tpu_torch.device import resolve
from panovlm_tpu_torch.models import association as tassoc
from panovlm_tpu_torch.parallel import (halo, make_mesh, multihost, pad_leading_to_multiple,
                                        shard_blocks)
from panovlm_tpu_torch.utils import poses as pose_util

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLDS = (1, 2, 4)
GROUP_CASES = ("mesh", "solve", "halo", "odometry", "joint", "mvs")
# name: (world size, cases, whether the cases get the group)
SPAWNS = {**{f"w{w}": (w, GROUP_CASES, True) for w in WORLDS},
          "stage": (1, ("stage",), True),     # 2 ranks: the torchrun test
          "single": (1, ("solve", "odometry", "odometry_sharded", "joint", "joint_sharded"),
                     False)}
DEADLINE_S = 300          # from the fixture's start, for every spawn
N_SCANS, WINDOW = 8, 2
ODOMETRY = dict(num_iteration_lidar=2, max_lm_iters=8)
JOINT = dict(num_iteration_joint=2, lidar_weight=0.01, camera_lidar_weight=5.0)
POSE_FILES = ("lidar_pose_refined.txt", "lidar_pose_undis_refined.txt")


def _plane_problem(rng):
    """tests/test_parallel.py::test_sharded_solve_matches_unsharded's inputs."""
    n_obs = 1024
    planes = np.array([[1, 0, 0, -2.0], [0, 1, 0, -1.5], [0, 0, 1, -3.0]], np.float32)
    pl = planes[rng.integers(0, 3, n_obs)]
    pts_w = rng.uniform(-2, 2, (n_obs, 3)).astype(np.float32)
    pts_w -= ((pts_w * pl[:, :3]).sum(1) + pl[:, 3])[:, None] * pl[:, :3]
    gt = np.zeros((4, 6), np.float32)
    gt[:, 3] = np.arange(4) * 0.1
    pair_r = rng.integers(0, 4, n_obs).astype(np.int32)
    pair_n = ((pair_r + 1) % 4).astype(np.int32)
    pts_n = pts_w + gt[pair_n][:, 3:]
    pl_r = pl.copy()
    pl_r[:, 3] = pl[:, 3] - (pl[:, :3] * gt[pair_r][:, 3:]).sum(1)
    poses0 = gt + rng.normal(size=gt.shape).astype(np.float32) * 0.02
    poses0[0] = gt[0]
    fixed = np.zeros((4, 6), bool)
    fixed[0] = True
    return dict(pair_r=pair_r, pair_n=pair_n, pts_n=pts_n, pl_r=pl_r, poses0=poses0,
                fixed=fixed, gt=gt)


def _jax_sharded_solve(p):
    """The JAX package's solve with its observations sharded over the
    8-device CPU mesh, as test_parallel.py runs it."""
    n = len(p["pair_r"])

    def solve(pair_r, pair_n, pts_n, pl_r, poses0):
        block = JResidualBlock(jres.point2plane_meter, ("poses", "poses"), (pair_r, pair_n),
                               (pts_n, pl_r), jnp.ones((n,), jnp.float32),
                               jnp.ones((n,), bool), loss="huber", loss_scale=0.2)
        out, _ = jsolve_lm({"poses": poses0}, (block,), {"poses": jnp.asarray(p["fixed"])},
                           JLMOptions(max_iters=8, cg_iters=25))
        return out["poses"]

    mesh = jmake_mesh()
    obs = jshard(tuple(jnp.asarray(p[k]) for k in ("pair_r", "pair_n", "pts_n", "pl_r")), mesh)
    return np.asarray(jax.jit(solve)(*obs, jreplicated(jnp.asarray(p["poses0"]), mesh)))


def _scans():
    """test_parallel.py's 8 scans through the JAX feature extraction (the
    port is bit-equal to it, tests/test_torch_velodyne.py), and the rough
    t_lw of a +x walk."""
    scans, _ = make_trajectory_scans(n_scans=N_SCANS, step=(0.2, 0.05, 0.0), yaw_step=0.03,
                                     noise=0.002, h_steps=450)
    feats = []
    for pts_lidar in scans:
        pts, _ = jvd.preprocess_cloud(pts_lidar)
        p, m = jvd.pad_points(pts, 8192)
        feats.append(jvd.extract_features(jnp.asarray(p), jnp.asarray(m))[0])
    batch = {k: np.asarray(v) for k, v in jlo.stack_features(feats).items()}
    poses = np.zeros((N_SCANS, 6), np.float32)
    poses[:, 3] = -np.arange(N_SCANS) * 0.2
    return batch, poses


def _dataset_copy(src, dst):
    shutil.copytree(src, dst)
    path = os.path.join(dst, "config.txt")
    with open(path) as f:
        text = f.read().replace(src, dst)
    with open(path, "w") as f:
        f.write(text)
    return dst


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Spawns:
    """Every spawn's ranks, started together; `result(name)` joins one
    spawn's ranks (before the shared deadline) and returns their outputs in
    rank order, or fails the calling test."""

    def __init__(self, d, t0):
        self.d, self.t0, self.done = d, t0, {}
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        env.pop("XLA_FLAGS", None)
        self.procs = {}
        for name, (world, _, _) in SPAWNS.items():
            self.procs[name] = []
            for r in range(world):
                log = open(os.path.join(d, f"log_{name}_{r}.txt"), "w")
                self.procs[name].append((subprocess.Popen(
                    [sys.executable, os.path.join(HERE, "torch_ranks.py"), d, name, str(world),
                     str(r)], cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))

    def _tail(self, name, r):
        with open(os.path.join(self.d, f"log_{name}_{r}.txt")) as f:
            return f.read()[-3000:]

    def result(self, name):
        if name not in self.done:
            self.done[name] = self._join(name)
        if isinstance(self.done[name], str):
            pytest.fail(self.done[name])
        return self.done[name]

    def _join(self, name):
        procs = self.procs[name]
        while any(p.poll() is None for p, _ in procs):
            bad = [r for r, (p, _) in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.time() - self.t0 > DEADLINE_S:
                self.kill(name)
                r = bad[0] if bad else 0
                why = f"rank {r} failed" if bad else f"no end after {DEADLINE_S} s"
                return f"spawn {name}: {why}:\n{self._tail(name, r)}"
            time.sleep(0.2)
        for r, (p, log) in enumerate(procs):
            log.close()
            if p.returncode:
                return f"spawn {name}: rank {r} exited {p.returncode}:\n{self._tail(name, r)}"
        out = []
        for r in range(len(procs)):
            with open(os.path.join(self.d, f"out_{name}_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out

    def kill(self, name=None):
        for n in ([name] if name else list(self.procs)):
            for p, log in self.procs[n]:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    t0 = time.time()
    d = str(tmp_path_factory.mktemp("ranks"))
    rng = np.random.default_rng(0)
    plane = _plane_problem(rng)
    batch, poses = _scans()
    poses0 = poses.copy()
    poses0[1:, :3] += 0.01   # perturbed, so that the solve has real work
    jscene = make_joint_scene(rng)
    scene = {k: ({kk: np.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
                 else np.asarray(v)) for k, v in jscene.items()}
    mvs_root = str(tmp_path_factory.mktemp("mvs") / "data")
    cfg_path, gt = make_dataset(mvs_root, n_frames=4, H=64, W=128, h_steps=900,
                                config_overrides=ROOM_MVS_KEYS)
    jcfg = jload_config(cfg_path)
    os.makedirs(jcfg.joint_result_path)
    _joint_poses(jcfg, gt)
    stage_root = str(tmp_path_factory.mktemp("stage") / "data")
    _, stage_gt = make_dataset(stage_root, n_frames=5, h_steps=450,
                               config_overrides="num_iteration_lidar = 2\n")
    _seed_sfm_poses(os.path.join(stage_root, "result"), stage_gt)
    for w in WORLDS:
        _dataset_copy(mvs_root, os.path.join(d, f"w{w}", "mvs"))
    _dataset_copy(stage_root, os.path.join(d, "stage", "stage"))
    torchrun_dir = _dataset_copy(stage_root, os.path.join(d, "torchrun"))
    joint = dict(scene=scene, config=JOINT)
    odometry = dict(batch=batch, poses=poses0, valid=np.ones(N_SCANS, bool), config=ODOMETRY)
    inputs = {"cases": {"solve": plane,
                        "halo": dict(batch=batch, poses=poses, window=WINDOW),
                        "odometry": odometry, "odometry_sharded": odometry,
                        "joint": joint, "joint_sharded": joint, "mvs": {}, "mesh": {},
                        "stage": {}},
              "spawns": {name: {"cases": cases, "group": g}
                         for name, (_, cases, g) in SPAWNS.items()}}
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    spawns = _Spawns(d, t0)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    torchrun_log = open(os.path.join(d, "torchrun.txt"), "w")
    torchrun = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", port, "-m", "panovlm_tpu_torch",
         "init_lidar_pose", os.path.join(torchrun_dir, "config.txt"), "--device", "cpu"],
        cwd=ROOT, env=env, stdout=torchrun_log, stderr=subprocess.STDOUT)
    try:
        # the JAX package's references, while the ranks run
        mesh = jmake_mesh()
        jax_odo, jax_infos = jlo.estimate_poses(
            {k: jnp.asarray(v) for k, v in batch.items()}, poses0, np.ones(N_SCANS, bool),
            jlo.OdometryConfig(**ODOMETRY), mesh=mesh)
        jcam, jlid, _, _ = jcl.joint_optimize(
            jscene["arc_batch"], jscene["lidar_batch"], jscene["cam_gt"], jscene["lid0"],
            jscene["timg"], jscene["tfeat"], jscene["tmask"], jscene["bearings"],
            jscene["pts3d"], np.ones(len(scene["pts3d"]), bool), jcl.JointConfig(**JOINT),
            mesh=mesh)
        ref = {"solve_jax": _jax_sharded_solve(plane), "odometry_jax": np.asarray(jax_odo),
               "joint_jax": {"cam": np.asarray(jcam), "lidar": np.asarray(jlid)},
               "halo_jax": {}}
        for w in WORLDS[1:]:
            _, pr, pn, pv = jhalo.associate_windowed_sharded(
                {k: jnp.asarray(v) for k, v in batch.items()}, poses, n_scans=N_SCANS,
                window=WINDOW, mesh=jmake_mesh(w), bidirectional=True)
            ref["halo_jax"][w] = tuple(np.asarray(a) for a in (pr, pn, pv))
        torchrun.wait(timeout=max(1, DEADLINE_S - (time.time() - t0)))
    except BaseException:
        spawns.kill()
        raise
    finally:
        if torchrun.poll() is None:
            torchrun.kill()
            torchrun.wait()
        torchrun_log.close()
    with open(os.path.join(d, "torchrun.txt")) as f:
        torchrun_out = (torchrun.returncode, f.read()[-3000:])
    yield dict(d=d, spawns=spawns, ref=ref, inputs=inputs["cases"], jax_infos=jax_infos,
               torchrun=torchrun_out, torchrun_dir=torchrun_dir, gt=gt)
    spawns.kill()


def _ranks(runs, w):
    return runs["spawns"].result(f"w{w}")


def _single(runs, case):
    """The port without a group."""
    return runs["spawns"].result("single")[0][case]


def _same_bits(a, b, what):
    """Equal as bits (NaN where NaN), for nested dicts / lists of arrays."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same_bits(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same_bits(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what
    else:
        assert a == b, what


# ---------------------------------------------------------------------------
# multihost: the split, the set-up, the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(454, 4), (24, 8), (7, 3), (3, 8), (0, 4), (1724, 16)])
def test_process_slice_partition(n, k):
    """Balanced contiguous partition, each item once, sizes within one,
    and JAX's split exactly (test_parallel.py:239-251)."""
    slices = [multihost.process_slice(n, p, k) for p in range(k)]
    items = [i for s in slices for i in range(s.start, s.stop)]
    assert items == list(range(n))
    sizes = [s.stop - s.start for s in slices]
    assert max(sizes) - min(sizes) <= 1
    assert slices == [jmultihost.process_slice(n, p, k) for p in range(k)]


def test_process_slice_single_process_is_everything():
    assert multihost.process_slice(17) == slice(0, 17)


def test_initialize_distributed_noop_without_the_environment(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize_distributed("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize_distributed("cpu") is False
    assert not torch.distributed.is_initialized()
    assert make_mesh("cpu") is None


def test_hybrid_mesh_single_host(runs):
    """On one host the (frame, data) mesh is (1, world), on every rank."""
    for w in WORLDS:
        for r, out in enumerate(_ranks(runs, w)):
            assert out["mesh"] == {"shape": (1, w), "names": ("frame", "data"),
                                   "rank": r, "world": w}, (w, r)


def test_ranks_import_neither_jax_nor_the_jax_package(runs):
    for name in SPAWNS:
        assert all(out["leaked"] == [] for out in runs["spawns"].result(name))


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------

def test_shard_blocks_puts_every_row_on_one_rank():
    """Rows split in rank order by whole chunks, the same chunks at every
    world size (4 chunks of 3 runs of 4 over 10 runs), and a block that is
    no whole number of runs loses them on every rank."""
    from panovlm_tpu_torch.solver.lm import ResidualBlock
    n = 40
    b = ResidualBlock(None, ("poses",), (torch.arange(n),), (torch.arange(n)[:, None],),
                      torch.ones(n), torch.ones(n, dtype=torch.bool), run_length=4)
    odd = ResidualBlock(None, ("poses",), (torch.arange(n - 1),),
                        (torch.arange(n - 1)[:, None],), torch.ones(n - 1),
                        torch.ones(n - 1, dtype=torch.bool), run_length=4)
    for world in (1, 3, 4, 7):
        parts = [shard_blocks((b, odd), types.SimpleNamespace(rank=r, world=world))
                 for r in range(world)]
        rows = torch.cat([p[0].indices[0] for p in parts])
        assert torch.equal(rows, torch.arange(n))
        assert all(p[0].run_length == 4 and p[0].chunk == 12 for p in parts)
        sizes = [len(p[0].indices[0]) for p in parts]
        starts = np.cumsum([0] + sizes)[:-1]
        assert all(s % 12 == 0 for s, m in zip(starts, sizes) if m)
        assert torch.equal(torch.cat([p[1].data[0][:, 0] for p in parts]), torch.arange(n - 1))
        assert all(p[1].run_length == 1 and p[1].chunk == 10 for p in parts)
    whole = shard_blocks((b,), None)[0]
    assert whole.chunk == 12 and whole.mask is b.mask


def test_pad_leading_to_multiple():
    tree = {"a": torch.ones((5, 2)), "m": np.ones(5, bool)}
    out = pad_leading_to_multiple(tree, 4)
    assert out["a"].shape == (8, 2) and out["a"][5:].sum() == 0
    assert out["m"].shape == (8,) and out["m"].sum() == 5
    assert pad_leading_to_multiple(tree, 5)["a"] is tree["a"]


def test_ring_halo_of_one_rank_is_its_own_head():
    x = {"a": torch.arange(12).reshape(6, 2), "b": torch.arange(6) > 2}
    h = halo.ring_halo_right(x, 2)
    assert torch.equal(h["a"], torch.cat([x["a"], x["a"][:2]]))
    assert torch.equal(h["b"], torch.cat([x["b"], x["b"][:2]]))
    with pytest.raises(ValueError):
        halo.ring_halo_right(x, 7)


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

def test_sharded_solve_is_bit_equal_at_every_world_size(runs):
    one = _ranks(runs, 1)[0]["solve"]
    for w in WORLDS:
        for out in _ranks(runs, w):
            _same_bits(out["solve"], one, f"world {w}")


def test_sharded_solve_matches_the_port_and_the_jax_sharded_solve(runs):
    """Within 5e-5 of the port without a group and of JAX's sharded solve
    (test_parallel.py's tolerance), and near the truth."""
    out = _ranks(runs, 4)[0]["solve"]
    np.testing.assert_allclose(out["poses"], _single(runs, "solve")["poses"], atol=5e-5)
    np.testing.assert_allclose(out["poses"], runs["ref"]["solve_jax"], atol=5e-5)
    gt = runs["inputs"]["solve"]["gt"]
    np.testing.assert_allclose(out["poses"][1:, :3], gt[1:, :3], atol=1e-3)


# ---------------------------------------------------------------------------
# the ring halo and the odometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", WORLDS[1:])
def test_halo_pairs_are_the_jax_pairs(runs, w):
    """Over the ranks in rank order: the JAX function's pair list and valid
    mask on a mesh of the same size."""
    outs = _ranks(runs, w)
    got = [np.concatenate([o["halo"][k] for o in outs]) for k in ("pair_r", "pair_n",
                                                                  "pair_valid")]
    for a, b, k in zip(got, runs["ref"]["halo_jax"][w], ("pair_r", "pair_n", "pair_valid")):
        np.testing.assert_array_equal(a, b, err_msg=k)
    pv = got[2]
    assert pv.sum() == 2 * (2 * N_SCANS - 3)   # (g, g+1), (g, g+2), both ways


@pytest.fixture(scope="module")
def halo_reference(runs):
    """The port's associate_all_pairs on every valid temporal pair."""
    inp = runs["inputs"]["halo"]
    pr, pn, pv = runs["ref"]["halo_jax"][2]
    pairs = list(zip(pr[pv].tolist(), pn[pv].tolist()))
    assoc = tassoc.associate_all_pairs(
        interop.features_from_numpy(inp["batch"]), interop.poses_from_numpy(inp["poses"]),
        torch.as_tensor(pr[pv]), torch.as_tensor(pn[pv]))
    return {p: i for i, p in enumerate(pairs)}, assoc


@pytest.mark.parametrize("w", WORLDS)
def test_halo_rows_are_associate_all_pairs_rows(runs, halo_reference, w):
    """Each valid pair's rows bit-equal to the port's associate_all_pairs
    on the same pair; invalid pairs masked everywhere."""
    index, ref = halo_reference
    for out in _ranks(runs, w):
        h = out["halo"]
        pv = h["pair_valid"]
        assert pv.any()
        rows = [index[p] for p in zip(h["pair_r"][pv].tolist(), h["pair_n"][pv].tolist())]
        for fam, d in h["assoc"].items():
            assert not d["mask"][~pv].any(), fam
            for k, v in d.items():
                np.testing.assert_array_equal(v[pv], ref[fam][k][rows].numpy(),
                                              err_msg=f"{fam}.{k}")


def test_odometry_is_bit_equal_at_every_world_size(runs):
    one = _ranks(runs, 1)[0]["odometry"]
    for w in WORLDS:
        for out in _ranks(runs, w):
            _same_bits(out["odometry"], one, f"world {w}")


def test_odometry_matches_the_port_without_a_group(runs):
    """The same pairs, rounds and poses within 2e-4."""
    out = _ranks(runs, 4)[0]["odometry"]
    single = _single(runs, "odometry")
    assert len(out["infos"]) == len(single["infos"])
    assert [i["pairs"] for i in out["infos"]] == [i["pairs"] for i in single["infos"]]
    np.testing.assert_allclose(out["poses"], single["poses"], atol=2e-4)


def test_odometry_is_the_sharded_solve_without_a_group_bit_for_bit(runs):
    """`OdometryConfig.sharded_solve` without a group associates and solves
    in the group's pair chunks and sums its costs exactly: the group's
    bits."""
    _same_bits(_ranks(runs, 2)[0]["odometry"], _single(runs, "odometry_sharded"), "no group")


def test_odometry_matches_the_jax_sharded_odometry(runs):
    """test_torch_odometry.py's bounds: 5 mm and 0.1 deg per scan."""
    out = _ranks(runs, 2)[0]["odometry"]
    assert len(out["infos"]) == len(runs["jax_infos"])
    Rt, tt = pose_util.params_to_world(out["poses"])
    Rj, tj = pose_util.params_to_world(runs["ref"]["odometry_jax"])
    assert np.linalg.norm(tt - tj, axis=1).max() < 0.005
    cos = (np.einsum("nij,nij->n", Rt, Rj) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))).max() < 0.1


# ---------------------------------------------------------------------------
# the joint solve
# ---------------------------------------------------------------------------

def test_joint_is_bit_equal_at_every_world_size(runs):
    one = _ranks(runs, 1)[0]["joint"]
    assert all(i["tier"] != "schur" for i in one["infos"])
    for w in WORLDS:
        for out in _ranks(runs, w):
            _same_bits(out["joint"], one, f"world {w}")


def test_joint_matches_the_port_without_a_group(runs):
    out = _ranks(runs, 2)[0]["joint"]
    single = _single(runs, "joint")
    assert [i["tier"] for i in single["infos"]] == ["schur"] * JOINT["num_iteration_joint"]
    np.testing.assert_allclose(out["lidar"], single["lidar"], atol=2e-3)
    np.testing.assert_allclose(out["cam"], single["cam"], atol=2e-3)
    s = runs["inputs"]["joint"]["scene"]
    err0 = np.abs(s["lid0"] - s["lid_gt"]).max()
    assert np.abs(out["lidar"] - s["lid_gt"]).max() < 0.5 * err0


def test_joint_is_the_sharded_solve_without_a_group_bit_for_bit(runs):
    """`JointConfig.sharded_solve` without a group gives the group's bits."""
    _same_bits(_ranks(runs, 4)[0]["joint"], _single(runs, "joint_sharded"), "no group")


def test_joint_matches_the_jax_sharded_joint(runs):
    """Within 2e-3 of the JAX package's joint_optimize(mesh=make_mesh())."""
    out = _ranks(runs, 2)[0]["joint"]
    ref = runs["ref"]["joint_jax"]
    np.testing.assert_allclose(out["lidar"], ref["lidar"], atol=2e-3)
    np.testing.assert_allclose(out["cam"], ref["cam"], atol=2e-3)


# ---------------------------------------------------------------------------
# the stages
# ---------------------------------------------------------------------------

def _tree(root):
    """Every file under root/result with its bytes (the fused cloud, the
    per-frame depth, normal and confidence artifacts, the pose files)."""
    out = {}
    for f in sorted(glob.glob(os.path.join(root, "result", "**", "*"), recursive=True)):
        if os.path.isfile(f):
            with open(f, "rb") as fh:
                out[os.path.relpath(f, root)] = fh.read()
    return out


def test_joint_mvs_is_bit_equal_at_every_world_size(runs):
    one = _ranks(runs, 1)[0]["mvs"]
    tree = _tree(os.path.join(runs["d"], "w1", "mvs"))
    assert any(k.endswith("mvs_fused.pcd") for k in tree)
    assert sum(k.endswith("_geo.npy") for k in tree) == 3 * 4   # depth, conf, normal
    assert sum(k.endswith("_filter.npy") for k in tree) == 4
    for w in WORLDS[1:]:
        for out in _ranks(runs, w):
            _same_bits(out["mvs"], one, f"world {w}")
        assert _tree(os.path.join(runs["d"], f"w{w}", "mvs")) == tree, w


def test_torchrun_on_two_ranks_writes_the_single_rank_outputs(runs):
    """`python -m torch.distributed.run --nproc-per-node 2 -m
    panovlm_tpu_torch init_lidar_pose ... --device cpu` (gloo): every file
    of the stage (both pose files, the centres, the undistorted clouds)
    byte for byte the 1-rank group's."""
    runs["spawns"].result("stage")
    rc, log = runs["torchrun"]
    assert rc == 0, log
    tree = _tree(os.path.join(runs["d"], "stage", "stage"))
    assert all(any(k.endswith(f) for k in tree) for f in POSE_FILES)
    assert _tree(runs["torchrun_dir"]) == tree


def test_resolve_names_a_card_by_its_index():
    assert resolve("cpu") == torch.device("cpu")
    for bad in ("tpu", "cuda:x"):
        with pytest.raises(ValueError, match="'cuda', 'cuda:N' or 'cpu'"):
            resolve(bad)
    if not torch.cuda.is_available():
        for dev in ("cuda:1", torch.device("cuda", 0)):
            with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
                resolve(dev)
