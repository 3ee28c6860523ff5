"""Rank bodies of tests/test_torch_parallel.py: cases run on every rank of
a gloo group, on the CPU.

    python tests/torch_ranks.py <dir> <spawn> <world> <rank>

joins the spawn's group of <world> ranks through a file store in <dir>,
reads <dir>/inputs.pkl (the cases' numpy inputs, built by the test from a
seed, and per spawn its cases and whether they get the group or run as the
port without one), runs the spawn's cases and writes
<dir>/out_<spawn>_<rank>.pkl with each case's seconds. A case's stage runs
in <dir>/<spawn>/<case>, a copy of its dataset. This module imports neither
jax nor panovlm_tpu, so a rank starts in a few seconds.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# how long a rank waits for the others before it raises
TIMEOUT = datetime.timedelta(seconds=120)


def _t(a):
    return torch.from_numpy(np.array(a))


def solve_case(inp, group, _):
    """tests/test_parallel.py's plane problem, its rows split over the ranks."""
    from panovlm_tpu_torch.parallel import shard_blocks
    from panovlm_tpu_torch.solver import residuals
    from panovlm_tpu_torch.solver.lm import LMOptions, ResidualBlock, solve_lm
    n = len(inp["pair_r"])
    block = ResidualBlock(residuals.point2plane_meter, ("poses", "poses"),
                          (_t(inp["pair_r"]).long(), _t(inp["pair_n"]).long()),
                          (_t(inp["pts_n"]), _t(inp["pl_r"])), torch.ones(n),
                          torch.ones(n, dtype=torch.bool), loss="huber", loss_scale=0.2)
    blocks = shard_blocks((block,), group) if group is not None else (block,)
    out, info = solve_lm({"poses": _t(inp["poses0"])}, blocks, {"poses": _t(inp["fixed"])},
                         LMOptions(max_iters=8, cg_iters=25, **inp.get("options", {})),
                         group=group)
    return {"poses": out["poses"].numpy(), "iterations": info["iterations"],
            "tier": info["tier"], "final_cost": float(info["final_cost"]),
            "initial_cost": float(info["initial_cost"])}


def _features(inp):
    from panovlm_tpu_torch import interop
    return interop.features_from_numpy(inp["batch"]), interop.poses_from_numpy(inp["poses"])


def halo_case(inp, group, _):
    """The ring-halo association of this rank's scans."""
    from panovlm_tpu_torch.parallel import halo, shard_leading_axis
    batch, poses = _features(inp)
    assoc, pr, pn, pv = halo.associate_windowed_sharded(
        shard_leading_axis(batch, group), poses, poses.shape[0], inp["window"], group,
        bidirectional=True)
    return {"assoc": {f: {k: v.numpy() for k, v in d.items()} for f, d in assoc.items()},
            "pair_r": pr.numpy(), "pair_n": pn.numpy(), "pair_valid": pv.numpy()}


def odometry_case(inp, group, _, **cfg):
    from panovlm_tpu_torch.models import lidar_odometry
    batch, poses = _features(inp)
    out, infos = lidar_odometry.estimate_poses(
        batch, poses.numpy(), inp["valid"],
        lidar_odometry.OdometryConfig(**inp["config"], **cfg), group=group)
    return {"poses": out.numpy(), "infos": infos}


def odometry_sharded_case(inp, group, wd):
    """The odometry case associated and solved as under a group, without one."""
    return odometry_case(inp, group, wd, sharded_solve=True)


def joint_case(inp, group, _, **cfg):
    from panovlm_tpu_torch.models import camera_lidar as cl
    s = inp["scene"]
    cam, lid, pts, infos = cl.joint_optimize(
        {k: _t(v) for k, v in s["arc_batch"].items()},
        {k: _t(v) for k, v in s["lidar_batch"].items()}, s["cam_gt"], s["lid0"], s["timg"],
        s["tfeat"], s["tmask"], s["bearings"], s["pts3d"], np.ones(len(s["pts3d"]), bool),
        cl.JointConfig(**inp["config"], **cfg), group=group)
    return {"cam": cam.numpy(), "lidar": lid.numpy(), "pts": pts.numpy(), "infos": infos}


def joint_sharded_case(inp, group, wd):
    """The joint case solved as under a group, without one."""
    return joint_case(inp, group, wd, sharded_solve=True)


def _stage(name):
    def run(inp, group, wd):
        from panovlm_tpu_torch import pipeline
        from panovlm_tpu_torch.config import load_config
        out = getattr(pipeline, name)(load_config(os.path.join(wd, "config.txt")),
                                      device="cpu")
        return [np.asarray(o) for o in out]
    return run


def mesh_case(inp, group, _):
    from panovlm_tpu_torch.parallel.multihost import make_hybrid_mesh
    m = make_hybrid_mesh("cpu")
    return {"shape": tuple(m.mesh.shape), "names": m.mesh_dim_names, "rank": group.rank,
            "world": group.world}


CASES = {"mesh": mesh_case, "solve": solve_case, "halo": halo_case, "odometry": odometry_case,
         "odometry_sharded": odometry_sharded_case, "joint": joint_case, "joint_sharded": joint_sharded_case, "mvs": _stage("joint_mvs"),
         "stage": _stage("init_lidar_pose")}


def main(d: str, spawn: str, world: int, rank: int):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store_{spawn}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        from panovlm_tpu_torch.parallel import DataGroup
        with open(os.path.join(d, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        spec = inputs["spawns"][spawn]
        group = DataGroup("cpu") if spec["group"] else None
        out, seconds = {}, {}
        for name in spec["cases"]:
            t0 = time.perf_counter()
            out[name] = CASES[name](inputs["cases"][name], group, os.path.join(d, spawn, name))
            seconds[name] = time.perf_counter() - t0
        out["seconds"] = seconds
        out["leaked"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "jaxlib", "panovlm_tpu"))
        path = os.path.join(d, f"out_{spawn}_{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
