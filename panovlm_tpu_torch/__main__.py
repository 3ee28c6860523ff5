"""CLI of the port — the verbs of the reference executable (main.cpp:41-89):

    python -m panovlm_tpu_torch <stage> <config.txt> [--device cuda|cpu]

All five stages: init_camera_pose, init_lidar_pose, joint_optimization,
colorize_lidar_map and joint_mvs. Pair surgery (pair_surgery.py: patch the
persisted pair set of init_camera_pose without rerunning the stage):

    python -m panovlm_tpu_torch add_pair <config.txt> <i> <j>
    python -m panovlm_tpu_torch recompute_pairs <config.txt> <idx1> <idx2>
    python -m panovlm_tpu_torch set_straight_motion <config.txt> <start> <end> <len>
    python -m panovlm_tpu_torch dump_relative_poses <config.txt> [out.txt]
    python -m panovlm_tpu_torch dump_global_poses <config.txt> [out.txt]

each with --device cuda|cpu (default cuda).
"""

from __future__ import annotations

import argparse
import logging
import sys

STAGES = ("init_camera_pose", "init_lidar_pose", "joint_optimization",
         "colorize_lidar_map", "joint_mvs")
# verb -> its arguments after the config: integers, or one optional path
SURGERY = {"add_pair": ("i", "j"), "recompute_pairs": ("idx1", "idx2"),
           "set_straight_motion": ("start", "end", "len"),
           "dump_relative_poses": ("[out.txt]",), "dump_global_poses": ("[out.txt]",)}


def main(argv=None, infos: list | None = None, tr=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m panovlm_tpu_torch",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("verb", choices=STAGES + tuple(SURGERY))
    parser.add_argument("config")
    parser.add_argument("args", nargs="*")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    want = SURGERY.get(args.verb, ())
    optional = want == ("[out.txt]",)
    if len(args.args) != len(want) and not (optional and not args.args):
        parser.error(f"{args.verb} takes <config.txt> {' '.join(want)}".rstrip())
    if optional:
        extra = args.args or [None]
    else:
        try:
            extra = [int(a) for a in args.args]
        except ValueError:
            parser.error(f"{args.verb}: {' '.join(want)} must be integers")

    from . import pipeline
    from .config import load_config
    from .device import resolve
    from .utils.timing import TimeReport

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    device = resolve(args.device)
    cfg = load_config(args.config)
    if args.verb in SURGERY:
        from . import pair_surgery
        getattr(pair_surgery, args.verb)(cfg, *extra, device=device)
        return 0
    tr = tr or TimeReport()
    with tr.phase(args.verb):
        if args.verb == "init_camera_pose":
            pipeline.init_camera_pose(cfg, tr, device=device)
        elif args.verb == "joint_mvs":
            pipeline.joint_mvs(cfg, tr, device=device)
        elif args.verb == "joint_optimization":
            pipeline.joint_optimization(cfg, tr, device=device)
        elif args.verb == "colorize_lidar_map":
            pipeline.colorize_lidar_map(cfg, tr, device=device)
        else:
            pipeline.init_lidar_pose(cfg, tr, device=device, infos=infos)
    print(tr.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
