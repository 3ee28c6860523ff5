"""CLI of the port — the verbs of the reference executable (main.cpp:41-89):

    python -m panovlm_tpu_torch <stage> <config.txt> [--device cuda|cpu]

All five stages: init_camera_pose, init_lidar_pose, joint_optimization,
colorize_lidar_map and joint_mvs.
"""

from __future__ import annotations

import argparse
import logging
import sys

STAGES = ("init_camera_pose", "init_lidar_pose", "joint_optimization",
         "colorize_lidar_map", "joint_mvs")


def main(argv=None, infos: list | None = None, tr=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m panovlm_tpu_torch")
    parser.add_argument("stage", choices=STAGES)
    parser.add_argument("config")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)

    from . import pipeline
    from .config import load_config
    from .device import resolve
    from .utils.timing import TimeReport

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    device = resolve(args.device)
    cfg = load_config(args.config)
    tr = tr or TimeReport()
    with tr.phase(args.stage):
        if args.stage == "init_camera_pose":
            pipeline.init_camera_pose(cfg, tr, device=device)
        elif args.stage == "joint_mvs":
            pipeline.joint_mvs(cfg, tr, device=device)
        elif args.stage == "joint_optimization":
            pipeline.joint_optimization(cfg, tr, device=device)
        elif args.stage == "colorize_lidar_map":
            pipeline.colorize_lidar_map(cfg, tr, device=device)
        else:
            pipeline.init_lidar_pose(cfg, tr, device=device, infos=infos)
    print(tr.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
