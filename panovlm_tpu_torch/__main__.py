"""CLI of the port — the verbs of the reference executable (main.cpp:41-89):

    python -m panovlm_tpu_torch <stage> <config.txt> [--device cuda|cpu]

Ported: init_camera_pose, init_lidar_pose, joint_optimization and joint_mvs.
colorize_lidar_map exits non-zero: it runs only in the JAX package
(`python -m panovlm_tpu`) until its slice lands.
"""

from __future__ import annotations

import argparse
import logging
import sys

PORTED = ("init_camera_pose", "init_lidar_pose", "joint_optimization", "joint_mvs")
NOT_PORTED = ("colorize_lidar_map",)


def main(argv=None, infos: list | None = None, tr=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m panovlm_tpu_torch")
    parser.add_argument("stage", choices=PORTED + NOT_PORTED)
    parser.add_argument("config")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if args.stage in NOT_PORTED:
        print(f"{args.stage}: not ported yet (ROADMAP.md)", file=sys.stderr)
        return 2

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
        else:
            pipeline.init_lidar_pose(cfg, tr, device=device, infos=infos)
    print(tr.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
