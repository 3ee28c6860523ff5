"""panovlm_tpu_torch — the PyTorch/CUDA port of panovlm_tpu.

A second package beside the JAX one (`panovlm_tpu/`), which stays the
reference that every ported function is tested against. The port goes one
pipeline stage at a time; the stage ported so far is the LiDAR odometry stage:

    python -m panovlm_tpu_torch init_lidar_pose config.txt [--device cuda|cpu]

The package imports torch and never jax. It shares the numpy-only modules of
the JAX package (config, io, pose/timing/track utilities, the native scan
prefetcher) instead of copying them. The module layout mirrors
`panovlm_tpu/`: `ops/` (se3, geometry, the KNN kernels), `sensors/`
(velodyne, lidar_lines), `models/` (association, line_tracks,
lidar_odometry), `solver/` (robust, residuals, lm) and `pipeline.py`.
"""

__version__ = "0.1.0"
