#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--scans N] [--mvs-frames N] [--mvs-exact-frames N]
                          [--sfm-frames N] [--profile-mvs]
                          [--only-sfm | --only-floor | --only-joint]

Run from the root of a checkout. Phases, each fatal on failure:
  1. card: nvidia-smi name and power limit, torch's device name; the
     Floor scans of phase 12 (one worker) and the MVS dataset's
     panoramas (gray PNG and colour JPEG) start in worker processes
     meanwhile;
  2. build: the CUDA kernels of panovlm_tpu_torch/csrc, compiled from this
     checkout (ops/_build.py, one nvcc per source, in parallel); then the
     script waits for the renders (the MVS and the SfM panoramas) and stops
     the workers, so that every later phase runs on an otherwise idle host;
  3. kernel vs plain, timed with CUDA events (median of 10 after warm-up):
     - each KNN kernel at the association shapes on random clouds (B=256
       pairs, 90 % of the points valid; point->line Q=T=1024, k=5;
       point->plane Q=512, T=4096, k=10 with ring offsets +-1, +-2, the
       target ring ids sorted within each pair as the stage's are):
       indices equal except on near-ties, d2 within rtol/atol 1e-5, two
       launches bit-equal;
     - the plane-sweep NCC kernel at the Room MVS shapes, 720 x 1440: full
       scoring V=4 views, C=2 candidates, T=49 texels (7x7), D=64 slices;
       candidate ranking V=2, C=16, T=5, every 4th slice (D=16); both again
       at 723 x 1443 (partial 32 x 8 tiles at the right and bottom edges):
       max |kernel - plain| <= 2e-4, and two launches bit-equal;
  4. the odometry stage (`python -m panovlm_tpu_torch init_lidar_pose`,
     in-process) on a synthetic Room-454 dataset (tests/synthetic.py, the
     loop trajectory of _room_scale.sh, 16 rings x 1800 azimuths), checked
     against ground truth (consecutive-scan distance error < 0.05 m in both
     pose files) and for kernel launches on that path (one knn and one
     knn_ring launch per association round); the arguments of the first
     knn and knn_ring calls are kept on the card;
  5. K1 and K2 on those arguments (the first association round, B = its
     pair count, ~3,500): as in phase 3, with the plain version and the
     library call run in chunks of 256 pairs and timed as the sum over the
     chunks; prints the valid shares of queries, targets and pairs;
  6. the MVS stage (`python -m panovlm_tpu_torch joint_mvs`, in-process) on
     the first --mvs-frames frames of the same loop: 2880 x 5760 panoramas
     (rendered at 1440 x 2880 and each pixel repeated 2 x 2, PANO_RENDER_DOWN)
     as tests/synthetic.render_panorama casts the rays, written as PNG, read at
     scale -2 (720 x 1440) with the Room MVS keys (configs/Room.txt:75-87;
     min_depth 0.1, the Config default, since Room's 0 divides by zero in
     the sweep path, ROADMAP F7), undistorted scans and ground-truth joint
     camera/LiDAR poses. Checked: the artifact set, the median relative
     depth error < 0.08 in rows H/4..3H/4 (the bound of
     tests/test_pipeline_cli_late.py), a floor on the share of that band
     with a depth, and K3 launches;
  7. K3 against its plain version at the shapes phase 6 launched it with:
     the sweep range and slice count that the stage's range fit chose (read
     from its log), full scoring at C=2, the initial scoring at C=1 and the
     ranking on every 4th slice, max |kernel - plain| <= 2e-4, two launches
     bit-equal;
  8. the SfM stage (`python -m panovlm_tpu_torch init_camera_pose`,
     in-process) on --sfm-frames frames of the same loop, every 6th (frames
     0, 6, ..., 282 by default: ~1.55 laps), panoramas rendered straight at
     the working size 720 x 1440 (scale 0), the scans of those frames with
     T_cl = identity, the Room SfM keys (configs/Room.txt:38-55) with
     frame_match_method 6, max_depth 5 and the on-device SIFT; checked: every
     frame valid, camera_pose_final.txt within 1 deg and 0.08 m of ground
     truth after aligning frame 0 (the bounds of
     tests/test_pipeline_cli.py::test_stage1_init_camera_pose), one launch of
     the fused descriptor search per batch of pairs; then the device SIFT
     and the VLAD proposal twice more on the same frames: descriptors,
     embeddings and pairs bit-equal to each other and to the stage's
     (ROADMAP F8);
  8 (b). the SfM stage again on phase 8's frames with the configs' own
     SIFT key, `sift_device = false` (and Room's `num_threads = 25`), no
     frame cache: the host SIFT (native/sift.cpp, cv2's bits in C++, g++
     at first use, no fallback). Checked: the port's SIFT gives the
     SHA-256 of cv2's output on an embedded seeded probe
     (SIFT_PROBE_SHA256, recomputed with cv2 in tier-1), phase 8's
     artifact set, every frame valid within 1 deg and 0.08 m of ground
     truth, one fused descriptor search per batch of pairs, and a rerun of
     the extraction bit-equal to the stage's frames_sift.npz. Prints the
     features kept per frame, "extract sift" beside phase 8's and the time
     per frame on 1 thread and on the threads used.
  8 (c). pair surgery through the port's CLI on copies of phase 8's result
     and pair caches: add_pair on the first pair (i, j >= i + 8) that phase
     8 did not propose, recompute_pairs over frames 0-15 (120 pairs), then
     the SfM stage on that copy, reading its caches; set_straight_motion
     over frames 0-5 with length 2 and the two dumps on a second copy.
     Checked: each verb's K1' launches one per batch of 16 pairs, every
     recomputed row that phase 8 matched bit-equal to phase 8's, the extra
     rows kept by the rerun (which matches nothing), every frame valid
     within 1 deg and 0.08 m; the forced rel_poses.npz rows (R = I, t = -z,
     CheckRT inliers on matched pairs); one dump record per pair and per
     frame.
  8 (d). the SfM stage with a GPS file (phase 8's true camera centres plus
     2 cm of seeded noise), frame_match_method 6 | 8, init_translation_GPS
     on and init_translation_DLT off, on phase 8's frame cache. Checked: the
     GPS pairs proposed, translation averaging given the GPS scales and
     init, one K1' launch per batch, every frame valid within 1 deg and
     0.08 m.
  9. K1 at D = 128 (csrc/knn_desc.cu, `knn_mutual`: forward top-2 and
     reverse top-1 in one launch) against two plain searches on the stage's
     own descriptors: the first pairs it matched, at the batch the stage
     launches, Q = T = num_sift, and a ragged cut (Q = 5000, T = 7001, more
     rows masked); two launches bit-equal.
  10. the odometry stage on the scans of phase 8's frames, seeded from its
     sfm/lidar_pose.txt (lidar_path_undistort set; data_gap_time 9.9 s, so
     that the undistortion leaves these undistorted scans nearly alone),
     then the joint stage (`python -m panovlm_tpu_torch
     joint_optimization`) on the port's own SfM and odometry outputs with
     the Room joint keys (configs/Room.txt:36,58,66,69-73). Checked: the
     reference's artifact set, camera poses within 1 deg and 0.08 m of
     ground truth after aligning frame 0, LiDAR consecutive-scan distance
     error < 0.05 m after the odometry stage and, after the joint stage,
     within 1.25 times (max and median) what the JAX joint_optimize gives
     on the same arguments (JOINT_LIDAR_REF: the reference moves the LiDAR
     poses ~0.57 m there), every pose valid and finite, a floor on the
     fused image arcs per frame before the cap, one knn and one knn_ring
     launch per joint round, K1 and K2 on the first joint round's own
     inputs as in phase 5. The joint_optimize arguments and the card's
     result are kept in chiprun_out/joint_chain.npz, the input of
     tests/joint_chain_reference.py (the JAX and the port's solve on the
     CPU, scan by scan). ROADMAP F9: the
     joint stage run twice gives bit-equal pose files and points, and the
     rotation averaging (L1-ADMM) and translation averaging calls of phase
     8 and the fuse's voxel_downsample of phase 6, rerun twice on their
     captured inputs, give the stage's bits; as a control, the float
     index_add_ that the solver used before runs twice on the joint solve's
     largest scattered sum. Prints the stage's TimeReport and peak memory.
  11. the colorize stage (`python -m panovlm_tpu_torch colorize_lidar_map`,
     in-process) on phase 6's dataset with colour panoramas: the render
     workers of phase 1 also write each of its frames as a colour JPEG
     (quality 95, 4:2:0, the port's own encoder) at 2880 x 5760, each
     channel a function of the world point hit (COLOR_OFFSETS), so that the
     true colour of any fused point is known; the stage reads them at scale
     -2 (720 x 1440 RGB) with the full-width undistorted scans (16 rings x
     1800 azimuths, cap 32,768) and the ground-truth joint poses, leaf
     0.04. Checked: the port's decoder gives cv2's bits on an embedded
     cv2-written probe; one decoded panorama within the q95 round-trip
     bounds of its source array (JPEG_Q95_MEAN / _MAX, held in tier-1);
     colorized_map.pcd has an rgb field; the fused points reach a floor;
     the median |colour - true colour| per channel is under a bound set by
     a CPU rehearsal at the same scale; a rerun writes the same bytes.
     Then the stage on phase 10's outputs (its 48 PNG frames at 720 x 1440,
     the port's joint poses and undistorted scans): the artifact and a
     fused-points floor only (those LiDAR poses carry the reference's own
     error, JOINT_LIDAR_REF). Prints the TimeReports, the decode time of one
     2880 x 5760 JPEG on one thread and the peak device memory. Cut: 16 of
     Room's 454 frames (render time), 48 in the chain; nothing in width.
  12. the LM solver's PCG tier (above 6144 parameters): (a) the odometry
     stage (`python -m panovlm_tpu_torch init_lidar_pose`, in-process) on
     FLOOR_SCANS = 1100 scans of the Room-454 loop (Floor has 1593; cut:
     the time limit) continued at the same yaw step (~6.1 revolutions;
     6,600 pose parameters, above the dense tier's 6,144), built as
     phase 4's: checked for the artifacts, valid
     poses, consecutive-scan distance error < 0.05 m in both pose files,
     one knn and one knn_ring launch per round, every solve on the PCG
     tier, and the first round's LM problem re-solved on its captured
     inputs with the stage's bits; that problem is solved once more with
     the dense tier forced per call (LMOptions(dense_max_params=P)) and
     the two are compared; prints the stage's phases, peak device memory,
     pairs, LM and CG iterations per round; then K1 and K2 on the first
     round's inputs as in phase 5 (B ~8,400 pairs). (b) translation
     averaging (softl1) on the 454 cameras of the loop, each paired with
     its 40 nearest centres (~9,000 pairs, P = 3 x 454 + pairs), 0.5 deg of
     seeded direction noise and 5 % on the scales: the PCG tier, centres
     within 0.08 m of ground truth after a similarity, a bit-equal rerun,
     and the dense tier forced per call for comparison; then chordal, lud,
     bata and l1 on the same graph, each within 0.08 m, or 1.25 times the
     JAX function's error where that is larger (TA_METHOD_REF,
     tests/ta_room_reference.py), and a bit-equal rerun; prints the L-inf
     LP's size and host time.
  13. the joint stage's line-track modes and its CALIBRATION mode on phase
     10's chain (after phase 11): (a) the joint stage through the CLI with
     use_image_track, use_lidar_track and use_track_associate appended to
     the chain config (the LBD descriptors on the card, the image-line
     tracks with the port's LK flow, the LiDAR line tracks, the track
     association). Checked: the artifact set, K1 and K2 once per round,
     camera poses within 1 deg and 0.08 m, LiDAR consecutive-scan distance
     error within 1.25 times (max and median) what the JAX joint_optimize
     gives in the same modes on the same arguments (JOINT_TRACKS_LIDAR_REF),
     every gate keeping lines in every round, a bit-equal rerun; prints per
     round the lines on tracks, the line pairs before and after the track
     association and the LK points with status 1. (b) on the frame/scan
     pair with the most line pairs at the true T_cl (identity), from the
     JAX test's start (1.2, -0.9, 0.7 deg; 0.06, -0.04, 0.05 m):
     perturb_calibration_search, then calibrate, on the card and on the
     CPU. Checked: the search keeps its pairs and does not turn the
     rotation away from the truth, the card gives the CPU's pairs and T
     within 1e-4 (rad, m), and the final error within 1.25 times the JAX
     functions' (CALIB_REF). Both JAX references come from
     tests/joint_chain_reference.py run on the host on the
     chiprun_out/joint_chain_tracks.npz that the phase keeps.
  14. the last four options, after phase 12: (a) the MVS stage with
     mvs_neighbor_selection = 1 and the configs' sweep on phase 10's chain
     (its frames at 720 x 1440, whose ground-truth depth the SfM render
     workers return, phase 8's result/sfm/points.npz, the joint poses,
     RefineCameraPose on the SfM tracks). Checked: the table the stage
     filtered with equals select_neighbor_sfm on the same points.npz with
     the KNN picks where it has -1, at least one row differs from the KNN
     table, the median relative depth error < 0.08 and coverage floors of
     its own (SFM_NEIGHBOUR_MIN_COVERAGE: the SfM score picks wider
     baselines than the KNN of phase 6's floors); prints the rows that
     fell back to KNN and the mean baseline to the SfM and to the KNN
     neighbours. (b) the MVS stage with mvs_sweep_slices = 0 (exact
     per-plane sampling) on the first --mvs-exact-frames frames of phase
     6's dataset at 720 x 1440. Checked: phase 6's depth bounds, no
     volscore launch, frame 0's photometric and geometric passes run again
     on their captured inputs bit-equal; prints the passes per frame beside
     phase 6's. (c)
     the odometry stage with extraction_method = 2
     and lidar_ring_repair = true on phase 4's Room-454 dataset (16 x 1800
     rays, nothing cut). Checked: the firing-column probe of
     tests/ring_scans.py repaired on the card to its rings, phase 4's
     artifacts and bounds, one knn and one knn_ring launch per round,
     hysteresis edges in every scan; prints the repaired points.
  15. the stages split over ranks on the one card (torch.distributed, each
     rank a spawned process on cuda:0 with a collective timeout,
     RANK_TIMEOUT_S, and every group stopped and failed after
     GROUP_DEADLINE_S; NCCL refuses two ranks on one card, so world size 2
     runs over gloo, the collectives through host memory, and NCCL at
     world size 1): (a) init_lidar_pose with its undistort round on the
     loop's first MULTI_SCANS = 128 scans (make_room, in the render pool;
     cut: the time limit), twice without a group in this process (as the
     stage runs by default, and with sharded_solve: the group's pair
     chunks and exact costs), on 2 gloo ranks and on 1 NCCL rank. Checked:
     each run's artifacts and phase 4's bounds, the ranks of a group
     bit-equal, the gloo and NCCL groups bit-equal, each within
     ODOMETRY_TOL of the sharded run and within ODOMETRY_TOL_M of both runs
     in its scan positions, and each group's K1 and K2 launches summed over
     its ranks equal to the sharded run's; prints each round's costs.
     (b) joint_optimize on
     phase 10's arguments (chiprun_out/joint_chain.npz) on 2 gloo ranks, on
     1 NCCL rank and without a group (JointConfig.sharded_solve, a process
     of its own): the PCG tier (no Schur elimination), the ranks of a group
     bit-equal, the gloo and NCCL groups bit-equal, each within JOINT_TOL
     of the solve without a group and within phase 10's pose bounds;
     prints the difference from phase 10's poses. (c) joint_mvs on 2 gloo
     ranks on phase 6's dataset in a result tree of its own: every
     artifact (depth, confidence and normal of both passes, filtered
     depth, the fused cloud) bit-equal to phase 6's, and the ranks'
     volscore launches summing to phase 6's. Every rank checks that it
     imported neither jax nor panovlm_tpu.
  16. the image formats the JAX package reads through cv2, after phase 11
     (printed before phase 13): (a) the port's decoders give cv2's digests
     on embedded probes of each kind (FORMAT_PROBES: progressive with
     successive approximation and restarts, a progressive file cut after
     its third scan, CMYK, YCCK, RGB-coded, 16-bit RGB, bilevel, palette +
     tRNS and Adam7 PNG); (b) the render workers of phase 1 re-code the
     first PROGRESSIVE_FRAMES colour JPEGs as progressive files from the
     coefficients of their baseline files: load_images_u8 gives the
     baseline files' bits, and the colorize stage on phase 11's frames with
     those files in place writes phase 11's colorized_map.pcd byte for
     byte; (c) the workers re-write one 2880 x 5760 gray PNG and one RGB
     frame as Paeth-filtered, Adam7 and 16-bit (v * 257) PNGs: each decodes
     to the 8-bit filter-0 file's bits (the 16-bit RGB file's gray read to
     libpng's 16-bit conversion of them), load_images_u8 too. Prints the
     one-thread decode times of the full-size files. (f) BMP, PxM, PAM,
     PFM and Sun raster: the decoders give cv2's digests on embedded
     probes of each kind (RASTER_PROBES), and the same two frames written
     as an 8-bit BMP, a P5 PGM and an 8-bit Sun raster (gray, through a
     gray palette / map) and a 24-bit BMP (RGB) decode to their PNGs' bits
     (the 24-bit BMP's gray read to imgcodecs' gray of them), timed on one
     thread. (g) joint_mvs on phase 6's first MASK_FRAMES = 4 frames with
     a tripod-style mask, as a PNG, as an RLE8 BMP named mask.png and (h)
     as an LZW TIFF in tiles named mask.tif: the same booleans from
     load_mask, every artifact bit-equal, fewer filtered depths in the
     masked pixels than without the mask, phase 6's depth error bound;
     prints K3's launches in each run (`launches_mask` in the kernel
     line: the PNG run's). (h) TIFF: the decoder gives cv2's digests on
     embedded probes (TIFF_PROBES: LZW with the predictor, compat LZW,
     Deflate tiles, planar PackBits, 16-bit RGB, palette, CMYK,
     premultiplied RGBA, YCbCr 4:2:0, orientation 6, a codec cv2 has no
     decoder for, a queued codec), and the two frames of (f) as LZW strips
     with the predictor, Deflate tiles and 16-bit files (TIFF_VARIANTS)
     decode to their PNGs' bits, timed on one thread. (i) The CCITT and
     JPEG-in-TIFF codecs: probes of RLE, RLE/W, Group 3 1-D and 2-D, Group
     4, a cut Group 4 strip and JPEG gray and YCbCr 2x2 tiles at cv2's
     digests (TIFF_PROBES; ThunderScan the queued one); the gray frame of
     (f) thresholded to bilevel as Group 4 (one strip) and Group 3 2-D
     (64-row strips) TIFFs decodes to its PNG's bits, the RGB frame's own
     baseline JPEG as a single-strip JPEG-in-TIFF to the JPEG's colour read,
     the frame as a tiled one to its tiles' standalone decodes, each timed
     on one thread; (g)'s runs once more with the tripod mask as a 1-bit
     Group 4 TIFF named mask.tif, bit-equal to the PNG-mask run. (j) GIF:
     the decoder gives cv2's digests on embedded probes (GIF_PROBES: 256
     colours, interlaced, local over global palette, no palette, an offset
     frame with background and transparency, 87a, minimum code size 11, a
     deferred clear, extensions and a second frame, short sub-blocks, and
     files cv2 gives no image for); the gray frame of (f) as a plain and an
     interlaced deferred-clear 8-bit GIF decodes to its PNG's bits, the RGB
     frame quantised to the 3-3-2 palette to the lookup of its indices,
     each timed on one thread; (g)'s runs once more with the tripod mask as
     a 2-colour GIF named mask.gif, bit-equal to the PNG-mask run.
--only-sfm runs phases 1-2, 8, 8 (b)-(d) and 9 alone (for iterating on the SfM
slice); --only-floor runs phases 1-2 and 12 alone (~170 s on the card);
--only-joint runs phases 1-2, 8, 10 and 13 alone. Prints the card line,
the kernel table as one JSON line, then, as the last line, {"ok": true,
"device": {...}}. In the kernel table, the headline numbers of knn and
knn_ring are those at the odometry stage's inputs (phase 5; the joint
stage's, phase 10, and the Floor stage's, phase 12, are further shapes,
and `launches_joint`, `launches_joint_tracks` (phase 13),
`launches_floor` and `launches_options` (phase 14 (c)) their launches
there; volscore's `launches_sfm_neighbours` and `launches_exact` its
launches in phases 14 (a) and 14 (b); knn_desc's `launches_surgery` and
`launches_gps` are its launches in phases 8 (c) and 8 (d); `launches_ranks`
each kernel's launches per rank in phase 15, by sub-phase and group, empty
for knn_desc, which no stage of phase 15 runs), volscore's those of the D=64
full-scoring shape of phase
3 and knn_desc's those of the fused search at the stage's batch; each
row's max_abs_err is the largest over its shapes, and its "shapes" list
holds each shape's numbers, with the bound of an earlier operation count
beside the current one (`bound_ms_pr3` for volscore and knn_desc;
`bound_ms_pr4` for knn and knn_ring, counting every point and every one
of the B*Q*T pairs, where their bound counts only the valid points'
coordinates and the valid pairs). Exits non-zero without that line
when there is no CUDA device or a phase fails. --profile-mvs wraps phase 6
in torch.profiler and writes its kernel table to chiprun_out/mvs_profile.txt.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import multiprocessing
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
NEAR_TIE = 1e-5
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s,
# float32 operations/s outside the tensor cores, dense TF32 tensor-core
# operations/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
S = ((1.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0))   # lidar z-up -> camera axes


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def bound_ms(n_bytes: float, n_ops: float):
    """Least time on the card: the larger of the bytes at HBM rate and the
    operations at the float32 rate. Returns (ms, "bytes" or "operations")."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ----------------------------------------------------------------------------
# phase 3: kernel vs plain
# ----------------------------------------------------------------------------

def _time_ms(fn, reps: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return (times[(reps - 1) // 2] + times[reps // 2]) / 2


def _check_slots(name, d, i, d_ref, i_ref, d2_full):
    """d2 within rtol/atol 1e-5; an index may differ from the plain one only
    on a near-tie: the plain distance of the kernel's pick is within
    1e-5 * max(1, d2) of the plain slot's distance."""
    import torch
    torch.testing.assert_close(d, d_ref, rtol=1e-5, atol=1e-5, msg=name)
    diff = i != i_ref
    n_ties = int(diff.sum())
    if n_ties:
        b, q, _ = torch.nonzero(diff, as_tuple=True)
        d_pick = d2_full[b, q, i[diff].long()]
        d_slot = d_ref[diff]
        tie = (d_pick - d_slot).abs() <= NEAR_TIE * torch.clamp_min(d_slot, 1.0)
        if not bool(tie.all()):
            fail(f"{name}: {int((~tie).sum())} index mismatches that are not near-ties")
    return float((d - d_ref).abs().max()), n_ties


def knn_valid_counts(q_mask, t_mask):
    """(valid queries, valid targets, valid pairs) over the batch; the
    pairs are the sum of |valid queries_b| x |valid targets_b|, whose
    distances the function needs (a masked pair's output, 1e30, is known
    without one), and only valid points' coordinates need to be read."""
    import torch
    nq, nt = q_mask.sum(1).double(), t_mask.sum(1).double()
    return int(nq.sum()), int(nt.sum()), int(torch.sum(nq * nt))


def _knn_bound(B, Q, T, D, k, ring, valid=None):
    """Bytes: both masks and the valid points' coordinates (+ ring ids) read
    once, (d2, idx) (+ ring outputs) written once for every query;
    operations: 3D+3 per valid (query, target) pair (|q|^2 + |t|^2 - 2 q.t
    and one top-k compare), one more for the ring minimum. `valid` is
    knn_valid_counts(); with None every point and every one of the B*Q*T
    pairs counts (the earlier count, kept as `bound_ms_pr4`)."""
    n_q, n_t, pairs = (B * Q, B * T, B * Q * T) if valid is None else valid
    n_out = k + (4 if ring else 0)
    n_bytes = (B * (Q + T) + (n_q + n_t) * (4 * D + (4 if ring else 0))
               + B * Q * n_out * 8)
    return bound_ms(n_bytes, pairs * (3 * D + 3 + (1 if ring else 0)))


KNN_CHUNK = 256   # pairs per plain-version and library call (phase 3's B)


def knn_case(torch, knn_mod, name, args, k, label):
    """K1 (args q, q_mask, t, t_mask) or K2 (args + q_row, t_row, ring
    offsets +-1, +-2) against its plain version: two launches bit-equal,
    d2 within rtol/atol 1e-5 and indices equal except on near-ties. The
    plain version and the library call (cdist + topk) run on chunks of
    KNN_CHUNK pairs (at the stage's batch they would need tens of GB at
    once); their times are the sums over the chunks. Returns the row."""
    ring = len(args) == 6
    q, qm, t, tm = args[:4]
    B, Q, D = q.shape
    T = t.shape[1]
    kernel = knn_mod.knn_ring if ring else knn_mod.knn
    plain = knn_mod.knn_ring_reference if ring else knn_mod.knn_reference
    out, again = kernel(*args, k), kernel(*args, k)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        fail(f"{name} [{label}]: two launches on the same inputs differ")
    del again
    chunks = [slice(b0, min(B, b0 + KNN_CHUNK)) for b0 in range(0, B, KNN_CHUNK)]
    errs, ties = [0.0], 0
    for sl in chunks:
        part = [a[sl] for a in args]
        ref = plain(*part, k)
        d2_full = knn_mod._dist2(*part[:4])
        for what, j in (("top-k", 0), ("rings", 2))[:2 if ring else 1]:
            e, n = _check_slots(f"{name} {what} [{label}]", out[j][sl], out[j + 1][sl],
                                ref[j], ref[j + 1], d2_full)
            errs.append(e)
            ties += n
        del ref, d2_full
    del out
    torch.cuda.empty_cache()
    valid = knn_valid_counts(qm, tm)
    pairs = valid[2]
    b_ms, b_by = _knn_bound(B, Q, T, D, k, ring, valid)
    b4_ms, _ = _knn_bound(B, Q, T, D, k, ring)
    row = dict(
        max_abs_err=max(errs), near_ties=ties,
        ms=_time_ms(lambda: kernel(*args, k)),
        plain_ms=sum(_time_ms(lambda: plain(*[a[sl] for a in args], k), reps=3)
                     for sl in chunks),
        library_ms=sum(_time_ms(lambda: torch.topk(torch.cdist(q[sl], t[sl]), k,
                                                    largest=False), reps=3)
                       for sl in chunks),
        bound_ms=b_ms, bound_by=b_by, bound_ms_pr4=b4_ms,
        valid_queries=float(qm.float().mean()), valid_targets=float(tm.float().mean()),
        valid_pairs=pairs / (B * Q * T),
        shape=f"B={B} Q={Q} T={T} D={D} k={k}{' rings=4' if ring else ''} ({label})")
    chunked = f" in {len(chunks)} chunks of {KNN_CHUNK} pairs" if len(chunks) > 1 else ""
    log(f"kernel {name} [{row['shape']}]: valid queries {row['valid_queries']:.4f}, "
        f"valid targets {row['valid_targets']:.4f}, valid pairs {row['valid_pairs']:.4f}; "
        f"max |d2 - plain| {row['max_abs_err']:.3g}, near-tie index swaps {ties}, repeat "
        f"bit-equal, kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms{chunked}, "
        f"cdist+topk {row['library_ms']:.3f} ms{chunked}, bound {b_ms:.4f} ms ({b_by}; "
        f"counting every point and pair {b4_ms:.4f} ms)")
    return row


def knn_vs_plain(torch, knn_mod):
    """Phase 3's KNN part: K1 and K2 at the association shapes, B = 256
    pairs of random clouds with 90 % of the points valid, interleaved; K2's
    target ring ids sorted within each pair, as gather_masked orders them."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B = 256

    def cloud(n):
        return (torch.rand((B, n, 3), generator=g, device=dev) * 6.0 - 3.0).contiguous()

    def mask(n):
        return torch.rand((B, n), generator=g, device=dev) > 0.1

    rows = {"knn": knn_case(torch, knn_mod, "knn",
                            (cloud(1024), mask(1024), cloud(1024), mask(1024)), 5, "random")}
    q, t = cloud(512), cloud(4096)
    qm, tm = mask(512), mask(4096)
    qr = torch.randint(0, 16, (B, 512), generator=g, device=dev, dtype=torch.int32)
    tr = torch.randint(0, 16, (B, 4096), generator=g, device=dev,
                       dtype=torch.int32).sort(dim=1).values
    rows["knn_ring"] = knn_case(torch, knn_mod, "knn_ring", (q, qm, t, tm, qr, tr), 10,
                                "random")
    return rows


def knn_at_stage(torch, knn_mod, captured, label="odometry stage, round 0"):
    """Phases 5 and 10: K1 and K2 on the arguments of their first launch in
    a stage (its first association round, B = its pair count)."""
    rows = {}
    for name, nargs in (("knn", 4), ("knn_ring", 6)):
        args = captured[name]
        if name == "knn_ring" and tuple(args[7]) != knn_mod.RING_OFFSETS:
            fail(f"knn_ring was called with ring offsets {args[7]}")
        rows[name] = knn_case(torch, knn_mod, name, tuple(args[:nargs]), args[nargs], label)
    return rows


# K3 arithmetic (csrc/volscore.cu), each operation counted once at the
# level of the indices its value depends on:
#   (pixel, texel): the gray difference, its square, the scale, the exp (4);
#   (candidate, pixel, texel): the texel-ray dot (5), the denominator clamp
#     (2), lambda (1), max and reciprocal (2), the slice coordinate (2) and
#     its clip (2), floor, fraction and 1 - f (3), the weight gate (1),
#     w i_t (1), the three moments of the gray (4): 23;
#   (view, candidate, pixel, texel): the two-slice interpolation (3), w s
#     (1), the three moments with s (5): 9;
#   (candidate, pixel): the plane offset (6), the gray mean and variance
#     (5), the validity tests (3): 14;
#   (view, candidate, pixel): the rest of the NCC epilogue (15).
# The count of the PR 3 kernel, which repeated the lower levels per view and
# candidate, was 36 per (view, candidate, pixel, texel) and 21 per (view,
# candidate, pixel): VOLSCORE_OPS_PR3, kept to compare the two shares.
VOLSCORE_OPS = (("pixel texel", 4), ("candidate pixel texel", 23),
                ("view candidate pixel texel", 9), ("candidate pixel", 14),
                ("view candidate pixel", 15))
VOLSCORE_OPS_PR3 = (36, 21)


def volscore_ops(V, C, T, H, W):
    """Operations of one K3 launch, per level of VOLSCORE_OPS."""
    HW = H * W
    n = {"pixel texel": HW * T, "candidate pixel texel": C * HW * T,
         "view candidate pixel texel": V * C * HW * T, "candidate pixel": C * HW,
         "view candidate pixel": V * C * HW}
    return {level: n[level] * ops for level, ops in VOLSCORE_OPS}


def _volscore_bytes(V, D, C, H, W):
    """The volume (bf16), depth + normals, rays + gray read once; the
    (V, C) costs written once."""
    HW = H * W
    return V * D * HW * 2 + C * HW * 4 * 4 + HW * 4 * 4 + V * C * HW * 4


def _volscore_bound(V, D, C, T, H, W, pr3: bool = False):
    if pr3:
        per_texel, per_pixel = VOLSCORE_OPS_PR3
        n_ops = V * C * H * W * (T * per_texel + per_pixel)
    else:
        n_ops = sum(volscore_ops(V, C, T, H, W).values())
    return bound_ms(_volscore_bytes(V, D, C, H, W), n_ops)


def volscore_cases(pm, cfg, main_path: bool):
    """(label, views, candidates, texel offsets, slice stride) of K3's
    launches: full scoring (and, on the main path, the initial scoring of
    one candidate) over every slice and view, the ranking of 16 candidates
    on the sparse texels, the nearest views and every k-th slice."""
    full = pm._patch_offsets(cfg)
    cases = [("full", 4, 2, full, 1)]
    if main_path:
        cases.append(("init", 4, 1, full, 1))
    cases.append(("rank", cfg.prune_views, 16, pm._cheap_offsets(cfg),
                  cfg.prune_slice_stride))
    return cases


def volscore_vs_plain(torch, cfg, main_path: bool = False):
    """K3 against its plain version at 720 x 1440 (and, outside the main
    path, at 723 x 1443, whose rows and columns end in partial 32 x 8 tiles)
    and the sweep of cfg (cfg.sweep_slices slices over [cfg.min_depth,
    cfg.max_depth]), on inputs with the main path's layout and texture: a
    smooth reference gray and a (4, D, H, W) bf16 volume of shifted copies
    of it plus noise (on white-noise images the bilateral weights leave one
    or two effective texels, and NCC of a near-zero variance amplifies
    rounding), candidate depths inside the sweep range and normals facing
    the camera. Each shape runs the kernel twice: the two results must be
    equal bit for bit."""
    from panovlm_tpu_torch.ops import patchmatch as pm
    from panovlm_tpu_torch.ops import spherical
    from panovlm_tpu_torch.ops import volscore as vs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    V, D = 4, cfg.sweep_slices
    lo, hi = max(cfg.min_depth, 1.0), min(cfg.max_depth, 4.0)
    rows = {}
    for H, W in ((720, 1440),) if main_path else ((720, 1440), (723, 1443)):
        rays = spherical.pixel_ray_grid(H, W, dev)
        rays_cf = rays.permute(2, 0, 1).contiguous()
        yy, xx = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                                torch.arange(W, device=dev, dtype=torch.float32),
                                indexing="ij")
        base = 0.5 + 0.25 * torch.sin(0.11 * xx + 0.07 * yy) * torch.cos(0.05 * yy)
        gray = base + 0.02 * torch.randn((H, W), generator=g, device=dev)
        vols = torch.stack([torch.stack([torch.roll(base, s + 3 * v, dims=1)
                                         for s in range(D)]) for v in range(V)])
        vols = (vols + 0.05 * torch.randn(vols.shape, generator=g, device=dev)
                ).to(torch.bfloat16)

        for label, nv, C, offsets, stride in volscore_cases(pm, cfg, main_path):
            label = f"main path {label}" if main_path else label
            if (H, W) != (720, 1440):
                label = f"{label} {H}x{W}"
            depth = lo + (hi - lo) * torch.rand((C, H, W), generator=g, device=dev)
            n_raw = -rays + 0.3 * torch.randn((C, H, W, 3), generator=g, device=dev)
            nrm = pm.random_normals(n_raw, rays).permute(0, 3, 1, 2).contiguous()
            sub = vols[:nv, ::stride]
            inv0, inv_step = pm._inv_grid(cfg, stride)
            args = (sub, depth, nrm, rays_cf, gray, offsets, inv0, inv_step,
                    cfg.min_depth, cfg.max_depth)
            out = vs.volscore(*args)
            again = vs.volscore(*args)
            ref = vs.volscore_reference(*args)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                fail(f"volscore [{label}]: two launches on the same inputs differ on "
                     f"{int((out != again).sum())} outputs")
            diff = (out - ref).abs()
            err = float(diff.max())
            if not err <= 2e-4:
                fail(f"volscore [{label}]: max |kernel - plain| {err:.3g} > 2e-4 on "
                     f"{int((diff > 2e-4).sum())} of {diff.numel()} outputs")
            shape = (nv, sub.shape[1], C, len(offsets), H, W)
            b_ms, b_by = _volscore_bound(*shape)
            b3_ms, _ = _volscore_bound(*shape, pr3=True)
            rows[label] = dict(
                max_abs_err=err, ms=_time_ms(lambda: vs.volscore(*args)),
                plain_ms=_time_ms(lambda: vs.volscore_reference(*args), reps=3),
                bound_ms=b_ms, bound_by=b_by, bound_ms_pr3=b3_ms,
                shape=(f"V={nv} C={C} T={len(offsets)} D={sub.shape[1]} {H}x{W} "
                       f"depths {cfg.min_depth:.4g}..{cfg.max_depth:.4g} m"))
            del out, again, ref, diff
            r = rows[label]
            log(f"kernel volscore {label} [{r['shape']}]: max |kernel - plain| {err:.3g}, "
                f"repeat bit-equal, kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}; PR 3 count {b3_ms:.4f} ms)")
        del vols
        torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------------------
# phase 4: the odometry stage on a synthetic Room dataset
# ----------------------------------------------------------------------------

ROOM_ODOMETRY_KEYS = """\
angle_residual               = true
point_to_line_residual       = false
line_to_line_residual        = true
point_to_plane_residual      = true
lidar_plane_tolerance        = 0.05
point_to_line_dis_threshold  = 0.3
point_to_plane_dis_threshold = 1.0
normalize_distance           = true
num_iteration_lidar          = 7
"""


def room_loop(n: int, loop: int = 454, sweep_alpha: float = 0.5):
    """The first n scans of the synthetic Room-`loop` trajectory (2.5 loops
    of the room, _room_scale.sh). Returns (scans, lidar poses)."""
    import synthetic
    yaw = 2.5 * 2 * math.pi / loop
    return synthetic.make_trajectory_scans(
        n_scans=n, step=(0.8 * yaw, 0.0, 0.0), yaw_step=yaw, origin=(0.0, 0.0, -1.0),
        noise=0.002, h_steps=1800, sweep_alpha=sweep_alpha, body_step=True)


def _camera_convention(poses):
    """Lidar z-up poses -> (R, t) in the camera-convention world."""
    import numpy as np
    Sm = np.asarray(S)
    return (np.stack([Sm @ p[0] @ Sm.T for p in poses]),
            np.stack([Sm @ p[1] for p in poses]))


def make_room(root: str, n: int, seed: int = 0):
    """The first n scans of the Room-454 loop, a perturbed (2 cm / 0.5 deg,
    scan 0 exact) stage-1 lidar_pose.txt and config.txt. Returns (config
    path, ground-truth lidar poses, mean points per scan)."""
    import numpy as np
    from scipy.spatial.transform import Rotation as ScR
    from panovlm_tpu_torch.io import artifacts
    from panovlm_tpu_torch.io.pointcloud import write_pcd

    scans, poses = room_loop(n)
    os.makedirs(os.path.join(root, "lidar"))
    for i, scan in enumerate(scans):
        write_pcd(os.path.join(root, "lidar", f"{i:06d}.pcd"), scan,
                  intensity=np.zeros(len(scan), np.float32))
    R, t = _camera_convention(poses)
    rng = np.random.default_rng(seed)
    dR = ScR.from_rotvec(rng.normal(size=(n, 3)) * np.radians(0.5)).as_matrix()
    dt = rng.normal(size=(n, 3)) * 0.02
    dR[0], dt[0] = np.eye(3), 0.0
    os.makedirs(os.path.join(root, "result", "sfm"))
    artifacts.export_pose_t(os.path.join(root, "result", "sfm", "lidar_pose.txt"),
                            R @ dR, t + dt)
    cfg = os.path.join(root, "config.txt")
    with open(cfg, "w") as f:
        f.write(f"lidar_path = {root}/lidar\nresult_path = {root}/result\n"
                f"lidar_path_undistort = {root}/result/undis\n"
                f"data_gap_time = 0.1\n{ROOM_ODOMETRY_KEYS}")
    return cfg, poses, sum(len(s) for s in scans) / n


def _copy(x):
    return x.clone() if hasattr(x, "clone") else (x.copy() if hasattr(x, "copy") else x)


class _Held:
    """A tensor kept in host memory, with the device it came from."""

    def __init__(self, t):
        self.t, self.device = t.detach().to("cpu", copy=True), t.device


def _hold(x):
    """A copy of x with every tensor in it held in host memory."""
    return _map_tensors(x, _Held, _hold, _copy)


def _map_tensors(x, on_tensor, recurse, other):
    """x with on_tensor applied to each tensor in it (also in tuples, named
    tuples, lists, dicts and dataclasses such as the solver's blocks)."""
    import dataclasses
    if hasattr(x, "detach"):
        return on_tensor(x)
    if hasattr(x, "_fields"):
        return type(x)(*(recurse(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(recurse(v) for v in x)
    if isinstance(x, dict):
        return {k: recurse(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: recurse(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return other(x)


def _restore(x):
    """_hold's copy with every tensor back on its device."""
    if isinstance(x, _Held):
        return x.t.to(x.device, copy=True)
    return _map_tensors(x, lambda t: t, _restore, lambda v: v)


class _FirstCall:
    """Wraps functions that a module imports and keeps a copy of the
    arguments of each one's first call (keep="last": of its last call),
    with that call's result. host=True keeps both in host memory, so that
    the capture adds nothing to the card's peak memory."""

    def __init__(self, module, names, keep: str = "first", host: bool = False):
        self.module, self.names, self.keep, self.host = module, names, keep, host
        self.args, self.kwargs, self.out = {}, {}, {}

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        keep = _hold if self.host else _copy
        for name, fn in self.saved.items():
            def wrapped(*a, _name=name, _fn=fn, **kw):
                if self.keep == "last" or _name not in self.args:
                    self.args[_name] = [keep(x) for x in a]
                    self.kwargs[_name] = {k: keep(v) for k, v in kw.items()}
                    res = _fn(*a, **kw)
                    self.out[_name] = _hold(res) if self.host else res
                    return res
                return _fn(*a, **kw)
            setattr(self.module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


class _EveryCall:
    """Wraps module.name and appends measure(args, result) of every call to
    .values and its host time to .seconds (calls from several threads too)."""

    def __init__(self, module, name, measure):
        self.module, self.name, self.measure = module, name, measure
        self.values, self.seconds = [], []

    def __enter__(self):
        self.saved = fn = getattr(self.module, self.name)

        def wrapped(*a, **kw):
            t0 = time.time()
            res = fn(*a, **kw)
            self.seconds.append(time.time() - t0)
            self.values.append(self.measure(a, res))
            return res
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def check_odometry_outputs(cfg_path, gt, n_scans: int):
    """The odometry stage's artifact set, one undistorted cloud per scan and
    the consecutive-scan distance error < 0.05 m in both pose files."""
    import numpy as np
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.io import artifacts

    cfg = load_config(cfg_path)
    for name in ("lidar_pose_refined.txt", "lidar_center_refined.pcd",
                 "lidar_pose_refined.ply", "lidar_pose_undis_refined.txt",
                 "lidar_center_undis_refined.pcd"):
        if not os.path.exists(os.path.join(cfg.odo_result_path, name)):
            fail(f"missing artifact {name}")
    n_und = len(os.listdir(cfg.lidar_path_undistort))
    if n_und != n_scans:
        fail(f"{n_und} undistorted clouds for {n_scans} scans")
    d_gt = np.linalg.norm(np.diff(np.stack([p[1] for p in gt]), axis=0), axis=1)
    for name in ("lidar_pose_refined.txt", "lidar_pose_undis_refined.txt"):
        _, t, _, ok = artifacts.read_pose_t(os.path.join(cfg.odo_result_path, name))
        if not ok.all():
            fail(f"{name}: invalid poses")
        err = np.abs(np.linalg.norm(np.diff(t, axis=0), axis=1) - d_gt)
        log(f"{name}: consecutive-scan distance error vs ground truth: "
            f"max {err.max() * 1000:.2f} mm, median {np.median(err) * 1000:.2f} mm")
        if not err.max() < 0.05:
            fail(f"{name}: error {err.max():.4f} m >= 0.05 m at scan {int(err.argmax())}")


def run_odometry(torch, knn_mod, root: str, n_scans: int):
    """Phase 4, on a Room dataset made in root (kept for phase 14 (c)).
    Returns (kernel launches, the arguments of the first knn and knn_ring
    calls, config path, ground-truth poses)."""
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.models import association

    t0 = time.time()
    cfg_path, gt, mean_pts = make_room(root, n_scans)
    log(f"dataset: Room-{n_scans} synthetic, {mean_pts:.0f} points/scan, "
        f"built in {time.time() - t0:.1f} s")
    infos = []
    torch.cuda.reset_peak_memory_stats()
    knn_mod.knn.launches = 0
    knn_mod.knn_ring.launches = 0
    t0 = time.time()
    with _FirstCall(association, ("knn", "knn_ring")) as first:
        rc = port_main(["init_lidar_pose", cfg_path, "--device", "cuda"], infos=infos)
    wall = time.time() - t0
    launches = {"knn": knn_mod.knn.launches, "knn_ring": knn_mod.knn_ring.launches}
    if rc != 0:
        fail(f"init_lidar_pose exited {rc}")
    log(f"odometry stage wall {wall:.1f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for r, info in enumerate(infos):
        log(f"odometry round {r}: {info['pairs']} pairs, cost "
            f"{info['initial_cost']:.6g} -> {info['final_cost']:.6g}, "
            f"{info['iterations']} LM iterations")
    log(f"kernel launches on the odometry path: {launches} in {len(infos)} "
        f"association rounds")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the odometry path was not launched: {launches}")
    if set(launches.values()) != {len(infos)}:
        fail(f"launches {launches} differ from the {len(infos)} association rounds")
    if set(first.args) != {"knn", "knn_ring"}:
        fail(f"the stage's KNN calls were not captured: {sorted(first.args)}")
    check_odometry_outputs(cfg_path, gt, n_scans)
    return launches, first.args, cfg_path, gt


# ----------------------------------------------------------------------------
# phase 6: the MVS stage on the same loop
# ----------------------------------------------------------------------------

ROOM_MVS_KEYS = """\
mvs_use_lidar        = true
scale                = -2
ncc_half_window      = 3
ncc_step             = 1
propagate_strategy   = 2
depth_diff_threshold = 0.01
min_segment          = 100
mvs_use_geometric    = true
keep_lidar_constant  = true
mvs_sweep_slices     = 64
max_depth            = 5
min_depth            = 0.1
"""
PANO_H, PANO_W = 2880, 5760   # Room panoramas; scale -2 works at 720 x 1440
# the MVS panoramas are rendered at half that size and each pixel repeated
# 2 x 2 (cut: the time limit; a full-size colour render took ~80 s of host
# time per frame and kept every timed phase waiting ~230 s after the build)
PANO_RENDER_DOWN = 2


def write_png_gray(path: str, img):
    """Minimal PNG encoder: 8-bit gray, filter type 0 on every row."""
    import numpy as np
    h, w = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 1)))
        f.write(chunk(b"IEND", b""))


# phase 11's colour: channel k of a world point p (LiDAR z-up frame) is
# synthetic._texture(p + COLOR_OFFSETS[k]); channel 0 is the gray texture
COLOR_OFFSETS = ((0.0, 0.0, 0.0), (0.37, -0.21, 0.13), (-0.29, 0.17, 0.41))


def true_color(p_l):
    """The colour of world points (..., 3) in the LiDAR z-up frame, in [0, 1]."""
    import numpy as np
    import synthetic
    p_l = np.asarray(p_l, np.float64)
    return np.clip(np.stack([synthetic._texture(p_l + np.asarray(o)) for o in COLOR_OFFSETS],
                            axis=-1), 0.0, 1.0)


def render_color(C, H: int, W: int, R_wc):
    """A colour panorama (H, W, 3) uint8 of the room seen from C (camera
    convention), each pixel true_color of the point its ray hits, as
    synthetic.render_panorama casts the rays (its gray is channel 0);
    rendered 240 rows at a time, so that a 2880 x 5760 frame needs a few
    hundred MB."""
    import numpy as np
    import synthetic
    band = 240
    Sm = np.asarray(S)
    o_l = Sm.T @ np.asarray(C, np.float64)
    rays = synthetic.pano_rays(H, W).reshape(-1, 3)
    out = np.empty((H * W, 3), np.uint8)
    for r0 in range(0, H, band):
        rays_l = (rays[r0 * W:(r0 + band) * W] @ np.asarray(R_wc).T) @ Sm
        t = synthetic.raycast_room(o_l, rays_l)
        hit = o_l + rays_l * np.where(np.isfinite(t), t, 0.0)[:, None]
        out[r0 * W:(r0 + band) * W] = np.clip(
            true_color(hit).astype(np.float32) * 255, 0, 255).astype(np.uint8)
    return out.reshape(H, W, 3)


def _render_frame(args):
    """Worker: render frame i at panorama size (PANO_RENDER_DOWN), as a gray
    PNG (phase 6) and as a colour JPEG at quality 95, 4:2:0 (phase 11; frame
    0's source array also as .npy), and return its ground-truth depth at the
    working size."""
    path, jpg_path, C, R_wc, pano_hw, work_hw = args
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import numpy as np
    import synthetic
    from panovlm_tpu_torch.io import jpeg
    k = PANO_RENDER_DOWN
    rgb = render_color(C, pano_hw[0] // k, pano_hw[1] // k, R_wc).repeat(k, 0).repeat(k, 1)
    write_png_gray(path, rgb[..., 0])
    jpeg.write_jpeg(jpg_path, rgb, quality=95)
    if jpg_path.endswith("000000.jpg"):
        np.save(jpg_path[:-4] + "_source.npy", rgb)
    write_format_variants(os.path.dirname(os.path.dirname(path)),
                          int(os.path.basename(path)[:6]), rgb)
    return synthetic.render_panorama(C, *work_hw, R_wc=R_wc)[1]


def start_mvs_dataset(root: str, n: int, pool, pano_hw=(PANO_H, PANO_W)):
    """Write the scans, the joint poses and config.txt of the MVS dataset,
    and start rendering its panoramas (pano_hw) on `pool`. Returns (config
    path, async result of the ground-truth depths at the working size)."""
    import numpy as np
    from panovlm_tpu_torch.io import artifacts
    from panovlm_tpu_torch.io.pointcloud import write_pcd

    scans, poses = room_loop(n, sweep_alpha=0.0)
    R, t = _camera_convention(poses)   # T_cl = identity: camera at the LiDAR
    for d in ("images", "color", "undis", "result/joint", "progressive", "arithmetic",
              "lossless", "png_variants"):
        os.makedirs(os.path.join(root, d))
    for i, scan in enumerate(scans):
        write_pcd(os.path.join(root, "undis", f"{i:06d}.pcd"), scan,
                  intensity=np.zeros(len(scan), np.float32))
    for name in ("camera_pose_joint.txt", "lidar_pose_joint.txt"):
        artifacts.export_pose_t(os.path.join(root, "result", "joint", name), R, t)
    cfg = os.path.join(root, "config.txt")
    with open(cfg, "w") as f:
        f.write(f"image_path = {root}/images\nlidar_path = {root}/undis\n"
                f"lidar_path_undistort = {root}/undis\nresult_path = {root}/result\n"
                f"mvs_data_path = {root}/mvs\n{ROOM_MVS_KEYS}")
    work = (pano_hw[0] // 4, pano_hw[1] // 4)      # scale -2
    jobs = [(os.path.join(root, "images", f"{i:06d}.png"),
             os.path.join(root, "color", f"{i:06d}.jpg"), t[i], R[i], pano_hw, work)
            for i in range(n)]
    return cfg, pool.map_async(_render_frame, jobs)


# share of rows H/4..3H/4 that must hold a depth: about 80 % of what the
# H100 run measured (0.185 after post-processing, 0.120 filtered), so that a
# stage that drops most pixels cannot pass on the accuracy of the rest
MVS_MIN_COVERAGE = {"geo (post-processed)": 0.15, "filter": 0.095}


class _RangeFit(logging.Handler):
    """Keeps the arguments of the stage's "sweep range fit" log record:
    (min, max, fitted min, fitted max, slices, fitted slices)."""

    def __init__(self):
        super().__init__()
        self.args = None

    def emit(self, record):
        if str(record.msg).startswith("sweep range fit"):
            self.args = record.args


def run_mvs(torch, vs_mod, cfg_path, d_gt, profile: bool):
    """Phase 6. Returns (K3 launches, the PatchMatchConfig of the sweep the
    stage ran, the capture of its last voxel_downsample call: the fuse, the
    stage's TimeReport)."""
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.models import mvs
    from panovlm_tpu_torch.ops.patchmatch import PatchMatchConfig
    from panovlm_tpu_torch.utils.timing import TimeReport

    cfg = load_config(cfg_path)
    n = len(d_gt)
    tr = TimeReport()
    fit = _RangeFit()
    logging.getLogger("panovlm").addHandler(fit)
    torch.cuda.reset_peak_memory_stats()
    vs_mod.volscore.launches = 0
    t0 = time.time()
    try:
        with _FirstCall(mvs, ("voxel_downsample",), keep="last", host=True) as vox:
            if profile:
                from torch.profiler import ProfilerActivity, profile as tprofile
                with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    rc = port_main(["joint_mvs", cfg_path, "--device", "cuda"], tr=tr)
            else:
                rc = port_main(["joint_mvs", cfg_path, "--device", "cuda"], tr=tr)
    finally:
        logging.getLogger("panovlm").removeHandler(fit)
    wall = time.time() - t0
    launches = vs_mod.volscore.launches
    lo, hi, slices = cfg.min_depth, cfg.max_depth, cfg.mvs_sweep_slices
    if fit.args is not None:
        lo, hi, slices = fit.args[2], fit.args[3], fit.args[5]
    pm_run = PatchMatchConfig(ncc_half_window=cfg.ncc_half_window, ncc_step=cfg.ncc_step,
                              min_depth=float(lo), max_depth=float(hi),
                              sweep_slices=int(slices))
    log(f"MVS sweep: {pm_run.sweep_slices} slices over [{lo:.4f}, {hi:.4f}] m "
        f"({'range fit' if fit.args is not None else 'no range fit'})")
    if rc != 0:
        fail(f"joint_mvs exited {rc}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"MVS stage wall {wall:.1f} s, peak device memory {peak:.2f} GiB, "
        f"volscore launches {launches} ({launches / n:.1f} per frame)")
    for name in ("photometric pass", "geometric pass", "lidar depth init",
                 "post + filter", "fuse + export"):
        sec = tr.time_spent.get(name, float("nan"))
        log(f"  {name}: {sec:.2f} s ({sec / n:.3f} s per frame)")
    if launches <= 0:
        fail("the volscore kernel was not launched on the MVS path")
    if profile:
        write_profile(prof, wall)

    check_mvs_outputs(torch, cfg, d_gt)
    return launches, pm_run, vox, tr


def check_mvs_outputs(torch, cfg, d_gt, label: str = "MVS", floors=None):
    """Phase 6's checks of a joint_mvs run: the artifact set, then in rows
    H/4..3H/4 of every frame against its ground-truth depth d_gt[i] the
    median relative error < 0.08 (post-processed) and the coverage floors
    (MVS_MIN_COVERAGE unless given). Returns {kind: (median error,
    coverage)}."""
    import numpy as np
    from panovlm_tpu_torch.models import mvs

    n = len(d_gt)
    names = sorted(os.listdir(cfg.mvs_depth_path))
    want = sorted(f"{i:06d}_{s}.npy" for i in range(n) for s in ("pho", "geo", "filter"))
    if names != want:
        fail(f"{label}: depth artifacts {names[:6]}... != {want[:6]}...")
    for sub in (cfg.mvs_conf_path, cfg.mvs_normal_path):
        if len(os.listdir(sub)) != 2 * n:
            fail(f"{label}: {sub}: {len(os.listdir(sub))} files for {n} frames x 2 passes")
    if not os.path.exists(os.path.join(cfg.mvs_result_path, "mvs_fused.pcd")):
        fail(f"{label}: missing result/mvs/mvs_fused.pcd")
    errs = {"geo (post-processed)": [], "filter": []}
    for i in range(n):
        geo = torch.from_numpy(np.load(os.path.join(
            cfg.mvs_depth_path, f"{i:06d}_geo.npy")).astype(np.float32) / 256).cuda()
        geo = mvs.gap_interpolation(mvs.remove_small_segments(
            geo, cfg.depth_diff_threshold, cfg.min_segment)).cpu().numpy()
        filt = np.load(os.path.join(cfg.mvs_depth_path, f"{i:06d}_filter.npy")) / 256.0
        H, W = geo.shape
        band = np.zeros((H, W), bool)
        band[H // 4:3 * H // 4] = True
        for key, d in (("geo (post-processed)", geo), ("filter", filt)):
            have = band & (d > 0) & (d_gt[i] > 0)
            errs[key].append((np.abs(d - d_gt[i])[have] / d_gt[i][have], have.sum() / band.sum()))
    floors = MVS_MIN_COVERAGE if floors is None else floors
    out = {}
    for key, parts in errs.items():
        med = float(np.median(np.concatenate([e for e, _ in parts])))
        cover = float(np.mean([c for _, c in parts]))
        out[key] = (med, cover)
        log(f"{label} depth vs ground truth [{key}]: median relative error {med:.4f}, "
            f"coverage {cover:.3f} of rows H/4..3H/4 (floor {floors[key]:.3f})")
    for key, (_, cover) in out.items():
        if not cover >= floors[key]:
            fail(f"{label} [{key}]: coverage {cover:.3f} < {floors[key]:.3f}")
    if not out["geo (post-processed)"][0] < 0.08:
        fail(f"{label}: median relative depth error {out['geo (post-processed)'][0]:.4f} >= 0.08")
    return out


# ----------------------------------------------------------------------------
# phases 8-9: the SfM stage on every 6th frame of the loop, then K1 at D = 128
# ----------------------------------------------------------------------------

ROOM_SFM_KEYS = """\
root_sift                    = true
num_sift                     = 8096
sift_match_dist_threshold    = 0.6
sift_match_num_threshold     = 40
keep_pairs_no_scale          = true
rotation_averaging_method    = 1
translation_averaging_method = 1
use_all_pairs_ra             = true
use_all_pairs_ta             = true
init_translation_DLT         = true
num_iteration_L2IRLS         = 3
upper_scale_ratio            = 1.3
lower_scale_ratio            = 1.0
triangulate_angle_threshold  = 25
colorize_structure           = true
frame_match_method           = 6
max_depth                    = 5
sift_device                  = true
scale                        = 0
"""
SFM_HW = (720, 1440)
SFM_EVERY = 6


def _render_sfm_frame(args):
    """Worker: render one panorama straight at the working size as PNG;
    returns its ground-truth depth (phase 14 (a))."""
    path, C, R_wc, hw = args
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import numpy as np
    import synthetic
    gray, depth = synthetic.render_panorama(C, *hw, R_wc=R_wc)
    write_png_gray(path, np.clip(gray * 255, 0, 255).astype(np.uint8))
    return depth.astype(np.float32)


def start_sfm_dataset(root: str, n: int, pool, hw=SFM_HW, every: int = SFM_EVERY,
                      keys: str = ROOM_SFM_KEYS):
    """Frames 0, every, ..., every * (n - 1) of the Room-454 loop: their scans
    (sweep_alpha 0), config.txt, and the panorama renders started on `pool`.
    Returns (config path, async result of the renders: each frame's
    ground-truth depth, ground truth (R_wc, C) in the camera-convention
    world)."""
    import numpy as np
    from panovlm_tpu_torch.io.pointcloud import write_pcd
    scans, poses = room_loop(every * (n - 1) + 1, sweep_alpha=0.0)
    scans, poses = scans[::every], poses[::every]
    R, t = _camera_convention(poses)   # T_cl = identity: camera at the LiDAR
    for d in ("images", "lidar"):
        os.makedirs(os.path.join(root, d))
    for i, scan in enumerate(scans):
        write_pcd(os.path.join(root, "lidar", f"{i:06d}.pcd"), scan,
                  intensity=np.zeros(len(scan), np.float32))
    cfg = os.path.join(root, "config.txt")
    with open(cfg, "w") as f:
        f.write(f"image_path = {root}/images\nlidar_path = {root}/lidar\n"
                f"result_path = {root}/result\nframe_path = {root}/frames\n"
                f"match_pair_path = {root}/pairs\ndata_gap_time = 0.1\n"
                f"T_cl = 1 0 0 0 0 1 0 0 0 0 1 0\n{keys}")
    jobs = [(os.path.join(root, "images", f"{i:06d}.png"), t[i], R[i], hw) for i in range(n)]
    return cfg, pool.map_async(_render_sfm_frame, jobs), (R, t)


def sfm_pose_errors(path, gt):
    """(max rotation error deg, max camera-centre error m, all valid) of a
    pose file against ground truth, both aligned to frame 0."""
    import numpy as np
    from panovlm_tpu_torch.io import artifacts
    R_wc, t_wc, _, ok = artifacts.read_pose_t(path)
    R_gt, C_gt = gt
    R_al = np.einsum("ij,njk->nik", R_gt[0].T, R_gt)
    C_al = (C_gt - C_gt[0]) @ R_gt[0]
    rot = max(np.degrees(np.arccos(np.clip((np.trace(R_wc[i].T @ R_al[i]) - 1) / 2, -1, 1)))
              for i in range(len(R_wc)) if ok[i]) if ok.any() else float("inf")
    return rot, float(np.abs(t_wc[ok] - C_al[ok]).max()) if ok.any() else float("inf"), bool(ok.all())


def run_sfm(torch, knn_mod, cfg_path, gt):
    """Phase 8. Returns (K1-D128 launches, the stage's match batch, config,
    the captures of its rotation and translation averaging calls)."""
    import numpy as np
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.io import artifacts
    from panovlm_tpu_torch.models import rotation_averaging, sfm, translation_averaging
    from panovlm_tpu_torch.utils.timing import TimeReport

    cfg = load_config(cfg_path)
    tr = TimeReport()
    torch.cuda.reset_peak_memory_stats()
    knn_mod.knn_mutual.launches = 0
    knn_mod.knn.desc_launches = 0
    t0 = time.time()
    with _FirstCall(rotation_averaging, ("rotation_averaging",), host=True) as ra_cap, \
            _FirstCall(translation_averaging, ("translation_averaging",), host=True) as ta_cap:
        rc = port_main(["init_camera_pose", cfg_path, "--device", "cuda"], tr=tr)
    wall = time.time() - t0
    launches = knn_mod.knn_mutual.launches
    if rc != 0:
        fail(f"init_camera_pose exited {rc}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    batch = sfm.match_batch(torch.device("cuda"), int(cfg.num_sift))
    log(f"SfM stage wall {wall:.1f} s, peak device memory {peak:.2f} GiB, "
        f"descriptor KNN launches {launches} (mutual) + {knn_mod.knn.desc_launches} (knn)")
    for name, sec in tr.time_spent.items():
        if name != "init_camera_pose":
            log(f"  {name}: {sec:.2f} s")
    mp = artifacts.load_npz(os.path.join(cfg.match_pair_path, "match_pairs.npz"))
    pts = artifacts.load_npz(os.path.join(cfg.sfm_result_path, "points.npz"))
    with open(os.path.join(cfg.sfm_result_path, "match_pair.txt")) as f:
        n_rel = sum(1 for _ in f) // 3
    n = len(gt[0])
    P = len(mp["pi"])
    log(f"SfM counts: {n} frames, {P} pairs proposed, {int(mp['pair_ok'].sum())} pairs "
        f"with >= {cfg.sift_match_num_threshold} matches, {n_rel} pairs with a relative "
        f"pose, {len(pts['points'])} tracks ({int(pts['point_ok'].sum())} kept), "
        f"matching {tr.time_spent.get('match pairs', 0) / max(P, 1) * 1e3:.2f} ms per pair, "
        f"relative poses {tr.time_spent.get('relative poses', 0) / max(P, 1) * 1e3:.2f} ms per pair")
    if launches != -(-P // batch):
        fail(f"{launches} launches of the fused descriptor search for {P} pairs in "
             f"batches of {batch}: the SfM path did not match one launch per batch")
    rot, dist, all_ok = sfm_pose_errors(
        os.path.join(cfg.sfm_result_path, "camera_pose_final.txt"), gt)
    log(f"camera_pose_final.txt vs ground truth: max rotation error {rot:.4f} deg, "
        f"max camera-centre error {dist * 1000:.2f} mm, every frame valid: {all_ok}")
    if not all_ok:
        fail("init_camera_pose left frames invalid")
    if not (rot < 1.0 and dist < 0.08):
        fail(f"SfM poses off ground truth: {rot:.3f} deg, {dist:.4f} m (bounds 1 deg, 0.08 m)")
    return launches, batch, cfg, {"rotation averaging (L1-ADMM)": (rotation_averaging, ra_cap),
                                  "translation averaging": (translation_averaging, ta_cap)}, tr


def sfm_reproducibility(torch, cfg):
    """ROADMAP F8: the device SIFT and the VLAD proposal run twice more on
    the stage's frames; the descriptors, the embeddings and the proposed
    pairs must equal each other and the stage's own bit for bit. As a
    control, the float scatter_add_ that the SIFT histograms used before
    runs twice on the same inputs at the descriptor-bin shape."""
    import numpy as np
    from panovlm_tpu_torch.io import artifacts, images
    from panovlm_tpu_torch.models import sfm, vlad
    from panovlm_tpu_torch.ops import sift_device as sd

    dev = torch.device("cuda")
    grays, _ = images.load_images(cfg.image_path, cfg.scale)
    H, W = grays[0].shape
    cap = int(cfg.num_sift)
    stage_desc = artifacts.load_npz(os.path.join(cfg.frame_path, "frames_sift.npz"))["desc"]
    mp = artifacts.load_npz(os.path.join(cfg.match_pair_path, "match_pairs.npz"))
    scfg = sfm.SfMConfig(num_sift=cap)
    runs = []
    t0 = time.time()
    for _ in range(2):
        uv, desc, fmask = sd.extract_sift_device_batch(
            np.stack(grays), num_features=cap, root_sift=cfg.root_sift,
            mask=images.load_mask(cfg.mask_path, H, W), device=dev)
        d, m = torch.as_tensor(desc, device=dev), torch.as_tensor(fmask, device=dev)
        _, _, emb = vlad.vlad_pairs(d, m, n_centers=min(64, cap))
        pi, pj = sfm.init_image_pairs(len(grays), scfg, embeddings=emb,
                                      methods=cfg.frame_match_method)
        runs.append(dict(uv=uv, desc=desc, fmask=fmask, emb=emb, pi=pi, pj=pj))
    differ = [k for k in runs[0] if not np.array_equal(runs[0][k], runs[1][k])]
    if not np.array_equal(runs[0]["desc"], stage_desc):
        differ.append("desc vs the stage's")
    if not (np.array_equal(runs[0]["pi"], mp["pi"]) and np.array_equal(runs[0]["pj"], mp["pj"])):
        differ.append("pairs vs the stage's")
    g = torch.Generator(device=dev).manual_seed(3)
    idx = torch.randint(0, 128, (8, cap, 256), generator=g, device=dev)
    src = torch.rand((8, cap, 256), generator=g, device=dev)
    a = torch.zeros((8, cap, 128), device=dev).scatter_add_(2, idx, src)
    b = torch.zeros((8, cap, 128), device=dev).scatter_add_(2, idx, src)
    control = float((a != b).double().mean())
    log(f"F8 reproducibility: device SIFT + VLAD twice more on {len(grays)} frames "
        f"({time.time() - t0:.1f} s): {len(runs[0]['pi'])} pairs, "
        f"{'differ: ' + ', '.join(differ) if differ else 'bit-equal to each other and to the stage'}; "
        f"control: float scatter_add_ at (8, {cap}, 256) -> 128 bins differs between two "
        f"runs on {control:.4%} of the bins")
    if differ:
        fail(f"F8: SfM inputs not reproducible: {differ}")
    return control


# ----------------------------------------------------------------------------
# phase 8 (b): the SfM stage with the configs' own host SIFT (sift_device false)
# ----------------------------------------------------------------------------

# the SHA-256 of what cv2 5.0's SIFT_create().detectAndCompute gives on
# sift_probe_image() on its x86 AVX2 path without IPP (OPENCV_CPU_DISABLE=
# AVX512-SKX, cv2.ipp.setUseIPP(False)): keypoints (x, y, size, angle,
# response) float32, packed octaves int32 and descriptors float32, in cv2's
# order (sift_digest); tests/test_torch_sift_host.py recomputes it with cv2
SIFT_PROBE_SHA256 = "f2be67fb61684823565f901cfff258a872389250056c9cfcc8d96e9c799517c8"


def random_disks(seed: int, h: int, w: int, n: int, rmax: float = 14.0):
    """A uint8 image of n random disks (radius 2..rmax, random levels) on a
    mid-gray field with N(0, 2) noise, made from `seed` with numpy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 128.0, np.float32)
    cx, cy = rng.uniform(0, w, n), rng.uniform(0, h, n)
    r, v = rng.uniform(2.0, rmax, n), rng.uniform(0, 255, n)
    for i in range(n):
        x0, x1 = max(int(cx[i] - r[i]), 0), min(int(cx[i] + r[i]) + 1, w)
        y0, y1 = max(int(cy[i] - r[i]), 0), min(int(cy[i] + r[i]) + 1, h)
        yy, xx = np.ogrid[y0:y1, x0:x1]
        img[y0:y1, x0:x1][(xx - cx[i]) ** 2 + (yy - cy[i]) ** 2 < r[i] ** 2] = v[i]
    img += rng.normal(0, 2.0, img.shape).astype(np.float32)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def sift_probe_image():
    return random_disks(11, 240, 480, 600)


def sift_digest(kp, octave, desc) -> str:
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    for a, t in ((kp, np.float32), (octave, np.int32), (desc, np.float32)):
        h.update(np.ascontiguousarray(a, t).tobytes())
    return h.hexdigest()


def variant_config(cfg_a, name: str, keys: dict, copy: tuple = (), own_frames=False) -> str:
    """config_<name>.txt: phase 8's config.txt with `keys` set and result and
    pair caches of its own under <phase 8's root>/<name> (`copy`: the
    directories of phase 8's tree, "result" and "pairs", copied there
    first); the images, scans and, unless own_frames, the frame cache are
    phase 8's. Returns its path."""
    import shutil
    base = os.path.dirname(cfg_a.result_path)
    root = os.path.join(base, name)
    for d in copy:
        shutil.copytree(os.path.join(base, d), os.path.join(root, d))
    keys = {"result_path": f"{root}/result", "match_pair_path": f"{root}/pairs", **keys}
    if own_frames:
        keys["frame_path"] = f"{root}/frames"
    with open(os.path.join(base, "config.txt")) as f:
        lines = [ln for ln in f.read().splitlines() if ln.split("=")[0].strip() not in keys]
    cfg_path = os.path.join(base, f"config_{name}.txt")
    with open(cfg_path, "w") as f:
        f.write("\n".join(lines + [f"{k} = {v}" for k, v in keys.items()]) + "\n")
    return cfg_path


def run_sfm_host_sift(torch, knn_mod, cfg_a, gt, extract_a: float, device: str = "cuda"):
    """Phase 8 (b): the SfM stage through the CLI on phase 8's frames with
    the Room keys as written (sift_device false, num_threads 25) and no
    frame cache, in a result directory of its own. Checked: the host SIFT's
    bits on the embedded cv2 probe, phase 8's artifact set, every frame
    valid within 1 deg and 0.08 m of ground truth, one fused descriptor
    search per batch of pairs, and a rerun of the extraction bit-equal to
    the stage's frames_sift.npz. Prints keypoints per frame, "extract sift"
    beside phase 8's (the device SIFT) and the time per frame on 1 thread
    and on the threads the stage used."""
    import numpy as np
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.io import artifacts, images
    from panovlm_tpu_torch.models import sfm
    from panovlm_tpu_torch.native import sift as native_sift
    from panovlm_tpu_torch.utils import sift as sift_mod
    from panovlm_tpu_torch.utils.timing import TimeReport

    t0 = time.time()
    (kp, octave, desc), = native_sift.detect_and_compute(sift_probe_image())
    got = sift_digest(kp, octave, desc)
    log(f"host SIFT probe ({len(kp)} keypoints, built in {time.time() - t0:.1f} s): "
        f"{'cv2 bits' if got == SIFT_PROBE_SHA256 else f'DIFFERS {got}'}")
    if got != SIFT_PROBE_SHA256:
        fail("the host SIFT built here does not give cv2's bits on the probe")

    cfg_path = variant_config(cfg_a, "host_sift", {"sift_device": "false", "num_threads": "25"},
                              own_frames=True)
    cfg = load_config(cfg_path)
    tr = TimeReport()
    knn_mod.knn_mutual.launches = 0
    t0 = time.time()
    rc = port_main(["init_camera_pose", cfg_path, "--device", device], tr=tr)
    wall = time.time() - t0
    launches = knn_mod.knn_mutual.launches
    if rc != 0:
        fail(f"init_camera_pose (host SIFT) exited {rc}")
    extract = tr.time_spent.get("extract sift", 0.0)
    log(f"SfM stage with the host SIFT: wall {wall:.1f} s, extract sift {extract:.2f} s "
        f"(phase 8, device SIFT: {extract_a:.2f} s), descriptor KNN launches {launches}")
    for name, sec in tr.time_spent.items():
        if name != "init_camera_pose":
            log(f"  {name}: {sec:.2f} s")

    def listing(c):
        return {os.path.relpath(os.path.join(d, f), c.result_path)
                for d, _, files in os.walk(c.result_path) for f in files}
    if listing(cfg) != listing(cfg_a):
        fail(f"host-SIFT stage artifacts differ from phase 8's: "
             f"{sorted(listing(cfg) ^ listing(cfg_a))[:10]}")
    mp = artifacts.load_npz(os.path.join(cfg.match_pair_path, "match_pairs.npz"))
    P, batch = len(mp["pi"]), sfm.match_batch(torch.device(device), int(cfg.num_sift))
    if device == "cuda" and launches != -(-P // batch):
        fail(f"{launches} launches of the fused descriptor search for {P} pairs in "
             f"batches of {batch}: the host-SIFT SfM path did not match one launch per batch")
    rot, dist, all_ok = sfm_pose_errors(
        os.path.join(cfg.sfm_result_path, "camera_pose_final.txt"), gt)
    log(f"camera_pose_final.txt (host SIFT) vs ground truth: max rotation error {rot:.4f} deg, "
        f"max camera-centre error {dist * 1000:.2f} mm, every frame valid: {all_ok}")
    if not all_ok:
        fail("init_camera_pose (host SIFT) left frames invalid")
    if not (rot < 1.0 and dist < 0.08):
        fail(f"host-SIFT SfM poses off ground truth: {rot:.3f} deg, {dist:.4f} m "
             f"(bounds 1 deg, 0.08 m)")

    stage = artifacts.load_npz(os.path.join(cfg.frame_path, "frames_sift.npz"))
    grays, _ = images.load_images_u8(cfg.image_path, cfg.scale)
    threads = sift_mod.pool_workers(cfg.num_threads)
    t0 = time.time()
    rerun = sift_mod.extract_sift_batch(grays, int(cfg.num_sift), root_sift=cfg.root_sift,
                                        num_threads=cfg.num_threads)
    t_batch = time.time() - t0
    differ = [k for k, v in zip(("uv", "desc", "fmask"), rerun) if not np.array_equal(v, stage[k])]
    t0 = time.time()
    (kp0, _, _), = native_sift.detect_and_compute(grays[0], nfeatures=2 * int(cfg.num_sift))
    t_one = time.time() - t0
    kept = stage["fmask"].sum(1)
    H, W = grays[0].shape
    log(f"host SIFT: features kept per frame min {kept.min()}, median {int(np.median(kept))}, "
        f"max {kept.max()} (cap {cfg.num_sift}); frame 0 detects {len(kp0)} keypoints "
        f"(nfeatures {2 * int(cfg.num_sift)}); {t_one * 1e3:.0f} ms per {H} x {W} frame on "
        f"1 thread, {t_batch / len(grays) * 1e3:.0f} ms per frame on {threads} threads "
        f"(grid distribution and RootSIFT included); rerun "
        f"{'differs: ' + ', '.join(differ) if differ else 'bit-equal to the stage'}")
    if differ:
        fail(f"host SIFT rerun differs from the stage's frames_sift.npz: {differ}")


# ----------------------------------------------------------------------------
# phase 8 (c): pair surgery through the CLI; phase 8 (d): the SfM stage with GPS
# ----------------------------------------------------------------------------

SURGERY_RANGE = (0, 15)          # recompute_pairs: 120 pairs, 8 launches
STRAIGHT = (0, 5, 2)             # set_straight_motion: 9 pairs, 1 launch
GPS_NOISE_M = 0.02


def _surgery_verb(knn_mod, argv, n_pairs, batch, device):
    """One verb through the port's CLI; on the card its fused-search
    launches must be one per batch of its pairs. Returns the launches."""
    from panovlm_tpu_torch.__main__ import main as port_main
    knn_mod.knn_mutual.launches = 0
    t0 = time.time()
    rc = port_main(argv + ["--device", device])
    sec = time.time() - t0
    launches = knn_mod.knn_mutual.launches
    if rc != 0:
        fail(f"{argv[0]} exited {rc}")
    log(f"{' '.join([argv[0]] + argv[2:])}: {n_pairs} pairs, {launches} descriptor KNN "
        f"launches, {sec:.2f} s")
    if device == "cuda" and launches != -(-n_pairs // batch):
        fail(f"{argv[0]}: {launches} launches of the fused descriptor search for {n_pairs} "
             f"pairs in batches of {batch}")
    return launches


def _rows(mp):
    return {(int(a), int(b)): r for r, (a, b) in enumerate(zip(mp["pi"], mp["pj"]))}


def run_pair_surgery(torch, knn_mod, cfg_a, gt, batch, device: str = "cuda"):
    """Phase 8 (c): the pair-surgery verbs through the port's CLI on copies
    of phase 8's result tree. add_pair on the first pair (i, j >= i + 8)
    that phase 8 did not propose and recompute_pairs over frames 0-15, then the
    SfM stage on that copy, reading its caches: each verb's launches one
    per batch, every recomputed row that phase 8 matched bit-equal to phase
    8's, the extra rows kept by the rerun, every frame valid within 1 deg and
    0.08 m. set_straight_motion over frames 0-5 (length 2) on a second
    copy: its rel_poses.npz rows forced (R = I, t = -z, inliers on matched
    pairs), and the two dumps one record per pair and per frame. Returns the
    verbs' launches."""
    import numpy as np
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.io import artifacts
    from panovlm_tpu_torch.utils.timing import TimeReport

    t_all = time.time()
    mp0 = artifacts.load_npz(os.path.join(cfg_a.match_pair_path, "match_pairs.npz"))
    rows0 = _rows(mp0)
    n = len(gt[0])
    new = next(((i, j) for i in range(n) for j in range(i + 8, n) if (i, j) not in rows0), None)
    if new is None:
        fail("phase 8 proposed every pair (i, j >= i + 8): nothing for add_pair to add")
    cfg_path = variant_config(cfg_a, "surgery", {}, copy=("result", "pairs"))
    cfg = load_config(cfg_path)
    launches = {"add_pair": _surgery_verb(knn_mod, ["add_pair", cfg_path, *map(str, new)], 1,
                                          batch, device)}
    a, b = SURGERY_RANGE
    n_quad = (b - a + 1) * (b - a) // 2
    launches["recompute_pairs"] = _surgery_verb(
        knn_mod, ["recompute_pairs", cfg_path, str(a), str(b)], n_quad, batch, device)
    mp1 = artifacts.load_npz(os.path.join(cfg.match_pair_path, "match_pairs.npz"))
    rows1 = _rows(mp1)
    quad = [(p, q) for p in range(a, b + 1) for q in range(p + 1, b + 1)]
    both = [k for k in quad if k in rows0]
    differ = [k for k in both if not all(np.array_equal(mp1[f][rows1[k]], mp0[f][rows0[k]])
                                         for f in ("idx", "mask", "pair_ok"))]
    extra1 = {k for k, r in rows1.items() if mp1["extra"][r]}
    log(f"recomputed rows: {len(both)} of {len(quad)} matched by phase 8 too, "
        f"{'all bit-equal to its rows' if not differ else f'{len(differ)} DIFFER'}; "
        f"{len(rows1)} rows, {len(extra1)} flagged extra")
    if differ:
        fail(f"recompute_pairs: rows differ from phase 8's: {differ[:5]}")
    if new not in extra1:
        fail(f"add_pair {new} is not flagged extra")

    tr = TimeReport()
    knn_mod.knn_mutual.launches = 0
    t0 = time.time()
    if port_main(["init_camera_pose", cfg_path, "--device", device], tr=tr) != 0:
        fail("init_camera_pose after pair surgery failed")
    wall = time.time() - t0
    mp2 = artifacts.load_npz(os.path.join(cfg.match_pair_path, "match_pairs.npz"))
    rows2 = _rows(mp2)
    lost = sorted(k for k in extra1 if k not in rows2)
    kept = sum(bool(mp2["extra"][rows2[k]]) for k in extra1 if k in rows2)
    rot, dist, all_ok = sfm_pose_errors(
        os.path.join(cfg.sfm_result_path, "camera_pose_final.txt"), gt)
    log(f"SfM stage after the surgery: wall {wall:.1f} s (relative poses "
        f"{tr.time_spent.get('relative poses', 0):.2f} s), {len(rows2)} pairs, "
        f"{knn_mod.knn_mutual.launches} descriptor KNN launches, {kept} of {len(extra1)} "
        f"extra rows still flagged (the others now proposed); max rotation error "
        f"{rot:.4f} deg, max camera-centre error {dist * 1000:.2f} mm, every frame valid: "
        f"{all_ok}")
    if lost:
        fail(f"the stage rerun dropped the surgery rows {lost[:5]}")
    if knn_mod.knn_mutual.launches:
        fail("the stage rerun matched pairs again instead of reading its cache")
    if not (all_ok and rot < 1.0 and dist < 0.08):
        fail(f"SfM poses after the surgery off ground truth: {rot:.3f} deg, {dist:.4f} m, "
             f"all valid {all_ok}")

    # set_straight_motion and the dumps on a second copy
    s0, s1, length = STRAIGHT
    cfg2_path = variant_config(cfg_a, "straight", {}, copy=("result", "pairs"))
    cfg2 = load_config(cfg2_path)
    forced = [(p, q) for p in range(s0, s1) for q in range(p + 1, min(p + length, s1) + 1)]
    launches["set_straight_motion"] = _surgery_verb(
        knn_mod, ["set_straight_motion", cfg2_path, str(s0), str(s1), str(length)],
        len(forced), batch, device)
    rc = artifacts.load_npz(os.path.join(cfg2.match_pair_path, "rel_poses.npz"))
    mp3 = artifacts.load_npz(os.path.join(cfg2.match_pair_path, "match_pairs.npz"))
    rrows, mrows = _rows(rc), _rows(mp3)
    bad = [k for k in forced if k not in rrows or not (
        np.all(rc["rel_aa"][rrows[k]] == 0) and np.array_equal(rc["rel_t"][rrows[k]], [0, 0, -1])
        and rc["ok"][rrows[k]]
        and (rc["n_inliers"][rrows[k]] > 0 or not mp3["pair_ok"][mrows[k]]))]
    inl = [int(rc["n_inliers"][rrows[k]]) for k in forced if k in rrows]
    log(f"set_straight_motion rows: {len(forced)} forced pairs, inliers per pair {inl}, "
        f"{sum(bool(mp3['pair_ok'][mrows[k]]) for k in forced)} matched; "
        f"{'all forced' if not bad else f'{bad} NOT forced'}")
    if bad:
        fail(f"set_straight_motion: rows not forced or without inliers: {bad}")
    for verb, count, per in (("dump_relative_poses", len(rc["pi"]), "pair"),
                             ("dump_global_poses", len(gt[0]), "frame")):
        out = os.path.join(cfg2.sfm_result_path, f"{verb}.txt")
        if port_main([verb, cfg2_path, out, "--device", device]) != 0:
            fail(f"{verb} failed")
        with open(out) as f:
            records = sum(1 for ln in f if ln.startswith(per))
        log(f"{verb}: {records} records ({count} {per}s)")
        if records != count:
            fail(f"{verb} wrote {records} records for {count} {per}s")
    log(f"phase 8 (c) (pair surgery): {time.time() - t_all:.1f} s")
    return launches


def run_sfm_gps(torch, knn_mod, cfg_a, gt, batch, device: str = "cuda"):
    """Phase 8 (d): the SfM stage with a GPS file (the true camera centres
    plus GPS_NOISE_M of seeded noise, `name x y z` per frame),
    frame_match_method 6 | 8, init_translation_GPS on and
    init_translation_DLT off, on phase 8's frame cache with pair caches of
    its own. Checked: the GPS pairs proposed, one fused search per batch of
    pairs, every frame valid within 1 deg and 0.08 m. Returns the launches."""
    import numpy as np
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.io import artifacts
    from panovlm_tpu_torch.models import translation_averaging
    from panovlm_tpu_torch.utils.gps import gps_pairs, read_gps, scale_from_gps
    from panovlm_tpu_torch.utils.timing import TimeReport

    R, C = gt
    gps = C + np.random.default_rng(12).normal(size=C.shape) * GPS_NOISE_M
    path = os.path.join(os.path.dirname(cfg_a.result_path), "gps.txt")
    with open(path, "w") as f:
        f.writelines(f"{i:06d}.png {x:.6f} {y:.6f} {z:.6f}\n" for i, (x, y, z) in enumerate(gps))
    cfg_path = variant_config(cfg_a, "gps", {
        "gps_path": path, "frame_match_method": "14", "init_translation_GPS": "true",
        "init_translation_DLT": "false"})
    cfg = load_config(cfg_path)
    xyz = read_gps(path)[0]
    tr = TimeReport()
    knn_mod.knn_mutual.launches = 0
    t0 = time.time()
    with _FirstCall(translation_averaging, ("translation_averaging",), host=True) as ta_cap:
        if port_main(["init_camera_pose", cfg_path, "--device", device], tr=tr) != 0:
            fail("init_camera_pose with GPS failed")
    wall = time.time() - t0
    ta_args = ta_cap.args["translation_averaging"]
    gps_used = (ta_cap.kwargs["translation_averaging"].get("t_init") is not None
                and np.array_equal(ta_args[5], scale_from_gps(xyz, ta_args[1], ta_args[2])))
    launches = knn_mod.knn_mutual.launches
    mp = artifacts.load_npz(os.path.join(cfg.match_pair_path, "match_pairs.npz"))
    rows, rows0 = _rows(mp), _rows(artifacts.load_npz(
        os.path.join(cfg_a.match_pair_path, "match_pairs.npz")))
    want = set(zip(*(a.tolist() for a in gps_pairs(xyz, 7.0, 15))))
    missing = sorted(want - set(rows))
    rot, dist, all_ok = sfm_pose_errors(
        os.path.join(cfg.sfm_result_path, "camera_pose_final.txt"), gt)
    log(f"SfM stage with GPS ({GPS_NOISE_M * 100:.0f} cm noise): wall {wall:.1f} s "
        f"(translation averaging {tr.time_spent.get('translation averaging', 0):.2f} s), "
        f"{len(rows)} pairs ({len(want)} GPS pairs, {len(set(rows) - set(rows0))} not in "
        f"phase 8's), {launches} descriptor KNN launches, GPS scales and init taken: "
        f"{gps_used}; max rotation error {rot:.4f} deg, "
        f"max camera-centre error {dist * 1000:.2f} mm, every frame valid: {all_ok}")
    if missing:
        fail(f"GPS pairs not proposed: {missing[:5]}")
    if not gps_used:
        fail("translation averaging did not take the GPS scales and init")
    if device == "cuda" and launches != -(-len(rows) // batch):
        fail(f"{launches} launches of the fused descriptor search for {len(rows)} pairs in "
             f"batches of {batch}")
    if not (all_ok and rot < 1.0 and dist < 0.08):
        fail(f"SfM poses with GPS off ground truth: {rot:.3f} deg, {dist:.4f} m, "
             f"all valid {all_ok}")
    log(f"phase 8 (d) (SfM with GPS): {time.time() - t0:.1f} s")
    return launches


# K1 at D = 128, the fused search (csrc/knn_desc.cu, one launch per batch):
# per (query, target) pair D products, each three TF32 tensor-core
# multiply-adds (3xTF32: 6 operations) at the dense TF32 rate; at the fp32
# rate the epilogue, 6 per pair (|q|^2 + |t|^2, -2 q.t, clamp, mask test,
# the forward top-k compare, the reverse minimum), and the norms, 2D per
# row. The PR 3 count, two launches of D fp32 FMAs + 6 per pair at the
# fp32 rate, is kept as `pr3` to compare the two shares.
KNN_DESC_EPILOGUE_OPS = 6
KNN_DESC_OPS_PER_PAIR_PR3 = lambda D: 2 * D + 6


def knn_mutual_work(B, Q, T, D):
    """(bytes, tensor-core operations, fp32 operations) of one fused launch:
    descriptors and masks read once, the forward (d2, idx) top-2 and the
    reverse 8-byte keys written once."""
    n_bytes = B * (Q + T) * (4 * D + 1) + B * Q * 2 * 8 + B * T * 8
    return n_bytes, B * Q * T * D * 6, B * Q * T * KNN_DESC_EPILOGUE_OPS + B * (Q + T) * 2 * D


def knn_mutual_bound(B, Q, T, D, pr3: bool = False):
    """Least time of the fused search: the larger of the bytes at HBM rate
    and the operations (tensor-core part at the TF32 rate plus the fp32
    part at the fp32 rate); with pr3, the bound of the two fp32 launches
    it replaced."""
    n_bytes, tc_ops, f32_ops = knn_mutual_work(B, Q, T, D)
    if pr3:
        return bound_ms(n_bytes, 2 * B * Q * T * KNN_DESC_OPS_PER_PAIR_PR3(D))
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = (tc_ops / TF32_OPS_PER_S + f32_ops / F32_OPS_PER_S) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def knn_mutual_vs_plain(torch, knn_mod, cfg, B):
    """Phase 9: K1 at D = 128, the fused forward top-2 + reverse top-1, on
    the stage's first B proposed pairs (Q = T = num_sift) and on a ragged
    cut of them (Q = 5000, T = 7001 with a fifth of the rows masked more),
    against two plain searches; every launch twice, bit-equal."""
    from panovlm_tpu_torch.io import artifacts
    fr = artifacts.load_npz(os.path.join(cfg.frame_path, "frames_sift.npz"))
    mp = artifacts.load_npz(os.path.join(cfg.match_pair_path, "match_pairs.npz"))
    dev = torch.device("cuda")
    desc = torch.as_tensor(fr["desc"], device=dev)
    fmask = torch.as_tensor(fr["fmask"], device=dev)
    pi = torch.as_tensor(mp["pi"][:B].astype("int64"), device=dev)
    pj = torch.as_tensor(mp["pj"][:B].astype("int64"), device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    full = (desc[pi], fmask[pi], desc[pj], fmask[pj])
    Qr, Tr = min(5000, desc.shape[1]), min(7001, desc.shape[1])
    ragged = (full[0][:, :Qr].contiguous(),
              full[1][:, :Qr] & (torch.rand((len(pi), Qr), generator=g, device=dev) > 0.2),
              full[2][:, :Tr].contiguous(),
              full[3][:, :Tr] & (torch.rand((len(pi), Tr), generator=g, device=dev) > 0.2))
    rows = {}
    for label, (q, qm, t, tm) in (("mutual", full), ("ragged", ragged)):
        Bq, Q, D = q.shape
        T = t.shape[1]
        out = knn_mod.knn_mutual(q, qm, t, tm)
        again = knn_mod.knn_mutual(q, qm, t, tm)
        ref = knn_mod.knn_mutual_reference(q, qm, t, tm)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            fail(f"knn_mutual [{label}]: two launches on the same inputs differ")
        d2_full = knn_mod._dist2(q, qm, t, tm)
        err_f, ties_f = _check_slots(f"knn_mutual {label} forward", out[0], out[1],
                                     ref[0], ref[1], d2_full)
        err_r, ties_r = _check_slots(f"knn_mutual {label} reverse", out[2], out[3],
                                     ref[2], ref[3], d2_full.transpose(1, 2))
        del d2_full, out, again, ref

        def library():
            dd = torch.cdist(q, t)
            return torch.topk(dd, 2, largest=False), torch.min(dd, dim=1)
        b_ms, b_by = knn_mutual_bound(Bq, Q, T, D)
        b3_ms, _ = knn_mutual_bound(Bq, Q, T, D, pr3=True)
        rows[label] = dict(
            max_abs_err=max(err_f, err_r), near_ties=ties_f + ties_r,
            ms=_time_ms(lambda: knn_mod.knn_mutual(q, qm, t, tm)),
            plain_ms=_time_ms(lambda: knn_mod.knn_mutual_reference(q, qm, t, tm), reps=3),
            library_ms=_time_ms(library, reps=3),
            bound_ms=b_ms, bound_by=b_by, bound_ms_pr3=b3_ms,
            shape=f"B={Bq} Q={Q} T={T} D={D} k=2 + reverse k=1")
        r = rows[label]
        log(f"kernel knn_desc {label} [{r['shape']}]: max |d2 - plain| {r['max_abs_err']:.3g}, "
            f"near-tie index swaps {ties_f} forward + {ties_r} reverse, repeat bit-equal, "
            f"kernel {r['ms']:.3f} ms, plain (two searches) {r['plain_ms']:.3f} ms, "
            f"cdist+topk+min {r['library_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"PR 3 fp32 two-launch bound {b3_ms:.4f} ms)")
        torch.cuda.empty_cache()
    return rows


def write_profile(prof, wall):
    ka = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in ka
                 if e.device_type is not None and "cuda" in str(e.device_type).lower())
    table = ka.table(sort_by="self_device_time_total", row_limit=30)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "mvs_profile.txt"), "w") as f:
        f.write(f"wall {wall:.3f} s, device self time {dev_us / 1e6:.3f} s\n{table}\n")
    log(f"MVS profile: wall {wall:.2f} s (profiling on), device self time "
        f"{dev_us / 1e6:.2f} s; table in chiprun_out/mvs_profile.txt")
    log(table)


# ----------------------------------------------------------------------------
# phase 10: the joint stage on the port's own SfM and odometry outputs; F9
# ----------------------------------------------------------------------------

# configs/Room.txt:36,58,66,69-73: image lines and joint optimization
ROOM_JOINT_KEYS = """\
ncc_threshold                = 0
num_iteration_joint          = 5
neighbor_size_joint          = 1
camera_weight                = 1
lidar_weight                 = 0.01
camera_lidar_weight          = 25
"""
JOINT_ARTIFACTS = ("camera_pose_joint.txt", "lidar_pose_joint.txt", "points.npz",
                   "camera_center_joint.pcd", "lidar_center_joint.pcd",
                   "camera_pose_joint.ply", "lidar_pose_joint.ply")
# fused image arcs per frame before the cap of 128 cuts them: about 80 %
# of the mean first measured on the H100 at the phase's 48 frames (193.0;
# 353.8 LSD segments per frame), so that a detector or a fusion that finds
# fewer lines cannot pass on the pose bounds alone
JOINT_MIN_ARCS = 154.0
# consecutive-scan distance error (m; max, median) of the LiDAR poses that
# the JAX package's joint_optimize gives on this phase's joint_optimize
# arguments (tests/joint_chain_reference.py on the CPU, 8 devices, from the
# chiprun_out/joint_chain.npz that this phase keeps). With the Room weights
# the reference moves the LiDAR poses off the odometry's (8.65 mm) by this
# much, so the port's joint output is held to JOINT_LIDAR_MARGIN times it.
JOINT_LIDAR_REF = (0.56605, 0.02716)
JOINT_LIDAR_MARGIN = 1.25


def _bits(x):
    """Every leaf of a nested result as bytes, for bit-equality."""
    import numpy as np
    if isinstance(x, (tuple, list)):
        return b"".join(_bits(v) for v in x)
    if isinstance(x, dict):
        return b"".join(k.encode() + _bits(x[k]) for k in sorted(x))
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy().tobytes()
    if isinstance(x, np.ndarray):
        return x.tobytes()
    return repr(x).encode()


def f9_reruns(torch, captures):
    """ROADMAP F9: each captured stage call (captured with host=True) runs
    twice more on its own inputs, each back on its device; both results
    must equal the stage's bit for bit."""
    for name, (module, cap) in captures.items():
        (fn_name,) = cap.args
        fn = getattr(module, fn_name)
        t0 = time.time()
        args, kwargs = _restore(cap.args[fn_name]), _restore(cap.kwargs[fn_name])
        runs = [fn(*args, **kwargs) for _ in range(2)]
        torch.cuda.synchronize()
        same = [_bits(r) == _bits(_restore(cap.out[fn_name])) for r in runs]
        log(f"F9 rerun of {name} ({fn_name}) on the stage's inputs, twice "
            f"({time.time() - t0:.1f} s): {'bit-equal to the stage' if all(same) else 'DIFFERS'}")
        if not all(same):
            fail(f"F9: {name} is not reproducible on the card")


def _joint_outputs(cfg):
    from panovlm_tpu_torch.io import artifacts
    out = []
    for name in JOINT_ARTIFACTS[:2]:
        with open(os.path.join(cfg.joint_result_path, name), "rb") as f:
            out.append(f.read())
    out.append(artifacts.read_point_tracks(
        os.path.join(cfg.joint_result_path, "points.npz"))["points"].tobytes())
    return out


def save_joint_chain(cap, gt, path):
    """The arguments and the card's result of the joint stage's
    joint_optimize call, with ground truth, as one npz: the input of
    tests/joint_chain_reference.py, which runs the JAX joint_optimize and
    the port's on the CPU on them."""
    import numpy as np

    def host(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)

    (arcs, feats, *arrays, jcfg), kw = cap.args["joint_optimize"], cap.kwargs["joint_optimize"]
    names = ("cam_poses0", "lidar_poses0", "track_img", "track_feat", "track_mask",
             "bearings", "points0", "point_ok")
    cam, lidar, points, _ = cap.out["joint_optimize"]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path, **{f"arc_{k}": host(v) for k, v in arcs.items()},
        **{f"lidar_{k}": host(v) for k, v in feats.items()},
        **{n: host(a) for n, a in zip(names, arrays)}, lidar_valid=host(kw["lidar_valid"]),
        out_cam=host(cam), out_lidar=host(lidar), out_points=host(points),
        gt_R=gt[0], gt_C=gt[1], jcfg=json.dumps(jcfg._asdict()))
    log(f"joint_optimize inputs and card result kept in {os.path.relpath(path, HERE)} "
        f"({os.path.getsize(path) / 2**20:.1f} MiB)")


def run_joint_chain(torch, knn_mod, sfm_cfg_path, gt):
    """Phase 10: the odometry stage on the SfM dataset's scans, seeded from
    the SfM stage's sfm/lidar_pose.txt, then the joint stage with the Room
    joint keys, twice (F9). Returns (kernel launches of the joint run,
    the arguments of its first knn and knn_ring calls)."""
    import numpy as np
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.io import artifacts
    from panovlm_tpu_torch.models import association, camera_lidar
    from panovlm_tpu_torch.solver import lm
    from panovlm_tpu_torch.utils import panorama_line
    from panovlm_tpu_torch.utils.timing import TimeReport

    root = os.path.dirname(sfm_cfg_path)
    cfg_path = os.path.join(root, "chain_config.txt")
    with open(sfm_cfg_path) as f:
        text = f.read()
    # the SfM scans carry no sweep distortion: a data gap of 9.9 s puts the
    # undistortion's sweep fraction at 0.1 / (0.1 + 9.9) = 1 %
    with open(cfg_path, "w") as f:
        f.write(f"{text}lidar_path_undistort = {root}/result/undis\ndata_gap_time = 9.9\n"
                f"{ROOM_ODOMETRY_KEYS}{ROOM_JOINT_KEYS}")
    cfg = load_config(cfg_path)
    R_gt, C_gt = gt
    d_gt = np.linalg.norm(np.diff(C_gt, axis=0), axis=1)

    def lidar_error(path, bound, median_bound=None):
        _, t, _, ok = artifacts.read_pose_t(path)
        if not (ok.all() and np.isfinite(t).all()):
            fail(f"{path}: invalid poses")
        err = np.abs(np.linalg.norm(np.diff(t, axis=0), axis=1) - d_gt)
        log(f"{os.path.basename(path)}: consecutive-scan distance error vs ground truth: "
            f"max {err.max() * 1000:.2f} mm (scan {int(err.argmax())}), "
            f"median {np.median(err) * 1000:.2f} mm")
        if not err.max() < bound:
            fail(f"{path}: error {err.max():.4f} m >= {bound} m at scan {int(err.argmax())}")
        if median_bound is not None and not np.median(err) < median_bound:
            fail(f"{path}: median error {np.median(err):.4f} m >= {median_bound} m")

    t0 = time.time()
    if port_main(["init_lidar_pose", cfg_path, "--device", "cuda"]) != 0:
        fail("init_lidar_pose on the SfM dataset failed")
    log(f"odometry on the SfM dataset's {len(d_gt) + 1} scans: {time.time() - t0:.1f} s")
    lidar_error(os.path.join(cfg.odo_result_path, "lidar_pose_undis_refined.txt"), 0.05)

    tr = TimeReport()
    largest = {}
    exact_sum = lm.index_sum

    def keep_largest(n, index, src):   # the biggest scattered sum of the solve
        if src.numel() > largest.get("src", src.new_zeros(0)).numel():
            largest.update(n=n, index=index, src=src)
        return exact_sum(n, index, src)

    torch.cuda.reset_peak_memory_stats()
    knn_mod.knn.launches = 0
    knn_mod.knn_ring.launches = 0
    lm.index_sum = keep_largest
    t0 = time.time()
    try:
        with _FirstCall(association, ("knn", "knn_ring")) as first, \
                _FirstCall(panorama_line, ("extract_panorama_lines_batch",)) as lines, \
                _EveryCall(panorama_line, "detect_lsd", lambda a, res: len(res)) as segs, \
                _EveryCall(panorama_line, "pad_arcs", lambda a, res: len(a[0]["arc"])) as fused, \
                _FirstCall(camera_lidar, ("joint_optimize",)) as joint:
            rc = port_main(["joint_optimization", cfg_path, "--device", "cuda"], tr=tr)
    finally:
        lm.index_sum = exact_sum
    wall = time.time() - t0
    launches = {"knn": knn_mod.knn.launches, "knn_ring": knn_mod.knn_ring.launches}
    if rc != 0:
        fail(f"joint_optimization exited {rc}")
    log(f"joint stage wall {wall:.1f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, sec in tr.time_spent.items():
        if name != "joint_optimization":
            log(f"  {name}: {sec:.2f} s")
    for name in JOINT_ARTIFACTS:
        if not os.path.exists(os.path.join(cfg.joint_result_path, name)):
            fail(f"missing artifact result/joint/{name}")
    arcs = lines.out["extract_panorama_lines_batch"]["mask"].sum(axis=1)
    segs, fused = np.asarray(segs.values), np.asarray(fused.values)
    log(f"image lines per frame: LSD segments mean {segs.mean():.1f} (min {segs.min()}, "
        f"max {segs.max()}), fused arcs mean {fused.mean():.1f} (min {fused.min()}, "
        f"max {fused.max()}), kept arcs mean {arcs.mean():.1f} (cap "
        f"{lines.out['extract_panorama_lines_batch']['mask'].shape[1]})")
    if not fused.mean() >= JOINT_MIN_ARCS:
        fail(f"{fused.mean():.1f} fused arcs per frame < {JOINT_MIN_ARCS}")
    log(f"kernel launches on the joint path: {launches} in {cfg.num_iteration_joint} rounds")
    if set(launches.values()) != {cfg.num_iteration_joint}:
        fail(f"launches {launches} differ from the {cfg.num_iteration_joint} joint rounds")
    rot, dist, all_ok = sfm_pose_errors(
        os.path.join(cfg.joint_result_path, "camera_pose_joint.txt"), gt)
    log(f"camera_pose_joint.txt vs ground truth: max rotation error {rot:.4f} deg, "
        f"max camera-centre error {dist * 1000:.2f} mm, every frame valid: {all_ok}")
    if not (all_ok and rot < 1.0 and dist < 0.08):
        fail(f"joint camera poses off ground truth: {rot:.3f} deg, {dist:.4f} m, "
             f"all valid {all_ok} (bounds 1 deg, 0.08 m)")
    save_joint_chain(joint, gt, os.path.join(HERE, "chiprun_out", "joint_chain.npz"))
    del joint
    # not the 0.05 m of the odometry output: on these inputs the JAX
    # joint_optimize itself moves the LiDAR poses that far (JOINT_LIDAR_REF)
    ref_max, ref_median = JOINT_LIDAR_REF
    log(f"LiDAR error of the JAX joint_optimize on the same inputs: max {ref_max * 1000:.2f} "
        f"mm, median {ref_median * 1000:.2f} mm; bounds {JOINT_LIDAR_MARGIN} x those")
    lidar_error(os.path.join(cfg.joint_result_path, "lidar_pose_joint.txt"),
                JOINT_LIDAR_MARGIN * ref_max, JOINT_LIDAR_MARGIN * ref_median)

    # F9: the stage again on the same inputs, every output bit-equal
    first_out = _joint_outputs(cfg)
    t0 = time.time()
    if port_main(["joint_optimization", cfg_path, "--device", "cuda"]) != 0:
        fail("joint_optimization (second run) failed")
    same = [a == b for a, b in zip(first_out, _joint_outputs(cfg))]
    log(f"F9: joint stage rerun ({time.time() - t0:.1f} s): camera poses, LiDAR poses, "
        f"points {'bit-equal' if all(same) else f'DIFFER {same}'}")
    if not all(same):
        fail(f"F9: the joint stage is not reproducible on the card: {same}")
    # control: the float index_add_ this PR replaced, twice on the same terms
    n, index, src = largest["n"], largest["index"], largest["src"]
    a = torch.zeros((n, *src.shape[1:]), dtype=src.dtype, device=src.device).index_add_(0, index, src)
    b = torch.zeros_like(a).index_add_(0, index, src)
    e1, e2 = exact_sum(n, index, src), exact_sum(n, index, src)
    touched = torch.zeros(n, dtype=torch.bool, device=src.device)
    touched[index] = True
    log(f"F9 control: float index_add_ of the solve's largest sum ({src.numel()} terms "
        f"into {int(touched.sum())} entries) twice: {float((a != b)[touched].double().mean()):.4%} "
        f"of the entries differ; index_sum twice: "
        f"{'bit-equal' if torch.equal(e1, e2) else 'DIFFERS'}")
    if not torch.equal(e1, e2):
        fail("F9: index_sum differs between two runs")
    return launches, first.args


# ----------------------------------------------------------------------------
# phase 11: the colorize stage on colour JPEG panoramas, and on phase 10's
# outputs
# ----------------------------------------------------------------------------

# the port's q95 4:2:0 JPEG of a colour panorama, decoded, against the
# array it was encoded from: mean and max |difference| (u8 levels), the
# bounds that tests/test_torch_jpeg.py holds the round trip to on frames 0
# and 8 at 360 x 720 (measured there: mean 2.38 and 2.38, max 56 and 62).
# The mean falls as the panorama grows, the texture then varying less per
# pixel (0.548 at 2880 x 5760, frame 0, in a CPU rehearsal); the max is set
# by colour edges, where one 4:2:0 chroma sample spans both sides (63 there)
JPEG_Q95_MEAN, JPEG_Q95_MAX = 2.5, 80
# a cv2-written JPEG (37 x 53, 4:2:0, quality 90, restart interval 2) and
# the SHA-256 of what cv2.imread gives for it in colour (RGB order) and in
# gray; tests/test_torch_jpeg.py checks both against cv2 and the port
JPEG_PROBE_B64 = (
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAMCAgMCAgMDAwMEAwMEBQgFBQQEBQoHBwYIDAoMDAsKCwsNDhIQDQ4R"
    "DgsLEBYQERMUFRUVDA8XGBYUGBIUFRT/2wBDAQMEBAUEBQkFBQkUDQsNFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQU"
    "FBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBT/wAARCAAlADUDASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAA"
    "AAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAk"
    "M2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKT"
    "lJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QA"
    "HwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdh"
    "cRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hp"
    "anN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
    "5ebn6Onq8vP09fb3+Pn6/90ABAAC/9oADAMBAAIRAxEAPwDf+KfjKy0+BooW8u8LkokK5O3B+6cYB56cD2GTXyp4"
    "i8aX+p6nHEhZIkOEZwRk845J4PHAYdPzq1F4j1XxjcRQyCSJdw/dFSic9ACM56kcY6nniva/AXwEkvc3c0SyfMu+"
    "QpkFcnIBOR6jge3cV5OQcL4ThukvrKvJn1jy7D4qj9awE+Rpa+f9f1c5H4T/AA5XxM0U9/GMOPlQj5VXkeuD05+u"
    "OM19T+G/hBZadpsLhA9zlZQ8agdAR8x7HqMnI7ZHIFbR/ByeCoYXit0hEQAWJkAV+CXPHA5OOo6fWmah8T4LK1Zi"
    "1vbRqCCzngYxng4xwOeMYzjqa+1p5bi8zqc1B2h+Hz7afefmmacbU6k/7Jteo9L9+39f8A//0PWPEfilPDdu0SFY"
    "praMsYlTaoABGMnO7Oc+/wCg8n8VfGwCMw2/72d4wRGdxAJHO7GCMZH4enJGR47+I6eI7VLfSEiZVAeUhiMNz93p"
    "gcD5j69ua8Xm0S8mvnjBIjJAEbsQAhBbJGffue/1z6WK4nwmGg8DkiU6v2qrV0unuL7TV78z91dOa90+HfD7E5VL"
    "+2s5nenuo+W/y/A6rWLKXxfcG8uL0n5jhUO0ITg7QMjoNvc/1JVvwh4T1J7Bms4RCTjes0alvY/Pzjrjn8AaK/Lc"
    "Vl9fEVpVa1dyk9W29W/PU/SZeKXC2GbowpRSjpb3f1Vz/9Gv4D+Cj6YQ0kKbY2LBlTau7rnJPJIwcAH73OOa9t8O"
    "6pD4dji8wtmOIN8rkndtxnHIzwB07+3G/bXFmmmgxiIkZQK+AgB45yM7snOOPyryH4j+KorCSaOzuGDOnEik5XkD"
    "CE8dwOoAOcjrj6HE4nB4Gi8XnUuWN7Jbyk+0Vu2/uXVpanxmaY3M+IsS6PDF3B2vbovO39djr/Gnjm0gtHMkqSfL"
    "mNYGwTzgtjAUDHOW9B24r5n8eeIJ9RVycMq7yo85sA/7RI55IGCOMk965bxB40vZj5kryGNyH5Xc4JI7Y6DOP6cc"
    "6fhszeKY44YofNBASMZG85zjB6A46455b2NfD47McxzqPsqadLCJ/AnrJLbna378vwp93Zn7DkeQZBkeF+s5rZ4v"
    "z37f1/wbH//S+f8Aw7qM817AoZjCJFO5t3LYwCSQcDqQf04GPoH4dfDZNbsRNPCucrIU4XHy/KCOMnpz0wfZa3PA"
    "PwCiQm7W1TLZCLtyHyfTgeh7cBj616f9og+Htu4OYm4lUSdOCwwMnr+GMDtXz6p06/LRwUff/rqcOccUZnia7w9V"
    "P6v09C9afCq30a3W3twyov8Azz4XGBgfM69sdqK4PU/2gI4Lx4t5lljysm4Jwcnj5uv16H2or6GnwTm04KTpt39T"
    "y45NktZKotb+Z//Tl+InjO+i1IfZ5JLf5jHlZM5z1zxyOensO/NeV6t4rnOrR2XlgRyDYMNwGJOWwfcdM+lFFfmb"
    "xNbNs2rVcdLnalJK/RKTSSS0SSS26673Z9j4U0KWDwihQiopxf5MyP8AhFINTu5RMy/ug8rERglxzkc9Mlc/ieDX"
    "vfwo8A2GiXdubZmEkmELNzyfLOfXqw4z2PrRRX3NSpKOFjFbNRf3n5px/OUsdOTeqv8Amz//1Ppga4vh7SnFvaRg"
    "EleDg5UDacnPY/1GDXzz8ZPFN3fX81kSUxIpVwQdrMeDgjt39dq4xjkor7bgLA4adWFWUE5a6+jZlh4qrheWaukn"
    "+iPlvxZ4hm0f7LcAGZrkvu3OVIxtbqMZ+/8A5zRRRXXxrxpnuT59iMDgK/JShyWXJB2vCLeri3u29z6zLMiy6rhI"
    "TnS1d+rXV9mf/9k=")
JPEG_PROBE_SHA256 = {
    "color": "92f8884dab025077ee415a04f6e9b744f974161f4fe1943f0f37630f85cdcd94",
    "gray": "73b3c88f0e89bf69d0d2b7866b6a46680cebe153a085c2ac7dda1cda47d62f6c",}
# fused points of the colorize stage: 80 % of the counts first measured on
# the card (26,417 on the 16 MVS frames, as in the CPU rehearsal, and
# 151,610 on phase 10's 48 frames), so that a stage that drops most scans
# cannot pass on the colours of the rest
COLOR_MIN_FUSED = 21133
CHAIN_MIN_FUSED = 121288
# median over the fused points of |colour - true colour| per channel: the
# CPU rehearsal at the same scale (16 frames rendered at 2880 x 5760, read
# at 720 x 1440) measured 0.0104, 0.0120 and 0.0105; a wrong camera or
# channel order gives ~0.1 (the channels are independent textures)
COLOR_MAX_MEDIAN_ERR = 0.02


def read_colorized(path):
    """The colorized map's points (N, 3) and colours (N, 3) uint8, or fail
    when the pcd has no rgb field."""
    import numpy as np
    from panovlm_tpu_torch.io.pointcloud import read_pcd
    with open(path, "rb") as f:
        head = f.read(4096).decode("ascii", errors="replace")
    fields = next(line.split()[1:] for line in head.splitlines() if line.startswith("FIELDS"))
    if "rgb" not in fields:
        fail(f"{path}: no rgb field (FIELDS {' '.join(fields)})")
    data = read_pcd(path)
    rgb = np.ascontiguousarray(data[:, fields.index("rgb")]).view(np.uint32)
    return data[:, :3], np.stack([(rgb >> 16) & 255, (rgb >> 8) & 255, rgb & 255],
                                 axis=1).astype(np.uint8)


def color_errors(points, rgb):
    """Per channel, the median over the points of |colour - true colour|
    (points in the camera-convention world of the poses)."""
    import numpy as np
    truth = true_color(np.asarray(points, np.float64) @ np.asarray(S))
    return np.median(np.abs(rgb / 255.0 - truth), axis=0)


def run_colorize(torch, cfg_path, label: str, device: str = "cuda"):
    """`python -m panovlm_tpu_torch colorize_lidar_map` in-process. Prints
    the stage's TimeReport and peak device memory; returns the pcd's
    bytes, points and colours."""
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.utils.timing import TimeReport

    cfg = load_config(cfg_path)
    tr = TimeReport()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    rc = port_main(["colorize_lidar_map", cfg_path, "--device", device], tr=tr)
    wall = time.time() - t0
    if rc != 0:
        fail(f"colorize_lidar_map ({label}) exited {rc}")
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else float("nan")
    log(f"colorize stage ({label}): wall {wall:.2f} s, peak device memory {peak:.2f} GiB")
    for name, sec in tr.time_spent.items():
        if name != "colorize_lidar_map":
            log(f"  {name}: {sec:.2f} s")
    path = os.path.join(cfg.texture_result_path, "colorized_map.pcd")
    if not os.path.exists(path):
        fail(f"missing result/texture/colorized_map.pcd ({label})")
    with open(path, "rb") as f:
        blob = f.read()
    return (blob, *read_colorized(path))


def check_jpeg_decoder():
    """The port's decoder on this machine: the embedded cv2-written probe
    gives cv2's bits (by hash)."""
    import base64
    import hashlib
    from panovlm_tpu_torch.native import jpeg as native_jpeg
    probe = base64.b64decode(JPEG_PROBE_B64)
    got = {kind: hashlib.sha256(native_jpeg.decode(probe, kind == "color").tobytes()).hexdigest()
           for kind in ("color", "gray")}
    log(f"JPEG probe (cv2-written 4:2:0 with restarts): "
        f"{'cv2 bits' if got == JPEG_PROBE_SHA256 else f'DIFFERS {got}'}")
    if got != JPEG_PROBE_SHA256:
        fail("the JPEG decoder built here does not give cv2's bits on the probe")


def run_colorize_phase(torch, mvs_cfg_path, device: str = "cuda"):
    """Phase 11 on the MVS dataset: the colour JPEG panoramas (2880 x 5760,
    read at scale -2), its undistorted scans and ground-truth joint poses."""
    import numpy as np
    from panovlm_tpu_torch.io.jpeg import read_jpeg

    root = os.path.dirname(mvs_cfg_path)
    cfg_path = os.path.join(root, "color_config.txt")
    with open(mvs_cfg_path) as f:
        text = f.read().replace(f"image_path = {root}/images", f"image_path = {root}/color")
    with open(cfg_path, "w") as f:
        f.write(text)
    check_jpeg_decoder()
    jpg = os.path.join(root, "color", "000000.jpg")
    t0 = time.time()
    img = read_jpeg(jpg, color=True)
    dt = time.time() - t0
    diff = np.abs(img.astype(np.int16) - np.load(jpg[:-4] + "_source.npy").astype(np.int16))
    log(f"JPEG decode of one {img.shape[0]} x {img.shape[1]} colour panorama on one thread: "
        f"{dt * 1000:.1f} ms ({os.path.getsize(jpg) / 2**20:.2f} MiB); against its source "
        f"array: mean {diff.mean():.4f}, max {diff.max()} (bounds {JPEG_Q95_MEAN}, "
        f"{JPEG_Q95_MAX})")
    if not (diff.mean() <= JPEG_Q95_MEAN and diff.max() <= JPEG_Q95_MAX):
        fail("decoded panorama off its source beyond the q95 round-trip bounds")
    blob, pts, rgb = run_colorize(torch, cfg_path, "MVS frames, colour JPEG", device)
    err = color_errors(pts, rgb)
    log(f"colorized map: {len(pts)} fused points (floor {COLOR_MIN_FUSED}); median |colour - "
        f"true colour| per channel {np.array2string(err, precision=5)} (bound "
        f"{COLOR_MAX_MEDIAN_ERR})")
    if not len(pts) >= COLOR_MIN_FUSED:
        fail(f"{len(pts)} fused points < {COLOR_MIN_FUSED}")
    if not (err < COLOR_MAX_MEDIAN_ERR).all():
        fail(f"colour error {err} not under {COLOR_MAX_MEDIAN_ERR}")
    again = run_colorize(torch, cfg_path, "rerun", device)[0]
    log(f"colorize stage rerun: colorized_map.pcd {'bit-equal' if again == blob else 'DIFFERS'}")
    if again != blob:
        fail("the colorize stage is not reproducible")
    return blob


def run_colorize_chain(torch, sfm_cfg_path, device: str = "cuda"):
    """Phase 11's chain: the stage on phase 10's outputs (its PNG frames, the
    port's own joint poses and undistorted scans). The joint LiDAR poses
    carry the reference's own error there (JOINT_LIDAR_REF), so only the
    artifact and the fused points are checked."""
    cfg_path = os.path.join(os.path.dirname(sfm_cfg_path), "chain_config.txt")
    _, pts, _ = run_colorize(torch, cfg_path, "phase 10's outputs", device)
    log(f"colorized map of the chain: {len(pts)} fused points (floor {CHAIN_MIN_FUSED})")
    if not len(pts) >= CHAIN_MIN_FUSED:
        fail(f"{len(pts)} fused points < {CHAIN_MIN_FUSED} on phase 10's outputs")


# ----------------------------------------------------------------------------
# phase 16: the image formats the JAX package reads through cv2 (progressive,
# CMYK / YCCK, RGB-coded JPEG; every PNG), on the datasets of phases 6 and 11
# ----------------------------------------------------------------------------

# small files, one per kind (cv2- or PIL-written; YCCK, Adam7, arithmetic-
# coded and lossless by tests/image_forge.py, as no tool writes them), each
# with the SHA-256 of what cv2.imread gives for it in colour (RGB order) and
# in gray, None where cv2 gives no image (the decoder must refuse the read);
# tests/test_torch_image_formats.py recomputes them with cv2
FORMAT_PROBES = {
    "progressive": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAYEBQYFBAYGBQYHBwYIChAKCgkJChQODwwQFxQYGBcUFhYaHSUf"
        "GhsjHBYWICwgIyYnKSopGR8tMC0oMCUoKSj/2wBDAQcHBwoIChMKChMoGhYaKCgoKCgoKCgoKCgoKCgoKCgo"
        "KCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCj/wgARCAAYACgDASIAAhEBAxEB/8QAGAABAAMBAAAA"
        "AAAAAAAAAAAAAAIEBQP/xAAXAQEBAQEAAAAAAAAAAAAAAAAEBQMC/90ABAAB/9oADAMBAAIQAxAAAAHK0ath"
        "Bv/QtcojZf/Rg7l2f//SUzmd/9PP0RzP/9TVELL/xAAcEAADAAIDAQAAAAAAAAAAAAAAAQIDERITITL/2gAI"
        "AQEAAQUCiz//0IWz/9FQf//Srw//0+Z//9RYz//Vl6P/1llP/9f6P//Q6T//0W0f/9KvT//TSZ//1MR//9WN"
        "H//EAB8RAAICAgEFAAAAAAAAAAAAAAECAAMEEQUSISMxM//aAAgBAwEBPwGwq/yn/9DFSxD5PU//0Rdj67z/"
        "0uPHSZ//07m2s//UWsGf/8QAHBEAAQQDAQAAAAAAAAAAAAAAAAECAwQREhQz/9oACAECAQE/AbbmyeJ//9CG"
        "KVjsyn//0emqh//SoJop/9O67Zh//9RY0yf/xAAXEAEAAwAAAAAAAAAAAAAAAAAAESEx/9oACAEBAAY/An//"
        "0H//0cf/0qf/03//1Jf/1bx//9Z//9d//9CX/9F//9J//9N//9R//9V//8QAHBAAAgIDAQEAAAAAAAAAAAAA"
        "AAERITFBYVGx/9oACAEBAAE/IWNr4f/Qq0vT/9FH0f/SF//TkoV0f//Uioqzg//Vh2cD/9aZLZ//15n3p//Q"
        "TN6LZ//RgppWf//SR6dP/9Py30//1GhbP//VaNvHT//aAAwDAQACAAMAAAAQl//Q1//RO//Sd//T9//U9//E"
        "ABgRAQEBAQEAAAAAAAAAAAAAAAEAESEx/9oACAEDAQE/EBM93//Q3sf/0cgXb//SPYv/03yS/9TQVb//xAAa"
        "EQADAQADAAAAAAAAAAAAAAAAAREhMXGR/9oACAECAQE/EEc5n//Q2xD/0Uik5T//0tFb2f/Tbuj/1Lrr9P/E"
        "ACQQAQACAQMDBAMAAAAAAAAAAAERIQAxQVFhgfBxkaHBsdHx/9oACAEBAAE/EBxYuOGvMZ//0Cct2qT85//R"
        "CiwWeE/Of//SAwRTqdDz95//0+/Cq1NPfbP/1JQjc9Vs+z0z/9UCKBQp1+s//9YGQiYCaemf/9ddIMy4N5//"
        "0GasJBtz2v8AGf/ROQk1erJn/9IhBG6Su3Pnf//Tja7BAitvXzt//9QQWkFaz/fvP//VlTYysJ1380z/2Q==",
        ".jpg", {"color": "3b42706c54b4d33f012b32bfb2fa01ab884e614d2c5eea0e5f949941265ae3f7",
                 "gray": "5b55f3eddeb48825654bf09a53f1ad83014a1d839591ff5177f1418d20a88b41"}),
    "progressive cut after scan 3": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAYEBQYFBAYGBQYHBwYIChAKCgkJChQODwwQFxQYGBcUFhYaHSUf"
        "GhsjHBYWICwgIyYnKSopGR8tMC0oMCUoKSj/2wBDAQcHBwoIChMKChMoGhYaKCgoKCgoKCgoKCgoKCgoKCgo"
        "KCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCj/wgARCAAYACgDASIAAhEBAxEB/8QAGAABAAMBAAAA"
        "AAAAAAAAAAAAAAIEBQP/xAAXAQEBAQEAAAAAAAAAAAAAAAAEBQMC/90ABAAB/9oADAMBAAIQAxAAAAHK0ath"
        "Bv/QtcojZf/Rg7l2f//SUzmd/9PP0RzP/9TVELL/xAAcEAADAAIDAQAAAAAAAAAAAAAAAQIDERITITL/2gAI"
        "AQEAAQUCiz//0IWz/9FQf//Srw//0+Z//9RYz//Vl6P/1llP/9f6P//Q6T//0W0f/9KvT//TSZ//1MR//9WN"
        "H//EAB8RAAICAgEFAAAAAAAAAAAAAAECAAMEEQUSISMxM//aAAgBAwEBPwGwq/yn/9DFSxD5PU//0Rdj67z/"
        "0uPHSZ//07m2s//UWsGf",
        ".jpg", {"color": "a6b41ed3eb97688a9727dce5688663e6c87094585f972dae6d4c63d9cf9c2127",
                 "gray": "a07628f4b37ca65ed2a03603d351fdf632a410a42560bba9a38836419c1cb690"}),
    "CMYK": (
        "/9j/7gAOQWRvYmUAZAAAAAAA/9sAQwAIBgYHBgUIBwcHCQkICgwUDQwLCwwZEhMPFB0aHx4dGhwcICQuJyAi"
        "LCMcHCg3KSwwMTQ0NB8nOT04MjwuMzQy/8AAFAgAGAAgBEMRAE0RAFkRAEsRAP/EAB8AAAEFAQEBAQEBAAAA"
        "AAAAAAABAgMEBQYHCAkKC//EALUQAAIBAwMCBAMFBQQEAAABfQECAwAEEQUSITFBBhNRYQcicRQygZGhCCNC"
        "scEVUtHwJDNicoIJChYXGBkaJSYnKCkqNDU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6"
        "g4SFhoeIiYqSk5SVlpeYmZqio6Slpqeoqaqys7S1tre4ubrCw8TFxsfIycrS09TV1tfY2drh4uPk5ebn6Onq"
        "8fLz9PX29/j5+v/aAA4EQwBNAFkASwAAPwDk9P8AEE88nO7cCFO7gY4Hbr3/ACrr9Q8PQxI7KOUGTtIOO/P6"
        "1vvfy/aVDdeD159x+Zz/AJxXI2HiG5mlVSxHQMBnp7Dr6V3mh2AvUCTY4XaRgc/jjmvPdavTYtIFKqPyJ5P4"
        "etSiBJ1CknHAYhevOM/XrXomiWEVzFGZV68O27n6j9K6OTwzZeQqqqjj5T0P/wCv/PPFc5H4nuWmADHB6ggk"
        "ZHfJ7VDfadCI9y7QDnHIH4gfh6+1b8mgWoh8xBlfmxn1z/8Aqrldejjs1fyCAx6BR07jA6n/AOvmuv0WRrtm"
        "LSEuFKn5ePr147VyesKsDlI1BC5524OfbH0Pt+dcl4gt47BXMRTJOSpOenpn2NYkfhAWUxZ0bAbqy5XOTn/P"
        "WtWbxZ/aES5ldt/r1I7j/PWu6uNIe2y7KGPZsjIx379sfhWRD4RNnKZcMAoLEbcdO/tx/Otuy1RNMVOgJXBz"
        "8vGRn+lZV5pZ1OQOFBOdwx07fh/P+tUpLv7GxCuAU5PPBGT3/HrWvaammjIMMAI+o6Y/P+XSrY8cpKrBWynb"
        "AxnsPft29faoE8ETJN5oQMTgKXPOPT9KzbjXAFC4G5TgknIPHp+P/wCurMnjpPKEe4PyQMdfx/Tms27l/tZj"
        "gjcxGAT0bj0+p/yKu2kD6WqllXA5K45P1P8AjWBqTG7PyyKyYGG/ur9Pwqnd3K6lEsZYjec+nYHr613Oq3No"
        "4ba65YEcHGT7c/zrhdMs7z7Uu4FVwF+9nH4j6+leyarJEEKAjLfNz6dB05//AFV22pzWbRfKqu7Dv1AHv17V"
        "5V4likuHcR72GMDAwBjj8/6V6h4dMUTJ56lnGAAq4x7n+grz/WD5geLftCEEHHUdM59a8r8Qo00oaPI6AZXr"
        "6e2OP89a5NLS7a8LElQpHBGDj6Y/Guza6szCAMY+6Apzx/8AWGPWuRuIp2mIbLZAzkEnPf8An2rkTDeeeGww"
        "VueATj1613nh0ONrTIchSFYYHXP4/wCfxrgvETvMXMasWCnofUf54/yX2gYZErYbBUbiSefau/8ADhCqrs4Y"
        "AYO48qMdcY/pX//Z",
        ".jpg", {"color": "46b0df803d895a36b36c8d7641cc814174357d676c40b7dfb200f0325fd92052",
                 "gray": "430bfbbd5e3a0282724d65b748394718183e1fb55fed46440a45ea30a71d9a6f"}),
    "RGB-coded": (
        "/9j/7gAOQWRvYmUAZAAAAAAA/9sAQwAIBgYHBgUIBwcHCQkICgwUDQwLCwwZEhMPFB0aHx4dGhwcICQuJyAi"
        "LCMcHCg3KSwwMTQ0NB8nOT04MjwuMzQy/8AAEQgAGAAgA1IRAEcRAEIRAP/EAB8AAAEFAQEBAQEBAAAAAAAA"
        "AAABAgMEBQYHCAkKC//EALUQAAIBAwMCBAMFBQQEAAABfQECAwAEEQUSITFBBhNRYQcicRQygZGhCCNCscEV"
        "UtHwJDNicoIJChYXGBkaJSYnKCkqNDU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6g4SF"
        "hoeIiYqSk5SVlpeYmZqio6Slpqeoqaqys7S1tre4ubrCw8TFxsfIycrS09TV1tfY2drh4uPk5ebn6Onq8fLz"
        "9PX29/j5+v/aAAwDUgBHAEIAAD8A67UvD9ta5PKhPmDZziuPstfu7p5g7HB+8zH9Ov4f/rrBNhEkTMM54AB/"
        "iPHvn149vWuA8Qag9gWRXJk3YADHHQfl2/z09C0WyjvyGOGDLgM/057Y6fyPWq0s7RoiKdwzjHQbenr7f55r"
        "mYPEc8k4Qs2SVBBzyOMgV0r+HLcRk42sBxwMnHv6f4/lYstQnBXLfLu65znH8u5+tdfocr3zRhypD9h6ev8A"
        "n06cVxeuRJp7F0UDI4AHQ545rr9JlaZlK5IAyxGTt7dPr/KtabxfHdswZgJM8ALjn156nn071mQ+E2spJXWM"
        "4AByvPUj8M1wNprPmhSx3YPXIGM8cfh/KsyXTP7a+ZY8E55xkde3FatpqbaUjI0pGxjy46kd/bFXkthcYBUb"
        "QBjv+QP51nL4JudwlKMc9OBjGOOMf54q0vjlNogaTOec7scY6579K0LbQjvUnA2H5cHnAHHYn/GtOCFtIJQx"
        "kNv6gdOnb8R+lULi6GqyuB8yyZGF5yc/574rfsIhaIrMnA6Bh9D07fWuI0q2vIrseZ5rL1ORjH68f/WrudXu"
        "YJImVABnkNt4+h614/pqSRzLvX5exYrz7fl35/CvUvDpijUK4OSdoAbqcZ7+1eW+IklnuGZG+b7u5RkAk4J/"
        "rnjr1rv9EkBCmQBlUEBmPXr09en049q62WeyMXyeVuzlN3p2/l/nrXJRwaiJ2IdiODjJ59u/OTjr/Suvt2tg"
        "i/vDk87h1yPb8M1wviTaULRZwOPQAc4xXe+G1WIrG4BJwNpBB/Xt/nvUN2ucliQQMgscg/h9a//Z",
        ".jpg", {"color": "933d4a1d42882254c87efab9a634e7e85f6d90c804828531f61238479b399f99",
                 "gray": "c61d6dad61e64590ca54d43712a5a173c3938420a49e44538dd1999b11e63157"}),
    "YCCK": (
        "/9j/7gAOQWRvYmUAZAAAAAAC/9sAhAAIBgYHBgUIBwcHCQkICgwUDQwLCwwZEhMPFB0aHx4dGhwcICQuJyAi"
        "LCMcHCg3KSwwMTQ0NB8nOT04MjwuMzQyAQkJCQwLDBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
        "MjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjL/wAAUCAAQABgEASIAAhEBAxEBBCIB/8QA1QAAAwEAAAAAAAAA"
        "AAAAAAAAAQUGAwEBAQAAAAAAAAAAAAAAAAAABAYCAQEAAAAAAAAAAAAAAAAAAAUGAwADAQAAAAAAAAAAAAAA"
        "AAABBQYEEAABAgMFBgYDAAAAAAAAAAABAhEAAyEEBRIxkQYVIkFRgRMWU2FxkpPR4REAAAYDAQAAAAAAAAAA"
        "AAAAAAEDBAURAhIxYRIAAgIDAAAAAAAAAAAAAAAAAQMAAgQRIRMAAAUCBAYDAAAAAAAAAAAAAAECA/AEEQUG"
        "FSESMVFxscGB0eH/2gAOBAEAAhEDIgQzAD8Aq7xuCzyMZSlFKggu3y/eIK+LynWJZUhhwjCAMm9tRnD+btgm"
        "3qKcaVAF1OWq5fLLXpCydc+8ypSEKXiNcQz/AHzg0Smq2yt9z0TtTVg0gSmqsKbbbNVtp5lhEYpVLZM7Sew/"
        "czAl8uAt7hW/QnWEZpn6I5O09omTvCWpT4iRmxbkOQo2sb79n+kfyCHw2Jny8U9UuopxCnQ07aQPK83pZvr/"
        "ACKJWRirLUiCSEZQp0yVTi7pue5PgbdTV18BgWWzTdStp2nMHQilvof/2Q==",
        ".jpg", {"color": "e7d9892c41b6226c9b384e5bcd694c8ee1c11ed2f218b7ac17779dbba14ad70e",
                 "gray": "21fbbb6c4c17e70d00b3133a5cf2ea5408941a4518f231d2d48a7d1299bf77f3"}),
    "16-bit RGB PNG": (
        "iVBORw0KGgoAAAANSUhEUgAAABAAAAAMEAIAAAC0FXaVAAAEl0lEQVQ4EQGMBHP7AUiEhNeTSgYb/tj+QuY4"
        "847+piTlAUXqJPTz9VkZzQ/HBZ/7yQXeDn7jDuw5/FoIuyBE+1IR+PBaCr/1AgI6AooGoRCfCxEQhe+5+SD0"
        "Jv+H+WcNPh4F8xL63uBZ/7j2zQE8qlVZlXgQByeSAUwSbf7zDdr1qO/u9pf87gU87mXzsBal/SMq5uEM+KPh"
        "YCHeFEgOY+5S/90POQ8236DzPfBhFrISoyQx7Y0DPvLU+Hj0YgsSGMP7xwWB3CgFKO72AVUBW0FTxrTR94MJ"
        "4wUu+CP+M/ZuDSMG++W2+/z2vBJiGHsG/uqr9l8GbQQbAaMIzxHO+8IO7OPPB30GvwGx+xL3ZAVC8o0QWuQU"
        "GD0IDetIBRcHKPlw2vL9CR8iDFT9y+80AU3wUNi+SgWI9EkFsA9wD2EFqRO3+kgAe+iFBAH8A/vvCF/XcAI5"
        "FpQRBfzQ5aPuUh4iLRjv3+1j/ZUCYBC3AeTeDt5lBCADXxy2A1YD8upSHmv9Gf+iCHn05AuYAxLotgFvQCCR"
        "uqHmYCAqDMsR7eiGE8MKWgSj/XvpJRVJ74webgni7q3emQbE/aMXVQjG8tEFPhBx/nf3UBJz5s8HHx18/5H7"
        "JfgP2V/uyfw4+swG9yi6CNT/+vJc8XD+pyU771IBejEVpOm3/6YUt/EB5BcG/gqmBon6Qe96HKwGBORI4OgG"
        "2fyYAtYWjPjqCEUiUwkA6wr2evWiHgMEJdX/23keoO4TCdsDtBEtDEQcTPKP+F8Wl/GvAKoD7ei1AOUZcvBo"
        "AXYgIfPVVegu9FkVFwRWEqrhvCAyC9AFofqV/K4Bivm9G1/5G+frDvHfDh2lFkr/Uu7b9lPmausUHin0mAeA"
        "9G7nHw1lGkPziu8sJEIMz/zQCYjVcuzmAZ8WbhORCGrpWAFdhR7Q090Q+xOLGCX/1P+a3dT2QPD4Cx8UlwgZ"
        "/aoCMAgP6KUBSC0q/5rdyQ4G9YcV6hG7+sYCQgb97Kj6swb59n7c6AZu8/YLXgOu0gj3lBWY7W0ZLA2cEUbu"
        "eiYR4v4BYIYbEsfO/UsDiA66/4kax+hiCBn9QPezGNAbvRDP/Ar+pPVR5JULDvHj/IT6qfsUBHkb3/qHDeQA"
        "6NToAeQs6AUb2kPnDAIxHAIan+Zo4JkE7uxS/nYec/OxBoz7ewt5AWErR+vN0fWa6rEFvxxgFiL+Kery+h/+"
        "0wboCintFwh/+n37+PmzAw/87AUaCVfx2ABgK2r+jO93+fvwF/u/GtbYGxZeAZ8TeugN/jTXAglBGObyr+rA"
        "/f8RoCALGsT0cQFMaESxxgUPixX05jQIevqeGyH4RQHy2dD6Z/F/GMMbFxxL8w3p2Pw79D8IYBTg8YQGRfYp"
        "9aLvlgiI9b8JQxMMD/sGxATC2HoClxIOFKrgMPi05eQiDyAr9G/fYfsE9ysBV9pNVLE0DokaHODUANjuPRmR"
        "AVAWeu2FAgb/8QKU7xTqJvKuEwkpxvoo+gDspwNG/8D8xv78BdAFdAUqAk0mbPMx7S/x0AEM+ir63vuAF6Ap"
        "9fRY7RPmZgeICyUaouUPDPQ4utu5G1EAAAAASUVORK5CYII=",
        ".png", {"color": "928c9e8d2649b38d09ab5f69850e5c14f2d379a03b82255cd5bf171bffe29603",
                 "gray": "bea1dd8c00f8005bc29f751b30f03db859a97fed321944bca68c5feb8bb28bce"}),
    "bilevel PNG": (
        "iVBORw0KGgoAAAANSUhEUgAAADAAAAAgAQAAAAB8r8axAAAAPElEQVQIHRXBgQ0AAACCIP3/aFtgnHHGGWec"
        "ccYZZ5xxxhlnnHHGGWecccYZZ5xxxhlnnHHGGWecccYZN1HSIAEb85OAAAAAAElFTkSuQmCC",
        ".png", {"color": "d397edef4cf4719aa6670603a4abe242d870f1ac33e619dc894b24dc1eb9b413",
                 "gray": "e6d1b616fc8f6230c07d0e573527b701e7f377803916cc22f51faa21917d9160"}),
    "palette + tRNS PNG": (
        "iVBORw0KGgoAAAANSUhEUgAAACAAAAAYBAMAAABpfeIHAAAAFVBMVEU5x0NVqVaBiXJkkGqbbXt9c3e4Q4YJ"
        "QaQiAAAAA3RSTlP//wDXyg1BAAAA+ElEQVR4nE2PMXLCQBAEe1dKDSscUywiFhZfsP9fEkUun3gAOoqYWwcQ"
        "eLKeoGtGDl8Xns3u0o39pR9OyPcmz10SspHR50HV6HCm24SFadQtPqdyAyb0s88KGm5ELAuUsa0ByGRgkd1p"
        "Uv5HhlYB1m+EY1IA6TGAzbVCoXhOCiLGNkoNifk4SePJVUGnCXmOm1avrpqFeobO7pZ9J1HFsK9XZPGKOHO3"
        "4XhCGpQ1rQRtKrIudUhReyDi+BRjCIjJjxhASauzQmRfMgBKNgVM5tf2sq9QgOhfhf6mrAAp3m99WxQEf3MR"
        "UwU0vZxcQaUB8ccOV0qSj+oPUyJkGNrfavMAAAAASUVORK5CYII=",
        ".png", {"color": "cca2ae13e7be693f1d054d4abc0c4f38cbed8d08f61ddf9c9e1587bb56210ad4",
                 "gray": "89df3498ce188c7a6390af04f19b785689b58662df7574ece91253422bfa9a56"}),
    "Adam7 PNG": (
        "iVBORw0KGgoAAAANSUhEUgAAAB4AAAAUCAIAAAFizioFAAAABGdBTUEAALGPC/xhBQAABvdJREFUeJwN0/tT"
        "FIcBwPF93u7t7b1v71buxUNUEBhNbBwzfaSTWrVBgwaaRNukYFFR0OOhqIAaRCKCkAoijiMmnczUpp3U1um0"
        "mfyQmaaT1ozJUNOC8oa7A+6199jb3bvd2936L3w/8wWafZUXehtHznUP9baDX32v8bsK5sM2pXC6BKrt/ts3"
        "bryn+eVDf3QB3U37bgy09F/ouXDuLvjlthPjB6enttle/HwL1Hb24Z6JvLGG7c6YB5guq/9yb/P7p07WDlZv"
        "/+InGx799FfjnYMt4+Bg3Su6IneCgZc0VqkQt62tkoatSEoA+hp3jvTUnu+vbm6t6+nvHR46P9I6DH5e0ry4"
        "Gff/cGnOpAbLwhzo2PxZBaSnVtfHVTKORslwTocnlQzvBuBtB2wrdCRAIYS8gfoHVfwfmxaXkLGaZ1sXSosn"
        "La996uBJiQgXfbcJAr7Ys+veW3v+3PDu7caqvkv1Xb49vo8rm0ePHPhD1c/Han482lj1SW31zWPvXTvTdOpj"
        "8Al9ktNJjNWQdIQEF/LvQgHWcI/LFa6QNGXYZDSR5ko2yaxjtnRjCocmX2ZmPWDIzScKyIiLhRgpyVvzF60b"
        "n0rEnL4gsO0lQbWJWjPDxTRZ2HpFntzELr8wBZJJPiGCUUcBYtkxoXr9lopJ+gePvPicyeKvKOZzEYVEHpeF"
        "I6sxD+bMsrDernrDCvmtSimlW6YoPRBO8m4nKIrrmXk7UIxRwKXLu1o6DjX31Xb4atoHK9/vquse7ugeaOy5"
        "emzoxvH2Eye72trbuu80tVy5ePY++PfKurQHhPnoE4q0ZMiZopVwHszm8mQmbTaJjNlmihjgsFwOoiC3BXLN"
        "gMX/NKKzxV4/rwKKouaR+pwMLsuvLE25c35PfKnkWU5vlTmD4vfD9dAuDS0Rzti8mB91LcdNkaADA+xkgpLi"
        "hGTWZaGgGzGpKS1ROksisjayhvPBVY9n0xKbQPkinbJkYugUpwC0SR9dNJQmUV5P0k+RcAkKPNx7+M6Pjv71"
        "6Ju/bz11umtf49mf7R1tePvDmrf/VL3jQc3Ov7zz+oOGqtsNl/s/uH10ELzWsVsTluO04shpJJV8iuVBguJ2"
        "IqoqiwjA4pnMvCefNgkwGmOi0Fd5C1MFRNxLfktrVyC+XFbdfpX62l7yNWGccm6eKNkQtAOP4uZnBifkhY2d"
        "sqINAVzWQuhohc6uIfqgaoyijoCLWNRY1yRZxaB1NMMlY3kZRDQpM3qYRmVkOWQELEbCVcgrRBjO2W3eGclW"
        "pMIJOhKcSZtlJqwCd3w1g+d2XD/0/d8drBo/fbjT9+rFS7sG6vbfajngu7qv6+Tuq75ftp6r77pX/V7nGy33"
        "2s5cPNx+85Cvp6VmqL7zbvuJa90Xek8eGWpp+qij99qFvp6R1ltj15su+7pGwM8OHNTJnApvEIUFBXHPQorR"
        "ISgGTTK1LBnQSZDTmM2yVs2sA5d4zEwwuANcilhIg5JDIULNMGk3yPKkCNMCnNRTRQCLJPJJcU1c9UCbF/Mt"
        "jyn0yZprutgcAT2CRiObo2KEVQp4Y9YJYEn38/pQmvITeHKlQvcvFxPdmJ0rDyyXCEFTcMUewG0LORoKv5hR"
        "qbkFAwfjACPJloQA+9YVr1IZJ6CuSCyUA4SMAGtlU0JVYDZrFhhMI5pVKYzxCKZ6cC0URhVQiMVTNpdlDY1S"
        "eg8WnWc2yM44neZyGYeatXJ+FY1oINSGzKGEkaBSRo5P8awb4yEkGotDOCx5tITAGS2YupwIFVuIFIEL7Mp6"
        "DSLr6UyucCrGYPjWZDbGOraLWJj1soFAYRLjHBBi01u1gO75KA+bdo76qu/XH/zkwL6Bwzt73t1/79Ib4xff"
        "6euuvHGqpn+08vTYvubB3b4P6s/c9e2/X9/26a+P/PZ01Uetx+++9eaDw7+40VV7s+74rSud402t9242nu84"
        "1j/UOdw7cP03YPtwBatxUYw2wKchDILTmWLEFpI1NjHG6uyExRRZ9K+XnQEg7hULlnMhzGLVw9lUHBVI2c6Z"
        "RJ0xRwaEnOqJuENezibzM0mdx0qnIgK0aoWmS1cn8heh/CBQlpTXJybK/Qy+ENVQshYwL4VKEDJKcEbcJKyI"
        "ZSn71qfElv+5N4XyX5oscwXAF76xFz7dXDKxzojbi6JuYb7UjnmAKIYCCmzuk2YRVGdOh6BY3KkwNh3Hsh4b"
        "bbDxqSApIhqtaqZDuCltdyzZrShqWwS0gN05rdfkohhXLsfCnqwVNqXQ5/bLuQyUIeyp1ZzEwwDyX1ZjI4P+"
        "HOwtMEt+EmVIinKkUliS4z1OzvXEg0YA87q0EPAiCuJ8ZpWyiaxk1tOKlsdCyxJBFVqwZ2mpIJoJ4YKdImOh"
        "MC8idnTr4v8BVDRg7Ecn4uQAAAAASUVORK5CYII=",
        ".png", {"color": "063e658e0d48b3d6ebd48190973d32f34057e47aebfed36dd2edac5984a186b2",
                 "gray": "c9a2b6c83a19fabf8bf6819fe14ba034ebfebefc94e19a23fdf8a9f8b43c9383"}),
    "arithmetic sequential": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wCEAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nIC"
        "IsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDIBCQkJDAsMGA0NGDIhHCEyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
        "MjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMv/JABEIABgAKAMBIgACEQEDEQH/zAAIAEEQDBEC/90ABAAC/9oADA"
        "MBAAIRAyIAPwDSjkecHiAxv3iitJQi3urpDD0a9mcnoGcNGMOQsC6iNSAVZsbM1hwnfjDgdDvhc2mj/wCV8AV1"
        "f2MC7RWLPr+PjA1gw7CxSfoomI3+UxiueoyrS6FRfLbc6ZBIeLZWOc+qoxINPb76vX4oS5yryC208P5pbxclZ9"
        "9oCdqNtOuWpeas6pOxVHaxpaGpCV4fyZWCtBNf1I3hsMb4VQLR5ug/6nqru/B19mf7aPAaIbb2GtnLsroge9/F"
        "NlIoOfhTdBwfNrTd02abHDprFGUL+uQo+V4ZYgEeF04fzaMhONDGU4TqnxNiTnu6cwJYbmZVn8uoCL7phIeDrE"
        "oRDv/Q0pb/AJzrjpIIM4UIt8YkGQte7GRSbwP73rPaTm8rBagKeI+yybk+SqwBmavoe0AbbZFgqX26SdmlE8zt"
        "sXSwgja/mFCEXP8A6y0ejAYe7FLKABbG8GtKc3xF8ZS0MygPMzCuMuAI4IVyNsGS3hfSNpYIIAmzdURs0y3FHA"
        "0db7pz+2ROpKSyLV48XxnZq+9OKdOyiwW8rCkLrMw6Nmye5kFLoLp+VmK9/wALN8F8q6Xoz/Lu8gUwA1n1zevr"
        "MPIcUbKgmRFVeLXtDQCZvxuBq4j/0dKiJemNqHiGa1GNbjbm1xdGgnFASrEMUV74vCA0j/0H5kAd7RyYKBnl2D"
        "WtNtrnydl9I0arghKrmV67v/L6Nj6C2ukrr1xu2pWk8/Hq6tLyh1HJPQu7FIlamwoYAA+jqodfPY2m7u3NKeLo"
        "N0C9xWzN6/MzTGkGC64hEZHVxBgCqqXSm3UHd5MMoAdOxJ9Z/qeOBjPKY640zNKeBr75vit6m6nSUP/Z",
        ".jpg", {"color": "07cbc15f866b2e4874591bbef4a01618a2cf27014ac1ac645e0421bcfc81b80a",
                 "gray": "a7c5e503e0efe1fa95d6085ff61cc677ce73f9621eec85bc6f54039a8b08fe9a"}),
    "arithmetic progressive": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wCEAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nIC"
        "IsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDIBCQkJDAsMGA0NGDIhHCEyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
        "MjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMv/KABEIABgAKAMBIgACEQEDEQH/3QAEAAP/2gAMAwEAAhEDIgAAAd"
        "HQkIL5d8F0HbsWPAPb3qEd1Zt+jP/Q/wAr0iE+MpkBV9fRV+aRIRL2IzEj6P/aAAgBAQABBQJEMZT9h03pYLVA"
        "/9AVShkTxiGGBG7Q/9E22tUDqNQHtv/ShqevsAQXydic/9NLETaKkRf7Aln/2gAIAQMAAT8BDcweiLLp2RRwZq"
        "L/0BW/hD/RB1ygruKr/9oACAECAAE/ARWoLz+EfdAi5bY5Y5M4uyb/0DnbiibY4oupbEgxPqBA/9oACAEBAAY/"
        "An0OJzeLUIL/0JWpi755eYkg/9FikWN0qzgg9//SkW7S5Fvw/9MJVidZ8L7/2gAIAQEAAT8hUryRAl1G45TU/A"
        "YwymCA/9A4b20BfyMTHqK5uN9ZGzE/vjfUR4X/0UyReFCJ0AAUd14qgx7N+RsY4ZP/0tkTu47AKu5RXgbz9yjO"
        "T47BAtrVgP/TZXzrqRbmVCQkXRSDhf/aAAwDAQACEQMiAAAQ+K+A/9CyPf/aAAgBAwABPxBiL5PGwU7D48LZxQ"
        "ZdRDaY/9AtVM/UczFTx9Ww/9oACAECAAE/EC8hCOrBQKOQq1Lb05gWOykTLAr/0ARV09VoIzzIOR11EJmzhIT/"
        "2gAIAQEAAT8Qhr7oQqwpweYX8bbPGpgaLpOcHgsLTTg9IUR3JguTbqJaIMuA6uZKMP/QVnj/ACTz+sf0vqbHRC"
        "lQwp6yFuhVzv3a9ZMRN1RBOIhL30D/0Wn2/fL4LIiHLiFhMS1U/Cf9VeQdZy0EShNJle2ymnmVNID/0mBvuY0n"
        "/XiLC2Xobs2CVIr2gXQCfEbl8Tzrv3JfhI3KR2nA/9MgkNCdmbO+wfaImdS8oRG8iMe+hEG0tvgbysD8OuEYrG"
        "djTC+ukP/Z",
        ".jpg", {"color": "07cbc15f866b2e4874591bbef4a01618a2cf27014ac1ac645e0421bcfc81b80a",
                 "gray": "a7c5e503e0efe1fa95d6085ff61cc677ce73f9621eec85bc6f54039a8b08fe9a"}),
    "arithmetic progressive cut after scan 3": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wCEAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nIC"
        "IsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDIBCQkJDAsMGA0NGDIhHCEyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
        "MjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMv/KABEIABgAKAMBIgACEQEDEQH/3QAEAAP/2gAMAwEAAhEDIgAAAd"
        "HQkIL5d8F0HbsWPAPb3qEd1Zt+jP/Q/wAr0iE+MpkBV9fRV+aRIRL2IzEj6P/aAAgBAQABBQJEMZT9h03pYLVA"
        "/9AVShkTxiGGBG7Q/9E22tUDqNQHtv/ShqevsAQXydic/9NLETaKkRf7Aln/2gAIAQMAAT8BDcweiLLp2RRwZq"
        "L/0BW/hD/RB1ygruKr",
        ".jpg", {"color": "0e215722efb71f87b521d594c34eeb9a70051ce3002fb5eae8a7e7c19d5bc67f",
                 "gray": "2a3de6edbdf948b3a2ee386b9e2effb53669b26f8772170187a7e47bd23d37c8"}),
    "lossless gray": (
        "/9j/wwALCAAYACgBAREA/8QAGwAAAgMBAQEAAAAAAAAAAAAABAUCAwYBAAf/3QAEAFD/2gAIAQEABgABXHA+dS"
        "msYSAsMGmWGrNBfygu52dRAVsaa3fAzBAHPrHeegPYaidqkjFXSvhYNUvRWXqouF+gWkw04IjIibH/0L2k0Nlc"
        "a36GluoWNiFoRdUWymmbk9Bp864OJkIFGrTQ0vQ9PGst7idOQmCYKAWoKahyjdFHZpK6U7D2aBBdvxtInTf/0X"
        "rRWRNYwXKqHAVa5V1rnj1jlWacUOxT6lXokOpRWaWNqdkyQHmRLzJbKIQK10yX8YhM86V1NIwAlA+hpE11wMKd"
        "Gq//0n0W9N4FdVKRmMBTIRC/oQ6BF6eiEvvcrbWENYi7olDlHbSpKldSRxogVE+XEwHl7O7L1YB1RiZkwtgp1I"
        "M/Vs//03Ujkp4HiBFtMIUwKE8FxbokZzW6lv2VjgD0DvVlhOq+cKAErofSFcDDWx6TXqAWpyrsguV3ZwgR0tJq"
        "i9//1NVUGxULnIArMSjOR0UEfSaxG6KWnqT6EXllR9L2Q0W4OWYdzxGiVL+Up3BxKRTshWBD6hu9DrsVyeqdDV"
        "eukCOlK//VYgtM7D1/WqtoiKrqbID4HiUOBpkriq13LeNFTWBy81A5Cf3UhRoo7E81pWULGXYwDD9WspeDlsc7"
        "eBxaYl//1pUghOZCVaGStlyF5ATTiA1dpg6QCBrKKOVGoiCGC8TIjiahUl67WX+TvOF0mKA9TebmG/ajBra6Du"
        "qNAsU2CFf/18xLjqKjSpynlwRA03l1wQxku9Qr7gXGfJMSxsF8BoM0KZSAAwROJ1Iy5dLrXi80FiQ1TqayH6tp"
        "FIcOWKXWvd//0M/aofW1dGbjGdKl7SLHCfRxUH+oDWeqRXj3SykeXVVwrd5xYxXWHDcrre9rGJYALm6MfoZ/fc"
        "V3WAao5kpOn//R+ft6hNQFFyKTA5ounqeEcsTEAjzqVOUay2zvhEJLFAybBENxW3bD4sV5DE/OD31Kyvcn0HVZ"
        "N/1uIVxNo5D2mf/SyhVtD4Egldo+K9IstvJ6crZQHs4n9z2b0GcKCnRwDSg2iW6HLEQNc4xsUF5pZQrSPEhKxK"
        "EeuJBbZw24g9c+0GZe/wD/2Q==",
        ".jpg", {"color": None,
                 "gray": "8074a04fb8e8913de4e0e3a58fea4178b5c3af1c75875cc9766c2956e08be5c8"}),
    "lossless RGB": (
        "/9j/wwARCAAYACgDASEAAhEAAxEA/8QAHAAAAgMBAQEBAAAAAAAAAAAABQYDBAcCAQAI/90ABAAo/9oADAMBAA"
        "IAAwAEAAD5at5uTM37ZVQg8PGg9JBnovN+mJEh2rQ5C42y7G82kzjQ0QZdeg6062qtxXj+rO8tOZeLpl42+CVa"
        "qHpEbdphtmuiK6pdQtz7XdIbi9Blo6Z2d29QzIwu7nE7oKUz2XmiooAQtPRnDsZtrz7SLh/JSjuimByGyzSHkM"
        "jJBpV+5wvp90ES0quy3baVnC4GYNTJ8ikNd//Qb6y3VDnb9JcLFF83HbNDEMHC5ZnKKMBp3ofw254wTsehyWUd"
        "Nn4YZYvE9yGsJs1fsxdqRi+jQXw2rsyznqdoOfS37XFQiZtiHAMz0kzRcOAOmy5Mt9cCSfF7QtirLDQT8HGUCs"
        "vm7DwHDT5ID6cNFTvU9c0MfqACOXOyJxGCkG5sXW1UfgeW5se2jeVd1rKMthPrGMtdbn//0dJZ81ErBL41ygBo"
        "hZproAu2cMsyuluwO+AVhDE0RXGDm4uJaRX+f9HaxlIEwVMwdOrnAU6y1WdSPqZKHR7DUOXM3Fu1s1eXWqrRqr"
        "KgzadRf1AG2zrpZO9jaESy2uQJNIjF5nCPS3RTqsvJgyabzaQ35sDzZ2AGFqR+QdYjs64MyNdUd8TpWtmw4jVf"
        "T7NGP4XjvXndL//S2q7i8NOSA2pnTudLXTK3I1A4gDy1CeqltRcurXUxmo6e8DLS1LVFNdt1WU26zMIusSmYeC"
        "d9VlJIeXaU+fMpsK7ZynDBZmQt3ndq6CHkTa2ayxmzATvJ6y2pzSVWj9jGi5Ys3l8rRtQ40tapBUs4EDIovTlG"
        "XFnzS/SmTE2go85fYRj1gom/oE1UAVVZTnXWZgN9ANSGhtszT//T3nNMM50ccQhRL5H1YEPiM2K6ybNCWO2vru"
        "ogjNED9R9c/OTR477nyOsGT89wZoUjjCnrBfUVfgm9h0qZ2CyhngJnOr1OKafXLNUIvRtRXMFfQg9pX4S1LRcc"
        "YVvveqKqyLR1WZlDivIzErXKsqLJNEMXLujM4s6RFLaD8ntupFecKf06GQ7oJrPmZB7yTR2pEPKEzMzp9U1//9"
        "TSxGfhGNJqWmVLc52RPBpbHmjGQdU5sb4S4sTbjdCWd8khLQoTGem4Z6vkqK+bIiWwT4dCu9NVIrjeMg7JKZlg"
        "hBPVhPeOSiyIYIL7NJmjqyBEbRMRVU7UNG0vI9FRleQwctxI0RzhxWBTWUHGsxcx6qxY2dGMduHUM/qugRzD5n"
        "2Et6YX1rNQx9asPOWACLjAvacjSKWsDRf/1XMcnIiWR4Asywzu7B0VJUC92nmNrsqfKU6KcxxQo5Su2MquW+pk"
        "xqcWHsT+fvqEyk10O1tr4roTKYqgiS66VirgoLnw2s6BLjDmxHYKrURSC4VtR6IlEvAWRGTZv0NWnu5tGznXqs"
        "pidER9KRELaQjd4uVHoK5KeUpFlqbJA1qpFTnYiUQYA5r+y9AY8wd79wWi5nstHj//1h1D3HovbjwOaWniGfPA"
        "AmyRI0jQDlvXBbXeHRSlwJRvvu801BIPoplkVNA4VrqYOEimF/R3xPaVdT1AuPf65qgaV0DRUxrjlb76d9qzS8"
        "VszzRxU8/Y1GPWmLR1yBAfgSsx1mP2AI6RikdhWBYAee5X9pjcVNIcRHdzODp+bUaq80hHXOdBb84y91WkNYoq"
        "ej6uj6GgDI8uZf/XRFDavz+58pX3xlYchdNjGvZ4aSKqmfas9o9265w01450v+VBNK9W0CWvVzZpIVI1QpwLcg"
        "LemGHhcfWlSELZ+qz5YpXeDejMTHSGhER/idQ8VKxZLbHlFp4yplyUnQFRMxm0ivVOnnTn9oddYuC2B3WxZT89"
        "yRs+jrQnsjrQpVOgm7JdPGJgjH6Tic0QOSwra/0Nm8qbjYtL1s6e/9DAZXjIyjQyUQTDUYjF1L79ZB4st39pci"
        "+NZr+i5cHTC9eUgt16r0sEiBJHZXtg6sZ5Ll5NnoCD4n4hYJCV3yiw8aGnZ8aJtQDRhC3y4wrfANjaYJM3mprD"
        "cmzM7NqnIzMFMPoZf4nifRbSR1csTbXSzjT2G5o6GLyBTqwuCnrRAMouxtkG5Km5swROHVxHzjYtWiZMiL4la0"
        "n/0cYdN4/P6GYEsdwl30z+rL6woFUUTMJ3p14oHxrEGsJ3y1ce1s09X1bPhzNR+JLDLoNlRufZwrLhukcUL7F1"
        "bbgyuRiOTLr6nN1JYZ3/AAsbd2cTf8toeYskBLVcEo6bFrnSeQOFEsMpz1SB26fYSyQXzJAMd7gRSCmdqmqYZB"
        "WYl6zqrTfAGaegGkzP2Jn5ZlMuLSdVQH/KLLmB/9JeBOGJzsYryxZaXFfuyVWzgQRoMmdTiG1RZR46refLB8Il"
        "UVvTGlXKobR4LLAwrgWrELy+E+FWCYzXmbN57wc0EhlE81V2eKgQqfGK7WHPEFGbG/L9kuw0KlsFMA6IatleiI"
        "UmqLLhlJK6csHTeDqzqH1lcAxwaEs8KVmglaHpGfaVIuk0nGt3o56Yydo0pwuuFJlVRwuv/9k=",
        ".jpg", {"color": "917f775c1cefd017730695d2a493dbc420171bddfcf832d3bcfb04f44f775a92",
                 "gray": None}),
}
# phase 16 (f): small files of the formats cv2 reads without a codec, one
# per kind (written by tests/image_forge.py, 6 x 11 pixels), each with the
# SHA-256 of what cv2.imread gives for it in colour (RGB order) and in gray,
# None where cv2 gives no image (a three-channel PFM read gray, a
# one-channel one read in colour, an RLE or RGB-ordered Sun raster); the
# PAM RGB_ALPHA digests hold 0 where cv2's conversion writes nothing;
# tests/test_torch_image_raster.py recomputes them with cv2
RASTER_PROBES = {
    "BMP 1-bit": (
        "Qk1WAAAAAAAAAD4AAAAoAAAACwAAAAYAAAABAAEAAAAAABgAAAATCwAAEwsAAAAAAAAAAAAA7d+tAKBWVAA3"
        "oAAAXyAAABZAAAAsoAAAWoAAABcgAAA=",
        {"color": '6fe7a6fe69f5dab8efb812c840b623903958513f22ee0d9456f3cc27ec8fb811',
         "gray": 'a16932057e965e4ded831de060af11dc0fba2975540af0f4604fa4777d4cbc67'}),
    "BMP 4-bit, 9-entry palette": (
        "Qk2KAAAAAAAAAFoAAAAoAAAACwAAAAYAAAABAAQAAAAAADAAAAATCwAAEwsAAAkAAAAAAAAAvdnJACsmHgB5"
        "uiQABNsgALow4QCzX2UAXbMuADlaNgDgDR0AxLfPMRBQAACJoRsxADAAAMbDCTANAAAArBgT4rbQAAABTTic"
        "/gAAAEZn59VoEAAA",
        {"color": 'b99a74c743412e9385a3f1868c43380c6abf5a1ad5fb6e8ceb7278441f109130',
         "gray": '16e1e1f9e8cc70c4e6b96ce15f561ae4c5bc5da311feb26ae524fdd9c512d70c'}),
    "BMP 8-bit, 40-entry palette": (
        "Qk0eAQAAAAAAANYAAAAoAAAACwAAAAYAAAABAAgAAAAAAEgAAAATCwAAEwsAACgAAAAAAAAAIrEFAFjANABZ"
        "blcACFjcAPHPPQBB8BAAuKbuABimeABoC5MAMLL1AMC7iACcu4EAfF6eALy5ogC1Z8AAzyftAKx1QADcr10A"
        "qZeXADDsQACCexIA2FXdAK5MBQAwDIMAQoQKAPYV3gAB4LsA86ZSAPvfVQDzk7UA3L2qABs5yQDNCD0Aa/+G"
        "AFK6gADl/AAAGv8hAB/BeABgxacAilYqACwUCxcsDwMhIQAFABgJGgERKxMhEAATACwmHAMQCRMAIB0QABos"
        "ISghIy4CGwYNAAABFC0DCBksHw4gACQGBiceFy0VBgghAA==",
        {"color": '152f10152dbbb3ba5ec532f8729b5facc72bd0214c34bd74f6625a3dac7aeb36',
         "gray": 'f1f40f51843eb2d53893adec5785d63ac454b42c46de4dd9a04a2ddee05c1e9d'}),
    "BMP 24-bit": (
        "Qk0OAQAAAAAAADYAAAAoAAAACwAAAAYAAAABABgAAAAAANgAAAATCwAAEwsAAAAAAAAAAAAA9/sKis3i4xaw"
        "9rXvo7hFluWSt+ms2Aq2hjXWPltRt6KoAAAAWHuT7Q+bKbGCFc0hbIqB9CqNTGf+JJk1rqSVQzTQ+ChbAAAA"
        "0IER38Wshf5dUPc+LkRo41qHqPk5J3jA89nIdJwanC9aAAAAqt/ogYDNlOpzrAvIIXVy6v6VSfkDfnXdiFFT"
        "wwffQ1TyAAAA0CVBCoAOBxRy/fRoI6ajhyY60fwuUiIi3h0KPfwnWi3mAAAA5MWE8kv/FqiKPKaHNLpn39U8"
        "+yYKNYYXyhHZkquWRYnKAAAA",
        {"color": 'c0bfd918bceff19463903694ede8d3dfc49d9f582da4a6ebac758ac2bdc59cdd',
         "gray": 'd3bcf600fa6310fce99016d8b50cbb38f64cb5f87f12b0daad458ec51ba7e4f2'}),
    "BMP 32-bit": (
        "Qk0+AQAAAAAAADYAAAAoAAAACwAAAAYAAAABACAAAAAAAAgBAAATCwAAEwsAAAAAAAAAAAAAv4iNA3zhs3O7"
        "FS4w/R759QDayYh9U7zsUmKdyUAfAJW1QjkdTdqKXaLP1vNZRbfaE/oqYjLcEfoWjMCDhlwxLVFmXguNRnlV"
        "DIPa0WTB+YvQViRUQjFgCV7cAWYojtBd4NOVnb8X2LO9cjCojkTB+B3ZacnKgL86oTRaP5eWJ4eG2aTM8b/A"
        "ctiLuzuDICTiVsNeTjkVhAOApJScyDx9myagxvClakyi/agovyNWN/BTlmHCQm77pvtqeDg4hAN6NR7vonwa"
        "sAjhBNbYvmiLJ4YsbWOrmTQMbNv/EhzdkaVSxAw5vVnYYjr2Y36vi+Wz+W6rcBA/fNoZoqSIyyImePIdKFnu"
        "KsH2",
        {"color": '2e97131f0ddbf425a79e9745731544c2c99861d2e0602f32f5108bf7bc7378a3',
         "gray": '577dbd3b163c4498c31a0dafd8b1a1a86ec6f45bfbe762390c388bf6b5165a03'}),
    "BMP RLE4": (
        "Qk24AAAAAAAAAHYAAAAoAAAACwAAAAYAAAABAAQAAgAAAEIAAAATCwAAEwsAAAAAAAAAAAAAYMRlABULWQDk"
        "wkkAj4geAFYn2QB0G6wACry8ANr3uQAqsqQAKB9IACiVGABqntAAtomvAC/E9ABMkzQAQpJ3AAJmAAIFAAAE"
        "7lUAAAKZAAIFAAAEiGYAAAJVAAIFAAAEZqoAAAACAAECIgACBQAABLvuAAAC/wACBQAABN1mAAAAAQ==",
        {"color": '40b8ebe9d40b3f7fc3101527ffaf231efac9abb7bcb4710981f54fc98ae0e99f',
         "gray": '8ba6be774a6ccfde9f884341a15881944015882eeab1c3089373a13e1d8da779'}),
    "BMP RLE8 with deltas": (
        "Qk3uAAAAAAAAAK4AAAAoAAAACwAAAAYAAAABAAgAAQAAAEAAAAATCwAAEwsAAB4AAAAAAAAAk94nAHHimwCq"
        "AVgADphlAI12MgBPGPsAmJ6iAFKw7QDGTY0A9B1VAJ5HvAAMAD0Ai1ayAFQXmQBXe5QADBVPADaIMwAdFYEA"
        "98SrANhdggAEdm4A44yqAPuiwgA1KmwAUXGXAL2tBADU+n8AXDLJABKltgCWs0MAAhUAAgUAAgsCBgAAAgMA"
        "AgUABBoAAAIEAAIFAAIaAg8AAAACAAECCQACBQACDQIOAAACHAACBQACCAIcAAAAAQ==",
        {"color": '17acb56bbe22f25235341d92572e267b6b97585b8ed9de25faab87c6a88e6b01',
         "gray": '3848a1b81cad8dd0c57f07b3b91b3ab8dad2549837ec50cdf3d799e6325f6286'}),
    "BMP 565 bitfields": (
        "Qk3SAAAAAAAAAEIAAAAoAAAACwAAAAYAAAABABAAAwAAAJAAAAATCwAAEwsAAAAAAAAAAAAAAPgAAOAHAAAf"
        "AAAAnps8JY/9Gcn1icPFCH42kjrvdDd31gAAeDiYRF/iLK/XFgk7rLtxyeWQKxsAywAAHFwblFa+MSsiADzd"
        "1+8Gf20bRQBMnAAA0wqjWfK4UAS/oMLaQSFqZFxYSxp6xwAAC75d5V79umjz8GHuXlFJgROZVT2XpgAAkB1T"
        "bG86twjtwiFak25qiL791B9VbAAA",
        {"color": 'd4aafdf84a4fda2edcaf6f8cb8cf42ba45e8ba6c9328a22e056cfe8b26c87108',
         "gray": '377b925022f4bad8ebea014447dc5cbe54916ac28f449d88f7c4b009ac299b87'}),
    "BMP OS/2 header": (
        "Qk16AAAAAAAAAEoAAAAMAAAACwAGAAEABAAyLqTLrwomRvTvHSnlqp7xOXVnV+SbR6DEiklARhwtn9UOM5Zk"
        "sWkHGAs8Y8waFETEt88xEFAAAImhGzEAMAAAxsMJMA0AAACsGBPittAAAAFNOJz+AAAARmfn1WgQAAA=",
        {"color": '6643c39478a3ef32cddf39a77b69512c5140e8cf334be1949e26eb7cb2a73f72',
         "gray": '56a5edde3c0d646c2562f3c7dd6b6d925bdbb0bf9a2e56d9cda85b473732f21b'}),
    "BMP top-down": (
        "Qk0OAQAAAAAAADYAAAAoAAAACwAAAPr///8BABgAAAAAANgAAAATCwAAEwsAAAAAAAAAAAAAGYikyz96km2P"
        "Hgsmfs/93NFK5ibmmj+LYXLsq9P7vMG3AAAAFJMNRW5HjVv+D1iQ6LssmaOvN0jalbPFEStJu0QcryycAAAA"
        "PPhCy3+6DpYEapaZ2JokY0YzpEjMHTycymoj6LIH5D7UAAAAB46t+IDa99UoOXG8xqqIGOtcZEdPYPLn3elr"
        "xy0Zxy48AAAAFhat2htDqTHHNbguszphOcqVyndb6VkS3gjY1yWB4BjYAAAA8JTVnCZps0ZhntHbXjDkeloY"
        "UTbo3dY3PBtDeEqrPlHBAAAA",
        {"color": '6de102bb03da8eae5a35229a305eb90dc813c483908286fcd83149d7a2814c61',
         "gray": '8326c2d0cba91d8e00742be9d6e3ec09fd3fe4beed966fae0b89dfe107ddd617'}),
    "P1": (
        "UDEKMTEgNgowMDAxMDExMTAwMTAxMDExMAoxMDEwMDAwMTAxMTAwMTAxMAowMDEwMTEwMDEwMDEwMTExMQox"
        "MDAxMDAxMTAxMTExMDEK",
        {"color": '815a64fbf2325285e200f5b7f4325fda1584490d86ff0bcba65cddd4cbae0df0',
         "gray": '16c5fa0acfabe449614877f7ad4bb2d59efa37b77f725898fde9fe7138dda401'}),
    "P4": (
        "UDQKMTEgNgoXIFqALKAWQF8gN6A=",
        {"color": '815a64fbf2325285e200f5b7f4325fda1584490d86ff0bcba65cddd4cbae0df0',
         "gray": '16c5fa0acfabe449614877f7ad4bb2d59efa37b77f725898fde9fe7138dda401'}),
    "P2": (
        "UDIKIyBhIGNvbW1lbnQKMTEgNgojIGEgY29tbWVudAo5OQoyOCAyIDU0IDgzIDIyIDcxIDkzIDIxIDQ2IDQ4"
        "IDc3IDQ0IDQ1IDY0IDg5IDQ3IDAKMjEgOTIgMzEgNiA4MCA3MCA4OCA3NyAzMiA3NyAyNyA5MCA0MiAyMyA2"
        "IDU3IDg4CjM4IDcyIDk1IDYwIDU3IDYzIDQ0IDMyIDczIDYwIDE2IDEgMTggMSAxNyAzNSAxMQozMyA2NCA5"
        "NiAxMSA0MCAxMiA1NSAxOSA0MCAxNSA5OSAyNSAyNSA0NCAxCg==",
        {"color": '342d8ae56a641a1991f0c18e51424949d38e984edd2d724ddc7d3afc8b28f648',
         "gray": '2cda2523d83df9472fa7e067192091e4bd96ba4ad966f9402bd7b0acab109138'}),
    "P5 maxval 1000": (
        "UDUKMTEgNgoxMDAwCgK8Av4AoANnADAA1wK+AiEBIACcAtcB2wKtAbACzAOwAT0BEQMYAWICYwGqAToAhQHD"
        "AoUD0wBtAEoDiQBdAV0DlACEAGgADwBAAFQBowCSABMA2gLNAUYApwJUAqIAowFYAVABLgLaAPMALgIzAYID"
        "cgKGAY0BkQOlAIkAZACuA9kBBg==",
        {"color": 'd1c5c2fa05f29215f43a3fbe938495d4fb82cde78d56932a72b35a272dd76382',
         "gray": '65edc15940fead0a45c1836e6f9f9b6fd28f9078511c1cf166369a1588000f7c'}),
    "P5 16-bit": (
        "UDUKMTEgNgo2NTUzNQodPzQdEhA5O1PJCvvmlApiSLbn8/yCilereXzreFeUP+ssuzQ4xben2N4cCKd2aBDN"
        "2jHn7WxEDAfktvbmKuXuy1x+gyUlk1Sl6wNacib40p7GhrYRtXj7ylg8UMGj02rzOPZBXzMhztofrePaqbYp"
        "0p6ZEmL4YIPSxJI6Rcriu0uqT1Q=",
        {"color": '2f79fb2475d722046ff129c379968116d301e2bee701867245cefacfd119aa5f',
         "gray": '3b65850ba1e814fd3b8834c54fab93b1c9c4ba77f385463b3ef81c3d7d6f5902'}),
    "P6": (
        "UDYKMTEgNgoyNTUK19wPV1kdrUXUfAx8zQpgqBOe5HT+OZCq0hl5pXk7xXthyGTstDzdxDV4fpjDp9OdNzGg"
        "Wq2zs0MjP+jI9mnzRzNOJfuwWrRj1t+SB/DhgCienDCW9UH0UImhZGCqF4KLENmjplVLRevn7MHfjrIE5mUw"
        "RRfUyN69xjZu90gXxucX+L8xu86TF4x5mWwolg/098NbK3v6mibyOUqH7ad1EM8f8AHQ0AJvY2cg7KICYOF+"
        "HZf6oDjg7MHiYMaaXjE6EE1qPzu4",
        {"color": '96d805639088a87db5a45a57c9b11b0ea726b4118e5ef750623075e3989b250a',
         "gray": 'd08c00ea61a0c62dac31388ca92c01c260982e4ca95137cd914cbc83863aaac1'}),
    "P3": (
        "UDMKMTEgNgoyNTUKMTM4IDggNjQgMjUyIDEzNiAyMjMgMjUzIDE2MiAxNTcgMTczIDE0NSAyNDIgNjggNTQg"
        "MTA1IDUwIDg0Cjg0IDEwMyAxNDYgMTQ2IDIxMyAyMSAxMTUgMTEwIDE3MiAxODQgNjIgMTEwIDE3MiAyMTgg"
        "MTc0IDE0OSAyMTkKMTY1IDEwMiAzMSAyMCAxMjggMTQ4IDE2MiAxNjIgNDUgMjMzIDg1IDI0MSA5IDEzOCAx"
        "MjcgMTcgNTIKMjcgMTUgMjE0IDE4IDE2OCA4OCA2NCAxNTEgMTEzIDE2MyAxNzEgMTY2IDUgODYgMzEgMTMy"
        "IDI1MQoxOCA5NCAxMTkgODcgMjAgMjAyIDg4IDE1NSAyNTIgMTQwIDEwMSAxMCAxMzYgMTk3IDE4NyAxMTYg"
        "NQo2MyAxNzUgMjM3IDE2OSAxNTYgMjAgMTQwIDE5IDIwNyAyNDYgMTIyIDE0OSA4NSA0NyAxMjMgNjkgMTI1"
        "CjExOSAxNTEgMTE0IDM3IDYgMyAxNjUgMTY4IDIzNyAyMSA1OSA3NiA3MyAxOTQgMTQ5IDE0OCAxNgoxMjIg"
        "NzYgMTMwIDIwMiAxNzggMjQ2IDg0IDk4IDUzIDM5IDE2OSA5MiA1NSA0MiAyNiAyMDkgMjUxCjcxIDExNiAx"
        "NTkgMTgwIDExIDIxMyAyMjYgNTAgMjAzIDE3OSA4MiAyMTUgMjUxIDEzIDI1NSA5MyAxNzMKMjM0IDIwNCAx"
        "NzAgNjYgMTI4IDI3IDEyNyA2IDIxMyAxMjcgMjMxIDE3OCAxNjAgMjQ2IDIzNCAzMiAyMjgKMjEyIDE1NyAx"
        "NTMgNDUgMjA5IDIyNyA5OSAyNTAgMiAxODkgNTMgODQgMTQ1IDE0OCAxOSAxNTggMTc1CjM0IDE1MyAyMzIg"
        "NjIgMTU2IDEyNiAyMTkgMjEwIDIxOCAxOCAxNDQK",
        {"color": '22df373f5a5c60b689019695d0f43b609fb00a1dee6c329c795ac1d4272ba598',
         "gray": 'f87590cc5ab78f9a828e4f68d5df95239530fcf158e8051c27a96de13999f052'}),
    "PAM RGB_ALPHA": (
        "UDcKV0lEVEggMTEKSEVJR0hUIDYKREVQVEggNApNQVhWQUwgMjU1ClRVUExUWVBFIFJHQl9BTFBIQQpFTkRI"
        "RFIK2LGZpRgxLL1Sj0lYWfGZG48I5LXW5iiFTpPqGyExlF3QE2hv78ebaTwHO2FDwNlo/KwJDJkyNUFX1jMR"
        "1w+T1CtkRwJWLHMeAHxlbo/GXA+CN+5GW7BTWHYoHN57Hdg/FKoRVZlyh2T1yvecDVPAuQJ0hTFAHvyRFwvp"
        "//hUgX1fghFRtXarqX+Tdagd+A+3OpjoChWVNQRAjcnQcbGulSNsi/Dcv/gRTz4X1TmAC3nYEw2/DfDMxvN8"
        "PRv4FAC7e2bZd0bxU30hcde2SGF0GoxhFpfP6n4GSLy86I5NDNAAUjaqiKtSix/7u8h/mjg+TioHWfyp64eX"
        "EMl4tad3naseIQ5KyMdl",
        {"color": '2ba7247f9465745c882b74c5f299b6c921cec6f9d37a59e953656f3e9cf47534',
         "gray": '41eb91aa19ea711adfb4a048e1773259d40ce4ba9f859838c1520dc1064712b9'}),
    "PAM GRAYSCALE": (
        "UDcKV0lEVEggMTEKSEVJR0hUIDYKREVQVEggMQpNQVhWQUwgMjU1ClRVUExUWVBFIEdSQVlTQ0FMRQpFTkRI"
        "RFIK5GY2t95HXRX2+LGQkaS9k8h5XB/OUKq8seix477yewadvCasw6A5o5AgraDYydoBEevTIUBg04zUm3eM"
        "D2Ph4ZBl",
        {"color": '7242b8e876f2201e3c4c69089afca7cb62db98fdc92fb2a84ce8d74b539fc0a1',
         "gray": 'befa9c53f9146f126d7b14f62d324659c42b98ebe85be970bd3adb63afb9ce8c'}),
    "PFM colour": (
        "UEYKMTEgNgotMS4wCgQ0O0MYUAFDfgS6wdy1R0KyqSJCegwFQ6LDZEM4cQFDG0InQ5oRiUIzFqxCFfGNQrMM"
        "OUM0zaTCWjf/QolLFEPZUipDbRgzQ0YRrkKu3IxCv/T7v5J1kkPmVE9DEUqOQrHaYEI9PD9DRrbEQvaYDEOC"
        "PqvAZdyXwBUhbUMbhbXBbXoLQ2GHKkMYWKtC0JHgQiWgxEK9fQ5Dc6v3QgprFkItCiZDAq0zQwU/6kE+tBtC"
        "yJ1hQ5M18kLijsNC6uTEQewbeUL/a/VC7QiZwutNBkOCjSJDfTqWQoAEG0JEkQdBuxaJQz6vIkNvYuNBVFo4"
        "Q+jeAENHzlBCkuE+Q6/BjUJkwmVDsKwaQ0U3W0Prea1Co6DvQlM0akMhhTFDfY2DQ6cDlkJ54+ZBs2WIQ2/0"
        "g0NSmz1D1pTzQqdgqEJqmFtDgwfiQuq/ZEKY7wRDwWJwQ/VTNEOfEt1AKABFQ21WREPJizVDo5F+QebVW0Ki"
        "5k1C7DsPQ269CUNFHAhDhH4FQT5ECkMsFzRDKStcQ4vOG0NBy5ZDHYqBQy2YG0MRr0FBF94rQ7XzC0EPKk5D"
        "aCXIQpA4h0PgCSRDeY4RQ233ZEOGetxCZdCGQ5xubUMqijpDxKrCQnJ320JaXzlDvd1wQ2LjF0MvnidDLI0R"
        "Qr8jBULp0ypCpeoAQyzGYEMUL39DUzNqQ6BfTkP09pVCFDo7QwHSr0J8yxNCvpb1Qh9Xn0I90zhDW6IiQ/At"
        "DENRnRBDV+owQw/UOUOvwm5Dob0UQ1iAA0NfB2VDZBW7Qk01BkMdaChDqWdiQ24oWEPyrMhCEmj2QhndU8Lq"
        "PkpDrrW1QpTZC0P0VGpC228yQvTOrEKILN5CUrNjQz/UMEPgLs9CcRNlQyhTCENvMiJD2qrEQqoQ40IcgjVD"
        "An8sP9FzlUKX+lxDknCSQgFOMkKN8y/Cl+F9QnvAy0L4Mf9C/VgdQ5I+E0M0aztCriXYQm0nIUNxGBFD6LtE"
        "Q1Hdc0PnCTJDkN9eQ43qCkNMlEtD/5huQrS7ikP8tzZDuYDjQt0mY8Lm1AFDGevdQg==",
        {"color": '0903aa733989ea19eb7a180b70bea41b9b82e20199510263f8a635139ca08b90',
         "gray": None}),
    "PFM gray": (
        "UGYKMTEgNgoyLjAKQv6/pkNKIT9C5syYQo3BgUKDf31BYtmcQsD/n0JVOWxDBXGtQyC4nkNZhaRDfw9HQwjt"
        "dkLYVPxDf5A9QuXJK0LsFq9DSea3QtAsiMFW4YFC+qDDQsfIKEKcytJDKo1TQppAm0Me57RCqazOQztyFEKI"
        "J9NDErJkQ2Uq6kKOtRlBvJyMQzXSsMIVLzFC+0MRQqbMc0MY0gRDDCg1QwkZeENXDIpC8C7GQwAmOkKUmb9C"
        "m5NuQ22cA0IKOJ9DHOVcwTAMXcCULLFCsNRXQsiz+0LQTytBAsshQwCYxkMhJn9DGvqvQvPXIcIzlmNCvOCU"
        "Qpv3DUIOuyXBrK70QqfzHENJIQtCfJ8d",
        {"color": None,
         "gray": '8a54e1faaca65c37b5f5042e038e95942aa1e5a603d55e4f64df408a18e8d0de'}),
    "Sun raster 8-bit with a map": (
        "WaZqlQAAAAsAAAAGAAAACAAAAEgAAAABAAAAAQAAADxv+4e+AOIFqquYus2bCtz0Z1qNmkLBU/tkArTR7Tsa"
        "oMp2DYoYEwFmvmbE8tKtfdLQn2zp8El/ZvthVYAMBgYPBhcVFQYICQAAARQVAwgBFAcOCAACFAkQCQsWAgMG"
        "DQAUDgQDEAkTAAgFEAAACQIBERMTCRAAEwAUFAsXFA8DCQkABQA=",
        {"color": 'fe769901568ab4e464d0872cdb6700ad13007e16a6c8dd960118d727394a352e',
         "gray": 'c1125cb7158fc19a73d6938d408c6762e40d66e974f47382a25ff9a340430f95'}),
    "Sun raster RLE 24-bit": (
        "WaZqlQAAAAsAAAAGAAAAGAAAAMwAAAACAAAAAAAAAADQjKbQjKbQjKbuwO7uwO7uwO7aFHnaFHnaFHnhhyrh"
        "hyoAxcZYxcZYxcZYObF2ObF2ObF2fu5Efu5Efu5EhZ9ghZ9gAJO62pO62pO62gcuKQcuKQcuKYzlKYzlKYzl"
        "Kbpz/7pz/wDpYGjpYGjpYGjdDY/dDY/dDY8J77YJ77YJ77b7sED7sEAAK05UK05UK05UGkjAGkjAGkjA7HQ+"
        "7HQ+7HQ+qlxlqlxlAD/BYD/BYD/BYEnXzknXzknXzq0HSq0HSq0HSijW3ijW3gA=",
        {"color": None,
         "gray": None}),
    "Sun raster RGB-format 32-bit": (
        "WaZqlQAAAAsAAAAGAAAAIAAAAQgAAAADAAAAAAAAAABoHTOSLYneBK/XFirw06QhWn/rfHqiEkosgJKvA2n9"
        "VjJwIcLSCt1bG6vCkWlB0mm1uLqksjjnSfa9K8ezkNBFo4ncmPl02XWBA264jwUU0F52s9QiBCP/Y40mrg8Q"
        "pnGyjNE2xs+6aFEykjTjPBGhbwOq5T8qM1+zdLE9khxGS0XuPVyCJrN/3uN6BTyyS4XMlyL6HMNi2w2CtE3w"
        "j4HlDV7a1EdDw3gMN1iyHkiBRVhhLohCWqkI/qL01ZwCVl4XIRFrk4V9k1z4b1VmpLa0w7DKugQM8gaeACyz"
        "qiJsefechdsCVKQw5r9uVtrKmcx8W2xdOvry/F6sYlkgiBZnv4Oul2DxmkE=",
        {"color": None,
         "gray": None}),
}
# phase 16 (h) and (i): small TIFF files (written by tests/image_forge.py,
# 6 x 11 pixels, the orientation-6 one 11 x 11, the CCITT and JPEG ones of
# (i) 9 x 23; one CCITT Group 4 file by PIL), one per kind, each with the
# SHA-256 of what cv2.imread gives for it in colour (RGB order) and in
# gray, None where cv2 gives no image (the decoder must refuse the read),
# "queued" where cv2 reads a codec the port does not yet (the decoder must
# raise NotImplementedError naming ROADMAP.md); (i)'s RLE/W file reads as
# libtiff reads it, some rows off their word boundary, and its cut Group 4
# strip as libtiff leaves it; tests/test_torch_image_tiff.py recomputes
# them with cv2
TIFF_PROBES = {
    "LZW with predictor 2": (
        "SUkqAAgAAAALAAABBAABAAAACwAAAAEBBAABAAAABgAAAAIBAwADAAAAkgAAAAMBAwABAAAABQAAAAYBAwABAAAA"
        "AgAAABEBBAACAAAAmAAAABUBAwABAAAAAwAAABYBBAABAAAABAAAABcBBAACAAAAoAAAABwBAwABAAAAAQAAAD0B"
        "AwABAAAAAgAAAAAAAAAIAAgACACoAAAAPwEAAJcAAABNAAAAgCWNZbK72dbzVwrN74IyvYCbRYRfrjCTjQLDHrcX"
        "bsaaELYPWQgNy9OIsdDtKCZVzUbB/AgVdTRTYLe7Hex9M5fK5paCGFyhHD2ciYaLJdpScioKKGViaU5pMCQb5XNS"
        "mXQYY4YSz4ORZfoXHppeCuaaSEikEzkfLCPBXBDBMYNZ7gChyCBqRxffw3EIRVaaNwDZ5JT8BIATz0LTCVniZ24V"
        "2u5WE9DEU1wyycNjuiUmfD8hBG/1etW+BAQgzkkCcN3eOG2UXqZhk+Ag+EUil4wVWfBCEgcmWQy1uPF890ygWhAQ",
        {"color": '6f9031bf2007701cbc4da897a93ffef52432d37199ec812e058c5bcfc30bfddc',
         "gray": '262d5963841b4df7380ca5ecfcec5fb1f415e036da7beed2b0a124aa48494688'}),
    "compat LZW": (
        "SUkqAAgAAAAKAAABBAABAAAACwAAAAEBBAABAAAABgAAAAIBAwABAAAACAAAAAMBAwABAAAABQAAAAYBAwABAAAA"
        "AQAAABEBBAABAAAAhgAAABUBAwABAAAAAQAAABYBBAABAAAABgAAABcBBAABAAAATQAAABwBAwABAAAAAQAAAAAA"
        "AAAApTW740RJo2+zJjmIVUGErUJXYl3wBUjRhR+silRAkg+HNDA0wpwAUosOD0remAE71uxUGHfPBK178+1LEhgx"
        "YGX4ggPVpmlPnuQJCA==",
        {"color": 'c09e82fea26dc831008297dce427d5c7be576b73741364140f8544cffd891fd4',
         "gray": '3d900eb41d3473ce69b199cbd3057876ee04950f9d97ba2f0cceb4e02f3f2b9a'}),
    "Deflate tiles": (
        "SUkqAAgAAAALAAABBAABAAAACwAAAAEBBAABAAAABgAAAAIBAwADAAAAkgAAAAMBAwABAAAACAAAAAYBAwABAAAA"
        "AgAAABUBAwABAAAAAwAAABwBAwABAAAAAQAAAEIBBAABAAAAEAAAAEMBBAABAAAAEAAAAEQBBAABAAAAmAAAAEUB"
        "BAABAAAA6AAAAAAAAAAIAAgACAB4nCt7Wjj1bW6qxNklZ3ITVO/O7p/9530z62YllZBCTXfRCyI2DKhg0qyGbunj"
        "Ru8NNtaxNvmu+79W8FlyipeK7kq5v/ZO0QuqvNHUM0aYZ3hoWbsnzvU+MH/dn5eTm9o3PbL7ytkxr5n1p6KKvBCa"
        "+tQ1Gj2f/028O+Pby8Yju34+ro6+P+lHznznr9+OqyubX7r3Dk391l3evjZxkxqPevS5eL7Q3bCL6UsMb+2MnSct"
        "Z5yQkWdacQNNvXlYrZXZie16GunGvrzST79NkTA+s+dp8AXfOTdMNjqxe6gzjIKRBABBmWE2",
        {"color": 'a762d4b5cae938d5d392e4764e58ea754381eb11a907ad4adb6c5e2edfe48622',
         "gray": 'e94e6c1e8405b153c2a412da4c1dde73737ec7b12836a4ae373b17eb9e1ab129'}),
    "planar PackBits": (
        "SUkqAAgAAAAKAAABBAABAAAACwAAAAEBBAABAAAABgAAAAIBAwADAAAAhgAAAAMBAwABAAAABYAAAAYBAwABAAAA"
        "AgAAABEBBAADAAAAjAAAABUBAwABAAAAAwAAABYBBAABAAAABgAAABcBBAADAAAAmAAAABwBAwABAAAAAgAAAAAA"
        "AAAIAAgACACkAAAA7QAAADUBAABJAAAASAAAAEUAAAAE8KDwUKD+AAGg8P6gBPBQAFDw/1D/oP7wA1CgUPD/AP/w"
        "BFAAoPCg/wAC8FAA/1AAAP/wBQBQoFAAUP8A/6AAAP9Q//ACUKDwAvBQAP9QD/Cg8FCg8ACg8KDwoPBQAFD+oAEA"
        "8P+gBfAAUKBQoP8A/vABUPD/UAgAoFDwUABQoPD/oAMAoACg/wABoFD+8ACg/vAAAP/wAwDwoAD/8AFQAP9Q//D/"
        "AADw/qABUPD/UATwoFCgAP2g/vAHUACg8ACgUAD/oP8AAaDw/gAD8KDwoP7wAQBQ",
        {"color": '3ea9d6e90211a8af97974cb6ad99de697b3ea27f9a16cc76ca8403a2554f2ea4',
         "gray": '1196633f4acc798dcb2f65a5eb06ca51a821ee53925fa0393350915d2b55cf6c'}),
    "16-bit RGB": (
        "TU0AKgAAAAgACgEAAAQAAAABAAAACwEBAAQAAAABAAAABgECAAMAAAADAAAAhgEDAAMAAAABAAEAAAEGAAMAAAAB"
        "AAIAAAERAAQAAAABAAAAjAEVAAMAAAABAAMAAAEWAAQAAAABAAAABgEXAAQAAAABAAABjAEcAAMAAAABAAEAAAAA"
        "AAAAEAAQABAuuFsOjqodfENYwRPIoyKVELnABm9kP2zD13D58h164WgeWop3qhg4vg3U+8GDNzj1EiR/G25vo7vt"
        "jpjqNkTOrC6Xu7hNZ9rgi6f/366pPBZ0Tw3dHSFkh4iNWc8cRHRvXEJX7XKjJ4ATlc3DGQucqQwPdhGBswLLgdlU"
        "lMH9ZddLHRlM65xnJ3Z1nku7xrESAZqdRxIbhYkMxQrQ1Ep+7qJJpKCtayN8Hjuh+1fUGqLIQ1rXyS4lcN+CTvgW"
        "gah7gDLJqHrTN7YEDeloZrqEdu8VUY0/wFDbq9K4ebE2uirDcq+c13fxlC549lPFgqqhC6sxv7DuIuzQuzQwo+JM"
        "M5SDEXlNIKMe/k/P6219P0QHg/w1Oa89s1mkloa8ml23+GgojsNQoc6qEjsfoDMr8uC7Gy2L2N6XymhT7ngznGbE"
        "vKzMWU08uUKE+cBsmoRMAnD+U6Sxm1Bh5WTPZAVswhRPyr2Gb/ZhwW7rHgkUQtiEzjBDEI04hpr3lV4wMEurz/rW"
        "1LiZTgX7QiY=",
        {"color": '041ec4f181a293473f504b55d996394543dea5e4fd99ffba4cbb7cf5eda5b5d9',
         "gray": '9469c509b7a5b85de8391438be295762b49e5716f79f5364b3b822adfa94661f'}),
    "palette": (
        "SUkqAAgAAAALAAABBAABAAAACwAAAAEBBAABAAAABgAAAAIBAwABAAAABAAAAAMBAwABAAAAAQAAAAYBAwABAAAA"
        "AwAAABEBBAABAAAA8gAAABUBAwABAAAAAQAAABYBBAABAAAABgAAABcBBAABAAAAJAAAABwBAwABAAAAAQAAAEAB"
        "AwAwAAAAkgAAAAAAAAASUSboq8QEGnFJAIf+UJERz8saki/BIEjFQWhwnfAxcDCgB6Oqps8HbE2UouhZuAtdjxGi"
        "WpyreRJt/k4PsA7Gs2nbAtR4j1rPLPU5d/46+ll9usphYYC0vNZwIClQEzfy/dzOjWDpxv9J8wDY8r4INYCc8JHz"
        "GbDmS3BDrWDmGDXi+sA=",
        {"color": '7f3249ef75cfc7bbcae7822a31c4103c2de4243c4ce0240e0cc0f374abf83c54',
         "gray": '8a395be676af7dcb88314952968a10adaf2dc6d726d4f0702325cd1cf13e0bc8'}),
    "CMYK": (
        "SUkqAAgAAAAKAAABBAABAAAACwAAAAEBBAABAAAABgAAAAIBAwAEAAAAhgAAAAMBAwABAAAAAQAAAAYBAwABAAAA"
        "BQAAABEBBAABAAAAjgAAABUBAwABAAAABAAAABYBBAABAAAABgAAABcBBAABAAAACAEAABwBAwABAAAAAQAAAAAA"
        "AAAIAAgACAAIAArGNjGWJMu0fPNw70Dx7UMHVkqXDGjD+FWS7RNmXpDnOMkjOuQdGKRjv6ZrWh2NvM0LzKXcJtN7"
        "VsnO59yk5QUz5MueLzSR1mW1eFOaIJb4Tj3xk52H8GV+IbdsM74kH/n8RkYrLmVWl35SrGC7G+kcWObXReAosJP/"
        "j1CFXezd998avw2aVSgOUfxR1/DWtmwmGx/8VluaWuSQ4MNfvwPupgY8Z44Glac0Ygl+5Wv1a6V28RxyxTTauZ/Y"
        "EVrV2vMqe5qb2SAPiSaZwlksYYfHJMRrRGHX6wT8xV3RuvKtvcqzagj2JOVvX67j6zWHKWpmoncAxcdwvHoAvjxo"
        "1zOtb/VqTaqpcA==",
        {"color": '3d48689febb228a45e8d8f11d6ef9ae262567e665dd3c6dfa6df4eec92879073',
         "gray": '3761646fc8363cc1e048218b138c49d3cb229b6d4004cb6e382aab1d3654e3d7'}),
    "premultiplied RGBA": (
        "SUkqAAgAAAALAAABBAABAAAACwAAAAEBBAABAAAABgAAAAIBAwAEAAAAkgAAAAMBAwABAAAAAQAAAAYBAwABAAAA"
        "AgAAABEBBAABAAAAmgAAABUBAwABAAAABAAAABYBBAABAAAABgAAABcBBAABAAAACAEAABwBAwABAAAAAQAAAFIB"
        "AwABAAAAAgAAAAAAAAAIAAgACAAIAGWYUgK/rt253nP2hM9qzmDupQPcAHs8uYhMLuatwpcfAXyH2kMXxYrKzaDF"
        "qWWVXMVHGhL8voQ4ZWcQzvuuerzKxg/H2jmBScLzjtgG2LdXW5msmKSG6r3hf0L5mWRaLLYbZ0ELFBO9/i1OY8hQ"
        "H/1uXkNMzDiUq6go7jn8GbY4gNHBoGVi5iT5shGC2yQd3VpBSxszc+Zs7wUkdSHLrhmHlEEpKcPnmoS4jknVN04V"
        "ISFy06HtnTnJfUArNkZfUssNQU86gMBq+OjnsYEV6fq/lhFk5GyvncSmxKR1729Eu9p3UmD7I5/WMN53lv3w5jfL"
        "Pj2yaTAtBiqdj6M9X8MRcDFkrIYO/A==",
        {"color": 'cef39f214b0bc9fdf174cd1e319629aed5a8f666beea14b851ed568de1939fe0',
         "gray": 'b0acc548044f7f1223057c63414b4df69f1c8eaf8fef48f59e55065943bd285b'}),
    "YCbCr 4:2:0": (
        "SUkqAAgAAAALAAABBAABAAAACwAAAAEBBAABAAAABgAAAAIBAwADAAAAkgAAAAMBAwABAAAAAQAAAAYBAwABAAAA"
        "BgAAABEBBAABAAAAmAAAABUBAwABAAAAAwAAABYBBAABAAAABgAAABcBBAABAAAAbAAAABwBAwABAAAAAQAAABIC"
        "AwACAAAAAgACAAAAAAAIAAgACADN2ltJEFDcIWOfY0Wx6kR6iU410+QLIfzpJpF9RpU6OrCw0NFa9UZ7xvNlQfAg"
        "yVpk4kJX251bE+vWEXThS2eBfnoJCby8oEfFbZVuINudBDNmYXuiitCcE+9dr8hnrSomOZLwurHy8sPDcsw=",
        {"color": 'd45a222b77f017ceec6b704006a528a2650b495a240da7cd159d1b082e4ab955',
         "gray": 'e3db807e169a629076ce9d213e5ce856ef37f909f1edac61c221607188fc7d4c'}),
    "orientation 6": (
        "SUkqAAgAAAALAAABBAABAAAACwAAAAEBBAABAAAACwAAAAIBAwADAAAAkgAAAAMBAwABAAAABQAAAAYBAwABAAAA"
        "AgAAABEBBAABAAAAmAAAABIBAwABAAAABgAAABUBAwABAAAAAwAAABYBBAABAAAACwAAABcBBAABAAAAqQEAABwB"
        "AwABAAAAAQAAAAAAAAAIAAgACACAPEUKt4uBkI8NppQncpMB+K5FtQNnNxjUpMRwqI/hY4vIOlh/CZiDcGOMEL8o"
        "qZAj15iBzDZJKgEngonttGktmdrllfmsDIkcnRRhlVF8Cg9gvstuUsv13K9OEkJCh9IByFR+EJ7vl0tQEOBiJNct"
        "4DMthuhBOVID0FuJDjBgudEoYPhIuq0/uQYNJ1tNHjB9uwyts3ssZltvu83uxAixNiAYoR5l8Hp9hnpcA5TAhamI"
        "VvNyntFlp/gxOJFiMQQK1GrYqrNBBpDOB7HokFMhqJMmhyrtNBNoiZ8oZqnhnIJ0oBgAwWL8km9Cl53oR/FxdkQv"
        "L0LAA2s9zFwBuYjnVIAMIpNyjIJCclrEEmNoFwcNYAgk2lhzLogiZNHIrm+JQ4FkGQKkYcpRlsN5vloGoIAuOZkj"
        "+XoijUMYSG+GBXGUA5+jOE5MD0PBahSbppm8dwRFIEwXFSahFA+MhrFIP5zAUO4uiKHJQCiCwgDUDIdHiGZSl4HI"
        "7mwBBpmUQ5uCQAI0mMYpVjAVQ5iuUxIDiHw3kyegBCEHZVigbh7BCOpkFGJAwFWgIA==",
        {"color": '3f145e7fb8406bf9319279bbfd0cf4c0ebbf1d31ee861b984f8e0bf499d35da0',
         "gray": '382658e95b5d892aae197530f00db6f7d9028eb4edf2a99d1c86564615941f2c'}),
    "no-image codec (ZSTD)": (
        "SUkqAAgAAAAKAAABBAABAAAACwAAAAEBBAABAAAABgAAAAIBAwABAAAACAAAAAMBAwABAAAAUMMAAAYBAwABAAAA"
        "AQAAABEBBAABAAAAhgAAABUBAwABAAAAAQAAABYBBAABAAAABgAAABcBBAABAAAAQgAAABwBAwABAAAAAQAAAAAA"
        "AAAGf2djHp3RfPogluHD3QG0RyJjEYQ7aYpLw2kAIJy4T7UE0BA8I840DqRvp6flT+p6XGuWr7V/p1wtbwefuOnq"
        "sSo=",
        {"color": None,
         "gray": None}),
    "CCITT RLE": (
        "SUkqAAgAAAAKAAABBAABAAAAFwAAAAEBBAABAAAACQAAAAIBAwABAAAAAQAAAAMBAwABAAAAAgAAAAYBAwABAAAA"
        "AAAAABEBBAABAAAAhgAAABUBAwABAAAAAQAAABYBBAABAAAACQAAABcBBAABAAAAHgAAABwBAwABAAAAAQAAAAAA"
        "AAA1QMA1HAuANSgfgDU7KYA1eM41/0I1QyA1Sdg1VRA=",
        {"color": 'fe9c7c2efafe681a3e877e4327d9ec2db54af0ac78d59ea088a6b42bcaa7773d',
         "gray": '8b52aa3336ad7e94de49be2ef05ba21275cd86d9f247732cbadfe7d5416f3569'}),
    "CCITT RLE/W": (
        "SUkqAAgAAAAKAAABBAABAAAAFwAAAAEBBAABAAAACQAAAAIBAwABAAAAAQAAAAMBAwABAAAAA4AAAAYBAwABAAAA"
        "AAAAABEBBAABAAAAhgAAABUBAwABAAAAAQAAABYBBAABAAAACQAAABcBBAABAAAAJAAAABwBAwABAAAAAQAAAAAA"
        "AAA1QMAANRwLgDUoH4A1OymANXjOADX/QgA1QyAANUnYADVVEAA=",
        {"color": '4992f1860f1b39b2be5e2e777a4e3abf2e42f6ae0135f383203f044eb93f970a',
         "gray": 'fed1384975a3fd08dcb271c8b1ef74662f628de9acb1cb30fb56e62521ba2aab'}),
    "CCITT Group 3 1-D": (
        "SUkqAAgAAAAKAAABBAABAAAAFwAAAAEBBAABAAAACQAAAAIBAwABAAAAAQAAAAMBAwABAAAAAwAAAAYBAwABAAAA"
        "AAAAABEBBAABAAAAhgAAABUBAwABAAAAAQAAABYBBAABAAAACQAAABcBBAABAAAAMAAAABwBAwABAAAAAQAAAAAA"
        "AAAAE1QMAE1HAuAAmpQPwATU7KYAJq8ZwATX/QgATVDIAE1SdgAmqqIAEAEAEAEAEAE=",
        {"color": 'fe9c7c2efafe681a3e877e4327d9ec2db54af0ac78d59ea088a6b42bcaa7773d',
         "gray": '8b52aa3336ad7e94de49be2ef05ba21275cd86d9f247732cbadfe7d5416f3569'}),
    "CCITT Group 3 2-D, fill bits": (
        "SUkqAAgAAAALAAABBAABAAAAFwAAAAEBBAABAAAACQAAAAIBAwABAAAAAQAAAAMBAwABAAAAAwAAAAYBAwABAAAA"
        "AAAAABEBBAABAAAAkgAAABUBAwABAAAAAQAAABYBBAABAAAACQAAABcBBAABAAAAMQAAABwBAwABAAAAAQAAACQB"
        "BAABAAAABQAAAAAAAAAAAZqgYAFI4IuAAZqUD8ABVUABmrxnAAFChKABmqGQAAFqAAGaqogAYAMAGADABgAw",
        {"color": 'fe9c7c2efafe681a3e877e4327d9ec2db54af0ac78d59ea088a6b42bcaa7773d',
         "gray": '8b52aa3336ad7e94de49be2ef05ba21275cd86d9f247732cbadfe7d5416f3569'}),
    "CCITT Group 4, FillOrder 2": (
        "SUkqAAgAAAALAAABBAABAAAAFwAAAAEBBAABAAAACQAAAAIBAwABAAAAAQAAAAMBAwABAAAABAAAAAYBAwABAAAA"
        "AAAAAAoBAwABAAAAAgAAABEBBAABAAAAkgAAABUBAwABAAAAAQAAABYBBAABAAAACQAAABcBBAABAAAAEwAAABwB"
        "AwABAAAAAQAAAAAAAABk1cRBdErQqhUaCmkhdB0KgAAI",
        {"color": 'fe9c7c2efafe681a3e877e4327d9ec2db54af0ac78d59ea088a6b42bcaa7773d',
         "gray": '8b52aa3336ad7e94de49be2ef05ba21275cd86d9f247732cbadfe7d5416f3569'}),
    "CCITT Group 4 (PIL)": (
        "SUkqACAAAAAmqI+R8Eo0kggsIKwuNr1cY2CCUAEAEAAJAAABAwABAAAACwAAAAEBAwABAAAABgAAAAIBAwABAAAA"
        "AQAAAAMBAwABAAAABAAAAAYBAwABAAAAAQAAABEBBAABAAAACAAAABYBAwABAAAABgAAABcBBAABAAAAFwAAABwB"
        "AwABAAAAAQAAAAAAAAA=",
        {"color": '2b0145dfde11f2674fba16f2b34bf2dbb173f6a89e5ffb26df353aef2cf4560c',
         "gray": '831665a30afdf21d2d9f81377415146eda32ffa7fc26a917157d195806bf314f'}),
    "CCITT Group 4, strip cut": (
        "SUkqAAgAAAAKAAABBAABAAAAFwAAAAEBBAABAAAACQAAAAIBAwABAAAAAQAAAAMBAwABAAAABAAAAAYBAwABAAAA"
        "AAAAABEBBAABAAAAhgAAABUBAwABAAAAAQAAABYBBAABAAAACQAAABcBBAABAAAADAAAABwBAwABAAAAAQAAAAAA"
        "AAAmqyOCLlILVahYUJY=",
        {"color": '23d9054147f6d8b3668cfa4cd698a6e085fa59b63eaa87317e50dc5609f96f86',
         "gray": 'f29ae151b78bc84013a085dc6aa8baaa07a685a8a52ac0c9cd3ab2e6e2f026e0'}),
    "JPEG gray": (
        "SUkqAAgAAAALAAABBAABAAAAFwAAAAEBBAABAAAACQAAAAIBAwABAAAACAAAAAMBAwABAAAABwAAAAYBAwABAAAA"
        "AQAAABEBBAABAAAAYAEAABUBAwABAAAAAQAAABYBBAABAAAACQAAABcBBAABAAAAbgAAABwBAwABAAAAAQAAAFsB"
        "BwDNAAAAkgAAAAAAAAD/2P/bAIQACAYGBwYFCAcHBwkJCAoMFA0MCwsMGRITDxQdGh8eHRocHCAkLicgIiwjHBwo"
        "NyksMDE0NDQfJzk9ODI8LjM0MgEJCQkMCwwYDQ0YMiEcITIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
        "MjIyMjIyMjIyMjIyMjIyMjIy/8QAQQAAAwEAAAAAAAAAAAAAAAAABAUHBhAAAQIDBgILAAAAAAAAAAAAAQIEAAMR"
        "BQYSITFxUcITNDVBYXOBg6Gxsv/ZAP/Y/8AACwgACQAXAQERAP/aAAgBAQAAPwAC8zie2clLROFCsOhqmnCm/wBd"
        "wMKLAeOHDuWJq14SunSLXXP18aa7RWGNisHdnla5ZqdU4wMJrmDmOPyInlsaN/O5EwPdztP2OaNjI6u73P7Ef//Z",
        {"color": '3d3c978942f0001e09368fc3409a851ee9416670c0ac013a5c1f5ea7a8b496ca',
         "gray": 'b72a085948370ebc72a6fc73eeea9793505da31626b31c4f53dc1a0c72204269'}),
    "JPEG YCbCr 2x2 tiles, JPEGTables": (
        "SUkqAAgAAAANAAABBAABAAAAFwAAAAEBBAABAAAACQAAAAIBAwADAAAAqgAAAAMBAwABAAAABwAAAAYBAwABAAAA"
        "BgAAABUBAwABAAAAAwAAABwBAwABAAAAAQAAAEIBBAABAAAAEAAAAEMBBAABAAAAEAAAAEQBBAACAAAAsAAAAEUB"
        "BAACAAAAuAAAAFsBBwAdAQAAwAAAABICAwACAAAAAgACAAAAAAAIAAgACADeAQAAYQIAAIMAAAD7AAAA/9j/2wCE"
        "AAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDIB"
        "CQkJDAsMGA0NGDIhHCEyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMv/E"
        "AJEAAAMBAAAAAAAAAAAAAAAAAAMFBgcBAQAAAAAAAAAAAAAAAAAAAAYCAQAAAAAAAAAAAAAAAAAAAAYQAAEDAwMD"
        "BQAAAAAAAAAAAAIBBREDBDEAEiEGIlEzQWFywREAAQMFAAAAAAAAAAAAAAAAAQIDEQAEBhMxEgACAQUAAAAAAAAA"
        "AAAAAAABAgMABAYTUf/ZAP/Y/8AAEQgAEAAQAwEiAAIRAQMRAf/aAAwDAQACEQMiAD8AfvjdYtO46JgKKPYQ4TiO"
        "YVcxrMLzqV0tXBUId1AS2CoSKInuifGI8xxjUDV6ie6/qvDhU+90a/uhE8uhFuJyvFWZla5Z850AdyhDlzuCVATy"
        "RQSyyxIJ9kqs68JFf//Z/9j/wAARCAAQABADASIAAhEBAxEB/8QAjAABAQEAAAAAAAAAAAAAAAAABAUHAQEAAAAA"
        "AAAAAAAAAAAAAAAHAgEAAAAAAAAAAAAAAAAAAAAHEAACAQUAAgMAAAAAAAAAAAABAgMABAURIRJBBjFREQABAwUB"
        "AAAAAAAAAAAAAAADAQUhAAIGEjEREgABBAMAAAAAAAAAAAAAAAADAQIFEQAGEv/aAAwDAQACEQMiAD8Al6af4jm2"
        "nkV2WzuD0Dh8D7/dj1v6rE6e2dy7QyQtlb4xSAh0Nw/iwPCCN9oFGeSvoXcgrxD00TxeTPYoz2edDMHYUI+EalVn"
        "/9k=",
        {"color": '62f7297cba5344fa186cd57041b9956cf40e9668870a06c5fc08c10bd8221dbc',
         "gray": '8a9f9a03d5aadb2cc94ee371171e2c635a0836a790f3acca9b15a48e4c7b0991'}),
    "queued codec (ThunderScan)": (
        "SUkqAAgAAAALAAABBAABAAAACwAAAAEBBAABAAAABgAAAAIBAwABAAAABAAAAAMBAwABAAAAKYAAAAYBAwABAAAA"
        "AwAAABEBBAABAAAA8gAAABUBAwABAAAAAQAAABYBBAABAAAABgAAABcBBAABAAAAQgAAABwBAwABAAAAAQAAAEAB"
        "AwAwAAAAkgAAAAAAAABHReyptvtsOlJeZHfs1J1tzxvb5JJSLQ5yxztdEhYz3/VtgNNtidHH9dswFvSAv8Ji5S7A"
        "NIQpPVxks3pUGMf3V4fby83hG5fvyLrj8MDNB4d0R7Wy01Idr67eQmK67TXCw87FzsDGxsnKw83BxM/Iz8LIyszB"
        "zMHKxsDFxs7IxsnNz8TOwcHCxsbEzsLPw8nOx8bCxszHyMfFycnCzMTNy8g=",
        {"color": 'queued',
         "gray": 'queued'}),
}

# phase 16 (j): small GIF files (written by tests/image_forge.py, 9 x 23
# pixels, the deferred-clear one 150 x 150 so that its LZW table fills),
# one per kind, each with the SHA-256 of what cv2.imread gives for it in
# colour (RGB order) and in gray, None where cv2 gives no image (the decoder
# must refuse the read); tests/test_torch_image_gif.py recomputes them with
# cv2
GIF_PROBES = {
    "256 colours": (
        "R0lGODlhFwAJAPcAABzQAxPsckjXzQu6tD53mNDmu/x/zmSTsVl15YHHtoRsukps6stcTc+B5tAeGThNiYEmBL42"
        "8FRt+8o1SeMN2KjwsZAaBpVzclrCLY6DRpDoYHCpbdUfzmm+OaTVV42KZG8VH+oktOiIKd7NkLvLEyt79eFtqHEC"
        "j9hfb6xrpRzREAQLdPOJgD0dD/vv+Jvqq+L27gOWgOl4PdGA4otcesa2INdMck3ByfUi7JVQMwrO21jDUOtrkvQX"
        "euijY7tTEjp+XsVtHO5Y8ufS6HbAfJX2bzGPSOW84W3BpobKHU3/tVUQMb6v3hYvvbFVhIZ0iqx918u/uWOq29JE"
        "EAz7WGGNA3tJPJ5ufl8yaBvs1WrnqndWp6CqpN3ftQU0wM+Gn7t6EGQuo9kE5QKTjsZHsQI9hrO7TxVuydtZDQO9"
        "AVqAGEBHC9r2xww+TEFnHsoadWWIDCEkMLZ0StfwdmTCTCnmn4ms5/aENE1N2WXW/7JiutVg1AdCkHHYcyeWItn3"
        "hjdNR9g2POn0ibLmGSvdTrsa9o2f5JmrO64qRF4kusNTYtlqcUzrKne4Lm1jQSRSoljD7XXJwg7DgWkCMol6BhyW"
        "0WdKNHSN/zgraEX9+ZArsCy6eQe4GA+zlJISthbzh2IZaGXwMWfkYuIemrp9bE2Liv7GoHTIM4rDtA9GbTmChWzx"
        "DAjGGicNliH+Ddpot/j6L+XiJuP5819o/IM8Kxc9wif3I/cxLCqAy+JT3hiO7ttKCAOCM86VCq/4eFaQGKF8dCDt"
        "xL6pJvT63n/2jG7lbqTpMrpmmI6NcyogYk9wos45/QaDyvsqsJ0e9ON78W3Q0HPGdPStkTckt+3THWF+UsJWRPpz"
        "fTo23X9Nw4UMXUpojmhTQIIfWGv4CGxeV15W8Yi1sV+7h10L7ii2gAONt+QdmX0VkXjv2FvQzV5Z9XuxZu5Ta1Ko"
        "9uqRm4F7145Rf1uOubtQZ7fpZ5bDqyvIQqy+n5yV/Qbsb16zZ9UquCpk93O3SBgkzXi8ue5hkywAAAAAFwAJAAAI"
        "7ADjCNgSpZ8vDmQ48YnjgAeJMGoQkHuHpRuYBRuigdFFjIWAfUyirLLWSZKAUjSuwcqkYdIKPlIUQCkBxdaCfec6"
        "gJOFDpA5JtlgnSoC45U3E68mCanALEUsCGmEQSMD71smHKwgZBPlBYsaKeJ44Ip0RYYPZIMIgDnXJcSwPzuS8fhH"
        "YZYxIB/6VdKXr020GgW4HKhAxpW9MuakwZE0zgUEYbtUaHmSqkKPfgFIqNGhR8Wvbh9kucm2J0IDAKEg5OI3Kt8F"
        "QPXYbcrz6wcvdwtsvFE0rU+nOGnoObo36NWJNGbuJJBm5tirPwEBADs=",
        {"color": '261b19c5981ef468f14f07f10594c5aefd5a300f1d97f14ace7fb5f404e2c591',
         "gray": '41f53ed44d2641bc44c19e654fb8ab603f6e9e8644864158caceff286590d889'}),
    "interlaced, 9 rows": (
        "R0lGODlhFwAJAPMAAAKYwDm2T9qI+lGrdfbpsLaIZ7ybZl/u1V+8jWxI09g6FX5qHsShxYerzvtBsZk4SCwAAAAA"
        "FwAJAEAEThBI8OpTWJVdjj/WdwzkQJxEoAZO61gTZTV0kymioZf8gPwITmFBXNSKCxSBpxQ4Ba6o5cGoMmJWRk2n"
        "Eya+iWh2Imo+z+CElRebppXcCAA7",
        {"color": '2845814af6f41de2fa6497ccc87b28f97f7cc0d4157eaf5f70bb5f1c91ab30a1',
         "gray": 'a81b4f260a2f4b58c2bb40ceb8889a6a4786bb5a054e1560c8a10066c4382fa3'}),
    "local palette over a global one": (
        "R0lGODlhFwAJAPMAAAKYwDm2T9qI+lGrdfbpsLaIZ7ybZl/u1V+8jWxI09g6FX5qHsShxYerzvtBsZk4SCwAAAAA"
        "FwAJAIFRq3XaiPo5tk8CmMAETxBI8OpTWJVdjj+WIzrWw5zMBKBM4w5wDCM0whVLvriN4Ru3hDAxcrBUkxKvkVF8"
        "Dr8nYUoQWK/WYQKlW1AJsi92JFOVtN/oJ0wNuANFSwQAOw==",
        {"color": '1701f9af7c8f89b8798f28f84c6e73d152d1e483e66a9dea56eac590430ee9d8',
         "gray": 'c09ebde9ab0a0a81394fd4e0f91ef0509bca0af0a8bd70f68f56637953fee13d'}),
    "no palette": (
        "R0lGODlhFwAJAHAAACwAAAAAFwAJAAADNwgK0yNQhBkWa9YNWhcnYCQKGlecBaiCnOEaFmct2ipaqoUWb+9Tu51o"
        "11vcaI7eLmeM7DSZRgIAOw==",
        {"color": '50205c065d3ca2d1504346eb5ca1233ac9cffa591e61275e72d40b55bc0aff0b',
         "gray": '3baac67e8dd480383dd3f5f03e640f41a4c74a43e594ccb12c3b8857ffe897fb'}),
    "offset frame, background, transparency": (
        "R0lGODlhFwAJAPMFAAKYwDm2T9qI+lGrdfbpsLaIZ7ybZl/u1V+8jWxI09g6FX5qHsShxYerzvtBsZk4SCH5BAEA"
        "AA8ALAMAAgARAAYAAAQvcEiJKiq4rL1MLkmYOKTDnAzwrE/jNkqsHDRN3ISg77qYLDjCZBDkDQBIFcsXjAAAOw==",
        {"color": '319586b16a34ff7a7a10c8f3a12131722d22c7a00db8a51b836c559d34ba10c6',
         "gray": '341ac01586c3d61f45078aaecc7452334f8c69c62d1d50eb7970124b49ab85d2'}),
    "transparent index the background": (
        "R0lGODlhFwAJAPMDAAKYwDm2T9qI+lGrdfbpsLaIZ7ybZl/u1V+8jWxI09g6FX5qHsShxYerzvtBsZk4SCH5BAEA"
        "AAMALAAAAAAXAAkAAARPEEjw6lNYlV2OP5YjOtbDnMwEoEzjDnAMIzTCFUu+uI3hG7eEMDFysFSTEq+RUXwOvydh"
        "ShBYr9ZhAqVbUAmyL3YkU5W03+gnTA24A0VLBAA7",
        {"color": '2845814af6f41de2fa6497ccc87b28f97f7cc0d4157eaf5f70bb5f1c91ab30a1',
         "gray": 'a81b4f260a2f4b58c2bb40ceb8889a6a4786bb5a054e1560c8a10066c4382fa3'}),
    "87a, 2 colours": (
        "R0lGODdhFwAJAPAAAP///wAAACwAAAAAFwAJAAACIIQRGYfqyhyb59loZc20m7xsiRh6H3SOpJmWzUWBmJoWADs=",
        {"color": '9003d44477df995636ae3866b8ee084237cbb75f8cd66c4f666a16d3521e23b0',
         "gray": 'e95f24ae8526d0bf46ee69a45169c7de60f80646b3f114db05ae3661975655d7'}),
    "minimum code size 11": (
        "R0lGODlhFwAJAPMAAAKYwDm2T9qI+lGrdfbpsLaIZ7ybZl/u1V+8jWxI09g6FX5qHsShxYerzvtBsZk4SCwAAAAA"
        "FwAJAAALlQAIAAIIAA9QgA+gAAioAAWwgAVwAA54AAboABLoAAb4AAxwgQwwgACAgQzQAB44ACAYgiCIACSIAAxY"
        "AAuQggvggQ1gAC5oACeYADKYABPoAByogQNYgSzYAAmoAA94AC/4gwQwhAQgAEZ4hEY4gwmAgSq4AERIACL4hEg4"
        "gSKogRWohE8YhA8YhUQYAF4YADVogAEIADs=",
        {"color": '2845814af6f41de2fa6497ccc87b28f97f7cc0d4157eaf5f70bb5f1c91ab30a1',
         "gray": 'a81b4f260a2f4b58c2bb40ceb8889a6a4786bb5a054e1560c8a10066c4382fa3'}),
    "deferred clear": (
        "R0lGODlhlgCWAPEAAAKYwDm2T9qI+lGrdSwAAAAAlgCWAAAC/9QwMQJhAZUQAQHAlrtpeOpMF5VAx9WgHaVSJIeE"
        "R9VdFePITyNqiDEz/GQhRMJYxJAYRhsPoqTFGsfKr3TwRGyMieJkYEFzGM6CpcVoccAbbCKSVF0PiaUJmSyc2bxT"
        "yAay8GHXJdYgNUY0gzTmoXbgJYJR4dZl5MURJgJSxqIWt1ECktMnGcLkMFhJqXBDAxeWxxSjYPZ4NGV0VhLl42J7"
        "Mxhp20TasZrxQ5eg90N1Wpmx45WWNZhhZZYprXHksYfbLMo54npG9zAzOruBwtLzNZStrMepCsl8hQT4PTQ+gg+O"
        "NWP0BHtn4lkQRsLkrHiY6kEdExKzVSLDo1mYPf8kwMUig4wiEzRWGKUYRgmRlUuxRnJBpunLBhfXEJa5VkKOsgi8"
        "nkCzcM2Eq0YRJQiNNDJPBG1A4CAUM6MYCSu2XDih4Y4SODmu6gxRtaGSFlZAfGhdamElJD8funwjc0npI09dSwmJ"
        "8HFspD0BVUFVkiGXYJca4GBZUWvL0oSdfJm80fSFKz/P4H350AIoVlBBuOSwutLbllSQUqSFU8gtlWbgailUAfgi"
        "uhjiLlL5wxOaLIxuUWuEKMNczlPHUmR6cUWxVaDYqgFS2kkPrk5QlGFCNs5QyXAahJmZTLsqFGhkeUr0KCRFeb6e"
        "UIQQKo9WmJS8cIzfwUF22t9FMMr/UaMKe0A1FYw9qEhh2lyglKFVD+u4l5Flw6nHyBmwlfIGDzhUZt8jOqFXTYD5"
        "YNZcFzItVccw5yDlRl2s7UHOhh76Mxd2OWHBUxZlHEQHWavtMAgiGrX0CkWUiRUZUKb55JQ9dNxB1X2zCCKKGqZt"
        "qMwJ6AT3yghpQAGOheIBosQyP2KXzpQqyShLcsVU8aY8DulT2G0S1hNYH3CykQU3+e0IoFyarNKdXWOlZKA3zMGQ"
        "1ldVdLdOQxIENl9Zv+1X3Rpg2FHfEsuUZFQudwjxiCSemeOOarX0aWccKfFQJh4dzQWEMWOMkCI0YT6jQiJUSQcW"
        "fOr1OlVCJyBSK4y3/2G1wkU9IBKDQaxB5tUXtTKB2EzYaKbNONJseJBW4qin3RZv0BPtjbGsAWCYF+XRnaufCENd"
        "VDU4eRays1FVai+1ylTWFU55CK1HexFCk7XLmNjuTTaEY6SzWxwsyV4Sz/UeoQWF2GgnYLyhg32TtgSMEkeokwM+"
        "0Ya1yzyQnkqflpL8SwVYuIoHQ4XITOWLNpPC9MEagdXc7MGsPdxkel76bFqVUy20LsrFgjmaX1ty9JR0UdFLRGnn"
        "zIxrDbRh89DH7S5xhkyvIvFODd5uQpMXn+k4TYdbp52qDtvwhbIpmNmAYn9jGWWUlyrs3Ngrna4zx31LqHOXgeoI"
        "Zlx7N/8/+zht+TXVqzSTGftZRhpydLKnsgxuXxsPV6USZE60YsmAcmtJ0Hb9vEuJ1hjhylIwSWRICNltKu2giaAZ"
        "4pWWJjNWSIGXWdlca7lwnjvhhZ6OAiQ67qi1ibL1qEn2kUApEVaZtNuMLj54YyHGsI40lldnz0QDNrCY5eWxQy9X"
        "BzxpFdgKwD2IbSCAClKM46/LAIIU1gqSOKoBJ9rNSCrnkQIxxnc8HZgPC9lLlay2AblN+C4KdmjHeNpTKA4apCsa"
        "olKzMpUeZ4CJQTfbSjUq85J08aUtgHuPO6rUpQ6YwBvSISHKfIKsWSArgJsIB/l6A66JBXBbJPzMmz4RBU7/9Klb"
        "C/pFhX6SQV5wsIfS09fphAaGC8Kjb5FTHWAwIRZ2GdA3QWpC0fABEsNhkYfKM8ckTBamu2ylL4WhyOs4RSoEEqNF"
        "rGDKblhVnStKAxQbgRV0GBgHZ/wpJye6ggOXZAFSvKQ2McyXbt5XJid+Bku/KpM9trURsKDmW68rICc7M8kglQsN"
        "k3BGXIxkmDSkshxrEwqWMtM+m9msCnBkhaZy1Mj0RQt2BcQElCyXs4G5pEHa+4aKqDWsJrSCI05xiF5EBz9W1SZo"
        "qBCkMn/WSCB6gi+iCBBFDFY3P06ThuOzU5hG4ZQn8C0UsCnHgUjSpVcQz0Ji8Et1Znmy0Fjw/301GVBmEgJIuKxG"
        "PwrjxmVwQcntwfAFPQoYNW5CtmIsxl9PwNYfKlOIPtRvOHLaEU9K8R5ssQcx1rGSJksXtJq9QwyWOiV4zjEUxRVG"
        "huTYC0lHFwW2ncAoEcFkC+WiEUcMS09IeIutBBGPqQwEejUbzy/sIzCVhDId/EhbnYIVSpC0CWv2ehopKGU9YrQU"
        "nK4rI0oWxRJvJgh1fjGMkOzJso70cDLEbOLDDjeq6IwPb4zVnRta2jN53ItwruFdHOOasDUGyjuF0eXiDDO31oRN"
        "NbsqCUpDwp+YKYQNUY1YVbHIyyx571Dpg1cumOLZgZQKGEvY4DACyRR/PQlrd/8BmIi21RXG3TV9zVUQg8zysVzm"
        "amve45wPwrISbKFtWb0Q4IlCdZMiwggq86Eu/yI3hWyYgzkw8UsrLDOJfZ0kKOmhlZU86aWKtEsYvRjiWWv5npol"
        "aSuF2kZbMZGlkvQDOamAF1VLlxhSyYJPUnjODH9pC3qerIO8uhYa4MQ2m2RkW+w6mc78ucR0GbZYk4XQ9taXttBK"
        "RketWaCIdmESpCyEVvhTEXK7AppjUas7EWKcQwCEL2kuxorIot5BCDFlvSxVemDoEO9W4dorc+eygporZMTSVY2s"
        "JRgG04p6qKbat5iLdLgL0bHuAOWKCdOBULSvO7wVjjYIsYjH4A3/B2Ua1N1UJ4nsRWhYlHW6jE3poYLoLY1owR3h"
        "ToFli9Tfs6gyIFiIJbxBaZCOEOSbR+cJBomAG4mO2bRkuAUvjNLcdzbLhVj6VBv7GOtPfKfAJ+TGRVwRG2gPtgtj"
        "3QNY4jpJpmQjj/g2ZR2FvlIvXJy6INTPlkJUW/9uMVVgvKtPuTXIhncMGJLwAhUXZB865HOv/wZLvNRK2FXA1dxl"
        "8E2oRTlHfnIS0k3o0XzVq5OgC2hua3KELTJgyFIvl73bBOTUB54WpGqgmMQIczXrLZQF6xdejK6PYWlcoVOhhWkW"
        "3Wog9xRSukRhCvDEBscpYyxiQxwiy6ikT21hiThD/2RWhVUZ5bSTK0Nf7rDgTKNt9Kto4e7r2SgpCjqHIdMkFj0w"
        "fskMYv1CCxZe8CiD0ObgEZfKZaqi6xkKxsVrpR/RTA2dVhFEURBWemsaqHKEq3OrCTJv/WpBVLm1iTHsHc1vl5lJ"
        "i3LvUwCibyNCYy9YiW56TQvQKd4SqUV0SJ6fcuiwqiufevDrZve88l12hAsrTsQ53PthIlV2P73kCLZKHtXh9ApE"
        "lY9zL5uOHCsMN9ytwDnHTOqIjIZSI+PUk1iVmwkDHW7h9eYGYfDqPFFrWVSAvegSbYGYI1dnb0MRcwrWXbfbBdGo"
        "+qwsyQS0hCbzTIv//YdPGRl39Gul/P+Z5IOSnErvHdzlHUAmLblzRg7zQMkyIw/DSd9SRlWxKc5nG+82Q0oyL0pB"
        "dKVhDagAeP6BQAQkHZIROidiQ7yHVkwTNnWUX+LUPMASNNeAWtynLWIWXRFiLkchM9kEC8thRjCnROWUUoewG10V"
        "cZl0KxriGaAmXI/UFqCSEllREVOCHQnWYrnTeQh0euSHGm0jWPiwA03VNgEBSP/UT+7hI5bECdzXSxa0EU0yauqH"
        "Kvi1Ez/zDPeBKytmJ6HhR3bBb89FOisTVfyQSXXUhBSSSQ3lZwCBNNqyOmblHNSAQWkTcTp0JajiHl0ocAxWehPn"
        "Q7dBTvkzTXBhgQYTR6X/VQScMykQdi+VJEawIWR3MlJYARJOhm6BQiD/BGzwkD5k40np9HdgcjR96Ed3RoS9I16N"
        "0g4gxWpMFh2p9mpfkYWKYHkQAkFRYw+vkgRO4134ZygRxUImMxCFtoam0ywsiBxJVCIKWH+7YSpn+EawsXucyIQs"
        "9BF1EQ8Mwm674mYpU4htpVDXCHLM1jJUImHhCHYqJnhdMh+JMQ8xMlrtMRFdYicm839cOA3OAm9c9VmJoDmpUBOq"
        "5ETZQF3FMFQfU5HG6HZrYYWXFXwnYUtNAmbQgmQVuHrfiGEnlDIo+RJLwRryYTW0SGDRJmX1Mj5Phxc8ExWpZHvf"
        "KCNCg1ZX/whk+8AshcRrz2MVp9Z4oyZLwIBxTkVwu3IcXKAbJyRSl0UhYehLihBQWYRcKwYZ1CZIe0KMpTJF1tQt"
        "3iR9byRnbEIgDFMkeMmUEzcELRUkWCc3NLhALQAWJHILr0SCtOQHarhwXxNf6+ZiZag72KJEO6eP9BF/1sEnxzEL"
        "AFFAsId2n+IhJaQFpWYcYKUkg9lAwpElnLhG/kUGCtN9SGUV4oUUM2N0UZlfEPQmLIl32qcO89R1Z2ct4GGK9iNx"
        "CIGabAAwS+JUQcBA+fOB2lNN3TIN7yZALukpQhWcwieNwyF6IAh8H7UixjMzERQqW3R3ngA3suFEMeOCA0WeXf9W"
        "nREldlTjUlUGL09jQv1nhFv0Dzd4m7HCPwJRXA5FLZ9zXduTha2zCi53f8QVFvBTTkP1ShxHTgChf9ZgQ5i2ne8A"
        "R040JFdnQ2BZCBQScg2TRRskQlrEhoy1k6FkP4MpREb0mb9BVB6hEAUCFT4Umd+1gejnE0I6B59iCCKmbSRqMRVG"
        "b55yI40gbOQRNCS1m4PRGe+mV4bpEbDYpWM4K4jBIAu2RR8hds62OYYhQ7roDwG5aEuIPLn2BtmxKXJ2ac8BJMZw"
        "mlfXDljUVHKRKhEhTP4GhtmhnUeiOhoWS1nYEqWySoiZUyexMr51QIE3dqIkYeY4ON13KYMSpFP/ZTBPmhzBo4c2"
        "KjozdQ+XozWdKjJYyWupMzfRViB352tEU5sbQTeJMqsqc5dZoSAicV2taSoEWEKJxKqB4QZ4g5LEhRlJJTuq9STQ"
        "Q3mzNDnbRVtM5jj5AV7yVDTX5EBWA17hASP0dBSxlIv4ZwzZ8y+/hxcWpiSrwo4KwWUt4iHfOE0k9a5IYmOf86Xe"
        "WCmLViajl52+5GIfU2AvN2/Kqntcg2mEB2p4xEnk12P65qQ0kqPbFpEIEWjQYgYZIrGYyW7XSBo7GRpL5zOptz4J"
        "8WhRkUgUtjSEkQab53Qg+0zpRh73RRNRxaaMATj44av0eC0oNW1qZBax15w7h6Eu/zebdZWcDUUo5RpQPVgQ8ch0"
        "A6qT8YdNDARexkOUooZq/ylEv1q1AyuZG7I5IMVnHBcKSMag1GEpHBQgmMEN1uV2AIWvHpeYPxIIA3Vih0ONqWkI"
        "nGkr+gKhqXSUozIKlEpCC/FouDmEDRI3v6erfVNgYvSYyqo2dYgXckqJ88lhlbinallqBal/8AmRLpdRdtAoZyNx"
        "PUETRPYcSzOWgBMheaKeqbQZ+3IY5yo210JdepKhcuGoYkcM64m8hNAx+oJI4OZNzyOkMZGt1UNmfQeiKEJ6EklZ"
        "3VaH5loxM5UbFcau7jI5PzQKKkJ+gHJTY2K+IIkSo7GOOPGEGeYsaP8imgyGemUhLNeKsRLIjF+HfOvmvtYKIcJB"
        "MDLDhKgBdolUOrTEcv3kPfToOq8TQFQHVOPRi8EVgZfLGSwzqYtZihkaULTwWTiqJenJcyAIiipUlG4mNIkFEjyC"
        "jTn0P1v2s8vkSuBrNkX1IlUWB4FUMfcgUeB2GmczK6EoMv8VPqYoFFYKNOQ6RNthUQTyIXUrJ++yfOW1V39GdNW3"
        "mZPLffAJQWUFChljhB3EKd2mJjXCEKdnItTGc/fyIiP3FQSLuZv2EsMDMtZSLOKmjEqZiOzSeHg2HynDpbQDLA33"
        "UVBaEDuEIWApKzXhOYDCK/t7CfGlbyE2RhSnSOIbUQb/qFyj5rGNVC1ABh8QBTsZcwhohFiDxVz2RcLn4zG+ZCb2"
        "lTtd9kP/EZnplheeiDGxQLvk9lvzIrWWJj4wIaErNHbdgFAlu4TxIcSQrFrR8i9uIbh95KNHZWxzNxleOYOiMzpN"
        "lA4M9ZUA2H32OKq+gohug1wp8sP+RMXZ0U0To6kYiB4FhyVjFUmMq8lYNjuTIpIDAnALt14W+iOrqSjnk0TKd2db"
        "oxNQdiapJ26vpJUzOzEAxE6UC9EeK2VKBikaFF9yuHT6Q5YaOGhHw2ahIFnpgQ9us2LH46xf2HJw0VwuIWrO4Q/H"
        "IHA2erq78CxB8TZS9gfulpDtqAlLqkWP/zs0oYIgA9tGI7NIc6hYNDlUiGI7iwR2w1UahJbHsod6vVYE24esvcTG"
        "AjVLzKFpOjkyikHQMDJDMahWwWMgocMIadoHtivH3JqmympJ4UbCO0klPVBVOIU0xBXGHsWoTaYLLIcz5dM6cAN8"
        "XKnSIWRFYrl07QqpiBvTQ+GNFdUbGLea7HdAuuCL5ViDGMXHc9aTOTgoCKQ3IqlmEsEr4SQi9fBmcPPXYV21RKCu"
        "N8ki1GSEqxfJZh08K5CEOtkyB7Rt0PEfeL0YHQxVbv2sk6RvPefHUWIeISRGvFlYrxsrKaUt8edvQsM9MjIoPBS3"
        "p6hL+pvIVJUEaCsSzPRDAv+EHk+2SuEFeKlJzm3QUWrhHvrTF6AxYKa3mmiWYoH3ntEWETk7FOdxVslwasVZSUxH"
        "GjIxzRbF25gZordQc7vJf+fTcOyjHDEammTEkcJJX6ktJ/TXN1pHSe+syYW8pOxKjeqDu9c2sPyVkPaEn5xzV0Is"
        "ajZlRih5GBJZm1FMDmwjKD1ROQZY2WIitoF2Nwv4R2qDMKtyaoaHi0UYh+QiMLDnauviz4mSQtMCi1tMqchqyMTW"
        "DdaZvbQGkf+ZLAQWEhZ2iUdTkUuIeg1nIBDNWe3UfeXTHP+QryUnPiH9i3y8lPny0Q+5YZX4J625rOUUgC4+JK8Z"
        "nPs33iilLev/ReNMFbtjs9SybB6OcHe0kgnJhyMseGHfIVXT2YQBC+d60hnrAiW9xYk4MkSrgzDW7KI+CJQP9CiW"
        "h3xMUcX67SrAxauG9OeiggYgC2HQ86Gl6EE4TbvMEg3Kg9I891pCcku/Amj+uxl0oZkMpiDxsJORomYa9Asu7Hkx"
        "oQMYFMQsGhBrdEKVNqzGBMxDR4Xh9k1rrhr/SBTOwGMouyvs3MeLcXoH0VGmcBqbCrzg7nCoxbokyt5I9A3MUCRI"
        "OG4j9sRnCHBYQiKUob+F7RluNSMJg6gIr3Q+g3bMQ28Nl16kKU2tw9mEHd9KkWD2xSKLe+bh9ro8oiy9vibG44lJ"
        "/7hwTdjUGXZdgwtc8V05W6QYP1k++kgqgfRaqXkd4kjNSZxLTZ45wsGzrI2e/G2tdMMPIMdpJKzzKIfWYfPdOm8s"
        "B+0ZzxeLss2wIGmFBP8rYBIPrCNfvP0V1lQWkhFMBQk+CmZMheUHqjG5qcu67iKXvpXirh1YMQY6qzUhuCvY3YrQ"
        "5wFau/7PcYRkkOibltvE6Vka4RFgn5iiYUYz+bOs3AF4ie1MIpSiGXaauZZ5m4dCSFyItd749Bxgv8is5eqjZWXR"
        "mqI5WbnexziQIKYyvrFE5bVKDtLaC24hAPtjX2ObBXNrmOms5bBj+o1se6b1cJ+aLaxGO0Ge0ubf0/80VdvGDOdr"
        "L1LSQUODWYZcjcTUlv9Zpt6FEmiKZHU3uDvrx8Rxy4M0s4RcIwjXBqmuflS2T6ARmi3S9PjW5JnSgg+iiFpV0688"
        "ewCuOrZxiVrDkt99uzFzCEvsOdIEnUL1oLZac4l5D6gu5RMBxwCNhX/UilQIr0sl3lGpFvWtV7xnJoOpaGynYd74"
        "UP+jNGR8TQQ1XxyiYAyu/zG5QzAZYvVnXMXSNlr52K6khWuCyX4Nd0pPJuo3HfABKuqGNc50ILpAzZxLs9U5e+61"
        "21qGFrh4Vzx9IKLxkseCS1Upka/XqQ1BzfvMY8/a+3gOhtVItDyOHFz3u+b2dTY1gaH/0G615YBZSgQjk1sIfaf4"
        "q8Azm4x7pIHFSPK+GCtm22/JDxfUxyoDamJDUxv0DB72G5amAsGLSl/6WWtN7C9aFmIdVqr8gnf0pJSh+V0ytCjb"
        "r1YhVu9WGRdDtjP/liMuiUSV1A//tKe+9AkCnHqQdcV1yhZJtyI4oVHtGhkgcoCihPcPQm6mJkMLdPW81Tp7VaX7"
        "Oc4K/q6z4jIaIoX/tPoqhU7dTLeeNOLtQEC3HDajsVGMCYWxq0JsjN0Ftm2l9YQXtKy393hipdbMtrLtbuTfrETJ"
        "BNCcmGxAeahVLW/VV4KodDicfdduRR4G24I386ONr7PG+098+WY8nWcP/yUkkIO3zkVxo/mxP5avHOdsb8yL+Fvb"
        "UPZR3neU+TXpUin3mxUncqm69qiRyDEhcf3vs1GVSSh5Rk8f4PcPXFhwej2X8SLVgrYwstrS071KODE9meuTkjTO"
        "DWTnDjuHQ4ZUR7Em7voQ4lJdQARvaXzcHiw3GiiTDLg6n7igPLnqSEVGbZ7qgHKb/fMlQGg+BZtQ4G6tczZji91o"
        "k3Ri9vT5Q6RuO4eT9KqKAAreUS2366O4L37ZpKKPlfU3/bMIvX52rvGsAy0gvNXH/xYXwwVsbGE60KZTotFr/y3F"
        "dTlE0eHyAN2C+2mq2BuhhgSJpo+5MeSeePsiSHI+3BwKvzq9yEBnbcanSUPr7SfWEq2Cf8QVPgqiWo3U5GSROm5i"
        "R7+0LJsqtqCpwayzbzyGZz8rKjlWJ7fWngUAADs=",
        {"color": '316be13460eb8f89f9aa27e2714dd704246e8896b9d00a7eb720433e274fb3d5',
         "gray": '90d6f05d4c7ac45831217e3c2c7e642815f12ae3c8fad064f59bce65153558b1'}),
    "extensions and a second frame": (
        "R0lGODlhFwAJAPMAAAKYwDm2T9qI+lGrdfbpsLaIZ7ybZl/u1V+8jWxI09g6FX5qHsShxYerzvtBsZk4SCH/C05F"
        "VFNDQVBFMi4wAwEAAAAh/gVwcm9iZQAhAQwAAAAAAAAAAAAAAAAEdGV4dAAsAAAAABcACQAABE8QSPDqU1iVXY4/"
        "liM61sOczASgTOMOcAwjNMIVS764jeEbt4QwMXKwVJMSr5FRfA6/J2FKEFiv1mECpVtQCbIvdiRTlbTf6CdMDbgD"
        "RUsEACH5BBwAAAAALAEAAQAFAAQAgAkIBwYFBAIHhBOAyrhZAAA7",
        {"color": '2845814af6f41de2fa6497ccc87b28f97f7cc0d4157eaf5f70bb5f1c91ab30a1',
         "gray": 'a81b4f260a2f4b58c2bb40ceb8889a6a4786bb5a054e1560c8a10066c4382fa3'}),
    "sub-blocks of 7 bytes": (
        "R0lGODlhFwAJAPMAAAKYwDm2T9qI+lGrdfbpsLaIZ7ybZl/u1V+8jWxI09g6FX5qHsShxYerzvtBsZk4SCwAAAAA"
        "FwAJAAAEBxBI8OpTWJUHXY4/liM61gfDnMwEoEzjBw5wDCM0whUHS764jeEbtweEMDFysFSTBxKvkVF8Dr8HJ2FK"
        "EFiv1gdhAqVbUAmyBy92JFOVtN8H6CdMDbgDRQJLBAA7",
        {"color": '2845814af6f41de2fa6497ccc87b28f97f7cc0d4157eaf5f70bb5f1c91ab30a1',
         "gray": 'a81b4f260a2f4b58c2bb40ceb8889a6a4786bb5a054e1560c8a10066c4382fa3'}),
    "a string past the frame": (
        "R0lGODlhAwABAPMAAAKYwDm2T9qI+lGrdfbpsLaIZ7ybZl/u1V+8jWxI09g6FX5qHsShxYerzvtBsZk4SCwAAAAA"
        "AwABAAACBDAIGQEAOw==",
        {"color": None, "gray": None}),
    "a code past the table": (
        "R0lGODlhAwABAPMAAAKYwDm2T9qI+lGrdfbpsLaIZ7ybZl/u1V+8jWxI09g6FX5qHsShxYerzvtBsZk4SCwAAAAA"
        "AwABAAACBDBMEQEAOw==",
        {"color": None, "gray": None}),
    "no trailer": (
        "R0lGODlhFwAJAPMAAAKYwDm2T9qI+lGrdfbpsLaIZ7ybZl/u1V+8jWxI09g6FX5qHsShxYerzvtBsZk4SCwAAAAA"
        "FwAJAAAETxBI8OpTWJVdjj+WIzrWw5zMBKBM4w5wDCM0whVLvriN4Ru3hDAxcrBUkxKvkVF8Dr8nYUoQWK/WYQKl"
        "W1AJsi92JFOVtN/oJ0wNuANFSwQA",
        {"color": None, "gray": None}),
    "disposal method 4": (
        "R0lGODlhFwAJAPMAAAKYwDm2T9qI+lGrdfbpsLaIZ7ybZl/u1V+8jWxI09g6FX5qHsShxYerzvtBsZk4SCH5BBAA"
        "AAAALAAAAAAXAAkAAARPEEjw6lNYlV2OP5YjOtbDnMwEoEzjDnAMIzTCFUu+uI3hG7eEMDFysFSTEq+RUXwOvydh"
        "ShBYr9ZhAqVbUAmyL3YkU5W03+gnTA24A0VLBAA7",
        {"color": None, "gray": None}),
    "background index past the palette": (
        "R0lGODlhFwAJAPIIAAKYwDm2T9qI+lGrdfbpsLaIZ7ybZl/u1SwAAAAAFwAJAAAETxBI8OpTWJVdjj+WIzrWw5zM"
        "BKBM4w5wDCM0whVLvriN4Ru3hDAxcrBUkxKvkVF8Dr8nYUoQWK/WYQKlW1AJsi92JFOVtN/oJ0wNuANFSwQAOw==",
        {"color": None, "gray": None}),
    "an application extension's 3-byte sub-block": (
        "R0lGODlhFwAJAPMAAAKYwDm2T9qI+lGrdfbpsLaIZ7ybZl/u1V+8jWxI09g6FX5qHsShxYerzvtBsZk4SCH/C1hN"
        "UCBEYXRhWE1QAwEAAAAsAAAAABcACQAABE8QSPDqU1iVXY4/liM61sOczASgTOMOcAwjNMIVS764jeEbt4QwMXKw"
        "VJMSr5FRfA6/J2FKEFiv1mECpVtQCbIvdiRTlbTf6CdMDbgDRUsEADs=",
        {"color": None, "gray": None}),
}

# phase 16 (f): the full-size files of frames GRAY_VARIANT_FRAME (8-bit
# BMP with a gray palette, P5, 8-bit Sun raster with an equal map) and
# RGB_VARIANT_FRAME (24-bit BMP) that the render workers write, timed on one
# thread; phase 16 (g): a joint_mvs run on the first MASK_FRAMES frames of
# phase 6's dataset with a tripod-style mask as a PNG and as an RLE8 BMP
# named mask.png, and without one
RASTER_VARIANTS = {"gray": ("bmp8.bmp", "p5.pgm", "sun8.ras"), "rgb": ("bmp24.bmp",)}
MASK_FRAMES = 4
# phase 16 (h): the same two frames as TIFF files (LZW with the predictor in
# strips of 16 rows, Deflate in 256 x 256 tiles, 16-bit v * 257 samples
# big-endian with Deflate and the predictor in strips of 32 rows), and the
# tripod mask of (g) as an LZW file in 128 x 128 tiles named mask.tif
TIFF_VARIANTS = {
    "lzw_predictor.tif": {"compression": 5, "predictor": 2, "rows_per_strip": 16},
    "deflate_tiles.tif": {"compression": 8, "tile": (256, 256), "level": 1},
    "16bit_deflate.tif": {"compression": 8, "predictor": 2, "rows_per_strip": 32,
                          "big_endian": True, "level": 1},
}
MASK_TIFF = {"compression": 5, "tile": (128, 128)}
# phase 16 (i): frame GRAY_VARIANT_FRAME's gray plane thresholded to bilevel
# (black below BILEVEL_THRESHOLD) as a PNG of 0 / 255 and as 1-bit
# MinIsWhite TIFFs, CCITT Group 4 in one strip and Group 3 2-D (every
# FAX_K-th row 1-D, fill bits) in strips of 64 rows; frame
# RGB_VARIANT_FRAME's own baseline JPEG as a single-strip JPEG-in-TIFF (its
# tables in JPEGTables) and the frame as a YCbCr 2x2 JPEG-in-TIFF in 256 x
# 256 tiles; the tripod mask of (g) as a Group 4 TIFF named mask.tif
BILEVEL_THRESHOLD, FAX_K = 128, 4
FAX_VARIANTS = {"bilevel_g4.tif": {"compression": 4},
                "bilevel_g3_2d.tif": {"compression": 3, "rows_per_strip": 64,
                                      "fax": (FAX_K, True, True)}}
JPEG_TIFF_TILE = (256, 256)
# phase 16 (j): frame GRAY_VARIANT_FRAME's gray plane as 8-bit GIFs through
# the identity gray palette, one plain (a clear code whenever the LZW table
# is full) and one interlaced with a deferred clear (the table stops
# growing when full), and frame RGB_VARIANT_FRAME quantised to the 3-3-2
# palette (image_forge.gif_332); the tripod mask of (g) as a GIF with a
# 2-entry palette named mask.gif
GIF_VARIANTS = {"gray_plain.gif": {}, "gray_interlaced.gif": {"interlace": True, "deferred": True}}
GIF_332 = "rgb_332.gif"

# the MVS frames re-coded as progressive files from the coefficients that
# their baseline files carry (phase 16 (b)) and as arithmetic-coded ones
# (phase 16 (d): even frames sequential with restarts every ARITH_RESTART
# MCUs, odd frames libjpeg's simple progression); the frame whose gray PNG
# and the frame whose RGB array are re-written as PNG variants (phase 16
# (c)); the frame whose gray plane is also a lossless JPEG (phase 16 (e):
# predictor 6, a restart interval of as many whole rows as fit 65535 MCUs)
PROGRESSIVE_FRAMES = 4
ARITH_RESTART = 90
GRAY_VARIANT_FRAME, RGB_VARIANT_FRAME = 4, 5
LOSSLESS_FRAME, LOSSLESS_PREDICTOR = GRAY_VARIANT_FRAME, 6
PNG_VARIANTS = {"paeth": {"filters": 4}, "adam7": {"interlace": True}, "16bit": {}}


def write_format_variants(root: str, i: int, rgb):
    """Render worker: frame i's extra files for phase 16: a progressive
    re-coding (image_forge.spectral_script: DC successive approximation,
    spectral selection) and an arithmetic-coded one (sequential or simple
    progression) of the coefficients of its baseline JPEG, or its gray
    plane / RGB array as Paeth-filtered, Adam7 and 16-bit (v * 257) PNGs
    beside an 8-bit filter-0 RGB PNG, as BMP, PGM and Sun raster files and
    as TIFF files (TIFF_VARIANTS), its gray plane as a lossless JPEG, the
    bilevel and JPEG-in-TIFF files of phase 16 (i) and the GIF files of
    phase 16 (j)."""
    import numpy as np
    import image_forge as forge
    if i < PROGRESSIVE_FRAMES:
        comps, q, w, h = forge.port_components(rgb, 95)
        with open(os.path.join(root, "progressive", f"{i:06d}.jpg"), "wb") as f:
            f.write(forge.jpeg_bytes(comps, w, h, q, forge.spectral_script(3)))
        seq = i % 2 == 0
        with open(os.path.join(root, "arithmetic", f"{i:06d}.jpg"), "wb") as f:
            f.write(forge.jpeg_bytes(comps, w, h, q, [("seq", [0, 1, 2])] if seq else
                                     forge.SIMPLE_PROGRESSION_3,
                                     restart=ARITH_RESTART if seq else 0, arithmetic=True))
    if i == LOSSLESS_FRAME:
        plane = np.ascontiguousarray(rgb[..., 0])
        h, w = plane.shape
        with open(os.path.join(root, "lossless", f"{i:06d}.jpg"), "wb") as f:
            f.write(forge.lossless_bytes([plane], w, h, predictor=LOSSLESS_PREDICTOR,
                                         restart=(65535 // w) * w))
    var = os.path.join(root, "png_variants")
    if i == GRAY_VARIANT_FRAME:   # phase 16 (i): the bilevel files
        black = rgb[..., 0] < BILEVEL_THRESHOLD
        with open(os.path.join(var, "bilevel.png"), "wb") as f:
            f.write(forge.png_bytes(np.where(black, 0, 255).astype(np.uint8), 0, 8, level=1))
        for name, kw in FAX_VARIANTS.items():
            with open(os.path.join(var, name), "wb") as f:
                f.write(forge.tiff_bytes(black.astype(np.uint8), 0, 1, **kw))
    if i == GRAY_VARIANT_FRAME:   # phase 16 (j): the gray GIFs
        gray_ramp = np.repeat(np.arange(256)[:, None], 3, axis=1)
        for name, kw in GIF_VARIANTS.items():
            with open(os.path.join(var, name), "wb") as f:
                f.write(forge.gif_bytes(rgb[..., 0], gray_ramp, **kw))
    if i == RGB_VARIANT_FRAME:    # phase 16 (j): the 3-3-2 GIF
        with open(os.path.join(var, GIF_332), "wb") as f:
            f.write(forge.gif_bytes(*forge.gif_332(rgb)))
    if i == RGB_VARIANT_FRAME:    # phase 16 (i): the JPEG-in-TIFF files
        with open(os.path.join(root, "color", f"{i:06d}.jpg"), "rb") as f:
            jpg = f.read()
        with open(os.path.join(var, "jpeg_strip.tif"), "wb") as f:
            f.write(forge.jpeg_as_tiff(jpg))
        with open(os.path.join(var, "jpeg_tiles.tif"), "wb") as f:
            f.write(forge.jpeg_tiff_tiles(rgb, JPEG_TIFF_TILE)[0])
    for frame, kind, img in ((GRAY_VARIANT_FRAME, "gray", None), (RGB_VARIANT_FRAME, "rgb", rgb)):
        if i != frame:
            continue
        img = np.ascontiguousarray(rgb[..., 0]) if img is None else img
        ramp = np.repeat(np.arange(256)[:, None], 3, axis=1)   # a gray palette / map
        raster = {"bmp8.bmp": lambda: forge.bmp_bytes(img, 8, ramp),
                  "p5.pgm": lambda: forge.pnm_bytes(img, 5),
                  "sun8.ras": lambda: forge.sun_bytes(img, 8, 1, ramp),
                  "bmp24.bmp": lambda: forge.bmp_bytes(img, 24)}
        for name in RASTER_VARIANTS[kind]:
            with open(os.path.join(root, "png_variants", f"{kind}_{name}"), "wb") as f:
                f.write(raster[name]())
        for name, kw in TIFF_VARIANTS.items():
            deep = name.startswith("16bit")
            with open(os.path.join(root, "png_variants", f"{kind}_{name}"), "wb") as f:
                f.write(forge.tiff_bytes(img.astype(np.uint16) * 257 if deep else img,
                                         1 if img.ndim == 2 else 2, 16 if deep else 8, **kw))
        ctype = 0 if img.ndim == 2 else 2
        out = os.path.join(root, "png_variants", kind)
        if ctype == 2:
            with open(f"{out}_filter0.png", "wb") as f:
                f.write(forge.png_bytes(img, 2, 8, filters=0, level=1))
        for name, kw in PNG_VARIANTS.items():
            deep = name == "16bit"
            with open(f"{out}_{name}.png", "wb") as f:
                f.write(forge.png_bytes(img.astype(np.uint16) * 257 if deep else img, ctype,
                                        16 if deep else 8, level=1, **kw))


def check_format_probes(names=None):
    """Phase 16 (a): the port's decoders on this machine give cv2's digests
    on every embedded probe, in colour and in gray, and refuse the reads
    cv2 gives no image for."""
    import base64
    import hashlib
    from panovlm_tpu_torch.native import jpeg as native_jpeg
    from panovlm_tpu_torch.native import png as native_png
    def digest(decode, data, color):
        try:
            return hashlib.sha256(decode(data, color).tobytes()).hexdigest()
        except native_jpeg.Cv2Refuses:   # a read cv2 gives no image for
            return None

    for name in names or FORMAT_PROBES:
        b64, ext, want = FORMAT_PROBES[name]
        data = base64.b64decode(b64)
        decode = native_png.decode if ext == ".png" else native_jpeg.decode
        got = {kind: digest(decode, data, kind == "color") for kind in ("color", "gray")}
        log(f"format probe {name}: {'cv2 bits' if got == want else f'DIFFERS {got}'}")
        if got != want:
            fail(f"the decoder built here does not give cv2's bits on the {name} probe")


def check_raster_probes(names=None):
    """Phase 16 (f): the port's BMP, PxM / PAM / PFM and Sun raster
    decoders on this machine give cv2's digests on every embedded probe,
    in colour and in gray, and refuse the reads cv2 gives no image for."""
    import base64
    import hashlib
    from panovlm_tpu_torch.io import images
    from panovlm_tpu_torch.native import Cv2Refuses, bmp, pxm, sunras

    for name in names or RASTER_PROBES:
        b64, want = RASTER_PROBES[name]
        data = base64.b64decode(b64)
        decoder = {"BMP": bmp, "Sun raster": sunras}.get(images.image_format(data[:64]), pxm)
        got = {}
        for kind in ("color", "gray"):
            try:
                got[kind] = hashlib.sha256(decoder.decode(data, kind == "color")
                                           .tobytes()).hexdigest()
            except (Cv2Refuses, ValueError):   # a read cv2 gives no image for
                got[kind] = None
        log(f"raster probe {name}: {'cv2 bits' if got == want else f'DIFFERS {got}'}")
        if got != want:
            fail(f"the decoder built here does not give cv2's bits on the {name} probe")


def check_tiff_probes(names=None):
    """Phase 16 (h): the port's TIFF decoder on this machine gives cv2's
    digests on every embedded probe, in colour and in gray, refuses the
    reads cv2 gives no image for, and names ROADMAP.md for the queued
    codec."""
    import base64
    import hashlib
    from panovlm_tpu_torch.native import Cv2Refuses, tiff

    for name in names or TIFF_PROBES:
        b64, want = TIFF_PROBES[name]
        data = base64.b64decode(b64)
        got = {}
        for kind in ("color", "gray"):
            try:
                got[kind] = hashlib.sha256(tiff.decode(data, kind == "color")
                                           .tobytes()).hexdigest()
            except Cv2Refuses:   # a read cv2 gives no image for
                got[kind] = None
            except NotImplementedError as e:
                got[kind] = "queued" if "ROADMAP" in str(e) else str(e)
        log(f"TIFF probe {name}: {'cv2 bits' if got == want else f'DIFFERS {got}'}")
        if got != want:
            fail(f"the TIFF decoder built here does not give cv2's bits on the {name} probe")


def check_gif_probes(names=None):
    """Phase 16 (j): the port's GIF decoder on this machine gives cv2's
    digests on every embedded probe, in colour and in gray, and refuses the
    reads cv2 gives no image for."""
    import base64
    import hashlib
    from panovlm_tpu_torch.native import Cv2Refuses, gif

    for name in names or GIF_PROBES:
        b64, want = GIF_PROBES[name]
        data = base64.b64decode(b64)
        got = {}
        for kind in ("color", "gray"):
            try:
                got[kind] = hashlib.sha256(gif.decode(data, kind == "color").tobytes()).hexdigest()
            except (Cv2Refuses, ValueError):   # a read cv2 gives no image for
                got[kind] = None
        log(f"GIF probe {name}: {'cv2 bits' if got == want else f'DIFFERS {got}'}")
        if got != want:
            fail(f"the GIF decoder built here does not give cv2's bits on the {name} probe")


def _one_thread_ms(read, path, color, reps: int = 2):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        img = read(path, color)
        best = min(best, time.perf_counter() - t0)
    return img, best * 1000


def _recoded_frames(torch, root: str, kind: str, base: dict, phase11_pcd: bytes, device):
    """The re-coded colour frames in root/kind load with the bits of their
    baseline files (base: colour flag -> (images, names)) in both reads,
    and the colorize stage on phase 11's frames with them in place writes
    phase 11's colorized_map.pcd. Returns their number."""
    import shutil
    import numpy as np
    from panovlm_tpu_torch.io import images
    recoded, color_dir = os.path.join(root, kind), os.path.join(root, "color")
    mixed_dir = os.path.join(root, f"color_{kind}")
    os.makedirs(mixed_dir)
    for name in sorted(os.listdir(color_dir)):
        if not name.endswith(".jpg"):
            continue
        src = os.path.join(recoded, name)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(mixed_dir, name))
        else:
            os.link(os.path.join(color_dir, name), os.path.join(mixed_dir, name))
    n = len(os.listdir(recoded))
    if n != PROGRESSIVE_FRAMES:
        fail(f"{n} {kind} frames written, {PROGRESSIVE_FRAMES} expected")
    for color in (True, False):
        a, names_a = images.load_images_u8(recoded, 0, color=color)
        b, names_b = base[color]
        same = names_a == names_b and all(np.array_equal(x, y) for x, y in zip(a, b))
        log(f"{kind} re-codings of {n} frames ({'colour' if color else 'gray'}, "
            f"{a[0].shape}): {'the baseline bits' if same else 'DIFFER'}")
        if not same:
            fail(f"a {kind} frame does not decode to its baseline file's bits")
        del a
    with open(os.path.join(root, "color_config.txt")) as f:
        text = f.read().replace(f"image_path = {root}/color", f"image_path = {mixed_dir}")
    cfg_path = os.path.join(root, f"{kind}_config.txt")
    with open(cfg_path, "w") as f:
        f.write(text)
    blob = run_colorize(torch, cfg_path, f"{n} {kind} frames", device)[0]
    log(f"colorize stage with {n} {kind} frames: colorized_map.pcd "
        f"{'bit-equal to phase 11' if blob == phase11_pcd else 'DIFFERS'}")
    if blob != phase11_pcd:
        fail(f"the colorize stage on {kind} frames differs from phase 11")
    return n


def run_formats_phase(torch, mvs_cfg_path, phase11_pcd: bytes, device: str = "cuda",
                      card: str = "no card"):
    """Phase 16: (a) the probes; (b) the progressive re-codings of the first
    PROGRESSIVE_FRAMES colour frames load with their baseline files' bits,
    and the colorize stage on the frames with those files in place writes
    phase 11's colorized_map.pcd; (d) so do their arithmetic-coded
    re-codings (sequential and progressive); (c) the full-size PNG variants
    load with the 8-bit filter-0 files' bits (the 16-bit RGB file's gray
    read: libpng converts at 16 bits, rounding, before it strips the low
    byte); (e) the lossless JPEG of a gray frame decodes to its source plane
    exactly; (f) the raster probes, and the full-size BMP, PGM and Sun
    raster files decode to their PNGs' bits; (h) so do the TIFF probes and
    the full-size TIFF files (TIFF_VARIANTS); (i) run_tiff_codecs; (j) the
    GIF probes and run_gif_files. Prints one-thread decode times
    of the full-size files beside the card line (nvidia-smi's name and power
    limit; the decoders run on the host)."""
    import numpy as np
    from panovlm_tpu_torch.io import images
    from panovlm_tpu_torch.io.jpeg import read_jpeg

    root = os.path.dirname(mvs_cfg_path)
    check_format_probes()
    check_raster_probes()
    check_tiff_probes()
    check_gif_probes()
    # (b) progressive and (d) arithmetic-coded frames, against the baseline
    # files of the same frames
    color_dir = os.path.join(root, "color")
    base_dir = os.path.join(root, "recoded_baseline")
    os.makedirs(base_dir)
    for name in sorted(os.listdir(os.path.join(root, "progressive"))):
        os.link(os.path.join(color_dir, name), os.path.join(base_dir, name))
    base = {color: images.load_images_u8(base_dir, 0, color=color) for color in (True, False)}
    for kind in ("progressive", "arithmetic"):
        _recoded_frames(torch, root, kind, base, phase11_pcd, device)
    del base
    # (e) the lossless gray frame
    lossless = os.path.join(root, "lossless", f"{LOSSLESS_FRAME:06d}.jpg")
    img, ms_lossless = _one_thread_ms(read_jpeg, lossless, False)
    plane = images.read_png(os.path.join(root, "images", f"{LOSSLESS_FRAME:06d}.png"), False)
    exact = img.shape == plane.shape and np.array_equal(img, plane)
    log(f"lossless JPEG of frame {LOSSLESS_FRAME}'s gray plane ({img.shape}, predictor "
        f"{LOSSLESS_PREDICTOR}): {'its source plane exactly' if exact else 'DIFFERS'}")
    if not exact:
        fail("the lossless frame does not decode to its source plane")
    del img, plane
    # decode times of one full-size colour frame in each coding
    times = {}
    for name, path in (("baseline", os.path.join(color_dir, "000000.jpg")),
                       ("progressive", os.path.join(root, "progressive", "000000.jpg")),
                       ("arithmetic sequential", os.path.join(root, "arithmetic", "000000.jpg")),
                       ("arithmetic progressive",
                        os.path.join(root, "arithmetic", "000001.jpg"))):
        img, ms = _one_thread_ms(read_jpeg, path, True)
        times[name] = (ms, os.path.getsize(path) / 2**20, img.shape)
        del img
    h0, w0 = times["baseline"][2][:2]
    log(f"one-thread decode ({card}; host CPU) of a {h0} x {w0} colour JPEG: " + ", ".join(
        f"{name} {ms:.1f} ms ({mib:.2f} MiB)" for name, (ms, mib, _) in times.items())
        + f"; the lossless gray frame {ms_lossless:.1f} ms "
        f"({os.path.getsize(lossless) / 2**20:.2f} MiB)")
    # (c) PNG variants
    var = os.path.join(root, "png_variants")
    refs = {"gray": os.path.join(root, "images", f"{GRAY_VARIANT_FRAME:06d}.png"),
            "rgb": os.path.join(var, "rgb_filter0.png")}
    for kind, ref_path in refs.items():
        for color in (True, False):
            ref, ms = _one_thread_ms(images.read_png, ref_path, color)
            log(f"one-thread decode of the {ref.shape} {kind} PNG, filter 0, "
                f"{'colour' if color else 'gray'} read: {ms:.1f} ms")
            for name in PNG_VARIANTS:
                path = os.path.join(var, f"{kind}_{name}.png")
                img, ms = _one_thread_ms(images.read_png, path, color)
                want = ref
                if kind == "rgb" and name == "16bit" and not color:
                    c = images.read_png(ref_path, True).astype(np.int64) * 257
                    want = (((9797 * c[..., 0] + 19234 * c[..., 1] + 3737 * c[..., 2] + 16384)
                             >> 15) >> 8).astype(np.uint8)
                same = np.array_equal(img, want)
                log(f"  {name} ({os.path.getsize(path) / 2**20:.2f} MiB): {ms:.1f} ms, "
                    f"{'the expected bits' if same else 'DIFFERS'}")
                if not same:
                    fail(f"the {kind} {name} PNG does not decode to the filter-0 file's bits")
        tmp = os.path.join(var, f"{kind}_load")
        os.makedirs(tmp)
        for name in ("paeth", "adam7"):
            os.link(os.path.join(var, f"{kind}_{name}.png"), os.path.join(tmp, f"{name}.png"))
        loaded, _ = images.load_images_u8(tmp, 0, color=kind == "rgb")
        ref = images.read_png(ref_path, kind == "rgb")
        if not all(np.array_equal(x, ref) for x in loaded):
            fail(f"load_images_u8 of the {kind} PNG variants differs from the filter-0 file")
    # (f) the same frames as BMP, PGM and Sun raster files: the gray ones
    # through a gray palette / map, so both reads give the PNG's samples
    for kind, ref_path in refs.items():
        for color in (True, False):
            ref = images.read_png(ref_path, color)
            for name in RASTER_VARIANTS[kind]:
                path = os.path.join(var, f"{kind}_{name}")
                img, ms = _one_thread_ms(images.read_image, path, color)
                want = ref
                if kind == "rgb" and not color:   # imgcodecs' gray of the BGR pixels
                    want = _gray_of_rgb(images.read_png(ref_path, True))
                same = np.array_equal(img, want)
                log(f"one-thread decode ({card}; host CPU) of the {img.shape} {name} "
                    f"({os.path.getsize(path) / 2**20:.2f} MiB), "
                    f"{'colour' if color else 'gray'} read: {ms:.1f} ms, "
                    f"{'the PNG bits' if same else 'DIFFERS'}")
                if not same:
                    fail(f"the full-size {name} does not decode to its PNG's bits")
    # (i) the CCITT and JPEG-in-TIFF files
    run_tiff_codecs(root, card)
    # (h) the same frames as TIFF files: the 16-bit ones through libtiff's
    # 16-to-8 rules (the high byte of a gray sample, (v + 128) / 257 of a
    # colour one), which give the 8-bit samples back
    for kind, ref_path in refs.items():
        for color in (True, False):
            want = images.read_png(ref_path, color)
            if kind == "rgb" and not color:   # imgcodecs' gray of the RGB pixels
                want = _gray_of_rgb(images.read_png(ref_path, True))
            for name in TIFF_VARIANTS:
                path = os.path.join(var, f"{kind}_{name}")
                img, ms = _one_thread_ms(images.read_image, path, color)
                same = np.array_equal(img, want)
                log(f"one-thread decode ({card}; host CPU) of the {img.shape} {kind} {name} "
                    f"({os.path.getsize(path) / 2**20:.2f} MiB), "
                    f"{'colour' if color else 'gray'} read: {ms:.1f} ms, "
                    f"{'the PNG bits' if same else 'DIFFERS'}")
                if not same:
                    fail(f"the full-size {kind} {name} does not decode to its PNG's bits")
    # (j) the GIF files
    run_gif_files(root, card)


def _gray_of_rgb(rgb):
    """imgcodecs' gray of RGB pixels (icvCvt_BGR2Gray): the gray read of a
    24-bit BMP, or of a TIFF's RGBA raster."""
    c = rgb.astype("int32")
    return ((1868 * c[..., 2] + 9617 * c[..., 1] + 4899 * c[..., 0] + 8192) >> 14).astype("uint8")


def run_tiff_codecs(root: str, card: str = "no card"):
    """Phase 16 (i) (its probes are check_tiff_probes'): frame
    GRAY_VARIANT_FRAME's bilevel plane as Group 4 in one strip and Group 3
    2-D in strips (FAX_VARIANTS) decodes to its PNG's bits in both reads;
    frame RGB_VARIANT_FRAME's own baseline JPEG as a single-strip
    JPEG-in-TIFF gives the port's colour read of the JPEG, and imgcodecs'
    gray of that in a gray read (libtiff asks libjpeg for RGB, cv2's TIFF
    read converts the RGBA raster); the frame as a tiled JPEG-in-TIFF gives
    in each tile the decode of the tile's stream spliced with JPEGTables
    into a standalone JPEG, and the gray of its colour read. Prints the
    one-thread decode time of each file beside the card line."""
    import numpy as np
    import image_forge as forge
    from panovlm_tpu_torch.io import images
    from panovlm_tpu_torch.io.jpeg import read_jpeg
    from panovlm_tpu_torch.native import jpeg as native_jpeg

    var = os.path.join(root, "png_variants")
    times = {}

    def timed(name, color, want):
        path = os.path.join(var, name)
        img, ms = _one_thread_ms(images.read_image, path, color)
        times[f"{name} {'colour' if color else 'gray'}"] = ms
        same = want is None or np.array_equal(img, want)
        log(f"phase 16 (i): {name} ({os.path.getsize(path) / 2**20:.2f} MiB), "
            f"{'colour' if color else 'gray'} read {img.shape}: {ms:.1f} ms one thread"
            + ("" if want is None else f", {'the expected bits' if same else 'DIFFERS'}"))
        if not same:
            fail(f"the full-size {name} does not decode to the expected bits")
        return img

    for color in (True, False):
        want = images.read_png(os.path.join(var, "bilevel.png"), color)
        for name in FAX_VARIANTS:
            timed(name, color, want)
    color_ref = read_jpeg(os.path.join(root, "color", f"{RGB_VARIANT_FRAME:06d}.jpg"), True)
    timed("jpeg_strip.tif", True, color_ref)
    timed("jpeg_strip.tif", False, _gray_of_rgb(color_ref))
    del color_ref
    tiled = timed("jpeg_tiles.tif", True, None)
    timed("jpeg_tiles.tif", False, _gray_of_rgb(tiled))
    with open(os.path.join(var, "jpeg_tiles.tif"), "rb") as f:
        data = f.read()
    fields = forge.tiff_fields(data)
    tw, th = fields[322][0], fields[323][0]
    H, W = tiled.shape[:2]
    origins = [(y, x) for y in range(0, H, th) for x in range(0, W, tw)]
    bad = 0
    for (y, x), off, count in zip(origins, fields[324], fields[325]):
        part = native_jpeg.decode(forge.splice_tables(fields[347], data[off:off + count]), True)
        h, w = min(th, H - y), min(tw, W - x)
        bad += not np.array_equal(tiled[y:y + h, x:x + w], part[:h, :w])
    log(f"phase 16 (i): {len(origins)} tiles of {tw} x {th} against their streams spliced "
        f"with JPEGTables: {'each the standalone decode' if not bad else f'{bad} DIFFER'}")
    if bad:
        fail("a tile of the tiled JPEG-in-TIFF differs from its spliced standalone JPEG")
    log(f"one-thread decode ({card}; host CPU) of the {H} x {W} phase 16 (i) TIFFs: "
        + ", ".join(f"{k} {ms:.1f} ms" for k, ms in times.items()))


def _cvt_gray(rgb):
    """cvtColor's COLOR_RGB2GRAY of uint8 pixels, the gray read of a GIF:
    (9798 R + 19235 G + 3735 B + 16384) >> 15."""
    c = rgb.astype("int32")
    return ((9798 * c[..., 0] + 19235 * c[..., 1] + 3735 * c[..., 2] + 16384) >> 15).astype("uint8")


def run_gif_files(root: str, card: str = "no card"):
    """Phase 16 (j) (its probes are check_gif_probes'): frame
    GRAY_VARIANT_FRAME's gray GIFs (GIF_VARIANTS) decode to its PNG's bits
    in both reads (the gray of (v, v, v) is v), frame RGB_VARIANT_FRAME's
    3-3-2 GIF to numpy's lookup of its indices in its palette (and to
    cvtColor's gray of that in a gray read). Prints the one-thread decode
    time of each file beside the card line."""
    import numpy as np
    import image_forge as forge
    from panovlm_tpu_torch.io import images

    var = os.path.join(root, "png_variants")
    gray_png = os.path.join(root, "images", f"{GRAY_VARIANT_FRAME:06d}.png")
    wants = {name: (lambda color: images.read_png(gray_png, color)) for name in GIF_VARIANTS}
    idx, pal = forge.gif_332(images.read_png(os.path.join(var, "rgb_filter0.png"), True))
    look = pal[idx]
    del idx
    wants[GIF_332] = lambda color: look if color else _cvt_gray(look)
    times = {}
    for name, want in wants.items():
        path = os.path.join(var, name)
        for color in (True, False):
            img, ms = _one_thread_ms(images.read_image, path, color)
            times[f"{name} {'colour' if color else 'gray'}"] = ms
            same = np.array_equal(img, want(color))
            log(f"phase 16 (j): {name} ({os.path.getsize(path) / 2**20:.2f} MiB), "
                f"{'colour' if color else 'gray'} read {img.shape}: {ms:.1f} ms one thread, "
                f"{'the expected bits' if same else 'DIFFERS'}")
            if not same:
                fail(f"the full-size {name} does not decode to the expected bits")
            del img
    log(f"one-thread decode ({card}; host CPU) of the {look.shape[0]} x {look.shape[1]} "
        f"phase 16 (j) GIFs: " + ", ".join(f"{k} {ms:.1f} ms" for k, ms in times.items()))


def tripod_mask(h: int, w: int):
    """A tripod-style mask, 255 where a pixel is usable: the bottom eighth
    of the rows (the tripod) and a pole, a band of w / 32 columns from the
    horizon down, cleared."""
    import numpy as np
    m = np.full((h, w), 255, np.uint8)
    m[h - h // 8:] = 0
    m[h // 2:, w // 2 - w // 64:w // 2 + w // 64] = 0
    return m


def _tree_bytes(root: str) -> dict:
    """Every file under root/result and root/mvs: relative path -> bytes."""
    out = {}
    for sub in ("result", "mvs"):
        for dirpath, _, files in os.walk(os.path.join(root, sub)):
            for name in files:
                path = os.path.join(dirpath, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, root)] = f.read()
    return out


def run_mask_phase(torch, vs_mod, mvs_cfg_path, d_gt, device: str = "cuda"):
    """Phase 16 (g): joint_mvs on the first MASK_FRAMES frames of phase 6's
    dataset with tripod_mask at half the working size (load_mask resizes
    it), once as a PNG, once as an RLE8 BMP named mask.png, (phase 16 (h))
    once as an LZW TIFF in tiles named mask.tif (MASK_TIFF), (phase 16 (i))
    once as a 1-bit MinIsWhite Group 4 TIFF named mask.tif and (phase 16
    (j)) once as a GIF with a 2-entry palette named mask.gif. Checked:
    load_mask gives the same booleans for all five, the resized mask's;
    every artifact of the runs bit-equal; fewer filtered depths in the masked
    pixels than the same frames without a mask have (a run resumed from
    the PNG run's pass artifacts; the mask clears the depths before the
    post-processing, whose gap interpolation may give some back); the
    depth error bound of phase 6.
    Prints each run's wall and K3 launches. Returns the launches of the
    PNG run."""
    import shutil
    import numpy as np
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.io import images
    import image_forge as forge

    root = os.path.join(os.path.dirname(mvs_cfg_path), "masked")
    H, W = d_gt[0].shape
    m = tripod_mask(H // 2, W // 2)
    os.makedirs(os.path.join(root, "masks", "bmp"))
    os.makedirs(os.path.join(root, "masks", "g4"))
    paths = {"png": os.path.join(root, "masks", "mask.png"),
             "bmp": os.path.join(root, "masks", "bmp", "mask.png"),
             "tif": os.path.join(root, "masks", "mask.tif"),
             "g4": os.path.join(root, "masks", "g4", "mask.tif"),
             "gif": os.path.join(root, "masks", "mask.gif")}
    images.write_png(paths["png"], m)
    with open(paths["bmp"], "wb") as f:
        f.write(forge.bmp_bytes((m > 0).astype(np.uint8), 8, [[0, 0, 0], [255, 255, 255]],
                                rle=True))
    with open(paths["tif"], "wb") as f:
        f.write(forge.tiff_bytes(m, 1, **MASK_TIFF))
    with open(paths["g4"], "wb") as f:   # 1-bit MinIsWhite: the masked pixels black
        f.write(forge.tiff_bytes((m == 0).astype(np.uint8), 0, 1, compression=4))
    with open(paths["gif"], "wb") as f:
        f.write(forge.gif_bytes((m > 0).astype(np.uint8), [[0, 0, 0], [255, 255, 255]]))
    want = np.repeat(np.repeat(m > 0, 2, axis=0), 2, axis=1)
    loaded = {kind: images.load_mask(path, H, W) for kind, path in paths.items()}
    same = all(x is not None and np.array_equal(x, want) for x in loaded.values())
    log(f"tripod mask {m.shape} as PNG ({os.path.getsize(paths['png'])} bytes), RLE8 BMP "
        f"named mask.png ({os.path.getsize(paths['bmp'])} bytes), LZW TIFF in tiles "
        f"({os.path.getsize(paths['tif'])} bytes), 1-bit Group 4 TIFF "
        f"({os.path.getsize(paths['g4'])} bytes) and 2-colour GIF "
        f"({os.path.getsize(paths['gif'])} bytes): load_mask at {H} x {W} "
        f"{'the same booleans, the resized mask' if same else 'DIFFERS'}; "
        f"{(~want).mean():.3f} of the pixels masked")
    if not same:
        fail("load_mask of the PNG, the BMP, the TIFF and the GIF masks differ")
    launches = {}
    for kind in ("png", "bmp", "tif", "g4", "gif"):
        cfg_path = _subset_config(os.path.join(root, kind), mvs_cfg_path, MASK_FRAMES,
                                  f"mask_path = {paths[kind]}\n")
        vs_mod.volscore.launches = 0
        t0 = time.time()
        rc = port_main(["joint_mvs", cfg_path, "--device", device])
        launches[kind] = vs_mod.volscore.launches
        log(f"joint_mvs, {MASK_FRAMES} frames at {H} x {W}, the {kind.upper()} mask: wall "
            f"{time.time() - t0:.1f} s, volscore launches {launches[kind]}")
        if rc != 0:
            fail(f"joint_mvs with the {kind} mask exited {rc}")
        if launches[kind] <= 0 and device == "cuda":
            fail(f"the volscore kernel was not launched in the run with the {kind} mask")
    trees = {kind: _tree_bytes(os.path.join(root, kind))
             for kind in ("png", "bmp", "tif", "g4", "gif")}
    for kind in ("bmp", "tif", "g4", "gif"):
        equal = trees["png"] == trees[kind]
        log(f"the PNG-mask and {kind.upper()}-mask runs: {len(trees['png'])} artifacts "
            f"{'bit-equal' if equal else 'DIFFER'}, volscore launches {launches['png']} and "
            f"{launches[kind]}")
        if not equal or launches["png"] != launches[kind]:
            fail(f"the runs with the PNG and the {kind.upper()} mask differ")
    # the same frames without a mask: the PNG run's pass artifacts, resumed
    none = os.path.join(root, "none")
    cfg_none = _subset_config(none, mvs_cfg_path, MASK_FRAMES)
    shutil.copytree(os.path.join(root, "png", "mvs"), os.path.join(none, "mvs"))
    for sub in ("depth", "conf"):
        for name in os.listdir(os.path.join(none, "mvs", sub)):
            if name.endswith("_filter.npy"):
                os.unlink(os.path.join(none, "mvs", sub, name))
    t0 = time.time()
    if port_main(["joint_mvs", cfg_none, "--device", device]) != 0:
        fail("joint_mvs without the mask exited non-zero")
    masked = ~want
    counts = {}
    for kind, cfg_path in (("png", os.path.join(root, "png", "config.txt")), ("none", cfg_none)):
        cfg = load_config(cfg_path)
        counts[kind] = sum(int((np.load(os.path.join(cfg.mvs_depth_path, f"{i:06d}_filter.npy"))
                                [masked] > 0).sum()) for i in range(MASK_FRAMES))
    log(f"filtered depths in masked pixels: {counts['png']} with the mask, {counts['none']} "
        f"without it (resumed run, {time.time() - t0:.1f} s)")
    if not counts["png"] < counts["none"]:   # gap interpolation may give some back
        fail("the mask did not take effect in the filtered depth maps")
    check_mvs_outputs(torch, load_config(os.path.join(root, "png", "config.txt")),
                      d_gt[:MASK_FRAMES], "phase 16 (g), PNG mask",
                      floors={key: 0.0 for key in MVS_MIN_COVERAGE})
    return launches["png"]


# ----------------------------------------------------------------------------
# phase 13: the joint stage's line-track modes and the CALIBRATION mode on
# phase 10's chain
# ----------------------------------------------------------------------------

JOINT_TRACK_KEYS = """\
use_image_track              = true
use_lidar_track              = true
use_track_associate          = true
"""
# consecutive-scan distance error (m; max, median) of the LiDAR poses that
# the JAX package's joint_optimize gives with the three track modes on this
# phase's joint_optimize arguments (tests/joint_chain_reference.py on the
# CPU, 8 devices, from the chiprun_out/joint_chain_tracks.npz that this
# phase keeps; the port on the CPU there: 0.15907, 0.02757); the port's are
# held to JOINT_LIDAR_MARGIN times it
JOINT_TRACKS_LIDAR_REF = (0.28077, 0.03613)
# the rotation error (deg) after the search, and the rotation (deg) and
# translation (m) errors after calibrate, against the true T_cl (identity),
# that the JAX package's perturb_calibration_search and calibrate give on
# this phase's calibration pair (the same host run): frame 20, 4 line pairs
# at the truth, too few to pin T_cl down, so the reference's own search
# turns the rotation from 1.6593 deg away from the truth
CALIB_REF = {"search_deg": 2.2653, "deg": 1.7689, "m": 1.19961}
CALIB_MARGIN = 1.25
# the JAX test's start (tests/test_camera_lidar.py:290-292)
CALIB_START_DEG = (1.2, -0.9, 0.7)
CALIB_START_M = (0.06, -0.04, 0.05)
CALIB_SEARCH_ITERS = 8


def _calib_errors(T):
    """(rotation error deg, translation error m) of T_cl against the
    truth, the identity."""
    import numpy as np
    cos = (np.trace(T[:3, :3]) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(cos, -1, 1)))), float(np.linalg.norm(T[:3, 3]))


def save_joint_tracks(cap, grays, calib, gt, path):
    """Phase 13's joint_optimize arguments (the arcs with their
    descriptors), the frames as uint8, the card's result and the
    calibration pair with its start and the card's results, as one npz:
    the input of tests/joint_chain_reference.py."""
    import numpy as np

    def host(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)

    (arcs, feats, *arrays, jcfg), kw = cap.args["joint_optimize"], cap.kwargs["joint_optimize"]
    names = ("cam_poses0", "lidar_poses0", "track_img", "track_feat", "track_mask",
             "bearings", "points0", "point_ok")
    cam, lidar, points, _ = cap.out["joint_optimize"]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path, **{f"arc_{k}": host(v) for k, v in arcs.items()},
        **{f"lidar_{k}": host(v) for k, v in feats.items()},
        **{n: host(a) for n, a in zip(names, arrays)}, lidar_valid=host(kw["lidar_valid"]),
        grays_u8=np.stack([np.rint(g * 255).astype(np.uint8) for g in grays]),
        out_cam=host(cam), out_lidar=host(lidar), out_points=host(points),
        gt_R=gt[0], gt_C=gt[1], jcfg=json.dumps(jcfg._asdict()), **calib)
    log(f"phase 13's joint_optimize inputs, frames, calibration pair and card results kept "
        f"in {os.path.relpath(path, HERE)} ({os.path.getsize(path) / 2**20:.1f} MiB)")


def run_calibration(torch, arcs_all, feats_all, device: str = "cuda"):
    """Phase 13 (b): the CALIBRATION mode on the chain's frame/scan pair
    with the most camera-LiDAR line pairs at the true T_cl (identity): the
    grid search from the JAX test's start, then calibrate, on the card and
    on the CPU; the search must keep its pairs and not turn away from the
    truth, and the card must give the CPU's result. Returns the pair's
    index, its start and the card's results (for the npz)."""
    import numpy as np
    from scipy.spatial.transform import Rotation as ScR
    from panovlm_tpu_torch.models import camera_lidar as cl

    arcs_all = {k: v for k, v in arcs_all.items() if k in cl._ARCS}
    feats_all = {k: v for k, v in feats_all.items() if k in cl._FEATS}
    n = arcs_all["normal"].shape[0]
    dev = arcs_all["normal"].device
    eye = torch.eye(3, device=dev).expand(n, 3, 3)
    at_truth = cl.associate_batch(arcs_all, {k: v[:n] for k, v in feats_all.items()}, eye,
                                  torch.zeros((n, 3), device=dev))["mask"].sum(1).cpu().numpy()
    f = int(np.argmax(at_truth))
    log(f"calibration pair: frame/scan {f}, {at_truth[f]} camera-LiDAR line pairs at the "
        f"true T_cl (median over the {n} frames {np.median(at_truth):.0f})")
    arcs = {k: v[f] for k, v in arcs_all.items()}
    feats = {k: v[f] for k, v in feats_all.items()}
    T0 = np.eye(4)
    T0[:3, :3] = ScR.from_euler("xyz", CALIB_START_DEG, degrees=True).as_matrix()
    T0[:3, 3] = CALIB_START_M
    def pairs_at(T):
        R, t = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (T[:3, :3], T[:3, 3]))
        return int(cl.associate_by_angle_pair(arcs, feats, R, t)["mask"].sum())
    n0 = pairs_at(T0)
    results = {}
    for where in ("card", "cpu"):
        t0 = time.time()
        on = device if where == "card" else "cpu"
        T_s, n_best = cl.perturb_calibration_search(arcs, feats, T0, device=on,
                                                    max_iterations=CALIB_SEARCH_ITERS)
        t1 = time.time()
        T_c, info = cl.calibrate(arcs, feats, T_s, device=on)
        results[where] = (T_s, n_best, T_c, info, t1 - t0, time.time() - t1)
    T_s, n_best, T_c, info, ts, tc = results["card"]
    for label, T, pairs in (("start", T0, n0), ("after the search", T_s, n_best),
                            ("after calibrate", T_c, pairs_at(T_c))):
        rot, trans = _calib_errors(T)
        log(f"  T_cl {label}: rotation error {rot:.4f} deg, translation error "
            f"{trans * 1000:.2f} mm, {pairs} line pairs")
    log(f"  search {ts:.2f} s ({CALIB_SEARCH_ITERS} iterations at most, 729 candidates in "
        f"chunks of 81), calibrate {tc:.2f} s, {int(info['iterations'])} LM iterations, "
        f"cost {info['initial_cost']:.4g} -> {info['final_cost']:.4g}; on the CPU "
        f"{results['cpu'][4]:.2f} s and {results['cpu'][5]:.2f} s")
    if not n_best >= n0:
        fail(f"calibration search lost line pairs: {n0} -> {n_best}")
    T_s_c, n_c, T_c_c = results["cpu"][:3]
    gap = [max(np.abs(ScR.from_matrix(a[:3, :3] @ b[:3, :3].T).as_rotvec()).max(),
               np.abs(a[:3, 3] - b[:3, 3]).max()) for a, b in ((T_s, T_s_c), (T_c, T_c_c))]
    log(f"  card vs CPU: pairs {n_best} vs {n_c}; T after the search {gap[0]:.2e}, after "
        f"calibrate {gap[1]:.2e} (rad / m)")
    if n_best != n_c or max(gap) > 1e-4:
        fail(f"calibration on the card differs from the CPU: {n_best} vs {n_c} pairs, {gap}")
    return {"calib_frame": f, "calib_T0": T0, "calib_T_search": T_s, "calib_n_search": n_best,
            "calib_T": T_c}


def run_joint_tracks(torch, knn_mod, sfm_cfg_path, gt, device: str = "cuda"):
    """Phase 13 (a): the joint stage through the CLI on phase 10's chain
    (its config with the three track flags), checked as phase 10 checks it
    plus the gates; a rerun for the same bits; then (b). Returns the kernel
    launches of the first run."""
    import numpy as np
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.io import artifacts
    from panovlm_tpu_torch.models import camera_lidar
    from panovlm_tpu_torch.utils.timing import TimeReport

    root = os.path.dirname(sfm_cfg_path)
    cfg_path = os.path.join(root, "chain_tracks_config.txt")
    with open(os.path.join(root, "chain_config.txt")) as f:
        text = f.read()
    with open(cfg_path, "w") as f:
        f.write(text + JOINT_TRACK_KEYS)
    cfg = load_config(cfg_path)
    if not (cfg.use_image_track and cfg.use_lidar_track and cfg.use_track_associate):
        fail("the track flags did not reach the config")
    tr = TimeReport()
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    knn_mod.knn.launches = 0
    knn_mod.knn_ring.launches = 0
    t0 = time.time()
    with _FirstCall(camera_lidar, ("joint_optimize",)) as joint:
        rc = port_main(["joint_optimization", cfg_path, "--device", device], tr=tr)
    wall = time.time() - t0
    launches = {"knn": knn_mod.knn.launches, "knn_ring": knn_mod.knn_ring.launches}
    if rc != 0:
        fail(f"joint_optimization with the track modes exited {rc}")
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    log(f"joint stage with the track modes: wall {wall:.1f} s, peak device memory "
        f"{peak:.2f} GiB")
    for name, sec in tr.time_spent.items():
        if name != "joint_optimization":
            log(f"  {name}: {sec:.2f} s")
    for name in JOINT_ARTIFACTS:
        if not os.path.exists(os.path.join(cfg.joint_result_path, name)):
            fail(f"missing artifact result/joint/{name}")
    infos = joint.out["joint_optimize"][3]
    for r, info in enumerate(infos):
        log(f"  round {r}: image lines {info['image_lines_tracked']} of {info['image_lines']} "
            f"on tracks, LiDAR lines {info['lidar_lines_tracked']} of {info['lidar_lines']}; "
            f"line pairs {info['line_pairs_untracked']} -> {info['line_pairs_tracked']} by "
            f"the track association; LK points {info.get('lk_points', 0)}, status 1 "
            f"{info.get('lk_ok', 0) / max(info.get('lk_points', 0), 1):.3f}")
        for key in ("image_lines_tracked", "lidar_lines_tracked", "line_pairs_tracked"):
            if not info[key] > 0:
                fail(f"round {r}: the gate keeps no lines ({key} = 0)")
    log(f"kernel launches on the path: {launches} in {cfg.num_iteration_joint} rounds")
    if on_card and set(launches.values()) != {cfg.num_iteration_joint}:
        fail(f"launches {launches} differ from the {cfg.num_iteration_joint} joint rounds")
    rot, dist, all_ok = sfm_pose_errors(
        os.path.join(cfg.joint_result_path, "camera_pose_joint.txt"), gt)
    log(f"camera_pose_joint.txt vs ground truth: max rotation error {rot:.4f} deg, "
        f"max camera-centre error {dist * 1000:.2f} mm, every frame valid: {all_ok}")
    if not (all_ok and rot < 1.0 and dist < 0.08):
        fail(f"joint camera poses off ground truth: {rot:.3f} deg, {dist:.4f} m, "
             f"all valid {all_ok} (bounds 1 deg, 0.08 m)")

    # the same bits on a rerun of the stage
    first_out = _joint_outputs(cfg)
    t1 = time.time()
    if port_main(["joint_optimization", cfg_path, "--device", device]) != 0:
        fail("joint_optimization with the track modes (second run) failed")
    same = [a == b for a, b in zip(first_out, _joint_outputs(cfg))]
    log(f"rerun ({time.time() - t1:.1f} s): camera poses, LiDAR poses, points "
        f"{'bit-equal' if all(same) else f'DIFFER {same}'}")
    if not all(same):
        fail(f"the joint stage with the track modes is not reproducible: {same}")

    # (b) the calibration on one frame/scan pair; then the bounds that the
    # JAX functions' errors on the kept inputs set
    t1 = time.time()
    arcs, feats = joint.args["joint_optimize"][:2]
    calib = run_calibration(torch, arcs, feats, device)
    log(f"phase 13 (b) (calibration): {time.time() - t1:.1f} s")
    save_joint_tracks(joint, joint.kwargs["joint_optimize"]["grays"], calib, gt,
                      os.path.join(HERE, "chiprun_out", "joint_chain_tracks.npz"))
    _, t, _, ok = artifacts.read_pose_t(os.path.join(cfg.joint_result_path,
                                                     "lidar_pose_joint.txt"))
    d_gt = np.linalg.norm(np.diff(gt[1], axis=0), axis=1)
    err = np.abs(np.linalg.norm(np.diff(t, axis=0), axis=1) - d_gt)
    ref_max, ref_median = JOINT_TRACKS_LIDAR_REF
    log(f"lidar_pose_joint.txt: consecutive-scan distance error vs ground truth: max "
        f"{err.max() * 1000:.2f} mm (scan {int(err.argmax())}), median "
        f"{np.median(err) * 1000:.2f} mm; the JAX joint_optimize on the same inputs: "
        f"{ref_max} m, {ref_median} m; bounds {JOINT_LIDAR_MARGIN} x those")
    # on a weakly constrained pair the reference's own search may turn the
    # rotation away from the truth: then the port may go as far (x 1.25)
    rot_s, rot_0 = _calib_errors(calib["calib_T_search"])[0], _calib_errors(calib["calib_T0"])[0]
    ref_s = CALIB_REF["search_deg"]
    log(f"calibration search: rotation error {rot_0:.4f} -> {rot_s:.4f} deg; the JAX search "
        f"on the same inputs: {ref_s} deg")
    if not (rot_s <= rot_0 + 1e-6 or (ref_s is not None and rot_s <= CALIB_MARGIN * ref_s)):
        fail(f"calibration search moved the rotation away from the truth: {rot_0:.4f} -> "
             f"{rot_s:.4f} deg (the JAX search: {ref_s} deg)")
    rot, trans = _calib_errors(calib["calib_T"])
    log(f"calibration error of the JAX functions on the same inputs: {CALIB_REF['deg']} deg, "
        f"{CALIB_REF['m']} m; bounds {CALIB_MARGIN} x those")
    if CALIB_REF["deg"] is None or not (rot <= CALIB_MARGIN * CALIB_REF["deg"]
                                        and trans <= CALIB_MARGIN * CALIB_REF["m"]):
        fail(f"calibration error {rot:.4f} deg, {trans:.4f} m against {CALIB_MARGIN} x "
             f"{CALIB_REF}")
    if not (ok.all() and np.isfinite(t).all()):
        fail("lidar_pose_joint.txt: invalid poses")
    if ref_max is None or not (err.max() < JOINT_LIDAR_MARGIN * ref_max
                               and np.median(err) < JOINT_LIDAR_MARGIN * ref_median):
        fail(f"joint LiDAR poses with the track modes: {err.max():.4f} / "
             f"{np.median(err):.4f} m against {JOINT_LIDAR_MARGIN} x {JOINT_TRACKS_LIDAR_REF}")
    return launches


# ----------------------------------------------------------------------------
# phase 12: the LM solver's PCG tier at Floor depth (cut) and at Room-454's
# pair graph
# ----------------------------------------------------------------------------

# the reference's Floor dataset has 1593 scans (_floor_scale.sh); cut to
# 1100 (the time limit), still above the dense tier's 6,144 parameters
FLOOR_SCANS = 1100
TA_FRAMES = 454
TA_NEIGHBOURS = 40          # nearest camera centres per frame: ~9,000 pairs
TA_DIR_NOISE_DEG = 0.5
TA_SCALE_NOISE = 0.05


def _timed(torch, fn):
    """(fn(), seconds), synchronised on the card (where there is one: the
    phase's functions also run on the CPU, at a small size)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.time()
    out = fn()
    sync()
    return out, time.time() - t0


def _pose_diff(a, b):
    """Max position (m) and rotation (deg) difference of two (N, 6) pose
    parameter arrays [aa, t]."""
    import numpy as np
    from scipy.spatial.transform import Rotation as ScR
    rot = ScR.from_rotvec(np.asarray(a[:, :3], np.float64)).inv() * ScR.from_rotvec(
        np.asarray(b[:, :3], np.float64))
    return (float(np.abs(np.asarray(a[:, 3:]) - np.asarray(b[:, 3:])).max()),
            float(np.degrees(rot.magnitude()).max()))


def run_floor_odometry(torch, knn_mod, cfg_path, gt, device: str = "cuda"):
    """Phase 12 (a): the odometry stage through the CLI on the Floor
    dataset cut to FLOOR_SCANS (make_room: the Room-454 loop's yaw step),
    on the PCG tier. Checks the artifacts, the ground-truth bound, one K1
    and one K2 launch per round, the tier, and a bit-equal re-solve of the
    first round's LM problem; compares that problem's PCG solve with the
    dense tier forced per call. Returns (launches, the first knn and
    knn_ring arguments)."""
    import numpy as np
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.io import artifacts
    from panovlm_tpu_torch.models import association, lidar_odometry
    from panovlm_tpu_torch.utils.timing import TimeReport

    on_card = device == "cuda"
    n_scans = len(gt)
    infos, tr = [], TimeReport()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    knn_mod.knn.launches = 0
    knn_mod.knn_ring.launches = 0
    t0 = time.time()
    with _FirstCall(association, ("knn", "knn_ring")) as first, \
            _FirstCall(lidar_odometry, ("solve_lm",), host=True) as solve:
        rc = port_main(["init_lidar_pose", cfg_path, "--device", device], infos=infos, tr=tr)
    wall = time.time() - t0
    launches = {"knn": knn_mod.knn.launches, "knn_ring": knn_mod.knn_ring.launches}
    if rc != 0:
        fail(f"init_lidar_pose at Floor-{n_scans} exited {rc}")
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    log(f"Floor-{n_scans} odometry stage wall {wall:.1f} s, peak device memory "
        f"{peak:.2f} GiB of the card's "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30 if on_card else 0:.1f}")
    for name, sec in tr.time_spent.items():
        if name != "init_lidar_pose":
            log(f"  {name}: {sec:.2f} s")
    for r, info in enumerate(infos):
        cg = info["cg_iterations"]
        log(f"Floor round {r}: {info['pairs']} pairs, {info['tier']} tier, cost "
            f"{info['initial_cost']:.6g} -> {info['final_cost']:.6g}, "
            f"{info['iterations']} LM iterations, CG iterations per LM iteration {cg} "
            f"(mean {np.mean(cg) if cg else 0:.1f})")
    log(f"kernel launches on the Floor odometry path: {launches} in {len(infos)} "
        f"association rounds")
    if on_card and (min(launches.values()) <= 0 or set(launches.values()) != {len(infos)}):
        fail(f"launches {launches} differ from the {len(infos)} association rounds")
    tiers = {info["tier"] for info in infos}
    if tiers != {"pcg"}:
        fail(f"the Floor odometry solves ran on the {tiers} tier, not PCG")

    cfg = load_config(cfg_path)
    for name in ("lidar_pose_refined.txt", "lidar_center_refined.pcd",
                 "lidar_pose_refined.ply", "lidar_pose_undis_refined.txt",
                 "lidar_center_undis_refined.pcd"):
        if not os.path.exists(os.path.join(cfg.odo_result_path, name)):
            fail(f"missing artifact {name}")
    n_und = len(os.listdir(cfg.lidar_path_undistort))
    if n_und != n_scans:
        fail(f"{n_und} undistorted clouds for {n_scans} scans")
    d_gt = np.linalg.norm(np.diff(np.stack([p[1] for p in gt]), axis=0), axis=1)
    for name in ("lidar_pose_refined.txt", "lidar_pose_undis_refined.txt"):
        _, t, _, ok = artifacts.read_pose_t(os.path.join(cfg.odo_result_path, name))
        if not (ok.all() and np.isfinite(t).all()):
            fail(f"Floor {name}: invalid poses")
        err = np.abs(np.linalg.norm(np.diff(t, axis=0), axis=1) - d_gt)
        log(f"Floor {name}: consecutive-scan distance error vs ground truth: "
            f"max {err.max() * 1000:.2f} mm (scan {int(err.argmax())}), "
            f"median {np.median(err) * 1000:.2f} mm")
        if not err.max() < 0.05:
            fail(f"Floor {name}: error {err.max():.4f} m >= 0.05 m at scan "
                 f"{int(err.argmax())}")

    # the first round's LM problem again on its captured inputs: the same
    # bits; then the dense tier forced per call on the same problem
    args, kwargs = solve.args["solve_lm"], solve.kwargs["solve_lm"]
    stage_out = _restore(solve.out["solve_lm"])
    (out, info), t_pcg = _timed(torch, lambda: lidar_odometry.solve_lm(
        *_restore(args), **_restore(kwargs)))
    same = _bits((out, info)) == _bits(stage_out)
    P = out["poses"].numel()
    log(f"Floor round 0 re-solved on its inputs (P = {P}, {info['tier']} tier, "
        f"{info['iterations']} LM iterations, CG {info['cg_iterations']}): {t_pcg:.2f} s, "
        f"{'bit-equal to the stage' if same else 'DIFFERS from the stage'}")
    if not same:
        fail("the Floor round-0 LM solve is not reproducible")
    dargs = list(_restore(args))
    dargs[3] = dargs[3]._replace(dense_max_params=P)
    (dout, dinfo), t_dense = _timed(torch, lambda: lidar_odometry.solve_lm(*dargs))
    dpos, drot = _pose_diff(out["poses"].cpu().numpy(), dout["poses"].cpu().numpy())
    log(f"Floor round 0 on the dense tier forced per call ({dinfo['tier']}, P = {P}, "
        f"{dinfo['iterations']} LM iterations): {t_dense:.2f} s against PCG {t_pcg:.2f} s; "
        f"poses PCG - dense: max {dpos * 1000:.3f} mm, {drot:.5f} deg; final cost "
        f"{float(info['final_cost']):.6g} (PCG) vs {float(dinfo['final_cost']):.6g} (dense)")
    if dinfo["tier"] != "dense":
        fail(f"the forced dense solve ran on the {dinfo['tier']} tier")
    return launches, first.args


def ta_room_inputs(n: int = TA_FRAMES, k: int = TA_NEIGHBOURS, seed: int = 0):
    """Translation averaging inputs at Room-454's pair graph: the cameras of
    room_loop(n) (T_cl = identity), each frame paired with its k nearest
    camera centres (the loop's other revolutions included), relative
    rotations exact, directions with TA_DIR_NOISE_DEG of Gaussian noise and
    scales the true distances with TA_SCALE_NOISE of relative noise.
    Returns (kwargs of translation_averaging, ground-truth centres (n, 3),
    camera rotations R_cw (n, 3, 3))."""
    import numpy as np
    from scipy.spatial.transform import Rotation as ScR
    import synthetic
    yaw = 2.5 * 2 * math.pi / 454
    # the poses of room_loop(n); a few azimuths per scan, the rays unused
    _, poses = synthetic.make_trajectory_scans(
        n_scans=n, step=(0.8 * yaw, 0.0, 0.0), yaw_step=yaw, origin=(0.0, 0.0, -1.0),
        noise=0.0, h_steps=4, sweep_alpha=0.5, body_step=True)
    R_wc, C = _camera_convention(poses)
    R_cw = np.transpose(R_wc, (0, 2, 1))
    t_cw = -np.einsum("nij,nj->ni", R_cw, C)
    d = np.linalg.norm(C[:, None] - C[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    nn = np.argsort(d, axis=1)[:, :k]
    pairs = np.unique(np.sort(np.stack([np.repeat(np.arange(n), k), nn.ravel()], 1), 1), axis=0)
    pi, pj = pairs[:, 0], pairs[:, 1]
    R_ji = R_cw[pj] @ np.transpose(R_cw[pi], (0, 2, 1))
    t_ji = t_cw[pj] - np.einsum("mij,mj->mi", R_ji, t_cw[pi])
    dist = np.linalg.norm(t_ji, axis=1)
    rng = np.random.default_rng(seed)
    u = t_ji / dist[:, None] + rng.normal(size=t_ji.shape) * np.radians(TA_DIR_NOISE_DEG)
    kwargs = dict(aa_global=ScR.from_matrix(R_cw).as_rotvec().astype(np.float32),
                  pair_i=pi, pair_j=pj,
                  rel_aa=ScR.from_matrix(R_ji).as_rotvec().astype(np.float32),
                  rel_t=(u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32),
                  scales=(dist * (1 + TA_SCALE_NOISE * rng.normal(size=len(dist)))
                          ).astype(np.float32))
    return kwargs, C, R_cw


def _similarity_error(est, ref):
    """Max |s R est + t - ref| after the least-squares similarity (Umeyama)."""
    import numpy as np
    mu_e, mu_r = est.mean(0), ref.mean(0)
    e, r = est - mu_e, ref - mu_r
    U, S, Vt = np.linalg.svd(r.T @ e / len(est))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / (e ** 2).sum(1).mean()
    return float(np.linalg.norm(s * e @ R.T + mu_r - ref, axis=1).max())


def run_ta_room(torch, device: str = "cuda"):
    """Phase 12 (b): translation averaging (softl1) at Room-454's pair
    graph, P = 3 x 454 + pairs > 6144, so the PCG tier; camera centres
    within 0.08 m of ground truth after a similarity, a bit-equal rerun, and
    the dense tier forced per call for comparison."""
    import functools
    import numpy as np
    from panovlm_tpu_torch.models import translation_averaging as ta_mod

    kwargs, C, R_cw = ta_room_inputs()
    m = len(kwargs["pair_i"])
    P = 3 * len(C) + m

    def solve():
        with _EveryCall(ta_mod, "solve_lm", lambda a, res: res[1]["tier"]) as tiers:
            t, s = ta_mod.translation_averaging(**kwargs, device=device)
        return (t, s), tiers.values

    ((t, s), tiers), t_pcg = _timed(torch, solve)
    centres = -np.einsum("nji,nj->ni", R_cw, t)
    err = _similarity_error(centres, C)
    log(f"translation averaging at Room-{len(C)}: {m} pairs ({TA_NEIGHBOURS} nearest "
        f"centres per frame), direction noise {TA_DIR_NOISE_DEG} deg, scale noise "
        f"{TA_SCALE_NOISE:.0%}; P = {P}, tiers {tiers}, {t_pcg:.2f} s; camera-centre error "
        f"after a similarity: max {err * 1000:.2f} mm")
    if tiers != ["pcg"]:
        fail(f"translation averaging ran on the {tiers} tier(s), not PCG")
    if not err < 0.08:
        fail(f"translation averaging centre error {err:.4f} m >= 0.08 m")
    ((t2, s2), _), t_again = _timed(torch, solve)
    same = t.tobytes() == t2.tobytes() and s.tobytes() == s2.tobytes()
    log(f"translation averaging rerun ({t_again:.2f} s): "
        f"{'bit-equal' if same else 'DIFFERS'}")
    if not same:
        fail("translation averaging is not reproducible")
    saved = ta_mod.LMOptions
    ta_mod.LMOptions = functools.partial(saved, dense_max_params=P)
    try:
        ((td, sd), dtiers), t_dense = _timed(torch, solve)
    finally:
        ta_mod.LMOptions = saved
    cd = -np.einsum("nji,nj->ni", R_cw, td)
    log(f"translation averaging on the dense tier forced per call ({dtiers}): "
        f"{t_dense:.2f} s against PCG {t_pcg:.2f} s; centres PCG - dense: max "
        f"{np.linalg.norm(centres - cd, axis=1).max() * 1000:.3f} mm, scales max "
        f"{np.abs(s - sd).max():.3g}; dense centre error {_similarity_error(cd, C) * 1000:.2f} mm")
    if dtiers != ["dense"]:
        fail(f"the forced dense translation averaging ran on {dtiers}")


# The JAX translation_averaging's camera-centre error after a similarity on
# ta_room_inputs(), per method: a host run of tests/ta_room_reference.py
# (the JAX package on the CPU, its Jacobian chunking off, ROADMAP F1). Where
# it is >= 0.08 m, the port's bound is TA_METHOD_MARGIN times it.
TA_METHOD_REF = {"chordal": 0.18840, "lud": 0.06900, "bata": 0.20236, "l1": 0.10695}
TA_METHOD_MARGIN = 1.25
# triplets l1's L-infinity LP samples (the method's default: 20,000; cut:
# the time limit, the host LP took 57.6-66.4 s there); TA_METHOD_REF's l1
# is the JAX function's error with the same sample
TA_LP_TRIPLETS = 2000


def run_ta_methods(torch, device: str = "cuda"):
    """Phase 12 (b), continued: chordal, lud, bata and l1 on the same
    Room-454 pair graph. Each: its tiers, time and camera-centre error after
    a similarity, < 0.08 m or within TA_METHOD_MARGIN times the JAX
    function's (TA_METHOD_REF), and a bit-equal rerun (l1's on its first
    LP solution). l1's L-inf LP samples TA_LP_TRIPLETS triplets. Prints the
    LP's size and time (scipy's HiGHS on the host)."""
    import numpy as np
    from panovlm_tpu_torch.models import translation_averaging as ta_mod

    kwargs, C, R_cw = ta_room_inputs()
    m = len(kwargs["pair_i"])
    triplets, _, found = ta_mod.linf_triplets(kwargs["pair_i"], kwargs["pair_j"],
                                              np.ones(m, bool), TA_LP_TRIPLETS)
    n_lam = len({k for tri in triplets for k in (tri[:2], tri[1:], tri[::2])})
    kwargs = dict(kwargs, lp_triplets=TA_LP_TRIPLETS)
    for method, ref in TA_METHOD_REF.items():
        def solve():
            with _EveryCall(ta_mod, "solve_lm", lambda a, res: res[1]["tier"]) as tiers, \
                    _EveryCall(ta_mod, "translation_averaging_linf_lp",
                               lambda a, res: res) as lp:
                out = ta_mod.translation_averaging(**kwargs, method=method, device=device)
            return out, tiers.values, lp
        (((t, s), tiers, lp), sec) = _timed(torch, solve)
        err = _similarity_error(-np.einsum("nji,nj->ni", R_cw, t), C)
        bound = 0.08 if ref < 0.08 else TA_METHOD_MARGIN * ref
        lp_note = ""
        if lp.values:
            lp_note = (f"; L-inf LP ({found} triplets, {len(triplets)} kept, {n_lam} pairs, "
                       f"{6 * n_lam} x {3 * len(C) + n_lam + 1}) {lp.seconds[0]:.2f} s on the "
                       f"host, ok {lp.values[0][1]}")
        log(f"translation averaging ({method}) at Room-{len(C)}: tiers {sorted(set(tiers))} "
            f"({len(tiers)} solves), {sec:.2f} s; camera-centre error after a similarity "
            f"{err * 1000:.2f} mm (JAX {ref * 1000:.2f} mm, bound {bound * 1000:.2f} mm)"
            f"{lp_note}")
        if not err < bound:
            fail(f"translation averaging ({method}) error {err:.4f} m >= {bound:.4f} m")
        # the rerun takes l1's host LP solution as it came (scipy's HiGHS,
        # deterministic, most of the call): the card's part again
        saved = ta_mod.translation_averaging_linf_lp
        if lp.values:
            ta_mod.translation_averaging_linf_lp = lambda *a, **k: lp.values[0]
        try:
            ((t2, s2), _, _), again = _timed(torch, solve)
        finally:
            ta_mod.translation_averaging_linf_lp = saved
        same = t.tobytes() == t2.tobytes() and s.tobytes() == s2.tobytes()
        log(f"translation averaging ({method}) rerun ({again:.2f} s"
            f"{', the LP reused' if lp.values else ''}): {'bit-equal' if same else 'DIFFERS'}")
        if not same:
            fail(f"translation averaging ({method}) is not reproducible")


# ----------------------------------------------------------------------------
# phase 14: the last four options: SfM-point neighbour selection, exact
# per-plane sampling, DOUBLE_EXTRACTION and the ring repair
# ----------------------------------------------------------------------------

def _peak_gib(torch) -> str:
    """Peak device memory since torch.cuda.reset_peak_memory_stats, as
    printed."""
    return f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"


# share of rows H/4..3H/4 with a depth that the SfM-point run of phase 14
# (a) must reach: about 80 % of what it measured on an NVIDIA H100 80GB
# HBM3 at 700 W (0.122 after post-processing, 0.019 filtered). The SfM
# score saturates at 10 deg of parallax and so picks wider baselines than
# the camera-centre KNN, whose run on the same chain and card covered
# 0.223 and 0.099: phase 6's floors, set on consecutive frames with KNN
# neighbours, do not carry over to this cell. The JAX stage does the same
# (tests/test_torch_mvs_options.py::test_sfm_neighbours_widen_the_baselines:
# on a 10-frame chain the neighbours' mean baseline goes from 0.40 m to
# 0.74 m and its coverage from 0.271 to 0.164 post-processed and from 0.176
# to 0.089 filtered); the phase prints both tables' mean baselines.
SFM_NEIGHBOUR_MIN_COVERAGE = {"geo (post-processed)": 0.098, "filter": 0.015}


def run_mvs_sfm_neighbours(torch, vs_mod, sfm_cfg_path, d_gt):
    """Phase 14 (a): joint_mvs with mvs_neighbor_selection = 1 and the
    configs' sweep on phase 10's chain (its frames at 720 x 1440, phase 8's
    result/sfm/points.npz, the joint poses, RefineCameraPose on the SfM
    tracks). Checked: the stage filtered with the host function's table on
    the same points.npz, KNN picks where it has -1; a row differs from the
    KNN table; against d_gt the median relative depth error < 0.08 and the
    coverage floors SFM_NEIGHBOUR_MIN_COVERAGE. Returns K3 launches."""
    import numpy as np
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.io import artifacts
    from panovlm_tpu_torch.models import mvs
    from panovlm_tpu_torch.ops import se3
    from panovlm_tpu_torch.utils.timing import TimeReport

    root = os.path.dirname(sfm_cfg_path)
    n = len(d_gt)
    cfg_path = os.path.join(root, "mvs_sfm_config.txt")
    with open(os.path.join(root, "chain_config.txt")) as f:
        text = f.read()
    with open(cfg_path, "w") as f:
        f.write(f"{text}{ROOM_MVS_KEYS}scale = 0\nmvs_neighbor_selection = 1\n"
                f"mvs_data_path = {root}/mvs_sfm\n")
    cfg = load_config(cfg_path)
    tr = TimeReport()
    vs_mod.volscore.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with _FirstCall(mvs, ("select_neighbor_sfm", "filter_depth_maps")) as cap:
        rc = port_main(["joint_mvs", cfg_path, "--device", "cuda"], tr=tr)
    wall = time.time() - t0
    launches = vs_mod.volscore.launches
    if rc != 0:
        fail(f"joint_mvs with SfM-point neighbours exited {rc}")
    log(f"joint_mvs, SfM-point neighbours, {n} frames: wall {wall:.1f} s, peak device "
        f"memory {_peak_gib(torch)}, volscore launches {launches}")
    for name in ("refine camera pose", "photometric pass", "geometric pass"):
        sec = tr.time_spent.get(name, float("nan"))
        log(f"  {name}: {sec:.2f} s ({sec / n:.3f} s per frame)")
    if "select_neighbor_sfm" not in cap.args:
        fail("the stage did not select neighbours from the SfM points")
    poses = cap.args["select_neighbor_sfm"][0]
    tracks = artifacts.read_point_tracks(os.path.join(cfg.sfm_result_path, "points.npz"))
    sfm_table = mvs.select_neighbor_sfm(poses, tracks["points"], tracks["track_img"],
                                        tracks["track_mask"], 4)
    _, _, _, c_ok = artifacts.read_pose_t(os.path.join(cfg.joint_result_path,
                                                       "camera_pose_joint.txt"))
    knn = mvs.select_neighbor_views(poses, 4, c_ok)
    want = np.where(sfm_table >= 0, sfm_table, knn)
    used = np.asarray(cap.args["filter_depth_maps"][3])
    del cap
    if not np.array_equal(used, want):
        fail(f"the stage's neighbour table differs from select_neighbor_sfm's on "
             f"points.npz: {int((used != want).any(1).sum())} rows")
    differ = int((want != knn).any(1).sum())
    fell_back = int((sfm_table < 0).any(1).sum())
    P = np.asarray(poses, np.float32)
    R = se3.exp_so3(torch.from_numpy(P[:, :3])).double().numpy()
    C = -np.einsum("nji,nj->ni", R, P[:, 3:].astype(np.float64))
    log(f"neighbour table: {differ} of {n} rows differ from the camera-centre KNN, "
        f"{fell_back} rows took KNN picks ({int((sfm_table < 0).sum())} entries), "
        f"{len(tracks['points'])} SfM points; mean baseline to the neighbours "
        f"{np.linalg.norm(C[:, None] - C[want], axis=-1).mean():.3f} m (KNN: "
        f"{np.linalg.norm(C[:, None] - C[knn], axis=-1).mean():.3f} m)")
    if differ == 0:
        fail("the SfM-point table equals the KNN table: the option changed nothing")
    if launches <= 0:
        fail("the volscore kernel was not launched on the sweep path")
    check_mvs_outputs(torch, cfg, d_gt, "phase 14 (a)", floors=SFM_NEIGHBOUR_MIN_COVERAGE)
    return launches


def _subset_config(root, mvs_cfg_path, k: int, keys: str = ""):
    """Config of a joint_mvs run on the first k frames of phase 6's dataset,
    with its own images, joint poses, results and depth maps, and `keys`
    after the Room MVS keys."""
    from panovlm_tpu_torch.io import artifacts

    src = os.path.dirname(mvs_cfg_path)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "result", "joint"))
    for i in range(k):
        os.symlink(os.path.join(src, "images", f"{i:06d}.png"),
                   os.path.join(root, "images", f"{i:06d}.png"))
    for name in ("camera_pose_joint.txt", "lidar_pose_joint.txt"):
        R, t, _, _ = artifacts.read_pose_t(os.path.join(src, "result", "joint", name))
        artifacts.export_pose_t(os.path.join(root, "result", "joint", name), R[:k], t[:k])
    cfg_path = os.path.join(root, "config.txt")
    with open(cfg_path, "w") as f:
        f.write(f"image_path = {root}/images\nlidar_path = {src}/undis\n"
                f"lidar_path_undistort = {src}/undis\nresult_path = {root}/result\n"
                f"mvs_data_path = {root}/mvs\n{ROOM_MVS_KEYS}{keys}")
    return cfg_path


class _FirstPasses:
    """Wraps models.mvs.estimate_depth_map and keeps, for the first call of
    each pass (photometric: no neighbour depths; geometric: with them), its
    arguments (tensors in host memory), the states its torch.Generator
    arguments had before the call, and its result."""

    def __init__(self, mvs):
        self.mvs, self.calls = mvs, {}

    def __enter__(self):
        self.saved = fn = self.mvs.estimate_depth_map

        def wrapped(*a, **kw):
            name = "photometric" if a[9] is None else "geometric"
            if name in self.calls:
                return fn(*a, **kw)
            gens = [x for x in (*a, *kw.values()) if type(x).__name__ == "Generator"]
            states = [(g, g.get_state()) for g in gens]
            res = fn(*a, **kw)
            self.calls[name] = (_hold(list(a)), _hold(kw), states, _hold(res))
            return res
        self.mvs.estimate_depth_map = wrapped
        return self

    def __exit__(self, *exc):
        self.mvs.estimate_depth_map = self.saved


def run_mvs_exact(torch, vs_mod, mvs_cfg_path, d_gt, k: int, tr6):
    """Phase 14 (b): joint_mvs with mvs_sweep_slices = 0 on the first k
    frames of phase 6's dataset at 720 x 1440. Checked: phase 6's depth
    bounds, no volscore launch, and frame 0's photometric and geometric
    passes run again on their captured inputs and generator states
    bit-equal to the stage's; prints the passes per frame beside phase 6's
    (tr6, the sweep)."""
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.models import mvs
    from panovlm_tpu_torch.utils.timing import TimeReport

    n6 = len(d_gt)
    cfg_path = _subset_config(os.path.join(os.path.dirname(mvs_cfg_path), "exact"),
                              mvs_cfg_path, k, "mvs_sweep_slices = 0\n")
    cfg = load_config(cfg_path)
    tr = TimeReport()
    vs_mod.volscore.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with _FirstPasses(mvs) as first:
        rc = port_main(["joint_mvs", cfg_path, "--device", "cuda"], tr=tr)
    wall = time.time() - t0
    if rc != 0:
        fail(f"joint_mvs with exact sampling exited {rc}")
    log(f"joint_mvs, exact sampling, {k} frames at {d_gt[0].shape[0]} x {d_gt[0].shape[1]}: "
        f"wall {wall:.1f} s, peak device memory {_peak_gib(torch)}, volscore "
        f"launches {vs_mod.volscore.launches}")
    if vs_mod.volscore.launches != 0:
        fail(f"the exact path launched the volscore kernel {vs_mod.volscore.launches} times")
    for name in ("photometric pass", "geometric pass"):
        sec = tr.time_spent.get(name, float("nan"))
        sweep = tr6.time_spent.get(name, float("nan"))
        log(f"  {name}: {sec:.2f} s, {sec / k:.3f} s per frame (phase 6, the sweep: "
            f"{sweep / n6:.3f} s per frame)")
    check_mvs_outputs(torch, cfg, d_gt[:k], "phase 14 (b)")
    if sorted(first.calls) != ["geometric", "photometric"]:
        fail(f"the stage's passes were not captured: {sorted(first.calls)}")
    for name, (args, kwargs, states, out) in sorted(first.calls.items(), reverse=True):
        for gen, state in states:
            gen.set_state(state)
        t0 = time.time()
        again = mvs.estimate_depth_map(*_restore(args), **_restore(kwargs))
        same = [bool(torch.equal(a, b)) for a, b in zip(again, _restore(out))]
        log(f"frame 0's {name} pass again ({time.time() - t0:.1f} s): depth, normal, "
            f"confidence {'bit-equal' if all(same) else f'DIFFER {same}'}")
        if not all(same):
            fail(f"exact sampling is not reproducible in the {name} pass: {same}")


def run_odometry_options(torch, knn_mod, room_cfg_path, gt, n_scans: int):
    """Phase 14 (c): init_lidar_pose with extraction_method = 2 and
    lidar_ring_repair = true on phase 4's dataset. Checked: the firing-column
    probe (tests/ring_scans.py) repaired on the card to its rings, phase 4's
    artifacts and bounds, one knn and one knn_ring launch per round,
    hysteresis edges in every scan; prints the repaired points. Returns the
    kernel launches."""
    import shutil
    import numpy as np
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.sensors import velodyne as vd
    from ring_scans import probe

    pts, expect = probe()
    p, m = vd.pad_points(pts, 96)
    rings = vd.repair_ring_conflicts(torch.from_numpy(p)[None].cuda(),
                                     torch.from_numpy(m)[None].cuda())[0].cpu().numpy()
    if not np.array_equal(rings[:len(expect)], expect):
        fail(f"ring repair of the probe on the card: {rings[:len(expect)].tolist()} != "
             f"{expect.tolist()}")
    log(f"ring repair of the firing-column probe on the card: {len(expect)} rings as expected")

    root = os.path.dirname(room_cfg_path)
    os.makedirs(os.path.join(root, "result_options", "sfm"))
    shutil.copy(os.path.join(root, "result", "sfm", "lidar_pose.txt"),
                os.path.join(root, "result_options", "sfm", "lidar_pose.txt"))
    cfg_path = os.path.join(root, "config_options.txt")
    with open(cfg_path, "w") as f:
        f.write(f"lidar_path = {root}/lidar\nresult_path = {root}/result_options\n"
                f"lidar_path_undistort = {root}/result_options/undis\n"
                f"data_gap_time = 0.1\n{ROOM_ODOMETRY_KEYS}"
                f"extraction_method = 2\nlidar_ring_repair = true\n")
    infos = []
    torch.cuda.reset_peak_memory_stats()
    knn_mod.knn.launches = 0
    knn_mod.knn_ring.launches = 0
    t0 = time.time()
    with _EveryCall(vd, "combine_edges_hysteresis",
                    lambda a, res: res[0].sum(dim=(1, 2)).cpu()) as hyst, \
            _EveryCall(vd, "repair_ring_conflicts",
                       lambda a, res: int(((res != vd.elevation_ring(a[0])) & (res >= 0))
                                          .sum())) as repair:
        rc = port_main(["init_lidar_pose", cfg_path, "--device", "cuda"], infos=infos)
    wall = time.time() - t0
    launches = {"knn": knn_mod.knn.launches, "knn_ring": knn_mod.knn_ring.launches}
    if rc != 0:
        fail(f"init_lidar_pose with the options exited {rc}")
    edges = torch.cat(hyst.values).numpy()
    log(f"odometry stage, extraction_method 2 + ring repair: wall {wall:.1f} s, peak device "
        f"memory {_peak_gib(torch)}; hysteresis in "
        f"{len(hyst.values)} batches ({sum(hyst.seconds):.2f} s), edge cells per scan min "
        f"{edges.min()}, median {np.median(edges):.0f}; ring repair in "
        f"{len(repair.values)} batches ({sum(repair.seconds):.2f} s), repaired points "
        f"{sum(repair.values)}")
    log(f"kernel launches: {launches} in {len(infos)} association rounds")
    if len(edges) != 2 * n_scans or edges.min() <= 0:
        fail(f"hysteresis edges: {len(edges)} scans extracted (want {2 * n_scans}), "
             f"min {edges.min()}")
    if not repair.values:
        fail("the ring repair did not run")
    if set(launches.values()) != {len(infos)}:
        fail(f"launches {launches} differ from the {len(infos)} association rounds")
    check_odometry_outputs(cfg_path, gt, n_scans)
    return launches


# ----------------------------------------------------------------------------
# phase 15: the stages split over ranks on the one card
# ----------------------------------------------------------------------------

MULTI_SCANS = 128       # phase 4's loop cut to its first 128 scans (cut: the time limit)
# a group's poses against the run without a group: the largest difference
# of a pose parameter, and of a scan position
ODOMETRY_TOL, ODOMETRY_TOL_M = 2e-4, 0.05
JOINT_TOL = 2e-3
RANK_TIMEOUT_S = 300    # a rank waits this long for the others at a collective, then raises
GROUP_DEADLINE_S = 400  # a group's ranks must all have ended by then, or the phase fails


def _rank_body(kind, backend, world, rank, store, arg, out_path):
    """Spawned: rank `rank` of a `world`-rank group (gloo or NCCL, file
    store `store`; "none": one process without a group) on cuda:0, running
    phase 15's `kind` on `arg`; writes its result, wall, kernel launches
    and any jax import to out_path."""
    import datetime
    import pickle
    sys.path[:0] = [HERE]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)   # at most three ranks share the host's cores
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if backend != "none":
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S),
            **({"device_id": dev} if backend == "nccl" else {}))
    try:
        from panovlm_tpu_torch.ops import _build
        from panovlm_tpu_torch.ops import knn as knn_mod
        from panovlm_tpu_torch.ops import volscore as vs_mod
        _build.load()
        knn_mod.knn.launches = knn_mod.knn_ring.launches = vs_mod.volscore.launches = 0
        t0 = time.time()
        out = {"result": _RANK_KINDS[kind](torch, arg)}
        torch.cuda.synchronize()
        out["wall"] = time.time() - t0
        out["launches"] = {"knn": knn_mod.knn.launches, "knn_ring": knn_mod.knn_ring.launches,
                           "volscore": vs_mod.volscore.launches}
        out["leaked"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "jaxlib", "panovlm_tpu"))
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rank_odometry(torch, cfg_path):
    from panovlm_tpu_torch import pipeline
    from panovlm_tpu_torch.config import load_config
    infos = []
    poses, _ = pipeline.init_lidar_pose(load_config(cfg_path), device="cuda", infos=infos)
    return {"poses": poses, "infos": infos}


def _joint_args(torch, path, device):
    """joint_optimize's arguments as phase 10 captured them
    (chiprun_out/joint_chain.npz), on `device`."""
    import numpy as np
    from panovlm_tpu_torch.models import camera_lidar as cl
    z = np.load(path)
    arcs = {k[4:]: torch.from_numpy(z[k]).to(device) for k in z.files if k.startswith("arc_")}
    feats = {k[6:]: torch.from_numpy(z[k]).to(device) for k in z.files
             if k.startswith("lidar_") and k != "lidar_valid" and k != "lidar_poses0"}
    arrays = [z[k] for k in ("cam_poses0", "lidar_poses0", "track_img", "track_feat",
                             "track_mask", "bearings", "points0", "point_ok")]
    return ((arcs, feats, *arrays, cl.JointConfig(**json.loads(str(z["jcfg"])))),
            {"lidar_valid": z["lidar_valid"]})


def _rank_joint(torch, path):
    """joint_optimize on phase 10's arguments, solved as under a group
    (`sharded_solve`), with the group when there is one."""
    from panovlm_tpu_torch.models import camera_lidar as cl
    from panovlm_tpu_torch.parallel import make_mesh
    args, kwargs = _joint_args(torch, path, "cuda")
    args = (*args[:-1], args[-1]._replace(sharded_solve=True))
    cam, lidar, points, infos = cl.joint_optimize(*args, **kwargs, group=make_mesh("cuda"))
    return {"cam": cam.cpu().numpy(), "lidar": lidar.cpu().numpy(),
            "points": points.cpu().numpy(), "infos": infos}


def _rank_mvs(torch, cfg_path):
    from panovlm_tpu_torch import pipeline
    from panovlm_tpu_torch.config import load_config
    depths, confs = pipeline.joint_mvs(load_config(cfg_path), device="cuda")
    return {"depths": depths, "confs": confs}


_RANK_KINDS = {"odometry": _rank_odometry, "joint": _rank_joint, "mvs": _rank_mvs}


def run_ranks(groups, root):
    """Starts every group of `groups` ({(kind, backend): (world, arg)}) at
    once, each rank a spawned process on cuda:0, and waits for all of them
    (GROUP_DEADLINE_S, then every rank is stopped and the phase fails).
    Returns {(kind, backend): [each rank's output]}."""
    import pickle
    ctx = multiprocessing.get_context("spawn")
    procs = {}
    for (kind, backend), (world, arg) in groups.items():
        store = os.path.join(root, f"store_{kind}_{backend}")
        procs[kind, backend] = [ctx.Process(target=_rank_body, args=(
            kind, backend, world, r, store, arg,
            os.path.join(root, f"out_{kind}_{backend}_{r}.pkl"))) for r in range(world)]
    every = [p for ps in procs.values() for p in ps]
    try:
        for p in every:
            p.start()
        t0 = time.time()
        while any(p.is_alive() for p in every):
            if time.time() - t0 > GROUP_DEADLINE_S:
                fail(f"phase 15: ranks still running after {GROUP_DEADLINE_S} s")
            if any(p.exitcode not in (None, 0) for p in every):
                break
            time.sleep(0.5)
        if any(p.exitcode for p in every):
            codes = {k: [p.exitcode for p in ps] for k, ps in procs.items()}
            fail(f"phase 15: a rank failed: exit codes {codes}")
    finally:
        for p in every:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    out = {}
    for (kind, backend), ps in procs.items():
        out[kind, backend] = []
        for r in range(len(ps)):
            with open(os.path.join(root, f"out_{kind}_{backend}_{r}.pkl"), "rb") as f:
                res = pickle.load(f)
            if res["leaked"]:
                fail(f"phase 15: rank {r} of {kind} {backend} imported {res['leaked']}")
            out[kind, backend].append(res)
        walls = ", ".join(f"{o['wall']:.1f}" for o in out[kind, backend])
        log(f"phase 15 {kind} {backend}: walls {walls} s; launches per rank "
            f"{[o['launches'] for o in out[kind, backend]]}")
        for r, o in enumerate(out[kind, backend][1:], 1):
            if _bits(o["result"]) != _bits(out[kind, backend][0]["result"]):
                fail(f"phase 15: rank {r} of the {kind} {backend} group differs from its "
                     "rank 0 (every decision is the group's)")
    return out


def _odometry_variant(src_cfg, root, label):
    """The Room config with its own result and undistort directories, the
    stage-1 poses copied in."""
    import shutil
    res = os.path.join(root, f"result_{label}")
    os.makedirs(os.path.join(res, "sfm"))
    shutil.copy(os.path.join(root, "result", "sfm", "lidar_pose.txt"),
                os.path.join(res, "sfm", "lidar_pose.txt"))
    with open(src_cfg) as f:
        text = f.read()
    path = os.path.join(root, f"config_{label}.txt")
    with open(path, "w") as f:
        f.write(text.replace(f"{root}/result", res))
    return path


def _mvs_variant(root, mvs_cfg_path):
    """Phase 6's MVS config with a result tree and depth maps of its own."""
    src = os.path.dirname(mvs_cfg_path)
    res = os.path.join(root, "mvs_result")
    os.makedirs(os.path.join(res, "joint"))
    for name in ("camera_pose_joint.txt", "lidar_pose_joint.txt"):
        os.symlink(os.path.join(src, "result", "joint", name), os.path.join(res, "joint", name))
    with open(mvs_cfg_path) as f:
        text = f.read()
    cfg_path = os.path.join(root, "mvs_config.txt")
    with open(cfg_path, "w") as f:
        f.write(text.replace(f"result_path = {src}/result", f"result_path = {res}")
                .replace(f"mvs_data_path = {src}/mvs", f"mvs_data_path = {root}/mvs"))
    return cfg_path


def run_multi(torch, knn_mod, root, odo_cfg, odo_gt, sfm_gt, mvs_cfg, k3_launches):
    """Phase 15: the odometry's two runs without a group in this process,
    then every group at once: (a) init_lidar_pose on the first MULTI_SCANS
    scans of the loop, (b) joint_optimize on phase 10's arguments, each on
    2 gloo ranks and 1 NCCL rank, with (b)'s sharded solve without a group
    in a process of its own beside them, (c) joint_mvs on 2 gloo ranks on
    phase 6's dataset; then each sub-phase's checks. Returns {sub-phase:
    {backend: [launches per rank]}}."""
    from panovlm_tpu_torch import pipeline
    from panovlm_tpu_torch.config import load_config

    cfgs = {label: _odometry_variant(odo_cfg, root, label)
            for label in ("plain", "sharded", "gloo", "nccl")}
    single = {}
    for label in ("plain", "sharded"):
        knn_mod.knn.launches = knn_mod.knn_ring.launches = 0
        t0 = time.time()
        infos = []
        poses, _ = pipeline.init_lidar_pose(load_config(cfgs[label]), device="cuda",
                                            infos=infos, sharded_solve=label == "sharded")
        launches = {"knn": knn_mod.knn.launches, "knn_ring": knn_mod.knn_ring.launches}
        single[label] = {"poses": poses, "infos": infos, "launches": launches}
        log(f"phase 15 (a) {label} run: {time.time() - t0:.1f} s, launches {launches}")
    torch.cuda.empty_cache()
    joint_path = os.path.join(HERE, "chiprun_out", "joint_chain.npz")
    mvs15 = _mvs_variant(root, mvs_cfg)
    t0 = time.time()
    out = run_ranks({("odometry", "gloo"): (2, cfgs["gloo"]),
                     ("odometry", "nccl"): (1, cfgs["nccl"]),
                     ("joint", "gloo"): (2, joint_path), ("joint", "nccl"): (1, joint_path),
                     ("joint", "none"): (1, joint_path), ("mvs", "gloo"): (2, mvs15)}, root)
    log(f"phase 15: the five groups and the joint solve without one side by side, "
        f"{time.time() - t0:.1f} s")
    check_multi_odometry(out, cfgs, odo_gt, single)
    check_multi_joint(out, root, joint_path, sfm_gt)
    check_multi_mvs(out, mvs_cfg, mvs15, k3_launches)
    launches = {"odometry": {"sharded, no group": [single["sharded"]["launches"]]}}
    for (kind, backend), ranks in out.items():
        launches.setdefault(kind, {})[backend] = [o["launches"] for o in ranks]
    return launches


def _pose_gap(a, b):
    """(max scan-position difference in m, in deg, max |parameter
    difference|, bit-equal) of two (N, 6) pose arrays."""
    import numpy as np
    from panovlm_tpu_torch.utils import poses as pose_util
    (Ra, ta), (Rb, tb) = pose_util.params_to_world(a), pose_util.params_to_world(b)
    dm = float(np.linalg.norm(ta - tb, axis=1).max())
    ddeg = float(np.degrees(np.arccos(np.clip(
        (np.einsum("nij,nij->n", Ra, Rb) - 1) / 2, -1, 1))).max())
    return dm, ddeg, float(np.abs(a - b).max()), a.tobytes() == b.tobytes()


def check_multi_odometry(out, cfgs, gt, single):
    """Phase 15 (a)'s checks: each run's artifacts and phase 4's bounds; the
    gloo and NCCL groups bit-equal, each within ODOMETRY_TOL of the run
    without a group that solves as they do (`sharded_solve`) and within
    ODOMETRY_TOL_M of the default run in its scan positions; each group's
    K1 and K2 launches, summed over its ranks, the sharded run's."""
    for label in ("sharded", "gloo", "nccl"):
        check_odometry_outputs(cfgs[label], gt, MULTI_SCANS)
    runs = {label: out["odometry", label][0]["result"] for label in ("gloo", "nccl")}
    runs.update(single)
    for label, run in runs.items():
        log(f"phase 15 (a) {label}: per round cost "
            + ", ".join(f"{i['initial_cost']:.9g} -> {i['final_cost']:.9g} "
                        f"({i['iterations']} it)" for i in run["infos"]))
    bad = []
    for a, b in (("gloo", "nccl"), ("gloo", "sharded"), ("nccl", "sharded"),
                 ("gloo", "plain"), ("nccl", "plain")):
        dm, ddeg, dp, same = _pose_gap(runs[a]["poses"], runs[b]["poses"])
        log(f"phase 15 (a) {a} - {b}: max {dm * 1000:.3f} mm, {ddeg:.4f} deg per scan, max "
            f"|difference| of the parameters {dp:.3g}{' (bit-equal)' if same else ''}")
        if b == "nccl" and not same:
            bad.append("the gloo and NCCL groups' poses are not bit-equal")
        if b == "sharded" and not dp <= ODOMETRY_TOL:
            bad.append(f"{a} - {b}: {dp:.3g} > {ODOMETRY_TOL}")
        if not dm < ODOMETRY_TOL_M:
            bad.append(f"{a} - {b}: {dm:.4f} m")
    for label in ("gloo", "nccl"):
        summed = {k: sum(o["launches"][k] for o in out["odometry", label])
                  for k in single["sharded"]["launches"]}
        if summed != single["sharded"]["launches"]:
            bad.append(f"{label} launches {summed} summed over the ranks, the sharded run "
                       f"{single['sharded']['launches']}")
    if bad:
        fail(f"phase 15 (a): {bad}")


def check_multi_joint(out, root, path, gt):
    """Phase 15 (b)'s checks: the gloo and NCCL groups bit-equal, each
    within JOINT_TOL of the same solve without a group and within phase
    10's pose bounds; prints the difference from phase 10's poses."""
    import numpy as np
    from panovlm_tpu_torch.io import artifacts
    from panovlm_tpu_torch.utils import poses as pose_util

    z = np.load(path)
    bound = [JOINT_LIDAR_MARGIN * r for r in JOINT_LIDAR_REF]
    ref = out["joint", "none"][0]["result"]
    bad = []
    for label in ("gloo", "nccl", "none"):
        res = out["joint", label][0]["result"]
        cam_txt, lidar_txt = (os.path.join(root, f"{k}_pose_{label}.txt")
                              for k in ("camera", "lidar"))
        artifacts.export_pose_t(cam_txt, *pose_util.params_to_world(res["cam"]))
        artifacts.export_pose_t(lidar_txt, *pose_util.params_to_world(res["lidar"]))
        rot, dist, all_ok = sfm_pose_errors(cam_txt, gt)
        _, t, _, ok = artifacts.read_pose_t(lidar_txt)
        err = np.abs(np.linalg.norm(np.diff(t, axis=0), axis=1)
                     - np.linalg.norm(np.diff(gt[1], axis=0), axis=1))
        gap = max(float(np.abs(res[k] - ref[k]).max()) for k in ("cam", "lidar"))
        same = _bits(res) == _bits(ref)
        log(f"phase 15 (b) {label}: tiers {sorted({i['tier'] for i in res['infos']})}, LM "
            f"iterations {[int(i['iterations']) for i in res['infos']]}; cameras vs ground truth "
            f"{rot:.4f} deg, {dist * 1000:.2f} mm; LiDAR consecutive-scan distance error max "
            f"{err.max() * 1000:.2f} mm, median {np.median(err) * 1000:.2f} mm (bounds "
            f"{bound[0] * 1000:.2f}, {bound[1] * 1000:.2f} mm); max |{label} - phase 10| cameras "
            f"{np.abs(res['cam'] - z['out_cam']).max():.3g}, LiDAR "
            f"{np.abs(res['lidar'] - z['out_lidar']).max():.3g}; max |{label} - no group| "
            f"{gap:.3g}{' (bit-equal)' if same else ''}")
        if not (all_ok and rot < 1.0 and dist < 0.08):
            bad.append(f"{label} cameras {rot:.3f} deg, {dist:.4f} m")
        if not (ok.all() and err.max() < bound[0] and np.median(err) < bound[1]):
            bad.append(f"{label} LiDAR {err.max():.4f} / {np.median(err):.4f} m")
        if not gap <= JOINT_TOL:
            bad.append(f"{label} {gap:.3g} from the solve without a group")
    gloo, nccl = out["joint", "gloo"][0]["result"], out["joint", "nccl"][0]["result"]
    if _bits(gloo) != _bits(nccl):
        bad.append("the gloo and NCCL groups' results are not bit-equal")
    if bad:
        fail(f"phase 15 (b): {bad}")


def check_multi_mvs(out, mvs_cfg_path, cfg_path, k3_launches):
    """Phase 15 (c)'s checks: every frame's depth, normal and confidence
    artifact of both passes, the filtered depths and the fused cloud
    bit-equal to phase 6's; the ranks' K3 launches sum to phase 6's."""
    from panovlm_tpu_torch.config import load_config

    launches = [o["launches"]["volscore"] for o in out["mvs", "gloo"]]
    if sum(launches) != k3_launches:
        fail(f"phase 15 (c): volscore launches {launches} do not sum to phase 6's {k3_launches}")
    a, b = load_config(mvs_cfg_path), load_config(cfg_path)
    n = 0
    for d_a, d_b in ((a.mvs_depth_path, b.mvs_depth_path), (a.mvs_conf_path, b.mvs_conf_path),
                     (a.mvs_normal_path, b.mvs_normal_path),
                     (a.mvs_result_path, b.mvs_result_path)):
        names = sorted(x for x in os.listdir(d_a) if x.endswith((".npy", ".pcd")))
        if sorted(x for x in os.listdir(d_b) if x.endswith((".npy", ".pcd"))) != names:
            fail(f"phase 15 (c): {d_b} does not hold phase 6's artifacts")
        for name in names:
            with open(os.path.join(d_a, name), "rb") as fa, \
                    open(os.path.join(d_b, name), "rb") as fb:
                if fa.read() != fb.read():
                    fail(f"phase 15 (c): {name} differs from phase 6's")
            n += 1
    log(f"phase 15 (c): {n} artifacts bit-equal to phase 6's (depth, confidence and normal "
        f"of both passes, filtered depth, fused cloud); volscore launches per rank {launches} "
        f"(phase 6: {k3_launches})")


def with_shapes(main, parts, **extra):
    """A kernel's row of the JSON line: the headline shape's numbers, the
    largest error over its shapes and each shape's numbers."""
    return dict(main, max_abs_err=max(r["max_abs_err"] for r in parts), **extra,
                shapes=[{"shape": r["shape"], **{k: r[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "bound_ms_pr3", "bound_ms_pr4") if k in r}}
                    for r in parts])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=454)
    ap.add_argument("--mvs-frames", type=int, default=16)
    ap.add_argument("--mvs-exact-frames", type=int, default=6)
    ap.add_argument("--sfm-frames", type=int, default=48)
    ap.add_argument("--profile-mvs", action="store_true")
    ap.add_argument("--only-sfm", action="store_true")
    ap.add_argument("--only-floor", action="store_true")
    ap.add_argument("--only-joint", action="store_true")
    args = ap.parse_args()
    if args.only_sfm + args.only_floor + args.only_joint > 1:
        fail("--only-sfm, --only-floor and --only-joint exclude each other")
    if not 5 <= args.mvs_exact_frames <= args.mvs_frames:
        fail("--mvs-exact-frames must lie in [5, --mvs-frames]: each frame needs its 4 "
             "neighbours")
    full = not (args.only_sfm or args.only_floor or args.only_joint)   # phases 3-7, 9, 11, 14
    chain = full or args.only_joint                                     # phases 10 and 13

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    if not os.path.isdir(os.path.join(HERE, "panovlm_tpu_torch")):
        fail("panovlm_tpu_torch/ not found: run from a checkout of the repository")
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    t_start = time.time()

    # 1. card; the MVS panoramas render on the host until phase 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    mvs_root = tempfile.TemporaryDirectory(prefix="chip_smoke_mvs_")
    sfm_root = tempfile.TemporaryDirectory(prefix="chip_smoke_sfm_")
    floor_root = tempfile.TemporaryDirectory(prefix="chip_smoke_floor_")
    room_root = tempfile.TemporaryDirectory(prefix="chip_smoke_room_")
    multi_root = tempfile.TemporaryDirectory(prefix="chip_smoke_multi_")
    # a worker per core: the renders, not the build, keep the later phases
    # waiting, and the three nvcc processes share the cores for their minute
    pool = multiprocessing.get_context("spawn").Pool(os.cpu_count() or 4)
    try:
        if not (args.only_sfm or args.only_joint):   # first in the queue: one worker
            floor_async = pool.apply_async(make_room, (floor_root.name, FLOOR_SCANS))
        if full:
            multi_async = pool.apply_async(make_room, (multi_root.name, MULTI_SCANS))
            mvs_cfg, gt_async = start_mvs_dataset(mvs_root.name, args.mvs_frames, pool)
        if not args.only_floor:
            sfm_cfg, sfm_async, sfm_gt = start_sfm_dataset(sfm_root.name, args.sfm_frames,
                                                           pool)

        from panovlm_tpu_torch.device import resolve
        resolve("cuda")
        from panovlm_tpu_torch.ops import _build
        from panovlm_tpu_torch.ops import knn as knn_mod
        from panovlm_tpu_torch.ops import volscore as vs_mod
        from panovlm_tpu_torch.ops.patchmatch import PatchMatchConfig

        # 2. build
        t0 = time.time()
        lib_path = _build.build()
        _build.load()
        log(f"build: {lib_path.relative_to(HERE)} in {time.time() - t0:.1f} s "
            f"(nvcc {'ran' if _build.build_seconds is not None else 'not needed'})")
        regs = {}
        for line in _build.build_log.splitlines():   # ptxas: entry, then its properties
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
                kernel = next(k for k in ("volscore", "knn_desc", "knn") if k in line)
            elif "Used" in line and "registers" in line:
                regs.setdefault(kernel, []).append(int(line.split("Used")[1].split()[0]))
            elif "spill stores" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill"):
                log(f"  spills in {entry}: {line.strip()}")
        for kernel, r in regs.items():
            log(f"  {kernel}: {len(r)} instantiation(s), {min(r)}-{max(r)} registers per thread")

        t0 = time.time()
        if not args.only_floor:
            sfm_d_gt = sfm_async.get(timeout=900)
        if full:
            multi_cfg, multi_gt, _ = multi_async.get(timeout=900)
            d_gt = gt_async.get(timeout=900)
            log(f"MVS dataset: {len(d_gt)} panoramas at 4x {d_gt[0].shape}, gray PNG "
                f"and colour JPEG")
        if not (args.only_sfm or args.only_joint):
            floor_cfg, floor_gt, floor_pts = floor_async.get(timeout=900)
            log(f"Floor dataset: {FLOOR_SCANS} scans of the Room-454 loop, "
                f"{floor_pts:.0f} points/scan")
        pool.close()
        pool.join()
        if not args.only_floor:
            log(f"SfM dataset: {args.sfm_frames} panoramas at {SFM_HW}")
        log(f"datasets ready {time.time() - t0:.1f} s after the build")

        rows, launches, knn_parts, knn_extra = {}, {}, {}, {"knn": {}, "knn_ring": {}}
        if full:
            # 3. kernel vs plain
            rows = knn_vs_plain(torch, knn_mod)
            vrows = volscore_vs_plain(torch, PatchMatchConfig(
                ncc_half_window=3, ncc_step=1, min_depth=0.5, max_depth=5.0,
                sweep_slices=64))

            # 4. the odometry stage
            launches, captured, room_cfg, room_gt = run_odometry(torch, knn_mod,
                                                                 room_root.name, args.scans)

            # 5. K1 and K2 on the stage's own inputs
            t0 = time.time()
            knn_parts = {name: [rows[name], row]
                         for name, row in knn_at_stage(torch, knn_mod, captured).items()}
            del captured
            torch.cuda.empty_cache()
            log(f"phase 5 (K1 and K2 at the stage's inputs): {time.time() - t0:.1f} s")

            # 6. the MVS stage
            launches["volscore"], pm_run, vox, mvs_tr = run_mvs(torch, vs_mod, mvs_cfg, d_gt,
                                                                args.profile_mvs)

            # 7. K3 at the shapes of phase 6
            vrows.update(volscore_vs_plain(torch, pm_run, main_path=True))
            vs_parts = list(vrows.values())

        if not args.only_floor:
            # 8. the SfM stage, then its reproducibility (F8)
            launches["knn_desc"], match_batch, sfm_config, f9_calls, sfm_tr = run_sfm(
                torch, knn_mod, sfm_cfg, sfm_gt)
            sfm_reproducibility(torch, sfm_config)

        if not (args.only_floor or args.only_joint):
            # 8 (b). the SfM stage with the host SIFT, the configs' own key
            t0 = time.time()
            run_sfm_host_sift(torch, knn_mod, sfm_config, sfm_gt,
                              sfm_tr.time_spent.get("extract sift", 0.0))
            log(f"phase 8 (b) (SfM stage with the host SIFT): {time.time() - t0:.1f} s")
            # 8 (c). pair surgery through the CLI; 8 (d). the stage with GPS
            desc_extra = {"launches_surgery": run_pair_surgery(torch, knn_mod, sfm_config,
                                                               sfm_gt, match_batch),
                          "launches_gps": run_sfm_gps(torch, knn_mod, sfm_config, sfm_gt,
                                                      match_batch)}

        if not (args.only_floor or args.only_joint):
            # 9. K1 at D = 128 on the stage's descriptors
            drows = knn_mutual_vs_plain(torch, knn_mod, sfm_config, match_batch)
            rows["knn_desc"] = with_shapes(drows["mutual"], list(drows.values()),
                                           **desc_extra)

        if chain:
            # 10. the odometry and joint stages on the SfM stage's outputs;
            # F9 reruns of the averaging and fuse calls the stages made
            from panovlm_tpu_torch.models import mvs as mvs_mod
            t0 = time.time()
            joint_launches, jargs = run_joint_chain(torch, knn_mod, sfm_cfg, sfm_gt)
            for name, row in knn_at_stage(torch, knn_mod, jargs,
                                          "joint stage, round 0").items():
                knn_parts.setdefault(name, []).append(row)
                knn_extra[name]["launches_joint"] = joint_launches[name]
                launches.setdefault(name, joint_launches[name])
            del jargs
            if full:
                f9_calls["voxel_downsample (MVS fuse)"] = (mvs_mod, vox)
                del vox
            f9_reruns(torch, f9_calls)
            torch.cuda.empty_cache()
            log(f"phase 10 (odometry + joint chain, F9): {time.time() - t0:.1f} s")

        if full:
            # 11. the colorize stage on the MVS dataset's colour JPEGs, then
            # on phase 10's outputs
            t0 = time.time()
            pcd11 = run_colorize_phase(torch, mvs_cfg)
            run_colorize_chain(torch, sfm_cfg)
            log(f"phase 11 (colorize): {time.time() - t0:.1f} s")
            # 16. the image formats: probes, progressive and arithmetic-coded
            # frames through the colorize stage, full-size PNG variants, a
            # lossless frame
            t0 = time.time()
            run_formats_phase(torch, mvs_cfg, pcd11, card=card)
            del pcd11
            t1 = time.time()
            vs_extra_mask = run_mask_phase(torch, vs_mod, mvs_cfg, d_gt)
            log(f"phase 16 (g) (joint_mvs with a mask): {time.time() - t1:.1f} s; "
                f"phase 16 (image formats): {time.time() - t0:.1f} s")

        if chain:
            # 13. the line-track modes and the CALIBRATION mode on phase 10's
            # chain (after phase 11, which reads phase 10's joint poses)
            t0 = time.time()
            torch.cuda.reset_peak_memory_stats()
            track_launches = run_joint_tracks(torch, knn_mod, sfm_cfg, sfm_gt)
            for name in knn_extra:
                knn_extra[name]["launches_joint_tracks"] = track_launches[name]
            torch.cuda.empty_cache()
            log(f"phase 13 (track modes, calibration): {time.time() - t0:.1f} s, peak device "
                f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        if not (args.only_sfm or args.only_joint):
            # 12. the PCG tier: the odometry stage at Floor depth, K1 and K2 on
            # its first round's inputs, translation averaging at Room-454's
            # pair graph
            t0 = time.time()
            floor_launches, fargs = run_floor_odometry(torch, knn_mod, floor_cfg, floor_gt)
            for name, row in knn_at_stage(torch, knn_mod, fargs,
                                          f"Floor-{FLOOR_SCANS} odometry, round 0"
                                          ).items():
                knn_parts.setdefault(name, []).append(row)
                knn_extra[name]["launches_floor"] = floor_launches[name]
                launches.setdefault(name, floor_launches[name])
            del fargs
            torch.cuda.empty_cache()
            log(f"phase 12 (a) (Floor odometry, K1 and K2 at its inputs): "
                f"{time.time() - t0:.1f} s")
            t1 = time.time()
            run_ta_room(torch)
            run_ta_methods(torch)
            log(f"phase 12 (b) (translation averaging at Room-{TA_FRAMES}): "
                f"{time.time() - t1:.1f} s; phase 12 {time.time() - t0:.1f} s")
        if full:
            # 14. the last four options: SfM-point neighbours and exact
            # sampling in joint_mvs, DOUBLE_EXTRACTION and the ring repair in
            # init_lidar_pose
            t0 = time.time()
            option_launches = run_odometry_options(torch, knn_mod, room_cfg, room_gt,
                                                   args.scans)
            for name in knn_extra:
                knn_extra[name]["launches_options"] = option_launches[name]
            torch.cuda.empty_cache()
            log(f"phase 14 (c) (odometry options): {time.time() - t0:.1f} s")
            t1 = time.time()
            run_mvs_exact(torch, vs_mod, mvs_cfg, d_gt, args.mvs_exact_frames, mvs_tr)
            vs_extra = {"launches_exact": vs_mod.volscore.launches,
                        "launches_mask": vs_extra_mask}
            torch.cuda.empty_cache()
            log(f"phase 14 (b) (exact sampling): {time.time() - t1:.1f} s")
            t1 = time.time()
            vs_extra["launches_sfm_neighbours"] = run_mvs_sfm_neighbours(
                torch, vs_mod, sfm_cfg, sfm_d_gt)
            del sfm_d_gt
            log(f"phase 14 (a) (SfM-point neighbours): {time.time() - t1:.1f} s; "
                f"phase 14 {time.time() - t0:.1f} s")
            # 15. the odometry, joint and MVS stages split over ranks on the
            # one card: gloo between ranks on cuda:0, and a 1-rank NCCL group
            t0 = time.time()
            torch.cuda.empty_cache()
            multi = run_multi(torch, knn_mod, multi_root.name, multi_cfg, multi_gt, sfm_gt,
                              mvs_cfg, launches["volscore"])
            log(f"phase 15 (ranks): {time.time() - t0:.1f} s")
            for name in knn_extra:
                knn_extra[name]["launches_ranks"] = {
                    kind: {b: [r[name] for r in ranks] for b, ranks in multi[kind].items()}
                    for kind in ("odometry", "joint")}
            vs_extra["launches_ranks"] = {"mvs": {b: [r["volscore"] for r in ranks]
                                                  for b, ranks in multi["mvs"].items()}}
            rows["knn_desc"]["launches_ranks"] = {}
            rows["volscore"] = with_shapes(vrows["full"], vs_parts, library_ms=None,
                                           **vs_extra)
        for name, parts in knn_parts.items():   # headline: the Room stage's inputs
            rows[name] = with_shapes(parts[1] if full else parts[0], parts,
                                     **knn_extra[name])
    finally:
        pool.terminate()
        pool.join()
        mvs_root.cleanup()
        sfm_root.cleanup()
        floor_root.cleanup()
        room_root.cleanup()
        multi_root.cleanup()

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "panovlm_tpu"))
    if leaked:
        fail(f"jax or the JAX package was imported: {leaked}")
    log(f"whole script {time.time() - t_start:.1f} s")

    src = {"knn": "csrc/knn.cu", "knn_ring": "csrc/knn.cu", "volscore": "csrc/volscore.cu",
           "knn_desc": "csrc/knn_desc.cu"}
    replaces = {"knn": "panovlm_tpu/ops/pallas/knn.py:30",
                "knn_ring": "panovlm_tpu/ops/pallas/knn.py:93",
                "volscore": "panovlm_tpu/ops/pallas/volscore.py:40",
                "knn_desc": "panovlm_tpu/ops/pallas/knn.py:30"}
    log(card)   # as nvidia-smi prints it: name, power limit
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"panovlm_tpu_torch/{src[name]}",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"],
         **{k: r[k] for k in ("launches_joint", "launches_joint_tracks", "launches_floor",
                              "launches_options", "launches_sfm_neighbours",
                              "launches_exact", "launches_mask", "launches_surgery",
                              "launches_gps",
                              "launches_ranks", "shapes") if k in r}}
        for name, r in rows.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
