"""Stage-file persistence — the checkpoint/resume contract.

Replaces util/FileIO.{h,cpp} (reference): every pipeline stage communicates
through durable artifacts so each stage is independently restartable
(SURVEY.md §5.4). Pose txt = `[name] r00 r01 r02 tx r10 ... tz` storing T_wc
rows (FileIO.cpp:11-191); depth/conf maps are .npy with the reference's
quantization (depth x256 uint16, conf mapped [-1,1] -> [0, 65534] uint16,
FileIO.h:101-131).

The port's copy of the parts of panovlm_tpu/io/artifacts.py that it calls,
the npz blobs (frames, match pairs, tracks) included.
"""

from __future__ import annotations

import os

import numpy as np


# ----------------------------------------------------------------------------
# pose txt (T_wc rows)
# ----------------------------------------------------------------------------

def export_pose_t(path, R_wc_list, t_wc_list, names=None):
    """ExportPoseT (FileIO.cpp:168-191)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i in range(len(R_wc_list)):
            R = np.asarray(R_wc_list[i], np.float64)
            t = np.asarray(t_wc_list[i], np.float64)
            row = []
            if names is not None:
                row.append(str(names[i]))
            for r in range(3):
                row += [f"{R[r, 0]:.17g}", f"{R[r, 1]:.17g}",
                        f"{R[r, 2]:.17g}", f"{t[r]:.17g}"]
            f.write(" ".join(row) + "\n")


def read_pose_t(path, with_invalid: bool = True):
    """ReadPoseT (FileIO.cpp:11-90). Returns (R (N,3,3), t (N,3), names,
    valid (N,)); invalid rows (inf/nan) give identity R, inf t."""
    Rs, ts, names, valid = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            name = ""
            if len(parts) == 13:
                name = parts[0]
                parts = parts[1:]
            if len(parts) != 12:
                continue
            ok = not any(("inf" in p or "nan" in p) for p in parts)
            if ok:
                vals = np.array([float(p) for p in parts]).reshape(3, 4)
                Rs.append(vals[:, :3])
                ts.append(vals[:, 3])
            else:
                Rs.append(np.zeros((3, 3)))
                ts.append(np.full(3, np.inf))
                if not with_invalid:
                    Rs.pop(); ts.pop()
                    continue
            names.append(name)
            valid.append(ok)
    return (np.asarray(Rs), np.asarray(ts), names, np.asarray(valid, bool))


# ----------------------------------------------------------------------------
# depth / normal / conf maps (reference quantization conventions)
# ----------------------------------------------------------------------------

def export_depth_u16(path, depth, scale: float = 256.0):
    """CV_16U fixed-point x256 depth (sfm/SfM.cpp:216-220)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    q = np.clip(np.asarray(depth, np.float64) * scale, 0, 65535).astype(np.uint16)
    np.save(path, q)


def read_depth_u16(path, scale: float = 256.0):
    return np.load(path).astype(np.float32) / scale


def export_conf_u16(path, conf):
    """conf [-1,1] -> uint16 (FileIO.h ExportConfMap)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    q = np.clip((np.asarray(conf, np.float64) + 1.0) * 32767, 0, 65535)
    np.save(path, q.astype(np.uint16))


def read_conf_u16(path):
    return np.load(path).astype(np.float32) / 32767.0 - 1.0


# ----------------------------------------------------------------------------
# npz blobs (frames / match pairs / tracks — replaces boost binary)
# ----------------------------------------------------------------------------

def save_npz(path, **arrays):
    """Compressed npz, written atomically (tmp + rename): caches are
    rewritten mid-run and a kill must not leave a truncated file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def save_npz_raw(path, **arrays):
    """Uncompressed npz for the large float caches (descriptors), atomic."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_npz(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load_npz_or_none(path):
    """A missing or unreadable cache is a cache miss, never an abort."""
    import logging
    if not os.path.exists(path):
        return None
    try:
        return load_npz(path)
    except Exception as e:  # zipfile.BadZipFile, OSError, ValueError
        logging.getLogger("panovlm").warning(
            "unreadable cache %s (%s) — recomputing", path, e)
        return None


def export_point_tracks(path, track_img, track_feat, track_mask, points,
                        point_ok, colors=None):
    """ExportPointTracks analog (points.bin -> points.npz)."""
    arrays = dict(track_img=track_img, track_feat=track_feat,
                  track_mask=track_mask, points=points, point_ok=point_ok)
    if colors is not None:
        arrays["colors"] = colors
    save_npz(path, **arrays)


def read_point_tracks(path) -> dict:
    return load_npz(path)
