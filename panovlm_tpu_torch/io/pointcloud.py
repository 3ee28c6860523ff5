"""PCD / PLY point-cloud IO (numpy fast paths; native C++ reader optional).

Replaces pcl::io::loadPCDFile / loadPLYFile as used by Velodyne::LoadLidar
(sensors/Velodyne.cpp:91-127). Supports the subsets those pipelines produce:
binary/ascii PCD with x,y,z[,intensity] float32 fields and binary/ascii PLY
with float vertex properties.

The port's copy of panovlm_tpu/io/pointcloud.py. When the port's native
library (panovlm_tpu_torch/native) builds, its C reader is used for large
binary files; numpy is the fallback.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_PCD_TYPE = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
             ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def lzf_decompress(src: bytes, out_len: int) -> bytes:
    """Decompress an LZF stream (the codec behind PCL's binary_compressed
    PCD bodies). ctrl < 32 is a literal run of ctrl+1 bytes; otherwise a
    back-reference of (ctrl>>5)+2 bytes (+1 extension byte when the 3-bit
    length saturates) at distance ((ctrl&0x1f)<<8)+next+1."""
    out = bytearray(out_len)
    i, o, n = 0, 0, len(src)
    while i < n:
        ctrl = src[i]
        i += 1
        if ctrl < 32:
            cnt = ctrl + 1
            out[o:o + cnt] = src[i:i + cnt]
            i += cnt
            o += cnt
        else:
            length = ctrl >> 5
            if length == 7:
                length += src[i]
                i += 1
            ref = o - (((ctrl & 0x1F) << 8) | src[i]) - 1
            i += 1
            if ref < 0:
                raise ValueError("corrupt LZF stream: reference before start")
            for _ in range(length + 2):  # byte-wise: ranges may overlap
                out[o] = out[ref]
                o += 1
                ref += 1
    if o != out_len:
        raise ValueError(f"corrupt LZF stream: produced {o}, expected {out_len}")
    return bytes(out)


def read_pcd(path: str) -> np.ndarray:
    """Read a PCD file -> (N, C) float32 array (x,y,z[,intensity,...])."""
    with open(path, "rb") as f:
        fields, sizes, types, counts = [], [], [], []
        width = height = points = 0
        data_mode = "ascii"
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            key = key.upper()
            if key == "FIELDS":
                fields = rest.split()
            elif key == "SIZE":
                sizes = [int(x) for x in rest.split()]
            elif key == "TYPE":
                types = rest.split()
            elif key == "COUNT":
                counts = [int(x) for x in rest.split()]
            elif key == "POINTS":
                points = int(rest)
            elif key == "WIDTH":
                width = int(rest)
            elif key == "HEIGHT":
                height = int(rest)
            elif key == "DATA":
                data_mode = rest.strip()
                break
        if not points:
            points = width * max(height, 1)
        if not counts:
            counts = [1] * len(fields)
        dtype = np.dtype([
            (name if name != "_" else f"pad{i}",
             _PCD_TYPE[(t, s)], (c,) if c > 1 else ())
            for i, (name, s, t, c) in enumerate(zip(fields, sizes, types, counts))
        ])
        if data_mode == "ascii":
            body = np.loadtxt(f, dtype=np.float64, max_rows=points)
            body = np.atleast_2d(body)
            out = body.astype(np.float32)
        elif data_mode == "binary":
            raw = np.frombuffer(f.read(dtype.itemsize * points), dtype=dtype, count=points)
            cols = [np.asarray(raw[n.lstrip("pad") if False else n], np.float32).reshape(points, -1)
                    for n in dtype.names if not n.startswith("pad")]
            out = np.concatenate(cols, axis=1)
        elif data_mode == "binary_compressed":
            # PCL layout: u32 compressed size, u32 uncompressed size, LZF
            # stream; decompressed body is field-major (SoA): field c is a
            # contiguous block of points * itemsize(c) bytes.
            comp_sz, uncomp_sz = struct.unpack("<II", f.read(8))
            plain = lzf_decompress(f.read(comp_sz), uncomp_sz)
            cols, off = [], 0
            for name, s, t, c in zip(fields, sizes, types, counts):
                fs = s * c
                blk = np.frombuffer(plain, dtype=f"{_PCD_TYPE[(t, s)]}",
                                    count=points * c, offset=off)
                if name != "_":
                    cols.append(np.asarray(blk, np.float32).reshape(points, c))
                off += points * fs
            out = np.concatenate(cols, axis=1)
        else:
            raise ValueError(f"unknown PCD DATA mode {data_mode}")
    return out


def write_pcd(path: str, xyz: np.ndarray, intensity: np.ndarray | None = None,
              rgb: np.ndarray | None = None, binary: bool = True):
    """Write x,y,z[,intensity][,rgb packed float] PCD (pcl-compatible),
    DATA binary or ascii."""
    n = len(xyz)
    fields = ["x", "y", "z"]
    cols = [np.asarray(xyz, np.float32)]
    if intensity is not None:
        fields.append("intensity")
        cols.append(np.asarray(intensity, np.float32).reshape(n, 1))
    if rgb is not None:
        fields.append("rgb")
        rgb8 = np.asarray(rgb, np.uint32)
        packed = (rgb8[:, 0] << 16) | (rgb8[:, 1] << 8) | rgb8[:, 2]
        cols.append(packed.view(np.float32).reshape(n, 1))
    data = np.concatenate([c.reshape(n, -1) for c in cols], axis=1).astype(np.float32)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * len(fields))}\n"
        f"TYPE {' '.join(['F'] * len(fields))}\n"
        f"COUNT {' '.join(['1'] * len(fields))}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(data.tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


_PLY_TYPE = {"float": "f4", "float32": "f4", "double": "f8", "uchar": "u1",
             "uint8": "u1", "int": "i4", "int32": "i4", "short": "i2",
             "ushort": "u2", "char": "i1", "uint": "u4"}


def read_ply(path: str) -> np.ndarray:
    """Read PLY vertex data -> (N, C) float32 (property order preserved)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        assert magic == b"ply", "not a PLY file"
        fmt = None
        n_vertex = 0
        props = []
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n_vertex = int(line.split()[-1])
            elif line.startswith("element"):
                pass  # faces etc. follow vertices; we only read vertices
            elif line.startswith("property") and n_vertex and "list" not in line:
                _, t, name = line.split()
                props.append((name, _PLY_TYPE[t]))
            elif line == "end_header":
                break
        if fmt == "ascii":
            rows = [f.readline().split()[:len(props)] for _ in range(n_vertex)]
            return np.asarray(rows, np.float32)
        dtype = np.dtype(props)
        if fmt == "binary_big_endian":
            dtype = dtype.newbyteorder(">")
        raw = np.frombuffer(f.read(dtype.itemsize * n_vertex), dtype=dtype, count=n_vertex)
        return np.stack([np.asarray(raw[n], np.float32) for n, _ in props], axis=1)


def load_cloud(path: str) -> np.ndarray:
    """Load .pcd or .ply -> (N, >=3) float32 (Velodyne::LoadLidar entry).
    Uses the port's native C++ reader when it builds."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".pcd", ".ply"):
        raise ValueError(f"unknown point cloud format {ext}, only .ply or .pcd")
    try:
        from ..native import read_cloud_native
        arr = read_cloud_native(path)
        if arr is not None:
            return arr
    except Exception:
        pass
    return read_pcd(path) if ext == ".pcd" else read_ply(path)
