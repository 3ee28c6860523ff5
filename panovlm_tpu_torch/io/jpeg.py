"""JPEG for the port, on a machine without cv2 (ITU-T T.81).

`read_jpeg` decodes as cv2.imread does (libjpeg-turbo at its defaults), bit
for bit, every Huffman-coded 8-bit file (sequential, multi-scan,
progressive; gray, YCbCr, RGB-coded, CMYK, YCCK), through the host C++
decoder `native/jpeg.cpp`. The image stages read the Room and Floor
panoramas and their masks with it.

`encode` / `write_jpeg` are a numpy baseline encoder: the port writes the
SfM stage's depth visualisations as `depth_{i}.jpg`, as the JAX stage does
through cv2.imwrite. Its choices are cv2's defaults: quality 95 (the Annex K quantisation tables
scaled by libjpeg's rule), the standard Huffman tables of Annex K.3, JFIF
YCbCr with 4:2:0 chroma for colour (one component for gray), edge pixels
replicated to whole MCUs. The DCT is the exact float transform; entropy
coding is vectorised: every (zero run, coefficient) becomes one token of at
most 60 bits, and the tokens are packed into the bit stream at once.
"""

from __future__ import annotations

import struct

import numpy as np

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full(64, 99)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# Annex K.3: (code counts per length 1..16, symbol values)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def _zigzag():
    order = sorted(((u + v, u if (u + v) % 2 else v, u, v) for u in range(8) for v in range(8)))
    return np.array([u * 8 + v for _, _, u, v in order])


ZIGZAG = _zigzag()          # zigzag index -> natural (row-major) index


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling applied to an Annex K table."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _huffman_codes(table):
    """(code, length) per symbol value (256 entries) of a (counts, values)
    table, by the canonical assignment of Annex C."""
    counts, values = table
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[values[k]] = code
            len_of[values[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_DCT = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) / 2 * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])
# the 2D DCT of a flattened 8x8 block, rows in zigzag order
_DCT2_ZZ = np.kron(_DCT, _DCT)[ZIGZAG]


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 8, 8)."""
    H, W = plane.shape
    return plane.reshape(H // 8, 8, W // 8, 8).transpose(0, 2, 1, 3)


def _quantized(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Level shift, 2D DCT and quantisation of every 8x8 block:
    (rows, cols, 64) int64 coefficients in zigzag order."""
    blocks = _blocks(plane - 128.0)
    coef = blocks.reshape(*blocks.shape[:2], 64) @ _DCT2_ZZ.T
    return np.round(coef / q[ZIGZAG]).astype(np.int64)


def _size(v):
    """Bit count of |v| (JPEG magnitude category); 0 for 0."""
    a = np.abs(v)
    out = np.zeros(a.shape, np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def _value_bits(v, s):
    return np.where(v >= 0, v, v + (1 << s) - 1)


def _tokens(coefs, dc_table, ac_table):
    """Entropy tokens of a component's blocks, in block order: returns
    (key, bits, nbits) with key = block * 65 + position."""
    n = coefs.shape[0]
    dc_code, dc_len = _huffman_codes(dc_table)
    ac_code, ac_len = _huffman_codes(ac_table)
    dc = coefs[:, 0]
    diff = np.diff(dc, prepend=0)
    s = _size(diff)
    keys = [np.arange(n) * 65]
    bits = [(dc_code[s] << s) | _value_bits(diff, s)]
    nbits = [dc_len[s] + s]
    ac = coefs[:, 1:]
    b, p = np.nonzero(ac)
    p = p + 1                                          # zigzag position 1..63
    v = ac[b, p - 1]
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate([[0], p[:-1]]))
    run = p - prev - 1
    zrl, r = run // 16, run % 16
    s = _size(v)
    sym = r * 16 + s
    tok_len = ac_len[sym] + s
    tok = (ac_code[sym] << s) | _value_bits(v, s)
    zrl_len = ac_len[0xF0] * zrl                       # up to three ZRL codes first
    zrl_bits = np.zeros(len(b), np.int64)
    for k in range(3):
        zrl_bits = np.where(zrl > k, (zrl_bits << ac_len[0xF0]) | ac_code[0xF0], zrl_bits)
    keys.append(b * 65 + p)
    bits.append((zrl_bits << tok_len) | tok)
    nbits.append(zrl_len + tok_len)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, p)
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 65 + 64)
    bits.append(np.full(len(eob), ac_code[0x00]))
    nbits.append(np.full(len(eob), ac_len[0x00]))
    return np.concatenate(keys), np.concatenate(bits), np.concatenate(nbits)


def _pack(bits: np.ndarray, nbits: np.ndarray) -> bytes:
    """Concatenate tokens MSB first, pad with ones, stuff 0x00 after 0xFF."""
    total = int(nbits.sum())
    tok = np.repeat(np.arange(len(bits)), nbits)
    start = np.cumsum(nbits) - nbits
    shift = (nbits[tok] - 1 - (np.arange(total) - start[tok])).astype(np.uint64)
    stream = ((bits[tok].astype(np.uint64) >> shift) & np.uint64(1)).astype(np.uint8)
    stream = np.concatenate([stream, np.ones((-total) % 8, np.uint8)])
    data = np.packbits(stream)
    reps = np.where(data == 0xFF, 2, 1)
    out = np.repeat(data, reps)
    out[np.cumsum(reps)[data == 0xFF] - 1] = 0
    return out.tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def _dht(tc_th: int, table) -> bytes:
    counts, values = table
    return bytes([tc_th]) + bytes(counts) + bytes(values)


def _pad(plane: np.ndarray, H: int, W: int) -> np.ndarray:
    h, w = plane.shape
    return np.pad(plane, ((0, H - h), (0, W - w)), mode="edge")


def quantized_components(img: np.ndarray, quality: int = 95):
    """The components `encode` codes for a uint8 (H, W) gray or (H, W, 3)
    RGB image: dicts of "id", "h", "v", "tq" and "coef", the quantised
    coefficients of the MCU-padded block grid, (rows, cols, 64) in zigzag
    order; and the quantisation tables {slot: 64 values in natural order}."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError("encode: expected uint8 (H, W) or (H, W, 3)")
    h, w = img.shape[:2]
    ql, qc = quant_table(_LUMA_Q, quality), quant_table(_CHROMA_Q, quality)
    if img.ndim == 2:
        H, W = -(-h // 8) * 8, -(-w // 8) * 8
        y = _quantized(_pad(img.astype(np.float64), H, W), ql)
        return [{"id": 1, "h": 1, "v": 1, "tq": 0, "coef": y}], {0: ql}
    H, W = -(-h // 16) * 16, -(-w // 16) * 16
    rgb = img.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    ycc = [0.299 * r + 0.587 * g + 0.114 * b,
           -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0,
           0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0]
    ycc = [_pad(np.clip(np.round(c), 0, 255), H, W) for c in ycc]
    # 4:2:0: each chroma sample is the mean of a 2 x 2 block
    chroma = [c.reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3)) for c in ycc[1:]]
    comps = [{"id": 1, "h": 2, "v": 2, "tq": 0, "coef": _quantized(ycc[0], ql)}]
    comps += [{"id": 2 + i, "h": 1, "v": 1, "tq": 1, "coef": _quantized(c, qc)}
              for i, c in enumerate(chroma)]
    return comps, {0: ql, 1: qc}


def encode(img: np.ndarray, quality: int = 95) -> bytes:
    """JPEG bytes of a uint8 (H, W) gray or (H, W, 3) RGB image."""
    comps, qtables = quantized_components(img, quality)
    h, w = img.shape[:2]
    ql = qtables[0]
    if len(comps) == 1:
        y = comps[0]["coef"]
        keys, bits, nbits = _tokens(y.reshape(-1, 64), _DC_LUMA, _AC_LUMA)
    else:
        qc = qtables[1]
        yq = comps[0]["coef"]                                     # (H/8, W/8, 64)
        H, W = yq.shape[0] * 8, yq.shape[1] * 8
        # MCU order: the 2 x 2 luma blocks of each MCU, then Cb, then Cr
        ymcu = yq.reshape(H // 16, 2, W // 16, 2, 64).transpose(0, 2, 1, 3, 4)
        ymcu = ymcu.reshape(-1, 4, 64)
        cq = [c["coef"].reshape(-1, 64) for c in comps[1:]]
        n_mcu = ymcu.shape[0]
        parts = []
        for comp, (coefs, dc_t, ac_t) in enumerate((
                (ymcu.reshape(-1, 64), _DC_LUMA, _AC_LUMA),
                (cq[0], _DC_CHROMA, _AC_CHROMA), (cq[1], _DC_CHROMA, _AC_CHROMA))):
            k, bt, nb = _tokens(coefs, dc_t, ac_t)
            blk = k // 65
            mcu = blk // 4 if comp == 0 else blk
            slot = blk % 4 if comp == 0 else 3 + comp
            parts.append(((mcu * 6 + slot) * 65 + k % 65, bt, nb))
        keys, bits, nbits = (np.concatenate(x) for x in zip(*parts))
        assert keys.max() < n_mcu * 6 * 65
    comps = [(c["id"], c["h"] * 16 + c["v"], c["tq"]) for c in comps]
    order = np.argsort(keys, kind="stable")
    scan = _pack(bits[order], nbits[order])

    out = [b"\xff\xd8",
           _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
           _segment(0xFFDB, bytes([0]) + bytes(ql[ZIGZAG].tolist())
                    + (bytes([1]) + bytes(qc[ZIGZAG].tolist()) if len(comps) > 1 else b"")),
           _segment(0xFFC0, struct.pack(">BHHB", 8, h, w, len(comps))
                    + b"".join(bytes(c) for c in comps)),
           _segment(0xFFC4, _dht(0x00, _DC_LUMA) + _dht(0x10, _AC_LUMA)
                    + (_dht(0x01, _DC_CHROMA) + _dht(0x11, _AC_CHROMA)
                       if len(comps) > 1 else b"")),
           _segment(0xFFDA, bytes([len(comps)]) + b"".join(
               bytes([c[0], 0x00 if c[2] == 0 else 0x11]) for c in comps) + b"\x00\x3f\x00"),
           scan, b"\xff\xd9"]
    return b"".join(out)


def write_jpeg(path: str, img: np.ndarray, quality: int = 95):
    """Write a uint8 gray or RGB image as a baseline JPEG file."""
    with open(path, "wb") as f:
        f.write(encode(img, quality))


def read_jpeg(path: str, color: bool = False) -> np.ndarray:
    """cv2.imread of a JPEG file: uint8 (H, W) gray, the Y plane of a colour
    file (IMREAD_GRAYSCALE), or (H, W, 3) RGB with color=True (IMREAD_COLOR,
    then BGR -> RGB); turned by the EXIF orientation as imread does.

    Reads every JPEG cv2 reads: baseline, extended and multi-scan
    sequential and progressive files, Huffman- or arithmetic-coded (a
    progressive file cut after any scan with libjpeg's block smoothing),
    with one component, three (YCbCr, or RGB by an Adobe transform 0 or
    ids 'R','G','B') or four (CMYK, YCCK; cv2's CMYK -> BGR / gray
    arithmetic); lossless files with 2- to 8-bit samples in the reads
    libjpeg does without a colour conversion (gray of one component,
    colour of RGB, either of CMYK). Raises native.jpeg.Cv2Refuses (a
    NotImplementedError) where cv2 gives no image: 12-bit, hierarchical
    and 2-component files, lossless arithmetic (SOF11), the other lossless
    reads, a non-integral sampling ratio in a component the read needs;
    ValueError for a corrupt file cv2 gives no image for."""
    from ..native import jpeg as native_jpeg
    with open(path, "rb") as f:
        data = f.read()
    try:
        return native_jpeg.decode(data, color)
    except (NotImplementedError, ValueError) as e:
        raise type(e)(f"{path}: {e}") from None
