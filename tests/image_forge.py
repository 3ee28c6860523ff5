"""Image files that cv2 and PIL do not write, made from numpy
arrays with numpy and zlib only (no cv2, no PIL): chip_smoke.py imports it
on the card's machine.

PNG (`png_bytes`): every colour type and bit depth of the specification,
Adam7 interlacing, any row filter (or all five in turn), extra chunks
(tRNS, gAMA, sRGB, sBIT, eXIf), IDAT split over several chunks.

JPEG (`jpeg_bytes`): a writer of quantised DCT coefficients, so that one
set of coefficients can be coded as a baseline file, as sequential scans
that each carry a subset of the components (non-interleaved), or as a
progressive script with spectral selection and successive approximation
(T.81 Annex G; EOB runs in the refinement scans, one EOB per block in the
first ones), with restart intervals; Huffman tables are optimised per scan
(Annex K.2, as libjpeg's jpeg_gen_optimal_table). With arithmetic=True
the same scans are arithmetic-coded (SOF9 / SOF10, DAC conditioning) by
`arith_forge.cpp` beside this file, built with g++ at first use into
build/native/. `port_components` gives the coefficients that
`io/jpeg.encode` codes, so that a re-coding of a baseline file from the
port's encoder decodes to the same bits; `plane_components` quantises any
set of planes (YCCK, RGB-coded). `lossless_bytes` writes lossless (SOF3)
files of sample planes.

BMP (`bmp_bytes`): OS/2, INFO, V4 and V5 headers, 1 to 32 bits, short
palettes, BI_BITFIELDS masks, RLE8 / RLE4 (`rle_codes`: runs, absolute
runs, deltas over index-0 pixels, end of line and of bitmap), top-down
rows. PxM (`pnm_bytes`: P1-P6, ASCII or binary, any maxval, comments),
PAM (`pam_bytes`), PFM (`pfm_bytes`) and Sun raster (`sun_bytes`: any
type, map type and depth, RT_BYTE_ENCODED's 0x80 escapes).

GIF (`gif_bytes`, built from `gif_screen`, `gif_gce`, `gif_extension` and
`gif_image`): 87a or 89a, global and local palettes of 2 to 256 entries or
none, a background index, frames at offsets, interlaced rows, graphic
control extensions (transparency, disposal), any extension, several
frames; LZW (`gif_lzw`) with any minimum code size, a clear code when the
table is full or a deferred clear, or any list of codes (`gif_pack`, each
as wide as the decoder's table makes it), in sub-blocks of any size.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path

import numpy as np

from panovlm_tpu_torch.io import jpeg

# ----------------------------------------------------------------------------
# PNG
# ----------------------------------------------------------------------------

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}            # colour type -> samples
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) integer samples -> (h, rowbytes) uint8, MSB first."""
    h, w, c = samples.shape
    if depth == 16:
        s = samples.astype(">u2").reshape(h, w * c)
        return s.view(np.uint8).reshape(h, 2 * w * c)
    if depth == 8:
        return samples.reshape(h, w * c).astype(np.uint8)
    bits = samples.reshape(h, w * c).astype(np.uint8)
    per = 8 // depth
    n = -(-w * c // per) * per
    padded = np.zeros((h, n), np.uint8)
    padded[:, :w * c] = bits
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    return (padded.reshape(h, -1, per) << shifts).sum(axis=2, dtype=np.uint16).astype(np.uint8)


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """PNG row filtering of (h, rowbytes) uint8: `filters` is a type 0-4
    for every row, "cycle" (type y % 5 on row y) or a sequence per row."""
    h, n = rows.shape
    if h == 0 or n == 0:
        return b""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp] if n > bpp else 0
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[:, bpp:] = b[:, :-bpp] if n > bpp else 0
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, paeth)
    if isinstance(filters, str):
        kinds = np.arange(h) % 5
    elif np.ndim(filters) == 0:
        kinds = np.full(h, int(filters))
    else:
        kinds = np.asarray(filters)[:h]
    out = np.empty((h, n + 1), np.uint8)
    out[:, 0] = kinds
    for f in range(5):
        sel = kinds == f
        out[sel, 1:] = ((x[sel] - preds[f][sel]) & 0xFF).astype(np.uint8)
    return out.tobytes()


def png_raw(samples, ctype: int, depth: int, interlace: bool = False, filters="cycle") -> bytes:
    """The filtered (uncompressed) image data of a PNG."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    bpp = max(1, CHANNELS[ctype] * depth // 8)
    if not interlace:
        return _filter_rows(_pack_rows(s, depth), bpp, filters)
    out = []
    for x0, y0, dx, dy in ADAM7:
        sub = s[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:
            out.append(_filter_rows(_pack_rows(sub, depth), bpp, filters))
    return b"".join(out)


def png_bytes(samples, ctype: int, depth: int, interlace: bool = False, filters="cycle",
              palette=None, trns: bytes | None = None, pre: tuple = (), post: tuple = (),
              level: int = 6, idat_chunks: int = 1) -> bytes:
    """A PNG file of integer `samples` ((h, w) or (h, w, c) at `depth`;
    palette indices for colour type 3). `palette` (n, 3) uint8 goes in a
    PLTE chunk, `trns` is the tRNS body; `pre` holds (kind, body) chunks
    written before PLTE (gAMA, sRGB, sBIT, ...) and `post` chunks written
    after IDAT (eXIf may go either side)."""
    s = np.asarray(samples)
    h, w = s.shape[:2]
    out = [PNG_MAGIC, chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                 int(interlace)))]
    out += [chunk(k, b) for k, b in pre]
    if palette is not None:
        out.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        out.append(chunk(b"tRNS", trns))
    data = zlib.compress(png_raw(s, ctype, depth, interlace, filters), level)
    step = -(-len(data) // idat_chunks)
    out += [chunk(b"IDAT", data[i:i + step]) for i in range(0, len(data), step)] or \
        [chunk(b"IDAT", data)]
    out += [chunk(k, b) for k, b in post]
    out.append(chunk(b"IEND", b""))
    return b"".join(out)


def gama(gamma: float) -> tuple:
    return (b"gAMA", struct.pack(">I", int(round(gamma * 100000))))


def random_samples(h: int, w: int, ctype: int, depth: int, seed: int, n_palette: int = 0):
    """Seeded samples that use the whole range of the depth, with smooth
    structure and runs of equal values (so that every filter and, for RGB,
    the r == g == b case of libpng's gray conversion occur)."""
    rng = np.random.default_rng(seed)
    c = CHANNELS[ctype]
    top = (n_palette if ctype == 3 else 1 << depth) - 1
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    smooth = (0.5 + 0.5 * np.sin(yy / 3.0 + np.arange(c)[:, None, None])
              * np.cos(xx / 5.0)).transpose(1, 2, 0)
    s = np.round(smooth * top).astype(np.int64)
    noise = rng.integers(0, top + 1, (h, w, c))
    pick = rng.random((h, w, 1)) < 0.3
    s = np.where(pick, noise, s)
    if c >= 3:                                        # some gray pixels
        g = rng.random((h, w)) < 0.2
        s[g, 1] = s[g, 0]
        s[g, 2] = s[g, 0]
    s = np.clip(s, 0, top)
    return s[..., 0] if c == 1 else s


# ----------------------------------------------------------------------------
# JPEG
# ----------------------------------------------------------------------------

def _category(v):
    """Bit count of |v| (JPEG magnitude category), 0 for 0."""
    a = np.abs(np.asarray(v, np.int64))
    out = np.zeros(a.shape, np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def _extra(v, s):
    """The s low bits that follow a category-s symbol for value v."""
    return np.where(v >= 0, v, v + (1 << s) - 1) & ((1 << s) - 1)


class _Tokens:
    """A scan's output in order: (mcu, key) sort keys, Huffman table (-1:
    raw bits), symbol, extra bits and their count."""

    def __init__(self):
        self.parts = []

    def add(self, mcu, key, table, sym, extra, elen):
        n = len(np.atleast_1d(mcu))
        self.parts.append([np.broadcast_to(np.asarray(x, np.int64), (n,)).copy()
                           for x in (mcu, key, table, sym, extra, elen)])

    def arrays(self):
        if not self.parts:
            return [np.zeros(0, np.int64)] * 6
        cols = [np.concatenate(c) for c in zip(*self.parts)]
        order = np.lexsort((cols[1], cols[0]))
        return [c[order] for c in cols]


def _block_order(comp, scan_comps, mcux, one):
    """(mcu index, slot in the MCU) of each block a scan codes of `comp`,
    and the blocks' (row, col): the component's own blocks for a
    one-component scan, the MCU grid otherwise."""
    if one:
        by, bx = np.meshgrid(np.arange(comp["bh"]), np.arange(comp["bw"]), indexing="ij")
        by, bx = by.ravel(), bx.ravel()
        return by * comp["bw"] + bx, np.zeros_like(by), by, bx
    by, bx = np.meshgrid(np.arange(comp["pbh"]), np.arange(comp["pbw"]), indexing="ij")
    by, bx = by.ravel(), bx.ravel()
    offset = 0
    for c in scan_comps:
        if c is comp:
            break
        offset += c["h"] * c["v"]
    mcu = (by // comp["v"]) * mcux + bx // comp["h"]
    slot = offset + (by % comp["v"]) * comp["h"] + bx % comp["h"]
    order = np.lexsort((slot, mcu))
    return mcu[order], slot[order], by[order], bx[order]


def _shift_ac(v, al):
    """The encoder's point transform of AC values: magnitude >> Al, sign kept."""
    return np.sign(v) * (np.abs(v) >> al)


def _dc_tokens(tok, values, mcu, key, table, restart):
    """DC differences along the scan order, the predictor reset at each
    restart interval."""
    interval = mcu // restart if restart else np.zeros_like(mcu)
    prev = np.concatenate([[0], values[:-1]])
    first = np.ones(len(values), bool)
    first[1:] = interval[1:] != interval[:-1]
    diff = values - np.where(first, 0, prev)
    s = _category(diff)
    tok.add(mcu, key, table, s, _extra(diff, s), s)


def _band_tokens(tok, vals, mcu, key0, table):
    """AC-first tokens of (blocks, band) values with no EOB runs: ZRLs, one
    symbol per nonzero value and an EOB (symbol 0) after the last."""
    n, L = vals.shape
    b, p = np.nonzero(vals)
    v = vals[b, p]
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, -1, np.concatenate([[0], p[:-1]]))
    run = p - prev - 1
    zrl = run // 16
    for k in range(int(zrl.max()) if len(zrl) else 0):
        sel = zrl > k
        tok.add(mcu[b[sel]], key0[b[sel]] + p[sel] * 4 + k, table, 0xF0, 0, 0)
    s = _category(v)
    tok.add(mcu[b], key0[b] + p * 4 + 3, table, (run % 16) * 16 + s, _extra(v, s), s)
    last = np.full(n, -1)
    np.maximum.at(last, b, p)
    eob = np.nonzero(last < L - 1)[0]
    tok.add(mcu[eob], key0[eob] + L * 4, table, 0, 0, 0)


def _eob_symbol(run):
    r = int(run).bit_length() - 1
    return r * 16, run - (1 << r), r


def _refine_tokens(tok, blocks, mcu, key0, table, ss, se, al, restart):
    """AC refinement tokens of one component, with EOB runs and the
    correction bits held as libjpeg's encoder (jcphuff.c
    encode_mcu_AC_refine) holds them."""
    out = []                    # (mcu, key, table, sym, extra, elen)
    eobrun, held, anchor = 0, [], None

    def flush():
        nonlocal eobrun, held
        if eobrun:
            sym, ext, n = _eob_symbol(eobrun)
            m, k = anchor
            out.append((m, k, table, sym, ext, n))
            out.extend((m, k + 1 + i, -1, bit, bit, 1) for i, bit in enumerate(held))
        eobrun, held = 0, []

    for i in range(len(blocks)):
        if restart and i and mcu[i] % restart == 0 and mcu[i] != mcu[i - 1]:
            flush()
        blk = blocks[i]
        absv = [abs(int(blk[k])) >> al for k in range(ss, se + 1)]
        last_new = max([j for j, a in enumerate(absv) if a == 1], default=-1)
        seq, r, corr = [], 0, []   # this block's (symbol or -1 for a raw bit, extra, length)
        for j, a in enumerate(absv):
            if a == 0:
                r += 1
                continue
            while r > 15 and j <= last_new:
                seq.append((0xF0, 0, 0))
                seq.extend((-1, bit, 1) for bit in corr)
                corr = []
                r -= 16
            if a > 1:
                corr.append(a & 1)
                continue
            seq.append((r * 16 + 1, 0, 0))
            seq.append((-1, 0 if blk[ss + j] < 0 else 1, 1))
            seq.extend((-1, bit, 1) for bit in corr)
            corr, r = [], 0
        if seq:
            flush()
        m, base = int(mcu[i]), int(key0[i])
        for j, (sym, ext, n) in enumerate(seq):
            out.append((m, base + j, table, sym, ext, n) if sym >= 0 else
                       (m, base + j, -1, ext, ext, n))
        if r > 0 or corr:
            if eobrun == 0:
                anchor = (m, base + len(seq))
            eobrun += 1
            held.extend(corr)
            if eobrun == 0x7FFF or len(held) > 937:
                flush()
    flush()
    if out:
        tok.add(*[np.array(c, np.int64) for c in zip(*out)])


def _huffman_table(freq):
    """libjpeg's jpeg_gen_optimal_table: (counts per length 1..16, values)."""
    freq = list(freq) + [1]               # the reserved all-ones code
    size, others = [0] * 257, [-1] * 257
    while True:
        c1 = c2 = -1
        v = None
        for i in range(257):
            if freq[i] and (v is None or freq[i] <= v):
                v, c1 = freq[i], i
        v = None
        for i in range(257):
            if freq[i] and i != c1 and (v is None or freq[i] <= v):
                v, c2 = freq[i], i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        size[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            size[c1] += 1
        others[c1] = c2
        size[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            size[c2] += 1
    bits = [0] * 33
    for s in size:
        if s:
            bits[s] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    values = [j for length in range(1, 33) for j in range(256) if size[j] == length]
    return bits[1:17], values


def _scan_bytes(cols, tables, restart):
    """Huffman-code a scan's sorted tokens; RSTn markers between restart
    intervals."""
    mcu, _, table, sym, extra, elen = cols
    codes = {t: jpeg._huffman_codes(tables[t]) for t in tables}
    bits = extra.copy()
    nbits = elen.copy()
    for t, (code_of, len_of) in codes.items():
        sel = table == t
        bits[sel] = (code_of[sym[sel]] << elen[sel]) | extra[sel]
        nbits[sel] = len_of[sym[sel]] + elen[sel]
    if not restart:
        return jpeg._pack(bits, nbits)
    interval = mcu // restart
    out = []
    for i, k in enumerate(np.unique(interval)):
        sel = interval == k
        if i:
            out.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
        out.append(jpeg._pack(bits[sel], nbits[sel]))
    return b"".join(out)


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


_arith_lib = None
_arith_lock = threading.Lock()


def _arith():
    """arith_forge.cpp through ctypes, built on first use."""
    global _arith_lib
    with _arith_lock:
        if _arith_lib is None:
            from panovlm_tpu_torch.native import compile_library
            lib = ctypes.CDLL(str(compile_library(Path(__file__).resolve().parent
                                                  / "arith_forge.cpp")))
            lib.pv_arith_scan.restype = ctypes.c_long
            lib.pv_arith_scan.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + \
                [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4 + [ctypes.c_long]
            _arith_lib = lib
    return _arith_lib


def _arith_scan(sc, kind, ss, se, ah, al, mcux, mcuy, restart, cond) -> bytes:
    """One arithmetic-coded scan of components sc (table slot = place in
    the scan), as arith_forge.cpp codes it."""
    code = {"seq": 0, "dc": 1 if ah == 0 else 2, "ac": 3 if ah == 0 else 4}[kind]
    coefs = [np.ascontiguousarray(c["coef"], np.int16) for c in sc]
    ptrs = (ctypes.c_void_p * len(sc))(*[c.ctypes.data for c in coefs])
    geom = np.array([[c["h"], c["v"], c["bw"], c["bh"], c["pbw"], i, i]
                     for i, c in enumerate(sc)], np.int32)
    cap = 4096 + 2 * sum(c.nbytes for c in coefs)
    out = np.empty(cap, np.uint8)
    n = _arith().pv_arith_scan(len(sc), ptrs, geom.ctypes.data, mcux, mcuy, code, ss, se, al,
                               restart, *(t.ctypes.data for t in cond), out.ctypes.data, cap)
    assert n >= 0
    return out[:n].tobytes()


def jpeg_bytes(components, width: int, height: int, qtables, scans, restart: int = 0,
               progressive: bool | None = None, jfif: bool = True, adobe: int | None = None,
               app: tuple = (), arithmetic: bool = False, dac=None) -> bytes:
    """A JPEG file of quantised coefficients.

    components: dicts with "id", "h", "v", "tq" and "coef", the (pbh, pbw,
    64) zigzag-order coefficients of the MCU-padded block grid. qtables:
    {slot: 64 values in natural order}. scans: ("seq", [component
    indices]) for a sequential scan of coefficients 0-63, ("dc", [indices],
    Ah, Al) and ("ac", index, Ss, Se, Ah, Al) for progressive ones; a
    progressive file when any scan is not "seq" (or `progressive`).
    `adobe` writes an APP14 with that transform; `app` holds whole extra
    segments written after SOI. arithmetic: SOF9 / SOF10 and arithmetic-
    coded scans, conditioned by `dac` = {"dc": {slot: (L, U)}, "ac":
    {slot: Kx}} (written as a DAC segment; other slots keep L = 0, U = 1,
    Kx = 5)."""
    comps = [dict(c) for c in components]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    for c in comps:
        c["pbw"], c["pbh"] = mcux * c["h"], mcuy * c["v"]
        c["bw"] = -(-(-(-width * c["h"] // hmax)) // 8)
        c["bh"] = -(-(-(-height * c["v"] // vmax)) // 8)
        assert c["coef"].shape == (c["pbh"], c["pbw"], 64), (c["coef"].shape, c["pbh"], c["pbw"])
    if progressive is None:
        progressive = any(s[0] != "seq" for s in scans)
    head = [b"\xff\xd8", *app]
    if jfif:
        head.append(_segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    if adobe is not None:
        head.append(_segment(0xFFEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe)))
    head.append(_segment(0xFFDB, b"".join(
        bytes([t]) + bytes(np.asarray(q)[jpeg.ZIGZAG].astype(np.uint8).tolist())
        for t, q in sorted(qtables.items()))))
    sof = (0xFFCA if progressive else 0xFFC9) if arithmetic else \
        (0xFFC2 if progressive else 0xFFC0)
    head.append(_segment(sof, struct.pack(">BHHB", 8, height, width, len(comps)) + b"".join(
        bytes([c["id"], c["h"] * 16 + c["v"], c["tq"]]) for c in comps)))
    cond = (np.zeros(16, np.uint8), np.ones(16, np.uint8), np.full(16, 5, np.uint8))
    if dac:
        for t, (lo, up) in dac.get("dc", {}).items():
            cond[0][t], cond[1][t] = lo, up
        for t, k in dac.get("ac", {}).items():
            cond[2][t] = k
        head.append(_segment(0xFFCC, b"".join(
            [bytes([t, up * 16 + lo]) for t, (lo, up) in dac.get("dc", {}).items()]
            + [bytes([16 + t, k]) for t, k in dac.get("ac", {}).items()])))
    if restart:
        head.append(_segment(0xFFDD, struct.pack(">H", restart)))
    body = []
    for scan in scans:
        kind = scan[0]
        idx = scan[1] if kind != "ac" else [scan[1]]
        sc = [comps[i] for i in idx]
        one = len(sc) == 1
        ss, se, ah, al = ((0, 63, 0, 0) if kind == "seq" else
                          (0, 0) + tuple(scan[2:4]) if kind == "dc" else tuple(scan[2:6]))
        if arithmetic:
            body.append(_segment(0xFFDA, bytes([len(sc)]) + b"".join(
                bytes([c["id"], slot * 16 + slot]) for slot, c in enumerate(sc))
                + bytes([ss, se, ah * 16 + al])))
            body.append(_arith_scan(sc, kind, ss, se, ah, al, mcux, mcuy, restart, cond))
            continue
        tok = _Tokens()
        for slot, c in enumerate(sc):
            mcu, bslot, by, bx = _block_order(c, sc, mcux, one)
            blocks = c["coef"][by, bx]
            key0 = bslot * 1000
            if kind == "seq":
                _dc_tokens(tok, blocks[:, 0], mcu, key0, slot, restart)
                _band_tokens(tok, blocks[:, 1:], mcu, key0 + 4, 4 + slot)
            elif kind == "dc":
                ah, al = scan[2], scan[3]
                if ah == 0:
                    _dc_tokens(tok, blocks[:, 0] >> al, mcu, key0, slot, restart)
                else:
                    bit = (blocks[:, 0] >> al) & 1
                    tok.add(mcu, key0, -1, 0, bit, 1)
            else:
                ss, se, ah, al = scan[2:]
                if ah == 0:
                    vals = _shift_ac(blocks[:, ss:se + 1], al)
                    _band_tokens(tok, vals, mcu, key0 + 4 * ss, 4 + slot)
                else:
                    _refine_tokens(tok, blocks, mcu, key0, 4 + slot, ss, se, al, restart)
        cols = tok.arrays()
        tables = {}
        for t in np.unique(cols[2]):
            if t < 0:
                continue
            freq = np.bincount(cols[3][cols[2] == t], minlength=256)
            tables[int(t)] = _huffman_table(freq.tolist())
        if tables:
            body.append(_segment(0xFFC4, b"".join(
                bytes([(16 if t >= 4 else 0) + t % 4]) + bytes(counts) + bytes(values)
                for t, (counts, values) in sorted(tables.items()))))
        ss, se, ahal = ((0, 63, 0) if kind == "seq" else
                        (0, 0, scan[2] * 16 + scan[3]) if kind == "dc" else
                        (scan[2], scan[3], scan[4] * 16 + scan[5]))
        body.append(_segment(0xFFDA, bytes([len(sc)]) + b"".join(
            bytes([c["id"], slot * 16 + slot]) for slot, c in enumerate(sc))
            + bytes([ss, se, ahal])))
        body.append(_scan_bytes(cols, tables, restart))
    return b"".join(head + body + [b"\xff\xd9"])


# the progressive script of libjpeg's jpeg_simple_progression for three
# components (YCbCr) and for one
SIMPLE_PROGRESSION_3 = (
    ("dc", [0, 1, 2], 0, 1), ("ac", 0, 1, 5, 0, 2), ("ac", 2, 1, 63, 0, 1),
    ("ac", 1, 1, 63, 0, 1), ("ac", 0, 6, 63, 0, 2), ("ac", 0, 1, 63, 2, 1),
    ("dc", [0, 1, 2], 1, 0), ("ac", 2, 1, 63, 1, 0), ("ac", 1, 1, 63, 1, 0),
    ("ac", 0, 1, 63, 1, 0))
SIMPLE_PROGRESSION_1 = (
    ("dc", [0], 0, 1), ("ac", 0, 1, 5, 0, 2), ("ac", 0, 6, 63, 0, 2),
    ("ac", 0, 1, 63, 2, 1), ("dc", [0], 1, 0), ("ac", 0, 1, 63, 1, 0))


def spectral_script(n_comps: int):
    """A progressive script without AC refinement (each scan vectorised):
    DC first at Al = 1 (interleaved), two AC bands per component, the DC
    refinement last."""
    script = [("dc", list(range(n_comps)), 0, 1)]
    for c in range(n_comps):
        script += [("ac", c, 1, 5, 0, 0), ("ac", c, 6, 63, 0, 0)]
    return tuple(script + [("dc", list(range(n_comps)), 1, 0)])


def port_components(img: np.ndarray, quality: int = 95):
    """The components, quantisation tables and size that io/jpeg.encode
    codes for a uint8 gray or RGB image (its coefficients, bit for bit)."""
    comps, qtables = jpeg.quantized_components(img, quality)
    return comps, qtables, img.shape[1], img.shape[0]


def plane_components(planes, sampling, quality: int = 90, ids=None):
    """Components of uint8 planes (full size, each in the colour space it is
    coded in), quantised with the Annex K luma table (component 0) and
    chroma table (others) at `quality`; sampling: (h, v) per plane, each
    plane averaged over its sampling ratio, edges replicated to the MCU."""
    h, w = planes[0].shape
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    q = {0: jpeg.quant_table(jpeg._LUMA_Q, quality), 1: jpeg.quant_table(jpeg._CHROMA_Q, quality)}
    comps = []
    for i, (p, (sh, sv)) in enumerate(zip(planes, sampling)):
        fh, fv = hmax // sh, vmax // sv
        H, W = mcuy * 8 * vmax, mcux * 8 * hmax
        full = np.pad(np.asarray(p, np.float64), ((0, H - h), (0, W - w)), mode="edge")
        sub = full.reshape(H // fv, fv, W // fh, fh).mean(axis=(1, 3))
        tq = 0 if i == 0 else 1
        coef = jpeg._quantized(sub, q[tq])
        comps.append({"id": ids[i] if ids else i + 1, "h": sh, "v": sv, "tq": tq, "coef": coef})
    return comps, q


# ----------------------------------------------------------------------------
# lossless JPEG (T.81 Annex H)
# ----------------------------------------------------------------------------

LOSSLESS_PREDICTORS = range(1, 8)


def _lossless_prediction(x: np.ndarray, predictor: int, first: np.ndarray, initial: int):
    """The prediction of each sample of (rows, cols) int64 samples: a row
    flagged `first` (the image's first and each restart interval's) is
    predicted from its left neighbour and `initial`; the first column of
    the others from the sample above; the rest by `predictor` from Ra
    (left), Rb (above) and Rc (above left)."""
    pred = np.empty_like(x)
    pred[:, 1:] = x[:, :-1]
    pred[:, 0] = initial
    if x.shape[0] > 1:
        ra, rb, rc = x[1:, :-1], x[:-1, 1:], x[:-1, :-1]
        rest = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
        other = np.concatenate([x[:-1, :1], rest], axis=1)
        pred[1:] = np.where(first[1:, None], pred[1:], other)
    return pred


def lossless_bytes(planes, width: int, height: int, sampling=None, precision: int = 8,
                   predictor: int = 1, pt: int = 0, restart: int = 0, scans=None, ids=None,
                   jfif: bool = False, adobe: int | None = None, sof: int = 0xC3) -> bytes:
    """A lossless (SOF3) file of integer sample planes, Huffman-coded.

    planes: component i's samples at its own resolution, (ceil(height *
    v / vmax), ceil(width * h / hmax)), each below 2^precision; sampling:
    (h, v) per component (default 1 x 1). predictor 1-7 and the point
    transform pt go in every scan header; restart is the interval in MCUs
    (libjpeg requires a multiple of a scan's MCUs per row). scans: lists
    of component indices (default: one interleaved scan). One Huffman table
    (slot 0), optimised over the file's difference categories (0-16)."""
    n = len(planes)
    sampling = sampling or [(1, 1)] * n
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    dims = [(-(-height * v // vmax), -(-width * h // hmax)) for h, v in sampling]
    for p, d in zip(planes, dims):
        assert np.shape(p) == d, (np.shape(p), d)
    scans = scans or [list(range(n))]
    ids = ids or list(range(1, n + 1))
    initial = 1 << (precision - pt - 1)
    streams = []
    for scan in scans:
        one = len(scan) == 1
        units = []                 # per component: its differences, (MCUs, samples per MCU)
        for ci in scan:
            h, v = (1, 1) if one else sampling[ci]
            sv = sampling[ci][1]
            dh, dw = dims[ci]
            x = np.asarray(planes[ci], np.int64) >> pt
            per_row = dw if one else mcux
            mcu_rows = np.arange(dh) if one else np.arange(dh) // v
            # restarts are taken before an MCU row; libjpeg's undifferencer
            # treats the first row of the iMCU row they fall in as a first row
            starts = (mcu_rows * per_row % restart == 0) if restart else mcu_rows == 0
            if one:
                imcu = np.arange(dh) // sv
                hit = np.zeros(imcu.max() + 1 if dh else 0, bool)
                np.logical_or.at(hit, imcu, starts)
                first = (np.arange(dh) % sv == 0) & hit[imcu]
            else:
                first = starts & (np.arange(dh) % v == 0)
            diff = (x - _lossless_prediction(x, predictor, first, initial)) & 0xFFFF
            d = np.where(diff >= 0x8000, diff - 0x10000, diff)
            if one:
                grid = d.reshape(-1, 1)
            else:
                grid = np.zeros((mcuy * v, mcux * h), np.int64)
                grid[:dh, :dw] = d
                grid = grid.reshape(mcuy, v, mcux, h).transpose(0, 2, 1, 3).reshape(
                    mcuy * mcux, v * h)
            units.append(grid)
        flat = np.concatenate(units, axis=1)
        n_mcu = flat.shape[0]
        flat = flat.reshape(-1)
        cat = np.where(flat == -0x8000, 16, _category(flat))
        extra = np.where(cat == 16, 0, _extra(flat, np.minimum(cat, 15)))
        elen = np.where(cat == 16, 0, cat)
        streams.append((n_mcu, flat.size // max(n_mcu, 1), cat, extra, elen))
    table = _huffman_table(np.bincount(np.concatenate([s[2] for s in streams]),
                                       minlength=256).tolist())
    code_of, len_of = jpeg._huffman_codes(table)
    head = [b"\xff\xd8"]
    if jfif:
        head.append(_segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    if adobe is not None:
        head.append(_segment(0xFFEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe)))
    head.append(_segment(0xFF00 | sof, struct.pack(">BHHB", precision, height, width, n)
                         + b"".join(bytes([ids[i], h * 16 + v, 0])
                                    for i, (h, v) in enumerate(sampling))))
    head.append(_segment(0xFFC4, bytes([0]) + bytes(table[0]) + bytes(table[1])))
    if restart:
        head.append(_segment(0xFFDD, struct.pack(">H", restart)))
    body = []
    for scan, (n_mcu, per, cat, extra, elen) in zip(scans, streams):
        body.append(_segment(0xFFDA, bytes([len(scan)]) + b"".join(
            bytes([ids[ci], 0]) for ci in scan) + bytes([predictor, 0, pt])))
        bits = (code_of[cat] << elen) | extra
        nbits = len_of[cat] + elen
        if not restart:
            body.append(jpeg._pack(bits, nbits))
            continue
        step = restart * per
        for i, k in enumerate(range(0, len(bits), step)):
            if i:
                body.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
            body.append(jpeg._pack(bits[k:k + step], nbits[k:k + step]))
    return b"".join(head + body + [b"\xff\xd9"])


def lossless_planes(width: int, height: int, sampling, precision: int, seed: int):
    """Seeded sample planes for `lossless_bytes`: smooth structure, noise
    and runs, over the whole range of the precision."""
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    top = (1 << precision) - 1
    out = []
    for i, (h, v) in enumerate(sampling):
        dh, dw = -(-height * v // vmax), -(-width * h // hmax)
        s = random_samples(dh, dw, 0, 16, seed + i).astype(np.int64) * top // 65535
        out.append(s)
    return out


# ----------------------------------------------------------------------------
# BMP
# ----------------------------------------------------------------------------

MASKS_555 = (0x7C00, 0x3E0, 0x1F)
MASKS_565 = (0xF800, 0x7E0, 0x1F)


def _rle_row(idx, rle4: bool, delta: bool):
    """The codes of one row of palette indices: encoded runs (two
    alternating nibbles for RLE4), absolute runs of 3 or more, and with
    delta=True stretches of 4 or more index-0 pixels skipped by a delta
    (cv2 fills what a delta skips with palette entry 0)."""
    out, x, w = [], 0, len(idx)
    while x < w:
        if delta and idx[x] == 0:
            z = x
            while z < w and idx[z] == 0 and z - x < 255:
                z += 1
            if z - x >= 4 and z < w:
                out += [0, 2, z - x, 0]
                x = z
                continue
        r = x + 1
        while r < w and idx[r] == idx[x] and r - x < 255:
            r += 1
        if r - x >= 3 or (r - x == 2 and not rle4):
            out += [r - x, idx[x] * 17 if rle4 else idx[x]]
            x = r
            continue
        e = x   # a literal stretch up to the next run of 3
        while e < w and e - x < 255 and not (e + 2 < w and idx[e] == idx[e + 1] == idx[e + 2]):
            e += 1
        n = e - x
        if n >= 3:
            lit = list(idx[x:e])
            if rle4:
                lit += [0] * (n % 2)
                body = [lit[k] << 4 | lit[k + 1] for k in range(0, len(lit), 2)]
            else:
                body = lit
            out += [0, n] + body + [0] * (len(body) % 2)
        elif rle4:
            pair = list(idx[x:e]) + [0]
            out += [n, pair[0] << 4 | (pair[1] if n == 2 else 0)]
        else:
            for v in idx[x:e]:
                out += [1, v]
        x = e
    return out


def rle_codes(indices, rle4: bool = False, delta: bool = True) -> bytes:
    """BI_RLE8 / BI_RLE4 data of an (h, w) array of palette indices, rows
    bottom-up: each row's runs, then end of line; rows of index 0 are
    skipped by a delta (0, dy) with delta=True, and the rows after the
    last one with a nonzero index by end of bitmap."""
    idx = np.asarray(indices)[::-1]
    h = idx.shape[0]
    nonzero = [y for y in range(h) if idx[y].any()]
    last = nonzero[-1] if nonzero else -1
    out, y = [], 0
    while y <= last:
        if delta and not idx[y].any():
            k = y
            while k <= last and not idx[k].any() and k - y < 255:
                k += 1
            out += [0, 2, 0, k - y]
            y = k
            continue
        out += _rle_row([int(v) for v in idx[y]], rle4, delta) + [0, 0]
        y += 1
    return bytes(out + [0, 1])


def bmp_bytes(pixels, bpp: int, palette=None, header: int = 40, rle: bool = False,
              codes: bytes | None = None, masks=None, top_down: bool = False,
              clrused: int | None = None, delta: bool = True) -> bytes:
    """A BMP file. pixels: (h, w) palette indices at 1, 4 and 8 bits (palette
    (n, 3) RGB, written B, G, R(, 0); clrused defaults to n below 2^bpp, else
    0), (h, w) raw 16-bit values, (h, w, 3) RGB at 24 bits or (h, w, 4) RGBA
    at 32 (written B, G, R, A). header 12 (OS/2), 40, 108 or 124; rle codes
    the indices as BI_RLE8 / BI_RLE4 (or writes `codes` as they are); masks
    (three values, MASKS_555 or MASKS_565) makes it BI_BITFIELDS with the
    masks after the header, as cv2 reads them (a V4 / V5 header also holds
    them)."""
    px = np.asarray(pixels)
    h, w = px.shape[:2]
    if bpp <= 8:
        pal = np.asarray(palette, np.uint8).reshape(-1, 3)[:, ::-1]
        if header != 12:
            pal = np.concatenate([pal, np.zeros((len(pal), 1), np.uint8)], axis=1)
        pal_bytes = pal.tobytes()
        if clrused is None:
            clrused = len(pal) if len(pal) < 1 << bpp else 0
    else:
        pal_bytes, clrused = b"", clrused or 0
    comp = 0
    if rle or codes is not None:
        comp = 1 if bpp == 8 else 2
        data = codes if codes is not None else rle_codes(px, bpp == 4, delta)
    else:
        if bpp <= 8:
            rows = _pack_rows(px[..., None].astype(np.uint8), bpp)
        elif bpp == 16:
            rows = px.astype("<u2").view(np.uint8).reshape(h, 2 * w)
        else:
            rows = px[..., [2, 1, 0, 3][:bpp // 8]].astype(np.uint8).reshape(h, -1)
        pad = (-rows.shape[1]) % 4
        rows = np.concatenate([rows, np.zeros((h, pad), np.uint8)], axis=1)
        data = (rows if top_down else rows[::-1]).tobytes()
    extra = b""
    if masks is not None:
        comp = 3
        extra = struct.pack("<III", *masks)
    if header == 12:
        hdr = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        hdr = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bpp, comp,
                          len(data), 2835, 2835, clrused, 0)
        if header > 40:
            hdr += extra + b"\0" * (header - 40 - len(extra))
    off = 14 + len(hdr) + len(extra) + len(pal_bytes)
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + hdr + extra
            + pal_bytes + data)


# ----------------------------------------------------------------------------
# PxM, PAM, PFM
# ----------------------------------------------------------------------------

def pnm_bytes(samples, kind: int, maxval: int = 255, comment: bool = False,
              line: int = 17) -> bytes:
    """A P1-P6 file of (h, w) or (h, w, 3) samples (0 / 1 at P1 / P4,
    1 = black). ASCII kinds put `line` samples on a line; comment=True puts
    a comment after each header number."""
    s = np.asarray(samples)
    h, w = s.shape[:2]
    c = b"# a comment\n" if comment else b""
    head = b"P%d\n" % kind + c + b"%d %d\n" % (w, h) + c
    if kind not in (1, 4):
        head += b"%d\n" % maxval
    if kind in (1, 2, 3):
        flat = [str(int(v)) for v in s.reshape(-1)]
        sep = "" if kind == 1 else " "
        return head + "\n".join(sep.join(flat[i:i + line])
                                for i in range(0, len(flat), line)).encode() + b"\n"
    if kind == 4:
        return head + _pack_rows(s[..., None].astype(np.uint8), 1).tobytes()
    return head + s.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def pam_bytes(samples, maxval: int = 255, tupltype: str | None = None,
              depth: int | None = None) -> bytes:
    """A P7 file of (h, w, depth) samples, big-endian above maxval 255."""
    s = np.asarray(samples)
    s = s[..., None] if s.ndim == 2 else s
    h, w, d = s.shape
    head = (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth or d}\nMAXVAL {maxval}\n"
            + (f"TUPLTYPE {tupltype}\n" if tupltype else "") + "ENDHDR\n")
    return head.encode() + s.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def pfm_bytes(values, scale: float = -1.0) -> bytes:
    """A Pf / PF file of (h, w) or (h, w, 3) float32 values (RGB), rows
    bottom-up, little endian for a negative scale."""
    v = np.asarray(values, np.float32)
    h, w = v.shape[:2]
    head = b"%s\n%d %d\n%s\n" % (b"PF" if v.ndim == 3 else b"Pf", w, h, repr(scale).encode())
    return head + v[::-1].astype("<f4" if scale < 0 else ">f4").tobytes()


# ----------------------------------------------------------------------------
# Sun raster
# ----------------------------------------------------------------------------

def sun_rle(data: bytes) -> bytes:
    """RT_BYTE_ENCODED: runs of 3 or more (or any run of 0x80) as
    0x80, count - 1, value; a single 0x80 as 0x80, 0."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i] and j - i < 256:
            j += 1
        if j - i >= 3 or data[i] == 0x80:
            if j - i == 1:
                out += b"\x80\x00"
            else:
                out += bytes([0x80, j - i - 1, data[i]])
        else:
            out += data[i:j]
        i = j
    return bytes(out)


def sun_bytes(pixels, depth: int, typ: int = 1, cmap=None, maptype: int | None = None) -> bytes:
    """A Sun raster file: (h, w) indices at 1 and 8 bits (cmap (n, 3) RGB
    written as three planes; map type 1, or 0 without one), (h, w, 3) at
    24 bits and (h, w, 4) at 32, stored byte by byte as given (type 3,
    RT_FORMAT_RGB, says they are R, G, B); rows padded to 16 bits; type 2
    RLE-codes the padded rows."""
    px = np.asarray(pixels)
    h, w = px.shape[:2]
    if depth <= 8:
        rows = _pack_rows(px[..., None].astype(np.uint8), depth)
    else:
        rows = px.astype(np.uint8).reshape(h, -1)
    rows = np.concatenate([rows, np.zeros((h, rows.shape[1] % 2), np.uint8)], axis=1)
    body = rows.tobytes()
    if typ == 2:
        body = sun_rle(body)
    mapbytes = b"" if cmap is None else np.asarray(cmap, np.uint8).reshape(-1, 3).T.tobytes()
    if maptype is None:
        maptype = 0 if cmap is None else 1
    return (struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), typ, maptype, len(mapbytes))
            + mapbytes + body)


# ----------------------------------------------------------------------------
# TIFF
# ----------------------------------------------------------------------------

# field type -> (struct letter, size); RATIONAL is two LONGs
TIFF_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
              7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4),
              12: ("d", 8), 13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
BYTE, ASCII, SHORT, LONG, RATIONAL, UNDEFINED, FLOAT, DOUBLE, LONG8 = 1, 2, 3, 4, 5, 7, 11, 12, 16


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 2 to 128 equal bytes as (1 - n, byte), the rest in
    literal runs of up to 128 bytes (n - 1, bytes)."""
    out, lit, i = bytearray(), bytearray(), 0

    def flush():
        if lit:
            out.append(len(lit) - 1)
            out.extend(lit)
            lit.clear()
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            flush()
            out += bytes([(1 - (j - i)) & 255, data[i]])
            i = j
        else:
            lit.append(data[i])
            i += 1
            if len(lit) == 128:
                flush()
    flush()
    return bytes(out)


_tiff_lib = None
_tiff_lock = threading.Lock()


def tiff_lzw(data: bytes, compat: bool = False) -> bytes:
    """TIFF LZW (see tiff_lzw_py); inputs over 64 KiB through tiff_forge.cpp
    beside this file (built with g++ at first use into build/native/),
    which writes the same codes."""
    if len(data) <= 1 << 16:
        return tiff_lzw_py(data, compat)
    cap = 2 * len(data) + 64
    out = np.empty(cap, np.uint8)
    n = _forge_lib().pv_lzw_code(data, len(data), int(compat), out.ctypes.data, cap)
    assert n >= 0
    return out[:n].tobytes()


def _forge_lib():
    """tiff_forge.cpp beside this file, built with g++ at first use into
    build/native/."""
    global _tiff_lib
    with _tiff_lock:
        if _tiff_lib is None:
            from panovlm_tpu_torch.native import compile_library
            lib = ctypes.CDLL(str(compile_library(Path(__file__).resolve().parent
                                                  / "tiff_forge.cpp")))
            lib.pv_lzw_code.restype = ctypes.c_long
            lib.pv_lzw_code.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_long]
            lib.pv_gif_lzw.restype = ctypes.c_long
            lib.pv_gif_lzw.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_long]
            lib.pv_fax_code.restype = ctypes.c_long
            lib.pv_fax_code.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                                        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_long]
            _tiff_lib = lib
    return _tiff_lib


def fax_code(black, mode: int, k: int = 0, fill: bool = False, eol_end: bool = True) -> bytes:
    """CCITT coding (tiff_forge.cpp) of (h, w) bilevel rows, True or nonzero
    for black: mode 2 (RLE, rows padded to a byte), 32771 (RLE/W, to 16
    bits), 3 (Group 3: an EOL before each row, `fill` bits ending it on a
    byte boundary; k = 0 1-D, else a tag bit after each EOL and every k-th
    row 1-D, the others 2-D) or 4 (Group 4); eol_end writes Group 3's RTC
    or Group 4's EOFB."""
    px = np.ascontiguousarray(np.asarray(black) != 0, np.uint8)
    h, w = px.shape
    cap = 2 * h * w + 64 * h + 64
    out = np.empty(cap, np.uint8)
    n = _forge_lib().pv_fax_code(px.ctypes.data, h, w, mode, k, int(fill), int(eol_end),
                                 out.ctypes.data, cap)
    assert n >= 0
    return out[:n].tobytes()


def tiff_lzw_py(data: bytes, compat: bool = False) -> bytes:
    """TIFF LZW: a clear code, codes of 9 to 12 bits, a clear code when the
    table is full, the end-of-information code. The code width follows the
    decoder's table: libtiff's new-style codes (MSB first, the width grows
    one entry early) or, with compat=True, the old bit-reversed codes that
    libtiff still reads (LSB first, the width grows when the table passes
    2^n - 1)."""
    acc = nacc = 0
    out = bytearray()
    nbits, codes = 9, 0            # the decoder's width; codes read since the clear

    def put(code):
        nonlocal acc, nacc
        if compat:
            acc |= code << nacc
            nacc += nbits
            while nacc >= 8:
                out.append(acc & 255)
                acc >>= 8
                nacc -= 8
        else:
            acc = acc << nbits | code
            nacc += nbits
            while nacc >= 8:
                nacc -= 8
                out.append(acc >> nacc & 255)
            acc &= (1 << nacc) - 1

    def emit(code):
        nonlocal nbits, codes
        put(code)
        codes += 1
        free = 258 + codes - 1     # entries the decoder holds after this code
        while nbits < 12 and free > (1 << nbits) - (1 if compat else 2):
            nbits += 1

    put(256)
    table, nxt, w = {bytes([i]): i for i in range(256)}, 258, b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = nxt
        nxt += 1
        w = bytes([c])
        if nxt == 4094:
            put(256)
            nbits, codes = 9, 0
            table, nxt = {bytes([i]): i for i in range(256)}, 258
    if w:
        emit(table[w])
    put(257)
    if nacc:
        out.append((acc if compat else acc << (8 - nacc)) & 255)
    return bytes(out)


def jpeg_units(data: bytes) -> list:
    """A JPEG stream's parts after SOI, up to EOI: (marker, bytes) for each
    marker segment, a scan's entropy-coded data (restart markers included)
    riding with its SOS."""
    units, pos = [], 2
    while pos + 1 < len(data):
        m = data[pos + 1]
        if m == 0xD9:
            break
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if m == 0xDA:
            while end + 1 < len(data) and not (data[end] == 0xFF and data[end + 1] != 0
                                                 and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
        units.append((m, data[pos:end]))
        pos = end
    return units


def tiff_jpeg_chunks(parts, photometric: int, subsampling=(1, 1), quality: int = 90,
                     restart: int = 0, tables: str | None = "all", progressive: bool = False):
    """JPEG-in-TIFF streams of strips or tiles (each (h, w, c) samples as
    the TIFF's photometric codes them: YCbCr with `subsampling`, Y's factors
    and 1 x 1 chroma; any other samples 1 x 1), and the JPEGTables stream:
    tables "all" moves the quantisation tables of every stream and the
    Huffman tables of the first one before its first scan there (the others
    keep theirs, which override them), "dqt" the quantisation tables only,
    None writes whole streams and no JPEGTables. Optimised Huffman tables,
    restart intervals of `restart` MCUs, and with `progressive` the
    spectral-selection script."""
    streams = []
    for part in parts:
        h, w, c = part.shape
        planes = [part[..., k].astype(np.float64) for k in range(c)]
        sampling = [(1, 1)] * c
        if photometric == 6 and c == 3:
            sampling[0] = tuple(subsampling)
        comps, q = plane_components(planes, sampling, quality)
        scans = spectral_script(c) if progressive else [("seq", list(range(c)))]
        streams.append(jpeg_bytes(comps, w, h, q, scans, restart=restart, jfif=False))
    if tables is None:
        return streams, None
    head, out = [], []
    for i, data in enumerate(streams):
        units = jpeg_units(data)
        first_sos = next(k for k, (m, _) in enumerate(units) if m == 0xDA)
        keep = []
        for k, (m, seg) in enumerate(units):
            move = m == 0xDB or (tables == "all" and i == 0 and m == 0xC4 and k < first_sos)
            if move and i == 0:
                head.append(seg)
            if not move:
                keep.append(seg)
        out.append(b"\xff\xd8" + b"".join(keep) + b"\xff\xd9")
    return out, b"\xff\xd8" + b"".join(head) + b"\xff\xd9"


def tiff_fields(data: bytes) -> dict:
    """The first IFD of a classic TIFF (either byte order): tag -> its values,
    bytes for BYTE, ASCII and UNDEFINED entries, else a list of integers."""
    order = "<" if data[:2] == b"II" else ">"
    ifd = struct.unpack(order + "I", data[4:8])[0]
    n = struct.unpack(order + "H", data[ifd:ifd + 2])[0]
    out = {}
    for i in range(n):
        tag, typ, count = struct.unpack(order + "HHI", data[ifd + 2 + 12 * i:ifd + 10 + 12 * i])
        letter, size = TIFF_TYPES[typ]
        at = ifd + 10 + 12 * i
        if count * size > 4:
            at = struct.unpack(order + "I", data[at:at + 4])[0]
        raw = data[at:at + count * size]
        out[tag] = raw if typ in (1, 2, 7) else list(struct.unpack(
            order + letter * (count * size // struct.calcsize(letter)), raw))
    return out


def splice_tables(tables: bytes, stream: bytes) -> bytes:
    """A standalone JPEG of a JPEG-in-TIFF strip or tile: the JPEGTables
    stream's segments before the strip's own (SOI once, EOI once)."""
    return tables[:-2] + stream[2:]


def jpeg_as_tiff(jpg: bytes) -> bytes:
    """A baseline JPEG file as a single-strip JPEG-in-TIFF: its DQT and DHT
    segments in JPEGTables, its APPn and COM segments dropped; YCbCr with
    the luma's sampling factors for three components, MinIsBlack for one."""
    units = jpeg_units(jpg)
    sof = next(seg for m, seg in units if m == 0xC0)
    height, width, nc = struct.unpack(">HHB", sof[5:10])
    tables = b"\xff\xd8" + b"".join(seg for m, seg in units if m in (0xC4, 0xDB)) + b"\xff\xd9"
    strip = b"\xff\xd8" + b"".join(seg for m, seg in units
                                   if m not in (0xC4, 0xDB, 0xFE) and not 0xE0 <= m <= 0xEF)
    strip += b"\xff\xd9"
    shape = (height, width, 3) if nc == 3 else (height, width)
    return tiff_bytes(np.zeros(shape, np.uint8), 6 if nc == 3 else 1, compression=7,
                      subsampling=(sof[11] >> 4, sof[11] & 15) if nc == 3 else None,
                      chunks=[strip], tags={347: (UNDEFINED, tables)})


def jpeg_tiff_tiles(rgb, tile, quality: int = 90):
    """A YCbCr 2x2 JPEG-in-TIFF of an (h, w, 3) RGB array (JFIF's full-range
    YCbCr) in tiles of tile = (width, height), its tables in JPEGTables.
    Returns the file, each tile's stream by its (row, column) origin, and
    the JPEGTables stream."""
    c = np.asarray(rgb, np.float64)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    ycc = np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                    128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
                    128 + 0.5 * r - 0.418688 * g - 0.081312 * b], -1)
    h, w = ycc.shape[:2]
    tw, th = tile
    origins = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
    parts = [np.pad(ycc[y:y + th, x:x + tw], ((0, th - min(th, h - y)), (0, tw - min(tw, w - x)),
                                               (0, 0)), mode="edge") for y, x in origins]
    streams, tables = tiff_jpeg_chunks(parts, 6, (2, 2), quality)
    data = tiff_bytes(np.zeros((h, w, 3), np.uint8), 6, compression=7, subsampling=(2, 2),
                      tile=tile, chunks=streams, tags={347: (UNDEFINED, tables)})
    return data, dict(zip(origins, streams)), tables


def _tiff_rows(s: np.ndarray, bits: int, big_endian: bool) -> bytes:
    """(n, m, c) samples -> rows of m * c samples, each row padded to a
    byte: 8 to 64-bit samples in the file's byte order, others MSB first."""
    n, m, c = s.shape
    if bits in (8, 16, 32, 64):
        dt = {8: "u1", 16: "u2", 32: "u4", 64: "u8"}[bits]
        return s.astype((">" if big_endian else "<") + dt).tobytes()
    flat = s.reshape(n, m * c).astype(np.uint64)
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint64)
    bitrows = ((flat[..., None] >> shifts) & 1).astype(np.uint8).reshape(n, -1)
    pad = (-bitrows.shape[1]) % 8
    bitrows = np.concatenate([bitrows, np.zeros((n, pad), np.uint8)], axis=1)
    return np.packbits(bitrows, axis=1).tobytes()


def _ycbcr_units(s: np.ndarray, sh: int, sv: int) -> bytes:
    """(n, m, 3) Y, Cb, Cr -> data units of sh * sv Y samples (row by row)
    and the block's Cb and Cr (of its top-left pixel); edge blocks repeat
    the last row and column."""
    n, m, _ = s.shape
    hb, wb = -(-n // sv), -(-m // sh)
    p = np.pad(s, ((0, hb * sv - n), (0, wb * sh - m), (0, 0)), mode="edge")
    y = p[..., 0].reshape(hb, sv, wb, sh).transpose(0, 2, 1, 3).reshape(hb, wb, sv * sh)
    cb = p[::sv, ::sh, 1][..., None]
    cr = p[::sv, ::sh, 2][..., None]
    return np.concatenate([y, cb, cr], axis=2).astype(np.uint8).tobytes()


def tiff_bytes(samples, photometric: int | None = None, bits: int = 8, compression: int = 1,
               predictor: int = 1, planar: int = 1, rows_per_strip: int | None = None,
               tile=None, big_endian: bool = False, bigtiff: bool = False, extra=(),
               colormap=None, orientation: int | None = None, fill_order: int = 1,
               sample_format: int | None = None, subsampling=None, ref_bw=None,
               lzw_compat: bool = False, tags=None, drop=(), level: int = 6,
               ifd_first: bool = True, chunks=None, fax=(0, False, True),
               jpeg=None) -> bytes:
    """A one-page TIFF (classic or BigTIFF, either byte order) of (h, w) or
    (h, w, spp) integer samples as stored: strips of rows_per_strip rows
    (one strip by default) or tiles (tile = (width, height), edge tiles
    padded with 0); PlanarConfiguration 1 or 2; compression 1 (none), 32773
    (PackBits), 5 (LZW; lzw_compat for the old bit-reversed codes), 8 or
    32946 (Deflate, zlib `level`), 2, 32771, 3 and 4 on 1-bit samples
    (CCITT RLE, RLE/W, Group 3 and Group 4 through `fax_code`; fax = (k,
    fill, eol_end) as it takes them, Group 3's T4Options written from k and
    fill), 7 (JPEG through `tiff_jpeg_chunks` with the options of the
    `jpeg` dict), any other number writing the data uncompressed under it;
    predictor 2 (horizontal differencing of 8 to
    64-bit samples) or any number written as given; fill_order 2 reverses
    the bits of every byte of the coded data. photometric defaults to
    MinIsBlack (1 or 2 samples) or RGB; colormap (2^bits, 3) 16-bit
    values; extra the ExtraSamples values; subsampling (h, v) codes
    (h, w, 3) YCbCr samples as data units. `tags` {tag: (type, values)}
    adds or replaces entries, `drop` leaves tags out; `chunks` replaces
    the coded strips or tiles. ifd_first puts the IFD before the data."""
    s = np.asarray(samples)
    s = s[..., None] if s.ndim == 2 else s
    h, w, spp = s.shape
    if photometric is None:
        photometric = 1 if spp - len(extra) == 1 else 2
    order = ">" if big_endian else "<"
    planes = [s[..., k:k + 1] for k in range(spp)] if planar == 2 else [s]
    if tile is not None:
        tw, th = tile
        boxes = [(y, x, th, tw) for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        rps = h if rows_per_strip is None else rows_per_strip
        boxes = [(y, 0, rps, w) for y in range(0, h, max(rps, 1))]
    coded = []
    for plane in planes if chunks is None else ():
        for y, x, bh, bw in boxes:
            part = plane[y:y + bh, x:x + bw]
            if tile is not None:
                part = np.pad(part, ((0, bh - part.shape[0]), (0, bw - part.shape[1]), (0, 0)))
            if compression == 7:   # JPEG: coded below, FillOrder ignored as libtiff ignores it
                coded.append(part)
                continue
            if compression in (2, 3, 4, 32771) and bits == 1:
                raw = fax_code(part[..., 0], compression, *fax)
            elif subsampling is not None and planar == 1:
                raw = _ycbcr_units(part, *subsampling)
            else:
                if predictor == 2 and bits in (8, 16, 32, 64):
                    v = part.astype(np.int64)
                    v[:, 1:] = v[:, 1:] - v[:, :-1]
                    part = (v % (1 << bits)).astype(np.uint64)
                raw = _tiff_rows(part, bits, big_endian)
            if compression == 32773:
                raw = packbits(raw)
            elif compression == 5:
                raw = tiff_lzw(raw, lzw_compat)
            elif compression in (8, 32946):
                raw = zlib.compress(raw, level)
            if fill_order == 2:
                raw = np.unpackbits(np.frombuffer(raw, np.uint8)).reshape(-1, 8)[:, ::-1]
                raw = np.packbits(raw).tobytes()
            coded.append(raw)
    extra_tags = {}
    if compression == 7 and chunks is None:
        coded, tables = tiff_jpeg_chunks(coded, photometric, subsampling or (1, 1), **(jpeg or {}))
        if tables is not None:
            extra_tags[347] = (UNDEFINED, tables)
    if compression == 3 and (fax[0] or fax[1]):
        extra_tags[292] = (LONG, [(1 if fax[0] else 0) | (4 if fax[1] else 0)])
    if chunks is not None:
        coded = list(chunks)
    off_type = LONG8 if bigtiff else LONG
    entries = {256: (LONG, [w]), 257: (LONG, [h]), 258: (SHORT, [bits] * spp),
               259: (SHORT, [compression]), 262: (SHORT, [photometric]),
               277: (SHORT, [spp]), 284: (SHORT, [planar])}
    if tile is not None:
        entries.update({322: (LONG, [tile[0]]), 323: (LONG, [tile[1]]),
                        324: (off_type, [0] * len(coded)),
                        325: (off_type, [len(c) for c in coded])})
    else:
        entries.update({273: (off_type, [0] * len(coded)), 278: (LONG, [rps]),
                        279: (off_type, [len(c) for c in coded])})
    if predictor != 1:
        entries[317] = (SHORT, [predictor])
    if fill_order != 1:
        entries[266] = (SHORT, [fill_order])
    if orientation is not None:
        entries[274] = (SHORT, [orientation])
    if extra:
        entries[338] = (SHORT, list(extra))
    if sample_format is not None:
        entries[339] = (SHORT, [sample_format] * spp)
    if colormap is not None:
        entries[320] = (SHORT, np.asarray(colormap).T.reshape(-1).tolist())
    if subsampling is not None:
        entries[530] = (SHORT, list(subsampling))
    if ref_bw is not None:
        entries[532] = (RATIONAL, [v for r in ref_bw for v in (int(round(r * 1000)), 1000)])
    entries.update(extra_tags)
    entries.update(tags or {})
    for t in drop:
        entries.pop(t, None)
    data_tag = 324 if 324 in entries else 273

    def pack(typ, vals):
        if isinstance(vals, (bytes, bytearray)):
            return bytes(vals)
        letter = TIFF_TYPES[typ][0][0]
        return struct.pack(order + letter * len(vals), *vals)

    def count(typ, vals):
        if isinstance(vals, (bytes, bytearray)):
            return len(vals)
        return len(vals) // (2 if typ in (5, 10) else 1)

    head = 16 if bigtiff else 8
    slot = 8 if bigtiff else 4
    ifd_size = (8 + 20 * len(entries) + 8) if bigtiff else (2 + 12 * len(entries) + 4)
    sizes = {t: len(pack(typ, v)) for t, (typ, v) in entries.items()}
    ool_size = sum(-(-n // 2) * 2 for n in sizes.values() if n > slot)
    data_size = sum(len(c) for c in coded)
    ifd_at = head if ifd_first else head + data_size + data_size % 2
    ool_at = ifd_at + ifd_size
    data_at = ool_at + ool_size if ifd_first else head
    offs, at = [], data_at
    for c in coded:
        offs.append(at)
        at += len(c)
    if data_tag in entries:
        typ, vals = entries[data_tag]
        if all(v == 0 for v in vals) and len(vals) == len(coded):
            entries[data_tag] = (typ, offs)
    ifd, ool = bytearray(), bytearray()
    ifd += struct.pack(order + ("Q" if bigtiff else "H"), len(entries))
    for t in sorted(entries):
        typ, vals = entries[t]
        body = pack(typ, vals)
        if len(body) > slot:
            ref = struct.pack(order + ("Q" if bigtiff else "I"), ool_at + len(ool))
            ool += body + b"\0" * (len(body) % 2)
        else:
            ref = body + b"\0" * (slot - len(body))
        ifd += struct.pack(order + ("HHQ" if bigtiff else "HHI"), t, typ, count(typ, vals)) + ref
    ifd += b"\0" * slot
    if bigtiff:
        hdr = (b"MM" if big_endian else b"II") + struct.pack(order + "HHHQ", 43, 8, 0, ifd_at)
    else:
        hdr = (b"MM" if big_endian else b"II") + struct.pack(order + "HI", 42, ifd_at)
    data = b"".join(coded)
    if ifd_first:
        return hdr + bytes(ifd) + bytes(ool) + data
    return hdr + data + b"\0" * (data_size % 2) + bytes(ifd) + bytes(ool)


# ----------------------------------------------------------------------------
# GIF
# ----------------------------------------------------------------------------

GIF_INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))   # (first row, step) of each pass


def gif_codes(data: bytes, min_code: int, deferred: bool = False) -> list:
    """GIF's LZW codes of data (indices below 2^min_code): a clear code
    first, a clear code when the next free entry reaches 4096 (with
    deferred none: the table stops growing there), the end-of-information
    code."""
    clear = 1 << min_code
    codes = [clear]
    fresh = {bytes([i]): i for i in range(256)}
    table, nxt, w = dict(fresh), clear + 2, b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        codes.append(table[w])
        if nxt < 4096:
            table[wc] = nxt
            nxt += 1
        w = bytes([c])
        if nxt == 4096 and not deferred:
            codes.append(clear)
            table, nxt = dict(fresh), clear + 2
    if w:
        codes.append(table[w])
    return codes + [clear + 1]


def gif_pack(codes, min_code: int) -> bytes:
    """The codes LSB first, each as wide as a decoder's table makes it:
    min_code + 1 bits after a clear or end-of-information code, one bit
    more when the next free entry (clear + 1 after a reset, one more for
    each other code while below 4096) reaches 2^bits, up to 12."""
    clear = 1 << min_code
    bits, nxt, acc, nacc, out = min_code + 1, clear + 1, 0, 0, bytearray()
    for code in map(int, codes):
        acc |= code << nacc
        nacc += bits
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8
        if code in (clear, clear + 1):
            bits, nxt = min_code + 1, clear + 1
            continue
        nxt = min(nxt + 1, 4096)
        if nxt == 1 << bits and bits < 12:
            bits += 1
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def gif_lzw(data: bytes, min_code: int, deferred: bool = False) -> bytes:
    """gif_pack of gif_codes; inputs over 64 KiB through tiff_forge.cpp
    beside this file (pv_gif_lzw, built with g++ at first use into
    build/native/), which writes the same codes."""
    if len(data) <= 1 << 16:
        return gif_pack(gif_codes(data, min_code, deferred), min_code)
    cap = 2 * len(data) + 64
    out = np.empty(cap, np.uint8)
    n = _forge_lib().pv_gif_lzw(data, len(data), min_code, int(deferred), out.ctypes.data, cap)
    assert n >= 0
    return out[:n].tobytes()


def gif_sub_blocks(data: bytes, size: int = 255) -> bytes:
    """data in sub-blocks of `size` bytes (the last shorter), then the block
    terminator."""
    return b"".join(bytes([len(data[i:i + size])]) + data[i:i + size]
                    for i in range(0, len(data), size)) + b"\0"


def _gif_palette(palette):
    """(size field, bytes) of an (n, 3) RGB palette, padded with black to
    the next power of two from 2 to 256."""
    p = np.asarray(palette, np.uint8).reshape(-1, 3)
    k = max(0, (len(p) - 1).bit_length() - 1)
    return k, p.tobytes() + bytes(3 * ((2 << k) - len(p)))


def gif_screen(width: int, height: int, palette=None, bg: int = 0,
               version: bytes = b"89a") -> bytes:
    """The header, the logical screen descriptor (8-bit colour resolution)
    and the global palette (none when palette is None)."""
    flags, table = 0x70, b""
    if palette is not None:
        k, table = _gif_palette(palette)
        flags |= 0x80 | k
    return b"GIF" + version + struct.pack("<HHBBB", width, height, flags, bg, 0) + table


def gif_extension(label: int, blocks) -> bytes:
    """An extension: 0x21, its label, each of blocks as a sub-block, the
    terminator."""
    return bytes([0x21, label]) + b"".join(bytes([len(b)]) + b for b in blocks) + b"\0"


def gif_gce(transparent: int | None = None, disposal: int = 0, delay: int = 0) -> bytes:
    """A graphic control extension."""
    flags = (disposal & 7) << 2 | (transparent is not None)
    return gif_extension(0xF9, [struct.pack("<BHB", flags, delay, transparent or 0)])


def gif_image(indices, left: int = 0, top: int = 0, palette=None, interlace: bool = False,
              min_code: int | None = None, deferred: bool = False, data: bytes | None = None,
              block: int = 255) -> bytes:
    """An image descriptor, its local palette (none when palette is None),
    the minimum code size and the LZW data of the (h, w) indices, rows in
    interlace order with interlace, in sub-blocks of `block` bytes. min_code
    defaults to the bits of the largest index, at least 2; `data` replaces
    the coded indices."""
    idx = np.asarray(indices, np.uint8)
    h, w = idx.shape
    flags, table = 0x40 * bool(interlace), b""
    if palette is not None:
        k, table = _gif_palette(palette)
        flags |= 0x80 | k
    if min_code is None:
        min_code = max(2, int(idx.max(initial=0)).bit_length())
    if data is None:
        rows = np.concatenate([idx[a::s] for a, s in GIF_INTERLACE]) if interlace else idx
        data = gif_lzw(np.ascontiguousarray(rows).tobytes(), min_code, deferred)
    return (b"\x2c" + struct.pack("<HHHHB", left, top, w, h, flags) + table + bytes([min_code])
            + gif_sub_blocks(data, block))


def gif_bytes(indices, palette=None, local=None, screen=None, offset=(0, 0), bg: int = 0,
              transparent: int | None = None, disposal: int | None = None, interlace: bool = False,
              min_code: int | None = None, deferred: bool = False, version: bytes = b"89a",
              before: bytes = b"", after: bytes = b"", **image) -> bytes:
    """A GIF of one frame of (h, w) palette indices: the global `palette`
    (RGB rows) or none, the frame's `local` palette or none, a logical
    screen of `screen` = (width, height) (the frame's size by default) with
    the frame at `offset` = (left, top), a graphic control extension when
    transparent or disposal is given, `before` (extensions) ahead of it and
    `after` (more frames, extensions) after the frame, then the trailer."""
    idx = np.asarray(indices, np.uint8)
    h, w = idx.shape
    sw, sh = screen or (w, h)
    gce = gif_gce(transparent, disposal or 0) if transparent is not None or disposal is not None \
        else b""
    return (gif_screen(sw, sh, palette, bg, version) + before + gce
            + gif_image(idx, offset[0], offset[1], local, interlace, min_code, deferred, **image)
            + after + b"\x3b")


def gif_332(rgb):
    """(h, w, 3) uint8 RGB quantised to the 3-3-2 palette: indices
    (r >> 5) << 5 | (g >> 5) << 2 | b >> 6 and the (256, 3) palette of
    their levels (each 3-bit level v as v * 255 // 7, each 2-bit one as
    v * 85)."""
    c = np.asarray(rgb, np.uint8)
    idx = (c[..., 0] & 0xE0) | (c[..., 1] & 0xE0) >> 3 | c[..., 2] >> 6
    i = np.arange(256)
    pal = np.stack([(i >> 5) * 255 // 7, (i >> 2 & 7) * 255 // 7, (i & 3) * 85], axis=1)
    return idx.astype(np.uint8), pal.astype(np.uint8)
