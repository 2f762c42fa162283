"""OpenEXR scanline reader and ZIP writer, Radiance HDR reader.

The port's own copy of relightable3dgaussian_tpu/scene/exr.py, numpy only
(the port imports nothing of the JAX package and loads none of its native
code). The formats are read from their specs:

  * EXR: version-2 scanline files; NONE/RLE/ZIPS/ZIP decoded in numpy
    (zlib + delta predictor + byte de-interleave); HALF/FLOAT/UINT
    channels. PIZ (bitmap LUT, canonical Huffman with its run-length code,
    the 14-bit or 16-bit-modulo 2D wavelet; HALF channels), which the JAX
    package decodes with its C++ module, is decoded in numpy to the same
    uint16 patterns (`piz_decode`): the Huffman codes by a 14-bit lookup
    table over every bit position at once and a walk of one step a code,
    the wavelet a level at a time. `write_exr_zip` writes FLOAT channels
    ZIP-compressed, byte for byte as the JAX package does (the env maps of
    the relighting tests and chip_smoke.py).
  * Radiance .hdr: RGBE with adaptive RLE (the reference's composition /
    teaser maps).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PTYPE = {0: "uint", 1: "half", 2: "float"}
_PSIZE = {"uint": 4, "half": 2, "float": 4}
_NPDT = {"uint": np.uint32, "half": np.float16, "float": np.float32}
_LINES_PER_BLOCK = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32}  # by compression id


def _read_cstr(f) -> bytes:
    out = b""
    while True:
        c = f.read(1)
        if c in (b"\x00", b""):
            return out
        out += c


def _parse_header(f) -> dict:
    magic, version = struct.unpack("<iI", f.read(8))
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise ValueError("tiled EXR not supported (scanline reader)")
    if version & 0x1000:
        raise ValueError("multi-part EXR not supported")
    attrs = {}
    while True:
        name = _read_cstr(f)
        if not name:
            break
        atype = _read_cstr(f)
        size = struct.unpack("<i", f.read(4))[0]
        data = f.read(size)
        attrs[name.decode()] = (atype.decode(), data)
    return attrs


def _parse_channels(data: bytes) -> list[tuple[str, str]]:
    chans = []
    i = 0
    while i < len(data) - 1:
        j = data.index(b"\x00", i)
        name = data[i:j].decode()
        ptype = struct.unpack("<i", data[j + 1:j + 5])[0]
        # pLinear u8 + 3 reserved + xSampling i32 + ySampling i32
        xs, ys = struct.unpack("<ii", data[j + 9:j + 17])
        if (xs, ys) != (1, 1):
            raise ValueError("subsampled channels not supported")
        chans.append((name, _PTYPE[ptype]))
        i = j + 17
    return chans


def _decode_rle(raw: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(raw)
    while i < n:
        count = struct.unpack("<b", raw[i:i + 1])[0]
        i += 1
        if count < 0:
            out += raw[i:i - count]
            i += -count
        else:
            out += raw[i:i + 1] * (count + 1)
            i += 1
    return bytes(out)


def read_exr(path: str) -> dict[str, np.ndarray]:
    """Read a scanline EXR; returns {channel: [H, W] float32/uint32}."""
    with open(path, "rb") as f:
        attrs = _parse_header(f)
        chans = _parse_channels(attrs["channels"][1])
        xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
        comp = attrs["compression"][1][0]
        if comp not in _LINES_PER_BLOCK:
            raise ValueError(f"EXR compression {comp} not supported")
        width = xmax - xmin + 1
        height = ymax - ymin + 1
        lpb = _LINES_PER_BLOCK[comp]
        n_blocks = -(-height // lpb)
        offsets = struct.unpack(f"<{n_blocks}Q", f.read(8 * n_blocks))

        row_bytes = sum(_PSIZE[t] for _, t in chans) * width
        out = {name: np.empty((height, width), _NPDT[t])
               for name, t in chans}

        for off in offsets:
            f.seek(off)
            y, size = struct.unpack("<ii", f.read(8))
            data = f.read(size)
            y0 = y - ymin
            rows = min(lpb, height - y0)
            expected = row_bytes * rows
            if comp == 4 and size < expected:
                if any(t != "half" for _, t in chans):
                    raise ValueError(
                        "PIZ with non-HALF channels not supported")
                planar = piz_decode(data, [width] * len(chans),
                                    [rows] * len(chans))
                for i, (name, _) in enumerate(chans):
                    block = planar[i * width * rows:(i + 1) * width * rows]
                    out[name][y0:y0 + rows] = block.view(
                        np.float16).reshape(rows, width)
                continue
            if comp == 0 or size == expected:
                # uncompressed (or stored raw because compression didn't help)
                raw = data
            elif comp == 1:
                raw = bytes(_undo_zip_predictor_bytes(_decode_rle(data)))
            else:  # ZIPS / ZIP
                raw = bytes(_undo_zip_predictor_bytes(zlib.decompress(data)))
            buf = np.frombuffer(raw, np.uint8)
            if len(buf) != expected:
                raise ValueError(
                    f"chunk at y={y}: got {len(buf)} bytes, "
                    f"expected {expected}")
            # rows: for each scanline, channels in header order, full line
            pos = 0
            for r in range(rows):
                for name, t in chans:
                    nb = _PSIZE[t] * width
                    out[name][y0 + r] = np.frombuffer(
                        buf[pos:pos + nb].tobytes(), _NPDT[t])
                    pos += nb
        return {k: (v.astype(np.float32) if v.dtype != np.uint32 else v)
                for k, v in out.items()}


def _undo_zip_predictor_bytes(raw: bytes) -> np.ndarray:
    """EXR ZIP/RLE postprocess: delta-decode then de-interleave."""
    b = np.frombuffer(raw, np.uint8).astype(np.int32)
    deltas = np.concatenate([b[:1], b[1:] - 128])
    d = (np.cumsum(deltas) % 256).astype(np.uint8)
    n = len(raw)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out


# ---------------------------------------------------------------------------
# PIZ: bitmap LUT + canonical Huffman + 2D Haar-like integer wavelet
# ---------------------------------------------------------------------------

_BITMAP_SIZE = (1 << 16) >> 3
_HUF_ENCSIZE = (1 << 16) + 1
_HUF_DECBITS = 14
_SHORT_ZEROCODE_RUN, _LONG_ZEROCODE_RUN = 59, 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN


def _windows(data: bytes) -> np.ndarray:
    """At every bit position p of the stream (bits MSB first), the 64 bits
    from p on (zero past the end) as a uint64."""
    b = np.frombuffer(data, np.uint8)
    pad = np.concatenate([b, np.zeros(9, np.uint8)])
    shifts = np.arange(56, -8, -8, dtype=np.uint64)
    words = np.zeros(len(b) + 1, np.uint64)
    for i, sh in enumerate(shifts):
        words |= pad[i:i + len(b) + 1].astype(np.uint64) << sh
    p = np.arange(8 * len(b), dtype=np.int64)
    byte, s = p >> 3, (p & 7).astype(np.uint64)
    nxt = pad[byte + 8].astype(np.uint64)
    return (words[byte] << s) | (nxt >> (np.uint64(8) - s))


def _huf_code_lengths(data: bytes, pos: int, im: int, iM: int):
    """The packed table of 6-bit code lengths for symbols im..iM (59-62: a
    short run of zeros, 63 and 8 bits: a long one) → (lengths [ENCSIZE],
    the byte where the table ends)."""
    need = min(len(data) - pos, (iM - im + 1) * 14 // 8 + 2)
    win = _windows(data[pos:pos + need])
    n_bits = 8 * need
    # every 6-bit field, read at each of the 6 phases of the position
    field = (win >> np.uint64(58)).astype(np.int64)
    lengths = np.zeros(_HUF_ENCSIZE, np.int64)
    is_run = field >= _SHORT_ZEROCODE_RUN
    next_run = np.full(n_bits + 7, n_bits + 6, np.int64)
    for r in range(6):
        idx = np.arange(r, n_bits, 6)
        runs = np.flatnonzero(is_run[idx])
        # for each position of this phase, the position of the next run
        nr = np.full(len(idx), n_bits + 6, np.int64)
        if len(runs):
            k = np.searchsorted(runs, np.arange(len(idx)))
            ok = k < len(runs)
            nr[ok] = idx[runs[k[ok]]]
        next_run[idx] = nr
    p, sym = 0, im
    while sym <= iM:
        if p >= n_bits:
            raise ValueError("PIZ: truncated Huffman table")
        stop = next_run[p]
        n = min((stop - p) // 6, iM + 1 - sym)
        if n:
            lengths[sym:sym + n] = field[p:p + 6 * n:6]
            sym += n
            p += 6 * n
            continue
        code = int(field[p])
        if p + (14 if code == _LONG_ZEROCODE_RUN else 6) > n_bits:
            raise ValueError("PIZ: truncated Huffman table")
        if code == _LONG_ZEROCODE_RUN:
            zerun = int(win[p + 6] >> np.uint64(56)) + _SHORTEST_LONG_RUN
            p += 14
        else:
            zerun = code - _SHORT_ZEROCODE_RUN + 2
            p += 6
        if sym + zerun > iM + 1 or p > n_bits:
            raise ValueError("PIZ: Huffman table run past its end")
        sym += zerun          # lengths stay 0
    if p > n_bits:
        raise ValueError("PIZ: truncated Huffman table")
    return lengths, pos + (p + 7) // 8


def _huf_uncompress(data: bytes, n_out: int) -> np.ndarray:
    """OpenEXR's hufUncompress: canonical Huffman with a run-length symbol
    (the largest, iM: the previous symbol repeated 8 bits' count times) →
    [n_out] uint16."""
    if len(data) < 20:
        if n_out == 0:
            return np.zeros(0, np.uint16)
        raise ValueError("PIZ: Huffman block too short")
    im, iM, _, n_bits = struct.unpack_from("<4I", data, 0)
    if im >= _HUF_ENCSIZE or iM >= _HUF_ENCSIZE or im > iM:
        raise ValueError("PIZ: bad Huffman symbol range")
    lengths, start = _huf_code_lengths(data, 20, im, iM)
    if n_bits > 8 * (len(data) - start):
        raise ValueError("PIZ: Huffman bit count past the data")
    # canonical codes: each length's codes are consecutive, from first[l],
    # in symbol order; longer codes take the smaller values
    count = np.bincount(lengths, minlength=59)[:59]
    first = np.zeros(59, np.int64)
    c = 0
    for ln in range(58, 0, -1):
        first[ln] = c
        c = (c + int(count[ln])) >> 1
    order = np.argsort(lengths, kind="stable")
    by_length = np.split(order, np.cumsum(count))[:59]
    # a 14-bit table for codes up to 14 bits; longer ones are matched by
    # their length below
    table_len = np.zeros(1 << _HUF_DECBITS, np.int64)
    table_sym = np.zeros(1 << _HUF_DECBITS, np.int64)
    long_lengths = []
    for ln in range(1, 59):
        syms = by_length[ln]
        if not len(syms):
            continue
        if first[ln] + len(syms) > (1 << ln):
            raise ValueError("PIZ: Huffman code does not fit its length")
        if ln > _HUF_DECBITS:
            long_lengths.append(ln)
            continue
        span = 1 << (_HUF_DECBITS - ln)
        slots = ((first[ln] + np.arange(len(syms)))[:, None] * span
                 + np.arange(span)[None]).ravel()
        if table_len[slots].any():
            raise ValueError("PIZ: Huffman codes overlap")
        table_len[slots] = ln
        table_sym[slots] = np.repeat(syms, span)

    stream = data[start:start + (n_bits + 7) // 8]
    win = _windows(stream)
    win = win[:n_bits]
    head = (win >> np.uint64(64 - _HUF_DECBITS)).astype(np.int64)
    code_len = table_len[head]
    code_sym = table_sym[head]
    for ln in long_lengths:
        todo = code_len == 0
        v = (win[todo] >> np.uint64(64 - ln)).astype(np.int64) - first[ln]
        hit = (v >= 0) & (v < len(by_length[ln]))
        at = np.flatnonzero(todo)[hit]
        code_len[at] = ln
        code_sym[at] = by_length[ln][v[hit]]
    rlc = iM
    is_run = code_sym == rlc
    run_at = np.flatnonzero(is_run)
    after = run_at + code_len[run_at]
    run_len = np.zeros(n_bits, np.int64)
    ok = after + 8 <= n_bits
    run_len[run_at[ok]] = (win[after[ok]] >> np.uint64(56)).astype(np.int64)
    step = code_len + np.where(is_run, 8, 0)

    # walk the codes from bit 0, one step a code
    steps, at, p = step.tolist(), [], 0
    while p < n_bits:
        at.append(p)
        s = steps[p]
        if s == 0 or p + s > n_bits:
            raise ValueError("PIZ: invalid Huffman code")
        p += s
    at = np.asarray(at, np.int64)
    runs = is_run[at]
    if len(at) and runs[0]:
        raise ValueError("PIZ: run-length code before any symbol")
    # a run code repeats the symbol before it run_len more times
    keep = at[~runs]
    owner = np.cumsum(~runs) - 1
    reps = np.ones(len(keep), np.int64)
    np.add.at(reps, owner[runs], run_len[at[runs]])
    if int(reps.sum()) != n_out:
        raise ValueError(f"PIZ: decoded {int(reps.sum())} values, expected "
                         f"{n_out}")
    return np.repeat(code_sym[keep].astype(np.uint16), reps)


def _wdec14(lo: np.ndarray, hi: np.ndarray):
    ls = lo.view(np.int16).astype(np.int32)
    hs = hi.view(np.int16).astype(np.int32)
    a = ls + (hs & 1) + (hs >> 1)
    return (a & 0xFFFF).astype(np.uint16), ((a - hs) & 0xFFFF).astype(np.uint16)


def _wdec16(lo: np.ndarray, hi: np.ndarray):
    m, d = lo.astype(np.int32), hi.astype(np.int32)
    b = (m - (d >> 1)) & 0xFFFF
    a = (d + b - (1 << 15)) & 0xFFFF
    return a.astype(np.uint16), b.astype(np.uint16)


def _wav2_decode(a: np.ndarray, max_value: int) -> None:
    """OpenEXR's wav2Decode on the [ny, nx] uint16 array a, in place: the
    levels from the coarsest, each level's 2x2 blocks at once."""
    dec = _wdec14 if max_value < (1 << 14) else _wdec16
    ny, nx = a.shape
    n, p = min(nx, ny), 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2, p = p, p >> 1
    while p >= 1:
        ry, rx = (ny - p2) // p2 + 1, (nx - p2) // p2 + 1
        y0, y1 = slice(0, ry * p2, p2), slice(p, ry * p2, p2)
        x0, x1 = slice(0, rx * p2, p2), slice(p, rx * p2, p2)
        i00, i10 = dec(a[y0, x0], a[y1, x0])
        i01, i11 = dec(a[y0, x1], a[y1, x1])
        a[y0, x0], a[y0, x1] = dec(i00, i01)
        a[y1, x0], a[y1, x1] = dec(i10, i11)
        if nx & p:
            xe = rx * p2
            a[y0, xe], a[y1, xe] = dec(a[y0, xe], a[y1, xe])
        if ny & p:
            ye = ry * p2
            a[ye, x0], a[ye, x1] = dec(a[ye, x0], a[ye, x1])
        p2, p = p, p >> 1


def piz_decode(data: bytes, nx: list[int], ny: list[int]) -> np.ndarray:
    """One PIZ-compressed scanline chunk of HALF channels → the planar
    uint16 half bit patterns (channels in file order, each ny[i] rows of
    nx[i] values), the JAX package's native decoder's output."""
    total = sum(w * h for w, h in zip(nx, ny))
    if len(data) < 4:
        raise ValueError("PIZ: chunk too short")
    min_nz, max_nz = struct.unpack_from("<HH", data, 0)
    if max_nz >= _BITMAP_SIZE:
        raise ValueError("PIZ: bad bitmap range")
    pos = 4
    bitmap = np.zeros(_BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        n = max_nz - min_nz + 1
        if pos + n > len(data):
            raise ValueError("PIZ: truncated bitmap")
        bitmap[min_nz:max_nz + 1] = np.frombuffer(data, np.uint8, n, pos)
        pos += n
    present = np.unpackbits(bitmap, bitorder="little").astype(bool)
    present[0] = True
    lut = np.zeros(1 << 16, np.uint16)
    values = np.flatnonzero(present)
    lut[:len(values)] = values
    if pos + 4 > len(data):
        raise ValueError("PIZ: truncated chunk")
    (huf_len,) = struct.unpack_from("<I", data, pos)
    pos += 4
    if pos + huf_len > len(data):
        raise ValueError("PIZ: truncated Huffman block")
    out = _huf_uncompress(data[pos:pos + huf_len], total)
    off = 0
    for w, h in zip(nx, ny):
        _wav2_decode(out[off:off + w * h].reshape(h, w), len(values) - 1)
        off += w * h
    return lut[out]


def read_exr_rgb(path: str) -> np.ndarray:
    """[H, W, 3 or 4] float32 (linear) from R/G/B(/A) channels."""
    ch = read_exr(path)
    names = [n for n in ("R", "G", "B", "A") if n in ch]
    if len(names) < 3:
        raise ValueError(f"{path}: no RGB channels (has {list(ch)})")
    return np.stack([ch[n] for n in names], axis=-1)


def write_exr_zip(path: str, img: np.ndarray,
                  channel_names: tuple[str, ...] | None = None) -> None:
    """Write [H, W, C] float32 as a ZIP-compressed (16 lines a block)
    scanline EXR of FLOAT channels, R, G, B, A by default."""
    img = np.asarray(img, np.float32)
    H, W, C = img.shape
    if channel_names is None:
        channel_names = ("R", "G", "B", "A")[:C] if C <= 4 else tuple(
            f"c{i}" for i in range(C))
    order = sorted(range(C), key=lambda i: channel_names[i])

    def attr(name: str, atype: str, data: bytes) -> bytes:
        return (name.encode() + b"\x00" + atype.encode() + b"\x00"
                + struct.pack("<i", len(data)) + data)

    chan_data = b"".join(channel_names[i].encode() + b"\x00"
                         + struct.pack("<i", 2)           # FLOAT
                         + b"\x00\x00\x00\x00" + struct.pack("<ii", 1, 1)
                         for i in order) + b"\x00"
    dw = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = (struct.pack("<iI", _MAGIC, 2)
              + attr("channels", "chlist", chan_data)
              + attr("compression", "compression", b"\x03")
              + attr("dataWindow", "box2i", dw)
              + attr("displayWindow", "box2i", dw)
              + attr("lineOrder", "lineOrder", b"\x00")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\x00")

    lpb = _LINES_PER_BLOCK[3]
    blocks = []
    for y0 in range(0, H, lpb):
        raw = b"".join(img[y, :, i].tobytes()
                       for y in range(y0, min(y0 + lpb, H)) for i in order)
        # the reader's postprocess undone: byte-split, then delta-encode
        b8 = np.frombuffer(raw, np.uint8)
        split = np.concatenate([b8[0::2], b8[1::2]]).astype(np.int32)
        deltas = np.concatenate([split[:1], (split[1:] - split[:-1] + 128)
                                 % 256]).astype(np.uint8)
        comp = zlib.compress(deltas.tobytes())
        blocks.append((y0, comp if len(comp) < len(b8) else raw))

    with open(path, "wb") as f:
        f.write(header)
        offsets, pos = [], len(header) + 8 * len(blocks)
        for _, comp in blocks:
            offsets.append(pos)
            pos += 8 + len(comp)
        f.write(struct.pack(f"<{len(blocks)}Q", *offsets))
        for y0, comp in blocks:
            f.write(struct.pack("<ii", y0, len(comp)) + comp)


# ---------------------------------------------------------------------------
# Radiance HDR (.hdr) — RGBE with adaptive RLE
# ---------------------------------------------------------------------------

def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance RGBE .hdr file → [H, W, 3] float32 (linear)."""
    with open(path, "rb") as f:
        line = f.readline()
        if not line.startswith(b"#?"):
            raise ValueError("not a Radiance HDR file")
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n"):
                break
            if line == b"":
                raise ValueError("truncated HDR header")
        dims = f.readline().split()
        if dims[0] != b"-Y" or dims[2] != b"+X":
            raise ValueError(f"unsupported HDR orientation {dims}")
        H, W = int(dims[1]), int(dims[3])
        data = f.read()

    img = np.empty((H, W, 4), np.uint8)
    pos = 0
    for y in range(H):
        # adaptive RLE scanline marker: 0x02 0x02 hi lo
        if (W >= 8 and W < 32768 and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == W):
            pos += 4
            for c in range(4):
                x = 0
                while x < W:
                    count = data[pos]
                    pos += 1
                    if count > 128:  # run
                        img[y, x:x + count - 128, c] = data[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        img[y, x:x + count, c] = np.frombuffer(
                            data[pos:pos + count], np.uint8)
                        pos += count
                        x += count
        else:  # flat RGBE (possibly old-style RLE, not handled)
            row = np.frombuffer(data[pos:pos + 4 * W],
                                np.uint8).reshape(W, 4)
            img[y] = row
            pos += 4 * W

    rgbe = img.astype(np.float32)
    exp = np.ldexp(1.0, img[:, :, 3].astype(np.int32) - 136)  # 128 + 8
    rgb = rgbe[:, :, :3] * exp[:, :, None]
    rgb[img[:, :, 3] == 0] = 0.0
    return rgb
