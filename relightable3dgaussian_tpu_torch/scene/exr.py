"""OpenEXR scanline reader and ZIP writer, Radiance HDR reader.

The port's own copy of relightable3dgaussian_tpu/scene/exr.py, numpy only
(the port imports nothing of the JAX package and loads none of its native
code). The formats are read from their specs:

  * EXR: version-2 scanline files; NONE/RLE/ZIPS/ZIP decoded in numpy
    (zlib + delta predictor + byte de-interleave); HALF/FLOAT/UINT
    channels. PIZ (wavelet + Huffman), which the JAX package decodes with
    its C++ module, raises NotImplementedError: its decoder is the last,
    droppable part of ROADMAP queue 1 item 3. `write_exr_zip` writes FLOAT
    channels ZIP-compressed, byte for byte as the JAX package does (the
    env maps of the relighting tests and chip_smoke.py).
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
            if comp == 4:
                raise NotImplementedError(
                    f"{path}: PIZ-compressed EXR is not read by the port yet "
                    "(ROADMAP queue 1 item 3, the PIZ decoder); store the "
                    "map with ZIP, RLE or no compression")
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
