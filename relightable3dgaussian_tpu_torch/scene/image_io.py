"""Image, mask, depth and normal-map files (port of relightable3dgaussian_tpu/scene/image_io.py).

The JAX package reads and writes PNGs through imageio; the machine the port
runs on has neither imageio nor Pillow, so the port carries its own PNG codec
on numpy and `zlib`: it reads 8-bit greyscale, grey+alpha, RGB and RGBA
files with any of the five row filters (not interlaced, not palette, not 16
bits), and writes the same four kinds. The arrays are imageio's:
[H, W] for grey, [H, W, C] otherwise, uint8. The MVS depth maps
(`extra/depths/*.tiff`) are baseline TIFFs of one float32 channel, which
the JAX package writes through imageio: the port reads and writes
them with its own numpy codec (uncompressed, any number of strips, either
byte order). PFM is parsed and written as the JAX package does; EXR and
Radiance HDR go through `scene/exr.py`.

`resize_image` is the JAX package's `jax.image.resize(..., "bilinear")`:
a triangle filter whose support widens by the scale factor when it shrinks
an image (antialiased), which `F.interpolate(..., antialias=True)` computes;
`resize2d` is the same on tensors, on any device.
"""
from __future__ import annotations

import os
import re
import struct
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.graphics import rgb_to_srgb

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples per pixel


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _chunks(data: bytes, path: str):
    pos = len(_PNG_SIGNATURE)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + length


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: raw [h, 1 + w·bpp] → [h, w, bpp] uint8."""
    ftype = raw[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"PNG filter type {int(ftype.max())} is not defined")
    data = raw[:, 1:].reshape(h, w, bpp)
    if not np.isin(ftype, (3, 4)).any():
        # None, Sub and Up: row by row, vectorised within a row.
        out = np.empty((h, w, bpp), np.uint8)
        prev = np.zeros((w, bpp), np.uint8)
        for y in range(h):
            row = data[y]
            if ftype[y] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif ftype[y] == 2:
                row = row + prev
            out[y] = row
            prev = out[y]
        return out
    # Average and Paeth depend on the left, upper and upper-left bytes: walk
    # the anti-diagonals y + x = k, whose pixels depend only on earlier ones.
    data = data.astype(np.int16)
    out = np.zeros((h + 1, w + 1, bpp), np.int16)   # out[y + 1, x + 1]
    for k in range(h + w - 1):
        y = np.arange(max(0, k - w + 1), min(h - 1, k) + 1)
        x = k - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        f = ftype[y][:, None]
        pred = np.select([f == 0, f == 1, f == 2, f == 3],
                         [np.zeros_like(a), a, b, (a + b) >> 1],
                         _paeth(a, b, c))
        out[y + 1, x + 1] = (data[y, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit PNG → uint8 [H, W] (grey) or [H, W, C] (C = 2, 3, 4)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise NotImplementedError(
            f"{path}: PNG with bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}; the port reads 8-bit grey, grey+alpha, "
            "RGB and RGBA without interlacing")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw.reshape(h, 1 + w * bpp), h, w, bpp)
    return img[..., 0] if bpp == 1 else img


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 [H, W] (grey) or [H, W, C] (C = 1, 2, 3, 4) → an 8-bit PNG,
    every row unfiltered."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    ctype = 0 if img.ndim == 2 else (
        {2: 4, 3: 2, 4: 6}.get(img.shape[2]) if img.ndim == 3 else None)
    if ctype is None:
        raise ValueError(f"write_png takes [H, W] or [H, W, 2, 3 or 4], got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                           0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def _to_grey(img: np.ndarray) -> np.ndarray:
    """imageio's mode="L" (Pillow's convert("L")): ITU-R 601-2 luma in
    fixed point, alpha dropped."""
    if img.ndim == 2:
        return img
    if img.shape[2] <= 2:
        return img[..., 0]
    r, g, b = (img[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


# ---------------------------------------------------------------------------
# The loaders of the scene readers
# ---------------------------------------------------------------------------

def load_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file")
        m = re.match(rb"^(\d+)\s(\d+)\s*$", f.readline())
        if not m:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = map(int, m.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
        shape = (height, width, 3) if channels == 3 else (height, width)
        return np.ascontiguousarray(data.reshape(shape)[::-1])


def load_img_rgb(path: str) -> np.ndarray:
    """[H, W, 3 or 4] float32, PNG values / 255; EXR is tonemapped
    linear → sRGB (unclipped) like the reference loader (scene/utils.py:
    38-49); HDR stays linear."""
    if path.endswith(".exr"):
        from .exr import read_exr_rgb
        img = np.array(read_exr_rgb(path), np.float32)
        img[..., :3] = rgb_to_srgb(torch.from_numpy(img[..., :3]),
                                   clip=False).numpy()
        return img
    if path.endswith(".hdr"):
        from .exr import read_hdr
        return np.asarray(read_hdr(path), np.float32)
    return np.asarray(read_png(path), np.float32) / 255.0


def load_mask_bool(path: str) -> np.ndarray:
    """A mask file read as greyscale, thresholded at half its maximum:
    0 or 255, float32."""
    mask = _to_grey(read_png(path)).astype(np.float32)
    return (mask > 0.5 * mask.max()).astype(np.float32) * 255.0


def save_pfm(path: str, data: np.ndarray) -> None:
    """[H, W] or [H, W, 3] → a little-endian PFM, bottom row first."""
    data = np.asarray(data, np.float32)
    color = data.ndim == 3 and data.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        data[::-1].tofile(f)


# ---------------------------------------------------------------------------
# TIFF: one float32 channel, uncompressed (the MVS depth maps)
# ---------------------------------------------------------------------------

_TIFF_TYPES = {1: "B", 3: "H", 4: "I"}   # BYTE, SHORT, LONG


def read_tiff_float(path: str) -> np.ndarray:
    """A baseline TIFF of one uncompressed float32 channel → [H, W] float32:
    the first image, in as many strips as the file has."""
    with open(path, "rb") as f:
        data = f.read()
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None or struct.unpack(order + "H", data[2:4])[0] != 42:
        raise ValueError(f"{path}: not a classic TIFF file")
    (ifd,) = struct.unpack(order + "I", data[4:8])
    (n,) = struct.unpack(order + "H", data[ifd:ifd + 2])
    tags = {}
    for i in range(n):
        entry = data[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
        tag, kind, count = struct.unpack(order + "HHI", entry[:8])
        if kind not in _TIFF_TYPES:
            continue
        fmt = order + _TIFF_TYPES[kind] * count
        size = struct.calcsize(fmt)
        raw = (entry[8:8 + size] if size <= 4 else data[
            struct.unpack(order + "I", entry[8:])[0]:][:size])
        tags[tag] = struct.unpack(fmt, raw)
    width, height = tags[256][0], tags[257][0]
    layout = (tags.get(258, (1,))[0], tags.get(259, (1,))[0],
              tags.get(277, (1,))[0], tags.get(339, (1,))[0])
    if layout != (32, 1, 1, 3):
        raise NotImplementedError(
            f"{path}: TIFF with (bits, compression, samples, sample format) "
            f"{layout}; the port reads one uncompressed float32 channel "
            "(32, 1, 1, 3), as the MVS step writes its depth maps")
    body = b"".join(data[o:o + c] for o, c in zip(tags[273], tags[279]))
    img = np.frombuffer(body, order + "f4", width * height)
    return img.reshape(height, width).astype(np.float32)


def write_tiff_float(path: str, img: np.ndarray) -> None:
    """[H, W] → a little-endian baseline TIFF of one uncompressed float32
    channel (BlackIsZero) in one strip."""
    img = np.ascontiguousarray(img, "<f4")
    if img.ndim != 2:
        raise ValueError(f"write_tiff_float takes [H, W], got {img.shape}")
    h, w = img.shape
    tags = ((256, 4, w), (257, 4, h), (258, 3, 32), (259, 3, 1), (262, 3, 1),
            (273, 4, 8 + 2 + 12 * 10 + 4), (277, 3, 1), (278, 4, h),
            (279, 4, img.nbytes), (339, 3, 3))
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHI", tag, kind, 1)
        + struct.pack("<" + _TIFF_TYPES[kind], value).ljust(4, b"\0")
        for tag, kind, value in tags) + struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", 8) + ifd + img.tobytes())


def load_depth(path: str) -> np.ndarray:
    """An MVS depth map (`extra/depths/*.tiff`, written by the MVS step) →
    [H, W] float32."""
    return read_tiff_float(path)


def save_image_u8(path: str, img: np.ndarray) -> None:
    """[H, W, 3] (or [H, W]) float in [0, 1] → an 8-bit PNG, as the JAX
    package quantises it (clip, ×255, truncate)."""
    write_png(path, (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8))


def resize2d(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[..., H, W] float → [..., height, width] on x's device, the JAX
    package's `jax.image.resize(x, x.shape[:-2] + (height, width),
    "bilinear")` (antialiased when it shrinks)."""
    lead = x.shape[:-2]
    flat = x.reshape(1, -1, *x.shape[-2:])
    out = F.interpolate(flat, size=(height, width), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.reshape(*lead, height, width)


def resize_image(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """[H, W] or [H, W, C] float → [height, width(, C)] float32, the JAX
    package's `jax.image.resize(..., "bilinear")` (antialiased when it
    shrinks)."""
    x = torch.as_tensor(np.asarray(img, np.float32))
    if x.ndim == 2:
        return np.ascontiguousarray(resize2d(x, height, width).numpy())
    out = resize2d(x.permute(2, 0, 1), height, width).permute(1, 2, 0)
    return np.ascontiguousarray(out.numpy())
