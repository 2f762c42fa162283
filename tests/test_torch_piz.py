"""The port's numpy PIZ decoder (scene/exr.py::piz_decode) against the JAX
package's C++ one (native.piz_decode), bit for bit, on chunks written by
the PIZ encoder below (OpenEXR's piz.cpp and huf.cpp, in numpy; neither
package writes PIZ): HALF images of 1 and 3 channels, widths that are not
multiples of the wavelet's blocks, constant channels (the Huffman
run-length code), and value sets that take the 14-bit and the
16-bit-modulo wavelet. Whole PIZ EXR files read by read_exr_rgb against
the JAX reader."""
import heapq
import struct
import zlib

import numpy as np
import pytest

from relightable3dgaussian_tpu import native
from relightable3dgaussian_tpu.scene.exr import read_exr_rgb as jax_read_rgb
from relightable3dgaussian_tpu_torch.scene import exr

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="the JAX package's native library")

BITMAP_SIZE = 8192
SHORT_ZEROCODE_RUN, LONG_ZEROCODE_RUN = 59, 63
SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN
LONGEST_LONG_RUN = 255 + SHORTEST_LONG_RUN


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

def _wenc14(a, b):
    a, b = a.view(np.int16).astype(np.int32), b.view(np.int16).astype(np.int32)
    return (((a + b) >> 1) & 0xFFFF).astype(np.uint16), ((a - b) & 0xFFFF).astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int32) + (1 << 15)) & 0xFFFF
    b = b.astype(np.int32)
    m = (ao + b) >> 1
    d = ao - b
    m = np.where(d < 0, (m + (1 << 15)) & 0xFFFF, m)
    return m.astype(np.uint16), (d & 0xFFFF).astype(np.uint16)


def wav2_encode(a: np.ndarray, max_value: int) -> None:
    """OpenEXR's wav2Encode on [ny, nx] uint16, in place."""
    enc = _wenc14 if max_value < (1 << 14) else _wenc16
    ny, nx = a.shape
    n, p, p2 = min(nx, ny), 1, 2
    while p2 <= n:
        ry, rx = (ny - p2) // p2 + 1, (nx - p2) // p2 + 1
        y0, y1 = slice(0, ry * p2, p2), slice(p, ry * p2, p2)
        x0, x1 = slice(0, rx * p2, p2), slice(p, rx * p2, p2)
        i00, i01 = enc(a[y0, x0], a[y0, x1])
        i10, i11 = enc(a[y1, x0], a[y1, x1])
        a[y0, x0], a[y1, x0] = enc(i00, i10)
        a[y0, x1], a[y1, x1] = enc(i01, i11)
        if nx & p:
            xe = rx * p2
            a[y0, xe], a[y1, xe] = enc(a[y0, xe], a[y1, xe])
        if ny & p:
            ye = ry * p2
            a[ye, x0], a[ye, x1] = enc(a[ye, x0], a[ye, x1])
        p, p2 = p2, p2 << 1


def _code_lengths(freq: dict) -> dict:
    """Huffman code lengths of the symbols in freq (count > 0)."""
    heap = [(f, i, [s]) for i, (s, f) in enumerate(sorted(freq.items()))]
    heapq.heapify(heap)
    length = {s: 0 for s in freq}
    if len(heap) == 1:
        return {s: 1 for s in freq}
    tie = len(heap)
    while len(heap) > 1:
        f1, _, s1 = heapq.heappop(heap)
        f2, _, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            length[s] += 1
        heapq.heappush(heap, (f1 + f2, tie, s1 + s2))
        tie += 1
    return length


def _canonical(length: dict) -> dict:
    """hufCanonicalCodeTable: symbol → code."""
    n = np.zeros(59, np.int64)
    for ln in length.values():
        n[ln] += 1
    first, c = {}, 0
    for ln in range(58, 0, -1):
        first[ln] = c
        c = (c + int(n[ln])) >> 1
    code = {}
    for s in sorted(length):
        code[s] = first[length[s]]
        first[length[s]] += 1
    return code


def _pack_bits(values: np.ndarray, widths: np.ndarray) -> tuple[bytes, int]:
    """Each value's low `width` bits, MSB first, concatenated."""
    widths = np.asarray(widths, np.int64)
    n = int(widths.sum())
    if n == 0:
        return b"", 0
    v = np.repeat(np.asarray(values, np.uint64), widths)
    w = np.repeat(widths, widths)
    j = np.arange(n) - np.repeat(np.cumsum(widths) - widths, widths)
    bits = ((v >> (w - 1 - j).astype(np.uint64)) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits).tobytes(), n


def huf_compress(raw: np.ndarray, force_runs: bool = False) -> bytes:
    """hufCompress: canonical Huffman with the run-length pseudo-symbol
    iM (+1 past the largest symbol); `force_runs` uses the run code for
    every run of 2 or more."""
    raw = np.asarray(raw, np.int64)
    syms, counts = np.unique(raw, return_counts=True)
    freq = dict(zip(syms.tolist(), counts.tolist()))
    im, rlc = int(syms[0]), int(syms[-1]) + 1
    freq[rlc] = 1
    length = _code_lengths(freq)
    code = _canonical(length)
    # the table
    fields, widths = [], []
    s = im
    while s <= rlc:
        ln = length.get(s, 0)
        if ln == 0:
            zerun = 1
            while s < rlc and zerun < LONGEST_LONG_RUN and length.get(s + 1, 0) == 0:
                s += 1
                zerun += 1
            if zerun >= 2:
                if zerun >= SHORTEST_LONG_RUN:
                    fields += [LONG_ZEROCODE_RUN, zerun - SHORTEST_LONG_RUN]
                    widths += [6, 8]
                else:
                    fields.append(SHORT_ZEROCODE_RUN + zerun - 2)
                    widths.append(6)
                s += 1
                continue
        fields.append(ln)
        widths.append(6)
        s += 1
    table, _ = _pack_bits(np.array(fields), np.array(widths))
    # the runs of equal values, cut at 256
    starts = np.flatnonzero(np.r_[True, raw[1:] != raw[:-1]])
    lens = np.diff(np.r_[starts, len(raw)])
    pieces = np.concatenate([np.minimum(256, ln - 256 * np.arange(-(-ln // 256)))
                             for ln in lens])
    vals = np.repeat(raw[starts], -(-lens // 256))
    emit_v, emit_w = [], []
    rl = length[rlc]
    for v, k in zip(vals.tolist(), pieces.tolist()):
        ls, cs = length[v], k - 1
        if (force_runs and cs >= 1) or ls + rl + 8 < ls * cs:
            emit_v += [code[v], code[rlc], cs]
            emit_w += [ls, rl, 8]
        else:
            emit_v += [code[v]] * k
            emit_w += [ls] * k
    data, n_bits = _pack_bits(np.array(emit_v), np.array(emit_w))
    return struct.pack("<5I", im, rlc, len(table), n_bits, 0) + table + data


def piz_compress(planar: np.ndarray, nx: int, ny: int, n_channels: int,
                 force_runs: bool = False) -> bytes:
    """One chunk: [n_channels * ny * nx] uint16 half patterns → PIZ."""
    planar = np.asarray(planar, np.uint16)
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    np.bitwise_or.at(bitmap, planar >> 3, (1 << (planar & 7)).astype(np.uint8))
    bitmap[0] &= 0xFE
    nz = np.flatnonzero(bitmap)
    lo, hi = (int(nz[0]), int(nz[-1])) if len(nz) else (BITMAP_SIZE - 1, 0)
    present = np.unpackbits(bitmap, bitorder="little").astype(bool)
    present[0] = True
    fwd = np.zeros(1 << 16, np.uint16)
    fwd[present] = np.arange(int(present.sum()))
    data = fwd[planar]
    for c in range(n_channels):
        wav2_encode(data[c * nx * ny:(c + 1) * nx * ny].reshape(ny, nx),
                    int(present.sum()) - 1)
    huf = huf_compress(data, force_runs)
    body = bitmap[lo:hi + 1].tobytes() if lo <= hi else b""
    return struct.pack("<HH", lo, hi) + body + struct.pack("<I", len(huf)) + huf


def write_exr_piz(path, img: np.ndarray) -> None:
    """[H, W, C] float16 → a PIZ scanline EXR of HALF channels (R, G, B,
    A), 32 lines a chunk; a chunk PIZ does not shrink is stored raw."""
    H, W, C = img.shape
    names = ("R", "G", "B", "A")[:C]
    order = sorted(range(C), key=lambda i: names[i])

    def attr(name, atype, data):
        return (name.encode() + b"\0" + atype.encode() + b"\0"
                + struct.pack("<i", len(data)) + data)

    chans = b"".join(names[i].encode() + b"\0" + struct.pack("<i", 1)
                     + b"\0" * 4 + struct.pack("<ii", 1, 1) for i in order) + b"\0"
    dw = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = (struct.pack("<iI", 20000630, 2) + attr("channels", "chlist", chans)
              + attr("compression", "compression", b"\x04")
              + attr("dataWindow", "box2i", dw) + attr("displayWindow", "box2i", dw)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0)) + b"\0")
    bits = img.astype(np.float16).view(np.uint16)
    blocks = []
    for y0 in range(0, H, 32):
        rows = bits[y0:y0 + 32]
        planar = np.concatenate([rows[:, :, i].ravel() for i in order])
        comp = piz_compress(planar, W, rows.shape[0], C)
        raw = b"".join(rows[r, :, i].tobytes() for r in range(rows.shape[0])
                       for i in order)
        blocks.append((y0, comp if len(comp) < len(raw) else raw))
    with open(path, "wb") as f:
        f.write(header)
        pos = len(header) + 8 * len(blocks)
        offsets = []
        for _, b in blocks:
            offsets.append(pos)
            pos += 8 + len(b)
        f.write(struct.pack(f"<{len(blocks)}Q", *offsets))
        for y0, b in blocks:
            f.write(struct.pack("<ii", y0, len(b)) + b)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def smooth_half(rng, h, w, c, scale=1.0) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([np.sin(3 * x + k) * np.cos(2 * y - k) + 1.2
                    for k in range(c)], -1) * scale
    return (img + 0.01 * rng.normal(size=img.shape)).astype(np.float16)


def chunk_case(kind: str, rng):
    if kind == "rgb_odd_width":
        img = smooth_half(rng, 32, 75, 3)
    elif kind == "one_channel":
        img = smooth_half(rng, 17, 33, 1)
    elif kind == "constant_channels":
        img = np.stack([np.full((32, 40), 0.5), np.zeros((32, 40)),
                        np.full((32, 40), 7.0)], -1).astype(np.float16)
    elif kind == "wavelet16":      # > 2^14 distinct values
        img = rng.integers(0, 1 << 16, (32, 701, 1), dtype=np.uint16).view(np.float16)
    elif kind == "narrow":         # one column, one row
        img = smooth_half(rng, 1, 1, 3)
    else:                          # a 3-wide, 5-tall block
        img = smooth_half(rng, 5, 3, 3, 100.0)
    h, w, c = img.shape
    planar = np.concatenate([img[..., i].view(np.uint16).ravel() for i in range(c)])
    return planar, w, h, c


@pytest.mark.parametrize("kind", ["rgb_odd_width", "one_channel",
                                  "constant_channels", "wavelet16", "narrow",
                                  "small_block"])
@pytest.mark.parametrize("force_runs", [False, True])
def test_piz_decode_matches_native(kind, force_runs):
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    planar, w, h, c = chunk_case(kind, rng)
    data = piz_compress(planar, w, h, c, force_runs)
    want = native.piz_decode(data, [w] * c, [h] * c)
    got = exr.piz_decode(data, [w] * c, [h] * c)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, planar)      # the encoder round trip


def test_piz_cases_take_both_wavelets_and_the_run_code():
    rng = np.random.default_rng(0)
    planar, *_ = chunk_case("wavelet16", rng)
    assert len(np.unique(planar)) > (1 << 14)
    planar, *_ = chunk_case("rgb_odd_width", rng)
    assert len(np.unique(planar)) < (1 << 14)
    planar, w, h, c = chunk_case("constant_channels", rng)
    huf = huf_compress(planar)
    # the constant runs are sent as the run-length code: far fewer bits
    # than one code a value
    assert struct.unpack_from("<I", huf, 12)[0] < planar.size // 4


def test_corrupt_piz_chunk_raises():
    rng = np.random.default_rng(1)
    planar, w, h, c = chunk_case("rgb_odd_width", rng)
    data = bytearray(piz_compress(planar, w, h, c))
    with pytest.raises(ValueError):
        exr.piz_decode(bytes(data[:len(data) // 2]), [w] * c, [h] * c)


@pytest.mark.parametrize("shape", [(70, 45, 3), (64, 64, 4)])
def test_read_exr_rgb_of_a_piz_file_matches_the_jax_reader(tmp_path, shape):
    img = smooth_half(np.random.default_rng(2), *shape, scale=3.0)
    path = str(tmp_path / "map.exr")
    write_exr_piz(path, img)
    want = jax_read_rgb(path)
    got = exr.read_exr_rgb(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img.astype(np.float32))


def test_read_exr_rgb_reads_a_piz_chunk_stored_raw(tmp_path):
    """A chunk that PIZ does not shrink (here the last one, one line) is
    stored uncompressed, as OpenEXR writes it; the port reads it."""
    img = smooth_half(np.random.default_rng(3), 33, 64, 4, scale=3.0)
    path = str(tmp_path / "map.exr")
    write_exr_piz(path, img)
    np.testing.assert_array_equal(exr.read_exr_rgb(path),
                                  img.astype(np.float32))
