"""Image decoding for the dataset loaders (the port's copy of the native
decoder's semantics, native/src/vslam_native.cpp:67-207), and histogram
equalization.

Formats: PNG (non-interlaced) gray8, gray16 and RGB8 — RGB8 becomes gray8
with the weights (299 r + 587 g + 114 b + 500) / 1000 — and binary PGM
(P5) at 8 and 16 bits.  Anything else raises ValueError naming the
format.  zlib (stdlib) inflates; `csrc/png_unfilter.cpp`, built with the
host compiler at first use (a failed build raises), reverses the row
filters of the whole image in one call: Average and Paeth make each byte
depend on the byte to its left, a serial walk that numpy cannot vectorize.
`unfilter_reference` is the plain per-byte version, for tests.
`write_png` writes the images that the tests and the smoke run read.

Needs neither cv2 nor the JAX package's native library.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from vslam_tpu_torch.ops.cuda_build import HostLibrary

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
UNFILTER = HostLibrary("png_unfilter.cpp")
_COLOR_TYPES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}


def unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse PNG's per-row filters: raw (h * (stride + 1),) uint8 of
    filter byte + filtered row -> (h, stride) uint8, in one call of the C
    function."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    fn = UNFILTER.load().vt_png_unfilter
    if fn.argtypes is None:
        fn.argtypes = [u8p, u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        fn.restype = ctypes.c_int
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty((h, stride), np.uint8)
    rc = fn(raw.ctypes.data_as(u8p), out.ctypes.data_as(u8p), h, stride, bpp)
    if rc < 0:
        y = -1 - rc
        raise ValueError(f"PNG: unknown row filter type {int(raw[y * (stride + 1)])}")
    return out


def unfilter_reference(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The plain per-byte version of `unfilter` (PNG spec, section 9)."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int64)
    for y in range(h):
        f = int(rows[y, 0])
        for x in range(stride):
            a = int(out[y, x - bpp]) if x >= bpp else 0
            b = int(out[y - 1, x]) if y else 0
            c = int(out[y - 1, x - bpp]) if y and x >= bpp else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            elif f == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                raise ValueError(f"PNG: unknown row filter type {f}")
            out[y, x] = (int(rows[y, 1 + x]) + pred) & 0xFF
    return out.astype(np.uint8)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 R, G, B -> gray8 with the native decoder's weights."""
    r, g, b = (rgb[..., k].astype(np.int32) for k in range(3))
    return ((299 * r + 587 * g + 114 * b + 500) // 1000).astype(np.uint8)


def decode_png(buf: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) uint8 or uint16."""
    if buf[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        if pos + 12 + length > len(buf):
            raise ValueError("PNG: truncated chunk")
        data = buf[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data[:13])
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if ihdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, color, _, _, interlace = ihdr
    name = _COLOR_TYPES.get(color, f"color type {color}")
    if interlace != 0:
        raise ValueError("PNG: interlaced (Adam7) images are not supported")
    if not ((color == 0 and depth in (8, 16)) or (color == 2 and depth == 8)):
        raise ValueError(f"PNG: {name} at {depth} bits is not supported "
                         "(gray 8/16-bit and RGB 8-bit are)")
    channels = 3 if color == 2 else 1
    bpp = channels * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG: image data holds {raw.size} bytes, expected "
                         f"{h * (stride + 1)}")
    flat = unfilter(raw, h, stride, bpp)
    if depth == 16:
        return flat.view(">u2").astype(np.uint16).reshape(h, w)
    if channels == 3:
        return rgb_to_gray(flat.reshape(h, w, 3))
    return flat.reshape(h, w)


def decode_pgm(buf: bytes) -> np.ndarray:
    """Binary PGM (P5) bytes -> (H, W) uint8 (maxval <= 255) or uint16."""
    if buf[:2] != b"P5":
        raise ValueError("not a binary PGM (P5) file")
    pos, fields = 2, []
    while len(fields) < 3:
        while pos < len(buf) and (buf[pos:pos + 1].isspace() or buf[pos] == ord("#")):
            if buf[pos] == ord("#"):
                while pos < len(buf) and buf[pos] != ord("\n"):
                    pos += 1
            else:
                pos += 1
        start = pos
        while pos < len(buf) and buf[pos:pos + 1].isdigit():
            pos += 1
        if pos == start:
            raise ValueError("PGM: malformed header")
        fields.append(int(buf[start:pos]))
    pos += 1  # the single whitespace byte after maxval
    w, h, maxval = fields
    dtype = ">u2" if maxval > 255 else np.uint8
    n = w * h * np.dtype(dtype).itemsize
    if len(buf) - pos < n:
        raise ValueError("PGM: truncated pixel data")
    return np.frombuffer(buf, dtype, w * h, pos).astype(
        np.uint16 if maxval > 255 else np.uint8).reshape(h, w)


def decode_image(path: str) -> np.ndarray:
    """Decode a PNG or PGM file to (H, W) uint8 or uint16.  Raises
    FileNotFoundError for a missing file and ValueError for a format the
    decoder does not read."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] == PNG_SIGNATURE:
        return decode_png(buf)
    if buf[:2] == b"P5":
        return decode_pgm(buf)
    raise ValueError(f"{path}: not a PNG or binary PGM (P5) file "
                     f"(starts with {buf[:8]!r})")


def _filter_rows(raw: np.ndarray, bpp: int, filters) -> bytes:
    """raw (h, stride) uint8 -> filtered scanlines, row y with filter type
    filters[y % len(filters)]."""
    out = []
    zeros = np.zeros(raw.shape[1], np.int32)
    for y in range(raw.shape[0]):
        f = filters[y % len(filters)]
        line = raw[y].astype(np.int32)
        b = raw[y - 1].astype(np.int32) if y else zeros
        a = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
        p = a + b - c
        paeth = np.where((abs(p - a) <= abs(p - b)) & (abs(p - a) <= abs(p - c)), a,
                         np.where(abs(p - b) <= abs(p - c), b, c))
        pred = [0, a, b, (a + b) // 2, paeth][f]
        out.append(bytes([f]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes())
    return b"".join(out)


def _png_chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(arr: np.ndarray, filters=(0,)) -> bytes:
    """A non-interlaced PNG of arr, (H, W) uint8 / uint16 gray or
    (H, W, 3) uint8 RGB, deflated by stdlib zlib at its fastest level;
    row y takes the filter type filters[y % len(filters)] (0-4)."""
    h, w = arr.shape[:2]
    depth = 16 if arr.dtype == np.uint16 else 8
    channels = 3 if arr.ndim == 3 else 1
    raw = (arr.astype(">u2") if depth == 16 else arr).reshape(h, -1).view(np.uint8)
    data = zlib.compress(_filter_rows(raw, channels * depth // 8, filters), 1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 2 if channels == 3 else 0, 0, 0, 0)
    return (PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr) + _png_chunk(b"IDAT", data)
            + _png_chunk(b"IEND", b""))


def write_png(path: str, arr: np.ndarray, filters=(0,)) -> None:
    """Write encode_png(arr, filters) to path."""
    with open(path, "wb") as f:
        f.write(encode_png(arr, filters))


def equalize(img: np.ndarray) -> np.ndarray:
    """Histogram equalization of an 8-bit image, OpenCV's equalizeHist
    (reference slam_assembly.cpp:391-410, -equalize-histogram): the LUT
    round(255 * cdf_above_first / (total - first_count)) in f32."""
    u8 = np.asarray(img).astype(np.uint8)
    hist = np.bincount(u8.reshape(-1), minlength=256)
    first = int(np.flatnonzero(hist)[0])
    total = u8.size
    if hist[first] == total:
        return np.full(u8.shape, first, np.float32)
    scale = np.float32(255.0) / np.float32(total - hist[first])
    lut = np.zeros(256, np.float32)
    csum = np.cumsum(hist[first + 1:]).astype(np.float32)
    lut[first + 1:] = np.clip(np.rint(csum * scale), 0, 255)
    return lut[u8]
