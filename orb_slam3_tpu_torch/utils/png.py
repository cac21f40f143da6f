"""A PNG codec on the standard library's zlib and numpy.

A CUDA host need not have OpenCV or libpng, and every dataset the drivers read (EuRoC,
TUM RGB-D with its 16-bit depth, TUM-VI, KITTI) ships PNG, so the port
decodes and encodes its images here:

- `decode` reads non-interlaced 1/2/4/8/16-bit grey, grey + alpha, RGB,
  RGBA and palette images with all five row filters and returns the
  samples as they are stored ([H, W] or [H, W, C], uint8 or uint16, colour
  in RGB order);
- `read_gray` is `cv2.imread(path, cv2.IMREAD_GRAYSCALE)`: alpha dropped,
  16-bit samples cut to their high byte, colour weighted 0.299 / 0.587 /
  0.114 (libpng's rgb_to_gray in 15-bit fixed point, rounded);
- `encode` writes grey or RGB (8 or 16 bit) with a filter for every row;
- `read` also reads a binary PGM (P5), as the native frame loader does.

A row filtered with Average or Paeth depends on the pixel to its left, so
an image holding such rows is reconstructed along anti-diagonals (each
pixel needs its left, upper and upper-left neighbours only): H + W
vectorised steps instead of H * W scalar ones. An image whose rows use
only None, Sub and Up is undone by two running sums over the whole image,
some fifty times faster.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples per pixel
# libpng's default rgb_to_gray coefficients (png_set_rgb_to_gray with 0.299,
# 0.587), in 15-bit fixed point as libpng stores them
_GRAY_R, _GRAY_G = 9798, 19235
_GRAY_B = 32768 - _GRAY_R - _GRAY_G


class PNGError(ValueError):
    """The bytes are not a PNG image this codec reads."""


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise PNGError("truncated PNG: no IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of `raw` ([h, 1 + stride] bytes) -> [h,
    stride] uint8. `bpp`: bytes per complete pixel, at least 1."""
    ftype = raw[:, 0]
    data = raw[:, 1:]
    if ftype.max(initial=0) > 4:
        raise PNGError(f"unknown row filter {int(ftype.max())}")
    P = stride // bpp   # whole pixels: bpp is 1 below 8 bits per pixel
    if not np.isin(ftype, (3, 4)).any():
        # None and Sub rows stand alone (Sub: a running sum along the row,
        # per byte of the pixel, modulo 256); a run of Up rows adds up the
        # rows from the last non-Up row: a running sum down the columns,
        # less its value before that row
        x = data.copy()
        sub = ftype == 1
        if sub.any():
            x[sub] = np.cumsum(x[sub].reshape(-1, P, bpp), axis=1,
                               dtype=np.uint8).reshape(-1, stride)
        up = ftype == 2
        if up.any():
            cs = np.zeros((h + 1, stride), np.uint8)
            np.cumsum(x, axis=0, dtype=np.uint8, out=cs[1:])
            start = np.maximum.accumulate(np.where(up, 0, np.arange(h)))
            x = cs[1:] - cs[start]
        return x
    # anti-diagonal wavefront over pixels (groups of bpp bytes)
    x = data.astype(np.int32).reshape(h, P, bpp)
    rec = np.zeros((h + 1, P + 1, bpp), np.int32)   # a zero row above, a zero column left
    f_all = ftype.astype(np.int32)
    for d in range(h + P - 1):
        r = np.arange(max(0, d - P + 1), min(h - 1, d) + 1)
        p = d - r
        a = rec[r + 1, p]
        b = rec[r, p + 1]
        c = rec[r, p]
        f = f_all[r][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, c), 0))))
        rec[r + 1, p + 1] = (x[r, p] + pred) & 0xFF
    return rec[1:, 1:].reshape(h, stride).astype(np.uint8)


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> the stored samples: [H, W] (grey) or [H, W, C] (grey +
    alpha, RGB, RGBA; a palette image expands to RGB or RGBA), uint8 or
    uint16 (16-bit files). Raises PNGError naming `name` for another format
    (a JPEG included) or an interlaced file."""
    if not data.startswith(SIGNATURE):
        kind = "JPEG" if data[:3] == b"\xff\xd8\xff" else "not PNG"
        raise PNGError(f"{name}: {kind}; the port's codec reads PNG only")
    ihdr = None
    palette = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise PNGError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise PNGError(f"{name}: interlaced PNG is not supported")
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise PNGError(f"{name}: colour type {ctype} at bit depth {depth}")
    ch = _CHANNELS[ctype]
    bits = ch * depth
    stride = (w * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise PNGError(f"{name}: image data shorter than {h} rows of {stride} bytes")
    rows = _unfilter(raw[:h * (stride + 1)].reshape(h, stride + 1), h, stride,
                     max(1, bits // 8))
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    elif depth == 8:
        img = rows.reshape(h, w, ch)
    else:
        per = 8 // depth
        shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
        img = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
        img = img[:, :, None].astype(np.uint8)
        if ctype == 0:  # scale grey to the full 8-bit range, as libpng's expand does
            img = (img.astype(np.uint16) * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if ctype == 3:
        if palette is None:
            raise PNGError(f"{name}: palette image without PLTE")
        idx = img[:, :, 0]
        rgb = palette[idx]
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[:len(trns)] = trns
            rgb = np.concatenate([rgb, alpha[idx][:, :, None]], axis=-1)
        return rgb
    return img[:, :, 0] if ch == 1 else img


def decode_pgm(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A binary PGM (P5, 8 or 16 bit) -> [H, W] uint8 or uint16."""
    fields, pos = [], 2
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    w, h, maxval = fields
    body = data[pos + 1:]
    dt = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
    if len(body) < w * h * dt.itemsize:
        raise PNGError(f"{name}: PGM data shorter than {w}x{h}")
    img = np.frombuffer(body, dt, count=w * h).reshape(h, w)
    return img.astype(np.uint16) if maxval > 255 else img.copy()


def read(path: str) -> np.ndarray:
    """`decode` of a file (cv2.IMREAD_UNCHANGED with colour in RGB order);
    a binary PGM is read too."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"P5":
        return decode_pgm(data, path)
    return decode(data, path)


def to_gray8(img: np.ndarray) -> np.ndarray:
    """Decoded samples -> 8-bit grey as cv2.IMREAD_GRAYSCALE gives it."""
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return img
    if img.shape[-1] in (1, 2):   # grey (+ alpha)
        return img[..., 0]
    rgb = img[..., :3].astype(np.int32)
    y = (_GRAY_R * rgb[..., 0] + _GRAY_G * rgb[..., 1] + _GRAY_B * rgb[..., 2] + 16384) >> 15
    return np.clip(y, 0, 255).astype(np.uint8)


def read_gray(path: str) -> np.ndarray:
    """cv2.imread(path, cv2.IMREAD_GRAYSCALE): [H, W] uint8."""
    return to_gray8(read(path))


def _filter_rows(rows: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """Apply filter `ftype` to every row of `rows` ([h, stride] uint8)."""
    x = rows.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1, 4: _paeth(a, b, c)}[ftype]
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode(img: np.ndarray, filter_type=1, level: int = 6) -> bytes:
    """[H, W] grey or [H, W, 3] RGB samples (uint8 or uint16) -> PNG bytes,
    every row with filter `filter_type` (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth), or row r with filter_type[r], deflated at zlib `level`."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise PNGError(f"encode takes uint8 or uint16 samples, not {img.dtype}")
    if img.ndim == 2:
        ctype, ch = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, ch = 2, 3
    else:
        raise PNGError(f"encode takes [H, W] or [H, W, 3], not {img.shape}")
    h, w = img.shape[:2]
    ftypes = np.broadcast_to(np.asarray(filter_type, np.uint8), (h,))
    if ftypes.max(initial=0) > 4:
        raise PNGError(f"unknown row filter {int(ftypes.max())}")
    depth = 16 if img.dtype == np.uint16 else 8
    samples = img.astype(">u2") if depth == 16 else img
    rows = np.frombuffer(np.ascontiguousarray(samples).tobytes(), np.uint8).reshape(h, -1)
    filtered = np.empty_like(rows)
    for f in np.unique(ftypes):
        sel = ftypes == f
        filtered[sel] = _filter_rows(rows, ch * depth // 8, int(f))[sel]
    raw = np.concatenate([ftypes[:, None], filtered], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def write(path: str, img: np.ndarray, filter_type=1) -> int:
    """`encode` to a file; returns the bytes written."""
    data = encode(img, filter_type)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
