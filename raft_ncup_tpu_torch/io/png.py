"""A PNG codec on numpy and ``zlib``.

The JAX package decodes and encodes PNGs with OpenCV and Pillow; the
port has neither, so this module reads and writes the PNGs the
datasets, the submissions and the demo use:

- read: bit depth 8 or 16, colour types gray (0), RGB (2) and RGBA (6),
  not interlaced, all five row filters (None, Sub, Up, Average, Paeth);
- write: the same types, every row with the Up filter.

Samples come out as ``uint8`` or ``uint16`` arrays, (H, W) for gray and
(H, W, C) otherwise, channels in file order (RGB, not OpenCV's BGR).

Reading undoes None, Sub and Up one row at a time with whole-row numpy
operations. Average and Paeth make a byte depend on the pixel to its
left, the one above and the one above-left; a run of such rows is
decoded along anti-diagonals, every pixel of one diagonal by the same
few numpy operations.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}


def _chunks(data: bytes):
    """``(type, payload)`` of every chunk after the signature, CRCs checked."""
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("PNG: truncated chunk header")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(payload) != n or len(crc) != 4:
            raise ValueError(f"PNG: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + payload):
            raise ValueError(f"PNG: CRC mismatch in {kind!r} chunk")
        yield kind, payload
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG: no IEND chunk")


def _unfilter_diagonals(filt, average, above) -> np.ndarray:
    """Decode rows of (h, w, bpp) filtered bytes, each with the Average
    (``average`` true) or the Paeth filter, given the decoded row ``above``
    them (w, bpp)."""
    h, w, bpp = filt.shape
    # Decoded bytes with the row above on top and a zero pixel to the left.
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    out[0, 1:] = above
    ys_all = np.arange(h)
    for k in range(h + w - 1):
        y = ys_all[max(0, k - w + 1):min(h, k + 1)]
        x = k - y
        a = out[y + 1, x]  # left
        b = out[y, x + 1]  # above
        c = out[y, x]  # above-left
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        if average.any():
            pred = np.where(average[y][:, None], (a + b) >> 1, pred)
        out[y + 1, x + 1] = (filt[y, x] + pred) & 0xFF
    return out[1:, 1:]


def _unfilter(raw: np.ndarray, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``raw`` (h rows of a filter byte and
    ``row_bytes`` bytes) -> (h, row_bytes) uint8. Rows filtered with None,
    Sub or Up decode one row at a time; each run of rows with Average or
    Paeth goes by anti-diagonals."""
    rows = raw.reshape(h, row_bytes + 1)
    ftype = rows[:, 0].astype(np.int64)
    if int(ftype.max(initial=0)) > 4:
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    w = row_bytes // bpp
    filt = rows[:, 1:].reshape(h, w, bpp)
    out = np.empty((h, w, bpp), np.uint8)
    above = np.zeros((w, bpp), np.uint8)
    y = 0
    while y < h:
        f = ftype[y]
        if f == 0:
            out[y] = filt[y]
        elif f == 1:
            out[y] = np.cumsum(filt[y], axis=0, dtype=np.uint8)  # wraps modulo 256
        elif f == 2:
            out[y] = filt[y] + above
        else:
            end = y
            while end < h and ftype[end] >= 3:
                end += 1
            out[y:end] = _unfilter_diagonals(filt[y:end].astype(np.int32),
                                             ftype[y:end] == 3, above.astype(np.int32))
            above = out[end - 1]
            y = end
            continue
        above = out[y]
        y += 1
    return out.reshape(h, row_bytes)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) uint8 / uint16 samples."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file (bad signature)")
    header = None
    idat = []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, colour, _comp, _filt, interlace = header
    if colour not in _CHANNELS or depth not in (8, 16):
        raise ValueError(
            f"PNG: colour type {colour} at bit depth {depth} is not supported "
            "(gray, RGB or RGBA at 8 or 16 bits)"
        )
    if interlace:
        raise ValueError("PNG: interlaced images are not supported")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"PNG: {raw.size} image bytes, want {h * (w * bpp + 1)}")
    px = _unfilter(raw, h, w * bpp, bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    px = px.reshape(h, w, channels)
    return px[..., 0] if channels == 1 else px


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, C) uint8 / uint16 samples (C 1, 3 or 4) -> PNG
    bytes, every row Up-filtered."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG: samples of {img.dtype}, want uint8 or uint16")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"PNG: want (H, W) or (H, W, 1|3|4), got {img.shape}")
    h, w, channels = img.shape
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = rows.view(np.uint8).reshape(h, -1)
    up = rows.copy()
    up[1:] -= rows[:-1]  # uint8 arithmetic wraps modulo 256, as the filter does
    body = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOUR_TYPE[channels], 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(body.tobytes(), 6))
            + chunk(b"IEND", b""))


def read_png(path: Union[str, os.PathLike]) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: Union[str, os.PathLike], img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
