"""WebP and JPEG decoding on the host, through the C++ decoders of
``csrc/`` (built and loaded by :mod:`raft_ncup_tpu_torch.io.codec_build`).

:func:`decode_webp` covers lossy (VP8) and lossless (VP8L) still images
and the first frame of an animation, as libwebp's ``WebPAnimDecoder``
composites it (on a cleared canvas, at its offset); alpha is dropped.
:func:`decode_jpeg` covers 8-bit sequential, progressive and lossless
JPEG, Huffman or arithmetic coded, with 1, 3 or 4 components. Both give
the pixels libwebp and libjpeg-turbo give with their default settings
(what Pillow returns). A malformed file, or a form Pillow refuses too,
raises ``ValueError`` naming the file and the decoder's reason; nothing
falls back to another decoder.
"""

from __future__ import annotations

import ctypes

import numpy as np

from raft_ncup_tpu_torch.io import codec_build

_MSG_LEN = 512


def sniff(data: bytes) -> str:
    """The format of an image file by its magic bytes: ``"webp"``,
    ``"jpeg"``, ``"png"``, ``"pnm"`` or ``""``."""
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if data[:2] in (b"P5", b"P6"):
        return "pnm"
    return ""


def _error(name: str, codec: str, msg) -> ValueError:
    return ValueError(f"{name}: {codec} decode failed: {msg.value.decode(errors='replace')}")


def decode_webp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A WebP file's pixels -> (H, W, 3) uint8 RGB (an animation's first
    frame on its canvas)."""
    lib = codec_build.load("webp_decode")
    data = bytes(data)
    w, h, kind = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    if lib.webp_probe(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(kind),
                      msg, _MSG_LEN):
        raise _error(name, "WebP", msg)
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.webp_decode_rgb(data, len(data), out.ctypes.data, w.value, h.value, msg, _MSG_LEN):
        raise _error(name, "WebP", msg)
    return out


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A JPEG file's pixels -> (H, W, 3) uint8 RGB, (H, W) for grey, or
    (H, W, 4) for four components, as Pillow's ``CMYK`` image holds them
    (CMYK inverted, YCCK as RGB and inverted K)."""
    lib = codec_build.load("jpeg_decode")
    data = bytes(data)
    w, h, ch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    if lib.jpeg_probe(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch),
                      msg, _MSG_LEN):
        raise _error(name, "JPEG", msg)
    out = np.empty((h.value, w.value, ch.value), np.uint8)
    if lib.jpeg_decode(data, len(data), out.ctypes.data, w.value, h.value, ch.value, msg,
                       _MSG_LEN):
        raise _error(name, "JPEG", msg)
    return out[..., 0] if ch.value == 1 else out
