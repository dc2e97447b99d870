"""Optical-flow and image file I/O (port of ``raft_ncup_tpu/io/flow_io.py``).

Middlebury ``.flo``, ``.pfm``, KITTI 16-bit PNG flow and disparity,
images, and the ``read_gen`` dispatcher by extension. Host-side numpy
throughout; flows are channel-last (H, W, 2) float32, images (H, W, 3)
uint8 RGB.

The JAX package reads and writes images with OpenCV and Pillow. Here PNGs
go through the port's own codec (:mod:`raft_ncup_tpu_torch.io.png`),
binary PPM/PGM (FlyingChairs' frames) are parsed with numpy, and WebP
(compressed FlyingThings3D) and JPEG through the port's C++ decoders
(:mod:`raft_ncup_tpu_torch.io.codecs`).
"""

from __future__ import annotations

import os
import re
import struct
from typing import Union

import numpy as np

from raft_ncup_tpu_torch.io.codecs import decode_jpeg, decode_webp, sniff
from raft_ncup_tpu_torch.io.png import decode_png, read_png, write_png

_FLO_MAGIC = 202021.25
_PNM_TOKEN = re.compile(rb"\s*(#[^\n]*\n\s*)*(\S+)")  # a header token after comments


# --------------------------------------------------------------------- .flo


def read_flo(path: Union[str, os.PathLike]) -> np.ndarray:
    """Read a Middlebury ``.flo`` file -> (H, W, 2) float32 (little-endian
    float32 magic 202021.25, int32 width and height, then (u, v) pairs)."""
    with open(path, "rb") as f:
        magic = struct.unpack("<f", f.read(4))[0]
        if abs(magic - _FLO_MAGIC) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {magic!r}")
        w, h = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(8 * w * h), dtype="<f4")
    if data.size != 2 * w * h:
        raise ValueError(f"{path}: truncated .flo ({data.size} of {2*w*h})")
    return data.reshape(h, w, 2).astype(np.float32)


def write_flo(path: Union[str, os.PathLike], flow: np.ndarray) -> None:
    """Write (H, W, 2) float32 flow as Middlebury ``.flo``."""
    flow = np.asarray(flow, dtype=np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(struct.pack("<f", _FLO_MAGIC))
        f.write(struct.pack("<ii", w, h))
        f.write(flow.astype("<f4").tobytes())


# --------------------------------------------------------------------- .pfm


def read_pfm(path: Union[str, os.PathLike]) -> np.ndarray:
    """Read a ``.pfm`` file -> (H, W) or (H, W, 3) float32, rows top-down
    (PFM stores them bottom-up; a negative scale marks little-endian)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        dims = f.readline()
        m = re.match(rb"^(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM dims {dims!r}")
        w, h = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(f.read(4 * w * h * channels), dtype=endian + "f4")
    shape = (h, w, 3) if channels == 3 else (h, w)
    return np.flipud(data.reshape(shape)).astype(np.float32)


def write_pfm(
    path: Union[str, os.PathLike], data: np.ndarray, scale: float = 1.0
) -> None:
    """Write (H, W) or (H, W, 3) float32 as little-endian ``.pfm``."""
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 3 and data.shape[2] == 3:
        header = b"PF"
    elif data.ndim == 2:
        header = b"Pf"
    else:
        raise ValueError(f"pfm data must be (H,W) or (H,W,3), got {data.shape}")
    h, w = data.shape[:2]
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{w} {h}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())
        f.write(np.flipud(data).astype("<f4").tobytes())


# --------------------------------------------------------- KITTI 16-bit png


def read_flow_kitti(
    path: Union[str, os.PathLike]
) -> tuple[np.ndarray, np.ndarray]:
    """Read KITTI 16-bit PNG flow -> ((H, W, 2) float32, (H, W) valid):
    ``u = (R - 2^15) / 64``, ``v = (G - 2^15) / 64``, B the validity."""
    raw = read_png(path)
    if raw.ndim != 3 or raw.shape[2] < 3:
        raise ValueError(f"{path}: KITTI flow must be an RGB PNG, got {raw.shape}")
    raw = raw[:, :, :3].astype(np.float32)
    flow = (raw[:, :, :2] - 2.0**15) / 64.0
    valid = raw[:, :, 2]
    return flow, valid


def read_disp_kitti(
    path: Union[str, os.PathLike]
) -> tuple[np.ndarray, np.ndarray]:
    """Read a KITTI 16-bit disparity PNG as pseudo-flow ((H, W, 2) with
    u = -disparity, v = 0) plus validity."""
    raw = read_png(path)
    if raw.ndim != 2:
        raise ValueError(f"{path}: KITTI disparity must be a gray PNG, got {raw.shape}")
    disp = raw.astype(np.float32) / 256.0
    valid = disp > 0.0
    flow = np.stack([-disp, np.zeros_like(disp)], axis=-1)
    return flow, valid


def write_flow_kitti(path: Union[str, os.PathLike], flow: np.ndarray) -> None:
    """Write (H, W, 2) flow as KITTI 16-bit PNG (all pixels marked valid)."""
    flow = np.asarray(flow, dtype=np.float64)
    enc = 64.0 * flow + 2.0**15
    valid = np.ones(flow.shape[:2] + (1,), np.float64)
    write_png(path, np.concatenate([enc, valid], axis=-1).astype(np.uint16))


# ------------------------------------------------------------------ images


def _read_pnm(path, data: bytes) -> np.ndarray:
    """Binary PPM (P6) or PGM (P5), 8 or 16 bits -> (H, W[, 3]) samples."""
    tokens, pos = [], 0
    while len(tokens) < 4:
        m = _PNM_TOKEN.match(data, pos)
        if m is None:
            raise ValueError(f"{path}: malformed PNM header")
        tokens.append(m.group(2))
        pos = m.end()
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic not in (b"P5", b"P6") or not 0 < maxval < 65536:
        raise ValueError(f"{path}: not a binary PPM/PGM (magic {magic!r}, max {maxval})")
    pos += 1  # the single whitespace byte after maxval
    channels = 3 if magic == b"P6" else 1
    dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
    n = h * w * channels
    px = np.frombuffer(data, dtype, count=n, offset=pos).astype(
        np.uint8 if maxval < 256 else np.uint16)
    return px.reshape((h, w, 3) if channels == 3 else (h, w))


_IMAGE_EXTS = (".png", ".jpeg", ".jpg", ".ppm", ".pgm", ".webp")


def read_image(path: Union[str, os.PathLike]) -> np.ndarray:
    """Read an image file -> (H, W, 3) uint8 RGB (gray broadcast, alpha
    dropped, a four-component JPEG's first three channels as JAX's
    ``[..., :3]`` keeps them of Pillow's CMYK). Among the image extensions
    the decoder is picked by the file's magic bytes, as Pillow picks it:
    PNG, binary PPM/PGM, JPEG and WebP (an animation's first frame)."""
    ext = os.path.splitext(str(path))[-1].lower()
    if ext not in _IMAGE_EXTS:
        raise ValueError(f"{path}: unsupported image extension {ext!r}")
    with open(path, "rb") as f:
        data = f.read()
    kind = sniff(data)
    if kind == "png":
        img = decode_png(data)
    elif kind == "pnm":
        img = _read_pnm(path, data)
    elif kind == "jpeg":
        img = decode_jpeg(data, str(path))
    elif kind == "webp":
        img = decode_webp(data, str(path))
    else:
        raise ValueError(f"{path}: not a PNG, PPM/PGM, JPEG or WebP file")
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: {img.dtype} samples; images must be 8-bit")
    if img.ndim == 2:
        img = np.tile(img[..., None], (1, 1, 3))
    return img[..., :3]


# ---------------------------------------------------------------- dispatch


def read_gen(path: Union[str, os.PathLike]):
    """Read a file by extension: images -> (H, W, 3) uint8; ``.flo`` ->
    (H, W, 2); ``.pfm`` flow -> (H, W, 2) (third channel dropped);
    ``.npz`` compressed FlyingThings -> (H, W, 2); ``.bin``/``.raw`` ->
    ``np.load``."""
    ext = os.path.splitext(str(path))[-1].lower()
    if ext in (".png", ".jpeg", ".jpg", ".ppm", ".webp"):
        return read_image(path)
    if ext == ".flo":
        return read_flo(path)
    if ext == ".pfm":
        data = read_pfm(path)
        return data if data.ndim == 2 else data[:, :, :2]
    if ext == ".npz":
        return (
            np.load(path)["optical_flow"]
            .astype(np.float32)
            .transpose(1, 2, 0)
        )
    if ext in (".bin", ".raw"):
        return np.load(path)
    raise ValueError(f"unsupported extension: {path}")
