"""Write the WebP and JPEG fixtures of this directory and ``manifest.json``.

Run from the repository root with Pillow installed (12.1.0 with libwebp
1.6.0 and libjpeg-turbo 3.1.3 wrote the committed files):

    python tests/data/codecs/make_fixtures.py

Most files are written by Pillow. Pillow's options cannot reach some
decoder branches, so those files are written otherwise:

- lossy WebP with the simple loop filter, 2, 4 and 8 token partitions,
  segments with sharpness, and no loop filter: through the encoder of
  the libwebp that Pillow bundles, over ctypes (``WebPConfig``'s
  ``filter_type``, ``partitions``, ``segments``, ...);
- JPEG with 4:4:0 sampling, an extended-sequential (SOF1) frame, 16-bit
  quantization tables and an Adobe RGB (transform 0) file with restart
  markers: by the small baseline encoder below.

The manifest records each file's shape and the sha256 of Pillow's decode
as the JAX package reads it (``np.asarray(Image.open(f))``, grey
broadcast to three channels, alpha dropped), and the versions. The
frames are synthetic and seeded; the 540x960 ones are the compressed
FlyingThings3D frames of ``chip_smoke.py``'s training run.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import io
import json
import os
import struct

import numpy as np
import PIL
from PIL import Image, features

HERE = os.path.dirname(os.path.abspath(__file__))


# ------------------------------------------------------------- images


def textured(h, w, seed, channels=3, noise=6.0):
    """Smooth waves, edges and mild noise: natural-looking image statistics."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    chans = []
    for c in range(channels):
        f = rng.uniform(0.01, 0.08, 4)
        ph = rng.uniform(0, 6.28, 4)
        v = (60 * np.sin(f[0] * x + ph[0]) * np.cos(f[1] * y + ph[1])
             + 30 * np.sin(f[2] * (x + y) + ph[2]) + 0.1 * x - 0.05 * y + 128)
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(0.1, 0.4) * min(h, w)
        v += np.where((x - cx) ** 2 + (y - cy) ** 2 < r * r, 40.0, -10.0)
        v += 15 * np.sign(np.sin(f[3] * 3 * x + ph[3]))
        chans.append(v + rng.normal(0, noise, (h, w)))
    return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)


def palette_image(h, w, colors, seed):
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (colors, 3)).astype(np.uint8)
    idx = (np.arange(h)[:, None] // 3 + np.arange(w)[None] // 5) % colors
    idx[h // 2:] = rng.integers(0, colors, (h - h // 2, w))
    return pal[idx]


# ------------------------------------------------------ libwebp encoder

_LIBS = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
_CFG_FIELDS = [
    "lossless", "quality", "method", "image_hint", "target_size", "target_PSNR", "segments",
    "sns_strength", "filter_strength", "filter_sharpness", "filter_type", "autofilter",
    "alpha_compression", "alpha_filtering", "alpha_quality", "pass", "show_compressed",
    "preprocessing", "partitions", "partition_limit", "emulate_jpeg_size", "thread_level",
    "low_memory", "near_lossless", "exact", "use_delta_palette", "use_sharp_yuv", "qmin",
    "qmax"]


class _MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 1)]


def libwebp_encode(img, **options):
    """Encode (H, W, 3) uint8 with Pillow's bundled libwebp and the given
    ``WebPConfig`` fields (libwebp 1.x struct layouts)."""
    ctypes.CDLL(glob.glob(os.path.join(_LIBS, "libsharpyuv-*.so*"))[0], mode=ctypes.RTLD_GLOBAL)
    lib = ctypes.CDLL(glob.glob(os.path.join(_LIBS, "libwebp-*.so*"))[0])
    cfg = ctypes.create_string_buffer(512)
    assert lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(75.0), 0x0209)
    for key, value in options.items():
        fmt = "<f" if key in ("quality", "target_PSNR") else "<i"
        struct.pack_into(fmt, cfg, 4 * _CFG_FIELDS.index(key), value)
    assert lib.WebPValidateConfig(cfg), options
    pic = ctypes.create_string_buffer(1024)
    assert lib.WebPPictureInitInternal(pic, 0x0209)
    h, w = img.shape[:2]
    struct.pack_into("<iiii", pic, 0, 0, 0, w, h)  # use_argb, colorspace, width, height
    img = np.ascontiguousarray(img)
    assert lib.WebPPictureImportRGB(pic, img.ctypes.data_as(ctypes.c_void_p), w * 3)
    writer = _MemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    write_fn = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    struct.pack_into("<QQ", pic, 96, write_fn, ctypes.addressof(writer))  # writer, custom_ptr
    assert lib.WebPEncode(cfg, pic)
    data = ctypes.string_at(writer.mem, writer.size)
    lib.WebPMemoryWriterClear(ctypes.byref(writer))
    lib.WebPPictureFree(pic)
    return data


# ------------------------------------------------- a baseline JPEG encoder

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]).reshape(8, 8)
_ZIGZAG = sorted(((r, c) for r in range(8) for c in range(8)),
                 key=lambda rc: (rc[0] + rc[1], rc[0] if (rc[0] + rc[1]) % 2 else -rc[0]))
_DCT = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) / 2 * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])
# every DC category a 4-bit code, every AC symbol an 8-bit code
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, bits):
        for i in range(bits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        while self.n:
            self.put(1, 1)


def _category(v):
    return 0 if v == 0 else int(abs(v)).bit_length()


def _magnitude_bits(v, s):
    return v if v >= 0 else v + (1 << s) - 1


def encode_jpeg(rgb, factors, *, qscale=1.0, sof=0xC0, precision16=False, adobe_rgb=False,
                restart=0):
    """Baseline Huffman JPEG of (H, W, 3) uint8 with per-component
    sampling ``factors`` [(h, v), ...] (YCbCr with a JFIF marker, or RGB
    with an Adobe marker of transform 0)."""
    h_img, w_img = rgb.shape[:2]
    f = rgb.astype(np.float64)
    if adobe_rgb:
        planes = [f[..., 0], f[..., 1], f[..., 2]]
    else:
        planes = [0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2],
                  -0.168736 * f[..., 0] - 0.331264 * f[..., 1] + 0.5 * f[..., 2] + 128,
                  0.5 * f[..., 0] - 0.418688 * f[..., 1] - 0.081312 * f[..., 2] + 128]
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    mx, my = -(-w_img // (8 * hmax)), -(-h_img // (8 * vmax))
    q = np.clip(np.round(_LUMA_Q * qscale), 1, 65535 if precision16 else 255).astype(int)
    comps = []
    for plane, (h, v) in zip(planes, factors):
        sx, sy = hmax // h, vmax // v
        dh, dw = -(-h_img // sy), -(-w_img // sx)
        p = np.pad(plane, ((0, dh * sy - h_img), (0, dw * sx - w_img)), mode="edge")
        p = p.reshape(dh, sy, dw, sx).mean(axis=(1, 3))
        p = np.pad(p, ((0, my * v * 8 - dh), (0, mx * h * 8 - dw)), mode="edge")
        blocks = p.reshape(my * v, 8, mx * h, 8).transpose(0, 2, 1, 3) - 128
        coef = np.round(np.einsum("ux,abxy,vy->abuv", _DCT, blocks, _DCT) / q).astype(int)
        comps.append(coef)
    bw = _BitWriter()
    pred = [0, 0, 0]
    data = bytearray()
    for m in range(mx * my):
        if restart and m and m % restart == 0:
            bw.flush()
            data += bw.out + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            bw = _BitWriter()
            pred = [0, 0, 0]
        bx, by = m % mx, m // mx
        for ci, (h, v) in enumerate(factors):
            for vv in range(v):
                for hh in range(h):
                    blk = comps[ci][by * v + vv, bx * h + hh]
                    zz = [int(blk[r, c]) for r, c in _ZIGZAG]
                    diff = zz[0] - pred[ci]
                    pred[ci] = zz[0]
                    s = _category(diff)
                    bw.put(s, 4)
                    bw.put(_magnitude_bits(diff, s), s)
                    run = 0
                    last = max([k for k in range(1, 64) if zz[k]] or [0])
                    for k in range(1, last + 1):
                        if zz[k] == 0:
                            run += 1
                            continue
                        while run > 15:
                            bw.put(_AC_SYMBOLS.index(0xF0), 8)
                            run -= 16
                        s = _category(zz[k])
                        bw.put(_AC_SYMBOLS.index((run << 4) | s), 8)
                        bw.put(_magnitude_bits(zz[k], s), s)
                        run = 0
                    if last < 63:
                        bw.put(_AC_SYMBOLS.index(0x00), 8)
    bw.flush()
    data += bw.out

    def segment(marker, payload):
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    out = bytearray(b"\xFF\xD8")
    if adobe_rgb:
        out += segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0))
    else:
        out += segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    qz = [int(q[r, c]) for r, c in _ZIGZAG]
    out += segment(0xDB, bytes([0x10]) + struct.pack(">64H", *qz) if precision16
                   else bytes([0x00]) + bytes(qz))
    sof_payload = struct.pack(">BHHB", 8, h_img, w_img, 3)
    for ci, (h, v) in enumerate(factors):
        sof_payload += bytes([ci + 1, (h << 4) | v, 0])
    out += segment(sof, sof_payload)
    out += segment(0xC4, bytes([0x00]) + bytes([0, 0, 0, 12] + [0] * 12) + bytes(range(12)))
    out += segment(0xC4, bytes([0x10]) + bytes([0] * 7 + [162] + [0] * 8) + bytes(_AC_SYMBOLS))
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    out += segment(0xDA, bytes([3, 1, 0x00, 2, 0x00, 3, 0x00, 0, 63, 0]))
    out += data + b"\xFF\xD9"
    return bytes(out)


# --------------------------------------------------------------- fixtures


def _pillow(img, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **kw)
    return buf.getvalue()


def fixtures():
    """name -> (bytes, what the file exercises)."""
    out = {}
    a, b = textured(37, 53, 1), textured(64, 80, 2)
    for img, tag, settings in ((a, "37x53", ((20, 0), (50, 6), (75, 0), (95, 6))),
                               (b, "64x80", ((20, 6), (50, 0), (75, 6), (95, 0)))):
        for q, m in settings:
            out[f"lossy_{tag}_q{q}_m{m}.webp"] = (
                _pillow(img, "WEBP", quality=q, method=m), "VP8, normal loop filter")
    c = textured(50, 70, 3)
    for name, opts, what in (
            ("lossy_simple_filter.webp", dict(filter_type=0, filter_strength=60),
             "VP8, simple loop filter"),
            ("lossy_partitions4_sharp.webp", dict(partitions=2, filter_sharpness=5, segments=4,
                                                 sns_strength=100), "4 token partitions, "
             "segment quantizer and filter deltas, sharpness"),
            ("lossy_partitions8.webp", dict(partitions=3, segments=2, quality=40.0),
             "8 token partitions"),
            ("lossy_partitions2_nofilter.webp", dict(partitions=1, filter_strength=0,
                                                     segments=1), "2 token partitions, "
             "no loop filter, no segments")):
        out[name] = (libwebp_encode(c, **opts), what)
    rgba = np.concatenate([textured(41, 59, 4), textured(41, 59, 5, channels=1)], -1)
    rgba[::4, :, 3] = 0
    out["lossy_alpha_vp8x.webp"] = (_pillow(rgba, "WEBP", quality=70),
                                   "VP8X with ALPH (alpha dropped)")
    out["lossy_exif_icc_vp8x.webp"] = (
        _pillow(c, "WEBP", quality=60, exif=b"Exif\x00\x00MM\x00*\x00\x00\x00\x08\x00\x00",
                icc_profile=b"\x00" * 128), "VP8X with ICCP and EXIF chunks skipped")
    out["lossless_rgb.webp"] = (_pillow(a, "WEBP", lossless=True), "VP8L, RGB")
    out["lossless_rgba.webp"] = (_pillow(rgba, "WEBP", lossless=True, exact=True),
                                 "VP8L with alpha")
    out["lossless_grey.webp"] = (_pillow(b[..., 0], "WEBP", lossless=True), "VP8L, grey")
    for colors, what in ((2, "8 indices a pixel"), (4, "4 indices a pixel"),
                         (11, "2 indices a pixel"), (200, "one index a pixel")):
        out[f"lossless_palette{colors}.webp"] = (
            _pillow(palette_image(33, 47, colors, colors), "WEBP", lossless=True),
            f"VP8L colour indexing, {colors} colours, {what}")
    out["lossless_m0.webp"] = (_pillow(c, "WEBP", lossless=True, method=0, quality=0),
                               "VP8L, fastest settings")
    # JPEG
    j = textured(45, 67, 6)
    for sub, tag in ((0, "444"), (1, "422"), (2, "420")):
        out[f"jpeg_{tag}_45x67.jpg"] = (_pillow(j, "JPEG", quality=85, subsampling=sub),
                                       f"baseline {tag}")
    out["jpeg_420_33x17.jpg"] = (_pillow(textured(33, 17, 7), "JPEG", quality=75,
                                         subsampling=2), "baseline 4:2:0, odd size")
    out["jpeg_grey.jpg"] = (_pillow(j[..., 1], "JPEG", quality=80), "one component")
    out["jpeg_optimize.jpg"] = (_pillow(j, "JPEG", quality=80, optimize=True),
                                "optimized Huffman tables")
    out["jpeg_progressive_420.jpg"] = (_pillow(j, "JPEG", quality=80, progressive=True,
                                               subsampling=2),
                                       "progressive: spectral selection, successive "
                                       "approximation, DC and AC refinement")
    out["jpeg_progressive_grey.jpg"] = (_pillow(j[..., 0], "JPEG", quality=90,
                                                progressive=True), "progressive, grey")
    out["jpeg_restart.jpg"] = (_pillow(j, "JPEG", quality=80, restart_marker_blocks=2),
                               "restart interval (DRI/RSTn)")
    out["jpeg_progressive_restart.jpg"] = (
        _pillow(j, "JPEG", quality=70, progressive=True, restart_marker_rows=1),
        "progressive with restart markers")
    out["jpeg_q100.jpg"] = (_pillow(j, "JPEG", quality=100), "quality 100")
    out["jpeg_q20.jpg"] = (_pillow(j, "JPEG", quality=20), "quality 20")
    out["jpeg_keep_rgb.jpg"] = (_pillow(j, "JPEG", quality=85, keep_rgb=True),
                                "Adobe APP14 transform 0 (RGB)")
    out["jpeg_440.jpg"] = (encode_jpeg(j, [(1, 2), (1, 1), (1, 1)]), "4:4:0 (h1v2)")
    out["jpeg_sof1_q16.jpg"] = (encode_jpeg(j, [(2, 1), (1, 1), (1, 1)], sof=0xC1,
                                            precision16=True, qscale=0.5),
                                "extended sequential (SOF1), 16-bit DQT, 4:2:2")
    out["jpeg_adobe_rgb_restart.jpg"] = (
        encode_jpeg(j, [(1, 1), (1, 1), (1, 1)], adobe_rgb=True, restart=3),
        "Adobe RGB with restart markers")
    out["jpeg_y_subsampled.jpg"] = (encode_jpeg(j, [(1, 1), (2, 2), (2, 2)]),
                                    "luma at half the chroma's resolution (box 2x2)")
    for i in range(4):
        out[f"frame_540x960_{i}.webp"] = (_pillow(textured(540, 960, 100 + i, noise=9.0), "WEBP",
                                                  quality=75),
                                          "540x960 lossy frame (timing, FlyingThings3D tree)")
    return out


def reference_rgb(path):
    """What the JAX package's ``read_image`` returns (Pillow)."""
    img = np.asarray(Image.open(path)).astype(np.uint8)
    if img.ndim == 2:
        img = np.tile(img[..., None], (1, 1, 3))
    return np.ascontiguousarray(img[..., :3])


def main():
    entries = {}
    for name, (data, what) in sorted(fixtures().items()):
        path = os.path.join(HERE, name)
        with open(path, "wb") as fh:
            fh.write(data)
        ref = reference_rgb(path)
        entries[name] = {"shape": list(ref.shape), "bytes": len(data),
                         "sha256_rgb": hashlib.sha256(ref.tobytes()).hexdigest(),
                         "exercises": what}
    manifest = {
        "versions": {"Pillow": PIL.__version__, "libwebp": features.version("webp"),
                     "libjpeg_turbo": features.version("libjpeg_turbo")},
        "digest": "sha256 of the (H, W, 3) uint8 RGB bytes of Pillow's decode",
        "not_held_against_a_reference": [],
        "files": entries,
    }
    with open(os.path.join(HERE, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.write("\n")
    total = sum(e["bytes"] for e in entries.values())
    print(f"{len(entries)} files, {total} bytes")


if __name__ == "__main__":
    main()
