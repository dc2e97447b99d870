"""Write the WebP and JPEG fixtures of this directory and ``manifest.json``.

Run from the repository root with Pillow installed (12.1.0 with libwebp
1.6.0 and libjpeg-turbo 3.1.3 wrote the committed files):

    python tests/data/codecs/make_fixtures.py

Most files are written by Pillow. Pillow's options cannot reach some
decoder branches, so those files are written otherwise (``jpeg_411`` by
OpenCV, which must be installed to rerun this script):

- lossy WebP with the simple loop filter, 2, 4 and 8 token partitions,
  segments with sharpness, and no loop filter: through the encoder of
  the libwebp that Pillow bundles, over ctypes (``WebPConfig``'s
  ``filter_type``, ``partitions``, ``segments``, ...);
- JPEG with 4:4:0 sampling, an extended-sequential (SOF1) frame, 16-bit
  quantization tables and an Adobe RGB (transform 0) file with restart
  markers: by the small baseline encoder below;
- JPEG with four components (no marker, YCCK), sampling factors of 3 and
  4, arithmetic coding (the QM coder of ITU T.81 Annex D, sequential and
  progressive, with DAC conditioning and restarts), lossless frames, and
  the forms Pillow refuses (12-bit samples, a DNL height, a hierarchical
  frame, lossless YCbCr, a fractional sampling ratio, an MCU of more than
  10 blocks): by the encoders below;
- animated WebP: ANIM and ANMF chunks assembled around Pillow's still
  frames, so that frame 0's kind, offset and blend are chosen, and one
  animation as Pillow writes it.

The manifest records each file's shape and the sha256 of Pillow's decode
as the JAX package reads it (``np.asarray(Image.open(f))``, grey
broadcast to three channels, alpha and CMYK's fourth channel dropped),
the versions, and, under ``refused_by_pillow``, each file Pillow refuses
with Pillow's error. The
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


# ------------------------------------- the forms Pillow's options cannot write
#
# Four components (CMYK and YCCK), sampling factors of 3 and 4, the QM
# arithmetic coder (ITU T.81 Annex D) for sequential and progressive
# frames, lossless (SOF3) frames, 12-bit samples, a DNL-sized frame and a
# hierarchical (SOF5) header. Each is written by the functions below;
# whether Pillow decodes it or refuses it, the tests hold the port to the
# same.

# T.81 Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS) by state;
# state 113 is libjpeg's fixed one-half bin, which never adapts.
_QM = [
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0)]


class _QMEncoder:
    """The QM arithmetic encoder (T.81 D.1), with libjpeg's register layout
    and termination. A statistics bin is a one-element list holding the
    state index with the MPS in bit 7."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _flush_zeros(self):
        self.out += b"\x00" * self.zc
        self.zc = 0

    def _byte(self, value):
        self.out.append(value)
        if value == 0xFF:
            self.out.append(0)

    def encode(self, bin_, val):
        sv = bin_[0]
        qe, nlps, nmps, switch = _QM[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            bin_[0] = (sv & 0x80) ^ (nlps | switch << 7)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            bin_[0] = (sv & 0x80) ^ nmps
        while True:  # renormalize, D.1.6
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:  # a carry into the stacked bytes
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._byte(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_zeros()
                        self._byte(self.buffer)
                    if self.sc:
                        self._flush_zeros()
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        """Terminate (D.1.8) and return the coded bytes."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0x8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._byte(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._byte(self.buffer)
            if self.sc:
                self._flush_zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)
        return bytes(self.out)


class _ArithModel:
    """The statistics of one arithmetic-coded scan (T.81 F.1.4 and G.1.3):
    DC bins by table (64 each) with their conditioning, AC bins by table
    (256 each), and the fixed one-half bin."""

    def __init__(self, dc_lu, ac_k):
        self.dc_lu, self.ac_k = dc_lu, ac_k
        self.reset()

    def reset(self):
        self.dc = [[[0] for _ in range(64)] for _ in range(4)]
        self.ac = [[[0] for _ in range(256)] for _ in range(4)]
        self.fixed = [113]

    @staticmethod
    def _magnitude(enc, bins, st, v, k_bins=None):
        """Encode ``v - 1`` (``v`` >= 1) as its category and bit pattern from
        bin ``st`` (F.1.4.4.1.3 for DC, F.1.4.4.2 for AC, whose larger
        categories go to bins ``k_bins``); returns the category's top bit,
        which conditions the next DC difference."""
        m, v = 0, v - 1
        if v:
            enc.encode(bins[st], 1)
            m, v2 = 1, v >> 1
            if k_bins is None:
                st = 20  # X1
            elif v2:
                enc.encode(bins[st], 1)
                m, v2, st = 2, v2 >> 1, k_bins
            while v2:
                enc.encode(bins[st], 1)
                m, v2, st = m << 1, v2 >> 1, st + 1
        enc.encode(bins[st], 0)
        st += 14
        bit = m >> 1
        while bit:
            enc.encode(bins[st], 1 if bit & v else 0)
            bit >>= 1
        return m

    def dc_diff(self, enc, tbl, ctx, diff):
        """One DC difference (F.1.4.1); returns the next context."""
        bins = self.dc[tbl]
        if diff == 0:
            enc.encode(bins[ctx], 0)
            return 0
        enc.encode(bins[ctx], 1)
        sign = 1 if diff < 0 else 0
        enc.encode(bins[ctx + 1], sign)
        m = self._magnitude(enc, bins, ctx + 2 + sign, abs(diff))
        lo, hi = self.dc_lu[tbl]
        if m < (1 << lo) >> 1:
            return 0
        return (12 if m > (1 << hi) >> 1 else 4) + 4 * sign

    def ac_first(self, enc, tbl, zz, ss, se):
        """AC coefficients ``zz[ss..se]`` (already point-transformed), F.1.4.2."""
        bins = self.ac[tbl]
        ke = max([k for k in range(ss, se + 1) if zz[k]] or [ss - 1])
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            enc.encode(bins[st], 0)
            while zz[k] == 0:
                enc.encode(bins[st + 1], 0)
                st += 3
                k += 1
            enc.encode(bins[st + 1], 1)
            enc.encode(self.fixed, 1 if zz[k] < 0 else 0)
            self._magnitude(enc, bins, st + 2, abs(zz[k]),
                            k_bins=189 if k <= self.ac_k[tbl] else 217)
            k += 1
        if k <= se:
            enc.encode(bins[3 * (k - 1)], 1)

    def ac_refine(self, enc, tbl, coef, ss, se, ah, al):
        """One successive-approximation pass of bit ``al`` over ``coef[ss..se]``
        (the full-precision zigzag coefficients), G.1.3.3."""
        bins = self.ac[tbl]

        def shifted(k, by):
            return abs(coef[k]) >> by

        ke = max([k for k in range(ss, se + 1) if shifted(k, al)] or [0])
        kex = max([k for k in range(1, ke + 1) if shifted(k, ah)] or [0])
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                enc.encode(bins[st], 0)
            while True:
                v = shifted(k, al)
                if v:
                    if v >> 1:
                        enc.encode(bins[st + 2], v & 1)
                    else:
                        enc.encode(bins[st + 1], 1)
                        enc.encode(self.fixed, 1 if coef[k] < 0 else 0)
                    break
                enc.encode(bins[st + 1], 0)
                st += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(bins[3 * (k - 1)], 1)


def _segment(marker, payload):
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def _dct_coefficients(planes, factors, q, level=128):
    """Each component's zigzag coefficients (rows of blocks, cols, 64),
    MCU-padded, and the blocks holding image data."""
    h_img, w_img = planes[0].shape
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    mx, my = -(-w_img // (8 * hmax)), -(-h_img // (8 * vmax))
    comps = []
    for plane, (h, v) in zip(planes, factors):
        # libjpeg's downsampled size (the samples the decoder keeps); the
        # encoder's box average may use a partial last box.
        dh, dw = -(-h_img * v // vmax), -(-w_img * h // hmax)
        sy, sx = vmax // v if vmax % v == 0 else 1, hmax // h if hmax % h == 0 else 1
        p = np.pad(plane, ((0, dh * sy - h_img if dh * sy > h_img else 0),
                           (0, dw * sx - w_img if dw * sx > w_img else 0)), mode="edge")
        p = p[:dh * sy, :dw * sx].reshape(dh, sy, dw, sx).mean(axis=(1, 3))
        p = np.pad(p, ((0, my * v * 8 - dh), (0, mx * h * 8 - dw)), mode="edge")
        blocks = p.reshape(my * v, 8, mx * h, 8).transpose(0, 2, 1, 3) - level
        coef = np.round(np.einsum("ux,abxy,vy->abuv", _DCT, blocks, _DCT) / q).astype(int)
        zz = np.stack([coef[..., r, c] for r, c in _ZIGZAG], -1)
        comps.append((zz, -(-dw // 8), -(-dh // 8)))
    return comps, mx, my


def _frame(width, height, factors, sof, precision=8, ids=None):
    payload = struct.pack(">BHHB", precision, height, width, len(factors))
    for ci, (h, v) in enumerate(factors):
        payload += bytes([ids[ci] if ids else ci + 1, (h << 4) | v, 0])
    return _segment(sof, payload)


def _app(colour):
    """JFIF for YCbCr and grey, Adobe APP14 with its transform otherwise
    (``"rgb"`` 0, ``"ycc"`` 1 with an Adobe marker, ``"cmyk"`` 0,
    ``"ycck"`` 2); ``"cmyk_bare"`` and ``"rgb_bare"`` write none."""
    transform = {"rgb": 0, "cmyk": 0, "adobe_ycc": 1, "ycck": 2}.get(colour)
    if transform is not None:
        return _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform))
    if colour in ("ycc", "grey"):
        return _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    return b""


def _colour_planes(img, colour):
    """The planes a colour space stores, from (H, W, C) uint8."""
    f = img.astype(np.float64)
    if colour == "grey":
        return [f[..., 0]]
    if colour in ("rgb", "rgb_bare", "cmyk", "cmyk_bare"):
        return [f[..., c] for c in range(f.shape[-1])]
    y = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    cb = -0.168736 * f[..., 0] - 0.331264 * f[..., 1] + 0.5 * f[..., 2] + 128
    cr = 0.5 * f[..., 0] - 0.418688 * f[..., 1] - 0.081312 * f[..., 2] + 128
    return [y, cb, cr] + ([255 - f[..., 3]] if colour == "ycck" else [])


def encode_dct(img, factors, colour, *, arithmetic=False, progressive=None, restart=0,
               dac=None, qscale=1.0, precision=8, height_in_dnl=False, sof=None):
    """A DCT JPEG of (H, W, C) uint8 ``img``: Huffman-coded sequential as
    :func:`encode_jpeg` writes it, or arithmetic-coded, sequential (SOF9)
    or progressive (SOF10) by the scan list ``progressive`` ([(component
    indices, Ss, Se, Ah, Al), ...]). ``dac`` maps a DC table to (L, U) and
    an AC table to Kx as ``{"dc": (L, U), "ac": K}`` for table 0;
    ``precision`` 12 scales the samples by 16; ``height_in_dnl`` writes a
    zero height and a DNL marker; ``sof`` overrides the frame marker."""
    h_img, w_img = img.shape[:2]
    planes = _colour_planes(img, colour)
    level = 128
    if precision == 12:
        planes, level = [p * 16 for p in planes], 2048
    q = np.clip(np.round(_LUMA_Q * qscale), 1, 255).astype(int)
    comps, mx, my = _dct_coefficients(planes, factors, q, level)
    nc = len(planes)
    if sof is None:
        sof = (0xCA if progressive else 0xC9) if arithmetic else (0xC2 if progressive else 0xC1)
    out = bytearray(b"\xFF\xD8") + _app(colour)
    qz = [int(q[r, c]) for r, c in _ZIGZAG]
    out += _segment(0xDB, bytes([0x00]) + bytes(qz))
    out += _frame(w_img, 0 if height_in_dnl else h_img, factors, sof, precision)
    dc_lu, ac_k = [(0, 1)] * 4, [5] * 4
    if arithmetic and dac:
        dc_lu[0], ac_k[0] = dac["dc"], dac["ac"]
        out += _segment(0xCC, bytes([0, dac["dc"][1] << 4 | dac["dc"][0], 16, dac["ac"]]))
    if not arithmetic:
        out += _segment(0xC4, bytes([0x00]) + bytes([0, 0, 0, 12] + [0] * 12) + bytes(range(12)))
        out += _segment(0xC4, bytes([0x10]) + bytes([0] * 7 + [162] + [0] * 8)
                        + bytes(_AC_SYMBOLS))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    scans = progressive or [(tuple(range(nc)), 0, 63, 0, 0)]
    for ci_list, ss, se, ah, al in scans:
        out += _segment(0xDA, bytes([len(ci_list)]) + b"".join(bytes([ci + 1, 0x00])
                                                               for ci in ci_list)
                        + bytes([ss, se, ah << 4 | al]))
        if arithmetic:
            out += _arith_scan(comps, factors, ci_list, ss, se, ah, al, mx, my, restart,
                               dc_lu, ac_k, progressive is not None)
        else:
            out += _huffman_scan(comps, factors, ci_list, mx, my, restart)
    if height_in_dnl:
        out += _segment(0xDC, struct.pack(">H", h_img))
    out += b"\xFF\xD9"
    return bytes(out)


def _scan_blocks(comps, factors, ci_list, mx, my):
    """The blocks of a scan in coding order, by MCU: [[(ci, zz), ...], ...]."""
    if len(ci_list) == 1:
        ci = ci_list[0]
        zz, wib, hib = comps[ci]
        return [[(ci, zz[by, bx])] for by in range(hib) for bx in range(wib)]
    mcus = []
    for m in range(mx * my):
        bx, by = m % mx, m // mx
        blocks = []
        for ci in ci_list:
            h, v = factors[ci]
            blocks += [(ci, comps[ci][0][by * v + vv, bx * h + hh])
                       for vv in range(v) for hh in range(h)]
        mcus.append(blocks)
    return mcus


def _huffman_scan(comps, factors, ci_list, mx, my, restart):
    """A sequential Huffman scan with :func:`encode_jpeg`'s tables."""
    bw, data = _BitWriter(), bytearray()
    pred = {}
    for m, blocks in enumerate(_scan_blocks(comps, factors, ci_list, mx, my)):
        if restart and m and m % restart == 0:
            bw.flush()
            data += bw.out + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            bw, pred = _BitWriter(), {}
        for ci, zz in blocks:
            diff = int(zz[0]) - pred.get(ci, 0)
            pred[ci] = int(zz[0])
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
                s = _category(int(zz[k]))
                bw.put(_AC_SYMBOLS.index((run << 4) | s), 8)
                bw.put(_magnitude_bits(int(zz[k]), s), s)
                run = 0
            if last < 63:
                bw.put(_AC_SYMBOLS.index(0x00), 8)
    bw.flush()
    return bytes(data + bw.out)


def _arith_scan(comps, factors, ci_list, ss, se, ah, al, mx, my, restart, dc_lu, ac_k,
                progressive):
    """One arithmetic-coded scan, sequential or one progressive pass."""
    model, enc, data = _ArithModel(dc_lu, ac_k), _QMEncoder(), bytearray()
    pred, ctx = {}, {}
    for m, blocks in enumerate(_scan_blocks(comps, factors, ci_list, mx, my)):
        if restart and m and m % restart == 0:
            data += enc.finish() + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            model.reset()
            enc, pred, ctx = _QMEncoder(), {}, {}
        for ci, zz in blocks:
            zz = [int(x) for x in zz]
            if not progressive:
                ctx[ci] = model.dc_diff(enc, 0, ctx.get(ci, 0), zz[0] - pred.get(ci, 0))
                pred[ci] = zz[0]
                model.ac_first(enc, 0, zz, 1, 63)
            elif ss == 0 and ah == 0:
                dc = zz[0] >> al
                ctx[ci] = model.dc_diff(enc, 0, ctx.get(ci, 0), dc - pred.get(ci, 0))
                pred[ci] = dc
            elif ss == 0:
                enc.encode(model.fixed, (zz[0] >> al) & 1)
            elif ah == 0:
                shifted = [(abs(x) >> al) * (1 if x >= 0 else -1) for x in zz]
                model.ac_first(enc, 0, shifted, ss, se)
            else:
                model.ac_refine(enc, 0, zz, ss, se, ah, al)
    return bytes(data + enc.finish())


def _lossless_differences(p, predictor, pt):
    """One component's sample differences (H.1.2): the first row predicts
    from the left (its first sample from 1 << (7 - pt)), every other row's
    first sample from above."""
    h, w = p.shape
    d = np.zeros((h, w), np.int64)
    for y in range(h):
        for x in range(w):
            if y == 0:
                pred = (1 << (8 - pt - 1)) if x == 0 else p[y, x - 1]
            elif x == 0:
                pred = p[y - 1, x]
            else:
                ra, rb, rc = int(p[y, x - 1]), int(p[y - 1, x]), int(p[y - 1, x - 1])
                pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                        6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
            diff = (int(p[y, x]) - int(pred)) & 0xFFFF
            d[y, x] = diff - 0x10000 if diff >= 0x8000 else diff
    return d


def encode_lossless(img, colour, predictor, *, pt=0, factors=None):
    """A lossless (SOF3) JPEG of (H, W, C) uint8 with one Huffman table for
    every component's differences (categories 0 to 16, 5-bit codes): one
    interleaved scan of ``predictor`` (1 to 7) with point transform
    ``pt``; ``factors`` subsample components by box averages, an MCU then
    holding h x v samples of each (difference 0 past a component's edge)."""
    h_img, w_img = img.shape[:2]
    planes = _colour_planes(img, colour)
    nc = len(planes)
    factors = factors or [(1, 1)] * nc
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    diffs = []
    for plane, (h, v) in zip(planes, factors):
        sy, sx = vmax // v, hmax // h
        dh, dw = -(-h_img * v // vmax), -(-w_img * h // hmax)
        q = np.pad(plane, ((0, dh * sy - h_img), (0, dw * sx - w_img)), mode="edge")
        q = np.round(q.reshape(dh, sy, dw, sx).mean(axis=(1, 3))).astype(np.int64) >> pt
        diffs.append(_lossless_differences(q, predictor, pt))
    bw = _BitWriter()
    mx, my = -(-w_img // hmax), -(-h_img // vmax)
    for m in range(mx * my):
        bx, by = m % mx, m // mx
        for d, (h, v) in zip(diffs, factors):
            for vv in range(v):
                for hh in range(h):
                    y, x = by * v + vv, bx * h + hh
                    diff = int(d[y, x]) if y < d.shape[0] and x < d.shape[1] else 0
                    s = _category(diff)
                    bw.put(s, 5)
                    bw.put(_magnitude_bits(diff, s), s)
    bw.flush()
    out = bytearray(b"\xFF\xD8") + _app(colour)
    out += _frame(w_img, h_img, factors, 0xC3)
    out += _segment(0xC4, bytes([0x00]) + bytes([0, 0, 0, 0, 17] + [0] * 11) + bytes(range(17)))
    out += _segment(0xDA, bytes([nc]) + b"".join(bytes([ci + 1, 0x00]) for ci in range(nc))
                    + bytes([predictor, 0, pt]))
    out += bw.out + b"\xFF\xD9"
    return bytes(out)


# -------------------------------------------------------- animated WebP


def _chunks(webp):
    """The chunks of a still WebP file's RIFF body, as (tag, payload)."""
    out, p = [], 12
    while p + 8 <= len(webp):
        tag, n = webp[p:p + 4], struct.unpack("<I", webp[p + 4:p + 8])[0]
        out.append((tag, webp[p + 8:p + 8 + n]))
        p += 8 + n + (n & 1)
    return out


def _chunk(tag, payload):
    return tag + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)


def animated_webp(canvas_hw, frames, *, background=(0, 0, 0, 0), loop=0, alpha=True):
    """An animated WebP (VP8X, ANIM, one ANMF a frame) of ``frames``:
    [(still WebP bytes, x, y, blend, dispose), ...] at even offsets; each
    frame's image chunks (ALPH and VP8, or VP8L) are taken from its still
    file."""
    h, w = canvas_hw
    body = _chunk(b"VP8X", bytes([0x02 | (0x10 if alpha else 0), 0, 0, 0])
                  + struct.pack("<I", w - 1)[:3] + struct.pack("<I", h - 1)[:3])
    body += _chunk(b"ANIM", bytes(background[2::-1]) + bytes([background[3]])
                   + struct.pack("<H", loop))
    for still, x, y, blend, dispose in frames:
        parts = [(t, d) for t, d in _chunks(still) if t in (b"ALPH", b"VP8 ", b"VP8L")]
        img = Image.open(io.BytesIO(still))
        fw, fh = img.size
        header = (struct.pack("<I", x // 2)[:3] + struct.pack("<I", y // 2)[:3]
                  + struct.pack("<I", fw - 1)[:3] + struct.pack("<I", fh - 1)[:3]
                  + struct.pack("<I", 80)[:3] + bytes([(0 if blend else 2) | (1 if dispose else 0)]))
        body += _chunk(b"ANMF", header + b"".join(_chunk(t, d) for t, d in parts))
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _rgba(h, w, seed, hole=True):
    """RGBA with a transparent stripe and a transparent corner."""
    img = np.concatenate([textured(h, w, seed), textured(h, w, seed + 1, channels=1)], -1)
    img[::5, :, 3] = 0
    if hole:
        img[: h // 3, : w // 3, 3] = 0
    return img


def animated_fixtures():
    """name -> (bytes, what): animated WebP whose first frame differs in
    kind, offset and alpha, and one whose frame leaves the canvas."""
    out = {}
    lossy = _pillow(textured(30, 40, 20), "WEBP", quality=70)
    lossless = _pillow(_rgba(16, 18, 21), "WEBP", lossless=True)
    alpha = _pillow(_rgba(14, 22, 23), "WEBP", quality=60)
    out["anim_lossy_first.webp"] = (
        animated_webp((30, 40), [(lossy, 0, 0, False, False), (lossless, 10, 6, True, False),
                                 (alpha, 4, 12, True, True)]),
        "animated: 3 frames (lossy, lossless with an offset, lossy with alpha and an "
        "offset), frame 0 a lossy full canvas")
    out["anim_alpha_offset_first.webp"] = (
        animated_webp((30, 40), [(alpha, 8, 6, True, False), (lossy, 0, 0, False, False)],
                      background=(255, 0, 0, 255)),
        "animated: frame 0 lossy with ALPH at an offset, blended, on the cleared canvas "
        "(the ANIM background colour unused)")
    out["anim_lossless_offset_first.webp"] = (
        animated_webp((30, 40), [(lossless, 22, 14, False, True), (alpha, 0, 0, True, False)]),
        "animated: frame 0 lossless RGBA at an offset, not blended")
    frames = [Image.fromarray(_rgba(24, 32, 30 + k, hole=k == 0)) for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=50,
                   quality=70, allow_mixed=True, loop=0)
    out["anim_pillow.webp"] = (buf.getvalue(), "animated: 3 RGBA frames as Pillow writes "
                               "them (its encoder picks the sub-frames)")
    return out


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
    out.update(animated_fixtures())
    out.update(jpeg_forms())
    return out


_PROGRESSIVE = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                ((0,), 1, 63, 1, 0)]


def jpeg_forms():
    """name -> (bytes, what): the JPEG forms Pillow decodes beyond its own
    writer's: four components, sampling factors of 3 and 4, arithmetic
    coding and lossless frames."""
    out = {}
    j, k = textured(33, 45, 40), textured(33, 45, 41, channels=4)
    cmyk = io.BytesIO()
    Image.fromarray(k, "CMYK").save(cmyk, "JPEG", quality=80)
    out["jpeg_cmyk.jpg"] = (cmyk.getvalue(), "CMYK as Pillow writes it (Adobe APP14 "
                            "transform 0, inverted samples)")
    out["jpeg_cmyk_no_adobe.jpg"] = (encode_dct(k, [(1, 1)] * 4, "cmyk_bare"),
                                     "4 components without an Adobe marker (CMYK)")
    out["jpeg_ycck.jpg"] = (encode_dct(k, [(2, 2), (1, 1), (1, 1), (2, 2)], "ycck"),
                            "YCCK (Adobe transform 2), 4:2:0 chroma")
    import cv2  # OpenCV's writer is the one with a 4:1:1 option

    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(j[..., ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    assert ok
    out["jpeg_411_opencv.jpg"] = (enc.tobytes(), "4:1:1 from OpenCV (luma H=4, box chroma)")
    for name, factors, what in (
            ("jpeg_h3.jpg", [(3, 1), (1, 1), (1, 1)], "sampling factor 3 (box x3)"),
            ("jpeg_h3v2.jpg", [(3, 2), (1, 1), (1, 1)], "sampling factors 3x2 (box)"),
            ("jpeg_h4v2.jpg", [(4, 2), (1, 1), (1, 1)], "sampling factors 4x2 (box)"),
            ("jpeg_h4_fancy.jpg", [(4, 1), (2, 1), (1, 1)],
             "sampling factor 4 with a 2:1 chroma (fancy h2v1) and a 4:1 chroma (box)"),
            ("jpeg_v4.jpg", [(1, 4), (1, 2), (1, 1)],
             "vertical factor 4 with a 1:2 chroma (fancy h1v2) and a 1:4 chroma (box)")):
        out[name] = (encode_dct(j, factors, "ycc"), what)
    out["jpeg_arith.jpg"] = (encode_dct(j, [(2, 2), (1, 1), (1, 1)], "ycc", arithmetic=True),
                             "arithmetic coding (SOF9), 4:2:0")
    out["jpeg_arith_dac_restart.jpg"] = (
        encode_dct(j, [(2, 1), (1, 1), (1, 1)], "ycc", arithmetic=True, restart=5,
                   dac={"dc": (2, 5), "ac": 3}),
        "arithmetic coding with DAC conditioning (L=2, U=5, Kx=3) and restart markers")
    out["jpeg_arith_grey.jpg"] = (encode_dct(j[..., :1], [(1, 1)], "grey", arithmetic=True),
                                  "arithmetic coding, one component")
    out["jpeg_arith_progressive.jpg"] = (
        encode_dct(j, [(2, 2), (1, 1), (1, 1)], "ycc", arithmetic=True,
                   progressive=_PROGRESSIVE),
        "arithmetic progressive (SOF10): DC and AC first passes and refinements")
    out["jpeg_arith_progressive_restart.jpg"] = (
        encode_dct(j, [(2, 2), (1, 1), (1, 1)], "ycc", arithmetic=True,
                   progressive=_PROGRESSIVE, restart=3),
        "arithmetic progressive with restart markers (statistics reset)")
    g = textured(20, 28, 42)
    for pred in range(1, 8):
        out[f"jpeg_lossless_p{pred}.jpg"] = (encode_lossless(g[..., :1], "grey", pred),
                                             f"lossless (SOF3), grey, predictor {pred}")
    out["jpeg_lossless_pt2.jpg"] = (encode_lossless(g[..., :1], "grey", 4, pt=2),
                                    "lossless, point transform 2")
    out["jpeg_lossless_rgb.jpg"] = (encode_lossless(g, "rgb", 7),
                                    "lossless, Adobe RGB, 3 interleaved components")
    out["jpeg_lossless_no_marker.jpg"] = (encode_lossless(g, "rgb_bare", 1),
                                          "lossless, components 1, 2, 3 and no marker (RGB)")
    out["jpeg_lossless_subsampled.jpg"] = (
        encode_lossless(textured(19, 27, 46), "rgb", 6, factors=[(2, 2), (1, 1), (2, 1)]),
        "lossless, sampling factors 2x2, 1x1, 2x1 (box upsampling, padded MCUs)")
    out["jpeg_lossless_cmyk.jpg"] = (encode_lossless(textured(12, 16, 47, channels=4),
                                                     "cmyk", 5), "lossless CMYK")
    return out


def refused_fixtures():
    """name -> (bytes, what): JPEG and WebP forms that Pillow refuses."""
    j = textured(33, 45, 43)
    lossy = _pillow(textured(30, 40, 20), "WEBP", quality=70)
    return {
        "refused_12bit.jpg": (encode_dct(textured(16, 24, 45), [(1, 1)] * 3, "ycc",
                                         precision=12),
                              "12-bit samples (SOF1)"),
        "refused_dnl.jpg": (encode_dct(j, [(1, 1)] * 3, "ycc", height_in_dnl=True),
                            "height defined by a DNL marker"),
        "refused_sof5.jpg": (encode_dct(j, [(1, 1)] * 3, "ycc", sof=0xC5),
                             "hierarchical (SOF5) frame"),
        "refused_lossless_ycc.jpg": (encode_lossless(textured(12, 16, 44), "ycc", 1),
                                     "lossless YCbCr (no colour conversion in lossless)"),
        "refused_fractional_sampling.jpg": (
            encode_dct(j, [(3, 1), (2, 1), (1, 1)], "ycc"),
            "sampling factors 3 and 2 (a fractional ratio)"),
        "refused_mcu_too_large.jpg": (encode_dct(j, [(4, 4), (1, 1), (1, 1)], "ycc"),
                                      "18 blocks in an interleaved MCU (above 10)"),
        "refused_anim_frame_off_canvas.webp": (
            animated_webp((30, 40), [(lossy, 2, 0, False, False)]),
            "animated frame reaching past the canvas"),
    }


def reference_rgb(path):
    """What the JAX package's ``read_image`` returns (Pillow)."""
    img = np.asarray(Image.open(path)).astype(np.uint8)
    if img.ndim == 2:
        img = np.tile(img[..., None], (1, 1, 3))
    return np.ascontiguousarray(img[..., :3])


def pillow_error(path):
    """Pillow's refusal of a file, as ``"Type: message"``."""
    try:
        reference_rgb(path)
    except Exception as e:  # noqa: BLE001 - whatever Pillow raises is the record
        return f"{type(e).__name__}: {e}".replace(repr(path), "<file>")
    raise AssertionError(f"Pillow decodes {path}")


def main():
    entries, refused = {}, {}
    for name, (data, what) in sorted(fixtures().items()):
        path = os.path.join(HERE, name)
        with open(path, "wb") as fh:
            fh.write(data)
        ref = reference_rgb(path)
        entries[name] = {"shape": list(ref.shape), "bytes": len(data),
                         "sha256_rgb": hashlib.sha256(ref.tobytes()).hexdigest(),
                         "exercises": what}
    for name, (data, what) in sorted(refused_fixtures().items()):
        path = os.path.join(HERE, name)
        with open(path, "wb") as fh:
            fh.write(data)
        refused[name] = {"bytes": len(data), "exercises": what, "pillow": pillow_error(path)}
    manifest = {
        "versions": {"Pillow": PIL.__version__, "libwebp": features.version("webp"),
                     "libjpeg_turbo": features.version("libjpeg_turbo")},
        "digest": "sha256 of the (H, W, 3) uint8 RGB bytes of Pillow's decode",
        "not_held_against_a_reference": [],
        "files": entries,
        "refused_by_pillow": refused,
    }
    with open(os.path.join(HERE, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.write("\n")
    total = sum(e["bytes"] for e in [*entries.values(), *refused.values()])
    print(f"{len(entries)} files and {len(refused)} refused, {total} bytes")


if __name__ == "__main__":
    main()
