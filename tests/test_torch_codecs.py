"""The port's WebP and JPEG decoders (``csrc/webp_decode.cpp``,
``csrc/jpeg_decode.cpp`` through ``io/codecs.py``) against Pillow, which
the JAX package's ``read_image`` decodes with, on the CPU.

- Every committed fixture (``tests/data/codecs``): the port's
  ``read_image`` equals Pillow's decode and JAX's ``read_image`` bit for
  bit (tolerance 0 for WebP and JPEG alike), and the manifest's digests
  equal Pillow's decodes. The fixtures include animated WebP (the first
  frame on its canvas), CMYK and YCCK JPEG, sampling factors of 3 and 4,
  arithmetic coding (sequential and progressive) and lossless frames.
- Every fixture of a form Pillow refuses (12-bit samples, a DNL height, a
  hierarchical frame, lossless YCbCr, fractional sampling, an oversized
  MCU, an animation frame past its canvas) raises on both sides: Pillow
  and JAX's ``read_image`` raise, and the port's ``read_image`` raises a
  ``ValueError`` naming the file and the reason.
- A seeded hypothesis sweep over size, quality, method and subsampling,
  encoded by Pillow here, decodes bit-exact.
- Truncations at 64 cut points and seeded byte flips of small fixtures
  either raise ``ValueError`` or give an image of the right shape, in a
  child process, so that a crash is reported with the input that caused
  it.
- Decoding in four threads gives the single-thread pixels; a failed
  build raises with the compiler's output.
"""

import hashlib
import io
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from raft_ncup_tpu.io import flow_io as jio
from raft_ncup_tpu_torch.io import codec_build, codecs
from raft_ncup_tpu_torch.io import flow_io as pio

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "codecs")
MANIFEST = json.load(open(os.path.join(FIXTURES, "manifest.json")))
NAMES = sorted(MANIFEST["files"])
REFUSED = sorted(MANIFEST["refused_by_pillow"])
SMALL = ["lossy_37x53_q50_m6.webp", "lossy_partitions4_sharp.webp", "lossless_rgba.webp",
         "lossless_palette4.webp", "jpeg_420_33x17.jpg", "jpeg_progressive_420.jpg",
         "jpeg_restart.jpg", "anim_lossy_first.webp", "jpeg_cmyk.jpg",
         "jpeg_arith_progressive_restart.jpg", "jpeg_arith_dac_restart.jpg",
         "jpeg_lossless_p4.jpg", "jpeg_lossless_subsampled.jpg", "jpeg_ycck.jpg",
         "jpeg_h4_fancy.jpg"]


def _pillow(data):
    img = np.asarray(Image.open(io.BytesIO(data))).astype(np.uint8)
    if img.ndim == 2:
        img = np.tile(img[..., None], (1, 1, 3))
    return np.ascontiguousarray(img[..., :3])


def _digest(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _decode(data):
    kind = codecs.sniff(data)
    img = codecs.decode_webp(data) if kind == "webp" else codecs.decode_jpeg(data)
    return np.tile(img[..., None], (1, 1, 3)) if img.ndim == 2 else img


def test_fixtures_cover_the_decoder_branches():
    assert len(NAMES) >= 70 and len(REFUSED) >= 7
    assert sum(e["bytes"] for e in MANIFEST["files"].values()) < 600_000
    assert MANIFEST["versions"]["libwebp"] == "1.6.0"
    what = " ".join(e["exercises"] for e in MANIFEST["files"].values())
    for branch in ("simple loop filter", "normal loop filter", "8 token partitions",
                   "ALPH", "VP8L colour indexing", "progressive", "restart", "4:4:0",
                   "SOF1", "Adobe", "one component", "animated", "CMYK", "YCCK",
                   "sampling factor 4", "sampling factor 3", "4:1:1", "arithmetic coding (SOF9)",
                   "arithmetic progressive (SOF10)", "DAC", "lossless (SOF3)",
                   "point transform", *(f"predictor {p}" for p in range(1, 8))):
        assert branch in what, branch
    assert MANIFEST["not_held_against_a_reference"] == []


@pytest.mark.parametrize("name", NAMES)
def test_fixture_matches_pillow_and_jax(name):
    path = os.path.join(FIXTURES, name)
    data = open(path, "rb").read()
    ref = _pillow(data)
    assert _digest(ref) == MANIFEST["files"][name]["sha256_rgb"]  # the manifest is Pillow's
    got = pio.read_image(path)
    assert got.dtype == np.uint8 and got.shape == tuple(MANIFEST["files"][name]["shape"])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jio.read_image(path))


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70), quality=st.integers(5, 100),
       fmt=st.sampled_from(["webp", "webp_lossless", "jpeg", "jpeg_progressive"]),
       option=st.integers(0, 6), seed=st.integers(0, 2**16))
def test_pillow_encodes_decode_bit_exact(h, w, quality, fmt, option, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.clip(np.stack([np.sin(x / (3.0 + c) + y / 5.0) * 90 + 128 for c in range(3)], -1)
                  + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    if fmt.startswith("webp"):
        Image.fromarray(img).save(buf, "WEBP", quality=quality, method=option,
                                  lossless=fmt == "webp_lossless")
    else:
        Image.fromarray(img if option != 3 else img[..., 0]).save(
            buf, "JPEG", quality=quality, subsampling=option % 3,
            progressive=fmt == "jpeg_progressive", optimize=option == 4)
    data = buf.getvalue()
    np.testing.assert_array_equal(_decode(data), _pillow(data))


def test_decoders_run_in_parallel_threads():
    datas = [open(os.path.join(FIXTURES, n), "rb").read() for n in NAMES]
    want = [_decode(d) for d in datas]
    got = [None] * len(datas)

    def work(k):
        for i in range(k, len(datas), 4):
            got[i] = _decode(datas[i])

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_unsupported_forms_raise_with_a_reason(tmp_path):
    # What raised in the earlier decoders and Pillow reads now decodes as
    # Pillow does: an animation's first frame, CMYK and arithmetic coding.
    anim = io.BytesIO()
    frames = [Image.fromarray(np.full((8, 8, 3), v, np.uint8)) for v in (0, 200)]
    frames[0].save(anim, "WEBP", save_all=True, append_images=frames[1:], duration=40)
    np.testing.assert_array_equal(codecs.decode_webp(anim.getvalue(), "anim.webp"),
                                  _pillow(anim.getvalue()))
    cmyk = io.BytesIO()
    Image.new("CMYK", (8, 8), (10, 20, 30, 40)).save(cmyk, "JPEG")
    got = codecs.decode_jpeg(cmyk.getvalue(), "cmyk.jpg")
    assert got.shape == (8, 8, 4)
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(cmyk.getvalue()))))
    arith = open(os.path.join(FIXTURES, "jpeg_arith.jpg"), "rb").read()
    np.testing.assert_array_equal(codecs.decode_jpeg(arith, "arith.jpg"), _pillow(arith))
    (tmp_path / "x.webp").write_bytes(b"RIFF\x04\x00\x00\x00WEBP")
    with pytest.raises(ValueError, match="x.webp"):
        pio.read_image(tmp_path / "x.webp")
    (tmp_path / "y.jpg").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG, PPM/PGM, JPEG or WebP"):
        pio.read_image(tmp_path / "y.jpg")


# The reason each refused form's ValueError names.
_REASONS = {"refused_12bit.jpg": "12-bit samples", "refused_dnl.jpg": "DNL",
            "refused_sof5.jpg": "hierarchical frame", "refused_lossless_ycc.jpg": "lossless",
            "refused_fractional_sampling.jpg": "fractional sampling",
            "refused_mcu_too_large.jpg": "MCU of 18 blocks",
            "refused_anim_frame_off_canvas.webp": "past the canvas"}


@pytest.mark.parametrize("name", REFUSED)
def test_forms_pillow_refuses_raise_on_both_sides(name):
    path = os.path.join(FIXTURES, name)
    data = open(path, "rb").read()
    assert len(data) == MANIFEST["refused_by_pillow"][name]["bytes"]
    with pytest.raises(Exception):  # noqa: B017 - Pillow's own errors vary by form
        _pillow(data)
    with pytest.raises(Exception):  # noqa: B017
        jio.read_image(path)
    with pytest.raises(ValueError, match=f"{name}.*{_REASONS[name]}"):
        pio.read_image(path)


def test_every_refused_form_has_a_reason():
    assert sorted(_REASONS) == REFUSED


_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    from raft_ncup_tpu_torch.io import codecs

    cases = json.load(open(sys.argv[1]))
    n_err = n_img = n_cut_err = 0
    for label, path, shape in cases:
        data = open(path, "rb").read()
        print(label, flush=True)
        try:
            kind = codecs.sniff(data)
            img = (codecs.decode_webp if kind == "webp" else codecs.decode_jpeg)(data, label)
        except ValueError:
            n_err += 1
            n_cut_err += " cut at " in label
            continue
        n_img += 1
        if shape is not None and list(img.shape[:2]) != shape[:2]:
            print("BADSHAPE", label, img.shape, flush=True)
            sys.exit(3)
    print("DONE", n_err, n_img, n_cut_err, flush=True)
""")


def _payload_start(data):
    if data[:4] == b"RIFF":
        for tag in (b"VP8 ", b"VP8L"):
            i = data.find(tag)
            if i >= 0:
                return i + 8 + 10
    return data.index(b"\xff\xda") + 14


def test_truncated_and_corrupted_files_raise_or_decode(tmp_path):
    rng = np.random.default_rng(14)
    cases = []
    for name in SMALL:
        data = open(os.path.join(FIXTURES, name), "rb").read()
        shape = MANIFEST["files"][name]["shape"]
        for k, cut in enumerate(np.linspace(0, len(data) - 1, 64).astype(int)):
            path = tmp_path / f"{name}.cut{k}"
            path.write_bytes(data[:cut])
            cases.append((f"{name} cut at {cut}", str(path), shape))
        start = _payload_start(data)
        for k in range(48):
            bad = bytearray(data)
            anywhere = k % 3 == 0
            lo = 0 if anywhere else start
            for _ in range(1 + k % 4):
                pos = int(rng.integers(lo, len(bad)))
                bad[pos] ^= 1 << int(rng.integers(0, 8))
            path = tmp_path / f"{name}.flip{k}"
            path.write_bytes(bytes(bad))
            # a flip in a header may change the size; one in the coded data may not
            cases.append((f"{name} flip {k}", str(path), None if anywhere else shape))
    listing = tmp_path / "cases.json"
    listing.write_text(json.dumps(cases))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(listing)], cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 0, (
        f"decoder crashed (rc {proc.returncode}) on: {lines[-1] if lines else '?'}\n"
        f"{proc.stderr[-2000:]}")
    n_err, n_img, n_cut_err = map(int, lines[-1].split()[1:])
    assert n_err + n_img == len(cases)
    assert n_cut_err == 64 * len(SMALL)  # no truncation passes for a whole file


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int broken( { return 0; }\n")
    monkeypatch.setattr(codec_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(codec_build, "BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match=r"broken(.|\n)*error"):
        codec_build.build(("broken",))
    assert not any(n.endswith(".so") for n in os.listdir(tmp_path / "b"))
