"""The port's file codecs, flow colouring, boundary mask and warm-start
splat against the JAX package (and OpenCV and Pillow, which the JAX
package decodes with), on the CPU.

- PNG: round trips of every type the codec writes; files written by
  OpenCV and Pillow (8-bit gray, RGB, RGBA, 16-bit RGB and gray) and
  hand-filtered files that use all five row filters read bit-exact;
  malformed files raise.
- ``.flo``, ``.pfm`` and KITTI 16-bit flow and disparity: the port reads
  what the JAX writers wrote, and the JAX readers read what the port
  wrote, bit-exact; images (PNG, PPM, gray, JPEG, WebP) and ``read_gen``'s
  dispatch.
- ``flow_to_image`` and ``flow_to_color``: bit-exact against JAX.
- ``flow_boundary_mask``: equal to JAX's (OpenCV's dilation) on rigid
  pairs.
- ``forward_interpolate_batch``: equal to JAX's on random fields, fields
  with exact ties and an all-out-of-bounds field.
"""

import io
import struct
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from raft_ncup_tpu.data.synthetic import flow_boundary_mask as jax_boundary_mask
from raft_ncup_tpu.data.synthetic import make_rigid_pair as jax_rigid_pair
from raft_ncup_tpu.io import flow_io as jio
from raft_ncup_tpu.ops.warmstart import forward_interpolate_batch as jax_splat
from raft_ncup_tpu.viz import flow_viz as jviz
from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset, flow_boundary_mask
from raft_ncup_tpu_torch.io import flow_io as pio
from raft_ncup_tpu_torch.io import png
from raft_ncup_tpu_torch.ops.warmstart import forward_interpolate_batch
from raft_ncup_tpu_torch.viz import flow_viz as pviz


def _smooth(g, shape, dtype):
    """Samples with smooth rows, so encoders pick predicting filters."""
    top = 256 if dtype == np.uint8 else 65536
    steps = g.integers(-3, 4, size=shape)
    return (np.cumsum(steps, axis=1) % top).astype(dtype)


# ----------------------------------------------------------------- PNG


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", [(7, 5), (9, 11, 3), (6, 4, 4), (1, 1, 3)])
def test_png_round_trip(tmp_path, dtype, shape):
    g = np.random.default_rng(0)
    img = g.integers(0, np.iinfo(dtype).max, size=shape, endpoint=True).astype(dtype)
    png.write_png(tmp_path / "x.png", img)
    got = png.read_png(tmp_path / "x.png")
    assert got.dtype == dtype and got.shape == shape
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "rgb16", "gray16"])
def test_png_reads_what_opencv_and_pillow_write(tmp_path, kind):
    g = np.random.default_rng(1)
    channels = {"gray": (), "rgb": (3,), "rgba": (4,)}[kind[:-2] if kind[-2:] == "16"
                                                          else kind[:-1]]
    dtype = np.uint16 if kind.endswith("16") else np.uint8
    img = _smooth(g, (23, 37, *channels), dtype)
    bgr = img[..., [2, 1, 0, 3][:img.shape[2]]] if img.ndim == 3 else img
    for level in (1, 9):
        cv2.imwrite(str(tmp_path / "cv.png"), bgr, [cv2.IMWRITE_PNG_COMPRESSION, level])
        np.testing.assert_array_equal(png.read_png(tmp_path / "cv.png"), img)
    if dtype == np.uint8:
        Image.fromarray(img).save(tmp_path / "pil.png")
        np.testing.assert_array_equal(png.read_png(tmp_path / "pil.png"), img)
    # And OpenCV reads what the port wrote.
    png.write_png(tmp_path / "port.png", img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port.png"),
                                             cv2.IMREAD_UNCHANGED), bgr)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(img: np.ndarray, filters) -> bytes:
    """A PNG of 8-bit RGB ``img`` whose row y uses filter ``filters[y]``,
    filtered byte by byte as the PNG specification states it."""
    h, w, _ = img.shape
    rows = img.reshape(h, -1).astype(int)
    body = bytearray()
    for y in range(h):
        body.append(filters[y])
        for i in range(rows.shape[1]):
            a = rows[y, i - 3] if i >= 3 else 0
            b = rows[y - 1, i] if y else 0
            c = rows[y - 1, i - 3] if y and i >= 3 else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][filters[y]]
            body.append((rows[y, i] - pred) % 256)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(body))) + chunk(b"IEND", b""))


def test_png_decodes_every_row_filter():
    g = np.random.default_rng(2)
    img = g.integers(0, 256, size=(12, 9, 3)).astype(np.uint8)
    filters = [0, 1, 2, 3, 4, 4, 3, 1, 3, 2, 0, 4]
    data = _filtered_png(img, filters)
    np.testing.assert_array_equal(png.decode_png(data), img)
    pillow = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(png.decode_png(data), pillow)


def test_png_refuses_malformed_files():
    good = png.encode_png(np.zeros((4, 4, 3), np.uint8))
    bad_crc = good[:40] + bytes([good[40] ^ 1]) + good[41:]
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bad_crc)
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"GIF89a" + good[6:])
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)  # interlaced
    laced = good[:16] + ihdr + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr)) + good[33:]
    with pytest.raises(ValueError, match="interlaced"):
        png.decode_png(laced)
    with pytest.raises(TypeError):
        png.encode_png(np.zeros((4, 4), np.float32))


# ------------------------------------------------------ flows and images


def test_flo_both_ways(tmp_path):
    flow = np.random.default_rng(3).normal(size=(13, 17, 2)).astype(np.float32)
    jio.write_flo(tmp_path / "j.flo", flow)
    np.testing.assert_array_equal(pio.read_flo(tmp_path / "j.flo"), flow)
    pio.write_flo(tmp_path / "p.flo", flow)
    assert (tmp_path / "p.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(pio.read_gen(tmp_path / "p.flo"), flow)


@pytest.mark.parametrize("shape", [(9, 14), (9, 14, 3)])
def test_pfm_both_ways(tmp_path, shape):
    data = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    jio.write_pfm(tmp_path / "j.pfm", data)
    np.testing.assert_array_equal(pio.read_pfm(tmp_path / "j.pfm"), data)
    pio.write_pfm(tmp_path / "p.pfm", data)
    np.testing.assert_array_equal(jio.read_pfm(tmp_path / "p.pfm"), data)
    want = data if data.ndim == 2 else data[..., :2]
    np.testing.assert_array_equal(pio.read_gen(tmp_path / "p.pfm"), want)


def test_kitti_flow_and_disparity_both_ways(tmp_path):
    g = np.random.default_rng(5)
    flow = g.normal(0, 20, size=(15, 22, 2)).astype(np.float32)
    jio.write_flow_kitti(tmp_path / "j.png", flow)
    for a, b in zip(pio.read_flow_kitti(tmp_path / "j.png"),
                    jio.read_flow_kitti(tmp_path / "j.png")):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    pio.write_flow_kitti(tmp_path / "p.png", flow)
    for a, b in zip(jio.read_flow_kitti(tmp_path / "p.png"),
                    pio.read_flow_kitti(tmp_path / "j.png")):
        np.testing.assert_array_equal(a, b)
    disp = _smooth(g, (15, 22), np.uint16)
    disp[3, 4] = 0  # an invalid pixel
    cv2.imwrite(str(tmp_path / "d.png"), disp)
    for a, b in zip(pio.read_disp_kitti(tmp_path / "d.png"),
                    jio.read_disp_kitti(tmp_path / "d.png")):
        np.testing.assert_array_equal(a, b)


def test_images_and_dispatch(tmp_path):
    g = np.random.default_rng(6)
    img = g.integers(0, 256, size=(10, 12, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "a.png"), img[..., ::-1])
    cv2.imwrite(str(tmp_path / "a.ppm"), img[..., ::-1])
    cv2.imwrite(str(tmp_path / "g.png"), img[..., 0])
    for name in ("a.png", "a.ppm"):
        np.testing.assert_array_equal(pio.read_gen(tmp_path / name), img)
    np.testing.assert_array_equal(pio.read_image(tmp_path / "a.png"),
                                  jio.read_image(tmp_path / "a.png"))
    np.testing.assert_array_equal(pio.read_image(tmp_path / "g.png"),
                                  jio.read_image(tmp_path / "g.png"))
    from PIL import Image

    for ext in (".jpg", ".jpeg", ".webp"):  # the port's C++ decoders against Pillow's
        Image.fromarray(img).save(tmp_path / f"x{ext}", quality=80)
        np.testing.assert_array_equal(pio.read_gen(tmp_path / f"x{ext}"),
                                      jio.read_image(tmp_path / f"x{ext}"))
    flow = g.normal(size=(2, 5, 6)).astype(np.float32)
    np.savez(tmp_path / "f.npz", optical_flow=flow)
    np.testing.assert_array_equal(pio.read_gen(tmp_path / "f.npz"),
                                  jio.read_gen(tmp_path / "f.npz"))
    with pytest.raises(ValueError, match="unsupported"):
        pio.read_gen(tmp_path / "x.tif")


# ------------------------------------------------------------ flow colour


@pytest.mark.parametrize("rad_max", [None, 3.0])
def test_flow_colouring_is_bit_exact(rad_max):
    g = np.random.default_rng(7)
    flow = g.normal(0, 4, size=(31, 43, 2)).astype(np.float32)
    flow[0, 0] = (2e7, 0.0)  # unknown flow
    flow[1, 1] = (0.0, 0.0)
    np.testing.assert_array_equal(pviz.make_colorwheel(), jviz.make_colorwheel())
    for fn in ("flow_to_image", "flow_to_color"):
        for bgr in (False, True):
            a = getattr(pviz, fn)(flow, convert_to_bgr=bgr, rad_max=rad_max)
            b = getattr(jviz, fn)(flow, convert_to_bgr=bgr, rad_max=rad_max)
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b, err_msg=f"{fn} bgr={bgr}")


# ---------------------------------------------------------- boundary mask


@pytest.mark.parametrize("seed", [0, 1])
def test_boundary_mask_matches_jax_on_rigid_pairs(seed):
    jax_flow = jax_rigid_pair(np.random.default_rng(seed), (48, 64), 12.0)["flow"]
    port_flow = SyntheticFlowDataset((48, 64), length=4, seed=seed, style="rigid").sample(
        1)["flow"]
    for flow in (jax_flow, port_flow.numpy()):
        got = flow_boundary_mask(flow)
        want = jax_boundary_mask(flow)
        assert got.dtype == bool and 0 < got.sum() < got.size
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(flow_boundary_mask(jax_flow, 1.0, 1),
                                  jax_boundary_mask(jax_flow, 1.0, 1))


# ----------------------------------------------------------------- splat


def _splat_fields():
    g = np.random.default_rng(8)
    rand = g.normal(0, 3, size=(2, 9, 14, 2)).astype(np.float32)
    # Integer shifts put several points at the same distance of a cell.
    ties = g.integers(-2, 3, size=(2, 9, 14, 2)).astype(np.float32)
    ties[1] = 0.5
    oob = np.full((2, 9, 14, 2), 50.0, np.float32)
    oob[0, 3, 4] = (-0.25, 0.5)  # one survivor in row 0; row 1 has none
    return {"random": rand, "ties": ties, "out_of_bounds": oob}


@pytest.mark.parametrize("name", ["random", "ties", "out_of_bounds"])
@pytest.mark.parametrize("chunk", [7, 1024])
def test_splat_matches_jax(name, chunk):
    flow = _splat_fields()[name]
    want = np.asarray(jax_splat(jnp.asarray(flow), chunk=chunk))
    got = forward_interpolate_batch(torch.from_numpy(flow), chunk=chunk).numpy()
    np.testing.assert_array_equal(got, want)
    if name == "out_of_bounds":
        assert not got[1].any() and got[0].any()
