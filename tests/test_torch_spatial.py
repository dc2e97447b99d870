"""The spatial axis of the port (``raft_ncup_tpu_torch/parallel/halo.py``):
the test-mode forward split by image rows across processes, on the CPU.

One-process cases hold the halo arithmetic (``halo.halo_rows``) against
the rows each output row reads, and the halo convolution of every
convolution shape the model uses (the 7x7/s2 stem, 3x3 at strides 1 and 2,
the 1x1/s2 downsample, the GRU's 5x1 and 1x5, a dilated 3x3, kernel B's
plain version at K 3 and 5, the convex upsampler's 3x3 unfold) against the
whole-image op: each band of S is run with ``halo.extend`` reading its
neighbours' rows from the whole tensor, and the bands joined must equal
the whole image's result within 1e-6; so must the U-Net weights net on
bands that pool to an odd row, which it runs on the gathered whole image.

One two-rank gloo world for the module (``tests/_torch_spatial_child.py``,
each rank in its own interpreter with its own timeout) on the mesh
``(data=1, spatial=2)``:

- the test-mode forward of the small ``raft_nc_dbl`` and the small ``raft``
  at 64x96 (the pad divisor 16), 4 iterations, f32, from carried JAX
  weights, against JAX's forward on ``make_mesh(data=1, spatial=2)`` over
  two of the 8 virtual CPU devices (``corr_impl="onthefly"`` there) at the
  flagship's tolerances (flow_lr atol 2e-3, flow_up atol 5e-3, rtol 1e-3),
  and against the port's one-process forward at atol 1e-4 (the same code,
  its convolutions on bands);
- each forward's halo exchanges, gathers and sums against what its
  convolutions, NConv layers and instance norms need, counted by hooks on
  the one-process forward; a guarded window around a sharded forward
  counting no implicit transfer;
- instance norm over two bands against the whole image;
- sharded ``validate_synthetic`` against one process, its reduced sums
  equal (no pair counted twice), the evaluate entry with ``--mesh 1,2``
  and the highres entry with ``--mesh 1,2`` against one process.
"""

import contextlib
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from raft_ncup_tpu.config import small_model_config as jax_small_model_config
from raft_ncup_tpu.inference.pipeline import ShapeCachedForward as JaxShapeCachedForward
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.parallel import make_mesh as jax_make_mesh
from raft_ncup_tpu.utils.torch_import import import_torch_state
from raft_ncup_tpu_torch import evaluation
from raft_ncup_tpu_torch import evaluate as eval_entry
from raft_ncup_tpu_torch import highres_forward
from raft_ncup_tpu_torch.evaluation import validate_synthetic
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.nn.layers import Conv2d, InstanceNorm2d, init_weights
from raft_ncup_tpu_torch.nn.nconv_unet import NConv2dLayer
from raft_ncup_tpu_torch.ops.geometry import convex_upsample_nchw
from raft_ncup_tpu_torch.ops.nconv import nconv2d_nchw
from raft_ncup_tpu_torch.parallel import halo

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_spatial_child as child  # noqa: E402

WORLD = 2
SPAWN_TIMEOUT_S = 240
FLOW_LR_TOL = dict(atol=2e-3, rtol=1e-3)
FLOW_UP_TOL = dict(atol=5e-3, rtol=1e-3)
SELF_ATOL = 1e-4
BAND_ATOL = 1e-6
VAL_RTOL = 1e-5

# (name, Conv2d arguments): every convolution shape of the model.
CONVS = [
    ("7x7/s2/p3 stem", dict(in_channels=3, out_channels=8, kernel_size=7, stride=2)),
    ("3x3/s1", dict(in_channels=4, out_channels=6, kernel_size=3)),
    ("3x3/s2", dict(in_channels=4, out_channels=6, kernel_size=3, stride=2)),
    ("1x1/s2 downsample", dict(in_channels=4, out_channels=6, kernel_size=1, stride=2)),
    ("5x1 GRU", dict(in_channels=4, out_channels=6, kernel_size=(5, 1))),
    ("1x5 GRU", dict(in_channels=4, out_channels=6, kernel_size=(1, 5))),
    ("3x3 dilation 2", dict(in_channels=4, out_channels=6, kernel_size=3, dilation=2,
                            padding=2)),
]


# ------------------------------------------------------------ one process


@pytest.mark.parametrize("kernel,stride,padding,dilation", [
    (7, 2, 3, 1), (3, 1, 1, 1), (3, 2, 1, 1), (1, 2, 0, 1), (5, 1, 2, 1), (1, 1, 0, 1),
    (3, 1, 2, 2), (5, 2, 2, 1)])
@pytest.mark.parametrize("S", [2, 4])
def test_halo_rows_are_the_rows_the_band_reads(kernel, stride, padding, dilation, S):
    H = 16 * S
    rows = H // S
    for s in range(S):
        first = s * rows
        outs = [o for o in range((H + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1)
                if first <= o * stride < first + rows]
        read = [o * stride - padding + j * dilation for o in outs for j in range(kernel)]
        top, bottom = halo.halo_rows(kernel, stride, padding, dilation, first, rows)
        assert (min(read), max(read)) == (first - top, first + rows - 1 + bottom)


@contextlib.contextmanager
def _band(monkeypatch, S, s, whole):
    """Band ``s`` of ``S`` in one process: ``halo.extend`` takes the
    neighbours' rows (zeros past the image's edges) from ``whole``, the
    tensor of which the op's input is the band. Yields the extend calls."""
    calls = []

    def extend(x, top, bottom, dim=2):
        calls.append((top, bottom))
        h = whole.shape[dim] // S
        pad = max(top, bottom, 0)
        shape = list(whole.shape)
        shape[dim] = pad
        padded = torch.cat([whole.new_zeros(shape), whole, whole.new_zeros(shape)], dim=dim)
        assert x.shape[dim] == h
        return padded.narrow(dim, pad + s * h - top, h + top + bottom)

    monkeypatch.setattr(halo, "extend", extend)
    with halo.spatial(halo.SpatialGroup(size=S, index=s, ranks=tuple(range(S)))):
        yield calls


def _bands(monkeypatch, S, whole_input, fn, dim=2):
    """``fn`` of each band of ``whole_input``, joined along ``dim``."""
    parts, calls = [], []
    for s in range(S):
        with _band(monkeypatch, S, s, whole_input) as c:
            parts.append(fn(halo.band(whole_input, dim)))
        calls += c
    return torch.cat(parts, dim=dim), calls


@pytest.mark.parametrize("name,kw", CONVS, ids=[c[0] for c in CONVS])
@pytest.mark.parametrize("S", [2, 4])
def test_halo_conv_matches_the_whole_image(monkeypatch, name, kw, S):
    conv = Conv2d(**kw)
    init_weights(conv, torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, kw["in_channels"], 8 * S, 12)).astype(np.float32))
    got, calls = _bands(monkeypatch, S, x, conv)
    want = conv(x)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=BAND_ATOL, rtol=0)
    kh = conv.kernel_size[0]
    assert bool(calls) == (kh > 1 or conv.stride[0] > 1), calls


@pytest.mark.parametrize("k", [3, 5])
def test_halo_nconv_matches_the_whole_image(monkeypatch, k):
    g = np.random.default_rng(k)
    data = torch.from_numpy(g.normal(size=(2, 2, 16, 12)).astype(np.float32))
    conf = torch.from_numpy((g.random((2, 2, 16, 12)) > 0.5).astype(np.float32))
    weight = torch.from_numpy(g.random((2, 2, k, k)).astype(np.float32))
    whole = torch.cat([data, conf], dim=1)

    def op(both):
        return torch.cat(nconv2d_nchw(both[:, :2], both[:, 2:], weight, impl="xla"), dim=1)

    got, calls = _bands(monkeypatch, 2, whole, op)
    torch.testing.assert_close(got, op(whole), atol=BAND_ATOL, rtol=0)
    assert calls == [(k // 2, k // 2)] * 2


def test_halo_convex_upsample_matches_the_whole_image(monkeypatch):
    g = np.random.default_rng(5)
    flow = torch.from_numpy(g.normal(size=(1, 2, 8, 6)).astype(np.float32))
    mask = torch.from_numpy(g.normal(size=(1, 9 * 64, 8, 6)).astype(np.float32))
    got = torch.cat([
        _bands_pair(monkeypatch, flow, mask, s) for s in range(2)], dim=2)
    torch.testing.assert_close(got, convex_upsample_nchw(flow, mask, 8), atol=BAND_ATOL, rtol=0)


def _bands_pair(monkeypatch, flow, mask, s):
    with _band(monkeypatch, 2, s, flow) as calls:
        out = convex_upsample_nchw(halo.band(flow, 2), halo.band(mask, 2), 8)
    assert calls == [(1, 1)]
    return out


def test_unet_weights_net_on_a_band_that_pools_to_an_odd_row_is_the_whole_images(monkeypatch):
    """The U-Net weights net (two poolings) on bands of 6 rows, which pool
    to an odd row: each rank runs it on the gathered whole image and keeps
    its band, so the bands joined equal the whole image's output."""
    from raft_ncup_tpu_torch.nn.weights_est import UNetWeightsNet

    net = UNetWeightsNet(4).eval()
    init_weights(net, torch.Generator().manual_seed(6))
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 4, 12, 8)).astype(
        np.float32))
    gathered = []

    def all_gather_rows(t, dim=1, group=None):
        gathered.append(tuple(t.shape))
        return x

    monkeypatch.setattr(halo, "all_gather_rows", all_gather_rows)
    got, calls = _bands(monkeypatch, 2, x, net)
    assert calls == [] and gathered == [(2, 4, 6, 8)] * 2  # no halo: the whole image, banded
    torch.testing.assert_close(got, net(x), atol=BAND_ATOL, rtol=0)


# ------------------------------------------------------------ two ranks


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(variant):
    """The port's seeded weights carried into JAX's variables."""
    seeded = RAFT(child.model_cfg(variant), device="cpu", seed=0)
    jmodel = JaxRAFT(jax_small_model_config(variant, dataset=child.MODELS[variant],
                                            corr_impl="onthefly"))
    template = jax.eval_shape(lambda k: jmodel.init(k, (1, child.H, child.W, 3)),
                              jax.random.key(0))
    variables = import_torch_state({k: v.numpy() for k, v in seeded.state_dict().items()},
                                   template, strict=True)
    return jmodel, jax.tree_util.tree_map(np.asarray, variables)


def _inputs():
    g = np.random.default_rng(21)
    img1 = g.uniform(0, 255, (1, child.H, child.W, 3)).astype(np.float32)
    return {"image1": torch.from_numpy(img1),
            "image2": torch.from_numpy(np.roll(img1, (2, 3), axis=(1, 2)).copy()),
            "norm_input": torch.from_numpy((3 * g.normal(size=(2, 5, 16, 12)) + 1).astype(
                np.float32))}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _needs(m, inputs):
    """The collectives one sharded forward of ``m`` over two ranks needs,
    counted by hooks on its one-process forward: a halo exchange for each
    convolution that reads across a band's edge (its rows above and below
    as bytes), each NConv layer wider than 1x1, an all-gather of fmap2 and
    of the outputs, two sums for each instance norm."""
    need = {"collective-permute": [0, 0], "all-reduce": [0, 0]}

    def conv_hook(mod, args):
        x = args[0]
        rows = x.shape[2] // WORLD
        kh, sh = mod.kernel_size[0], mod.stride[0]
        top, bottom = halo.halo_rows(kh, sh, mod.padding[0], mod.dilation[0], 0, rows)
        n = max(top, 0) + max(bottom, 0)
        if (kh > 1 or sh > 1) and n:
            need["collective-permute"][0] += 1
            need["collective-permute"][1] += n * x.numel() // x.shape[2] * 4

    def nconv_hook(mod, args):
        p = mod.weight_p.shape[-1] // 2
        if p:
            d = args[0]
            need["collective-permute"][0] += 1
            need["collective-permute"][1] += 2 * p * 2 * d.numel() // d.shape[2] * 4

    def norm_hook(mod, args):
        need["all-reduce"][0] += 2
        need["all-reduce"][1] += 2 * args[0].shape[0] * args[0].shape[1] * 4

    hooks = []
    for mod in m.modules():
        hook = {Conv2d: conv_hook, NConv2dLayer: nconv_hook, InstanceNorm2d: norm_hook}.get(
            type(mod))
        if hook is not None:
            hooks.append(mod.register_forward_pre_hook(hook))
    try:
        flows = m(inputs["image1"], inputs["image2"], iters=child.ITERS)
    finally:
        for h in hooks:
            h.remove()
    return flows, need


def _capture_pull(monkeypatch, what):
    """Record the accumulators a validation pass pulls (and reduces)."""
    seen = []
    real = getattr(evaluation, what)

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        seen.append(np.array(out))
        return out

    monkeypatch.setattr(evaluation, what, wrapped)
    return seen


def _references(inputs, variables, jmodels):
    jax_mesh = jax_make_mesh(data=1, spatial=2, devices=jax.devices()[:2])
    refs = {}
    for variant in child.MODELS:
        jfwd = JaxShapeCachedForward(jmodels[variant], variables[variant], mesh=jax_mesh)
        jax_lr, jax_up = jfwd(inputs["image1"].numpy(), inputs["image2"].numpy(),
                              iters=child.ITERS)
        (lr, up), need = _needs(child.model(variant, variables[variant]), inputs)
        refs[variant] = {"jax": (np.asarray(jax_lr), np.asarray(jax_up)), "port": (lr, up),
                         "need": need}
    refs["instance_norm"] = InstanceNorm2d(5)(inputs["norm_input"])
    m = child.model("raft", variables["raft"])
    with pytest.MonkeyPatch.context() as mp:
        pulls = _capture_pull(mp, "_pull")
        refs["validation"] = validate_synthetic(m, **child.VAL)
    refs["validation_acc"] = pulls
    refs["evaluate"] = child.entry_json(eval_entry.main, child.EVAL_ARGV)
    refs["highres"] = child.entry_json(highres_forward.main, child.HIGHRES_ARGV)
    hr = highres_forward
    args = hr.build_parser().parse_args(child.HIGHRES_ARGV)
    img1, img2 = hr.frames(*args.size)
    refs["highres_flows"] = RAFT(hr.model_config(True, "f32"), device="cpu", seed=hr.SEED)(
        img1, img2, iters=args.iters)
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both ranks' outputs, after one run of the child in each; the
    references are computed here while the ranks run."""
    work = tmp_path_factory.mktemp("spatial")
    jmodels, variables = {}, {}
    for variant in child.MODELS:
        jmodels[variant], variables[variant] = _variables(variant)
    inputs = _inputs()
    torch.save({**inputs, "variables": variables}, work / "inputs.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE), OMP_NUM_THREADS="1")
    env.pop("RAFT_TORCH_FLIGHT_DIR", None)
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_spatial_child.py"),
                               str(port), str(r), str(WORLD), str(work)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(WORLD)]
    logs = []
    try:
        refs = _references(inputs, variables, jmodels)
        for p in procs:
            out, _ = p.communicate(timeout=SPAWN_TIMEOUT_S)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    out = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": out, "refs": refs, "work": work}


def test_the_world_is_a_spatial_mesh(world):
    for r, rank in enumerate(world["ranks"]):
        assert rank["fingerprint"] == "mesh(data=1,spatial=2:cpu)"
        assert rank["backend"] == "gloo" and rank["layout"] == (0, r)
        assert rank["barrier"]


@pytest.mark.parametrize("variant", list(child.MODELS))
def test_forward_matches_jax_and_one_process(world, variant):
    ref = world["refs"][variant]
    jax_lr, jax_up = ref["jax"]
    lr1, up1 = ref["port"]
    for rank in world["ranks"]:
        got = rank["forwards"][variant]
        lr, up = got["flow_lr"], got["flow_up"]
        assert lr.shape == (1, child.H // 8, child.W // 8, 2)
        assert up.shape == (1, child.H, child.W, 2)
        np.testing.assert_allclose(lr.numpy(), jax_lr, **FLOW_LR_TOL)
        np.testing.assert_allclose(up.numpy(), jax_up, **FLOW_UP_TOL)
        torch.testing.assert_close(lr, lr1, atol=SELF_ATOL, rtol=0)
        torch.testing.assert_close(up, up1, atol=SELF_ATOL, rtol=0)
    a, b = (r["forwards"][variant] for r in world["ranks"])
    assert torch.equal(a["flow_up"], b["flow_up"])  # both ranks hold the same gathered flow


@pytest.mark.parametrize("variant", list(child.MODELS))
def test_collectives_are_what_the_convolutions_need(world, variant):
    need = world["refs"][variant]["need"]
    B, C, h8, w8 = 1, 128, child.H // 8, child.W // 8  # the small fnet's 128 channels
    gathers = [B * h8 * w8 * C * 4, B * h8 * w8 * 2 * 4, B * child.H * child.W * 2 * 4]
    if variant == "raft":  # the small raft's bilinear x8 reads the gathered low-res flow
        gathers.append(B * h8 * w8 * 2 * 4)
    for rank in world["ranks"]:
        by_op = rank["forwards"][variant]["collectives"]["by_op"]
        for op in ("collective-permute", "all-reduce"):
            assert [by_op[op]["count"], by_op[op]["bytes"]] == need[op], op
        assert by_op["all-gather"] == {"count": len(gathers), "bytes": sum(gathers)}
        assert need["collective-permute"][0] > 3 * child.ITERS


def test_a_guarded_sharded_forward_counts_no_implicit_transfer(world):
    for rank in world["ranks"]:
        assert rank["forwards"]["guarded"] == {"host_transfers": 0, "sanctioned_gets": 0}


def test_instance_norm_over_two_bands_is_the_whole_images(world):
    for rank in world["ranks"]:
        torch.testing.assert_close(rank["instance_norm"], world["refs"]["instance_norm"],
                                   atol=BAND_ATOL, rtol=0)


def test_sharded_validation_equals_one_process_and_counts_each_pair_once(world):
    refs = world["refs"]
    (one_acc,) = refs["validation_acc"]
    for rank in world["ranks"]:
        got = rank["validation"]
        assert set(got) == set(refs["validation"])
        for k, v in refs["validation"].items():
            assert abs(got[k] - v) <= VAL_RTOL * abs(v), (k, got[k], v)
        # The reduced sums: the one-process sums, not twice them.
        (acc,) = rank["validation_acc"]
        np.testing.assert_allclose(acc, one_acc, rtol=VAL_RTOL)
        # One all-reduce of the sums, over the data group (the rank itself).
        assert rank["validation_collectives"]["by_op"]["all-reduce"]["count"] >= 1


def test_evaluate_entry_with_a_spatial_mesh(world):
    code1, one = world["refs"]["evaluate"]
    assert code1 == 0 and one["results"] and one["mesh"] == "nomesh"
    for r, rank in enumerate(world["ranks"]):
        code, rep = rank["evaluate"]
        assert code == 0 and rep["mesh"] == "mesh(data=1,spatial=2:cpu)"
        assert rep["world"] == 2 and rep["rank"] == r
        assert rep["collectives"]["by_op"]["collective-permute"]["count"] > 0
        for k, v in one["results"].items():
            assert abs(rep["results"][k] - v) <= VAL_RTOL * abs(v), (k, rep["results"][k], v)


def test_highres_entry_with_a_spatial_mesh(world):
    code1, one = world["refs"]["highres"]
    lr1, up1 = world["refs"]["highres_flows"]
    assert code1 == 0 and one["mesh"] == "nomesh" and one["collectives"] == 0
    for r, rank in enumerate(world["ranks"]):
        code, rep = rank["highres"]
        assert code == 0 and rep["finite"] and rep["rank"] == r and rep["devices"] == 2
        assert rep["mesh"] == "mesh(data=1,spatial=2:cpu)" and rep["collectives"] > 0
        flows = torch.load(world["work"] / "highres" / f"flows_rank{r}.pt")
        torch.testing.assert_close(flows["flow_lr"], lr1, atol=SELF_ATOL, rtol=0)
        torch.testing.assert_close(flows["flow_up"], up1, atol=SELF_ATOL, rtol=0)
