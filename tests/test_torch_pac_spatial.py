"""The PAC and DJIF heads and the bf16 presets on a band of rows of the
spatial axis (``parallel/halo.py``, ``ops/pac.py``, ``nn/pac.py``), on the
CPU.

One process, the bands emulated:

- the halo arithmetic of the banded half-pixel resize (``halo.resize_halo``)
  and of the transposed PAC convolution (``ops.pac.transpose_band_rows``)
  against the rows each output row reads;
- the single-input ops on S in {2, 4} bands through ``tests/test_torch_spatial.py``'s
  ``_bands`` (``halo.extend`` reading the neighbours' rows from the whole
  tensor): the resize up x8, up x4 and down x2, the patches, the adapting
  kernel at stride 1 and 2 and with a smoothed centre, the transposed PAC
  convolution with the whole kernel's band;
- the modules (``PacJointUpsample``, ``DJIF``, the normalised
  ``PacConvTranspose2d``, ``JointBilateral``) on S in {2, 4} bands run at
  once, one thread a band, whose ``halo.extend``, ``all_gather_rows`` and
  ``group_sum`` swap tensors between the threads (:func:`emulated_bands`):
  the bands' outputs joined against the whole image's within 1e-5, and the
  gradients of the whole inputs and of every parameter through them in
  float64 within 1e-10 of their largest (a gradient zero by structure,
  below 1e-6 of the largest, as rounding noise on both sides);
- a guard that no upsampler kind refuses a band: the small
  ``raft_nc_dbl`` with every kind (``nconv``, ``bilinear``, ``pac``,
  ``djif``) under ``f32`` and ``bf16_infer``, its emulated two-band
  forward against its whole-image forward: within ``SELF_ATOL`` under f32,
  and under bf16 no further, in mean EPE and in the largest difference,
  than the whole image's bf16 forward is from its f32 forward (the bands'
  f32 group sums round differently, and bf16 keeps a flipped last bit).

One two-rank gloo world (``tests/_torch_pac_spatial_child.py forward``) on
the mesh ``(data=1, spatial=2)``, from JAX's variables carried across:

- the small ``raft_nc_dbl`` with each head, test mode at 64x96, 3
  iterations, against JAX's forward on ``make_mesh(data=1, spatial=2)``
  over two of the 8 virtual CPU devices (``corr_impl="onthefly"``) at the
  flagship's tolerances (flow_lr atol 2e-3, flow_up atol 5e-3, rtol 1e-3)
  and against the port's one-process forward at atol 1e-4;
- the highres entry with the PAC head and the evaluate entry with the DJIF
  head under ``--mesh 1,2`` against one process, and the serve entry with
  the PAC head against one process's answers at atol 1e-4.

The heads' train steps on the mesh are ``tests/test_torch_pac_spatial_train.py``'s,
the bf16 presets' ``tests/test_torch_bf16_spatial.py``'s (the same child
script, each file a world of its own, so that each stays near a minute).
"""

import os
import socket
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from raft_ncup_tpu.config import ModelConfig as JaxModelConfig
from raft_ncup_tpu.config import UpsamplerConfig as JaxUpsamplerConfig
from raft_ncup_tpu.inference.pipeline import ShapeCachedForward as JaxShapeCachedForward
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.parallel import make_mesh as jax_make_mesh
from raft_ncup_tpu.utils.torch_import import import_torch_state
from raft_ncup_tpu_torch import evaluate as eval_entry
from raft_ncup_tpu_torch import highres_forward
from raft_ncup_tpu_torch.config import UpsamplerConfig, small_model_config
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.nn import pac as pac_nn
from raft_ncup_tpu_torch.nn.layers import init_weights
from raft_ncup_tpu_torch.ops import pac as pac_ops
from raft_ncup_tpu_torch.parallel import halo

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_pac_spatial_child as child  # noqa: E402
from test_torch_spatial import _band, _bands  # noqa: E402

WORLD = 2
SPAWN_TIMEOUT_S = 240
FLOW_LR_TOL = dict(atol=2e-3, rtol=1e-3)
FLOW_UP_TOL = dict(atol=5e-3, rtol=1e-3)
SELF_ATOL = 1e-4
BAND_TOL = 1e-5
NEGLIGIBLE = 1e-6  # of the largest gradient: rounding noise
F64_TOL = 1e-10  # of a float64 gradient's largest value
KINDS = ("nconv", "bilinear", "pac", "djif")
PRESETS = ("f32", "bf16_infer")


def rnp(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def _epe(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b), axis=-1).mean())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ the bands


class _Swap:
    """The tensors of ``size`` threads, swapped: each thread posts its own
    and gets every thread's, in band order."""

    def __init__(self, size: int):
        self.barrier = threading.Barrier(size)
        self.slots = [None] * size

    def __call__(self, index: int, value):
        self.slots[index] = value
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got


def emulated_bands(S, fn, *wholes, dim=1, calls=None):
    """``fn`` on each band of ``S`` of the whole inputs, the bands run at once
    in ``S`` threads under a spatial group each, joined along ``dim``.
    ``halo.extend`` takes the neighbours' rows from their threads' tensors
    (zeros past the image's edges), ``all_gather_rows`` and ``group_sum``
    join and sum every thread's; all are differentiable, so a gradient
    taken through the joined outputs reaches the whole inputs. ``calls``
    collects each band's ``(top, bottom)`` halo counts."""
    swap = _Swap(S)

    def extend(x, top, bottom, dim=2):
        s = halo.current().index
        if calls is not None:
            calls.append((top, bottom))
        parts = swap(s, x)
        h = x.shape[dim]
        if top < 0:
            x, h, top = x.narrow(dim, -top, h + top), h + top, 0
        if bottom < 0:
            x, h, bottom = x.narrow(dim, 0, h + bottom), h + bottom, 0

        def rows(n, src, from_end):
            if n == 0:
                return None
            if src is None:
                shape = list(x.shape)
                shape[dim] = n
                return x.new_zeros(shape)
            return src.narrow(dim, src.shape[dim] - n if from_end else 0, n)

        above = rows(top, parts[s - 1] if s > 0 else None, True)
        below = rows(bottom, parts[s + 1] if s < S - 1 else None, False)
        return torch.cat([p for p in (above, x, below) if p is not None], dim=dim)

    def all_gather_rows(x, dim=1, group=None):
        return torch.cat(swap((group or halo.current()).index, x), dim=dim)

    def group_sum(t):
        return sum(swap(halo.current().index, t))

    outs, errors = [None] * S, []

    def work(s):
        try:
            torch.set_num_threads(1)
            with halo.spatial(halo.SpatialGroup(size=S, index=s, ranks=tuple(range(S)))):
                outs[s] = fn(*[halo.band(w, dim) for w in wholes])
        except BaseException as e:  # noqa: BLE001 - re-raised on the test's thread
            errors.append(e)
            swap.barrier.abort()

    threads = [threading.Thread(target=work, args=(s,)) for s in range(S)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(halo, "extend", extend)
        mp.setattr(halo, "all_gather_rows", all_gather_rows)
        mp.setattr(halo, "group_sum", group_sum)
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=dim) for parts in zip(*outs))
    return torch.cat(outs, dim=dim)


# ------------------------------------------------------- halo arithmetic


@pytest.mark.parametrize("in_rows,out_rows", [(4, 32), (8, 4), (4, 16), (16, 8), (6, 24)])
@pytest.mark.parametrize("S", [2, 4])
def test_resize_halo_holds_every_row_the_band_reads(in_rows, out_rows, S):
    """The resize's halo against the rows with a nonzero weight in the whole
    image's weight matrix, for every interior band (edge bands ask the same
    counts and get zeros past the image)."""
    w = pac_ops._resize_weights(in_rows * S, out_rows * S, "cpu")
    top, bottom = halo.resize_halo(in_rows, out_rows, S)
    need_top = need_bottom = 0
    for s in range(S):
        read = torch.nonzero(w[:, s * out_rows:(s + 1) * out_rows].abs().sum(dim=1))[:, 0]
        need_top = max(need_top, s * in_rows - int(read.min()))
        need_bottom = max(need_bottom, int(read.max()) - ((s + 1) * in_rows - 1))
    assert (top, bottom) == (need_top, need_bottom)
    assert max(top, bottom) <= 1  # the heads' resizes read one row of halo


@pytest.mark.parametrize("stride,ksize,padding,output_padding", [
    (2, 5, 2, 1), (4, 5, 1, 1), (2, 3, 1, 1), (2, 4, 1, 0)])
def test_transpose_band_rows_are_the_rows_the_band_reads(stride, ksize, padding,
                                                         output_padding):
    """The transposed convolution's halo and its stuffed band's padding
    against the input rows each output row of the band reads (stuffed rows
    ``o - p + j`` the stride divides) and the stuffed rows it spans."""
    rows, S = 4, 3
    top, bottom, lo, hi = pac_ops.transpose_band_rows(rows, stride, ksize, 1, padding,
                                                      output_padding)
    p = ksize - 1 - padding
    s = 1  # an interior band
    first_out = stride * s * rows
    stuffed = [o - p + j for o in range(first_out, first_out + stride * rows)
               for j in range(ksize)]
    read = [r // stride for r in stuffed if r % stride == 0]
    assert (top, bottom) == (s * rows - min(read), max(read) - (s * rows + rows - 1))
    span = stride * (top + rows - 1 + bottom) + 1  # the halo-extended band, stuffed
    assert lo + span + hi - (ksize - 1) == stride * rows
    assert stride * (s * rows - top) - lo == min(stuffed)


def test_a_transposed_convolution_that_changes_the_height_refuses_a_band():
    with pytest.raises(ValueError, match="cannot run on a band"):
        pac_ops.transpose_band_rows(4, 2, 5, 1, 0, 0)


# --------------------------------------------------- single-input ops


SINGLE_OPS = {
    "resize up x8": (rnp(1, 2, 8, 6, 3), lambda b: pac_ops.resize_half_pixel(
        b, (8 * b.shape[1], 48))),
    "resize up x4": (rnp(2, 2, 8, 6, 3), lambda b: pac_ops.resize_half_pixel(
        b, (4 * b.shape[1], 24))),
    "resize down x2": (rnp(3, 2, 16, 12, 3), lambda b: pac_ops.resize_half_pixel(
        b, (b.shape[1] // 2, 6))),
    "patches": (rnp(4, 2, 16, 7, 3), lambda b: pac_ops.extract_patches(b, 5, 1)),
    "patches dilated": (rnp(5, 2, 16, 7, 3), lambda b: pac_ops.extract_patches(b, 3, 2)),
    "kernel": (rnp(6, 2, 16, 7, 3), lambda b: pac_ops.pac_kernel2d(b, 5, padding=2)[0]),
    "kernel stride 2": (rnp(7, 2, 16, 7, 3), lambda b: pac_ops.pac_kernel2d(
        b, 3, stride=2, padding=1)[0]),
    "kernel smoothed": (rnp(8, 2, 16, 7, 3), lambda b: pac_ops.pac_kernel2d(
        b, 5, padding=2, smooth_kernel=pac_ops.smooth_kernel_2d("gaussian"))[0]),
}


@pytest.mark.parametrize("name", list(SINGLE_OPS))
@pytest.mark.parametrize("S", [2, 4])
def test_single_input_op_on_bands_is_the_whole_images(monkeypatch, name, S):
    x, op = SINGLE_OPS[name]
    got, calls = _bands(monkeypatch, S, x, op, dim=1)
    want = op(x)
    assert got.shape == want.shape and calls
    torch.testing.assert_close(got, want, atol=BAND_TOL, rtol=0)


@pytest.mark.parametrize("S", [2, 4])
def test_transposed_pac_convolution_on_bands_is_the_whole_images(monkeypatch, S):
    """The stage of the heads: k=5, stride 2, padding 2, output padding 1,
    each band's kernel the whole kernel's band; the band exchanges one
    low-resolution row each side."""
    x, guide = rnp(9, 2, 4 * S, 7, 3), rnp(10, 2, 8 * S, 14, 4)
    w, b = rnp(11, 25, 3, 4), rnp(12, 4)
    kernel, _ = pac_ops.pac_kernel2d(guide, 5, pad_lo=(2, 2), pad_hi=(2, 2))
    band_rows = kernel.shape[1] // S
    parts = []
    for s in range(S):
        with _band(monkeypatch, S, s, x) as calls:
            k = kernel[:, s * band_rows:(s + 1) * band_rows]
            parts.append(pac_ops.pacconv_transpose2d(halo.band(x, 1), k, w, b, stride=2,
                                                     padding=2, output_padding=1))
        assert calls == [(1, 1)]
    want = pac_ops.pacconv_transpose2d(x, kernel, w, b, stride=2, padding=2, output_padding=1)
    torch.testing.assert_close(torch.cat(parts, dim=1), want, atol=BAND_TOL, rtol=0)


# --------------------------------------------------------------- modules


MODULES = {
    "PacJointUpsample": (lambda: pac_nn.PacJointUpsample(factor=4, channels=2,
                                                         guide_channels=5),
                         lambda S: (rnp(13, 1, 4 * S, 6, 2), rnp(14, 1, 16 * S, 24, 5))),
    "DJIF": (lambda: pac_nn.DJIF(factor=4, channels=2, guide_channels=5),
             lambda S: (rnp(15, 1, 4 * S, 6, 2), rnp(16, 1, 16 * S, 24, 5))),
    "PacConvTranspose2d normalised": (
        lambda: pac_nn.PacConvTranspose2d(3, 2, normalize_kernel=True),
        lambda S: (rnp(17, 1, 4 * S, 7, 3), rnp(18, 1, 8 * S, 14, 2))),
    "JointBilateral": (lambda: pac_nn.JointBilateral(factor=4, channels=2),
                       lambda S: (rnp(19, 1, 4 * S, 6, 2), rnp(20, 1, 16 * S, 24, 3))),
}


@pytest.mark.parametrize("name", list(MODULES))
@pytest.mark.parametrize("S", [2, 4])
def test_module_on_bands_is_the_whole_images(name, S):
    """The module's output on the bands joined against the whole image's in
    float32 within 1e-5; the gradients of its inputs and parameters through
    the joined bands in float64 (where float32's other order of sums cannot
    hide a missed halo row), within 1e-10 of each one's largest value."""
    make, inputs = MODULES[name]
    mod = make()
    init_weights(mod, torch.Generator().manual_seed(21))
    wholes = inputs(S)
    torch.testing.assert_close(emulated_bands(S, mod, *wholes), mod(*wholes), atol=BAND_TOL,
                               rtol=0)
    mod = mod.double()
    wholes = [t.double().requires_grad_() for t in wholes]
    want = mod(*wholes)
    cot = rnp(22, *want.shape).double()
    params = list(mod.parameters())
    want_g = torch.autograd.grad((want * cot).sum(), [*wholes, *params])
    got = emulated_bands(S, mod, *wholes)
    got_g = torch.autograd.grad((got * cot).sum(), [*wholes, *params])
    gmax = max(float(w.abs().max()) for w in want_g)
    for g, w in zip(got_g, want_g):
        scale = float(w.abs().max())
        if scale < NEGLIGIBLE * gmax:
            # Zero by structure (the guide's last bias cancels in the
            # kernel's differences): rounding noise on both sides.
            assert float(g.abs().max()) < NEGLIGIBLE * gmax
            continue
        torch.testing.assert_close(g, w, atol=F64_TOL * scale, rtol=0)


def test_djif_branch_on_a_band_zeroes_the_whole_images_padding():
    """DJIF's target branch pads (2, 2, 2) for kernels (9, 1, 5): its 1x1
    layer's output holds bias-only rows past the first layer's shorter
    output, which every band reproduces; the bands exchange the branch's
    whole receptive field, 6 rows each side, once."""
    djif = pac_nn.DJIF(factor=4, channels=1, guide_channels=1)
    init_weights(djif, torch.Generator().manual_seed(23))
    x = rnp(24, 1, 32, 12, 1)
    calls = []
    got = emulated_bands(2, lambda b: djif._branch(b, "t"), x, calls=calls)
    torch.testing.assert_close(got, djif._branch(x, "t"), atol=BAND_TOL, rtol=0)
    assert calls == [(6, 6)] * 2


# ------------------------------------------------------------ the guard


def _guard_model(kind):
    cfg = small_model_config("raft_nc_dbl", dataset="sintel", corr_impl="pallas",
                             nconv_impl="pallas", upsampler=UpsamplerConfig(kind=kind))
    return RAFT(cfg, device="cpu", seed=0)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("kind", KINDS)
def test_no_upsampler_kind_refuses_a_band(kind, preset):
    """Every registry kind under every serving preset runs an emulated
    two-band forward and gives the whole image's flow: a new head cannot
    quietly opt out of the spatial axis."""
    g = np.random.default_rng(25)
    img1 = torch.from_numpy(g.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32))
    img2 = torch.roll(img1, (2, 3), dims=(1, 2))
    f32 = _guard_model(kind)
    model = f32.with_policy(preset)
    lr, up = model(img1, img2, iters=2)
    _, up32 = f32(img1, img2, iters=2)
    got_lr, got_up = emulated_bands(2, lambda a, b: model(a, b, iters=2),
                                    img1, img2)
    assert got_up.shape == up.shape and got_up.dtype == torch.float32
    if preset == "f32":
        torch.testing.assert_close(got_lr, lr, atol=SELF_ATOL, rtol=0)
        torch.testing.assert_close(got_up, up, atol=SELF_ATOL, rtol=0)
        return
    own = (_epe(up.numpy(), up32.numpy()), float((up - up32).abs().max()))
    band = (_epe(got_up.numpy(), up.numpy()), float((got_up - up).abs().max()))
    print(f"{kind} bf16 bands vs whole {band}, bf16 vs f32 {own}")
    assert band[0] <= own[0] and band[1] <= own[1], (band, own)


# ------------------------------------------------------------ two ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_variables(jmodel, port: RAFT, hw):
    """The port's seeded weights carried into JAX's variables, the PAC
    transposed weights (which the JAX package's import does not map) set
    by hand in their shared layout, as tests/test_torch_pac.py does."""
    template = jax.eval_shape(lambda k: jmodel.init(k, (1, *hw, 3)), jax.random.key(0))
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    convt = {k: state.pop(k) for k in list(state) if ".up_convt" in k and k.endswith("weight")}
    variables = jax.tree_util.tree_map(np.asarray,
                                       import_torch_state(state, template, strict=True))
    for k, v in convt.items():
        node = variables["params"]
        for part in k.split(".")[:-1]:
            node = node[part]
        node["weight"] = v
    return variables


def jax_head_model(kind, dataset="sintel", **kw):
    return JaxRAFT(JaxModelConfig(variant="raft_nc_dbl", small=True, corr_impl="onthefly",
                                  dataset=dataset, upsampler=JaxUpsamplerConfig(kind=kind), **kw))


def jax_flagship(precision_, dataset="sintel"):
    return JaxRAFT(JaxModelConfig(dataset=dataset, corr_impl="onthefly", precision=precision_))


def spawn_world(tmp_path_factory, mode, inputs, references):
    """Both ranks' outputs after one run of the child in ``mode``; the
    ``references()`` are computed here while the ranks run."""
    work = tmp_path_factory.mktemp(f"pac_spatial_{mode}")
    torch.save(inputs, work / "inputs.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE), OMP_NUM_THREADS="1")
    env.pop("RAFT_TORCH_FLIGHT_DIR", None)
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_pac_spatial_child.py"),
                               str(port), str(r), str(WORLD), str(work), mode],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(WORLD)]
    logs = []
    try:
        refs = references()
        for p in procs:
            out, _ = p.communicate(timeout=SPAWN_TIMEOUT_S)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": ranks, "refs": refs, "work": work}


def _frames():
    g = np.random.default_rng(26)
    img1 = g.uniform(0, 255, (1, child.H, child.W, 3)).astype(np.float32)
    return img1, np.roll(img1, (2, 3), axis=(1, 2)).copy()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    hw = (child.H, child.W)
    jmodels, variables = {}, {}
    for kind in child.HEADS:
        jmodels[kind] = jax_head_model(kind)
        variables[kind] = jax_variables(jmodels[kind], RAFT(child.head_cfg(kind), device="cpu",
                                                            seed=0), hw)
    img1, img2 = _frames()
    inputs = {"image1": torch.from_numpy(img1), "image2": torch.from_numpy(img2),
              "variables": variables}

    def references():
        jax_mesh = jax_make_mesh(data=1, spatial=2, devices=jax.devices()[:2])
        refs = {}
        for kind in child.HEADS:
            jfwd = JaxShapeCachedForward(jmodels[kind], variables[kind], mesh=jax_mesh)
            jlr, jup = jfwd(img1, img2, iters=child.ITERS)
            m = child.carried(child.head_cfg(kind), variables[kind])
            lr, up = m(inputs["image1"], inputs["image2"], iters=child.ITERS)
            refs[kind] = {"jax": (np.asarray(jlr), np.asarray(jup)), "port": (lr, up)}
        refs["highres"] = child.entry_json(highres_forward.main, child.HIGHRES_ARGV)
        args = highres_forward.build_parser().parse_args(child.HIGHRES_ARGV)
        cfg = highres_forward.model_config(True, "f32", args.final_upsampling)
        refs["highres_flows"] = RAFT(cfg, device="cpu", seed=highres_forward.SEED)(
            *highres_forward.frames(*args.size), iters=args.iters)
        refs["evaluate"] = child.entry_json(eval_entry.main, child.EVAL_ARGV)
        refs["serve"] = child.served(child.SERVE_ARGV["pac"])
        return refs

    return spawn_world(tmp_path_factory, "forward", inputs, references)


def test_the_world_is_a_spatial_mesh(world):
    for r, rank in enumerate(world["ranks"]):
        assert rank["fingerprint"] == "mesh(data=1,spatial=2:cpu)"
        assert rank["layout"] == (0, r) and rank["barrier"]


@pytest.mark.parametrize("kind", child.HEADS)
def test_head_forward_matches_jax_and_one_process(world, kind):
    ref = world["refs"][kind]
    jax_lr, jax_up = ref["jax"]
    lr1, up1 = ref["port"]
    for rank in world["ranks"]:
        got = rank[kind]
        lr, up = got["flow_lr"], got["flow_up"]
        assert lr.shape == (1, child.H // 8, child.W // 8, 2)
        assert up.shape == (1, child.H, child.W, 2) and up.dtype == torch.float32
        np.testing.assert_allclose(lr.numpy(), jax_lr, **FLOW_LR_TOL)
        np.testing.assert_allclose(up.numpy(), jax_up, **FLOW_UP_TOL)
        torch.testing.assert_close(lr, lr1, atol=SELF_ATOL, rtol=0)
        torch.testing.assert_close(up, up1, atol=SELF_ATOL, rtol=0)
    a, b = (r[kind] for r in world["ranks"])
    assert torch.equal(a["flow_up"], b["flow_up"])


@pytest.mark.parametrize("kind", child.HEADS)
def test_head_forward_exchanges_halos_and_gathers_three_tensors(world, kind):
    """The head runs on bands: halo exchanges beyond the trunk's, and the
    only gathers are fmap2's and the two outputs' (no whole-image
    fallback)."""
    a, b = (r[kind]["collectives"] for r in world["ranks"])
    assert a == b
    by_op = a["by_op"]
    assert by_op["all-gather"]["count"] == 3
    B, h8, w8 = 1, child.H // 8, child.W // 8
    assert by_op["all-gather"]["bytes"] == 4 * B * (h8 * w8 * 128 + h8 * w8 * 2
                                                    + child.H * child.W * 2)
    assert by_op["collective-permute"]["count"] > 0


def test_highres_entry_with_the_pac_head_on_a_spatial_mesh(world):
    code1, one = world["refs"]["highres"]
    lr1, up1 = world["refs"]["highres_flows"]
    assert code1 == 0 and one["final_upsampling"] == "PacJointUpsampleFull"
    for r, rank in enumerate(world["ranks"]):
        code, rep = rank["highres"]
        assert code == 0 and rep["finite"] and rep["mesh"] == "mesh(data=1,spatial=2:cpu)"
        assert rep["final_upsampling"] == "PacJointUpsampleFull"
        flows = torch.load(world["work"] / "highres" / f"flows_rank{r}.pt")
        torch.testing.assert_close(flows["flow_lr"], lr1, atol=SELF_ATOL, rtol=0)
        torch.testing.assert_close(flows["flow_up"], up1, atol=SELF_ATOL, rtol=0)


def test_evaluate_entry_with_the_djif_head_on_a_spatial_mesh(world):
    code1, one = world["refs"]["evaluate"]
    assert code1 == 0 and one["results"]
    for rank in world["ranks"]:
        code, rep = rank["evaluate"]
        assert code == 0 and rep["mesh"] == "mesh(data=1,spatial=2:cpu)"
        for k, v in one["results"].items():
            assert abs(rep["results"][k] - v) <= 1e-5 * abs(v), (k, rep["results"][k], v)


def test_serve_entry_with_the_pac_head_on_a_spatial_mesh(world):
    check_served(world["refs"]["serve"], [r["serve"] for r in world["ranks"]],
                 lambda flow, ref: np.testing.assert_allclose(flow, ref, atol=SELF_ATOL, rtol=0))


def check_served(one, ranks, close):
    """The serve entry's run over the mesh against one process's: every
    rank exits 0 and names the mesh, every answer is ok, finite and
    ``close`` to one process's."""
    rc1, _, want = one
    assert rc1 == 0 and want and all(status == "ok" for status, _ in want)
    lead, follow = ranks
    assert lead[0] == follow[0] == 0
    assert lead[1]["mesh"] == follow[1]["mesh"] == "mesh(data=1,spatial=2:cpu)"
    got = lead[2]
    assert len(got) == len(want) and all(status == "ok" for status, _ in got)
    for (_, flow), (_, ref) in zip(got, want):
        assert flow.shape == ref.shape and np.isfinite(flow).all()
        close(flow, ref)
