"""The port's validators, submission writers, checkpoint loaders and
evaluate and demo entries against the JAX package, on the CPU.

The datasets are the fixtures of ``tests/test_drivers.py`` (frames
written with Pillow, flows with the JAX package's ``write_flo`` and
``write_flow_kitti``), at 48x64. The models are small ``raft`` and the
flagship ``raft_nc_dbl``, at 2 iterations; the JAX variables come from
the port's seeded weights (``import_torch_state``) and are carried back
with ``load_jax_variables``. JAX runs its default ``volume`` correlation
and XLA NConv2d; the port runs both kernels' wrappers, which take their
plain versions on the CPU.

Tolerances: a validator's EPE within 5e-3 px of JAX's and its 1/3/5 px
fractions within 5e-3 (the forwards agree within flow_up atol 5e-3),
KITTI F1 within 0.5 points; submission flows within 5e-3 px (KITTI's
16-bit PNGs also within their 1/64 px step); a reference ``.pth`` from
JAX's exporter gives JAX's forward within flow_lr atol 2e-3 and flow_up
atol 5e-3 (rtol 1e-3).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_ncup_tpu import evaluation as jev
from raft_ncup_tpu.config import DataConfig as JaxDataConfig
from raft_ncup_tpu.config import flagship_config as jax_flagship_config
from raft_ncup_tpu.config import small_model_config as jax_small_config
from raft_ncup_tpu.data.synthetic import flow_boundary_mask as jax_boundary_mask
from raft_ncup_tpu.inference import metrics as jmetrics
from raft_ncup_tpu.inference.pipeline import ShapeCachedForward as JaxShapeCachedForward
from raft_ncup_tpu.io import read_flo as jax_read_flo
from raft_ncup_tpu.io import read_flow_kitti as jax_read_flow_kitti
from raft_ncup_tpu.models.raft import RAFT as JaxRAFT
from raft_ncup_tpu.utils.torch_export import save_torch_checkpoint
from raft_ncup_tpu.utils.torch_import import import_torch_state, load_torch_checkpoint
from raft_ncup_tpu_torch import demo as demo_mod
from raft_ncup_tpu_torch import evaluate as evaluate_mod
from raft_ncup_tpu_torch import evaluation as pev
from raft_ncup_tpu_torch.config import DataConfig, flagship_config, small_model_config
from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset
from raft_ncup_tpu_torch.io import read_flo, read_png
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.training import checkpoint
from raft_ncup_tpu_torch.utils.jax_weights import load_jax_variables
from raft_ncup_tpu_torch.viz import flow_to_image
from test_drivers import make_chairs_fixture, make_kitti_fixture, make_sintel_fixture

H, W, ITERS = 48, 64, 2
EPE_TOL = 5e-3
FRACTION_TOL = 5e-3
F1_TOL = 0.5
FLOW_UP_ATOL = 5e-3
FLOW_LR_TOL = dict(atol=2e-3, rtol=1e-3)
FLOW_UP_TOL = dict(atol=5e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    split = make_chairs_fixture(root / "chairs")
    make_kitti_fixture(root / "KITTI", "training")
    make_kitti_fixture(root / "KITTI", "testing")
    make_sintel_fixture(root / "Sintel")
    roots = dict(root_chairs=str(root / "chairs"), chairs_split_file=str(split),
                 root_kitti=str(root / "KITTI"), root_sintel=str(root / "Sintel"),
                 num_workers=1)
    return root, JaxDataConfig(**roots), DataConfig(**roots)


def _pair(jax_cfg, port_cfg):
    """The port model (seeded weights) and the JAX model with the same
    variables; the port's weights go through JAX's importer and come back
    through ``load_jax_variables``."""
    seeded = RAFT(port_cfg, device="cpu", seed=0)
    jmodel = JaxRAFT(jax_cfg)
    template = jax.eval_shape(lambda k: jmodel.init(k, (1, H, W, 3)), jax.random.key(0))
    variables = import_torch_state(
        {k: v.numpy() for k, v in seeded.state_dict().items()}, template, strict=True)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = load_jax_variables(RAFT(port_cfg, device="cpu", seed=1), variables)
    return port, jmodel, variables


@pytest.fixture(scope="module")
def flagship():
    return _pair(jax_flagship_config(), flagship_config(corr_impl="pallas",
                                                        nconv_impl="pallas"))


@pytest.fixture(scope="module")
def small_raft():
    return _pair(jax_small_config("raft", dataset="chairs"),
                 small_model_config("raft", dataset="chairs", corr_impl="pallas",
                                    nconv_impl="pallas"))


def _assert_results_agree(got: dict, want: dict):
    assert set(got) == set(want) and want
    for k, v in want.items():
        tol = (F1_TOL if k.endswith("f1") else
               FRACTION_TOL if k.endswith("px") else EPE_TOL)
        assert abs(got[k] - v) <= tol, (k, got[k], v)


VALIDATED = [("small_raft", "chairs"), ("small_raft", "kitti"), ("small_raft", "sintel"),
             ("flagship", "chairs"), ("flagship", "kitti"), ("flagship", "sintel"),
             ("flagship", "sintel_warm")]


@pytest.mark.parametrize("model_name,dataset", VALIDATED)
def test_validators_match_jax(request, data, model_name, dataset):
    port, jmodel, variables = request.getfixturevalue(model_name)
    _, jcfg, pcfg = data
    want = jev.VALIDATORS[dataset](jmodel, variables, jcfg, iters=ITERS)
    got = pev.VALIDATORS[dataset](port, pcfg, iters=ITERS)
    _assert_results_agree(got, want)


class _NumpySamples:
    """The port's synthetic split as numpy samples, for the JAX pass."""

    def __init__(self, ds):
        self._ds = ds

    def __len__(self):
        return len(self._ds)

    def sample(self, i, *_):
        return {k: v.numpy() for k, v in self._ds.sample(i).items()}


@pytest.mark.parametrize("style", ["smooth", "rigid"])
def test_synthetic_validators_match_jax_on_the_same_pairs(flagship, style):
    """The JAX package's pairs are its own, so the JAX side runs its
    validator's pass (``_run_metric_pass``) over the port's pairs."""
    port, jmodel, variables = flagship
    kind = "epe_band" if style == "rigid" else "epe"
    ds = SyntheticFlowDataset((H, W), length=4, seed=999, style=style)
    acc = jev._run_metric_pass(
        JaxShapeCachedForward(jmodel, variables), _NumpySamples(ds), kind=kind,
        iters=ITERS, batch_size=2,
        band_fn=jax_boundary_mask if style == "rigid" else None, num_workers=1)
    m = jmetrics.finalize(kind, acc)
    prefix = "synthetic" if style == "smooth" else "synthetic_rigid"
    want = {prefix: m["epe"]}
    if style == "rigid":
        want.update({f"{prefix}_bnd": m["bnd"], f"{prefix}_interior": m["interior"]})
    fn = pev.validate_synthetic if style == "smooth" else pev.validate_synthetic_rigid
    got = fn(port, DataConfig(num_workers=1), iters=ITERS, batch_size=2, size_hw=(H, W),
             length=4)
    _assert_results_agree(got, want)


@pytest.mark.parametrize("warm_start", [False, True])
def test_sintel_submission_matches_jax(tmp_path, data, flagship, warm_start):
    port, jmodel, variables = flagship
    _, jcfg, pcfg = data
    jev.create_sintel_submission(jmodel, variables, jcfg, iters=ITERS, warm_start=warm_start,
                                 output_path=str(tmp_path / "jax"))
    pev.create_sintel_submission(port, pcfg, iters=ITERS, warm_start=warm_start,
                                 output_path=str(tmp_path / "port"), write_png=True)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 4  # clean and final, two frames each
    for rel in files:
        want = jax_read_flo(tmp_path / "jax" / rel)
        got = read_flo(tmp_path / "port" / rel)
        assert got.shape == (H, W, 2)
        np.testing.assert_allclose(got, want, atol=FLOW_UP_ATOL, rtol=0, err_msg=rel)
        colour = read_png(tmp_path / "port_png" / rel.replace(".flo", ".png"))
        np.testing.assert_array_equal(colour, flow_to_image(got))


def test_kitti_submission_matches_jax(tmp_path, data, flagship):
    port, jmodel, variables = flagship
    _, jcfg, pcfg = data
    jev.create_kitti_submission(jmodel, variables, jcfg, iters=ITERS,
                                output_path=str(tmp_path / "jax"))
    pev.create_kitti_submission(port, pcfg, iters=ITERS, output_path=str(tmp_path / "port"),
                                write_png=True)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 2
    for name in names:
        (want, _), (got, valid) = (jax_read_flow_kitti(tmp_path / d / name)
                                   for d in ("jax", "port"))
        assert valid.min() == 1.0
        np.testing.assert_allclose(got, want, atol=FLOW_UP_ATOL + 1 / 64, rtol=0)
        assert read_png(tmp_path / "port_png" / name).shape == (H, W, 3)


# ------------------------------------------------------------ checkpoints


def _jax_forward(jmodel, variables, img1, img2):
    apply = jax.jit(functools.partial(jmodel.apply, iters=ITERS, test_mode=True))
    return [np.asarray(x) for x in apply(variables, jnp.asarray(img1), jnp.asarray(img2))]


def test_reference_pth_from_jax_loads_strictly_and_gives_jaxs_forward(tmp_path, flagship):
    _, jmodel, variables = flagship
    path = str(tmp_path / "ref.pth")
    save_torch_checkpoint(path, variables)
    port = checkpoint.load_reference_pth(
        RAFT(flagship_config(corr_impl="pallas", nconv_impl="pallas"), device="cpu", seed=5),
        path)
    g = np.random.default_rng(0)
    img1 = g.uniform(0, 255, (1, H, W, 3)).astype(np.float32)
    img2 = np.roll(img1, (1, 2), axis=(1, 2)).copy()
    want_lr, want_up = _jax_forward(jmodel, variables, img1, img2)
    lr, up = port(torch.from_numpy(img1), torch.from_numpy(img2), iters=ITERS)
    np.testing.assert_allclose(lr.numpy(), want_lr, **FLOW_LR_TOL)
    np.testing.assert_allclose(up.numpy(), want_up, **FLOW_UP_TOL)

    # The port writes the reference's key set: JAX's strict importer takes it.
    out = str(tmp_path / "port.pth")
    checkpoint.save_reference_pth(port, out)
    assert set(torch.load(out, weights_only=True)) == set(torch.load(path, weights_only=True))
    back = load_torch_checkpoint(out, jax.tree_util.tree_map(np.zeros_like, variables))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, variables)


def test_reference_pth_with_a_stray_missing_or_unequal_key_raises(tmp_path, flagship):
    _, _, variables = flagship
    path = str(tmp_path / "ref.pth")
    save_torch_checkpoint(path, variables)
    state = torch.load(path, weights_only=True)
    model = RAFT(flagship_config(), device="cpu")
    norm_alias = next(k for k in checkpoint.reference_aliases(model) if ".norm3." in k)
    cases = {
        "stray": ({**state, "module.fnet.extra.weight": torch.zeros(1)}, KeyError),
        "missing": ({k: v for k, v in state.items()
                     if k != f"module.{norm_alias}"}, KeyError),
        "alias differs": ({**state, "module.upsampler.interpolation_net.encoder.0.0.weight_p":
                           state["module.upsampler.interpolation_net.nconv_in.weight_p"] + 1},
                          ValueError),
    }
    for name, (bad, exc) in cases.items():
        torch.save(bad, tmp_path / f"{name}.pth")
        with pytest.raises(exc):
            checkpoint.load_reference_pth(model, str(tmp_path / f"{name}.pth"))


# ----------------------------------------------------------------- entries


def test_evaluate_entry_on_the_cpu(tmp_path, capsys, data, flagship):
    port, jmodel, variables = flagship
    root, jcfg, _ = data
    pth = str(tmp_path / "ref.pth")
    save_torch_checkpoint(pth, variables)
    args = ["--device", "cpu", "--model", "raft_nc_dbl", "--dataset", "sintel",
            "--root_sintel", str(root / "Sintel"),
            "--iters", str(ITERS), "--num_workers", "1", "--restore_ckpt", pth]
    assert evaluate_mod.main(args) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _assert_results_agree(report["results"], jev.validate_sintel(jmodel, variables, jcfg,
                                                                  iters=ITERS))
    assert report["cache"] == {"compiles": 1, "hits": 1, "evictions": 0}
    assert report["device"] == "cpu"

    # --export_pth writes back the same weights, and a port train state loads.
    out = str(tmp_path / "export.pth")
    assert evaluate_mod.main(args + ["--export_pth", out]) == 0
    a, b = torch.load(pth, weights_only=True), torch.load(out, weights_only=True)
    # JAX's exporter writes each num_batches_tracked with shape (1,), torch's ().
    assert set(a) == set(b) and all(torch.equal(a[k].reshape(b[k].shape), b[k]) for k in a)
    run = tmp_path / "run"
    run.mkdir()
    torch.save({"model": port.state_dict()}, run / "step_3.pt")
    loaded = evaluate_mod.load_model(port.cfg, str(run), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(loaded.state_dict().values(),
                                                 port.state_dict().values()))
    with pytest.raises(ValueError, match="multi-GPU"):
        evaluate_mod.main(["--device", "cpu", "--dataset", "sintel", "--mesh", "1,2"])


def test_demo_entry_on_the_cpu(tmp_path, capsys, data):
    root, _, _ = data
    frames = root / "Sintel" / "training" / "clean" / "scene_x"
    out = tmp_path / "demo"
    assert demo_mod.main(["--device", "cpu", "--path", str(frames), "--output", str(out),
                          "--iters", "1", "--model", "raft", "--small"]) == 0
    written = sorted(os.listdir(out))
    assert written == ["frame_0000_flow.png", "frame_0001_flow.png"]
    vis = read_png(out / written[0])
    assert vis.shape == (2 * H, W, 3)
    np.testing.assert_array_equal(vis[:H], read_png(frames / "frame_0000.png"))
    with pytest.raises(SystemExit, match="display"):
        demo_mod.main(["--device", "cpu", "--path", str(frames), "--show"])
