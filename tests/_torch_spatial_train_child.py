"""One rank of the two-rank gloo world of ``tests/test_torch_spatial_train.py``.

``python tests/_torch_spatial_train_child.py PORT RANK WORLD WORKDIR``: joins
the world at ``127.0.0.1:PORT`` with explicit arguments, builds the mesh
``(data=1, spatial=2)``, reads the inputs from ``WORKDIR/inputs.pt``, runs
every task on the CPU and saves what each produced to
``WORKDIR/rank<RANK>.pt``. Imports torch and the port only.
"""

import contextlib
import hashlib
import os
import sys

import torch

from raft_ncup_tpu_torch import train as train_entry
from raft_ncup_tpu_torch.config import TrainConfig, flagship_config, small_model_config
from raft_ncup_tpu_torch.data import device_prefetch
from raft_ncup_tpu_torch.models.raft import RAFT
from raft_ncup_tpu_torch.nn.extractor import Encoder
from raft_ncup_tpu_torch.nn.layers import (
    Conv2d,
    InstanceNorm2d,
    init_weights,
    synced_batch_stats,
)
from raft_ncup_tpu_torch.ops.geometry import bilinear_resize_align_corners_nchw
from raft_ncup_tpu_torch.parallel import halo
from raft_ncup_tpu_torch.parallel import mesh as mesh_mod
from raft_ncup_tpu_torch.parallel import multihost
from raft_ncup_tpu_torch.training import step as step_mod
from raft_ncup_tpu_torch.training.state import state_for

# Shared with the test (which imports this module for them).
H = W = 64
BATCH, ITERS = 2, 2
# (case, model configuration, stage): small raft with nothing frozen, the
# flagship at stage sintel with BatchNorm frozen.
CASES = {
    "raft_small_chairs": (lambda: small_model_config("raft", corr_impl="pallas"), "chairs"),
    "flagship_sintel": (lambda: flagship_config(dataset="sintel", corr_impl="pallas",
                                                nconv_impl="pallas"), "sintel"),
}
# (name, Conv2d arguments): the convolutions whose halos the primitives' test
# differentiates through.
CONVS = {
    "7x7/s2 stem": dict(in_channels=3, out_channels=4, kernel_size=7, stride=2),
    "3x3/s1": dict(in_channels=3, out_channels=4, kernel_size=3),
    "3x3/s2": dict(in_channels=3, out_channels=4, kernel_size=3, stride=2),
    "1x1/s2": dict(in_channels=3, out_channels=4, kernel_size=1, stride=2),
    "5x1 GRU": dict(in_channels=3, out_channels=4, kernel_size=(5, 1)),
}
# The encoders, in float64 on two bands against the whole image: the feature
# encoders (instance norm) and the flagship's context encoder with its
# BatchNorm training (statistics summed over the ranks).
ENCODERS = {"small fnet": dict(output_dim=128, norm_fn="instance", small=True),
            "fnet": dict(output_dim=256, norm_fn="instance"),
            "cnet": dict(output_dim=256, norm_fn="batch")}
ENTRY_HW = (48, 64)
COLLECTIVE_TIMEOUT_S = 120.0  # a hung collective fails well inside the test's own limit


def train_cfg(stage):
    return TrainConfig(stage=stage, lr=1e-4, num_steps=50, batch_size=BATCH,
                       image_size=(H, W), iters=ITERS)


def conv(name):
    c = Conv2d(**CONVS[name])
    init_weights(c, torch.Generator().manual_seed(3))
    return c


def resize_whole(t):
    """A function of the whole height (an aligned-corner resize mixes every
    row), squared so its gradient depends on its input."""
    return bilinear_resize_align_corners_nchw(t, (2 * t.shape[2], t.shape[3])) ** 2


def encoder(name):
    enc = Encoder(**ENCODERS[name])
    init_weights(enc, torch.Generator().manual_seed(4))
    return enc.double().train()


def encoder_grads(inputs, name, group=None):
    """The float64 encoder ``name`` on this rank's band of the frames (the
    whole frames with no group): its parameters' gradients (this rank's
    part) for the loss ``sum(output * g)`` over its band."""
    enc = encoder(name)
    params = [p for _, p in enc.named_parameters()]
    synced = (synced_batch_stats(enc, multihost.all_reduce_grad) if group is not None
              else contextlib.nullcontext())
    with synced, halo.spatial(group):
        x = halo.band(inputs["frames"], 2)
        y = enc(x)
        g = halo.band(inputs["encoder_g"][name], 2)
        grads = torch.autograd.grad((y * g).sum(), params)
    return dict(zip([n for n, _ in enc.named_parameters()], grads))


def primitive_grads(inputs, group):
    """Each halo primitive on this rank's band of ``inputs["x"]``, with the
    loss ``sum(band of the output * band of g)`` (the bands' losses sum to
    the whole image's): the input band's gradient and, for a convolution,
    this rank's part of its weight gradient."""
    out = {}
    x_whole, g_whole = inputs["x"], inputs["g"]
    with halo.spatial(group):
        for name in CONVS:
            c = conv(name)
            x = halo.band(x_whole, 2).clone().requires_grad_()
            y = c(x)
            g = halo.band(inputs["conv_g"][name], 2)
            gx, gw = torch.autograd.grad((y * g).sum(), [x, c.weight])
            out[name] = {"x": gx, "weight": gw}
        x = halo.band(x_whole, 2).clone().requires_grad_()
        y = InstanceNorm2d(x.shape[1])(x) * halo.band(g_whole, 2)
        out["instance norm"] = {"x": torch.autograd.grad(y.sum(), x)[0]}
        x = halo.band(x_whole, 2).clone().requires_grad_()
        y = halo.on_whole(resize_whole, x)
        gy = halo.band(inputs["resize_g"], 2)
        out["on_whole"] = {"x": torch.autograd.grad((y * gy).sum(), x)[0]}
        # The gather alone: each rank's loss reads the whole tensor with its
        # own weights, so the band's gradient sums every rank's.
        x = halo.band(x_whole, 2).clone().requires_grad_()
        whole = halo.all_gather_rows(x, dim=2)
        gr = inputs["gather_g"][group.index]
        out["all_gather_rows"] = {"x": torch.autograd.grad((whole * gr).sum(), x)[0]}
    return out


def step_outputs(case, inputs, mesh, remat):
    """One train step of ``case`` from the seeded weights: the loss, the
    reduced gradients it applied, the metrics, the state after it and the
    collectives it issued."""
    model_cfg, stage = CASES[case]
    cfg = train_cfg(stage)
    state = state_for(RAFT(model_cfg(), device="cpu", seed=0), cfg)
    lr0 = float(state.optimizer.lr())
    seen = {}
    apply_update = step_mod.apply_update

    def capture(state_, loss, grads, bn_old, cfg_):
        seen["loss"], seen["grads"] = loss.clone(), [g.clone() for g in grads]
        return apply_update(state_, loss, grads, bn_old, cfg_)

    step_mod.apply_update = capture
    mesh_mod.reset_collective_stats()
    try:
        metrics = step_mod.make_train_step(cfg, remat=remat, mesh=mesh)(state, inputs["batch"])
    finally:
        step_mod.apply_update = apply_update
    names = [n for n, _ in state.named_params]
    return {
        "loss": seen["loss"], "grads": dict(zip(names, seen["grads"])),
        "metrics": {k: v.clone() for k, v in metrics.items()},
        "after": {k: v.clone() for k, v in state.model.state_dict().items()},
        "collectives": mesh_mod.collective_stats(), "lr0": lr0,
    }


def noise_draws(mesh):
    """The noise both frames get at one step, on this rank."""
    gen = step_mod.step_generators(7, 3, "cpu")[0]
    base = torch.full((BATCH, H, W, 3), 128.0)
    return step_mod.add_noise(base, base.clone(), gen, mesh)


def entry_run(workdir):
    """The train entry over ``--mesh 1,2`` for 2 steps: its exit code and
    a digest of each batch this rank drew."""
    digests = []
    nxt = device_prefetch.DevicePrefetcher.__next__

    def hashed(self):
        batch = nxt(self)
        h = hashlib.sha256()
        for k in sorted(batch):
            h.update(k.encode())
            h.update(batch[k].numpy().tobytes())
        digests.append(h.hexdigest())
        return batch

    device_prefetch.DevicePrefetcher.__next__ = hashed
    try:
        status = train_entry.main([
            "--device", "cpu", "--name", "run", "--stage", "chairs", "--model", "raft",
            "--small", "--synthetic_ok", "--batch_size", "2", "--image_size",
            *(str(v) for v in ENTRY_HW), "--iters", "1", "--num_workers", "1",
            "--sum_freq", "1", "--num_steps", "2", "--mesh", "1,2",
            "--checkpoint_dir", os.path.join(workdir, "ck")])
    finally:
        device_prefetch.DevicePrefetcher.__next__ = nxt
    return status, digests


def main():
    port, rank, world, workdir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    multihost.COLLECTIVE_TIMEOUT_S = COLLECTIVE_TIMEOUT_S
    assert multihost.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = mesh_mod.make_mesh(data=1, spatial=world, device="cpu")
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {"fingerprint": mesh_mod.mesh_fingerprint(mesh), "layout": (mesh.data_index,
                                                                        mesh.spatial_index)}
    mesh_mod.reset_collective_stats()
    out["primitives"] = primitive_grads(inputs, mesh_mod.spatial_group(mesh))
    out["primitive_collectives"] = mesh_mod.collective_stats()
    out["encoders"] = {name: encoder_grads(inputs, name, mesh_mod.spatial_group(mesh))
                       for name in ENCODERS}
    out["steps"] = {(case, remat): step_outputs(case, inputs, mesh, remat)
                    for case in CASES for remat in (True, False)}
    out["noise"] = noise_draws(mesh)
    out["entry"] = entry_run(workdir)
    out["barrier"] = multihost.barrier("child_end", timeout_s=60)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    multihost.shutdown()


if __name__ == "__main__":
    main()
