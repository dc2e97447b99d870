"""The plain reference against the program on the CPU at small sizes:
the weights load into the program by name, the two lookups agree, and
the served forward and a train step agree with the program's."""

import pytest
import torch

from flowbench import harness
from flowbench.drivers import common
from flowbench.drivers import train as train_driver
from flowbench.reference import model as ref
from flowbench.reference import train as ref_train
from flowbench.traffic import make_pairs
from flowbench.weights import make_weights

NAMES = ["raft_nc_dbl", "raft"]


@pytest.mark.parametrize("name", NAMES)
def test_spec_is_the_programs(name):
    cfg = harness.load_config(name)
    model = common.port_model(cfg, make_weights(ref.param_spec(cfg), 3, "cpu"), "cpu")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {n: tuple(s) for n, s, _ in ref.param_spec(cfg)} == want


def test_weights_follow_the_seed():
    cfg = harness.load_config("raft_nc_dbl")
    a = make_weights(ref.param_spec(cfg), 2 ** 33 + 1, "cpu")
    b = make_weights(ref.param_spec(cfg), 2 ** 33 + 1, "cpu")
    c = make_weights(ref.param_spec(cfg), 2 ** 33 + 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fnet.conv1.weight"], c["fnet.conv1.weight"])


def test_lookups_agree():
    g = torch.Generator().manual_seed(0)
    f1, f2 = torch.randn(2, 16, 16, 20, generator=g), torch.randn(2, 16, 16, 20, generator=g)
    coords = ref.coords_grid(2, 16, 20, "cpu") + 3 * torch.randn(2, 2, 16, 20, generator=g)
    a = ref.lookup_volume(f1, f2, coords, 4, 3)
    b = ref.lookup_windowed(f1, f2, coords, 4, 3, rows=4)
    assert torch.allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_served_forward_matches_program(name):
    cfg = harness.load_config(name)
    p = make_weights(ref.param_spec(cfg), 11, "cpu")
    model = common.port_model(cfg, p, "cpu")
    pairs = make_pairs(11, 2, (44, 92), "cpu")
    want = ref.serve(p, cfg, pairs["image1"], pairs["image2"], 5)
    from raft_ncup_tpu_torch.ops.padding import InputPadder

    pad = InputPadder((44, 92, 3))
    i1, i2 = pad.pad(pairs["image1"].float(), pairs["image2"].float())
    got = pad.unpad(model(i1, i2, iters=5)[1])
    assert got.shape == want.shape == (2, 44, 92, 2)
    assert common.rel_gap(got, want) < 1e-5


def test_train_steps_match_program():
    cfg = harness.load_config("raft_nc_dbl")
    mix = dict(harness.load_mix("things.train6"), batch=2, crop=[48, 64], iters=3,
               distinct_batches=2)
    cell = harness.Cell(workload={}, config=cfg, mix=mix, limits={}, seed=5, seconds=0,
                        trace=False, device="cpu")
    p = make_weights(ref.param_spec(cfg), 5, "cpu")
    batches = train_driver.make_batches(cell, "cpu")
    from raft_ncup_tpu_torch.training.state import state_for
    from raft_ncup_tpu_torch.training.step import make_train_step

    state = state_for(common.port_model(cfg, p, "cpu"), train_driver.train_config(mix))
    step = make_train_step(train_driver.train_config(mix))
    losses = []
    for i, b in enumerate(batches):
        losses.append(step(state, b)["loss"])
        if i == 0:
            mu1 = [t.clone() for t in state.optimizer.mu]
    named = state.named_params
    program = train_driver.program_readings(losses, mu1, [q.detach() for _, q in named],
                                            named, p)
    found = train_driver.compare(program, ref_train.train(p, cfg, mix, batches, 2))
    assert found["loss_gap"] < 1e-5 and found["grad_gap"] < 1e-3 and found["change_gap"] < 1e-2
