"""The benchmark's own work counts: the analytic FLOPs equal a
FlopCounterMode count of the reference at a small size, come within 1%
of the cost ledger's measured count at the flagship's profiled size, and
the frozen kernel counts equal the port's today."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from flowbench import harness, work
from flowbench.reference import model as ref
from flowbench.weights import make_weights


def _counted(cfg, B, H, W, iters, train):
    p = make_weights(ref.param_spec(cfg), 7, "cpu")
    g = torch.Generator().manual_seed(1)
    i1 = torch.randint(0, 255, (B, H, W, 3), generator=g).float()
    i2 = torch.randint(0, 255, (B, H, W, 3), generator=g).float()
    with FlopCounterMode(display=False) as fc:
        ref.forward(p, cfg, i1, i2, iters, lookup="windowed", train=train)
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ["raft_nc_dbl", "raft"])
@pytest.mark.parametrize("train", [False, True])
def test_analytic_equals_counted(name, train):
    cfg = harness.load_config(name)
    got = work.forward_flops(cfg, 2, 64, 96, 3, train=train)
    assert got == _counted(cfg, 2, 64, 96, 3, train)


def test_flagship_against_cost_ledger():
    # The cost ledger's measured count of the f32 flagship forward at batch
    # 2, 440x1024, 12 iterations (ROADMAP held item H1): 1.3103e12.
    got = work.forward_flops(harness.load_config("raft_nc_dbl"), 2, 440, 1024, 12)
    assert abs(got / 1.3103e12 - 1.0) < 0.01


def test_frozen_lookup_work_equals_port():
    from raft_ncup_tpu_torch.ops import corr_cuda

    g = torch.Generator().manual_seed(3)
    for (B, H, W, C, r, spread) in [(2, 7, 9, 16, 4, 3.0), (1, 12, 20, 8, 3, 40.0),
                                    (3, 5, 4, 4, 2, 0.0)]:
        f1 = torch.randn(B, H, W, C, generator=g)
        f2 = torch.randn(B, H, W, C, generator=g)
        f1s, levels = corr_cuda.prepare_levels(f1, f2, 4)
        y, x = torch.meshgrid(torch.arange(H).float(), torch.arange(W).float(), indexing="ij")
        coords = torch.stack([x, y], -1)[None].expand(B, H, W, 2) \
            + spread * torch.randn(B, H, W, 2, generator=g)
        want = corr_cuda.lookup_work(f1s, levels, coords, r)
        assert work.lookup_work_from(coords, 4, r, C) == want


@pytest.mark.parametrize("shape", [(2, 440, 1024, 5, 1, 2), (12, 400, 720, 3, 4, 2),
                                   (1, 3, 2, 7, 2, 8), (4, 9, 11, 1, 2, 1)])
def test_frozen_nconv_work_equals_port(shape):
    from raft_ncup_tpu_torch.ops import nconv_cuda

    assert work.nconv_work(*shape) == nconv_cuda.nconv_work(*shape)


def test_peaks():
    assert work.peaks("NVIDIA H100 80GB HBM3")["f32_flops"] == 67e12
    with pytest.raises(ValueError):
        work.peaks("cpu")
