"""The port's multi-phase and mixed-resolution traffic
(``raft_ncup_tpu_torch/traffic.py``) against the JAX package's
(``raft_ncup_tpu/traffic.py``), on the CPU.

The port's synthetic pairs are not JAX's pixels, so the schedule is held
with one frame source substituted in both packages (a numpy generator
keyed on ``(seed, index)`` and the frame size): every item's index,
phase, due time (exactly) and both frames (bit for bit) are JAX's for the
same seed, phases, sizes and chaos. With the port's own synthetic pairs
the schedule stays deterministic and its frames are uint8 (H, W, 3).
"""

import jax  # noqa: F401  (the reference package runs on the CPU platform)
import numpy as np
import pytest
import torch

import raft_ncup_tpu.traffic as jax_traffic
import raft_ncup_tpu_torch.traffic as traffic
from raft_ncup_tpu.resilience.chaos import ChaosSpec as JaxChaosSpec
from raft_ncup_tpu_torch.resilience.chaos import ChaosSpec

torch.set_num_threads(1)


class _Frames:
    """One frame source for both packages: sample ``index`` depends on
    ``(seed, index)`` and the size only."""

    def __init__(self, size_hw, length=1, seed=0, style="smooth"):
        self.size_hw, self.seed = tuple(size_hw), seed

    def sample(self, index):
        g = np.random.default_rng([self.seed, index, *self.size_hw])
        return {k: g.integers(0, 256, (*self.size_hw, 3), dtype=np.uint8)
                for k in ("image1", "image2")}


class _TorchFrames(_Frames):
    def sample(self, index):
        return {k: torch.from_numpy(v) for k, v in super().sample(index).items()}


@pytest.fixture
def same_frames(monkeypatch):
    monkeypatch.setattr(traffic, "SyntheticFlowDataset", _TorchFrames)
    monkeypatch.setattr(jax_traffic, "SyntheticFlowDataset", _Frames)


def _same_items(ours, ref):
    a, b = list(ours.items()), list(ref.items())
    assert len(a) == len(b) == len(ours) == len(ref)
    for x, y in zip(a, b):
        assert (x["index"], x["phase"], x["due_s"]) == (y["index"], y["phase"], y["due_s"])
        for k in ("image1", "image2"):
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            assert x[k].tobytes() == y[k].tobytes()
    for (d1, i1, j1), (d2, i2, j2) in zip(ours, ref):  # the replay triples
        assert d1 == d2 and i1.tobytes() == i2.tobytes() and j1.tobytes() == j2.tobytes()
    return a


@pytest.mark.parametrize("chaos", ["", "burst@3,poison@9", "poison@0,burst@12,burst@40"])
def test_step_traffic_draws_jaxs_schedule(same_frames, chaos):
    kw = dict(low_n=4, high_n=9, low_interval_s=0.25, high_interval_s=0.02, seed=5,
              burst_size=3)
    ours = traffic.StepTraffic.step((32, 48), chaos=ChaosSpec.parse(chaos), **kw)
    ref = jax_traffic.StepTraffic.step((32, 48), chaos=JaxChaosSpec.parse(chaos), **kw)
    assert ours.phase_bounds() == ref.phase_bounds() == {
        "low": (0, 4), "high": (4, 13), "cooldown": (13, 17)}
    items = _same_items(ours, ref)
    spec = ChaosSpec.parse(chaos)
    for it in items:
        assert np.isnan(it["image1"]).all() == (it["index"] in spec.poison_requests)


def test_step_traffic_custom_phases_match_jax(same_frames):
    phases = [("warm", 2, 0.5), ("spike", 3, 0.0), ("tail", 2, 0.1)]
    ours = traffic.StepTraffic((40, 56), [traffic.TrafficPhase(*p) for p in phases], seed=2)
    ref = jax_traffic.StepTraffic((40, 56), [jax_traffic.TrafficPhase(*p) for p in phases],
                                  seed=2)
    items = _same_items(ours, ref)
    assert [it["due_s"] for it in items] == pytest.approx([0.5, 1.0, 1.0, 1.0, 1.0, 1.1, 1.2])
    for bad in ([], [("a", 1, 0.1), ("a", 1, 0.1)]):
        for mod in (traffic, jax_traffic):
            with pytest.raises(ValueError):
                mod.StepTraffic((32, 48), [mod.TrafficPhase(*p) for p in bad])
    for args in (("a", -1, 0.1), ("a", 1, -0.1)):
        for mod in (traffic, jax_traffic):
            with pytest.raises(ValueError):
                mod.TrafficPhase(*args)


@pytest.mark.parametrize("chaos,exponent,interval", [
    ("", 1.1, 0.0), ("burst@2,poison@5", 0.7, 0.01)])
def test_mixed_resolution_draws_jaxs_schedule(same_frames, chaos, exponent, interval):
    sizes = [(48, 64), (96, 128), (40, 56)]
    kw = dict(exponent=exponent, interval_s=interval, seed=11, burst_size=2)
    ours = traffic.MixedResolutionTraffic(sizes, 24, chaos=ChaosSpec.parse(chaos), **kw)
    ref = jax_traffic.MixedResolutionTraffic(sizes, 24, chaos=JaxChaosSpec.parse(chaos), **kw)
    assert ours.size_counts() == ref.size_counts()
    assert sum(ours.size_counts().values()) == 24
    items = _same_items(ours, ref)
    for it in items:
        h, w = (int(v) for v in it["phase"].split("x"))
        assert it["image1"].shape == (h, w, 3)
    for mod, spec in ((traffic, ChaosSpec), (jax_traffic, JaxChaosSpec)):
        for bad in (dict(sizes=[]), dict(sizes=[(32, 48), (32, 48)]), dict(exponent=0.0),
                    dict(n_requests=-1)):
            args = dict(sizes=sizes, n_requests=4, **kw)
            args.update(bad)
            with pytest.raises(ValueError):
                mod.MixedResolutionTraffic(args.pop("sizes"), args.pop("n_requests"), **args)


def test_port_frames_are_deterministic_uint8_pairs():
    a = list(traffic.StepTraffic.step((32, 48), low_n=1, high_n=2, seed=7).schedule())
    b = list(traffic.StepTraffic.step((32, 48), low_n=1, high_n=2, seed=7).schedule())
    c = list(traffic.StepTraffic.step((32, 48), low_n=1, high_n=2, seed=8).schedule())
    assert len(a) == 4
    for x, y, z in zip(a, b, c):
        assert x.image1.dtype == np.uint8 and x.image1.shape == (32, 48, 3)
        assert x.image1.tobytes() == y.image1.tobytes()
        assert x.image2.tobytes() == y.image2.tobytes()
        assert x.image1.tobytes() != z.image1.tobytes()
    m = traffic.MixedResolutionTraffic([(32, 48), (40, 56)], 6, seed=3)
    assert [it.image1.shape[:2] for it in m.schedule()] == [
        tuple(int(v) for v in it.phase.split("x")) for it in m.schedule()]
