"""The port's ``FleetAutoscaler`` against the JAX package's, on the CPU.

Each scenario of the JAX package's autoscaler matrix (scale-up under
saturation, paging and sheds; the time-to-READY estimate; scale-down to
the floor and the victim rule; anti-flap; the fail-budget breaker; the ETA
publication; signals) runs once through each package's autoscaler, with
the same fake supervisor (replica handles, no processes), fake router
(counters) and fake clock. Every tick's whole decision record, the
published ETAs, the replica slots left and the final report must be equal
between the two, and each scenario also checks the trajectory JAX's own
test pins.
"""

import jax  # noqa: F401  (the reference package runs on the CPU platform)
import pytest
import torch

import raft_ncup_tpu.fleet as jfleet
import raft_ncup_tpu.fleet.replica as jreplica
import raft_ncup_tpu.observability as jobs
import raft_ncup_tpu_torch.fleet as pfleet
import raft_ncup_tpu_torch.fleet.replica as preplica
import raft_ncup_tpu_torch.observability as pobs

torch.set_num_threads(1)

PKGS = {"jax": (jfleet, jreplica, jobs), "port": (pfleet, preplica, pobs)}


class _Handle:
    def __init__(self, index, state):
        self.index, self.state, self.circuit_open = index, state, False
        self.last_healthz = {"overall": "ready"}


class _Sup:
    """Replica handles without processes; spawn and drain change the list
    as the supervisor's add_replica and remove_replica do."""

    def __init__(self, states, indices):
        self.states = states
        self.replicas = [_Handle(i, states.UP) for i in indices]

    def handle(self, i):
        return next((h for h in self.replicas if h.index == i), None)

    def spawn(self, i):
        self.replicas.append(_Handle(i, self.states.SPAWNING))

    def drain(self, i):
        self.replicas = [h for h in self.replicas if h.index != i]


class _Router:
    def __init__(self):
        self.stats, self.inflight, self.scale_eta, self.eta_log = {"shed": 0}, {}, None, []

    def inflight_of(self, i):
        return self.inflight.get(i, 0)

    def set_scale_eta(self, eta_s):
        self.scale_eta = eta_s
        self.eta_log.append(eta_s)


class _Clock:
    t = 0.0

    def __call__(self):
        return self.t


class _World:
    """One package's autoscaler over the fakes."""

    def __init__(self, pkg, tmp, indices=(0,), **cfg_kw):
        fleet, self.states, obs = PKGS[pkg]
        kw = dict(n_replicas=1, min_replicas=1, max_replicas=3, scale_hysteresis_ticks=2,
                  scale_cooldown_s=5.0, scale_fail_budget=2, scale_eta_prior_s=20.0,
                  max_inflight_per_replica=4)
        kw.update(cfg_kw)
        self.cfg = fleet.FleetConfig(base_dir=str(tmp), **kw)
        self.sup, self.router, self.clock = _Sup(self.states, indices), _Router(), _Clock()
        self.sc = fleet.FleetAutoscaler(self.cfg, self.sup, self.router,
                                        telemetry=obs.Telemetry(), clock=self.clock,
                                        spawn_fn=self.sup.spawn, drain_fn=self.sup.drain)

    def ticks(self, n, dt=1.0):
        out = []
        for _ in range(n):
            self.clock.t += dt
            out.append(self.sc.tick())
        return out

    def set_state(self, i, name):
        self.sup.handle(i).state = getattr(self.states, name)

    def outcome(self):
        return dict(decisions=list(self.sc.decisions), report=self.sc.report(),
                    eta=self.router.eta_log, slots=[(h.index, h.state) for h in
                                                    self.sup.replicas],
                    ttr=self.sc.time_to_ready_s(), breaker=self.sc.breaker_open)


def _saturation(w):
    w.router.inflight[0] = 4  # occupancy 1.0
    recs = w.ticks(4)
    assert [r["decision"] for r in recs] == ["hold", "up", "hold", "hold"]
    assert recs[0]["reason"] == "hysteresis 1/2"
    assert recs[1]["reason"].startswith("spawned slot 1")
    assert all(r["reason"].startswith("topology change in flight") for r in recs[2:])


def _time_to_ready(w):
    w.router.inflight[0] = 4
    w.ticks(2)  # up at t=2
    w.set_state(1, "UP")
    w.clock.t = 4.0  # 2 s observed
    w.sc.tick()
    assert w.sc.time_to_ready_s() == pytest.approx(2.0)
    w.router.inflight[1] = 4
    w.ticks(4)  # the cooldown ends at t=7: slot 2 spawns
    w.set_state(2, "UP")
    t_spawn = [r for r in w.sc.decisions if r["decision"] == "up"][-1]["t"]
    w.clock.t = t_spawn + 6.0
    w.sc.tick()
    assert w.sc.time_to_ready_s() == pytest.approx(0.5 * 2.0 + 0.5 * 6.0)


def _at_max(w):
    for i in range(3):
        w.router.inflight[i] = 4
    recs = w.ticks(3)
    assert [r["decision"] for r in recs] == ["hold"] * 3
    assert recs[-1]["reason"] == "at max_replicas (3)"


def _paging_and_sheds(w):
    w.sup.handle(0).last_healthz = {
        "overall": "ready",
        "slo": {"paging": ["availability"], "verdicts": {"availability": {"burn_fast": 14.4}}}}
    recs = w.ticks(2)
    assert recs[1]["decision"] == "up" and recs[1]["paging"] == ["availability"]
    w.sup.handle(0).last_healthz = {"overall": "ready"}
    w.set_state(1, "UP")
    for _ in range(8):
        w.router.stats["shed"] += 3
        rec = w.ticks(1)[0]
        assert rec["shed_delta"] == 3


def _calm_drains_one(w):
    recs = w.ticks(4)
    assert [r["decision"] for r in recs] == ["hold", "down", "hold", "hold"]
    assert recs[2]["reason"] == "at min_replicas (1)"
    assert [h.index for h in w.sup.replicas] == [0]


def _victim(w):
    w.router.inflight = {0: 1, 1: 0, 2: 0}
    w.ticks(2)
    assert [h.index for h in w.sup.replicas] == [0, 1]  # ties retire the newest


def _draining_not_up(w):
    w.set_state(1, "DRAINING")
    rec = w.sc.tick()
    assert (rec["n_up"], rec["n_draining"], rec["reason"]) == (1, 1, "at min_replicas (1)")


def _oscillation(w):
    for k in range(12):
        load = 4 if k % 2 == 0 else 0
        w.router.inflight = {0: load, 1: load}
        assert w.ticks(1)[0]["decision"] == "hold"


def _cooldown(w):
    w.router.inflight[0] = 4
    w.ticks(2)
    w.set_state(1, "UP")
    w.router.inflight[1] = 4
    recs = w.ticks(4)
    assert [r["decision"] for r in recs] == ["hold"] * 4 and recs[-1]["reason"] == "cooldown"
    assert w.ticks(1)[0]["decision"] == "up"


def _mid_band(w):
    w.router.inflight[0] = 4
    w.ticks(1)
    w.router.inflight[0] = 2
    assert w.ticks(1)[0]["reason"] == "steady"
    w.router.inflight[0] = 4
    assert w.ticks(1)[0]["reason"] == "hysteresis 1/2"


def _breaker(w):
    w.router.inflight[0] = 4
    for _ in range(20):
        if w.sc.breaker_open:
            break
        rec = w.ticks(1)[0]
        if rec["decision"] == "up":  # the spawned replica breaks before READY
            next(h for h in w.sup.replicas if h.state == w.states.SPAWNING).state = \
                w.states.BROKEN
    assert w.sc.failed_scale_ups == 2 and w.sc.breaker_open
    rec = w.ticks(1)[0]
    assert rec["decision"] == "hold" and "respawn storm bounded" in rec["reason"]
    before = w.sc.scale_ups
    w.ticks(3)
    assert w.sc.scale_ups == before


def _success_resets_streak(w):
    w.router.inflight[0] = 4
    w.ticks(2)
    w.set_state(1, "BROKEN")
    w.ticks(1)
    w.sup.drain(1)
    w.ticks(2)
    w.set_state(1, "UP")
    w.ticks(1)
    assert w.sc.failed_scale_ups == 1 and not w.sc.breaker_open
    w.router.inflight = {0: 4, 1: 4}
    w.ticks(2)
    assert w.sc.scale_ups == 3


def _eta(w):
    w.router.inflight[0] = 4
    w.ticks(1)
    assert w.router.scale_eta == pytest.approx(20.0)
    w.ticks(2)
    w.set_state(1, "UP")
    w.router.inflight = {0: 0, 1: 0}
    w.ticks(1)
    assert w.router.scale_eta is None
    w.router.inflight = {0: 4, 1: 4}
    w.ticks(1)
    w.sc.stop()  # no thread: stop still clears the ETA
    assert w.router.scale_eta is None


def _signals(w):
    w.sup.handle(1).circuit_open = True
    assert w.sc.signals()["up_indices"] == [0]
    w.set_state(0, "BROKEN")
    s = w.sc.signals()
    assert s["n_up"] == 0 and s["occupancy"] == 1.0  # an empty fleet is saturated
    w.ticks(3)


SCENARIOS = {
    "saturation": (_saturation, {}),
    "time_to_ready": (_time_to_ready, {}),
    "at_max": (_at_max, dict(indices=(0, 1, 2), n_replicas=3)),
    "paging_and_sheds": (_paging_and_sheds, {}),
    "calm_drains_one": (_calm_drains_one, dict(indices=(0, 1), n_replicas=2)),
    "victim": (_victim, dict(indices=(0, 1, 2), n_replicas=3)),
    "draining_not_up": (_draining_not_up, dict(indices=(0, 1), n_replicas=2)),
    "oscillation": (_oscillation, dict(indices=(0, 1), n_replicas=2)),
    "cooldown": (_cooldown, {}),
    "mid_band": (_mid_band, {}),
    "breaker": (_breaker, dict(scale_cooldown_s=0.001)),
    "success_resets_streak": (_success_resets_streak, dict(scale_cooldown_s=0.001)),
    "eta": (_eta, {}),
    "signals": (_signals, dict(indices=(0, 1), n_replicas=2)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decisions_match_jax(tmp_path, name):
    scenario, kw = SCENARIOS[name]
    outcomes = {}
    for pkg in PKGS:
        w = _World(pkg, tmp_path / pkg, **kw)
        scenario(w)
        outcomes[pkg] = w.outcome()
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"]["decisions"], "the scenario ticked"


def test_background_loop_ticks_and_stops(tmp_path):
    import time

    w = _World("port", tmp_path)
    w.sc._clock = time.monotonic
    with w.sc.start(interval_s=0.01):
        deadline = time.monotonic() + 5.0
        while len(w.sc.decisions) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert len(w.sc.decisions) >= 3
    assert w.router.scale_eta is None  # stop() cleared it
    rep = w.sc.report()
    assert set(rep) == {"scale_ups", "scale_ups_completed", "scale_downs", "failed_scale_ups",
                        "breaker_open", "time_to_ready_s", "time_to_ready_observed", "ticks"}
