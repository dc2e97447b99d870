"""SLO-driven elastic fleet sizing (port of
``raft_ncup_tpu/fleet/autoscaler.py``).

The anytime-iteration idea at fleet granularity: the server already
degrades per-request quality under load (RAFT's fixed-point iteration
structure lets it answer with fewer iterations, arXiv:2003.12039);
the fleet-level counterpart is to ADD CAPACITY instead of shedding
quality — and to give capacity back when the burn clears. Everything
the loop touches is an existing contract, composed rather than
re-implemented:

- **inputs** — SLO burn-rate paging verdicts from the replicas' healthz
  ``slo`` blocks (the multi-window burn engine, read with ``.get``
  per the wire schema-evolution contract), router queue depth (total
  dispatched-but-unanswered) and per-replica occupancy
  (``FleetRouter.inflight_of``), and the router's shed counter (a shed
  IS the demand the fleet failed to admit);
- **scale-up** — ``ReplicaSupervisor.add_replica``: the new replica
  warms its full executable set during startup and is only promoted to
  UP once its healthz advertises the warmed shapes, so the router's
  shape-aware preference never sees cold capacity (pre-warm is the
  READY gate, not a second mechanism);
- **scale-down** — the replica drain contract (SIGTERM → DRAINING in
  healthz before the flush → exit 75): ZERO in-flight loss, asserted
  by the chaos tier, not by this module;
- **anti-flap** — a decision needs the SAME signal for
  ``scale_hysteresis_ticks`` consecutive ticks AND
  ``scale_cooldown_s`` since the last topology change; an oscillating
  load step whose period beats either bound holds the fleet still
  (pinned in tests/test_torch_autoscaler.py);
- **respawn-storm bound** — per-replica crash loops are already
  bounded by the supervisor's restart budget + circuit breaker; the
  autoscaler adds its own: ``scale_fail_budget`` consecutive FAILED
  scale-ups (the spawned replica breaks or dies before READY) open
  the autoscaler breaker and no further scale-ups fire;
- **backpressure honesty** — while capacity is warming (or the fleet
  is saturated at a bound), the loop publishes its time-to-READY
  estimate to ``FleetRouter.set_scale_eta``: a shed during a cold
  scale-up answers "retry when the new replica can admit", never the
  250ms re-shed treadmill.

Host-only stdlib (no torch): the loop reads healthz dicts and counters;
it must never be able to touch a device tensor.
Deterministic by construction: the clock is injectable and ``tick()``
is synchronous, so the fast tier asserts EXACT decision trajectories
under a fake clock; the background thread is an optional convenience
for real fleets.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from raft_ncup_tpu_torch.fleet.replica import DRAINING, SPAWNING, UP
from raft_ncup_tpu_torch.fleet.topology import FleetConfig

__all__ = ["FleetAutoscaler"]


class FleetAutoscaler:
    """One control loop per fleet: observe → decide → act, one
    decision per tick, every decision recorded.

    ``spawn_fn`` / ``drain_fn`` default to the supervisor's
    ``add_replica`` / (threaded) ``remove_replica``; tests inject
    synchronous recorders. ``clock`` defaults to ``time.monotonic``;
    tests inject a fake.
    """

    def __init__(
        self,
        cfg: FleetConfig,
        supervisor,
        router,
        *,
        telemetry=None,
        clock: Callable[[], float] = time.monotonic,
        spawn_fn: Optional[Callable[[int], None]] = None,
        drain_fn: Optional[Callable[[int], None]] = None,
    ):
        from raft_ncup_tpu_torch.observability import get_telemetry

        self.cfg = cfg
        self.sup = supervisor
        self.router = router
        self._tel = telemetry if telemetry is not None else get_telemetry()
        self._clock = clock
        self._spawn_fn = spawn_fn or self._default_spawn
        self._drain_fn = drain_fn or self._default_drain
        self._lock = threading.RLock()
        # Anti-flap state.
        self._up_streak = 0
        self._down_streak = 0
        self._last_scale_at: Optional[float] = None
        # In-flight topology changes (at most one of each; a loop that
        # stacks spawns is a respawn storm by construction).
        self._pending_up: Optional[tuple] = None  # (index, started_at)
        self._pending_down: Optional[int] = None
        # Time-to-READY estimate: EWMA over observed spawn→READY
        # durations, seeded with the config prior.
        self._ttr_s = float(cfg.scale_eta_prior_s)
        self._ttr_observed = 0
        self._last_shed = int(router.stats.get("shed", 0))
        self._fail_streak = 0
        self.breaker_open = False
        self.scale_ups = 0          # spawns initiated
        self.scale_ups_completed = 0
        self.scale_downs = 0        # drains initiated
        self.failed_scale_ups = 0
        self.decisions: deque = deque(maxlen=4096)
        self._loop_stop = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- actions

    def _default_spawn(self, i: int) -> None:
        self.sup.add_replica(i, wait_ready=False)

    def _default_drain(self, i: int) -> None:
        threading.Thread(
            target=self.sup.remove_replica, args=(i,),
            name=f"autoscaler-drain-{i}", daemon=True,
        ).start()

    # ------------------------------------------------------------- signals

    def time_to_ready_s(self) -> float:
        """The current spawn→READY estimate (the prior until a real
        scale-up has been observed) — what shed hints are floored at
        while capacity warms."""
        with self._lock:
            return self._ttr_s

    def signals(self) -> dict:
        """One coherent observation of the fleet: live/warming sets,
        occupancy, queue depth, paging, shed delta since the last
        tick. Pure reads — calling it never scales anything."""
        handles = list(self.sup.replicas)
        ups = [
            h for h in handles
            if h.state == UP and not h.circuit_open
        ]
        spawning = [h for h in handles if h.state == SPAWNING]
        draining = [h for h in handles if h.state == DRAINING]
        cap = len(ups) * self.cfg.max_inflight_per_replica
        inflight = sum(self.router.inflight_of(h.index) for h in ups)
        # Saturated by definition when nothing is admittable: an empty
        # fleet must read as pressure, not as 0% busy.
        occupancy = min(1.0, inflight / cap) if cap else 1.0
        paging = []
        burn_fast = 0.0
        for h in ups:
            slo = (h.last_healthz or {}).get("slo") or {}
            paging.extend(slo.get("paging") or [])
            for v in (slo.get("verdicts") or {}).values():
                if isinstance(v, dict):
                    burn_fast = max(
                        burn_fast, float(v.get("burn_fast") or 0.0)
                    )
        shed_total = int(self.router.stats.get("shed", 0))
        with self._lock:  # RLock: tick() calls this holding it already
            last_shed = self._last_shed
        return {
            "n_up": len(ups),
            "n_spawning": len(spawning),
            "n_draining": len(draining),
            "up_indices": sorted(h.index for h in ups),
            "occupancy": round(occupancy, 4),
            "queue_depth": inflight,
            "paging": sorted(set(paging)),
            "burn_fast": round(burn_fast, 3),
            "shed_total": shed_total,
            "shed_delta": shed_total - last_shed,
        }

    # ------------------------------------------------------------ the loop

    def tick(self) -> dict:
        """One observe→decide→act pass. Returns (and records) the
        decision: ``{"decision": "hold"|"up"|"down", "reason": ...,
        **signals}``. Synchronous and deterministic under an injected
        clock — the unit the fast tier asserts trajectories on."""
        with self._lock:
            now = self._clock()
            self._settle_pending(now)
            s = self.signals()
            self._last_shed = s["shed_total"]
            pressure = bool(
                s["paging"]
                or s["occupancy"] >= self.cfg.scale_up_occupancy
                or s["shed_delta"] > 0
            )
            calm = (
                not s["paging"]
                and s["shed_delta"] == 0
                and s["occupancy"] <= self.cfg.scale_down_occupancy
            )
            if pressure:
                self._up_streak += 1
                self._down_streak = 0
            elif calm:
                self._down_streak += 1
                self._up_streak = 0
            else:
                # The band between the thresholds: a healthy steady
                # state, not evidence for either direction.
                self._up_streak = 0
                self._down_streak = 0
            cooldown_ok = (
                self._last_scale_at is None
                or now - self._last_scale_at >= self.cfg.scale_cooldown_s
            )
            busy = (
                self._pending_up is not None
                or self._pending_down is not None
            )
            n_live = s["n_up"] + s["n_spawning"]
            decision, reason = "hold", "steady"
            if pressure and not busy:
                decision, reason = self._try_up(
                    now, s, cooldown_ok, n_live
                )
            elif calm and not busy:
                decision, reason = self._try_down(
                    now, s, cooldown_ok
                )
            elif busy:
                reason = (
                    f"topology change in flight (up={self._pending_up}, "
                    f"down={self._pending_down})"
                )
            # Backpressure honesty: publish the ETA whenever sheds
            # would otherwise lie (capacity warming, or saturated with
            # nothing the loop can add yet); clear it when calm.
            eta_active = self._pending_up is not None or pressure
            self.router.set_scale_eta(
                self._ttr_s if eta_active else None
            )
            record = {
                "t": round(now, 4),
                "decision": decision,
                "reason": reason,
                "eta_published": eta_active,
                "breaker_open": self.breaker_open,
                **s,
            }
            self.decisions.append(record)
        self._tel.event("fleet_autoscale_tick", **{
            k: v for k, v in record.items() if k != "up_indices"
        })
        return record

    def _settle_pending(self, now: float) -> None:
        if self._pending_up is not None:
            i, started = self._pending_up
            handle = None
            for h in self.sup.replicas:
                if h.index == i:
                    handle = h
                    break
            if handle is not None and handle.state == UP:
                observed = max(1e-6, now - started)
                # EWMA, half-weight on the newest observation: the
                # estimate tracks compile-time drift without a single
                # outlier owning it.
                self._ttr_s = (
                    observed if self._ttr_observed == 0
                    else 0.5 * self._ttr_s + 0.5 * observed
                )
                self._ttr_observed += 1
                self._pending_up = None
                self._fail_streak = 0
                self.scale_ups_completed += 1
                self._tel.event(
                    "fleet_scale_up_ready", replica=i,
                    time_to_ready_s=round(observed, 3),
                )
            elif handle is None or handle.state not in (SPAWNING, UP):
                # Broke, died, or was retired before ever reaching
                # READY: a failed scale-up — counted, and budgeted.
                self._pending_up = None
                self.failed_scale_ups += 1
                self._fail_streak += 1
                self._tel.event(
                    "fleet_scale_up_failed", replica=i,
                    state=None if handle is None else handle.state,
                    consecutive=self._fail_streak,
                )
                if self._fail_streak >= self.cfg.scale_fail_budget:
                    self.breaker_open = True
                    self._tel.event(
                        "fleet_autoscaler_breaker_open",
                        consecutive=self._fail_streak,
                    )
        if self._pending_down is not None:
            live = {h.index for h in self.sup.replicas}
            if self._pending_down not in live:
                self.scale_downs += 1
                self._tel.event(
                    "fleet_scale_down_done",
                    replica=self._pending_down,
                )
                self._pending_down = None

    def _try_up(self, now, s, cooldown_ok, n_live):
        if self.breaker_open:
            return "hold", (
                f"breaker open after {self._fail_streak} failed "
                "scale-up(s) — respawn storm bounded"
            )
        if n_live >= self.cfg.scale_max:
            return "hold", f"at max_replicas ({self.cfg.scale_max})"
        if self._up_streak < self.cfg.scale_hysteresis_ticks:
            return "hold", (
                f"hysteresis {self._up_streak}/"
                f"{self.cfg.scale_hysteresis_ticks}"
            )
        if not cooldown_ok:
            return "hold", "cooldown"
        taken = {h.index for h in self.sup.replicas}
        slot = next(
            (i for i in range(self.cfg.scale_max) if i not in taken),
            None,
        )
        if slot is None:
            return "hold", "no free replica slot"
        self._spawn_fn(slot)
        self._pending_up = (slot, now)
        self._last_scale_at = now
        self._up_streak = 0
        self.scale_ups += 1
        self._tel.inc("fleet_scale_ups_total")
        return "up", (
            f"spawned slot {slot} (occupancy {s['occupancy']}, "
            f"paging {s['paging']}, shed_delta {s['shed_delta']})"
        )

    def _try_down(self, now, s, cooldown_ok):
        if s["n_up"] <= self.cfg.scale_min:
            return "hold", f"at min_replicas ({self.cfg.scale_min})"
        if self._down_streak < self.cfg.scale_hysteresis_ticks:
            return "hold", (
                f"hysteresis {self._down_streak}/"
                f"{self.cfg.scale_hysteresis_ticks}"
            )
        if not cooldown_ok:
            return "hold", "cooldown"
        # Least-loaded victim; ties retire the NEWEST slot so the
        # stable low-index replicas keep their warm streams sticky.
        victim = max(
            s["up_indices"],
            key=lambda i: (-self.router.inflight_of(i), i),
        )
        self._drain_fn(victim)
        self._pending_down = victim
        self._last_scale_at = now
        self._down_streak = 0
        self._tel.inc("fleet_scale_downs_total")
        return "down", (
            f"draining slot {victim} (occupancy {s['occupancy']})"
        )

    # --------------------------------------------------- background loop

    def start(self, interval_s: Optional[float] = None) -> "FleetAutoscaler":
        """Run :meth:`tick` on a daemon thread every
        ``cfg.scale_tick_s`` (real fleets; tests call tick())."""
        interval = self.cfg.scale_tick_s if interval_s is None else interval_s
        self._loop_stop.clear()

        def _loop() -> None:
            while not self._loop_stop.wait(interval):
                try:
                    self.tick()
                except Exception as e:
                    # A control-loop error must be visible, never fatal
                    # to the fleet it sizes (logged, not swallowed).
                    self._tel.event(
                        "fleet_autoscaler_tick_error", error=repr(e)
                    )

        self._loop_thread = threading.Thread(
            target=_loop, name="fleet-autoscaler", daemon=True
        )
        self._loop_thread.start()
        return self

    def stop(self) -> None:
        self._loop_stop.set()
        if self._loop_thread is not None and self._loop_thread.is_alive():
            self._loop_thread.join(timeout=10.0)
        # Never leave a stale ETA flooring shed hints after the loop
        # that maintained it is gone.
        self.router.set_scale_eta(None)

    def report(self) -> dict:
        """Elasticity accounting: every decision is in ``decisions``; this
        is the summary."""
        with self._lock:
            return {
                "scale_ups": self.scale_ups,
                "scale_ups_completed": self.scale_ups_completed,
                "scale_downs": self.scale_downs,
                "failed_scale_ups": self.failed_scale_ups,
                "breaker_open": self.breaker_open,
                "time_to_ready_s": round(self._ttr_s, 3),
                "time_to_ready_observed": self._ttr_observed,
                "ticks": len(self.decisions),
            }

    def __enter__(self) -> "FleetAutoscaler":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
