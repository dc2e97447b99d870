"""The fleet router: admission, affinity, shape-aware routing, and
failover over N replica processes (port of
``raft_ncup_tpu/fleet/router.py``).

The router is the fleet's front door and its robustness chokepoint:

- **admission sheds HERE**, before work crosses a process boundary: a
  request the fleet cannot absorb is refused at the router with an
  honest ``retry_after_s`` aggregated from the replicas' own hints (the
  max over the replicas consulted — the router never invents a smaller
  number than a replica it asked), not serialized over a socket into a
  queue that would shed it anyway.
- **stream affinity is consistent-hash + sticky**: a video stream's
  warm slot state in device memory lives on exactly one replica, so its frames must
  keep landing there; rendezvous hashing picks the home, a sticky map
  keeps it until that replica dies or drains (a replica coming BACK
  must not steal streams whose warm state now lives elsewhere).
- **request routing is shape-aware**: the replicas advertise their
  warmed ``(shape, batch, iters)`` sets through healthz; a request
  whose padded shape is already warm on one replica must not pay a cold
  capture on another while the first sits idle.
- **rotation is DRAINING/DEGRADED-aware**: a draining replica finishes
  its in-flight work but gets nothing new (the healthz DRAINING state
  is published BEFORE the flush for exactly this poll); a DEGRADED
  replica still serves — coarser answers beat shed ones.
- **failover respects deadlines and is bounded**: when a replica dies
  with requests in flight, each pending request is re-dispatched at
  most ``max_failovers`` times and only if its deadline still allows;
  otherwise it terminates with an honest ``shed``/``error`` — the same
  five-status protocol as ``serving/request.py``, no silent drops.

Host-only stdlib + numpy (no torch): the router holds pixels only as
host ndarrays in transit and can never add a device sync to the path it
routes.
"""

from __future__ import annotations

import hashlib
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from raft_ncup_tpu_torch.fleet import wire
from raft_ncup_tpu_torch.fleet.replica import ReplicaSupervisor
from raft_ncup_tpu_torch.fleet.topology import FleetConfig
from raft_ncup_tpu_torch.observability.spans import TraceContext, new_trace_id
from raft_ncup_tpu_torch.serving.request import (
    STATUS_ERROR,
    STATUS_SHED,
    FlowResponse,
    ServeHandle,
)


def rendezvous_choice(key: str, candidates: Sequence[int]) -> int:
    """Highest-random-weight (rendezvous) hash: the stable
    consistent-hash choice of a replica for ``key`` — when a replica
    leaves, only ITS keys move; the rest stay put."""
    if not candidates:
        raise ValueError("no candidates")
    return max(
        candidates,
        key=lambda i: hashlib.md5(
            f"{key}:{i}".encode("utf-8")
        ).hexdigest(),
    )


class _Pending:
    """One dispatched, unanswered request held for completion or
    failover. The router keeps the staged host arrays exactly as long
    as a failover could still need them."""

    __slots__ = (
        "rid", "handle", "kind", "header", "arrays", "deadline",
        "submit_time", "replica", "failovers", "stream_id", "consulted",
        "link", "trace_id", "sent_s",
    )

    def __init__(self, rid, handle, kind, header, arrays, deadline,
                 submit_time, replica, stream_id, consulted):
        self.rid = rid
        self.handle = handle
        self.kind = kind
        self.header = header
        self.arrays = arrays
        self.deadline = deadline
        self.submit_time = submit_time
        self.replica = replica
        self.failovers = 0
        self.stream_id = stream_id
        self.consulted = set(consulted)
        # One trace per request, minted at the fleet edge: the id
        # SURVIVES failover (the re-dispatch is the same journey) and
        # rides the wire header's optional trace context so the
        # replica's spans adopt it.
        self.trace_id = new_trace_id()
        self.sent_s: Optional[float] = None  # router clock at last send
        # The link incarnation that carried the dispatch: responses ride
        # the same connection, so when THIS link dies the request can
        # never be answered — even if a fresh link to the same replica
        # already exists (the reconnect race must not strand it).
        self.link = None


class _Link:
    """One live socket to one replica incarnation, with its reader
    thread. Dead links are discarded; a restarted replica gets a fresh
    link on the next dispatch.

    Half-open detection (TCP): when the socket carries a read deadline
    (``wire.set_read_timeout``; the router arms it on INET links), a
    deadline at a frame BOUNDARY (``wire.FrameTimeout``) means the link
    is idle — or the peer vanished without a FIN and will never speak
    again. The reader answers it with a ping probe: a healthy peer
    pongs before the next deadline, a half-open one fails the send
    (RST once the peer's host notices, or ``SO_SNDTIMEO`` when even
    that is gone) and the normal down path flushes this incarnation's
    in-flight requests — half-open detection folded into the existing
    incarnation-tagged failover flush, not a second mechanism. A
    deadline MID-frame arrives as ``ConnectionError`` (slow-loris /
    dying peer) and tears the link like any torn frame."""

    def __init__(self, index: int, sock: socket.socket,
                 on_message: Callable, on_down: Callable,
                 clock: Callable[[], float] = time.monotonic):
        self.index = index
        self.sock = sock
        self.alive = True
        self.send_lock = threading.Lock()
        self._on_message = on_message
        self._on_down = on_down
        self._clock = clock
        self.probes = 0  # boundary-timeout ping probes sent
        self.reader = threading.Thread(
            target=self._read_loop, name=f"fleet-link-{index}", daemon=True
        )
        self.reader.start()

    def send(self, header: dict, arrays=()) -> bool:
        with self.send_lock:
            if not self.alive:
                return False
            try:
                wire.send_msg(self.sock, header, arrays)
                return True
            except OSError:
                self.alive = False
                return False

    def _read_loop(self) -> None:
        try:
            while True:
                try:
                    msg = wire.recv_msg(self.sock)
                except wire.FrameTimeout:
                    self.probes += 1
                    if not self.send(
                        {"kind": "ping", "t0": self._clock()}
                    ):
                        break  # half-open: the send noticed first
                    continue
                if msg is None:
                    break
                self._on_message(self.index, *msg)
        except (OSError, ValueError):
            pass  # connection torn mid-frame: same as EOF below
        with self.send_lock:
            # Same lock as send(): a sender mid-send must never observe
            # alive flipping under it.
            self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass
        self._on_down(self.index, self)


class FleetRouter:
    """Route requests and stream frames over a supervised replica
    fleet. Constructed from the same :class:`FleetConfig` the
    supervisor spawned from — topology is read, never re-declared."""

    def __init__(
        self,
        cfg: FleetConfig,
        supervisor: ReplicaSupervisor,
        *,
        telemetry=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        from raft_ncup_tpu_torch.observability import get_telemetry

        self.cfg = cfg
        self.sup = supervisor
        self._clock = clock
        self._tel = telemetry if telemetry is not None else get_telemetry()
        self._lock = threading.RLock()
        self._links: Dict[int, _Link] = {}
        self._pending: Dict[int, _Pending] = {}
        # Keyed by replica slot index; accessed with .get(i, 0) — the
        # live set is elastic (autoscaler adds/retires slots), so a
        # fresh slot must not KeyError its first dispatch.
        self._inflight: Dict[int, int] = {
            i: 0 for i in range(cfg.n_replicas)
        }
        self._dispatched: Dict[int, int] = {
            i: 0 for i in range(cfg.n_replicas)
        }
        # The autoscaler's published time-to-READY estimate (None when
        # capacity isn't warming): sheds while a scale-up is still
        # compiling must tell the client to retry AFTER the new
        # replica can admit, not the default 250ms re-shed treadmill.
        self._scale_eta_s: Optional[float] = None
        self._affinity: Dict[str, int] = {}
        self._shed_hints: Dict[int, float] = {}
        self._replica_of: Dict[int, int] = {}  # rid -> last replica
        # Monotonic-clock offsets from the per-link handshake:
        # replica_mono - router_mono, estimated as pong minus
        # (ping + rtt/2). 0.0 until a pong answers (UDS on one host:
        # CLOCK_MONOTONIC is shared, so 0.0 is already correct; the
        # handshake is what keeps per-hop deltas meaningful when the
        # wire grows a TCP multi-host transport).
        self._clock_offsets: Dict[int, float] = {}
        # set_fleet_telemetry ack bookkeeping (bench's fleet
        # telemetry-overhead window toggles the replicas' hubs in place).
        self._tel_ack_cond = threading.Condition()
        self._tel_acks: set = set()
        self._next_id = 0
        self._draining = False
        self.stats = {
            "submitted": 0, "routed": 0, "shed": 0, "completed": 0,
            "failovers": 0, "failover_errors": 0, "failover_sheds": 0,
        }
        # The supervisor's death notifications flush our pending set;
        # link EOFs reach the same path first for a faster failover.
        # CHAIN any callback the supervisor was constructed with (an
        # operator's alerting hook must not be silently discarded).
        prev_on_death = supervisor._on_death

        def _on_death(index: int, reason: str) -> None:
            self._on_replica_death(index, reason)
            if prev_on_death is not None:
                prev_on_death(index, reason)

        supervisor._on_death = _on_death

    # ------------------------------------------------------------ routing

    def _admittable(self) -> List[int]:
        return [
            h.index for h in self.sup.replicas if h.admittable()
        ]

    def _warm_for(self, i: int, h: int, w: int) -> bool:
        """Does replica ``i`` advertise a warmed executable for this
        native shape? Matched on the padded (H, W) of the replica's own
        pad divisor against the healthz ``warmed`` set."""
        handle = self.sup.handle(i)
        hz = handle.last_healthz
        warmed = (hz or {}).get("warmed") or []
        ph, pw = self.cfg.shape_key(h, w, i)
        return any(
            int(entry[0]) == ph and int(entry[1]) == pw
            for entry in warmed
            if isinstance(entry, (list, tuple)) and len(entry) >= 2
        )

    def _pick_replica(
        self, *, stream_id: Optional[str], h: int, w: int,
        exclude: frozenset = frozenset(),
    ):
        """Choose a replica for one dispatch. Returns
        ``(index | None, consulted)`` — ``consulted`` is every replica
        whose capacity the decision looked at, the set the shed hint
        aggregates over."""
        candidates = [
            i for i in self._admittable() if i not in exclude
        ]
        consulted = list(candidates)
        if not candidates:
            return None, consulted
        if stream_id is not None:
            home = self._affinity.get(stream_id)
            if home is not None and home in candidates:
                candidates = [home]
            else:
                # (Re-)home by rendezvous hash over the live set; sticky
                # from here so a replica coming back cannot steal the
                # stream's now-elsewhere warm state.
                home = rendezvous_choice(stream_id, candidates)
                self._affinity[stream_id] = home
                candidates = [home]
        else:
            warm = [i for i in candidates if self._warm_for(i, h, w)]
            if warm:
                candidates = warm
        # Admission bound: shed at the router before a socket hop.
        open_cap = [
            i for i in candidates
            if self._inflight.get(i, 0) < self.cfg.max_inflight_per_replica
        ]
        if not open_cap:
            return None, consulted
        # Least in-flight wins; ties break by cumulative dispatch count
        # so a sequential open-loop (inflight always 0 at submit time)
        # still spreads over the fleet instead of pinning replica 0.
        return min(
            open_cap,
            key=lambda i: (
                self._inflight.get(i, 0), self._dispatched.get(i, 0), i,
            ),
        ), consulted

    def _retry_after(self, consulted) -> float:
        """The aggregated backpressure hint: the MAX over the hints the
        consulted replicas last shed with (never smaller than any
        replica the decision looked at), floored at the config default
        — and at the autoscaler's published time-to-READY estimate
        while a scale-up is warming: a client told "retry in 250ms"
        during a cold compile just re-sheds; a client told "retry in
        the ETA" lands on the new capacity (regression-pinned in
        tests/test_fleet.py)."""
        with self._lock:  # RLock: callers may already hold it
            hints = [
                self._shed_hints[i] for i in consulted
                if i in self._shed_hints
            ]
            floor = [self.cfg.default_retry_after_s]
            if self._scale_eta_s is not None:
                floor.append(self._scale_eta_s)
        return round(max(hints + floor), 4)

    def _link(self, i: int) -> Optional[_Link]:
        with self._lock:
            link = self._links.get(i)
            if link is not None and link.alive:
                return link
        spec = self.cfg.replica(i)
        try:
            transport = wire.Transport.parse(
                spec.address or spec.socket_path
            )
            sock = transport.connect(
                timeout_s=self.cfg.connect_timeout_s
            )
            # Bound SENDS only (SO_SNDTIMEO, not settimeout: the reader
            # thread shares this socket and must block indefinitely): a
            # frame pair can exceed the UDS buffer, and sendall to a
            # SIGSTOPped replica must fail over after seconds, not hang
            # the submitter until the staleness pass.
            import struct as _struct

            sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                _struct.pack("ll", 10, 0),
            )
            if transport.is_inet:
                # Read deadline → boundary timeouts → the link reader's
                # ping probe: half-open peers (partitioned host, agent
                # SIGKILL) get flushed instead of hanging forever.
                wire.set_read_timeout(
                    sock, self.cfg.link_read_timeout_s
                )
        except (OSError, ValueError):
            return None
        link = _Link(
            i, sock, self._on_message, self._on_link_down,
            clock=self._clock,
        )
        with self._lock:
            self._links[i] = link
        # Clock handshake: ping carries the router's monotonic clock;
        # the pong (handled in _on_message) yields this link's offset.
        # Fire-and-forget — a replica that predates the handshake
        # simply never answers with t_mono and the offset stays 0.0.
        link.send({"kind": "ping", "t0": self._clock()})
        return link

    # ----------------------------------------------------------- admission

    def submit(
        self,
        image1,
        image2,
        *,
        deadline_s: Optional[float] = None,
        stream_id: Optional[str] = None,
        frame_index: Optional[int] = None,
    ) -> ServeHandle:
        """Submit one frame pair to the fleet; returns a handle that
        terminates in exactly one of the five serving statuses.
        ``stream_id`` routes by affinity through the owning replica's
        StreamEngine; without it the request rides FlowServer routing."""
        handle = ServeHandle()
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self.stats["submitted"] += 1
        self._tel.inc("fleet_submitted_total")
        if self._draining:
            self._complete_shed(rid, handle, (), "router draining")
            return handle
        shape = getattr(image1, "shape", None)
        if shape is None or len(shape) != 3:
            handle.complete(FlowResponse(
                rid, STATUS_ERROR,
                detail=f"not an (H, W, C) array: {type(image1).__name__}",
            ))
            return handle
        h, w = int(shape[0]), int(shape[1])
        now = self._clock()
        deadline = None if deadline_s is None else now + deadline_s
        kind = "request" if stream_id is None else "frame"
        header = {"kind": kind, "id": rid}
        if deadline_s is not None:
            header["deadline_s"] = deadline_s
        if stream_id is not None:
            header["stream_id"] = stream_id
            if frame_index is not None:
                header["frame_index"] = frame_index
        with self._lock:
            target, consulted = self._pick_replica(
                stream_id=stream_id, h=h, w=w
            )
            if target is None:
                self._complete_shed(
                    rid, handle, consulted,
                    "fleet at capacity" if consulted
                    else "no admittable replica",
                )
                return handle
            pending = _Pending(
                rid, handle, kind, header, (image1, image2), deadline,
                now, target, stream_id, consulted,
            )
            self._register(pending, target)
        self._dispatch(pending, target)
        return handle

    def _register(self, pending: _Pending, target: int) -> None:
        self._pending[pending.rid] = pending
        self._inflight[target] = self._inflight.get(target, 0) + 1
        self._dispatched[target] = self._dispatched.get(target, 0) + 1
        self._replica_of[pending.rid] = target
        self.stats["routed"] += 1

    def _dispatch(self, pending: _Pending, target: int) -> None:
        # The router-side correlation id IS the replica-side request id:
        # the replica's FlowServer/StreamEngine register the request
        # under this exact id, so one `request_id` matches spans on both
        # sides of the process boundary (scripts/postmortem.py) — and
        # the trace context rides the header as an OPTIONAL field, so
        # the replica's own spans adopt the same trace_id (old replicas
        # ignore it).
        now = self._clock()
        pending.sent_s = now
        with self._lock:
            clock_offset_s = self._clock_offsets.get(target, 0.0)
        pending.header["trace"] = TraceContext(
            trace_id=pending.trace_id,
            span_id=f"router-{pending.rid}",
            clock_offset_s=clock_offset_s,
            sent_s=now,
        ).to_wire()
        self._tel.event(
            "fleet_dispatch", request_id=pending.rid, replica=target,
            kind=pending.kind, stream_id=pending.stream_id,
            trace_id=pending.trace_id,
        )
        # Router-queue hop: submit -> this send (routing + any failover
        # wait). Feeds the fleet_hop_* stage breakdown in
        # telemetry_report() alongside the wire/replica/return hops.
        self._tel.hist_observe(
            "fleet_hop_router_queue_ms",
            (now - pending.submit_time) * 1e3,
        )
        link = self._link(target)
        pending.link = link
        sent = link is not None and link.send(
            pending.header, pending.arrays
        )
        if not sent:
            self._on_replica_death(target, "dispatch send failed")

    def _complete_shed(self, rid, handle, consulted, detail) -> None:
        with self._lock:
            self.stats["shed"] += 1
        self._tel.inc("fleet_shed_total")
        handle.complete(FlowResponse(
            rid, STATUS_SHED,
            retry_after_s=self._retry_after(consulted),
            detail=detail,
        ))

    # ---------------------------------------------------------- responses

    def _on_message(self, index: int, header: dict, arrays) -> None:
        kind = header.get("kind")
        if kind == "pong":
            # Clock handshake answer: offset = replica_mono - router_mono,
            # with the one-way delay approximated as rtt/2.
            t0, t_mono = header.get("t0"), header.get("t_mono")
            if t0 is not None and t_mono is not None:
                now = self._clock()
                rtt = max(0.0, now - float(t0))
                offset = float(t_mono) - (float(t0) + rtt / 2.0)
                with self._lock:
                    self._clock_offsets[index] = offset
                self._tel.event(
                    "fleet_clock_handshake", replica=index,
                    offset_s=round(offset, 6),
                    rtt_ms=round(rtt * 1e3, 3),
                )
            return
        if kind == "telemetry_ack":
            with self._tel_ack_cond:
                self._tel_acks.add(index)
                self._tel_ack_cond.notify_all()
            return
        if kind != "response":
            return
        rid = header.get("id")
        with self._lock:
            pending = self._pending.pop(rid, None)
            if pending is not None:
                self._inflight[pending.replica] = max(
                    0, self._inflight.get(pending.replica, 0) - 1
                )
        if pending is None:
            return  # failed over already; the late answer is dropped
        status = header.get("status", STATUS_ERROR)
        retry_after = header.get("retry_after_s")
        if status == STATUS_SHED and header.get("detail") == "draining":
            # A draining replica refuses work it never admitted into
            # its engine (the SIGTERM beat the socket read). That
            # refusal is re-routable — the scale-down zero-loss claim
            # is the ROUTER's to keep — so treat it like a death-
            # stranding: redispatch to a survivor within the failover
            # budget (and shed honestly, ETA-floored, only if none can
            # admit).
            self._tel.event(
                "fleet_drain_refusal_failover", request_id=rid,
                replica=index,
            )
            self._failover_one(pending, index, self._clock())
            return
        if status == STATUS_SHED:
            # Aggregate the backpressure hint: never smaller than any
            # replica this request's routing consulted.
            with self._lock:
                if retry_after is not None:
                    self._shed_hints[index] = float(retry_after)
                hints = [
                    self._shed_hints[i]
                    for i in pending.consulted | {index}
                    if i in self._shed_hints
                ]
                self.stats["shed"] += 1
            retry_after = round(max(
                hints + [float(retry_after or 0.0),
                         self.cfg.default_retry_after_s]
            ), 4)
            self._tel.inc("fleet_shed_total")
        now = self._clock()
        flow = arrays[0] if arrays else None
        with self._lock:
            self.stats["completed"] += 1
            offset = self._clock_offsets.get(pending.replica, 0.0)
        self._tel.hist_observe(
            "fleet_e2e_ms", (now - pending.submit_time) * 1e3
        )
        # Per-hop attribution: the replica stamps its receive/done instants on
        # its own monotonic clock; the handshake offset translates them
        # onto the router's. Clamped at 0 — the offset carries up to
        # rtt/2 of estimation error, and a hop must never read negative.
        t_recv = header.get("t_recv_s")
        t_done = header.get("t_done_s")
        if t_recv is not None and pending.sent_s is not None:
            self._tel.hist_observe(
                "fleet_hop_wire_ms",
                max(0.0, (float(t_recv) - offset - pending.sent_s) * 1e3),
            )
        if t_recv is not None and t_done is not None:
            self._tel.hist_observe(
                "fleet_hop_replica_ms",
                max(0.0, (float(t_done) - float(t_recv)) * 1e3),
            )
        if t_done is not None:
            self._tel.hist_observe(
                "fleet_hop_return_ms",
                max(0.0, (now - (float(t_done) - offset)) * 1e3),
            )
        # The trace's ROOT span: one ring record per completed request
        # carrying the trace id — what aggregate.py anchors the stitched
        # fleet tree on (and for_attr(trace_id=...) finds live).
        self._tel.observe_ms(
            "fleet_request", (now - pending.submit_time) * 1e3,
            trace_id=pending.trace_id, request_id=rid,
            replica=pending.replica, kind=pending.kind,
            span_id=f"router-{rid}",
        )
        pending.handle.complete(FlowResponse(
            rid,
            status,
            flow=flow,
            iters=header.get("iters"),
            latency_s=now - pending.submit_time,
            retry_after_s=retry_after,
            detail=header.get("detail", ""),
        ))

    # ------------------------------------------------------------ failover

    def _on_link_down(self, index: int, link: _Link) -> None:
        # Flush the requests THIS incarnation carried even when a fresh
        # link to the same replica was already installed by a racing
        # dispatch — responses ride the connection that died, so those
        # requests can never be answered (no-silent-drop contract).
        self._on_replica_death(index, "connection lost", link=link)

    def _on_replica_death(
        self, index: int, reason: str, link: Optional[_Link] = None,
    ) -> None:
        """Flush pending requests on a dead replica (``link=None``: all
        of them — supervisor-detected death) or on one dead link
        incarnation (``link=``): re-dispatch within budget and deadline,
        terminate honestly otherwise. Runs from the supervisor's poll,
        a link reader, or a failed send — whichever notices first; the
        pending map makes it idempotent."""
        with self._lock:
            popped = None
            if link is None or self._links.get(index) is link:
                popped = self._links.pop(index, None)
            stranded = [
                p for p in self._pending.values()
                if p.replica == index and (link is None or p.link is link)
            ]
            for p in stranded:
                del self._pending[p.rid]
            if link is None:
                self._inflight[index] = 0
            else:
                # Only this incarnation's requests died; a racing fresh
                # link may already carry live ones.
                self._inflight[index] = max(
                    0, self._inflight.get(index, 0) - len(stranded)
                )
            # Streams homed here must re-admit elsewhere, cold (a
            # reconnected incarnation has no warm slot state either).
            moved_streams = [
                s for s, i in self._affinity.items() if i == index
            ]
            for s in moved_streams:
                del self._affinity[s]
        for dead in {link, popped} - {None}:
            dead.alive = False
            try:
                dead.sock.close()
            except OSError:
                pass
        if not stranded and not moved_streams:
            return
        self._tel.event(
            "fleet_replica_down", replica=index, reason=reason,
            stranded=len(stranded), moved_streams=len(moved_streams),
        )
        # Fault trigger: bank the failover context (the stranded ids
        # correlate with the dead replica's own flight dumps).
        self._tel.flight_dump(
            "replica_failover", replica=index, reason=reason,
            request_ids=[p.rid for p in stranded],
            moved_streams=moved_streams,
        )
        now = self._clock()
        for p in stranded:
            self._failover_one(p, index, now)

    def _failover_one(self, p: _Pending, dead: int, now: float) -> None:
        if p.failovers >= self.cfg.max_failovers:
            with self._lock:
                self.stats["failover_errors"] += 1
            p.handle.complete(FlowResponse(
                p.rid, STATUS_ERROR,
                detail=f"replica {dead} died; failover budget "
                f"({self.cfg.max_failovers}) exhausted",
            ))
            return
        if p.deadline is not None and now >= p.deadline:
            with self._lock:
                self.stats["failover_errors"] += 1
            p.handle.complete(FlowResponse(
                p.rid, STATUS_ERROR,
                latency_s=now - p.submit_time,
                detail=f"replica {dead} died; deadline expired before "
                "failover",
            ))
            return
        with self._lock:
            target, consulted = self._pick_replica(
                stream_id=p.stream_id,
                h=int(p.arrays[0].shape[0]),
                w=int(p.arrays[0].shape[1]),
                exclude=frozenset({dead}),
            )
            if target is None:
                self.stats["failover_sheds"] += 1
                self.stats["shed"] += 1
                self._tel.inc("fleet_shed_total")
                p.handle.complete(FlowResponse(
                    p.rid, STATUS_SHED,
                    retry_after_s=self._retry_after(consulted),
                    detail=f"replica {dead} died; no admittable replica "
                    "for failover",
                ))
                return
            p.failovers += 1
            p.replica = target
            p.consulted |= set(consulted)
            self._register_failover(p, target)
            self.stats["failovers"] += 1
        self._tel.inc("fleet_failovers_total")
        self._tel.event(
            "fleet_failover", request_id=p.rid, from_replica=dead,
            to_replica=target, kind=p.kind, stream_id=p.stream_id,
            trace_id=p.trace_id,
        )
        self._dispatch(p, target)

    def _register_failover(self, pending: _Pending, target: int) -> None:
        self._pending[pending.rid] = pending
        self._inflight[target] = self._inflight.get(target, 0) + 1
        self._dispatched[target] = self._dispatched.get(target, 0) + 1
        self._replica_of[pending.rid] = target

    # ------------------------------------------------------------ queries

    def replica_of(self, rid: int) -> Optional[int]:
        """Which replica carried request ``rid`` (last dispatch) — the
        deterministic coordinate fleet chaos targets."""
        with self._lock:
            return self._replica_of.get(rid)

    def clock_offsets(self) -> Dict[int, float]:
        """Per-replica monotonic-clock offsets from the link handshake
        (replica_mono - router_mono) — what aggregate.py uses to
        translate replica-side record timestamps onto the router's
        clock when stitching the fleet trace tree."""
        with self._lock:
            return dict(self._clock_offsets)

    def set_fleet_telemetry(
        self, enabled: bool, timeout: float = 10.0,
    ) -> int:
        """Toggle every LIVE replica's telemetry hub in place over the
        wire (the fleet analogue of ``Telemetry.enabled``: the fleet
        telemetry-overhead measurement flips it off and back on the SAME
        warm fleet, so the comparison never embeds a re-warmup).
        Returns how many replicas acked within ``timeout``; the
        router's own hub is the caller's to flip."""
        with self._lock:
            targets = [
                i for i, link in self._links.items() if link.alive
            ]
        with self._tel_ack_cond:
            self._tel_acks.clear()
        sent = set()
        for i in targets:
            link = self._link(i)
            if link is not None and link.send(
                {"kind": "set_telemetry", "enabled": bool(enabled)}
            ):
                sent.add(i)
        deadline = time.monotonic() + timeout
        with self._tel_ack_cond:
            while not sent <= self._tel_acks:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._tel_ack_cond.wait(left)
            return len(self._tel_acks & sent)

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    # --------------------------------------------- autoscaler surfaces

    def inflight_of(self, i: int) -> int:
        """Outstanding dispatches on replica ``i`` — the autoscaler's
        per-replica occupancy input and its least-loaded-victim key on
        scale-down."""
        with self._lock:
            return self._inflight.get(i, 0)

    def queue_depth(self) -> int:
        """Total dispatched-but-unanswered requests (the router has no
        literal queue — backpressure sheds at admission — so depth IS
        the fleet-wide in-flight count)."""
        with self._lock:
            return sum(self._inflight.values())

    def occupancy(self) -> float:
        """Fleet-wide occupancy in [0, 1]: in-flight over the open
        capacity of the admittable set. 1.0 with NOTHING admittable —
        a fleet with no admittable replica is saturated by definition,
        not idle."""
        with self._lock:
            admittable = self._admittable()
            cap = len(admittable) * self.cfg.max_inflight_per_replica
            if cap <= 0:
                return 1.0
            used = sum(self._inflight.get(i, 0) for i in admittable)
            return min(1.0, used / cap)

    def set_scale_eta(self, eta_s: Optional[float]) -> None:
        """Publish (or clear, with ``None``) the autoscaler's
        time-to-READY estimate: every shed's ``retry_after_s`` is
        floored at it while set (see :meth:`_retry_after`)."""
        with self._lock:
            self._scale_eta_s = (
                None if eta_s is None else max(0.0, float(eta_s))
            )

    def report(self) -> dict:
        with self._lock:
            return {
                "stats": dict(self.stats),
                "per_replica_dispatched": dict(self._dispatched),
                "per_replica_inflight": dict(self._inflight),
                "affinity": dict(self._affinity),
                "shed_hints": dict(self._shed_hints),
            }

    # ----------------------------------------------------------- teardown

    def drain(self, timeout: float = 60.0) -> dict:
        """Stop admitting (new submits shed), wait for in-flight work,
        close links. The replicas' own drains are the supervisor's job —
        the router only owns its half of the no-silent-loss contract."""
        self._draining = True
        deadline = self._clock() + timeout
        while self.pending_count() and self._clock() < deadline:
            time.sleep(0.02)
        with self._lock:
            leftovers = list(self._pending.values())
            self._pending.clear()
            links = list(self._links.values())
            self._links.clear()
        for p in leftovers:
            # Bounded wait expired: the client gets an explicit error,
            # never silence.
            p.handle.complete(FlowResponse(
                p.rid, STATUS_ERROR,
                detail="router drained with request still in flight",
            ))
        for link in links:
            link.alive = False
            try:
                link.sock.close()
            except OSError:
                pass
        # Bank the router's half of the fleet trace tree: the full span
        # ring (every fleet_request root span + dispatch event) plus the
        # handshake's clock offsets — exactly what aggregate.py needs to
        # stitch this run's traces against the replicas' own drain dumps.
        self._tel.flight_dump(
            "router_drain",
            stranded=len(leftovers),
            clock_offsets={
                str(i): round(o, 6)
                for i, o in self.clock_offsets().items()
            },
        )
        return self.report()

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.drain()


def replay_fleet(
    router: FleetRouter,
    items,
    *,
    supervisor: Optional[ReplicaSupervisor] = None,
    chaos=None,
    interval_s: float = 0.0,
    manager=None,
):
    """Drive a deterministic schedule through the router, firing fleet
    chaos at exact submission indices (the serve and stream chaos
    machinery at fleet granularity): after submission ``n`` dispatches, ``killreplica@n``
    SIGKILLs / ``stallreplica@n`` SIGSTOPs / ``drainreplica@n`` SIGTERM-
    drains the replica that carried it. Returns the submission handles.

    Host-scale kinds need ``manager`` (a
    ``fleet/host_supervisor.FleetManager``): ``partitionhost@n`` drops
    the TCP links to the host that carried submission ``n`` (both
    directions), ``killsupervisor@n`` SIGKILLs that host's agent (its
    replicas linger until the staleness contract reaps them). The
    coordinate stays a submission index for every kind — the TARGET
    host is derived from the carrying replica's placement, so the
    blast lands deterministically.

    ``items``: dicts with ``image1``/``image2`` (+ optional
    ``stream_id``, ``frame_index``, ``deadline_s``).
    """
    handles = []
    for n, item in enumerate(items):
        with router._lock:
            rid = router._next_id  # this submission's id (sole submitter)
        handle = router.submit(
            item["image1"], item["image2"],
            deadline_s=item.get("deadline_s"),
            stream_id=item.get("stream_id"),
            frame_index=item.get("frame_index"),
        )
        handles.append(handle)
        if chaos is not None:
            target = router.replica_of(rid)
            if target is not None and supervisor is not None:
                if n in chaos.kill_replica_at:
                    supervisor.kill(target)
                if n in chaos.stall_replica_at:
                    supervisor.stall(target)
                if n in chaos.drain_replica_at:
                    threading.Thread(
                        target=supervisor.drain, args=(target,),
                        name=f"chaos-drain-{target}", daemon=True,
                    ).start()
            if target is not None and manager is not None:
                if n in chaos.partition_host_at:
                    manager.partition(manager.host_of(target))
                if n in chaos.kill_supervisor_at:
                    manager.kill_agent(manager.host_of(target))
        if interval_s:
            time.sleep(interval_s)
    return handles
