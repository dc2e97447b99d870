"""Socket frame protocol between the router and a replica server:
length-prefixed JSON header + raw C-order ndarray payloads over a Unix
domain socket or a TCP connection (port of ``raft_ncup_tpu/fleet/wire.py``;
the frames are byte for byte the JAX package's, so either package's
router talks to either package's replica).

One frame is::

    u32 big-endian header length
    header JSON (utf-8): {"kind": ..., ..., "arrays": [
        {"shape": [...], "dtype": "<numpy dtype str>"}, ...]}
    for each entry of header["arrays"]: that array's raw C-order bytes

JSON carries the control fields a human can read in a pcap; the pixel
payloads ride as raw bytes because base64-ing megabytes of frames into
JSON would triple the router's copy costs. The receiver wraps each
payload with ``np.frombuffer`` (zero-copy, read-only — every consumer
downstream stages/copies anyway).

**Schema evolution contract**: every field beyond ``kind`` is OPTIONAL
— in particular the cross-process trace context under ``TRACE_KEY``
(``observability.spans.TraceContext.to_wire``). An old replica must
parse a new router's frames (it ignores the key) and a new replica an
old router's (``TraceContext.from_wire(header.get(TRACE_KEY))`` is
``None``); consumers therefore read it with ``.get``, never a
subscript.

**Addressing** (:class:`Transport`): an address string is either a
filesystem path (Unix domain socket — anything containing a path
separator, or lacking a ``host:port`` shape) or ``host:port`` (TCP).
The frame protocol is family-agnostic; what the INET family adds is
failure modes the LAN owns and the loopback never shows:

- a connect can hang on an unroutable host → :meth:`Transport.connect`
  bounds it with a timeout;
- a peer can vanish without a FIN (host partition, agent SIGKILL) and
  leave the connection half-open — ``SO_KEEPALIVE`` is armed on every
  TCP socket, and a read deadline (:func:`set_read_timeout`, raw
  ``SO_RCVTIMEO`` so sends stay governed by their own ``SO_SNDTIMEO``)
  turns eternal silence into a timeout the caller can probe on;
- a slow-loris peer can dribble a frame forever — a read timeout that
  fires MID-frame raises ``ConnectionError`` (the frame can never be
  trusted; same contract as a mid-frame EOF), while one that fires at a
  frame BOUNDARY raises :class:`FrameTimeout` (the link is merely
  idle; the router's link reader answers it with a ping probe).

Clean-EOF vs mid-frame semantics are identical across families.

Host-only stdlib + numpy (no torch: an AST scan in
``tests/test_torch_fleet.py``): the wire layer must never be able to
touch a device tensor; producers hand it host ndarrays that were read at
their own sanctioned boundaries.
"""

from __future__ import annotations

import errno
import json
import os
import socket
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Sanity bound on a single header (a corrupt length prefix must fail
# loudly, not allocate gigabytes).
MAX_HEADER_BYTES = 1 << 20

# The OPTIONAL trace-context header field (see the schema-evolution
# contract above): request frames may carry a serialized TraceContext
# here; response frames may echo {"trace_id": ...}.
TRACE_KEY = "trace"

_LEN = struct.Struct(">I")

# Default bound on a TCP connect (an unroutable host must fail in
# seconds, not kernel-default minutes); FleetConfig overrides per fleet.
DEFAULT_CONNECT_TIMEOUT_S = 10.0


class FrameTimeout(TimeoutError):
    """A read deadline fired at a frame BOUNDARY: the peer simply has
    nothing to say (or is half-open — the caller cannot tell yet, which
    is exactly why the router's link reader answers this with a ping
    probe: a half-open peer fails the send and the normal down path
    flushes). A deadline that fires MID-frame is ``ConnectionError``
    instead — that frame can never be trusted."""


class Transport:
    """One parsed wire address: where a replica (or host agent)
    listens, family included. ``host:port`` (port all digits, no path
    separator) is TCP; anything else is a Unix-domain-socket path.

    The parse is deliberately syntactic — the same string that appears
    in ``FleetConfig``-derived argv (the serve entry's
    ``--replica_socket``)
    decides the family on both ends, so a topology is moved from UDS to
    TCP by changing addresses, nothing else.
    """

    __slots__ = ("family", "path", "host", "port")

    def __init__(self, family: int, path: str = "",
                 host: str = "", port: int = 0):
        self.family = family
        self.path = path
        self.host = host
        self.port = port

    @classmethod
    def parse(cls, address: str) -> "Transport":
        if not address:
            raise ValueError("empty wire address")
        host, sep, port = address.rpartition(":")
        if sep and host and port.isdigit() and os.sep not in address:
            return cls(socket.AF_INET, host=host, port=int(port))
        return cls(socket.AF_UNIX, path=address)

    @property
    def is_inet(self) -> bool:
        return self.family == socket.AF_INET

    def render(self) -> str:
        return f"{self.host}:{self.port}" if self.is_inet else self.path

    def connect(
        self, timeout_s: Optional[float] = DEFAULT_CONNECT_TIMEOUT_S,
    ) -> socket.socket:
        """Open a connected stream socket to this address. The connect
        itself is bounded by ``timeout_s``; the returned socket is back
        in blocking mode (read deadlines are the caller's policy —
        :func:`set_read_timeout`). TCP sockets get ``SO_KEEPALIVE`` +
        ``TCP_NODELAY`` (frames are latency-bound request/response
        pairs, never throughput-bound streams worth Nagle-batching)."""
        sock = socket.socket(self.family, socket.SOCK_STREAM)
        try:
            sock.settimeout(timeout_s)
            if self.is_inet:
                sock.setsockopt(
                    socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1
                )
                sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
                sock.connect((self.host, self.port))
            else:
                sock.connect(self.path)
            sock.settimeout(None)
        except BaseException:
            sock.close()
            raise
        return sock

    def listen(self, backlog: int = 16) -> socket.socket:
        """Bind + listen on this address. A stale UDS path from a dead
        incarnation is removed first; TCP binds with ``SO_REUSEADDR``
        so a restarted replica is not locked out by its predecessor's
        TIME_WAIT."""
        sock = socket.socket(self.family, socket.SOCK_STREAM)
        try:
            if self.is_inet:
                sock.setsockopt(
                    socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
                )
                sock.bind((self.host, self.port))
            else:
                try:
                    os.remove(self.path)
                except OSError:
                    pass
                sock.bind(self.path)
            sock.listen(backlog)
        except BaseException:
            sock.close()
            raise
        return sock

    def cleanup(self) -> None:
        """Remove the UDS path at teardown (no-op for TCP)."""
        if not self.is_inet:
            try:
                os.remove(self.path)
            except OSError:
                pass


def set_read_timeout(
    sock: socket.socket, timeout_s: Optional[float],
) -> None:
    """Arm a receive deadline as raw ``SO_RCVTIMEO`` — NOT
    ``settimeout()``, which would flip the fd non-blocking and bound
    sends too; the router's links already bound sends separately with
    ``SO_SNDTIMEO`` and share one socket between a sender and a reader
    thread. A deadline that fires surfaces in :func:`recv_msg` as
    :class:`FrameTimeout` (frame boundary) or ``ConnectionError``
    (mid-frame)."""
    t = 0.0 if timeout_s is None else max(0.0, float(timeout_s))
    sec = int(t)
    usec = int(round((t - sec) * 1e6))
    sock.setsockopt(
        socket.SOL_SOCKET, socket.SO_RCVTIMEO,
        struct.pack("ll", sec, usec),
    )


def send_msg(sock: socket.socket, header: dict,
             arrays: Sequence[np.ndarray] = ()) -> None:
    """Send one frame. ``header`` must not carry an ``arrays`` key of
    its own — the descriptor list is derived from ``arrays``."""
    if "arrays" in header:
        raise ValueError("header key 'arrays' is reserved for the wire")
    payloads = []
    descs = []
    for arr in arrays:
        if not isinstance(arr, np.ndarray):
            raise TypeError(
                f"wire payloads must be host ndarrays, got "
                f"{type(arr).__name__} (pull at the producer's "
                "sanctioned boundary first)"
            )
        payloads.append(arr.tobytes())  # C-order copy if non-contiguous
        descs.append({"shape": list(arr.shape), "dtype": str(arr.dtype)})
    blob = json.dumps({**header, "arrays": descs}).encode("utf-8")
    if len(blob) > MAX_HEADER_BYTES:
        raise ValueError(f"header too large: {len(blob)} bytes")
    sock.sendall(_LEN.pack(len(blob)) + blob + b"".join(payloads))


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly ``n`` bytes; None on clean EOF at a frame boundary
    (0 bytes read). A mid-frame EOF raises — a half message means the
    peer died mid-send and the frame must not be trusted. A read
    deadline (``settimeout`` or raw ``SO_RCVTIMEO``) that fires at 0
    bytes raises :class:`FrameTimeout` (idle link, probe-able); one
    that fires mid-read raises ``ConnectionError`` (slow-loris or
    half-open peer — the frame is as dead as a torn one)."""
    chunks = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except OSError as e:
            if isinstance(e, socket.timeout) or e.errno in (
                errno.EAGAIN, errno.EWOULDBLOCK,
            ):
                if got == 0:
                    raise FrameTimeout(
                        "no bytes within the read deadline"
                    ) from e
                raise ConnectionError(
                    f"read deadline mid-frame ({got}/{n} bytes): "
                    "slow-loris or half-open peer"
                ) from e
            raise
        if not chunk:
            if got == 0:
                return None
            raise ConnectionError(
                f"peer closed mid-frame ({got}/{n} bytes)"
            )
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_msg(
    sock: socket.socket,
) -> Optional[Tuple[dict, List[np.ndarray]]]:
    """Receive one frame; ``None`` on clean EOF (peer closed between
    frames). Returns ``(header, arrays)`` with the descriptor list
    stripped back off the header."""
    raw_len = _recv_exact(sock, _LEN.size)
    if raw_len is None:
        return None
    (n,) = _LEN.unpack(raw_len)
    if n > MAX_HEADER_BYTES:
        raise ValueError(f"frame header length {n} exceeds bound")
    try:
        blob = _recv_exact(sock, n)
        if blob is None:
            raise ConnectionError(
                "peer closed between length and header"
            )
        header = json.loads(blob.decode("utf-8"))
        descs = header.pop("arrays", [])
        arrays: List[np.ndarray] = []
        for d in descs:
            dtype = np.dtype(d["dtype"])
            shape = tuple(int(x) for x in d["shape"])
            count = 1
            for x in shape:
                count *= x
            payload = _recv_exact(sock, count * dtype.itemsize)
            if payload is None:
                raise ConnectionError("peer closed before array payload")
            arrays.append(
                np.frombuffer(payload, dtype=dtype).reshape(shape)
            )
    except FrameTimeout as e:
        # The length prefix landed, so the frame has STARTED: a read
        # deadline anywhere past it is mid-frame by definition, even if
        # an individual _recv_exact saw 0 of its own bytes.
        raise ConnectionError(
            f"read deadline mid-frame (after length prefix): {e}"
        ) from e
    return header, arrays
