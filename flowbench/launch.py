"""Start one process per card for a cell over several cards.

:func:`launch` starts ``n`` copies of a command, each with ``--rank r``
appended and the rendezvous in its environment (``MASTER_ADDR``
``127.0.0.1``, a free ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``): the program's ``parallel.multihost`` joins the world
from them, one card a rank. Rank 0's standard output is the launcher's;
the other ranks' goes to standard error, so the result line rank 0
prints stays the last line. When a rank fails, or when rank 0 has ended,
the launcher stops the others (terminate, then kill after a grace
period), waits for every one, and returns the first failing exit code
(rank 0's otherwise). No process outlives it.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from typing import Optional

GRACE_S = 20.0  # how long a rank may take to end once rank 0 has
POLL_S = 0.2


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(procs: list) -> None:
    """Terminate every live process, kill what is left after the grace
    period, and wait for all of them."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(n: int, argv: list, timeout_s: Optional[float] = None) -> int:
    """Run ``argv + ["--rank", r]`` for r in 0..n-1 and wait as the module
    docstring says; ``timeout_s`` bounds the whole (exit code 124)."""
    port = free_port()
    procs = []
    prev = signal.getsignal(signal.SIGTERM)

    def on_term(signum, frame):
        _stop(procs)
        sys.exit(128 + signum)

    signal.signal(signal.SIGTERM, on_term)
    try:
        for r in range(n):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r))
            procs.append(subprocess.Popen([*argv, "--rank", str(r)], env=env,
                                          stdout=None if r == 0 else sys.stderr.fileno()))
        start = time.monotonic()
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                _stop(procs)
                return failed[0]
            if codes[0] is not None:
                # Rank 0 is done: the others end now, or are stopped.
                deadline = time.monotonic() + GRACE_S
                while time.monotonic() < deadline and any(p.poll() is None for p in procs):
                    time.sleep(POLL_S)
                late = any(p.poll() is None for p in procs)
                _stop(procs)
                codes = [p.returncode for p in procs]
                bad = [c for c in codes if c != 0]
                return bad[0] if bad else (1 if late else 0)
            if timeout_s is not None and time.monotonic() - start > timeout_s:
                _stop(procs)
                return 124
            time.sleep(POLL_S)
    finally:
        _stop(procs)
        signal.signal(signal.SIGTERM, prev)
