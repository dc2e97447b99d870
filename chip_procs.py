#!/usr/bin/env python3
"""Run a command while sampling ``/proc``, and name every process that
started during the run and is still there after the command ended.

    python3 chip_procs.py [--out procs.json] [--log run.log] -- python3 chip_smoke.py

The command's output goes to ``--log`` (default: this process's own). Every
0.1 s the sampler records each process that was not there before the
command started: its parent, command line, and when it was first and last
seen (seconds from the start). After the command ends it lists, at +0, +1,
+5 and +20 s, every such process still there (with its state, threads and
wait channel), reads ``nvidia-smi``'s compute processes where there is one,
writes it all to ``--out`` as JSON, and prints a summary. It then stops
(SIGKILL) what is still there at +20 s, so it leaves nothing running itself.
Exits with the command's exit code. Linux only.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time


def _info(pid: int):
    try:
        with open(f"/proc/{pid}/stat") as fh:
            stat = fh.read()
        fields = stat[stat.rindex(")") + 2:].split()
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            cmd = fh.read().replace(b"\0", b" ").decode(errors="replace").strip()[:300]
        return {"state": fields[0], "ppid": int(fields[1]), "pgid": int(fields[2]),
                "sid": int(fields[3]), "comm": stat[stat.index("(") + 1:stat.rindex(")")],
                "cmd": cmd}
    except (OSError, ValueError, IndexError):
        return None


def _pids() -> list:
    return [int(p) for p in os.listdir("/proc") if p.isdigit()]


def _details(pid: int, info: dict) -> dict:
    try:
        tasks = os.listdir(f"/proc/{pid}/task")
        info["threads"] = sorted({open(f"/proc/{pid}/task/{t}/comm").read().strip()
                                  for t in tasks})[:40]
        info["wchan"] = open(f"/proc/{pid}/wchan").read()
    except OSError:
        pass
    return info


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="procs.json")
    ap.add_argument("--log", default=None)
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    command = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not command:
        ap.error("no command given")

    me = os.getpid()
    before = set(_pids())
    seen, stop = {}, threading.Event()
    t0 = time.monotonic()

    def sample():
        while not stop.is_set():
            now = time.monotonic() - t0
            for pid in _pids():
                if pid in before or pid == me:
                    continue
                if pid in seen:
                    seen[pid]["last"] = now
                else:
                    info = _info(pid)
                    if info is not None:
                        seen[pid] = {**info, "first": now, "last": now}
            time.sleep(0.1)

    sampler = threading.Thread(target=sample, name="proc-sampler", daemon=True)
    sampler.start()
    log = open(args.log, "w") if args.log else None
    try:
        rc = subprocess.call(command, stdout=log, stderr=subprocess.STDOUT if log else None)
    finally:
        if log is not None:
            log.close()
    seconds = time.monotonic() - t0
    left = {}
    for delay in (0.0, 1.0, 5.0, 20.0):
        time.sleep(delay)
        now = {}
        for pid in _pids():
            if pid in before or pid == me:
                continue
            info = _info(pid)
            if info is not None:
                now[pid] = _details(pid, info)
        left[f"+{delay:g}s"] = now
    stop.set()
    sampler.join(timeout=5.0)
    smi = None
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,process_name,used_memory",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
    with open(args.out, "w") as fh:
        json.dump({"command": command, "rc": rc, "seconds": seconds, "left_after_exit": left,
                   "nvidia_smi_compute_apps": smi, "seen": seen}, fh, indent=1)
    print(f"chip_procs: rc {rc} in {seconds:.1f} s; {len(seen)} processes started during the run")
    for when, procs in left.items():
        print(f"chip_procs: still there at {when}: "
              + json.dumps({p: [d["state"], d["ppid"], d["cmd"][:160]] for p, d in procs.items()}))
    print(f"chip_procs: nvidia-smi compute processes after the run: {smi!r}")
    for pid in left["+20s"]:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    return rc


if __name__ == "__main__":
    sys.exit(main())
