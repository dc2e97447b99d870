"""The port's environment knobs (the getters of
``raft_ncup_tpu/utils/knobs.py`` that the port needs, under the port's own
``RAFT_TORCH_`` prefix).

Every knob is declared here once, with its default and one line of
meaning, and read only through :func:`knob_raw` or :func:`knob_enabled`,
which raise on a name missing from :data:`KNOBS`. Pure stdlib: the
telemetry package reads its knobs through this module and imports nothing
else of the port.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

# name -> (default, meaning)
KNOBS: Dict[str, Tuple[Optional[str], str]] = {
    "RAFT_TORCH_TELEMETRY": (
        "1", "0 disables the default telemetry hub at creation (opt-out)"),
    "RAFT_TORCH_FLIGHT_DIR": (
        None, "arms the default hub's flight recorder in this directory"),
    "RAFT_TORCH_CPU_PEAK_FLOPS": (
        None, "peak FLOP/s of the whole CPU for MFU (default: cores x 4.8e10)"),
    "RAFT_TORCH_DIST_BACKEND": (
        None, "the process group's backend, nccl or gloo (default: nccl for a rank on a "
        "card, gloo for a rank on the CPU)"),
    "RAFT_TORCH_EARLYEXIT": (
        None, "1 turns the served forward's early exit on (read once by FlowServer)"),
    "RAFT_TORCH_EARLYEXIT_TOL": (
        "0.05", "the early exit's convergence tolerance, in low-res pixels"),
}


def _known(name: str) -> Tuple[Optional[str], str]:
    if name not in KNOBS:
        raise KeyError(f"unregistered env knob {name!r}: declare it in "
                       "raft_ncup_tpu_torch/utils/knobs.py")
    return KNOBS[name]


def knob_raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """The env string when set; else ``default`` when given; else the
    registered default."""
    registered, _ = _known(name)
    raw = os.environ.get(name)
    if raw is not None:
        return raw
    return default if default is not None else registered


def knob_enabled(name: str) -> bool:
    """Opt-out boolean: true unless the env value is exactly ``"0"``."""
    _known(name)
    return os.environ.get(name, "1") != "0"
