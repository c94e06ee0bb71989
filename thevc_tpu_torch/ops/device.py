"""Device accounting and device choice for the port.

Counterpart of ``thevc_tpu/ops/device.py``.  It keeps the launch and
transfer counters (``STATS``) that the decode reports per frame, and the
decode's stage walls (``STAGES``), which are summed only while stage
timing is on because each timed stage synchronises the device.  It has
no environment policy, no backend probe and no compile cache: callers
pass a ``torch.device`` explicitly, and a CUDA device that is absent is
an error, never a quiet switch to the CPU.
"""

from __future__ import annotations

import contextlib
import time

import torch

STATS = {"launches": 0, "h2d_bytes": 0, "d2h_bytes": 0}
# stage name -> seconds, summed while stage timing is on
STAGES: dict = {}
_TIMING = {"on": False}
_OPEN: list = []        # seconds spent in the stages inside each open one


def stat_launch(h2d_bytes: int = 0) -> None:
    STATS["launches"] += 1
    STATS["h2d_bytes"] += int(h2d_bytes)


def stat_h2d(nbytes: int) -> None:
    """A host-to-device copy that launches nothing."""
    STATS["h2d_bytes"] += int(nbytes)


def stat_d2h(nbytes: int) -> None:
    STATS["d2h_bytes"] += int(nbytes)


def stage_timing(on: bool) -> dict:
    """Turn stage timing on or off; returns the walls summed so far and
    zeroes them."""
    _TIMING["on"] = bool(on)
    out = dict(STAGES)
    STAGES.clear()
    return out


@contextlib.contextmanager
def stage(name: str, device: torch.device):
    """Add the wall of the block to ``STAGES[name]`` while stage timing
    is on, with the device synchronised before and after it (so work
    queued earlier is not charged to it, and its own work is).  A stage
    inside another is charged to itself only.  While timing is on the
    block, its closing synchronisation included, is also a
    ``torch.profiler`` range of the stage's name, so a profile taken then
    can charge each device activity to the stage that launched it.  Off,
    it does nothing."""
    if not _TIMING["on"]:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    _OPEN.append(0.0)
    try:
        with torch.profiler.record_function(name):
            try:
                yield
            finally:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
    finally:
        wall = time.perf_counter() - t0
        inner = _OPEN.pop()
        STAGES[name] = STAGES.get(name, 0.0) + wall - inner
        if _OPEN:
            _OPEN[-1] += wall


def stats_reset() -> dict:
    """Return the counters so far and zero them."""
    out = dict(STATS)
    for k in STATS:
        STATS[k] = 0
    return out


def resolve(device) -> torch.device:
    """``device`` (a ``torch.device`` or its name) as a ``torch.device``.

    Raises when a CUDA device is asked for and CUDA is not available, or
    when the device is neither a CPU nor a CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")
    return dev
