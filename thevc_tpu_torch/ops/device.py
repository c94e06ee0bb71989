"""Device accounting and device choice for the port.

Counterpart of ``thevc_tpu/ops/device.py``.  It keeps the launch and
transfer counters (``STATS``) that the decode reports per frame.  It has
no environment policy, no backend probe and no compile cache: callers
pass a ``torch.device`` explicitly, and a CUDA device that is absent is
an error, never a quiet switch to the CPU.
"""

from __future__ import annotations

import torch

STATS = {"launches": 0, "h2d_bytes": 0, "d2h_bytes": 0}


def stat_launch(h2d_bytes: int = 0) -> None:
    STATS["launches"] += 1
    STATS["h2d_bytes"] += int(h2d_bytes)


def stat_d2h(nbytes: int) -> None:
    STATS["d2h_bytes"] += int(nbytes)


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
