"""The seam between the reference encoder and the port's decision pass.

The reference encoder (``thevc_tpu.encoder``) runs the fast-RD intra
decision pass through ``thevc_tpu.encoder.fast_intra.decide_frame``,
which ``slice_encoder.py`` imports at call time.  ``device_decisions``
sets that name to the port's ``decide_frame`` on a torch device for the
length of a ``with`` block, so the reference's CLI, cfg handling, native
apply pass and entropy coding run unchanged around the port's
decisions, and no reference file is edited.  It also:

- sets ``thevc_tpu.encoder.fast_inter.dispatch_frame_p`` to a function
  that raises ``NotImplementedError``: the port has no P/B fast-RD yet;
- refuses ``THEVC_FASTRD_DEVAPPLY`` other than ``0`` (the device apply
  runs in ``jax``) and ``THEVC_DEVICE=1`` (the reference's device policy
  imports ``jax``), and sets ``THEVC_DEVICE=0`` while it is active, so
  the reference's thread-count choice does not probe for a JAX backend;
- loads the native core on the calling thread first: concurrent first
  calls of ``thevc_tpu.native.get_lib()`` can see ``None``.

Everything is restored on exit, also on error.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import time

from ..ops import device as device_mod
from . import fast_intra


@dataclasses.dataclass
class DecisionStats:
    """What the decision passes of one ``device_decisions`` block cost:
    frames decided and their summed wall time in seconds, from the call
    to the maps on the host (so synchronised with the device)."""
    frames: int = 0
    wall_s: float = 0.0
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock,
                                              repr=False)

    def add(self, seconds: float) -> None:
        with self._lock:
            self.frames += 1
            self.wall_s += seconds


def _no_inter_fast_rd(*args, **kwargs):
    raise NotImplementedError("fast-RD for P/B slices (inter decisions) is "
                              "not ported to thevc_tpu_torch yet")


@contextlib.contextmanager
def device_decisions(device):
    """Run the reference encoder's fast-RD intra decisions on ``device``
    (a ``torch.device`` or its name) inside the block.  Yields the
    block's ``DecisionStats``."""
    dev = device_mod.resolve(device)
    if os.environ.get("THEVC_FASTRD_DEVAPPLY", "0") != "0":
        raise ValueError("THEVC_FASTRD_DEVAPPLY must be 0: the device apply "
                         "is not ported and would import jax")
    if os.environ.get("THEVC_DEVICE", "") == "1":
        raise ValueError("THEVC_DEVICE=1 selects the reference's JAX device "
                         "path; unset it to encode with thevc_tpu_torch")
    from thevc_tpu import native
    from thevc_tpu.encoder import fast_inter
    from thevc_tpu.encoder import fast_intra as ref_fast_intra
    native.get_lib()
    stats = DecisionStats()
    decide = functools.partial(fast_intra.decide_frame, device=dev)

    def timed_decide_frame(*args):
        t0 = time.perf_counter()
        maps = decide(*args)
        stats.add(time.perf_counter() - t0)
        return maps

    saved = (ref_fast_intra.decide_frame, fast_inter.dispatch_frame_p,
             os.environ.get("THEVC_DEVICE"))
    ref_fast_intra.decide_frame = timed_decide_frame
    fast_inter.dispatch_frame_p = _no_inter_fast_rd
    os.environ["THEVC_DEVICE"] = "0"
    try:
        yield stats
    finally:
        ref_fast_intra.decide_frame, fast_inter.dispatch_frame_p = saved[:2]
        if saved[2] is None:
            os.environ.pop("THEVC_DEVICE", None)
        else:
            os.environ["THEVC_DEVICE"] = saved[2]
