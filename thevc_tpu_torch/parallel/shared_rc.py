"""Mesh-wide rate control: a shared bit pool across parallel encoders.

Counterpart of ``thevc_tpu/parallel/shared_rc.py``.  The multi-stream
encode plan needs exactly one collective: frame-level rate feedback.
Each slot encodes its own stream in its own process (one rank of a
``torch.distributed`` process group, as ``torchrun`` or
``torch.multiprocessing`` gives them); after every frame the per-slot
bit counts are summed over the group with one ``all_reduce`` of an
int64 scalar (on the slot's CUDA device under NCCL, which rides NVLink
between cards; on the CPU under gloo) and every slot re-derives its
next-frame budget from the GLOBAL remaining pool.  A slot that
undershot gets more room only because the group-wide sum says the pool
allows it: the rate-control state is a function of the collective's
result.

The QP update is the frame-level half of the reference's URQ model
(TEncRateCtrl::getFrameQP, TEncRateCtrl.cpp:321): budget-ratio driven QP
deltas clamped to +-2 per frame, without the MAD model (open-loop
multi-stream encoders have no shared texture statistics).  The rule and
its numpy arithmetic are the JAX package's (``frame_targets`` and
``frame_qps``, :70-101), evaluated for this slot only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


class MeshRatePool:
    """Shared bit pool over a process group, one rank per slot.

    Usage in each slot's process, per frame k:
        target = pool.frame_targets(spent, k + 1)
        qp     = pool.frame_qp(qp, spent, k + 1)
    `spent` is this slot's total bits written so far; each call runs one
    all-reduce over the group and returns this slot's host value.  The
    group (the default one when ``group`` is None) must be initialised;
    its slot count is its world size.
    """

    def __init__(self, total_bits: int, n_frames: int, group=None):
        self.group = group
        self.total_bits = int(total_bits)
        self.n_frames = int(n_frames)
        self.n = dist.get_world_size(group)
        backend = dist.get_backend(group)
        if backend == "nccl":
            self.device = torch.device("cuda", torch.cuda.current_device())
        elif backend == "gloo":
            self.device = torch.device("cpu")
        else:
            raise ValueError(f"unsupported backend {backend}: expected "
                             "nccl or gloo")

    def global_spent(self, spent_local: int) -> int:
        """All-reduce (sum) this slot's spent bits over the group; returns
        the group-wide total."""
        t = torch.tensor([int(spent_local)], dtype=torch.int64,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return int(t.item())

    def frame_targets(self, spent_local: int, frames_done: int) -> float:
        """This slot's bit target for the next frame from the GLOBAL pool:
        remaining pool split evenly over remaining slot-frames."""
        g = self.global_spent(spent_local)
        remaining_frames = self.n * (self.n_frames - frames_done)
        if remaining_frames <= 0:
            return 0.0
        return max(0.0, (self.total_bits - g) / remaining_frames)

    def frame_qp(self, qp: int, spent_local: int, frames_done: int) -> int:
        """QP of this slot's next frame: its QP nudged by the ratio of its
        last-frame spend to the pool-derived target (getFrameQP's
        budget-ratio clamp, TEncRateCtrl.cpp:321-420)."""
        target = self.frame_targets(spent_local, frames_done)
        per_frame_spent = np.float64(spent_local) / max(1, frames_done)
        qp = np.int32(qp)
        if target > 0:
            ratio = per_frame_spent / target
            if ratio > 1.25:
                qp += 2
            elif ratio > 1.05:
                qp += 1
            elif ratio < 0.8:
                qp -= 2
            elif ratio < 0.95:
                qp -= 1
        return int(np.clip(qp, 0, 51))
