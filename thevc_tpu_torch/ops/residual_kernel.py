"""Binding of the hand-written CUDA residual kernel (``csrc/residual.cu``).

Replaces the Pallas TPU kernel ``thevc_tpu/ops/jx_pallas.py:_kernel``
(:141-187): fused dequant + 2-D inverse DCT/DST over a TU batch of one
size class, int32-exact.  The design notes and what bounds the kernel on
the card are in the source's header comment.  Its plain PyTorch version
is ``ops.tq.residual_pipeline_plain``.

The kernel is compiled with ``nvcc`` on first use and bound with
``ctypes`` (``ops.build``).  Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

NAME = "residual"
_ENTRIES = {"thevc_residual": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]}

# kernel launches made by residual(); a plain integer that a run resets
# and reads to show that its main path went through the kernel
launches = 0


def build() -> ctypes.CDLL:
    """Compile (if not built yet) and load the kernel library."""
    return _build.load(NAME, _ENTRIES)


def residual(x: torch.Tensor, scale: torch.Tensor, basis: torch.Tensor,
             dq_shift: int, sh2: int) -> torch.Tensor:
    """Launch the kernel: int16 coefficients [N, s, s] on a CUDA device,
    per-TU int32 dequant scales [N] and the int32 basis [s, s] -> int16
    residual [N, s, s].  Launches on the current stream without
    synchronising; raises on any input the kernel does not take and on
    a launch error."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"the residual kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dim() != 3 or x.shape[1] != x.shape[2] \
            or x.shape[1] not in (4, 8, 16, 32) or x.shape[0] >= 2 ** 31:
        raise ValueError(f"coefficients must be [N, s, s] with s in "
                         f"4/8/16/32 and N < 2^31, got {tuple(x.shape)}")
    n, s = int(x.shape[0]), int(x.shape[1])
    _build.check_tensor(x, "coefficients", torch.int16, (n, s, s), x.device)
    _build.check_tensor(scale, "scale", torch.int32, (n,), x.device)
    _build.check_tensor(basis, "basis", torch.int32, (s, s), x.device)
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = build()
    with torch.cuda.device(x.device):
        rc = lib.thevc_residual(x.data_ptr(), scale.data_ptr(),
                                basis.data_ptr(), out.data_ptr(), n, s,
                                dq_shift, sh2, _build.stream_of(x.device))
    _build.check(lib, rc, "residual kernel launch")
    launches += 1
    return out
