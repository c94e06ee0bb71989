"""Binding of the hand-written CUDA SATD kernel (``csrc/satd.cu``).

Replaces the Pallas TPU kernel ``thevc_tpu/ops/jx_pallas.py:_satd_kernel``
(:63-89, launched by ``satd_sweep_planar`` at :115): the Hadamard SATD
of each PU's original against each of its candidate predictions, int32-
exact.  The design notes and what bounds the kernel on the card are in
the source's header comment.  Its plain PyTorch version is
``ops.satd.satd_plain``.

The kernel is compiled with ``nvcc`` on first use and bound with
``ctypes`` (``ops.build``).  Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

NAME = "satd"
SIZES = (4, 8, 16, 32, 64)
_ENTRIES = {"thevc_satd": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}

# kernel launches made by satd(); a plain integer that a run resets and
# reads to show that its main path went through the kernel
launches = 0


def build() -> ctypes.CDLL:
    """Compile (if not built yet) and load the kernel library."""
    return _build.load(NAME, _ENTRIES)


def satd(org: torch.Tensor, preds: torch.Tensor,
         bit_increment: int) -> torch.Tensor:
    """Launch the kernel: int16 originals [N, s, s] and int16 candidates
    [N, M, s, s] on a CUDA device -> int32 SATDs [N, M].  Launches on the
    current stream without synchronising; raises on any input the kernel
    does not take and on a launch error."""
    global launches
    if org.device.type != "cuda":
        raise ValueError(f"the SATD kernel takes CUDA tensors, got "
                         f"{org.device}")
    if preds.dim() != 4 or preds.shape[2] != preds.shape[3] \
            or preds.shape[2] not in SIZES:
        raise ValueError(f"candidates must be [N, M, s, s] with s in "
                         f"{SIZES}, got {tuple(preds.shape)}")
    if not 0 <= bit_increment <= 30:
        raise ValueError(f"bit increment {bit_increment} out of range")
    n, m, s = (int(v) for v in preds.shape[:3])
    _build.check_tensor(org, "org", torch.int16, (n, s, s), org.device)
    _build.check_tensor(preds, "candidates", torch.int16, (n, m, s, s),
                        org.device)
    for t, name in ((org, "org"), (preds, "candidates")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    out = torch.empty((n, m), dtype=torch.int32, device=org.device)
    if n == 0 or m == 0:
        return out
    lib = build()
    with torch.cuda.device(org.device):
        rc = lib.thevc_satd(org.data_ptr(), preds.data_ptr(),
                            out.data_ptr(), n, m, s, bit_increment,
                            _build.stream_of(org.device))
    _build.check(lib, rc, "SATD kernel launch")
    launches += 1
    return out
