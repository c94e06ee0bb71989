"""Binding of the hand-written CUDA residual kernel (``csrc/residual.cu``).

Replaces the Pallas TPU kernel ``thevc_tpu/ops/jx_pallas.py:_kernel``
(:141-187), fused for 8x8 to 32x32 TUs with the coefficient-group unpack
``thevc_tpu/ops/jx.py:_unpack_cgs`` (:168-181): dequant + 2-D inverse
DCT/DST over a TU batch of one size class, int32-exact, with both
transform passes on the tensor cores.  The design notes and what bounds
the kernel on the card are in the source's header comment.  Its plain
PyTorch versions are ``ops.tq.residual_pipeline_plain`` (dense) and
``ops.tq.residual_pipeline_packed_plain`` (CG-packed).

The kernel is compiled with ``nvcc`` on first use and bound with
``ctypes`` (``ops.build``).  Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

NAME = "residual"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {"thevc_residual": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
            "thevc_residual_packed": [_P, _P, _I, _P, _P, _P, _I, _I, _I,
                                      _I, _P]}

# kernel launches made by residual() and residual_packed(), and by the
# replays of CUDA graphs that captured them (``replayed``); a plain
# integer that a run resets and reads to show that its main path went
# through the kernel
launches = 0
# launches recorded into a CUDA graph under capture: they run, and count,
# when the graph replays
captured = 0


def _count() -> None:
    global launches, captured
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1


def replayed(n: int) -> None:
    """Count ``n`` launches made by replays of CUDA graphs that captured
    this kernel (each replay launches it as often as it was captured)."""
    global launches
    launches += n


def build() -> ctypes.CDLL:
    """Compile (if not built yet) and load the kernel library."""
    return _build.load(NAME, _ENTRIES)


def _check_common(qp: torch.Tensor, basis: torch.Tensor, n: int, s: int,
                  device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"the residual kernel takes CUDA tensors, got "
                         f"{device}")
    _build.check_tensor(qp, "qp", torch.int32, (n,), device)
    _build.check_tensor(basis, "basis", torch.int32, (s, s), device)


def _check_aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def residual(x: torch.Tensor, qp: torch.Tensor, basis: torch.Tensor,
             dq_shift: int, sh2: int) -> torch.Tensor:
    """Launch the dense entry: int16 coefficients [N, s, s] on a CUDA
    device, per-TU int32 scaled QPs [N] (0..63) and the int32 basis
    [s, s] -> int16 residual [N, s, s].  Launches on the current stream
    without synchronising; raises on any input the kernel does not take
    and on a launch error."""
    if x.dim() != 3 or x.shape[1] != x.shape[2] \
            or x.shape[1] not in (4, 8, 16, 32) or x.shape[0] >= 2 ** 31:
        raise ValueError(f"coefficients must be [N, s, s] with s in "
                         f"4/8/16/32 and N < 2^31, got {tuple(x.shape)}")
    n, s = int(x.shape[0]), int(x.shape[1])
    _check_common(qp, basis, n, s, x.device)
    _build.check_tensor(x, "coefficients", torch.int16, (n, s, s), x.device)
    _check_aligned(x, "coefficients")
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = build()
    with torch.cuda.device(x.device):
        rc = lib.thevc_residual(x.data_ptr(), qp.data_ptr(),
                                basis.data_ptr(), out.data_ptr(), n, s,
                                dq_shift, sh2, _build.stream_of(x.device))
    _build.check(lib, rc, "residual kernel launch")
    _count()
    return out


def residual_packed(vals: torch.Tensor, idx: torch.Tensor, qp: torch.Tensor,
                    basis: torch.Tensor, size: int, dq_shift: int,
                    sh2: int) -> torch.Tensor:
    """Launch the CG-packed entry: coded 4x4 groups int16 [M, 16] (raster
    order within the group) with int32 indices [M] (``tu * ncg + cg_y *
    size/4 + cg_x``, ascending; rows at or past ``N * ncg`` are padding),
    per-TU int32 scaled QPs [N] (0..63) and the int32 basis [s, s] ->
    int16 residual [N, s, s], s in 8/16/32.  Launches on the current
    stream without synchronising; raises on any input the kernel does not
    take and on a launch error."""
    if size not in (8, 16, 32):
        raise ValueError(f"the packed entry takes sizes 8/16/32, got {size}")
    dev = vals.device
    n, m = int(qp.shape[0]), int(vals.shape[0])
    if n * (size // 4) ** 2 >= 2 ** 31 or m >= 2 ** 31:
        raise ValueError(f"{n} TUs of {size}x{size} or {m} groups: the CG "
                         f"indices must fit int32")
    _check_common(qp, basis, n, size, dev)
    _build.check_tensor(vals, "cg_vals", torch.int16, (m, 16), dev)
    _build.check_tensor(idx, "cg_idx", torch.int32, (m,), dev)
    _check_aligned(vals, "cg_vals")
    out = torch.empty((n, size, size), dtype=torch.int16, device=dev)
    if n == 0:
        return out
    lib = build()
    with torch.cuda.device(dev):
        rc = lib.thevc_residual_packed(
            vals.data_ptr(), idx.data_ptr(), m, qp.data_ptr(),
            basis.data_ptr(), out.data_ptr(), n, size, dq_shift, sh2,
            _build.stream_of(dev))
    _build.check(lib, rc, "residual kernel launch (packed)")
    _count()
    return out
