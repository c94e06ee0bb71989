"""Binding of the hand-written CUDA kernels of the fast-RD intra decision
pass (``csrc/intra_rd.cu``).

Two kernels, three entries:

- ``sweep`` (``thevc_intra_sweep``, kernel A): the 35-mode intra
  prediction and Hadamard SATD of every block of one luma size class,
  read from the padded source plane -> int32 SATD [nb, 35] and each
  block's first-minimum mode.  It replaces the prediction stack and the
  SATD of the size pass (``thevc_tpu/encoder/fast_intra.py:404``
  ``_size_pass_impl``, whose SATD is the Pallas kernel
  ``thevc_tpu/ops/jx_pallas.py:_satd_kernel``).
- ``tu_rd_given`` and ``tu_rd_intra`` (``thevc_tu_rd_given``,
  ``thevc_tu_rd_intra``, kernel B): the transform-RD estimate of a batch
  of TUs (``fast_intra.py:338`` ``_tq_rd`` with K5's forward transform and
  quant, ``ops/jx.py:62, 113``, and K1's dequant + inverse,
  ``jx_pallas.py:141``) -> int32 dist [N], float32 bits [N].  The given
  entry reads each item's prediction from a tensor; the intra entry
  predicts one mode of one block itself from the padded plane (luma, or
  Cb and Cr in one launch).

Both are bound by their operations.  The sweep builds each (block,
mode)'s reference array once in shared memory, predicts two runs of four
samples a lane with float FMAs, and takes the Hadamard on the int8 tensor
cores (butterflies by shuffles above bit increment 4); the TU-RD kernel
runs all four transform passes on the int8 tensor cores, a 16x16 region
or a 32x32 TU a warp.  The design and the exactness argument of every
split are in the source's header comment.  Their plain PyTorch forms are
``encoder.fast_intra.intra_sweep_plain``, ``tu_rd_modes_plain`` and
``_tq_rd``; every output equals them bit for bit.

The kernels are compiled with ``nvcc`` on first use and bound with
``ctypes`` (``ops.build``).  Every entry checks its inputs and raises
before anything is built; nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

NAME = "intra_rd"
SWEEP_SIZES = (4, 8, 16, 32, 64)
# _tq_rd's sizes: one TU a block, or 64 = four 32x32 and -32 = four 16x16
# quadrant TUs
RD_SIZES = (4, 8, 16, 32, 64, -32)
# the chroma blocks of the decision passes (4:2:0, CTUs up to 64): 4..16,
# and 32 as four 16x16 TUs
CHROMA_RD_SIZES = (4, 8, 16, -32)
LEVEL_BITS_LEN = 32769
MAX_BIT_INC = 8
# the largest sample of an int16 plane; at a bit increment b the kernels
# take samples up to max_val_limit(b), below 256 << b: the sweep's operand
# forms and the forward first pass's int16 bound rest on it
MAX_VAL = 32767

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENTRIES = {
    "thevc_intra_sweep": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "thevc_tu_rd_given": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P, _P,
                          _P],
    "thevc_tu_rd_intra": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                          _I, _I, _I, _I, _P, _P, _P],
}

# kernel launches made by each entry; plain integers that a run resets and
# reads to show that its main path went through the kernels
sweep_launches = 0
tu_rd_given_launches = 0
tu_rd_intra_launches = 0


def tu_rd_launches() -> int:
    """Kernel B's launches, both entries."""
    return tu_rd_given_launches + tu_rd_intra_launches


def build() -> ctypes.CDLL:
    """Compile (if not built yet) and load the kernel library."""
    return _build.load(NAME, _ENTRIES)


def max_val_limit(bit_increment: int) -> int:
    """The largest max_val the kernels take at ``bit_increment``: that of
    the bit depth 8 + bit_increment, and at most that of an int16 plane."""
    return min((256 << bit_increment) - 1, MAX_VAL)


def _check_common(bit_increment: int, max_val: int) -> None:
    if not 0 <= bit_increment <= MAX_BIT_INC:
        raise ValueError(f"bit increment {bit_increment} out of 0.."
                         f"{MAX_BIT_INC}")
    top = max_val_limit(bit_increment)
    if not 0 < max_val <= top:
        raise ValueError(f"max_val {max_val} out of 1..{top} (samples of "
                         f"{8 + bit_increment} bits in int16 planes)")


def _check_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the intra RD kernels take CUDA tensors, {name} "
                         f"is on {t.device}")


def check_plane(plane: torch.Tensor, name: str, size: int, nby: int,
                nbx: int) -> None:
    """Raise unless ``plane`` is a contiguous int16 [H, W] plane in
    which every block of the ``nby`` x ``nbx`` grid of ``size`` finds its
    source samples and its 2 * size + 1 reference samples above and left
    (the decision pass's padding: one row and column on the top and left,
    at least one block on the bottom and right).  The device's type is
    not checked here."""
    if plane.dim() != 2:
        raise ValueError(f"{name} must be [H, W], got {tuple(plane.shape)}")
    _build.check_tensor(plane, name, torch.int16, tuple(plane.shape),
                        plane.device)
    h, w = (int(v) for v in plane.shape)
    if nby <= 0 or nbx <= 0:
        raise ValueError(f"block grid {nby}x{nbx} is empty")
    if nby * size + size + 1 > h or nbx * size + size + 1 > w:
        raise ValueError(
            f"{name} {h}x{w} is too small for {nby}x{nbx} blocks of "
            f"{size}: their reference lines need "
            f"{nby * size + size + 1}x{nbx * size + size + 1}")


def check_sweep(plane: torch.Tensor, size: int, nby: int, nbx: int,
                bit_increment: int, max_val: int) -> None:
    """Raise on any input the sweep kernel does not take (but a device
    that is not CUDA: the entry refuses that)."""
    if size not in SWEEP_SIZES:
        raise ValueError(f"size {size} not in {SWEEP_SIZES}")
    _check_common(bit_increment, max_val)
    check_plane(plane, "plane", size, nby, nbx)


def sweep(plane: torch.Tensor, size: int, nby: int, nbx: int,
          bit_increment: int, max_val: int) -> tuple:
    """Launch kernel A on the padded int16 luma plane: -> (int32 SATD
    [nby * nbx, 35] in the order planar, DC, 2..34; int32 first-minimum
    mode [nby * nbx]).  Launches on the current stream without
    synchronising; raises on any input the kernel does not take and on a
    launch error."""
    global sweep_launches
    _check_cuda(plane, "plane")
    check_sweep(plane, size, nby, nbx, bit_increment, max_val)
    nb = nby * nbx
    out = torch.empty((nb, 35), dtype=torch.int32, device=plane.device)
    best = torch.empty((nb,), dtype=torch.int32, device=plane.device)
    lib = build()
    with torch.cuda.device(plane.device):
        rc = lib.thevc_intra_sweep(
            plane.data_ptr(), int(plane.shape[0]), int(plane.shape[1]),
            size, nby, nbx, bit_increment, max_val, out.data_ptr(),
            best.data_ptr(), _build.stream_of(plane.device))
    _build.check(lib, rc, "intra sweep kernel launch")
    sweep_launches += 1
    return out, best


def _check_tables(basis: torch.Tensor, level_bits: torch.Tensor,
                  tsize: int, device: torch.device) -> None:
    _build.check_tensor(basis, "basis", torch.int32, (tsize, tsize), device)
    _build.check_tensor(level_bits, "level_bits", torch.int32,
                        (LEVEL_BITS_LEN,), device)


def transform_size(size: int) -> int:
    """The TU size of a ``_tq_rd`` size (64 -> 32, -32 -> 16)."""
    return 32 if size == 64 else 16 if size == -32 else size


def check_given(org: torch.Tensor, pred: torch.Tensor, qp: torch.Tensor,
                basis: torch.Tensor, level_bits: torch.Tensor, size: int,
                bit_increment: int, max_val: int) -> None:
    """Raise on any input the given-prediction entry does not take (but a
    device that is not CUDA)."""
    if size not in RD_SIZES:
        raise ValueError(f"size {size} not in {RD_SIZES}")
    _check_common(bit_increment, max_val)
    s = abs(size)
    if org.dim() != 3:
        raise ValueError(f"org must be [N, s, s], got {tuple(org.shape)}")
    n = int(org.shape[0])
    _build.check_tensor(org, "org", torch.int16, (n, s, s), org.device)
    _build.check_tensor(pred, "pred", torch.int16, (n, s, s), org.device)
    _build.check_tensor(qp, "qp", torch.int32, (n,), org.device)
    _check_tables(basis, level_bits, transform_size(size), org.device)


def tu_rd_given(org: torch.Tensor, pred: torch.Tensor, qp: torch.Tensor,
                basis: torch.Tensor, level_bits: torch.Tensor, size: int,
                is_intra: bool, bit_increment: int, max_val: int) -> tuple:
    """Launch kernel B on given predictions: int16 org and pred [N, s, s]
    (s = |size|), int32 scaled QPs [N], the TU basis int32 [t, t] and the
    level-bit table in 2^-23 units int32 [32769] -> (int32 dist [N],
    float32 bits [N]).  org and pred hold samples in 0..max_val."""
    global tu_rd_given_launches
    _check_cuda(org, "org")
    check_given(org, pred, qp, basis, level_bits, size, bit_increment,
                max_val)
    n = int(org.shape[0])
    dist = torch.empty((n,), dtype=torch.int32, device=org.device)
    bits = torch.empty((n,), dtype=torch.float32, device=org.device)
    if n == 0:
        return dist, bits
    lib = build()
    with torch.cuda.device(org.device):
        rc = lib.thevc_tu_rd_given(
            org.data_ptr(), pred.data_ptr(), qp.data_ptr(),
            basis.data_ptr(), level_bits.data_ptr(), n, size,
            int(bool(is_intra)), bit_increment, max_val, dist.data_ptr(),
            bits.data_ptr(), _build.stream_of(org.device))
    _build.check(lib, rc, "TU RD kernel launch")
    tu_rd_given_launches += 1
    return dist, bits


def check_intra(planes: tuple, modes: torch.Tensor, qp: torch.Tensor,
                basis: torch.Tensor, level_bits: torch.Tensor, size: int,
                nby: int, nbx: int, bit_increment: int,
                max_val: int) -> None:
    """Raise on any input the intra entry does not take (but a device
    that is not CUDA)."""
    if size not in RD_SIZES:
        raise ValueError(f"size {size} not in {RD_SIZES}")
    _check_common(bit_increment, max_val)
    if not 1 <= len(planes) <= 2:
        raise ValueError(f"{len(planes)} planes: one (luma) or two (Cb, "
                         "Cr)")
    for i, p in enumerate(planes):
        check_plane(p, f"plane {i}", abs(size), nby, nbx)
        if p.shape != planes[0].shape or p.device != planes[0].device:
            raise ValueError("the planes differ in shape or device")
    dev = planes[0].device
    if modes.dim() != 2 or int(modes.shape[0]) != nby * nbx:
        raise ValueError(f"modes must be [{nby * nbx}, k], got "
                         f"{tuple(modes.shape)}")
    k = int(modes.shape[1])
    _build.check_tensor(modes, "modes", torch.int32, (nby * nbx, k), dev)
    _build.check_tensor(qp, "qp", torch.int32, (len(planes) * nby * nbx * k,),
                        dev)
    _check_tables(basis, level_bits, transform_size(size), dev)


def tu_rd_intra(planes: tuple, modes: torch.Tensor, qp: torch.Tensor,
                basis: torch.Tensor, level_bits: torch.Tensor, size: int,
                nby: int, nbx: int, luma: bool, bit_increment: int,
                max_val: int) -> tuple:
    """Launch kernel B predicting each item itself: the padded int16
    planes (one luma plane, or the Cb and Cr planes), int32 mode ids
    [nby * nbx, k] of each block (the same on every plane), int32 scaled
    QPs [planes * nby * nbx * k] -> (int32 dist, float32 bits), both in
    (plane, block, mode) order."""
    global tu_rd_intra_launches
    for i, p in enumerate(planes):
        _check_cuda(p, f"plane {i}")
    if not luma and size not in CHROMA_RD_SIZES:
        raise ValueError(f"chroma size {size} not in {CHROMA_RD_SIZES}")
    check_intra(planes, modes, qp, basis, level_bits, size, nby, nbx,
                bit_increment, max_val)
    n = int(qp.shape[0])
    dev = planes[0].device
    dist = torch.empty((n,), dtype=torch.int32, device=dev)
    bits = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return dist, bits
    lib = build()
    p1 = planes[1] if len(planes) == 2 else planes[0]
    with torch.cuda.device(dev):
        rc = lib.thevc_tu_rd_intra(
            planes[0].data_ptr(), p1.data_ptr(), int(planes[0].shape[0]),
            int(planes[0].shape[1]), nby, nbx, int(modes.shape[1]),
            len(planes), modes.data_ptr(), qp.data_ptr(), basis.data_ptr(),
            level_bits.data_ptr(), size, int(bool(luma)), bit_increment,
            max_val, dist.data_ptr(), bits.data_ptr(),
            _build.stream_of(dev))
    _build.check(lib, rc, "TU RD kernel launch")
    tu_rd_intra_launches += 1
    return dist, bits
