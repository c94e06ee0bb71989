"""Binding of the hand-written CUDA kernel of the fast-RD device apply's
class step (``csrc/apply.cu``).

Replaces the XLA function ``thevc_tpu/encoder/fast_apply.py:_class_step``
(:729, run per wave by ``_apply_body`` :818): for every record of one
size class's window, on its plane (Cb and Cr of a chroma class in the
same launch), the intra prediction from the evolving recon plane, the
forward transform, RDOQ or plain quantisation, sign-bit hiding, dequant,
inverse transform and recon, written into the plane and the record's
level stack row.  One launch a class step; the kernel reads its window's
start on the device (``starts[k]``) and advances ``k`` itself, so a
captured step is one kernel node of a CUDA graph.  The design notes are
in the source's header comment.  Its plain PyTorch version is
``encoder.fast_apply._class_step_plain``.

The kernel is compiled with ``nvcc`` on first use and bound with
``ctypes`` (``ops.build``).  Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..common import rom
from . import build as _build

NAME = "apply"
# the size classes a step runs: (size, is_luma, use_dst)
CLASSES = ((4, True, True), (8, True, False), (16, True, False),
           (32, True, False), (4, False, False), (8, False, False),
           (16, False, False))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# thevc_apply_step(pointers, size, luma, cap, n_planes, hgt, wid, qp0, qp1,
# bit_inc, max_val, lam0, lam1, es0, es1, sign_hide, use_rdoq, cgb00,
# cgb01, cgb10, cgb11, stream)
_ENTRIES = {"thevc_apply_step": [_P] + [_I] * 10 + [_F] * 4 + [_I] * 2
            + [_F] * 4 + [_P]}
# the RDOQ tables the kernel reads, in its pointer order
EBT_KEYS = ("sig0p", "sig1p", "rlv", "one0", "one1", "abs0", "abs1", "cbf0",
            "cbf1")
# the length of the context-indexed bit tables (one0 .. cbf1)
CTX_PAD = 16

# kernel launches made by class_step(), and by the replays of CUDA graphs
# that captured it (``replayed``); a plain integer that a run resets and
# reads to show that its main path went through the kernel
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


def err_scale(qp: int, size: int, bit_inc: int) -> float:
    """RDOQ's float32 error scale at scaled QP ``qp``, in the reference's
    order ((2^15 * 2^-2ts) / Q) / Q / 2^(2 bit_inc), as ``_rdoq_batch``
    computes it."""
    ts = 15 - (8 + bit_inc) - (size.bit_length() - 1)
    uiq = int(rom.QUANT_SCALES[qp % 6])
    return float(np.float32(1 << 15) * np.float32(2.0 ** (-2 * ts))
                 / np.float32(uiq) / np.float32(uiq)
                 / np.float32(1 << (2 * bit_inc)))


def check_inputs(ci, planes, records, starts, k, done, tables, ebt, cap,
                 bit_inc, max_val) -> tuple:
    """Raise on any input the kernel does not take: ``ci`` an index of
    ``CLASSES``; ``planes`` one (rec, lv, wins, qp, lam) for a luma class
    and two for a chroma one, each plane int16 [H, W] (both alike), its
    level stack and source windows int16 [n_flat, s, s] and its scaled QP
    in 0..63; the six record fields int64 [n_flat]; ``starts`` int64
    [n_waves]; ``k`` int64 [1]; ``done`` int32 [1]; the class's tables
    (``tables``: basis int32 [s, s], plan int32 [3, 33, s*s], scan int32
    [3, s*s], rgt and low int32 [3, ncg], the quant scales int32 [6]) and
    with RDOQ its estBits (``ebt``: sig0p and sig1p float32 [3, 4, s*s],
    rlv [3, s*s], the six context tables [16], the sigCG bits 2x2); a
    window of 1 to n_flat records (``cap``; each start plus ``cap`` must
    stay inside the records, which the kernel does not check); bit
    increment 0..4 and ``max_val`` its largest sample; every tensor
    contiguous and on the first plane's device.  The device's type is not
    checked here.  Returns (size, luma, n_flat)."""
    if not isinstance(ci, int) or not 0 <= ci < len(CLASSES):
        raise ValueError(f"unknown class {ci!r}: the classes are "
                         f"{CLASSES}")
    size, luma, _ = CLASSES[ci]
    if len(planes) != (1 if luma else 2):
        raise ValueError(f"class {CLASSES[ci]} takes {1 if luma else 2} "
                         f"planes, got {len(planes)}")
    if not 0 <= bit_inc <= 4 or max_val != (1 << (8 + bit_inc)) - 1:
        raise ValueError(f"bit increment {bit_inc} with largest sample "
                         f"{max_val}")
    rec0 = planes[0][0]
    device = rec0.device
    if rec0.dim() != 2 or min(rec0.shape) < 1 \
            or rec0.shape[0] * rec0.shape[1] >= 2 ** 31:
        raise ValueError(f"a recon plane must be [H, W] below 2^31 "
                         f"samples, got {tuple(rec0.shape)}")
    if len(records) != 6 or records[0].dim() != 1:
        raise ValueError("the records are six int64 [n_flat] fields")
    n_flat = int(records[0].shape[0])
    if not 1 <= cap <= n_flat:
        raise ValueError(f"a window of {cap} records in {n_flat}")
    p = size * size
    for j, (rec, lv, wins, qp, _lam) in enumerate(planes):
        _build.check_tensor(rec, f"plane {j}", torch.int16,
                            tuple(rec0.shape), device)
        _build.check_tensor(lv, f"level stack {j}", torch.int16,
                            (n_flat, size, size), device)
        _build.check_tensor(wins, f"source windows {j}", torch.int16,
                            (n_flat, size, size), device)
        if not 0 <= int(qp) <= 63:
            raise ValueError(f"scaled QP {qp} out of range 0..63")
    for j, t in enumerate(records):
        _build.check_tensor(t, f"record field {j}", torch.int64, (n_flat,),
                            device)
    if starts.dim() != 1:
        raise ValueError("starts must be [n_waves]")
    _build.check_tensor(starts, "starts", torch.int64, tuple(starts.shape),
                        device)
    _build.check_tensor(k, "wave counter", torch.int64, (1,), device)
    _build.check_tensor(done, "done count", torch.int32, (1,), device)
    ncg = p // 16
    for name, shape in (("basis", (size, size)), ("plan", (3, 33, p)),
                        ("scan", (3, p)), ("rgt", (3, ncg)),
                        ("low", (3, ncg)), ("quant_scales", (6,)),
                        ("inv_quant_scales", (6,))):
        _build.check_tensor(tables[name], name, torch.int32, shape, device)
    if ebt is not None:
        for name, shape in (("sig0p", (3, 4, p)), ("sig1p", (3, 4, p)),
                            ("rlv", (3, p))):
            _build.check_tensor(ebt[name], name, torch.float32, shape, device)
        for name in EBT_KEYS[3:]:
            _build.check_tensor(ebt[name], name, torch.float32, (CTX_PAD,),
                                device)
        if np.shape(ebt["cg"]) != (2, 2):
            raise ValueError("the sigCG bits are 2x2")
    return size, luma, n_flat


def arguments(ci, planes, records, starts, k, done, tables, ebt, cap,
              bit_inc, max_val, sign_hide) -> tuple:
    """The entry's pointer list and its scalar arguments after the
    pointers, before the stream (unchecked; ``class_step`` checks)."""
    size, luma, _ = CLASSES[ci]
    two = list(planes) + [(None, None, None, 0, 1.0)] * (2 - len(planes))

    def ptr(t):
        return None if t is None else t.data_ptr()
    ptrs = [ptr(t) for t in records] + [ptr(starts), ptr(k), ptr(done)]
    for rec, lv, wins, _qp, _lam in two:
        ptrs += [ptr(rec), ptr(lv), ptr(wins)]
    ptrs += [ptr(tables[n]) for n in ("basis", "plan", "scan", "rgt", "low",
                                      "quant_scales", "inv_quant_scales")]
    ptrs += [None if ebt is None else ptr(ebt[n]) for n in EBT_KEYS]
    cg = [[0, 0], [0, 0]] if ebt is None else ebt["cg"]
    rec0 = planes[0][0]
    qps = [int(q) for _r, _l, _w, q, _m in two]
    lams = [float(np.float32(m)) for _r, _l, _w, _q, m in two]
    scalars = [size, int(luma), int(cap), len(planes), int(rec0.shape[0]),
               int(rec0.shape[1]), qps[0], qps[1], int(bit_inc),
               int(max_val), lams[0], lams[1],
               err_scale(qps[0], size, bit_inc),
               err_scale(qps[1], size, bit_inc), int(bool(sign_hide)),
               int(ebt is not None), float(cg[0][0]), float(cg[0][1]),
               float(cg[1][0]), float(cg[1][1])]
    return ptrs, scalars


def class_step(ci, planes, records, starts, k, done, tables, ebt, cap,
               bit_inc, max_val, sign_hide) -> None:
    """Launch one class step on a CUDA device, in place: the window of
    ``cap`` records from ``starts[k]`` of class ``ci``, on each plane of
    ``planes`` ((rec, lv, wins, scaled qp, lambda); Cb and Cr of a chroma
    class in the one launch), RDOQ with the estBits ``ebt`` (None for the
    plain quantiser), sign hiding if ``sign_hide``; ``k`` advances by one
    on the device.  Launches on the current stream without synchronising;
    raises on any input the kernel does not take (``check_inputs``, before
    anything builds) and on a launch error."""
    check_inputs(ci, planes, records, starts, k, done, tables, ebt, cap,
                 bit_inc, max_val)
    device = planes[0][0].device
    if device.type != "cuda":
        raise ValueError(f"the apply kernel takes CUDA tensors, got "
                         f"{device}")
    ptrs, scalars = arguments(ci, planes, records, starts, k, done, tables,
                              ebt, cap, bit_inc, max_val, sign_hide)
    lib = build()
    with torch.cuda.device(device):
        rc = lib.thevc_apply_step((ctypes.c_void_p * len(ptrs))(*ptrs),
                                  *scalars, _build.stream_of(device))
    _build.check(lib, rc, "apply kernel launch")
    _count()
