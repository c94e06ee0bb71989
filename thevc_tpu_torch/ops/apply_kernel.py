"""Binding of the hand-written CUDA kernel of the fast-RD device apply
(``csrc/apply.cu``): one persistent launch a frame.

Replaces the XLA function ``thevc_tpu/encoder/fast_apply.py:_class_step``
(:729, run per wave by ``_apply_body`` :818): for every item of a frame's
item list (a TU record on one plane: luma, Cb or Cr), the intra
prediction from the evolving recon plane, the forward transform, RDOQ or
plain quantisation, sign-bit hiding, dequant, inverse transform and
recon, written into the plane and into the record's level stack row.
CTAs take the items by ticket in list order; an item waits until the
units under its available range are flagged in its plane's ready map,
and flags its own units after its recon stores.  The design notes are in
the source's header comment.  The plain version of the launch is
``encoder.fast_apply.apply_items_plain``; ``encoder.fast_apply.
apply_items`` dispatches between the two.

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
# the size classes: (size, is_luma, use_dst)
CLASSES = ((4, True, True), (8, True, False), (16, True, False),
           (32, True, False), (4, False, False), (8, False, False),
           (16, False, False))
# an item: int32 [8]; ``kind`` is class | plane << 4 | real << 6 (plane 0
# luma, 1 Cb, 2 Cr; a padding row is not real), ``lv_off`` the element
# offset of its level stack row in the flat level buffer
ITEM_FIELDS = ("x", "y", "lo", "hi", "mode", "scan", "kind", "lv_off")
# the static tables of a class, then its RDOQ tables, in pointer order
TABLE_KEYS = ("basis", "plan", "scan", "rgt", "low")
EBT_KEYS = ("sig0p", "sig1p", "rlv", "one0", "one1", "abs0", "abs1", "cbf0",
            "cbf1")
# the length of the context-indexed bit tables (one0 .. cbf1)
CTX_PAD = 16
# items, state, ready, 3 recon planes, 3 source planes, levels, the two
# quant scale tables, then 14 pointers a class
N_PTRS = 12 + len(CLASSES) * (len(TABLE_KEYS) + len(EBT_KEYS))
# rec_h[3], rec_w[3], org_h[3], org_w[3], map_h, map_w, n_lv, qp[3],
# bit_inc, max_val, sign_hide, use_rdoq
N_INTS = 12 + 3 + 3 + 4
# lam[3], es[3][4], cgb[7][2][2]
N_FLOATS = 3 + 12 + 4 * len(CLASSES)
# the state's words: the next ticket, the error (ticket + 1 of an item
# whose wait timed out or whose inputs the kernel refused), items that
# waited
STATE_WORDS = 3
_P, _I = ctypes.c_void_p, ctypes.c_int
# thevc_apply_frame(ptrs, ints, floats, n_items, stream)
# thevc_apply_grid(int* grid)
_ENTRIES = {"thevc_apply_frame": [_P, _P, _P, _I, _P],
            "thevc_apply_grid": [_P]}

# kernel launches made by apply_frame(): a plain integer that a run
# resets and reads to show that its main path went through the kernel
launches = 0


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


def kind(ci: int, plane: int, real: bool) -> int:
    """An item's ``kind`` field."""
    return ci | plane << 4 | int(real) << 6


def check_items(items: np.ndarray, orgs_shapes, map_shape, n_lv: int,
                classes) -> None:
    """Raise on an item list (host int32 [n, 8]) the kernel does not
    take: an unknown class, a plane its class does not have, a level
    stack row past ``n_lv``, a real TU outside its source plane (shapes
    ``orgs_shapes``) or its ready map (``map_shape``, units of 4 luma or
    2 chroma samples) or not on its unit grid, an available range that
    is neither empty (1, 0) nor inside the reference line, a mode or scan
    out of range; ``classes`` are the classes the launch has tables for."""
    if not isinstance(items, np.ndarray) or items.dtype != np.int32 \
            or items.ndim != 2 or items.shape[1] != len(ITEM_FIELDS):
        raise ValueError("the item list is a host int32 [n, 8] array")
    if not len(items):
        return
    x, y, lo, hi, mode, scan, knd, lv_off = items.T
    ci, plane, real = knd & 15, (knd >> 4) & 3, (knd >> 6) & 1
    if (knd >> 7).any() or (ci >= len(CLASSES)).any():
        raise ValueError("an item of an unknown class")
    missing = set(np.unique(ci).tolist()) - set(classes)
    if missing:
        raise ValueError(f"items of classes {sorted(missing)} without their "
                         "tables")
    size = np.array([c[0] for c in CLASSES])[ci]
    luma = np.array([c[1] for c in CLASSES])[ci]
    if ((plane == 0) != luma).any() or (plane > 2).any():
        raise ValueError("an item on a plane its class does not have")
    if (lv_off < 0).any() or (lv_off.astype(np.int64) + size * size
                              > n_lv).any():
        raise ValueError(f"a level stack row outside the {n_lv} levels")
    if ((mode < 0) | (mode > 34) | (scan < 0) | (scan > 15)).any():
        raise ValueError("a mode or scan out of range")
    unit = np.where(luma, 4, 2)
    length = 4 * size + unit
    empty = (lo == 1) & (hi == 0)
    if (~empty & ((lo < 0) | (hi < lo) | (hi >= length))).any():
        raise ValueError("an available range outside the reference line")
    r = real == 1
    oh = np.array([s[0] for s in orgs_shapes])[plane]
    ow = np.array([s[1] for s in orgs_shapes])[plane]
    if (r & ((x < 0) | (y < 0) | (x + size > ow) | (y + size > oh)
             | (x % unit != 0) | (y % unit != 0)
             | ((x + size) // unit > map_shape[1])
             | ((y + size) // unit > map_shape[0]))).any():
        raise ValueError("a real TU outside its source plane or ready map")


def check_inputs(items, recs, orgs, lv, ready, state, tables, ebts, qps,
                 bit_inc, max_val) -> None:
    """Raise on any input tensor the kernel does not take: ``items`` int32
    [n, 8]; ``recs`` and ``orgs`` three int16 [H, W] planes each (Y, Cb,
    Cr; Cb and Cr alike); ``lv`` int16 [n_lv]; ``ready`` int32 [3, map_h,
    map_w]; ``state`` int32 [3]; ``tables`` {class: its static tables}
    (basis int32 [s, s], plan int32 [3, 33, s*s], scan int32 [3, s*s], rgt
    and low int32 [3, ncg], the quant scales int32 [6]) and, with RDOQ,
    ``ebts`` {class: its estBits} for the same classes (sig0p and sig1p
    float32 [3, 4, s*s], rlv [3, s*s], the six context tables [16], the
    sigCG bits 2x2), None without; scaled QPs in 0..63; bit increment
    0..4 and ``max_val`` its largest sample; every tensor contiguous and on the first recon plane's device.  The
    device's type and the items' values are not checked here
    (``check_items`` checks a host list)."""
    if len(recs) != 3 or len(orgs) != 3:
        raise ValueError("three recon and three source planes (Y, Cb, Cr)")
    device = recs[0].device
    for name, planes in (("recon", recs), ("source", orgs)):
        for j, t in enumerate(planes):
            if t.dim() != 2 or min(t.shape) < (1 if name == "recon" else 0) \
                    or t.shape[0] * t.shape[1] >= 2 ** 31:
                raise ValueError(f"{name} plane {j} must be [H, W] below 2^31 "
                                 f"samples, got {tuple(t.shape)}")
            _build.check_tensor(t, f"{name} plane {j}", torch.int16,
                                tuple(t.shape), device)
        if planes[1].shape != planes[2].shape:
            raise ValueError(f"the Cb and Cr {name} planes differ: "
                             f"{tuple(planes[1].shape)}, "
                             f"{tuple(planes[2].shape)}")
    if not isinstance(items, np.ndarray):
        if items.dim() != 2 or items.shape[1] != len(ITEM_FIELDS):
            raise ValueError("the items are int32 [n, 8]")
        _build.check_tensor(items, "items", torch.int32, tuple(items.shape),
                            device)
    if lv.dim() != 1 or not 0 < lv.numel() < 2 ** 31:
        raise ValueError("the level stacks are one int16 [n_lv] buffer")
    _build.check_tensor(lv, "level stacks", torch.int16, tuple(lv.shape),
                        device)
    if ready.dim() != 3 or ready.shape[0] != 3:
        raise ValueError("the ready maps are int32 [3, map_h, map_w]")
    _build.check_tensor(ready, "ready maps", torch.int32, tuple(ready.shape),
                        device)
    _build.check_tensor(state, "state", torch.int32, (STATE_WORDS,), device)
    if len(qps) != 3 or not all(0 <= int(q) <= 63 for q in qps):
        raise ValueError(f"scaled QPs {qps} out of range 0..63")
    if not 0 <= bit_inc <= 4 or max_val != (1 << (8 + bit_inc)) - 1:
        raise ValueError(f"bit increment {bit_inc} with largest sample "
                         f"{max_val}")
    for ci, tab in tables.items():
        if not isinstance(ci, int) or not 0 <= ci < len(CLASSES):
            raise ValueError(f"unknown class {ci!r}: the classes are "
                             f"{CLASSES}")
        size = CLASSES[ci][0]
        p = size * size
        ncg = p // 16
        for name, shape in (("basis", (size, size)), ("plan", (3, 33, p)),
                            ("scan", (3, p)), ("rgt", (3, ncg)),
                            ("low", (3, ncg)), ("quant_scales", (6,)),
                            ("inv_quant_scales", (6,))):
            _build.check_tensor(tab[name], name, torch.int32, shape, device)
        if ebts is None:
            continue
        if ci not in ebts:
            raise ValueError(f"RDOQ without the estBits of class {ci}")
        ebt = ebts[ci]
        for name, shape in (("sig0p", (3, 4, p)), ("sig1p", (3, 4, p)),
                            ("rlv", (3, p))):
            _build.check_tensor(ebt[name], name, torch.float32, shape, device)
        for name in EBT_KEYS[3:]:
            _build.check_tensor(ebt[name], name, torch.float32, (CTX_PAD,),
                                device)
        if np.shape(ebt["cg"]) != (2, 2):
            raise ValueError("the sigCG bits are 2x2")


def arguments(items, recs, orgs, lv, ready, state, tables, ebts, qps, lams,
              bit_inc, max_val, sign_hide) -> tuple:
    """The entry's pointer, int and float arrays (unchecked; ``apply_frame``
    checks)."""
    def ptr(t):
        return None if t is None else t.data_ptr()
    any_tab = next(iter(tables.values()), None)
    ptrs = [ptr(items), ptr(state), ptr(ready), *map(ptr, recs),
            *map(ptr, orgs), ptr(lv),
            None if any_tab is None else ptr(any_tab["quant_scales"]),
            None if any_tab is None else ptr(any_tab["inv_quant_scales"])]
    cgb = []
    for ci in range(len(CLASSES)):
        tab = tables.get(ci)
        ebt = None if ebts is None else ebts.get(ci)
        ptrs += [None if tab is None else ptr(tab[k]) for k in TABLE_KEYS]
        ptrs += [None if ebt is None else ptr(ebt[k]) for k in EBT_KEYS]
        cg = [[0, 0], [0, 0]] if ebt is None else ebt["cg"]
        cgb += [float(cg[x][b]) for x in (0, 1) for b in (0, 1)]
    ints = ([int(t.shape[0]) for t in recs] + [int(t.shape[1]) for t in recs]
            + [int(t.shape[0]) for t in orgs] + [int(t.shape[1]) for t in orgs]
            + [int(ready.shape[1]), int(ready.shape[2]), int(lv.numel())]
            + [int(q) for q in qps]
            + [int(bit_inc), int(max_val), int(bool(sign_hide)),
               int(ebts is not None)])
    floats = ([float(np.float32(m)) for m in lams]
              + [err_scale(int(q), s, bit_inc) for q in qps
                 for s in (4, 8, 16, 32)] + cgb)
    return ptrs, ints, floats


def grid() -> int:
    """The CTAs of one launch on the current CUDA device: as many as can
    be resident."""
    lib = build()
    out = ctypes.c_int(0)
    _build.check(lib, lib.thevc_apply_grid(ctypes.byref(out)),
                 "apply kernel occupancy")
    return out.value


def apply_frame(items, recs, orgs, lv, ready, state, tables, ebts, qps,
                lams, bit_inc, max_val, sign_hide) -> None:
    """Launch the frame kernel on a CUDA device, in place: every item of
    ``items`` (int32 [n, 8] in ticket order, each item's writers before
    it: a host array, checked by ``check_items`` and uploaded, or a tensor
    on the card, taken as it is) on its plane of ``recs`` (recon, with the
    guard)
    and ``orgs`` (source), its levels into ``lv``; ``ready`` the planes'
    ready maps (zeroed for a frame: an item waits for the units under its
    available range), ``state`` the kernel's three words (zeroed by the
    launch; after it, its error word and the items that waited), the
    classes' ``tables`` and with RDOQ their estBits ``ebts`` (None for the
    plain quantiser), scaled QPs and lambdas per plane, sign hiding if
    ``sign_hide``.  Launches on the current stream without synchronising;
    raises on any input the kernel does not take (``check_inputs``, before
    anything builds) and on a launch error.  A wait that never ends traps
    the launch (the next synchronisation raises)."""
    check_inputs(items, recs, orgs, lv, ready, state, tables, ebts, qps,
                 bit_inc, max_val)
    if isinstance(items, np.ndarray):
        check_items(items, [tuple(o.shape) for o in orgs],
                    tuple(ready.shape[1:]), lv.numel(), tables)
    device = recs[0].device
    if device.type != "cuda":
        raise ValueError(f"the apply kernel takes CUDA tensors, got "
                         f"{device}")
    if isinstance(items, np.ndarray):
        items = torch.from_numpy(np.ascontiguousarray(items)).to(device)
    ptrs, ints, floats = arguments(items, recs, orgs, lv, ready, state,
                                   tables, ebts, qps, lams, bit_inc, max_val,
                                   sign_hide)
    lib = build()
    with torch.cuda.device(device):
        rc = lib.thevc_apply_frame((ctypes.c_void_p * len(ptrs))(*ptrs),
                                   (ctypes.c_int * len(ints))(*ints),
                                   (ctypes.c_float * len(floats))(*floats),
                                   int(items.shape[0]),
                                   _build.stream_of(device))
    _build.check(lib, rc, "apply kernel launch")
    global launches
    launches += 1
