"""Binding of the hand-written CUDA kernels of the fast-RD intra decision
pass's selection steps (``csrc/intra_select.cu``).

Three kernels, one entry each:

- ``select`` (``thevc_intra_select``, kernel A): one launch a decision
  pass, after the sweeps of every luma class up to the CTU size: per
  block the open-loop MPM, each mode's bits and SATD + bits cost, and
  the top 3 -> per class int32 modes [nb, 3] (ascending cost, ties to
  the lower mode) and their float32 bits [nb, 3]
  (``thevc_tpu/encoder/fast_intra.py:467-492``);
- ``pick`` (``thevc_intra_pick``, kernel B): one launch a decision
  pass, after the TU-RDs of every class's top 3: the RD pick of best,
  second and third -> per class int32 best, dist, mode2, mode3 and
  float32 bits [nb], and the chroma candidates' mode ids
  (``fast_intra.py:500-516, 580-583, 832-835``);
- ``dp`` (``thevc_intra_dp``, kernel C): one launch a frame, a CTA a
  CTU: the chroma pick of every chroma class, the bottom-up quadtree DP
  and the top-down expansion into the unit maps, with the P/B pass's
  inter leaves (``fast_intra.py:588-600, 613-775``).

Their plain PyTorch forms are ``encoder.fast_intra``'s
``intra_select_pass_plain`` and ``intra_pick_pass_plain`` (the per-class
``intra_select_plain`` and ``intra_pick_plain`` class by class) and
``intra_dp_plain``; every output equals them bit for bit.  The kernels
are compiled with ``nvcc`` on first use (with ``-fmad=false``) and bound
with ``ctypes`` (``ops.build``).  Every entry
checks its inputs and raises before anything is built; nothing here runs
when the module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

NAME = "intra_select"
SIZES = (4, 8, 16, 32, 64)
CTU_SIZES = (16, 32, 64)
MODES = 35
TOP_K = 3
CHROMA_CANDS = 5

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {"thevc_intra_select": [_P, _P], "thevc_intra_pick": [_P, _P],
            "thevc_intra_dp": [_P, _P]}

LUMA_FIELDS = ("mode", "dist", "bits", "mode2", "mode3")
CHROMA_FIELDS = ("ids", "dist", "bits")
INTER_FIELDS = ("rd", "mvx", "mvy", "ref", "dir", "mvx1", "mvy1", "ref1")


class _SelectClass(ctypes.Structure):
    _fields_ = [("satd", _P), ("best", _P), ("topk", _P), ("mbits", _P),
                ("nby", _I), ("nbx", _I), ("size", _I), ("first", _I)]


class SelectArgs(ctypes.Structure):
    """``SelectArgs`` of ``csrc/intra_select.cu``: the class table (4x4
    first; ``first`` is set by the entry), the mode-bit classes and
    sqrt-lambda, the class count and the CTU size."""
    _fields_ = [("cls", _SelectClass * 5), ("b0", _P), ("b12", _P),
                ("bo", _P), ("sqrt_lam", _P), ("classes", _I), ("ctu", _I)]


PICK_IN = ("topk", "mbits", "dist_k", "cbits_k")
PICK_OUT = ("best", "dist", "bits", "mode2", "mode3", "cids")


class _PickClass(ctypes.Structure):
    _fields_ = [(n, _P) for n in PICK_IN + PICK_OUT] + [
        ("nby", _I), ("nbx", _I), ("size", _I), ("first", _I)]


class PickArgs(ctypes.Structure):
    """``PickArgs`` of ``csrc/intra_select.cu``: the class table (4x4
    first), lambda and the class count."""
    _fields_ = [("cls", _PickClass * 5), ("lam", _P), ("classes", _I)]


class _Luma(ctypes.Structure):
    _fields_ = [(n, _P) for n in LUMA_FIELDS]


class _Chroma(ctypes.Structure):
    _fields_ = [(n, _P) for n in CHROMA_FIELDS]


class _Inter(ctypes.Structure):
    _fields_ = [(n, _P) for n in INTER_FIELDS]


class DpArgs(ctypes.Structure):
    """``DpArgs`` of ``csrc/intra_select.cu``: per class 4 << k its luma
    results, its chroma candidates (index 0: the NxN variant at 8) and
    its inter leaves, the scalars, the geometry and the output."""
    _fields_ = [("luma", _Luma * 5), ("chroma", _Chroma * 5),
                ("inter", _Inter * 5), ("lam", _P), ("clam", _P),
                ("cw", _P), ("bits_dm", _P), ("bits_oth", _P),
                ("intra_pen", ctypes.c_float), ("inter_kind", _I),
                ("inter_mask", _I), ("width", _I), ("height", _I),
                ("wp", _I), ("hp", _I), ("ctu", _I), ("max_sig", _I),
                ("min_tr_log2", _I), ("out", _P)]


# kernel launches made by each entry; plain integers that a run resets and
# reads to show that its main path went through the kernels
select_launches = 0
pick_launches = 0
dp_launches = 0


def build() -> ctypes.CDLL:
    """Compile (if not built yet) and load the kernel library."""
    return _build.load(NAME, _ENTRIES)


def _check_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the intra select kernels take CUDA tensors, "
                         f"{name} is on {t.device}")


def _check_scalar(t, name: str, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a 0-d float32 tensor, got "
                        f"{type(t).__name__}")
    _build.check_tensor(t, name, torch.float32, (), device)


def _check_classes(classes: dict, ctu_size: int, what: str) -> None:
    """Every luma class up to the CTU size, no other, each with a grid."""
    if ctu_size not in CTU_SIZES:
        raise ValueError(f"CTU size {ctu_size} not in {CTU_SIZES}")
    above = [s for s in classes if s in SIZES and s > ctu_size]
    if above:
        raise ValueError(f"{what}: class {above[0]} above the CTU size "
                         f"{ctu_size}")
    want = [s for s in SIZES if s <= ctu_size]
    if sorted(classes) != want:
        raise ValueError(f"{what}: classes {sorted(classes)}, expected "
                         f"{want}, every luma class up to CTU {ctu_size}")
    for s, v in classes.items():
        nby, nbx = v[-2:]
        if nby <= 0 or nbx <= 0:
            raise ValueError(f"{what}: class {s}'s block grid {nby}x{nbx} "
                             "is empty")


def _first_tensor(classes: dict) -> torch.Tensor:
    return classes[min(classes)][0]


def check_select(classes: dict, ctu_size: int, bits3: tuple,
                 sqrt_lam: torch.Tensor) -> None:
    """Raise on any input kernel A does not take (but a device that is
    not CUDA: the entry refuses that)."""
    _check_classes(classes, ctu_size, "select")
    dev = _first_tensor(classes).device
    for s, (satd, best, nby, nbx) in classes.items():
        nb = nby * nbx
        _build.check_tensor(satd, f"satd[{s}]", torch.int32, (nb, MODES),
                            dev)
        _build.check_tensor(best, f"best[{s}]", torch.int32, (nb,), dev)
        if satd.data_ptr() % 16:
            raise ValueError(f"satd[{s}] is not 16-byte aligned")
    if len(bits3) != 3:
        raise ValueError(f"{len(bits3)} mode-bit classes, expected 3")
    for name, t in zip(("b0", "b12", "bo", "sqrt_lam"), (*bits3, sqrt_lam)):
        _check_scalar(t, name, dev)


def select(classes: dict, ctu_size: int, bits3: tuple,
           sqrt_lam: torch.Tensor) -> dict:
    """Launch kernel A once over every luma class: ``classes[s]`` the
    sweep's int32 SATD [nby * nbx, 35] and SATD-best [nby * nbx] and the
    class's grid (nby, nbx), for each s up to ``ctu_size``; the mode-bit
    classes (b0, b12, bo) and sqrt-lambda (0-d float32, read on the
    device) -> {s: (int32 top-3 modes [nb, 3], float32 their bits [nb,
    3])}.  Launches on the current stream without synchronising; raises
    on any input the kernel does not take and on a launch error."""
    global select_launches
    check_select(classes, ctu_size, bits3, sqrt_lam)
    _check_cuda(_first_tensor(classes), "satd")
    dev = _first_tensor(classes).device
    sizes = sorted(classes)
    nbs = [classes[s][2] * classes[s][3] for s in sizes]
    topk = torch.empty((sum(nbs), TOP_K), dtype=torch.int32,
                       device=dev).split(nbs)
    mbits = torch.empty((sum(nbs), TOP_K), dtype=torch.float32,
                        device=dev).split(nbs)
    a = SelectArgs()
    for k, s in enumerate(sizes):
        satd, best, nby, nbx = classes[s]
        c = a.cls[k]
        c.satd, c.best = satd.data_ptr(), best.data_ptr()
        c.topk, c.mbits = topk[k].data_ptr(), mbits[k].data_ptr()
        c.nby, c.nbx, c.size = nby, nbx, s
    a.b0, a.b12, a.bo = (t.data_ptr() for t in bits3)
    a.sqrt_lam = sqrt_lam.data_ptr()
    a.classes, a.ctu = len(sizes), ctu_size
    lib = build()
    with torch.cuda.device(dev):
        rc = lib.thevc_intra_select(ctypes.addressof(a),
                                    _build.stream_of(dev))
    _build.check(lib, rc, "intra select kernel launch")
    select_launches += 1
    return {s: (topk[k], mbits[k]) for k, s in enumerate(sizes)}


def check_pick(classes: dict, ctu_size: int, lam: torch.Tensor) -> None:
    """Raise on any input kernel B does not take (but a device that is
    not CUDA)."""
    _check_classes(classes, ctu_size, "pick")
    nby, nbx = classes[4][-2:]
    if nby % 2 or nbx % 2:
        raise ValueError(f"a 4x4 grid of {nby}x{nbx}: the NxN variant's "
                         "8x8 blocks need an even grid")
    dev = _first_tensor(classes).device
    for s, (topk, mbits, dist_k, cbits_k, nby, nbx) in classes.items():
        nb = nby * nbx
        _build.check_tensor(topk, f"topk[{s}]", torch.int32, (nb, TOP_K),
                            dev)
        _build.check_tensor(mbits, f"mbits[{s}]", torch.float32,
                            (nb, TOP_K), dev)
        _build.check_tensor(dist_k, f"dist_k[{s}]", torch.int32,
                            (nb * TOP_K,), dev)
        _build.check_tensor(cbits_k, f"cbits_k[{s}]", torch.float32,
                            (nb * TOP_K,), dev)
    _check_scalar(lam, "lam", dev)


def pick(classes: dict, ctu_size: int, lam: torch.Tensor) -> dict:
    """Launch kernel B once over every luma class: ``classes[s]`` kernel
    A's modes and bits [nb, 3], the TU-RD estimates of those modes (int32
    dist, float32 bits [nb * 3]) and the class's grid (nby, nbx), for
    each s up to ``ctu_size``; lambda (0-d float32) -> {s: (int32 best,
    int32 dist, float32 bits, int32 mode2, int32 mode3, each [nb]; int32
    chroma candidate ids [nb, 5], for s = 4 the NxN variant's [nb / 4,
    5])}."""
    global pick_launches
    check_pick(classes, ctu_size, lam)
    _check_cuda(_first_tensor(classes), "topk")
    dev = _first_tensor(classes).device
    sizes = sorted(classes)
    nbs = [classes[s][4] * classes[s][5] for s in sizes]
    ncs = [nb if s >= 8 else nb // 4 for s, nb in zip(sizes, nbs)]
    # per class best, dist, mode2 and mode3 in one int32 buffer
    ints = torch.empty((4 * sum(nbs),), dtype=torch.int32,
                       device=dev).split([nb for nb in nbs for _ in range(4)])
    bits = torch.empty((sum(nbs),), dtype=torch.float32,
                       device=dev).split(nbs)
    cids = torch.empty((sum(ncs), CHROMA_CANDS), dtype=torch.int32,
                       device=dev).split(ncs)
    a = PickArgs()
    out = {}
    for k, s in enumerate(sizes):
        c = a.cls[k]
        for name, t in zip(PICK_IN, classes[s][:4]):
            setattr(c, name, t.data_ptr())
        best, dist, mode2, mode3 = ints[4 * k:4 * k + 4]
        fields = (best, dist, bits[k], mode2, mode3, cids[k])
        for name, t in zip(PICK_OUT, fields):
            setattr(c, name, t.data_ptr())
        c.nby, c.nbx, c.size = classes[s][4], classes[s][5], s
        out[s] = fields
    a.lam, a.classes = lam.data_ptr(), len(sizes)
    lib = build()
    with torch.cuda.device(dev):
        rc = lib.thevc_intra_pick(ctypes.addressof(a), _build.stream_of(dev))
    _build.check(lib, rc, "intra pick kernel launch")
    pick_launches += 1
    return out


def _check_chroma(c, name: str, nby: int, nbx: int, device) -> None:
    ids, dist, bits = c
    nb = nby * nbx
    _build.check_tensor(ids, f"{name} ids", torch.int32,
                        (nby, nbx, CHROMA_CANDS), device)
    _build.check_tensor(dist, f"{name} dist", torch.int32,
                        (2 * nb * CHROMA_CANDS,), device)
    _build.check_tensor(bits, f"{name} bits", torch.float32,
                        (2 * nb * CHROMA_CANDS,), device)


def check_dp(res: dict, cres: dict, cres8_nxn, width: int, height: int,
             lam: torch.Tensor, lam_w_bits2, max_sig: int, min_tr_log2: int,
             ctu_size: int, wp: int, hp: int, inter=None,
             intra_pen: float = 0.0) -> None:
    """Raise on any input kernel C does not take (but a device that is
    not CUDA)."""
    if ctu_size not in CTU_SIZES:
        raise ValueError(f"CTU size {ctu_size} not in {CTU_SIZES}")
    if wp <= 0 or hp <= 0 or wp % ctu_size or hp % ctu_size:
        raise ValueError(f"padded frame {wp}x{hp} is not a grid of "
                         f"{ctu_size} CTUs")
    if not (0 < width <= wp and 0 < height <= hp):
        raise ValueError(f"frame {width}x{height} outside its padded "
                         f"{wp}x{hp}")
    if not (0 <= max_sig <= 4 and 0 <= min_tr_log2 <= 5):
        raise ValueError(f"max_sig {max_sig} or min_tr_log2 {min_tr_log2} "
                         "out of range")
    dev = lam.device
    _check_scalar(lam, "lam", dev)
    classes = [s for s in SIZES if s <= ctu_size]
    if sorted(res) != classes or sorted(cres) != classes[1:]:
        raise ValueError(f"luma classes {sorted(res)} and chroma classes "
                         f"{sorted(cres)}, expected {classes} and "
                         f"{classes[1:]}")
    for s in classes:
        shape = (hp // s, wp // s)
        for name, t in zip(LUMA_FIELDS, res[s][:5]):
            _build.check_tensor(t, f"res[{s}].{name}",
                                torch.float32 if name == "bits"
                                else torch.int32, shape, dev)
    for s in classes[1:]:
        _check_chroma(cres[s], f"cres[{s}]", hp // s, wp // s, dev)
    _check_chroma(cres8_nxn, "cres8_nxn", hp // 8, wp // 8, dev)
    (bits_dm, bits_oth), clam, cw = lam_w_bits2
    for name, t in (("chroma lam", clam), ("cw", cw), ("bits_dm", bits_dm),
                    ("bits_oth", bits_oth)):
        _check_scalar(t, name, dev)
    if inter is None:
        return
    if not inter or not set(inter) <= set(classes[1:]):
        raise ValueError(f"inter classes {sorted(inter)} not among "
                         f"{classes[1:]}")
    n = {len(v) for v in inter.values()}
    if n != {4} and n != {8}:
        raise ValueError(f"inter leaves of {sorted(n)} fields: 4 (P) or 8 "
                         "(B)")
    for s, v in inter.items():
        for name, t in zip(INTER_FIELDS, v):
            _build.check_tensor(t, f"inter[{s}].{name}",
                                torch.float32 if name == "rd"
                                else torch.int32, (hp // s, wp // s), dev)


def dp(res: dict, cres: dict, cres8_nxn, width: int, height: int,
       lam: torch.Tensor, lam_w_bits2, max_sig: int, min_tr_log2: int,
       ctu_size: int, wp: int, hp: int, inter=None,
       intra_pen: float = 0.0) -> torch.Tensor:
    """Launch kernel C, one launch for the frame: ``res[s]`` each luma
    class's (mode, dist, bits, mode2, mode3) [hp / s, wp / s] (int32,
    bits float32); ``cres[s]`` each chroma class's (ids [nby, nbx, 5],
    int32 dist and float32 bits [2 * nb * 5] (Cb, then Cr)),
    ``cres8_nxn`` the NxN variant's at 8; ``lam`` and the frame's
    ``lam_w_bits2`` ((bits_dm, bits_oth), lambda, chroma weight) 0-d
    float32; ``inter`` None (I slices) or each inter class's
    (rd float32, mvx, mvy, ref) (P) or (rd, mvx0, mvy0, ref0, dir, mvx1,
    mvy1, ref1) (B), int32 -> the unit maps, int8 [6, hp/4, wp/4] or
    int16 [10 | 14, hp/4, wp/4] (``fast_intra.dp_expand_plain``'s)."""
    global dp_launches
    _check_cuda(lam, "lam")
    check_dp(res, cres, cres8_nxn, width, height, lam, lam_w_bits2, max_sig,
             min_tr_log2, ctu_size, wp, hp, inter, intra_pen)
    dev = lam.device
    kind = 0 if inter is None else 1 if len(next(iter(inter.values()))) == 4 \
        else 2
    out = torch.empty((6, hp // 4, wp // 4), dtype=torch.int8, device=dev) \
        if kind == 0 else torch.empty((10 if kind == 1 else 14, hp // 4,
                                       wp // 4), dtype=torch.int16,
                                      device=dev)
    a = DpArgs()
    mask = 0
    for k, s in enumerate(SIZES):
        if s > ctu_size:
            break
        for name, t in zip(LUMA_FIELDS, res[s][:5]):
            setattr(a.luma[k], name, t.data_ptr())
        c = cres8_nxn if s == 4 else cres[s]
        for name, t in zip(CHROMA_FIELDS, c):
            setattr(a.chroma[k], name, t.data_ptr())
        if inter is not None and s in inter:
            mask |= 1 << k
            for name, t in zip(INTER_FIELDS, inter[s]):
                setattr(a.inter[k], name, t.data_ptr())
    (bits_dm, bits_oth), clam, cw = lam_w_bits2
    a.lam, a.clam, a.cw = lam.data_ptr(), clam.data_ptr(), cw.data_ptr()
    a.bits_dm, a.bits_oth = bits_dm.data_ptr(), bits_oth.data_ptr()
    a.intra_pen = float(intra_pen)
    a.inter_kind, a.inter_mask = kind, mask
    a.width, a.height, a.wp, a.hp, a.ctu = width, height, wp, hp, ctu_size
    a.max_sig, a.min_tr_log2 = max_sig, min_tr_log2
    a.out = out.data_ptr()
    lib = build()
    with torch.cuda.device(dev):
        rc = lib.thevc_intra_dp(ctypes.addressof(a), _build.stream_of(dev))
    _build.check(lib, rc, "intra DP kernel launch")
    dp_launches += 1
    return out
