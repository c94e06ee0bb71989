"""Binding of the hand-written CUDA motion-compensation kernel
(``csrc/mc.cu``).

Replaces the XLA functions ``thevc_tpu/ops/jx_mc.py:mc_batch`` (:77) and
``bi_avg_batch`` (:107), and the weighted paths of the JAX decoder's
``precompute_device`` (``thevc_tpu/decoder/inter.py:121-221``).  Three
entries: ``picture`` predicts every inter PU of a picture in one launch
(the decode), ``blocks`` predicts N blocks of one size and case (Cb and
Cr in one launch, and a bi-prediction's two lists averaged in the
kernel), ``qpel`` the 49 quarter-pel candidates of N blocks of one size.
``blocks_fields`` and ``qpel_fields`` launch the same two kernels with
each block's job derived in the kernel from its MV and reference on a
size class's block grid: the P/B fast-RD pass's winners and quarter-pel
refine, with no job table built.
The design notes and what bounds the kernel on the card are in the
source's header comment.  Their plain PyTorch versions are
``ops.mc.mc_picture_plain``, ``ops.mc.mc_blocks_plain`` and
``ops.mc.mc_qpel_plain``, and for the field entries
``ops.mc.mc_blocks_fields_plain`` and ``mc_qpel_fields_plain``.

The kernel is compiled with ``nvcc`` on first use and bound with
``ctypes`` (``ops.build``).  Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build as _build
from .device import stat_h2d

NAME = "mc"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {"thevc_mc_picture": [_P, _I, _I, _I, _I, _P, _I, _P],
            "thevc_mc_blocks": [_P, _P, _I, _I, _I, _I, _P, _P,
                                ctypes.c_longlong, _P, _I, _I, _I, _I, _I,
                                _I, _I, _P],
            "thevc_mc_qpel": [_P, _I, _I, _P, ctypes.c_longlong, _P, _I, _I,
                              _P],
            "thevc_mc_blocks_fields": [_P, _P, _I, _I, _I, _I, _P, _P, _P,
                                       _P, _P, _P, ctypes.c_longlong, _I, _I,
                                       _P, _I, _I, _I, _I, _I, _P],
            "thevc_mc_qpel_fields": [_P, _I, _I, _P, _P, _P,
                                     ctypes.c_longlong, _I, _I, _P, _I, _I,
                                     _P]}
BLOCK_JOB_COLS = 5   # blocks(): (plane, window x, window y, fx, fy)
QPEL_SIZES = (8, 16, 32, 64)   # qpel(): block sizes
QPEL_CANDIDATES = 49           # qpel(): the 7x7 quarter-pel offsets

# the four filter cases, indexed by (frac_x != 0) + 2 * (frac_y != 0)
CASES = ("copy", "hor", "ver", "2d")
# the picture entry's job: one (PU, component), int32 fields: output
# height and width, luma (1) or chroma (0), kind (KINDS), destination
# origin and row stride in the flat prediction, the weights of list 0 and
# 1 (the uni weight first), the offset at the bit depth (both lists'
# summed for a bi job) and the log2 denominator; then per list (one for
# uni kinds, two for bi) the L_* fields: reference plane, window x and y
# (the first tap sample, in plane coordinates), fx, fy and the case
J_H, J_W, J_LUMA, J_KIND, J_DST, J_STRIDE, J_W0, J_W1, J_OFF, J_DEN, \
    J_LIST = range(11)
L_PLANE, L_WX, L_WY, L_FX, L_FY, L_CASE = range(6)
JOB_COLS = J_LIST + 2 * 6
# uni in pixels, bi average, weighted uni, weighted bi (the last three
# predict each list at 14 bits)
KINDS = ("uni", "bi", "wuni", "wbi")

# the picture entry reads the plane descriptors and the runs of equal band
# counts into shared memory (csrc/mc.cu kMaxPlanes, kMaxRuns)
MAX_PLANES = 96
MAX_RUNS = 64
# a warp's shared memory in the picture entry, int16 samples: two windows
# and a first pass of a band (csrc/mc.cu kPicWarpSmem)
PICTURE_WARP_SAMPLES = 3360
# what blocks() writes (csrc/mc.cu): pixels, 14 bits, the bi average
PIXELS, BITS14, AVERAGE = range(3)

# kernel launches made by picture(), by blocks() and by qpel(), one count
# a kernel; plain integers that a run resets and reads to show that its
# main path went through the kernel.  The field entries launch the blocks
# and quarter-pel kernels: blocks_fields() and qpel_fields() add to those
# counts and to their own, so that a run can show that it built no job
# table
launches = 0
blocks_launches = 0
qpel_launches = 0
blocks_field_launches = 0
qpel_field_launches = 0


def build() -> ctypes.CDLL:
    """Compile (if not built yet) and load the kernel library."""
    return _build.load(NAME, _ENTRIES)


def _check_bd(bd: int) -> None:
    if not 8 <= bd <= 12:
        raise ValueError(f"bit depth {bd} out of range 8..12")


def band_rows(jobs: np.ndarray) -> np.ndarray:
    """The output rows of a band of the picture entry (one warp's item) a
    job: at most 32 rows and 64 8-column groups (``csrc/mc.cu:band_rows``,
    which computes the same)."""
    h = jobs[:, J_H].astype(np.int64)
    return np.minimum(np.minimum(h, 32), 64 // ((jobs[:, J_W] + 7) // 8))


def picture_order(jobs: np.ndarray) -> tuple:
    """The picture entry's work over jobs [J, JOB_COLS]: (the jobs
    ordered by their count of bands, most first, then by component and
    size; per run of equal band counts (first item, first job, bands),
    int64 [R, 3]; the items, a band of a job each).  A warp finds its
    job and band from these runs (``csrc/mc.cu:mc_picture_kernel``)."""
    h = jobs[:, J_H].astype(np.int64)
    bands = -(-h // band_rows(jobs))
    # one sort key: bands (at most 64) descending, luma, rows, columns
    # (each 1..64); the order among jobs of one key does not matter
    key = ((((64 - bands) << 1 | jobs[:, J_LUMA]) << 7 | h) << 7
           | jobs[:, J_W])
    order = np.argsort(key)
    bands = bands[order]
    start = np.flatnonzero(np.diff(bands, prepend=-1))
    runs = np.stack([(np.cumsum(bands) - bands)[start], start, bands[start]],
                    axis=1)
    return jobs[order], runs, int(bands.sum())


def picture_table(jobs: np.ndarray, planes: list, size: int,
                  bd: int) -> tuple:
    """Check the picture entry's inputs (host jobs int32 [J, JOB_COLS],
    the reference planes, int16 [rows, cols] each, contiguous, on one
    CUDA device, that the jobs' plane fields index; the prediction's
    size; the bit depth) and build its device table on the host, int32:
    the planes' (pointer low, pointer high, rows, columns); the jobs and
    their runs of ``picture_order``.  Returns (table, planes, jobs, runs,
    items) with the table first, an item a band of a job.  Raises on any
    input the kernel does not take."""
    if not planes:
        raise ValueError("no reference planes")
    if len(planes) > MAX_PLANES:
        raise ValueError(f"{len(planes)} reference planes, at most "
                         f"{MAX_PLANES}")
    device = planes[0].device
    if device.type != "cuda":
        raise ValueError(f"the MC kernel takes CUDA tensors, got {device}")
    _check_bd(bd)
    for k, p in enumerate(planes):
        if p.dim() != 2:
            raise ValueError(f"plane {k} has shape {tuple(p.shape)}")
        _build.check_tensor(p, f"plane {k}", torch.int16, tuple(p.shape),
                            device)
    jobs = np.ascontiguousarray(jobs, np.int32)
    if jobs.ndim != 2 or jobs.shape[1] != JOB_COLS:
        raise ValueError(f"jobs must be [J, {JOB_COLS}], got {jobs.shape}")
    h, w = jobs[:, J_H], jobs[:, J_W]
    if len(jobs) and (h.min() < 1 or h.max() > 64 or w.min() < 1
                      or w.max() > 64):
        raise ValueError("job sizes out of 1..64")
    kind, luma = jobs[:, J_KIND], jobs[:, J_LUMA]
    if len(jobs) and (kind.min() < 0 or kind.max() >= len(KINDS)
                      or luma.min() < 0 or luma.max() > 1):
        raise ValueError("unknown job kind or component")
    n_lists = 1 + ((kind == KINDS.index("bi")) | (kind == KINDS.index("wbi")))
    for lst in (0, 1):
        sel = n_lists > lst
        col = J_LIST + lst * 6
        p, c = jobs[sel, col + L_PLANE], jobs[sel, col + L_CASE]
        if len(p) and (p.min() < 0 or p.max() >= len(planes)
                       or c.min() < 0 or c.max() >= len(CASES)):
            raise ValueError(f"list {lst}: plane or case out of range")
    first = jobs[:, J_DST].astype(np.int64)
    end = first + (h - 1).astype(np.int64) * jobs[:, J_STRIDE] + w
    if len(jobs) and (first.min() < 0 or end.max() > size
                      or (jobs[:, J_STRIDE] < w).any()):
        raise ValueError("a job writes outside the prediction buffer")
    desc = np.zeros((len(planes), 4), np.int64)
    for k, p in enumerate(planes):
        ptr = p.data_ptr()
        desc[k] = (ptr & 0xffffffff, ptr >> 32, p.shape[0], p.shape[1])
    jobs, runs, n_items = picture_order(jobs)
    table = np.concatenate([desc.astype(np.uint32).view(np.int32).ravel(),
                            jobs.ravel(), runs.astype(np.int32).ravel()])
    return table, len(planes), len(jobs), len(runs), n_items


def launch_picture(table: torch.Tensor, n_planes: int, n_jobs: int,
                   n_runs: int, n_items: int, pred: torch.Tensor,
                   bd: int) -> None:
    """Launch the picture entry on the current stream over a device
    table of ``picture_table`` (its planes must still hold the samples
    its pointers name), writing the jobs' samples of ``pred`` (int16 on
    the table's device; the rest is left as it is).  Does not
    synchronise; raises on a launch error."""
    global launches
    _build.check_tensor(table, "table", torch.int32,
                        (4 * n_planes + JOB_COLS * n_jobs + 3 * n_runs,),
                        table.device)
    _build.check_tensor(pred, "prediction", torch.int16, tuple(pred.shape),
                        table.device)
    if not n_items:
        return
    lib = build()
    with torch.cuda.device(table.device):
        rc = lib.thevc_mc_picture(table.data_ptr(), n_planes, n_jobs,
                                  n_runs, n_items, pred.data_ptr(), bd,
                                  _build.stream_of(table.device))
    _build.check(lib, rc, "MC picture kernel launch")
    launches += 1


def picture(jobs: np.ndarray, planes: list, size: int,
            bd: int) -> torch.Tensor:
    """The picture entry: host jobs int32 [J, JOB_COLS] and the reference
    planes (int16 [rows, cols] each, contiguous, on one CUDA device) that
    the jobs' plane fields index -> the flat int16 prediction [size],
    zero outside the jobs.  Uploads the plane table, the ordered jobs
    and their runs in one copy and launches once on the current stream
    without synchronising; raises on any input the kernel does not take
    and on a launch error."""
    table, *counts = picture_table(jobs, planes, size, bd)
    device = planes[0].device
    pred = torch.zeros(size, dtype=torch.int16, device=device)
    if counts[-1]:
        stat_h2d(table.nbytes)
        launch_picture(torch.from_numpy(table).to(device), *counts, pred, bd)
    return pred


def blocks(planes: torch.Tensor, jobs: torch.Tensor, case: str, luma: bool,
           bd: int, bi: bool, out_h: int, out_w: int, *, pair: bool = False,
           planes1: torch.Tensor | None = None,
           jobs1: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the blocks entry: int16 planes [P, rows, cols] and int32
    jobs [N, 5] of (plane, window x, window y, fx, fy) on one CUDA device
    -> int16 [N, out_h, out_w], in pixels, or at 14 bits when ``bi``.
    ``pair``: the planes stack two components (plane p and p + P / 2,
    Cb then Cr) and each job predicts both -> [2, N, out_h, out_w].
    ``planes1`` / ``jobs1`` (with ``bi``): list 1's planes (of the same
    rows and columns, stacked as ``planes``) and jobs [N, 5]; both lists
    are predicted at 14 bits and written as their bi average in pixels.
    The jobs' plane indices must lie in [0, P) ([0, P / 2) with
    ``pair``).  Launches on the current stream without synchronising;
    raises on any input the kernel does not take and on a launch
    error."""
    global blocks_launches
    device = planes.device
    if device.type != "cuda":
        raise ValueError(f"the MC kernel takes CUDA tensors, got {device}")
    if case not in CASES:
        raise ValueError(f"unknown MC case {case!r}")
    _check_bd(bd)
    if not (1 <= out_h <= 64 and 1 <= out_w <= 64):
        raise ValueError(f"block size {out_h}x{out_w} out of 1..64")
    if (planes1 is None) != (jobs1 is None) or (jobs1 is not None
                                                and not bi):
        raise ValueError("a second list takes planes1 and jobs1, with bi")
    n = int(jobs.shape[0]) if jobs.dim() == 2 else -1
    lists = [(planes, jobs)] + ([(planes1, jobs1)] if jobs1 is not None
                                else [])
    for k, (p, j) in enumerate(lists):
        if p.dim() != 3 or p.shape[1:] != planes.shape[1:] \
                or (pair and p.shape[0] % 2):
            raise ValueError(f"planes of list {k} must be [P, rows, cols]"
                             f"{' with P even' if pair else ''}, got "
                             f"{tuple(p.shape)}")
        _build.check_tensor(p, f"planes of list {k}", torch.int16,
                            tuple(p.shape), device)
        _build.check_tensor(j, f"jobs of list {k}", torch.int32,
                            (n, BLOCK_JOB_COLS), device)
    (p0, j0), (p1, j1) = lists[0], lists[-1]
    out = torch.empty(((2, n) if pair else (n,)) + (out_h, out_w),
                      dtype=torch.int16, device=device)
    if n == 0:
        return out
    mode = AVERAGE if jobs1 is not None else (BITS14 if bi else PIXELS)
    lib = build()
    with torch.cuda.device(device):
        rc = lib.thevc_mc_blocks(
            p0.data_ptr(), p1.data_ptr(), int(planes.shape[1]),
            int(planes.shape[2]), int(p0.shape[0]) // 2 if pair else 0,
            int(p1.shape[0]) // 2 if pair else 0, j0.data_ptr(),
            j1.data_ptr(), n, out.data_ptr(), out_h, out_w,
            CASES.index(case), int(luma), 2 if pair else 1, mode, bd,
            _build.stream_of(device))
    _build.check(lib, rc, "MC blocks kernel launch")
    blocks_launches += 1
    return out


def qpel(planes: torch.Tensor, origins: torch.Tensor, s: int,
         bd: int) -> torch.Tensor:
    """Launch the quarter-pel entry: int16 planes [P, rows, cols] and
    int32 origins [N, 3] of (plane, window x, window y), the first tap
    sample of each block's candidate (0, 0), on one CUDA device -> int16
    pixels [N, 49, s, s], candidate (qdy + 3) * 7 + qdx + 3 at quarter-pel
    offset (qdx, qdy).  The origins' plane indices must lie in [0, P).
    Launches on the current stream without synchronising; raises
    ``ValueError`` on any input the kernel does not take and
    ``RuntimeError`` on a launch error."""
    global qpel_launches
    device = planes.device
    if device.type != "cuda":
        raise ValueError(f"the MC kernel takes CUDA tensors, got {device}")
    if s not in QPEL_SIZES:
        raise ValueError(f"quarter-pel block size {s} not in {QPEL_SIZES}")
    _check_bd(bd)
    if planes.dim() != 3 or planes.dtype != torch.int16 \
            or not planes.is_contiguous():
        raise ValueError("planes must be contiguous int16 [P, rows, cols], "
                         f"got {planes.dtype} {tuple(planes.shape)}")
    if origins.device != device or origins.dtype != torch.int32 \
            or origins.dim() != 2 or origins.shape[1] != 3 \
            or not origins.is_contiguous():
        raise ValueError("origins must be contiguous int32 [N, 3] on "
                         f"{device}, got {origins.dtype} "
                         f"{tuple(origins.shape)} on {origins.device}")
    n = int(origins.shape[0])
    out = torch.empty((n, QPEL_CANDIDATES, s, s), dtype=torch.int16,
                      device=device)
    if n == 0:
        return out
    lib = build()
    with torch.cuda.device(device):
        rc = lib.thevc_mc_qpel(planes.data_ptr(), int(planes.shape[1]),
                               int(planes.shape[2]), origins.data_ptr(), n,
                               out.data_ptr(), s, bd,
                               _build.stream_of(device))
    _build.check(lib, rc, "MC quarter-pel kernel launch")
    qpel_launches += 1
    return out


def _check_fields(fields: tuple, name: str, dtype: torch.dtype, n: int,
                  device) -> None:
    """(ref, mvx, mvy) of n blocks: contiguous [n] of dtype each."""
    if len(fields) != 3:
        raise ValueError(f"{name} must be (ref, mvx, mvy)")
    for k, t in zip(("ref", "mvx", "mvy"), fields):
        _build.check_tensor(t, f"{name} {k}", dtype, (n,), device)


def check_fields(planes: torch.Tensor, fields: tuple, size: int, nbx: int,
                 pad: int, luma: bool, bd: int, *, pair: bool = False,
                 planes1: torch.Tensor | None = None,
                 fields1: tuple | None = None) -> None:
    """Raise on any input the blocks field entry does not take (but a
    device that is not CUDA): the planes int16 [P, rows, cols] (P even
    with ``pair``), per list (ref, mvx, mvy) int32 [n] each on the planes'
    device, contiguous, n a whole grid nbx blocks wide of size x size
    blocks (8..64 luma, 4..32 chroma), a padding the window offset keeps
    in the plane, bit depth 8..12."""
    device = planes.device
    _check_bd(bd)
    sizes = (8, 16, 32, 64) if luma else (4, 8, 16, 32)
    if size not in sizes:
        raise ValueError(f"block size {size} not in {sizes}")
    if (planes1 is None) != (fields1 is None):
        raise ValueError("a second list takes planes1 and fields1")
    if not 1 <= pad < 1 << 16:
        raise ValueError(f"padding {pad} out of 1..65535")
    if len(fields) != 3:
        raise ValueError("fields must be (ref, mvx, mvy)")
    n = int(fields[0].shape[0]) if fields[0].dim() == 1 else -1
    if nbx < 1 or n < 0 or n % nbx:
        raise ValueError(f"{n} blocks are not a grid {nbx} blocks wide")
    lists = [(planes, fields)] + ([(planes1, fields1)] if fields1 is not None
                                  else [])
    for k, (p, f) in enumerate(lists):
        if p.dim() != 3 or p.shape[1:] != planes.shape[1:] \
                or (pair and p.shape[0] % 2):
            raise ValueError(f"planes of list {k} must be [P, rows, cols]"
                             f"{' with P even' if pair else ''}, got "
                             f"{tuple(p.shape)}")
        _build.check_tensor(p, f"planes of list {k}", torch.int16,
                            tuple(p.shape), device)
        _check_fields(f, f"fields of list {k}", torch.int32, n, device)


def blocks_fields(planes: torch.Tensor, fields: tuple, size: int, nbx: int,
                  pad: int, luma: bool, bd: int, bi: bool, *,
                  pair: bool = False, planes1: torch.Tensor | None = None,
                  fields1: tuple | None = None) -> torch.Tensor:
    """Launch the blocks kernel on MV fields: per list each block's (ref,
    mvx, mvy), int32 [n] (quarter pel), block k at row k // nbx and column
    k % nbx of a grid of size x size blocks over planes padded by ``pad``
    (luma: the 8-tap filter at quarter-pel phases, window at (column *
    size + (mvx >> 2) + pad - 3, ...); chroma: 4 taps at eighth-pel
    phases, (mvx >> 3) + pad - 1) -> int16 [n, size, size] in pixels, at
    14 bits with ``bi``; ``pair`` and ``planes1`` / ``fields1`` as in
    ``blocks``.  Launches on the current stream without synchronising;
    raises on any input the kernel does not take and on a launch error."""
    global blocks_launches, blocks_field_launches
    device = planes.device
    if device.type != "cuda":
        raise ValueError(f"the MC kernel takes CUDA tensors, got {device}")
    check_fields(planes, fields, size, nbx, pad, luma, bd, pair=pair,
                 planes1=planes1, fields1=fields1)
    if fields1 is not None and not bi:
        raise ValueError("a second list averages at 14 bits: pass bi")
    n = int(fields[0].shape[0])
    (p0, f0) = (planes, fields)
    (p1, f1) = (planes1, fields1) if fields1 is not None else (planes,
                                                               fields)
    out = torch.empty(((2, n) if pair else (n,)) + (size, size),
                      dtype=torch.int16, device=device)
    if n == 0:
        return out
    mode = AVERAGE if fields1 is not None else (BITS14 if bi else PIXELS)
    lib = build()
    with torch.cuda.device(device):
        rc = lib.thevc_mc_blocks_fields(
            p0.data_ptr(), p1.data_ptr(), int(planes.shape[1]),
            int(planes.shape[2]), int(p0.shape[0]) // 2 if pair else 0,
            int(p1.shape[0]) // 2 if pair else 0,
            *(t.data_ptr() for t in f0), *(t.data_ptr() for t in f1), n,
            nbx, pad, out.data_ptr(), size, int(luma), 2 if pair else 1,
            mode, bd, _build.stream_of(device))
    _build.check(lib, rc, "MC blocks kernel launch (fields)")
    blocks_launches += 1
    blocks_field_launches += 1
    return out


def check_qpel_fields(planes: torch.Tensor, fields: tuple, s: int,
                      nbx: int, pad: int, bd: int) -> None:
    """Raise on any input the quarter-pel field entry does not take (but
    a device that is not CUDA): the planes int16 [P, rows, cols],
    contiguous; (ref, int_mx, int_my) int64 [n] each (the coarse search's
    reference and the refinement's winner, full pel) on their device, n a
    whole grid nbx blocks wide; s in QPEL_SIZES; bit depth 8..12."""
    if s not in QPEL_SIZES:
        raise ValueError(f"quarter-pel block size {s} not in {QPEL_SIZES}")
    _check_bd(bd)
    if planes.dim() != 3:
        raise ValueError(f"planes must be [P, rows, cols], got "
                         f"{tuple(planes.shape)}")
    _build.check_tensor(planes, "planes", torch.int16, tuple(planes.shape),
                        planes.device)
    if not 3 <= pad < 1 << 16:
        raise ValueError(f"padding {pad} out of 3..65535")
    if len(fields) != 3:
        raise ValueError("fields must be (ref, int_mx, int_my)")
    n = int(fields[0].shape[0]) if fields[0].dim() == 1 else -1
    if nbx < 1 or n < 0 or n % nbx:
        raise ValueError(f"{n} blocks are not a grid {nbx} blocks wide")
    _check_fields(fields, "fields", torch.int64, n, planes.device)


def qpel_fields(planes: torch.Tensor, fields: tuple, s: int, nbx: int,
                pad: int, bd: int) -> torch.Tensor:
    """Launch the quarter-pel kernel on MV fields: each block's (ref,
    int_mx, int_my), int64 [n] (full pel), block k at row k // nbx and
    column k % nbx of a grid of s x s blocks over planes padded by ``pad``,
    its candidate (0, 0)'s first tap sample at (column * s + int_mx + pad
    - 3, row * s + int_my + pad - 3) -> int16 pixels [n, 49, s, s], as
    ``qpel``.  Launches on the current stream without synchronising;
    raises ``ValueError`` on any input the kernel does not take and
    ``RuntimeError`` on a launch error."""
    global qpel_launches, qpel_field_launches
    device = planes.device
    if device.type != "cuda":
        raise ValueError(f"the MC kernel takes CUDA tensors, got {device}")
    check_qpel_fields(planes, fields, s, nbx, pad, bd)
    n = int(fields[0].shape[0])
    out = torch.empty((n, QPEL_CANDIDATES, s, s), dtype=torch.int16,
                      device=device)
    if n == 0:
        return out
    lib = build()
    with torch.cuda.device(device):
        rc = lib.thevc_mc_qpel_fields(
            planes.data_ptr(), int(planes.shape[1]), int(planes.shape[2]),
            *(t.data_ptr() for t in fields), n, nbx, pad, out.data_ptr(), s,
            bd, _build.stream_of(device))
    _build.check(lib, rc, "MC quarter-pel kernel launch (fields)")
    qpel_launches += 1
    qpel_field_launches += 1
    return out
