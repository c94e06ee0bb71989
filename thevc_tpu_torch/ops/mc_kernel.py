"""Binding of the hand-written CUDA motion-compensation kernel
(``csrc/mc.cu``).

Replaces the XLA functions ``thevc_tpu/ops/jx_mc.py:mc_batch`` (:77) and
``bi_avg_batch`` (:107), and the weighted paths of the JAX decoder's
``precompute_device`` (``thevc_tpu/decoder/inter.py:121-221``).  Three
entries: ``picture`` predicts every inter PU of a picture in one launch
(the decode), ``blocks`` predicts N blocks of one size and case (the P/B
fast-RD pass's winners), ``qpel`` the 49 quarter-pel candidates of N
blocks of one size (the P/B pass's quarter-pel refine).  The design notes
and what bounds the kernel on the card are in the source's header
comment.  Their plain PyTorch versions are ``ops.mc.mc_picture_plain``,
``ops.mc.mc_blocks_plain`` and ``ops.mc.mc_qpel_plain``.

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
_ENTRIES = {"thevc_mc_picture": [_P, _I, _I, _I, _P, _I, _P],
            "thevc_mc_blocks": [_P, _I, _I, _P, ctypes.c_longlong, _P, _I,
                                _I, _I, _I, _I, _I, _P],
            "thevc_mc_qpel": [_P, _I, _I, _P, ctypes.c_longlong, _P, _I, _I,
                              _P]}
TILE = 16            # the picture entry's output tile edge (csrc/mc.cu)
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

# kernel launches made by picture() and blocks(), and by qpel(); plain
# integers that a run resets and reads to show that its main path went
# through the kernel
launches = 0
qpel_launches = 0


def build() -> ctypes.CDLL:
    """Compile (if not built yet) and load the kernel library."""
    return _build.load(NAME, _ENTRIES)


def _check_bd(bd: int) -> None:
    if not 8 <= bd <= 12:
        raise ValueError(f"bit depth {bd} out of range 8..12")


def _tiles(jobs: np.ndarray) -> np.ndarray:
    """The picture entry's tiles: int32 [T, 3] of (job, first row, first
    column), TILE x TILE output samples (fewer at a job's edge) each."""
    ny = -(-jobs[:, J_H] // TILE)
    nx = -(-jobs[:, J_W] // TILE)
    per = ny * nx
    job = np.repeat(np.arange(len(jobs)), per)
    k = np.arange(int(per.sum())) - np.repeat(np.cumsum(per) - per, per)
    return np.stack([job, k // nx[job] * TILE, k % nx[job] * TILE],
                    axis=1).astype(np.int32)


def picture_table(jobs: np.ndarray, planes: list, size: int,
                  bd: int) -> tuple:
    """Check the picture entry's inputs (host jobs int32 [J, JOB_COLS],
    the reference planes, int16 [rows, cols] each, contiguous, on one
    CUDA device, that the jobs' plane fields index; the prediction's
    size; the bit depth) and build its device table on the host: the
    planes' (pointer low, pointer high, rows, columns), the jobs and
    their tiles, int32.  Returns (table, planes, jobs, tiles) counts
    with the table first.  Raises on any input the kernel does not
    take."""
    if not planes:
        raise ValueError("no reference planes")
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
    if not np.isin(jobs[:, J_KIND], range(len(KINDS))).all() \
            or not np.isin(jobs[:, J_LUMA], (0, 1)).all():
        raise ValueError("unknown job kind or component")
    n_lists = 1 + np.isin(jobs[:, J_KIND], (KINDS.index("bi"),
                                            KINDS.index("wbi")))
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
    tile = _tiles(jobs)
    table = np.concatenate([desc.astype(np.uint32).view(np.int32).ravel(),
                            jobs.ravel(), tile.ravel()])
    return table, len(planes), len(jobs), len(tile)


def launch_picture(table: torch.Tensor, n_planes: int, n_jobs: int,
                   n_tiles: int, pred: torch.Tensor, bd: int) -> None:
    """Launch the picture entry on the current stream over a device
    table of ``picture_table`` (its planes must still hold the samples
    its pointers name), writing the jobs' samples of ``pred`` (int16 on
    the table's device; the rest is left as it is).  Does not
    synchronise; raises on a launch error."""
    global launches
    _build.check_tensor(table, "table", torch.int32,
                        (4 * n_planes + JOB_COLS * n_jobs + 3 * n_tiles,),
                        table.device)
    _build.check_tensor(pred, "prediction", torch.int16, tuple(pred.shape),
                        table.device)
    if not n_tiles:
        return
    lib = build()
    with torch.cuda.device(table.device):
        rc = lib.thevc_mc_picture(table.data_ptr(), n_planes, n_jobs,
                                  n_tiles, pred.data_ptr(), bd,
                                  _build.stream_of(table.device))
    _build.check(lib, rc, "MC picture kernel launch")
    launches += 1


def picture(jobs: np.ndarray, planes: list, size: int,
            bd: int) -> torch.Tensor:
    """The picture entry: host jobs int32 [J, JOB_COLS] and the reference
    planes (int16 [rows, cols] each, contiguous, on one CUDA device) that
    the jobs' plane fields index -> the flat int16 prediction [size],
    zero outside the jobs.  Uploads the plane table, the jobs and their
    tiles in one copy and launches once on the current stream without
    synchronising; raises on any input the kernel does not take and on a
    launch error."""
    table, n_planes, n_jobs, n_tiles = picture_table(jobs, planes, size, bd)
    device = planes[0].device
    pred = torch.zeros(size, dtype=torch.int16, device=device)
    if n_tiles:
        stat_h2d(table.nbytes)
        launch_picture(torch.from_numpy(table).to(device), n_planes, n_jobs,
                       n_tiles, pred, bd)
    return pred


def blocks(planes: torch.Tensor, jobs: torch.Tensor, case: str, luma: bool,
           bd: int, bi: bool, out_h: int, out_w: int) -> torch.Tensor:
    """Launch the blocks entry: int16 planes [P, rows, cols] and int32
    jobs [N, 5] of (plane, window x, window y, fx, fy) on one CUDA device
    -> int16 [N, out_h, out_w], in pixels, or at 14 bits when ``bi``.
    The jobs' plane indices must lie in [0, P).  Launches on the current
    stream without synchronising; raises on any input the kernel does not
    take and on a launch error."""
    global launches
    device = planes.device
    if device.type != "cuda":
        raise ValueError(f"the MC kernel takes CUDA tensors, got {device}")
    if case not in CASES:
        raise ValueError(f"unknown MC case {case!r}")
    _check_bd(bd)
    if not (1 <= out_h <= 64 and 1 <= out_w <= 64):
        raise ValueError(f"block size {out_h}x{out_w} out of 1..64")
    if planes.dim() != 3:
        raise ValueError(f"planes must be [P, rows, cols], got "
                         f"{tuple(planes.shape)}")
    _build.check_tensor(planes, "planes", torch.int16, tuple(planes.shape),
                        device)
    n = int(jobs.shape[0]) if jobs.dim() == 2 else -1
    _build.check_tensor(jobs, "jobs", torch.int32, (n, BLOCK_JOB_COLS),
                        device)
    out = torch.empty((n, out_h, out_w), dtype=torch.int16, device=device)
    if n == 0:
        return out
    lib = build()
    with torch.cuda.device(device):
        rc = lib.thevc_mc_blocks(planes.data_ptr(), int(planes.shape[1]),
                                 int(planes.shape[2]), jobs.data_ptr(), n,
                                 out.data_ptr(), out_h, out_w,
                                 CASES.index(case), int(luma), int(bi), bd,
                                 _build.stream_of(device))
    _build.check(lib, rc, "MC blocks kernel launch")
    launches += 1
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
