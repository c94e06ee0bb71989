"""Motion-compensation interpolation in PyTorch over PU batches.

Counterpart of ``thevc_tpu/ops/jx_mc.py``: ``_copy_batch`` (:35),
``_filter_1d_batch`` (:44), ``mc_batch`` (:77) and ``bi_avg_batch``
(:107), with HM's int16 (``Short``) intermediate wrap, and the explicit
weighted prediction of ``thevc_tpu/decoder/inter.py`` (``_weight_uni``,
``_weight_bi``, :46-69) over PU batches.  Also the device
window gather that replaces the host ``np.stack`` of per-PU slices of
``Picture.padded()`` (``thevc_tpu/decoder/inter.py:149-182``).

Three entries serve the codec, named after the hand-written kernel's
(``csrc/mc.cu``, ``ops.mc_kernel``):

- ``mc_picture``: every inter PU of a picture from a host job table
  (``mc_kernel.JOB_COLS`` fields a (PU, component), both lists of a bi
  PU in one job) into the picture's flat prediction buffer;
- ``mc_blocks``: N blocks of one size and case from a stacked plane
  tensor, for the encoder's P/B decision pass (Cb and Cr of the same
  jobs in one call, and a bi-prediction's two lists averaged in it);
- ``mc_qpel``: the 49 quarter-pel candidates of N blocks of one size
  from a stacked plane tensor, for that pass's quarter-pel refine;
- ``mc_blocks_fields`` and ``mc_qpel_fields``: the same two on the
  blocks of a size class's grid at their MVs, each block's job or origin
  derived from its MV (``field_jobs``, ``qpel_origins``), for the P/B
  pass, which so builds no job table on the card.

Each dispatches on the device of its planes: a CUDA tensor launches the
kernel (and raises if it cannot launch), a CPU tensor runs the plain
version in this module (``mc_picture_plain``, ``mc_blocks_plain``,
``mc_qpel_plain``, ``mc_blocks_fields_plain``, ``mc_qpel_fields_plain``),
built from the per-class functions below.  The plain
versions run on the card too, where the tests and ``chip_smoke.py`` hold
the kernel against them.  In the plain form the tap vector is gathered per PU
(``coeff[frac]``), an int32 multiply and sum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.tables import from_reference
from . import mc_kernel
from .interp import IF_FILTER_PREC, IF_INTERNAL_OFFS, IF_INTERNAL_PREC
from .mc_kernel import CASES, J_DEN, J_DST, J_H, J_KIND, J_LIST, J_LUMA, \
    J_OFF, J_STRIDE, J_W, J_W0, J_W1, JOB_COLS, KINDS, L_CASE, L_FX, \
    L_FY, L_PLANE, L_WX, L_WY

# mc_batch calls, one per MC class of the plain versions; a plain integer
# that a run resets and reads to show which path ran (0 on a card's run)
launches = 0


def window_shape(case: str, luma: bool, out_h: int, out_w: int):
    """(rows, cols) of the window a case reads for an out_h x out_w
    block: the taps' extra rows or columns where that direction filters."""
    extra = 7 if luma else 3
    return (out_h + extra * (case in ("ver", "2d")),
            out_w + extra * (case in ("hor", "2d")))


def gather_windows(planes: torch.Tensor, plane_idx: torch.Tensor,
                   x0: torch.Tensor, y0: torch.Tensor, rows: int,
                   cols: int) -> torch.Tensor:
    """Read windows [N, rows, cols] as int16 from planes [P, H, W].

    plane_idx, x0, y0: integer tensors [N] on the planes' device; (x0,
    y0) is the window's top-left sample in plane coordinates and may lie
    outside the plane.  Coordinates are clamped to the plane, which reads
    what ``Picture.padded()`` (edge extension) holds there, as long as
    the window lies inside the pad margin (``clip_mv`` keeps it so)."""
    n_planes, h, w = planes.shape
    dev = planes.device
    ys = (y0.long()[:, None] + torch.arange(rows, device=dev)).clamp(0, h - 1)
    xs = (x0.long()[:, None] + torch.arange(cols, device=dev)).clamp(0, w - 1)
    idx = ((plane_idx.long()[:, None, None] * h + ys[:, :, None]) * w
           + xs[:, None, :])
    return planes.reshape(n_planes * h * w)[idx].to(torch.int16)


def _copy_batch(src: torch.Tensor, bd: int, is_last: bool) -> torch.Tensor:
    """filterCopy (first pass): [N, h, w] int16 pixels -> int16."""
    if is_last:
        return src.to(torch.int16)
    shift = IF_INTERNAL_PREC - bd
    return ((src.to(torch.int32) << shift) - IF_INTERNAL_OFFS).to(torch.int16)


def _filter_1d_batch(src: torch.Tensor, coeff: torch.Tensor, vertical: bool,
                     bd: int, is_first: bool, is_last: bool, out_h: int,
                     out_w: int) -> torch.Tensor:
    """filter<N>: src [N, H, W] int16, coeff [N, taps] int32 per PU.
    The int16 result wraps as HM's ``Short`` does."""
    n_taps = coeff.shape[1]
    head_room = IF_INTERNAL_PREC - bd
    shift = IF_FILTER_PREC
    if is_last:
        shift += 0 if is_first else head_room
        offset = 1 << (shift - 1)
        offset += 0 if is_first else IF_INTERNAL_OFFS << IF_FILTER_PREC
    else:
        shift -= head_room if is_first else 0
        offset = (-IF_INTERNAL_OFFS << shift) if is_first else 0

    s = src.to(torch.int32)
    if vertical:
        win = torch.stack([s[:, k:k + out_h, :out_w] for k in range(n_taps)],
                          dim=1)
    else:
        win = torch.stack([s[:, :out_h, k:k + out_w] for k in range(n_taps)],
                          dim=1)
    acc = (win * coeff[:, :, None, None]).sum(dim=1, dtype=torch.int32)
    val = (acc + offset) >> shift
    if is_last:
        val = val.clamp(0, (1 << bd) - 1)
    return val.to(torch.int16)


def mc_batch(windows: torch.Tensor, frac_x: torch.Tensor,
             frac_y: torch.Tensor, case: str, luma: bool, bd: int, bi: bool,
             out_h: int, out_w: int) -> torch.Tensor:
    """One MC class: windows [N, wh, ww] int16 (element (0, 0) is the
    first tap sample), per-PU fractional phases [N].

    case: "copy" | "hor" | "ver" | "2d", kept distinct because HM's
    single-pass rounding of the hor/ver-only cases differs from a
    synthetic two-pass.  Returns [N, out_h, out_w] int16: the pixel
    domain when not bi, else the 14-bit internal domain."""
    global launches
    if case not in CASES:
        raise ValueError(f"unknown MC case {case!r}")
    launches += 1
    tables = from_reference(windows.device)
    filt = tables.luma_filter if luma else tables.chroma_filter
    n_taps = 8 if luma else 4
    is_last = not bi
    if case == "copy":
        return _copy_batch(windows[:, :out_h, :out_w], bd, is_last)
    if case == "hor":
        return _filter_1d_batch(windows, filt[frac_x.long()], False, bd, True,
                                is_last, out_h, out_w)
    if case == "ver":
        return _filter_1d_batch(windows, filt[frac_y.long()], True, bd, True,
                                is_last, out_h, out_w)
    tmp = _filter_1d_batch(windows, filt[frac_x.long()], False, bd, True,
                           False, out_h + n_taps - 1, out_w)
    return _filter_1d_batch(tmp, filt[frac_y.long()], True, bd, False,
                            is_last, out_h, out_w)


def bi_avg_batch(p0: torch.Tensor, p1: torch.Tensor, bd: int) -> torch.Tensor:
    """TComYuv::addAvg over a PU batch of 14-bit predictions -> int16
    pixels."""
    shift = IF_INTERNAL_PREC + 1 - bd
    offset = (1 << (shift - 1)) + 2 * IF_INTERNAL_OFFS
    val = (p0.to(torch.int32) + p1.to(torch.int32) + offset) >> shift
    return val.clamp(0, (1 << bd) - 1).to(torch.int16)


def weight_uni_batch(p: torch.Tensor, w: torch.Tensor, offset: torch.Tensor,
                     log2_denom: torch.Tensor, bd: int) -> torch.Tensor:
    """Explicit weighted uni-prediction (TComWeightPrediction.cpp
    addWeightUni) over a PU batch of 14-bit predictions p [N, h, w]: per
    PU the weight, the offset at the bit depth (the signalled offset <<
    (bd - 8)) and the log2 denominator, [N] each -> int16 pixels.  In
    int64, clipped to [0, (1 << bd) - 1]."""
    w, offset, log2_denom = (v.to(torch.int64)[:, None, None]
                             for v in (w, offset, log2_denom))
    shift = log2_denom + (IF_INTERNAL_PREC - bd)
    rnd = (1 << shift) >> 1                      # 0 when shift is 0
    v = ((w * (p.to(torch.int64) + IF_INTERNAL_OFFS) + rnd) >> shift) + offset
    return v.clamp(0, (1 << bd) - 1).to(torch.int16)


def weight_bi_batch(p0: torch.Tensor, p1: torch.Tensor, w0: torch.Tensor,
                    w1: torch.Tensor, offset: torch.Tensor,
                    log2_denom: torch.Tensor, bd: int) -> torch.Tensor:
    """Explicit weighted bi-prediction (TComWeightPrediction.cpp
    addWeightBi) over a PU batch of 14-bit prediction pairs [N, h, w]:
    per PU the two weights, the sum of the two offsets at the bit depth
    and the log2 denominator, [N] each -> int16 pixels.  Weights (1, 1),
    offset 0 and denominator 0 give ``bi_avg_batch``."""
    w0, w1, offset, log2_denom = (v.to(torch.int64)[:, None, None]
                                  for v in (w0, w1, offset, log2_denom))
    shift = log2_denom + (IF_INTERNAL_PREC + 1 - bd)
    half = (1 << shift) >> 1
    v = (w0 * (p0.to(torch.int64) + IF_INTERNAL_OFFS)
         + w1 * (p1.to(torch.int64) + IF_INTERNAL_OFFS)
         + half + offset * half) >> shift
    return v.clamp(0, (1 << bd) - 1).to(torch.int16)


def scatter_blocks(flat: torch.Tensor, blocks: torch.Tensor,
                   origin: torch.Tensor, stride: torch.Tensor) -> None:
    """Write blocks [N, h, w] into the flat buffer: block k's sample (i,
    j) goes to ``origin[k] + i * stride[k] + j``."""
    n, h, w = blocks.shape
    dev = flat.device
    idx = (origin.long()[:, None, None]
           + torch.arange(h, device=dev)[None, :, None]
           * stride.long()[:, None, None]
           + torch.arange(w, device=dev)[None, None, :])
    flat[idx.reshape(-1)] = blocks.reshape(-1).to(flat.dtype)


def _list_rows(jobs: np.ndarray) -> np.ndarray:
    """One row per (job, list) of a picture's job table: (job, list,
    plane, window x, window y, fx, fy, case), int64 [R, 8]."""
    n_lists = 1 + np.isin(jobs[:, J_KIND], (KINDS.index("bi"),
                                            KINDS.index("wbi")))
    rows = []
    for lst in (0, 1):
        idx = np.nonzero(n_lists > lst)[0]
        c = J_LIST + 6 * lst
        rows.append(np.concatenate([
            idx[:, None], np.full((len(idx), 1), lst),
            jobs[idx][:, [c + L_PLANE, c + L_WX, c + L_WY, c + L_FX,
                          c + L_FY, c + L_CASE]]], axis=1))
    return np.concatenate(rows)


def mc_picture_plain(jobs: np.ndarray, planes: list, size: int,
                     bd: int) -> torch.Tensor:
    """The plain version of the picture kernel, on any device: host jobs
    [J, JOB_COLS], planes int16 [rows, cols] each -> flat int16 [size],
    zero outside the jobs.  The planes of one shape are stacked; each
    (component, case, size, 14-bit, plane shape) class of (job, list)
    rows is gathered and filtered in one ``mc_batch``; uni jobs are
    scattered (weighted first where they are), the bi jobs' two lists
    meet in one buffer per (size, kind) and are averaged or weighted."""
    dev = planes[0].device
    pred = torch.zeros(size, dtype=torch.int16, device=dev)
    jobs = np.asarray(jobs, np.int64).reshape(-1, JOB_COLS)
    if not len(jobs):
        return pred
    shapes = sorted({tuple(p.shape) for p in planes})
    stacks = [torch.stack([p for p in planes if tuple(p.shape) == sh])
              for sh in shapes]
    stack_of = np.asarray([shapes.index(tuple(p.shape)) for p in planes])
    pos_of = np.zeros(len(planes), np.int64)
    for k in range(len(shapes)):
        pos_of[stack_of == k] = np.arange(int((stack_of == k).sum()))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    uni, bi, wuni, wbi = (KINDS.index(k) for k in ("uni", "bi", "wuni",
                                                   "wbi"))
    kind = jobs[:, J_KIND]
    # each bi job's slot in the pair buffer of its (size, kind)
    pair_key = jobs[:, J_H] * 128 + jobs[:, J_W]
    pair_rank = np.zeros(len(jobs), np.int64)
    bufs = {}
    for k in (bi, wbi):
        for key in np.unique(pair_key[kind == k]):
            sel = np.nonzero((kind == k) & (pair_key == key))[0]
            pair_rank[sel] = np.arange(len(sel))
            bufs[k, key] = (sel, torch.empty(
                (2, len(sel), key // 128, key % 128), dtype=torch.int16,
                device=dev))

    rows = _list_rows(jobs)
    job = jobs[rows[:, 0]]
    keys = np.stack([job[:, J_LUMA], rows[:, 7], job[:, J_H], job[:, J_W],
                     job[:, J_KIND] != uni, stack_of[rows[:, 2]]], axis=1)
    order = np.lexsort(keys.T[::-1])
    rows, keys = rows[order], keys[order]
    bounds = np.r_[0, np.nonzero(np.any(np.diff(keys, axis=0), axis=1))[0]
                   + 1, len(keys)]
    for a, b in zip(bounds[:-1], bounds[1:]):
        luma, case_id, h, w, bi14, stack = (int(v) for v in keys[a])
        r = rows[a:b]
        case = CASES[case_id]
        wr, wc = window_shape(case, bool(luma), h, w)
        win = gather_windows(stacks[stack], t(pos_of[r[:, 2]]), t(r[:, 3]),
                             t(r[:, 4]), wr, wc)
        out = mc_batch(win, t(r[:, 5]), t(r[:, 6]), case, bool(luma), bd,
                       bool(bi14), h, w)
        jr = jobs[r[:, 0]]
        for k in (uni, wuni):
            sel = np.nonzero(jr[:, J_KIND] == k)[0]
            if not len(sel):
                continue
            blk = out[t(sel)]
            if k == wuni:
                blk = weight_uni_batch(blk, t(jr[sel, J_W0]),
                                       t(jr[sel, J_OFF]), t(jr[sel, J_DEN]),
                                       bd)
            scatter_blocks(pred, blk, t(jr[sel, J_DST]), t(jr[sel, J_STRIDE]))
        for k in (bi, wbi):
            sel = np.nonzero(jr[:, J_KIND] == k)[0]
            if len(sel):
                buf = bufs[k, h * 128 + w][1]
                buf[t(r[sel, 1]), t(pair_rank[r[sel, 0]])] = out[t(sel)]
    for (k, _key), (sel, buf) in bufs.items():
        j = jobs[sel]
        if k == bi:
            blk = bi_avg_batch(buf[0], buf[1], bd)
        else:
            blk = weight_bi_batch(buf[0], buf[1], t(j[:, J_W0]),
                                  t(j[:, J_W1]), t(j[:, J_OFF]),
                                  t(j[:, J_DEN]), bd)
        scatter_blocks(pred, blk, t(j[:, J_DST]), t(j[:, J_STRIDE]))
    return pred


def mc_picture(jobs: np.ndarray, planes: list, size: int,
               bd: int) -> torch.Tensor:
    """Every inter PU of a picture: host jobs int32 [J, JOB_COLS]
    (``ops.mc_kernel``) over the reference planes (int16 [rows, cols]
    each, on one device) -> the flat int16 prediction [size], zero outside
    the jobs.  On a CUDA device this is one launch of the hand-written
    kernel (and raises if it cannot launch); on the CPU the plain
    version."""
    dev = planes[0].device
    if dev.type == "cpu":
        return mc_picture_plain(jobs, planes, size, bd)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return mc_kernel.picture(jobs, planes, size, bd)


def _blocks_plain(planes: torch.Tensor, jobs: torch.Tensor, case: str,
                  luma: bool, bd: int, bi: bool, out_h: int,
                  out_w: int) -> torch.Tensor:
    """One plane stack, one list: ``gather_windows`` then ``mc_batch``
    -> int16 [N, out_h, out_w]."""
    rows, cols = window_shape(case, luma, out_h, out_w)
    outs = []
    # in chunks of about 2^22 window samples, which bounds the tap stacks
    for j in jobs.split(max(1, (1 << 22) // (rows * cols))):
        win = gather_windows(planes, j[:, 0], j[:, 1], j[:, 2], rows, cols)
        outs.append(mc_batch(win, j[:, 3], j[:, 4], case, luma, bd, bi,
                             out_h, out_w))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def mc_blocks_plain(planes: torch.Tensor, jobs: torch.Tensor, case: str,
                    luma: bool, bd: int, bi: bool, out_h: int, out_w: int,
                    *, pair: bool = False,
                    planes1: torch.Tensor | None = None,
                    jobs1: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of the blocks kernel, on any device, with the
    arguments of ``mc_blocks``: ``mc_batch`` over the gathered windows of
    each plane stack (``pair``: the first and the second half of the
    planes, stacked [2, N, out_h, out_w]); with a second list the two
    14-bit predictions through ``bi_avg_batch``."""
    def one(p, j, bits14):
        if not pair:
            return _blocks_plain(p, j, case, luma, bd, bits14, out_h, out_w)
        half = p.shape[0] // 2
        return torch.stack([_blocks_plain(q, j, case, luma, bd, bits14,
                                          out_h, out_w)
                            for q in (p[:half], p[half:])])
    if jobs1 is None:
        return one(planes, jobs, bi)
    return bi_avg_batch(one(planes, jobs, True), one(planes1, jobs1, True),
                        bd)


def mc_blocks(planes: torch.Tensor, jobs: torch.Tensor, case: str,
              luma: bool, bd: int, bi: bool, out_h: int, out_w: int, *,
              pair: bool = False, planes1: torch.Tensor | None = None,
              jobs1: torch.Tensor | None = None) -> torch.Tensor:
    """N predictions of one size and case: int16 planes [P, rows, cols]
    and integer jobs [N, 5] of (plane, window x, window y, fx, fy), the
    window's first tap sample in plane coordinates (read clamped to the
    plane) -> int16 [N, out_h, out_w], pixels, or 14 bits when ``bi``.
    ``pair``: the planes stack Cb then Cr (P / 2 each) and every job
    predicts both -> [2, N, out_h, out_w].  ``planes1`` and ``jobs1``
    (with ``bi``): list 1's planes and jobs; the result is the bi average
    of both lists' predictions, in pixels.  On a CUDA device one launch
    of the hand-written kernel (and raises if it cannot launch); on the
    CPU the plain version."""
    if planes.device.type == "cpu":
        return mc_blocks_plain(planes, jobs, case, luma, bd, bi, out_h,
                               out_w, pair=pair, planes1=planes1,
                               jobs1=jobs1)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")

    def prep(p, j):
        return (p.to(torch.int16).contiguous(),
                j.to(torch.int32).contiguous())
    planes, jobs = prep(planes, jobs)
    if planes1 is not None and jobs1 is not None:
        planes1, jobs1 = prep(planes1, jobs1)
    return mc_kernel.blocks(planes, jobs, case, luma, bd, bi, out_h, out_w,
                            pair=pair, planes1=planes1, jobs1=jobs1)


def field_jobs(fields: tuple, size: int, nbx: int, pad: int,
               luma: bool) -> torch.Tensor:
    """The ``mc_blocks`` job table of blocks on a grid: (ref, mvx, mvy)
    integer [n] each (quarter pel), block k at row k // nbx and column k %
    nbx of size x size blocks over planes padded by ``pad`` -> jobs [n, 5]
    of the fields' dtype: luma (the 8-tap filter, quarter-pel phases)
    (ref, column * size + (mvx >> 2) + pad - 3, row * size + (mvy >> 2) +
    pad - 3, mvx & 3, mvy & 3); chroma (4 taps, eighth-pel phases) the
    same with >> 3, pad - 1 and & 7 (``encoder.fast_inter._luma_jobs``,
    ``_chroma_jobs``)."""
    ref, mvx, mvy = fields
    k = torch.arange(int(ref.shape[0]), device=ref.device, dtype=ref.dtype)
    by, bx = k // nbx * size, k % nbx * size
    sh, mask, off = (2, 3, pad - 3) if luma else (3, 7, pad - 1)
    return torch.stack([ref, bx + (mvx >> sh) + off, by + (mvy >> sh) + off,
                        mvx & mask, mvy & mask], dim=1)


def mc_blocks_fields_plain(planes: torch.Tensor, fields: tuple, size: int,
                           nbx: int, pad: int, luma: bool, bd: int,
                           bi: bool, *, pair: bool = False,
                           planes1: torch.Tensor | None = None,
                           fields1: tuple | None = None) -> torch.Tensor:
    """The plain version of the blocks kernel's field entry, on any
    device: each list's job table (``field_jobs``) through
    ``mc_blocks_plain`` in the 2-D case."""
    jobs1 = None if fields1 is None else field_jobs(fields1, size, nbx, pad,
                                                    luma)
    return mc_blocks_plain(planes, field_jobs(fields, size, nbx, pad, luma),
                           "2d", luma, bd, bi, size, size, pair=pair,
                           planes1=planes1, jobs1=jobs1)


def mc_blocks_fields(planes: torch.Tensor, fields: tuple, size: int,
                     nbx: int, pad: int, luma: bool, bd: int, bi: bool, *,
                     pair: bool = False, planes1: torch.Tensor | None = None,
                     fields1: tuple | None = None) -> torch.Tensor:
    """``mc_blocks`` of the blocks of a grid at their MVs, in the 2-D case
    (a zero phase on the identity tap row): (ref, mvx, mvy) [n] each, the
    rest as ``field_jobs`` and ``mc_blocks`` -> int16 [n, size, size] (or
    [2, n, size, size] with ``pair``).  On a CUDA device one launch of the
    blocks kernel's field entry, which derives each job in the kernel (the
    fields int32; raises if it cannot launch); on the CPU the plain
    version."""
    if planes.device.type == "cpu":
        return mc_blocks_fields_plain(planes, fields, size, nbx, pad, luma,
                                      bd, bi, pair=pair, planes1=planes1,
                                      fields1=fields1)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    return mc_kernel.blocks_fields(planes, fields, size, nbx, pad, luma, bd,
                                   bi, pair=pair, planes1=planes1,
                                   fields1=fields1)


# per quarter-pel candidate k = (qdy + 3) * 7 + qdx + 3: integer row
# offset, fy, integer column offset, fx (an offset q is 4 * (q >> 2) +
# (q & 3))
QPEL_CAND = tuple(((k // 7 - 3) >> 2, (k // 7 - 3) & 3, (k % 7 - 3) >> 2,
                   (k % 7 - 3) & 3) for k in range(49))


def qpel_jobs(origins: torch.Tensor) -> torch.Tensor:
    """The 49-job table of the quarter-pel candidates: origins [nb, 3] of
    (plane, window x, window y) of candidate (0, 0) -> int64 jobs
    [nb * 49, 5] of (plane, window x, window y, fx, fy), block-major."""
    nb = origins.shape[0]
    o = origins.long()
    cand = torch.tensor(QPEL_CAND, device=origins.device)
    return torch.stack([
        o[:, 0, None].expand(nb, 49), o[:, 1, None] + cand[:, 2],
        o[:, 2, None] + cand[:, 0], cand[:, 3].expand(nb, 49),
        cand[:, 1].expand(nb, 49)], dim=2).reshape(nb * 49, 5)


def mc_qpel_plain(planes: torch.Tensor, origins: torch.Tensor, s: int,
                  bd: int) -> torch.Tensor:
    """The plain version of the quarter-pel kernel, on any device: the
    49-job table (``qpel_jobs``) through ``mc_blocks_plain`` in the 2-D
    case -> int16 pixels [nb, 49, s, s]."""
    return mc_blocks_plain(planes, qpel_jobs(origins), "2d", True, bd, False,
                           s, s).reshape(origins.shape[0], 49, s, s)


def mc_qpel(planes: torch.Tensor, origins: torch.Tensor, s: int,
            bd: int) -> torch.Tensor:
    """The 7x7 quarter-pel candidates of nb luma blocks of size s (8, 16,
    32 or 64): int16 planes [P, rows, cols] and integer origins [nb, 3] of
    (plane, window x, window y), the first tap sample of each block's
    candidate (0, 0) in plane coordinates (read clamped to the plane) ->
    int16 pixels [nb, 49, s, s], candidate (qdy + 3) * 7 + qdx + 3 at
    quarter-pel offset (qdx, qdy), the 2-D case at every phase.  On a CUDA
    device one launch of the hand-written kernel (and raises if it cannot
    launch); on the CPU the plain version."""
    if planes.device.type == "cpu":
        return mc_qpel_plain(planes, origins, s, bd)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    return mc_kernel.qpel(planes.to(torch.int16).contiguous(),
                          origins.to(torch.int32).contiguous(), s, bd)


def qpel_origins(fields: tuple, s: int, nbx: int, pad: int) -> torch.Tensor:
    """The quarter-pel entry's origins of blocks on a grid: (ref, int_mx,
    int_my) integer [n] each (full pel), block k at row k // nbx and
    column k % nbx of s x s blocks over planes padded by ``pad`` -> [n, 3]
    of (ref, column * s + int_mx + pad - 3, row * s + int_my + pad - 3)
    (``encoder.fast_inter._qpel_preds``)."""
    ref, mx, my = fields
    k = torch.arange(int(ref.shape[0]), device=ref.device, dtype=ref.dtype)
    return torch.stack([ref, k % nbx * s + mx + (pad - 3),
                        k // nbx * s + my + (pad - 3)], dim=1)


def mc_qpel_fields_plain(planes: torch.Tensor, fields: tuple, s: int,
                         nbx: int, pad: int, bd: int) -> torch.Tensor:
    """The plain version of the quarter-pel kernel's field entry, on any
    device: the origins (``qpel_origins``) through ``mc_qpel_plain``."""
    return mc_qpel_plain(planes, qpel_origins(fields, s, nbx, pad), s, bd)


def mc_qpel_fields(planes: torch.Tensor, fields: tuple, s: int, nbx: int,
                   pad: int, bd: int) -> torch.Tensor:
    """``mc_qpel`` of the blocks of a grid at their integer MVs: (ref,
    int_mx, int_my) [n] each, the rest as ``qpel_origins`` and
    ``mc_qpel`` -> int16 pixels [n, 49, s, s].  On a CUDA device one
    launch of the quarter-pel kernel's field entry, which derives each
    origin in the kernel (the fields int64; raises if it cannot launch);
    on the CPU the plain version."""
    if planes.device.type == "cpu":
        return mc_qpel_fields_plain(planes, fields, s, nbx, pad, bd)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    return mc_kernel.qpel_fields(planes, fields, s, nbx, pad, bd)
