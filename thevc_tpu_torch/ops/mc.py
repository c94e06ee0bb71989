"""Motion-compensation interpolation in PyTorch over PU batches.

Counterpart of ``thevc_tpu/ops/jx_mc.py``: ``_copy_batch`` (:35),
``_filter_1d_batch`` (:44), ``mc_batch`` (:75) and ``bi_avg_batch``
(:106), with HM's int16 (``Short``) intermediate wrap, and the explicit
weighted prediction of ``thevc_tpu/decoder/inter.py`` (``_weight_uni``,
``_weight_bi``, :46-69) over PU batches.  Also the device
window gather that replaces the host ``np.stack`` of per-PU slices of
``Picture.padded()`` (``thevc_tpu/decoder/inter.py:149-182``).

Every PU of a picture reads reference pictures only, so the decoder
gathers all windows of one (component, filter case, size, bi) class and
filters them in one call.  The fractional phase varies per PU: the tap
vector is gathered per PU (``coeff[frac]``).  The taps are an int32
multiply and sum, not a matrix product (torch has no int32 GEMM on
CUDA).  Plain torch on any device.
"""

from __future__ import annotations

import torch

from ..common.tables import from_reference
from .interp import IF_FILTER_PREC, IF_INTERNAL_OFFS, IF_INTERNAL_PREC

# the four filter cases of ``_mc_block``, indexed by
# (frac_x != 0) + 2 * (frac_y != 0)
CASES = ("copy", "hor", "ver", "2d")

# mc_batch calls, one per MC class of a picture; a plain integer that a
# run resets and reads to show that its decode went through this module
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
