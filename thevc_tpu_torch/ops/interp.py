"""Motion-compensation interpolation (luma 8-tap / chroma 4-tap).

Behavioral reference: TComInterpolationFilter.cpp (m_lumaFilter :55,
m_chromaFilter :63, filter<> :164, filterCopy :85) and TComYuv::addAvg.

IF_INTERNAL_PREC=14, IF_FILTER_PREC=6, IF_INTERNAL_OFFS=8192.  All
intermediates are kept in int16 exactly like the reference's Short
arithmetic (wrap-around included), computed here vectorized over the block;
the same separable-filter formulation maps to TPU as two batched matmuls
over the tap dimension (ops.jx mirror).
"""

from __future__ import annotations

import numpy as np

IF_INTERNAL_PREC = 14
IF_FILTER_PREC = 6
IF_INTERNAL_OFFS = 1 << (IF_INTERNAL_PREC - 1)

LUMA_FILTER = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], np.int32)

CHROMA_FILTER = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], np.int32)


def _as_i16(x):
    return x.astype(np.int16)


def _filter_copy(src, bd, is_first, is_last):
    if is_first == is_last:
        return _as_i16(src)
    if is_first:
        shift = IF_INTERNAL_PREC - bd
        return _as_i16((src.astype(np.int32) << shift) - IF_INTERNAL_OFFS)
    shift = IF_INTERNAL_PREC - bd
    offset = IF_INTERNAL_OFFS + ((1 << (shift - 1)) if shift else 0)
    val = (src.astype(np.int32) + offset) >> shift
    return _as_i16(np.clip(val, 0, (1 << bd) - 1))


def _filter_1d(src, coeff, vertical, bd, is_first, is_last, out_h, out_w):
    """filter<N, isVertical, isFirst, isLast>: src already positioned so
    that row/col 0 corresponds to the first tap (src - (N/2-1)*stride)."""
    n = len(coeff)
    head_room = IF_INTERNAL_PREC - bd
    shift = IF_FILTER_PREC
    if is_last:
        shift += 0 if is_first else head_room
        offset = 1 << (shift - 1)
        offset += 0 if is_first else IF_INTERNAL_OFFS << IF_FILTER_PREC
    else:
        shift -= head_room if is_first else 0
        offset = (-IF_INTERNAL_OFFS << shift) if is_first else 0

    s = src.astype(np.int32)
    acc = np.zeros((out_h, out_w), np.int32)
    for k in range(n):
        if vertical:
            acc += s[k:k + out_h, :out_w] * int(coeff[k])
        else:
            acc += s[:out_h, k:k + out_w] * int(coeff[k])
    val = (acc + offset) >> shift
    if is_last:
        val = np.clip(val, 0, (1 << bd) - 1)
    return _as_i16(val)


def _mc_block(ref, y0, x0, frac_x, frac_y, w, h, filt, n_taps, bd, bi):
    """Generic separable MC; ref is the padded plane, (y0, x0) the integer
    start inside it.  Returns int16 (pixel domain if not bi, 14-bit if bi)."""
    half = n_taps // 2
    if frac_y == 0 and frac_x == 0:
        blk = ref[y0:y0 + h, x0:x0 + w]
        return _filter_copy(blk, bd, True, not bi)
    if frac_y == 0:
        src = ref[y0:y0 + h, x0 - (half - 1):x0 + w + half]
        return _filter_1d(src, filt[frac_x], False, bd, True, not bi, h, w)
    if frac_x == 0:
        src = ref[y0 - (half - 1):y0 + h + half, x0:x0 + w]
        return _filter_1d(src, filt[frac_y], True, bd, True, not bi, h, w)
    src = ref[y0 - (half - 1):y0 + h + half,
              x0 - (half - 1):x0 + w + half]
    tmp = _filter_1d(src, filt[frac_x], False, bd, True, False,
                     h + n_taps - 1, w)
    return _filter_1d(tmp, filt[frac_y], True, bd, False, not bi, h, w)


def mc_luma(ref_padded, margin, px, py, mv_x, mv_y, w, h, bd, bi):
    """xPredInterLumaBlk on a padded reference plane."""
    x0 = margin + px + (mv_x >> 2)
    y0 = margin + py + (mv_y >> 2)
    return _mc_block(ref_padded, y0, x0, mv_x & 3, mv_y & 3, w, h,
                     LUMA_FILTER, 8, bd, bi)


def mc_chroma(ref_padded, margin, cx, cy, mv_x, mv_y, cw, ch, bd, bi):
    """xPredInterChromaBlk (one component) on a padded chroma plane."""
    x0 = margin + cx + (mv_x >> 3)
    y0 = margin + cy + (mv_y >> 3)
    return _mc_block(ref_padded, y0, x0, mv_x & 7, mv_y & 7, cw, ch,
                     CHROMA_FILTER, 4, bd, bi)


def bi_avg(p0, p1, bd):
    """TComYuv::addAvg: (s0 + s1 + offset) >> shift with clipping."""
    shift = IF_INTERNAL_PREC + 1 - bd
    offset = (1 << (shift - 1)) + 2 * IF_INTERNAL_OFFS
    val = (p0.astype(np.int32) + p1.astype(np.int32) + offset) >> shift
    return np.clip(val, 0, (1 << bd) - 1).astype(np.int16)


def pad_plane(plane, margin):
    """extendPicBorder: edge-replicate padding."""
    return np.pad(plane, margin, mode="edge")
