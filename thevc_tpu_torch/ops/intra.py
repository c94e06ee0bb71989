"""Intra prediction: reference-sample assembly, smoothing, 35-mode prediction.

Behavioral reference:
- TComPattern.cpp: fillReferenceSamples (:368, incl. unavailable-sample
  substitution over the unit-granular neighbor line), initAdiPattern [1 2 1]
  smoothing (:283-305), getPredictorPtr filter selection (:577,
  m_aucIntraFilter thresholds :49).
- TComPrediction.cpp: xPredIntraAng (:190, 33 angles with 5-bit fractional
  interpolation + inverse-angle main reference extension), xPredIntraPlanar
  (:689), predIntraGetPredValDC (:128), xDCPredFiltering (:1010), entry
  points predIntraLumaAng (:338) / predIntraChromaAng (:369).

Reference samples for a size-S block are carried as a "line" array of length
2S (left, bottom->top) + 1 (corner) + 2S (top, left->right), index 0 =
bottom-most below-left sample.  This is the layout that batches naturally:
one gather builds all TU lines from the recon plane, one matmul-free VPU pass
applies smoothing, and the 33 angular modes are a pair of gathers + lerp.
"""

from __future__ import annotations

import numpy as np

# m_aucIntraFilter (TComPattern.cpp:49): smoothing threshold per log2 size
INTRA_FILTER_THRESH = {2: 10, 3: 7, 4: 1, 5: 0, 6: 10}

ANG_TABLE = np.array([0, 2, 5, 9, 13, 17, 21, 26, 32], np.int32)
INV_ANG_TABLE = np.array([0, 4096, 1638, 910, 630, 482, 390, 315, 256], np.int32)

PLANAR_IDX = 0
DC_IDX = 1
HOR_IDX = 10
VER_IDX = 26


def fill_reference_line(rec: np.ndarray, x0: int, y0: int, size: int,
                        unit_size: int, flags: np.ndarray,
                        dc_value: int) -> np.ndarray:
    """Assemble the neighbor reference line with substitution.

    rec: reconstructed plane (H, W) int16; (x0, y0): TU top-left; size: TU
    size; unit_size: availability granularity (4 luma, 2 chroma);
    flags: bool[4*num_units+1] availability, index 0 = bottom-most
    below-left unit, num_units*2 = corner, upward to above-right.

    Returns int32 line of length 4*size + unit_size laid out as
    [left+below-left (2*size, bottom->top) | corner x unit_size | top+above-right (2*size)]
    (fillReferenceSamples, TComPattern.cpp:368).
    """
    num_units = size // unit_size          # units along one edge
    total_units = 4 * num_units + 1
    line = np.full(4 * size + unit_size, dc_value, np.int64)
    corner_base = 2 * size                 # line index of corner unit start

    n_avail = int(flags.sum())
    if n_avail == 0:
        return line.astype(np.int32)

    h, w = rec.shape
    # corner
    if flags[2 * num_units]:
        line[corner_base:corner_base + unit_size] = rec[y0 - 1, x0 - 1]
    # left + below-left: unit j (0-based from corner downward) covers rows
    # y0 + j*unit .. y0+(j+1)*unit-1 at column x0-1; line positions
    # corner_base-1-j*unit downward.
    for j in range(2 * num_units):
        if flags[2 * num_units - 1 - j]:
            ys = y0 + j * unit_size
            seg = rec[ys:ys + unit_size, x0 - 1].astype(np.int64)
            # line[corner_base-1-j*unit - i] = rec[ys+i] for i in 0..unit-1
            dst = corner_base - 1 - j * unit_size
            line[dst - unit_size + 1: dst + 1] = seg[::-1]
    # top + above-right: unit j covers cols x0 + j*unit .. at row y0-1
    for j in range(2 * num_units):
        if flags[2 * num_units + 1 + j]:
            xs = x0 + j * unit_size
            dst = corner_base + unit_size + j * unit_size
            line[dst: dst + unit_size] = rec[y0 - 1, xs:xs + unit_size]

    if n_avail == total_units:
        return line.astype(np.int32)

    # substitution pass (TComPattern.cpp:495-534): scan units from 0 upward
    curr = 0
    while curr < total_units:
        if not flags[curr]:
            if curr == 0:
                nxt = 1
                while nxt < total_units and not flags[nxt]:
                    nxt += 1
                if nxt < total_units:
                    ref = line[nxt * unit_size]
                else:
                    ref = dc_value
                line[: nxt * unit_size] = ref
                curr = nxt
            else:
                line[curr * unit_size: (curr + 1) * unit_size] = \
                    line[curr * unit_size - 1]
                curr += 1
        else:
            curr += 1
    return line.astype(np.int32)


def smooth_reference_line(line: np.ndarray, size: int, unit_size: int) -> np.ndarray:
    """[1 2 1] filtering of the border (initAdiPattern, TComPattern.cpp:283).

    The filter runs over the logical sequence: left border bottom->top,
    corner, top border left->right (total 4*size+1 samples); the first and
    last samples are unfiltered.
    """
    corner_base = 2 * size
    seq = np.concatenate([line[:corner_base],
                          line[corner_base:corner_base + 1],
                          line[corner_base + unit_size:]]).astype(np.int64)
    out = seq.copy()
    out[1:-1] = (seq[:-2] + 2 * seq[1:-1] + seq[2:] + 2) >> 2
    res = line.copy()
    res[:corner_base] = out[:corner_base]
    res[corner_base:corner_base + unit_size] = out[corner_base]
    res[corner_base + unit_size:] = out[corner_base + 1:]
    return res


def use_filtered(mode: int, log2_size: int, is_luma: bool) -> bool:
    """getPredictorPtr (TComPattern.cpp:577): smoothed buffer selection.

    NB chroma never uses the filtered buffer in HM (initAdiPatternChroma
    doesn't build one and predIntraChromaAng receives the raw buffer).
    """
    if not is_luma:
        return False
    if mode == DC_IDX:
        return False
    diff = min(abs(mode - HOR_IDX), abs(mode - VER_IDX))
    return diff > INTRA_FILTER_THRESH[log2_size]


def _refs_from_line(line: np.ndarray, size: int, unit_size: int):
    """Build refAbove/refLeft arrays of length 2*size+1:
    ref_above[k] = sample at (x0-1+k, y0-1) for k=0..2S (corner at k=0);
    ref_left[k]  = sample at (x0-1, y0-1+k).
    """
    corner = line[2 * size]
    ref_above = np.empty(2 * size + 1, np.int64)
    ref_above[0] = corner
    ref_above[1:] = line[2 * size + unit_size:]
    ref_left = np.empty(2 * size + 1, np.int64)
    ref_left[0] = corner
    ref_left[1:] = line[2 * size - 1::-1][:2 * size]
    return ref_above, ref_left


def predict(line: np.ndarray, size: int, unit_size: int, mode: int,
            is_luma: bool, max_val: int) -> np.ndarray:
    """35-mode intra prediction from a reference line -> (size, size) int32.

    Mirrors predIntraLumaAng/predIntraChromaAng incl. DC filtering (luma
    only) and the mode-0/HOR/VER edge filters (bFilter=true for luma).
    """
    ref_above, ref_left = _refs_from_line(line, size, unit_size)
    if mode == PLANAR_IDX:
        return _planar(ref_above, ref_left, size)
    pred = _angular(ref_above, ref_left, size, mode, is_luma, max_val)
    if mode == DC_IDX and is_luma:
        pred = _dc_filter(ref_above, ref_left, pred)
    return pred


def _planar(ref_above, ref_left, size: int) -> np.ndarray:
    """xPredIntraPlanar (TComPrediction.cpp:689)."""
    log2 = size.bit_length() - 1
    top_row = ref_above[1:size + 2].astype(np.int64)       # k=0..size
    left_col = ref_left[1:size + 2].astype(np.int64)
    bottom_left = left_col[size]
    top_right = top_row[size]
    bottom_row = bottom_left - top_row[:size]
    right_col = top_right - left_col[:size]
    top_acc = (top_row[:size] << log2)
    k = np.arange(1, size + 1, dtype=np.int64)
    # horPred(k,l) = (leftColumn[k]<<log2) + size + (l+1)*rightColumn[k]
    hor = (left_col[:size, None] << log2) + size + k[None, :] * right_col[:size, None]
    ver = top_acc[None, :] + k[:, None] * bottom_row[None, :]
    return ((hor + ver) >> (log2 + 1)).astype(np.int32)


def _angular(ref_above, ref_left, size: int, mode: int, bfilter: bool,
             max_val: int) -> np.ndarray:
    """xPredIntraAng (TComPrediction.cpp:190)."""
    mode_dc = mode < 2
    if mode_dc:
        # DC over above row + left col (both always "available" post-fill)
        s = int(ref_above[1:size + 1].sum() + ref_left[1:size + 1].sum())
        dcval = (s + size) // (2 * size)
        return np.full((size, size), dcval, np.int32)

    mode_hor = mode < 18
    intra_pred_angle = (mode - VER_IDX) if not mode_hor else -(mode - HOR_IDX)
    abs_ang = int(ANG_TABLE[abs(intra_pred_angle)])
    inv_angle = int(INV_ANG_TABLE[abs(intra_pred_angle)])
    sign = -1 if intra_pred_angle < 0 else 1
    intra_pred_angle = sign * abs_ang

    ref_main_src = ref_above if not mode_hor else ref_left
    ref_side_src = ref_left if not mode_hor else ref_above

    if intra_pred_angle < 0:
        # main ref indices -size..size relative; extension via inverse angle
        ext = (size * intra_pred_angle) >> 5  # negative
        ref_main = np.zeros(2 * size + 1, np.int64)  # index k+size-? use dict-like
        # layout: ref_main[i + size] for i in -size..size ; only 0..size from src
        buf = np.zeros(2 * size + 1, np.int64)
        off = size  # buf[off + i] = refMain[i]
        buf[off:off + size + 1] = ref_main_src[:size + 1]
        inv_sum = 128
        for k in range(-1, ext, -1):
            inv_sum += inv_angle
            buf[off + k] = ref_side_src[inv_sum >> 8]
        ref_main = buf
    else:
        buf = np.zeros(3 * size + 1, np.int64)
        off = 0
        buf[:2 * size + 1] = ref_main_src[:2 * size + 1]
        ref_main = buf
        off = 0

    pred = np.empty((size, size), np.int64)
    if intra_pred_angle == 0:
        row = ref_main[off + 1: off + 1 + size]
        pred[:, :] = row[None, :]
        if bfilter:
            delta = (ref_side_src[1:size + 1] - ref_side_src[0]) >> 1
            pred[:, 0] = np.clip(pred[:, 0] + delta, 0, max_val)
    else:
        k = np.arange(1, size + 1, dtype=np.int64)
        delta_pos = k * intra_pred_angle
        delta_int = delta_pos >> 5
        delta_frac = delta_pos & 31
        l = np.arange(size, dtype=np.int64)
        idx = off + l[None, :] + delta_int[:, None] + 1
        a = ref_main[idx]
        b = ref_main[idx + 1]
        f = delta_frac[:, None]
        pred = np.where(f != 0, ((32 - f) * a + f * b + 16) >> 5, a)

    if mode_hor:
        pred = pred.T
    return pred.astype(np.int32)


def _dc_filter(ref_above, ref_left, pred: np.ndarray) -> np.ndarray:
    """xDCPredFiltering (TComPrediction.cpp:1010)."""
    out = pred.astype(np.int64)
    size = pred.shape[0]
    top = ref_above[1:size + 1]
    left = ref_left[1:size + 1]
    out[0, 0] = (top[0] + left[0] + 2 * out[0, 0] + 2) >> 2
    out[0, 1:] = (top[1:] + 3 * out[0, 1:] + 2) >> 2
    out[1:, 0] = (left[1:] + 3 * out[1:, 0] + 2) >> 2
    return out.astype(np.int32)
