"""Rate-distortion optimized quantization (RDOQ) + sign-bit hiding.

Behavioral reference: TComTrQuant.cpp — xRateDistOptQuant (:1719), helpers
xGetCodedLevel (:2444), xGetICRateCost (:2507), xGetICRate (:2531),
xGetRateLast (:2644), xGetRateSigCoeffGroup/xGetRateSigCoef, error scale
setErrScaleCoeff (:2794), signBitHidingHDQ (:977), RDOQ's own SBH pass
(:2180-2300).

Bit rates are in 1/32768-bit units (SCALE_BITS); costs are doubles —
bit-exact decision parity with the reference requires the same double
arithmetic order, which numpy float64 scalar ops provide.
"""

from __future__ import annotations

import numpy as np

from ..common import rom
from .sbac_writer import EstBits

SCALE_BITS = 15
C1FLAG_NUMBER = 8
C2FLAG_NUMBER = 1
SBH_THRESHOLD = 4
MAX_INT = 2147483647
MAX_INT64 = (1 << 63) - 1
IEP_RATE = 32768


def _get_ic_rate_cost(abs_level, ctx_one, ctx_abs, go_rice, c1_idx, c2_idx,
                      eb: EstBits) -> float:
    rate = float(IEP_RATE)
    base_level = (2 + (1 if c2_idx < C2FLAG_NUMBER else 0)) \
        if c1_idx < C1FLAG_NUMBER else 1
    if abs_level >= base_level:
        symbol = abs_level - base_level
        if symbol < (3 << go_rice):
            length = symbol >> go_rice
            rate += (length + 1 + go_rice) << 15
        else:
            length = go_rice
            symbol -= 3 << go_rice
            while symbol >= (1 << length):
                symbol -= 1 << length
                length += 1
            rate += (3 + length + 1 - go_rice + length) << 15
        if c1_idx < C1FLAG_NUMBER:
            rate += eb.greater_one_bits[ctx_one][1]
            if c2_idx < C2FLAG_NUMBER:
                rate += eb.level_abs_bits[ctx_abs][1]
    elif abs_level == 1:
        rate += eb.greater_one_bits[ctx_one][0]
    elif abs_level == 2:
        rate += eb.greater_one_bits[ctx_one][1]
        rate += eb.level_abs_bits[ctx_abs][0]
    else:
        assert abs_level == 0
    return rate


def _get_ic_rate(abs_level, ctx_one, ctx_abs, go_rice, c1_idx, c2_idx,
                 eb: EstBits) -> int:
    rate = 0
    base_level = (2 + (1 if c2_idx < C2FLAG_NUMBER else 0)) \
        if c1_idx < C1FLAG_NUMBER else 1
    if abs_level >= base_level:
        symbol = abs_level - base_level
        max_vlc = int(rom.GO_RICE_RANGE[go_rice])
        if symbol > max_vlc:
            num = symbol - max_vlc
            egs = 1
            mx = 2
            while num >= mx:
                mx <<= 1
                egs += 2
            rate += egs << 15
            symbol = min(symbol, max_vlc + 1)
        pref_len = (symbol >> go_rice) + 1
        num_bins = min(pref_len, int(rom.GO_RICE_PREFIX_LEN[go_rice])) + go_rice
        rate += num_bins << 15
        if c1_idx < C1FLAG_NUMBER:
            rate += int(eb.greater_one_bits[ctx_one][1])
            if c2_idx < C2FLAG_NUMBER:
                rate += int(eb.level_abs_bits[ctx_abs][1])
    elif abs_level == 0:
        return 0
    elif abs_level == 1:
        rate += int(eb.greater_one_bits[ctx_one][0])
    elif abs_level == 2:
        rate += int(eb.greater_one_bits[ctx_one][1])
        rate += int(eb.level_abs_bits[ctx_abs][0])
    else:
        assert False
    return rate


def _get_coded_level(cost_coeff, cost_coeff0, cost_sig, scan_pos,
                     level_double, max_abs_level, ctx_sig, ctx_one, ctx_abs,
                     go_rice, c1_idx, c2_idx, qbits, err_scale, is_last,
                     lam, eb: EstBits):
    """xGetCodedLevel; returns (best_level, cost, cost_sig)."""
    curr_cost_sig = 0.0
    best_level = 0
    coded_cost = cost_coeff
    coded_cost0 = cost_coeff0
    coded_cost_sig = cost_sig
    if not is_last and max_abs_level < 3:
        coded_cost_sig = lam * float(eb.sig_bits[ctx_sig][0])
        coded_cost = coded_cost0 + coded_cost_sig
        if max_abs_level == 0:
            return 0, coded_cost, coded_cost_sig
    else:
        coded_cost = np.finfo(np.float64).max

    if not is_last:
        curr_cost_sig = lam * float(eb.sig_bits[ctx_sig][1])

    min_abs_level = max_abs_level - 1 if max_abs_level > 1 else 1
    for abs_level in range(max_abs_level, min_abs_level - 1, -1):
        err = float(level_double - (abs_level << qbits))
        curr_cost = err * err * err_scale + lam * _get_ic_rate_cost(
            abs_level, ctx_one, ctx_abs, go_rice, c1_idx, c2_idx, eb)
        curr_cost += curr_cost_sig
        if curr_cost < coded_cost:
            best_level = abs_level
            coded_cost = curr_cost
            coded_cost_sig = curr_cost_sig
    return best_level, coded_cost, coded_cost_sig


def rdoq(src_coeff: np.ndarray, width: int, qp_per: int, qp_rem: int,
         lam: float, is_luma: bool, is_intra: bool, scan_idx: int,
         eb: EstBits, tr_depth: int, sign_hide: bool, bit_increment: int = 0,
         quant_tab=None, err_tab=None):
    """xRateDistOptQuant for a width x width TU.

    Returns (dst_coeff int32 flat array, abs_sum).
    scan_idx: already zigzag->diag mapped.  tr_depth: luma CBF ctx depth
    (for the uncoded-block cost); chroma uses its own cbf ctx = trDepth.
    quant_tab/err_tab: per-coefficient quant scale / error scale in raster
    order when a scaling list is active (TComTrQuant.cpp:1759-1760).
    """
    max_coeff = width * width
    log2 = width.bit_length() - 1
    uiQ = int(rom.QUANT_SCALES[qp_rem])
    transform_shift = 15 - (8 + bit_increment) - log2
    qbits = 14 + qp_per + transform_shift
    err_scale = float(1 << SCALE_BITS) * (2.0 ** (-2.0 * transform_shift)) \
        / float(uiQ) / float(uiQ) / float(1 << (2 * bit_increment))
    if quant_tab is not None:
        quant_flat = np.asarray(quant_tab, np.int64).reshape(-1)
        err_flat = np.asarray(err_tab, np.float64).reshape(-1)

    dst = np.zeros(max_coeff, np.int32)
    cost_coeff = np.zeros(max_coeff, np.float64)
    cost_sig = np.zeros(max_coeff, np.float64)
    cost_coeff0 = np.zeros(max_coeff, np.float64)
    rate_inc_up = np.zeros(max_coeff, np.int64)
    rate_inc_down = np.zeros(max_coeff, np.int64)
    sig_rate_delta = np.zeros(max_coeff, np.int64)
    delta_u = np.zeros(max_coeff, np.int64)

    scan = rom.sig_last_scan(scan_idx, width)
    scan_cg = rom.cg_scan(scan_idx, width)
    num_blk_side = width >> 2
    cg_size = 16
    cost_cg_sig = np.zeros(64, np.float64)
    sig_cg = np.zeros(64, np.int32)

    block_uncoded_cost = 0.0
    base_cost = 0.0
    last_scan_pos = -1
    cg_last_scan_pos = -1
    ctx_set = 0
    c1 = 1
    c2 = 0
    go_rice = 0
    c1_idx = 0
    c2_idx = 0

    comp = 0 if is_luma else 1
    flat = src_coeff.reshape(-1)

    cg_num = max_coeff >> 4
    for cg_scan_pos in range(cg_num - 1, -1, -1):
        cg_blk_pos = int(scan_cg[cg_scan_pos])
        cg_pos_y = cg_blk_pos // num_blk_side if num_blk_side else 0
        cg_pos_x = cg_blk_pos - cg_pos_y * num_blk_side
        rd_sig_cost = 0.0
        rd_sig_cost0 = 0.0
        rd_coded_leveland_dist = 0.0
        rd_uncoded_dist = 0.0
        rd_nnz_before_pos0 = 0
        pattern = _calc_pattern(sig_cg, cg_pos_x, cg_pos_y, width)
        for pos_in_cg in range(cg_size - 1, -1, -1):
            scan_pos = cg_scan_pos * cg_size + pos_in_cg
            blk_pos = int(scan[scan_pos])
            if quant_tab is not None:
                uiQ = int(quant_flat[blk_pos])
                err_scale = float(err_flat[blk_pos])
            level_double = int(flat[blk_pos])
            level_double = min(abs(level_double) * uiQ,
                               MAX_INT - (1 << (qbits - 1)))
            max_abs_level = (level_double + (1 << (qbits - 1))) >> qbits
            err = float(level_double)
            cost_coeff0[scan_pos] = err * err * err_scale
            block_uncoded_cost += cost_coeff0[scan_pos]
            dst[blk_pos] = max_abs_level

            if max_abs_level > 0 and last_scan_pos < 0:
                last_scan_pos = scan_pos
                ctx_set = 0 if (scan_pos < 16 or not is_luma) else 2
                cg_last_scan_pos = cg_scan_pos

            if last_scan_pos >= 0:
                ctx_one = 4 * ctx_set + c1
                ctx_abs = ctx_set + c2
                if scan_pos == last_scan_pos:
                    level, cc_, cs_ = _get_coded_level(
                        cost_coeff[scan_pos], cost_coeff0[scan_pos],
                        cost_sig[scan_pos], scan_pos, level_double,
                        max_abs_level, 0, ctx_one, ctx_abs, go_rice,
                        c1_idx, c2_idx, qbits, err_scale, True, lam, eb)
                    cost_coeff[scan_pos], cost_sig[scan_pos] = cc_, cs_
                else:
                    pos_y = blk_pos >> log2
                    pos_x = blk_pos - (pos_y << log2)
                    ctx_sig = _sig_ctx(pattern, scan_idx, pos_x, pos_y,
                                       log2, comp)
                    level, cc_, cs_ = _get_coded_level(
                        cost_coeff[scan_pos], cost_coeff0[scan_pos],
                        cost_sig[scan_pos], scan_pos, level_double,
                        max_abs_level, ctx_sig, ctx_one, ctx_abs, go_rice,
                        c1_idx, c2_idx, qbits, err_scale, False, lam, eb)
                    cost_coeff[scan_pos], cost_sig[scan_pos] = cc_, cs_
                    sig_rate_delta[blk_pos] = (eb.sig_bits[ctx_sig][1]
                                               - eb.sig_bits[ctx_sig][0])
                delta_u[blk_pos] = (level_double - (level << qbits)) >> (qbits - 8)
                if level > 0:
                    rate_now = _get_ic_rate(level, ctx_one, ctx_abs, go_rice,
                                            c1_idx, c2_idx, eb)
                    rate_inc_up[blk_pos] = _get_ic_rate(
                        level + 1, ctx_one, ctx_abs, go_rice, c1_idx, c2_idx,
                        eb) - rate_now
                    rate_inc_down[blk_pos] = _get_ic_rate(
                        level - 1, ctx_one, ctx_abs, go_rice, c1_idx, c2_idx,
                        eb) - rate_now
                else:
                    rate_inc_up[blk_pos] = int(eb.greater_one_bits[ctx_one][0])
                dst[blk_pos] = level
                base_cost += cost_coeff[scan_pos]

                base_level = (2 + (1 if c2_idx < C2FLAG_NUMBER else 0)) \
                    if c1_idx < C1FLAG_NUMBER else 1
                if level >= base_level:
                    if level > 3 * (1 << go_rice):
                        go_rice = min(go_rice + 1, 4)
                if level >= 1:
                    c1_idx += 1
                if level > 1:
                    c1 = 0
                    c2 += (1 if c2 < 2 else 0)
                    c2_idx += 1
                elif 0 < c1 < 3 and level:
                    c1 += 1
                if (scan_pos % 16 == 0) and scan_pos > 0:
                    c2 = 0
                    go_rice = 0
                    c1_idx = 0
                    c2_idx = 0
                    ctx_set = 0 if (scan_pos == 16 or not is_luma) else 2
                    if c1 == 0:
                        ctx_set += 1
                    c1 = 1
            else:
                base_cost += cost_coeff0[scan_pos]
            rd_sig_cost += cost_sig[scan_pos]
            if pos_in_cg == 0:
                rd_sig_cost0 = cost_sig[scan_pos]
            if dst[blk_pos]:
                sig_cg[cg_blk_pos] = 1
                rd_coded_leveland_dist += cost_coeff[scan_pos] - cost_sig[scan_pos]
                rd_uncoded_dist += cost_coeff0[scan_pos]
                if pos_in_cg != 0:
                    rd_nnz_before_pos0 += 1

        if cg_last_scan_pos >= 0:
            if cg_scan_pos:
                if sig_cg[cg_blk_pos] == 0:
                    ctx_sig = _cg_ctx(sig_cg, cg_pos_x, cg_pos_y, width)
                    base_cost += lam * float(eb.sig_cg_bits[ctx_sig][0]) - rd_sig_cost
                    cost_cg_sig[cg_scan_pos] = lam * float(eb.sig_cg_bits[ctx_sig][0])
                else:
                    if cg_scan_pos < cg_last_scan_pos:
                        if rd_nnz_before_pos0 == 0:
                            base_cost -= rd_sig_cost0
                            rd_sig_cost -= rd_sig_cost0
                        cost_zero_cg = base_cost
                        ctx_sig = _cg_ctx(sig_cg, cg_pos_x, cg_pos_y, width)
                        base_cost += lam * float(eb.sig_cg_bits[ctx_sig][1])
                        cost_zero_cg += lam * float(eb.sig_cg_bits[ctx_sig][0])
                        cost_cg_sig[cg_scan_pos] = lam * float(eb.sig_cg_bits[ctx_sig][1])
                        cost_zero_cg += rd_uncoded_dist
                        cost_zero_cg -= rd_coded_leveland_dist
                        cost_zero_cg -= rd_sig_cost
                        if cost_zero_cg < base_cost:
                            sig_cg[cg_blk_pos] = 0
                            base_cost = cost_zero_cg
                            cost_cg_sig[cg_scan_pos] = lam * float(eb.sig_cg_bits[ctx_sig][0])
                            for pos_in_cg in range(cg_size - 1, -1, -1):
                                scan_pos = cg_scan_pos * cg_size + pos_in_cg
                                blk_pos = int(scan[scan_pos])
                                if dst[blk_pos]:
                                    dst[blk_pos] = 0
                                    cost_coeff[scan_pos] = cost_coeff0[scan_pos]
                                    cost_sig[scan_pos] = 0.0
            else:
                sig_cg[cg_blk_pos] = 1

    if last_scan_pos < 0:
        return dst, 0

    # ---- last position estimation (TComTrQuant.cpp:2096-2177) ----
    if is_luma and not is_intra and tr_depth == 0:
        ctx_cbf = 0
        best_cost = block_uncoded_cost + lam * float(eb.block_root_cbp_bits[ctx_cbf][0])
        base_cost += lam * float(eb.block_root_cbp_bits[ctx_cbf][1])
    else:
        # getCtxQtCbf: luma -> (trDepth==0 ? 1 : 0); chroma -> trDepth
        ctx = (1 if tr_depth == 0 else 0) if is_luma else tr_depth
        ctx_cbf = (0 if is_luma else 1) * 5 + ctx
        best_cost = block_uncoded_cost + lam * float(eb.block_cbp_bits[ctx_cbf][0])
        base_cost += lam * float(eb.block_cbp_bits[ctx_cbf][1])

    best_last_idx_p1 = 0
    found_last = False
    for cg_scan_pos in range(cg_last_scan_pos, -1, -1):
        cg_blk_pos = int(scan_cg[cg_scan_pos])
        base_cost -= cost_cg_sig[cg_scan_pos]
        if sig_cg[cg_blk_pos]:
            for pos_in_cg in range(cg_size - 1, -1, -1):
                scan_pos = cg_scan_pos * cg_size + pos_in_cg
                if scan_pos > last_scan_pos:
                    continue
                blk_pos = int(scan[scan_pos])
                if dst[blk_pos]:
                    pos_y = blk_pos >> log2
                    pos_x = blk_pos - (pos_y << log2)
                    if scan_idx == rom.SCAN_VER:
                        cost_last = _rate_last(pos_y, pos_x, lam, eb)
                    else:
                        cost_last = _rate_last(pos_x, pos_y, lam, eb)
                    total_cost = base_cost + cost_last - cost_sig[scan_pos]
                    if total_cost < best_cost:
                        best_last_idx_p1 = scan_pos + 1
                        best_cost = total_cost
                    if dst[blk_pos] > 1:
                        found_last = True
                        break
                    base_cost -= cost_coeff[scan_pos]
                    base_cost += cost_coeff0[scan_pos]
                else:
                    base_cost -= cost_sig[scan_pos]
            if found_last:
                break

    abs_sum = 0
    for scan_pos in range(best_last_idx_p1):
        blk_pos = int(scan[scan_pos])
        level = int(dst[blk_pos])
        abs_sum += level
        dst[blk_pos] = -level if flat[blk_pos] < 0 else level
    for scan_pos in range(best_last_idx_p1, last_scan_pos + 1):
        dst[int(scan[scan_pos])] = 0

    # ---- RDOQ sign-bit hiding (TComTrQuant.cpp:2180+) ----
    if sign_hide and abs_sum >= 2:
        inv_q = int(rom.INV_QUANT_SCALES[qp_rem])
        rd_factor = int(float(inv_q) * float(inv_q) * float(1 << (2 * qp_per))
                        / lam / 16.0 / float(1 << (2 * bit_increment)) + 0.5)
        last_cg = -1
        for subset in range((max_coeff - 1) >> 4, -1, -1):
            sub_pos = subset << 4
            first_nz = 16
            last_nz = -1
            for n in range(15, -1, -1):
                if dst[int(scan[n + sub_pos])]:
                    last_nz = n
                    break
            for n in range(16):
                if dst[int(scan[n + sub_pos])]:
                    first_nz = n
                    break
            s = 0
            for n in range(first_nz, last_nz + 1):
                s += int(dst[int(scan[n + sub_pos])])
            if last_nz >= 0 and last_cg == -1:
                last_cg = 1
            if last_nz - first_nz >= SBH_THRESHOLD:
                signbit = 0 if dst[int(scan[sub_pos + first_nz])] > 0 else 1
                if signbit != (s & 1):
                    min_cost_inc = MAX_INT64
                    min_pos = -1
                    final_change = 0
                    start_n = last_nz if last_cg == 1 else 15
                    for n in range(start_n, -1, -1):
                        blk = int(scan[n + sub_pos])
                        if dst[blk] != 0:
                            cost_up = rd_factor * (-int(delta_u[blk])) + int(rate_inc_up[blk])
                            cost_down = rd_factor * int(delta_u[blk]) + int(rate_inc_down[blk]) \
                                - ((1 << 15) + int(sig_rate_delta[blk])
                                   if abs(int(dst[blk])) == 1 else 0)
                            if last_cg == 1 and last_nz == n and abs(int(dst[blk])) == 1:
                                cost_down -= 4 << 15
                            if cost_up < cost_down:
                                cur_cost = cost_up
                                cur_change = 1
                            else:
                                cur_change = -1
                                if n == first_nz and abs(int(dst[blk])) == 1:
                                    cur_cost = MAX_INT64
                                else:
                                    cur_cost = cost_down
                        else:
                            cur_cost = rd_factor * (-abs(int(delta_u[blk]))) \
                                + (1 << 15) + int(rate_inc_up[blk]) \
                                + int(sig_rate_delta[blk])
                            cur_change = 1
                            if n < first_nz:
                                this_sign = 0 if flat[blk] >= 0 else 1
                                if this_sign != signbit:
                                    cur_cost = MAX_INT64
                        if cur_cost < min_cost_inc:
                            min_cost_inc = cur_cost
                            final_change = cur_change
                            min_pos = blk
                    if dst[min_pos] == 32767 or dst[min_pos] == -32768:
                        final_change = -1
                    if flat[min_pos] >= 0:
                        dst[min_pos] += final_change
                    else:
                        dst[min_pos] -= final_change
            if last_cg == 1:
                last_cg = 0

    return dst, abs_sum


def _rate_last(pos_x, pos_y, lam, eb: EstBits) -> float:
    cx = int(rom.GROUP_IDX[pos_x])
    cy = int(rom.GROUP_IDX[pos_y])
    cost = float(eb.last_x_bits[cx] + eb.last_y_bits[cy])
    if cx > 3:
        cost += IEP_RATE * ((cx - 2) >> 1)
    if cy > 3:
        cost += IEP_RATE * ((cy - 2) >> 1)
    return lam * cost


def _cg_ctx(sig_cg, cg_x, cg_y, width) -> int:
    n = width >> 2
    right = int(sig_cg[cg_y * n + cg_x + 1] != 0) if cg_x < n - 1 else 0
    lower = int(sig_cg[(cg_y + 1) * n + cg_x] != 0) if cg_y < n - 1 else 0
    return 1 if (right or lower) else 0


def _calc_pattern(sig_cg, cg_x, cg_y, width) -> int:
    if width == 4:
        return -1
    n = width >> 2
    right = int(sig_cg[cg_y * n + cg_x + 1] != 0) if cg_x < n - 1 else 0
    lower = int(sig_cg[(cg_y + 1) * n + cg_x] != 0) if cg_y < n - 1 else 0
    return right + (lower << 1)


def _sig_ctx(pattern, scan_idx, pos_x, pos_y, log2, comp) -> int:
    CTX_IND_MAP = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8)
    if pos_x + pos_y == 0:
        return 0
    if log2 == 2:
        return CTX_IND_MAP[4 * pos_y + pos_x]
    if log2 == 3:
        offset = 9 if scan_idx == rom.SCAN_DIAG else 15
    else:
        offset = 21 if comp == 0 else 12
    pxs = pos_x & 3
    pys = pos_y & 3
    if pattern == 0:
        s = pxs + pys
        cnt = (2 if s == 0 else 1) if s <= 2 else 0
    elif pattern == 1:
        cnt = (2 if pys == 0 else 1) if pys <= 1 else 0
    elif pattern == 2:
        cnt = (2 if pxs == 0 else 1) if pxs <= 1 else 0
    else:
        cnt = 2
    luma_extra = 3 if (comp == 0 and ((pos_x >> 2) + (pos_y >> 2)) > 0) else 0
    return luma_extra + offset + cnt
