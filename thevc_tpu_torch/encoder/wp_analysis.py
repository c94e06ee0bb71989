"""Weighted-prediction analysis: per-picture AC/DC statistics, LMS weight
estimation with the range-limit denominator loop, and the SAD-based
per-reference selection.

Behavioral reference: WeightPredAnalysis.cpp (xCalcACDCParamSlice :71,
xUpdatingWPParameters :252, xSelectWP :313, xCheckWPEnable :135,
DTHRESH=0.99) with WP_PARAM_RANGE_LIMIT active (TypeDef.h:98).
"""

from __future__ import annotations

import numpy as np

DTHRESH = 0.99


def calc_acdc(planes) -> list:
    """(normalized DC, AC) per component of the original picture."""
    out = []
    for p in planes:
        a = p.astype(np.int64)
        n = a.size
        dc = int(a.sum())
        norm_dc = (dc + (n >> 1)) // n
        ac = int(np.abs(a - norm_dc).sum())
        out.append((norm_dc, ac))
    return out


def _updating_wp_parameters(sh, lists, cur_acdc, log2_denom, bit_depth):
    """xUpdatingWPParameters: returns (table, ok)."""
    real_denom = log2_denom + bit_depth - 8
    real_offset = 1 << (real_denom - 1)
    num_dir = 2 if sh.slice_type == 0 else 1
    table = [[[None] * 3 for _ in range(16)] for _ in range(2)]
    for lst in range(num_dir):
        for ref in range(sh.num_ref_idx[lst]):
            ref_acdc = lists[lst][ref].wp_acdc
            for comp in range(3):
                cur_dc, cur_ac = cur_acdc[comp]
                ref_dc, ref_ac = ref_acdc[comp]
                dweight = 1.0 if ref_ac == 0 else \
                    min(15.0, max(-16.0, cur_ac / ref_ac))
                weight = int(0.5 + dweight * (1 << log2_denom))
                offset = int(((cur_dc << log2_denom) - weight * ref_dc
                              + real_offset) >> real_denom)
                if comp:
                    shift = 1 << (bit_depth - 1)
                    pred = shift - ((shift * weight) >> log2_denom)
                    delta = max(-512, min(511, offset - pred))
                    offset = max(-128, min(127, delta + pred))
                default = 1 << log2_denom
                if not (-128 <= default - weight <= 127):
                    return None, False
                table[lst][ref][comp] = (True, weight, offset)
    return table, True


def _sad_wp(org, ref, denom, weight, offset, bit_depth) -> int:
    """xCalcSADvalueWP: mean |org<<denom - (ref*w + offset<<realDenom)|."""
    real_denom = denom + bit_depth - 8
    o = org.astype(np.int64) << denom
    r = ref.astype(np.int64) * weight + (offset << real_denom)
    return int(np.abs(o - r).sum()) // org.size


def estimate_wp_param_slice(sh, lists, org_planes, bit_depth) -> dict:
    """xEstimateWPParamSlice: fill the slice WP table (wp_scaling dict)."""
    cur_acdc = sh.wp_acdc
    denom = 7 if sh.num_ref_idx[0] > 3 else 6
    while True:
        table, ok = _updating_wp_parameters(sh, lists, cur_acdc, denom,
                                            bit_depth)
        if ok:
            break
        denom -= 1

    # xSelectWP: compare whole-picture SAD with/without the weights
    num_dir = 2 if sh.slice_type == 0 else 1
    default = 1 << denom
    for lst in range(num_dir):
        for ref in range(sh.num_ref_idx[lst]):
            pic = lists[lst][ref]
            refs = (pic.rec_y, pic.rec_cb, pic.rec_cr)
            sad_wp = sad_no = 0
            for comp in range(3):
                _p, w, o = table[lst][ref][comp]
                sad_wp += _sad_wp(org_planes[comp], refs[comp], denom, w, o,
                                  bit_depth)
                sad_no += _sad_wp(org_planes[comp], refs[comp], denom,
                                  default, 0, bit_depth)
            if sad_wp / sad_no >= DTHRESH:
                for comp in range(3):
                    table[lst][ref][comp] = (False, default, 0)

    # fill the untouched entries with defaults (setWpScaling of m_wp)
    for lst in range(2):
        for ref in range(16):
            for comp in range(3):
                if table[lst][ref][comp] is None:
                    table[lst][ref][comp] = (False, default, 0)
    return {"luma_log2_denom": denom, "chroma_log2_denom": denom,
            "wp": table}


def check_wp_enable(wp_scaling, sh) -> bool:
    """xCheckWPEnable: True when any present flag survives; otherwise the
    table is reset to denominator-0 identity (in place)."""
    present = 0
    for lst in range(2):
        for ref in range(16):
            for comp in range(3):
                present += int(wp_scaling["wp"][lst][ref][comp][0])
    if present:
        return True
    for lst in range(2):
        for ref in range(16):
            for comp in range(3):
                wp_scaling["wp"][lst][ref][comp] = (False, 1, 0)
    wp_scaling["luma_log2_denom"] = 0
    wp_scaling["chroma_log2_denom"] = 0
    return False
