"""Deblocking filter — frame-level, vectorized over edges.

Behavioral reference: TComLoopFilter.cpp — loopFilterPic (:153, all vertical
edges then all horizontal), xSetEdgefilterTU/PU (:293,:329), boundary
strength xGetBoundaryStrengthSingle (:444, intra => BS 2), luma kernel
xPelFilterLuma (:799, strong/weak + per-side decisions), chroma kernel
xPelFilterChroma (:870), tables tctable_8x8/betatable_8x8 (:59,:64),
chroma QP via QpUV (:51 — note: clipped to 0..51, no chroma offset).

The TPU mapping: edges on the 8-pel grid are mutually independent within a
direction, so each direction is one batched kernel over [num_edges, 4] line
groups; the two directions are two sequential kernel launches.
"""

from __future__ import annotations

import numpy as np

from ..common.rom import CHROMA_SCALE

TC_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11,
     13, 14, 16, 18, 20, 22, 24], np.int32)
BETA_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11, 12,
     13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38, 40, 42,
     44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64], np.int32)

DEFAULT_INTRA_TC_OFFSET = 2


def _clip3(lo, hi, v):
    return np.minimum(hi, np.maximum(lo, v))


def filter_luma_edges(plane: np.ndarray, edge_flags: np.ndarray,
                      bs: np.ndarray, qp_p: np.ndarray, qp_q: np.ndarray,
                      no_filter_p: np.ndarray, no_filter_q: np.ndarray,
                      direction: int, beta_offset: int, tc_offset: int,
                      bit_depth: int) -> None:
    """Filter all luma edges in one direction, in place.

    edge_flags/bs/qp_*/no_filter_*: per 4x4 unit [uh, uw]; an entry at
    (uy, ux) describes the edge segment on the left (direction 0 = VER) or
    top (direction 1 = HOR) boundary of that unit, covering 4 lines.
    Only units on the 8-pel grid in the edge-normal direction are filtered.
    """
    if direction == 1:
        # filter horizontal edges by operating on the transpose
        filter_luma_edges(plane.T, edge_flags.T, bs.T, qp_p.T, qp_q.T,
                          no_filter_p.T, no_filter_q.T, 0, beta_offset,
                          tc_offset, bit_depth)
        return

    uh, uw = edge_flags.shape
    scale = 1 << (bit_depth - 8)
    max_val = (1 << bit_depth) - 1
    p = plane
    for ucol in range(2, uw, 2):       # 8-pel aligned edge columns, col 0 = pic edge
        col_flags = edge_flags[:, ucol] & (bs[:, ucol] > 0)
        if not col_flags.any():
            continue
        rows = np.nonzero(col_flags)[0]
        x = ucol * 4
        qp = (qp_p[rows, ucol].astype(np.int32) + qp_q[rows, ucol] + 1) >> 1
        b = bs[rows, ucol].astype(np.int32)
        idx_tc = _clip3(0, 53, qp + DEFAULT_INTRA_TC_OFFSET * (b - 1)
                        + (tc_offset << 1))
        idx_b = _clip3(0, 51, qp + (beta_offset << 1))
        tc = TC_TABLE[idx_tc] * scale
        beta = BETA_TABLE[idx_b] * scale
        side_thresh = (beta + (beta >> 1)) >> 3
        thr_cut = tc * 10

        y0 = rows * 4
        # gather the 8-wide stripes [n, 4, 8] (4 lines per segment)
        n = len(rows)
        stripes = np.empty((n, 4, 8), np.int64)
        for i, y in enumerate(y0):
            stripes[i] = p[y:y + 4, x - 4:x + 4]
        m = [stripes[:, :, k] for k in range(8)]  # m0..m7, edge between m3|m4

        dp0 = np.abs(m[1][:, 0] - 2 * m[2][:, 0] + m[3][:, 0])
        dq0 = np.abs(m[4][:, 0] - 2 * m[5][:, 0] + m[6][:, 0])
        dp3 = np.abs(m[1][:, 3] - 2 * m[2][:, 3] + m[3][:, 3])
        dq3 = np.abs(m[4][:, 3] - 2 * m[5][:, 3] + m[6][:, 3])
        d0 = dp0 + dq0
        d3 = dp3 + dq3
        dpp = dp0 + dp3
        dqq = dq0 + dq3
        d = d0 + d3

        do_filter = d < beta
        filter_p = dpp < side_thresh
        filter_q = dqq < side_thresh

        def strong_check(line):
            ds = (np.abs(m[0][:, line] - m[3][:, line])
                  + np.abs(m[7][:, line] - m[4][:, line]))
            dd = d0 if line == 0 else d3
            return ((ds < (beta >> 3)) & (2 * dd < (beta >> 2))
                    & (np.abs(m[3][:, line] - m[4][:, line]) < ((tc * 5 + 1) >> 1)))

        sw = strong_check(0) & strong_check(3)

        tcv = tc[:, None]
        # strong filter outputs
        s_m3 = _clip3(m[3] - 2 * tcv, m[3] + 2 * tcv,
                      (m[1] + 2 * m[2] + 2 * m[3] + 2 * m[4] + m[5] + 4) >> 3)
        s_m4 = _clip3(m[4] - 2 * tcv, m[4] + 2 * tcv,
                      (m[2] + 2 * m[3] + 2 * m[4] + 2 * m[5] + m[6] + 4) >> 3)
        s_m2 = _clip3(m[2] - 2 * tcv, m[2] + 2 * tcv,
                      (m[1] + m[2] + m[3] + m[4] + 2) >> 2)
        s_m5 = _clip3(m[5] - 2 * tcv, m[5] + 2 * tcv,
                      (m[3] + m[4] + m[5] + m[6] + 2) >> 2)
        s_m1 = _clip3(m[1] - 2 * tcv, m[1] + 2 * tcv,
                      (2 * m[0] + 3 * m[1] + m[2] + m[3] + m[4] + 4) >> 3)
        s_m6 = _clip3(m[6] - 2 * tcv, m[6] + 2 * tcv,
                      (m[3] + m[4] + m[5] + 3 * m[6] + 2 * m[7] + 4) >> 3)

        # weak filter
        delta = (9 * (m[4] - m[3]) - 3 * (m[5] - m[2]) + 8) >> 4
        weak_ok = np.abs(delta) < thr_cut[:, None]
        delta_c = _clip3(-tcv, tcv, delta)
        w_m3 = np.clip(m[3] + delta_c, 0, max_val)
        w_m4 = np.clip(m[4] - delta_c, 0, max_val)
        tc2 = (tc >> 1)[:, None]
        delta1 = _clip3(-tc2, tc2, (((m[1] + m[3] + 1) >> 1) - m[2] + delta_c) >> 1)
        w_m2 = np.clip(m[2] + delta1, 0, max_val)
        delta2 = _clip3(-tc2, tc2, (((m[6] + m[4] + 1) >> 1) - m[5] - delta_c) >> 1)
        w_m5 = np.clip(m[5] + delta2, 0, max_val)

        swv = sw[:, None]
        dfv = do_filter[:, None]
        fpv = filter_p[:, None]
        fqv = filter_q[:, None]
        npv = no_filter_p[rows, ucol][:, None]
        nqv = no_filter_q[rows, ucol][:, None]

        out = {k: m[k].copy() for k in range(8)}
        # strong path
        out[3] = np.where(dfv & swv, s_m3, out[3])
        out[4] = np.where(dfv & swv, s_m4, out[4])
        out[2] = np.where(dfv & swv, s_m2, out[2])
        out[5] = np.where(dfv & swv, s_m5, out[5])
        out[1] = np.where(dfv & swv, s_m1, out[1])
        out[6] = np.where(dfv & swv, s_m6, out[6])
        # weak path
        wsel = dfv & ~swv & weak_ok
        out[3] = np.where(wsel, w_m3, out[3])
        out[4] = np.where(wsel, w_m4, out[4])
        out[2] = np.where(wsel & fpv, w_m2, out[2])
        out[5] = np.where(wsel & fqv, w_m5, out[5])
        # PCM / lossless suppression
        for k in (1, 2, 3):
            out[k] = np.where(npv, m[k], out[k])
        for k in (4, 5, 6):
            out[k] = np.where(nqv, m[k], out[k])

        for i, y in enumerate(y0):
            for k in range(1, 7):
                p[y:y + 4, x - 4 + k] = out[k][i]


def filter_chroma_edges(cb: np.ndarray, cr: np.ndarray,
                        edge_flags: np.ndarray, bs: np.ndarray,
                        qp_p: np.ndarray, qp_q: np.ndarray,
                        no_filter_p: np.ndarray, no_filter_q: np.ndarray,
                        direction: int, tc_offset: int, bit_depth: int) -> None:
    """Chroma deblocking (BS > 1 only, 16-luma-pel edge grid).

    Arrays are per luma 4x4 unit as in filter_luma_edges; each chroma edge
    segment covers 2 chroma lines (one luma unit).
    """
    if direction == 1:
        filter_chroma_edges(cb.T, cr.T, edge_flags.T, bs.T, qp_p.T, qp_q.T,
                            no_filter_p.T, no_filter_q.T, 0, tc_offset,
                            bit_depth)
        return
    uh, uw = edge_flags.shape
    scale = 1 << (bit_depth - 8)
    max_val = (1 << bit_depth) - 1
    for ucol in range(4, uw, 4):     # every 16 luma pels
        col = edge_flags[:, ucol] & (bs[:, ucol] > 1)
        if not col.any():
            continue
        rows = np.nonzero(col)[0]
        xc = ucol * 2
        qp_avg = (qp_p[rows, ucol].astype(np.int32) + qp_q[rows, ucol] + 1) >> 1
        qp = CHROMA_SCALE[_clip3(0, 51, qp_avg)]
        b = bs[rows, ucol].astype(np.int32)
        idx_tc = _clip3(0, 53, qp + DEFAULT_INTRA_TC_OFFSET * (b - 1)
                        + (tc_offset << 1))
        tc = (TC_TABLE[idx_tc] * scale)[:, None]
        npv = no_filter_p[rows, ucol][:, None]
        nqv = no_filter_q[rows, ucol][:, None]
        for plane in (cb, cr):
            n = len(rows)
            stripes = np.empty((n, 2, 4), np.int64)
            for i, r in enumerate(rows):
                yc = r * 2
                stripes[i] = plane[yc:yc + 2, xc - 2:xc + 2]
            m2, m3, m4, m5 = (stripes[:, :, k] for k in range(4))
            delta = _clip3(-tc, tc, ((((m4 - m3) << 2) + m2 - m5 + 4) >> 3))
            o3 = np.clip(m3 + delta, 0, max_val)
            o4 = np.clip(m4 - delta, 0, max_val)
            o3 = np.where(npv, m3, o3)
            o4 = np.where(nqv, m4, o4)
            for i, r in enumerate(rows):
                yc = r * 2
                plane[yc:yc + 2, xc - 1] = o3[i]
                plane[yc:yc + 2, xc] = o4[i]
