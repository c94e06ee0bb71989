"""Inter prediction search: AMVP estimation, TZ integer motion search,
half/quarter-pel refinement, merge estimation, and the inter residual
quadtree RD.

Behavioral reference: TEncSearch.cpp (predInterSearch :3184,
xMotionEstimation :4120, xSetSearchRange :4209, xPatternSearch :4227,
xTZSearch :4302 + TZ_SEARCH_CONFIGURATION :293, xTZSearchHelp :312,
xTZ8PointDiamondSearch :536, xTZ2PointSearch :351, xPatternSearchFracDIF
:4476, xExtDIFUpSamplingH :5982, xExtDIFUpSamplingQ :6023,
xPatternRefinement :711, xEstimateMvPredAMVP :3839, xGetTemplateCost :4057,
xCheckBestMVP :4012, xGetBlkBits :3954, xGetMvpIdxBits :3928,
xMergeEstimation :3096, xGetInterPredictionError :3059,
encodeResAndCalcRdInterCU :4526, xEstimateResidualQT :4782,
xEncodeResidualQT :5674, xSetResidualQTData :5787, xAddSymbolBitsInter
:5937) and TComRdCost motion-cost fixed point (TComRdCost.h:185-210).

Host-side this is the sequential RD driver; the SAD/SATD sweeps and the
separable interpolation are batched numpy (ops.jx mirrors the SSE/SATD
reductions on device; interpolation stays host-side) — each candidate
position is an independent reduction, which is exactly the shape the TPU
kernels consume.
"""

from __future__ import annotations

import math

import numpy as np

from ..common import rom
from ..decoder.frame import (MODE_INTER, SIZE_2Nx2N, SIZE_2NxN, SIZE_2NxnD,
                             SIZE_2NxnU, SIZE_NxN, SIZE_Nx2N, SIZE_nLx2N,
                             SIZE_nRx2N)
from ..decoder.mv import clip_mv, num_pus, pu_geometry
from ..ops import transforms as tops
from ..ops.interp import LUMA_FILTER, _filter_1d, _filter_copy, mc_luma
from .rdcost import calc_had

MAX_UINT = 0xFFFFFFFF
RQTDBG = None
MAX_INT = 0x7FFFFFFF
MAX_DOUBLE = 1.7e308
AMVP_MAX_NUM_CANDS = 2
MRG_MAX_NUM_CANDS_SIGNALED = 5


def _component_bits(v: int) -> int:
    """TComRdCost::xGetComponentBits."""
    temp = (-v << 1) + 1 if v <= 0 else (v << 1)
    length = 1
    while temp != 1:
        temp >>= 1
        length += 2
    return length


class MotionCost:
    """Fixed-point motion lambda cost (m_uiCost / getCost / getBits)."""

    def __init__(self, rd):
        self.rd = rd
        self.cost = 0
        self.pred = (0, 0)
        self.scale = 0

    def motion_cost_sad(self):
        self.cost = self.rd.lambda_motion_sad

    def set_predictor(self, mv):
        self.pred = (int(mv[0]), int(mv[1]))

    def set_cost_scale(self, s):
        self.scale = s

    def bits(self, x, y):
        return _component_bits((x << self.scale) - self.pred[0]) + \
            _component_bits((y << self.scale) - self.pred[1])

    def cost_pts(self, x, y):
        return (self.cost * self.bits(x, y)) >> 16

    def cost_bits(self, b):
        return (self.cost * b) >> 16

    def rd_cost_sad(self, bits, dist):
        """calcRdCost(bits, dist, false, DF_SAD)."""
        return float(int(dist + (int(bits * float(self.rd.lambda_motion_sad)
                                     + 0.5) >> 16)))


def _sad(org, cur, sub_shift, bit_inc):
    if sub_shift:
        org = org[::2]
        cur = cur[::2]
    s = int(np.abs(org.astype(np.int32) - cur.astype(np.int32)).sum())
    return (s << sub_shift) >> bit_inc


# half/quarter-pel refinement offsets (TEncSearch.cpp:47)
REFINE_H = [(0, 0), (0, -1), (0, 1), (-1, 0), (1, 0),
            (-1, -1), (1, -1), (-1, 1), (1, 1)]
REFINE_Q = [(0, 0), (0, -1), (0, 1), (-1, -1), (1, -1),
            (-1, 0), (1, 0), (-1, 1), (1, 1)]


class InterSearch:
    """Per-slice inter search state bound to a CuEncoder."""

    def __init__(self, cu, lists, mvctx, fast_enc: bool, use_had_me: bool,
                 search_range: int, bipred_range: int, fdm: bool):
        self.cu = cu
        self.f = cu.f
        self.sh = cu.sh
        self.sps = cu.sps
        self.pps = cu.pps
        self.rd = cu.rd
        self.lists = lists
        self.mvctx = mvctx
        self.fast_enc = fast_enc
        self.use_had_me = use_had_me
        self.search_range = search_range
        self.bipred_range = bipred_range
        self.fdm = fdm
        self.bit_inc = cu.bit_inc
        self.mc = MotionCost(cu.rd)
        self.is_b = cu.sh.slice_type == 0
        # mvp idx cost with iNum=AMVP_MAX_NUM_CANDS (xGetMvpIdxBits): 1 bit
        self.mvp_idx_cost = [1, 1]
        ctu = self.f.ctu_size
        self.pred_y = np.zeros((ctu, ctu), np.int16)
        self.pred_cb = np.zeros((ctu // 2, ctu // 2), np.int16)
        self.pred_cr = np.zeros((ctu // 2, ctu // 2), np.int16)
        self.resi_y = np.zeros((ctu, ctu), np.int32)
        self.resi_cb = np.zeros((ctu // 2, ctu // 2), np.int32)
        self.resi_cr = np.zeros((ctu // 2, ctu // 2), np.int32)
        self.resi_best_y = np.zeros((ctu, ctu), np.int32)
        self.resi_best_cb = np.zeros((ctu // 2, ctu // 2), np.int32)
        self.resi_best_cr = np.zeros((ctu // 2, ctu // 2), np.int32)
        nlayers = (cu.sps.quadtree_tu_log2_max_size
                   - cu.sps.quadtree_tu_log2_min_size + 1)
        self.qt_resi = [dict(y=np.zeros((ctu, ctu), np.int32),
                             cb=np.zeros((ctu // 2, ctu // 2), np.int32),
                             cr=np.zeros((ctu // 2, ctu // 2), np.int32))
                        for _ in range(nlayers)]
        self.qt_coeff = [dict(y=np.zeros((ctu, ctu), np.int32),
                              cb=np.zeros((ctu // 2, ctu // 2), np.int32),
                              cr=np.zeros((ctu // 2, ctu // 2), np.int32))
                         for _ in range(nlayers)]

    # ------------------------------------------------------------------
    # weighted-prediction ME support (TComRdCostWeightPrediction.cpp,
    # TEncSearch::setWpScalingDistParam :6183)
    # ------------------------------------------------------------------
    def _wp_active(self) -> bool:
        """Live flags: the slice-level WP disable toggles the PPS flags
        during compression (xCheckWPEnable / xRestoreWPparam)."""
        return ((self.sh.slice_type == 1 and self.pps.use_wp) or
                (self.sh.slice_type == 0 and self.pps.wp_bipred))

    def _wp_luma_params(self, lst: int, ref: int):
        """Uni-derived (w, offset, shift, round) for luma (getWpScaling)."""
        w = self.sh.wp_scaling["wp"][lst][ref][0]
        denom = self.sh.wp_scaling["luma_log2_denom"]
        bd = self.sps.internal_bit_depth
        offset = w[2] * (1 << (bd - 8))
        rnd = (1 << (denom - 1)) if denom >= 1 else 0
        return w[1], offset, denom, rnd

    _wp_plane_cache: dict

    def _weighted_plane(self, lst: int, ref: int):
        """Padded reference plane with the ME weighting pre-applied:
        pred = ((w*ref + round) >> shift) + offset (xGetSADw, no clip)."""
        cache = getattr(self, "_wp_planes", None)
        if cache is None:
            cache = self._wp_planes = {}
        key = (lst, ref)
        p = cache.get(key)
        if p is None:
            w, offset, shift, rnd = self._wp_luma_params(lst, ref)
            pad_y = self.lists[lst][ref].padded()[0]
            p = (((w * pad_y.astype(np.int32) + rnd) >> shift)
                 + offset).astype(np.int16)
            cache[key] = p
        return p

    def _wp_weight_block(self, blk, lst, ref):
        """Weight interpolated samples for the fractional SATD/SAD."""
        w, offset, shift, rnd = self._wp_luma_params(lst, ref)
        return (((w * blk.astype(np.int32) + rnd) >> shift)
                + offset).astype(np.int16)

    # ------------------------------------------------------------------
    # small helpers
    # ------------------------------------------------------------------
    def _clip(self, mv, cu_x, cu_y):
        return clip_mv(mv, cu_x, cu_y, self.f.width, self.f.height,
                       self.f.ctu_size)

    def _set_pu_motion(self, xp, yp, pw, ph, lst, ref, mv, mvd=(0, 0),
                       mvp_idx=-1):
        f = self.f
        ux, uy, uw, uh = xp // 4, yp // 4, pw // 4, ph // 4
        f.ref_idx[lst, uy:uy + uh, ux:ux + uw] = ref
        f.mv[lst, uy:uy + uh, ux:ux + uw] = mv
        f.mvd[lst, uy:uy + uh, ux:ux + uw] = mvd
        f.mvp_idx[lst, uy:uy + uh, ux:ux + uw] = mvp_idx

    def _set_pu(self, arr, xp, yp, pw, ph, val):
        arr[yp // 4:(yp + ph) // 4, xp // 4:(xp + pw) // 4] = val

    def _org_pu(self, xp, yp, pw, ph):
        return self.cu.org_y[yp:yp + ph, xp:xp + pw]

    # ------------------------------------------------------------------
    # motion compensation over the whole CU (encoder side)
    # ------------------------------------------------------------------
    def motion_compensation(self, cu_x, cu_y, size, part_idx=-1):
        """TComPrediction::motionCompensation into self.pred_*, at the CU's
        CTU-local position."""
        from ..decoder.inter import InterPredictor
        ip = InterPredictor(self.f, self.sh, self.sps, self.pps,
                            self.lists[0], self.lists[1])
        part_sz = int(self.f.part_size_arr[cu_y // 4, cu_x // 4])
        lx = cu_x % self.f.ctu_size
        ly = cu_y % self.f.ctu_size
        for pu in range(num_pus(part_sz)):
            if part_idx >= 0 and pu != part_idx:
                continue
            xp, yp, pw, ph = pu_geometry(part_sz, cu_x, cu_y, size, pu)
            ip._predict_pu(cu_x, cu_y, xp, yp, pw, ph,
                           self.pred_y[ly:ly + size, lx:lx + size],
                           self.pred_cb[ly // 2:(ly + size) // 2,
                                        lx // 2:(lx + size) // 2],
                           self.pred_cr[ly // 2:(ly + size) // 2,
                                        lx // 2:(lx + size) // 2],
                           cu_x, cu_y)

    def _pred_pu_luma(self, xp, yp, pw, ph, lst, ref, mv, cu_x, cu_y):
        """xPredInterLumaBlk (uni, pixel domain) for one PU."""
        pic = self.lists[lst][ref]
        mvc = self._clip(mv, cu_x, cu_y)
        pad_y = pic.padded()[0]
        return mc_luma(pad_y, pic.margin, xp, yp, mvc[0], mvc[1], pw, ph,
                       self.sps.internal_bit_depth, False)

    # ------------------------------------------------------------------
    # AMVP estimation
    # ------------------------------------------------------------------
    def _estimate_mvp_amvp(self, cu_x, cu_y, size, part_sz, pu_idx, lst,
                           ref_idx):
        """xEstimateMvPredAMVP; returns (mv_pred, mvp_idx, amvp_cands,
        dist_bip)."""
        cands = self.mvctx.amvp_candidates(cu_x, cu_y, size, part_sz,
                                           pu_idx, lst, ref_idx)
        xp, yp, pw, ph = pu_geometry(part_sz, cu_x, cu_y, size, pu_idx)
        org = self._org_pu(xp, yp, pw, ph)
        best_cost = MAX_INT
        best_idx = 0
        dist_bip = MAX_INT
        for i, cand in enumerate(cands):
            pred = self._pred_pu_luma(xp, yp, pw, ph, lst, ref_idx,
                                      cand, cu_x, cu_y)
            dist = _sad(org, pred, 0, self.bit_inc)
            cost = int(self.mc.rd_cost_sad(self.mvp_idx_cost[i], dist))
            if best_cost > cost:
                best_cost = cost
                best_idx = i
                dist_bip = cost
        return cands[best_idx], best_idx, cands, dist_bip

    def _check_best_mvp(self, cands, mv, mv_pred, mvp_idx, bits, cost):
        """xCheckBestMVP; returns (mv_pred, mvp_idx, bits, cost)."""
        if len(cands) < 2:
            return mv_pred, mvp_idx, bits, cost
        self.mc.motion_cost_sad()
        self.mc.set_cost_scale(0)
        self.mc.set_predictor(mv_pred)
        org_mv_bits = self.mc.bits(mv[0], mv[1]) + self.mvp_idx_cost[mvp_idx]
        best_bits = org_mv_bits
        best_idx = mvp_idx
        for i, cand in enumerate(cands):
            if i == mvp_idx:
                continue
            self.mc.set_predictor(cand)
            b = self.mc.bits(mv[0], mv[1]) + self.mvp_idx_cost[i]
            if b < best_bits:
                best_bits = b
                best_idx = i
        if best_idx != mvp_idx:
            new_bits = bits - org_mv_bits + best_bits
            cost = (cost - self.mc.cost_bits(bits)) + \
                self.mc.cost_bits(new_bits)
            return cands[best_idx], best_idx, new_bits, cost
        return mv_pred, mvp_idx, bits, cost

    # ------------------------------------------------------------------
    # integer + fractional motion estimation
    # ------------------------------------------------------------------
    def _motion_estimation(self, cu_x, cu_y, xp, yp, pw, ph, lst, ref_idx,
                           mv_pred, bits_in, bi_mv=None, bi_other=None):
        """xMotionEstimation; returns (mv, bits, cost)."""
        f = self.f
        bi = bi_mv is not None
        srch_rng = self.bipred_range if bi else self.search_range
        org = self._org_pu(xp, yp, pw, ph).astype(np.int32)
        if bi:
            # remove high freq: 2*org - otherPred (no clip,
            # DISABLING_CLIP_FOR_BIPREDME)
            org = 2 * org - bi_other.astype(np.int32)
        pic = self.lists[lst][ref_idx]
        pad_y, _, _ = pic.padded()
        m = pic.margin

        # search range (xSetSearchRange)
        base = bi_mv if bi else mv_pred
        ctmp = self._clip((int(base[0]), int(base[1])), cu_x, cu_y)
        sr_lt = (ctmp[0] - (srch_rng << 2), ctmp[1] - (srch_rng << 2))
        sr_rb = (ctmp[0] + (srch_rng << 2), ctmp[1] + (srch_rng << 2))
        sr_lt = self._clip(sr_lt, cu_x, cu_y)
        sr_rb = self._clip(sr_rb, cu_x, cu_y)
        sr_lt = (sr_lt[0] >> 2, sr_lt[1] >> 2)
        sr_rb = (sr_rb[0] >> 2, sr_rb[1] >> 2)

        self.mc.motion_cost_sad()
        self.mc.set_predictor(mv_pred)
        self.mc.set_cost_scale(2)

        sub_shift = 1 if (self.fast_enc and ph > 8) else 0
        wp = self._wp_active()
        if wp:
            # weighted SAD ignores the subsampling shift (xGetSADw)
            sub_shift = 0
            sad_plane = self._weighted_plane(lst, ref_idx)
        else:
            sad_plane = pad_y

        def sad_at(x, y):
            blk = sad_plane[m + yp + y:m + yp + y + ph,
                            m + xp + x:m + xp + x + pw]
            return _sad(org, blk, sub_shift, self.bit_inc) + \
                self.mc.cost_pts(x, y)

        if bi:
            mv_int, cost = self._full_search(sad_at, sr_lt, sr_rb)
        else:
            start = self._clip(mv_pred, cu_x, cu_y)
            mv_int, cost = self._tz_search(sad_at, sr_lt, sr_rb,
                                           (start[0] >> 2, start[1] >> 2))

        # fractional refinement
        self.mc.motion_cost_sad()
        self.mc.set_cost_scale(1)
        mv_half, mv_qter, cost = self._frac_search(
            org if not bi else org, pad_y, m, xp, yp, pw, ph, mv_int,
            wp_ref=(lst, ref_idx) if wp else None)

        self.mc.set_cost_scale(0)
        mv = (mv_int[0] * 4 + mv_half[0] * 2 + mv_qter[0],
              mv_int[1] * 4 + mv_half[1] * 2 + mv_qter[1])
        mv_bits = self.mc.bits(mv[0], mv[1])
        bits = bits_in + mv_bits
        weight = 0.5 if bi else 1.0
        cost = int(math.floor(weight * (float(cost)
                                        - float(self.mc.cost_bits(mv_bits))))
                   + float(self.mc.cost_bits(bits)))
        return mv, bits, cost

    def _full_search(self, sad_at, sr_lt, sr_rb):
        best = MAX_UINT
        bx = by = 0
        for y in range(sr_lt[1], sr_rb[1] + 1):
            for x in range(sr_lt[0], sr_rb[0] + 1):
                s = sad_at(x, y)
                if s < best:
                    best = s
                    bx, by = x, y
        return (bx, by), best - self.mc.cost_pts(bx, by)

    # -- TZ search ------------------------------------------------------
    def _tz_search(self, sad_at, sr_lt, sr_rb, start):
        st = {"best": MAX_UINT, "x": 0, "y": 0, "dist": 0, "round": 0,
              "point": 0}

        def helper(x, y, point, distance):
            s = sad_at(x, y)
            if s < st["best"]:
                st.update(best=s, x=x, y=y, dist=distance, round=0,
                          point=point)

        def diamond(sx, sy, dist):
            top, bottom = sy - dist, sy + dist
            left, right = sx - dist, sx + dist
            st["round"] += 1
            if dist == 1:
                if top >= sr_lt[1]:
                    helper(sx, top, 2, dist)
                if left >= sr_lt[0]:
                    helper(left, sy, 4, dist)
                if right <= sr_rb[0]:
                    helper(right, sy, 5, dist)
                if bottom <= sr_rb[1]:
                    helper(sx, bottom, 7, dist)
            elif dist <= 8:
                t2, b2 = sy - (dist >> 1), sy + (dist >> 1)
                l2, r2 = sx - (dist >> 1), sx + (dist >> 1)
                if top >= sr_lt[1] and left >= sr_lt[0] and \
                        right <= sr_rb[0] and bottom <= sr_rb[1]:
                    helper(sx, top, 2, dist)
                    helper(l2, t2, 1, dist >> 1)
                    helper(r2, t2, 3, dist >> 1)
                    helper(left, sy, 4, dist)
                    helper(right, sy, 5, dist)
                    helper(l2, b2, 6, dist >> 1)
                    helper(r2, b2, 8, dist >> 1)
                    helper(sx, bottom, 7, dist)
                else:
                    if top >= sr_lt[1]:
                        helper(sx, top, 2, dist)
                    if t2 >= sr_lt[1]:
                        if l2 >= sr_lt[0]:
                            helper(l2, t2, 1, dist >> 1)
                        if r2 <= sr_rb[0]:
                            helper(r2, t2, 3, dist >> 1)
                    if left >= sr_lt[0]:
                        helper(left, sy, 4, dist)
                    if right <= sr_rb[0]:
                        helper(right, sy, 5, dist)
                    if b2 <= sr_rb[1]:
                        if l2 >= sr_lt[0]:
                            helper(l2, b2, 6, dist >> 1)
                        if r2 <= sr_rb[0]:
                            helper(r2, b2, 8, dist >> 1)
                    if bottom <= sr_rb[1]:
                        helper(sx, bottom, 7, dist)
            else:
                if top >= sr_lt[1] and left >= sr_lt[0] and \
                        right <= sr_rb[0] and bottom <= sr_rb[1]:
                    helper(sx, top, 0, dist)
                    helper(left, sy, 0, dist)
                    helper(right, sy, 0, dist)
                    helper(sx, bottom, 0, dist)
                    for index in range(1, 4):
                        pyt = top + ((dist >> 2) * index)
                        pyb = bottom - ((dist >> 2) * index)
                        pxl = sx - ((dist >> 2) * index)
                        pxr = sx + ((dist >> 2) * index)
                        helper(pxl, pyt, 0, dist)
                        helper(pxr, pyt, 0, dist)
                        helper(pxl, pyb, 0, dist)
                        helper(pxr, pyb, 0, dist)
                else:
                    if top >= sr_lt[1]:
                        helper(sx, top, 0, dist)
                    if left >= sr_lt[0]:
                        helper(left, sy, 0, dist)
                    if right <= sr_rb[0]:
                        helper(right, sy, 0, dist)
                    if bottom <= sr_rb[1]:
                        helper(sx, bottom, 0, dist)
                    for index in range(1, 4):
                        pyt = top + ((dist >> 2) * index)
                        pyb = bottom - ((dist >> 2) * index)
                        pxl = sx - ((dist >> 2) * index)
                        pxr = sx + ((dist >> 2) * index)
                        if pyt >= sr_lt[1]:
                            if pxl >= sr_lt[0]:
                                helper(pxl, pyt, 0, dist)
                            if pxr <= sr_rb[0]:
                                helper(pxr, pyt, 0, dist)
                        if pyb <= sr_rb[1]:
                            if pxl >= sr_lt[0]:
                                helper(pxl, pyb, 0, dist)
                            if pxr <= sr_rb[0]:
                                helper(pxr, pyb, 0, dist)

        def two_point():
            sx, sy = st["x"], st["y"]
            pt = st["point"]
            cand = {
                1: [(sx - 1, sy), (sx, sy - 1)],
                2: [(sx - 1, sy - 1), (sx + 1, sy - 1)],
                3: [(sx, sy - 1), (sx + 1, sy)],
                4: [(sx - 1, sy + 1), (sx - 1, sy - 1)],
                5: [(sx + 1, sy - 1), (sx + 1, sy + 1)],
                6: [(sx - 1, sy), (sx, sy + 1)],
                7: [(sx - 1, sy + 1), (sx + 1, sy + 1)],
                8: [(sx + 1, sy), (sx, sy + 1)],
            }.get(pt, [])
            for (x, y) in cand:
                if sr_lt[0] <= x <= sr_rb[0] and sr_lt[1] <= y <= sr_rb[1]:
                    helper(x, y, 0, 2)

        # start points: median predictor + zero
        helper(start[0], start[1], 0, 0)
        helper(0, 0, 0, 0)

        # first search (diamond, FIRSTSEARCHSTOP=1, 3 rounds)
        sx, sy = st["x"], st["y"]
        dist = 1
        while dist <= self.search_range:
            diamond(sx, sy, dist)
            if st["round"] >= 3:
                break
            dist *= 2

        # 2-point refinement when distance 1
        if st["dist"] == 1:
            st["dist"] = 0
            two_point()

        # raster search
        raster = 5
        if st["dist"] > raster:
            st["dist"] = raster
            for y in range(sr_lt[1], sr_rb[1] + 1, raster):
                for x in range(sr_lt[0], sr_rb[0] + 1, raster):
                    helper(x, y, 0, raster)

        # star refinement (diamond, no stop)
        while st["dist"] > 0:
            sx, sy = st["x"], st["y"]
            st["dist"] = 0
            st["point"] = 0
            dist = 1
            while dist < self.search_range + 1:
                diamond(sx, sy, dist)
                dist *= 2
            if st["dist"] == 1:
                st["dist"] = 0
                if st["point"] != 0:
                    two_point()

        return (st["x"], st["y"]), \
            st["best"] - self.mc.cost_pts(st["x"], st["y"])

    # -- fractional search ----------------------------------------------
    def _frac_search(self, org, pad_y, m, xp, yp, pw, ph, mv_int,
                     wp_ref=None):
        """xPatternSearchFracDIF: half then quarter refinement."""
        # ROI origin inside padded plane
        ox = m + xp + mv_int[0]
        oy = m + yp + mv_int[1]
        blocks = self._upsample_h(pad_y, ox, oy, pw, ph)

        mv_half, cost = self._refine(org, blocks, pw, ph, 2,
                                     (mv_int[0] * 2, mv_int[1] * 2), (0, 0),
                                     wp_ref)
        self.mc.set_cost_scale(0)
        self._upsample_q(pad_y, ox, oy, pw, ph, mv_half, blocks)
        base = (mv_half[0] * 2, mv_half[1] * 2)
        start = (mv_int[0] * 4 + mv_half[0] * 2,
                 mv_int[1] * 4 + mv_half[1] * 2)
        mv_qter, cost = self._refine(org, blocks, pw, ph, 1, start, base,
                                     wp_ref)
        return mv_half, mv_qter, cost

    def _upsample_h(self, pad_y, ox, oy, pw, ph):
        """xExtDIFUpSamplingH: blocks [v][h] for v,h in {0,2}.

        The reference's filter<> internally backs src up by (N/2-1); all
        offsets below are expressed relative to (oy-4, ox-4) with that
        backup already folded in: horizontal output col c of a pass whose
        srcPtr column is (ox-1) reads source cols (ox-4+c .. +7).
        """
        bd = self.sps.internal_bit_depth
        blocks = {}
        src = pad_y[oy - 4:oy + ph + 4, ox - 4:ox + pw + 5].astype(np.int32)
        # tmp arrays: (ph+8) x (pw+1), Short domain; col c <-> ROI col c-1
        tmp0 = _filter_copy(src[:, 3:3 + pw + 1], bd, True, False)
        tmp2 = _filter_1d(src, LUMA_FILTER[2], False, bd, True, False,
                          ph + 8, pw + 1)

        def vfull(tmp, vfrac, row_off, out_h, out_w, col_off=0):
            t = tmp[:, col_off:]
            if vfrac == 0:
                return _filter_copy(t[row_off:row_off + out_h, :out_w], bd,
                                    False, True)
            return _filter_1d(t[row_off:], LUMA_FILTER[vfrac], True, bd,
                              False, True, out_h, out_w)

        # [0][0]: intPtr=tmp0+4*stride+1, frac0 -> copy rows 4..
        blocks[(0, 0)] = vfull(tmp0, 0, 4, ph, pw, col_off=1)
        # [2][0]: intPtr=tmp0+3*stride+1, frac2 -> window row r..r+7
        blocks[(2, 0)] = vfull(tmp0, 2, 0, ph + 1, pw, col_off=1)
        # [0][2]: intPtr=tmp2+4*stride, frac0
        blocks[(0, 2)] = vfull(tmp2, 0, 4, ph, pw + 1)
        # [2][2]: intPtr=tmp2+3*stride, frac2
        blocks[(2, 2)] = vfull(tmp2, 2, 0, ph + 1, pw + 1)
        blocks["tmp0"] = tmp0
        blocks["tmp2"] = tmp2
        return blocks

    def _upsample_q(self, pad_y, ox, oy, pw, ph, half_ref, blocks):
        """xExtDIFUpSamplingQ.  Row offsets are (intPtr row - 3), the -3
        being the vertical filter's internal backup; frac-0 vertical passes
        are plain copies at the stated row."""
        bd = self.sps.internal_bit_depth
        hh, hv = half_ref
        ext_h = ph + 8 if hv == 0 else ph + 7
        base_row = oy - 4 + (1 if hv > 0 else 0)
        col1 = ox - 4 + (1 if hh >= 0 else 0)
        col3 = ox - 4 + (1 if hh > 0 else 0)
        src1 = pad_y[base_row:base_row + ext_h,
                     col1:col1 + pw + 7].astype(np.int32)
        src3 = pad_y[base_row:base_row + ext_h,
                     col3:col3 + pw + 7].astype(np.int32)
        tmp1 = _filter_1d(src1, LUMA_FILTER[1], False, bd, True, False,
                          ext_h, pw)
        tmp3 = _filter_1d(src3, LUMA_FILTER[3], False, bd, True, False,
                          ext_h, pw)

        def vq(tmp, vfrac, row_off, out_w, col_off=0):
            t = tmp[:, col_off:]
            if vfrac == 0:
                return _filter_copy(t[row_off:row_off + ph, :out_w], bd,
                                    False, True)
            return _filter_1d(t[row_off:], LUMA_FILTER[vfrac], True, bd,
                              False, True, ph, out_w)

        # @1,1 and @3,1 (from tmp1)
        blocks[(1, 1)] = vq(tmp1, 1, 1 if hv == 0 else 0, pw)
        blocks[(3, 1)] = vq(tmp1, 3, 0, pw)
        if hv != 0:
            blocks[(2, 1)] = vq(tmp1, 2, 1 if hv == 0 else 0, pw)
            blocks[(2, 3)] = vq(tmp3, 2, 1 if hv == 0 else 0, pw)
        else:
            blocks[(0, 1)] = vq(tmp1, 0, 4, pw)
            blocks[(0, 3)] = vq(tmp3, 0, 4, pw)
        tmp0, tmp2 = blocks["tmp0"], blocks["tmp2"]
        if hh != 0:
            col = 1 if hh > 0 else 0
            blocks[(1, 2)] = vq(tmp2, 1, 1 if hv >= 0 else 0, pw,
                                col_off=col)
            blocks[(3, 2)] = vq(tmp2, 3, 1 if hv > 0 else 0, pw,
                                col_off=col)
        else:
            blocks[(1, 0)] = vq(tmp0, 1, 1 if hv >= 0 else 0, pw, col_off=1)
            blocks[(3, 0)] = vq(tmp0, 3, 1 if hv > 0 else 0, pw, col_off=1)
        blocks[(1, 3)] = vq(tmp3, 1, 1 if hv == 0 else 0, pw)
        blocks[(3, 3)] = vq(tmp3, 3, 0, pw)

    def _refine(self, org, blocks, pw, ph, frac, start_mv, base_mv,
                wp_ref=None):
        """xPatternRefinement."""
        refine = REFINE_H if frac == 2 else REFINE_Q
        best = MAX_UINT
        best_i = 0
        for i, (dx, dy) in enumerate(refine):
            hor_val = (base_mv[0] + dx) * frac
            ver_val = (base_mv[1] + dy) * frac
            blk = blocks[(ver_val & 3, hor_val & 3)]
            co = 1 if (hor_val == 2 and (ver_val & 1) == 0) else 0
            ro = 1 if ((hor_val & 1) == 0 and ver_val == 2) else 0
            cur = blk[ro:ro + ph, co:co + pw]
            if wp_ref is not None:
                cur = self._wp_weight_block(cur, *wp_ref)
            if self.use_had_me:
                dist = calc_had(org, cur, self.bit_inc)
            else:
                dist = _sad(org, cur, 0, self.bit_inc)
            mx = start_mv[0] + dx
            my = start_mv[1] + dy
            dist += self.mc.cost_pts(mx, my)
            if dist < best:
                best = dist
                best_i = i
        return refine[best_i], best

    # ------------------------------------------------------------------
    # merge estimation
    # ------------------------------------------------------------------
    def _inter_prediction_error(self, cu_x, cu_y, size, pu_idx):
        """xGetInterPredictionError: MC + HAD over the PU."""
        part_sz = int(self.f.part_size_arr[cu_y // 4, cu_x // 4])
        xp, yp, pw, ph = pu_geometry(part_sz, cu_x, cu_y, size, pu_idx)
        from ..decoder.inter import InterPredictor
        ip = InterPredictor(self.f, self.sh, self.sps, self.pps,
                            self.lists[0], self.lists[1])
        py = np.zeros((ph, pw), np.int16)
        pcb = np.zeros((ph // 2, pw // 2), np.int16)
        pcr = np.zeros((ph // 2, pw // 2), np.int16)
        ip._predict_pu(cu_x, cu_y, xp, yp, pw, ph, py, pcb, pcr, xp, yp)
        org = self._org_pu(xp, yp, pw, ph)
        if self.use_had_me:
            return calc_had(org, py, self.bit_inc)
        return _sad(org, py, 0, self.bit_inc)

    def _merge_estimation(self, cu_x, cu_y, size, part_sz, pu_idx):
        """xMergeEstimation; returns (inter_dir, mv_fields, merge_idx,
        cost, cands) or cost=MAX_UINT."""
        f = self.f
        xp, yp, pw, ph = pu_geometry(part_sz, cu_x, cu_y, size, pu_idx)
        cand_dir, cand_mv, n_valid = self.mvctx.merge_candidates(
            cu_x, cu_y, size, part_sz, pu_idx)
        # xRestrictBipredMergeCand
        if size == 8 and part_sz != SIZE_2Nx2N:
            for c in range(n_valid):
                if cand_dir[c] == 3:
                    cand_dir[c] = 1
                    cand_mv[c][1] = (-1, (0, 0))
        best_cost = MAX_UINT
        best = None
        saved = self._save_pu_motion(xp, yp, pw, ph)
        for c in range(n_valid):
            # set candidate motion over the PU, then measure
            self._set_pu(f.inter_dir, xp, yp, pw, ph, cand_dir[c])
            for lst in range(2):
                ref, mv = cand_mv[c][lst]
                self._set_pu_motion(xp, yp, pw, ph, lst, ref, mv)
            err = self._inter_prediction_error(cu_x, cu_y, size, pu_idx)
            bits_cand = c + 1
            if c == MRG_MAX_NUM_CANDS_SIGNALED - 1:
                bits_cand -= 1
            cost = err + self.mc.cost_bits(bits_cand)
            if cost < best_cost:
                best_cost = cost
                best = (cand_dir[c], [cand_mv[c][0], cand_mv[c][1]], c)
        self._restore_pu_motion(xp, yp, pw, ph, saved)
        return best, best_cost

    def _save_pu_motion(self, xp, yp, pw, ph):
        f = self.f
        s = (slice(yp // 4, (yp + ph) // 4), slice(xp // 4, (xp + pw) // 4))
        return (f.inter_dir[s].copy(), f.ref_idx[:, s[0], s[1]].copy(),
                f.mv[:, s[0], s[1]].copy(), f.mvd[:, s[0], s[1]].copy(),
                f.mvp_idx[:, s[0], s[1]].copy(),
                f.merge_flag[s].copy(), f.merge_idx[s].copy())

    def _restore_pu_motion(self, xp, yp, pw, ph, saved):
        f = self.f
        s = (slice(yp // 4, (yp + ph) // 4), slice(xp // 4, (xp + pw) // 4))
        f.inter_dir[s] = saved[0]
        f.ref_idx[:, s[0], s[1]] = saved[1]
        f.mv[:, s[0], s[1]] = saved[2]
        f.mvd[:, s[0], s[1]] = saved[3]
        f.mvp_idx[:, s[0], s[1]] = saved[4]
        f.merge_flag[s] = saved[5]
        f.merge_idx[s] = saved[6]

    # ------------------------------------------------------------------
    # predInterSearch
    # ------------------------------------------------------------------
    def _blk_bits(self, part_sz, p_slice, pu_idx, last_mode):
        if part_sz in (SIZE_2Nx2N, SIZE_NxN):
            return [1, 3, 5] if p_slice else [3, 3, 5]
        if part_sz in (SIZE_2NxN, SIZE_2NxnU, SIZE_2NxnD):
            if p_slice:
                return [3, 0, 0]
            tab = [[[0, 0, 3], [0, 0, 0], [0, 0, 0]],
                   [[5, 7, 7], [7, 5, 7], [6, 6, 6]]]
            return list(tab[pu_idx][last_mode])
        if part_sz in (SIZE_Nx2N, SIZE_nLx2N, SIZE_nRx2N):
            if p_slice:
                return [3, 0, 0]
            tab = [[[0, 2, 3], [0, 0, 0], [0, 0, 0]],
                   [[5, 7, 7], [5, 5, 7], [6, 6, 6]]]
            return list(tab[pu_idx][last_mode])
        raise ValueError(part_sz)

    def pred_inter_search(self, cu_x, cu_y, size, part_sz, use_mrg=False):
        """predInterSearch: per-PU ME + merge decision; fills motion into
        the frame arrays and self.pred_* with the CU prediction."""
        f = self.f
        n_pu = num_pus(part_sz)
        p_slice = not self.is_b
        last_mode = 0
        for pu in range(n_pu):
            xp, yp, pw, ph = pu_geometry(part_sz, cu_x, cu_y, size, pu)
            blk_bits = self._blk_bits(part_sz, p_slice, pu, last_mode)
            test_normal = not (use_mrg and size > 8 and n_pu == 2)
            cost_uni = [MAX_UINT, MAX_UINT]
            bits_uni = [0, 0]
            mv_uni = [None, None]
            ref_uni = [0, 0]
            mvp_idx_arr = [[0] * 33, [0] * 33]
            mv_pred_arr = [[None] * 33, [None] * 33]
            cands_arr = [[None] * 33, [None] * 33]
            me_bits = 0

            if test_normal:
                sh = self.sh
                n_dir = 2 if self.is_b else 1
                lc = getattr(sh, "num_ref_lc", 0)
                nbp = bool(getattr(sh, "no_back_pred", False))
                mvdl1z = self.is_b and bool(sh.mvd_l1_zero_flag)
                cost_l0 = [MAX_UINT] * 33
                bits_l0 = [0] * 33
                mv_temp = [[None] * 33, [None] * 33]
                pred_store = [None, None]   # m_acYuvPred (luma, this PU)
                best_bip_dist = MAX_INT
                best_bip_ref = 0
                best_bip_mvp = 0
                for lst in range(n_dir):
                    nri = self.sh.num_ref_idx[lst]
                    for ref in range(nri):
                        bits_tmp = blk_bits[lst]
                        if nri > 1:
                            bits_tmp += ref + 1
                            if ref == nri - 1:
                                bits_tmp -= 1
                        mv_pred, mvp_idx, cands, dbp = \
                            self._estimate_mvp_amvp(cu_x, cu_y, size,
                                                    part_sz, pu, lst, ref)
                        mvp_idx_arr[lst][ref] = mvp_idx
                        mv_pred_arr[lst][ref] = mv_pred
                        cands_arr[lst][ref] = cands
                        if mvdl1z and lst == 1 and dbp < best_bip_dist:
                            best_bip_dist = dbp
                            best_bip_mvp = mvp_idx
                            best_bip_ref = ref
                        bits_tmp += self.mvp_idx_cost[mvp_idx]
                        # GPB_SIMPLE_UNI shortcut (TEncSearch.cpp:3334-3380)
                        if lc > 0 and lst == 1 and \
                                (nbp or sh.ref_idx_of_l0_from_l1[ref] >= 0):
                            src = ref if nbp \
                                else sh.ref_idx_of_l0_from_l1[ref]
                            mv = mv_temp[0][src]
                            cost_tmp = cost_l0[src] - \
                                self.mc.cost_bits(bits_l0[src])
                            self.mc.set_predictor(mv_pred)
                            self.mc.set_cost_scale(0)
                            bits_tmp += self.mc.bits(mv[0], mv[1])
                            cost_tmp += self.mc.cost_bits(bits_tmp)
                        elif lc <= 0 and lst == 1 and nbp:
                            cost_tmp = MAX_UINT
                            mv = mv_temp[0][ref]
                        else:
                            mv, bits_tmp, cost_tmp = \
                                self._motion_estimation(
                                    cu_x, cu_y, xp, yp, pw, ph, lst, ref,
                                    mv_pred, bits_tmp)
                        mv_temp[lst][ref] = mv
                        mv_pred, mvp_idx, bits_tmp, cost_tmp = \
                            self._check_best_mvp(cands, mv, mv_pred,
                                                 mvp_idx, bits_tmp,
                                                 cost_tmp)
                        mvp_idx_arr[lst][ref] = mvp_idx
                        mv_pred_arr[lst][ref] = mv_pred
                        if RQTDBG:
                            RQTDBG.write(
                                "MEC l=%d r=%d mvp=%d pred=%d,%d mv=%d,%d "
                                "bits=%d cost=%d c0=%d,%d c1=%d,%d\n" % (
                                    lst, ref, mvp_idx, mv_pred[0],
                                    mv_pred[1], mv[0], mv[1], bits_tmp,
                                    cost_tmp, cands[0][0], cands[0][1],
                                    cands[1][0], cands[1][1]))
                        if lc > 0 and not nbp:
                            if lst == 0:
                                cost_l0[ref] = cost_tmp
                                bits_l0[ref] = bits_tmp
                                if sh.ref_idx_of_lc[0][ref] < 0:
                                    cost_tmp = MAX_UINT
                            elif sh.ref_idx_of_lc[1][ref] < 0:
                                cost_tmp = MAX_UINT
                        if False and RQTDBG:
                            RQTDBG.write(
                                "MEC l=%d r=%d mvp=%d pred=%d,%d mv=%d,%d "
                                "bits=%d cost=%d c0=%d,%d c1=%d,%d\n" % (
                                    lst, ref, mvp_idx, mv_pred[0],
                                    mv_pred[1], mv[0], mv[1], bits_tmp,
                                    cost_tmp, cands[0][0], cands[0][1],
                                    cands[1][0], cands[1][1]))
                        # best-uni update (TEncSearch.cpp:3407-3410)
                        if ((lst == 0 and cost_tmp < cost_uni[0]) or
                                (lst == 1 and nbp and
                                 ref == ref_uni[0]) or
                                (lst == 1 and lc > 0 and
                                 (ref == 0 or ref == ref_uni[0]) and
                                 not nbp and
                                 ref == sh.ref_idx_of_l0_from_l1[ref]) or
                                (lst == 1 and not nbp and
                                 cost_tmp < cost_uni[1])):
                            cost_uni[lst] = cost_tmp
                            bits_uni[lst] = bits_tmp
                            mv_uni[lst] = mv
                            ref_uni[lst] = ref
                            if self.is_b and not mvdl1z:
                                # store uni pred for bi removeHighFreq
                                if lst == 1:
                                    pred_store[1] = self._pred_pu_luma(
                                        xp, yp, pw, ph, 1, ref, mv,
                                        cu_x, cu_y)
                                if lst == 0 and (
                                        nbp or (lc > 0 and
                                        sh.ref_idx_of_l0_from_l1[0] == 0)):
                                    pred_store[0] = self._pred_pu_luma(
                                        xp, yp, pw, ph, 0, ref, mv,
                                        cu_x, cu_y)

                #  Bi-directional prediction (TEncSearch.cpp:3440-3577)
                cost_bi = MAX_UINT
                bits_bi = 0
                mv_bi = [mv_uni[0], mv_uni[1]]
                ref_bi = [ref_uni[0], ref_uni[1]]
                mvp_pred_bi = [row[:] for row in mv_pred_arr]
                mvp_idx_bi = [row[:] for row in mvp_idx_arr]
                bipred_restricted = (size == 8 and (pw < 8 or ph < 8))
                if self.is_b and not bipred_restricted:
                    mot_bits = [0, 0]
                    if mvdl1z:
                        cands1 = cands_arr[1][best_bip_ref]
                        mvp_idx_bi[1][best_bip_ref] = best_bip_mvp
                        mvp_pred_bi[1][best_bip_ref] = cands1[best_bip_mvp]
                        mv_bi[1] = cands1[best_bip_mvp]
                        ref_bi[1] = best_bip_ref
                        pred_store[1] = self._pred_pu_luma(
                            xp, yp, pw, ph, 1, best_bip_ref, mv_bi[1],
                            cu_x, cu_y)
                        mot_bits[0] = bits_uni[0] - blk_bits[0]
                        mot_bits[1] = blk_bits[1]
                        nri1 = sh.num_ref_idx[1]
                        if nri1 > 1:
                            mot_bits[1] += best_bip_ref + 1
                            if best_bip_ref == nri1 - 1:
                                mot_bits[1] -= 1
                        mot_bits[1] += self.mvp_idx_cost[best_bip_mvp]
                        bits_bi = blk_bits[2] + mot_bits[0] + mot_bits[1]
                        mv_temp[1][best_bip_ref] = mv_bi[1]
                    else:
                        mot_bits[0] = bits_uni[0] - blk_bits[0]
                        mot_bits[1] = bits_uni[1] - blk_bits[1]
                        bits_bi = blk_bits[2] + mot_bits[0] + mot_bits[1]
                    n_iter = 1 if (self.fast_enc or mvdl1z) else 4
                    for it in range(n_iter):
                        ilist = it % 2
                        if self.fast_enc and (
                                nbp or (lc > 0 and
                                        sh.ref_idx_of_l0_from_l1[0] == 0)):
                            ilist = 1
                        if mvdl1z:
                            ilist = 0
                        changed = False
                        nri = sh.num_ref_idx[ilist]
                        for ref in range(nri):
                            bits_tmp = blk_bits[2] + mot_bits[1 - ilist]
                            if nri > 1:
                                bits_tmp += ref + 1
                                if ref == nri - 1:
                                    bits_tmp -= 1
                            bits_tmp += \
                                self.mvp_idx_cost[mvp_idx_bi[ilist][ref]]
                            mv, bits_tmp, cost_tmp = \
                                self._motion_estimation(
                                    cu_x, cu_y, xp, yp, pw, ph, ilist, ref,
                                    mvp_pred_bi[ilist][ref], bits_tmp,
                                    bi_mv=mv_temp[ilist][ref],
                                    bi_other=pred_store[1 - ilist])
                            mv_temp[ilist][ref] = mv
                            p2, i2, bits_tmp, cost_tmp = \
                                self._check_best_mvp(
                                    cands_arr[ilist][ref], mv,
                                    mvp_pred_bi[ilist][ref],
                                    mvp_idx_bi[ilist][ref],
                                    bits_tmp, cost_tmp)
                            mvp_pred_bi[ilist][ref] = p2
                            mvp_idx_bi[ilist][ref] = i2
                            if cost_tmp < cost_bi:
                                changed = True
                                mv_bi[ilist] = mv
                                ref_bi[ilist] = ref
                                cost_bi = cost_tmp
                                mot_bits[ilist] = bits_tmp - blk_bits[2] \
                                    - mot_bits[1 - ilist]
                                bits_bi = bits_tmp
                                if n_iter != 1:
                                    pred_store[ilist] = self._pred_pu_luma(
                                        xp, yp, pw, ph, ilist, ref, mv,
                                        cu_x, cu_y)
                        if not changed:
                            if cost_bi <= cost_uni[0] and \
                                    cost_bi <= cost_uni[1]:
                                r0 = ref_bi[0]
                                p2, i2, bits_bi, cost_bi = \
                                    self._check_best_mvp(
                                        cands_arr[0][r0], mv_bi[0],
                                        mvp_pred_bi[0][r0],
                                        mvp_idx_bi[0][r0],
                                        bits_bi, cost_bi)
                                mvp_pred_bi[0][r0] = p2
                                mvp_idx_bi[0][r0] = i2
                                if not mvdl1z:
                                    r1 = ref_bi[1]
                                    p2, i2, bits_bi, cost_bi = \
                                        self._check_best_mvp(
                                            cands_arr[1][r1], mv_bi[1],
                                            mvp_pred_bi[1][r1],
                                            mvp_idx_bi[1][r1],
                                            bits_bi, cost_bi)
                                    mvp_pred_bi[1][r1] = p2
                                    mvp_idx_bi[1][r1] = i2
                            break

                # final mode selection (TEncSearch.cpp:3660-3760)
                if nbp or (lc > 0 and sh.ref_idx_of_l0_from_l1[0] == 0):
                    cost_uni[1] = MAX_UINT
                self._set_pu(f.merge_flag, xp, yp, pw, ph, False)
                if cost_bi <= cost_uni[0] and cost_bi <= cost_uni[1]:
                    self._set_pu(f.inter_dir, xp, yp, pw, ph, 3)
                    for lst in range(2):
                        ref = ref_bi[lst]
                        mv = mv_bi[lst]
                        pred = mvp_pred_bi[lst][ref]
                        mvd = (mv[0] - pred[0], mv[1] - pred[1])
                        self._set_pu_motion(xp, yp, pw, ph, lst, ref, mv,
                                            mvd, mvp_idx_bi[lst][ref])
                    last_mode = 2
                    me_bits = bits_bi
                elif cost_uni[0] <= cost_uni[1]:
                    ref = ref_uni[0]
                    mv = mv_uni[0]
                    pred = mv_pred_arr[0][ref]
                    mvd = (mv[0] - pred[0], mv[1] - pred[1])
                    self._set_pu(f.inter_dir, xp, yp, pw, ph, 1)
                    self._set_pu_motion(xp, yp, pw, ph, 0, ref, mv, mvd,
                                        mvp_idx_arr[0][ref])
                    self._set_pu_motion(xp, yp, pw, ph, 1, -1, (0, 0),
                                        (0, 0), -1)
                    last_mode = 0
                    me_bits = bits_uni[0]
                else:
                    ref = ref_uni[1]
                    mv = mv_uni[1]
                    pred = mv_pred_arr[1][ref]
                    mvd = (mv[0] - pred[0], mv[1] - pred[1])
                    self._set_pu(f.inter_dir, xp, yp, pw, ph, 2)
                    self._set_pu_motion(xp, yp, pw, ph, 1, ref, mv, mvd,
                                        mvp_idx_arr[1][ref])
                    self._set_pu_motion(xp, yp, pw, ph, 0, -1, (0, 0),
                                        (0, 0), -1)
                    last_mode = 1
                    me_bits = bits_uni[1]

            if part_sz != SIZE_2Nx2N:
                self.mc.motion_cost_sad()
                me_cost = MAX_UINT
                saved_me = self._save_pu_motion(xp, yp, pw, ph)
                if test_normal:
                    err = self._inter_prediction_error(cu_x, cu_y, size, pu)
                    me_cost = err + self.mc.cost_bits(me_bits)
                mrg, mrg_cost = self._merge_estimation(cu_x, cu_y, size,
                                                       part_sz, pu)
                if mrg_cost < me_cost:
                    mrg_dir, mrg_mv, mrg_idx = mrg
                    self._set_pu(f.merge_flag, xp, yp, pw, ph, True)
                    self._set_pu(f.merge_idx, xp, yp, pw, ph, mrg_idx)
                    self._set_pu(f.inter_dir, xp, yp, pw, ph, mrg_dir)
                    for lst in range(2):
                        ref, mv = mrg_mv[lst]
                        self._set_pu_motion(xp, yp, pw, ph, lst, ref, mv,
                                            (0, 0), -1)
                else:
                    self._restore_pu_motion(xp, yp, pw, ph, saved_me)

            if RQTDBG:
                f_ = self.f
                pux, puy = xp // 4, yp // 4
                RQTDBG.write(
                    "ME pu=%d ps=%d mrg=%d/%d dir=%d r0=%d mv0=%d,%d "
                    "r1=%d mv1=%d,%d\n" % (
                        pu, part_sz, int(f_.merge_flag[puy, pux]),
                        int(f_.merge_idx[puy, pux]),
                        int(f_.inter_dir[puy, pux]),
                        int(f_.ref_idx[0, puy, pux]),
                        int(f_.mv[0, puy, pux, 0]),
                        int(f_.mv[0, puy, pux, 1]),
                        int(f_.ref_idx[1, puy, pux]),
                        int(f_.mv[1, puy, pux, 0]),
                        int(f_.mv[1, puy, pux, 1])))
            # MC for this PU into the CU prediction buffers
            self.motion_compensation(cu_x, cu_y, size, pu)
        return True


# ---------------------------------------------------------------------------
# Inter residual quadtree RD (encodeResAndCalcRdInterCU / xEstimateResidualQT)
# ---------------------------------------------------------------------------

class InterResidualSearch:
    """Mixin-style implementation bound to InterSearch (kept separate for
    readability); instantiated as part of InterSearch below."""


def _cbf_set(self, abs_part, depth_for_region, comp, value):
    """setCbfSubParts: assign value over the region at depth."""
    cu = self.cu
    f = self.f
    ux, uy = cu._unit_xy(abs_part)
    units = f.units_per_row >> depth_for_region
    f.cbf[comp, uy:uy + units, ux:ux + units] = value


def _ts_set(self, abs_part, depth_for_region, comp, value):
    cu = self.cu
    f = self.f
    ux, uy = cu._unit_xy(abs_part)
    units = f.units_per_row >> depth_for_region
    f.ts_flag[comp, uy:uy + units, ux:ux + units] = bool(value)


def encode_res_and_calc_rd(self, abs_part, depth, skip_res):
    """encodeResAndCalcRdInterCU: returns (bits, dist, cost) and leaves
    frame state + rec planes holding this mode's reconstruction.  The CU
    snapshot [depth][CI_TEMP_BEST] receives the post-syntax context."""
    cu = self.cu
    f = self.f
    px, py = cu._pel_xy(abs_part)
    ux, uy = cu._unit_xy(abs_part)
    size = f.ctu_size >> depth
    units = f.units_per_row >> depth
    cs = size // 2
    lx = px % f.ctu_size
    ly = py % f.ctu_size
    org_y = cu.org_y[py:py + size, px:px + size]
    org_cb = cu.org_cb[py // 2:py // 2 + cs, px // 2:px // 2 + cs]
    org_cr = cu.org_cr[py // 2:py // 2 + cs, px // 2:px // 2 + cs]
    pred_y = self.pred_y[ly:ly + size, lx:lx + size]
    pred_cb = self.pred_cb[ly // 2:ly // 2 + cs, lx // 2:lx // 2 + cs]
    pred_cr = self.pred_cr[ly // 2:ly // 2 + cs, lx // 2:lx // 2 + cs]

    if skip_res:
        # SKIP: reconstruction = prediction
        f.skip[uy:uy + units, ux:ux + units] = True
        cu.rec_y[py:py + size, px:px + size] = pred_y
        cu.rec_cb[py // 2:py // 2 + cs, px // 2:px // 2 + cs] = pred_cb
        cu.rec_cr[py // 2:py // 2 + cs, px // 2:px // 2 + cs] = pred_cr
        dist = cu.rd.dist_part(pred_y, org_y) + \
            cu.rd.dist_part(pred_cb, org_cb, True) + \
            cu.rd.dist_part(pred_cr, org_cr, True)
        cu._load(depth, 0)        # CI_CURR_BEST
        cu.go_on.reset_bits()
        if self.pps.transquant_bypass_enable_flag:
            cu.w.code_tq_bypass(abs_part)
        cu.w.code_skip_flag(abs_part)
        cu.w.code_merge_index(abs_part)
        bits = cu.go_on.num_written_bits
        cost = cu.rd.calc_rd_cost(bits, dist)
        cu._store(depth, 2)       # CI_TEMP_BEST
        f.cbf[:, uy:uy + units, ux:ux + units] = 0
        f.tr_idx[uy:uy + units, ux:ux + units] = 0
        f.coeff_y[py:py + size, px:px + size] = 0
        f.coeff_cb[py // 2:py // 2 + cs, px // 2:px // 2 + cs] = 0
        f.coeff_cr[py // 2:py // 2 + cs, px // 2:px // 2 + cs] = 0
        f.ts_flag[:, uy:uy + units, ux:ux + units] = False
        return bits, dist, cost

    # residual
    self.resi_y[ly:ly + size, lx:lx + size] = \
        org_y.astype(np.int32) - pred_y
    self.resi_cb[ly // 2:ly // 2 + cs, lx // 2:lx // 2 + cs] = \
        org_cb.astype(np.int32) - pred_cb
    self.resi_cr[ly // 2:ly // 2 + cs, lx // 2:lx // 2 + cs] = \
        org_cr.astype(np.int32) - pred_cr

    cu._load(depth, 0)            # CI_CURR_BEST
    acc = {"cost": 0.0, "bits": 0, "dist": 0, "zero_dist": 0}
    self._est_residual_qt(abs_part, depth, depth, acc, acc)

    # zero-residual alternative (TU_ZERO_CBF_RDO); disabled for lossless
    # CUs (TEncSearch.cpp:4629-4632)
    cu.go_on.reset_bits()
    cu.w.code_qt_root_cbf_zero()
    zero_bits = cu.go_on.num_written_bits
    zero_cost = cu.rd.calc_rd_cost(zero_bits, acc["zero_dist"])
    if f.tq_bypass[uy, ux]:
        zero_cost = acc["cost"] + 1
    if zero_cost < acc["cost"]:
        acc["cost"] = zero_cost
        acc["bits"] = 0
        acc["dist"] = acc["zero_dist"]
        f.tr_idx[uy:uy + units, ux:ux + units] = 0
        f.cbf[:, uy:uy + units, ux:ux + units] = 0
        f.coeff_y[py:py + size, px:px + size] = 0
        f.coeff_cb[py // 2:py // 2 + cs, px // 2:px // 2 + cs] = 0
        f.coeff_cr[py // 2:py // 2 + cs, px // 2:px // 2 + cs] = 0
        f.ts_flag[:, uy:uy + units, ux:ux + units] = False
        self.resi_best_y[ly:ly + size, lx:lx + size] = 0
        self.resi_best_cb[ly // 2:ly // 2 + cs, lx // 2:lx // 2 + cs] = 0
        self.resi_best_cr[ly // 2:ly // 2 + cs, lx // 2:lx // 2 + cs] = 0
    else:
        self._set_residual_qt_data(abs_part, depth, depth, spatial=False)

    # full syntax bits (xAddSymbolBitsInter)
    cu._load(depth, 0)
    bits = self._add_symbol_bits_inter(abs_part, depth)
    cost = cu.rd.calc_rd_cost(bits, acc["dist"])
    if RQTDBG:
        RQTDBG.write("RES cu=%d addr=%d bits=%d dist=%d cost=%f zero=%d\n"
                     % (abs_part, cu.ctu_addr, bits, acc["dist"], cost,
                        acc["zero_dist"]))
    cu._store(depth, 2)           # CI_TEMP_BEST

    # spatial residual of the chosen tree (best-update block in the ref)
    root_cbf = ((int(f.cbf[0, uy, ux]) | int(f.cbf[1, uy, ux]) |
                 int(f.cbf[2, uy, ux])) & 1) != 0
    if not root_cbf:
        self.resi_best_y[ly:ly + size, lx:lx + size] = 0
        self.resi_best_cb[ly // 2:ly // 2 + cs, lx // 2:lx // 2 + cs] = 0
        self.resi_best_cr[ly // 2:ly // 2 + cs, lx // 2:lx // 2 + cs] = 0
    else:
        self._set_residual_qt_data(abs_part, depth, depth, spatial=True)

    # reconstruction + final (clipped) distortion
    rec_y = np.clip(pred_y.astype(np.int32) +
                    self.resi_best_y[ly:ly + size, lx:lx + size],
                    0, cu.max_val).astype(np.int16)
    rec_cb = np.clip(pred_cb.astype(np.int32) +
                     self.resi_best_cb[ly // 2:ly // 2 + cs,
                                       lx // 2:lx // 2 + cs],
                     0, cu.max_val).astype(np.int16)
    rec_cr = np.clip(pred_cr.astype(np.int32) +
                     self.resi_best_cr[ly // 2:ly // 2 + cs,
                                       lx // 2:lx // 2 + cs],
                     0, cu.max_val).astype(np.int16)
    cu.rec_y[py:py + size, px:px + size] = rec_y
    cu.rec_cb[py // 2:py // 2 + cs, px // 2:px // 2 + cs] = rec_cb
    cu.rec_cr[py // 2:py // 2 + cs, px // 2:px // 2 + cs] = rec_cr
    dist = cu.rd.dist_part(rec_y, org_y) + \
        cu.rd.dist_part(rec_cb, org_cb, True) + \
        cu.rd.dist_part(rec_cr, org_cr, True)
    cost = cu.rd.calc_rd_cost(bits, dist)

    # skip flag per root cbf is NOT set here (xAddSymbolBitsInter did);
    # isSkipped => cbf zero
    if bool(f.skip[uy, ux]):
        f.cbf[:, uy:uy + units, ux:ux + units] = 0
    return bits, dist, cost


def _add_symbol_bits_inter(self, abs_part, depth):
    """xAddSymbolBitsInter: full CU syntax bit count with GoOn."""
    cu = self.cu
    f = self.f
    ux, uy = cu._unit_xy(abs_part)
    units = f.units_per_row >> depth
    merge_2nx2n = bool(f.merge_flag[uy, ux]) and \
        int(f.part_size_arr[uy, ux]) == SIZE_2Nx2N
    root_cbf = ((int(f.cbf[0, uy, ux]) | int(f.cbf[1, uy, ux]) |
                 int(f.cbf[2, uy, ux])) & 1) != 0
    w = cu.w
    if merge_2nx2n and not root_cbf:
        f.skip[uy:uy + units, ux:ux + units] = True
        cu.go_on.reset_bits()
        if self.pps.transquant_bypass_enable_flag:
            w.code_tq_bypass(abs_part)
        w.code_skip_flag(abs_part)
        w.code_merge_index(abs_part)
        return cu.go_on.num_written_bits
    cu.go_on.reset_bits()
    if self.pps.transquant_bypass_enable_flag:
        w.code_tq_bypass(abs_part)
    w.code_skip_flag(abs_part)
    if RQTDBG:
        RQTDBG.write("SYM skip=%d\n" % cu.go_on.num_written_bits)
    w.code_pred_mode(abs_part)
    if RQTDBG:
        RQTDBG.write("SYM pm=%d\n" % cu.go_on.num_written_bits)
    w.code_part_size(abs_part, depth)
    if RQTDBG:
        RQTDBG.write("SYM ps=%d\n" % cu.go_on.num_written_bits)
    self._code_pu_wise(abs_part, depth)
    if RQTDBG:
        RQTDBG.write("SYM pi=%d\n" % cu.go_on.num_written_bits)
    self._code_coeff(abs_part, depth)
    if RQTDBG:
        RQTDBG.write("SYM coeff=%d\n" % cu.go_on.num_written_bits)
    return cu.go_on.num_written_bits


def _code_pu_wise(self, abs_part, depth):
    """TEncEntropy::encodePUWise over frame state."""
    cu = self.cu
    f = self.f
    w = cu.w
    ux, uy = cu._unit_xy(abs_part)
    part_sz = int(f.part_size_arr[uy, ux])
    n_pu = num_pus(part_sz)
    from ..decoder.mv import PU_OFFSET
    pu_off = (PU_OFFSET[part_sz] << ((f.max_depth - depth) << 1)) >> 4
    part = abs_part
    for pu in range(n_pu):
        pux, puy = cu._unit_xy(part)
        w.code_merge_flag(part)
        if f.merge_flag[puy, pux]:
            w.code_merge_index(part)
        else:
            if self.is_b:
                w.code_inter_dir(part, depth)
            for lst in range(2):
                if self.sh.num_ref_idx[lst] > 0:
                    idir = int(f.inter_dir[puy, pux])
                    if idir & (1 << lst):
                        if self.sh.num_ref_idx[lst] > 1:
                            w.code_ref_idx(part, lst)
                        w.code_mvd(part, lst)
                        w.code_mvp_idx(part, lst)
        part += pu_off


def _code_coeff(self, abs_part, depth):
    """TEncEntropy::encodeCoeff inter wrapper (root cbf + transform tree)."""
    cu = self.cu
    f = self.f
    ux, uy = cu._unit_xy(abs_part)
    merge_2nx2n = bool(f.merge_flag[uy, ux]) and \
        int(f.part_size_arr[uy, ux]) == SIZE_2Nx2N
    root_cbf = ((int(f.cbf[0, uy, ux]) | int(f.cbf[1, uy, ux]) |
                 int(f.cbf[2, uy, ux])) & 1) != 0
    if not merge_2nx2n:
        cu.w.code_qt_root_cbf(1 if root_cbf else 0)
    if not root_cbf:
        return
    cu._final_writer = cu.w
    cu._final_transform_tree(abs_part, depth, 0)


def _min_tu_log2_inter(self, abs_part, depth):
    """getQuadtreeTULog2MinSizeInCU for the inter CU at abs_part."""
    f = self.f
    sps = self.sps
    log2_cb = (f.ctu_size >> depth).bit_length() - 1
    part_sz = int(f.part_size_arr[self.cu._unit_xy(abs_part)[1],
                                  self.cu._unit_xy(abs_part)[0]])
    qt_max_depth = sps.quadtree_tu_max_depth_inter
    inter_split = 1 if (qt_max_depth == 1 and part_sz != SIZE_2Nx2N) else 0
    if log2_cb < (sps.quadtree_tu_log2_min_size + qt_max_depth - 1 +
                  inter_split):
        return sps.quadtree_tu_log2_min_size
    v = log2_cb - (qt_max_depth - 1 + inter_split)
    return min(v, sps.quadtree_tu_log2_max_size)


def _est_residual_qt(self, abs_part, cu_depth, full_depth, acc, zacc):
    """xEstimateResidualQT; acc accumulates (cost, bits, dist), zacc (or
    None) the all-zero-residual distortion (puiZeroDist)."""
    cu = self.cu
    f = self.f
    sps = self.sps
    w = cu.w
    tr_mode = full_depth - cu_depth
    log2_tr = cu._log2_ctu() - full_depth
    size = 1 << log2_tr
    px, py = cu._pel_xy(abs_part)
    ux, uy = cu._unit_xy(abs_part)
    lx, ly = cu._ctu_local(abs_part)
    min_tu_log2 = self._min_tu_log2_inter(abs_part, cu_depth)
    part_sz = int(f.part_size_arr[uy, ux])

    split_forced = (sps.quadtree_tu_max_depth_inter == 1 and
                    part_sz != SIZE_2Nx2N)
    if split_forced and full_depth == cu_depth and log2_tr > min_tu_log2:
        check_full = False
    else:
        check_full = log2_tr <= sps.quadtree_tu_log2_max_size
    check_split = log2_tr > min_tu_log2

    code_chroma = True
    tr_mode_c = tr_mode
    log2_tr_c = log2_tr - 1
    if log2_tr == 2:
        log2_tr_c += 1
        tr_mode_c -= 1
        qp_div = f.parts_per_ctu >> ((cu_depth + tr_mode_c) << 1)
        code_chroma = (abs_part % qp_div) == 0
    size_c = 1 << log2_tr_c
    cxp, cyp = px // 2, py // 2
    clx, cly = lx // 2, ly // 2
    if log2_tr == 2 and code_chroma:
        pass  # chroma block co-located with the 4-TU group top-left

    set_cbf = 1 << tr_mode
    units = f.units_per_row >> full_depth
    units_c = f.units_per_row >> (cu_depth + tr_mode_c)

    cu._store(full_depth, 4)      # CI_QT_TRAFO_ROOT
    single_cost = MAX_DOUBLE
    single_bits = 0
    single_dist = 0
    abs_sum_y = abs_sum_u = abs_sum_v = 0
    best_ts = [0, 0, 0]
    layer = cu._qt_layer(full_depth)
    layer_c = layer          # chroma shares the node's access layer (HM
    #                          indexes m_ppcQTTempCoeffCb by the LUMA log2)

    if check_full:
        f.tr_idx[uy:uy + units, ux:ux + units] = tr_mode
        check_ts_y = (self.pps.use_transform_skip and size == 4 and
                      not f.tq_bypass[uy, ux])
        check_ts_uv = (self.pps.use_transform_skip and size_c == 4 and
                       not f.tq_bypass[uy, ux])
        self._ts_set(abs_part, full_depth, 0, 0)
        if code_chroma:
            self._ts_set(abs_part, cu_depth + tr_mode_c, 1, 0)
            self._ts_set(abs_part, cu_depth + tr_mode_c, 2, 0)
        min_cost = [MAX_DOUBLE, MAX_DOUBLE, MAX_DOUBLE]

        resi_y = self.resi_y[ly:ly + size, lx:lx + size]
        qps_y = tops.qp_scaled(int(f.qp[uy, ux]), True, sps.qp_bd_offset_y)
        coeff_y, abs_sum_y = cu._xform_quant(
            abs_part, resi_y, size, qps_y, True, 0, False, tr_mode,
            is_intra=False)
        self._cbf_set(abs_part, full_depth, 0, set_cbf if abs_sum_y else 0)

        coeff_u = coeff_v = None
        abs_sum_u = abs_sum_v = 0
        if code_chroma:
            qp_off_u = self.pps.chroma_cb_qp_offset + self.sh.slice_qp_delta_cb
            qp_off_v = self.pps.chroma_cr_qp_offset + self.sh.slice_qp_delta_cr
            qps_u = tops.qp_scaled(int(f.qp[uy, ux]), False,
                                   sps.qp_bd_offset_c, qp_off_u)
            qps_v = tops.qp_scaled(int(f.qp[uy, ux]), False,
                                   sps.qp_bd_offset_c, qp_off_v)
            resi_u = self.resi_cb[cly:cly + size_c, clx:clx + size_c]
            resi_v = self.resi_cr[cly:cly + size_c, clx:clx + size_c]
            coeff_u, abs_sum_u = cu._xform_quant(
                abs_part, resi_u, size_c, qps_u, False, 1, False, tr_mode,
                is_intra=False)
            coeff_v, abs_sum_v = cu._xform_quant(
                abs_part, resi_v, size_c, qps_v, False, 2, False, tr_mode,
                is_intra=False)
            self._cbf_set(abs_part, cu_depth + tr_mode_c, 1,
                          set_cbf if abs_sum_u else 0)
            self._cbf_set(abs_part, cu_depth + tr_mode_c, 2,
                          set_cbf if abs_sum_v else 0)

        # bits per component (GoOn evolves continuously)
        cu.go_on.reset_bits()
        w.code_qt_cbf(abs_part, 0, tr_mode)
        w.code_coeff_nxn(abs_part, coeff_y, size, 0)
        bits_y = cu.go_on.num_written_bits
        bits_u = bits_v = 0
        if code_chroma:
            w.code_qt_cbf(abs_part, 1, tr_mode)
            w.code_coeff_nxn(abs_part, coeff_u, size_c, 1)
            bits_u = cu.go_on.num_written_bits - bits_y
            w.code_qt_cbf(abs_part, 2, tr_mode)
            w.code_coeff_nxn(abs_part, coeff_v, size_c, 2)
            bits_v = cu.go_on.num_written_bits - bits_y - bits_u

        # luma distortion: zero vs coded
        dist_y = cu.rd.dist_part(np.zeros_like(resi_y), resi_y)
        if zacc is not None:
            zacc["zero_dist"] += dist_y
        resi_rec_y = None
        if abs_sum_y:
            if f.tq_bypass[uy, ux]:
                resi_rec_y = coeff_y      # invtransformNxN bypass
            else:
                deq = cu._dequant(coeff_y, qps_y, size, 0, False)
                resi_rec_y = tops.inverse_transform(
                    deq[None], use_dst=False, bit_increment=self.bit_inc)[0]
            nz_dist_y = cu.rd.dist_part(resi_rec_y, resi_y)
            if f.tq_bypass[uy, ux]:
                dist_y = nz_dist_y    # lossless: never zero the residual
            else:                     # (TEncSearch.cpp:4990-4994)
                single_cost_y = cu.rd.calc_rd_cost(bits_y, nz_dist_y)
                cu.go_on.reset_bits()
                w.code_qt_cbf_zero(0, tr_mode)
                null_bits_y = cu.go_on.num_written_bits
                null_cost_y = cu.rd.calc_rd_cost(null_bits_y, dist_y)
                if null_cost_y < single_cost_y:
                    abs_sum_y = 0
                    coeff_y = np.zeros_like(coeff_y)
                    resi_rec_y = None
                    if check_ts_y:
                        min_cost[0] = null_cost_y
                else:
                    dist_y = nz_dist_y
                    if check_ts_y:
                        min_cost[0] = single_cost_y
        elif check_ts_y:
            cu.go_on.reset_bits()
            w.code_qt_cbf_zero(0, tr_mode)
            null_bits_y = cu.go_on.num_written_bits
            min_cost[0] = cu.rd.calc_rd_cost(null_bits_y, dist_y)
        qt_y = self.qt_resi[layer]["y"]
        qt_y[ly:ly + size, lx:lx + size] = \
            0 if resi_rec_y is None else resi_rec_y

        dist_u = dist_v = 0
        resi_rec_u = resi_rec_v = None
        if code_chroma:
            dist_u = cu.rd.dist_part(np.zeros_like(resi_u), resi_u, True)
            if zacc is not None:
                zacc["zero_dist"] += dist_u
            if abs_sum_u:
                if f.tq_bypass[uy, ux]:
                    resi_rec_u = coeff_u      # invtransformNxN bypass
                else:
                    deq = cu._dequant(coeff_u, qps_u, size_c, 1, False)
                    resi_rec_u = tops.inverse_transform(
                        deq[None], use_dst=False,
                        bit_increment=self.bit_inc)[0]
                nz = cu.rd.dist_part(resi_rec_u, resi_u, True)
                if f.tq_bypass[uy, ux]:
                    dist_u = nz       # lossless (TEncSearch.cpp:5096)
                else:
                    sc = cu.rd.calc_rd_cost(bits_u, nz)
                    cu.go_on.reset_bits()
                    w.code_qt_cbf_zero(1, tr_mode)
                    nb = cu.go_on.num_written_bits
                    nc = cu.rd.calc_rd_cost(nb, dist_u)
                    if nc < sc:
                        abs_sum_u = 0
                        coeff_u = np.zeros_like(coeff_u)
                        resi_rec_u = None
                        if check_ts_uv:
                            min_cost[1] = nc
                    else:
                        dist_u = nz
                        if check_ts_uv:
                            min_cost[1] = sc
            elif check_ts_uv:
                cu.go_on.reset_bits()
                w.code_qt_cbf_zero(1, tr_mode_c)
                nb = cu.go_on.num_written_bits
                min_cost[1] = cu.rd.calc_rd_cost(nb, dist_u)
            qt_u = self.qt_resi[layer_c]["cb"]
            qt_u[cly:cly + size_c, clx:clx + size_c] = \
                0 if resi_rec_u is None else resi_rec_u

            dist_v = cu.rd.dist_part(np.zeros_like(resi_v), resi_v, True)
            if zacc is not None:
                zacc["zero_dist"] += dist_v
            if abs_sum_v:
                if f.tq_bypass[uy, ux]:
                    resi_rec_v = coeff_v      # invtransformNxN bypass
                else:
                    deq = cu._dequant(coeff_v, qps_v, size_c, 2, False)
                    resi_rec_v = tops.inverse_transform(
                        deq[None], use_dst=False,
                        bit_increment=self.bit_inc)[0]
                nz = cu.rd.dist_part(resi_rec_v, resi_v, True)
                if f.tq_bypass[uy, ux]:
                    dist_v = nz       # lossless (TEncSearch.cpp:5197)
                    _ll_skip_v = True
                else:
                    _ll_skip_v = False
                    sc = cu.rd.calc_rd_cost(bits_v, nz)
                    cu.go_on.reset_bits()
                    w.code_qt_cbf_zero(2, tr_mode)
                    nb = cu.go_on.num_written_bits
                    nc = cu.rd.calc_rd_cost(nb, dist_v)
                if not _ll_skip_v and nc < sc:
                    abs_sum_v = 0
                    coeff_v = np.zeros_like(coeff_v)
                    resi_rec_v = None
                    if check_ts_uv:
                        min_cost[2] = nc
                else:
                    dist_v = nz
                    if check_ts_uv:
                        min_cost[2] = sc
            elif check_ts_uv:
                cu.go_on.reset_bits()
                w.code_qt_cbf_zero(2, tr_mode_c)
                nb = cu.go_on.num_written_bits
                min_cost[2] = cu.rd.calc_rd_cost(nb, dist_v)
            qt_v = self.qt_resi[layer_c]["cr"]
            qt_v[cly:cly + size_c, clx:clx + size_c] = \
                0 if resi_rec_v is None else resi_rec_v

        self._cbf_set(abs_part, full_depth, 0, set_cbf if abs_sum_y else 0)
        if code_chroma:
            self._cbf_set(abs_part, cu_depth + tr_mode_c, 1,
                          set_cbf if abs_sum_u else 0)
            self._cbf_set(abs_part, cu_depth + tr_mode_c, 2,
                          set_cbf if abs_sum_v else 0)

        # ---- inter transform-skip RDO (luma) ----
        if RQTDBG and check_ts_y:
            RQTDBG.write("PRETSY d=%d sumY=%d distY=%d minC=%f\n" % (
                full_depth, abs_sum_y, dist_y, min_cost[0]))
        if check_ts_y:
            coeff_y, abs_sum_y, dist_y = self._ts_check_luma(
                abs_part, full_depth, tr_mode, resi_y, qps_y, coeff_y,
                abs_sum_y, dist_y, min_cost[0], best_ts, layer, lx, ly,
                size, set_cbf)
        if code_chroma and check_ts_uv:
            (coeff_u, abs_sum_u, dist_u, coeff_v, abs_sum_v,
             dist_v) = self._ts_check_chroma(
                abs_part, full_depth, cu_depth, tr_mode, tr_mode_c,
                resi_u, resi_v, qps_u, qps_v, coeff_u, abs_sum_u, dist_u,
                coeff_v, abs_sum_v, dist_v, min_cost, best_ts, layer_c,
                clx, cly, size_c, set_cbf)

        # store coefficients into the layer buffers
        self.qt_coeff[layer]["y"][ly:ly + size, lx:lx + size] = coeff_y
        if code_chroma:
            self.qt_coeff[layer_c]["cb"][cly:cly + size_c,
                                         clx:clx + size_c] = coeff_u
            self.qt_coeff[layer_c]["cr"][cly:cly + size_c,
                                         clx:clx + size_c] = coeff_v

        # single-pass bits
        cu._load(full_depth, 4)
        cu.go_on.reset_bits()
        if log2_tr > min_tu_log2:
            w.code_transform_subdiv(0, log2_tr)
        if code_chroma:
            w.code_qt_cbf(abs_part, 1, tr_mode)
            w.code_qt_cbf(abs_part, 2, tr_mode)
        w.code_qt_cbf(abs_part, 0, tr_mode)
        w.code_coeff_nxn(abs_part, coeff_y, size, 0)
        if code_chroma:
            w.code_coeff_nxn(abs_part, coeff_u, size_c, 1)
            w.code_coeff_nxn(abs_part, coeff_v, size_c, 2)
        single_bits = cu.go_on.num_written_bits
        single_dist = dist_y + dist_u + dist_v
        single_cost = cu.rd.calc_rd_cost(single_bits, single_dist)
        if RQTDBG:
            RQTDBG.write("RQT full part=%d d=%d bits=%d dist=%d cost=%f "
                         "sumY=%d sumU=%d sumV=%d\n" % (
                             abs_part, full_depth, single_bits, single_dist,
                             single_cost, abs_sum_y, abs_sum_u, abs_sum_v))

    if check_split:
        if check_full:
            cu._store(full_depth, 3)      # CI_QT_TRAFO_TEST
            cu._load(full_depth, 4)       # CI_QT_TRAFO_ROOT
        sub_acc = {"cost": 0.0, "bits": 0, "dist": 0}
        q_parts = f.parts_per_ctu >> ((full_depth + 1) << 1)
        part = abs_part
        for i in range(4):
            self._est_residual_qt(part, cu_depth, full_depth + 1, sub_acc,
                                  None if check_full else zacc)
            part += q_parts
        y_cbf = u_cbf = v_cbf = 0
        part = abs_part
        for i in range(4):
            iux, iuy = cu._unit_xy(part)
            y_cbf |= (int(f.cbf[0, iuy, iux]) >> (tr_mode + 1)) & 1
            u_cbf |= (int(f.cbf[1, iuy, iux]) >> (tr_mode + 1)) & 1
            v_cbf |= (int(f.cbf[2, iuy, iux]) >> (tr_mode + 1)) & 1
            part += q_parts
        f.cbf[0, uy:uy + units, ux:ux + units] |= y_cbf << tr_mode
        f.cbf[1, uy:uy + units, ux:ux + units] |= u_cbf << tr_mode
        f.cbf[2, uy:uy + units, ux:ux + units] |= v_cbf << tr_mode

        cu._load(full_depth, 4)
        cu.go_on.reset_bits()
        if RQTDBG:
            RQTDBG.write("WALK begin d=%d\n" % full_depth)
        self._enc_residual_qt(abs_part, cu_depth, full_depth, True, 0)
        self._enc_residual_qt(abs_part, cu_depth, full_depth, False, 0)
        self._enc_residual_qt(abs_part, cu_depth, full_depth, False, 1)
        self._enc_residual_qt(abs_part, cu_depth, full_depth, False, 2)
        if RQTDBG:
            RQTDBG.write("WALK end\n")
        subdiv_bits = cu.go_on.num_written_bits
        subdiv_cost = cu.rd.calc_rd_cost(subdiv_bits, sub_acc["dist"])
        if RQTDBG:
            RQTDBG.write("RQT split part=%d d=%d bits=%d dist=%d cost=%f\n"
                         % (abs_part, full_depth, subdiv_bits,
                            sub_acc["dist"], subdiv_cost))

        if (y_cbf or u_cbf or v_cbf or not check_full) and \
                subdiv_cost < single_cost:
            acc["cost"] += subdiv_cost
            acc["bits"] += subdiv_bits
            acc["dist"] += sub_acc["dist"]
            return
        # full wins: restore TS flags and context
        self._ts_set(abs_part, full_depth, 0, best_ts[0])
        if code_chroma:
            self._ts_set(abs_part, cu_depth + tr_mode_c, 1, best_ts[1])
            self._ts_set(abs_part, cu_depth + tr_mode_c, 2, best_ts[2])
        cu._load(full_depth, 3)           # CI_QT_TRAFO_TEST

    acc["cost"] += single_cost
    acc["bits"] += single_bits
    acc["dist"] += single_dist
    f.tr_idx[uy:uy + units, ux:ux + units] = tr_mode
    self._cbf_set(abs_part, full_depth, 0, set_cbf if abs_sum_y else 0)
    if code_chroma:
        self._cbf_set(abs_part, cu_depth + tr_mode_c, 1,
                      set_cbf if abs_sum_u else 0)
        self._cbf_set(abs_part, cu_depth + tr_mode_c, 2,
                      set_cbf if abs_sum_v else 0)


InterSearch._cbf_set = _cbf_set
InterSearch._ts_set = _ts_set
InterSearch.encode_res_and_calc_rd = encode_res_and_calc_rd
InterSearch._add_symbol_bits_inter = _add_symbol_bits_inter
InterSearch._code_pu_wise = _code_pu_wise
InterSearch._code_coeff = _code_coeff
InterSearch._min_tu_log2_inter = _min_tu_log2_inter
InterSearch._est_residual_qt = _est_residual_qt


def _ts_check_luma(self, abs_part, full_depth, tr_mode, resi_y, qps_y,
                   coeff_y, abs_sum_y, dist_y, min_cost_y, best_ts, layer,
                   lx, ly, size, set_cbf):
    """Inter transform-skip RDO for the luma TU (INTER_TRANSFORMSKIP)."""
    cu = self.cu
    w = cu.w
    qt_y = self.qt_resi[layer]["y"]
    best_coeff = coeff_y.copy()
    best_resi = qt_y[ly:ly + size, lx:lx + size].copy()
    cu._load(full_depth, 4)           # CI_QT_TRAFO_ROOT
    self._ts_set(abs_part, full_depth, 0, 1)
    ts_coeff, ts_abs_sum = cu._xform_quant(
        abs_part, resi_y, size, qps_y, True, 0, True, tr_mode,
        is_intra=False)
    self._cbf_set(abs_part, full_depth, 0, set_cbf if ts_abs_sum else 0)
    ts_cost = MAX_DOUBLE
    nz_dist = 0
    resi_rec = None
    if ts_abs_sum:
        cu.go_on.reset_bits()
        w.code_qt_cbf(abs_part, 0, tr_mode)
        w.code_coeff_nxn(abs_part, ts_coeff, size, 0)
        ts_bits = cu.go_on.num_written_bits
        # HM quirk: invtransformNxN( pcCU, ... ) converts the CU pointer to
        # the Bool transQuantBypass argument => the TS distortion estimate
        # (and the committed residual if TS wins) is the raw level copy
        # (TEncSearch.cpp:5325) — replicated bit-exactly here.
        resi_rec = ts_coeff.astype(np.int16)
        nz_dist = cu.rd.dist_part(resi_rec, resi_y)
        ts_cost = cu.rd.calc_rd_cost(ts_bits, nz_dist)
    if RQTDBG:
        RQTDBG.write("TSY d=%d sum=%d nzdist=%d tsbits=%d tscost=%f "
                     "mincost=%f\n" % (full_depth, ts_abs_sum,
                                        nz_dist if ts_abs_sum else -1, 0,
                                        ts_cost if ts_abs_sum else -1.0,
                                        min_cost_y))
    if (not ts_abs_sum) or min_cost_y < ts_cost:
        self._ts_set(abs_part, full_depth, 0, 0)
        coeff_out, abs_out, dist_out = best_coeff, abs_sum_y, dist_y
        qt_y[ly:ly + size, lx:lx + size] = best_resi
    else:
        coeff_out, abs_out, dist_out = ts_coeff, ts_abs_sum, nz_dist
        best_ts[0] = 1
        qt_y[ly:ly + size, lx:lx + size] = resi_rec
    self._cbf_set(abs_part, full_depth, 0, set_cbf if abs_out else 0)
    return coeff_out, abs_out, dist_out


def _ts_check_chroma(self, abs_part, full_depth, cu_depth, tr_mode,
                     tr_mode_c, resi_u, resi_v, qps_u, qps_v, coeff_u,
                     abs_sum_u, dist_u, coeff_v, abs_sum_v, dist_v,
                     min_cost, best_ts, layer_c, clx, cly, size_c, set_cbf):
    """Inter transform-skip RDO for the chroma TUs."""
    cu = self.cu
    w = cu.w
    qt_u = self.qt_resi[layer_c]["cb"]
    qt_v = self.qt_resi[layer_c]["cr"]
    best_cu_ = coeff_u.copy()
    best_cv_ = coeff_v.copy()
    best_ru = qt_u[cly:cly + size_c, clx:clx + size_c].copy()
    best_rv = qt_v[cly:cly + size_c, clx:clx + size_c].copy()
    cu._load(full_depth, 4)
    self._ts_set(abs_part, cu_depth + tr_mode_c, 1, 1)
    self._ts_set(abs_part, cu_depth + tr_mode_c, 2, 1)
    ts_cu, ts_asu = cu._xform_quant(abs_part, resi_u, size_c, qps_u, False,
                                    1, True, tr_mode, is_intra=False)
    ts_cv, ts_asv = cu._xform_quant(abs_part, resi_v, size_c, qps_v, False,
                                    2, True, tr_mode, is_intra=False)
    self._cbf_set(abs_part, cu_depth + tr_mode_c, 1,
                  set_cbf if ts_asu else 0)
    self._cbf_set(abs_part, cu_depth + tr_mode_c, 2,
                  set_cbf if ts_asv else 0)
    cu.go_on.reset_bits()
    bits_u = 0
    cost_u = MAX_DOUBLE
    nz_du = 0
    rec_u = None
    if ts_asu:
        w.code_qt_cbf(abs_part, 1, tr_mode)
        w.code_coeff_nxn(abs_part, ts_cu, size_c, 1)
        bits_u = cu.go_on.num_written_bits
        rec_u = ts_cu.astype(np.int16)       # bypass quirk, see luma
        nz_du = cu.rd.dist_part(rec_u, resi_u, True)
        cost_u = cu.rd.calc_rd_cost(bits_u, nz_du)
    if (not ts_asu) or min_cost[1] < cost_u:
        self._ts_set(abs_part, cu_depth + tr_mode_c, 1, 0)
        out_cu, out_asu, out_du = best_cu_, abs_sum_u, dist_u
        qt_u[cly:cly + size_c, clx:clx + size_c] = best_ru
    else:
        out_cu, out_asu, out_du = ts_cu, ts_asu, nz_du
        best_ts[1] = 1
        qt_u[cly:cly + size_c, clx:clx + size_c] = rec_u
    cost_v = MAX_DOUBLE
    nz_dv = 0
    rec_v = None
    if ts_asv:
        w.code_qt_cbf(abs_part, 2, tr_mode)
        w.code_coeff_nxn(abs_part, ts_cv, size_c, 2)
        bits_v = cu.go_on.num_written_bits - bits_u
        rec_v = ts_cv.astype(np.int16)       # bypass quirk, see luma
        nz_dv = cu.rd.dist_part(rec_v, resi_v, True)
        cost_v = cu.rd.calc_rd_cost(bits_v, nz_dv)
    if (not ts_asv) or min_cost[2] < cost_v:
        self._ts_set(abs_part, cu_depth + tr_mode_c, 2, 0)
        out_cv, out_asv, out_dv = best_cv_, abs_sum_v, dist_v
        qt_v[cly:cly + size_c, clx:clx + size_c] = best_rv
    else:
        out_cv, out_asv, out_dv = ts_cv, ts_asv, nz_dv
        best_ts[2] = 1
        qt_v[cly:cly + size_c, clx:clx + size_c] = rec_v
    self._cbf_set(abs_part, cu_depth + tr_mode_c, 1,
                  set_cbf if out_asu else 0)
    self._cbf_set(abs_part, cu_depth + tr_mode_c, 2,
                  set_cbf if out_asv else 0)
    return out_cu, out_asu, out_du, out_cv, out_asv, out_dv


def _enc_residual_qt(self, abs_part, cu_depth, full_depth, subdiv_and_cbf,
                     comp):
    """xEncodeResidualQT (bit counting for the subdiv alternative)."""
    cu = self.cu
    f = self.f
    w = cu.w
    ux, uy = cu._unit_xy(abs_part)
    cur_tr = full_depth - cu_depth
    tr_mode = int(f.tr_idx[uy, ux])
    subdiv = cur_tr != tr_mode
    log2_tr = cu._log2_ctu() - full_depth
    min_tu_log2 = self._min_tu_log2_inter(abs_part, cu_depth)

    if subdiv_and_cbf and log2_tr <= self.sps.quadtree_tu_log2_max_size \
            and log2_tr > min_tu_log2:
        w.code_transform_subdiv(1 if subdiv else 0, log2_tr)

    if subdiv_and_cbf:
        first_cbf = cur_tr == 0
        if first_cbf or log2_tr > 2:
            if first_cbf or cu._cbf(abs_part, 1, cur_tr - 1):
                w.code_qt_cbf(abs_part, 1, cur_tr)
            if first_cbf or cu._cbf(abs_part, 2, cur_tr - 1):
                w.code_qt_cbf(abs_part, 2, cur_tr)

    if not subdiv:
        layer = cu._qt_layer(full_depth)
        lx, ly = cu._ctu_local(abs_part)
        size = 1 << log2_tr
        code_chroma = True
        tr_mode_c = tr_mode
        log2_tr_c = log2_tr - 1
        if log2_tr == 2:
            log2_tr_c += 1
            tr_mode_c -= 1
            qp_div = f.parts_per_ctu >> ((cu_depth + tr_mode_c) << 1)
            code_chroma = (abs_part % qp_div) == 0
        size_c = 1 << log2_tr_c
        layer_c = layer
        if subdiv_and_cbf:
            w.code_qt_cbf(abs_part, 0, tr_mode)
        else:
            if comp == 0 and cu._cbf(abs_part, 0, tr_mode):
                cy_ = self.qt_coeff[layer]["y"][ly:ly + size, lx:lx + size]
                w.code_coeff_nxn(abs_part, cy_, size, 0)
            if code_chroma:
                clx, cly = lx // 2, ly // 2
                if comp == 1 and cu._cbf(abs_part, 1, tr_mode):
                    cu_ = self.qt_coeff[layer_c]["cb"][cly:cly + size_c,
                                                       clx:clx + size_c]
                    w.code_coeff_nxn(abs_part, cu_, size_c, 1)
                if comp == 2 and cu._cbf(abs_part, 2, tr_mode):
                    cv_ = self.qt_coeff[layer_c]["cr"][cly:cly + size_c,
                                                       clx:clx + size_c]
                    w.code_coeff_nxn(abs_part, cv_, size_c, 2)
    else:
        if subdiv_and_cbf or cu._cbf(abs_part, comp, cur_tr):
            q_parts = f.parts_per_ctu >> ((full_depth + 1) << 1)
            part = abs_part
            for i in range(4):
                self._enc_residual_qt(part, cu_depth, full_depth + 1,
                                      subdiv_and_cbf, comp)
                part += q_parts


def _set_residual_qt_data(self, abs_part, cu_depth, full_depth, spatial):
    """xSetResidualQTData: commit the chosen TU tree's coefficients (or
    spatial residual) from the layer buffers."""
    cu = self.cu
    f = self.f
    ux, uy = cu._unit_xy(abs_part)
    cur_tr = full_depth - cu_depth
    tr_mode = int(f.tr_idx[uy, ux])
    if cur_tr == tr_mode:
        log2_tr = cu._log2_ctu() - full_depth
        size = 1 << log2_tr
        layer = cu._qt_layer(full_depth)
        lx, ly = cu._ctu_local(abs_part)
        px, py = cu._pel_xy(abs_part)
        code_chroma = True
        tr_mode_c = tr_mode
        log2_tr_c = log2_tr - 1
        if log2_tr == 2:
            log2_tr_c += 1
            tr_mode_c -= 1
            qp_div = f.parts_per_ctu >> ((cu_depth + tr_mode_c) << 1)
            code_chroma = (abs_part % qp_div) == 0
        size_c = 1 << log2_tr_c
        layer_c = layer
        clx, cly = lx // 2, ly // 2
        if spatial:
            self.resi_best_y[ly:ly + size, lx:lx + size] = \
                self.qt_resi[layer]["y"][ly:ly + size, lx:lx + size]
            if code_chroma:
                self.resi_best_cb[cly:cly + size_c, clx:clx + size_c] = \
                    self.qt_resi[layer_c]["cb"][cly:cly + size_c,
                                                clx:clx + size_c]
                self.resi_best_cr[cly:cly + size_c, clx:clx + size_c] = \
                    self.qt_resi[layer_c]["cr"][cly:cly + size_c,
                                                clx:clx + size_c]
        else:
            f.coeff_y[py:py + size, px:px + size] = \
                self.qt_coeff[layer]["y"][ly:ly + size, lx:lx + size]
            if code_chroma:
                cpx, cpy = px // 2, py // 2
                f.coeff_cb[cpy:cpy + size_c, cpx:cpx + size_c] = \
                    self.qt_coeff[layer_c]["cb"][cly:cly + size_c,
                                                 clx:clx + size_c]
                f.coeff_cr[cpy:cpy + size_c, cpx:cpx + size_c] = \
                    self.qt_coeff[layer_c]["cr"][cly:cly + size_c,
                                                 clx:clx + size_c]
    else:
        q_parts = self.f.parts_per_ctu >> ((full_depth + 1) << 1)
        part = abs_part
        for i in range(4):
            self._set_residual_qt_data(part, cu_depth, full_depth + 1,
                                       spatial)
            part += q_parts


InterSearch._ts_check_luma = _ts_check_luma
InterSearch._ts_check_chroma = _ts_check_chroma
InterSearch._enc_residual_qt = _enc_residual_qt
InterSearch._set_residual_qt_data = _set_residual_qt_data
