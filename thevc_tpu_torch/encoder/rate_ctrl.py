"""Rate control: MAD linear prediction + pixel-based URQ quadratic model.

Behavioral reference: TEncRateCtrl.cpp/.h (HM-8 draft) — MADLinearModel
(:60), PixelBaseURQQuadraticModel (:99), TEncRateCtrl::create (:229),
getFrameQP (:321), calculateUnitQP (:429), updateRCGOPStatus (:472),
updataRCFrameStatus (:486), updataRCUnitStatus (:569), updateFrameData
(:588), updateLCUData (:607).  Hook points: TEncSlice.cpp:249 (frame QP),
:814 (unit QP + lambda recalculation), :969 (LCU update), :991 (frame
data); TEncGOP.cpp:1209 (frame status), :1230 (GOP status).

The models run on the host (scalar control flow, a handful of flops per
CTU); only the MAD computation touches pixel data and is vectorized.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

_DBG = os.environ.get("RCDBG")


def _dbg(fmt, *a):
    if _DBG:
        sys.stderr.write(fmt % a)

ADJUSTMENT_FACTOR = 0.60
HIGH_QSTEP_THRESHOLD = 9.5238
HIGH_QSTEP_ALPHA = 4.9371
HIGH_QSTEP_BETA = 0.0922
LOW_QSTEP_ALPHA = 16.7429
LOW_QSTEP_BETA = -1.1494
MAX_DELTA_QP = 2
MIN_QP, MAX_QP = 0, 51

_QP2QSTEP = (0.625, 0.703, 0.797, 0.891, 1.000, 1.125)


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def qp_to_qstep(qp: int) -> float:
    q = _QP2QSTEP[qp % 6]
    return q * (2 ** (qp // 6))


def qstep_to_qp(qstep: float) -> int:
    if qstep < qp_to_qstep(MIN_QP):
        return MIN_QP
    if qstep > qp_to_qstep(MAX_QP):
        return MAX_QP
    per = 0
    while qstep > qp_to_qstep(5):
        qstep /= 2.0
        per += 1
    for rem, bound in enumerate((0.625, 0.703, 0.797, 0.891, 1.000)):
        if qstep <= bound:
            return per * 6 + rem
    return per * 6 + 5


class MadLinearModel:
    def __init__(self):
        self.active = False
        self.y1 = 1.0
        self.y2 = 0.0
        self.mads = [0.0, 0.0, 0.0]   # [pp-prev, p-prev, prev]

    def get_mad(self) -> float:
        pred = self.y1 * self.mads[2] + self.y2
        if pred < 0:
            pred = self.mads[2]
            self.y1, self.y2 = 1.0, 0.0
        return pred

    def update_model(self) -> None:
        new_y1 = ((self.mads[2] - self.mads[1])
                  / (self.mads[1] - self.mads[0]))
        new_y2 = self.mads[2] - new_y1 * self.mads[1]
        self.y1 = 0.70 + 0.20 * self.y1 + 0.10 * new_y1
        self.y2 = 0.20 * self.y2 + 0.10 * new_y2

    def update_history(self, mad: float) -> None:
        self.mads = [self.mads[1], self.mads[2], mad]
        self.active = bool(self.mads[0] and self.mads[1] and self.mads[2])


class UrqQuadraticModel:
    """Pixel-based unified-rate-quantization quadratic model."""

    def __init__(self):
        self.high_x1 = HIGH_QSTEP_ALPHA
        self.high_x2 = HIGH_QSTEP_BETA
        self.low_x1 = LOW_QSTEP_ALPHA
        self.low_x2 = LOW_QSTEP_BETA

    def get_qp(self, qp: int, target_bits: int, num_pixels: int,
               pred_mad: float) -> int:
        bpp_per_mad = target_bits / (num_pixels * pred_mad)
        if qp_to_qstep(qp) >= HIGH_QSTEP_THRESHOLD:
            x1, x2 = self.high_x1, self.high_x2
        else:
            x1, x2 = self.low_x1, self.low_x2
        # note x1^3 in the discriminant (the draft's formula, not x1^2)
        qstep = 1 / (math.sqrt((bpp_per_mad / x1)
                               + ((x2 * x2) / (4 * x1 * x1 * x1)))
                     - (x2 / (2 * x1)))
        return qstep_to_qp(qstep)

    def update(self, qp: int, bits: int, num_pixels: int,
               mad: float) -> None:
        qstep = qp_to_qstep(qp)
        inv = 1 / qstep
        if qstep >= HIGH_QSTEP_THRESHOLD:
            new_x2 = (((bits / (num_pixels * mad)) - (23.3772 * inv * inv))
                      / ((1 - 200 * inv) * inv))
            new_x1 = 23.3772 - 200 * new_x2
            self.high_x1 = 0.70 * HIGH_QSTEP_ALPHA + 0.20 * self.high_x1 \
                + 0.10 * new_x1
            self.high_x2 = 0.70 * HIGH_QSTEP_BETA + 0.20 * self.high_x2 \
                + 0.10 * new_x2
        else:
            new_x2 = (((bits / (num_pixels * mad)) - (5.8091 * inv * inv))
                      / ((1 - 9.5455 * inv) * inv))
            new_x1 = 5.8091 - 9.5455 * new_x2
            self.low_x1 = 0.90 * LOW_QSTEP_ALPHA + 0.09 * self.low_x1 \
                + 0.01 * new_x1
            self.low_x2 = 0.90 * LOW_QSTEP_BETA + 0.09 * self.low_x2 \
                + 0.01 * new_x2

    def check_update_available(self, qp_ref: int) -> bool:
        q = qp_to_qstep(qp_ref)
        return qp_to_qstep(MIN_QP) <= q <= qp_to_qstep(MAX_QP)


class _FrameData:
    __slots__ = ("referenced", "qp", "bits", "mad")

    def __init__(self, qp=0):
        self.referenced = False
        self.qp = qp
        self.bits = 0
        self.mad = 0.0


class _LcuData:
    __slots__ = ("qp", "bits", "pixels", "w", "h", "mad")

    def __init__(self, qp=0):
        self.qp = qp
        self.bits = 0
        self.pixels = 0
        self.w = 0
        self.h = 0
        self.mad = 0.0


class RateCtrl:
    def __init__(self, intra_period: int, gop_size: int, frame_rate: int,
                 target_kbps: int, qp: int, width: int, height: int,
                 max_cu: int = 64):
        self.w_lcu = (width + max_cu - 1) // max_cu
        self.h_lcu = (height + max_cu - 1) // max_cu
        self.is_lowdelay = intra_period == -1
        self.prev_bitrate = target_kbps * 1000
        self.curr_bitrate = target_kbps * 1000
        self.frame_rate = frame_rate
        self.ref_frame_num = gop_size if self.is_lowdelay else gop_size >> 1
        self.nonref_frame_num = gop_size - self.ref_frame_num
        self.size_gop = gop_size
        self.num_pixels = (width * height * 3) >> 1
        self.index_gop = 0
        self.index_frame = 0
        self.index_lcu = 0
        self.index_unit = 0
        self.index_ref = 0
        self.index_nonref = 0
        self.index_poc_in_gop = 0
        self.index_prev_poc_in_gop = 0
        self.occupancy_vb = 0
        self.initial_ovb = 0
        self.target_buf_level = 0
        self.initial_tbl = 0
        self.remaining_gop_bits = self.curr_bitrate * gop_size // frame_rate
        self.remaining_frame_bits = 0
        self.occupancy_vb_in_frame = 0
        self.target_bits = 0
        self.num_units = self.w_lcu * self.h_lcu
        self.coded_pixels = 0
        self.active_unit_level = False
        self.cost_nonref_w = 0.0
        self.cost_ref_w = 0.0
        self.cost_avg_bpp = 0.0
        self.mad_model = MadLinearModel()
        self.urq = UrqQuadraticModel()
        self.frames = [_FrameData(qp) for _ in range(gop_size + 1)]
        self.lcus = [_LcuData(qp) for _ in range(self.num_units)]
        for iy in range(self.h_lcu):
            for ix in range(self.w_lcu):
                u = self.lcus[iy * self.w_lcu + ix]
                u.w = min(width - ix * max_cu, max_cu)
                u.h = min(height - iy * max_cu, max_cu)
                u.pixels = (u.w * u.h * 3) >> 1

    # -- frame level (TEncRateCtrl::getFrameQP) --------------------------
    def get_frame_qp(self, referenced: bool, poc: int) -> int:
        self.index_poc_in_gop = self.size_gop if poc % self.size_gop == 0 \
            else poc % self.size_gop
        fd = self.frames[self.index_poc_in_gop]
        if self.index_frame != 0:
            if referenced:
                gamma = 0.5 if self.is_lowdelay else 0.25
                beta = 0.9 if self.is_lowdelay else 0.6
                rem_ref = self.ref_frame_num - self.index_ref
                rem_nonref = self.nonref_frame_num - self.index_nonref
                occ = (self.curr_bitrate / self.frame_rate) + gamma * (
                    self.target_buf_level - self.occupancy_vb
                    - (self.initial_ovb / self.frame_rate))
                budget = ((self.cost_ref_w * self.remaining_gop_bits)
                          / ((self.cost_ref_w * rem_ref)
                             + (self.cost_nonref_w * rem_nonref)))
                self.target_bits = int(beta * budget + (1 - beta) * occ)
                prev = self.frames[self.index_prev_poc_in_gop].qp
                if self.target_bits <= 0 or self.remaining_gop_bits <= 0:
                    final_qp = prev + 2
                else:
                    pred_mad = self.mad_model.get_mad()
                    final_qp = self.urq.get_qp(prev, self.target_bits,
                                               self.num_pixels, pred_mad)
                    final_qp = max(prev - 2, min(prev + 2, final_qp))
                    self.active_unit_level = True
                    self.remaining_frame_bits = self.target_bits
                    self.cost_avg_bpp = self.target_bits / self.num_pixels
                self.index_ref += 1
            else:
                bwd = self.frames[self.index_poc_in_gop - 1].qp
                fwd = self.frames[self.index_poc_in_gop + 1].qp
                if (fwd + bwd) in (bwd, fwd):
                    final_qp = fwd + bwd
                elif bwd != fwd:
                    final_qp = (bwd + fwd + 2) >> 1
                else:
                    final_qp = bwd + 2
                self.index_nonref += 1
        else:
            num_ref = 0
            final_qp = 0
            for idx in range(1, self.size_gop + 1):
                if self.frames[idx].referenced:
                    final_qp += self.frames[idx].qp
                    num_ref += 1
            qp0 = self.frames[0].qp
            final_qp = qp0 if num_ref == 0 else \
                (final_qp + (1 << (num_ref >> 1))) // num_ref
            final_qp = max(qp0 - 2, min(qp0 + 2, final_qp))
            avg_frame_bits = self.remaining_gop_bits / self.size_gop
            buf_level = self.occupancy_vb + self.initial_ovb
            if abs(buf_level) > avg_frame_bits:
                final_qp += -2 if buf_level < 0 else 2
            self.index_ref += 1
        final_qp = max(MIN_QP, min(MAX_QP, final_qp))
        for u in self.lcus:
            u.qp = final_qp
        fd.referenced = referenced
        fd.qp = final_qp
        _dbg("FRAMEQP poc=%d ref=%d finalQP=%d targetBits=%d remGOP=%d occVB=%d iOVB=%d tbl=%d crw=%.6f cnw=%.6f active=%d\n",
             poc, int(referenced), final_qp, self.target_bits,
             self.remaining_gop_bits, self.occupancy_vb, self.initial_ovb,
             self.target_buf_level, self.cost_ref_w, self.cost_nonref_w,
             int(self.active_unit_level))
        return final_qp

    # -- unit level (calculateUnitQP / getUnitQP) ------------------------
    def calculate_unit_qp(self) -> bool:
        if not self.active_unit_level or self.index_lcu == 0:
            return False
        u = self.lcus[self.index_lcu]
        col_qp, col_mad = u.qp, u.mad
        budget_in_unit = u.pixels * self.cost_avg_bpp
        # Int/Int in the reference: the occupancy share truncates first
        occ = int(budget_in_unit - _cdiv(self.occupancy_vb_in_frame,
                                         self.num_units - self.index_unit))
        budget = int((self.remaining_frame_bits * u.pixels)
                     / (self.num_pixels - self.coded_pixels))
        target_bits = (budget >> 1) + (occ >> 1)
        if self.index_lcu >= self.w_lcu:
            mid = (self.lcus[self.index_lcu - 1].qp
                   + self.lcus[self.index_lcu - self.w_lcu].qp) >> 1
            upper, lower = mid + MAX_DELTA_QP, mid - MAX_DELTA_QP
        else:
            prev_qp = self.lcus[self.index_lcu - 1].qp
            upper, lower = prev_qp + MAX_DELTA_QP, prev_qp - MAX_DELTA_QP
        if target_bits < 0:
            final_qp = self.lcus[self.index_lcu - 1].qp + 1
        else:
            final_qp = self.urq.get_qp(u.qp, target_bits, u.pixels, u.mad)
        final_qp = max(lower, min(upper, final_qp))
        u.qp = max(MIN_QP, min(MAX_QP, final_qp))
        _dbg("UNITQP lcu=%d colQP=%d colMAD=%.6f tgt=%d occ=%d bud=%d lo=%d hi=%d final=%d remF=%d occF=%d coded=%d avgbpp=%.8f hx1=%.6f hx2=%.6f lx1=%.6f lx2=%.6f\n",
             self.index_lcu, col_qp, col_mad, target_bits, occ, budget,
             lower, upper, u.qp, self.remaining_frame_bits,
             self.occupancy_vb_in_frame, self.coded_pixels,
             self.cost_avg_bpp, self.urq.high_x1, self.urq.high_x2,
             self.urq.low_x1, self.urq.low_x2)
        return True

    def get_unit_qp(self) -> int:
        return self.lcus[self.index_lcu].qp

    # -- updates ----------------------------------------------------------
    def update_lcu_data(self, org_y: np.ndarray, rec_y: np.ndarray,
                        x: int, y: int, bits: int, qp: int) -> None:
        u = self.lcus[self.index_lcu]
        o = org_y[y:y + u.h, x:x + u.w].astype(np.int64)
        r = rec_y[y:y + u.h, x:x + u.w].astype(np.int64)
        u.qp = qp
        u.mad = float(np.abs(o - r).sum()) / (u.w * u.h)
        u.bits = int(bits)
        _dbg("LCUDATA lcu=%d qp=%d mad=%.6f bits=%d\n",
             self.index_lcu, qp, u.mad, u.bits)
        self.index_lcu += 1

    def update_unit_status(self) -> None:
        if not self.active_unit_level or self.index_lcu == 0:
            return
        u = self.lcus[self.index_lcu - 1]
        self.coded_pixels += u.pixels
        self.remaining_frame_bits -= u.bits
        self.occupancy_vb_in_frame = int(
            self.occupancy_vb_in_frame + u.bits
            - u.pixels * self.cost_avg_bpp)
        if self.urq.check_update_available(u.qp):
            self.urq.update(u.qp, u.bits, u.pixels, u.mad)
        self.index_unit += 1

    def update_frame_data(self, actual_frame_bits: int) -> None:
        mad = sum(u.mad for u in self.lcus) / self.num_units
        fd = self.frames[self.index_poc_in_gop]
        fd.mad = mad
        fd.bits = int(actual_frame_bits)
        if fd.referenced:
            self.index_prev_poc_in_gop = self.index_poc_in_gop
            self.mad_model.update_history(fd.mad)

    def update_frame_status(self, frame_bits: int, slice_type: int) -> None:
        """updataRCFrameStatus; slice_type: params.I_SLICE sentinel only."""
        fd = self.frames[self.index_poc_in_gop]
        self.remaining_gop_bits = self.remaining_gop_bits + (
            ((self.curr_bitrate - self.prev_bitrate) // self.frame_rate)
            * (self.size_gop - self.index_frame)) - frame_bits
        occupancy = int(frame_bits - (self.curr_bitrate / self.frame_rate))
        if occupancy < 0 and self.initial_ovb > 0:
            occupancy, self.initial_ovb, _ = \
                self._adjust(occupancy, self.initial_ovb)
            if self.initial_ovb < 0:
                occupancy += self.initial_ovb
                self.initial_ovb = 0
        elif occupancy > 0 and self.initial_ovb < 0:
            self.initial_ovb, occupancy, _ = \
                self._adjust(self.initial_ovb, occupancy)
            if occupancy < 0:
                self.initial_ovb += occupancy
                occupancy = 0
        if self.index_gop == 0:
            self.initial_ovb = occupancy
        else:
            self.occupancy_vb += occupancy
        if fd.referenced:
            self.cost_ref_w = (fd.bits * fd.qp) / 8.0 \
                + 7.0 * self.cost_ref_w / 8.0
            if self.index_frame == 0:
                self.initial_tbl = self.target_buf_level = \
                    frame_bits - self.curr_bitrate // self.frame_rate
            else:
                distance = 0 if self.cost_nonref_w == 0 else 1
                self.target_buf_level = (
                    self.target_buf_level
                    - _cdiv(self.initial_tbl, self.ref_frame_num - 1)
                    + int((self.cost_ref_w * (distance + 1)
                           * self.curr_bitrate)
                          / (self.frame_rate
                             * (self.cost_ref_w
                                + self.cost_nonref_w * distance)))
                    - self.curr_bitrate // self.frame_rate)
            if self.mad_model.active:
                self.mad_model.update_model()
            from ..params import I_SLICE
            if slice_type != I_SLICE and \
                    self.urq.check_update_available(fd.qp):
                self.urq.update(fd.qp, fd.bits, self.num_pixels, fd.mad)
        else:
            self.cost_nonref_w = (fd.bits * fd.qp) / 8.0 \
                + 7.0 * self.cost_nonref_w / 8.0
        self.index_frame += 1
        self.index_lcu = 0
        self.index_unit = 0
        self.occupancy_vb_in_frame = 0
        self.remaining_frame_bits = 0
        self.coded_pixels = 0
        self.active_unit_level = False
        self.cost_avg_bpp = 0.0

    def update_gop_status(self) -> None:
        self.remaining_gop_bits = \
            (self.curr_bitrate // self.frame_rate) * self.size_gop \
            - self.occupancy_vb
        carry = self.frames[self.size_gop]
        qp0 = 0
        self.frames = [_FrameData(qp0) for _ in range(self.size_gop + 1)]
        self.frames[0] = carry
        self.index_gop += 1
        self.index_frame = 0
        self.index_ref = 0
        self.index_nonref = 0

    @staticmethod
    def _adjust(reduction: int, compensation: int):
        adj = ADJUSTMENT_FACTOR * reduction
        reduction -= int(adj)
        compensation += int(adj)
        return reduction, compensation, adj

    def gop_id(self) -> int:
        return self.index_frame
