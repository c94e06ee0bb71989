"""SAO parameter estimation (LCU-based RDO) + application.

Behavioral reference: TEncSampleAdaptiveOffset.cpp (SAOProcess :1225,
startSaoEnc :530, rdoSaoUnitAll :1466, saoComponentParamDist :1897,
sao2ChromaParamDist :2064, estSaoTypeDist :1808, estIterOffset :1858,
estSaoDist :1854, calcSaoStatsCuOrg :859, xRoundIbdi :85) and
TComSampleAdaptiveOffset.cpp (m_auiEoTable :94, m_lumaTableBo :181) with
the active macros SAO_SINGLE_MERGE, SAO_TYPE_SHARING, SAO_MERGE_ONE_CTX,
SAO_TYPE_CODING, SAO_ENCODING_CHOICE(+_CHROMA), SAO_SKIP_RIGHT,
SAOLcuBasedOptimization=1.

The per-CTU statistics are pure sign-comparison reductions over the
deblocked frame (vectorized here with numpy; the same formulation batches
over all CTUs on device — ops.jx will mirror it for the TPU path).

Syntax rate is measured with the fractional-bit counter starting from
fresh slice-init contexts (startSaoEnc calls resetEntropy), evolving only
through the chosen SAO syntax per CTU.
"""

from __future__ import annotations

import numpy as np

from ..cabac import contexts as cc
from ..cabac.bitcount import CounterEncoder
from .sbac_writer import SbacWriter

MAX_DOUBLE = 1.7e308
SAO_ENCODING_RATE = 0.75
SAO_ENCODING_RATE_CHROMA = 0.5
N_TYPES = 5          # EO_0, EO_1, EO_2, EO_3, BO
N_CLASSES = 33
BO_CLASSES = 32
BO_LEN = 4
EO_TABLE = np.array([1, 2, 0, 3, 4], np.int64)  # edgeType -> stats class


def _fsum4(vals, i):
    """Naive left-to-right double summation (C semantics; Python's sum()
    uses compensated summation since 3.12, which breaks RD tie-breaks)."""
    s = 0.0
    s += vals[i]
    s += vals[i + 1]
    s += vals[i + 2]
    s += vals[i + 3]
    return s


def _trunc_div(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // b
    return q if a >= 0 else -q


def _round_ibdi(x: float, bit_increment: int) -> int:
    """xRoundIbdi (TEncSampleAdaptiveOffset.cpp:85-109): half-away rounding;
    the IBDI variant truncates to int first and uses C integer division."""
    if bit_increment > 0:
        ix = int(x)  # C double->int truncation
        if x > 0:
            return _trunc_div(ix + (1 << (bit_increment - 1)),
                              1 << bit_increment)
        return _trunc_div(ix - (1 << (bit_increment - 1)), 1 << bit_increment)
    return int(x + 0.5) if x >= 0 else -int(-x + 0.5)


class SaoUnit:
    __slots__ = ("type_idx", "sub_type", "offsets", "merge_left", "merge_up",
                 "length")

    def __init__(self):
        self.reset()

    def reset(self):
        self.type_idx = -1
        self.sub_type = 0
        self.offsets = [0, 0, 0, 0]
        self.merge_left = 0
        self.merge_up = 0
        self.length = 0

    def copy_from(self, other: "SaoUnit"):
        self.type_idx = other.type_idx
        self.sub_type = other.sub_type
        self.offsets = list(other.offsets)
        self.merge_left = other.merge_left
        self.merge_up = other.merge_up
        self.length = other.length


_QT_CUM_PARTS = (1, 5, 21, 85, 341)   # m_aiNumCulPartsLevel


class _QtPart:
    """SAOQTPart: one node of the picture-based SAO quadtree."""
    __slots__ = ("idx", "level", "scx", "ecx", "scy", "ecy", "up", "down",
                 "best_type", "length", "sub_type", "offsets", "split",
                 "processed", "min_cost", "min_dist", "min_rate")

    def __init__(self, idx, level, scx, ecx, scy, ecy, up):
        self.idx = idx
        self.level = level
        self.scx, self.ecx, self.scy, self.ecy = scx, ecx, scy, ecy
        self.up = up
        self.down = [-1, -1, -1, -1]
        self.best_type = -1
        self.length = 0
        self.sub_type = 0
        self.offsets = [0, 0, 0, 0]
        self.split = False
        self.processed = False
        self.min_cost = MAX_DOUBLE
        self.min_dist = 0
        self.min_rate = 0


class _QtLcuUnit:
    """SaoLcuParam fields used by the QT→LCU conversion.  Initial merge
    flags follow resetLcuPart (TComSampleAdaptiveOffset.cpp:1241-1248):
    mergeUp defaults to 1 — in the one-unit case assignSaoUnitSyntax never
    touches them, so every non-first-row CTU is written as a merge-up."""
    __slots__ = ("part_idx", "part_tmp", "merge_left", "merge_up",
                 "type_idx", "length", "sub_type", "offsets")

    def __init__(self):
        self.part_idx = 0
        self.part_tmp = 0
        self.merge_left = 0
        self.merge_up = 1
        self.type_idx = -1
        self.length = 0
        self.sub_type = 0
        self.offsets = [0, 0, 0, 0]


class SaoEncoder:
    """TEncSampleAdaptiveOffset equivalent for the LCU-based RDO path."""

    def __init__(self, frame, sh, sps, pps, cfg, lambda_luma: float,
                 lambda_chroma: float, org_planes, depth_sao_rate=None,
                 gop_depth: int = 0, init_frac: int = 0):
        self.f = frame
        self.sh = sh
        self.sps = sps
        self.pps = pps
        self.cfg = cfg
        self.lambda_luma = lambda_luma
        self.lambda_chroma = lambda_chroma
        self.org_y, self.org_cb, self.org_cr = org_planes
        self.gop_depth = gop_depth
        # persistent across pictures (SAO_ENCODING_CHOICE)
        self.depth_sao_rate = depth_sao_rate if depth_sao_rate is not None \
            else [[0.0] * 10, [0.0] * 10]

        bd = sps.internal_bit_depth
        self.bit_increment = sps.bit_increment
        self.sao_bit_increase = bd - min(bd, 10)
        self.offset_th = 1 << min(bd - 5, 5)
        self.shift = sps.bit_increment << 1
        self.bo_shift = bd - 5  # lumaTableBo: 1 + (pel >> (bd-5))

        self.bsao = [True, True]  # [luma, chroma] (SAO_TYPE_SHARING)
        # chosen per-CTU units [comp][ctu]
        self.units = [[SaoUnit() for _ in range(frame.num_ctus)]
                      for _ in range(3)]

        # RD coder state; startSaoEnc does resetEntropy + resetBits on the
        # GoOn coder, which keeps the post-compressSlice fractional-bit
        # residue (TEncBinCABAC::start never clears m_fracBits)
        from .slice_encoder import enc_init_type
        init = cc.make_context_states_idx(enc_init_type(sh, pps),
                                          sh.slice_qp)
        frac = init_frac & 32767
        self.go = CounterEncoder(init.copy())
        self.go.frac_bits = frac
        self.w = SbacWriter(frame, sh, sps, pps, self.go)
        self.curr_best = (init.copy(), frac)
        self.temp_best = (init.copy(), frac)

        # per-CTU stats [comp][type][class]
        self.count = np.zeros((3, N_TYPES, N_CLASSES), np.int64)
        self.offset_org = np.zeros((3, N_TYPES, N_CLASSES), np.int64)
        self.offset = np.zeros((3, N_TYPES, N_CLASSES), np.int64)

    # -- coder snapshots ----------------------------------------------------
    def _load(self, snap):
        ctx, frac = snap
        np.copyto(self.go.ctx, ctx)
        self.go.frac_bits = frac

    def _snap(self):
        return (self.go.ctx.copy(), self.go.frac_bits)

    # ==================================================================
    def process(self, rec_y, rec_cb, rec_cr):
        """SAOProcess: RDO fills frame SAO arrays, then apply offsets."""
        f = self.f
        sh = self.sh
        if getattr(self.cfg, "sao_lcu_based_optimization", 1) == 0:
            self._rdo_quadtree(rec_y)       # fills frame arrays directly
            native_done = True
        else:
            native_done = self._rdo_native(rec_y, rec_cb, rec_cr)
        if not native_done:
            self._rdo_sao_unit_all(rec_y, rec_cb, rec_cr)
            # store into frame arrays (decoder storage convention)
            for comp in range(3):
                for ctu in range(f.num_ctus):
                    u = self.units[comp][ctu]
                    f.sao_type[comp, ctu] = u.type_idx
                    f.sao_sub_type[comp, ctu] = u.sub_type
                    f.sao_offsets[comp, ctu] = u.offsets
                    f.sao_merge_left[comp, ctu] = bool(u.merge_left)
                    f.sao_merge_up[comp, ctu] = bool(u.merge_up)

        # TEncEntropy::setEntropyCoder:61-74 — the chroma slice flag is
        # forced 0 when the luma flag is off (and then no SAO data is
        # written at all, TEncSlice.cpp:1241)
        sh.sao_enabled = self.bsao[0]
        sh.sao_enabled_chroma = self.bsao[1] if self.bsao[0] else False
        from ..decoder.filters import sao_frame
        return sao_frame(f, sh, self.sps, rec_y, rec_cb, rec_cr)

    def _rdo_native(self, rec_y, rec_cb, rec_cr) -> bool:
        """Run rdoSaoUnitAll in the native core; returns False when the
        native library is unavailable (Python fallback runs instead)."""
        import os
        if os.environ.get("THEVC_NATIVE", "1") == "0":
            return False
        from .. import native
        lib = native.get_lib()
        if lib is None:
            return False
        import ctypes
        from ..decoder.native_parse import fill_frame_arrays

        f = self.f
        depth = self.gop_depth
        self.bsao = [True, True]
        if depth > 0 and self.depth_sao_rate[0][depth - 1] > \
                SAO_ENCODING_RATE:
            self.bsao[0] = False
        if depth > 0 and self.depth_sao_rate[1][depth - 1] > \
                SAO_ENCODING_RATE_CHROMA:
            self.bsao[1] = False

        fa = fill_frame_arrays(f)
        init = np.ascontiguousarray(self.go.ctx, np.uint8)  # slice-init copy
        rec_y = np.ascontiguousarray(rec_y, np.int16)
        rec_cb = np.ascontiguousarray(rec_cb, np.int16)
        rec_cr = np.ascontiguousarray(rec_cr, np.int16)
        org_y = np.ascontiguousarray(self.org_y, np.int16)
        org_cb = np.ascontiguousarray(self.org_cb, np.int16)
        org_cr = np.ascontiguousarray(self.org_cr, np.int16)
        out_no_sao = np.zeros(2, np.int64)
        lib.sao_rdo(
            ctypes.byref(fa), ctypes.byref(native.ctx_offsets()),
            rec_y.ctypes.data, rec_cb.ctypes.data, rec_cr.ctypes.data,
            org_y.ctypes.data, org_cb.ctypes.data,
            org_cr.ctypes.data,
            rec_y.shape[1], self.sps.internal_bit_depth, self.bit_increment,
            self.lambda_luma, self.lambda_chroma,
            int(self.bsao[0]), int(self.bsao[1]),
            init.ctypes.data, cc.NUM_CTX, self.go.frac_bits,
            out_no_sao.ctypes.data)
        n = float(f.num_ctus)
        self.depth_sao_rate[0][depth] = int(out_no_sao[0]) / n
        self.depth_sao_rate[1][depth] = int(out_no_sao[1]) / (n * 2)
        return True

    # ==================================================================
    # statistics (calcSaoStatsCuOrg)
    # ==================================================================
    def _calc_stats_cu(self, ctu: int, comp: int, rec, org,
                       lcu_skip: bool = True):
        """Fill self.count/offset_org[comp] for one CTU (numpy-vectorized,
        same truncation/skip geometry as the reference).  lcu_skip=False is
        the picture-based mode: m_saoLcuBasedOptimization==0 zeroes both
        numSkipLine and numSkipLineRight (calcSaoStatsCuOrg :886-898)."""
        f = self.f
        chroma = comp != 0
        lcu = f.ctu_size >> (1 if chroma else 0)
        pic_w = f.width >> (1 if chroma else 0)
        pic_h = f.height >> (1 if chroma else 0)
        rx, ry = ctu % f.ctus_w, ctu // f.ctus_w
        lx, ty = rx * lcu, ry * lcu
        rpel = min(lx + lcu, pic_w)
        bpel = min(ty + lcu, pic_h)
        width = rpel - lx
        height = bpel - ty
        skip_n = (2 if chroma else 4) if lcu_skip else 0
        skip_r = (3 if chroma else 5) if lcu_skip else 0

        cnt = self.count[comp]
        sums = self.offset_org[comp]
        cnt[:] = 0
        sums[:] = 0
        r = rec.astype(np.int64)
        o = org.astype(np.int64)
        diff_full = o - r

        def acc(type_idx, ys, ye, xs, xe, et):
            d = diff_full[ty + ys:ty + ye, lx + xs:lx + xe].reshape(-1)
            cls = EO_TABLE[et.reshape(-1)]
            np.add.at(sums[type_idx], cls, d)
            np.add.at(cnt[type_idx], cls, 1)

        # ---- BO ----
        end_x = width if rpel == pic_w else width - skip_r
        end_y = height if bpel == pic_h else height - skip_n
        if end_x > 0 and end_y > 0:
            blk_r = r[ty:ty + end_y, lx:lx + end_x]
            cls = 1 + (blk_r >> self.bo_shift)
            d = diff_full[ty:ty + end_y, lx:lx + end_x]
            np.add.at(sums[4], cls.reshape(-1), d.reshape(-1))
            np.add.at(cnt[4], cls.reshape(-1), 1)

        sgn = np.sign

        # ---- EO_0 (horizontal) ----
        xs = 1 if lx == 0 else 0
        xe = (width - 1) if rpel == pic_w else width - skip_r
        ye = height - skip_n
        if xe > xs and ye > 0:
            c = r[ty:ty + ye, lx + xs:lx + xe]
            left = r[ty:ty + ye, lx + xs - 1:lx + xe - 1]
            right = r[ty:ty + ye, lx + xs + 1:lx + xe + 1]
            et = (sgn(c - left) + sgn(c - right) + 2).astype(np.int64)
            acc(0, 0, ye, xs, xe, et)

        # ---- EO_1 (vertical) ----
        ys = 1 if ty == 0 else 0
        ye = (height - 1) if bpel == pic_h else height - skip_n
        xe = width if rpel == pic_w else width - skip_r
        if ye > ys and xe > 0:
            c = r[ty + ys:ty + ye, lx:lx + xe]
            up = r[ty + ys - 1:ty + ye - 1, lx:lx + xe]
            dn = r[ty + ys + 1:ty + ye + 1, lx:lx + xe]
            et = (sgn(c - up) + sgn(c - dn) + 2).astype(np.int64)
            acc(1, ys, ye, 0, xe, et)

        # ---- EO_2 (135 degrees) ----
        xs = 1 if lx == 0 else 0
        xe = (width - 1) if rpel == pic_w else width - skip_r
        ys = 1 if ty == 0 else 0
        ye = (height - 1) if bpel == pic_h else height - skip_n
        if xe > xs and ye > ys:
            c = r[ty + ys:ty + ye, lx + xs:lx + xe]
            ul = r[ty + ys - 1:ty + ye - 1, lx + xs - 1:lx + xe - 1]
            dr = r[ty + ys + 1:ty + ye + 1, lx + xs + 1:lx + xe + 1]
            et = (sgn(c - ul) + sgn(c - dr) + 2).astype(np.int64)
            acc(2, ys, ye, xs, xe, et)

        # ---- EO_3 (45 degrees) ----
        if xe > xs and ye > ys:
            c = r[ty + ys:ty + ye, lx + xs:lx + xe]
            ur = r[ty + ys - 1:ty + ye - 1, lx + xs + 1:lx + xe + 1]
            dl = r[ty + ys + 1:ty + ye + 1, lx + xs - 1:lx + xe - 1]
            et = (sgn(c - ur) + sgn(c - dl) + 2).astype(np.int64)
            acc(3, ys, ye, xs, xe, et)

    # ==================================================================
    # offset estimation (estSaoTypeDist / estIterOffset / estSaoDist)
    # ==================================================================
    @staticmethod
    def _est_sao_dist(count, offset, offset_org, shift):
        return (count * offset * offset - offset_org * offset * 2) >> shift

    def _est_iter_offset(self, type_idx, class_idx, lam, offset_input, count,
                         offset_org, dist_bo, cost_bo):
        iter_offset = int(offset_input)
        offset_output = 0
        temp_min_cost = lam
        while iter_offset != 0:
            temp_rate = (abs(iter_offset) + 2) if type_idx == 4 \
                else (abs(iter_offset) + 1)
            if abs(iter_offset) == self.offset_th - 1:
                temp_rate -= 1
            temp_offset = iter_offset << self.sao_bit_increase
            temp_dist = self._est_sao_dist(count, temp_offset, offset_org,
                                           self.shift)
            temp_cost = float(temp_dist) + lam * float(temp_rate)
            if temp_cost < temp_min_cost:
                temp_min_cost = temp_cost
                offset_output = iter_offset
                if type_idx == 4:
                    dist_bo[class_idx - 1] = int(temp_dist)
                    cost_bo[class_idx - 1] = temp_cost
            iter_offset = iter_offset - 1 if iter_offset > 0 else iter_offset + 1
        return offset_output

    def _est_sao_type_dist(self, comp, type_idx, lam, dist_bo, cost_bo):
        est_dist = 0
        n = (4 + 1) if type_idx < 4 else (BO_CLASSES + 1)
        for class_idx in range(1, n):
            if type_idx == 4:
                dist_bo[class_idx - 1] = 0
                cost_bo[class_idx - 1] = lam
            cnt = int(self.count[comp][type_idx][class_idx])
            if cnt:
                num = float(int(self.offset_org[comp][type_idx][class_idx])
                            << self.bit_increment)
                den = float(cnt << self.sao_bit_increase)
                off = _round_ibdi(num / den, self.bit_increment)
                off = max(-self.offset_th + 1, min(self.offset_th - 1, off))
                if type_idx < 4:
                    if off < 0 and class_idx < 3:
                        off = 0
                    if off > 0 and class_idx >= 3:
                        off = 0
                off = self._est_iter_offset(
                    type_idx, class_idx, lam, off, cnt,
                    int(self.offset_org[comp][type_idx][class_idx]),
                    dist_bo, cost_bo)
                self.offset[comp][type_idx][class_idx] = off
            else:
                self.offset_org[comp][type_idx][class_idx] = 0
                self.offset[comp][type_idx][class_idx] = 0
            if type_idx != 4:
                est_dist += self._est_sao_dist(
                    int(self.count[comp][type_idx][class_idx]),
                    int(self.offset[comp][type_idx][class_idx])
                    << self.sao_bit_increase,
                    int(self.offset_org[comp][type_idx][class_idx]),
                    self.shift)
        return int(est_dist)

    # -- rate helper --------------------------------------------------------
    def _code_unit(self, unit: SaoUnit, comp: int) -> None:
        self.w.code_sao_offset(comp, unit.type_idx, unit.sub_type,
                               unit.offsets, self.sps.internal_bit_depth)

    # ==================================================================
    # per-component RDO (saoComponentParamDist / sao2ChromaParamDist)
    # ==================================================================
    def _component_param_dist(self, allow_l, allow_u, ctu, comp, lam,
                              merge_units, comp_distortion):
        f = self.f
        best_unit = self.units[comp][ctu]
        best_unit.reset()
        merge_units[0].reset()
        merge_units[1].reset()

        dist_bo = [0] * (N_CLASSES - 1)
        cost_bo = [0.0] * (N_CLASSES - 1)
        best_rd_bo = MAX_DOUBLE
        best_class_bo = 0

        rdo = SaoUnit()
        self._load(self.temp_best)
        self.go.reset_bits()
        self._code_unit(rdo, comp)
        cost_best = self.go.num_written_bits * lam
        best_unit.copy_from(rdo)
        best_dist = 0

        for type_idx in range(N_TYPES):
            est_dist = self._est_sao_type_dist(comp, type_idx, lam,
                                               dist_bo, cost_bo)
            if type_idx == 4:
                for i in range(BO_CLASSES - BO_LEN + 1):
                    cur = _fsum4(cost_bo, i)
                    if cur < best_rd_bo:
                        best_rd_bo = cur
                        best_class_bo = i
                est_dist = sum(dist_bo[best_class_bo:best_class_bo + BO_LEN])
            rdo.reset()
            rdo.length = 4
            rdo.type_idx = type_idx
            rdo.sub_type = best_class_bo if type_idx == 4 else type_idx
            for ci in range(4):
                rdo.offsets[ci] = int(
                    self.offset[comp][type_idx]
                    [ci + (best_class_bo if type_idx == 4 else 0) + 1])
            self._load(self.temp_best)
            self.go.reset_bits()
            self._code_unit(rdo, comp)
            est_rate = self.go.num_written_bits
            cost = float(est_dist) + lam * float(est_rate)
            if cost < cost_best:
                cost_best = cost
                best_unit.copy_from(rdo)
                best_dist = est_dist

        comp_distortion[0] += float(best_dist) / lam
        self._load(self.temp_best)
        self._code_unit(best_unit, comp)
        self.temp_best = self._snap()

        # merge candidates
        for idx_neighbor in range(2):
            nb = None
            if allow_l and idx_neighbor == 0 and ctu % f.ctus_w > 0:
                nb = self.units[comp][ctu - 1]
            elif allow_u and idx_neighbor == 1 and ctu >= f.ctus_w:
                nb = self.units[comp][ctu - f.ctus_w]
            if nb is None:
                continue
            est_dist = 0
            if nb.type_idx >= 0:
                band = nb.sub_type if nb.type_idx == 4 else 0
                for ci in range(4):
                    est_dist += self._est_sao_dist(
                        int(self.count[comp][nb.type_idx][ci + band + 1]),
                        nb.offsets[ci],
                        int(self.offset_org[comp][nb.type_idx][ci + band + 1]),
                        self.shift)
            merge_units[idx_neighbor].copy_from(nb)
            merge_units[idx_neighbor].merge_up = idx_neighbor
            merge_units[idx_neighbor].merge_left = 1 - idx_neighbor
            comp_distortion[idx_neighbor + 1] += float(est_dist) / lam

    def _chroma2_param_dist(self, allow_l, allow_u, ctu, lam,
                            merge_cb, merge_cr, distortion):
        f = self.f
        best = [self.units[1][ctu], self.units[2][ctu]]
        best[0].reset()
        best[1].reset()
        merge_param = [[merge_cb[0], merge_cb[1]], [merge_cr[0], merge_cr[1]]]
        for cu in (merge_cb + merge_cr):
            cu.reset()

        dist_bo = [0] * (N_CLASSES - 1)
        cost_bo = [0.0] * (N_CLASSES - 1)
        best_class_bo = [0, 0]
        est_dist = [0, 0]

        rdo = [SaoUnit(), SaoUnit()]
        self._load(self.temp_best)
        self.go.reset_bits()
        self._code_unit(rdo[0], 1)
        self._code_unit(rdo[1], 2)
        cost_best = self.go.num_written_bits * lam
        best[0].copy_from(rdo[0])
        best[1].copy_from(rdo[1])
        best_dist = 0

        for type_idx in range(N_TYPES):
            if type_idx == 4:
                for ci in range(2):
                    best_rd_bo = MAX_DOUBLE
                    est_dist[ci] = self._est_sao_type_dist(
                        ci + 1, type_idx, lam, dist_bo, cost_bo)
                    for i in range(BO_CLASSES - BO_LEN + 1):
                        cur = _fsum4(cost_bo, i)
                        if cur < best_rd_bo:
                            best_rd_bo = cur
                            best_class_bo[ci] = i
                    est_dist[ci] = sum(
                        dist_bo[best_class_bo[ci]:best_class_bo[ci] + BO_LEN])
            else:
                est_dist[0] = self._est_sao_type_dist(1, type_idx, lam,
                                                      dist_bo, cost_bo)
                est_dist[1] = self._est_sao_type_dist(2, type_idx, lam,
                                                      dist_bo, cost_bo)

            self._load(self.temp_best)
            self.go.reset_bits()
            for ci in range(2):
                rdo[ci].reset()
                rdo[ci].length = 4
                rdo[ci].type_idx = type_idx
                rdo[ci].sub_type = best_class_bo[ci] if type_idx == 4 \
                    else type_idx
                for k in range(4):
                    rdo[ci].offsets[k] = int(
                        self.offset[ci + 1][type_idx]
                        [k + (best_class_bo[ci] if type_idx == 4 else 0) + 1])
                self._code_unit(rdo[ci], ci + 1)
            est_rate = self.go.num_written_bits
            cost = float(est_dist[0] + est_dist[1]) + lam * float(est_rate)
            if cost < cost_best:
                cost_best = cost
                best[0].copy_from(rdo[0])
                best[1].copy_from(rdo[1])
                best_dist = est_dist[0] + est_dist[1]

        distortion[0] += float(best_dist) / lam
        self._load(self.temp_best)
        self._code_unit(best[0], 1)
        self._code_unit(best[1], 2)
        self.temp_best = self._snap()

        for idx_neighbor in range(2):
            for ci in range(2):
                nb = None
                if allow_l and idx_neighbor == 0 and ctu % f.ctus_w > 0:
                    nb = self.units[ci + 1][ctu - 1]
                elif allow_u and idx_neighbor == 1 and ctu >= f.ctus_w:
                    nb = self.units[ci + 1][ctu - f.ctus_w]
                if nb is None:
                    continue
                dist_c = 0
                if nb.type_idx >= 0:
                    band = nb.sub_type if nb.type_idx == 4 else 0
                    for k in range(4):
                        dist_c += self._est_sao_dist(
                            int(self.count[ci + 1][nb.type_idx][k + band + 1]),
                            nb.offsets[k],
                            int(self.offset_org[ci + 1][nb.type_idx]
                                [k + band + 1]),
                            self.shift)
                merge_param[ci][idx_neighbor].copy_from(nb)
                merge_param[ci][idx_neighbor].merge_up = idx_neighbor
                merge_param[ci][idx_neighbor].merge_left = 1 - idx_neighbor
                distortion[idx_neighbor + 1] += float(dist_c) / lam

    # ==================================================================
    # rdoSaoUnitAll
    # ==================================================================
    def _rdo_sao_unit_all(self, rec_y, rec_cb, rec_cr) -> None:
        f = self.f
        depth = self.gop_depth
        self.bsao = [True, True]
        if depth > 0 and self.depth_sao_rate[0][depth - 1] > SAO_ENCODING_RATE:
            self.bsao[0] = False
        if depth > 0 and self.depth_sao_rate[1][depth - 1] > \
                SAO_ENCODING_RATE_CHROMA:
            self.bsao[1] = False
        num_no_sao = [0, 0]

        rec = [rec_y, rec_cb, rec_cr]
        org = [self.org_y, self.org_cb, self.org_cr]

        # per-CTU tile and slice indices for merge allowances
        # (rdoSaoUnitAll: "check tile id and slice id")
        upr = f.units_per_row
        ctu_tile = f.tile_idx[::upr, ::upr].reshape(-1)
        ctu_slice = f.slice_idx[::upr, ::upr].reshape(-1)

        for ctu in range(f.num_ctus):
            rx, ry = ctu % f.ctus_w, ctu // f.ctus_w
            allow_l = rx != 0 and ctu_tile[ctu - 1] == ctu_tile[ctu] and \
                ctu_slice[ctu - 1] == ctu_slice[ctu]
            allow_u = ry != 0 and \
                ctu_tile[ctu - f.ctus_w] == ctu_tile[ctu] and \
                ctu_slice[ctu - f.ctus_w] == ctu_slice[ctu]

            comp_distortion = [0.0, 0.0, 0.0]
            self._load(self.curr_best)
            if allow_l:
                self.w.code_sao_merge(0)
            if allow_u:
                self.w.code_sao_merge(0)
            self.temp_best = self._snap()

            self.count[:] = 0
            self.offset_org[:] = 0
            for comp in range(3):
                u = self.units[comp][ctu]
                u.type_idx = -1
                u.merge_up = 0
                u.merge_left = 0
                u.sub_type = 0
                if (comp == 0 and self.bsao[0]) or (comp > 0 and self.bsao[1]):
                    self._calc_stats_cu(ctu, comp, rec[comp], org[comp])

            merge_units = [[SaoUnit(), SaoUnit()] for _ in range(3)]
            self._component_param_dist(allow_l, allow_u, ctu, 0,
                                       self.lambda_luma, merge_units[0],
                                       comp_distortion)
            self._chroma2_param_dist(allow_l, allow_u, ctu,
                                     self.lambda_chroma, merge_units[1],
                                     merge_units[2], comp_distortion)

            if self.bsao[0] or self.bsao[1]:
                # cost of new params
                self._load(self.curr_best)
                self.go.reset_bits()
                if allow_l:
                    self.w.code_sao_merge(0)
                if allow_u:
                    self.w.code_sao_merge(0)
                for comp in range(3):
                    if (comp == 0 and self.bsao[0]) or \
                            (comp > 0 and self.bsao[1]):
                        self._code_unit(self.units[comp][ctu], comp)
                rate = self.go.num_written_bits
                best_cost = comp_distortion[0] + float(rate)
                self.temp_best = self._snap()

                # cost of merge
                for merge_up in range(2):
                    if not ((allow_l and merge_up == 0) or
                            (allow_u and merge_up == 1)):
                        continue
                    self._load(self.curr_best)
                    self.go.reset_bits()
                    if allow_l:
                        self.w.code_sao_merge(1 - merge_up)
                    if allow_u and merge_up == 1:
                        self.w.code_sao_merge(1)
                    rate = self.go.num_written_bits
                    merge_cost = comp_distortion[merge_up + 1] + float(rate)
                    if merge_cost < best_cost:
                        best_cost = merge_cost
                        self.temp_best = self._snap()
                        for comp in range(3):
                            merge_units[comp][merge_up].merge_left = \
                                1 - merge_up
                            merge_units[comp][merge_up].merge_up = merge_up
                            if (comp == 0 and self.bsao[0]) or \
                                    (comp > 0 and self.bsao[1]):
                                self.units[comp][ctu].copy_from(
                                    merge_units[comp][merge_up])

                if self.units[0][ctu].type_idx == -1:
                    num_no_sao[0] += 1
                if self.units[1][ctu].type_idx == -1:
                    num_no_sao[1] += 2
                self._load(self.temp_best)
                self.curr_best = self._snap()

        n = float(f.num_ctus)
        self.depth_sao_rate[0][depth] = num_no_sao[0] / n
        self.depth_sao_rate[1][depth] = num_no_sao[1] / (n * 2)

    # ==================================================================
    # picture-based (quadtree) RDO — SAOLcuBasedOptimization=0
    # (TEncSampleAdaptiveOffset.cpp: SAOProcess :1280-1296 QT branch,
    #  rdoSaoOnePart :112, runQuadTreeDecision :282, disablePartTree :262,
    #  getSaoStats :1127, assignSaoUnitSyntax :1403, checkMerge :1343;
    #  TComSampleAdaptiveOffset.cpp: initSAOParam :305, convertQT2SaoUnit
    #  :1267, convertOnePart2SaoUnit :1293.  Under SAO_TYPE_SHARING the
    #  quadtree mode runs luma only — chroma SAO is disabled entirely.)
    # ==================================================================

    def _build_part_tree(self):
        """initSAOParam: quadtree over the CTU grid, breadth-first part
        indices with level offsets _QT_CUM_PARTS; max split level =
        min(floor(log2(ctus_h)), floor(log2(ctus_w)), SAO_MAX_DEPTH=4)."""
        f = self.f
        max_lvl = min(f.ctus_h.bit_length() - 1, f.ctus_w.bit_length() - 1, 4)
        parts = [None] * _QT_CUM_PARTS[max_lvl]

        def init(level, row, col, parent, scx, ecx, scy, ecy):
            idx = ((_QT_CUM_PARTS[level - 1] if level else 0)
                   + row * (1 << level) + col)
            p = _QtPart(idx, level, scx, ecx, scy, ecy, parent)
            parts[idx] = p
            if level != max_lvl:
                nl = (ecx - scx + 1) >> 1
                nt = (ecy - scy + 1) >> 1
                subs = ((scx, scx + nl - 1, scy, scy + nt - 1, 0, 0),
                        (scx + nl, ecx, scy, scy + nt - 1, 0, 1),
                        (scx, scx + nl - 1, scy + nt, ecy, 1, 0),
                        (scx + nl, ecx, scy + nt, ecy, 1, 1))
                for i, (sx, ex, sy, ey, dr, dc) in enumerate(subs):
                    p.down[i] = init(level + 1, (row << 1) + dr,
                                     (col << 1) + dc, idx, sx, ex, sy, ey)
            return idx

        init(0, 0, 0, -1, 0, f.ctus_w - 1, 0, f.ctus_h - 1)
        return parts, max_lvl

    def _qt_get_stats(self, parts, max_lvl, rec_y):
        """getSaoStats: per-LCU stats accumulated into leaf parts, then
        summed bottom-up into every ancestor level."""
        f = self.f
        n = len(parts)
        cnt_p = np.zeros((n, N_TYPES, N_CLASSES), np.int64)
        org_p = np.zeros((n, N_TYPES, N_CLASSES), np.int64)
        leaf_start = _QT_CUM_PARTS[max_lvl - 1] if max_lvl else 0
        for pi in range(leaf_start, len(parts)):
            p = parts[pi]
            for ly in range(p.scy, p.ecy + 1):
                for lx in range(p.scx, p.ecx + 1):
                    self._calc_stats_cu(ly * f.ctus_w + lx, 0, rec_y,
                                        self.org_y, lcu_skip=False)
                    cnt_p[pi] += self.count[0]
                    org_p[pi] += self.offset_org[0]
        for lvl in range(max_lvl - 1, -1, -1):
            start = _QT_CUM_PARTS[lvl - 1] if lvl else 0
            for pi in range(start, _QT_CUM_PARTS[lvl]):
                for ci in parts[pi].down:
                    cnt_p[pi] += cnt_p[ci]
                    org_p[pi] += org_p[ci]
        return cnt_p, org_p

    def _qt_rdo_one_part(self, parts, pi, lam, snaps):
        """rdoSaoOnePart: best type (incl. off) for one part.  Context
        snapshots index (depth, 0=CI_CURR_BEST / 1=CI_NEXT_BEST /
        2=CI_TEMP_BEST), mirroring the shared RD-snapshot grid."""
        p = parts[pi]
        d = p.level
        dist_bo = [0] * (N_CLASSES - 1)
        cost_bo = [0.0] * (N_CLASSES - 1)
        best_rd_bo = MAX_DOUBLE
        best_class_bo = 0
        dist_org = 0
        cost_part_best = MAX_DOUBLE
        type_part_best = -1
        dist_t = [0] * N_TYPES
        rate_t = [0] * N_TYPES
        # encodeSaoOffset(&rdo, iPartIdx) passes the PART index where a
        # component index is expected — part 2 therefore rates like Cr
        # (no type bits).  Reference quirk, kept for exactness.
        comp_quirk = 2 if pi == 2 else 0
        e = self.w.e
        for type_idx in range(-1, N_TYPES):
            self._load(snaps[(d, 0)])
            self.go.reset_bits()
            # codeSaoTypeIdx(typeIdx+1)
            if type_idx < 0:
                e.encode_bin(0, cc.O_SAO_TYPE)
            else:
                e.encode_bin(1, cc.O_SAO_TYPE)
                e.encode_bin_ep(1 if type_idx + 1 <= 4 else 0)
            if type_idx >= 0:
                est_dist = self._est_sao_type_dist(pi, type_idx, lam,
                                                   dist_bo, cost_bo)
                if type_idx == 4:
                    for i in range(BO_CLASSES - BO_LEN + 1):
                        cur = _fsum4(cost_bo, i)
                        if cur < best_rd_bo:
                            best_rd_bo = cur
                            best_class_bo = i
                    est_dist = sum(
                        dist_bo[best_class_bo:best_class_bo + BO_LEN])
                u = SaoUnit()
                u.type_idx = type_idx
                u.sub_type = best_class_bo if type_idx == 4 else 0
                u.length = 4
                u.offsets = [
                    int(self.offset[pi][type_idx]
                        [ci + u.sub_type + 1]) for ci in range(4)]
                self._load(snaps[(d, 0)])
                self.go.reset_bits()
                self._code_unit(u, comp_quirk)
                dist_t[type_idx] = est_dist
                rate_t[type_idx] = self.go.num_written_bits
                cost = float(est_dist) + lam * float(rate_t[type_idx])
                if cost < cost_part_best:
                    dist_org = 0
                    cost_part_best = cost
                    type_part_best = type_idx
                    snaps[(d, 2)] = self._snap()
            else:
                if dist_org < cost_part_best:
                    cost_part_best = float(dist_org) + \
                        self.go.num_written_bits * lam
                    type_part_best = -1
                    snaps[(d, 2)] = self._snap()
        p.processed = True
        p.split = False
        p.min_dist = dist_t[type_part_best] if type_part_best >= 0 \
            else dist_org
        p.min_rate = rate_t[type_part_best] if type_part_best >= 0 else 0
        p.min_cost = p.min_dist + lam * p.min_rate
        p.best_type = type_part_best
        if p.best_type != -1:
            p.length = 4
            min_index = 0
            if p.best_type == 4:
                p.sub_type = best_class_bo
                min_index = best_class_bo
            p.offsets = [int(self.offset[pi][p.best_type][min_index + i + 1])
                         for i in range(4)]
        else:
            p.length = 0

    def _qt_disable_tree(self, parts, pi, max_lvl):
        p = parts[pi]
        p.split = False
        p.length = 0
        p.best_type = -1
        if p.level < max_lvl:
            for c in p.down:
                self._qt_disable_tree(parts, c, max_lvl)

    def _qt_run_decision(self, parts, pi, max_lvl, lam, snaps):
        """runQuadTreeDecision: bottom-up split-vs-merge RD, returning the
        subtree cost (dCostFinal)."""
        p = parts[pi]
        d = p.level
        if not p.processed:
            self._qt_rdo_one_part(parts, pi, lam, snaps)
        if d < max_lvl:
            cost_not_split = lam + p.min_cost
            cost_split = lam
            for i in range(4):
                snaps[(d + 1, 0)] = snaps[(d, 0)] if i == 0 \
                    else snaps[(d + 1, 1)]
                cost_split += self._qt_run_decision(parts, p.down[i],
                                                    max_lvl, lam, snaps)
                snaps[(d + 1, 1)] = snaps[(d + 1, 2)]
            if cost_split < cost_not_split:
                p.split = True
                p.length = 0
                p.best_type = -1
                snaps[(d, 1)] = snaps[(d + 1, 1)]
                return cost_split
            p.split = False
            for c in p.down:
                self._qt_disable_tree(parts, c, max_lvl)
            snaps[(d, 1)] = snaps[(d, 2)]
            return cost_not_split
        return p.min_cost

    def _qt_convert(self, parts, pi, max_lvl, lcu):
        """convertQT2SaoUnit + convertOnePart2SaoUnit."""
        f = self.f
        p = parts[pi]
        if not p.split:
            for y in range(p.scy, p.ecy + 1):
                for x in range(p.scx, p.ecx + 1):
                    u = lcu[y * f.ctus_w + x]
                    u.part_tmp = pi
                    u.type_idx = p.best_type
                    u.sub_type = p.sub_type
                    if p.best_type != -1:
                        u.length = p.length
                        u.offsets = list(p.offsets)
                    else:
                        u.length = 0
                        u.offsets = [0, 0, 0, 0]
            return
        if p.level < max_lvl:
            for c in p.down:
                self._qt_convert(parts, c, max_lvl, lcu)

    @staticmethod
    def _qt_check_merge(cur, chk, direction):
        """checkMerge: fold identical-parameter neighbors across part
        boundaries into merges."""
        if cur.part_idx == chk.part_idx:
            return
        if cur.type_idx != -1:
            if cur.type_idx == chk.type_idx:
                diff = sum(cur.offsets[i] != chk.offsets[i]
                           for i in range(cur.length))
                diff += cur.sub_type != chk.sub_type
                if diff == 0:
                    cur.part_idx = chk.part_idx
                    cur.merge_up, cur.merge_left = \
                        (1, 0) if direction == 1 else (0, 1)
        elif cur.type_idx == chk.type_idx:
            cur.part_idx = chk.part_idx
            cur.merge_up, cur.merge_left = \
                (1, 0) if direction == 1 else (0, 1)

    def _rdo_quadtree(self, rec_y):
        """SAOProcess, picture-based branch: luma quadtree decision, then
        QT→LCU conversion and merge-syntax assignment into frame arrays."""
        f = self.f
        self.bsao = [True, False]
        parts, max_lvl = self._build_part_tree()
        cnt_p, org_p = self._qt_get_stats(parts, max_lvl, rec_y)
        saved = (self.count, self.offset_org, self.offset)
        self.count, self.offset_org = cnt_p, org_p
        self.offset = np.zeros_like(cnt_p)
        snaps = {(0, 0): self.curr_best, (0, 1): self.curr_best}
        cost_final = self._qt_run_decision(parts, 0, max_lvl,
                                           self.lambda_luma, snaps)
        self.count, self.offset_org, self.offset = saved
        self.bsao[0] = cost_final < 0

        f.sao_type[:] = -1
        f.sao_sub_type[:] = 0
        f.sao_offsets[:] = 0
        f.sao_merge_left[:] = False
        f.sao_merge_up[:] = False
        if not self.bsao[0]:
            return

        lcu = [_QtLcuUnit() for _ in range(f.num_ctus)]
        self._qt_convert(parts, 0, max_lvl, lcu)
        if parts[0].split:
            # assignSaoUnitSyntax, split case: compact part ids + merges
            idx_count = -1
            lcu[0].merge_up = 0
            lcu[0].merge_left = 0
            for j in range(f.ctus_h):
                for i in range(f.ctus_w):
                    addr = i + j * f.ctus_w
                    addr_left = -1 if addr % f.ctus_w == 0 else addr - 1
                    addr_up = -1 if addr < f.ctus_w else addr - f.ctus_w
                    idx = lcu[addr].part_tmp
                    idx_left = -1 if addr_left == -1 \
                        else lcu[addr_left].part_tmp
                    idx_up = -1 if addr_up == -1 else lcu[addr_up].part_tmp
                    if idx != idx_left and idx != idx_up:
                        lcu[addr].merge_up = 0
                        idx_count += 1
                        lcu[addr].merge_left = 0
                        lcu[addr].part_idx = idx_count
                    elif idx == idx_left:
                        lcu[addr].merge_up = 1
                        lcu[addr].merge_left = 1
                        lcu[addr].part_idx = lcu[addr_left].part_idx
                    elif idx == idx_up:
                        lcu[addr].merge_up = 1
                        lcu[addr].merge_left = 0
                        lcu[addr].part_idx = lcu[addr_up].part_idx
                    if addr_up != -1:
                        self._qt_check_merge(lcu[addr], lcu[addr_up], 1)
                    if addr_left != -1:
                        self._qt_check_merge(lcu[addr], lcu[addr_left], 0)

        for addr in range(f.num_ctus):
            u = lcu[addr]
            t = u.type_idx
            f.sao_type[0, addr] = t
            # final-pass encodeSaoOffset overwrites subTypeIdx with the EO
            # class for luma (TEncEntropy.cpp:787); mirror it here so both
            # the writer and the SAO apply read the same value
            f.sao_sub_type[0, addr] = u.sub_type if t == 4 \
                else (t if t >= 0 else 0)
            f.sao_offsets[0, addr] = u.offsets
            f.sao_merge_left[0, addr] = bool(u.merge_left)
            f.sao_merge_up[0, addr] = bool(u.merge_up)

    # ==================================================================
    # encodeSlice-side writer (TEncSlice.cpp:1241-1332)
    # ==================================================================
    def make_writer(self):
        f = self.f
        bsao = self.bsao

        def sao_write(w: SbacWriter, ctu: int, cu_in_slice: int = None,
                      tile_ok_l: bool = True, tile_ok_u: bool = True) -> None:
            """Final-pass SAO syntax for one CTU (TEncSlice.cpp:1241-1332).
            cu_in_slice is the raster distance from the slice start;
            tile_ok_* gate merges across tile boundaries."""
            rx, ry = ctu % f.ctus_w, ctu // f.ctus_w
            if cu_in_slice is None:
                cu_in_slice = ctu
            cu_up_in_slice = cu_in_slice - f.ctus_w
            allow_l = tile_ok_l and rx > 0 and cu_in_slice != 0
            allow_u = tile_ok_u and ry > 0 and cu_up_in_slice >= 0
            if not bsao[0]:
                return   # per-CTU SAO writes gated on the LUMA flag only
            merge_left = int(f.sao_merge_left[0, ctu]) if allow_l else 0
            if allow_l:
                w.code_sao_merge(merge_left)
            if merge_left == 0:
                merge_up = int(f.sao_merge_up[0, ctu]) if allow_u else 0
                if allow_u:
                    w.code_sao_merge(merge_up)
                if merge_up == 0:
                    for comp in range(3):
                        if (comp == 0 and bsao[0]) or (comp > 0 and bsao[1]):
                            w.code_sao_offset(
                                comp, int(f.sao_type[comp, ctu]),
                                int(f.sao_sub_type[comp, ctu]),
                                [int(v) for v in f.sao_offsets[comp, ctu]],
                                self.sps.internal_bit_depth)

        return sao_write
