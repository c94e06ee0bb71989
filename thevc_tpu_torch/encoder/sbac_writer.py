"""CU syntax writing (CABAC binarization + context selection), engine-agnostic.

Behavioral reference: TEncSbac.cpp (codeSplitFlag, codePartSize,
codeIntraDirLumaAng :673, codeIntraDirChroma, codeQtCbf, codeCoeffNxN :1195,
codeLastSignificantXY :1136, xWriteCoefRemainExGolomb :420, SAO :1562+,
estBit :1723+) and TEncEntropy.cpp / TEncCu::xEncodeCU (syntax ordering).

The same writer runs against two engines: cabac.engine.BinEncoder (real
arithmetic coding, final pass) and cabac.bitcount.CounterEncoder
(fractional-bit RD estimation) — HM's FAST_BIT_EST two-pass structure.
"""

from __future__ import annotations

import numpy as np

from ..cabac import contexts as cc
from ..common import rom
from ..decoder.frame import (DM_CHROMA_IDX, MODE_INTRA, SIZE_2Nx2N,
                             SIZE_2NxN, SIZE_2NxnD, SIZE_2NxnU, SIZE_NxN,
                             SIZE_Nx2N, SIZE_nLx2N, SIZE_nRx2N, FrameModel)
from ..params import I_SLICE, Pps, SliceHeader, Sps

TREEDBG = None

# Optional encoder-side syntax trace (the ENC_DEC_TRACE counterpart of
# decoder/cu_parser.TRACE, TComRom.h:195-226): set sbac_writer.TRACE to a
# writable file and run with THEVC_NATIVE=0 — the symbol lines use the
# same formats as the decoder's, so encode/decode traces of the same
# stream diff clean and the first divergent syntax element localizes an
# encoder bug without a decode step.
TRACE = None


def _trace(msg: str) -> None:
    if TRACE is not None:
        TRACE.write(msg + "\n")


def _tracing(engine) -> bool:
    """Trace only the final arithmetic pass, not the RD counter passes
    (HM's trace is likewise gated to the real bitstream coder)."""
    return TRACE is not None and not hasattr(engine, "frac_bits")


SBH_THRESHOLD = 4
C1FLAG_NUMBER = 8
COEF_REMAIN_BIN_REDUCTION = 3
CU_DQP_TU_CMAX = 5
CU_DQP_EG_K = 0


class SbacWriter:
    """Writes CU-level syntax for a CTU region from FrameModel state."""

    def __init__(self, frame: FrameModel, sh: SliceHeader, sps: Sps, pps: Pps,
                 engine):
        self.f = frame
        self.sh = sh
        self.sps = sps
        self.pps = pps
        self.e = engine
        self.ctu_addr = 0
        self.dqp_flag = False
        self.coded_qp = sh.slice_qp
        self.bak_abs_part_cu = 0
        self.bak_chroma_part = 0

    # -- addressing helpers (mirror cu_parser) ------------------------------
    def _unit_xy(self, abs_part: int):
        r = int(self.f.z2r[abs_part])
        upr = self.f.units_per_row
        cx = self.ctu_addr % self.f.ctus_w
        cy = self.ctu_addr // self.f.ctus_w
        return cx * upr + (r % upr), cy * upr + (r // upr)

    def _pel_xy(self, abs_part: int):
        ux, uy = self._unit_xy(abs_part)
        return ux * 4, uy * 4

    def _units_at_depth(self, depth: int) -> int:
        return self.f.units_per_row >> depth

    def _log2_ctu(self) -> int:
        return rom.convert_to_bit(self.f.ctu_size) + 2

    # -- primitives ---------------------------------------------------------
    def _write_unary_max(self, value: int, ctx0: int, ctx1: int, max_symbol: int):
        """xWriteUnaryMaxSymbol."""
        if max_symbol == 0:
            return
        self.e.encode_bin(1 if value else 0, ctx0)
        if value == 0:
            return
        b_code_last = max_symbol > value
        for _ in range(value - 1):
            self.e.encode_bin(1, ctx1)
        if b_code_last:
            self.e.encode_bin(0, ctx1)

    def _write_ep_exgolomb(self, value: int, count: int) -> None:
        """xWriteEpExGolomb."""
        bins = 0
        num = 0
        while value >= (1 << count):
            bins = 2 * bins + 1
            num += 1
            value -= 1 << count
            count += 1
        bins = 2 * bins  # stop bit 0
        num += 1
        bins = (bins << count) | value
        num += count
        self.e.encode_bins_ep(bins, num)

    def _write_coef_remain_exgolomb(self, symbol: int, rparam: int) -> None:
        code_number = symbol
        if code_number < (COEF_REMAIN_BIN_REDUCTION << rparam):
            length = code_number >> rparam
            self.e.encode_bins_ep((1 << (length + 1)) - 2, length + 1)
            self.e.encode_bins_ep(code_number % (1 << rparam), rparam)
        else:
            length = rparam
            code_number -= COEF_REMAIN_BIN_REDUCTION << rparam
            while code_number >= (1 << length):
                code_number -= 1 << length
                length += 1
            self.e.encode_bins_ep(
                (1 << (COEF_REMAIN_BIN_REDUCTION + length + 1 - rparam)) - 2,
                COEF_REMAIN_BIN_REDUCTION + length + 1 - rparam)
            self.e.encode_bins_ep(code_number, length)

    # -- CU-level elements --------------------------------------------------
    def code_split_flag(self, abs_part: int, depth: int) -> None:
        f = self.f
        max_sig = f.max_depth - self.sps.add_cu_depth
        if depth == max_sig:
            return
        ux, uy = self._unit_xy(abs_part)
        ctx = f.ctx_split_flag(ux, uy, depth)
        split = 1 if f.depth[uy, ux] > depth else 0
        self.e.encode_bin(split, cc.O_SPLIT_FLAG + ctx)

    def code_part_size(self, abs_part: int, depth: int) -> None:
        """codePartSize (TEncSbac.cpp), intra + inter incl. AMP."""
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        part_sz = int(f.part_size_arr[uy, ux])
        max_sig = f.max_depth - self.sps.add_cu_depth
        if f.pred_mode[uy, ux] == MODE_INTRA:
            if depth == max_sig:
                self.e.encode_bin(1 if part_sz == SIZE_2Nx2N else 0,
                                  cc.O_PART_SIZE)
            return
        e = self.e
        amp = self.sps.use_amp and depth < max_sig
        if part_sz == SIZE_2Nx2N:
            e.encode_bin(1, cc.O_PART_SIZE)
        elif part_sz in (SIZE_2NxN, SIZE_2NxnU, SIZE_2NxnD):
            e.encode_bin(0, cc.O_PART_SIZE)
            e.encode_bin(1, cc.O_PART_SIZE + 1)
            if amp:
                if part_sz == SIZE_2NxN:
                    e.encode_bin(1, cc.O_AMP)
                else:
                    e.encode_bin(0, cc.O_AMP)
                    e.encode_bin_ep(0 if part_sz == SIZE_2NxnU else 1)
        elif part_sz in (SIZE_Nx2N, SIZE_nLx2N, SIZE_nRx2N):
            e.encode_bin(0, cc.O_PART_SIZE)
            e.encode_bin(0, cc.O_PART_SIZE + 1)
            size = f.ctu_size >> depth
            if depth == max_sig and not size == 8:
                e.encode_bin(1, cc.O_PART_SIZE + 2)
            if amp:
                if part_sz == SIZE_Nx2N:
                    e.encode_bin(1, cc.O_AMP)
                else:
                    e.encode_bin(0, cc.O_AMP)
                    e.encode_bin_ep(0 if part_sz == SIZE_nLx2N else 1)
        else:  # SIZE_NxN inter (only at max depth, size > 8)
            e.encode_bin(0, cc.O_PART_SIZE)
            e.encode_bin(0, cc.O_PART_SIZE + 1)
            e.encode_bin(0, cc.O_PART_SIZE + 2)

    # -- inter PU syntax (codeMergeFlag/Index, codeInterDir, codeRefFrmIdx,
    #    codeMvd, codeMVPIdx in TEncSbac.cpp) --------------------------------
    def code_merge_flag(self, abs_part: int) -> None:
        ux, uy = self._unit_xy(abs_part)
        self.e.encode_bin(1 if self.f.merge_flag[uy, ux] else 0,
                          cc.O_MERGE_FLAG)

    def code_merge_index(self, abs_part: int) -> None:
        ux, uy = self._unit_xy(abs_part)
        idx = int(self.f.merge_idx[uy, ux])
        num_cand = self.sh.max_num_merge_cand
        if num_cand > 1:
            for ui in range(num_cand - 1):
                sym = 0 if ui == idx else 1
                if ui == 0:
                    self.e.encode_bin(sym, cc.O_MERGE_IDX)
                else:
                    self.e.encode_bin_ep(sym)
                if sym == 0:
                    break

    def code_inter_dir(self, abs_part: int, depth: int) -> None:
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        inter_dir = int(f.inter_dir[uy, ux]) - 1
        size = f.ctu_size >> depth   # CU height (getCtxInterDir = CU depth)
        part_sz = int(f.part_size_arr[uy, ux])
        if part_sz == SIZE_2Nx2N or size != 8:
            self.e.encode_bin(1 if inter_dir == 2 else 0,
                              cc.O_INTER_DIR + depth)
        if inter_dir < 2:
            self.e.encode_bin(inter_dir, cc.O_INTER_DIR + 4)

    def code_ref_idx(self, abs_part: int, lst: int) -> None:
        ux, uy = self._unit_xy(abs_part)
        ref = int(self.f.ref_idx[lst, uy, ux])
        self.e.encode_bin(0 if ref == 0 else 1, cc.O_REF_PIC)
        if ref > 0:
            ref_num = self.sh.num_ref_idx[lst] - 2
            ref -= 1
            for ui in range(ref_num):
                sym = 0 if ui == ref else 1
                if ui == 0:
                    self.e.encode_bin(sym, cc.O_REF_PIC + 1)
                else:
                    self.e.encode_bin_ep(sym)
                if sym == 0:
                    break

    def code_mvd(self, abs_part: int, lst: int) -> None:
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        if self.sh.mvd_l1_zero_flag and lst == 1 and \
                int(f.inter_dir[uy, ux]) == 3:
            return
        hor = int(f.mvd[lst, uy, ux, 0])
        ver = int(f.mvd[lst, uy, ux, 1])
        e = self.e
        e.encode_bin(1 if hor != 0 else 0, cc.O_MVD)
        e.encode_bin(1 if ver != 0 else 0, cc.O_MVD)
        ah, av = abs(hor), abs(ver)
        if hor != 0:
            e.encode_bin(1 if ah > 1 else 0, cc.O_MVD + 1)
        if ver != 0:
            e.encode_bin(1 if av > 1 else 0, cc.O_MVD + 1)
        if hor != 0:
            if ah > 1:
                self._write_ep_exgolomb(ah - 2, 1)
            e.encode_bin_ep(1 if hor < 0 else 0)
        if ver != 0:
            if av > 1:
                self._write_ep_exgolomb(av - 2, 1)
            e.encode_bin_ep(1 if ver < 0 else 0)

    def code_mvp_idx(self, abs_part: int, lst: int) -> None:
        ux, uy = self._unit_xy(abs_part)
        idx = int(self.f.mvp_idx[lst, uy, ux])
        self._write_unary_max(idx, cc.O_MVP_IDX, cc.O_MVP_IDX + 1, 1)

    def code_qt_root_cbf(self, cbf: int) -> None:
        self.e.encode_bin(1 if cbf else 0, cc.O_QT_ROOT_CBF)

    def code_qt_root_cbf_zero(self) -> None:
        self.e.encode_bin(0, cc.O_QT_ROOT_CBF)

    def code_qt_cbf_zero(self, comp: int, ctx_tr_depth: int) -> None:
        """codeQtCbfZero: hypothetical cbf=0 bit (ctx = getCtxQtCbf)."""
        ctx = 1 if comp == 0 and ctx_tr_depth == 0 else \
            (0 if comp == 0 else ctx_tr_depth)
        off = cc.O_QT_CBF if comp == 0 else cc.O_QT_CBF + 5
        self.e.encode_bin(0, off + ctx)

    def code_pred_mode(self, abs_part: int) -> None:
        if self.sh.slice_type == I_SLICE:
            return
        ux, uy = self._unit_xy(abs_part)
        self.e.encode_bin(1 if self.f.pred_mode[uy, ux] == MODE_INTRA else 0,
                          cc.O_PRED_MODE)

    def code_tq_bypass(self, abs_part: int) -> None:
        ux, uy = self._unit_xy(abs_part)
        self.e.encode_bin(1 if self.f.tq_bypass[uy, ux] else 0, cc.O_TQ_BYPASS)

    def code_skip_flag(self, abs_part: int) -> None:
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        ctx = f.ctx_skip_flag(ux, uy)
        self.e.encode_bin(1 if f.skip[uy, ux] else 0, cc.O_SKIP_FLAG + ctx)

    def code_intra_dir_luma(self, abs_part: int, multiple: bool) -> None:
        """codeIntraDirLumaAng (TEncSbac.cpp:673)."""
        f = self.f
        ux0, uy0 = self._unit_xy(abs_part)
        mode_sz = int(f.part_size_arr[uy0, ux0])
        depth = int(f.depth[uy0, ux0])
        part_num = 4 if (multiple and mode_sz == SIZE_NxN) else 1
        part_offset = (f.parts_per_ctu >> (depth << 1)) >> 2
        dirs, preds, pred_idx = [], [], []
        for j in range(part_num):
            part = abs_part + part_offset * j
            ux, uy = self._unit_xy(part)
            d = int(f.luma_dir[uy, ux])
            p = f.intra_mpm(ux, uy)
            idx = -1
            for i, pm in enumerate(p):
                if d == pm:
                    idx = i
            dirs.append(d)
            preds.append(p)
            pred_idx.append(idx)
            self.e.encode_bin(1 if idx != -1 else 0, cc.O_INTRA_PRED)
        for j in range(part_num):
            if pred_idx[j] != -1:
                self.e.encode_bin_ep(1 if pred_idx[j] else 0)
                if pred_idx[j]:
                    self.e.encode_bin_ep(pred_idx[j] - 1)
            else:
                p = sorted(preds[j])
                d = dirs[j]
                for i in range(len(p) - 1, -1, -1):
                    if d > p[i]:
                        d -= 1
                self.e.encode_bins_ep(d, 5)

    def code_intra_dir_chroma(self, abs_part: int) -> None:
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        mode = int(f.chroma_dir[uy, ux])
        if mode == DM_CHROMA_IDX:
            self.e.encode_bin(0, cc.O_CHROMA_PRED)
        else:
            allowed = f.allowed_chroma_dirs(ux, uy)
            idx = allowed.index(mode)
            self.e.encode_bin(1, cc.O_CHROMA_PRED)
            self.e.encode_bins_ep(idx, 2)

    def code_delta_qp(self, abs_part: int) -> None:
        """codeDeltaQP with CU_DQP_TU_EG binarization."""
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        qp = int(f.qp[uy, ux])
        ref_qp = self._ref_qp(abs_part)
        dqp = qp - ref_qp
        dqp = (dqp + 78 + self.sps.qp_bd_offset_y + (self.sps.qp_bd_offset_y // 2)) \
            % (52 + self.sps.qp_bd_offset_y) - 26 - (self.sps.qp_bd_offset_y // 2)
        abs_dqp = min(abs(dqp), CU_DQP_TU_CMAX)
        self._write_unary_max(abs_dqp, cc.O_DQP, cc.O_DQP + 1, CU_DQP_TU_CMAX)
        if abs(dqp) >= CU_DQP_TU_CMAX:
            self._write_ep_exgolomb(abs(dqp) - CU_DQP_TU_CMAX, CU_DQP_EG_K)
        if abs(dqp) > 0:
            self.e.encode_bin_ep(1 if dqp < 0 else 0)
        self.coded_qp = qp

    def _last_coded_qp(self, abs_part: int) -> int:
        """getLastCodedQP (TComDataCU.cpp:1846): previous valid part's QP
        within the CTU, else the predecessor CTU's (same tile, not a WPP
        row start), else the slice QP — all from the frame arrays."""
        f = self.f
        sh = self.sh
        parts = f.parts_per_ctu
        mask = ~((1 << ((f.max_depth - self.pps.max_cu_dqp_depth) << 1)) - 1)
        last = (abs_part & mask) - 1
        # getLastValidPartIdx: walk back over MODE_NONE parts
        cx = (self.ctu_addr % f.ctus_w) * f.units_per_row
        cy = (self.ctu_addr // f.ctus_w) * f.units_per_row
        while last >= 0:
            r = int(f.z2r[last])
            lux = cx + r % f.units_per_row
            luy = cy + r // f.units_per_row
            if f.pred_mode[luy, lux] != 15:   # MODE_NONE
                break
            d = int(f.depth[luy, lux])
            last -= parts >> (d << 1)
        scu_base = int(f.ctu_inv_order[self.ctu_addr]) * parts
        start = max(getattr(sh, "slice_cur_start_cu_addr", 0),
                    getattr(sh, "dependent_slice_start_cu_addr", 0))
        if scu_base + last < start:
            return sh.slice_qp
        if last >= 0:
            r = int(f.z2r[last])
            return int(f.qp[cy + r // f.units_per_row,
                            cx + r % f.units_per_row])
        enc_order = int(f.ctu_inv_order[self.ctu_addr])
        if enc_order > 0:
            prev = int(f.ctu_order[enc_order - 1])
            same_tile = (f.tiles is None or
                         int(f.tiles.tile_idx_map[prev]) ==
                         int(f.tiles.tile_idx_map[self.ctu_addr]))
            wpp_row_start = (self.pps.tiles_or_entropy_coding_sync_idc == 2
                             and self.ctu_addr % f.ctus_w == 0)
            if same_tile and not wpp_row_start:
                # previous CTU's last valid part
                pcx = (prev % f.ctus_w) * f.units_per_row
                pcy = (prev // f.ctus_w) * f.units_per_row
                pl = parts - 1
                while pl >= 0:
                    r = int(f.z2r[pl])
                    lux = pcx + r % f.units_per_row
                    luy = pcy + r // f.units_per_row
                    if f.pred_mode[luy, lux] != 15:
                        return int(f.qp[luy, lux])
                    d = int(f.depth[luy, lux])
                    pl -= parts >> (d << 1)
                return sh.slice_qp
        return sh.slice_qp

    def _ref_qp(self, abs_part: int) -> int:
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        upr = f.units_per_row
        left = f.left_unit(ux, uy)
        above = f.above_unit(ux, uy)
        lqp = aqp = None
        if left is not None and left[0] // upr == ux // upr and left[1] // upr == uy // upr:
            lqp = int(f.qp[left[1], left[0]])
        if above is not None and above[0] // upr == ux // upr and above[1] // upr == uy // upr:
            aqp = int(f.qp[above[1], above[0]])
        last = self._last_coded_qp(abs_part)
        l = lqp if lqp is not None else last
        a = aqp if aqp is not None else last
        return (l + a + 1) >> 1

    def code_transform_subdiv(self, subdiv: int, log2_tr: int) -> None:
        if TREEDBG:
            TREEDBG.write("T subdiv v=%d c=%d\n" % (subdiv, 5 - log2_tr))
        self.e.encode_bin(subdiv, cc.O_TRANS_SUBDIV + (5 - log2_tr))

    def code_qt_cbf(self, abs_part: int, comp: int, tr_depth: int) -> None:
        if TREEDBG:
            _ux, _uy = self._unit_xy(abs_part)
            _v = (int(self.f.cbf[comp, _uy, _ux]) >> tr_depth) & 1
            TREEDBG.write("T cbf part=%d t=%d d=%d v=%d\n" % (
                abs_part, comp if comp == 0 else comp + 1, tr_depth, _v))
        ux, uy = self._unit_xy(abs_part)
        cbf = (int(self.f.cbf[comp, uy, ux]) >> tr_depth) & 1
        if comp == 0:
            ctx = 1 if tr_depth == 0 else 0
            self.e.encode_bin(cbf, cc.O_QT_CBF + ctx)
        else:
            self.e.encode_bin(cbf, cc.O_QT_CBF + 5 + tr_depth)

    def code_ts_flag(self, abs_part: int, width: int, comp: int) -> None:
        ux, uy = self._unit_xy(abs_part)
        if self.f.tq_bypass[uy, ux] or width != 4:
            return
        flag = 1 if self.f.ts_flag[comp, uy, ux] else 0
        self.e.encode_bin(flag, cc.O_TS_FLAG + (0 if comp == 0 else 1))

    def code_terminating_bit(self, is_last: int) -> None:
        self.e.encode_bin_trm(is_last)

    def code_pcm_samples(self, abs_part: int, depth: int) -> None:
        """Raw PCM sample writes (TEncSbac::codeIPCMInfo sample loops).

        Samples are read from the frame's PCM stores (filled by the mode
        decision as org >> (internal - pcm depth))."""
        f, sps = self.f, self.sps
        px, py = self._pel_xy(abs_part)
        size = f.ctu_size >> depth
        sb_l = sps.pcm_bit_depth_luma
        sb_c = sps.pcm_bit_depth_chroma
        for y in range(py, py + size):
            for x in range(px, px + size):
                self.e.write_pcm_code(int(f.pcm_y[y, x]), sb_l)
        for plane in (f.pcm_cb, f.pcm_cr):
            for y in range(py // 2, (py + size) // 2):
                for x in range(px // 2, (px + size) // 2):
                    self.e.write_pcm_code(int(plane[y, x]), sb_c)

    # ------------------------------------------------------------------
    # coefficient coding (codeCoeffNxN)
    # ------------------------------------------------------------------
    def _scan_idx(self, abs_part: int, width: int, is_luma: bool) -> int:
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        if f.pred_mode[uy, ux] != MODE_INTRA:
            return rom.SCAN_DIAG
        ctx_idx = {2: 6, 4: 5, 8: 4, 16: 3, 32: 2, 64: 1}.get(width, 0)
        if is_luma:
            dir_mode = int(f.luma_dir[uy, ux])
            if 3 < ctx_idx < 6:
                if abs(dir_mode - rom.VER_IDX) < 5:
                    return rom.SCAN_HOR
                if abs(dir_mode - rom.HOR_IDX) < 5:
                    return rom.SCAN_VER
            return rom.SCAN_DIAG
        dir_mode = int(f.chroma_dir[uy, ux])
        if dir_mode == DM_CHROMA_IDX:
            depth = int(f.depth[uy, ux])
            num_parts = f.parts_per_ctu >> (2 * depth)
            cu_part = (abs_part // num_parts) * num_parts
            cux, cuy = self._unit_xy(cu_part)
            dir_mode = int(f.luma_dir[cuy, cux])
        if 4 < ctx_idx < 7:
            if abs(dir_mode - rom.VER_IDX) < 5:
                return rom.SCAN_HOR
            if abs(dir_mode - rom.HOR_IDX) < 5:
                return rom.SCAN_VER
        return rom.SCAN_DIAG

    def _code_last_xy(self, pos_x: int, pos_y: int, width: int,
                      is_chroma: bool, scan_idx: int) -> None:
        if scan_idx == rom.SCAN_VER:
            pos_x, pos_y = pos_y, pos_x
        lg = rom.convert_to_bit(width)
        if is_chroma:
            blk_off, shift = 0, lg
            base_x, base_y = cc.O_LAST_X + 15, cc.O_LAST_Y + 15
        else:
            blk_off = lg * 3 + ((lg + 1) >> 2)
            shift = (lg + 3) >> 2
            base_x, base_y = cc.O_LAST_X, cc.O_LAST_Y
        gx = int(rom.GROUP_IDX[pos_x])
        gy = int(rom.GROUP_IDX[pos_y])
        gmax = int(rom.GROUP_IDX[width - 1])
        ctx = 0
        for ctx in range(gx):
            self.e.encode_bin(1, base_x + blk_off + (ctx >> shift))
        ctx = gx
        if gx < gmax:
            self.e.encode_bin(0, base_x + blk_off + (ctx >> shift))
        for ctx in range(gy):
            self.e.encode_bin(1, base_y + blk_off + (ctx >> shift))
        ctx = gy
        if gy < gmax:
            self.e.encode_bin(0, base_y + blk_off + (ctx >> shift))
        if gx > 3:
            count = (gx - 2) >> 1
            rem = pos_x - int(rom.MIN_IN_GROUP[gx])
            for i in range(count - 1, -1, -1):
                self.e.encode_bin_ep((rem >> i) & 1)
        if gy > 3:
            count = (gy - 2) >> 1
            rem = pos_y - int(rom.MIN_IN_GROUP[gy])
            for i in range(count - 1, -1, -1):
                self.e.encode_bin_ep((rem >> i) & 1)

    def code_coeff_nxn(self, abs_part: int, coeff: np.ndarray, width: int,
                       comp: int) -> None:
        if TREEDBG:
            cs = 0
            for v in coeff.reshape(-1):
                cs = cs * 31 + int(v)
            _ux, _uy = self._unit_xy(abs_part)
            TREEDBG.write("T coef part=%d t=%d w=%d cs=%d ts=%d\n" % (
                abs_part, comp if comp == 0 else comp + 1, width, cs,
                int(self.f.ts_flag[comp, _uy, _ux])))
        """codeCoeffNxN; coeff is the (width, width) block (row-major)."""
        f = self.f
        e = self.e
        flat = coeff.reshape(-1)
        num_sig = int(np.count_nonzero(flat))
        if num_sig == 0:
            return
        if self.pps.use_transform_skip:
            self.code_ts_flag(abs_part, width, comp)
        is_luma = comp == 0
        log2 = width.bit_length() - 1
        scan_idx = self._scan_idx(abs_part, width, is_luma)
        scan = rom.sig_last_scan(scan_idx, width)
        scan_cg = rom.cg_scan(scan_idx, width)

        ux, uy = self._unit_xy(abs_part)
        be_valid = (not f.tq_bypass[uy, ux]) and self.pps.sign_hide_flag

        num_blk_side = width >> 2
        sig_cg = np.zeros(max(num_blk_side * num_blk_side, 1), np.int32)
        scan_pos_last = -1
        remaining = num_sig
        while remaining > 0:
            scan_pos_last += 1
            pos = int(scan[scan_pos_last])
            if flat[pos]:
                py, px = pos >> log2, pos & (width - 1)
                sig_cg[num_blk_side * (py >> 2) + (px >> 2)] = 1
                remaining -= 1
        pos_last = int(scan[scan_pos_last])
        last_y = pos_last >> log2
        last_x = pos_last - (last_y << log2)
        if _tracing(e):
            etype = 0 if comp == 0 else comp + 1
            # depth follows the luma transform-tree walk: chroma blocks
            # sit one level up at half the luma width, except 4x4 chroma
            # coded at the luma 4x4 leaf (last part of the split group)
            if comp == 0:
                luma_w = width
            else:
                _ux, _uy = self._unit_xy(abs_part)
                _lw = self.f.ctu_size >> (int(self.f.depth[_uy, _ux]) +
                                          int(self.f.tr_idx[_uy, _ux]))
                luma_w = 4 if (width == 4 and _lw == 4) else width * 2
            _trace(f"parseCoeffNxN()\teType={etype}\twidth={width}"
                   f"\theight={width}\tdepth="
                   f"{self.f.ctu_size.bit_length() - luma_w.bit_length()}"
                   f"\tabspartidx={abs_part}")
        self._code_last_xy(last_x, last_y, width, not is_luma, scan_idx)
        if _tracing(e):
            # the parser numbers the diagonal scan 0 (SCAN_ZIGZAG slot,
            # REMOVE_ZIGZAG_SCAN) — match it so traces diff clean
            _trace(f"SCANTRACE "
                   f"scan={0 if scan_idx == rom.SCAN_DIAG else scan_idx} "
                   f"lastX={last_x} lastY={last_y}")

        sig_base = cc.O_SIG + (0 if is_luma else cc.NUM_SIG_FLAG_CTX_LUMA)
        cg_base = cc.O_SIG_CG + (0 if is_luma else 2)
        last_scan_set = scan_pos_last >> 4
        c1 = 1
        go_rice = 0
        i_scan_pos_sig = scan_pos_last
        block_type = log2

        for subset in range(last_scan_set, -1, -1):
            sub_pos = subset << 4
            go_rice = 0
            abs_coeff = []
            coeff_signs = 0
            num_nonzero = 0
            last_nz = -1
            first_nz = 16
            if i_scan_pos_sig == scan_pos_last:
                abs_coeff.append(abs(int(flat[pos_last])))
                coeff_signs = 1 if flat[pos_last] < 0 else 0
                num_nonzero = 1
                last_nz = i_scan_pos_sig
                first_nz = i_scan_pos_sig
                i_scan_pos_sig -= 1

            cg_blk_pos = int(scan_cg[subset])
            cg_pos_y = cg_blk_pos // num_blk_side if num_blk_side else 0
            cg_pos_x = cg_blk_pos - cg_pos_y * num_blk_side
            if subset == last_scan_set or subset == 0:
                sig_cg[cg_blk_pos] = 1
            else:
                flag = int(sig_cg[cg_blk_pos] != 0)
                ctx = self._sig_cg_ctx(sig_cg, cg_pos_x, cg_pos_y, width)
                e.encode_bin(flag, cg_base + ctx)
                if _tracing(e):
                    _trace(f"CGTRACE set={subset} ctx={ctx} flag={flag}")

            if sig_cg[cg_blk_pos]:
                pattern = self._calc_pattern_sig_ctx(sig_cg, cg_pos_x,
                                                     cg_pos_y, width)
                while i_scan_pos_sig >= sub_pos:
                    blk = int(scan[i_scan_pos_sig])
                    yy = blk >> log2
                    xx = blk - (yy << log2)
                    sig = int(flat[blk] != 0)
                    if i_scan_pos_sig > sub_pos or subset == 0 or num_nonzero:
                        ctx = self._sig_ctx_inc(pattern, scan_idx, xx, yy,
                                                block_type, comp)
                        e.encode_bin(sig, sig_base + ctx)
                        if _tracing(e):
                            _trace(f"SIGTRACE pos={i_scan_pos_sig} "
                                   f"ctx={ctx} sig={sig}")
                    if sig:
                        abs_coeff.append(abs(int(flat[blk])))
                        coeff_signs = 2 * coeff_signs + (1 if flat[blk] < 0 else 0)
                        num_nonzero += 1
                        if last_nz == -1:
                            last_nz = i_scan_pos_sig
                        first_nz = i_scan_pos_sig
                    i_scan_pos_sig -= 1
            else:
                i_scan_pos_sig = sub_pos - 1

            if num_nonzero > 0:
                sign_hidden = (last_nz - first_nz) >= SBH_THRESHOLD
                ctx_set = 2 if (subset > 0 and is_luma) else 0
                if c1 == 0:
                    ctx_set += 1
                c1 = 1
                one_base = cc.O_ONE + (0 if is_luma else 16) + 4 * ctx_set
                num_c1 = min(num_nonzero, C1FLAG_NUMBER)
                first_c2_idx = -1
                for idx in range(num_c1):
                    sym = 1 if abs_coeff[idx] > 1 else 0
                    e.encode_bin(sym, one_base + c1)
                    if _tracing(e):
                        _trace(f"C1TRACE c1={c1} bin={sym}")
                    if sym:
                        c1 = 0
                        if first_c2_idx == -1:
                            first_c2_idx = idx
                    elif 0 < c1 < 3:
                        c1 += 1
                if c1 == 0:
                    abs_base = cc.O_ABS + (0 if is_luma else 4) + ctx_set
                    if first_c2_idx != -1:
                        e.encode_bin(1 if abs_coeff[first_c2_idx] > 2 else 0,
                                     abs_base)
                if be_valid and sign_hidden:
                    e.encode_bins_ep(coeff_signs >> 1, num_nonzero - 1)
                else:
                    e.encode_bins_ep(coeff_signs, num_nonzero)
                first_coeff2 = 1
                if c1 == 0 or num_nonzero > C1FLAG_NUMBER:
                    for idx in range(num_nonzero):
                        base_level = (2 + first_coeff2) if idx < C1FLAG_NUMBER else 1
                        if abs_coeff[idx] >= base_level:
                            self._write_coef_remain_exgolomb(
                                abs_coeff[idx] - base_level, go_rice)
                            if _tracing(e):
                                _trace(f"GRTRACE rice={go_rice} "
                                       f"level={abs_coeff[idx] - base_level}")
                            if abs_coeff[idx] > 3 * (1 << go_rice):
                                go_rice = min(go_rice + 1, 4)
                        if abs_coeff[idx] >= 2:
                            first_coeff2 = 0

    @staticmethod
    def _sig_cg_ctx(sig_cg, cg_x, cg_y, width) -> int:
        n = width >> 2
        right = int(sig_cg[cg_y * n + cg_x + 1] != 0) if cg_x < n - 1 else 0
        lower = int(sig_cg[(cg_y + 1) * n + cg_x] != 0) if cg_y < n - 1 else 0
        return 1 if (right or lower) else 0

    @staticmethod
    def _calc_pattern_sig_ctx(sig_cg, cg_x, cg_y, width) -> int:
        if width == 4:
            return -1
        n = width >> 2
        right = int(sig_cg[cg_y * n + cg_x + 1] != 0) if cg_x < n - 1 else 0
        lower = int(sig_cg[(cg_y + 1) * n + cg_x] != 0) if cg_y < n - 1 else 0
        return right + (lower << 1)

    @staticmethod
    def _sig_ctx_inc(pattern, scan_idx, pos_x, pos_y, block_type, comp) -> int:
        CTX_IND_MAP = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8)
        if pos_x + pos_y == 0:
            return 0
        if block_type == 2:
            return CTX_IND_MAP[4 * pos_y + pos_x]
        if block_type == 3:
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

    # ------------------------------------------------------------------
    # SAO syntax (encoder side)
    # ------------------------------------------------------------------
    def code_sao_merge(self, flag: int) -> None:
        self.e.encode_bin(flag, cc.O_SAO_MERGE)

    def code_sao_offset(self, comp: int, type_idx: int, sub_type: int,
                        offsets, bit_depth: int) -> None:
        """encodeSaoOffset (TEncSbac codeSaoTypeIdx/MaxUvlc/Uflc pattern).

        type_idx: folded EO class (0..3) or 4=BO or -1=off; for comp==2 (Cr)
        the type is shared with Cb and not re-signalled.
        """
        e = self.e
        if comp == 2:
            if type_idx < 0:
                return
        else:
            if type_idx < 0:
                e.encode_bin(0, cc.O_SAO_TYPE)
                return
            e.encode_bin(1, cc.O_SAO_TYPE)
            e.encode_bin_ep(0 if type_idx == 4 else 1)
        offset_th = 1 << min(bit_depth - 5, 5)
        if type_idx == 4:  # BO
            for i in range(4):
                self._sao_max_uvlc(abs(int(offsets[i])), offset_th - 1)
            for i in range(4):
                if offsets[i] != 0:
                    e.encode_bin_ep(1 if offsets[i] < 0 else 0)
            e.encode_bins_ep(sub_type, 5)
        else:  # EO: offsets stored signed with fixed signs
            self._sao_max_uvlc(int(offsets[0]), offset_th - 1)
            self._sao_max_uvlc(int(offsets[1]), offset_th - 1)
            self._sao_max_uvlc(-int(offsets[2]), offset_th - 1)
            self._sao_max_uvlc(-int(offsets[3]), offset_th - 1)
            if comp != 2:
                e.encode_bins_ep(sub_type, 2)

    def _sao_max_uvlc(self, value: int, max_symbol: int) -> None:
        """codeSaoMaxUvlc (bypass truncated unary)."""
        if max_symbol == 0:
            return
        if value == 0:
            self.e.encode_bin_ep(0)
            return
        self.e.encode_bin_ep(1)
        i = 1
        while i < value:
            self.e.encode_bin_ep(1)
            i += 1
            if i == max_symbol:
                break
        if i < max_symbol:
            self.e.encode_bin_ep(0)


# ---------------------------------------------------------------------------
# RDOQ bit-estimation tables (TEncSbac::estBit)
# ---------------------------------------------------------------------------

class EstBits:
    """estBitsSbacStruct equivalent, built from a context-state array."""

    __slots__ = ("block_cbp_bits", "block_root_cbp_bits", "sig_cg_bits",
                 "sig_bits", "last_x_bits", "last_y_bits", "greater_one_bits",
                 "level_abs_bits")


def _ent(states, off, n):
    from ..cabac.tables import ENTROPY_BITS
    out = np.empty((n, 2), np.int64)
    for i in range(n):
        s = states[off + i]
        out[i, 0] = ENTROPY_BITS[s ^ 0]
        out[i, 1] = ENTROPY_BITS[s ^ 1]
    return out


def build_est_bits(states: np.ndarray, width: int, is_luma: bool) -> EstBits:
    """estBit (TEncSbac.cpp:1723) for a TU of the given size/component."""
    from ..cabac.tables import ENTROPY_BITS
    eb = EstBits()
    eb.block_cbp_bits = _ent(states, cc.O_QT_CBF, 10)
    eb.block_root_cbp_bits = _ent(states, cc.O_QT_ROOT_CBF, 1)
    comp_off = 0 if is_luma else 2
    eb.sig_cg_bits = _ent(states, cc.O_SIG_CG + comp_off, 2)

    # significant map contexts
    sig_off = cc.O_SIG + (0 if is_luma else cc.NUM_SIG_FLAG_CTX_LUMA)
    n_sig = 27 if is_luma else 15
    eb.sig_bits = np.zeros((max(n_sig, 28), 2), np.int64)
    first_ctx, num_ctx = 1, 8
    if width >= 16:
        first_ctx = 21 if is_luma else 12
        num_ctx = 6 if is_luma else 3
    elif width == 8:
        first_ctx = 9
        num_ctx = 12 if is_luma else 3
    for b in range(2):
        eb.sig_bits[0, b] = ENTROPY_BITS[states[sig_off] ^ b]
    for ctx in range(first_ctx, first_ctx + num_ctx):
        for b in range(2):
            eb.sig_bits[ctx, b] = ENTROPY_BITS[states[sig_off + ctx] ^ b]

    lg = rom.convert_to_bit(width)
    if is_luma:
        blk_off = lg * 3 + ((lg + 1) >> 2)
        shift = (lg + 3) >> 2
        base_x, base_y = cc.O_LAST_X, cc.O_LAST_Y
    else:
        blk_off, shift = 0, lg
        base_x, base_y = cc.O_LAST_X + 15, cc.O_LAST_Y + 15
    gmax = int(rom.GROUP_IDX[width - 1])
    eb.last_x_bits = np.zeros(16, np.int64)
    eb.last_y_bits = np.zeros(16, np.int64)
    bits = 0
    for ctx in range(gmax):
        off = blk_off + (ctx >> shift)
        eb.last_x_bits[ctx] = bits + ENTROPY_BITS[states[base_x + off] ^ 0]
        bits += ENTROPY_BITS[states[base_x + off] ^ 1]
    eb.last_x_bits[gmax] = bits
    bits = 0
    for ctx in range(gmax):
        off = blk_off + (ctx >> shift)
        eb.last_y_bits[ctx] = bits + ENTROPY_BITS[states[base_y + off] ^ 0]
        bits += ENTROPY_BITS[states[base_y + off] ^ 1]
    eb.last_y_bits[gmax] = bits

    one_off = cc.O_ONE + (0 if is_luma else 16)
    n_one = 16 if is_luma else 8
    eb.greater_one_bits = _ent(states, one_off, n_one)
    abs_off = cc.O_ABS + (0 if is_luma else 4)
    n_abs = 4 if is_luma else 2
    eb.level_abs_bits = _ent(states, abs_off, n_abs)
    return eb
