"""CU-level RD search and final syntax encoding (all-intra path).

Behavioral reference: TEncCu.cpp (xCompressCU :386, xCheckRDCostIntra :1409,
xCheckBestMode :1547, xEncodeCU :1144, finishCU :995, encodeCU :249),
TEncSearch.cpp (estIntraPredQT :2471, xRecurIntraCodingQT :1394,
xIntraCodingLumaBlk :1006, xIntraCodingChromaBlk :1166,
xRecurIntraChromaCodingQT :2160, estIntraPredChromaQT :2806,
xGetIntraBitsQT :960, xGetIntraBitsQTChroma :985, xEncSubdivCbfQT :763,
xEncCoeffQT :836, xEncIntraHeader :890, xModeBitsIntra :5889,
xUpdateCandList :5905, xStoreIntraResultQT :1815, xLoadIntraResultQT :1879),
TEncEntropy.cpp (xEncodeTransform), TComDataCU.cpp
(getIntraDirLumaPredictor :1928 piMode semantics).

Decision-equality with the reference requires the exact candidate order,
double-precision cost arithmetic, the CABAC context snapshot discipline
([depth][CI_*] grid), and fractional-bit counting where resetBits only
masks (frac &= 32767) rather than zeroing.

Instead of the reference's per-depth best/temp CU objects + YUV buffers,
all candidate state lives in the frame-wide arrays (FrameModel) and is
check-pointed with region snapshots; the net dataflow is equivalent (the
frame at the end of each _compress_cu holds best data, which is what
copyToPic/xCopyYuv2Pic establish in the reference).
"""

from __future__ import annotations

import numpy as np

from ..cabac import contexts as cc
from ..cabac.bitcount import CounterEncoder
from ..common import rom
from ..common import scaling as scaling_mod
from ..decoder.frame import (DM_CHROMA_IDX, MODE_INTER, MODE_INTRA,
                             SIZE_2Nx2N, SIZE_2NxN, SIZE_2NxnD, SIZE_2NxnU,
                             SIZE_NxN, SIZE_Nx2N, SIZE_nLx2N, SIZE_nRx2N,
                             FrameModel)
from ..decoder.recon import _tu_availability_flags
from ..ops import intra as intra_ops
from ..ops import transforms as tops
from ..params import I_SLICE
from . import rdoq as rdoq_mod
from .rdcost import RdCost, calc_had_batched
from .sbac_writer import SbacWriter, build_est_bits

MAX_DOUBLE = 1.7e308

# CI snapshot indices (TEncTop.h: CI_CURR_BEST .. CI_QT_TRAFO_ROOT)
CI_CURR_BEST = 0
CI_NEXT_BEST = 1
CI_TEMP_BEST = 2
CI_QT_TRAFO_TEST = 3
CI_QT_TRAFO_ROOT = 4

DC_IDX = 1

TSDBG = None  # set to a file object to trace transform-skip RD decisions


class CuEncoder:
    """Per-slice encoder state driving the recursive CU RD search."""

    def __init__(self, frame: FrameModel, sh, sps, pps, org_planes,
                 rec_planes, rdcost: RdCost, lambda_luma: float,
                 lambda_chroma: float, cfg=None):
        self.f = frame
        self.sh = sh
        self.sps = sps
        self.pps = pps
        self.org_y, self.org_cb, self.org_cr = org_planes
        self.rec_y, self.rec_cb, self.rec_cr = rec_planes
        self.rd = rdcost
        self.lambda_luma = lambda_luma      # RDOQ lambda (luma)
        self.lambda_chroma = lambda_chroma  # RDOQ lambda (chroma) = l/weight
        self.cfg = cfg or {}
        self.bit_depth = sps.internal_bit_depth
        self.bit_inc = sps.bit_increment
        self.max_val = (1 << self.bit_depth) - 1
        # active quantization matrices (TEncGOP.cpp:255-275 activation)
        self.scaling = getattr(sps, "enc_scaling", None) \
            if sps.scaling_list_enabled_flag else None
        # rate-control unit QP override (TEncCu.cpp:449-455/:812-817)
        self.unit_qp = None
        # AdaptiveQP layers for per-depth QP (xComputeQP, TEncCu.cpp:1113);
        # set by PictureCompressor when MaxCuDQPDepth > 0
        self.aq_layers = None
        self.qp_adaptation_range = 6
        self._depth_qp = None

        from .slice_encoder import enc_init_type
        init = cc.make_context_states_idx(enc_init_type(sh, pps),
                                          sh.slice_qp)
        depths = sps.max_cu_depth + 2
        # RD coder grid [depth][ci] -> (ctx copy, frac_bits)
        self.snap = [[(init.copy(), 0) for _ in range(5)] for _ in range(depths)]
        self.go_on = CounterEncoder(init.copy())
        self.w = SbacWriter(frame, sh, sps, pps, self.go_on)
        self.ctu_addr = 0

        ctu = frame.ctu_size
        nlayers = (sps.quadtree_tu_log2_max_size
                   - sps.quadtree_tu_log2_min_size + 1)
        # QT-layer temp buffers (m_pcQTTempTComYuv / m_ppcQTTempCoeff*)
        self.qt_rec = [dict(y=np.zeros((ctu, ctu), np.int16),
                            cb=np.zeros((ctu // 2, ctu // 2), np.int16),
                            cr=np.zeros((ctu // 2, ctu // 2), np.int16))
                       for _ in range(nlayers)]
        self.qt_coeff = [dict(y=np.zeros((ctu, ctu), np.int32),
                              cb=np.zeros((ctu // 2, ctu // 2), np.int32),
                              cr=np.zeros((ctu // 2, ctu // 2), np.int32))
                         for _ in range(nlayers)]
        # shared prediction for transform-skip candidate loops
        self.shared_pred = [np.zeros((ctu, ctu), np.int32),
                            np.zeros((ctu // 2, ctu // 2), np.int32),
                            np.zeros((ctu // 2, ctu // 2), np.int32)]

        self.total_bits = 0
        self.total_dist = 0
        self.total_cost = 0.0

    # -- coder snapshot plumbing -------------------------------------------
    def _store(self, depth: int, ci: int) -> None:
        self.snap[depth][ci] = (self.go_on.ctx.copy(), self.go_on.frac_bits)

    def _load(self, depth: int, ci: int) -> None:
        ctx, frac = self.snap[depth][ci]
        np.copyto(self.go_on.ctx, ctx)
        self.go_on.frac_bits = frac

    def _copy_snap(self, sd, sci, dd, dci) -> None:
        ctx, frac = self.snap[sd][sci]
        self.snap[dd][dci] = (ctx.copy(), frac)

    # -- addressing ---------------------------------------------------------
    def _unit_xy(self, abs_part: int):
        r = int(self.f.z2r[abs_part])
        upr = self.f.units_per_row
        cx = self.ctu_addr % self.f.ctus_w
        cy = self.ctu_addr // self.f.ctus_w
        return cx * upr + (r % upr), cy * upr + (r // upr)

    def _pel_xy(self, abs_part: int):
        ux, uy = self._unit_xy(abs_part)
        return ux * 4, uy * 4

    def _ctu_local(self, abs_part: int):
        r = int(self.f.z2r[abs_part])
        upr = self.f.units_per_row
        return (r % upr) * 4, (r // upr) * 4

    def _log2_ctu(self) -> int:
        return rom.convert_to_bit(self.f.ctu_size) + 2

    def _cbf(self, abs_part, comp, tr_depth) -> int:
        ux, uy = self._unit_xy(abs_part)
        return (int(self.f.cbf[comp, uy, ux]) >> tr_depth) & 1

    @property
    def _min_cu_dqp_size(self) -> int:
        return self.f.ctu_size >> self.pps.max_cu_dqp_depth

    # -- frame region snapshots (stand-in for best/temp CU + YUV buffers) ---
    _ATTRS = ("depth", "pred_mode", "part_size_arr", "luma_dir", "chroma_dir",
              "tr_idx", "qp", "tq_bypass", "ipcm", "skip", "merge_flag",
              "merge_idx", "inter_dir")
    _MV_ATTRS = ("mv", "mvd", "ref_idx", "mvp_idx")

    def _save_region(self, abs_part: int, depth: int) -> dict:
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        units = f.units_per_row >> depth
        px, py = ux * 4, uy * 4
        size = f.ctu_size >> depth
        return {"attrs": {a: getattr(f, a)[uy:uy + units, ux:ux + units].copy()
                          for a in self._ATTRS},
                "cbf": f.cbf[:, uy:uy + units, ux:ux + units].copy(),
                "ts": f.ts_flag[:, uy:uy + units, ux:ux + units].copy(),
                "motion": {a: getattr(f, a)[:, uy:uy + units,
                                            ux:ux + units].copy()
                           for a in self._MV_ATTRS},
                "coeff_y": f.coeff_y[py:py + size, px:px + size].copy(),
                "coeff_cb": f.coeff_cb[py // 2:(py + size) // 2,
                                       px // 2:(px + size) // 2].copy(),
                "coeff_cr": f.coeff_cr[py // 2:(py + size) // 2,
                                       px // 2:(px + size) // 2].copy(),
                "rec_y": self.rec_y[py:py + size, px:px + size].copy(),
                "rec_cb": self.rec_cb[py // 2:(py + size) // 2,
                                      px // 2:(px + size) // 2].copy(),
                "rec_cr": self.rec_cr[py // 2:(py + size) // 2,
                                      px // 2:(px + size) // 2].copy(),
                "bits": self.total_bits, "dist": self.total_dist,
                "cost": self.total_cost}

    def _restore_region(self, abs_part: int, depth: int, snap: dict) -> None:
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        units = f.units_per_row >> depth
        px, py = ux * 4, uy * 4
        size = f.ctu_size >> depth
        for a in self._ATTRS:
            getattr(f, a)[uy:uy + units, ux:ux + units] = snap["attrs"][a]
        f.cbf[:, uy:uy + units, ux:ux + units] = snap["cbf"]
        f.ts_flag[:, uy:uy + units, ux:ux + units] = snap["ts"]
        for a in self._MV_ATTRS:
            getattr(f, a)[:, uy:uy + units, ux:ux + units] = \
                snap["motion"][a]
        f.coeff_y[py:py + size, px:px + size] = snap["coeff_y"]
        f.coeff_cb[py // 2:(py + size) // 2,
                   px // 2:(px + size) // 2] = snap["coeff_cb"]
        f.coeff_cr[py // 2:(py + size) // 2,
                   px // 2:(px + size) // 2] = snap["coeff_cr"]
        self.rec_y[py:py + size, px:px + size] = snap["rec_y"]
        self.rec_cb[py // 2:(py + size) // 2,
                    px // 2:(px + size) // 2] = snap["rec_cb"]
        self.rec_cr[py // 2:(py + size) // 2,
                    px // 2:(px + size) // 2] = snap["rec_cr"]
        self.total_bits = snap["bits"]
        self.total_dist = snap["dist"]
        self.total_cost = snap["cost"]

    # ==================================================================
    # compressCU entry (per CTU)
    # ==================================================================
    def compress_ctu(self, ctu_addr: int) -> None:
        self.ctu_addr = ctu_addr
        self.w.ctu_addr = ctu_addr
        self.total_bits = 0
        self.total_dist = 0
        self.total_cost = 0.0
        # initCU: reset the CTU region
        f = self.f
        upr = f.units_per_row
        cx, cy = ctu_addr % f.ctus_w, ctu_addr // f.ctus_w
        sl = (slice(cy * upr, (cy + 1) * upr), slice(cx * upr, (cx + 1) * upr))
        f.depth[sl] = 0
        f.tr_idx[sl] = 0
        f.qp[sl] = self.sh.slice_qp if self.unit_qp is None else self.unit_qp
        f.pred_mode[sl] = 15
        f.part_size_arr[sl] = 15
        f.skip[sl] = False
        f.cbf[:, sl[0], sl[1]] = 0
        f.ts_flag[:, sl[0], sl[1]] = False
        f.ipcm[sl] = False
        f.tq_bypass[sl] = False
        f.merge_flag[sl] = False
        f.merge_idx[sl] = 0
        f.inter_dir[sl] = 0
        f.mv[:, sl[0], sl[1]] = 0
        f.mvd[:, sl[0], sl[1]] = 0
        f.ref_idx[:, sl[0], sl[1]] = -1
        f.mvp_idx[:, sl[0], sl[1]] = 0
        self._compress_cu(0, 0)

    def _compute_qp(self, px: int, py: int, depth: int,
                    inherited: int) -> int:
        """xComputeQP + the iMinQP/iMaxQP gating (TEncCu.cpp:425-446):
        AQ layers give slice_qp + a psycho-visual offset while the CU is
        at least MinCuDQPSize; smaller CUs inherit the parent's QP."""
        if self.aq_layers is None:
            return inherited
        if (self.f.ctu_size >> depth) < self._min_cu_dqp_size:
            return inherited
        from .preanalyzer import compute_qp_offset
        off = compute_qp_offset(self.aq_layers, depth, px, py,
                                self.qp_adaptation_range)
        return max(-self.sps.qp_bd_offset_y,
                   min(51, self.sh.slice_qp + off))

    def _compress_cu(self, abs_part: int, depth: int,
                     parent_part: int = -1, qp_in: int | None = None
                     ) -> dict:
        """xCompressCU (TEncCu.cpp:386); frame ends holding this CU's best.

        Returns the best snapshot dict (bits/dist/cost feed the parent's
        split accounting).  parent_part: best partition size of the parent
        CU (AMP_ENC_SPEEDUP), -1 = SIZE_NONE (parent intra / top).
        qp_in: the QP this CU inherits (initSubCU's iQP); None = slice QP.
        """
        f = self.f
        sps = self.sps
        px, py = self._pel_xy(abs_part)
        size = f.ctu_size >> depth
        inside = (px + size <= f.width) and (py + size <= f.height)
        max_sig_depth = f.max_depth - sps.add_cu_depth
        boundary = not inside

        best = None
        ux, uy = self._unit_xy(abs_part)

        inherited = qp_in if qp_in is not None else (
            self.sh.slice_qp if self.unit_qp is None else self.unit_qp)
        cu_qp = self._compute_qp(px, py, depth, inherited)
        self._depth_qp = cu_qp if self.aq_layers is not None else None

        if inside:
            qp = cu_qp
            is_inter_slice = self.sh.slice_type != I_SLICE
            if is_inter_slice:
                best = self._check_rd_merge_2nx2n(abs_part, depth, best)
                best = self._check_rd_inter(abs_part, depth, SIZE_2Nx2N,
                                            best)
                if not (size == 8):
                    if depth == max_sig_depth:
                        best = self._check_rd_inter(abs_part, depth,
                                                    SIZE_NxN, best)
                best = self._check_rd_inter(abs_part, depth, SIZE_Nx2N,
                                            best)
                best = self._check_rd_inter(abs_part, depth, SIZE_2NxN,
                                            best)
                if sps.use_amp and depth < max_sig_depth:
                    best = self._check_amp(abs_part, depth, best,
                                           parent_part, size)
            do_intra = (not is_inter_slice or
                        int(f.cbf[0, uy, ux]) != 0 or
                        int(f.cbf[1, uy, ux]) != 0 or
                        int(f.cbf[2, uy, ux]) != 0)
            if do_intra:
                best = self._check_intra(abs_part, depth, SIZE_2Nx2N, qp,
                                         best)
                if depth == max_sig_depth and \
                        size > (1 << sps.quadtree_tu_log2_min_size):
                    best = self._check_intra(abs_part, depth, SIZE_NxN, qp,
                                             best)
            if sps.use_pcm and (1 << sps.pcm_log2_min_size) <= size \
                    <= (1 << sps.pcm_log2_max_size):
                # g_uiBitDepth is the 8-bit base depth, not the internal
                # depth (TEncCu.cpp:725, TComRom.cpp:445)
                raw_bits = 8 * size * size * 3 // 2
                if (best["bits"] > raw_bits
                        or best["cost"] > self.rd.calc_rd_cost(raw_bits, 0)):
                    best = self._check_intra_pcm(abs_part, depth, best)

            # add split-flag bits to best (TEncCu.cpp:741; GoOn ctx as-is;
            # frame region holds best data so the writer derives split=0)
            self.go_on.reset_bits()
            self.w.code_split_flag(abs_part, depth)
            best["bits"] += self.go_on.num_written_bits
            best["cost"] = self.rd.calc_rd_cost(best["bits"], best["dist"])
            self.total_bits, self.total_dist, self.total_cost = \
                best["bits"], best["dist"], best["cost"]

        # ---- split ----
        # parent partition size for AMP_ENC_SPEEDUP: captured once from the
        # best-so-far BEFORE children overwrite the frame region
        if best is None or f.pred_mode[uy, ux] == MODE_INTRA:
            sub_parent = -1
        else:
            sub_parent = int(f.part_size_arr[uy, ux])
        if depth < max_sig_depth:
            q_parts = (f.parts_per_ctu >> (depth << 1)) >> 2
            split_bits = 0
            split_dist = 0
            part = abs_part
            for i in range(4):
                spx, spy = self._pel_xy(part)
                if spx < f.width and spy < f.height:
                    if i == 0:
                        self._copy_snap(depth, CI_CURR_BEST,
                                        depth + 1, CI_CURR_BEST)
                    else:
                        self._copy_snap(depth + 1, CI_NEXT_BEST,
                                        depth + 1, CI_CURR_BEST)
                    sub_best = self._compress_cu(part, depth + 1,
                                                 sub_parent, cu_qp)
                    split_bits += sub_best["bits"]
                    split_dist += sub_best["dist"]
                else:
                    # initSubCU + copyToPic for the out-of-picture child
                    sux, suy = self._unit_xy(part)
                    su = f.units_per_row >> (depth + 1)
                    f.depth[suy:suy + su, sux:sux + su] = depth + 1
                    f.pred_mode[suy:suy + su, sux:sux + su] = 15
                part += q_parts

            if not boundary:
                # split flag (=1) counted with the GoOn post-children state
                self.go_on.reset_bits()
                self.w.code_split_flag(abs_part, depth)
                split_bits += self.go_on.num_written_bits
            split_bits, split_cost = self._check_dqp_split(
                abs_part, depth, split_bits, split_dist)

            self._copy_snap(depth + 1, CI_NEXT_BEST, depth, CI_TEMP_BEST)

            if best is None or split_cost < best["cost"]:
                self.total_bits, self.total_dist = split_bits, split_dist
                self.total_cost = split_cost
                best = self._save_region(abs_part, depth)
                self._copy_snap(depth, CI_TEMP_BEST, depth, CI_NEXT_BEST)
            else:
                # non-split wins: restore best into frame (net effect of
                # xCheckBestMode keeping best + final copyToPic/xCopyYuv2Pic)
                self._restore_region(abs_part, depth, best)
        return best

    # ------------------------------------------------------------------
    def _check_intra(self, abs_part: int, depth: int, part_size: int, qp: int,
                     best):
        """xCheckRDCostIntra (TEncCu.cpp:1409) + xCheckBestMode."""
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        units = f.units_per_row >> depth
        reg = (slice(uy, uy + units), slice(ux, ux + units))
        f.skip[reg] = False
        f.part_size_arr[reg] = part_size
        f.pred_mode[reg] = MODE_INTRA
        f.depth[reg] = depth
        f.qp[reg] = qp
        f.ipcm[reg] = False
        f.tr_idx[reg] = 0
        f.cbf[:, reg[0], reg[1]] = 0
        f.ts_flag[:, reg[0], reg[1]] = False
        # initEstData also clears the motion fields (stale inter data from a
        # previously tested mode must not leak into later AMVP/merge scans)
        f.merge_flag[reg] = False
        f.merge_idx[reg] = 0
        f.inter_dir[reg] = 0
        f.mv[:, reg[0], reg[1]] = 0
        f.mvd[:, reg[0], reg[1]] = 0
        f.ref_idx[:, reg[0], reg[1]] = -1
        f.mvp_idx[:, reg[0], reg[1]] = 0
        tqb = (bool(self.cfg.get("CUTransquantBypassFlagValue", 0))
               if self.pps.transquant_bypass_enable_flag else False)
        f.tq_bypass[reg] = tqb

        dist_y = self._est_intra_pred_qt(abs_part, depth)
        # copyToPicLuma is implicit: frame luma already holds the winner
        dist_c = self._est_intra_chroma(abs_part, depth)

        # ---- bit count for the full CU syntax (GoOn = CI_CURR_BEST) ----
        self.go_on.reset_bits()
        w = self.w
        if self.pps.transquant_bypass_enable_flag:
            w.code_tq_bypass(abs_part)
        if self.sh.slice_type != I_SLICE:
            w.code_skip_flag(abs_part)
            w.code_pred_mode(abs_part)
        w.code_part_size(abs_part, depth)
        # encodePredInfo: intra dirs
        w.code_intra_dir_luma(abs_part, multiple=True)
        w.code_intra_dir_chroma(abs_part)
        # encodeIPCMInfo (RD variant: no part-size gate, TEncCu.cpp:1442)
        if self.sps.use_pcm and (1 << self.sps.pcm_log2_min_size) <= \
                (f.ctu_size >> depth) <= (1 << self.sps.pcm_log2_max_size):
            w.code_terminating_bit(0)
        w.dqp_flag = False
        self._transform_tree(w, abs_part, depth, 0)
        bits = self.go_on.num_written_bits
        self._store(depth, CI_TEMP_BEST)

        dist = dist_y + dist_c
        cost = self.rd.calc_rd_cost(bits, dist)
        self.total_bits, self.total_dist, self.total_cost = bits, dist, cost
        self._check_dqp_rd(abs_part, depth)
        cost = self.total_cost

        # xCheckBestMode
        if best is None or cost < best["cost"]:
            new_best = self._save_region(abs_part, depth)
            self._copy_snap(depth, CI_TEMP_BEST, depth, CI_NEXT_BEST)
            return new_best
        self._restore_region(abs_part, depth, best)
        return best

    def _check_intra_pcm(self, abs_part, depth, best):
        """xCheckIntraPCM (TEncCu.cpp:1469) + IPCMSearch
        (TEncSearch.cpp:2988): lossless PCM candidate with distortion 0 and
        raw-sample bits."""
        f = self.f
        sps = self.sps
        ux, uy = self._unit_xy(abs_part)
        units = f.units_per_row >> depth
        reg = (slice(uy, uy + units), slice(ux, ux + units))
        qp = self._depth_qp if self._depth_qp is not None else (
            self.sh.slice_qp if self.unit_qp is None else self.unit_qp)
        f.skip[reg] = False
        f.ipcm[reg] = True
        f.part_size_arr[reg] = SIZE_2Nx2N
        f.pred_mode[reg] = MODE_INTRA
        f.depth[reg] = depth
        f.qp[reg] = qp
        f.tr_idx[reg] = 0
        f.cbf[:, reg[0], reg[1]] = 0
        f.ts_flag[:, reg[0], reg[1]] = False
        f.luma_dir[reg] = DC_IDX          # initEstData (TComDataCU.cpp:476)
        f.chroma_dir[reg] = 0
        f.merge_flag[reg] = False
        f.merge_idx[reg] = 0
        f.inter_dir[reg] = 0
        f.mv[:, reg[0], reg[1]] = 0
        f.mvd[:, reg[0], reg[1]] = 0
        f.ref_idx[:, reg[0], reg[1]] = -1
        f.mvp_idx[:, reg[0], reg[1]] = 0
        tqb = (bool(self.cfg.get("CUTransquantBypassFlagValue", 0))
               if self.pps.transquant_bypass_enable_flag else False)
        f.tq_bypass[reg] = tqb

        # xEncPCM: samples = org >> (internal - pcm depth); recon = back-shift
        px, py = ux * 4, uy * 4
        size = f.ctu_size >> depth
        if not hasattr(f, "pcm_y"):
            f.pcm_y = np.zeros((f.frame_units_h * 4, f.frame_units_w * 4),
                               np.int16)
            f.pcm_cb = np.zeros((f.frame_units_h * 2, f.frame_units_w * 2),
                                np.int16)
            f.pcm_cr = np.zeros((f.frame_units_h * 2, f.frame_units_w * 2),
                                np.int16)
        sh_l = sps.internal_bit_depth - sps.pcm_bit_depth_luma
        sh_c = sps.internal_bit_depth - sps.pcm_bit_depth_chroma
        ly, lx = slice(py, py + size), slice(px, px + size)
        cy, cx = slice(py // 2, (py + size) // 2), \
            slice(px // 2, (px + size) // 2)
        f.pcm_y[ly, lx] = self.org_y[ly, lx] >> sh_l
        f.pcm_cb[cy, cx] = self.org_cb[cy, cx] >> sh_c
        f.pcm_cr[cy, cx] = self.org_cr[cy, cx] >> sh_c
        self.rec_y[ly, lx] = f.pcm_y[ly, lx] << sh_l
        self.rec_cb[cy, cx] = f.pcm_cb[cy, cx] << sh_c
        self.rec_cr[cy, cx] = f.pcm_cr[cy, cx] << sh_c

        # bit count (xCheckIntraPCM syntax list, RD/bRD=true IPCM info:
        # pcm_flag + numSubseqIPCM(0) + align(0 bits) + raw samples)
        self._load(depth, CI_CURR_BEST)
        self.go_on.reset_bits()
        w = self.w
        if self.pps.transquant_bypass_enable_flag:
            w.code_tq_bypass(abs_part)
        if self.sh.slice_type != I_SLICE:
            w.code_skip_flag(abs_part)
            w.code_pred_mode(abs_part)
        w.code_part_size(abs_part, depth)
        w.code_terminating_bit(1)
        self.go_on.encode_num_subseq_ipcm(0)
        self.go_on.encode_pcm_align_bits()
        w.code_pcm_samples(abs_part, depth)
        self.go_on.reset_bac()
        bits = self.go_on.num_written_bits
        self._store(depth, CI_TEMP_BEST)

        dist = 0
        cost = self.rd.calc_rd_cost(bits, dist)
        self.total_bits, self.total_dist, self.total_cost = bits, dist, cost
        self._check_dqp_rd(abs_part, depth)
        cost = self.total_cost

        if best is None or cost < best["cost"]:
            new_best = self._save_region(abs_part, depth)
            self._copy_snap(depth, CI_TEMP_BEST, depth, CI_NEXT_BEST)
            return new_best
        self._restore_region(abs_part, depth, best)
        return best

    # ==================================================================
    # Inter mode checks (xCheckRDCostMerge2Nx2N / xCheckRDCostInter /
    # AMP derivation, TEncCu.cpp:1248/1371/307)
    # ==================================================================
    def _reset_inter_region(self, abs_part, depth, part_size):
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        units = f.units_per_row >> depth
        reg = (slice(uy, uy + units), slice(ux, ux + units))
        f.skip[reg] = False
        f.part_size_arr[reg] = part_size
        f.pred_mode[reg] = MODE_INTER
        f.depth[reg] = depth
        f.qp[reg] = self._depth_qp if self._depth_qp is not None else (
            self.sh.slice_qp if self.unit_qp is None else self.unit_qp)
        f.ipcm[reg] = False
        f.tr_idx[reg] = 0
        f.cbf[:, reg[0], reg[1]] = 0
        f.ts_flag[:, reg[0], reg[1]] = False
        f.merge_flag[reg] = False
        f.merge_idx[reg] = 0
        f.inter_dir[reg] = 0
        f.mv[:, reg[0], reg[1]] = 0
        f.mvd[:, reg[0], reg[1]] = 0
        f.ref_idx[:, reg[0], reg[1]] = -1
        f.mvp_idx[:, reg[0], reg[1]] = 0
        tqb = (bool(self.cfg.get("CUTransquantBypassFlagValue", 0))
               if self.pps.transquant_bypass_enable_flag else False)
        f.tq_bypass[reg] = tqb
        return reg

    def _check_dqp_rd(self, abs_part: int, depth: int) -> None:
        """xCheckDQP (TEncCu.cpp:1575): when the candidate in the frame
        region has coded coefficients, add the dQP bits to its totals
        (RDO_WITHOUT_DQP_BITS=0); otherwise reset its QP to the reference
        QP.  Run on every mode candidate before the best compare."""
        f = self.f
        if not (self.pps.use_dqp and
                (f.ctu_size >> depth) >= self._min_cu_dqp_size):
            return
        ux, uy = self._unit_xy(abs_part)
        if (int(f.cbf[0, uy, ux]) | int(f.cbf[1, uy, ux]) |
                int(f.cbf[2, uy, ux])):
            self.go_on.reset_bits()
            self.w.code_delta_qp(abs_part)
            self.total_bits += self.go_on.num_written_bits
            self.total_cost = self.rd.calc_rd_cost(self.total_bits,
                                                   self.total_dist)
        else:
            units = f.units_per_row >> depth
            f.qp[uy:uy + units, ux:ux + units] = self.w._ref_qp(abs_part)

    def _set_qp_subcus(self, qp: int, abs_part: int, depth: int,
                       found: list) -> None:
        """setQPSubCUs (TComDataCU.cpp:2159): reset leading no-cbf CUs
        to qp until the first CU with coded coefficients."""
        f = self.f
        if found[0]:
            return
        ux, uy = self._unit_xy(abs_part)
        if int(f.depth[uy, ux]) > depth:
            q_parts = (f.parts_per_ctu >> (depth << 1)) >> 2
            for i in range(4):
                self._set_qp_subcus(qp, abs_part + i * q_parts, depth + 1,
                                    found)
        else:
            if (int(f.cbf[0, uy, ux]) | int(f.cbf[1, uy, ux]) |
                    int(f.cbf[2, uy, ux])):
                found[0] = True
            else:
                units = f.units_per_row >> depth
                f.qp[uy:uy + units, ux:ux + units] = qp

    def _check_dqp_split(self, abs_part: int, depth: int, split_bits: int,
                         split_dist: int):
        """The split candidate's dQP handling (TEncCu.cpp:889-932);
        dependent-slice starts are CTU-aligned under REMOVE_FGS so the
        target part is always 0.  Returns updated (split_bits, cost)."""
        f = self.f
        split_cost = self.rd.calc_rd_cost(split_bits, split_dist)
        if not (self.pps.use_dqp and
                (f.ctu_size >> depth) == self._min_cu_dqp_size):
            return split_bits, split_cost
        ux, uy = self._unit_xy(abs_part)
        units = f.units_per_row >> depth
        reg_cbf = (f.cbf[0, uy:uy + units, ux:ux + units] |
                   f.cbf[1, uy:uy + units, ux:ux + units] |
                   f.cbf[2, uy:uy + units, ux:ux + units])
        if reg_cbf.any():
            self.go_on.reset_bits()
            self.w.code_delta_qp(abs_part)
            split_bits += self.go_on.num_written_bits
            split_cost = self.rd.calc_rd_cost(split_bits, split_dist)
            found = [False]
            self._set_qp_subcus(self.w._ref_qp(abs_part), abs_part, depth,
                                found)
            assert found[0]
        else:
            f.qp[uy:uy + units, ux:ux + units] = self.w._ref_qp(abs_part)
        return split_bits, split_cost

    def _best_update(self, abs_part, depth, bits, dist, cost, best):
        """xCheckBestMode (preceded by xCheckDQP as in every
        xCheckRDCost* caller)."""
        self.total_bits, self.total_dist, self.total_cost = bits, dist, cost
        self._check_dqp_rd(abs_part, depth)
        cost = self.total_cost
        if best is None or cost < best["cost"]:
            new_best = self._save_region(abs_part, depth)
            self._copy_snap(depth, CI_TEMP_BEST, depth, CI_NEXT_BEST)
            return new_best
        self._restore_region(abs_part, depth, best)
        return best

    def _check_rd_merge_2nx2n(self, abs_part, depth, best):
        f = self.f
        px, py = self._pel_xy(abs_part)
        size = f.ctu_size >> depth
        ux, uy = self._unit_xy(abs_part)
        self._reset_inter_region(abs_part, depth, SIZE_2Nx2N)
        cand_dir, cand_mv, n_valid = self.inter.mvctx.merge_candidates(
            px, py, size, SIZE_2Nx2N, 0)
        cand_buffer = [0] * n_valid
        best_is_skip = False
        # lossless CUs never try the forced-no-residual merge pass
        # (TEncCu.cpp:1267-1275)
        no_resi_range = (0,) if (self.pps.transquant_bypass_enable_flag
                                 and f.tq_bypass[uy, ux]) else (0, 1)
        for no_resi in no_resi_range:
            for cand in range(n_valid):
                if no_resi == 1 and cand_buffer[cand] == 1:
                    continue
                if best_is_skip and no_resi == 0:
                    continue
                reg = self._reset_inter_region(abs_part, depth, SIZE_2Nx2N)
                f.merge_flag[reg] = True
                f.merge_idx[reg] = cand
                f.inter_dir[reg] = cand_dir[cand]
                for lst in range(2):
                    ref, mv = cand_mv[cand][lst]
                    f.ref_idx[lst, reg[0], reg[1]] = ref
                    f.mv[lst, reg[0], reg[1]] = mv
                self.inter.motion_compensation(px, py, size)
                bits, dist, cost = self.inter.encode_res_and_calc_rd(
                    abs_part, depth, bool(no_resi))
                root_cbf = ((int(f.cbf[0, uy, ux]) | int(f.cbf[1, uy, ux]) |
                             int(f.cbf[2, uy, ux])) & 1) != 0
                if no_resi == 0 and not root_cbf:
                    cand_buffer[cand] = 1
                f.skip[reg] = not root_cbf
                best = self._best_update(abs_part, depth, bits, dist, cost,
                                         best)
                if self.inter.fdm and not best_is_skip:
                    bcbf = ((int(f.cbf[0, uy, ux]) | int(f.cbf[1, uy, ux]) |
                             int(f.cbf[2, uy, ux])) & 1) != 0
                    best_is_skip = not bcbf
        return best

    def _check_rd_inter(self, abs_part, depth, part_size, best,
                        use_mrg=False):
        f = self.f
        px, py = self._pel_xy(abs_part)
        size = f.ctu_size >> depth
        self._reset_inter_region(abs_part, depth, part_size)
        self.inter.pred_inter_search(px, py, size, part_size, use_mrg)
        bits, dist, cost = self.inter.encode_res_and_calc_rd(
            abs_part, depth, False)
        return self._best_update(abs_part, depth, bits, dist, cost, best)

    def _check_amp(self, abs_part, depth, best, parent_part, size):
        """deriveTestModeAMP + the AMP check sequence (AMP_ENC_SPEEDUP,
        AMP_MRG)."""
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        bpart = int(f.part_size_arr[uy, ux])
        bmerge = bool(f.merge_flag[uy, ux])
        bskip = bool(f.skip[uy, ux])
        hor = ver = mrg_hor = mrg_ver = False
        if bpart == SIZE_2NxN:
            hor = True
        elif bpart == SIZE_Nx2N:
            ver = True
        elif bpart == SIZE_2Nx2N and not bmerge and not bskip:
            hor = ver = True
        if SIZE_2NxnU <= parent_part <= SIZE_nRx2N:
            mrg_hor = mrg_ver = True
        if parent_part == -1:
            if bpart == SIZE_2NxN:
                mrg_hor = True
            elif bpart == SIZE_Nx2N:
                mrg_ver = True
        if bpart == SIZE_2Nx2N and not bskip:
            mrg_hor = mrg_ver = True
        if size == 64:
            hor = ver = False
        if hor:
            best = self._check_rd_inter(abs_part, depth, SIZE_2NxnU, best)
            best = self._check_rd_inter(abs_part, depth, SIZE_2NxnD, best)
        elif mrg_hor:
            best = self._check_rd_inter(abs_part, depth, SIZE_2NxnU, best,
                                        use_mrg=True)
            best = self._check_rd_inter(abs_part, depth, SIZE_2NxnD, best,
                                        use_mrg=True)
        if ver:
            best = self._check_rd_inter(abs_part, depth, SIZE_nLx2N, best)
            best = self._check_rd_inter(abs_part, depth, SIZE_nRx2N, best)
        elif mrg_ver:
            best = self._check_rd_inter(abs_part, depth, SIZE_nLx2N, best,
                                        use_mrg=True)
            best = self._check_rd_inter(abs_part, depth, SIZE_nRx2N, best,
                                        use_mrg=True)
        return best

    # ==================================================================
    # Luma intra search (estIntraPredQT, bLumaOnly=true)
    # ==================================================================
    def _est_intra_pred_qt(self, abs_part: int, depth: int) -> int:
        f = self.f
        ux0, uy0 = self._unit_xy(abs_part)
        part_size = int(f.part_size_arr[uy0, ux0])
        num_pu = 4 if part_size == SIZE_NxN else 1
        init_tr_depth = 0 if part_size == SIZE_2Nx2N else 1
        q_parts = f.parts_per_ctu >> (depth << 1) >> 2
        # getIntraSizeIdx
        w_ = (f.ctu_size >> depth) >> (1 if part_size == SIZE_NxN else 0)
        size_idx = min(max(w_.bit_length() - 2, 0), 6)

        overall_dist_y = 0
        for pu in range(num_pu):
            part = abs_part + pu * (q_parts if part_size == SIZE_NxN else 0)
            overall_dist_y += self._search_luma_pu(part, depth, init_tr_depth,
                                                   size_idx)

        if num_pu > 1:
            self._merge_nxn_cbf(abs_part, q_parts)

        self._load(depth, CI_CURR_BEST)
        return overall_dist_y

    def _merge_nxn_cbf(self, abs_part: int, q_parts: int) -> None:
        """estIntraPredQT NxN combined-cbf OR (TEncSearch.cpp:2772)."""
        f = self.f
        comb = [0, 0, 0]
        for p in range(4):
            part = abs_part + p * q_parts
            ux, uy = self._unit_xy(part)
            for c in range(3):
                comb[c] |= (int(f.cbf[c, uy, ux]) >> 1) & 1
        ux, uy = self._unit_xy(abs_part)
        depth = int(f.depth[uy, ux])
        units = f.units_per_row >> depth
        for c in range(3):
            if comb[c]:
                f.cbf[c, uy:uy + units, ux:ux + units] |= comb[c]

    def _left_above_luma_dirs(self, ux: int, uy: int):
        """Left/above intra dirs exactly as getIntraDirLumaPredictor
        (incl. the left neighbor's dependent-slice restriction,
        TComDataCU.cpp:1936 / getPULeft default args)."""
        f = self.f
        n = f.left_unit(ux, uy)
        if n is not None and f.unit_order(n[0], n[1]) < \
                int(f.dep_slice_start[uy, ux]):
            n = None
        left = int(f.luma_dir[n[1], n[0]]) if (
            n is not None and f.pred_mode[n[1], n[0]] == MODE_INTRA) else DC_IDX
        n = f.above_unit(ux, uy, planar_at_ctu_boundary=True)
        above = int(f.luma_dir[n[1], n[0]]) if (
            n is not None and f.pred_mode[n[1], n[0]] == MODE_INTRA) else DC_IDX
        return left, above

    def _search_luma_pu(self, part: int, depth: int, init_tr_depth: int,
                        size_idx: int) -> int:
        """One PU of estIntraPredQT (luma only)."""
        f = self.f
        px, py = self._pel_xy(part)
        ux, uy = self._unit_xy(part)
        size = f.ctu_size >> (depth + init_tr_depth)
        log2 = size.bit_length() - 1
        units = f.units_per_row >> (depth + init_tr_depth)

        # ---- SATD-based candidate preselection ----
        line_raw, line_filt = self._adi_lines_luma(px, py, size)
        org = self.org_y[py:py + size, px:px + size]
        num_full = int(rom.INTRA_MODE_NUM_FAST[size_idx])
        cand_modes = [0] * num_full
        cand_costs = [MAX_DOUBLE] * num_full

        preds_all = np.empty((35, size, size), np.int32)
        for mode in range(35):
            line = (line_filt if intra_ops.use_filtered(mode, log2, True)
                    else line_raw)
            preds_all[mode] = intra_ops.predict(line, size, 4, mode, True,
                                                self.max_val)
        sads = calc_had_batched(org, preds_all, self.bit_inc)
        for mode in range(35):
            mode_bits = self._mode_bits_intra(part, mode, depth, init_tr_depth)
            cost = float(sads[mode]) + float(mode_bits) * self.rd.sqrt_lambda
            self._update_cand_list(mode, cost, cand_modes, cand_costs)

        # MPM augmentation (FAST_UDI_USE_MPM): only the first numCand preds,
        # numCand = 1 if left==above else 2 (getIntraDirLumaPredictor piMode)
        left, above = self._left_above_luma_dirs(ux, uy)
        preds = f.intra_mpm(ux, uy)
        num_cand = 1 if left == above else 2
        rd_list = list(cand_modes)
        for j in range(num_cand):
            if preds[j] not in rd_list:
                rd_list.append(preds[j])

        # ---- full RD over candidates (HHI_RQT_INTRA_SPEEDUP two-phase) ----
        best_mode = 0
        best_dist = 0
        best_cost = MAX_DOUBLE
        best_store = None
        for mode in rd_list:
            f.luma_dir[uy:uy + units, ux:ux + units] = mode
            self._load(depth, CI_CURR_BEST)
            dist, cost = self._recur_intra_luma(part, depth, init_tr_depth,
                                                check_first=True)
            if TSDBG:
                TSDBG.write(f"LUMDBG cu={self.ctu_addr} part={part} "
                            f"mode={mode} dist={dist} cost={cost:.4f}\n")
            if cost < best_cost:
                best_mode = mode
                best_cost = cost
                best_dist = dist
                best_store = self._save_luma_result(part, depth, init_tr_depth)

        # second pass: best mode with full RQT depth
        f.luma_dir[uy:uy + units, ux:ux + units] = best_mode
        self._load(depth, CI_CURR_BEST)
        dist, cost = self._recur_intra_luma(part, depth, init_tr_depth,
                                            check_first=False)
        if cost < best_cost:
            best_cost = cost
            best_dist = dist
            best_store = self._save_luma_result(part, depth, init_tr_depth)

        self._restore_luma_result(part, depth, init_tr_depth, best_store)
        f.luma_dir[uy:uy + units, ux:ux + units] = best_mode
        return best_dist

    def _save_luma_result(self, part, depth, init_tr_depth) -> dict:
        f = self.f
        px, py = self._pel_xy(part)
        ux, uy = self._unit_xy(part)
        units = f.units_per_row >> (depth + init_tr_depth)
        size = f.ctu_size >> (depth + init_tr_depth)
        return dict(
            tr_idx=f.tr_idx[uy:uy + units, ux:ux + units].copy(),
            cbf=f.cbf[0, uy:uy + units, ux:ux + units].copy(),
            ts=f.ts_flag[0, uy:uy + units, ux:ux + units].copy(),
            coeff=f.coeff_y[py:py + size, px:px + size].copy(),
            rec=self.rec_y[py:py + size, px:px + size].copy())

    def _restore_luma_result(self, part, depth, init_tr_depth, store) -> None:
        f = self.f
        px, py = self._pel_xy(part)
        ux, uy = self._unit_xy(part)
        units = f.units_per_row >> (depth + init_tr_depth)
        size = f.ctu_size >> (depth + init_tr_depth)
        f.tr_idx[uy:uy + units, ux:ux + units] = store["tr_idx"]
        f.cbf[0, uy:uy + units, ux:ux + units] = store["cbf"]
        f.ts_flag[0, uy:uy + units, ux:ux + units] = store["ts"]
        f.coeff_y[py:py + size, px:px + size] = store["coeff"]
        self.rec_y[py:py + size, px:px + size] = store["rec"]

    def _mode_bits_intra(self, part, mode, depth, init_tr_depth) -> int:
        """xModeBitsIntra: intra-dir bits after loadIntraDirModeLuma
        (copies binIf state incl. frac bits + the intra-dir ctx only)."""
        f = self.f
        ux, uy = self._unit_xy(part)
        units = f.units_per_row >> (depth + init_tr_depth)
        saved = f.luma_dir[uy:uy + units, ux:ux + units].copy()
        f.luma_dir[uy:uy + units, ux:ux + units] = mode
        curr_ctx, curr_frac = self.snap[depth][CI_CURR_BEST]
        self.go_on.ctx[cc.O_INTRA_PRED] = curr_ctx[cc.O_INTRA_PRED]
        self.go_on.frac_bits = curr_frac
        self.go_on.reset_bits()
        self.w.code_intra_dir_luma(part, multiple=False)
        bits = self.go_on.num_written_bits
        f.luma_dir[uy:uy + units, ux:ux + units] = saved
        return bits

    @staticmethod
    def _update_cand_list(mode, cost, cand_modes, cand_costs) -> int:
        n = len(cand_costs)
        shift = 0
        while shift < n and cost < cand_costs[n - 1 - shift]:
            shift += 1
        if shift:
            for i in range(1, shift):
                cand_modes[n - i] = cand_modes[n - 1 - i]
                cand_costs[n - i] = cand_costs[n - 1 - i]
            cand_modes[n - shift] = mode
            cand_costs[n - shift] = cost
            return 1
        return 0

    # -- reference sample helpers ------------------------------------------
    def _adi_lines_luma(self, px, py, size):
        dc = 1 << (self.bit_depth - 1)
        flags = _tu_availability_flags(self.f, px // 4, py // 4, size // 4)
        line = intra_ops.fill_reference_line(self.rec_y, px, py, size, 4,
                                             flags, dc)
        return line, intra_ops.smooth_reference_line(line, size, 4)

    def _adi_line_chroma(self, cx, cy, size, comp):
        dc = 1 << (self.bit_depth - 1)
        flags = _tu_availability_flags(self.f, cx // 2, cy // 2, size // 2)
        plane = self.rec_cb if comp == 1 else self.rec_cr
        return intra_ops.fill_reference_line(plane, cx, cy, size, 2, flags, dc)

    # ------------------------------------------------------------------
    # xRecurIntraCodingQT (bLumaOnly=true)
    # ------------------------------------------------------------------
    def _recur_intra_luma(self, part: int, cu_depth: int, tr_depth: int,
                          check_first: bool):
        f = self.f
        sps = self.sps
        full_depth = cu_depth + tr_depth
        log2_tr = self._log2_ctu() - full_depth
        check_full = log2_tr <= sps.quadtree_tu_log2_max_size
        check_split = log2_tr > self._min_tu_log2_in_cu(part)
        if check_first and check_full:
            check_split = False

        single_cost = MAX_DOUBLE
        single_dist = 0
        single_cbf = 0
        best_mode_id = 0

        ux, uy = self._unit_xy(part)
        units = f.units_per_row >> full_depth
        check_ts = (self.pps.use_transform_skip
                    and (f.ctu_size >> full_depth) == 4
                    and not f.tq_bypass[uy, ux])
        if self.cfg.get("TransformSkipFast", 1):
            check_ts = check_ts and \
                int(f.part_size_arr[uy, ux]) == SIZE_NxN

        if check_full:
            if check_ts:
                self._store(full_depth, CI_QT_TRAFO_ROOT)
                best_tmp = None
                for mode_id in (0, 1):
                    f.ts_flag[0, uy:uy + units, ux:ux + units] = bool(mode_id)
                    d0s1l2 = 1 if mode_id == 0 else 2
                    dist_tmp = self._intra_coding_luma_blk(
                        part, cu_depth, tr_depth, d0s1l2)
                    cbf_tmp = self._cbf(part, 0, tr_depth)
                    if mode_id == 1 and cbf_tmp == 0:
                        cost_tmp = MAX_DOUBLE
                    else:
                        bits_tmp = self._intra_bits_qt(part, cu_depth,
                                                       tr_depth)
                        cost_tmp = self.rd.calc_rd_cost(bits_tmp, dist_tmp)
                        if TSDBG:
                            TSDBG.write(
                                f"TSDBG cu={self.ctu_addr} part={part} "
                                f"mode={mode_id} dist={dist_tmp} "
                                f"bits={bits_tmp} cost={cost_tmp:.4f}\n")
                    if cost_tmp < single_cost:
                        single_cost = cost_tmp
                        single_dist = dist_tmp
                        single_cbf = cbf_tmp
                        best_mode_id = mode_id
                        if mode_id == 0:
                            best_tmp = self._store_tu_result(part, full_depth,
                                                             "y")
                            self._store(full_depth, CI_TEMP_BEST)
                    if mode_id == 0:
                        self._load(full_depth, CI_QT_TRAFO_ROOT)
                f.ts_flag[0, uy:uy + units, ux:ux + units] = bool(best_mode_id)
                if best_mode_id == 0:
                    self._load_tu_result(part, full_depth, "y", best_tmp)
                    f.cbf[0, uy:uy + units, ux:ux + units] = \
                        single_cbf << tr_depth
                    self._load(full_depth, CI_TEMP_BEST)
            else:
                f.ts_flag[0, uy:uy + units, ux:ux + units] = False
                if check_split:
                    self._store(full_depth, CI_QT_TRAFO_ROOT)
                single_dist = self._intra_coding_luma_blk(part, cu_depth,
                                                          tr_depth, 0)
                if check_split:
                    single_cbf = self._cbf(part, 0, tr_depth)
                bits = self._intra_bits_qt(part, cu_depth, tr_depth)
                single_cost = self.rd.calc_rd_cost(bits, single_dist)

        if check_split:
            if check_full:
                self._store(full_depth, CI_QT_TRAFO_TEST)
                self._load(full_depth, CI_QT_TRAFO_ROOT)
            else:
                self._store(full_depth, CI_QT_TRAFO_ROOT)
            split_dist = 0
            q_parts = f.parts_per_ctu >> ((full_depth + 1) << 1)
            split_cbf = 0
            sub = part
            for i in range(4):
                d_, _ = self._recur_intra_luma(sub, cu_depth, tr_depth + 1,
                                               check_first)
                split_dist += d_
                split_cbf |= self._cbf(sub, 0, tr_depth + 1)
                sub += q_parts
            if split_cbf:
                f.cbf[0, uy:uy + units, ux:ux + units] |= split_cbf << tr_depth
            self._load(full_depth, CI_QT_TRAFO_ROOT)
            split_bits = self._intra_bits_qt(part, cu_depth, tr_depth)
            split_cost = self.rd.calc_rd_cost(split_bits, split_dist)
            if split_cost < single_cost:
                return split_dist, split_cost
            # single wins: restore coder, TU structure, and frame recon
            self._load(full_depth, CI_QT_TRAFO_TEST)
            f.tr_idx[uy:uy + units, ux:ux + units] = tr_depth
            f.cbf[0, uy:uy + units, ux:ux + units] = single_cbf << tr_depth
            f.ts_flag[0, uy:uy + units, ux:ux + units] = bool(best_mode_id)
            self._qt_to_frame(part, full_depth, "y")
        return single_dist, single_cost

    def _min_tu_log2_in_cu(self, part: int) -> int:
        """getQuadtreeTULog2MinSizeInCU (TComDataCU.cpp)."""
        f = self.f
        sps = self.sps
        ux, uy = self._unit_xy(part)
        depth = int(f.depth[uy, ux])
        log2_cb = self._log2_ctu() - depth
        part_sz = int(f.part_size_arr[uy, ux])
        is_intra = f.pred_mode[uy, ux] == MODE_INTRA
        intra_split = 1 if (is_intra and part_sz == SIZE_NxN) else 0
        inter_split = 1 if (not is_intra
                            and sps.quadtree_tu_max_depth_inter == 1
                            and part_sz != SIZE_2Nx2N) else 0
        max_tu_depth = (sps.quadtree_tu_max_depth_intra if is_intra
                        else sps.quadtree_tu_max_depth_inter)
        if log2_cb < (sps.quadtree_tu_log2_min_size + max_tu_depth - 1
                      + intra_split + inter_split):
            return sps.quadtree_tu_log2_min_size
        v = log2_cb - (max_tu_depth - 1 + intra_split + inter_split)
        return min(v, sps.quadtree_tu_log2_max_size)

    def _qt_layer(self, full_depth: int) -> int:
        return self.sps.quadtree_tu_log2_max_size - \
            (self._log2_ctu() - full_depth)

    # QT-buffer <-> TU-store helpers (xStoreIntraResultQT/xLoadIntraResultQT)
    def _chroma_tu_size(self, full_depth: int) -> int:
        """Chroma block size for a TU: bChromaSame keeps 4x4 when the luma
        TU is 4x4 (xStoreIntraResultQT:1828-1834)."""
        lsize = self.f.ctu_size >> full_depth
        return lsize if lsize == 4 else lsize // 2

    def _store_tu_result(self, part: int, full_depth: int, plane: str) -> dict:
        size = self.f.ctu_size >> full_depth
        layer = self._qt_layer(full_depth)
        lx, ly = self._ctu_local(part)
        if plane != "y":
            size = self._chroma_tu_size(full_depth)
            lx, ly = lx // 2, ly // 2
        return dict(
            rec=self.qt_rec[layer][plane][ly:ly + size, lx:lx + size].copy(),
            coeff=self.qt_coeff[layer][plane][ly:ly + size,
                                              lx:lx + size].copy())

    def _load_tu_result(self, part: int, full_depth: int, plane: str,
                        store: dict) -> None:
        f = self.f
        size = f.ctu_size >> full_depth
        px, py = self._pel_xy(part)
        layer = self._qt_layer(full_depth)
        lx, ly = self._ctu_local(part)
        if plane != "y":
            size = self._chroma_tu_size(full_depth)
            px, py = px // 2, py // 2
            lx, ly = lx // 2, ly // 2
        self.qt_rec[layer][plane][ly:ly + size, lx:lx + size] = store["rec"]
        self.qt_coeff[layer][plane][ly:ly + size, lx:lx + size] = store["coeff"]
        rec_plane = {"y": self.rec_y, "cb": self.rec_cb,
                     "cr": self.rec_cr}[plane]
        coeff_plane = {"y": f.coeff_y, "cb": f.coeff_cb,
                       "cr": f.coeff_cr}[plane]
        rec_plane[py:py + size, px:px + size] = store["rec"]
        coeff_plane[py:py + size, px:px + size] = store["coeff"]

    def _qt_to_frame(self, part: int, full_depth: int, plane: str) -> None:
        f = self.f
        size = f.ctu_size >> full_depth
        px, py = self._pel_xy(part)
        layer = self._qt_layer(full_depth)
        lx, ly = self._ctu_local(part)
        if plane != "y":
            size = self._chroma_tu_size(full_depth)
            px, py = px // 2, py // 2
            lx, ly = lx // 2, ly // 2
        rec_plane = {"y": self.rec_y, "cb": self.rec_cb,
                     "cr": self.rec_cr}[plane]
        coeff_plane = {"y": f.coeff_y, "cb": f.coeff_cb,
                       "cr": f.coeff_cr}[plane]
        rec_plane[py:py + size, px:px + size] = \
            self.qt_rec[layer][plane][ly:ly + size, lx:lx + size]
        coeff_plane[py:py + size, px:px + size] = \
            self.qt_coeff[layer][plane][ly:ly + size, lx:lx + size]

    # ------------------------------------------------------------------
    def _intra_coding_luma_blk(self, part: int, cu_depth: int, tr_depth: int,
                               d0s1l2: int = 0) -> int:
        """xIntraCodingLumaBlk (TEncSearch.cpp:1006)."""
        f = self.f
        full_depth = cu_depth + tr_depth
        size = f.ctu_size >> full_depth
        px, py = self._pel_xy(part)
        ux, uy = self._unit_xy(part)
        units = f.units_per_row >> full_depth
        mode = int(f.luma_dir[uy, ux])
        use_ts = bool(f.ts_flag[0, uy, ux])
        log2 = size.bit_length() - 1

        if d0s1l2 != 2:
            line_raw, line_filt = self._adi_lines_luma(px, py, size)
            line = (line_filt if intra_ops.use_filtered(mode, log2, True)
                    else line_raw)
            pred = intra_ops.predict(line, size, 4, mode, True, self.max_val)
            if d0s1l2 == 1:
                self.shared_pred[0][:size, :size] = pred
        else:
            pred = self.shared_pred[0][:size, :size]

        org = self.org_y[py:py + size, px:px + size].astype(np.int32)
        resi = org - pred

        f.tr_idx[uy:uy + units, ux:ux + units] = tr_depth

        qps = tops.qp_scaled(int(f.qp[uy, ux]), True, self.sps.qp_bd_offset_y)
        levels, abs_sum = self._xform_quant(part, resi, size, qps, True, 0,
                                            use_ts, tr_depth)

        cbf = 1 if abs_sum else 0
        f.cbf[0, uy:uy + units, ux:ux + units] = cbf << tr_depth

        if abs_sum:
            if f.tq_bypass[uy, ux]:
                resi_rec = levels      # invtransformNxN bypass
            elif use_ts:
                deq = self._dequant(levels, qps, size, 0, True)
                resi_rec = tops.transform_skip_inv(deq[None], self.bit_inc)[0]
            else:
                deq = self._dequant(levels, qps, size, 0, True)
                resi_rec = tops.inverse_transform(
                    deq[None], use_dst=(size == 4),
                    bit_increment=self.bit_inc)[0]
        else:
            levels = np.zeros((size, size), np.int32)
            resi_rec = 0

        rec = np.clip(pred + resi_rec, 0, self.max_val).astype(np.int16)
        layer = self._qt_layer(full_depth)
        lx, ly = self._ctu_local(part)
        self.qt_rec[layer]["y"][ly:ly + size, lx:lx + size] = rec
        self.qt_coeff[layer]["y"][ly:ly + size, lx:lx + size] = levels
        self.rec_y[py:py + size, px:px + size] = rec
        f.coeff_y[py:py + size, px:px + size] = levels

        return self.rd.dist_part(rec, self.org_y[py:py + size, px:px + size])

    def _dequant(self, levels, qps, size, comp, is_intra):
        """xDeQuant dispatch: scaling-list path when matrices are active."""
        if self.scaling is not None:
            deq_tab = self.scaling.tables_for(size, qps, is_intra, comp)[0]
            return scaling_mod.dequant_with_list(
                levels, deq_tab, qps, size.bit_length() - 1, self.bit_inc)
        return tops.dequant(levels[None], qps, self.bit_inc)[0]

    def _xform_quant(self, part, resi, size, qps, is_luma, comp, use_ts,
                     cbf_tr_depth, is_intra=True):
        """transformNxN: forward transform + RDOQ/quant (+ SBH)."""
        ux, uy = self._unit_xy(part)
        if self.f.tq_bypass[uy, ux]:
            # lossless CU: coefficients carry the raw residual
            # (TComTrQuant.cpp:1388-1400)
            levels = resi.astype(np.int32)
            return levels, int(np.abs(levels).sum())
        per, rem = qps // 6, qps % 6
        scan_idx = self.w._scan_idx(part, size, is_luma)
        if scan_idx == rom.SCAN_ZIGZAG:
            scan_idx = rom.SCAN_DIAG
        if use_ts:
            coeff_t = tops.transform_skip_fwd(resi[None], self.bit_inc)[0]
        else:
            coeff_t = tops.forward_transform(
                resi[None], use_dst=(is_luma and size == 4 and is_intra),
                bit_increment=self.bit_inc)[0]
        # xQuant: RDOQ unless (TransformSkipFast && transformSkip)
        use_rdoq = self.cfg.get("RDOQ", 1) and not (
            self.cfg.get("TransformSkipFast", 1) and use_ts)
        quant_tab = err_tab = None
        if self.scaling is not None:
            comp_idx = 0 if is_luma else comp
            _deq, quant_tab, err_tab = self.scaling.tables_for(
                size, qps, is_intra, comp_idx)
        if use_rdoq:
            eb = build_est_bits(self.go_on.ctx, size, is_luma)
            lam = self.lambda_luma if is_luma else self.lambda_chroma
            levels, abs_sum = rdoq_mod.rdoq(
                coeff_t, size, per, rem, lam, is_luma, is_intra, scan_idx,
                eb, cbf_tr_depth, self.pps.sign_hide_flag, self.bit_inc,
                quant_tab=quant_tab, err_tab=err_tab)
            return levels.reshape(size, size), abs_sum
        # ADAPTIVE_QP_SELECTION (compiled in the reference): the plain
        # quantizer's shift uses the slice base QP's per, the scale table
        # the CU QP's rem (TComTrQuant.cpp:1162-1232)
        base_qps = tops.qp_scaled(self.sh.slice_qp, True,
                                  self.sps.qp_bd_offset_y) if is_luma else \
            tops.qp_scaled(self.sh.slice_qp, False, self.sps.qp_bd_offset_c)
        if quant_tab is not None:
            levels, du0 = scaling_mod.quant_with_list(
                coeff_t, quant_tab, base_qps // 6, size.bit_length() - 1,
                self.sh.slice_type == I_SLICE, self.bit_inc)
            abs_sum = int(np.abs(levels).sum())
            if self.pps.sign_hide_flag and abs_sum >= 2:
                levels = self._sign_bit_hiding(levels, coeff_t, du0,
                                               scan_idx, size)
            return levels, abs_sum
        lv, du = tops.quant(coeff_t[None], qps,
                            self.sh.slice_type == I_SLICE, self.bit_inc,
                            qp_base=base_qps)
        levels = lv[0]
        # xQuant returns the PRE-sign-bit-hiding absolute sum (uiAcSum is
        # accumulated before signBitHidingHDQ runs)
        abs_sum = int(np.abs(levels).sum())
        if self.pps.sign_hide_flag and abs_sum >= 2:
            levels = self._sign_bit_hiding(levels, coeff_t, du[0], scan_idx,
                                           size)
        return levels, abs_sum

    def _sign_bit_hiding(self, levels, src_coeff, delta_u, scan_idx, size):
        """signBitHidingHDQ (TComTrQuant.cpp) for the non-RDOQ path."""
        q = levels.reshape(-1).copy()
        src = src_coeff.reshape(-1)
        du = delta_u.reshape(-1)
        scan = rom.sig_last_scan(scan_idx, size)
        last_cg = -1
        for subset in range((size * size - 1) >> 4, -1, -1):
            sub_pos = subset << 4
            first_nz, last_nz = 16, -1
            for n in range(15, -1, -1):
                if q[int(scan[n + sub_pos])]:
                    last_nz = n
                    break
            for n in range(16):
                if q[int(scan[n + sub_pos])]:
                    first_nz = n
                    break
            s = 0
            for n in range(first_nz, last_nz + 1):
                s += int(q[int(scan[n + sub_pos])])
            if last_nz >= 0 and last_cg == -1:
                last_cg = 1
            if last_nz - first_nz >= 4:
                signbit = 0 if q[int(scan[sub_pos + first_nz])] > 0 else 1
                if signbit != (s & 1):
                    min_cost = 1 << 62
                    min_pos = -1
                    final_change = 0
                    start_n = last_nz if last_cg == 1 else 15
                    for n in range(start_n, -1, -1):
                        blk = int(scan[n + sub_pos])
                        if q[blk] != 0:
                            if du[blk] > 0:
                                cur_cost, cur_change = -int(du[blk]), 1
                            elif n == first_nz and abs(int(q[blk])) == 1:
                                cur_cost, cur_change = 1 << 62, 0
                            else:
                                cur_cost, cur_change = int(du[blk]), -1
                        else:
                            if n < first_nz:
                                this_sign = 0 if src[blk] >= 0 else 1
                                if this_sign != signbit:
                                    cur_cost, cur_change = 1 << 62, 0
                                else:
                                    cur_cost, cur_change = -int(du[blk]), 1
                            else:
                                cur_cost, cur_change = -int(du[blk]), 1
                        if cur_cost < min_cost:
                            min_cost = cur_cost
                            final_change = cur_change
                            min_pos = blk
                    if q[min_pos] == 32767 or q[min_pos] == -32768:
                        final_change = -1
                    if src[min_pos] >= 0:
                        q[min_pos] += final_change
                    else:
                        q[min_pos] -= final_change
            if last_cg == 1:
                last_cg = 0
        return q.reshape(size, size)

    # ------------------------------------------------------------------
    # bit counting (xGetIntraBitsQT / xGetIntraBitsQTChroma)
    # ------------------------------------------------------------------
    def _intra_bits_qt(self, part: int, cu_depth: int, tr_depth: int,
                       chroma: bool = False) -> int:
        self.go_on.reset_bits()
        if not chroma:
            self._enc_intra_header(part, cu_depth, tr_depth, luma=True)
            self._enc_subdiv_cbf_qt(part, cu_depth, tr_depth, luma=True,
                                    chroma=False)
            self._enc_coeff_qt(part, cu_depth, tr_depth, comp=0)
        else:
            self._enc_intra_header(part, cu_depth, tr_depth, luma=False)
            self._enc_subdiv_cbf_qt(part, cu_depth, tr_depth, luma=False,
                                    chroma=True)
            self._enc_coeff_qt(part, cu_depth, tr_depth, comp=1)
            self._enc_coeff_qt(part, cu_depth, tr_depth, comp=2)
        return self.go_on.num_written_bits

    def _intra_bits_qt_chroma(self, part, cu_depth, tr_depth, comp) -> int:
        self.go_on.reset_bits()
        self._enc_coeff_qt(part, cu_depth, tr_depth, comp=comp)
        return self.go_on.num_written_bits

    def _enc_intra_header(self, part, cu_depth, tr_depth, luma: bool) -> None:
        """xEncIntraHeader (TEncSearch.cpp:890); part is CTU-absolute while
        the reference's uiAbsPartIdx is CU-relative — converted here."""
        f = self.f
        w = self.w
        cu_parts = f.parts_per_ctu >> (cu_depth << 1)
        cu_start = (part // cu_parts) * cu_parts
        in_cu = part - cu_start
        cux, cuy = self._unit_xy(cu_start)
        part_sz = int(f.part_size_arr[cuy, cux])
        if luma:
            if in_cu == 0:
                if self.sh.slice_type != I_SLICE:
                    if self.pps.transquant_bypass_enable_flag:
                        w.code_tq_bypass(cu_start)
                    w.code_skip_flag(cu_start)
                    w.code_pred_mode(cu_start)
                w.code_part_size(cu_start, cu_depth)
                if part_sz == SIZE_2Nx2N and self.sps.use_pcm and \
                        (1 << self.sps.pcm_log2_min_size) <= \
                        (f.ctu_size >> cu_depth) <= \
                        (1 << self.sps.pcm_log2_max_size):
                    w.code_terminating_bit(0)  # pcm_flag (always 0 here)
            if part_sz == SIZE_2Nx2N:
                if in_cu == 0:
                    w.code_intra_dir_luma(cu_start, multiple=False)
            else:
                q_parts = cu_parts >> 2
                if tr_depth == 0:
                    for p in range(4):
                        w.code_intra_dir_luma(cu_start + p * q_parts,
                                              multiple=False)
                elif in_cu % q_parts == 0:
                    w.code_intra_dir_luma(part, multiple=False)
        else:
            if in_cu == 0:
                w.code_intra_dir_chroma(cu_start)

    def _enc_subdiv_cbf_qt(self, part, cu_depth, tr_depth, luma, chroma):
        """xEncSubdivCbfQT (TEncSearch.cpp:763)."""
        f = self.f
        w = self.w
        ux, uy = self._unit_xy(part)
        full_depth = cu_depth + tr_depth
        tr_mode = int(f.tr_idx[uy, ux])
        subdiv = 1 if tr_mode > tr_depth else 0
        log2_tr = self._log2_ctu() - full_depth
        part_sz = int(f.part_size_arr[uy, ux])
        if f.pred_mode[uy, ux] == MODE_INTRA and part_sz == SIZE_NxN \
                and tr_depth == 0:
            pass
        elif log2_tr > self.sps.quadtree_tu_log2_max_size:
            pass
        elif log2_tr == self.sps.quadtree_tu_log2_min_size:
            pass
        elif log2_tr == self._min_tu_log2_in_cu(part):
            pass
        elif luma:
            w.code_transform_subdiv(subdiv, log2_tr)
        if chroma and log2_tr > 2:
            if tr_depth == 0 or self._cbf(part, 1, tr_depth - 1):
                w.code_qt_cbf(part, 1, tr_depth)
            if tr_depth == 0 or self._cbf(part, 2, tr_depth - 1):
                w.code_qt_cbf(part, 2, tr_depth)
        if subdiv:
            q_parts = f.parts_per_ctu >> ((full_depth + 1) << 1)
            for p in range(4):
                self._enc_subdiv_cbf_qt(part + p * q_parts, cu_depth,
                                        tr_depth + 1, luma, chroma)
            return
        if luma:
            w.code_qt_cbf(part, 0, tr_mode)

    def _enc_coeff_qt(self, part, cu_depth, tr_depth, comp) -> None:
        """xEncCoeffQT (TEncSearch.cpp:836)."""
        f = self.f
        ux, uy = self._unit_xy(part)
        full_depth = cu_depth + tr_depth
        tr_mode = int(f.tr_idx[uy, ux])
        if tr_mode > tr_depth:
            q_parts = f.parts_per_ctu >> ((full_depth + 1) << 1)
            for p in range(4):
                self._enc_coeff_qt(part + p * q_parts, cu_depth, tr_depth + 1,
                                   comp)
            return
        log2_tr = self._log2_ctu() - full_depth
        td = tr_depth
        if comp != 0 and log2_tr == 2:
            td -= 1
            q_div = f.parts_per_ctu >> ((cu_depth + td) << 1)
            if part % q_div != 0:
                return
        if not self._cbf(part, comp, tr_mode):
            return
        px, py = self._pel_xy(part)
        size = f.ctu_size >> (cu_depth + td)
        if comp == 0:
            coeff = f.coeff_y[py:py + size, px:px + size]
        else:
            size //= 2
            plane = f.coeff_cb if comp == 1 else f.coeff_cr
            coeff = plane[py // 2:py // 2 + size, px // 2:px // 2 + size]
        self.w.code_coeff_nxn(part, coeff, size, comp)

    # ==================================================================
    # Chroma search (estIntraPredChromaQT :2806)
    # ==================================================================
    def _est_intra_chroma(self, abs_part: int, depth: int) -> int:
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        units = f.units_per_row >> depth
        mode_list = f.allowed_chroma_dirs(ux, uy)
        best_mode = 0
        best_dist = 0
        best_cost = MAX_DOUBLE
        best_store = None
        for mode in mode_list:
            self._load(depth, CI_CURR_BEST)
            f.chroma_dir[uy:uy + units, ux:ux + units] = mode
            dist = self._recur_intra_chroma(abs_part, depth, 0)
            if self.pps.use_transform_skip:
                self._load(depth, CI_CURR_BEST)
            bits = self._intra_bits_qt(abs_part, depth, 0, chroma=True)
            cost = self.rd.calc_rd_cost(bits, dist)
            if TSDBG:
                px_, py_ = self._pel_xy(abs_part)
                TSDBG.write(f"CHRDBG cu={self.ctu_addr} xy={px_},{py_} "
                            f"w={self.f.ctu_size >> depth} "
                            f"luma0={int(self.f.luma_dir[uy, ux])} "
                            f"mode={mode} "
                            f"dist={dist} bits={bits} cost={cost:.4f}\n")
            if cost < best_cost:
                best_cost = cost
                best_dist = dist
                best_mode = mode
                best_store = self._save_chroma_result(abs_part, depth)
        self._restore_chroma_result(abs_part, depth, best_store)
        f.chroma_dir[uy:uy + units, ux:ux + units] = best_mode
        self._load(depth, CI_CURR_BEST)
        return best_dist

    def _save_chroma_result(self, abs_part, depth) -> dict:
        f = self.f
        px, py = self._pel_xy(abs_part)
        ux, uy = self._unit_xy(abs_part)
        units = f.units_per_row >> depth
        cs = (f.ctu_size >> depth) // 2
        return dict(
            cbf=f.cbf[1:3, uy:uy + units, ux:ux + units].copy(),
            ts=f.ts_flag[1:3, uy:uy + units, ux:ux + units].copy(),
            coeff_cb=f.coeff_cb[py // 2:py // 2 + cs,
                                px // 2:px // 2 + cs].copy(),
            coeff_cr=f.coeff_cr[py // 2:py // 2 + cs,
                                px // 2:px // 2 + cs].copy(),
            rec_cb=self.rec_cb[py // 2:py // 2 + cs,
                               px // 2:px // 2 + cs].copy(),
            rec_cr=self.rec_cr[py // 2:py // 2 + cs,
                               px // 2:px // 2 + cs].copy())

    def _restore_chroma_result(self, abs_part, depth, store) -> None:
        f = self.f
        px, py = self._pel_xy(abs_part)
        ux, uy = self._unit_xy(abs_part)
        units = f.units_per_row >> depth
        cs = (f.ctu_size >> depth) // 2
        f.cbf[1:3, uy:uy + units, ux:ux + units] = store["cbf"]
        f.ts_flag[1:3, uy:uy + units, ux:ux + units] = store["ts"]
        f.coeff_cb[py // 2:py // 2 + cs, px // 2:px // 2 + cs] = \
            store["coeff_cb"]
        f.coeff_cr[py // 2:py // 2 + cs, px // 2:px // 2 + cs] = \
            store["coeff_cr"]
        self.rec_cb[py // 2:py // 2 + cs, px // 2:px // 2 + cs] = \
            store["rec_cb"]
        self.rec_cr[py // 2:py // 2 + cs, px // 2:px // 2 + cs] = \
            store["rec_cr"]

    def _recur_intra_chroma(self, part: int, cu_depth: int,
                            tr_depth: int) -> int:
        """xRecurIntraChromaCodingQT (TEncSearch.cpp:2160)."""
        f = self.f
        ux, uy = self._unit_xy(part)
        full_depth = cu_depth + tr_depth
        tr_mode = int(f.tr_idx[uy, ux])
        dist = 0
        if tr_mode == tr_depth:
            log2_tr = self._log2_ctu() - full_depth
            actual_td = tr_depth
            if log2_tr == 2:
                actual_td -= 1
                q_div = f.parts_per_ctu >> ((cu_depth + actual_td) << 1)
                if part % q_div != 0:
                    return 0
            # checkTransformSkip is computed before the bFirstQ gate in the
            # reference (reading past the CU for non-first parts, value
            # discarded); evaluated here only where it is used
            check_ts = self.pps.use_transform_skip and log2_tr <= 3
            if self.cfg.get("TransformSkipFast", 1):
                # INTRA_TRANSFORMSKIP_FAST: 4x4 only + >=1 luma TS block
                check_ts = check_ts and log2_tr < 3
                if check_ts:
                    n_skip = 0
                    for sub in range(part, part + 4):
                        sux, suy = self._unit_xy(sub)
                        n_skip += int(f.ts_flag[0, suy, sux])
                    check_ts = check_ts and n_skip > 0
            if TSDBG:
                px_, py_ = self._pel_xy(part)
                TSDBG.write(f"CTSDBG cu={self.ctu_addr} part={part} "
                            f"trd={tr_depth} ckts={int(check_ts)}\n")
            units_a = f.units_per_row >> (cu_depth + actual_td)
            if check_ts:
                self._store(full_depth, CI_QT_TRAFO_ROOT)
                for comp in (1, 2):
                    single_cost = MAX_DOUBLE
                    best_mode_id = 0
                    single_dist_c = 0
                    single_cbf_c = 0
                    best_tmp = None
                    for mode_id in (0, 1):
                        f.ts_flag[comp, uy:uy + units_a, ux:ux + units_a] = \
                            bool(mode_id)
                        d0s1l2 = 1 if mode_id == 0 else 2
                        dist_tmp = self._intra_coding_chroma_blk(
                            part, cu_depth, tr_depth, comp, d0s1l2)
                        cbf_tmp = self._cbf(part, comp, tr_depth)
                        if mode_id == 1 and cbf_tmp == 0:
                            cost_tmp = MAX_DOUBLE
                        else:
                            bits_tmp = self._intra_bits_qt_chroma(
                                part, cu_depth, tr_depth, comp)
                            cost_tmp = self.rd.calc_rd_cost(bits_tmp, dist_tmp)
                        if cost_tmp < single_cost:
                            single_cost = cost_tmp
                            single_dist_c = dist_tmp
                            best_mode_id = mode_id
                            single_cbf_c = cbf_tmp
                            if mode_id == 0:
                                best_tmp = self._store_tu_result(
                                    part, full_depth,
                                    "cb" if comp == 1 else "cr")
                                self._store(full_depth, CI_TEMP_BEST)
                        if mode_id == 0:
                            self._load(full_depth, CI_QT_TRAFO_ROOT)
                    if best_mode_id == 0:
                        self._load_tu_result(part, full_depth,
                                             "cb" if comp == 1 else "cr",
                                             best_tmp)
                        f.cbf[comp, uy:uy + units_a, ux:ux + units_a] = \
                            single_cbf_c << tr_depth
                        self._load(full_depth, CI_TEMP_BEST)
                    f.ts_flag[comp, uy:uy + units_a, ux:ux + units_a] = \
                        bool(best_mode_id)
                    dist += single_dist_c
                    if comp == 1:
                        self._store(full_depth, CI_QT_TRAFO_ROOT)
            else:
                f.ts_flag[1, uy:uy + units_a, ux:ux + units_a] = False
                f.ts_flag[2, uy:uy + units_a, ux:ux + units_a] = False
                dist += self._intra_coding_chroma_blk(part, cu_depth,
                                                      tr_depth, 1)
                dist += self._intra_coding_chroma_blk(part, cu_depth,
                                                      tr_depth, 2)
        else:
            q_parts = f.parts_per_ctu >> ((full_depth + 1) << 1)
            split_cbf_u = 0
            split_cbf_v = 0
            sub = part
            for p in range(4):
                dist += self._recur_intra_chroma(sub, cu_depth, tr_depth + 1)
                split_cbf_u |= self._cbf(sub, 1, tr_depth + 1)
                split_cbf_v |= self._cbf(sub, 2, tr_depth + 1)
                sub += q_parts
            units = f.units_per_row >> full_depth
            if split_cbf_u:
                f.cbf[1, uy:uy + units, ux:ux + units] |= \
                    split_cbf_u << tr_depth
            if split_cbf_v:
                f.cbf[2, uy:uy + units, ux:ux + units] |= \
                    split_cbf_v << tr_depth
        return dist

    def _intra_coding_chroma_blk(self, part, cu_depth, tr_depth, comp,
                                 d0s1l2: int = 0) -> int:
        """xIntraCodingChromaBlk (TEncSearch.cpp:1166)."""
        f = self.f
        org_tr_depth = tr_depth
        full_depth = cu_depth + tr_depth
        log2_tr = self._log2_ctu() - full_depth
        td = tr_depth
        if log2_tr == 2:
            td -= 1
            q_div = f.parts_per_ctu >> ((cu_depth + td) << 1)
            if part % q_div != 0:
                return 0
        ux, uy = self._unit_xy(part)
        size = (f.ctu_size >> cu_depth) >> (td + 1)
        px, py = self._pel_xy(part)
        cx, cy = px // 2, py // 2
        use_ts = bool(f.ts_flag[comp, uy, ux])

        cu_parts = f.parts_per_ctu >> (cu_depth << 1)
        cu_start = (part // cu_parts) * cu_parts
        cux, cuy = self._unit_xy(cu_start)
        mode = int(f.chroma_dir[uy, ux])
        if mode == DM_CHROMA_IDX:
            mode = int(f.luma_dir[cuy, cux])

        if d0s1l2 != 2:
            line = self._adi_line_chroma(cx, cy, size, comp)
            pred = intra_ops.predict(line, size, 2, mode, False, self.max_val)
            if d0s1l2 == 1:
                self.shared_pred[comp][:size, :size] = pred
        else:
            pred = self.shared_pred[comp][:size, :size]

        org_plane = self.org_cb if comp == 1 else self.org_cr
        rec_plane = self.rec_cb if comp == 1 else self.rec_cr
        coeff_plane = f.coeff_cb if comp == 1 else f.coeff_cr

        org = org_plane[cy:cy + size, cx:cx + size].astype(np.int32)
        resi = org - pred

        qp_off = (self.pps.chroma_cb_qp_offset + self.sh.slice_qp_delta_cb
                  if comp == 1 else
                  self.pps.chroma_cr_qp_offset + self.sh.slice_qp_delta_cr)
        qps = tops.qp_scaled(int(f.qp[uy, ux]), False,
                             self.sps.qp_bd_offset_c, qp_off)

        # RDOQ's uncoded-cost cbf ctx uses getTransformIdx (undecremented)
        levels, abs_sum = self._xform_quant(part, resi, size, qps, False,
                                            comp, use_ts, org_tr_depth)

        units_td = f.units_per_row >> (cu_depth + td)
        cbf = 1 if abs_sum else 0
        # setCbfSubParts: bit at *original* trDepth, region at decremented
        f.cbf[comp, uy:uy + units_td, ux:ux + units_td] = cbf << org_tr_depth

        if abs_sum:
            if f.tq_bypass[uy, ux]:
                resi_rec = levels      # invtransformNxN bypass
            elif use_ts:
                deq = self._dequant(levels, qps, size, comp, True)
                resi_rec = tops.transform_skip_inv(deq[None], self.bit_inc)[0]
            else:
                deq = self._dequant(levels, qps, size, comp, True)
                resi_rec = tops.inverse_transform(
                    deq[None], use_dst=False, bit_increment=self.bit_inc)[0]
        else:
            levels = np.zeros((size, size), np.int32)
            resi_rec = 0

        rec = np.clip(pred + resi_rec, 0, self.max_val).astype(np.int16)
        if TSDBG:
            wts = np.arange(1, size * size + 1).reshape(size, size)
            TSDBG.write(
                f"CBDBG comp={comp - 1} part={part} w={size} mode={mode} "
                f"predsum={int((pred * wts).sum())} "
                f"coefsum={int((levels * wts).sum())} "
                f"dist={self.rd.dist_part(rec, org_plane[cy:cy + size, cx:cx + size], weighted=True)}\n")
        layer = self._qt_layer(full_depth)
        lx, ly = self._ctu_local(part)
        pl = "cb" if comp == 1 else "cr"
        self.qt_rec[layer][pl][ly // 2:ly // 2 + size,
                               lx // 2:lx // 2 + size] = rec
        self.qt_coeff[layer][pl][ly // 2:ly // 2 + size,
                                 lx // 2:lx // 2 + size] = levels
        rec_plane[cy:cy + size, cx:cx + size] = rec
        coeff_plane[cy:cy + size, cx:cx + size] = levels
        return self.rd.dist_part(rec, org_plane[cy:cy + size, cx:cx + size],
                                 weighted=True)

    # ==================================================================
    # Final syntax pass (encodeCU :249 / xEncodeCU :1144 / finishCU :995)
    # ==================================================================
    def encode_ctu(self, ctu_addr: int, writer: SbacWriter) -> None:
        """One CTU of the final pass; writer carries the engine (real
        arithmetic coder in encodeSlice, counter in compressSlice)."""
        self.ctu_addr = ctu_addr
        writer.ctu_addr = ctu_addr
        if self.pps.use_dqp:
            writer.dqp_flag = True
        self._final_writer = writer
        self._encode_cu_final(0, 0)

    def _encode_cu_final(self, abs_part: int, depth: int) -> None:
        f = self.f
        w = self._final_writer
        px, py = self._pel_xy(abs_part)
        size = f.ctu_size >> depth
        inside = (px + size <= f.width) and (py + size <= f.height)
        max_sig_depth = f.max_depth - self.sps.add_cu_depth
        ux, uy = self._unit_xy(abs_part)
        # burst IPCM state (TEncCu.cpp:1154-1157): a burst member's split/
        # skip/pred/part-size syntax is covered by the burst count
        last_suc = num_suc = 0
        if self.sps.use_pcm:
            last_suc = self._check_last_cu_suc_ipcm(abs_part)
            num_suc = self._count_num_suc_ipcm(abs_part)
        burst_member = last_suc and bool(f.ipcm[uy, ux])
        # dependent-slice range gates (TEncCu::xEncodeCU:1165-1191): a
        # byte/bin-budget violation updates the end address mid-CTU, and
        # the remaining CUs must not be encoded
        sh = self.sh
        scu_base = int(f.ctu_inv_order[self.ctu_addr]) * f.parts_per_ctu
        cur_parts = f.parts_per_ctu >> (depth << 1)
        slice_start_inside = (
            sh.dependent_slice_start_cu_addr > scu_base + abs_part
            and sh.dependent_slice_start_cu_addr <
            scu_base + abs_part + cur_parts)
        if inside and not slice_start_inside and not burst_member:
            w.code_split_flag(abs_part, depth)
        if (depth < int(f.depth[uy, ux]) and depth < max_sig_depth) \
                or not inside or slice_start_inside:
            if size == self._min_cu_dqp_size and self.pps.use_dqp:
                w.dqp_flag = True
            q_parts = (f.parts_per_ctu >> (depth << 1)) >> 2
            part = abs_part
            for i in range(4):
                spx, spy = self._pel_xy(part)
                in_slice = (scu_base + part + q_parts >
                            sh.dependent_slice_start_cu_addr
                            and scu_base + part <
                            sh.dependent_slice_end_cu_addr)
                if in_slice and spx < f.width and spy < f.height:
                    self._encode_cu_final(part, depth + 1)
                part += q_parts
            return
        if size >= self._min_cu_dqp_size and self.pps.use_dqp:
            w.dqp_flag = True
        if not burst_member:
            if self.pps.transquant_bypass_enable_flag:
                w.code_tq_bypass(abs_part)
            if self.sh.slice_type != I_SLICE:
                w.code_skip_flag(abs_part)
        if self.sh.slice_type != I_SLICE:
            if f.skip[uy, ux]:
                w.code_merge_index(abs_part)
                self._finish_cu_final(abs_part, depth)
                return
            if not burst_member:
                w.code_pred_mode(abs_part)
        if not burst_member:
            w.code_part_size(abs_part, depth)
        part_sz = int(f.part_size_arr[uy, ux])
        is_intra = f.pred_mode[uy, ux] == MODE_INTRA
        if is_intra and part_sz == SIZE_2Nx2N and self.sps.use_pcm and \
                (1 << self.sps.pcm_log2_min_size) <= size <= \
                (1 << self.sps.pcm_log2_max_size):
            # codeIPCMInfo (TEncSbac.cpp:1008) with burst semantics
            ipcm_flag = bool(f.ipcm[uy, ux])
            first = ipcm_flag and not last_suc
            if not ipcm_flag or first:
                w.code_terminating_bit(1 if ipcm_flag else 0)
                if first:
                    w.e.encode_num_subseq_ipcm(num_suc - 1)
                    w.e.encode_pcm_align_bits()
            if ipcm_flag:
                w.code_pcm_samples(abs_part, depth)
                if num_suc == 1:          # last burst member restarts CABAC
                    w.e.reset_bac()
                self._finish_cu_final(abs_part, depth, num_suc_ipcm=num_suc)
                return
        if is_intra:
            w.code_intra_dir_luma(abs_part, multiple=True)
            w.code_intra_dir_chroma(abs_part)
        else:
            self._final_code_pu_wise(abs_part, depth)
            merge_2nx2n = bool(f.merge_flag[uy, ux]) and \
                part_sz == SIZE_2Nx2N
            root_cbf = ((int(f.cbf[0, uy, ux]) | int(f.cbf[1, uy, ux]) |
                         int(f.cbf[2, uy, ux])) & 1) != 0
            if not merge_2nx2n:
                w.code_qt_root_cbf(1 if root_cbf else 0)
            if not root_cbf:
                self._finish_cu_final(abs_part, depth)
                return
        self._final_transform_tree(abs_part, depth, 0)
        self._finish_cu_final(abs_part, depth)

    def _last_valid_part_idx(self, abs_part: int) -> int:
        """TComDataCU::getLastValidPartIdx (TComDataCU.cpp:1834)."""
        f = self.f
        last = abs_part - 1
        while last >= 0:
            lux, luy = self._unit_xy(last)
            if f.pred_mode[luy, lux] != 15:    # MODE_NONE
                break
            d = int(f.depth[luy, lux])
            last -= f.parts_per_ctu >> (d << 1)
        return last

    def _check_last_cu_suc_ipcm(self, abs_part: int) -> bool:
        """TEncCu::checkLastCUSucIPCM (TEncCu.cpp:1606): previous sibling
        at the same depth in the same slice is IPCM."""
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        cur_depth = int(f.depth[uy, ux])
        shift = (f.max_depth - cur_depth) << 1
        start_part = (abs_part & (0x03 << shift)) >> shift
        scu_base = int(f.ctu_inv_order[self.ctu_addr]) * f.parts_per_ctu
        if self.sh.dependent_slice_start_cu_addr == scu_base + abs_part:
            return False
        if cur_depth > 0 and start_part > 0:
            last = self._last_valid_part_idx(abs_part)
            if last >= 0:
                lux, luy = self._unit_xy(last)
                if (scu_base + last >= self.sh.slice_cur_start_cu_addr
                        and int(f.depth[luy, lux]) == cur_depth
                        and bool(f.ipcm[luy, lux])):
                    return True
        return False

    def _count_num_suc_ipcm(self, abs_part: int) -> int:
        """TEncCu::countNumSucIPCM (TEncCu.cpp:1645): length of the run of
        same-depth IPCM siblings starting at abs_part."""
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        if not f.ipcm[uy, ux]:
            return 0
        cur_depth = int(f.depth[uy, ux])
        if cur_depth == 0:
            return 1
        q_parts = (f.parts_per_ctu >> ((cur_depth - 1) << 1)) >> 2
        shift = (f.max_depth - cur_depth) << 1
        start_part = (abs_part & (0x03 << shift)) >> shift
        scu_base = int(f.ctu_inv_order[self.ctu_addr]) * f.parts_per_ctu
        dep_start = self.sh.dependent_slice_start_cu_addr
        dep_end = self.sh.dependent_slice_end_cu_addr
        n = 0
        part = abs_part
        for _ in range(start_part, 4):
            px, py = self._pel_xy(part)
            in_slice = (scu_base + part + q_parts > dep_start
                        and scu_base + part < dep_end)
            if in_slice and px < f.width and py < f.height:
                pux, puy = self._unit_xy(part)
                if int(f.depth[puy, pux]) == cur_depth and \
                        f.ipcm[puy, pux]:
                    n += 1
                else:
                    break
            part += q_parts
        return n

    def _final_code_pu_wise(self, abs_part: int, depth: int) -> None:
        """TEncEntropy::encodePUWise for the final pass."""
        from ..decoder.mv import PU_OFFSET, num_pus
        f = self.f
        w = self._final_writer
        ux, uy = self._unit_xy(abs_part)
        part_sz = int(f.part_size_arr[uy, ux])
        pu_off = (PU_OFFSET[part_sz] << ((f.max_depth - depth) << 1)) >> 4
        part = abs_part
        for pu in range(num_pus(part_sz)):
            pux, puy = self._unit_xy(part)
            w.code_merge_flag(part)
            if f.merge_flag[puy, pux]:
                w.code_merge_index(part)
            else:
                if self.sh.slice_type == 0:
                    w.code_inter_dir(part, depth)
                for lst in range(2):
                    if self.sh.num_ref_idx[lst] > 0:
                        if int(f.inter_dir[puy, pux]) & (1 << lst):
                            if self.sh.num_ref_idx[lst] > 1:
                                w.code_ref_idx(part, lst)
                            w.code_mvd(part, lst)
                            w.code_mvp_idx(part, lst)
            part += pu_off

    def _finish_cu_final(self, abs_part: int, depth: int,
                         num_suc_ipcm: int = 0) -> None:
        f = self.f
        sh = self.sh
        w = self._final_writer
        px, py = self._pel_xy(abs_part)
        size = f.ctu_size >> depth
        gran = f.ctu_size  # REMOVE_FGS: slice granularity = CTU
        gran_boundary = (
            ((px + size) % gran == 0 or (px + size) == f.width) and
            ((py + size) % gran == 0 or (py + size) == f.height))
        if gran_boundary and num_suc_ipcm <= 1:
            cur_parts = f.parts_per_ctu >> (depth << 1)
            # pcCU->getSCUAddr() is in encode (tile-scan) order
            scu = int(f.ctu_inv_order[self.ctu_addr]) * f.parts_per_ctu \
                + abs_part
            terminate = (scu + cur_parts == self._slice_end_scu())
            if not terminate:
                w.code_terminating_bit(0)

        # byte/bin-constrained slice-end recording (TEncCu.cpp:1047-1106);
        # active only during the counting compress pass (finalized=False,
        # engine is the fractional-bit counter = m_pcBitCounter non-null)
        eng = w.e
        counting = isinstance(eng, CounterEncoder)
        written = eng.num_written_bits if counting else 0
        if not sh.finalized and counting:
            parts = f.parts_per_ctu
            scu_abs = int(f.ctu_inv_order[self.ctu_addr]) * parts + abs_part
            gran_end = (scu_abs // parts) * parts
            if gran_end <= sh.dependent_slice_start_cu_addr:
                gran_end += max(parts, parts >> (depth << 1))
            if self.cfg.get("SliceMode", 0) == 2 and \
                    sh.slice_bits + written > \
                    (self.cfg.get("SliceArgument", 0) << 3):
                sh.dependent_slice_end_cu_addr = gran_end
                sh.slice_cur_end_cu_addr = gran_end
                return
            if self.cfg.get("DependentSliceMode", 0) == 2 and \
                    sh.dependent_slice_counter + eng.bins_coded > \
                    self.cfg.get("DependentSliceArgument", 0):
                sh.dependent_slice_end_cu_addr = gran_end
                return
        if gran_boundary and counting:
            sh.slice_bits += written
            sh.dependent_slice_counter += eng.bins_coded
            eng.bins_coded = 0
            eng.reset_bits()   # TEncSbac::resetBits: count=0, frac&=32767

    def _slice_end_scu(self) -> int:
        """finishCU's real-end-address computation (TEncCu.cpp:1000):
        the dependent-slice end address walked back past out-of-picture
        parts, in encode order."""
        f = self.f
        parts = f.parts_per_ctu
        end = getattr(self.sh, "dependent_slice_end_cu_addr", 0) \
            or self.sh.slice_cur_end_cu_addr
        raster = int(f.ctu_order[(end - 1) // parts]) * parts \
            + (end - 1) % parts
        internal = raster % parts
        external = raster // parts
        upr = f.units_per_row
        while True:
            r = int(f.z2r[internal])
            pos_x = (external % f.ctus_w) * f.ctu_size + (r % upr) * 4
            pos_y = (external // f.ctus_w) * f.ctu_size + (r // upr) * 4
            if pos_x < f.width and pos_y < f.height:
                break
            internal -= 1
        internal += 1
        if internal == parts:
            internal = 0
            nxt = int(f.ctu_inv_order[external]) + 1
            external = int(f.ctu_order[nxt]) if nxt < f.num_ctus \
                else f.num_ctus
        if external >= f.num_ctus:
            return f.num_ctus * parts
        return int(f.ctu_inv_order[external]) * parts + internal

    def _final_transform_tree(self, abs_part: int, depth: int,
                              tr_idx: int) -> None:
        """TEncEntropy::xEncodeTransform mirror over frame state."""
        f = self.f
        w = self._final_writer
        ux, uy = self._unit_xy(abs_part)
        log2_tr = self._log2_ctu() - depth
        if tr_idx == 0:
            self._bak_cu_part = abs_part
        if log2_tr == 2:
            pn = f.parts_per_ctu >> ((depth - 1) << 1)
            if abs_part % pn == 0:
                self._bak_chroma = abs_part
        cu_d = int(f.depth[uy, ux])
        tr_depth = depth - cu_d
        part_sz = int(f.part_size_arr[uy, ux])
        tr_mode = int(f.tr_idx[uy, ux])
        subdiv = 1 if tr_mode > tr_depth else 0

        if f.pred_mode[uy, ux] == MODE_INTRA and part_sz == SIZE_NxN \
                and depth == cu_d:
            pass
        elif f.pred_mode[uy, ux] != MODE_INTRA and part_sz != SIZE_2Nx2N \
                and depth == cu_d \
                and self.sps.quadtree_tu_max_depth_inter == 1:
            pass  # implicit inter split (xEncodeTransform)
        elif log2_tr > self.sps.quadtree_tu_log2_max_size:
            pass
        elif log2_tr == self.sps.quadtree_tu_log2_min_size:
            pass
        elif log2_tr == self._min_tu_log2_in_cu(abs_part):
            pass
        else:
            w.code_transform_subdiv(subdiv, log2_tr)

        first_cbf = tr_depth == 0
        if first_cbf or log2_tr > 2:
            if first_cbf or self._cbf(abs_part, 1, tr_depth - 1):
                w.code_qt_cbf(abs_part, 1, tr_depth)
            if first_cbf or self._cbf(abs_part, 2, tr_depth - 1):
                w.code_qt_cbf(abs_part, 2, tr_depth)

        if subdiv:
            q_parts = f.parts_per_ctu >> ((depth + 1) << 1)
            part = abs_part
            for i in range(4):
                self._final_transform_tree(part, depth + 1, tr_idx + 1)
                part += q_parts
            return

        # inter implicit luma cbf: at trDepth 0 with both chroma cbfs 0 the
        # luma cbf is inferred = 1 (xEncodeTransform)
        if not (f.pred_mode[uy, ux] != MODE_INTRA and depth == cu_d and
                not self._cbf(abs_part, 1, 0) and
                not self._cbf(abs_part, 2, 0)):
            w.code_qt_cbf(abs_part, 0, tr_mode)
        cbf_y = self._cbf(abs_part, 0, tr_idx)
        cbf_u = self._cbf(abs_part, 1, tr_idx)
        cbf_v = self._cbf(abs_part, 2, tr_idx)
        if log2_tr == 2:
            # last part re-reads from the bak part; others keep their own
            # read (uniform over the region anyway) — TEncEntropy.cpp:315-327
            pn = f.parts_per_ctu >> ((depth - 1) << 1)
            if abs_part % pn == pn - 1:
                bux, buy = self._unit_xy(self._bak_chroma)
                cbf_u = (int(f.cbf[1, buy, bux]) >> tr_idx) & 1
                cbf_v = (int(f.cbf[2, buy, bux]) >> tr_idx) & 1
        if (cbf_y or cbf_u or cbf_v) and self.pps.use_dqp and w.dqp_flag:
            w.code_delta_qp(self._bak_cu_part)
            w.dqp_flag = False
        size = 1 << log2_tr
        px, py = self._pel_xy(abs_part)
        if cbf_y:
            w.code_coeff_nxn(abs_part, f.coeff_y[py:py + size, px:px + size],
                             size, 0)
        if log2_tr > 2:
            cs = size // 2
            if cbf_u:
                w.code_coeff_nxn(abs_part,
                                 f.coeff_cb[py // 2:py // 2 + cs,
                                            px // 2:px // 2 + cs], cs, 1)
            if cbf_v:
                w.code_coeff_nxn(abs_part,
                                 f.coeff_cr[py // 2:py // 2 + cs,
                                            px // 2:px // 2 + cs], cs, 2)
        else:
            pn = f.parts_per_ctu >> ((depth - 1) << 1)
            if abs_part % pn == pn - 1:
                bpx, bpy = self._pel_xy(self._bak_chroma)
                if cbf_u:
                    w.code_coeff_nxn(self._bak_chroma,
                                     f.coeff_cb[bpy // 2:bpy // 2 + size,
                                                bpx // 2:bpx // 2 + size],
                                     size, 1)
                if cbf_v:
                    w.code_coeff_nxn(self._bak_chroma,
                                     f.coeff_cr[bpy // 2:bpy // 2 + size,
                                                bpx // 2:bpx // 2 + size],
                                     size, 2)

    # ------------------------------------------------------------------
    def _transform_tree(self, w, abs_part, depth, tr_idx) -> None:
        """encodeCoeff for the RD bit count (same walker, RD writer)."""
        saved = getattr(self, "_final_writer", None)
        self._final_writer = w
        try:
            self._final_transform_tree(abs_part, depth, tr_idx)
        finally:
            self._final_writer = saved
