"""Slice-data CABAC parsing: CTU quadtree, intra modes, transform tree,
coefficients, SAO parameters.

Behavioral reference: TDecSbac.cpp (parseSplitFlag :586, parsePartSize :608,
parseIntraDirLumaAng :673, parseIntraDirChroma :734, parseQtCbf :1013,
parseTransformSubdivFlag :920, parseDeltaQP :966, parseCoeffNxN :1133,
parseLastSignificantXY :1074, SAO :1533+), TDecEntropy.cpp (xDecodeTransform
:322, decodeCoeff :562), TDecCu.cpp (xDecodeCU :202, xDecodeSliceEnd :153),
TDecSlice.cpp (decompressSlice :93), and the sig-ctx helpers in
TComTrQuant.cpp (calcPatternSigCtx :2315, getSigCtxInc :2350,
getSigCoeffGroupCtxInc :2707).

This is the host-side sequential pass of the TPU decoder: it converts the
bitstream into frame-level syntax tensors (FrameModel) that the batched
device reconstruction consumes.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import InputBitstream
from ..cabac import contexts as cc
from ..cabac.engine import BinDecoder
from ..common import rom
from ..params import I_SLICE, Pps, SliceHeader, Sps
from .frame import (MODE_INTER, MODE_INTRA, SIZE_2Nx2N, SIZE_2NxN, SIZE_2NxnD,
                    SIZE_2NxnU, SIZE_NxN, SIZE_Nx2N, SIZE_nLx2N, SIZE_nRx2N,
                    DM_CHROMA_IDX, FrameModel)

SBH_THRESHOLD = 4
C1FLAG_NUMBER = 8
COEF_REMAIN_BIN_REDUCTION = 3
CU_DQP_TU_CMAX = 5
CU_DQP_EG_K = 0

# Optional syntax trace matching the reference's ENC_DEC_TRACE format
# (TComRom.h:195+); enables diffing against the traced oracle decoder.
TRACE = None


def _trace(msg: str) -> None:
    if TRACE is not None:
        TRACE.write(msg + "\n")


class SbacParser:
    """Syntax-level CABAC reader bound to a context array and bin decoder."""

    def __init__(self, dec: BinDecoder):
        self.dec = dec

    # -- primitives ---------------------------------------------------------
    def unary_max(self, ctx_indices, max_symbol: int) -> int:
        """xReadUnaryMaxSymbol: ctx_indices[0] for first bin, [1] for rest."""
        if max_symbol == 0:
            return 0
        sym = self.dec.decode_bin(ctx_indices[0])
        if sym == 0 or max_symbol == 1:
            return sym
        count = 0
        cont = 1
        while cont and count < max_symbol - 1:
            cont = self.dec.decode_bin(ctx_indices[1])
            count += 1
        if cont and count == max_symbol - 1:
            count += 1
        return count

    def ep_exgolomb(self, count: int) -> int:
        sym = 0
        bit = 1
        while bit:
            bit = self.dec.decode_bin_ep()
            sym += bit << count
            count += 1
        count -= 1
        if count:
            sym += self.dec.decode_bins_ep(count)
        return sym

    def coef_remain_exgolomb(self, rparam: int) -> int:
        prefix = 0
        codeword = 1
        while codeword:
            prefix += 1
            codeword = self.dec.decode_bin_ep()
        prefix -= 1
        if prefix < COEF_REMAIN_BIN_REDUCTION:
            codeword = self.dec.decode_bins_ep(rparam) if rparam else 0
            return (prefix << rparam) + codeword
        n = prefix - COEF_REMAIN_BIN_REDUCTION + rparam
        codeword = self.dec.decode_bins_ep(n) if n else 0
        return (((1 << (prefix - COEF_REMAIN_BIN_REDUCTION))
                 + COEF_REMAIN_BIN_REDUCTION - 1) << rparam) + codeword


class SliceDataParser:
    def __init__(self, frame: FrameModel, sh: SliceHeader, sps: Sps, pps: Pps,
                 bs: InputBitstream, mvctx=None, slice_idx: int = 0,
                 substreams=None, dep_ctx_in=None):
        self.f = frame
        self.mvctx = mvctx           # decoder.mv.MvCtx for P/B slices
        self.sh = sh
        self.sps = sps
        self.pps = pps
        self.slice_idx = slice_idx
        self._base_ctx = cc.make_context_states(sh.slice_type, sh.slice_qp,
                                                sh.cabac_init_flag)
        # Substream decoders (TDecGop::decompressSlice): one BinDecoder +
        # context array per substream (WPP rows); plain slices have one.
        if substreams is None:
            substreams = [bs]
        self._sub_bs = substreams
        self._decs = [None] * len(substreams)
        self.dec = self._get_dec(0)
        self.p = SbacParser(self.dec)
        # WPP/tile context buffers, one per tile column
        # (m_pcBufferSbacDecoders "save init. state": starts at slice init)
        n_tile_cols = frame.tiles.n_cols if frame.tiles is not None else 1
        self._buffer_ctx = [self._base_ctx.copy() for _ in range(n_tile_cols)]
        self.dep_ctx_in = dep_ctx_in    # (ctx after 2nd LCU, ctx at dep end)
        self.dep_ctx_out = None
        self.is_last = False
        self.dqp_flag = False
        self.last_dqp_nonzero = 0
        self.coded_qp = sh.slice_qp
        self.bak_abs_part_cu = 0      # m_bakAbsPartIdxCU
        self.bak_chroma_part = 0      # m_uiBakAbsPartIdx
        self.num_suc_ipcm = 0
        # current CTU position
        self.ctu_addr = 0

    def _get_dec(self, sub: int) -> BinDecoder:
        if self._decs[sub] is None:
            self._decs[sub] = BinDecoder(self._sub_bs[sub],
                                         self._base_ctx.copy())
        return self._decs[sub]

    def _switch_dec(self, sub: int) -> None:
        self.dec = self._get_dec(sub)
        self.p = SbacParser(self.dec)

    # ------------------------------------------------------------------
    # helpers mapping z-part index within current CTU to unit coords
    # ------------------------------------------------------------------
    def _unit_xy(self, abs_part: int):
        r = int(self.f.z2r[abs_part])
        upr = self.f.units_per_row
        cx = self.ctu_addr % self.f.ctus_w
        cy = self.ctu_addr // self.f.ctus_w
        return cx * upr + (r % upr), cy * upr + (r // upr)

    def _pel_xy(self, abs_part: int):
        ux, uy = self._unit_xy(abs_part)
        return ux * self.f.unit, uy * self.f.unit

    def _units_at_depth(self, depth: int) -> int:
        return self.f.units_per_row >> depth

    # ------------------------------------------------------------------
    # slice loop
    # ------------------------------------------------------------------
    def parse_slice(self) -> None:
        """CTU loop in tile-scan order with WPP/tile/dependent-slice CABAC
        state handling (TDecSlice::decompressSlice, TDecSlice.cpp:93+).

        Slice start addresses in ``self.sh`` must already be converted to
        encode (tile-scan) order by the caller (TDecTop.cpp "convert the
        start and end CU addresses ... into encoding order").
        """
        f, sh, pps = self.f, self.sh, self.pps
        parts = f.parts_per_ctu
        ctus_w = f.ctus_w
        tiles = f.tiles
        wpp = pps.tiles_or_entropy_coding_sync_idc == 2
        allow_dep = (pps.dependent_slices_enabled_flag
                     and not getattr(pps, "cabac_independent_flag", False))
        nsub = len(self._sub_bs)
        n_tiles = (tiles.n_cols * tiles.n_rows) if tiles is not None else 1
        per_tile = max(1, nsub // n_tiles)

        start_enc = max(sh.slice_cur_start_cu_addr,
                        sh.dependent_slice_start_cu_addr) // parts
        slice_start_raster = int(
            f.ctu_order[sh.slice_cur_start_cu_addr // parts])
        dep_start_raster = int(
            f.ctu_order[sh.dependent_slice_start_cu_addr // parts])

        # dependent slice: restore contexts from the previous segment
        # (TDecSlice.cpp:186-196)
        if allow_dep and sh.dependent_slice and self.dep_ctx_in is not None:
            ctx2, ctx_end = self.dep_ctx_in
            if wpp and ctx2 is not None:
                self._buffer_ctx[0][:] = ctx2
            self._get_dec(0).ctx[:] = ctx_end

        tile_col = 0
        for enc in range(start_enc, f.num_ctus):
            ctu = int(f.ctu_order[enc])
            self.ctu_addr = ctu
            self._mark_ctu_slice(ctu)
            col, lin = ctu % ctus_w, ctu // ctus_w
            if tiles is not None:
                tile = int(tiles.tile_idx_map[ctu])
                tile_col = tile % tiles.n_cols
                tile_first = int(tiles.first_cu[tile])
            else:
                tile = 0
                tile_col = 0
                tile_first = 0
            tile_lcux = tile_first % ctus_w

            # substream selection + WPP top-right context inherit
            if nsub > 1 or (allow_dep and col == tile_lcux and wpp):
                sub = (tile * per_tile + lin % per_tile) if nsub > 1 else 0
                self._switch_dec(sub)
                if col == tile_lcux and wpp:
                    self._wpp_row_sync(ctu, tile, tile_col, allow_dep)
            elif nsub == 1 and tiles is not None and n_tiles > 1:
                # crossing into another tile (single substream): CABAC
                # terminate + byte align + context re-init (TDecSlice:269+)
                if (ctu == tile_first and ctu != 0
                        and ctu != slice_start_raster
                        and ctu != dep_start_raster):
                    self._tile_ctx_reset()

            if self.sps.use_sao and self.sh.sao_enabled:
                allow_left = allow_up = True
                if tiles is not None:
                    if col > 0 and tiles.tile_idx_map[ctu - 1] != tile:
                        allow_left = False
                    if lin > 0 and tiles.tile_idx_map[ctu - ctus_w] != tile:
                        allow_up = False
                self._parse_sao_ctu(ctu, slice_start_raster,
                                    allow_left, allow_up)
            self._decode_ctu()

            # store contexts after 2nd LCU of a row (WPP)
            if (wpp and col == tile_lcux + 1
                    and (nsub > 1 or allow_dep)):
                self._buffer_ctx[tile_col][:] = self.dec.ctx
            if self.is_last:
                break

        if allow_dep:
            self.dep_ctx_out = (
                self._buffer_ctx[tile_col].copy() if wpp else None,
                self.dec.ctx.copy())

    def _wpp_row_sync(self, ctu: int, tile: int, tile_col: int,
                      allow_dep: bool) -> None:
        """Inherit CABAC contexts from the top-right CTU's saved state when
        starting a CTU row (TDecSlice.cpp:228-262)."""
        f, sh = self.f, self.sh
        ctus_w = f.ctus_w
        parts = f.parts_per_ctu
        tr_exists = ctu >= ctus_w and (ctu % ctus_w) + 1 < ctus_w
        if not tr_exists:
            return
        tr = ctu - ctus_w + 1
        tr_end = int(f.ctu_inv_order[tr]) * parts + parts - 1
        same_tile = (f.tiles is None
                     or f.tiles.tile_idx_map[tr] == f.tiles.tile_idx_map[ctu])
        if (same_tile and tr_end >= sh.slice_cur_start_cu_addr
                and tr_end >= sh.dependent_slice_start_cu_addr):
            self.dec.ctx[:] = self._buffer_ctx[tile_col]
        elif (allow_dep and ctu != 0 and same_tile
              and tr_end >= sh.slice_cur_start_cu_addr):
            self.dec.ctx[:] = self._buffer_ctx[tile_col]

    def _tile_ctx_reset(self) -> None:
        """TDecSbac::updateContextTables: terminate, align, re-init, restart."""
        self.dec.decode_bin_trm()
        bs = self.dec.bs
        while bs.num_bits_left > 0 and bs.bits_until_byte_aligned != 0:
            bs.read(1)
        self.dec.ctx[:] = cc.make_context_states(
            self.sh.slice_type, self.sh.slice_qp, self.sh.cabac_init_flag)
        self.dec.start()

    def _mark_ctu_slice(self, ctu: int) -> None:
        f = self.f
        upr = f.units_per_row
        cx, cy = ctu % f.ctus_w, ctu // f.ctus_w
        sl = slice(cy * upr, (cy + 1) * upr), slice(cx * upr, (cx + 1) * upr)
        f.slice_start[sl] = self.sh.slice_cur_start_cu_addr
        f.dep_slice_start[sl] = self.sh.dependent_slice_start_cu_addr
        f.slice_idx[sl] = self.slice_idx

    # ------------------------------------------------------------------
    # SAO per-CTU parameters (parseSaoOneLcuInterleaving)
    # ------------------------------------------------------------------
    def _parse_sao_ctu(self, ctu: int, start_ctu: int,
                       allow_left: bool = True, allow_up: bool = True) -> None:
        f = self.f
        rx = ctu % f.ctus_w
        ry = ctu // f.ctus_w
        cu_addr_in_slice = ctu - start_ctu
        cu_addr_up_in_slice = cu_addr_in_slice - f.ctus_w
        sao_flag = [self.sh.sao_enabled, self.sh.sao_enabled_chroma]

        for comp in range(3):
            f.sao_merge_left[comp, ctu] = False
            f.sao_merge_up[comp, ctu] = False
            f.sao_sub_type[comp, ctu] = 0
            f.sao_type[comp, ctu] = -1
            f.sao_offsets[comp, ctu] = 0

        merge_left = merge_up = 0
        if sao_flag[0] or sao_flag[1]:
            if rx > 0 and cu_addr_in_slice != 0 and allow_left:
                merge_left = self.dec.decode_bin(cc.O_SAO_MERGE)
            if merge_left == 0:
                if ry > 0 and cu_addr_up_in_slice >= 0 and allow_up:
                    merge_up = self.dec.decode_bin(cc.O_SAO_MERGE)

        for comp in range(3):
            enabled = sao_flag[0] if comp == 0 else sao_flag[1]
            if not enabled:
                f.sao_type[comp, ctu] = -1
                f.sao_sub_type[comp, ctu] = 0
                continue
            ml = merge_left if (rx > 0 and cu_addr_in_slice != 0 and allow_left) else 0
            f.sao_merge_left[comp, ctu] = bool(ml)
            if not ml:
                mu = merge_up if (ry > 0 and cu_addr_up_in_slice >= 0 and allow_up) else 0
                f.sao_merge_up[comp, ctu] = bool(mu)
                if not mu:
                    if comp == 2:
                        # Cr shares type with Cb (SAO_TYPE_SHARING)
                        self._parse_sao_offset(comp, ctu, shared_type=int(f.sao_type[1, ctu]))
                    else:
                        self._parse_sao_offset(comp, ctu, shared_type=None)
                else:
                    self._copy_sao(comp, ctu, ctu - f.ctus_w)
            else:
                self._copy_sao(comp, ctu, ctu - 1)

    def _copy_sao(self, comp: int, dst: int, src: int) -> None:
        f = self.f
        f.sao_type[comp, dst] = f.sao_type[comp, src]
        if f.sao_type[comp, dst] != -1:
            f.sao_sub_type[comp, dst] = f.sao_sub_type[comp, src]
            f.sao_offsets[comp, dst] = f.sao_offsets[comp, src]
        else:
            f.sao_offsets[comp, dst] = 0

    def _sao_max_uvlc(self, max_symbol: int) -> int:
        if max_symbol == 0:
            return 0
        if self.dec.decode_bin_ep() == 0:
            return 0
        i = 1
        while True:
            if self.dec.decode_bin_ep() == 0:
                break
            i += 1
            if i == max_symbol:
                break
        return i

    def _parse_sao_offset(self, comp: int, ctu: int, shared_type) -> None:
        f = self.f
        if shared_type is not None:
            type_p1 = shared_type + 1
        else:
            # parseSaoTypeIdx
            if self.dec.decode_bin(cc.O_SAO_TYPE) == 0:
                type_p1 = 0
            else:
                type_p1 = 5 if self.dec.decode_bin_ep() == 0 else 1
        type_idx = type_p1 - 1
        f.sao_type[comp, ctu] = type_idx
        if type_p1 == 0:
            return
        bit_depth = self.sps.internal_bit_depth
        offset_th = 1 << min(bit_depth - 5, 5)
        if type_idx == 4:  # SAO_BO
            for i in range(4):
                f.sao_offsets[comp, ctu, i] = self._sao_max_uvlc(offset_th - 1)
            for i in range(4):
                if f.sao_offsets[comp, ctu, i] != 0:
                    if self.dec.decode_bin_ep():
                        f.sao_offsets[comp, ctu, i] = -f.sao_offsets[comp, ctu, i]
            f.sao_sub_type[comp, ctu] = self.dec.decode_bins_ep(5)
        else:  # EO: type_idx in 0..3
            f.sao_offsets[comp, ctu, 0] = self._sao_max_uvlc(offset_th - 1)
            f.sao_offsets[comp, ctu, 1] = self._sao_max_uvlc(offset_th - 1)
            f.sao_offsets[comp, ctu, 2] = -self._sao_max_uvlc(offset_th - 1)
            f.sao_offsets[comp, ctu, 3] = -self._sao_max_uvlc(offset_th - 1)
            if comp != 2:
                sub = self.dec.decode_bins_ep(2)
                f.sao_sub_type[comp, ctu] = sub
                f.sao_type[comp, ctu] = type_idx + sub
            else:
                # Cr: type index shared from Cb includes subtype already
                f.sao_sub_type[comp, ctu] = f.sao_sub_type[1, ctu]

    # ------------------------------------------------------------------
    # CU quadtree (xDecodeCU)
    # ------------------------------------------------------------------
    def _decode_ctu(self) -> None:
        self.is_last = False
        self._decode_cu(0, 0)

    def _decode_cu(self, abs_part: int, depth: int) -> None:
        f = self.f
        cur_parts = f.parts_per_ctu >> (depth << 1)
        q_parts = cur_parts >> 2
        px, py = self._pel_xy(abs_part)
        size = f.ctu_size >> depth
        boundary = not (px + size <= f.width and py + size <= f.height)
        max_sig_depth = f.max_depth - self.sps.add_cu_depth

        ux, uy = self._unit_xy(abs_part)
        units = self._units_at_depth(depth)

        split = False
        if not boundary:
            if depth == max_sig_depth:
                f.set_region(f.depth, ux, uy, units, depth)
            elif self.num_suc_ipcm > 0:
                f.set_region(f.depth, ux, uy, units, depth)
            else:
                ctx = f.ctx_split_flag(ux, uy, depth)
                bit = self.dec.decode_bin(cc.O_SPLIT_FLAG + ctx)
                _trace("SplitFlag")
                f.set_region(f.depth, ux, uy, units, depth + bit)
                split = bit == 1
        if (not boundary and split and depth < max_sig_depth) or boundary:
            idx = abs_part
            if self.pps.use_dqp and size == self._min_cu_dqp_size():
                self.dqp_flag = True
            for i in range(4):
                spx, spy = self._pel_xy(idx)
                if spx < f.width and spy < f.height:
                    self._decode_cu(idx, depth + 1)
                else:
                    # setOutsideCUPart
                    sux, suy = self._unit_xy(idx)
                    su = self._units_at_depth(depth + 1)
                    f.set_region(f.depth, sux, suy, su, depth + 1)
                    f.set_region(f.pred_mode, sux, suy, su, 15)  # MODE_NONE
                if self.is_last:
                    return
                idx += q_parts
            return

        # leaf CU
        lt0, ct0 = len(f.luma_tus), len(f.chroma_tus)
        if self.pps.use_dqp and size >= self._min_cu_dqp_size():
            self.dqp_flag = True

        if self.pps.transquant_bypass_enable_flag:
            bit = self.dec.decode_bin(cc.O_TQ_BYPASS)
            f.set_region(f.tq_bypass, ux, uy, units, bool(bit))

        if self.sh.slice_type != I_SLICE and self.num_suc_ipcm == 0:
            self._parse_skip_flag(abs_part, depth)

        if f.skip[uy, ux]:
            self._decode_skip_cu(abs_part, depth)
            f.cu_list.append((px, py, size, MODE_INTER, lt0, lt0, ct0, ct0))
            self._finish_cu(abs_part, depth)
            return

        if self.num_suc_ipcm == 0:
            # pred mode
            if self.sh.slice_type == I_SLICE:
                f.set_region(f.pred_mode, ux, uy, units, MODE_INTRA)
            else:
                bit = self.dec.decode_bin(cc.O_PRED_MODE)
                f.set_region(f.pred_mode, ux, uy, units, MODE_INTER + bit)
            self._parse_part_size(abs_part, depth)
        else:
            f.set_region(f.pred_mode, ux, uy, units, MODE_INTRA)
            f.set_region(f.part_size_arr, ux, uy, units, SIZE_2Nx2N)
            f.set_region(f.tr_idx, ux, uy, units, 0)

        is_intra = f.pred_mode[uy, ux] == MODE_INTRA
        part_sz = int(f.part_size_arr[uy, ux])

        if is_intra and part_sz == SIZE_2Nx2N:
            if self._pcm_allowed(size):
                self._parse_ipcm(abs_part, depth)
                if f.ipcm[uy, ux]:
                    f.cu_list.append((px, py, size, MODE_INTRA, lt0,
                                      len(f.luma_tus), ct0,
                                      len(f.chroma_tus)))
                    self._finish_cu(abs_part, depth)
                    return

        # prediction info
        if is_intra:
            self._parse_intra_dir_luma(abs_part, depth)
            self._parse_intra_dir_chroma(abs_part, depth)
        else:
            self._parse_pu_wise(abs_part, depth)

        # coefficients
        code_dqp = self.dqp_flag
        code_dqp = self._decode_coeff(abs_part, depth, code_dqp)
        self.dqp_flag = code_dqp
        f.cu_list.append((px, py, size,
                          MODE_INTRA if is_intra else MODE_INTER,
                          lt0, len(f.luma_tus), ct0, len(f.chroma_tus)))
        self._finish_cu(abs_part, depth)

    def _min_cu_dqp_size(self) -> int:
        return self.f.ctu_size >> self.pps.max_cu_dqp_depth

    def _pcm_allowed(self, size: int) -> bool:
        sps = self.sps
        return (sps.use_pcm and
                size >= (1 << sps.pcm_log2_min_size) and
                size <= (1 << sps.pcm_log2_max_size))

    def _finish_cu(self, abs_part: int, depth: int) -> None:
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        units = self._units_at_depth(depth)
        if self.pps.use_dqp:
            val = self._ref_qp(abs_part) if self.dqp_flag else self.coded_qp
            f.set_region(f.qp, ux, uy, units, val)
        else:
            f.set_region(f.qp, ux, uy, units, self.sh.slice_qp)
        if self.num_suc_ipcm > 0:
            return
        self.is_last = self._decode_slice_end(abs_part, depth)

    def _decode_slice_end(self, abs_part: int, depth: int) -> bool:
        f = self.f
        px, py = self._pel_xy(abs_part)
        size = f.ctu_size >> depth
        gran = f.ctu_size
        if (((px + size) % gran == 0 or (px + size) == f.width) and
                ((py + size) % gran == 0 or (py + size) == f.height)):
            return self.dec.decode_bin_trm() > 0
        return False

    # ------------------------------------------------------------------
    def _parse_skip_flag(self, abs_part: int, depth: int) -> None:
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        units = self._units_at_depth(depth)
        ctx = f.ctx_skip_flag(ux, uy)
        bit = self.dec.decode_bin(cc.O_SKIP_FLAG + ctx)
        if bit:
            f.set_region(f.skip, ux, uy, units, True)
            f.set_region(f.pred_mode, ux, uy, units, MODE_INTER)
            f.set_region(f.part_size_arr, ux, uy, units, SIZE_2Nx2N)
            f.set_region(f.merge_flag, ux, uy, units, True)

    def _parse_part_size(self, abs_part: int, depth: int) -> None:
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        units = self._units_at_depth(depth)
        max_sig_depth = f.max_depth - self.sps.add_cu_depth
        if f.pred_mode[uy, ux] == MODE_INTRA:
            sym = 1
            if depth == max_sig_depth:
                sym = self.dec.decode_bin(cc.O_PART_SIZE + 0)
            mode = SIZE_2Nx2N if sym else SIZE_NxN
            f.set_region(f.part_size_arr, ux, uy, units, mode)
            # TrIdx preset (parsePartSize) — overwritten by transform tree
            size = f.ctu_size >> depth
            width_bit = rom.convert_to_bit(size) + 2
            tr_size_bit = rom.convert_to_bit(self.sps.max_tr_size) + 2
            tr_level = max(0, width_bit - tr_size_bit)
            f.set_region(f.tr_idx, ux, uy, units,
                         (1 + tr_level) if mode == SIZE_NxN else tr_level)
        else:
            # inter branch (parsePartSize :609): truncated unary over up to
            # three ctx bins, then AMP refinement (ctx bin + EP) when AMP is
            # accumulated at this depth (xActivateParameterSets: AMPAcc[d] =
            # useAMP for d < maxSigDepth, else 0).
            size = f.ctu_size >> depth
            max_bits = 3 if (depth == max_sig_depth and size != 8) else 2
            mode = 0
            for ui in range(max_bits):
                if self.dec.decode_bin(cc.O_PART_SIZE + ui):
                    break
                mode += 1
            if self.sps.use_amp and depth < max_sig_depth:
                if mode in (SIZE_2NxN, SIZE_Nx2N):
                    if self.dec.decode_bin(cc.O_AMP) == 0:
                        sym = self.dec.decode_bin_ep()
                        if mode == SIZE_2NxN:
                            mode = SIZE_2NxnU if sym == 0 else SIZE_2NxnD
                        else:
                            mode = SIZE_nLx2N if sym == 0 else SIZE_nRx2N
            f.set_region(f.part_size_arr, ux, uy, units, mode)

    def _parse_intra_dir_luma(self, abs_part: int, depth: int) -> None:
        f = self.f
        part_sz = int(f.part_size_arr[self._unit_xy(abs_part)[1],
                                      self._unit_xy(abs_part)[0]])
        part_num = 4 if part_sz == SIZE_NxN else 1
        part_offset = (f.parts_per_ctu >> (depth << 1)) >> 2
        sub_depth = depth + 1 if part_sz == SIZE_NxN else depth
        mpm_flags = [self.dec.decode_bin(cc.O_INTRA_PRED)
                     for _ in range(part_num)]
        for j in range(part_num):
            part = abs_part + part_offset * j
            ux, uy = self._unit_xy(part)
            preds = f.intra_mpm(ux, uy)
            if mpm_flags[j]:
                sym = self.dec.decode_bin_ep()
                if sym:
                    sym = self.dec.decode_bin_ep() + 1
                mode = preds[sym]
            else:
                mode = self.dec.decode_bins_ep(5)
                sp = sorted(preds)
                for p in sp:
                    mode += (mode >= p)
            units = self._units_at_depth(sub_depth)
            f.set_region(f.luma_dir, ux, uy, units, mode)

    def _parse_intra_dir_chroma(self, abs_part: int, depth: int) -> None:
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        units = self._units_at_depth(depth)
        sym = self.dec.decode_bin(cc.O_CHROMA_PRED)
        if sym == 0:
            mode = DM_CHROMA_IDX
        else:
            idx = self.dec.decode_bins_ep(2)
            mode = f.allowed_chroma_dirs(ux, uy)[idx]
        f.set_region(f.chroma_dir, ux, uy, units, mode)

    # ------------------------------------------------------------------
    # IPCM
    # ------------------------------------------------------------------
    def _parse_ipcm(self, abs_part: int, depth: int) -> None:
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        units = self._units_at_depth(depth)
        read_pcm = False
        if self.num_suc_ipcm > 0:
            read_pcm = True
        else:
            if self.dec.decode_bin_trm():
                read_pcm = True
                # decodeNumSubseqIPCM
                n = 0
                while True:
                    self.dec.value += self.dec.value
                    self.dec.bits_needed += 1
                    if self.dec.bits_needed >= 0:
                        self.dec.bits_needed = -8
                        self.dec.value += self.dec.bs.read_byte()
                    bit = (self.dec.value & 128) >> 7
                    n += 1
                    if not (bit and n < 3):
                        break
                if bit and n == 3:
                    n += 1
                n -= 1
                self.num_suc_ipcm = n + 1
                self.dec.decode_pcm_align_bits()
        if read_pcm:
            f.set_region(f.part_size_arr, ux, uy, units, SIZE_2Nx2N)
            f.set_region(f.tr_idx, ux, uy, units, 0)
            f.set_region(f.ipcm, ux, uy, units, True)
            size = f.ctu_size >> depth
            px, py = self._pel_xy(abs_part)
            sb_l = self.sps.pcm_bit_depth_luma
            sb_c = self.sps.pcm_bit_depth_chroma
            shift_l = self.sps.internal_bit_depth - sb_l
            shift_c = self.sps.internal_bit_depth - sb_c
            # luma samples written directly into a PCM store on the frame
            if not hasattr(f, "pcm_y"):
                f.pcm_y = np.zeros((f.frame_units_h * 4, f.frame_units_w * 4), np.int16)
                f.pcm_cb = np.zeros((f.frame_units_h * 2, f.frame_units_w * 2), np.int16)
                f.pcm_cr = np.zeros((f.frame_units_h * 2, f.frame_units_w * 2), np.int16)
            for y in range(size):
                for x in range(size):
                    f.pcm_y[py + y, px + x] = self.dec.read_pcm_code(sb_l) << shift_l
            for plane in (f.pcm_cb, f.pcm_cr):
                for y in range(size // 2):
                    for x in range(size // 2):
                        plane[py // 2 + y, px // 2 + x] = \
                            self.dec.read_pcm_code(sb_c) << shift_c
            f.luma_tus.append((px, py, size, abs_part, self.ctu_addr, 0))
            f.chroma_tus.append((px // 2, py // 2, size // 2, abs_part,
                                 self.ctu_addr, 0))
            self.num_suc_ipcm -= 1
            if self.num_suc_ipcm == 0:
                self.dec.start()

    # ------------------------------------------------------------------
    # dQP (parseDeltaQP) and getRefQP machinery
    # ------------------------------------------------------------------
    def _ref_qp(self, abs_part: int) -> int:
        """getRefQP (TComDataCU.cpp:1826) — average of left/above QP-min-CU
        neighbors, falling back to last coded QP."""
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        # QP min CU granularity mask
        left = f.left_unit(ux, uy)
        above = f.above_unit(ux, uy)
        # getQpMinCuLeft/Above only look within the same CTU in HM8? They
        # use getPULeft with enforceSameCTU behavior; approximate with
        # in-CTU restriction:
        upr = f.units_per_row
        lqp = aqp = None
        if left is not None and left[0] // upr == ux // upr and left[1] // upr == uy // upr:
            lqp = int(f.qp[left[1], left[0]])
        if above is not None and above[0] // upr == ux // upr and above[1] // upr == uy // upr:
            aqp = int(f.qp[above[1], above[0]])
        last = self.coded_qp
        l = lqp if lqp is not None else last
        a = aqp if aqp is not None else last
        return (l + a + 1) >> 1

    def _parse_delta_qp(self, abs_part: int) -> None:
        f = self.f
        dqp = self.p.unary_max((cc.O_DQP, cc.O_DQP + 1), CU_DQP_TU_CMAX)
        if dqp >= CU_DQP_TU_CMAX:
            dqp += self.p.ep_exgolomb(CU_DQP_EG_K)
        if dqp > 0:
            sign = self.dec.decode_bin_ep()
            idqp = -dqp if sign else dqp
            qp_bd = self.sps.qp_bd_offset_y
            qp = ((self._ref_qp(abs_part) + idqp + 52 + 2 * qp_bd)
                  % (52 + qp_bd)) - qp_bd
        else:
            qp = self._ref_qp(abs_part)
        ux, uy = self._unit_xy(self.bak_abs_part_cu)
        depth = int(f.depth[uy, ux])
        units = self._units_at_depth(depth)
        f.set_region(f.qp, ux, uy, units, qp)
        self.coded_qp = qp

    # ------------------------------------------------------------------
    # transform tree (xDecodeTransform)
    # ------------------------------------------------------------------
    def _decode_coeff(self, abs_part: int, depth: int, code_dqp: bool) -> bool:
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        units = self._units_at_depth(depth)
        if f.pred_mode[uy, ux] != MODE_INTRA:
            root_cbf = 1
            if not (int(f.part_size_arr[uy, ux]) == SIZE_2Nx2N
                    and f.merge_flag[uy, ux]):
                root_cbf = self.dec.decode_bin(cc.O_QT_ROOT_CBF)
            if not root_cbf:
                f.cbf[:, uy:uy + units, ux:ux + units] = 0
                f.tr_idx[uy:uy + units, ux:ux + units] = 0
                return code_dqp
        self._code_dqp = code_dqp
        self._decode_transform(abs_part, depth, tr_idx=0)
        return self._code_dqp

    def _log2_ctu(self) -> int:
        return rom.convert_to_bit(self.f.ctu_size) + 2

    def _min_tu_size_in_cu(self, abs_part: int) -> int:
        """getQuadtreeTULog2MinSizeInCU (TComDataCU.cpp:2037)."""
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        depth = int(f.depth[uy, ux])
        log2_cb = self._log2_ctu() - depth
        part_sz = int(f.part_size_arr[uy, ux])
        is_intra = f.pred_mode[uy, ux] == MODE_INTRA
        max_tu_depth = (self.sps.quadtree_tu_max_depth_intra if is_intra
                        else self.sps.quadtree_tu_max_depth_inter)
        intra_split = 1 if (is_intra and part_sz == SIZE_NxN) else 0
        inter_split = 1 if (max_tu_depth == 1 and not is_intra
                            and part_sz != SIZE_2Nx2N) else 0
        if log2_cb < (self.sps.quadtree_tu_log2_min_size + max_tu_depth - 1
                      + inter_split + intra_split):
            return self.sps.quadtree_tu_log2_min_size
        v = log2_cb - (max_tu_depth - 1 + inter_split + intra_split)
        return min(v, self.sps.quadtree_tu_log2_max_size)

    def _get_cbf(self, ux: int, uy: int, comp: int, tr_depth: int) -> int:
        return (int(self.f.cbf[comp, uy, ux]) >> tr_depth) & 1

    def _set_cbf(self, abs_part: int, comp: int, value: int, depth: int) -> None:
        ux, uy = self._unit_xy(abs_part)
        units = self._units_at_depth(depth)
        self.f.cbf[comp, uy:uy + units, ux:ux + units] = value

    def _or_cbf(self, abs_part: int, comp: int, value: int, num_units4: int) -> None:
        # OR over 4*qparts region starting at abs_part
        f = self.f
        for k in range(num_units4):
            part = abs_part + k
            r = int(f.z2r[part])
            upr = f.units_per_row
            cx = self.ctu_addr % f.ctus_w
            cy = self.ctu_addr // f.ctus_w
            ux, uy = cx * upr + r % upr, cy * upr + r // upr
            f.cbf[comp, uy, ux] |= value

    def _decode_transform(self, abs_part: int, depth: int, tr_idx: int,
                          cu_abs_part: int = None, cu_depth: int = None) -> None:
        f = self.f
        if tr_idx == 0:
            self.bak_abs_part_cu = abs_part
            cu_abs_part = abs_part
            ux, uy = self._unit_xy(abs_part)
            cu_depth = int(f.depth[uy, ux])
        log2_tr = self._log2_ctu() - depth

        ux, uy = self._unit_xy(abs_part)

        if log2_tr == 2:
            part_num = f.parts_per_ctu >> ((depth - 1) << 1)
            if abs_part % part_num == 0:
                self.bak_chroma_part = abs_part

        is_intra = f.pred_mode[uy, ux] == MODE_INTRA
        part_sz = int(f.part_size_arr[uy, ux])
        cu_d = int(f.depth[uy, ux])

        if is_intra and part_sz == SIZE_NxN and depth == cu_d:
            subdiv = 1
        elif (self.sps.quadtree_tu_max_depth_inter == 1 and not is_intra
              and part_sz != SIZE_2Nx2N and depth == cu_d):
            subdiv = int(log2_tr > self._min_tu_size_in_cu(abs_part))
        elif log2_tr > self.sps.quadtree_tu_log2_max_size:
            subdiv = 1
        elif log2_tr == self.sps.quadtree_tu_log2_min_size:
            subdiv = 0
        elif log2_tr == self._min_tu_size_in_cu(abs_part):
            subdiv = 0
        else:
            subdiv = self.dec.decode_bin(cc.O_TRANS_SUBDIV + (5 - log2_tr))
            _trace(f"parseTransformSubdivFlag()\tsymbol={subdiv}\tctx={5-log2_tr}")

        tr_depth = depth - cu_d
        first_cbf_of_cu = tr_depth == 0
        if first_cbf_of_cu:
            self._set_cbf_region_zero(abs_part, depth)
        if first_cbf_of_cu or log2_tr > 2:
            for comp in (1, 2):
                if first_cbf_of_cu or self._get_cbf(ux, uy, comp, tr_depth - 1):
                    ctx = tr_depth  # chroma ctx = trDepth
                    bit = self.dec.decode_bin(cc.O_QT_CBF + 5 + ctx)
                    _trace(f"parseQtCbf()\tsymbol={bit}\tctx={ctx}\tetype={comp+1}\tuiAbsPartIdx={abs_part}")
                    self._set_cbf_store(abs_part, comp, bit << tr_depth, depth)
        else:
            for comp in (1, 2):
                parent = self._get_cbf(ux, uy, comp, tr_depth - 1)
                self._set_cbf_store(abs_part, comp, parent << tr_depth, depth)

        if subdiv:
            depth += 1
            tr_idx += 1
            q_parts = f.parts_per_ctu >> (depth << 1)
            start = abs_part
            y_cbf = u_cbf = v_cbf = 0
            luma_tr = tr_depth + 1
            chroma_tr = self._convert_chroma_tr(cu_abs_part, tr_depth + 1, cu_d)
            part = abs_part
            for i in range(4):
                self._decode_transform(part, depth, tr_idx, cu_abs_part, cu_depth)
                sux, suy = self._unit_xy(part)
                y_cbf |= self._get_cbf(sux, suy, 0, luma_tr)
                u_cbf |= self._get_cbf(sux, suy, 1, chroma_tr)
                v_cbf |= self._get_cbf(sux, suy, 2, chroma_tr)
                part += q_parts
            # propagate to parent bit level
            luma_tr_p = tr_depth
            chroma_tr_p = self._convert_chroma_tr(cu_abs_part, tr_depth, cu_d)
            for k in range(4 * q_parts):
                p = start + k
                r = int(f.z2r[p])
                upr = f.units_per_row
                cx = self.ctu_addr % f.ctus_w
                cy = self.ctu_addr // f.ctus_w
                sux, suy = cx * upr + r % upr, cy * upr + r // upr
                f.cbf[0, suy, sux] |= y_cbf << luma_tr_p
                f.cbf[1, suy, sux] |= u_cbf << chroma_tr_p
                f.cbf[2, suy, sux] |= v_cbf << chroma_tr_p
            return

        # leaf TU
        units = self._units_at_depth(depth)
        f.tr_idx[uy:uy + units, ux:ux + units] = tr_depth
        _trace(f"TrIdx: abspart={abs_part}\tdepth={depth}\ttrdepth={tr_depth}")
        size = 1 << log2_tr
        px, py = self._pel_xy(abs_part)
        f.luma_tus.append((px, py, size, abs_part, self.ctu_addr, tr_depth))
        if log2_tr > 2:
            f.chroma_tus.append((px // 2, py // 2, size // 2, abs_part,
                                 self.ctu_addr, tr_depth))
        else:
            pn = f.parts_per_ctu >> ((depth - 1) << 1)
            if abs_part % pn == 0:
                f.chroma_tus.append((px // 2, py // 2, size, abs_part,
                                     self.ctu_addr, tr_depth - 1))

        # luma CBF
        if (not is_intra and depth == cu_d
                and not self._get_cbf(ux, uy, 1, 0)
                and not self._get_cbf(ux, uy, 2, 0)):
            self._set_cbf_store(abs_part, 0, 1 << tr_depth, depth)
        else:
            ctx = 1 if tr_depth == 0 else 0
            bit = self.dec.decode_bin(cc.O_QT_CBF + ctx)
            _trace(f"parseQtCbf()\tsymbol={bit}\tctx={ctx}\tetype=0\tuiAbsPartIdx={abs_part}")
            self._set_cbf_store(abs_part, 0, bit << tr_depth, depth)

        cbf_y = self._get_cbf(ux, uy, 0, tr_idx)
        cbf_u = self._get_cbf(ux, uy, 1, tr_idx)
        cbf_v = self._get_cbf(ux, uy, 2, tr_idx)
        if log2_tr == 2:
            part_num = f.parts_per_ctu >> ((depth - 1) << 1)
            if abs_part % part_num == part_num - 1:
                bux, buy = self._unit_xy(self.bak_chroma_part)
                cbf_u = self._get_cbf(bux, buy, 1, tr_idx)
                cbf_v = self._get_cbf(bux, buy, 2, tr_idx)

        if cbf_y or cbf_u or cbf_v:
            if self.pps.use_dqp and self._code_dqp:
                self._parse_delta_qp(self.bak_abs_part_cu)
                self._code_dqp = False

        size = 1 << log2_tr
        if cbf_y:
            px, py = self._pel_xy(abs_part)
            self._parse_coeff_nxn(abs_part, px, py, size, depth, 0)
        if log2_tr > 2:
            px, py = self._pel_xy(abs_part)
            if cbf_u:
                self._parse_coeff_nxn(abs_part, px // 2, py // 2, size // 2, depth, 1)
            if cbf_v:
                self._parse_coeff_nxn(abs_part, px // 2, py // 2, size // 2, depth, 2)
        else:
            part_num = f.parts_per_ctu >> ((depth - 1) << 1)
            if abs_part % part_num == part_num - 1:
                px, py = self._pel_xy(self.bak_chroma_part)
                if cbf_u:
                    self._parse_coeff_nxn(self.bak_chroma_part, px // 2, py // 2,
                                          size, depth, 1)
                if cbf_v:
                    self._parse_coeff_nxn(self.bak_chroma_part, px // 2, py // 2,
                                          size, depth, 2)

    def _convert_chroma_tr(self, cu_abs_part: int, tr_depth: int, cu_depth: int) -> int:
        """convertTransIdx (TComDataCU.cpp:3520) is the identity for both
        luma and chroma in this reference cut."""
        return tr_depth

    def _set_cbf_region_zero(self, abs_part: int, depth: int) -> None:
        ux, uy = self._unit_xy(abs_part)
        units = self._units_at_depth(depth)
        self.f.cbf[1, uy:uy + units, ux:ux + units] = 0
        self.f.cbf[2, uy:uy + units, ux:ux + units] = 0

    def _set_cbf_store(self, abs_part: int, comp: int, value: int, depth: int) -> None:
        ux, uy = self._unit_xy(abs_part)
        units = self._units_at_depth(depth)
        self.f.cbf[comp, uy:uy + units, ux:ux + units] = value

    # ------------------------------------------------------------------
    # coefficient parsing (parseCoeffNxN)
    # ------------------------------------------------------------------
    def _scan_idx(self, abs_part: int, width: int, is_luma: bool) -> int:
        """getCoefScanIdx (TComDataCU.cpp:4014)."""
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        if f.pred_mode[uy, ux] != MODE_INTRA:
            return rom.SCAN_ZIGZAG
        ctx_idx = {2: 6, 4: 5, 8: 4, 16: 3, 32: 2, 64: 1}.get(width, 0)
        if is_luma:
            dir_mode = int(f.luma_dir[uy, ux])
            if 3 < ctx_idx < 6:
                if abs(dir_mode - rom.VER_IDX) < 5:
                    return rom.SCAN_HOR
                if abs(dir_mode - rom.HOR_IDX) < 5:
                    return rom.SCAN_VER
            return rom.SCAN_ZIGZAG
        dir_mode = int(f.chroma_dir[uy, ux])
        if dir_mode == DM_CHROMA_IDX:
            depth = int(f.depth[uy, ux])
            # luma mode from upper-left corner of current CU
            num_parts = f.parts_per_ctu >> (2 * depth)
            cu_part = (abs_part // num_parts) * num_parts
            cux, cuy = self._unit_xy(cu_part)
            dir_mode = int(f.luma_dir[cuy, cux])
        if 4 < ctx_idx < 7:
            if abs(dir_mode - rom.VER_IDX) < 5:
                return rom.SCAN_HOR
            if abs(dir_mode - rom.HOR_IDX) < 5:
                return rom.SCAN_VER
        return rom.SCAN_ZIGZAG

    def _parse_transform_skip_flag(self, abs_part: int, width: int,
                                   depth: int, comp: int) -> None:
        f = self.f
        ux, uy = self._unit_xy(abs_part)
        if f.tq_bypass[uy, ux]:
            return
        if width != 4:
            return
        bit = self.dec.decode_bin(cc.O_TS_FLAG + (0 if comp == 0 else 1))
        etype = 0 if comp == 0 else comp + 1
        _trace(f"parseTransformSkip()\tsymbol={bit}\tAddr={depth}"
               f"\tetype={etype}\tuiAbsPartIdx={abs_part}")
        store_depth = depth
        if comp != 0:
            log2_tr = self._log2_ctu() - depth
            if log2_tr == 2:
                store_depth = depth - 1
        units = self._units_at_depth(store_depth)
        f.ts_flag[comp, uy:uy + units, ux:ux + units] = bool(bit)

    def _parse_last_xy(self, width: int, comp_chroma: bool, scan_idx: int):
        """parseLastSignificantXY (TDecSbac.cpp:1074)."""
        dec = self.dec
        lg = rom.convert_to_bit(width)  # log2(width)-2
        if comp_chroma:
            blk_off, shift = 0, lg
            base_x = cc.O_LAST_X + 15
            base_y = cc.O_LAST_Y + 15
        else:
            blk_off = lg * 3 + ((lg + 1) >> 2)
            shift = (lg + 3) >> 2
            base_x = cc.O_LAST_X
            base_y = cc.O_LAST_Y
        group_max = int(rom.GROUP_IDX[width - 1])
        pos_x = 0
        while pos_x < group_max:
            if not dec.decode_bin(base_x + blk_off + (pos_x >> shift)):
                break
            pos_x += 1
        pos_y = 0
        while pos_y < group_max:
            if not dec.decode_bin(base_y + blk_off + (pos_y >> shift)):
                break
            pos_y += 1
        if pos_x > 3:
            count = (pos_x - 2) >> 1
            tmp = dec.decode_bins_ep(count)
            pos_x = int(rom.MIN_IN_GROUP[pos_x]) + tmp
        if pos_y > 3:
            count = (pos_y - 2) >> 1
            tmp = dec.decode_bins_ep(count)
            pos_y = int(rom.MIN_IN_GROUP[pos_y]) + tmp
        if scan_idx == rom.SCAN_VER:
            pos_x, pos_y = pos_y, pos_x
        return pos_x, pos_y

    def _parse_coeff_nxn(self, abs_part: int, px: int, py: int, width: int,
                         depth: int, comp: int) -> None:
        """parseCoeffNxN (TDecSbac.cpp:1133) into the frame coeff plane."""
        f = self.f
        dec = self.dec
        if width > self.sps.max_tr_size:
            width = self.sps.max_tr_size
        etype = 0 if comp == 0 else comp + 1
        _trace(f"parseCoeffNxN()\teType={etype}\twidth={width}\theight={width}\tdepth={depth}\tabspartidx={abs_part}")
        if self.pps.use_transform_skip:
            self._parse_transform_skip_flag(abs_part, width, depth, comp)
        if TRACE is None and self._parse_coeff_native(abs_part, px, py,
                                                      width, comp):
            return
        is_luma = comp == 0
        log2 = width.bit_length() - 1
        max_coeff = width * width
        scan_idx = self._scan_idx(abs_part, width, is_luma)
        block_type = log2

        pos_x, pos_y = self._parse_last_xy(width, not is_luma, scan_idx)
        blk_pos_last = pos_x + (pos_y << log2)
        _trace(f"SCANTRACE scan={scan_idx} lastX={pos_x} lastY={pos_y}")

        coeff = np.zeros(max_coeff, np.int32)
        coeff[blk_pos_last] = 1

        if scan_idx == rom.SCAN_ZIGZAG:
            scan_idx = rom.SCAN_DIAG
        scan = rom.sig_last_scan(scan_idx, width)
        scan_pos_last = int(np.nonzero(scan == blk_pos_last)[0][0])

        sig_base = cc.O_SIG + (0 if is_luma else cc.NUM_SIG_FLAG_CTX_LUMA)
        cg_base = cc.O_SIG_CG + (0 if is_luma else 2)

        last_scan_set = scan_pos_last >> 4
        c1 = 1
        go_rice = 0

        ux, uy = self._unit_xy(abs_part)
        be_valid = (not f.tq_bypass[uy, ux]) and self.pps.sign_hide_flag

        num_blk_side = width >> 2
        sig_cg_flags = np.zeros(max(num_blk_side * num_blk_side, 1), np.int32)
        scan_cg = rom.cg_scan(scan_idx, width)

        i_scan_pos_sig = scan_pos_last
        for subset in range(last_scan_set, -1, -1):
            sub_pos = subset << 4
            go_rice = 0
            num_nonzero = 0
            last_nz_in_cg = -1
            first_nz_in_cg = 16
            pos = []
            if i_scan_pos_sig == scan_pos_last:
                last_nz_in_cg = i_scan_pos_sig
                first_nz_in_cg = i_scan_pos_sig
                i_scan_pos_sig -= 1
                pos.append(blk_pos_last)
                num_nonzero = 1

            cg_blk_pos = int(scan_cg[subset])
            cg_pos_y = cg_blk_pos // num_blk_side if num_blk_side else 0
            cg_pos_x = cg_blk_pos - cg_pos_y * num_blk_side

            if subset == last_scan_set or subset == 0:
                sig_cg_flags[cg_blk_pos] = 1
            else:
                ctx = self._sig_cg_ctx(sig_cg_flags, cg_pos_x, cg_pos_y, width)
                bit = dec.decode_bin(cg_base + ctx)
                _trace(f"CGTRACE set={subset} ctx={ctx} flag={bit}")
                sig_cg_flags[cg_blk_pos] = bit

            pattern = self._calc_pattern_sig_ctx(sig_cg_flags, cg_pos_x,
                                                 cg_pos_y, width)
            while i_scan_pos_sig >= sub_pos:
                blk = int(scan[i_scan_pos_sig])
                yy = blk >> log2
                xx = blk - (yy << log2)
                sig = 0
                if sig_cg_flags[cg_blk_pos]:
                    if i_scan_pos_sig > sub_pos or subset == 0 or num_nonzero:
                        ctx = self._sig_ctx_inc(pattern, scan_idx, xx, yy,
                                                block_type, comp)
                        sig = dec.decode_bin(sig_base + ctx)
                        _trace(f"SIGTRACE pos={i_scan_pos_sig} ctx={ctx} sig={sig}")
                    else:
                        sig = 1
                coeff[blk] = sig
                if sig:
                    pos.append(blk)
                    num_nonzero += 1
                    if last_nz_in_cg == -1:
                        last_nz_in_cg = i_scan_pos_sig
                    first_nz_in_cg = i_scan_pos_sig
                i_scan_pos_sig -= 1

            if num_nonzero:
                sign_hidden = (last_nz_in_cg - first_nz_in_cg) >= SBH_THRESHOLD
                ctx_set = 2 if (subset > 0 and is_luma) else 0
                if c1 == 0:
                    ctx_set += 1
                c1 = 1
                one_base = cc.O_ONE + (0 if is_luma else 16) + 4 * ctx_set
                abs_coeff = [1] * num_nonzero
                num_c1 = min(num_nonzero, C1FLAG_NUMBER)
                first_c2_idx = -1
                for idx in range(num_c1):
                    bit = dec.decode_bin(one_base + c1)
                    _trace(f"C1TRACE c1={c1} bin={bit}")
                    if bit == 1:
                        c1 = 0
                        if first_c2_idx == -1:
                            first_c2_idx = idx
                    elif 0 < c1 < 3:
                        c1 += 1
                    abs_coeff[idx] = bit + 1
                if c1 == 0:
                    abs_base = cc.O_ABS + (0 if is_luma else 4) + ctx_set
                    if first_c2_idx != -1:
                        bit = dec.decode_bin(abs_base)
                        abs_coeff[first_c2_idx] = bit + 2
                if sign_hidden and be_valid:
                    nsign_bits = num_nonzero - 1
                else:
                    nsign_bits = num_nonzero
                signs = dec.decode_bins_ep(nsign_bits) if nsign_bits else 0
                sign_bits = [(signs >> (nsign_bits - 1 - i)) & 1
                             for i in range(nsign_bits)]

                first_coeff2 = 1
                if c1 == 0 or num_nonzero > C1FLAG_NUMBER:
                    for idx in range(num_nonzero):
                        base_level = (2 + first_coeff2) if idx < C1FLAG_NUMBER else 1
                        if abs_coeff[idx] == base_level:
                            level = self.p.coef_remain_exgolomb(go_rice)
                            _trace(f"GRTRACE rice={go_rice} level={level}")
                            abs_coeff[idx] = level + base_level
                            if abs_coeff[idx] > 3 * (1 << go_rice):
                                go_rice = min(go_rice + 1, 4)
                        if abs_coeff[idx] >= 2:
                            first_coeff2 = 0

                abs_sum = 0
                for idx in range(num_nonzero):
                    blk = pos[idx]
                    coeff[blk] = abs_coeff[idx]
                    abs_sum += abs_coeff[idx]
                    if idx == num_nonzero - 1 and sign_hidden and be_valid:
                        if abs_sum & 1:
                            coeff[blk] = -coeff[blk]
                    else:
                        if sign_bits[idx]:
                            coeff[blk] = -coeff[blk]

        if TRACE is not None:
            h = 0
            for v in coeff:
                h = (h * 1000003 + int(v)) & 0xFFFFFFFFFFFFFFFF
            if h >= 1 << 63:
                h -= 1 << 64
            _trace(f"COEFSUM={h}")
        # store into the frame coeff plane at (px, py)
        plane = (f.coeff_y if comp == 0 else
                 f.coeff_cb if comp == 1 else f.coeff_cr)
        plane[py:py + width, px:px + width] = coeff.reshape(width, width)

    # cached contiguous scan tables (pointers) for the native parser
    _scan_cache: dict = {}
    # reusable zeroed coefficient buffers per width: (array, 2d view, ptr)
    _coeff_bufs: dict = {}

    def _native_state(self):
        """Lazy per-parser native call state (struct + pointers)."""
        from .. import native
        lib = native.get_lib()
        if lib is None:
            return None
        import ctypes
        st = native.BsEngine()
        self._nstate = (lib, st, ctypes.byref(st),
                        ctypes.byref(native.coeff_ctx_offsets()),
                        self.dec.ctx.ctypes.data)
        return self._nstate

    def _parse_coeff_native(self, abs_part: int, px: int, py: int,
                            width: int, comp: int) -> bool:
        """Native parseCoeffNxN fast path; returns False to fall back."""
        ns = getattr(self, "_nstate", None) or self._native_state()
        if ns is None:
            return False
        lib, st, st_ref, off_ref, _ = ns
        f = self.f
        dec = self.dec
        bs = dec.bs
        scan_idx = self._scan_idx(abs_part, width, comp == 0)
        key = (scan_idx if scan_idx != rom.SCAN_ZIGZAG else rom.SCAN_DIAG,
               width)
        cached = self._scan_cache.get(key)
        if cached is None:
            scan = np.ascontiguousarray(rom.sig_last_scan(key[0], width),
                                        dtype=np.int32)
            scan_cg = np.ascontiguousarray(rom.cg_scan(key[0], width),
                                           dtype=np.int32)
            cached = (scan, scan_cg, scan.ctypes.data, scan_cg.ctypes.data)
            self._scan_cache[key] = cached
        scan_p, cg_p = cached[2], cached[3]
        cb = self._coeff_bufs.get(width)
        if cb is None:
            arr = np.zeros(width * width, np.int32)
            cb = (arr, arr.reshape(width, width), arr.ctypes.data)
            self._coeff_bufs[width] = cb
        coeff_flat, coeff_2d, coeff_p = cb
        coeff_flat.fill(0)

        ux, uy = self._unit_xy(abs_part)
        be_valid = int((not f.tq_bypass[uy, ux]) and self.pps.sign_hide_flag)

        st.buf = bs._buf
        st.buf_len = len(bs._buf)
        st.idx = bs._idx
        st.held = bs._held
        st.num_held = bs._num_held
        st.num_bits_read = bs._num_bits_read
        st.range = dec.range
        st.value = dec.value
        st.bits_needed = dec.bits_needed
        st.overflow = 0
        rc = lib.parse_coeff_nxn(
            st_ref, self.dec.ctx.ctypes.data, off_ref,
            width, scan_idx, int(comp == 0), be_valid,
            scan_p, cg_p, coeff_p)
        # sync state back
        bs._idx = st.idx
        bs._held = st.held
        bs._num_held = st.num_held
        bs._num_bits_read = st.num_bits_read
        dec.range = st.range
        dec.value = st.value
        dec.bits_needed = st.bits_needed
        if rc != 0:
            raise EOFError("bitstream exhausted")
        plane = (f.coeff_y if comp == 0 else
                 f.coeff_cb if comp == 1 else f.coeff_cr)
        plane[py:py + width, px:px + width] = coeff_2d
        return True

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


# ---------------------------------------------------------------------------
# Inter PU syntax (TDecEntropy::decodePUWise :153, TDecSbac parseMergeFlag/
# parseMergeIndex/parseInterDir/parseRefFrmIdx/parseMvd/parseMVPIdx) grafted
# onto SliceDataParser.  Motion derivation runs inline via self.mvctx
# (decoder.mv.MvCtx), mirroring the reference's decode-time MV
# reconstruction.
# ---------------------------------------------------------------------------

def _pu_region(self, cu_x, cu_y, size, part_sz, pu_idx):
    from .mv import pu_geometry
    xp, yp, pw, ph = pu_geometry(part_sz, cu_x, cu_y, size, pu_idx)
    return xp // 4, yp // 4, pw // 4, ph // 4


def _set_pu(self, arr, ux, uy, uw, uh, value):
    arr[uy:uy + uh, ux:ux + uw] = value


def _decode_skip_cu(self, abs_part, depth):
    """Skip CU: implicit 2Nx2N merge (TDecCu::xDecodeCU skip branch)."""
    f = self.f
    ux, uy = self._unit_xy(abs_part)
    units = self._units_at_depth(depth)
    px, py = self._pel_xy(abs_part)
    size = f.ctu_size >> depth
    merge_idx = self._parse_merge_index()
    f.set_region(f.merge_idx, ux, uy, units, merge_idx)
    cand_dir, cand_mv, _n = self.mvctx.merge_candidates(
        px, py, size, SIZE_2Nx2N, 0, mrg_cand_idx=merge_idx)
    f.set_region(f.inter_dir, ux, uy, units, cand_dir[merge_idx])
    for lst in range(2):
        if self.sh.num_ref_idx[lst] > 0:
            ref, mv = cand_mv[merge_idx][lst]
            f.ref_idx[lst, uy:uy + units, ux:ux + units] = ref
            f.mv[lst, uy:uy + units, ux:ux + units] = mv
            f.mvd[lst, uy:uy + units, ux:ux + units] = 0
            f.mvp_idx[lst, uy:uy + units, ux:ux + units] = 0
        else:
            f.ref_idx[lst, uy:uy + units, ux:ux + units] = -1
            f.mv[lst, uy:uy + units, ux:ux + units] = 0
    f.cbf[:, uy:uy + units, ux:ux + units] = 0
    f.tr_idx[uy:uy + units, ux:ux + units] = 0


def _parse_merge_index(self):
    """parseMergeIndex (TDecSbac.cpp)."""
    num_cand = self.sh.max_num_merge_cand
    idx = 0
    if num_cand > 1:
        while idx < num_cand - 1:
            if idx == 0:
                sym = self.dec.decode_bin(cc.O_MERGE_IDX)
            else:
                sym = self.dec.decode_bin_ep()
            if sym == 0:
                break
            idx += 1
    _trace(f"parseMergeIndex()\tuiMRGIdx= {idx}")
    return idx


def _parse_pu_wise(self, abs_part, depth):
    """decodePUWise for a non-skip inter CU."""
    from .mv import num_pus
    f = self.f
    ux, uy = self._unit_xy(abs_part)
    px, py = self._pel_xy(abs_part)
    size = f.ctu_size >> depth
    part_sz = int(f.part_size_arr[uy, ux])
    n_pu = num_pus(part_sz)
    is_b = self.sh.slice_type == 0

    for pu in range(n_pu):
        rux, ruy, ruw, ruh = self._pu_region(px, py, size, part_sz, pu)
        # merge flag
        merge = self.dec.decode_bin(cc.O_MERGE_FLAG)
        _trace(f"MergeFlag: {merge}\tuiAbsPartIdx: x")
        self._set_pu(f.merge_flag, rux, ruy, ruw, ruh, bool(merge))
        if merge:
            merge_idx = self._parse_merge_index()
            self._set_pu(f.merge_idx, rux, ruy, ruw, ruh, merge_idx)
            cand_dir, cand_mv, _n = self.mvctx.merge_candidates(
                px, py, size, part_sz, pu, mrg_cand_idx=merge_idx)
            self._set_pu(f.inter_dir, rux, ruy, ruw, ruh,
                         cand_dir[merge_idx])
            for lst in range(2):
                if self.sh.num_ref_idx[lst] > 0:
                    ref, mv = cand_mv[merge_idx][lst]
                    f.ref_idx[lst, ruy:ruy + ruh, rux:rux + ruw] = ref
                    f.mv[lst, ruy:ruy + ruh, rux:rux + ruw] = mv
                    f.mvd[lst, ruy:ruy + ruh, rux:rux + ruw] = 0
                    f.mvp_idx[lst, ruy:ruy + ruh, rux:rux + ruw] = 0
                else:
                    f.ref_idx[lst, ruy:ruy + ruh, rux:rux + ruw] = -1
                    f.mv[lst, ruy:ruy + ruh, rux:rux + ruw] = 0
        else:
            # inter dir
            if not is_b:
                inter_dir = 1
            else:
                ctx = depth  # getCtxInterDir = depth
                restrict = not (part_sz == SIZE_2Nx2N or size != 8)
                if restrict:
                    sym = 0
                else:
                    sym = self.dec.decode_bin(cc.O_INTER_DIR + ctx)
                if sym:
                    inter_dir = 3
                else:
                    inter_dir = 1 + int(self.dec.decode_bin(cc.O_INTER_DIR + 4))
            self._set_pu(f.inter_dir, rux, ruy, ruw, ruh, inter_dir)
            for lst in range(2):
                if self.sh.num_ref_idx[lst] <= 0:
                    f.ref_idx[lst, ruy:ruy + ruh, rux:rux + ruw] = -1
                    f.mv[lst, ruy:ruy + ruh, rux:rux + ruw] = 0
                    continue
                has_list = inter_dir & (1 << lst)
                # ref idx
                if self.sh.num_ref_idx[lst] > 1 and has_list:
                    ref_idx = self._parse_ref_idx(lst)
                elif has_list:
                    ref_idx = 0
                else:
                    ref_idx = -1
                f.ref_idx[lst, ruy:ruy + ruh, rux:rux + ruw] = ref_idx
                # mvd
                if has_list:
                    mvd = self._parse_mvd(lst, inter_dir)
                    f.mvd[lst, ruy:ruy + ruh, rux:rux + ruw] = mvd
                else:
                    mvd = (0, 0)
                    f.mvd[lst, ruy:ruy + ruh, rux:rux + ruw] = 0
                # mvp idx + AMVP
                if has_list:
                    mvp_idx = self.p.unary_max(
                        (cc.O_MVP_IDX, cc.O_MVP_IDX + 1), 1)
                else:
                    mvp_idx = -1
                f.mvp_idx[lst, ruy:ruy + ruh, rux:rux + ruw] = mvp_idx
                cands = self.mvctx.amvp_candidates(
                    px, py, size, part_sz, pu, lst, ref_idx)
                if ref_idx >= 0:
                    pred = cands[mvp_idx if mvp_idx >= 0 else 0]
                    mv = (int(pred[0]) + mvd[0], int(pred[1]) + mvd[1])
                else:
                    mv = (0, 0)
                f.mv[lst, ruy:ruy + ruh, rux:rux + ruw] = mv
        # bipred restriction (8x8 CU with sub-8x8 PUs)
        if int(f.inter_dir[ruy, rux]) == 3 and size == 8 and \
                part_sz != SIZE_2Nx2N:
            f.mv[1, ruy:ruy + ruh, rux:rux + ruw] = 0
            f.ref_idx[1, ruy:ruy + ruh, rux:rux + ruw] = -1
            self._set_pu(f.inter_dir, rux, ruy, ruw, ruh, 1)


def _parse_ref_idx(self, lst):
    """parseRefFrmIdx with REF_IDX_BYPASS."""
    sym = self.dec.decode_bin(cc.O_REF_PIC)
    if not sym:
        return 0
    ref_num = self.sh.num_ref_idx[lst] - 2
    ui = 0
    while ui < ref_num:
        if ui == 0:
            sym = self.dec.decode_bin(cc.O_REF_PIC + 1)
        else:
            sym = self.dec.decode_bin_ep()
        if sym == 0:
            break
        ui += 1
    return ui + 1


def _parse_mvd(self, lst, inter_dir):
    """parseMvd."""
    if self.sh.mvd_l1_zero_flag and lst == 1 and inter_dir == 3:
        return (0, 0)
    dec = self.dec
    hor = int(dec.decode_bin(cc.O_MVD))
    ver = int(dec.decode_bin(cc.O_MVD))
    hor_gr0, ver_gr0 = hor != 0, ver != 0
    if hor_gr0:
        hor += int(dec.decode_bin(cc.O_MVD + 1))
    if ver_gr0:
        ver += int(dec.decode_bin(cc.O_MVD + 1))
    hor_sign = ver_sign = 0
    if hor_gr0:
        if hor == 2:
            hor += int(self.p.ep_exgolomb(1))
        hor_sign = dec.decode_bin_ep()
    if ver_gr0:
        if ver == 2:
            ver += int(self.p.ep_exgolomb(1))
        ver_sign = dec.decode_bin_ep()
    return (-hor if hor_sign else hor, -ver if ver_sign else ver)


SliceDataParser._pu_region = _pu_region
SliceDataParser._set_pu = _set_pu
SliceDataParser._decode_skip_cu = _decode_skip_cu
SliceDataParser._parse_merge_index = _parse_merge_index
SliceDataParser._parse_pu_wise = _parse_pu_wise
SliceDataParser._parse_ref_idx = _parse_ref_idx
SliceDataParser._parse_mvd = _parse_mvd
