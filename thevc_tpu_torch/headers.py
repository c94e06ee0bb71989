"""VPS/SPS/PPS/slice-header read + write (fixed/Exp-Golomb syntax).

Behavioral reference: TDecCAVLC.cpp (parseVPS :770, parseSPS :595,
parsePPS :407, parseSliceHeader :791, parseShortTermRefPicSet :153) and the
mirrored writers in TEncCavlc.cpp.  This is the HM-8.x (JCTVC-J draft) syntax
— notably different from final H.265 (profile_tier_level, nal types, etc.).

Host-side by design: header syntax is a few hundred bits per picture.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from .bitstream import InputBitstream, OutputBitstream
from . import nal as nal_mod
from .params import (B_SLICE, I_SLICE, P_SLICE, Pps, ReferencePictureSet,
                     SliceHeader, Sps, Vps)
from .common import scaling

MRG_MAX_NUM_CANDS = 5


# ---------------------------------------------------------------------------
# Short-term reference picture sets
# ---------------------------------------------------------------------------

def parse_short_term_rps(bs: InputBitstream, sps: Sps,
                         idx: int, num_sps_rps: int) -> ReferencePictureSet:
    """TDecCavlc::parseShortTermRefPicSet (TDecCAVLC.cpp:153).

    delta_idx_minus1 is only present for the slice-header-coded RPS
    (idx == num_short_term_ref_pic_sets); SPS-list entries predict from
    the immediately preceding set (J0234_INTER_RPS_SIMPL).
    """
    rps = ReferencePictureSet()
    rps.inter_rps_prediction = bool(bs.read_flag())
    if rps.inter_rps_prediction:
        if idx == num_sps_rps:
            delta_idx_minus1 = bs.read_ue()
        else:
            delta_idx_minus1 = 0
        rps.delta_ridx_minus1 = delta_idx_minus1
        r_idx = idx - 1 - delta_idx_minus1
        assert 0 <= r_idx <= idx - 1
        rps_ref = sps.rps_list[r_idx]
        sign = bs.read(1)
        abs_delta_minus1 = bs.read_ue()
        delta_rps = (1 - (sign << 1)) * (abs_delta_minus1 + 1)
        k = k0 = k1 = 0
        num_ref = rps_ref.num_negative_pics + rps_ref.num_positive_pics
        rps.delta_poc = [0] * 16
        rps.used = [False] * 16
        rps.ref_idc = []
        for j in range(num_ref + 1):
            ref_idc = bs.read(1)
            if ref_idc == 0:
                ref_idc = bs.read(1) << 1
            if ref_idc in (1, 2):
                delta_poc = delta_rps + (rps_ref.delta_poc[j] if j < num_ref else 0)
                rps.delta_poc[k] = delta_poc
                rps.used[k] = ref_idc == 1
                if delta_poc < 0:
                    k0 += 1
                else:
                    k1 += 1
                k += 1
            rps.ref_idc.append(ref_idc)
        rps.num_ref_idc = num_ref + 1
        rps.delta_rps = delta_rps
        rps.num_negative_pics = k0
        rps.num_positive_pics = k1
        rps.sort_delta_poc()
        rps.delta_poc = rps.delta_poc[:k]
        rps.used = rps.used[:k]
    else:
        rps.num_negative_pics = bs.read_ue()
        rps.num_positive_pics = bs.read_ue()
        rps.delta_poc = []
        rps.used = []
        prev = 0
        for _ in range(rps.num_negative_pics):
            prev = prev - bs.read_ue() - 1
            rps.delta_poc.append(prev)
            rps.used.append(bool(bs.read_flag()))
        prev = 0
        for _ in range(rps.num_positive_pics):
            prev = prev + bs.read_ue() + 1
            rps.delta_poc.append(prev)
            rps.used.append(bool(bs.read_flag()))
    return rps


def write_short_term_rps(bs: OutputBitstream, rps: ReferencePictureSet,
                         idx: int, num_sps_rps: int) -> None:
    """Mirror of TEncCavlc::codeShortTermRefPicSet."""
    bs.write_flag(rps.inter_rps_prediction)
    if rps.inter_rps_prediction:
        if idx == num_sps_rps:
            # explicit slice-header RPS predicts from an SPS RPS
            # (TEncCavlc.cpp:189, J0234_INTER_RPS_SIMPL)
            bs.write_ue(rps.delta_ridx_minus1)
        sign = 1 if rps.delta_rps < 0 else 0
        bs.write(sign, 1)
        bs.write_ue(abs(rps.delta_rps) - 1)
        for j in range(rps.num_ref_idc):
            ref_idc = rps.ref_idc[j]
            bs.write(1 if ref_idc == 1 else 0, 1)
            if ref_idc != 1:
                bs.write(1 if ref_idc == 2 else 0, 1)
    else:
        bs.write_ue(rps.num_negative_pics)
        bs.write_ue(rps.num_positive_pics)
        prev = 0
        for j in range(rps.num_negative_pics):
            bs.write_ue(prev - rps.delta_poc[j] - 1)
            prev = rps.delta_poc[j]
            bs.write_flag(rps.used[j])
        prev = 0
        for j in range(rps.num_negative_pics,
                       rps.num_negative_pics + rps.num_positive_pics):
            bs.write_ue(rps.delta_poc[j] - prev - 1)
            prev = rps.delta_poc[j]
            bs.write_flag(rps.used[j])


# ---------------------------------------------------------------------------
# VPS
# ---------------------------------------------------------------------------

def parse_vps(bs: InputBitstream) -> Vps:
    vps = Vps()
    vps.max_t_layers = bs.read(3) + 1
    vps.max_layers = bs.read(5) + 1
    vps.vps_id = bs.read_ue()
    vps.temporal_id_nesting_flag = bool(bs.read_flag())
    for i in range(vps.max_t_layers):
        vps.max_dec_pic_buffering[i] = bs.read_ue()
        vps.num_reorder_pics[i] = bs.read_ue()
        vps.max_latency_increase[i] = bs.read_ue()
    ext = bs.read_flag()
    assert not ext
    return vps


def write_vps(vps: Vps) -> OutputBitstream:
    bs = OutputBitstream()
    bs.write(vps.max_t_layers - 1, 3)
    bs.write(vps.max_layers - 1, 5)
    bs.write_ue(vps.vps_id)
    bs.write_flag(vps.temporal_id_nesting_flag)
    for i in range(vps.max_t_layers):
        bs.write_ue(vps.max_dec_pic_buffering[i])
        bs.write_ue(vps.num_reorder_pics[i])
        bs.write_ue(vps.max_latency_increase[i])
    bs.write_flag(False)  # vps_extension_flag
    bs.write_rbsp_trailing_bits()
    return bs


# ---------------------------------------------------------------------------
# SPS
# ---------------------------------------------------------------------------

def parse_sps(bs: InputBitstream) -> Sps:
    sps = Sps()
    sps.profile_space = bs.read(3)
    sps.profile_idc = bs.read(5)
    sps.rsvd_ind_flags = bs.read(16)
    sps.level_idc = bs.read(8)
    sps.profile_compat = bs.read(32)
    sps.sps_id = bs.read_ue()
    sps.vps_id = bs.read_ue()
    sps.chroma_format_idc = bs.read_ue()
    sps.max_t_layers = bs.read(3) + 1
    sps.pic_width_in_luma_samples = bs.read_ue()
    sps.pic_height_in_luma_samples = bs.read_ue()
    sps.pic_cropping_flag = bool(bs.read_flag())
    if sps.pic_cropping_flag:
        # crop unit: 2 for 4:2:0 horizontally/vertically
        cux = 2 if sps.chroma_format_idc == 1 else 1
        cuy = 2 if sps.chroma_format_idc == 1 else 1
        sps.pic_crop_left_offset = bs.read_ue() * cux
        sps.pic_crop_right_offset = bs.read_ue() * cux
        sps.pic_crop_top_offset = bs.read_ue() * cuy
        sps.pic_crop_bottom_offset = bs.read_ue() * cuy
    inc = bs.read_ue()          # bit_depth_luma_minus8 (!FULL_NBIT semantics)
    sps.bit_depth = 8
    sps.bit_increment = inc
    sps.qp_bd_offset_y = 6 * inc
    inc_c = bs.read_ue()
    sps.qp_bd_offset_c = 6 * inc_c
    sps.use_pcm = bool(bs.read_flag())
    if sps.use_pcm:
        sps.pcm_bit_depth_luma = bs.read(4) + 1
        sps.pcm_bit_depth_chroma = bs.read(4) + 1
    sps.bits_for_poc = bs.read_ue() + 4
    for i in range(sps.max_t_layers):
        sps.max_dec_pic_buffering[i] = bs.read_ue()
        sps.num_reorder_pics[i] = bs.read_ue()
        sps.max_latency_increase[i] = bs.read_ue()
    sps.restricted_ref_pic_lists_flag = bool(bs.read_flag())
    if sps.restricted_ref_pic_lists_flag:
        sps.lists_modification_present_flag = bool(bs.read_flag())
    else:
        sps.lists_modification_present_flag = True
    log2_min_cu = bs.read_ue() + 3
    sps.log2_min_cu_size = log2_min_cu
    depth_correct = bs.read_ue()
    sps.max_cu_width = sps.max_cu_height = 1 << (log2_min_cu + depth_correct)
    sps.quadtree_tu_log2_min_size = bs.read_ue() + 2
    sps.quadtree_tu_log2_max_size = bs.read_ue() + sps.quadtree_tu_log2_min_size
    sps.max_tr_size = 1 << sps.quadtree_tu_log2_max_size
    if sps.use_pcm:
        sps.pcm_log2_min_size = bs.read_ue() + 3
        sps.pcm_log2_max_size = bs.read_ue() + sps.pcm_log2_min_size
    sps.quadtree_tu_max_depth_inter = bs.read_ue() + 1
    sps.quadtree_tu_max_depth_intra = bs.read_ue() + 1
    add_cu_depth = 0
    while (sps.max_cu_width >> depth_correct) > (1 << (sps.quadtree_tu_log2_min_size + add_cu_depth)):
        add_cu_depth += 1
    sps.add_cu_depth = add_cu_depth
    sps.max_cu_depth = depth_correct + add_cu_depth
    sps.scaling_list_enabled_flag = bool(bs.read_flag())
    if sps.scaling_list_enabled_flag:
        sps.scaling_list_present_flag = bool(bs.read_flag())
        if sps.scaling_list_present_flag:
            sps.scaling_list = scaling.parse_scaling_list(bs, False)
    sps.use_amp = bool(bs.read_flag())
    sps.use_sao = bool(bs.read_flag())
    if sps.use_pcm:
        sps.pcm_filter_disable_flag = bool(bs.read_flag())
    sps.temporal_id_nesting_flag = bool(bs.read_flag())
    num_rps = bs.read_ue()
    sps.rps_list = []
    for i in range(num_rps):
        sps.rps_list.append(parse_short_term_rps(bs, sps, i, num_rps))
    sps.long_term_refs_present = bool(bs.read_flag())
    sps.tmvp_flags_present = bool(bs.read_flag())
    sps.amvp_modes = [bs.read_flag() for _ in range(sps.max_cu_depth)]
    ext = bs.read_flag()
    if ext:
        raise NotImplementedError("sps_extension")
    return sps


def write_sps(sps: Sps) -> OutputBitstream:
    bs = OutputBitstream()
    bs.write(sps.profile_space, 3)
    bs.write(sps.profile_idc, 5)
    bs.write(sps.rsvd_ind_flags, 16)
    bs.write(sps.level_idc, 8)
    bs.write(sps.profile_compat, 32)
    bs.write_ue(sps.sps_id)
    bs.write_ue(sps.vps_id)
    bs.write_ue(sps.chroma_format_idc)
    bs.write(sps.max_t_layers - 1, 3)
    bs.write_ue(sps.pic_width_in_luma_samples)
    bs.write_ue(sps.pic_height_in_luma_samples)
    bs.write_flag(sps.pic_cropping_flag)
    if sps.pic_cropping_flag:
        cu = 2 if sps.chroma_format_idc == 1 else 1
        bs.write_ue(sps.pic_crop_left_offset // cu)
        bs.write_ue(sps.pic_crop_right_offset // cu)
        bs.write_ue(sps.pic_crop_top_offset // cu)
        bs.write_ue(sps.pic_crop_bottom_offset // cu)
    bs.write_ue(sps.bit_increment)
    bs.write_ue(sps.qp_bd_offset_c // 6)
    bs.write_flag(sps.use_pcm)
    if sps.use_pcm:
        bs.write(sps.pcm_bit_depth_luma - 1, 4)
        bs.write(sps.pcm_bit_depth_chroma - 1, 4)
    bs.write_ue(sps.bits_for_poc - 4)
    for i in range(sps.max_t_layers):
        bs.write_ue(sps.max_dec_pic_buffering[i])
        bs.write_ue(sps.num_reorder_pics[i])
        bs.write_ue(sps.max_latency_increase[i])
    bs.write_flag(sps.restricted_ref_pic_lists_flag)
    if sps.restricted_ref_pic_lists_flag:
        bs.write_flag(sps.lists_modification_present_flag)
    log2_min_cu = sps.log2_min_cu_size
    depth_correct = sps.max_cu_depth - sps.add_cu_depth
    bs.write_ue(log2_min_cu - 3)
    bs.write_ue(depth_correct)
    bs.write_ue(sps.quadtree_tu_log2_min_size - 2)
    bs.write_ue(sps.quadtree_tu_log2_max_size - sps.quadtree_tu_log2_min_size)
    if sps.use_pcm:
        bs.write_ue(sps.pcm_log2_min_size - 3)
        bs.write_ue(sps.pcm_log2_max_size - sps.pcm_log2_min_size)
    bs.write_ue(sps.quadtree_tu_max_depth_inter - 1)
    bs.write_ue(sps.quadtree_tu_max_depth_intra - 1)
    bs.write_flag(sps.scaling_list_enabled_flag)
    if sps.scaling_list_enabled_flag:
        bs.write_flag(sps.scaling_list_present_flag)
        if sps.scaling_list_present_flag:
            scaling.write_scaling_list(bs, sps.scaling_list)
    bs.write_flag(sps.use_amp)
    bs.write_flag(sps.use_sao)
    if sps.use_pcm:
        bs.write_flag(sps.pcm_filter_disable_flag)
    bs.write_flag(sps.temporal_id_nesting_flag)
    bs.write_ue(len(sps.rps_list))
    for i, rps in enumerate(sps.rps_list):
        write_short_term_rps(bs, rps, i, len(sps.rps_list))
    bs.write_flag(sps.long_term_refs_present)
    bs.write_flag(sps.tmvp_flags_present)
    for i in range(sps.max_cu_depth):
        bs.write_flag(sps.amvp_modes[i])
    bs.write_flag(False)  # sps_extension_flag
    bs.write_rbsp_trailing_bits()
    return bs


# ---------------------------------------------------------------------------
# PPS
# ---------------------------------------------------------------------------

def parse_pps(bs: InputBitstream) -> Pps:
    pps = Pps()
    pps.pps_id = bs.read_ue()
    pps.sps_id = bs.read_ue()
    pps.sign_hide_flag = bool(bs.read_flag())
    pps.cabac_init_present_flag = bool(bs.read_flag())
    pps.num_ref_idx_l0_default_active = bs.read_ue() + 1
    pps.num_ref_idx_l1_default_active = bs.read_ue() + 1
    pps.pic_init_qp_minus26 = bs.read_se()
    pps.constrained_intra_pred_flag = bool(bs.read_flag())
    pps.use_transform_skip = bool(bs.read_flag())
    pps.use_dqp = bool(bs.read_flag())
    if pps.use_dqp:
        pps.max_cu_dqp_depth = bs.read_ue()
    else:
        pps.max_cu_dqp_depth = 0
    pps.chroma_cb_qp_offset = bs.read_se()
    pps.chroma_cr_qp_offset = bs.read_se()
    pps.slice_chroma_qp_flag = bool(bs.read_flag())
    pps.use_wp = bool(bs.read_flag())
    pps.wp_bipred = bool(bs.read_flag())
    pps.output_flag_present_flag = bool(bs.read_flag())
    pps.dependent_slices_enabled_flag = bool(bs.read_flag())
    pps.transquant_bypass_enable_flag = bool(bs.read_flag())
    pps.tiles_or_entropy_coding_sync_idc = bs.read(2)
    if pps.tiles_or_entropy_coding_sync_idc == 1:
        pps.num_tile_columns_minus1 = bs.read_ue()
        pps.num_tile_rows_minus1 = bs.read_ue()
        pps.uniform_spacing_flag = bool(bs.read_flag())
        if not pps.uniform_spacing_flag:
            pps.column_widths = [bs.read_ue() for _ in range(pps.num_tile_columns_minus1)]
            pps.row_heights = [bs.read_ue() for _ in range(pps.num_tile_rows_minus1)]
        if pps.num_tile_columns_minus1 or pps.num_tile_rows_minus1:
            pps.lf_cross_tile_boundary_flag = bool(bs.read_flag())
    elif pps.tiles_or_entropy_coding_sync_idc == 3:
        pps.cabac_independent_flag = bool(bs.read_flag())
    pps.lf_cross_slice_boundary_flag = bool(bs.read_flag())
    pps.deblocking_filter_control_present = bool(bs.read_flag())
    if pps.deblocking_filter_control_present:
        pps.loop_filter_offset_in_pps = bool(bs.read_flag())
        if pps.loop_filter_offset_in_pps:
            pps.loop_filter_disable = bool(bs.read_flag())
            if not pps.loop_filter_disable:
                pps.loop_filter_beta_offset = bs.read_se()
                pps.loop_filter_tc_offset = bs.read_se()
    pps.scaling_list_present_flag = bool(bs.read_flag())
    if pps.scaling_list_present_flag:
        pps.scaling_list = scaling.parse_scaling_list(bs, False)
    pps.log2_parallel_merge_level_minus2 = bs.read_ue()
    pps.slice_header_extension_present_flag = bool(bs.read_flag())
    ext = bs.read_flag()
    if ext:
        raise NotImplementedError("pps_extension")
    return pps


def write_pps(pps: Pps) -> OutputBitstream:
    bs = OutputBitstream()
    bs.write_ue(pps.pps_id)
    bs.write_ue(pps.sps_id)
    bs.write_flag(pps.sign_hide_flag)
    bs.write_flag(pps.cabac_init_present_flag)
    bs.write_ue(pps.num_ref_idx_l0_default_active - 1)
    bs.write_ue(pps.num_ref_idx_l1_default_active - 1)
    bs.write_se(pps.pic_init_qp_minus26)
    bs.write_flag(pps.constrained_intra_pred_flag)
    bs.write_flag(pps.use_transform_skip)
    bs.write_flag(pps.use_dqp)
    if pps.use_dqp:
        bs.write_ue(pps.max_cu_dqp_depth)
    bs.write_se(pps.chroma_cb_qp_offset)
    bs.write_se(pps.chroma_cr_qp_offset)
    bs.write_flag(pps.slice_chroma_qp_flag)
    bs.write_flag(pps.use_wp)
    bs.write_flag(pps.wp_bipred)
    bs.write_flag(pps.output_flag_present_flag)
    bs.write_flag(pps.dependent_slices_enabled_flag)
    bs.write_flag(pps.transquant_bypass_enable_flag)
    bs.write(pps.tiles_or_entropy_coding_sync_idc, 2)
    if pps.tiles_or_entropy_coding_sync_idc == 1:
        bs.write_ue(pps.num_tile_columns_minus1)
        bs.write_ue(pps.num_tile_rows_minus1)
        bs.write_flag(pps.uniform_spacing_flag)
        if not pps.uniform_spacing_flag:
            for w in pps.column_widths:
                bs.write_ue(w)
            for h in pps.row_heights:
                bs.write_ue(h)
        if pps.num_tile_columns_minus1 or pps.num_tile_rows_minus1:
            bs.write_flag(pps.lf_cross_tile_boundary_flag)
    elif pps.tiles_or_entropy_coding_sync_idc == 3:
        bs.write_flag(pps.cabac_independent_flag)
    bs.write_flag(pps.lf_cross_slice_boundary_flag)
    bs.write_flag(pps.deblocking_filter_control_present)
    if pps.deblocking_filter_control_present:
        bs.write_flag(pps.loop_filter_offset_in_pps)
        if pps.loop_filter_offset_in_pps:
            bs.write_flag(pps.loop_filter_disable)
            if not pps.loop_filter_disable:
                bs.write_se(pps.loop_filter_beta_offset)
                bs.write_se(pps.loop_filter_tc_offset)
    bs.write_flag(pps.scaling_list_present_flag)
    if pps.scaling_list_present_flag:
        scaling.write_scaling_list(bs, pps.scaling_list)
    bs.write_ue(pps.log2_parallel_merge_level_minus2)
    bs.write_flag(pps.slice_header_extension_present_flag)
    bs.write_flag(False)  # pps_extension_flag
    bs.write_rbsp_trailing_bits()
    return bs


# ---------------------------------------------------------------------------
# Slice header
# ---------------------------------------------------------------------------

def parse_slice_header(bs: InputBitstream, nal_type: int, temporal_id: int,
                       sps_map: Dict[int, Sps], pps_map: Dict[int, Pps],
                       prev_poc: int = 0,
                       prev_slice: Optional[SliceHeader] = None) -> Tuple[SliceHeader, Sps, Pps]:
    """TDecCavlc::parseSliceHeader (TDecCAVLC.cpp:791)."""
    sh = SliceHeader(nal_unit_type=nal_type, temporal_id=temporal_id)
    sh.first_slice_in_pic = bool(bs.read_flag())
    if nal_type in (nal_mod.NAL_UNIT_CODED_SLICE_IDR,
                    nal_mod.NAL_UNIT_CODED_SLICE_BLANT,
                    nal_mod.NAL_UNIT_CODED_SLICE_BLA,
                    nal_mod.NAL_UNIT_CODED_SLICE_CRANT,
                    nal_mod.NAL_UNIT_CODED_SLICE_CRA):
        bs.read_flag()  # no_output_of_prior_pics_flag, ignored
    sh.pps_id = bs.read_ue()
    pps = pps_map[sh.pps_id]
    sps = sps_map[pps.sps_id]

    num_cus = sps.num_ctus
    max_parts = sps.num_partitions
    req_bits_outer = 0
    while num_cus > (1 << req_bits_outer):
        req_bits_outer += 1
    lcu_address = 0
    if not sh.first_slice_in_pic:
        lcu_address = bs.read(req_bits_outer)
    start_addr = max_parts * lcu_address
    sh.dependent_slice_start_cu_addr = start_addr
    sh.dependent_slice_end_cu_addr = num_cus * max_parts

    sh.slice_type = bs.read_ue()
    sh.dependent_slice = bool(bs.read_flag())
    if pps.dependent_slices_enabled_flag and sh.dependent_slice:
        bs.read_out_trailing_bits()
        if prev_slice is None:
            raise ValueError("dependent slice without preceding slice")
        return sh, sps, pps

    sh.slice_cur_start_cu_addr = start_addr
    sh.slice_cur_end_cu_addr = num_cus * max_parts

    if pps.output_flag_present_flag:
        sh.pic_output_flag = bool(bs.read_flag())
    else:
        sh.pic_output_flag = True

    if nal_type == nal_mod.NAL_UNIT_CODED_SLICE_IDR:
        sh.poc = 0
        sh.rps = ReferencePictureSet()
    else:
        poc_lsb = bs.read(sps.bits_for_poc)
        max_poc_lsb = 1 << sps.bits_for_poc
        prev_poc_lsb = prev_poc % max_poc_lsb
        prev_poc_msb = prev_poc - prev_poc_lsb
        if poc_lsb < prev_poc_lsb and (prev_poc_lsb - poc_lsb) >= (max_poc_lsb // 2):
            poc_msb = prev_poc_msb + max_poc_lsb
        elif poc_lsb > prev_poc_lsb and (poc_lsb - prev_poc_lsb) > (max_poc_lsb // 2):
            poc_msb = prev_poc_msb - max_poc_lsb
        else:
            poc_msb = prev_poc_msb
        if nal_type in (nal_mod.NAL_UNIT_CODED_SLICE_BLA,
                        nal_mod.NAL_UNIT_CODED_SLICE_BLANT):
            poc_msb = 0
        sh.poc = poc_msb + poc_lsb

        if not bs.read_flag():  # short_term_ref_pic_set_sps_flag == 0
            sh.rps = parse_short_term_rps(bs, sps, len(sps.rps_list),
                                          len(sps.rps_list))
            sh.rps_idx = -1
        else:
            sh.rps_idx = bs.read_ue()
            sh.rps = sps.rps_list[sh.rps_idx]
        if sps.long_term_refs_present:
            rps = sh.rps
            offset = rps.num_negative_pics + rps.num_positive_pics
            num_lt = bs.read_ue()
            rps.num_longterm_pics = num_lt
            # extend arrays
            need = offset + num_lt
            rps.delta_poc += [0] * (need - len(rps.delta_poc))
            rps.used += [False] * (need - len(rps.used))
            rps.poc = [0] * need
            rps.check_lt_msb = [False] * need
            max_poc_lsb = 1 << sps.bits_for_poc
            prev_lsb = 0
            prev_delta_msb = 0
            delta_poc_msb_cycle = 0
            for j in range(offset + num_lt - 1, offset - 1, -1):
                poc_lsb_lt = bs.read(sps.bits_for_poc)
                msb_present = bool(bs.read_flag())
                if msb_present:
                    v = bs.read_ue()
                    delta_flag = (j == offset + num_lt - 1) or (poc_lsb_lt != prev_lsb)
                    delta_poc_msb_cycle = v if delta_flag else v + prev_delta_msb
                    poc_lt = (sh.poc - delta_poc_msb_cycle * max_poc_lsb
                              - (sh.poc % max_poc_lsb) + poc_lsb_lt)
                    rps.poc[j] = poc_lt
                    rps.delta_poc[j] = -sh.poc + poc_lt
                    rps.check_lt_msb[j] = True
                else:
                    rps.poc[j] = poc_lsb_lt
                    rps.delta_poc[j] = -sh.poc + poc_lsb_lt
                    rps.check_lt_msb[j] = False
                rps.used[j] = bool(bs.read_flag())
                prev_lsb = poc_lsb_lt
                prev_delta_msb = delta_poc_msb_cycle
        if nal_type in (nal_mod.NAL_UNIT_CODED_SLICE_BLA,
                        nal_mod.NAL_UNIT_CODED_SLICE_BLANT):
            sh.rps = ReferencePictureSet()

    if sps.use_sao:
        sh.sao_enabled = bool(bs.read_flag())
        if sh.sao_enabled:
            sh.sao_enabled_chroma = bool(bs.read_flag())
        else:
            sh.sao_enabled_chroma = False

    if sh.slice_type != I_SLICE:
        if sps.tmvp_flags_present:
            sh.tmvp_enabled = bool(bs.read_flag())
        else:
            sh.tmvp_enabled = False
        if bs.read_flag():  # num_ref_idx_active_override_flag
            sh.num_ref_idx[0] = bs.read_ue() + 1
            if sh.slice_type == B_SLICE:
                sh.num_ref_idx[1] = bs.read_ue() + 1
            else:
                sh.num_ref_idx[1] = 0
        else:
            sh.num_ref_idx[0] = pps.num_ref_idx_l0_default_active
            sh.num_ref_idx[1] = (pps.num_ref_idx_l1_default_active
                                 if sh.slice_type == B_SLICE else 0)

        # ref_pic_list_modification
        num_rps_curr = _num_rps_curr_temp_list(sh)
        for lx in range(2):
            if lx == 1 and sh.slice_type != B_SLICE:
                break
            if not sps.lists_modification_present_flag:
                sh.ref_pic_list_modification_flag[lx] = False
                continue
            sh.ref_pic_list_modification_flag[lx] = bool(bs.read_flag())
            if sh.ref_pic_list_modification_flag[lx]:
                sh.ref_pic_set_idx[lx] = []
                if num_rps_curr > 1:
                    length = 1
                    tmp = num_rps_curr - 1
                    while tmp >> 1:
                        tmp >>= 1
                        length += 1
                    for _ in range(sh.num_ref_idx[lx]):
                        sh.ref_pic_set_idx[lx].append(bs.read(length))
                else:
                    sh.ref_pic_set_idx[lx] = [0] * sh.num_ref_idx[lx]

    if sh.slice_type == B_SLICE:
        sh.mvd_l1_zero_flag = bool(bs.read_flag())

    sh.cabac_init_flag = False
    if pps.cabac_init_present_flag and sh.slice_type != I_SLICE:
        sh.cabac_init_flag = bool(bs.read_flag())

    sh.slice_qp = 26 + pps.pic_init_qp_minus26 + bs.read_se()
    if pps.slice_chroma_qp_flag:
        sh.slice_qp_delta_cb = bs.read_se()
        sh.slice_qp_delta_cr = bs.read_se()

    if pps.deblocking_filter_control_present:
        if pps.loop_filter_offset_in_pps:
            sh.inherit_dbl_param_from_pps = bool(bs.read_flag())
        if not sh.inherit_dbl_param_from_pps:
            sh.loop_filter_disable = bool(bs.read_flag())
            if not sh.loop_filter_disable:
                sh.loop_filter_beta_offset = bs.read_se()
                sh.loop_filter_tc_offset = bs.read_se()
        else:
            sh.loop_filter_disable = pps.loop_filter_disable
            sh.loop_filter_beta_offset = pps.loop_filter_beta_offset
            sh.loop_filter_tc_offset = pps.loop_filter_tc_offset

    if sh.tmvp_enabled:
        if sh.slice_type == B_SLICE:
            sh.col_dir = bs.read_flag()
        if sh.slice_type != I_SLICE and (
                (sh.col_dir == 0 and sh.num_ref_idx[0] > 1) or
                (sh.col_dir == 1 and sh.num_ref_idx[1] > 1)):
            sh.col_ref_idx = bs.read_ue()

    if (pps.use_wp and sh.slice_type == P_SLICE) or \
            (pps.wp_bipred and sh.slice_type == B_SLICE):
        _parse_pred_weight_table(bs, sh, sps)

    sh.max_num_merge_cand = MRG_MAX_NUM_CANDS - bs.read_ue()

    is_sao = sps.use_sao and sh.sao_enabled
    is_dbf = not sh.loop_filter_disable
    if pps.lf_cross_slice_boundary_flag and (is_sao or is_dbf):
        sh.lf_cross_slice_boundary_flag = bool(bs.read_flag())
    else:
        sh.lf_cross_slice_boundary_flag = pps.lf_cross_slice_boundary_flag

    if not pps.dependent_slices_enabled_flag:
        if pps.tiles_or_entropy_coding_sync_idc > 0:
            sh.num_entry_point_offsets = bs.read_ue()
            offset_len_minus1 = bs.read_ue() if sh.num_entry_point_offsets else 0
            sh.entry_point_offsets = [bs.read(offset_len_minus1 + 1)
                                      for _ in range(sh.num_entry_point_offsets)]
            if pps.tiles_or_entropy_coding_sync_idc == 1:
                pos = 0
                sh.tile_locations = []
                for off in sh.entry_point_offsets:
                    sh.tile_locations.append(pos + off)
                    pos += off
            elif pps.tiles_or_entropy_coding_sync_idc == 2:
                n = pps.num_substreams
                sh.substream_sizes = [
                    (sh.entry_point_offsets[i] << 3)
                    if i < sh.num_entry_point_offsets else 0
                    for i in range(n - 1)]

    if pps.slice_header_extension_present_flag:
        ext_len = bs.read_ue()
        for _ in range(ext_len):
            bs.read(8)

    bs.read_out_trailing_bits()
    return sh, sps, pps


def _num_rps_curr_temp_list(sh: SliceHeader) -> int:
    """TComSlice::getNumRpsCurrTempList — count of used pics in the RPS."""
    if sh.slice_type == I_SLICE:
        return 0
    rps = sh.rps
    return sum(1 for i in range(rps.num_negative_pics + rps.num_positive_pics
                                + rps.num_longterm_pics) if rps.used[i])


def _write_pred_weight_table(bs: OutputBitstream, sh: SliceHeader,
                             sps: Sps) -> None:
    """TEncCavlc::xCodePredWeightTable (TEncCavlc.cpp:1339)."""
    w = sh.wp_scaling
    luma_denom = w["luma_log2_denom"]
    chroma_denom = w["chroma_log2_denom"]
    num_lists = 2 if sh.slice_type == B_SLICE else 1
    denom_coded = False
    for lx in range(num_lists):
        for i in range(sh.num_ref_idx[lx]):
            if not denom_coded:
                bs.write_ue(luma_denom)
                bs.write_se(chroma_denom - luma_denom)
                denom_coded = True
            bs.write_flag(w["wp"][lx][i][0][0])
        for i in range(sh.num_ref_idx[lx]):
            bs.write_flag(w["wp"][lx][i][1][0])
        for i in range(sh.num_ref_idx[lx]):
            present, wt, off = w["wp"][lx][i][0]
            if present:
                bs.write_se(wt - (1 << luma_denom))
                bs.write_se(off)
            if w["wp"][lx][i][1][0]:
                half = 1 << (sps.internal_bit_depth - 1)
                for c in (1, 2):
                    _p, cw, co = w["wp"][lx][i][c]
                    bs.write_se(cw - (1 << chroma_denom))
                    pred = half - ((half * cw) >> chroma_denom)
                    bs.write_se(co - pred)


def _parse_pred_weight_table(bs: InputBitstream, sh: SliceHeader, sps: Sps) -> None:
    """TDecCavlc::xParsePredWeightTable — explicit WP parameters."""
    wp = [[[None] * 3 for _ in range(16)] for _ in range(2)]
    luma_log2_denom = bs.read_ue()
    chroma_log2_denom = 0
    if sps.chroma_format_idc:
        chroma_log2_denom = luma_log2_denom + bs.read_se()
    num_lists = 2 if sh.slice_type == B_SLICE else 1
    for lx in range(num_lists):
        luma_flags = [bool(bs.read_flag()) for _ in range(sh.num_ref_idx[lx])]
        chroma_flags = [False] * sh.num_ref_idx[lx]
        if sps.chroma_format_idc:
            chroma_flags = [bool(bs.read_flag()) for _ in range(sh.num_ref_idx[lx])]
        for i in range(sh.num_ref_idx[lx]):
            if luma_flags[i]:
                dw = bs.read_se()
                off = bs.read_se()
                wp[lx][i][0] = (True, (1 << luma_log2_denom) + dw, off)
            else:
                wp[lx][i][0] = (False, 1 << luma_log2_denom, 0)
            for c in (1, 2):
                if chroma_flags[i]:
                    dw = bs.read_se()
                    doff = bs.read_se()
                    w = (1 << chroma_log2_denom) + dw
                    # offset prediction + range limit (TDecCAVLC.cpp:1820-
                    # 1828, WP_PARAM_RANGE_LIMIT)
                    half = 1 << (sps.internal_bit_depth - 1)
                    pred = half - ((half * w) >> chroma_log2_denom)
                    off = max(-128, min(127, doff + pred))
                    wp[lx][i][c] = (True, w, off)
                else:
                    wp[lx][i][c] = (False, 1 << chroma_log2_denom, 0)
    sh.wp_scaling = {"luma_log2_denom": luma_log2_denom,
                     "chroma_log2_denom": chroma_log2_denom, "wp": wp}


# ---------------------------------------------------------------------------
# SEI
# ---------------------------------------------------------------------------

SEI_USER_DATA_UNREGISTERED = 5
SEI_PICTURE_DIGEST = 256

DIGEST_METHOD_MD5 = 0
DIGEST_METHOD_CRC = 1
DIGEST_METHOD_CHECKSUM = 2
_DIGEST_LEN = {DIGEST_METHOD_MD5: 16, DIGEST_METHOD_CRC: 2,
               DIGEST_METHOD_CHECKSUM: 4}


def parse_sei_rbsp(rbsp: bytes) -> list:
    """Parse all SEI messages in an SEI NAL (SEIread.cpp:46)."""
    bs = InputBitstream(rbsp)
    out = []
    while True:
        payload_type = 0
        while True:
            b = bs.read(8)
            payload_type += b
            if b != 0xFF:
                break
        payload_size = 0
        while True:
            b = bs.read(8)
            payload_size += b
            if b != 0xFF:
                break
        if payload_type == SEI_PICTURE_DIGEST:
            method = bs.read(8)
            n = _DIGEST_LEN[method]
            digest = [bytes(bs.read(8) for _ in range(n)) for _ in range(3)]
            out.append({"type": "picture_digest", "method": method,
                        "digest": digest})
        elif payload_type == SEI_USER_DATA_UNREGISTERED:
            uuid = bytes(bs.read(8) for _ in range(16))
            data = bytes(bs.read(8) for _ in range(payload_size - 16))
            out.append({"type": "user_data_unregistered", "uuid": uuid,
                        "data": data})
        else:
            for _ in range(payload_size):
                bs.read(8)
            out.append({"type": "unknown", "payload_type": payload_type})
        if bs.num_bits_left <= 8 or bs.pseudo_read(8) == 0x80:
            break
    return out


def write_sei_picture_digest(method: int, digest: list) -> OutputBitstream:
    """SEIwrite.cpp: picture_digest payload, type 256, + trailing bits."""
    bs = OutputBitstream()
    # payload type 256 -> ff 01
    bs.write(0xFF, 8)
    bs.write(256 - 255, 8)
    n = _DIGEST_LEN[method]
    bs.write(1 + 3 * n, 8)  # payload size
    bs.write(method, 8)
    for plane_digest in digest:
        for byte in plane_digest[:n]:
            bs.write(byte, 8)
    bs.write_rbsp_trailing_bits()
    return bs


# ---------------------------------------------------------------------------
# Slice header writer
# ---------------------------------------------------------------------------

def write_slice_header(sh: SliceHeader, sps: Sps, pps: Pps,
                       last_idr_poc: int = 0) -> OutputBitstream:
    """Mirror of TEncCavlc::codeSliceHeader (TEncCavlc.cpp:534).

    Does NOT include the byte alignment or substream data; the caller
    appends write_align_one + the CABAC substream (TEncGOP.cpp:1809).
    """
    bs = OutputBitstream()
    num_cus = sps.num_ctus
    req_bits_outer = 0
    while num_cus > (1 << req_bits_outer):
        req_bits_outer += 1
    # multi-slice encoder passes the raster LCU address explicitly (slice
    # start addresses are kept in encode/tile-scan order internally)
    address = getattr(sh, "write_lcu_address", None)
    if address is None:
        address = sh.slice_cur_start_cu_addr // sps.num_partitions \
            if not sh.dependent_slice else \
            sh.dependent_slice_start_cu_addr // sps.num_partitions
    bs.write_flag(address == 0)
    if sh.nal_unit_type in (nal_mod.NAL_UNIT_CODED_SLICE_IDR,
                            nal_mod.NAL_UNIT_CODED_SLICE_BLANT,
                            nal_mod.NAL_UNIT_CODED_SLICE_BLA,
                            nal_mod.NAL_UNIT_CODED_SLICE_CRANT,
                            nal_mod.NAL_UNIT_CODED_SLICE_CRA):
        bs.write_flag(False)  # no_output_of_prior_pics_flag
    bs.write_ue(sh.pps_id)
    if address > 0:
        bs.write(address, req_bits_outer)  # reqBitsInner == 0 (REMOVE_FGS)

    bs.write_ue(sh.slice_type)
    bs.write_flag(sh.dependent_slice)
    if pps.dependent_slices_enabled_flag and sh.dependent_slice:
        return bs

    if pps.output_flag_present_flag:
        bs.write_flag(sh.pic_output_flag)
    if sh.nal_unit_type != nal_mod.NAL_UNIT_CODED_SLICE_IDR:
        max_poc_lsb = 1 << sps.bits_for_poc
        poc_lsb = (sh.poc - last_idr_poc + max_poc_lsb) % max_poc_lsb
        bs.write(poc_lsb, sps.bits_for_poc)
        if sh.rps_idx < 0:
            bs.write_flag(False)
            write_short_term_rps(bs, sh.rps, len(sps.rps_list),
                                 len(sps.rps_list))
        else:
            bs.write_flag(True)
            bs.write_ue(sh.rps_idx)
        if sps.long_term_refs_present:
            # TEncCavlc.cpp:646-682 (LT entries pre-arranged by
            # arrange_longterm_pictures_in_rps)
            rps = sh.rps
            bs.write_ue(rps.num_longterm_pics)
            prev_delta_msb = prev_lsb = 0
            offset = rps.num_negative_pics + rps.num_positive_pics
            for i in range(rps.num_pics - 1, offset - 1, -1):
                bs.write(rps.poc_lsb_lt[i], sps.bits_for_poc)
                bs.write_flag(rps.delta_poc_msb_present[i])
                if rps.delta_poc_msb_present[i]:
                    delta_flag = (i == rps.num_pics - 1
                                  or rps.poc_lsb_lt[i] != prev_lsb)
                    if delta_flag:
                        bs.write_ue(rps.delta_poc_msb_cycle[i])
                    else:
                        diff = rps.delta_poc_msb_cycle[i] - prev_delta_msb
                        assert diff >= 0
                        bs.write_ue(diff)
                    prev_lsb = rps.poc_lsb_lt[i]
                    prev_delta_msb = rps.delta_poc_msb_cycle[i]
                bs.write_flag(bool(rps.used[i]))

    if sps.use_sao:
        bs.write_flag(sh.sao_enabled)
        if sh.sao_enabled:
            bs.write_flag(sh.sao_enabled_chroma)

    if sh.slice_type != I_SLICE:
        if sps.tmvp_flags_present:
            bs.write_flag(sh.tmvp_enabled)
        override = (sh.num_ref_idx[0] != pps.num_ref_idx_l0_default_active
                    or (sh.slice_type == B_SLICE and
                        sh.num_ref_idx[1] != pps.num_ref_idx_l1_default_active))
        bs.write_flag(override)
        if override:
            bs.write_ue(sh.num_ref_idx[0] - 1)
            if sh.slice_type == B_SLICE:
                bs.write_ue(sh.num_ref_idx[1] - 1)
        if sps.lists_modification_present_flag:
            num_rps_curr = _num_rps_curr_temp_list(sh)
            for lx in range(2):
                if lx == 1 and sh.slice_type != B_SLICE:
                    break
                bs.write_flag(sh.ref_pic_list_modification_flag[lx])
                if sh.ref_pic_list_modification_flag[lx] and num_rps_curr > 1:
                    length = 1
                    tmp = num_rps_curr - 1
                    while tmp >> 1:
                        tmp >>= 1
                        length += 1
                    for idx in sh.ref_pic_set_idx[lx]:
                        bs.write(idx, length)

    if sh.slice_type == B_SLICE:
        bs.write_flag(sh.mvd_l1_zero_flag)

    if sh.slice_type != I_SLICE and pps.cabac_init_present_flag:
        bs.write_flag(sh.cabac_init_flag)

    bs.write_se(sh.slice_qp - (pps.pic_init_qp_minus26 + 26))
    if pps.slice_chroma_qp_flag:
        bs.write_se(sh.slice_qp_delta_cb)
        bs.write_se(sh.slice_qp_delta_cr)

    if pps.deblocking_filter_control_present:
        if pps.loop_filter_offset_in_pps:
            bs.write_flag(sh.inherit_dbl_param_from_pps)
        if not sh.inherit_dbl_param_from_pps:
            bs.write_flag(sh.loop_filter_disable)
            if not sh.loop_filter_disable:
                bs.write_se(sh.loop_filter_beta_offset)
                bs.write_se(sh.loop_filter_tc_offset)

    if sh.tmvp_enabled:
        if sh.slice_type == B_SLICE:
            bs.write_flag(bool(sh.col_dir))
        if sh.slice_type != I_SLICE and (
                (sh.col_dir == 0 and sh.num_ref_idx[0] > 1) or
                (sh.col_dir == 1 and sh.num_ref_idx[1] > 1)):
            bs.write_ue(sh.col_ref_idx)

    if (pps.use_wp and sh.slice_type == P_SLICE) or \
            (pps.wp_bipred and sh.slice_type == B_SLICE):
        _write_pred_weight_table(bs, sh, sps)

    bs.write_ue(MRG_MAX_NUM_CANDS - sh.max_num_merge_cand)

    is_sao = sps.use_sao and sh.sao_enabled
    is_dbf = not sh.loop_filter_disable
    if pps.lf_cross_slice_boundary_flag and (is_sao or is_dbf):
        bs.write_flag(sh.lf_cross_slice_boundary_flag)

    if not pps.dependent_slices_enabled_flag and \
            pps.tiles_or_entropy_coding_sync_idc > 0:
        bs.write_ue(sh.num_entry_point_offsets)
        if sh.num_entry_point_offsets:
            max_off = max(sh.entry_point_offsets)
            offset_len_minus1 = 0
            while max_off >= (1 << (offset_len_minus1 + 1)):
                offset_len_minus1 += 1
            bs.write_ue(offset_len_minus1)
            for off in sh.entry_point_offsets:
                bs.write(off, offset_len_minus1 + 1)

    if pps.slice_header_extension_present_flag:
        bs.write_ue(0)
    return bs
