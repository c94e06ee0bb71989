"""Parameter sets and slice header state (HM-8.x draft-era field set).

Behavioral reference: TComSlice.h (TComVPS/TComSPS/TComPPS/TComSlice field
inventories) and TDecCAVLC.cpp parse order.  Fields default to the values
TAppEncTop/TEncTop::xInitSPS would configure for the shipped cfg files.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

# Slice types (TypeDef.h: enum SliceType { B_SLICE, P_SLICE, I_SLICE })
B_SLICE = 0
P_SLICE = 1
I_SLICE = 2


@dataclass
class Vps:
    vps_id: int = 0
    max_t_layers: int = 1
    max_layers: int = 1
    temporal_id_nesting_flag: bool = False
    # per temporal layer
    max_dec_pic_buffering: List[int] = field(default_factory=lambda: [0] * 8)
    num_reorder_pics: List[int] = field(default_factory=lambda: [0] * 8)
    max_latency_increase: List[int] = field(default_factory=lambda: [0] * 8)


@dataclass
class ReferencePictureSet:
    """Short-term RPS (TComReferencePictureSet, TComSlice.h:70)."""
    num_negative_pics: int = 0
    num_positive_pics: int = 0
    num_longterm_pics: int = 0
    delta_poc: List[int] = field(default_factory=list)   # len >= neg+pos(+lt)
    used: List[bool] = field(default_factory=list)
    poc: List[int] = field(default_factory=list)         # absolute POCs (LT)
    check_lt_msb: List[bool] = field(default_factory=list)
    # long-term write fields, filled by arrange_longterm_pictures_in_rps
    # (TEncGOP.cpp:1849; written by TEncCavlc.cpp:646-682)
    poc_lsb_lt: List[int] = field(default_factory=list)
    delta_poc_msb_present: List[bool] = field(default_factory=list)
    delta_poc_msb_cycle: List[int] = field(default_factory=list)
    inter_rps_prediction: bool = False
    # inter-RPS bookkeeping (encoder side)
    delta_rps: int = 0
    num_ref_idc: int = 0
    ref_idc: List[int] = field(default_factory=list)
    delta_ridx_minus1: int = 0   # slice-header inter-RPS prediction index

    @property
    def num_pics(self) -> int:
        return self.num_negative_pics + self.num_positive_pics + self.num_longterm_pics

    def sort_delta_poc(self) -> None:
        """TComReferencePictureSet::sortDeltaPOC — negatives descending
        (closest first), then positives ascending."""
        st = self.num_negative_pics + self.num_positive_pics
        pairs = sorted(zip(self.delta_poc[:st], self.used[:st]))
        neg = [p for p in pairs if p[0] < 0][::-1]
        pos = [p for p in pairs if p[0] >= 0]
        ordered = neg + pos
        for i, (dp, u) in enumerate(ordered):
            self.delta_poc[i] = dp
            self.used[i] = u


@dataclass
class Sps:
    profile_space: int = 0
    profile_idc: int = 1
    rsvd_ind_flags: int = 0
    level_idc: int = 0
    profile_compat: int = 1
    sps_id: int = 0
    vps_id: int = 0
    chroma_format_idc: int = 1
    max_t_layers: int = 1
    pic_width_in_luma_samples: int = 0
    pic_height_in_luma_samples: int = 0
    pic_cropping_flag: bool = False
    pic_crop_left_offset: int = 0
    pic_crop_right_offset: int = 0
    pic_crop_top_offset: int = 0
    pic_crop_bottom_offset: int = 0
    bit_depth: int = 8          # g_uiBitDepth (always 8 with !FULL_NBIT)
    bit_increment: int = 0      # g_uiBitIncrement = internal depth - 8
    qp_bd_offset_y: int = 0
    qp_bd_offset_c: int = 0
    use_pcm: bool = False
    pcm_bit_depth_luma: int = 8
    pcm_bit_depth_chroma: int = 8
    bits_for_poc: int = 8
    max_dec_pic_buffering: List[int] = field(default_factory=lambda: [0] * 8)
    num_reorder_pics: List[int] = field(default_factory=lambda: [0] * 8)
    max_latency_increase: List[int] = field(default_factory=lambda: [0] * 8)
    restricted_ref_pic_lists_flag: bool = False
    lists_modification_present_flag: bool = True
    log2_min_cu_size: int = 3
    max_cu_width: int = 64
    max_cu_height: int = 64
    max_cu_depth: int = 4       # includes g_uiAddCUDepth
    add_cu_depth: int = 1
    quadtree_tu_log2_min_size: int = 2
    quadtree_tu_log2_max_size: int = 5
    max_tr_size: int = 32
    pcm_log2_min_size: int = 3
    pcm_log2_max_size: int = 5
    quadtree_tu_max_depth_inter: int = 3
    quadtree_tu_max_depth_intra: int = 3
    scaling_list_enabled_flag: bool = False
    scaling_list_present_flag: bool = False
    scaling_list: object = None
    use_amp: bool = True
    use_sao: bool = True
    pcm_filter_disable_flag: bool = False
    temporal_id_nesting_flag: bool = False
    rps_list: List[ReferencePictureSet] = field(default_factory=list)
    long_term_refs_present: bool = False
    tmvp_flags_present: bool = True
    amvp_modes: List[int] = field(default_factory=lambda: [1] * 8)

    @property
    def internal_bit_depth(self) -> int:
        return self.bit_depth + self.bit_increment

    @property
    def pic_width_in_ctus(self) -> int:
        return (self.pic_width_in_luma_samples + self.max_cu_width - 1) // self.max_cu_width

    @property
    def pic_height_in_ctus(self) -> int:
        return (self.pic_height_in_luma_samples + self.max_cu_height - 1) // self.max_cu_height

    @property
    def num_ctus(self) -> int:
        return self.pic_width_in_ctus * self.pic_height_in_ctus

    @property
    def num_partitions(self) -> int:
        """4x4 sub-parts per CTU (1 << (maxCUDepth << 1))."""
        return 1 << (self.max_cu_depth << 1)


@dataclass
class Pps:
    pps_id: int = 0
    sps_id: int = 0
    sign_hide_flag: bool = True
    cabac_init_present_flag: bool = True
    num_ref_idx_l0_default_active: int = 1
    num_ref_idx_l1_default_active: int = 1
    pic_init_qp_minus26: int = 0
    constrained_intra_pred_flag: bool = False
    use_transform_skip: bool = False
    use_dqp: bool = False
    max_cu_dqp_depth: int = 0
    chroma_cb_qp_offset: int = 0
    chroma_cr_qp_offset: int = 0
    slice_chroma_qp_flag: bool = False
    use_wp: bool = False
    wp_bipred: bool = False
    output_flag_present_flag: bool = False
    dependent_slices_enabled_flag: bool = False
    transquant_bypass_enable_flag: bool = False
    tiles_or_entropy_coding_sync_idc: int = 0
    num_tile_columns_minus1: int = 0
    num_tile_rows_minus1: int = 0
    uniform_spacing_flag: bool = False
    column_widths: List[int] = field(default_factory=list)
    row_heights: List[int] = field(default_factory=list)
    lf_cross_tile_boundary_flag: bool = True
    cabac_independent_flag: bool = False
    lf_cross_slice_boundary_flag: bool = True
    deblocking_filter_control_present: bool = False
    loop_filter_offset_in_pps: bool = False
    loop_filter_disable: bool = False
    loop_filter_beta_offset: int = 0
    loop_filter_tc_offset: int = 0
    scaling_list_present_flag: bool = False
    scaling_list: object = None
    log2_parallel_merge_level_minus2: int = 0
    slice_header_extension_present_flag: bool = False
    num_substreams: int = 1


@dataclass
class SliceHeader:
    """Per-slice state (subset of TComSlice relevant to parsing/recon)."""
    nal_unit_type: int = 0
    temporal_id: int = 0
    # byte/bin-constrained segmentation state (TComSlice m_uiSliceBits /
    # m_uiDependentSliceCounter / m_bFinalized)
    slice_bits: int = 0
    dependent_slice_counter: int = 0
    finalized: bool = False
    first_slice_in_pic: bool = True
    pps_id: int = 0
    dependent_slice: bool = False
    slice_type: int = I_SLICE
    poc: int = 0
    pic_output_flag: bool = True
    rps: Optional[ReferencePictureSet] = None
    rps_idx: int = -1            # -1 = explicit in slice header
    sao_enabled: bool = False
    sao_enabled_chroma: bool = False
    tmvp_enabled: bool = False
    num_ref_idx: List[int] = field(default_factory=lambda: [0, 0])
    ref_pic_list_modification_flag: List[bool] = field(default_factory=lambda: [False, False])
    ref_pic_set_idx: List[List[int]] = field(default_factory=lambda: [[], []])
    mvd_l1_zero_flag: bool = False
    cabac_init_flag: bool = False
    slice_qp: int = 26
    slice_qp_delta_cb: int = 0
    slice_qp_delta_cr: int = 0
    inherit_dbl_param_from_pps: bool = False
    loop_filter_disable: bool = False
    loop_filter_beta_offset: int = 0
    loop_filter_tc_offset: int = 0
    col_dir: int = 0            # collocated_from_l0_flag
    col_ref_idx: int = 0
    max_num_merge_cand: int = 5
    lf_cross_slice_boundary_flag: bool = True
    num_entry_point_offsets: int = 0
    entry_point_offsets: List[int] = field(default_factory=list)
    tile_locations: List[int] = field(default_factory=list)
    substream_sizes: List[int] = field(default_factory=list)
    slice_cur_start_cu_addr: int = 0
    slice_cur_end_cu_addr: int = 0
    dependent_slice_start_cu_addr: int = 0
    dependent_slice_end_cu_addr: int = 0
    # weighted prediction tables: wp[list][ref_idx][comp] -> (flag, weight, offset)
    wp_scaling: Optional[list] = None

    @property
    def is_intra(self) -> bool:
        return self.slice_type == I_SLICE

    @property
    def is_inter_b(self) -> bool:
        return self.slice_type == B_SLICE
