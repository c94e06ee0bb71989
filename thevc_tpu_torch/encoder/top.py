"""Encoder top level: parameter-set derivation, frame loop, AU assembly.

Behavioral reference: TEncTop.cpp (xInitSPS :463, xInitPPS :560, xInitRPS
:656), TAppEncTop.cpp (xInitLibCfg :68), TEncGOP.cpp (compressGOP :137 —
header NALs :680, slice NAL assembly :826-997, digest SEI :1149,
getNalUnitType :1728, xWriteTileLocationToSliceHeader :1809) and
TAppEncCfg.cpp xCheckParameter derivations.

A copy of ``thevc_tpu/encoder/top.py``.  The frame-parallel thread count
does not probe for a JAX device (it was ``ops.device.device_enabled``),
and ``Encoder`` takes the torch device of the fast-RD decision passes
(``encoder.fast_intra``, ``encoder.fast_inter``) and a
``DecisionStats`` that they add their wall times to; it hands both, and
the device copies of the reference pictures, to each picture's
``slice_encoder.PictureCompressor``.  ``device_apply`` runs the fast-RD
apply of intra slices on that device too (``encoder.fast_apply``), where
the reference read ``THEVC_FASTRD_DEVAPPLY``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import time

import numpy as np

from .. import headers
from .. import nal as nal_mod
from ..digest import calc_digest
from ..decoder.frame import FrameModel
from ..decoder.filters import deblock_frame, sao_frame
from ..io.yuv import YuvFrame, YuvReader, YuvWriter
from ..common import scaling as scaling_mod
from ..params import I_SLICE, P_SLICE, Pps, ReferencePictureSet, Sps, Vps
from ..decoder.mv import MvCtx
from ..decoder.refpic import Dpb, Picture, build_ref_lists, check_ldc
from ..ops import device as device_mod
from . import slice_encoder as se
from .fast_inter import RefCache
from .inter_search import InterSearch
from ..utils.cfg import EncoderCfg


def derive_params(cfg: EncoderCfg):
    """Build (Vps, Sps, Pps) exactly as TAppEncTop + TEncTop would."""
    if cfg.use_rate_ctrl:
        # TAppEncCfg.cpp:896-906: RC forces per-LCU delta-QP coding
        cfg.max_delta_qp = 2
        cfg.max_cu_dqp_depth = 0
    num_reorder, max_dpb = cfg.dpb_params()
    max_tl = cfg.max_temp_layer

    vps = Vps(max_t_layers=max_tl, max_layers=1)
    vps.num_reorder_pics = list(num_reorder)
    vps.max_dec_pic_buffering = list(max_dpb)

    internal_bd = cfg.internal_bit_depth or cfg.input_bit_depth
    sps = Sps()
    sps.pic_width_in_luma_samples = cfg.source_width
    sps.pic_height_in_luma_samples = cfg.source_height
    # cropping window (TEncTop::xInitSPS, TEncTop.cpp:467-474)
    sps.pic_cropping_flag = cfg.cropping_mode != 0
    if sps.pic_cropping_flag:
        sps.pic_crop_left_offset = cfg.crop_left
        sps.pic_crop_right_offset = cfg.crop_right
        sps.pic_crop_top_offset = cfg.crop_top
        sps.pic_crop_bottom_offset = cfg.crop_bottom
    sps.max_cu_width = cfg.max_cu_width
    sps.max_cu_height = cfg.max_cu_height
    # g_uiAddCUDepth derivation (TAppEncCfg.cpp:928-933)
    add = 0
    while (cfg.max_cu_width >> cfg.max_partition_depth) > \
            (1 << (cfg.qt_tu_log2_min + add)):
        add += 1
    sps.max_cu_depth = cfg.max_partition_depth + add
    sps.add_cu_depth = add + 1
    sps.pcm_log2_min_size = cfg.pcm_log2_min_size
    sps.use_pcm = bool(cfg.use_pcm)
    sps.pcm_log2_max_size = cfg.pcm_log2_max_size
    sps.quadtree_tu_log2_max_size = cfg.qt_tu_log2_max
    sps.quadtree_tu_log2_min_size = cfg.qt_tu_log2_min
    sps.quadtree_tu_max_depth_inter = cfg.qt_tu_max_depth_inter
    sps.quadtree_tu_max_depth_intra = cfg.qt_tu_max_depth_intra
    sps.tmvp_flags_present = cfg.tmvp_mode != 0  # TEncGOP.cpp:402-412
    sps.max_tr_size = 1 << cfg.qt_tu_log2_max
    sps.use_amp = bool(cfg.enable_amp)
    sps.bit_depth = 8
    sps.bit_increment = internal_bd - 8
    sps.qp_bd_offset_y = 6 * (internal_bd - 8)
    sps.qp_bd_offset_c = 6 * (internal_bd - 8)
    sps.use_sao = bool(cfg.use_sao)
    sps.max_t_layers = max_tl
    sps.temporal_id_nesting_flag = False
    sps.max_dec_pic_buffering = list(max_dpb)
    sps.num_reorder_pics = list(num_reorder)
    sps.max_latency_increase = [0] * 8
    pcm_bd = cfg.input_bit_depth if cfg.pcm_input_bit_depth_flag else internal_bd
    sps.pcm_bit_depth_luma = pcm_bd
    sps.pcm_bit_depth_chroma = pcm_bd
    sps.pcm_filter_disable_flag = bool(cfg.pcm_filter_disable_flag)
    sps.scaling_list_enabled_flag = cfg.scaling_list != 0
    # TComSPS constructor defaults not touched by xInitSPS:
    sps.profile_space = 0
    sps.profile_idc = 0       # never set by the encoder in this draft
    sps.rsvd_ind_flags = 0
    sps.level_idc = 0
    sps.profile_compat = 0
    sps.bits_for_poc = 8
    sps.restricted_ref_pic_lists_flag = True
    sps.lists_modification_present_flag = False
    sps.long_term_refs_present = False
    sps.amvp_modes = [1] * 8

    # xInitRPS over the expanded GOP list (GOPSize + extra startup RPSs)
    from ..utils.cfg import expand_gop
    extra = expand_gop(cfg) if cfg.gop_size > 0 else 0
    sps.rps_list = []
    for i, ge in enumerate(cfg.gop_list[:cfg.gop_size + extra]):
        rps = ReferencePictureSet()
        rps.delta_poc = list(ge.reference_pics)
        rps.used = [bool(u) for u in ge.used_by_curr_pic]
        rps.num_negative_pics = sum(1 for p in rps.delta_poc if p <= 0)
        rps.num_positive_pics = sum(1 for p in rps.delta_poc if p > 0)
        rps.inter_rps_prediction = ge.inter_rps_prediction > 0
        if ge.inter_rps_prediction == 1:
            rps.delta_rps = ge.delta_rps
            rps.num_ref_idc = ge.num_ref_idc
            rps.ref_idc = list(ge.ref_idc)
            # WRITE_BACK: re-derive deltaPOC/used from the refIdc
            ref_rps = sps.rps_list[i - 1]
            tmp = []
            for j in range(ge.num_ref_idc):
                if ge.ref_idc[j]:
                    n_ref = (ref_rps.num_negative_pics +
                             ref_rps.num_positive_pics)
                    d = ge.delta_rps + (ref_rps.delta_poc[j]
                                        if j < n_ref else 0)
                    tmp.append((d, ge.ref_idc[j] == 1))
            tmp.sort()
            neg = [t for t in tmp if t[0] < 0]
            pos = [t for t in tmp if t[0] >= 0]
            ordered = neg[::-1] + pos
            rps.delta_poc = [t[0] for t in ordered]
            rps.used = [t[1] for t in ordered]
            rps.num_negative_pics = len(neg)
            rps.num_positive_pics = len(pos)
        elif ge.inter_rps_prediction == 2:
            # automatic refIdc derivation from the previous RPS
            # (TEncTop.cpp:699-730, AUTO_INTER_RPS)
            ref_rps = sps.rps_list[i - 1]
            delta_rps = cfg.gop_list[i - 1].poc - ge.poc
            n_ref = ref_rps.num_negative_pics + ref_rps.num_positive_pics
            rps.delta_rps = delta_rps
            rps.num_ref_idc = n_ref + 1
            rps.ref_idc = [0] * (n_ref + 1)
            n_cur = rps.num_negative_pics + rps.num_positive_pics
            count = 0
            for j in range(n_ref + 1):
                ref_d = ref_rps.delta_poc[j] if j < n_ref else 0
                for k in range(n_cur):
                    if rps.delta_poc[k] == ref_d + delta_rps:
                        rps.ref_idc[j] = 1 if rps.used[k] else 2
                        count += 1
                        break
            if count != n_cur:
                print("Warning: Unable fully predict all delta POCs using "
                      "the reference RPS index given in the config file.  "
                      "Setting Inter RPS to false for this RPS.")
                rps.inter_rps_prediction = False
        sps.rps_list.append(rps)

    pps = Pps()
    pps.constrained_intra_pred_flag = bool(cfg.constrained_intra_pred)
    use_dqp = cfg.max_cu_dqp_depth > 0
    if cfg.use_lossless:
        lowest_qp = -sps.qp_bd_offset_y
        if cfg.max_cu_dqp_depth == 0 and cfg.max_delta_qp == 0 \
                and int(cfg.qp) == lowest_qp:
            use_dqp = False
        else:
            use_dqp = True
    elif not use_dqp and (cfg.max_delta_qp != 0 or cfg.use_adaptive_qp):
        use_dqp = True
    pps.use_dqp = use_dqp
    pps.max_cu_dqp_depth = cfg.max_cu_dqp_depth if use_dqp else 0
    pps.chroma_cb_qp_offset = cfg.cb_qp_offset
    pps.chroma_cr_qp_offset = cfg.cr_qp_offset
    # WPP substream count (TAppEncCfg.cpp:460: one per CTU row, forced to 1
    # with dependent slices) and tile geometry (TEncTop::xInitPPSforTiles)
    ctus_h = (cfg.source_height + cfg.max_cu_height - 1) // cfg.max_cu_height
    wf_substreams = ctus_h if cfg.wavefront_synchro else 1
    if cfg.dependent_slice_mode:
        wf_substreams = 1
    pps.num_substreams = wf_substreams
    # written idc (TEncCavlc.cpp:289-311): tiles=1, substreams=2,
    # dependent slices alone=3 (keeps 2 when entropy sync is also on)
    initial_idc = 2 if cfg.wavefront_synchro else \
        (1 if (cfg.num_tile_columns_minus1 > 0 or cfg.num_tile_rows_minus1 > 0)
         else 0)
    if initial_idc == 1:
        idc = 1
    elif wf_substreams > 1:
        idc = 2
    elif cfg.dependent_slice_mode:
        idc = 2 if initial_idc == 2 else 3
    else:
        idc = 0
    pps.tiles_or_entropy_coding_sync_idc = idc
    pps.uniform_spacing_flag = cfg.uniform_spacing_idc == 1
    pps.num_tile_columns_minus1 = cfg.num_tile_columns_minus1
    pps.num_tile_rows_minus1 = cfg.num_tile_rows_minus1
    if not pps.uniform_spacing_flag:
        # only the first NumColumnsMinus1/NumRowsMinus1 entries are used
        # (TAppEncCfg array parse + xInitPPSforTiles)
        pps.column_widths = [int(v) for v in
                             cfg.column_width_array.split()
                             ][:cfg.num_tile_columns_minus1]
        pps.row_heights = [int(v) for v in
                           cfg.row_height_array.split()
                           ][:cfg.num_tile_rows_minus1]
    pps.lf_cross_tile_boundary_flag = bool(cfg.lf_cross_tile_boundary_flag)
    if cfg.wavefront_synchro:
        pps.num_substreams = wf_substreams * (cfg.num_tile_columns_minus1 + 1)
    pps.use_wp = bool(cfg.use_weighted_pred)
    pps.wp_bipred = bool(cfg.use_weighted_bipred)
    pps.output_flag_present_flag = False
    pps.sign_hide_flag = bool(cfg.sign_hide_flag)
    pps.deblocking_filter_control_present = bool(cfg.dbf_control_present)
    pps.log2_parallel_merge_level_minus2 = cfg.log2_parallel_merge_level - 2
    pps.cabac_init_present_flag = True  # CABAC_INIT_PRESENT_FLAG
    pps.enc_cabac_table_idx = I_SLICE   # m_encCABACTableIdx, encoder-only
    pps.lf_cross_slice_boundary_flag = bool(cfg.lf_cross_slice_boundary_flag)
    # numRefIdxL0DefaultActive: histogram mode of numRefPicsActive
    hist = [0] * 8
    for ge in cfg.gop_list[:cfg.gop_size]:
        if ge.num_ref_pics_active < 8:
            hist[ge.num_ref_pics_active] += 1
    best = max(range(8), key=lambda i: (hist[i], -i))
    pps.num_ref_idx_l0_default_active = best
    pps.num_ref_idx_l1_default_active = best
    pps.transquant_bypass_enable_flag = bool(cfg.transquant_bypass_enable_flag)
    pps.use_transform_skip = bool(cfg.use_transform_skip)
    pps.dependent_slices_enabled_flag = cfg.dependent_slice_mode != 0
    pps.cabac_independent_flag = bool(cfg.cabac_independent_flag)
    pps.pic_init_qp_minus26 = 0

    # scaling-list activation (TEncGOP.cpp:243-279): mode 1 = defaults with
    # present flags off; mode 2 = file read, SPS carries the data whenever
    # any matrix differs from the defaults (checkDefaultScalingList)
    if cfg.scaling_list:
        sl = scaling_mod.ScalingList(pps.use_transform_skip)
        if cfg.scaling_list == 1:
            sl.set_default()
            sps.scaling_list_present_flag = False
            pps.scaling_list_present_flag = False
        else:
            if scaling_mod.parse_scaling_list_file(sl, cfg.scaling_list_file):
                sl.set_default()
            scaling_mod.check_dc_of_matrix(sl)
            sps.scaling_list_present_flag = \
                scaling_mod.check_default_scaling_list(sl)
            pps.scaling_list_present_flag = False
            if sps.scaling_list_present_flag:
                sps.scaling_list = sl
        sps.enc_scaling = scaling_mod.ActiveScaling(sl, sps.bit_increment,
                                                    for_encoder=True)
    return vps, sps, pps


def _nal_unit_type(cfg: EncoderCfg, poc: int, poc_cra: int) -> int:
    """getNalUnitType (TEncGOP.cpp:1728) incl. CRA leading-pic TFD typing.

    Every picture with POC below the last CRA's POC is a leading picture
    of that CRA and is marked TFD (TEncGOP.cpp:1745-1756) because the
    encoder references across the CRA when coding it."""
    if poc == 0:
        return nal_mod.NAL_UNIT_CODED_SLICE_IDR
    if cfg.intra_period > 0 and poc % cfg.intra_period == 0:
        if cfg.decoding_refresh_type == 1:
            return nal_mod.NAL_UNIT_CODED_SLICE_CRA
        if cfg.decoding_refresh_type == 2:
            return nal_mod.NAL_UNIT_CODED_SLICE_IDR
    if poc_cra > 0 and poc < poc_cra:
        return nal_mod.NAL_UNIT_CODED_SLICE_TFD
    return nal_mod.NAL_UNIT_CODED_SLICE


def _create_explicit_rps(sh, sps, dpb) -> None:
    """createExplicitReferencePictureSetFromReference (TComSlice.cpp:1052).

    Restrict the selected SPS RPS to the pictures still referenced in the
    DPB and attach it to the slice as an explicit slice-header RPS
    (rps_idx = -1), keeping the reference's inter-RPS prediction: the new
    RPS predicts from the same SPS reference RPS, re-indexed for the
    slice-level position (deltaRIdxMinus1 += numRPS - rpsIdx)."""
    ref = sh.rps
    new = ReferencePictureSet()
    new.delta_poc = []
    new.used = []
    n_neg = n_pos = 0
    for i in range(ref.num_negative_pics + ref.num_positive_pics):
        for p in dpb.pics:
            if p.poc == sh.poc + ref.delta_poc[i] and p.referenced:
                new.delta_poc.append(ref.delta_poc[i])
                new.used.append(ref.used[i])
                if ref.delta_poc[i] < 0:
                    n_neg += 1
                else:
                    n_pos += 1
    new.num_negative_pics = n_neg
    new.num_positive_pics = n_pos
    if not ref.inter_rps_prediction:
        new.inter_rps_prediction = False
        new.num_ref_idc = 0
    else:
        r_idx = sh.rps_idx - ref.delta_ridx_minus1 - 1
        ref_rps = sps.rps_list[r_idx]
        n_ref = ref_rps.num_negative_pics + ref_rps.num_positive_pics
        new.ref_idc = []
        for i in range(n_ref + 1):
            d = ref_rps.delta_poc[i] if i != n_ref else 0
            idc = 0
            for j in range(len(new.delta_poc)):
                if d + ref.delta_rps == new.delta_poc[j]:
                    idc = 1 if new.used[j] else 2
            new.ref_idc.append(idc)
        new.inter_rps_prediction = True
        new.num_ref_idc = n_ref + 1
        new.delta_rps = ref.delta_rps
        new.delta_ridx_minus1 = (ref.delta_ridx_minus1
                                 + len(sps.rps_list) - sh.rps_idx)
    sh.rps = new
    sh.rps_idx = -1


class _FrameSource:
    """On-demand, GOP-windowed original-frame access (one-GOP buffering per
    the reference TEncTop.cpp:374-405, instead of whole-sequence RAM)."""

    def __init__(self, reader, base: int):
        import threading
        self.reader = reader
        self.base = base
        self.cache: dict = {}
        self.lock = threading.Lock()

    def __getitem__(self, idx: int):
        with self.lock:
            f = self.cache.get(idx)
            if f is None:
                f = self.reader.read_frame_at(idx, self.base)
                if f is None:
                    raise IndexError(idx)
                self.cache[idx] = f
            return f

    def drop(self, idx: int) -> None:
        with self.lock:
            self.cache.pop(idx, None)

    def evict_below(self, idx: int) -> None:
        with self.lock:
            for k in [k for k in self.cache if k < idx]:
                del self.cache[k]


def arrange_longterm_pictures_in_rps(sh, sps: Sps, dpb: Dpb) -> None:
    """arrangeLongtermPicturesInRPS (TEncGOP.cpp:1849): sort LT entries in
    decreasing POC-LSB (ties: decreasing MSB), decide MSB-present flags, and
    fill the slice-header write fields."""
    rps = sh.rps
    if not rps.num_longterm_pics:
        return
    offset = rps.num_negative_pics + rps.num_positive_pics
    max_lsb = 1 << sps.bits_for_poc
    ents = []   # (poc, lsb, used)
    for i in range(rps.num_pics - 1, offset - 1, -1):
        ents.append([rps.poc[i], rps.poc[i] % max_lsb, rps.used[i]])
    # decreasing LSB, then decreasing MSB (stable double bubble in reference)
    ents.sort(key=lambda e: (-e[1], -(e[0] - e[1])))
    # MSB present iff another referenced DPB picture shares the LSB
    msb_present = []
    for poc, lsb, _ in ents:
        msb_present.append(any(
            p.poc % max_lsb == lsb and p.referenced and p.poc != poc
            for p in dpb.pics))
    need = rps.num_pics
    rps.poc_lsb_lt = [0] * need
    rps.delta_poc_msb_present = [False] * need
    rps.delta_poc_msb_cycle = [0] * need
    curr_lsb = sh.poc % max_lsb
    curr_msb = sh.poc - curr_lsb
    for ctr, i in enumerate(range(rps.num_pics - 1, offset - 1, -1)):
        poc, lsb, used = ents[ctr]
        rps.poc[i] = poc
        rps.delta_poc[i] = poc - sh.poc
        rps.used[i] = used
        rps.poc_lsb_lt[i] = lsb
        rps.delta_poc_msb_cycle[i] = (curr_msb - (poc - lsb)) // max_lsb
        rps.delta_poc_msb_present[i] = msb_present[ctr]
        assert rps.delta_poc_msb_cycle[i] >= 0


def _generate_combined_list(sh, list0, list1) -> None:
    """TComSlice::generateCombinedList (TComSlice.cpp:339): interleave
    L0/L1 by index, skipping POC duplicates, and record the idx maps used
    by GPB_SIMPLE_UNI uni-prediction estimation."""
    if sh.num_ref_lc <= 0:
        return
    sh.num_ref_lc = 0
    lists = (list0, list1)
    list_id_from_lc: list = []
    ref_idx_from_lc: list = []
    for i in range(16):
        for l in range(2):
            if i >= sh.num_ref_idx[l]:
                continue
            in_lc = True
            for j in range(sh.num_ref_lc):
                other = lists[list_id_from_lc[j]][ref_idx_from_lc[j]]
                if lists[l][i].poc == other.poc:
                    if l == 0:
                        sh.ref_idx_of_l1_from_l0[i] = ref_idx_from_lc[j]
                        sh.ref_idx_of_l0_from_l1[ref_idx_from_lc[j]] = i
                    else:
                        sh.ref_idx_of_l0_from_l1[i] = ref_idx_from_lc[j]
                        sh.ref_idx_of_l1_from_l0[ref_idx_from_lc[j]] = i
                    in_lc = False
                    break
            if in_lc:
                list_id_from_lc.append(l)
                ref_idx_from_lc.append(i)
                sh.ref_idx_of_lc[l][i] = sh.num_ref_lc
                sh.num_ref_lc += 1


class Encoder:
    """Full encoder pipeline.  ``device`` (a ``torch.device`` or its
    name) runs the fast-RD decision passes of ``cfg.fast_rd`` encodes,
    which add their wall times to ``stats`` (a ``DecisionStats``), and
    with ``device_apply`` the apply of their intra slices too."""

    def __init__(self, cfg: EncoderCfg, device=None, stats=None,
                 device_apply: bool = False):
        self.cfg = cfg
        self.decision_device = (device_mod.resolve(device)
                                if device is not None else None)
        self.decision_stats = stats
        if device_apply and not cfg.fast_rd:
            raise ValueError("the device apply is the apply of a fast-RD "
                             "encode: it needs --FastRD=1")
        if device_apply and os.environ.get("THEVC_FASTRD_DEVCHROMA",
                                           "1") == "0":
            # the apply predicts chroma with the decided modes while the
            # syntax would signal DM: a nonconformant stream
            raise ValueError("the device apply cannot run with "
                             "THEVC_FASTRD_DEVCHROMA=0")
        self.device_apply = bool(device_apply)
        # the decision passes' device copies of the reference pictures
        self.decision_refs = RefCache()
        self.vps, self.sps, self.pps = derive_params(cfg)
        self.frames_encoded = 0
        self.total_bits = 0
        self.psnr_sums = [0.0, 0.0, 0.0]
        # TEncAnalyze accumulators: [psnrY, psnrU, psnrV, bits, numPic]
        # for all/I/P/B slices (TEncAnalyze.h:58-96)
        self.analyze = {k: [0.0, 0.0, 0.0, 0.0, 0] for k in "aipb"}
        self.rvm_rp: list = []      # per-AU bits for RVM (TEncGOP.cpp:1677)
        self.verbose = True
        # SAO_ENCODING_CHOICE early-termination state (persists per encoder)
        self._sao_rate_state = [[0.0] * 10, [0.0] * 10]
        self.dpb = Dpb()
        self.last_idr = 0
        self.rate_ctrl = None
        if cfg.use_rate_ctrl:
            from .rate_ctrl import RateCtrl
            self.rate_ctrl = RateCtrl(
                cfg.intra_period, cfg.gop_size, cfg.frame_rate,
                cfg.target_bitrate, int(cfg.qp), cfg.source_width,
                cfg.source_height, self.sps.max_cu_width)
        self.poc_cra = 0
        self.refresh_pending = False

    # ------------------------------------------------------------------
    def encode_frame(self, org: YuvFrame, poc: int, first: bool,
                     gop_id: int = 0):
        """Compress one picture; returns (au_bytes_list, recon YuvFrame).

        One iteration of TEncGOP::compressGOP.
        """
        t_start = time.time()
        cfg = self.cfg
        sps, pps = self.sps, self.pps
        nal_type = _nal_unit_type(cfg, poc, self.poc_cra)
        if nal_type == nal_mod.NAL_UNIT_CODED_SLICE_IDR:
            self.last_idr = poc
        sh, lam, weight, lam_chroma = se.init_enc_slice(
            cfg, sps, pps, poc, gop_id, nal_type, rc=self.rate_ctrl)
        ge = cfg.gop_list[gop_id] if gop_id < len(cfg.gop_list) else None
        sh.temporal_id = 0 if poc == 0 else (ge.temporal_id if ge else 0)
        if sh.slice_type == 0 and ge is not None and ge.slice_type == "P":
            sh.slice_type = P_SLICE

        # col dir selection (compressGOP :157-202)
        col_dir = 1
        if ge is not None:
            close_left, close_right = 1, -1
            for r in ge.reference_pics:
                if r > 0 and (r < close_right or close_right == -1):
                    close_right = r
                elif r < 0 and (r > close_left or close_left == 1):
                    close_left = r
            if close_right > -1:
                close_right += ge.poc - 1
            if close_left < 1:
                close_left += ge.poc - 1
                while close_left < 0:
                    close_left += cfg.gop_size
            left_qp = right_qp = 0
            for g2 in cfg.gop_list[:cfg.gop_size]:
                if g2.poc == (close_left % cfg.gop_size) + 1:
                    left_qp = g2.qp_offset
                if g2.poc == (close_right % cfg.gop_size) + 1:
                    right_qp = g2.qp_offset
            if close_right > -1 and right_qp < left_qp:
                col_dir = 0

        # decodingRefreshMarking (TComSlice.cpp:646) + RPS selection
        if nal_type == nal_mod.NAL_UNIT_CODED_SLICE_IDR:
            self.dpb.idr_flush()
            # (only BLA/BLANT set pocCRA here in the reference; IDR does
            # not — TComSlice.cpp:662-665)
        else:
            if self.refresh_pending and poc > self.poc_cra:
                # CRA reference marking pending: every picture except the
                # CRA itself becomes unreferenced (TComSlice.cpp:670-679)
                for p in self.dpb.pics:
                    if p.poc != poc and p.poc != self.poc_cra:
                        p.referenced = False
                self.refresh_pending = False
            if nal_type == nal_mod.NAL_UNIT_CODED_SLICE_CRA:
                self.refresh_pending = True
                self.poc_cra = poc

        if not sh.is_intra or nal_type != nal_mod.NAL_UNIT_CODED_SLICE_IDR:
            sh.rps_idx = gop_id
            n_extra = len(sps.rps_list) - cfg.gop_size
            for extra in range(cfg.gop_size, cfg.gop_size + n_extra):
                eg = cfg.gop_list[extra]
                if cfg.intra_period > 0 and cfg.decoding_refresh_type > 0:
                    poc_index = poc % cfg.intra_period
                    if poc_index == 0:
                        poc_index = cfg.intra_period
                    if poc_index == eg.poc:
                        sh.rps_idx = extra
                else:
                    if poc == eg.poc:
                        sh.rps_idx = extra
            sh.rps = sps.rps_list[sh.rps_idx]
            # checkThatAllRefPicsAreAvailable (TComSlice.cpp:917): when a
            # short-term entry was unreferenced by the CRA refresh marking,
            # write an explicit slice-header RPS restricted to the
            # available pictures (createExplicitReferencePictureSetFrom-
            # Reference, TComSlice.cpp:1052)
            n_st = sh.rps.num_negative_pics + sh.rps.num_positive_pics
            if any(not any(p.poc == poc + sh.rps.delta_poc[i]
                           and p.referenced for p in self.dpb.pics)
                   for i in range(n_st)):
                _create_explicit_rps(sh, sps, self.dpb)
            self.dpb.apply_rps(sh.rps, poc, sps.bits_for_poc)
            # TLA typing at temporal switching points (TEncGOP.cpp:299-305,
            # TComSlice::isTemporalLayerSwitchingPoint TComSlice.cpp:838)
            if sh.temporal_id > 0:
                switching = all(
                    getattr(p, "temporal_id", 0) < sh.temporal_id
                    for p in self.dpb.pics
                    if p.referenced and p.poc != poc)
                if switching or sps.temporal_id_nesting_flag:
                    nal_type = nal_mod.NAL_UNIT_CODED_SLICE_TLA
                    sh.nal_unit_type = nal_type

        if sps.long_term_refs_present and sh.rps is not None:
            arrange_longterm_pictures_in_rps(sh, sps, self.dpb)

        list0: list = []
        list1: list = []
        if not sh.is_intra:
            n_pics = sh.rps.num_negative_pics + sh.rps.num_positive_pics
            active = min(ge.num_ref_pics_active, n_pics) if ge else n_pics
            sh.num_ref_idx[0] = active
            sh.num_ref_idx[1] = active if sh.slice_type == 0 else 0
            list0, list1 = build_ref_lists(sh, self.dpb, sps.bits_for_poc)
            # the decision passes' device copies of pictures no longer
            # held for reference go
            self.decision_refs.retain(p.rec_y for p in self.dpb.pics
                                      if p.referenced)
            if sh.slice_type == 0 and sh.num_ref_idx[1] == 0:
                sh.slice_type = P_SLICE
            if sh.slice_type == 0:
                sh.col_dir = col_dir
                sh.check_ldc_flag = check_ldc(sh, list0, list1)
                gpb = (sh.num_ref_idx[0] == sh.num_ref_idx[1] and
                       all(a.poc == b.poc for a, b in zip(list0, list1)))
                sh.mvd_l1_zero_flag = gpb
            else:
                sh.check_ldc_flag = False
                sh.mvd_l1_zero_flag = False
            # encoder-internal combined list / noBackPred
            # (TEncGOP.cpp:325-389; draft-8 LC has no bitstream syntax)
            sh.no_back_pred = False
            sh.num_ref_lc = 0
            sh.ref_idx_of_lc = [[-1] * 16, [-1] * 16]
            sh.ref_idx_of_l0_from_l1 = [-1] * 16
            sh.ref_idx_of_l1_from_l0 = [-1] * 16
            if sh.slice_type == 0:
                use_lcomb = bool(cfg.use_lcomb)
                if use_lcomb:
                    sh.num_ref_lc = sh.num_ref_idx[0]
                else:
                    if (sh.num_ref_idx[0] == sh.num_ref_idx[1] and
                            all(a.poc == b.poc
                                for a, b in zip(list0, list1))):
                        sh.no_back_pred = True
                if sh.no_back_pred:
                    sh.num_ref_lc = 0
                _generate_combined_list(sh, list0, list1)

        # ---- weighted-prediction analysis (TEncSlice.cpp:686-710) ----
        from . import wp_analysis as wpa
        wp_saved = (pps.use_wp, pps.wp_bipred)
        if pps.use_wp or pps.wp_bipred:
            sh.wp_acdc = wpa.calc_acdc((org.y, org.cb, org.cr))
        wp_explicit = (sh.slice_type == P_SLICE and pps.use_wp) or \
                      (sh.slice_type == 0 and pps.wp_bipred)
        if wp_explicit:
            sh.wp_scaling = wpa.estimate_wp_param_slice(
                sh, [list0, list1], (org.y, org.cb, org.cr),
                sps.internal_bit_depth)
            if not wpa.check_wp_enable(sh.wp_scaling, sh):
                # no weights survived: compress this picture unweighted
                # (the PPS flags are restored before the entropy pass)
                pps.use_wp = False
                pps.wp_bipred = False

        f = FrameModel(sps, pps)
        from ..common.tiles import TileInfo
        f.init_tiles(TileInfo(f.ctus_w, f.ctus_h, pps))
        h, w = sps.pic_height_in_luma_samples, sps.pic_width_in_luma_samples
        rec_y = np.zeros((h, w), np.int16)
        rec_cb = np.zeros((h // 2, w // 2), np.int16)
        rec_cr = np.zeros((h // 2, w // 2), np.int16)

        cu = se.make_cu_encoder(cfg, sps, pps, sh, f,
                                (org.y, org.cb, org.cr),
                                (rec_y, rec_cb, rec_cr),
                                lam, weight, lam_chroma)
        if not sh.is_intra:
            col_pic = None
            if sh.tmvp_enabled:
                col_list = list1 if (sh.slice_type == 0 and sh.col_dir) \
                    else list0
                col_pic = col_list[sh.col_ref_idx]
            mvctx = MvCtx(f, sh, sps, pps, list0, list1, col_pic,
                          sh.check_ldc_flag)
            cu.inter = InterSearch(
                cu, [list0, list1], mvctx,
                fast_enc=bool(cfg.use_fast_enc),
                use_had_me=bool(cfg.use_had_me),
                search_range=cfg.search_range,
                bipred_range=cfg.bipred_search_range,
                fdm=bool(cfg.use_fast_decision_for_merge))
        # ---- slice segmentation + compression (TEncGOP.cpp:560-625) ----
        import copy as _copy
        pc = se.PictureCompressor(cu, cfg, self.decision_device,
                                  self.decision_stats, self.decision_refs,
                                  self.device_apply)
        pc.rc = self.rate_ctrl
        if cfg.use_adaptive_qp:
            from .preanalyzer import preanalyze
            pc.aq = preanalyze(org.y, sps.max_cu_width,
                               pps.max_cu_dqp_depth + 1)
        real_end = se.real_end_address(f)
        stage_t = time.time() if os.environ.get("THEVC_STAGE_TIME") else None
        sh.slice_cur_start_cu_addr = 0
        sh.dependent_slice_start_cu_addr = 0
        sh.dependent_slice = False
        segments = []
        n_regular = 1
        next_addr = 0
        start_slice_var = 0
        start_dep_var = 0
        while True:
            sh.next_slice = False
            sh.next_dependent_slice = False
            start, bounding = se.determine_bounds(cfg, f, sh, False)
            pc.compress_slice(sh, start, bounding, n_regular - 1)
            segments.append(_copy.copy(sh))
            no_constraint = not sh.next_slice and not sh.next_dependent_slice
            if sh.next_slice or (no_constraint and cfg.slice_mode == 1):
                start_slice_var = sh.slice_cur_end_cu_addr
                pc.cur_dep_idx = 0
                if start_slice_var < real_end:
                    sh.slice_cur_start_cu_addr = start_slice_var
                    sh.dependent_slice_start_cu_addr = start_slice_var
                    sh.dependent_slice = False
                    sh.slice_bits = 0          # TEncGOP.cpp:609
                    n_regular += 1
                if start_dep_var < start_slice_var:
                    start_dep_var = start_slice_var
            elif sh.next_dependent_slice or (no_constraint
                                             and cfg.dependent_slice_mode == 1):
                start_dep_var = sh.dependent_slice_end_cu_addr
                sh.dependent_slice_start_cu_addr = start_dep_var
                sh.dependent_slice = True
            else:
                start_slice_var = sh.slice_cur_end_cu_addr
                start_dep_var = sh.dependent_slice_end_cu_addr
            next_addr = max(start_slice_var, start_dep_var)
            if next_addr >= real_end:
                break

        if stage_t is not None:
            print("STAGE compress %.3f" % (time.time() - stage_t))
            stage_t = time.time()
        # xRestoreWPparam (TEncSlice.cpp:988)
        pps.use_wp, pps.wp_bipred = wp_saved
        if self.rate_ctrl is not None:     # TEncSlice.cpp:989-992
            self.rate_ctrl.update_frame_data(pc.pic_total_bits)

        # in-loop filters run before the final entropy pass (TEncGOP:631+)
        from ..decoder.filters import ref_poc_from_lists
        ref_pocs = [[p.poc for p in list0], [p.poc for p in list1]]
        deblock_frame(f, sh, sps, pps, rec_y, rec_cb, rec_cr,
                      ref_poc_from_lists(f, ref_pocs)
                      if not sh.is_intra else None)
        if stage_t is not None:
            print("STAGE deblock %.3f" % (time.time() - stage_t))
            stage_t = time.time()
        sao_write = None
        if sps.use_sao:
            from .sao_encoder import SaoEncoder
            sao = SaoEncoder(f, sh, sps, pps, cfg, lam, lam / weight,
                             (org.y, org.cb, org.cr),
                             depth_sao_rate=self._sao_rate_state,
                             gop_depth=getattr(sh, "gop_depth", 0),
                             init_frac=cu.go_on.frac_bits)
            rec_y, rec_cb, rec_cr = sao.process(rec_y, rec_cb, rec_cr)
            sao_write = sao.make_writer()

        if stage_t is not None:
            print("STAGE sao %.3f" % (time.time() - stage_t))
            stage_t = time.time()
        # ---- assemble the access unit ----
        au = []
        if first:
            bs = headers.write_vps(self.vps)
            au.append((nal_mod.NAL_UNIT_VPS, 0, bs.get_bytes()))
            bs = headers.write_sps(sps)
            au.append((nal_mod.NAL_UNIT_SPS, 0, bs.get_bytes()))
            bs = headers.write_pps(pps)
            au.append((nal_mod.NAL_UNIT_PPS, 0, bs.get_bytes()))

        # ---- final entropy pass, one NAL per slice segment ----
        parts = f.parts_per_ctu
        slice_nals = []
        for seg in segments:
            # picture-level decisions made after compression (SAO flags)
            seg.sao_enabled = sh.sao_enabled
            seg.sao_enabled_chroma = sh.sao_enabled_chroma
            # cabac_init_flag from the CURRENT PPS encCABACTableIdx — set
            # before this segment's encode pass updates it
            # (TEncCavlc.cpp:792-801)
            if seg.slice_type != I_SLICE and pps.cabac_init_present_flag:
                idx = pps.enc_cabac_table_idx
                seg.cabac_init_flag = (seg.slice_type != idx
                                       and idx != I_SLICE)
            start_field = seg.dependent_slice_start_cu_addr \
                if seg.dependent_slice else seg.slice_cur_start_cu_addr
            seg.write_lcu_address = int(f.ctu_order[start_field // parts])
            seg.finalized = True               # TEncGOP.cpp:889
            seg_subs, tile_locs = pc.encode_slice(seg, sao_write)
            seg.num_entry_point_offsets = 0
            seg.entry_point_offsets = []
            if not pps.dependent_slices_enabled_flag and \
                    pps.tiles_or_entropy_coding_sync_idc > 0:
                if pps.tiles_or_entropy_coding_sync_idc == 1:
                    offs, prev = [], 0
                    for loc in tile_locs:
                        offs.append(loc - prev)
                        prev = loc
                    seg.entry_point_offsets = offs
                else:
                    sizes = list(seg.substream_sizes)
                    while sizes and sizes[-1] == 0:
                        sizes.pop()
                    seg.entry_point_offsets = [s >> 3 for s in sizes]
                seg.num_entry_point_offsets = len(seg.entry_point_offsets)
            hdr = headers.write_slice_header(seg, sps, pps,
                                             last_idr_poc=self.last_idr)
            hdr.write_align_one()
            for sub in seg_subs:
                hdr.add_substream(sub)
            slice_nals.append((nal_type, seg.temporal_id, hdr.get_bytes()))

        if stage_t is not None:
            print("STAGE entropy %.3f" % (time.time() - stage_t))
            stage_t = time.time()
        digest = None
        if cfg.picture_digest:
            method = cfg.picture_digest - 1  # 1:MD5 2:CRC 3:checksum
            digest = calc_digest(method, (rec_y, rec_cb, rec_cr),
                                 sps.internal_bit_depth)
            bs = headers.write_sei_picture_digest(method, digest)
            au.append((nal_mod.NAL_UNIT_SEI, sh.temporal_id, bs.get_bytes()))
        au.extend(slice_nals)

        # DPB bookkeeping for inter prediction of later pictures
        dpb_pic = Picture(poc, (rec_y, rec_cb, rec_cr), f, sh, ref_pocs,
                          margin=sps.max_cu_width + 16)
        dpb_pic.temporal_id = sh.temporal_id
        # AC/DC stats of the original picture for later WP estimation
        # (WeightPredAnalysis::xCalcACDCParamSlice)
        dpb_pic.wp_acdc = getattr(sh, "wp_acdc", None)
        if not sh.is_intra:
            # an all-intra picture's motion field is uniform (no MVs,
            # ref_idx -1, MODE_INTRA everywhere), so compressMV is a no-op
            dpb_pic.compress_motion()
        self.dpb.add(dpb_pic)

        if stage_t is not None:
            print("STAGE tail %.3f" % (time.time() - stage_t))
        data, _sizes = nal_mod.write_annexb(au)
        # AU size excluding start codes and SEI NALs (TEncGOP.cpp:1655)
        if os.environ.get("THEVC_VERBOSE_RATE"):
            # VERBOSE_RATE per-NAL byte print (TEncGOP.cpp:1557-1665)
            for (t, tid, rbsp) in au:
                name = {1: "SLICE", 2: "TFD", 3: "TLA", 4: "CRA", 6: "BLA",
                        8: "IDR", 25: "VPS", 26: "SPS", 27: "PPS",
                        31: "SEI"}.get(t, "UNKNOWN")
                print("*** %6s numBytesInNALunit: %u"
                      % (name, len(nal_mod.write_nal(t, tid, rbsp))))
        uibits = sum(
            len(nal_mod.write_nal(t, tid, rbsp)) * 8
            for (t, tid, rbsp) in au if t != nal_mod.NAL_UNIT_SEI)
        if self.rate_ctrl is not None:
            self.rate_ctrl.update_frame_status(uibits, sh.slice_type)
        psnrs = self._add_psnr(org, (rec_y, rec_cb, rec_cr), len(data) * 8,
                               uibits, sh.slice_type)
        if self.verbose:
            referenced = True if ge is None else bool(ge.ref_pic)
            self._print_poc_line(sh, uibits, psnrs, time.time() - t_start,
                                 list0, list1, digest,
                                 cfg.picture_digest, referenced)
        return data, YuvFrame(rec_y, rec_cb, rec_cr)

    @staticmethod
    def _frame_sse(o: np.ndarray, r: np.ndarray) -> float:
        """Sum of squared sample differences between two int16 planes."""
        from .. import native
        lib = native.get_lib()
        if (lib is not None and o.dtype == np.int16 and r.dtype == np.int16
                and o.strides[1] == 2 and r.strides[1] == 2):
            return float(lib.frame_sse(
                o.ctypes.data, o.strides[0] // 2,
                r.ctypes.data, r.strides[0] // 2, o.shape[0], o.shape[1]))
        # float64 dot fallback: exact for 14-bit samples (d^2*count < 2^53)
        d = (o - r).astype(np.float64).ravel()
        return float(np.dot(d, d))

    def _add_psnr(self, org: YuvFrame, rec, bits: int, uibits: int,
                  slice_type: int):
        """xCalculateAddPSNR (TEncGOP.cpp:1582-1688)."""
        self.frames_encoded += 1
        self.total_bits += bits
        # maxval = 255 << (bitDepth - 8) (TEncGOP.cpp:1648)
        maxval = 255 << (self.sps.internal_bit_depth - 8)
        psnrs = []
        px, py = self.cfg.pad_x, self.cfg.pad_y
        for i, (o, r) in enumerate(zip((org.y, org.cb, org.cr), rec)):
            if px or py:
                # PSNR excludes the source padding (TEncGOP.cpp:1601-1602)
                d = 1 if i == 0 else 2
                h, w = o.shape
                o = o[: h - py // d, : w - px // d]
                r = r[: h - py // d, : w - px // d]
            sse = self._frame_sse(o, r)
            if sse == 0.0:
                psnr = 99.99
            else:
                psnr = 10.0 * math.log10(maxval * maxval * o.size / sse)
            self.psnr_sums[i] += psnr
            psnrs.append(psnr)
        self.rvm_rp.append(uibits)
        buckets = ["a"]
        buckets.append("i" if slice_type == I_SLICE else
                       "p" if slice_type == P_SLICE else "b")
        for k in buckets:
            acc = self.analyze[k]
            acc[0] += psnrs[0]
            acc[1] += psnrs[1]
            acc[2] += psnrs[2]
            acc[3] += float(uibits)
            acc[4] += 1
        return psnrs

    log_sink = None   # set to a list to capture per-POC lines (parallel path)

    def _print_poc_line(self, sh, uibits, psnrs, enc_time, list0, list1,
                        digest, digest_method, referenced) -> None:
        """Per-POC log line (TEncGOP.cpp:1690-1759 + digest print :1195)."""
        c = ("I" if sh.slice_type == I_SLICE else
             "P" if sh.slice_type == P_SLICE else "B")
        if not referenced:
            c = c.lower()
        line = ("POC %4d TId: %1d ( %c-SLICE, nQP %d QP %d ) %10d bits"
                % (sh.poc, sh.temporal_id, c, sh.slice_qp, sh.slice_qp,
                   uibits))
        line += (" [Y %6.4f dB    U %6.4f dB    V %6.4f dB]"
                 % (psnrs[0], psnrs[1], psnrs[2]))
        line += " [ET %5.0f ]" % enc_time
        for name, lst in (("L0", list0), ("L1", list1)):
            line += " [%s " % name
            for p in lst:
                line += "%d " % (p.poc - self.last_idr)
            line += "]"
        if digest is not None:
            tag = ("MD5", "CRC", "Checksum")[digest_method - 1]
            line += " [%s:%s]" % (tag, ",".join(d.hex() for d in digest))
        if self.log_sink is not None:
            self.log_sink.append(line)
        else:
            print(line)

    def print_summary(self) -> None:
        """printOutSummary (TEncGOP.cpp:1321-1355) + TEncAnalyze printOut."""
        fps = float(self.cfg.frame_rate or 30)
        heads = [("SUMMARY --------------------------------------------------------", "a"),
                 ("I Slices--------------------------------------------------------", "i"),
                 ("P Slices--------------------------------------------------------", "p"),
                 ("B Slices--------------------------------------------------------", "b")]
        for head, k in heads:
            acc = self.analyze[k]
            print("\n\n%s" % head)
            print("\tTotal Frames |  Bitrate    Y-PSNR    U-PSNR    V-PSNR ")
            n = acc[4]
            if n == 0:
                n = 1  # HM divides by zero and prints nan; print zeros
                scale = 0.0
            else:
                scale = fps / 1000 / acc[4]
            print("\t %8d    %c%12.4f  %8.4f  %8.4f  %8.4f"
                  % (acc[4], k, acc[3] * scale,
                     acc[0] / n, acc[1] / n, acc[2] / n))
        print("\nRVM: %.3f" % self._calc_rvm())

    def _calc_rvm(self) -> float:
        """Rate-variation metric (TEncGOP::xCalculateRVM :1760-1806)."""
        cfg, m = self.cfg, 4  # RVM_VCEGAM10_M (TypeDef.h:200)
        if not (cfg.gop_size == 1 and cfg.intra_period != 1
                and self.frames_encoded > 2 * m):
            return 0.0
        rp = self.rvm_rp
        n = len(rp)
        vrl = [0.0] * n
        vb = [0.0] * n
        ravg = bavg = 0.0
        for i in range(m + 1, n - m + 1):
            vrl[i] = sum(rp[i - m:i + m]) / (2 * m)
            vb[i] = vb[i - 1] + rp[i] - vrl[i]
            ravg += rp[i]
            bavg += vb[i]
        cnt = n - 2 * m
        ravg /= cnt
        bavg /= cnt
        sigma_b = math.sqrt(
            sum((vb[i] - bavg) ** 2 for i in range(m + 1, n - m + 1)) / cnt)
        f = math.sqrt(12.0 * (m - 1) / (m + 1))
        return sigma_b / ravg * f

    # ------------------------------------------------------------------
    # Frame-parallel all-intra encoding.  Intra pictures are pixel-
    # independent, so the per-frame pipeline (compressSlice RD + filters +
    # SAO RDO + final CABAC pass — all running in the native core, which
    # releases the GIL) is farmed out to a thread pool; the cross-frame
    # bookkeeping (PSNR/analyze accumulation, per-POC log order, bitstream
    # concatenation) is replayed in POC order afterwards, so the output is
    # bit-identical to the serial path.
    # ------------------------------------------------------------------
    def _can_encode_parallel(self, n: int) -> bool:
        import os
        if n <= 1 or self.rate_ctrl is not None:
            return False
        if self.cfg.intra_period != 1 or self.cfg.gop_size > 1:
            return False
        if os.environ.get("THEVC_NATIVE", "1") == "0":
            return False
        if os.environ.get("THEVC_THREADS", "") == "1":
            return False
        from .. import native
        return native.get_lib() is not None

    def _encode_all_intra_parallel(self, frames, writer, reader, out_path):
        import copy
        import os
        from concurrent.futures import ThreadPoolExecutor

        class _RefStub:
            """Placeholder DPB entry: RPS bookkeeping only (intra pictures
            never read reference samples)."""
            __slots__ = ("poc", "referenced", "is_long_term", "temporal_id")

            def __init__(self, poc):
                self.poc = poc
                self.referenced = True
                self.is_long_term = False
                self.temporal_id = 0

        n = frames.count

        def job(poc):
            w = copy.copy(self)
            w.dpb = Dpb()
            for p in range(poc):
                w.dpb.add(_RefStub(p))
            w.analyze = {k: [0.0, 0.0, 0.0, 0.0, 0] for k in "aipb"}
            w.rvm_rp = []
            w.psnr_sums = [0.0, 0.0, 0.0]
            w.frames_encoded = 0
            w.total_bits = 0
            w.log_sink = []
            w._sao_rate_state = [list(r) for r in self._sao_rate_state]
            data, rec = w.encode_frame(frames[poc], poc, poc == 0, 0)
            frames.drop(poc)
            return w, data, rec

        req = int(os.environ.get("THEVC_THREADS", "0"))
        workers = req or min(os.cpu_count() or 4, 16)
        chunks = []
        with ThreadPoolExecutor(max_workers=workers) as ex:
            results = list(ex.map(job, range(n)))
        for poc, (w, data, rec) in enumerate(results):
            chunks.append(data)
            if self.verbose:
                for line in w.log_sink:
                    print(line)
            self.frames_encoded += w.frames_encoded
            self.total_bits += w.total_bits
            for i in range(3):
                self.psnr_sums[i] += w.psnr_sums[i]
            self.rvm_rp.extend(w.rvm_rp)
            for k in "aipb":
                for i in range(4):
                    self.analyze[k][i] += w.analyze[k][i]
                self.analyze[k][4] += w.analyze[k][4]
            if writer is not None:
                writer.write_frame(rec)
        reader.close()
        if writer is not None:
            writer.close()
        stream = b"".join(chunks)
        if out_path:
            with open(out_path, "wb") as fh:
                fh.write(stream)
        return stream

    # ------------------------------------------------------------------
    # checkpoint / resume: every piece of cross-frame encoder state (DPB
    # with recon+motion snapshots, rate-control models, SAO encoding-choice
    # rates, CRA/IDR bookkeeping, summary accumulators) is held in explicit
    # serializable fields, so a checkpoint is a plain pickle and a resumed
    # encode continues the bitstream byte-exactly (the reference keeps no
    # such machinery — SURVEY.md section 5)
    def save_checkpoint(self, path: str, nxt: int, next_write: int) -> None:
        import pickle
        state = dict(
            version=1,
            nxt=nxt,
            next_write=next_write,
            frames_encoded=self.frames_encoded,
            analyze=self.analyze,
            rvm_rp=self.rvm_rp,
            sao_rate_state=self._sao_rate_state,
            dpb=self.dpb,
            last_idr=self.last_idr,
            rate_ctrl=self.rate_ctrl,
            poc_cra=self.poc_cra,
            refresh_pending=self.refresh_pending,
            enc_cabac_table_idx=self.pps.enc_cabac_table_idx,
        )
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(state, fh)
        os.replace(tmp, path)

    def load_checkpoint(self, path: str):
        import pickle
        with open(path, "rb") as fh:
            st = pickle.load(fh)
        self.frames_encoded = st["frames_encoded"]
        self.analyze = st["analyze"]
        self.rvm_rp = st["rvm_rp"]
        self._sao_rate_state = st["sao_rate_state"]
        self.dpb = st["dpb"]
        self.last_idr = st["last_idr"]
        self.rate_ctrl = st["rate_ctrl"]
        self.poc_cra = st["poc_cra"]
        self.refresh_pending = st["refresh_pending"]
        self.pps.enc_cabac_table_idx = st["enc_cabac_table_idx"]
        return st["nxt"], st["next_write"]

    # ------------------------------------------------------------------
    def encode(self, out_path: str | None = None):
        """Drive the whole sequence per the cfg; returns bitstream bytes."""
        cfg = self.cfg
        internal_bd = self.sps.internal_bit_depth
        reader = YuvReader(cfg.input_file, cfg.source_width, cfg.source_height,
                           cfg.input_bit_depth, internal_bd,
                           pad_x=cfg.pad_x, pad_y=cfg.pad_y)
        reader.skip_frames(cfg.frame_skip)
        writer = None
        if cfg.recon_file:
            out_bd = cfg.output_bit_depth or internal_bd
            writer = YuvWriter(cfg.recon_file, out_bd, internal_bd,
                               append=bool(cfg.resume_file),
                               crop=(cfg.crop_left, cfg.crop_right,
                                     cfg.crop_top, cfg.crop_bottom))
        chunks = []
        # with checkpointing active the stream is flushed to disk at each
        # checkpoint so the on-disk prefix always corresponds to the saved
        # state; a resumed run appends its continuation
        out_fh = None
        if out_path and (cfg.checkpoint_file or cfg.resume_file):
            out_fh = open(out_path, "ab" if cfg.resume_file else "wb")
        n = cfg.frames_to_be_encoded
        gop_size = max(cfg.gop_size, 1)

        # GOP-windowed frame source: frames are read on demand and evicted
        # once their GOP is done (the reference buffers one GOP,
        # TEncTop.cpp:374-405, rather than the whole sequence)
        avail = reader.num_frames_remaining()
        n = avail if n <= 0 else min(n, avail)
        frames = _FrameSource(reader, cfg.frame_skip)
        frames.count = n

        if self._can_encode_parallel(n):
            return self._encode_all_intra_parallel(frames, writer, reader,
                                                   out_path)

        recons = {}
        first = True
        nxt = 1
        next_write = 0
        gops_done = 0
        if cfg.resume_file:
            nxt, next_write = self.load_checkpoint(cfg.resume_file)
            first = False
            if writer is not None:
                # drop any recon frames written after the checkpoint by the
                # interrupted run, then continue appending
                out_bd = cfg.output_bit_depth or internal_bd
                fbytes = (cfg.source_width * cfg.source_height * 3 // 2 *
                          (2 if out_bd > 8 else 1))
                try:
                    writer._fd.truncate(next_write * fbytes)
                except OSError:
                    pass          # /dev/null, pipes: nothing to truncate
        elif n > 0:
            data, rec = self.encode_frame(frames[0], 0, True, 0)
            first = False
            chunks.append(data)
            recons[0] = rec
            if self.rate_ctrl is not None:   # TEncGOP.cpp:1228-1231
                self.rate_ctrl.update_gop_status()
        while nxt < n:
            batch = min(gop_size, n - nxt)
            poc_last = nxt + batch - 1
            for gop_id in range(gop_size):
                poc = poc_last - batch + cfg.gop_list[gop_id].poc
                if poc >= n or poc in recons:
                    continue
                data, rec = self.encode_frame(frames[poc], poc, first,
                                              gop_id)
                chunks.append(data)
                recons[poc] = rec
            nxt += batch
            frames.evict_below(nxt)
            # stream POC-contiguous recon out and free the buffers
            while next_write in recons and next_write < nxt:
                if writer is not None:
                    writer.write_frame(recons[next_write])
                del recons[next_write]
                next_write += 1
            if self.rate_ctrl is not None:
                self.rate_ctrl.update_gop_status()
            gops_done += 1
            if cfg.checkpoint_file and cfg.checkpoint_every > 0 and \
                    gops_done % cfg.checkpoint_every == 0:
                if out_fh is not None:
                    for c in chunks:
                        out_fh.write(c)
                    out_fh.flush()
                    chunks.clear()
                if writer is not None:
                    writer._fd.flush()
                self.save_checkpoint(cfg.checkpoint_file, nxt, next_write)
        for poc in sorted(recons):
            if writer is not None:
                writer.write_frame(recons[poc])
        reader.close()
        if writer is not None:
            writer.close()
        stream = b"".join(chunks)
        if out_fh is not None:
            out_fh.write(stream)
            out_fh.close()
        elif out_path:
            with open(out_path, "wb") as fh:
                fh.write(stream)
        return stream


# -- the port's fast-RD decision passes


@dataclasses.dataclass
class DecisionStats:
    """What an encode's fast-RD device work cost: frames decided (I and
    P/B), the P/B ones among them, and their summed wall time in seconds,
    from the call to the maps on the host (so synchronised with the
    device); and of the device apply (``encoder.fast_apply``), the frames
    applied, their waves and class steps, their summed wall (schedule to
    filled syntax arrays) and the frames whose schedule was rejected,
    which the host apply ran."""
    frames: int = 0
    inter_frames: int = 0
    wall_s: float = 0.0
    device_apply_frames: int = 0
    device_apply_waves: int = 0
    device_apply_class_steps: int = 0
    device_apply_wall_s: float = 0.0
    device_apply_fallback_frames: int = 0
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock,
                                              repr=False)

    def add(self, seconds: float, inter: bool = False) -> None:
        with self._lock:
            self.frames += 1
            self.inter_frames += int(inter)
            self.wall_s += seconds

    def add_apply(self, seconds: float, waves: int, class_steps: int) -> None:
        with self._lock:
            self.device_apply_frames += 1
            self.device_apply_waves += waves
            self.device_apply_class_steps += class_steps
            self.device_apply_wall_s += seconds

    def add_apply_fallback(self) -> None:
        with self._lock:
            self.device_apply_fallback_frames += 1
