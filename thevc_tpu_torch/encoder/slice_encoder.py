"""Slice-level encoding: lambda/QP init, CTU compression loop, final write.

Behavioral reference: TEncSlice.cpp (initEncSlice :164, compressSlice :652,
encodeSlice :999) for the single-substream, no-tiles, no-WPP configuration.

The two-pass structure per CTU is preserved exactly:
  1. compressCU — RD search with the GoOn fractional-bit counter and the
     [depth][CI_*] snapshot grid seeded from [0][CI_CURR_BEST];
  2. encodeCU with the counter engine starting from [0][CI_CURR_BEST] —
     this (not the search's NEXT_BEST) produces the next CTU's start state
     (TEncSlice.cpp:912-934).
The real arithmetic pass (encode_slice) then replays the final syntax with
BinEncoder from fresh slice-init contexts.
"""

from __future__ import annotations

import math

import numpy as np

from ..bitstream import OutputBitstream
from ..cabac import contexts as cc
from ..cabac.bitcount import CounterEncoder
from ..cabac.engine import BinEncoder
from ..common import rom
from ..decoder.frame import FrameModel
from ..params import I_SLICE, P_SLICE, SliceHeader
from .cu_encoder import CI_CURR_BEST, CuEncoder
from .rdcost import RdCost
from .sbac_writer import SbacWriter


def init_enc_slice(cfg, sps, pps, poc: int, gop_id: int, nal_type: int,
                   rc=None):
    """initEncSlice: slice type, QP, lambda (TEncSlice.cpp:164).

    Returns (SliceHeader, lambda, chroma_weight, lambda_chroma).
    rc: active rate controller — overrides the QP (TEncSlice.cpp:248-251).
    """
    ge = cfg.gop_list[gop_id] if gop_id < len(cfg.gop_list) else None

    # depth from GOP position (TEncSlice.cpp:180)
    depth = 0
    gop_size = cfg.gop_size
    ipoc = poc % gop_size if gop_size else 0
    if ipoc != 0:
        step = gop_size
        i = step >> 1
        while i >= 1:
            found = any(j == ipoc for j in range(i, gop_size, step))
            # NB the reference increments iDepth even on the found
            # iteration (i=0 + break exits the inner loop only;
            # iStep>>=1 and iDepth++ still execute, TEncSlice.cpp:192-204)
            step >>= 1
            depth += 1
            if found:
                break
            i >>= 1

    intra_period = cfg.intra_period
    is_intra = (poc == 0 or (intra_period > 0 and poc % intra_period == 0)
                or cfg.gop_size == 0)
    slice_type = I_SLICE if is_intra else 0  # B_SLICE otherwise

    dqp = float(cfg.qp)
    if slice_type != I_SLICE and ge is not None:
        dqp += ge.qp_offset
    if rc is not None:
        referenced = True if slice_type == I_SLICE else \
            bool(ge.ref_pic) if ge is not None else True
        dqp = float(rc.get_frame_qp(referenced, poc))

    # lambda (iDQpIdx = 0 case)
    num_b = cfg.gop_size - 1
    shift_qp = 12
    lambda_scale = 1.0 - max(0.0, min(0.5, 0.05 * num_b))
    qp_temp = dqp - shift_qp
    qp_factor = ge.qp_factor if ge is not None else 1.0
    if slice_type == I_SLICE:
        qp_factor = 0.57 * lambda_scale
    lam = qp_factor * math.pow(2.0, qp_temp / 3.0)
    if depth > 0:
        lam *= max(2.0, min(4.0, qp_temp / 6.0))
    if not cfg.use_had_me:
        lam *= 0.95
    iqp = max(-sps.qp_bd_offset_y, min(51, int(math.floor(dqp + 0.5))))

    # LambdaModifier per temporal layer (TEncSlice.cpp:313-316)
    if slice_type != I_SLICE:
        lam *= cfg.lambda_modifier[ge.temporal_id if ge is not None else 0]

    # WEIGHTED_CHROMA_DISTORTION weight (TEncSlice.cpp:320-328); uses the
    # pre-recalculation QP even when RecalculateQPAccordingToLambda is on
    weight = 1.0
    if iqp >= 0:
        weight = math.pow(2.0, (iqp - int(rom.CHROMA_SCALE[iqp])) / 3.0)

    # RECALCULATE_QP_ACCORDING_LAMBDA (TEncSlice.cpp:352-357,
    # xGetQPValueAccordingToLambda :1710)
    if cfg.recalculate_qp_according_to_lambda:
        dqp_recal = 4.2005 * math.log(lam) + 13.7122
        iqp = max(-sps.qp_bd_offset_y,
                  min(51, int(math.floor(dqp_recal + 0.5))))

    sh = SliceHeader(nal_unit_type=nal_type, temporal_id=0,
                     slice_type=slice_type, poc=poc, slice_qp=iqp)
    sh.gop_depth = depth
    sh.cabac_init_flag = False
    sh.max_num_merge_cand = 5
    sh.slice_cur_start_cu_addr = 0
    sh.slice_cur_end_cu_addr = sps.num_ctus * sps.num_partitions
    sh.dependent_slice_start_cu_addr = 0
    sh.dependent_slice_end_cu_addr = sh.slice_cur_end_cu_addr
    sh.loop_filter_disable = bool(cfg.loop_filter_disable)
    sh.loop_filter_beta_offset = cfg.loop_filter_beta_offset_div2 << 1
    sh.loop_filter_tc_offset = cfg.loop_filter_tc_offset_div2 << 1
    sh.lf_cross_slice_boundary_flag = bool(cfg.lf_cross_slice_boundary_flag)
    sh.tmvp_enabled = cfg.tmvp_mode == 1 and slice_type != I_SLICE
    return sh, lam, weight, lam / weight


def rc_lambda_recalc(cu: CuEncoder, cfg, sh, change_qp: int,
                     id_gop: int) -> None:
    """xLamdaRecalculation (TEncSlice.cpp:413): refresh every lambda from
    the unit QP chosen by the rate controller (slice header QP unchanged)."""
    sps = cu.sps
    num_b = cfg.gop_size - 1
    lambda_scale = 1.0 - max(0.0, min(0.5, 0.05 * num_b))
    qp_temp = float(change_qp) - 12
    ge = cfg.gop_list[id_gop] if id_gop < len(cfg.gop_list) else None
    qp_factor = ge.qp_factor if ge is not None else 1.0
    if sh.slice_type == I_SLICE:
        qp_factor = 0.57 * lambda_scale
    lam = qp_factor * math.pow(2.0, qp_temp / 3.0)
    if sh.gop_depth > 0:
        lam *= max(2.0, min(4.0, qp_temp / 6.0))
    if not cfg.use_had_me:
        lam *= 0.95
    if sh.slice_type != I_SLICE:
        # NB the reference indexes the modifier by DEPTH here, unlike
        # initEncSlice's temporal-layer index (TEncSlice.cpp:474-477)
        lam *= cfg.lambda_modifier[sh.gop_depth]
    qp = max(-sps.qp_bd_offset_y,
             min(51, int(math.floor(change_qp + 0.5))))
    weight = 1.0
    if qp >= 0:
        weight = math.pow(2.0, (qp - int(rom.CHROMA_SCALE[qp])) / 3.0)
    cu.rd.set_lambda(lam)
    cu.rd.chroma_distortion_weight = weight
    cu.lambda_luma = lam
    cu.lambda_chroma = lam / weight


def make_cu_encoder(cfg, sps, pps, sh, frame: FrameModel, org_planes,
                    rec_planes, lam: float, weight: float,
                    lam_chroma: float) -> CuEncoder:
    rd = RdCost(sps.bit_increment)
    rd.set_lambda(lam)
    rd.chroma_distortion_weight = weight
    enc_cfg = {"RDOQ": cfg.use_rdoq,
               "TransformSkipFast": cfg.use_transform_skip_fast,
               "CUTransquantBypassFlagValue": cfg.cu_transquant_bypass_flag_value,
               "SliceMode": cfg.slice_mode,
               "SliceArgument": cfg.slice_argument,
               "DependentSliceMode": cfg.dependent_slice_mode,
               "DependentSliceArgument": cfg.dependent_slice_argument}
    return CuEncoder(frame, sh, sps, pps, org_planes, rec_planes, rd,
                     lam, lam_chroma, enc_cfg)


def compress_slice(cu: CuEncoder) -> None:
    """compressSlice CTU loop (single substream, raster order)."""
    f = cu.f
    sh = cu.sh
    init = cc.make_context_states(sh.slice_type, sh.slice_qp,
                                  sh.cabac_init_flag)
    cu.snap[0][CI_CURR_BEST] = (init.copy(), 0)
    # slice bookkeeping for availability
    f.slice_start[:, :] = sh.slice_cur_start_cu_addr
    f.tile_idx[:, :] = 0

    for ctu_addr in range(f.num_ctus):
        cu.compress_ctu(ctu_addr)
        # final-pass re-encode with the counter: advances [0][CI_CURR_BEST]
        ctx, frac = cu.snap[0][CI_CURR_BEST]
        eng = CounterEncoder(ctx.copy())
        eng.frac_bits = frac
        w = SbacWriter(f, sh, cu.sps, cu.pps, eng)
        cu.encode_ctu(ctu_addr, w)
        cu.snap[0][CI_CURR_BEST] = (eng.ctx, eng.frac_bits)


def encode_slice(cu: CuEncoder, sao_write=None) -> OutputBitstream:
    """encodeSlice: real CABAC pass producing the slice substream."""
    f = cu.f
    sh = cu.sh
    bs = OutputBitstream()
    ctx = cc.make_context_states(sh.slice_type, sh.slice_qp,
                                 sh.cabac_init_flag)
    eng = BinEncoder(bs, ctx)
    eng.start()
    w = SbacWriter(f, sh, cu.sps, cu.pps, eng)
    for ctu_addr in range(f.num_ctus):
        if sao_write is not None:
            sao_write(w, ctu_addr)
        cu.encode_ctu(ctu_addr, w)
    # terminating bit + finish + stop bit + alignment (TEncGOP.cpp:921-929)
    eng.encode_bin_trm(1)
    eng.finish()
    bs.write(1, 1)
    bs.write_align_zero()
    return bs


# ---------------------------------------------------------------------------
# Multi-slice / tiles / WPP picture compression
# (TEncGOP.cpp:560-625 segmentation driver, TEncSlice.cpp:652-997 compress +
# encode passes, TEncSlice.cpp:1402 boundary determination)
# ---------------------------------------------------------------------------

def enc_init_type(sh, pps) -> int:
    """Encoder-side CABAC init table: the PPS's encCABACTableIdx when set by
    a previous inter slice (TEncSbac::resetEntropy :112-124), else the
    slice's own type."""
    idx = getattr(pps, "enc_cabac_table_idx", I_SLICE)
    if (sh.slice_type != I_SLICE and pps.cabac_init_present_flag
            and idx != I_SLICE):
        return idx
    return sh.slice_type


def _scu_enc_to_raster(f, scu: int) -> int:
    """getPicSCUAddr: encode-order SCU -> raster SCU."""
    p = f.parts_per_ctu
    return int(f.ctu_order[scu // p]) * p + scu % p


def _scu_raster_to_enc(f, scu: int) -> int:
    """getPicSCUEncOrder: raster SCU -> encode-order SCU."""
    p = f.parts_per_ctu
    return int(f.ctu_inv_order[scu // p]) * p + scu % p


def real_end_address(f) -> int:
    """Last in-picture SCU + 1 (TEncGOP.cpp:450-468)."""
    parts = f.parts_per_ctu
    upr = f.units_per_row
    internal = parts - 4
    external = f.num_ctus - 1
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
        external += 1
    return external * parts + internal


def _real_start_address(f, scu_enc: int) -> int:
    """Advance an encode-order SCU start address past out-of-picture parts
    (TEncSlice.cpp:1622-1640 'calculate real dependent slice start')."""
    parts = f.parts_per_ctu
    upr = f.units_per_row
    raster = _scu_enc_to_raster(f, scu_enc)
    internal = raster % parts
    external = raster // parts

    def pos(ext, itn):
        r = int(f.z2r[itn])
        return ((ext % f.ctus_w) * f.ctu_size + (r % upr) * 4,
                (ext // f.ctus_w) * f.ctu_size + (r // upr) * 4)

    px, py = pos(external, internal)
    while (px >= f.width or py >= f.height) and \
            not (px >= f.width and py >= f.height):
        internal += 1
        if internal >= parts:
            internal = 0
            nxt = int(f.ctu_inv_order[external]) + 1
            external = int(f.ctu_order[nxt]) if nxt < f.num_ctus else f.num_ctus
        px, py = pos(external, internal)
    return _scu_raster_to_enc(f, external * parts + internal) \
        if external < f.num_ctus else f.num_ctus * parts


def _tiles_increment(f, tiles, start_scu: int, n_arg: int) -> int:
    """Tiles-in-slice SCU increment (TEncSlice.cpp:1428-1448): sum of the
    sizes of n_arg tiles starting at the tile containing start_scu."""
    parts = f.parts_per_ctu
    n_tiles = tiles.n_cols * tiles.n_rows
    lcu_enc = start_scu // parts
    tile_idx = int(tiles.tile_idx_map[int(f.ctu_order[lcu_enc])])
    inc = 0
    for k in range(n_arg):
        if tile_idx + k < n_tiles:
            inc += int(tiles.widths[tile_idx + k]) \
                * int(tiles.heights[tile_idx + k]) * parts
    return inc


def determine_bounds(cfg, f, sh, encode_pass: bool):
    """xDetermineStartAndBoundingCUAddr (TEncSlice.cpp:1402) for slice
    modes 0-3 and dependent-slice modes 0-3.  Updates the slice header's
    end addresses, next_slice/next_dependent_slice flags (compress pass),
    and returns (start, bounding) in encode-order SCUs."""
    parts = f.parts_per_ctu
    num_scus = f.num_ctus * parts
    tiles = f.tiles
    n_tiles = tiles.n_cols * tiles.n_rows if tiles is not None else 1

    start_slice = sh.slice_cur_start_cu_addr
    if cfg.slice_mode == 1:
        bound_slice = min(start_slice + cfg.slice_argument * parts, num_scus)
    elif cfg.slice_mode == 2:
        # byte budget: end discovered dynamically during compression
        # (finishCU); the final pass re-uses the recorded end address
        bound_slice = sh.slice_cur_end_cu_addr if encode_pass else num_scus
    elif cfg.slice_mode == 3:
        bound_slice = min(start_slice + _tiles_increment(
            f, tiles, start_slice, cfg.slice_argument), num_scus)
    else:
        bound_slice = num_scus
    if not encode_pass:
        # WPP: clamp the slice end to the end of the CTU row when the slice
        # does not start at a row boundary (TEncSlice.cpp:1497-1501)
        row_scus = f.ctus_w * parts
        if getattr(f.pps, "num_substreams", 1) > 1 and \
                start_slice % row_scus != 0:
            bound_slice = start_slice - start_slice % row_scus + row_scus
    sh.slice_cur_end_cu_addr = bound_slice

    # clamp slices at tile boundaries (TEncSlice.cpp:1505-1524)
    tile_boundary = False
    if cfg.slice_mode in (1, 2) and n_tiles > 1:
        lcu_enc = (start_slice + parts - 1) // parts
        lcu = int(f.ctu_order[lcu_enc]) if lcu_enc < f.num_ctus else -1
        if lcu >= 0:
            start_tile = int(tiles.tile_idx_map[lcu])
            while lcu_enc < f.num_ctus and \
                    int(tiles.tile_idx_map[int(f.ctu_order[lcu_enc])]) == start_tile:
                lcu_enc += 1
            tile_bound = lcu_enc * parts
            if tile_bound < bound_slice:
                bound_slice = tile_bound
                sh.slice_cur_end_cu_addr = bound_slice
                tile_boundary = True

    start_dep = sh.dependent_slice_start_cu_addr
    if cfg.dependent_slice_mode == 1:
        bound_dep = min(start_dep + cfg.dependent_slice_argument * parts,
                        num_scus)
    elif cfg.dependent_slice_mode == 2:
        # bin budget: end discovered dynamically (finishCU)
        bound_dep = sh.dependent_slice_end_cu_addr if encode_pass \
            else num_scus
    elif cfg.dependent_slice_mode == 3:
        bound_dep = min(start_dep + _tiles_increment(
            f, tiles, start_dep, cfg.dependent_slice_argument), num_scus)
    else:
        bound_dep = num_scus
    if bound_dep > bound_slice:
        bound_dep = bound_slice
    sh.dependent_slice_end_cu_addr = bound_dep

    # real start addresses (skip out-of-picture parts)
    start_dep = _real_start_address(f, start_dep)
    sh.dependent_slice_start_cu_addr = start_dep
    start_slice = _real_start_address(f, start_slice)
    sh.slice_cur_start_cu_addr = start_slice

    start = max(start_slice, start_dep)
    bounding = min(bound_slice, bound_dep)

    if not encode_pass:
        # the known-boundary mode combinations (TEncSlice.cpp:1674-1682)
        sm, dm = cfg.slice_mode, cfg.dependent_slice_mode
        deterministic = (
            (sm in (0, 1, 3) and dm in (0, 1) and (sm or dm))
            or (dm == 3 and sm == 0)
            or tile_boundary)
        if deterministic:
            sh.next_slice = bound_slice <= bound_dep
            sh.next_dependent_slice = bound_dep <= bound_slice
        else:
            sh.next_slice = False
            sh.next_dependent_slice = False
    return start, bounding


class PictureCompressor:
    """Per-picture CABAC-state machinery shared by all slice segments:
    per-substream RD context chains (TEncTop::createWPPCoders),
    WPP/tile context buffers, and dependent-slice context memory.

    compress pass: compress_slice() mirrors TEncSlice::compressSlice's
    CTU loop; final pass: encode_slice() mirrors TEncSlice::encodeSlice.

    ``device``, ``stats`` and ``ref_cache`` go to the fast-RD decision
    passes of a ``cfg.fast_rd`` encode (``fast_intra.decide_frame``,
    ``fast_inter.decide_frame_p``); with ``device_apply`` the apply of
    an intra slice runs on ``device`` too (``fast_apply``).
    """

    def __init__(self, cu: CuEncoder, cfg, device=None, stats=None,
                 ref_cache=None, device_apply: bool = False):
        self.cu = cu
        self.cfg = cfg
        self.device = device
        self.stats = stats
        self.ref_cache = ref_cache
        self.device_apply = device_apply
        f = cu.f
        pps = cu.pps
        self.f = f
        self.parts = f.parts_per_ctu
        self.nsub = getattr(pps, "num_substreams", 1)
        self.tiles = f.tiles
        self.n_tiles = (self.tiles.n_cols * self.tiles.n_rows
                        if self.tiles is not None else 1)
        self.n_tile_cols = self.tiles.n_cols if self.tiles is not None else 1
        self.wpp = pps.tiles_or_entropy_coding_sync_idc == 2
        self.aq = None          # AdaptiveQP layers (preanalyzer.AqLayer)
        self.allow_dep = (pps.dependent_slices_enabled_flag
                          and not pps.cabac_independent_flag)
        sh = cu.sh
        init = cc.make_context_states_idx(enc_init_type(sh, pps),
                                          sh.slice_qp)
        self._init_ctx = init
        # main RD chain start state (m_pppcRDSbacCoder[0][CI_CURR_BEST])
        cu.snap[0][CI_CURR_BEST] = (init.copy(), 0)
        # RD chains: per-substream (ctx, frac) (ppppcRDSbacCoders[s][0][BEST])
        self.sub_best = [(init.copy(), 0) for _ in range(self.nsub)]
        # WPP 2nd-LCU buffers per tile column (m_pcBufferSbacCoders)
        self.buffer_ctx = [init.copy() for _ in range(self.n_tile_cols)]
        # dependent-slice context memory, compress side (CTXMem_enc)
        self.dep_mem = None            # [ctx_2nd_lcu, (ctx_end, frac_end)]
        self.cur_dep_idx = 0           # rpcPic->getCurrDepSliceIdx
        # encode-pass state, created fresh per picture
        self.enc_buffer_ctx = None
        self.enc_buffer_used = None
        self.enc_dep_mem = None
        self.enc_dep_used = None
        # rate control (TEncSlice.cpp:812-819/:968-970 hooks)
        self.rc = None
        self.pic_total_bits = 0

    # -- tile helpers --------------------------------------------------
    def _tile_of(self, ctu: int) -> int:
        return int(self.tiles.tile_idx_map[ctu]) if self.tiles is not None else 0

    def _tile_first(self, tile: int) -> int:
        return int(self.tiles.first_cu[tile]) if self.tiles is not None else 0

    def _tr_sync_ok(self, ctu: int, sh) -> int:
        """Top-right availability for WPP ctx inherit.  Returns 2 = sync,
        1 = dep-slice carry-over sync, 0 = no sync (slice-init ctx)."""
        f = self.f
        ctus_w = f.ctus_w
        parts = self.parts
        if ctu < ctus_w or (ctu % ctus_w) + 1 >= ctus_w:
            return 0
        tr = ctu - ctus_w + 1
        tr_end = int(f.ctu_inv_order[tr]) * parts + parts - 1
        same_tile = self._tile_of(tr) == self._tile_of(ctu)
        if (same_tile and tr_end >= sh.slice_cur_start_cu_addr
                and tr_end >= sh.dependent_slice_start_cu_addr):
            return 2
        if (self.allow_dep and ctu != 0 and same_tile
                and tr_end >= sh.slice_cur_start_cu_addr):
            return 1
        return 0

    def _substream_of(self, ctu: int) -> int:
        if self.nsub <= 1:
            return 0
        lin = ctu // self.f.ctus_w
        per_tile = self.nsub // self.n_tiles
        return self._tile_of(ctu) * per_tile + lin % per_tile

    def _mark_ctu(self, ctu: int, sh, slice_idx: int) -> None:
        f = self.f
        upr = f.units_per_row
        cx, cy = ctu % f.ctus_w, ctu // f.ctus_w
        sl = (slice(cy * upr, (cy + 1) * upr), slice(cx * upr, (cx + 1) * upr))
        f.slice_start[sl] = sh.slice_cur_start_cu_addr
        f.dep_slice_start[sl] = sh.dependent_slice_start_cu_addr
        f.slice_idx[sl] = slice_idx

    def _reinit_type(self, sh):
        """Slice type for tile-boundary ctx re-init: the PPS's
        encCABACTableIdx when set (TEncSlice.cpp:891-903)."""
        return enc_init_type(sh, self.cu.pps)

    # -- threaded WPP compress (THEVC_ENC_THREADS > 1) -------------------
    def _compress_wpp_threaded(self, sh, slice_idx: int, nat,
                               nthreads: int) -> bool:
        """Row-parallel WPP compression: worker threads claim CTU rows and
        advance under the standard wavefront stagger (row r may compress
        column c once row r-1 has finished column c+1 — the same
        dependency HM's WPP frame threads use).  Each worker drives its
        own native EncState bound to the SHARED frame arrays; the
        per-substream CABAC chain lives entirely inside one row, and the
        row-start context inherit (TEncSlice.cpp:846-884) waits on the
        row above's 2nd-CTU snapshot.  The schedule preserves every data
        and context dependency of the sequential loop, so the output is
        byte-identical at any thread count (asserted by
        tests/test_fast_rd.py).  ctypes releases the GIL around
        enc_compress_ctu, so rows genuinely overlap on multicore hosts.
        Returns False to fall back to the sequential loop."""
        import threading
        from .native_enc import make_native_encoder

        cu, f = self.cu, self.f
        ctus_w = f.ctus_w
        n_rows = f.num_ctus // ctus_w
        if n_rows * ctus_w != f.num_ctus or self.nsub != n_rows:
            return False
        # worker encoders share frame arrays/recon; clone decision maps
        nats = [nat]
        for _ in range(min(nthreads, n_rows) - 1):
            n2 = make_native_encoder(cu)
            if n2 is None:
                return False
            if getattr(nat, "_fd_args", None) is not None:
                n2.set_fd(*nat._fd_args)
            if getattr(nat, "_fdi_args", None) is not None:
                n2.set_fd_inter(*nat._fdi_args)
            nats.append(n2)

        for enc in range(f.num_ctus):
            self._mark_ctu(int(f.ctu_order[enc]), sh, slice_idx)

        init = self._init_ctx
        progress = [0] * n_rows        # columns completed per row
        after2 = [None] * n_rows       # ctx snapshot after column 1
        results = {}                   # row -> (bits, (ctx, frac), go)
        errors = []
        cond = threading.Condition()
        state = {"next_row": 0}

        def worker(wnat):
            try:
                while True:
                    with cond:
                        r = state["next_row"]
                        if r >= n_rows:
                            return
                        state["next_row"] = r + 1
                    first = r * ctus_w
                    if self._tr_sync_ok(first, sh):
                        with cond:
                            while after2[r - 1] is None and not errors:
                                cond.wait()
                            if errors:
                                return
                            start_ctx = after2[r - 1].copy()
                    else:
                        start_ctx = init.copy()
                    wnat.set_slice_ctx(start_ctx, 0)
                    bits = 0
                    for c in range(ctus_w):
                        if r > 0:
                            need = min(c + 2, ctus_w)
                            with cond:
                                while progress[r - 1] < need and not errors:
                                    cond.wait()
                                if errors:
                                    return
                        bits += wnat.compress_ctu(r * ctus_w + c)
                        with cond:
                            progress[r] = c + 1
                            if c == 1:
                                after2[r] = wnat.get_slice_ctx()[0]
                            cond.notify_all()
                    with cond:
                        results[r] = (bits, wnat.get_slice_ctx(),
                                      wnat.get_go_frac())
            except BaseException as e:    # noqa: BLE001
                with cond:
                    errors.append(e)
                    cond.notify_all()

        threads = [threading.Thread(target=worker, args=(n,))
                   for n in nats]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        self.pic_total_bits += sum(results[r][0] for r in range(n_rows))
        _, last_chain, go_frac = results[n_rows - 1]
        cu.snap[0][CI_CURR_BEST] = last_chain
        cu.go_on.frac_bits = go_frac
        cu._native = nat
        sh.next_slice = True               # TEncSlice tail (nsub > 1)
        return True

    # -- compress pass --------------------------------------------------
    def compress_slice(self, sh, start: int, bounding: int,
                       slice_idx: int) -> None:
        """CTU loop of TEncSlice::compressSlice over [start, bounding)."""
        cu, f = self.cu, self.f
        cu.sh = sh          # finishCU's slice-end checks read the segment
        sh.dependent_slice_counter = 0   # TEncSlice.cpp:657
        sh.finalized = False
        parts = self.parts
        ctus_w = f.ctus_w
        slice_start_raster_lcu = _scu_enc_to_raster(
            f, sh.slice_cur_start_cu_addr) // parts
        dep_start_raster_lcu = _scu_enc_to_raster(
            f, sh.dependent_slice_start_cu_addr) // parts

        # per-slice reset of all RD chains and buffers to slice-init state
        # (TEncSlice.cpp:668-700: resetEntropy + load into the RD coder,
        # the per-substream coders, and the WPP buffers)
        init = self._init_ctx
        cu.snap[0][CI_CURR_BEST] = (init.copy(), 0)
        self.sub_best = [(init.copy(), 0) for _ in range(self.nsub)]
        for b in self.buffer_ctx:
            b[:] = init

        # dependent-slice context restore (TEncSlice.cpp:775-800)
        if self.allow_dep:
            if self.cur_dep_idx:
                # loadContexts copies context models only: the counter state
                # (frac bits) of the freshly reset chains is kept
                if self.cfg.wavefront_synchro:
                    self.buffer_ctx[0][:] = self.dep_mem[0]
                ctx_end = self.dep_mem[1]
                mctx, mfrac = cu.snap[0][CI_CURR_BEST]
                cu.snap[0][CI_CURR_BEST] = (ctx_end.copy(), mfrac)
                sctx, sfrac = self.sub_best[0]
                self.sub_best[0] = (ctx_end.copy(), sfrac)
            else:
                base, _ = cu.snap[0][CI_CURR_BEST]
                self.dep_mem = [base.copy(), base.copy()]

        # native fast path: the whole CTU loop incl. the counter
        # re-encode runs in C (native/codec_core.cpp enc_compress_ctu).
        # plain: one slice, no substreams.  wpp: WaveFrontSynchro
        # substreams — the per-substream context rules
        # (TEncSlice.cpp:846-947) run in Python around the native
        # per-CTU calls via the enc_set/get_slice_ctx hooks.
        n_tiles = (self.tiles.n_cols * self.tiles.n_rows
                   if self.tiles is not None else 1)
        # rate control rides the fast path in fast-RD mode: the frame
        # QP (TEncSlice.cpp:248-251) steers the decision pass, per-LCU
        # stats feed the models from the counter pass, and the unit-level
        # QP refinement is skipped (frame-level RC only — the open-loop
        # decisions are not re-costed per LCU)
        rc_ok = self.rc is None or self.cfg.fast_rd
        base_ok = (n_tiles == 1
                   and not self.allow_dep and rc_ok
                   and self.cfg.slice_mode != 2
                   and self.cfg.dependent_slice_mode != 2
                   and start == 0 and bounding >= f.num_ctus * parts)
        wpp_native = (base_ok and self.nsub > 1 and self.rc is None
                      and self.cfg.wavefront_synchro)
        if base_ok and (self.nsub == 1 or wpp_native):
            from .native_enc import make_native_encoder
            # rate control forces delta QP on (derive_params); fast-RD
            # keeps every CU at the frame QP, a zero delta
            nat = make_native_encoder(
                cu, dqp_at_slice_qp=(self.cfg.fast_rd and self.rc is not None
                                     and self.aq is None))
            if nat is not None and self.cfg.fast_rd \
                    and sh.slice_type != I_SLICE:
                # fast-RD for P/B slices: device-batched motion search
                # (per list + bi stage for B) + intra decisions; the
                # native CTU loop applies the maps with real merge RD
                # and AMVP (encoder/fast_inter.py)
                from ..ops import transforms as tops
                from .fast_intra import chroma_bits2, mode_bits3
                from .fast_inter import decide_frame_p
                bits3 = mode_bits3(sh, cu.pps, self._init_ctx)
                cbits2 = chroma_bits2(self._init_ctx,
                                      cu.rd.chroma_distortion_weight)
                qp_cb = tops.qp_scaled(
                    sh.slice_qp, False, cu.sps.qp_bd_offset_c,
                    cu.pps.chroma_cb_qp_offset + sh.slice_qp_delta_cb)
                qp_cr = tops.qp_scaled(
                    sh.slice_qp, False, cu.sps.qp_bd_offset_c,
                    cu.pps.chroma_cr_qp_offset + sh.slice_qp_delta_cr)
                refs = [(p.poc, p.rec_y, p.rec_cb, p.rec_cr)
                        for p in cu.inter.lists[0]]
                is_b = sh.slice_type != P_SLICE
                refs1 = [(p.poc, p.rec_y, p.rec_cb, p.rec_cr)
                         for p in cu.inter.lists[1]] if is_b else None
                fd = decide_frame_p(
                    cu.org_y, cu.org_cb, cu.org_cr, refs,
                    f.width, f.height,
                    sh.slice_qp + cu.sps.qp_bd_offset_y, qp_cb, qp_cr,
                    cu.rd.lambda_, cu.rd.sqrt_lambda,
                    cu.rd.lambda_motion_sad / 65536.0, bits3, cbits2,
                    f.max_depth - cu.sps.add_cu_depth,
                    cu.sps.quadtree_tu_log2_min_size,
                    self.cfg.search_range, f.ctu_size,
                    cu.sps.bit_increment,
                    (1 << cu.sps.internal_bit_depth) - 1,
                    ref_pics_l1=refs1, device=self.device, stats=self.stats,
                    ref_cache=self.ref_cache)
                nat.set_fd(fd[0], fd[1], fd[2], fd[3], fd[4], fd[5], True)
                nat.set_fd_inter(fd[6], fd[7], fd[8], fd[9],
                                 *(fd[10:14] if is_b else ()))
            if nat is not None and self.cfg.fast_rd \
                    and sh.slice_type == I_SLICE:
                # fast-RD mode: device-batched open-loop decisions replace
                # the full search; the native CTU loop applies them
                from ..ops import transforms as tops
                from .fast_intra import (chroma_bits2, decide_frame,
                                         mode_bits3)
                bits3 = mode_bits3(sh, cu.pps, self._init_ctx)
                cbits2 = chroma_bits2(self._init_ctx,
                                      cu.rd.chroma_distortion_weight)
                qp_cb = tops.qp_scaled(
                    sh.slice_qp, False, cu.sps.qp_bd_offset_c,
                    cu.pps.chroma_cb_qp_offset + sh.slice_qp_delta_cb)
                qp_cr = tops.qp_scaled(
                    sh.slice_qp, False, cu.sps.qp_bd_offset_c,
                    cu.pps.chroma_cr_qp_offset + sh.slice_qp_delta_cr)
                fd = decide_frame(
                    cu.org_y, cu.org_cb, cu.org_cr, f.width, f.height,
                    sh.slice_qp + cu.sps.qp_bd_offset_y, qp_cb, qp_cr,
                    cu.rd.lambda_, cu.rd.sqrt_lambda, bits3, cbits2,
                    f.max_depth - cu.sps.add_cu_depth,
                    cu.sps.quadtree_tu_log2_min_size, f.ctu_size,
                    cu.sps.bit_increment,
                    (1 << cu.sps.internal_bit_depth) - 1,
                    device=self.device, stats=self.stats)
                import os as _os
                fix_tu = _os.environ.get("THEVC_FASTRD_FIXTU", "1") != "0"
                dev_chroma = _os.environ.get(
                    "THEVC_FASTRD_DEVCHROMA", "1") != "0"
                top2 = _os.environ.get("THEVC_FASTRD_TOP2", "1") != "0"
                nat.set_fd(fd[0], fd[1], fd[2],
                           fd[3] if dev_chroma else None,
                           fd[4] if top2 else None,
                           fd[5] if top2 and len(fd) > 5 else None,
                           fix_tu)
            dev_applied = False
            if (nat is not None and not wpp_native and self.cfg.fast_rd
                    and sh.slice_type == I_SLICE and self.device_apply):
                # device-resident apply: prediction/transform/quant/recon
                # run as a wavefront on the device (encoder/fast_apply.py);
                # the host walks the fixed tree with the bit counter only
                from . import fast_apply
                dev_applied = fast_apply.device_apply_frame(
                    cu, fd, qp_cb, qp_cr, nat, device=self.device,
                    stats=self.stats)
            def _rc_ctu(ctu, bits):
                """Frame-level RC feedback in fast-RD mode: per-LCU
                distortion/bit stats keep the URQ/MAD models current
                (update_lcu_data/update_unit_status) while the unit QP
                stays at the frame QP."""
                if self.rc is None:
                    return
                self.rc.update_lcu_data(
                    cu.org_y, cu.rec_y, (ctu % f.ctus_w) * f.ctu_size,
                    (ctu // f.ctus_w) * f.ctu_size, bits, sh.slice_qp)
                self.rc.update_unit_status()

            if dev_applied:
                import time as _time
                _t0 = _time.perf_counter()
                for enc in range(f.num_ctus):
                    ctu = int(f.ctu_order[enc])
                    self._mark_ctu(ctu, sh, slice_idx)
                    bits = nat.encode_ctu_counter(ctu)
                    self.pic_total_bits += bits
                    _rc_ctu(ctu, bits)
                fast_apply.add_stage("counter", _time.perf_counter() - _t0)
                cu.snap[0][CI_CURR_BEST] = nat.get_slice_ctx()
                cu.go_on.frac_bits = nat.get_go_frac()
                cu._native = nat
                return
            if nat is not None and not wpp_native:
                for enc in range(f.num_ctus):
                    ctu = int(f.ctu_order[enc])
                    self._mark_ctu(ctu, sh, slice_idx)
                    bits = nat.compress_ctu(ctu)
                    self.pic_total_bits += bits
                    _rc_ctu(ctu, bits)
                cu.snap[0][CI_CURR_BEST] = nat.get_slice_ctx()
                # the SAO RDO coder keeps the GoOn counter's fractional-bit
                # residue from the end of compressSlice (startSaoEnc
                # resetEntropy does not clear m_fracBits)
                cu.go_on.frac_bits = nat.get_go_frac()
                cu._native = nat      # reused by the final entropy pass
                return
            if nat is not None and wpp_native:
                import os as _os
                nthreads = int(_os.environ.get("THEVC_ENC_THREADS", "1"))
                if nthreads > 1 and f.num_ctus > f.ctus_w \
                        and self._compress_wpp_threaded(
                            sh, slice_idx, nat, nthreads):
                    return
                ctus_w_ = f.ctus_w
                for enc in range(f.num_ctus):
                    ctu = int(f.ctu_order[enc])
                    self._mark_ctu(ctu, sh, slice_idx)
                    col = ctu % ctus_w_
                    sub = self._substream_of(ctu)
                    # WPP row-start ctx inherit (TEncSlice.cpp:846-884)
                    if col == 0 and self._tr_sync_ok(ctu, sh):
                        sctx, sfrac = self.sub_best[sub]
                        self.sub_best[sub] = (self.buffer_ctx[0].copy(),
                                              sfrac)
                    nat.set_slice_ctx(*self.sub_best[sub])
                    self.pic_total_bits += nat.compress_ctu(ctu)
                    self.sub_best[sub] = nat.get_slice_ctx()
                    # store 2nd-LCU-of-row contexts (TEncSlice.cpp:938-947)
                    if col == 1:
                        self.buffer_ctx[0][:] = self.sub_best[sub][0]
                cu.snap[0][CI_CURR_BEST] = nat.get_slice_ctx()
                cu.go_on.frac_bits = nat.get_go_frac()
                cu._native = nat
                sh.next_slice = True           # TEncSlice tail (nsub > 1)
                return

        tile_col = 0
        for enc in range(start // parts, (bounding + parts - 1) // parts):
            ctu = int(f.ctu_order[enc])
            self._mark_ctu(ctu, sh, slice_idx)
            col, lin = ctu % ctus_w, ctu // ctus_w
            tile = self._tile_of(ctu)
            tile_col = tile % self.n_tile_cols
            tile_lcux = self._tile_first(tile) % ctus_w
            sub = self._substream_of(ctu)

            # WPP row-start ctx inherit into the substream chain
            if ((self.nsub > 1 or self.allow_dep) and col == tile_lcux
                    and self.cfg.wavefront_synchro):
                sync = self._tr_sync_ok(ctu, sh)
                if sync:
                    sctx, sfrac = self.sub_best[sub]
                    self.sub_best[sub] = (self.buffer_ctx[tile_col].copy(),
                                          sfrac)
            if self.nsub > 1 or (self.allow_dep and self.cfg.wavefront_synchro):
                sctx, sfrac = self.sub_best[sub]
                cu.snap[0][CI_CURR_BEST] = (sctx.copy(), sfrac)

            # tile-start context re-init (TEncSlice.cpp:885-905)
            if (ctu == self._tile_first(tile) and ctu != 0
                    and ctu != slice_start_raster_lcu
                    and ctu != dep_start_raster_lcu):
                ctx, frac = cu.snap[0][CI_CURR_BEST]
                ctx = cc.make_context_states_idx(self._reinit_type(sh),
                                                 sh.slice_qp)
                cu.snap[0][CI_CURR_BEST] = (ctx, frac)

            if self.rc is not None:
                if self.rc.calculate_unit_qp():
                    rc_lambda_recalc(cu, self.cfg, sh,
                                     self.rc.get_unit_qp(),
                                     self.rc.gop_id())
                cu.unit_qp = max(0, min(51, self.rc.get_unit_qp()))
            elif self.aq is not None:
                if cu.pps.max_cu_dqp_depth > 0:
                    # per-depth offsets: the CU recursion computes its own
                    # QP from the AQ layers (xComputeQP, TEncCu.cpp:425)
                    cu.aq_layers = self.aq
                    cu.qp_adaptation_range = self.cfg.qp_adaptation_range
                else:
                    # xComputeQP (TEncCu.cpp:1113): per-CTU psycho-visual
                    # QP (MaxCuDQPDepth=0: the offset is depth-invariant)
                    from .preanalyzer import compute_qp_offset
                    off = compute_qp_offset(
                        self.aq, 0, col * f.ctu_size, lin * f.ctu_size,
                        self.cfg.qp_adaptation_range)
                    cu.unit_qp = max(-cu.sps.qp_bd_offset_y,
                                     min(51, sh.slice_qp + off))

            cu.compress_ctu(ctu)
            # final-pass re-encode advancing [0][CI_CURR_BEST]
            ctx, frac = cu.snap[0][CI_CURR_BEST]
            eng = CounterEncoder(ctx.copy())
            eng.frac_bits = frac
            w = SbacWriter(f, sh, cu.sps, cu.pps, eng)
            cu.encode_ctu(ctu, w)
            cu.snap[0][CI_CURR_BEST] = (eng.ctx, eng.frac_bits)

            # byte/bin budget exceeded: end the segment at the boundary
            # recorded by finishCU (TEncSlice.cpp:922-931)
            if self.cfg.slice_mode == 2 and \
                    sh.slice_bits + eng.num_written_bits > \
                    (self.cfg.slice_argument << 3):
                sh.next_slice = True
                break
            if self.cfg.dependent_slice_mode == 2 and \
                    sh.dependent_slice_counter + eng.bins_coded > \
                    self.cfg.dependent_slice_argument and \
                    sh.slice_cur_end_cu_addr != \
                    sh.dependent_slice_end_cu_addr:
                sh.next_dependent_slice = True
                break

            self.pic_total_bits += cu.total_bits
            if self.rc is not None:
                ux = (ctu % ctus_w) * f.units_per_row
                uy = (ctu // ctus_w) * f.units_per_row
                self.rc.update_lcu_data(
                    cu.org_y, cu.rec_y, (ctu % ctus_w) * f.ctu_size,
                    (ctu // ctus_w) * f.ctu_size, cu.total_bits,
                    int(f.qp[uy, ux]))
                self.rc.update_unit_status()

            self.sub_best[sub] = (eng.ctx.copy(), eng.frac_bits)
            # store 2nd-LCU-of-row contexts (TEncSlice.cpp:938-947)
            if (col == tile_lcux + 1
                    and (self.allow_dep or self.nsub > 1)
                    and self.cfg.wavefront_synchro):
                self.buffer_ctx[tile_col][:] = self.sub_best[sub][0]

        if self.nsub > 1:
            sh.next_slice = True
        if self.allow_dep:
            if self.cfg.wavefront_synchro:
                self.dep_mem[0] = self.buffer_ctx[tile_col].copy()
            self.dep_mem[1] = cu.snap[0][CI_CURR_BEST][0].copy()
            self.cur_dep_idx += 1

    # -- final entropy pass ----------------------------------------------
    def encode_slice(self, sh, sao_write=None):
        """TEncSlice::encodeSlice over the dependent-slice range.  Returns
        (substream OutputBitstreams, tile_locations) for this segment."""
        if getattr(self.cu, "_dev_applied", False):
            import time as _time
            from . import fast_apply as _fa
            _t0 = _time.perf_counter()
            try:
                return self._encode_slice_impl(sh, sao_write)
            finally:
                _fa.add_stage("cabac", _time.perf_counter() - _t0)
        return self._encode_slice_impl(sh, sao_write)

    def _encode_slice_impl(self, sh, sao_write=None):
        cu, f = self.cu, self.f
        cu.sh = sh          # finishCU's slice-end checks read the segment
        parts = self.parts
        ctus_w = f.ctus_w
        start = sh.dependent_slice_start_cu_addr
        bounding = sh.dependent_slice_end_cu_addr
        slice_start_raster_lcu = _scu_enc_to_raster(
            f, sh.slice_cur_start_cu_addr) // parts
        dep_start_raster_lcu = _scu_enc_to_raster(f, start) // parts

        init = cc.make_context_states_idx(enc_init_type(sh, cu.pps),
                                          sh.slice_qp)
        zero_used = np.zeros_like(init)
        subs = [OutputBitstream() for _ in range(self.nsub)]
        engines = [BinEncoder(subs[i], init.copy()) for i in range(self.nsub)]
        # the 2nd-LCU buffers and dep memory shadow the binsCoded marks:
        # loadContexts copies ContextModel structs including m_binsCoded
        if self.enc_buffer_ctx is None:
            self.enc_buffer_ctx = [init.copy()
                                   for _ in range(self.n_tile_cols)]
            self.enc_buffer_used = [zero_used.copy()
                                    for _ in range(self.n_tile_cols)]
        else:
            # per-slice reset of the buffers (TEncSlice.cpp:1035-1040)
            for b, u in zip(self.enc_buffer_ctx, self.enc_buffer_used):
                b[:] = init
                u[:] = 0
        if self.allow_dep:
            if not sh.dependent_slice:
                self.enc_dep_mem = [init.copy(), init.copy()]
                self.enc_dep_used = [zero_used.copy(), zero_used.copy()]
            else:
                if self.cfg.wavefront_synchro:
                    self.enc_buffer_ctx[0][:] = self.enc_dep_mem[0]
                    self.enc_buffer_used[0][:] = self.enc_dep_used[0]
                engines[0].ctx[:] = self.enc_dep_mem[1]
                engines[0].used[:] = self.enc_dep_used[1]

        tile_locations = []
        bits_at_tile_start = 0
        tile_col = 0
        eng = engines[0]
        for enc in range(start // parts, (bounding + parts - 1) // parts):
            ctu = int(f.ctu_order[enc])
            col, lin = ctu % ctus_w, ctu // ctus_w
            tile = self._tile_of(ctu)
            tile_col = tile % self.n_tile_cols
            tile_lcux = self._tile_first(tile) % ctus_w
            sub = self._substream_of(ctu)
            eng = engines[sub]

            if ((self.nsub > 1 or self.allow_dep) and col == tile_lcux
                    and self.cfg.wavefront_synchro):
                if self._tr_sync_ok(ctu, sh):
                    eng.ctx[:] = self.enc_buffer_ctx[tile_col]
                    eng.used[:] = self.enc_buffer_used[tile_col]

            # tile crossing with a single substream: terminate + align +
            # ctx re-init + record tile location (TEncSlice.cpp:1163-1237)
            if (ctu == self._tile_first(tile) and ctu != 0
                    and ctu != slice_start_raster_lcu
                    and ctu != dep_start_raster_lcu):
                if self.nsub <= 1:
                    eng.ctx[:] = cc.make_context_states_idx(
                        self._reinit_type(sh), sh.slice_qp)
                    eng.used[:] = 0
                    eng.encode_bin_trm(1)
                    eng.finish()
                    subs[sub].write(1, 1)
                    subs[sub].write_align_zero()
                    eng.start()
                    # tile entry point: accumulated bytes incl. emulation
                    # prevention inserted later (TEncSlice.cpp:1201-1237)
                    data = subs[sub].get_bytes()
                    emu = _count_emulation_bytes(data)
                    tile_locations.append(len(data) + emu)

            w = SbacWriter(f, sh, cu.sps, cu.pps, eng)
            if sao_write is not None:
                w.ctu_addr = ctu
                tile_ok_l = (col == 0 or
                             self._tile_of(ctu - 1) == tile)
                tile_ok_u = (lin == 0 or
                             self._tile_of(ctu - ctus_w) == tile)
                sao_write(w, ctu, ctu - slice_start_raster_lcu,
                          tile_ok_l, tile_ok_u)
            nat = getattr(cu, "_native", None)
            from . import sbac_writer as _sw
            if nat is not None and _sw.TRACE is None:
                nat.encode_ctu_real(ctu, eng, subs[sub])
            else:
                # the native compressor stores all decisions + coeffs in
                # the shared FrameModel arrays, so the Python writer
                # replays the identical final syntax — with symbol
                # tracing (sbac_writer.TRACE) usable on the NATIVE path
                cu.encode_ctu(ctu, w)

            if (col == tile_lcux + 1
                    and (self.allow_dep or self.nsub > 1)
                    and self.cfg.wavefront_synchro):
                self.enc_buffer_ctx[tile_col][:] = eng.ctx
                self.enc_buffer_used[tile_col][:] = eng.used

        if self.allow_dep:
            if self.cfg.wavefront_synchro:
                self.enc_dep_mem[0] = self.enc_buffer_ctx[tile_col].copy()
                self.enc_dep_used[0] = self.enc_buffer_used[tile_col].copy()
            self.enc_dep_mem[1] = eng.ctx.copy()
            self.enc_dep_used[1] = eng.used.copy()

        # choose the init table for the NEXT slice from this slice's final
        # context states (TEncSlice.cpp:1392-1395)
        if cu.pps.cabac_init_present_flag:
            if sh.slice_type == I_SLICE:
                cu.pps.enc_cabac_table_idx = I_SLICE
            else:
                cu.pps.enc_cabac_table_idx = cc.determine_cabac_init_idx(
                    eng.ctx, eng.used, sh.slice_qp)

        # flush every substream (TEncGOP.cpp:904-935)
        sizes = []
        for i, e in enumerate(engines):
            e.encode_bin_trm(1)
            e.finish()
            subs[i].write(1, 1)
            subs[i].write_align_zero()
            sizes.append(subs[i].num_bits)
        sh.substream_sizes = sizes[:-1]
        return subs, tile_locations


def _count_emulation_bytes(data: bytes) -> int:
    """Number of emulation-prevention bytes NAL writing will insert
    (TEncSlice.cpp:1201-1226)."""
    count = 0
    zeros = 0
    for b in data:
        if zeros >= 2 and b <= 3:
            count += 1
            zeros = 0
        if b == 0:
            zeros += 1
        else:
            zeros = 0
    return count
