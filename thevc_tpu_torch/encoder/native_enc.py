"""Native all-intra encoder glue: drives the C compressSlice/encodeSlice
core (native/codec_core.cpp enc_*) over the CuEncoder's frame state.

The Python CuEncoder remains the bit-exact reference implementation and
the fallback for every configuration the native core does not cover
(inter slices, scaling lists, dQP/rate control, PCM, lossless).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..cabac import contexts as cc
from ..params import I_SLICE


class NativeCuEncoder:
    """Wraps a native EncState for one slice."""

    def __init__(self, handle, lib, refs):
        self.handle = handle
        self.lib = lib
        self._refs = refs   # keepalive for arrays referenced by the C state
        self._out = np.zeros(1 << 22, np.uint8)   # CTU byte sink (reused)

    def compress_ctu(self, ctu_addr: int) -> int:
        return int(self.lib.enc_compress_ctu(self.handle, ctu_addr))

    def set_fd(self, fd_depth, fd_mode, fd_nxn, fd_chroma=None,
               fd_mode2=None, fd_mode3=None, fix_tu: bool = True) -> None:
        """Bind fast-RD decision maps (encoder/fast_intra.py) — the CTU
        loop then applies them instead of running the full search.
        fd_chroma fixes the chroma mode too (None keeps the 5-mode RD);
        fd_mode2/fd_mode3 add runner-up modes for closed-loop
        re-ranking; fix_tu pins the TU tree at the CU size (no RQT
        split RD)."""
        import numpy as np
        fd_depth = np.ascontiguousarray(fd_depth, np.int8)
        fd_mode = np.ascontiguousarray(fd_mode, np.int8)
        fd_nxn = np.ascontiguousarray(fd_nxn, np.uint8)
        cptr = m2ptr = m3ptr = 0
        if fd_chroma is not None:
            fd_chroma = np.ascontiguousarray(fd_chroma, np.int8)
            cptr = fd_chroma.ctypes.data
        if fd_mode2 is not None:
            fd_mode2 = np.ascontiguousarray(fd_mode2, np.int8)
            m2ptr = fd_mode2.ctypes.data
        if fd_mode3 is not None:
            fd_mode3 = np.ascontiguousarray(fd_mode3, np.int8)
            m3ptr = fd_mode3.ctypes.data
        self._fd_keep = (fd_depth, fd_mode, fd_nxn, fd_chroma, fd_mode2,
                         fd_mode3)
        # replayable args so a WPP worker clone can bind the same maps
        self._fd_args = (fd_depth, fd_mode, fd_nxn, fd_chroma, fd_mode2,
                         fd_mode3, fix_tu)
        self.lib.enc_set_fd(self.handle, fd_depth.ctypes.data,
                            fd_mode.ctypes.data, fd_nxn.ctypes.data,
                            cptr, m2ptr, m3ptr, int(fix_tu))

    def set_fd_inter(self, fd_pred, fd_ref, fd_mvx, fd_mvy, fd_dir=None,
                     fd_ref1=None, fd_mvx1=None, fd_mvy1=None) -> None:
        """Bind inter fast-RD decision maps (encoder/fast_inter.py):
        per-unit pred flag, L0 ref idx and quarter-pel MV; B slices also
        bind inter_dir and the L1 ref/MV planes."""
        import numpy as np
        fd_pred = np.ascontiguousarray(fd_pred, np.int8)
        fd_ref = np.ascontiguousarray(fd_ref, np.int8)
        fd_mvx = np.ascontiguousarray(fd_mvx, np.int16)
        fd_mvy = np.ascontiguousarray(fd_mvy, np.int16)
        extras = []
        for a, dt in ((fd_dir, np.int8), (fd_ref1, np.int8),
                      (fd_mvx1, np.int16), (fd_mvy1, np.int16)):
            extras.append(None if a is None
                          else np.ascontiguousarray(a, dt))
        self._fdi_keep = (fd_pred, fd_ref, fd_mvx, fd_mvy, *extras)
        self._fdi_args = self._fdi_keep
        self.lib.enc_set_fd_inter(
            self.handle, fd_pred.ctypes.data, fd_ref.ctypes.data,
            fd_mvx.ctypes.data, fd_mvy.ctypes.data,
            *(None if a is None else a.ctypes.data for a in extras))

    def fill_from_fd(self) -> None:
        """Populate the frame syntax arrays for the fixed fast-RD tree
        from the (device-computed) coefficient planes — the host half of
        the device-apply path (no per-CU math)."""
        r = int(self.lib.enc_fill_from_fd(self.handle))
        assert r == 0, "enc_fill_from_fd called without fd maps bound"

    def encode_ctu_counter(self, ctu_addr: int) -> int:
        """Counter-only entropy pass over already-filled arrays: advances
        the slice RD context chain like the compress-pass tail re-encode
        and returns the CTU's whole-bit count."""
        return int(self.lib.enc_encode_ctu_counter(self.handle, ctu_addr))

    def get_go_frac(self) -> int:
        return int(self.lib.enc_get_go_frac(self.handle))

    def get_slice_ctx(self):
        ctx = np.zeros(cc.NUM_CTX, np.uint8)
        frac = ctypes.c_uint64(0)
        self.lib.enc_get_slice_ctx(self.handle, ctx.ctypes.data,
                                   ctypes.byref(frac))
        return ctx, int(frac.value)

    def set_slice_ctx(self, ctx, frac: int) -> None:
        """Load the RD chain start state ([0][CI_CURR_BEST]) — the hook
        the WPP fast path uses to apply the per-substream context rules
        (TEncSlice.cpp:846-884) around native per-CTU compression."""
        ctx = np.ascontiguousarray(ctx, np.uint8)
        self.lib.enc_set_slice_ctx(self.handle, ctx.ctypes.data,
                                   ctypes.c_uint64(frac))

    def encode_ctu_real(self, ctu_addr: int, eng, bs) -> None:
        """Run the real-CABAC final pass for one CTU, sharing the
        BinEncoder engine state + OutputBitstream with Python."""
        ctx = eng.ctx
        low = ctypes.c_uint32(eng.low)
        rng = ctypes.c_int32(eng.range)
        bits_left = ctypes.c_int32(eng.bits_left)
        num_buf = ctypes.c_int32(eng.num_buffered_bytes)
        buf_byte = ctypes.c_int32(eng.buffered_byte)
        out = self._out
        cap = out.shape[0]
        n = self.lib.enc_encode_ctu(
            self.handle, ctu_addr, ctx.ctypes.data,
            ctypes.byref(low), ctypes.byref(rng), ctypes.byref(bits_left),
            ctypes.byref(num_buf), ctypes.byref(buf_byte),
            out.ctypes.data, cap, eng.used.ctypes.data)
        assert n <= cap, "CTU bitstream overflow"
        eng.low = int(low.value)
        eng.range = int(rng.value)
        eng.bits_left = int(bits_left.value)
        eng.num_buffered_bytes = int(num_buf.value)
        eng.buffered_byte = int(buf_byte.value)
        bs.write_bytes(out[:n].tobytes())

    def __del__(self):
        try:
            self.lib.enc_destroy(self.handle)
        except Exception:
            pass


def make_native_encoder(cu) -> NativeCuEncoder | None:
    """Build the native encoder for this slice, or None if unsupported."""
    import os
    if os.environ.get("THEVC_NATIVE", "1") == "0":
        return None
    sh, sps, pps, cfg = cu.sh, cu.sps, cu.pps, cu.cfg
    inter = None
    if sh.slice_type != I_SLICE:
        inter = getattr(cu, "inter", None)
        if inter is None:
            return None
        # weighted prediction runs through the Python search (xGetSADw
        # distortion variants are not ported to the C core)
        if inter._wp_active():
            return None
        if sh.num_ref_idx[0] > 16 or sh.num_ref_idx[1] > 16:
            return None
    if cu.scaling is not None:
        return None
    if pps.use_dqp or cu.unit_qp is not None:
        return None
    if sps.use_pcm:
        return None              # PCM mode decision not ported
    if cfg.get("CUTransquantBypassFlagValue", 0):
        return None              # lossless encode not ported
    from .. import native
    lib = native.get_lib()
    if lib is None:
        return None
    from ..decoder.native_parse import fill_frame_arrays

    f = cu.f
    fa = fill_frame_arrays(f)
    ep = native.EncParams()
    ep.slice_type = sh.slice_type
    ep.slice_qp = sh.slice_qp
    ep.bit_depth = sps.internal_bit_depth
    ep.bit_inc = sps.bit_increment
    ep.max_val = (1 << sps.internal_bit_depth) - 1
    ep.qp_bd_offset_y = sps.qp_bd_offset_y
    ep.qp_bd_offset_c = sps.qp_bd_offset_c
    ep.cb_qp_off = pps.chroma_cb_qp_offset + sh.slice_qp_delta_cb
    ep.cr_qp_off = pps.chroma_cr_qp_offset + sh.slice_qp_delta_cr
    ep.use_dqp = 0
    ep.tq_bypass_enable = int(bool(pps.transquant_bypass_enable_flag))
    ep.cu_tq_bypass_value = 0
    ep.use_ts = int(bool(pps.use_transform_skip))
    ep.ts_fast = int(bool(cfg.get("TransformSkipFast", 1)))
    ep.use_rdoq = int(bool(cfg.get("RDOQ", 1)))
    ep.sign_hide = int(bool(pps.sign_hide_flag))
    ep.use_pcm = 0
    ep.pcm_log2_min = sps.pcm_log2_min_size
    ep.pcm_log2_max = sps.pcm_log2_max_size
    ep.add_cu_depth = sps.add_cu_depth
    ep.max_tr_log2 = sps.quadtree_tu_log2_max_size
    ep.min_tr_log2 = sps.quadtree_tu_log2_min_size
    ep.tu_depth_intra = sps.quadtree_tu_max_depth_intra
    ep.tu_depth_inter = sps.quadtree_tu_max_depth_inter
    ep.max_tr_size = sps.max_tr_size
    ep.use_amp = int(bool(sps.use_amp))
    ep.lambda_ = cu.rd.lambda_
    ep.sqrt_lambda = cu.rd.sqrt_lambda
    ep.chroma_weight = cu.rd.chroma_distortion_weight
    ep.lambda_luma = cu.lambda_luma
    ep.lambda_chroma = cu.lambda_chroma
    ep.slice_end_scu = cu._slice_end_scu()
    ep.unit_qp = -1

    from .slice_encoder import enc_init_type
    init = np.ascontiguousarray(
        cc.make_context_states_idx(enc_init_type(sh, pps), sh.slice_qp),
        np.uint8)

    org_y = np.ascontiguousarray(cu.org_y, np.int16)
    org_cb = np.ascontiguousarray(cu.org_cb, np.int16)
    org_cr = np.ascontiguousarray(cu.org_cr, np.int16)
    assert cu.rec_y.dtype == np.int16 and cu.rec_y.flags.c_contiguous
    handle = lib.enc_create(
        ctypes.byref(fa), ctypes.byref(ep),
        ctypes.byref(native.ctx_offsets()),
        ctypes.byref(native.scan_tables()),
        org_y.ctypes.data, org_cb.ctypes.data, org_cr.ctypes.data,
        cu.rec_y.ctypes.data, cu.rec_cb.ctypes.data, cu.rec_cr.ctypes.data,
        cu.rec_y.shape[1], init.ctypes.data)
    if not handle:
        return None
    keep = [fa, ep, init, org_y, org_cb, org_cr, cu.rec_y, cu.rec_cb,
            cu.rec_cr, f]

    if inter is not None:
        # bind the inter environment: merge/AMVP slice params, padded
        # reference planes, ME parameters (mirrors decoder/native_parse.py
        # SliceParams + decoder/recon.py InterRefs population)
        mvctx = inter.mvctx
        sp = native.SliceParams()
        sp.slice_type = sh.slice_type
        sp.slice_qp = sh.slice_qp
        sp.poc = sh.poc
        sp.slice_start_cu = 0
        sp.dep_start_cu = 0
        sp.dependent_slice = 0
        sp.slice_index = 0
        sp.bit_depth = sps.internal_bit_depth
        sp.tq_bypass_enable = int(bool(pps.transquant_bypass_enable_flag))
        sp.use_ts = int(bool(pps.use_transform_skip))
        sp.sign_hide = int(bool(pps.sign_hide_flag))
        sp.add_cu_depth = sps.add_cu_depth
        sp.max_tr_log2 = sps.quadtree_tu_log2_max_size
        sp.min_tr_log2 = sps.quadtree_tu_log2_min_size
        sp.tu_depth_intra = sps.quadtree_tu_max_depth_intra
        sp.tu_depth_inter = sps.quadtree_tu_max_depth_inter
        sp.max_tr_size = sps.max_tr_size
        sp.use_amp = int(bool(sps.use_amp))
        sp.qp_bd_offset_y = sps.qp_bd_offset_y
        sp.num_ref_idx0 = sh.num_ref_idx[0]
        sp.num_ref_idx1 = sh.num_ref_idx[1]
        sp.max_merge = sh.max_num_merge_cand
        sp.mvd_l1_zero = int(bool(sh.mvd_l1_zero_flag))
        sp.tmvp = int(bool(sh.tmvp_enabled))
        sp.plevel = pps.log2_parallel_merge_level_minus2 + 2
        sp.col_dir = getattr(sh, "col_dir", 0)
        sp.is_b = int(sh.slice_type == 0)
        sp.check_ldc = int(bool(mvctx.check_ldc))
        sp.has_col = 0
        for lst in range(2):
            for i, poc in enumerate(mvctx.ref_pocs[lst][:16]):
                sp.ref_pocs[lst][i] = poc
        col = mvctx.col_pic
        if col is not None:
            sp.has_col = 1
            sp.col_poc = col.poc
            col_ref_poc = col.ref_poc
            if col_ref_poc.dtype != np.int64 or \
                    not col_ref_poc.flags.c_contiguous:
                col_ref_poc = np.ascontiguousarray(col_ref_poc, np.int64)
            keep.append(col_ref_poc)
            keep.append(col)
            sp.col_pred_mode = col.pred_mode.ctypes.data
            sp.col_ref_idx = col.ref_idx.ctypes.data
            sp.col_mv = col.mv.ctypes.data
            sp.col_ref_poc = col_ref_poc.ctypes.data

        refs = native.InterRefs()
        margin = 0
        for lst in (0, 1):
            pics = inter.lists[lst]
            refs.n_ref[lst] = len(pics)
            for i, pic in enumerate(pics):
                pad_y, pad_cb, pad_cr = pic.padded()
                keep.append((pad_y, pad_cb, pad_cr))
                refs.pad_y[lst * 16 + i] = pad_y.ctypes.data
                refs.pad_cb[lst * 16 + i] = pad_cb.ctypes.data
                refs.pad_cr[lst * 16 + i] = pad_cr.ctypes.data
                refs.ref_poc[lst * 16 + i] = pic.poc
                margin = pic.margin
                refs.ys = pad_y.shape[1]
                refs.cs = pad_cb.shape[1]
        refs.margin = margin

        me = native.EncInterParams()
        me.search_range = inter.search_range
        me.bipred_range = inter.bipred_range
        me.fast_enc = int(bool(inter.fast_enc))
        me.use_had_me = int(bool(inter.use_had_me))
        me.fdm = int(bool(inter.fdm))
        me.lambda_motion_sad = cu.rd.lambda_motion_sad
        me.is_b = int(bool(inter.is_b))
        me.mvd_l1_zero = int(bool(sh.mvd_l1_zero_flag))
        me.num_ref_lc = getattr(sh, "num_ref_lc", 0)
        me.no_back_pred = int(bool(getattr(sh, "no_back_pred", False)))
        for i in range(16):
            me.ref_idx_of_l0_from_l1[i] = sh.ref_idx_of_l0_from_l1[i]
            me.ref_idx_of_lc[0][i] = sh.ref_idx_of_lc[0][i]
            me.ref_idx_of_lc[1][i] = sh.ref_idx_of_lc[1][i]
        lib.enc_set_inter(handle, ctypes.byref(sp), ctypes.byref(refs),
                          ctypes.byref(me))
        keep += [sp, refs, me]

    return NativeCuEncoder(handle, lib, tuple(keep))
