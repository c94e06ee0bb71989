"""Native slice-data parse: marshals the FrameModel + slice state into the
C decode core (native/codec_core.cpp parse_slice_data) and runs the whole
CTU loop there — CABAC parse, MV reconstruction, SAO parameters, PCM.

This is the host-side serial stage of the decoder; the Python
SliceDataParser (cu_parser.py) remains the bit-exact reference
implementation and the fallback (THEVC_NATIVE=0, or tracing enabled).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..cabac import contexts as cc
from ..params import I_SLICE, Pps, SliceHeader, Sps


def _frame_geom(f):
    """Cached contiguous int32/int64 geometry tables for the native core."""
    g = getattr(f, "_native_geom", None)
    if g is None:
        g = {
            "z2r": np.ascontiguousarray(f.z2r, np.int32),
            "r2z": np.ascontiguousarray(f.r2z, np.int32),
            "ctu_order": np.ascontiguousarray(f.ctu_order, np.int64),
            "ctu_inv_order": np.ascontiguousarray(f.ctu_inv_order, np.int64),
            "tile_map": np.ascontiguousarray(
                f.tiles.tile_idx_map if f.tiles is not None
                else np.zeros(f.num_ctus), np.int32),
            "tile_first": np.ascontiguousarray(
                f.tiles.first_cu if f.tiles is not None
                else np.zeros(1), np.int32),
        }
        f._native_geom = g
    return g


def _frame_outputs(f):
    """Per-frame TU/CU output arrays (shared across this picture's slices)."""
    o = getattr(f, "_native_out", None)
    if o is None:
        n_units = f.frame_units_w * f.frame_units_h
        o = {
            "luma_tus": np.zeros((n_units + 64, 6), np.int32),
            "chroma_tus": np.zeros((n_units + 64, 6), np.int32),
            "cu_list": np.zeros((n_units // 4 + 64, 8), np.int32),
            "n_luma": 0, "n_chroma": 0, "n_cu": 0,
        }
        f._native_out = o
    return o


def fill_frame_arrays(f):
    """Populate a native.FrameArrays view over the FrameModel's storage."""
    from .. import native
    geom = _frame_geom(f)
    fa = native.FrameArrays()
    for name, arr in (
            ("depth", f.depth), ("pred_mode", f.pred_mode),
            ("part_size", f.part_size_arr), ("merge_idx", f.merge_idx),
            ("inter_dir", f.inter_dir), ("luma_dir", f.luma_dir),
            ("chroma_dir", f.chroma_dir), ("tr_idx", f.tr_idx),
            ("qp", f.qp), ("ref_idx", f.ref_idx), ("mvp_idx", f.mvp_idx),
            ("skip", f.skip), ("merge_flag", f.merge_flag),
            ("tq_bypass", f.tq_bypass), ("ipcm", f.ipcm), ("cbf", f.cbf),
            ("ts_flag", f.ts_flag), ("mv", f.mv), ("mvd", f.mvd),
            ("slice_start", f.slice_start),
            ("dep_slice_start", f.dep_slice_start),
            ("slice_idx_arr", f.slice_idx), ("tile_idx", f.tile_idx),
            ("coeff_y", f.coeff_y), ("coeff_cb", f.coeff_cb),
            ("coeff_cr", f.coeff_cr)):
        setattr(fa, name, arr.ctypes.data)
    if hasattr(f, "pcm_y"):
        fa.pcm_y = f.pcm_y.ctypes.data
        fa.pcm_cb = f.pcm_cb.ctypes.data
        fa.pcm_cr = f.pcm_cr.ctypes.data
    fa.sao_type = f.sao_type.ctypes.data
    fa.sao_sub_type = f.sao_sub_type.ctypes.data
    fa.sao_offsets = f.sao_offsets.ctypes.data
    fa.sao_merge_left = f.sao_merge_left.ctypes.data
    fa.sao_merge_up = f.sao_merge_up.ctypes.data
    fa.uw, fa.uh = f.frame_units_w, f.frame_units_h
    fa.upr = f.units_per_row
    fa.ctus_w, fa.ctus_h, fa.num_ctus = f.ctus_w, f.ctus_h, f.num_ctus
    fa.ctu_size, fa.max_depth = f.ctu_size, f.max_depth
    fa.parts, fa.width, fa.height = f.parts_per_ctu, f.width, f.height
    fa.z2r = geom["z2r"].ctypes.data
    fa.r2z = geom["r2z"].ctypes.data
    fa.ctu_order = geom["ctu_order"].ctypes.data
    fa.ctu_inv_order = geom["ctu_inv_order"].ctypes.data
    fa.tile_map = geom["tile_map"].ctypes.data
    fa.tile_first = geom["tile_first"].ctypes.data
    fa.n_tile_cols = f.tiles.n_cols if f.tiles is not None else 1
    fa.n_tile_rows = f.tiles.n_rows if f.tiles is not None else 1
    return fa


def parse_slice_native(f, sh: SliceHeader, sps: Sps, pps: Pps, bs,
                       mvctx=None, slice_idx: int = 0, substreams=None,
                       dep_ctx_in=None):
    """Run the native slice parse.  Returns (True, dep_ctx_out) on success,
    (False, None) when the native core is unavailable."""
    from .. import native
    from . import cu_parser
    if cu_parser.TRACE is not None:
        return False, None
    lib = native.get_lib()
    if lib is None:
        return False, None

    geom = _frame_geom(f)
    out = _frame_outputs(f)

    if sps.use_pcm and not hasattr(f, "pcm_y"):
        f.pcm_y = np.zeros((f.frame_units_h * 4, f.frame_units_w * 4),
                           np.int16)
        f.pcm_cb = np.zeros((f.frame_units_h * 2, f.frame_units_w * 2),
                            np.int16)
        f.pcm_cr = np.zeros((f.frame_units_h * 2, f.frame_units_w * 2),
                            np.int16)

    fa = fill_frame_arrays(f)
    fa.luma_tus = out["luma_tus"].ctypes.data
    fa.chroma_tus = out["chroma_tus"].ctypes.data
    fa.cu_list = out["cu_list"].ctypes.data
    fa.n_luma, fa.n_chroma, fa.n_cu = (out["n_luma"], out["n_chroma"],
                                       out["n_cu"])

    sp = native.SliceParams()
    sp.slice_type = sh.slice_type
    sp.slice_qp = sh.slice_qp
    sp.poc = sh.poc
    sp.slice_start_cu = sh.slice_cur_start_cu_addr
    sp.dep_start_cu = sh.dependent_slice_start_cu_addr
    sp.dependent_slice = int(bool(sh.dependent_slice))
    sp.slice_index = slice_idx
    sp.sao_enabled = int(bool(sh.sao_enabled))
    sp.sao_enabled_chroma = int(bool(sh.sao_enabled_chroma))
    sp.use_sao = int(bool(sps.use_sao))
    sp.bit_depth = sps.internal_bit_depth
    sp.use_dqp = int(bool(pps.use_dqp))
    sp.max_cu_dqp_depth = pps.max_cu_dqp_depth
    sp.tq_bypass_enable = int(bool(pps.transquant_bypass_enable_flag))
    sp.use_ts = int(bool(pps.use_transform_skip))
    sp.sign_hide = int(bool(pps.sign_hide_flag))
    sp.use_pcm = int(bool(sps.use_pcm))
    sp.pcm_log2_min = sps.pcm_log2_min_size
    sp.pcm_log2_max = sps.pcm_log2_max_size
    sp.pcm_bd_luma = sps.pcm_bit_depth_luma
    sp.pcm_bd_chroma = sps.pcm_bit_depth_chroma
    sp.add_cu_depth = sps.add_cu_depth
    sp.max_tr_log2 = sps.quadtree_tu_log2_max_size
    sp.min_tr_log2 = sps.quadtree_tu_log2_min_size
    sp.tu_depth_intra = sps.quadtree_tu_max_depth_intra
    sp.tu_depth_inter = sps.quadtree_tu_max_depth_inter
    sp.max_tr_size = sps.max_tr_size
    sp.use_amp = int(bool(sps.use_amp))
    sp.qp_bd_offset_y = sps.qp_bd_offset_y
    wpp = pps.tiles_or_entropy_coding_sync_idc == 2
    sp.wpp = int(wpp)
    allow_dep = (pps.dependent_slices_enabled_flag
                 and not getattr(pps, "cabac_independent_flag", False))
    sp.allow_dep = int(bool(allow_dep))
    sp.num_ref_idx0 = sh.num_ref_idx[0] if not sh.is_intra else 0
    sp.num_ref_idx1 = sh.num_ref_idx[1] if not sh.is_intra else 0
    sp.max_merge = sh.max_num_merge_cand
    sp.mvd_l1_zero = int(bool(getattr(sh, "mvd_l1_zero_flag", False)))
    sp.tmvp = int(bool(sh.tmvp_enabled))
    sp.plevel = pps.log2_parallel_merge_level_minus2 + 2
    sp.col_dir = getattr(sh, "col_dir", 0)
    sp.is_b = int(sh.slice_type == 0)
    sp.has_col = 0
    keepalive = []
    if mvctx is not None:
        sp.check_ldc = int(bool(mvctx.check_ldc))
        for lst in range(2):
            for i, poc in enumerate(mvctx.ref_pocs[lst][:16]):
                sp.ref_pocs[lst][i] = poc
        col = mvctx.col_pic
        if col is not None:
            sp.has_col = 1
            sp.col_poc = col.poc
            ref_poc = col.ref_poc
            if ref_poc.dtype != np.int64 or not ref_poc.flags.c_contiguous:
                ref_poc = np.ascontiguousarray(ref_poc, np.int64)
                keepalive.append(ref_poc)
            sp.col_pred_mode = col.pred_mode.ctypes.data
            sp.col_ref_idx = col.ref_idx.ctypes.data
            sp.col_mv = col.mv.ctypes.data
            sp.col_ref_poc = ref_poc.ctypes.data

    # substream engines (buffers held alive for the call duration)
    streams = substreams if substreams is not None else [bs]
    nsub = len(streams)
    engines = (native.BsEngine * nsub)()
    bufs = []
    for i, s in enumerate(streams):
        buf = bytes(s._buf)
        bufs.append(buf)
        engines[i].buf = buf
        engines[i].buf_len = len(buf)
        engines[i].idx = s._idx
        engines[i].held = s._held
        engines[i].num_held = s._num_held
        engines[i].num_bits_read = s._num_bits_read
        engines[i].overflow = 0

    n_ctx = cc.NUM_CTX
    init_ctx = np.ascontiguousarray(
        cc.make_context_states(sh.slice_type, sh.slice_qp,
                               sh.cabac_init_flag), np.uint8)
    sub_ctx = np.zeros((nsub, n_ctx), np.uint8)
    sub_started = np.zeros(nsub, np.uint8)
    buffer_ctx = np.zeros((max(fa.n_tile_cols, 1), n_ctx), np.uint8)
    dep_out_wpp = np.zeros(n_ctx, np.uint8)
    dep_out_end = np.zeros(n_ctx, np.uint8)
    dep_in_wpp_p = None
    dep_in_end_p = None
    if allow_dep and sh.dependent_slice and dep_ctx_in is not None:
        ctx2, ctx_end = dep_ctx_in
        if ctx2 is not None:
            ctx2 = np.ascontiguousarray(ctx2, np.uint8)
            keepalive.append(ctx2)
            dep_in_wpp_p = ctx2.ctypes.data
        ctx_end = np.ascontiguousarray(ctx_end, np.uint8)
        keepalive.append(ctx_end)
        dep_in_end_p = ctx_end.ctypes.data

    info = np.zeros(4, np.int32)
    rc = lib.parse_slice_data(
        ctypes.byref(fa), ctypes.byref(sp),
        ctypes.byref(native.ctx_offsets()),
        ctypes.byref(native.scan_tables()),
        engines, nsub,
        sub_ctx.ctypes.data, sub_started.ctypes.data,
        buffer_ctx.ctypes.data, init_ctx.ctypes.data,
        dep_in_wpp_p, dep_in_end_p,
        dep_out_wpp.ctypes.data, dep_out_end.ctypes.data,
        info.ctypes.data)
    del bufs, keepalive
    if rc != 0:
        raise EOFError("bitstream exhausted (native slice parse)")

    # sync the decode-order TU/CU lists
    n_luma, n_chroma, n_cu = int(info[0]), int(info[1]), int(info[2])
    f.luma_tus.extend(out["luma_tus"][out["n_luma"]:n_luma].tolist())
    f.chroma_tus.extend(out["chroma_tus"][out["n_chroma"]:n_chroma].tolist())
    f.cu_list.extend(out["cu_list"][out["n_cu"]:n_cu].tolist())
    out["n_luma"], out["n_chroma"], out["n_cu"] = n_luma, n_chroma, n_cu

    dep_ctx_out = None
    if allow_dep:
        dep_ctx_out = (dep_out_wpp.copy() if wpp else None,
                       dep_out_end.copy())
    return True, dep_ctx_out
