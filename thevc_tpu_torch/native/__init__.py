"""Native decode core: build + ctypes bindings.

The shared library is compiled on first use with g++ (no pybind11 in the
image; plain C ABI + ctypes).  The CABAC tables are generated from
cabac/tables.py so there is a single source of truth.

The library is built into ``build/thevc_tpu_torch/`` at the root of the
checkout, named by a hash of the sources and the compiler flags, and
loaded with ``RTLD_LOCAL`` so its symbols do not interpose with another
build of the same core in one process.  ``get_lib`` loads it once, under
a lock.

Set THEVC_NATIVE=0 to disable (pure-Python paths remain bit-exact).
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "thevc_tpu_torch"
_SRC = _DIR / "codec_core.cpp"
_HDR = _DIR / "tables_gen.h"
_FLAGS = ("-O3", "-march=native", "-fno-math-errno", "-shared", "-fPIC",
          "-std=c++17")

_lib = None
_tried = False
_lock = threading.Lock()


def _gen_tables_header() -> None:
    from ..cabac import tables as T

    def arr2d(name, a):
        rows = ",\n  ".join(
            "{" + ",".join(str(int(v)) for v in row) + "}" for row in a)
        return (f"static const uint8_t {name}[{a.shape[0]}]"
                f"[{a.shape[1]}] = {{\n  {rows}}};\n")

    def arr1d(name, a):
        vals = ",".join(str(int(v)) for v in a)
        return f"static const uint8_t {name}[{len(a)}] = {{{vals}}};\n"

    from ..common import rom

    def arr1d_t(name, a, ctype):
        vals = ",".join(str(int(v)) for v in a)
        return f"static const {ctype} {name}[{len(a)}] = {{{vals}}};\n"

    def arr2d_t(name, a, ctype):
        rows = ",\n  ".join(
            "{" + ",".join(str(int(v)) for v in row) + "}" for row in a)
        return (f"static const {ctype} {name}[{a.shape[0]}]"
                f"[{a.shape[1]}] = {{\n  {rows}}};\n")

    with io.StringIO() as fh:
        fh.write("// generated from thevc_tpu/cabac/tables.py and "
                 "common/rom.py — do not edit\n")
        fh.write(arr2d("kLPS", np.asarray(T.LPS_TABLE)))
        fh.write(arr1d("kRenorm", np.asarray(T.RENORM_TABLE)))
        fh.write(arr1d("kNextMPS", np.asarray(T.NEXT_STATE_MPS)))
        fh.write(arr1d("kNextLPS", np.asarray(T.NEXT_STATE_LPS)))
        fh.write(arr1d_t("kEntropyBits", np.asarray(T.ENTROPY_BITS),
                         "int32_t"))
        fh.write(arr2d_t("kNextState", np.asarray(T.NEXT_STATE), "uint8_t"))
        fh.write(arr1d_t("kQuantScales", np.asarray(rom.QUANT_SCALES),
                         "int32_t"))
        fh.write(arr1d_t("kGoRiceRange", np.asarray(rom.GO_RICE_RANGE),
                         "int32_t"))
        fh.write(arr1d_t("kGoRicePrefixLen",
                         np.asarray(rom.GO_RICE_PREFIX_LEN), "int32_t"))
        fh.write(arr1d_t("kIntraModeNumFast",
                         np.asarray(rom.INTRA_MODE_NUM_FAST), "int32_t"))
        fh.write(arr1d_t("kChromaScale", np.asarray(rom.CHROMA_SCALE),
                         "int32_t"))
        for s in (4, 8, 16, 32):
            fh.write(arr2d_t(f"kDct{s}", np.asarray(rom.DCT_MATRICES[s]),
                             "int32_t"))
        fh.write(arr2d_t("kDst4", np.asarray(rom.DST4), "int32_t"))
        text = fh.getvalue()
    # rewrite the header only when it changes, and atomically: another
    # process may be compiling from it
    if not _HDR.exists() or _HDR.read_text() != text:
        tmp = _HDR.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(text)
        os.replace(tmp, _HDR)


def _library_path() -> Path:
    """Where the library built from the current sources lives."""
    digest = hashlib.sha256(_SRC.read_bytes() + _HDR.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"codec_core-{digest[:16]}.so"


def _build() -> Path:
    """Compile the core unless the library of these sources exists;
    returns its path.  Raises ``RuntimeError`` with the compiler's output
    when g++ fails.  Safe to call from several processes at once: each
    writes a temporary file and renames it into place."""
    _gen_tables_header()
    so = _library_path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       capture_output=True, text=True)
    so.with_suffix(".log").write_text(r.stdout + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC.name} (log: "
                           f"{so.with_suffix('.log')}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, so)
    return so


class BsEngine(ctypes.Structure):
    _fields_ = [
        ("buf", ctypes.c_char_p),
        ("buf_len", ctypes.c_int64),
        ("idx", ctypes.c_int64),
        ("held", ctypes.c_uint64),
        ("num_held", ctypes.c_int32),
        ("num_bits_read", ctypes.c_int64),
        ("range", ctypes.c_int32),
        ("value", ctypes.c_int64),
        ("bits_needed", ctypes.c_int32),
        ("overflow", ctypes.c_int32),
    ]


class AvailMaps(ctypes.Structure):
    _fields_ = [
        ("order", ctypes.c_void_p),
        ("in_pic", ctypes.c_void_p),
        ("ctu", ctypes.c_void_p),
        ("tile", ctypes.c_void_p),
        ("sstart", ctypes.c_void_p),
        ("pad", ctypes.c_int32),
        ("w", ctypes.c_int32),
        ("uw", ctypes.c_int32),
    ]


class IntraParams(ctypes.Structure):
    _fields_ = [
        ("stride", ctypes.c_int32),
        ("cstride", ctypes.c_int32),
        ("unit", ctypes.c_int32),
        ("avail_div", ctypes.c_int32),
        ("is_luma", ctypes.c_int32),
        ("dc_val", ctypes.c_int32),
        ("max_val", ctypes.c_int32),
        ("bit_inc", ctypes.c_int32),
        ("dct4", ctypes.c_void_p),
        ("dct8", ctypes.c_void_p),
        ("dct16", ctypes.c_void_p),
        ("dct32", ctypes.c_void_p),
        ("dst4", ctypes.c_void_p),
        ("pcm_plane", ctypes.c_void_p),
        ("pcm_stride", ctypes.c_int32),
        # device decode hybrid: precomputed-residual store (or null)
        ("resi_buf", ctypes.c_void_p),
        ("resi_map", ctypes.c_void_p),
        ("map_w", ctypes.c_int32),
    ]


class CoeffCtxOffsets(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in
                ("o_last_x", "o_last_y", "o_sig", "o_sig_cg", "o_one",
                 "o_abs", "num_sig_luma")]


class CtxOffsets(ctypes.Structure):
    """All syntax context offsets (mirrors cabac/contexts.py)."""
    _fields_ = [(n, ctypes.c_int32) for n in
                ("split_flag", "skip_flag", "merge_flag", "merge_idx",
                 "part_size", "amp", "pred_mode", "intra_pred",
                 "chroma_pred", "inter_dir", "mvd", "ref_pic", "dqp",
                 "qt_cbf", "qt_root_cbf", "sig_cg", "sig", "last_x",
                 "last_y", "one", "abs_", "mvp_idx", "sao_merge",
                 "sao_type", "trans_subdiv", "ts_flag", "tq_bypass",
                 "num_sig_luma", "num_ctx")]


class ScanTables(ctypes.Structure):
    _fields_ = [("scan", (ctypes.c_void_p * 4) * 4),
                ("cg", (ctypes.c_void_p * 4) * 4)]


class InterRefs(ctypes.Structure):
    _fields_ = [
        ("pad_y", ctypes.c_void_p * 32),
        ("pad_cb", ctypes.c_void_p * 32),
        ("pad_cr", ctypes.c_void_p * 32),
        ("ref_poc", ctypes.c_int64 * 32),
        ("n_ref", ctypes.c_int32 * 2),
        ("margin", ctypes.c_int32),
        ("ys", ctypes.c_int32),
        ("cs", ctypes.c_int32),
        ("wp_active", ctypes.c_int32),
        ("luma_log2_denom", ctypes.c_int32),
        ("chroma_log2_denom", ctypes.c_int32),
        ("wp_w", ctypes.c_int32 * 96),
        ("wp_o", ctypes.c_int32 * 96),
    ]


class InterReconParams(ctypes.Structure):
    _fields_ = [
        ("slice_type", ctypes.c_int32),
        ("wp_bipred", ctypes.c_int32),
        ("bit_depth", ctypes.c_int32),
        ("bit_inc", ctypes.c_int32),
        ("pic_w", ctypes.c_int32),
        ("pic_h", ctypes.c_int32),
        ("ctu_size", ctypes.c_int32),
        ("rls", ctypes.c_int32),
        ("rcs", ctypes.c_int32),
        ("ls", ctypes.c_int32),
        ("cls", ctypes.c_int32),
        ("qp_bd_y", ctypes.c_int32),
        ("qp_bd_c", ctypes.c_int32),
        ("cb_off", ctypes.c_int32),
        ("cr_off", ctypes.c_int32),
        ("chroma_scale", ctypes.c_void_p),
        ("dct4", ctypes.c_void_p),
        ("dct8", ctypes.c_void_p),
        ("dct16", ctypes.c_void_p),
        ("dct32", ctypes.c_void_p),
    ]


class FrameArrays(ctypes.Structure):
    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("depth", "pred_mode", "part_size", "merge_idx", "inter_dir",
          "luma_dir", "chroma_dir", "tr_idx", "qp", "ref_idx", "mvp_idx",
          "skip", "merge_flag", "tq_bypass", "ipcm", "cbf", "ts_flag",
          "mv", "mvd", "slice_start", "dep_slice_start", "slice_idx_arr",
          "tile_idx", "coeff_y", "coeff_cb", "coeff_cr",
          "pcm_y", "pcm_cb", "pcm_cr",
          "sao_type", "sao_sub_type", "sao_offsets",
          "sao_merge_left", "sao_merge_up")]
        + [(n, ctypes.c_int32) for n in
           ("uw", "uh", "upr", "ctus_w", "ctus_h", "num_ctus",
            "ctu_size", "max_depth", "parts", "width", "height")]
        + [(n, ctypes.c_void_p) for n in
           ("z2r", "r2z", "ctu_order", "ctu_inv_order", "tile_map",
            "tile_first")]
        + [("n_tile_cols", ctypes.c_int32),
           ("n_tile_rows", ctypes.c_int32)]
        + [(n, ctypes.c_void_p) for n in
           ("luma_tus", "chroma_tus", "cu_list")]
        + [("n_luma", ctypes.c_int32), ("n_chroma", ctypes.c_int32),
           ("n_cu", ctypes.c_int32)])


class SliceParams(ctypes.Structure):
    _fields_ = (
        [(n, ctypes.c_int32) for n in
         ("slice_type", "slice_qp", "poc",
          "slice_start_cu", "dep_start_cu", "dependent_slice",
          "slice_index", "sao_enabled", "sao_enabled_chroma", "use_sao",
          "bit_depth", "use_dqp", "max_cu_dqp_depth", "tq_bypass_enable",
          "use_ts", "sign_hide", "use_pcm", "pcm_log2_min", "pcm_log2_max",
          "pcm_bd_luma", "pcm_bd_chroma", "add_cu_depth", "max_tr_log2",
          "min_tr_log2", "tu_depth_intra", "tu_depth_inter", "max_tr_size",
          "use_amp", "qp_bd_offset_y", "wpp", "allow_dep",
          "num_ref_idx0", "num_ref_idx1", "max_merge", "mvd_l1_zero",
          "tmvp", "plevel", "col_dir", "check_ldc", "is_b")]
        + [("ref_pocs", (ctypes.c_int32 * 16) * 2)]
        + [(n, ctypes.c_void_p) for n in
           ("col_pred_mode", "col_ref_idx", "col_mv", "col_ref_poc")]
        + [("col_poc", ctypes.c_int32), ("has_col", ctypes.c_int32)])


class EncInterParams(ctypes.Structure):
    """ME/inter-search parameters (codec_core.cpp EncInterParams)."""
    _fields_ = (
        [(n, ctypes.c_int32) for n in
         ("search_range", "bipred_range", "fast_enc", "use_had_me", "fdm")]
        + [("lambda_motion_sad", ctypes.c_int64)]
        + [(n, ctypes.c_int32) for n in
           ("is_b", "mvd_l1_zero", "num_ref_lc", "no_back_pred")]
        + [("ref_idx_of_l0_from_l1", ctypes.c_int32 * 16),
           ("ref_idx_of_lc", (ctypes.c_int32 * 16) * 2)])


class EncParams(ctypes.Structure):
    _fields_ = (
        [(n, ctypes.c_int32) for n in
         ("slice_type", "slice_qp", "bit_depth", "bit_inc", "max_val",
          "qp_bd_offset_y", "qp_bd_offset_c", "cb_qp_off", "cr_qp_off",
          "use_dqp", "tq_bypass_enable", "cu_tq_bypass_value",
          "use_ts", "ts_fast", "use_rdoq", "sign_hide",
          "use_pcm", "pcm_log2_min", "pcm_log2_max",
          "add_cu_depth", "max_tr_log2", "min_tr_log2", "tu_depth_intra",
          "tu_depth_inter", "max_tr_size", "use_amp")]
        + [(n, ctypes.c_double) for n in
           ("lambda_", "sqrt_lambda", "chroma_weight", "lambda_luma",
            "lambda_chroma")]
        + [("slice_end_scu", ctypes.c_int32),
           ("unit_qp", ctypes.c_int32)])


def get_lib():
    """Load (building if needed) the native library; None only when
    THEVC_NATIVE=0.  The first call builds and loads it under a lock, so
    callers on other threads wait for it instead of seeing None.  Raises
    ``RuntimeError`` (naming the compiler's output) when the build or the
    load fails."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    if os.environ.get("THEVC_NATIVE", "1") == "0":
        return None
    with _lock:
        if _lib is None:
            _lib = _load(_build())
        _tried = True
    return _lib


def _load(so: Path):
    """Bind the library's entry points."""
    try:
        lib = ctypes.CDLL(str(so), mode=os.RTLD_LOCAL)
        lib.parse_coeff_nxn.restype = ctypes.c_int
        lib.parse_coeff_nxn.argtypes = [
            ctypes.POINTER(BsEngine), ctypes.c_void_p,
            ctypes.POINTER(CoeffCtxOffsets),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.intra_recon_tus.restype = None
        lib.intra_recon_tus.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(AvailMaps), ctypes.POINTER(IntraParams)]
        lib.deblock_luma.restype = None
        lib.deblock_luma.argtypes = [ctypes.c_void_p] + \
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        lib.deblock_chroma.restype = None
        lib.deblock_chroma.argtypes = [ctypes.c_void_p] * 2 + \
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        lib.build_edge_maps.restype = None
        lib.build_edge_maps.argtypes = [
            ctypes.POINTER(FrameArrays)] + [ctypes.c_int32] * 5 + \
            [ctypes.c_void_p] * 7
        lib.build_intra_rows.restype = None
        lib.build_intra_rows.argtypes = [
            ctypes.POINTER(FrameArrays), ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.inter_recon_cus.restype = None
        lib.inter_recon_cus.argtypes = [
            ctypes.POINTER(FrameArrays), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(InterRefs), ctypes.POINTER(InterReconParams),
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.get_prof.restype = None
        lib.get_prof.argtypes = [ctypes.c_void_p]
        lib.frame_sse.restype = ctypes.c_double
        lib.frame_sse.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.sao_apply_plane.restype = None
        lib.sao_apply_plane.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.sao_rdo.restype = None
        lib.sao_rdo.argtypes = [
            ctypes.POINTER(FrameArrays), ctypes.POINTER(CtxOffsets)] + \
            [ctypes.c_void_p] * 6 + \
            [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
             ctypes.c_double, ctypes.c_double, ctypes.c_int32,
             ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
             ctypes.c_uint64, ctypes.c_void_p]
        lib.enc_create.restype = ctypes.c_void_p
        lib.enc_create.argtypes = [
            ctypes.POINTER(FrameArrays), ctypes.POINTER(EncParams),
            ctypes.POINTER(CtxOffsets), ctypes.POINTER(ScanTables),
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p]
        lib.enc_destroy.restype = None
        lib.enc_destroy.argtypes = [ctypes.c_void_p]
        lib.enc_set_inter.restype = None
        lib.enc_set_inter.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(SliceParams),
            ctypes.POINTER(InterRefs), ctypes.POINTER(EncInterParams)]
        lib.enc_set_fd.restype = None
        lib.enc_set_fd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32]
        lib.enc_set_fd_inter.restype = None
        lib.enc_set_fd_inter.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.enc_set_slice_ctx.restype = None
        lib.enc_set_slice_ctx.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
        lib.enc_get_go_frac.restype = ctypes.c_uint64
        lib.enc_get_go_frac.argtypes = [ctypes.c_void_p]
        lib.enc_get_slice_ctx.restype = None
        lib.enc_get_slice_ctx.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.enc_compress_ctu.restype = ctypes.c_int64
        lib.enc_compress_ctu.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.enc_encode_ctu.restype = ctypes.c_int64
        lib.enc_encode_ctu.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p]
        try:
            # fast-RD device-apply entry points — absent from older .so
            # builds (e.g. an A/B-bench variant pinned via mtime); the
            # device apply falls back to the host path when missing
            lib.enc_fd_schedule.restype = ctypes.c_int64
            lib.enc_fd_schedule.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            lib.enc_fill_from_fd.restype = ctypes.c_int32
            lib.enc_fill_from_fd.argtypes = [ctypes.c_void_p]
            lib.enc_encode_ctu_counter.restype = ctypes.c_int64
            lib.enc_encode_ctu_counter.argtypes = [
                ctypes.c_void_p, ctypes.c_int32]
        except AttributeError:
            pass
        lib.parse_slice_data.restype = ctypes.c_int
        lib.parse_slice_data.argtypes = [
            ctypes.POINTER(FrameArrays), ctypes.POINTER(SliceParams),
            ctypes.POINTER(CtxOffsets), ctypes.POINTER(ScanTables),
            ctypes.POINTER(BsEngine), ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    except (OSError, AttributeError) as exc:
        raise RuntimeError(f"loading the native core {so} failed (build "
                           f"log: {so.with_suffix('.log')}): {exc}") from exc
    return lib


_offsets_struct = None


def coeff_ctx_offsets() -> CoeffCtxOffsets:
    global _offsets_struct
    if _offsets_struct is None:
        from ..cabac import contexts as cc
        _offsets_struct = CoeffCtxOffsets(
            cc.O_LAST_X, cc.O_LAST_Y, cc.O_SIG, cc.O_SIG_CG, cc.O_ONE,
            cc.O_ABS, cc.NUM_SIG_FLAG_CTX_LUMA)
    return _offsets_struct


_ctx_offsets = None
_scan_tables = None
_scan_keepalive = []


def ctx_offsets() -> CtxOffsets:
    global _ctx_offsets
    if _ctx_offsets is None:
        from ..cabac import contexts as cc
        _ctx_offsets = CtxOffsets(
            cc.O_SPLIT_FLAG, cc.O_SKIP_FLAG, cc.O_MERGE_FLAG, cc.O_MERGE_IDX,
            cc.O_PART_SIZE, cc.O_AMP, cc.O_PRED_MODE, cc.O_INTRA_PRED,
            cc.O_CHROMA_PRED, cc.O_INTER_DIR, cc.O_MVD, cc.O_REF_PIC,
            cc.O_DQP, cc.O_QT_CBF, cc.O_QT_ROOT_CBF, cc.O_SIG_CG, cc.O_SIG,
            cc.O_LAST_X, cc.O_LAST_Y, cc.O_ONE, cc.O_ABS, cc.O_MVP_IDX,
            cc.O_SAO_MERGE, cc.O_SAO_TYPE, cc.O_TRANS_SUBDIV, cc.O_TS_FLAG,
            cc.O_TQ_BYPASS, cc.NUM_SIG_FLAG_CTX_LUMA, cc.NUM_CTX)
    return _ctx_offsets


def scan_tables() -> ScanTables:
    """Coefficient + coefficient-group scan orders for the native parser
    (single source of truth: common/rom.py)."""
    global _scan_tables
    if _scan_tables is None:
        from ..common import rom
        st = ScanTables()
        for s in (1, 2, 3):   # HOR, VER, DIAG
            for lg in range(4):
                w = 4 << lg
                a = np.ascontiguousarray(rom.sig_last_scan(s, w), np.int32)
                b = np.ascontiguousarray(rom.cg_scan(s, w), np.int32)
                _scan_keepalive.extend((a, b))
                st.scan[s][lg] = a.ctypes.data
                st.cg[s][lg] = b.ctypes.data
        _scan_tables = st
    return _scan_tables
