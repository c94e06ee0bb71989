"""Binding of the hand-written CUDA in-loop filter kernel
(``csrc/filters.cu``).

Replaces the XLA function ``thevc_tpu/ops/jx_filters.py:_filter_core``
(:273; entries ``filter_picture`` :312 and ``filter_pictures`` :342):
deblocking of every vertical then every horizontal edge, then SAO, for a
batch of pictures and all three planes, in at most three launches a call
(vertical edges, horizontal edges, SAO).  The design notes and what
bounds the kernel on the card are in the source's header comment.  Its
plain PyTorch version is ``ops.filters.filter_pictures_plain``.

The kernel is compiled with ``nvcc`` on first use and bound with
``ctypes`` (``ops.build``).  Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes

import torch

from ..common.tables import from_reference
from . import build as _build

NAME = "filters"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {"thevc_deblock": [_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _P],
            "thevc_sao": [_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _P]}
PLANE_DTYPES = (torch.uint8, torch.int16)
# the six per-unit maps of one direction, as ``decoder/filters.py``
# builds them (``_shrink``: the QPs as int8)
MAP_NAMES = ("flags", "bs", "qp_p", "qp_q", "no_p", "no_q")
MAP_DTYPES = (torch.uint8, torch.uint8, torch.int8, torch.int8, torch.uint8,
              torch.uint8)

# kernel launches made by filter_pictures(), one a launch (at most three a
# call); a plain integer that a run resets and reads to show that its main
# path went through the kernel
launches = 0


def build() -> ctypes.CDLL:
    """Compile (if not built yet) and load the kernel library."""
    return _build.load(NAME, _ENTRIES)


def _check(t: torch.Tensor, name: str, dtypes: tuple, shape: tuple,
           device: torch.device) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")
    _build.check_tensor(t, name, t.dtype, shape, device)


def check_inputs(rec_y, rec_cb, rec_cr, dbk_ver, dbk_hor, sao_types,
                 sao_band_pos, sao_offsets, bit_depth, ctu_size, ctus_w,
                 ctus_h) -> tuple:
    """Raise on any input the kernel does not take: the planes uint8 or
    int16 (one dtype), luma [B, H, W] with H and W multiples of 8 and
    chroma [B, H/2, W/2]; each direction's six maps (``MAP_DTYPES``)
    [B, uh, uw] with uh >= H/4 and uw >= W/4, both directions alike; the
    SAO types int8 and band positions int32 [B, 3, nctu], the offsets int32
    [B, 3, nctu, 4], nctu = ctus_w * ctus_h and the CTU grid covering the
    picture; every tensor contiguous and on the luma plane's device.  The
    device's type is not checked here.  Returns (B, H, W, uh, uw)."""
    if rec_y.dim() != 3:
        raise ValueError(f"luma plane must be [B, H, W], got "
                         f"{tuple(rec_y.shape)}")
    nb, h, w = (int(s) for s in rec_y.shape)
    if nb < 1 or h < 8 or w < 8 or h % 8 or w % 8:
        raise ValueError(f"luma plane {h}x{w} x {nb}: H and W must be "
                         "positive multiples of 8")
    device = rec_y.device
    _check(rec_y, "luma plane", PLANE_DTYPES, (nb, h, w), device)
    for t, name in ((rec_cb, "Cb plane"), (rec_cr, "Cr plane")):
        _check(t, name, (rec_y.dtype,), (nb, h // 2, w // 2), device)
    if not 8 <= bit_depth <= 12:
        raise ValueError(f"bit depth {bit_depth} out of range 8..12")
    if len(dbk_ver) != 6 or len(dbk_hor) != 6:
        raise ValueError("each direction takes six maps "
                         f"{MAP_NAMES}")
    if dbk_ver[0].dim() != 3:
        raise ValueError(f"maps must be [B, uh, uw], got "
                         f"{tuple(dbk_ver[0].shape)}")
    uh, uw = (int(s) for s in dbk_ver[0].shape[1:])
    if uh < h // 4 or uw < w // 4:
        raise ValueError(f"maps of {uh}x{uw} units do not cover a "
                         f"{h}x{w} picture")
    for maps, d in ((dbk_ver, "vertical"), (dbk_hor, "horizontal")):
        for t, name, dt in zip(maps, MAP_NAMES, MAP_DTYPES):
            _check(t, f"{d} {name}", (dt,), (nb, uh, uw), device)
    if ctu_size < 16 or ctu_size % 2 or ctus_w < 1 or ctus_h < 1 \
            or ctus_w * ctu_size < w or ctus_h * ctu_size < h:
        raise ValueError(f"CTU grid {ctus_w}x{ctus_h} of {ctu_size} does "
                         f"not cover a {h}x{w} picture")
    nctu = ctus_w * ctus_h
    _check(sao_types, "SAO types", (torch.int8,), (nb, 3, nctu), device)
    _check(sao_band_pos, "SAO band positions", (torch.int32,), (nb, 3, nctu),
           device)
    _check(sao_offsets, "SAO offsets", (torch.int32,), (nb, 3, nctu, 4),
           device)
    return nb, h, w, uh, uw


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def filter_pictures(rec_y, rec_cb, rec_cr, dbk_ver, dbk_hor, sao_types,
                    sao_band_pos, sao_offsets, beta_offset=0, tc_offset=0,
                    bit_depth=8, ctu_size=64, ctus_w=1, ctus_h=1,
                    do_deblock=True, do_sao=False, do_sao_chroma=False,
                    out_u8=False) -> tuple:
    """``ops.filters.filter_pictures`` on a CUDA device: the same
    arguments (checked by ``check_inputs``), the same (y, cb, cr) out,
    uint8 with ``out_u8``, else int16.  Launches on the current stream
    without synchronising: vertical edges into an int16 working copy,
    horizontal edges in place (into the output when SAO is off), SAO into
    the output (a converting copy with both filters off); raises on any
    input the kernel does not take and on a launch error."""
    global launches
    nb, h, w, uh, uw = check_inputs(
        rec_y, rec_cb, rec_cr, dbk_ver, dbk_hor, sao_types, sao_band_pos,
        sao_offsets, bit_depth, ctu_size, ctus_w, ctus_h)
    device = rec_y.device
    if device.type != "cuda":
        raise ValueError(f"the filter kernel takes CUDA tensors, got {device}")
    dt = torch.uint8 if out_u8 else torch.int16
    shapes = ((nb, h, w), (nb, h // 2, w // 2), (nb, h // 2, w // 2))
    out = tuple(torch.empty(s, dtype=dt, device=device) for s in shapes)
    src = (rec_y, rec_cb, rec_cr)
    src_u8, out_u8 = int(rec_y.dtype == torch.uint8), int(out_u8)
    lib = build()
    stream = _build.stream_of(device)
    with torch.cuda.device(device):
        if do_deblock:
            tab = from_reference(device)
            tables = _ptrs((tab.tc, tab.beta, tab.chroma_scale))
            work = tuple(torch.empty(s, dtype=torch.int16, device=device)
                         for s in shapes)
            # vertical edges into the working copy, then horizontal edges
            # in place, or into the output when SAO is off
            last = (work, 0) if do_sao else (out, out_u8)
            for d, (maps, s, s_u8, dst, d_u8) in enumerate((
                    (dbk_ver, src, src_u8, work, 0),
                    (dbk_hor, work, 0, *last))):
                rc = lib.thevc_deblock(
                    _ptrs(s), _ptrs(dst), s_u8, d_u8, _ptrs(maps), tables,
                    nb, h, w, uh, uw, d, int(beta_offset), int(tc_offset),
                    int(bit_depth), stream)
                _build.check(lib, rc, "deblocking kernel launch")
                launches += 1
            src, src_u8 = work, 0
        if do_sao or not do_deblock:
            rc = lib.thevc_sao(
                _ptrs(src), _ptrs(out), src_u8, out_u8, sao_types.data_ptr(),
                sao_band_pos.data_ptr(), sao_offsets.data_ptr(), nb, h, w,
                ctus_w * ctus_h, int(ctu_size), int(ctus_w), int(do_sao),
                int(do_sao and do_sao_chroma), int(bit_depth), stream)
            _build.check(lib, rc, "SAO kernel launch")
            launches += 1
    return out
