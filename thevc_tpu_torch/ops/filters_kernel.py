"""Binding of the hand-written CUDA in-loop filter kernel
(``csrc/filters.cu``).

Replaces the XLA function ``thevc_tpu/ops/jx_filters.py:_filter_core``
(:273; entries ``filter_picture`` :312 and ``filter_pictures`` :342):
deblocking of every vertical then every horizontal edge, then SAO, for a
batch of pictures and all three planes, in one launch a call.  The kernel
is bound by bytes: a CTA keeps one tile's window (the tile and 4 samples
each side) in shared memory through both edge directions and SAO, so each
plane is read once and written once and nothing else is allocated but the
three outputs.  The design notes are in the source's header comment.  Its
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
# thevc_filter(pointers, nb, h, w, uh, uw, src_u8, dst_u8, beta_offset,
# tc_offset, bd, ctu_size, ctus_w, ctus_h, deblock, sao_luma, sao_chroma,
# stream)
_ENTRIES = {"thevc_filter": [_P] + [_I] * 16 + [_P]}
PLANE_DTYPES = (torch.uint8, torch.int16)
# the six per-unit maps of one direction, as ``decoder/filters.py``
# builds them (``_shrink``: the QPs as int8)
MAP_NAMES = ("flags", "bs", "qp_p", "qp_q", "no_p", "no_q")
MAP_DTYPES = (torch.uint8, torch.uint8, torch.int8, torch.int8, torch.uint8,
              torch.uint8)

# kernel launches made by filter_pictures(), one a call; a plain integer
# that a run resets and reads to show that its main path went through the
# kernel
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


def filter_pictures(rec_y, rec_cb, rec_cr, dbk_ver, dbk_hor, sao_types,
                    sao_band_pos, sao_offsets, beta_offset=0, tc_offset=0,
                    bit_depth=8, ctu_size=64, ctus_w=1, ctus_h=1,
                    do_deblock=True, do_sao=False, do_sao_chroma=False,
                    out_u8=False) -> tuple:
    """``ops.filters.filter_pictures`` on a CUDA device: the same
    arguments (checked by ``check_inputs``), the same (y, cb, cr) out,
    uint8 with ``out_u8``, else int16.  One launch on the current stream,
    without synchronising, that allocates nothing but the outputs (with
    both filters off, a converting copy); raises on any input the kernel
    does not take and on a launch error."""
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
    tensors = [rec_y, rec_cb, rec_cr, *out, *dbk_ver, *dbk_hor, sao_types,
               sao_band_pos, sao_offsets]
    ptrs = [t.data_ptr() for t in tensors]
    if do_deblock:
        tab = from_reference(device)
        ptrs += [tab.tc.data_ptr(), tab.beta.data_ptr(),
                 tab.chroma_scale.data_ptr()]
    else:
        ptrs += [None] * 3
    lib = build()
    with torch.cuda.device(device):
        rc = lib.thevc_filter(
            (ctypes.c_void_p * len(ptrs))(*ptrs), nb, h, w, uh, uw,
            int(rec_y.dtype == torch.uint8), int(out_u8), int(beta_offset),
            int(tc_offset), int(bit_depth), int(ctu_size), int(ctus_w),
            int(ctus_h), int(do_deblock), int(do_sao),
            int(do_sao and do_sao_chroma), _build.stream_of(device))
    _build.check(lib, rc, "filter kernel launch")
    launches += 1
    return out
