"""Sample Adaptive Offset — functional, frame-level, vectorized.

Behavioral reference: TComSampleAdaptiveOffset.cpp — processSaoCuOrg (:781,
per-CTU EO/BO kernels with picture-boundary exclusions), processSaoUnitAll
(:1072, offset table construction: EO mapping m_auiEoTable [1,2,0,3,4],
BO band table 1+(v>>(bd-5)), offsets << saoBitIncrease), SAOProcess (:1005).

HM's line-buffer dance (m_pTmpL1/U1) exists to guarantee every neighbor
comparison uses PRE-SAO samples; expressed functionally that is simply
out = sao(src) with all reads from an immutable src — which is exactly the
batched, data-parallel form the TPU wants (one gather + compare + table
lookup over the whole plane).
"""

from __future__ import annotations

import numpy as np

SAO_EO_0 = 0
SAO_EO_1 = 1
SAO_EO_2 = 2
SAO_EO_3 = 3
SAO_BO = 4

# neighbor offsets (dy, dx) per EO class: (n1, n2)
_EO_NEIGHBORS = {
    SAO_EO_0: ((0, -1), (0, 1)),
    SAO_EO_1: ((-1, 0), (1, 0)),
    SAO_EO_2: ((-1, -1), (1, 1)),
    SAO_EO_3: ((1, -1), (-1, 1)),
}


def _sign(x: np.ndarray) -> np.ndarray:
    return np.sign(x).astype(np.int32)


def apply_sao_plane(src: np.ndarray, ctu_size: int, sao_type: np.ndarray,
                    sao_sub_type: np.ndarray, sao_offsets: np.ndarray,
                    ctus_w: int, ctus_h: int, bit_depth: int) -> np.ndarray:
    """Whole-plane vectorized SAO (same formulation as the device kernel
    ops/jx_filters._sao_plane: per-CTU params expanded per pixel, offsets
    via arithmetic selects).  When the native library is available the
    per-CTU AVX2 kernel (codec_core.cpp:sao_apply_plane) runs instead —
    it skips type==-1 CTUs entirely, which the whole-plane numpy form
    cannot.  The per-CTU loop form below is kept as the behavioral
    reference (`apply_sao_plane_ref`)."""
    if src.dtype == np.int16 and src.flags.c_contiguous:
        try:
            from .. import native
            lib = native.get_lib()
        except Exception:
            lib = None
        if lib is not None:
            import ctypes
            h, w = src.shape
            dst = np.empty_like(src)
            t = np.ascontiguousarray(sao_type, np.int32)
            st = np.ascontiguousarray(sao_sub_type, np.int32)
            offs = np.ascontiguousarray(sao_offsets, np.int32)
            lib.sao_apply_plane(
                src.ctypes.data, dst.ctypes.data, ctypes.c_int64(w),
                h, w, ctu_size, t.ctypes.data, st.ctypes.data,
                offs.ctypes.data, ctus_w, ctus_h, bit_depth)
            return dst
    h, w = src.shape
    max_val = (1 << bit_depth) - 1
    sao_shift = bit_depth - min(bit_depth, 10)
    s = src.astype(np.int32)

    def expand(v):
        g = np.asarray(v, np.int32).reshape(ctus_h, ctus_w)
        return g.repeat(ctu_size, 0)[:h].repeat(ctu_size, 1)[:, :w]

    t_px = expand(sao_type)
    bp_px = expand(sao_sub_type)
    offs = np.asarray(sao_offsets, np.int32) << sao_shift
    off_px = [expand(offs[:, i]) for i in range(4)]

    pad = np.pad(s, 1)
    out = s.copy()
    yy = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    for c, ((d1y, d1x), (d2y, d2x)) in _EO_NEIGHBORS.items():
        sel = t_px == c
        if not sel.any():
            continue
        n1 = pad[1 + d1y:1 + d1y + h, 1 + d1x:1 + d1x + w]
        n2 = pad[1 + d2y:1 + d2y + h, 1 + d2x:1 + d2x + w]
        et = np.sign(s - n1).astype(np.int32) + np.sign(s - n2) + 2
        off = np.zeros_like(s)
        for et_val, oi in ((0, 0), (1, 1), (3, 2), (4, 3)):
            m = et == et_val
            off[m] = off_px[oi][m]
        mask = sel
        if c in (SAO_EO_0, SAO_EO_2, SAO_EO_3):
            mask = mask & (xx > 0) & (xx < w - 1)
        if c in (SAO_EO_1, SAO_EO_2, SAO_EO_3):
            mask = mask & (yy > 0) & (yy < h - 1)
        out[mask] = np.clip(s[mask] + off[mask], 0, max_val)
    bo = t_px == SAO_BO
    if bo.any():
        band = 1 + (s >> (bit_depth - 5))
        idx = (band - 1 - bp_px) & 31
        off = np.zeros_like(s)
        for i in range(4):
            m = bo & (idx == i)
            off[m] = off_px[i][m]
        out[bo] = np.clip(s[bo] + off[bo], 0, max_val)
    return out.astype(src.dtype)


def apply_sao_plane_ref(src: np.ndarray, ctu_size: int, sao_type: np.ndarray,
                        sao_sub_type: np.ndarray, sao_offsets: np.ndarray,
                        ctus_w: int, ctus_h: int, bit_depth: int) -> np.ndarray:
    """Apply SAO to one plane.

    src: deblocked plane (H, W) — never modified; sao_type[ctu] in -1..4
    (after EO subtype folding the parser stores 0..3 EO class directly in
    sao_type for EO, 4 for BO); sao_offsets[ctu, 4]; sao_sub_type[ctu] =
    band position for BO.
    """
    h, w = src.shape
    out = src.copy()
    max_val = (1 << bit_depth) - 1
    sao_shift = bit_depth - min(bit_depth, 10)  # 0 for <=10 bit

    s = src.astype(np.int32)
    for ctu in range(ctus_w * ctus_h):
        t = int(sao_type[ctu])
        if t < 0:
            continue
        cx = (ctu % ctus_w) * ctu_size
        cy = (ctu // ctus_w) * ctu_size
        x1 = min(cx + ctu_size, w)
        y1 = min(cy + ctu_size, h)
        offs = (sao_offsets[ctu].astype(np.int32)) << sao_shift
        if t == SAO_BO:
            band_pos = int(sao_sub_type[ctu])
            table = np.zeros(33, np.int32)
            for i in range(4):
                table[(band_pos + i) % 32 + 1] = offs[i]
            blk = s[cy:y1, cx:x1]
            band = 1 + (blk >> (bit_depth - 5))
            out[cy:y1, cx:x1] = np.clip(blk + table[band], 0, max_val)
        else:
            (d1y, d1x), (d2y, d2x) = _EO_NEIGHBORS[t]
            # picture-boundary exclusions (processSaoCuOrg)
            sx, ex, sy, ey = cx, x1, cy, y1
            if t in (SAO_EO_0, SAO_EO_2, SAO_EO_3):
                if cx == 0:
                    sx = cx + 1
                if x1 == w:
                    ex = x1 - 1
            if t in (SAO_EO_1, SAO_EO_2, SAO_EO_3):
                if cy == 0:
                    sy = cy + 1
                if y1 == h:
                    ey = y1 - 1
            if sx >= ex or sy >= ey:
                continue
            blk = s[sy:ey, sx:ex]
            n1 = s[sy + d1y:ey + d1y, sx + d1x:ex + d1x]
            n2 = s[sy + d2y:ey + d2y, sx + d2x:ex + d2x]
            edge_type = _sign(blk - n1) + _sign(blk - n2) + 2
            # m_iOffsetEo: et0->off[0], et1->off[1], et2->0, et3->off[2], et4->off[3]
            eo = np.array([offs[0], offs[1], 0, offs[2], offs[3]], np.int32)
            out[sy:ey, sx:ex] = np.clip(blk + eo[edge_type], 0, max_val)
    return out
