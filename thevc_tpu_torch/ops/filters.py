"""In-loop filters in PyTorch: deblocking + SAO for a batch of pictures.

Counterpart of ``thevc_tpu/ops/jx_filters.py``: ``_luma_dir`` (:47),
``_chroma_dir`` (:156), ``_sao_plane`` (:205), ``_filter_core`` (:273),
``filter_picture`` (:309) and ``filter_pictures`` (:338).  Behavioral
reference: TComLoopFilter.cpp xPelFilterLuma / xPelFilterChroma and the
loopFilterPic ordering (all vertical edges, then all horizontal);
TComSampleAdaptiveOffset.cpp processSaoCuOrg.

Every array carries a leading picture axis [B, ...] where the JAX
package ``vmap``s one picture.  ``filter_pictures`` runs the
hand-written CUDA kernel (``ops.filters_kernel``, ``csrc/filters.cu``)
on a CUDA device and the plain form below, ``filter_pictures_plain``,
on the CPU.  All normative math is int32 with explicit shifts.  Every
edge on the 8-sample grid is independent within a direction (the filter
reaches 4 samples either side), so a direction is one tensor op over
[B, rows, edges, lines]; SAO reads only the deblocked samples, so it is
a per-sample gather and table lookup.
"""

from __future__ import annotations

import torch

from ..common.tables import from_reference
from . import filters_kernel
from .deblock import DEFAULT_INTRA_TC_OFFSET


def _clip3(lo: torch.Tensor, hi: torch.Tensor, v: torch.Tensor):
    return torch.minimum(hi, torch.maximum(lo, v))


def _luma_dir(plane, flags, bs, qp_p, qp_q, no_p, no_q,
              beta_offset, tc_offset, bit_depth):
    """One direction of luma deblocking (the vertical edges of ``plane``).

    plane: [B, H, W] int32, H % 4 == 0, W % 8 == 0.
    flags/bs/qp_p/qp_q/no_p/no_q: per 4x4 unit [B, H//4.., W//4..] (the
    edge on the LEFT of the unit).  Returns a new plane."""
    nb, h, w = plane.shape
    n_rows = h // 4
    n_edges = w // 8 - 1          # edges at x = 8, 16, ..., W-8
    if n_edges <= 0:
        return plane
    tab = from_reference(plane.device)
    scale = 1 << (bit_depth - 8)
    max_val = (1 << bit_depth) - 1

    ucols = 2 + 2 * torch.arange(n_edges, device=plane.device)

    def sel(a):                   # [B, n_rows, n_edges]
        return a[:, :n_rows][:, :, ucols]

    # same bitwise semantics as the reference: flags & (bs > 0)
    active = (sel(flags) & (sel(bs) > 0)) != 0
    b = sel(bs).to(torch.int32)
    qp = (sel(qp_p).to(torch.int32) + sel(qp_q).to(torch.int32) + 1) >> 1
    idx_tc = (qp + DEFAULT_INTRA_TC_OFFSET * (b - 1)
              + (tc_offset << 1)).clamp(0, 53)
    idx_b = (qp + (beta_offset << 1)).clamp(0, 51)
    tc = tab.tc[idx_tc.long()] * scale          # [B, n_rows, nE]
    beta = tab.beta[idx_b.long()] * scale
    side_thresh = (beta + (beta >> 1)) >> 3
    thr_cut = tc * 10
    no_pv = sel(no_p) != 0
    no_qv = sel(no_q) != 0

    # stripes [B, n_rows, 4 lines, nE, 8]: cols 8(j+1)-4 .. 8(j+1)+4
    mid = plane[:, :, 4:w - 4].reshape(nb, n_rows, 4, n_edges, 8)
    m = [mid[..., k].transpose(-1, -2) for k in range(8)]
    # m[k]: [B, n_rows, nE, 4 lines]

    dp0 = (m[1][..., 0] - 2 * m[2][..., 0] + m[3][..., 0]).abs()
    dq0 = (m[4][..., 0] - 2 * m[5][..., 0] + m[6][..., 0]).abs()
    dp3 = (m[1][..., 3] - 2 * m[2][..., 3] + m[3][..., 3]).abs()
    dq3 = (m[4][..., 3] - 2 * m[5][..., 3] + m[6][..., 3]).abs()
    d0 = dp0 + dq0
    d3 = dp3 + dq3
    d = d0 + d3

    do_filter = active & (d < beta)
    filter_p = (dp0 + dp3) < side_thresh
    filter_q = (dq0 + dq3) < side_thresh

    def strong_check(line, dd):
        ds = ((m[0][..., line] - m[3][..., line]).abs()
              + (m[7][..., line] - m[4][..., line]).abs())
        return ((ds < (beta >> 3)) & (2 * dd < (beta >> 2))
                & ((m[3][..., line] - m[4][..., line]).abs()
                   < ((tc * 5 + 1) >> 1)))

    sw = strong_check(0, d0) & strong_check(3, d3)

    tcv = tc[..., None]
    s_m3 = _clip3(m[3] - 2 * tcv, m[3] + 2 * tcv,
                  (m[1] + 2 * m[2] + 2 * m[3] + 2 * m[4] + m[5] + 4) >> 3)
    s_m4 = _clip3(m[4] - 2 * tcv, m[4] + 2 * tcv,
                  (m[2] + 2 * m[3] + 2 * m[4] + 2 * m[5] + m[6] + 4) >> 3)
    s_m2 = _clip3(m[2] - 2 * tcv, m[2] + 2 * tcv,
                  (m[1] + m[2] + m[3] + m[4] + 2) >> 2)
    s_m5 = _clip3(m[5] - 2 * tcv, m[5] + 2 * tcv,
                  (m[3] + m[4] + m[5] + m[6] + 2) >> 2)
    s_m1 = _clip3(m[1] - 2 * tcv, m[1] + 2 * tcv,
                  (2 * m[0] + 3 * m[1] + m[2] + m[3] + m[4] + 4) >> 3)
    s_m6 = _clip3(m[6] - 2 * tcv, m[6] + 2 * tcv,
                  (m[3] + m[4] + m[5] + 3 * m[6] + 2 * m[7] + 4) >> 3)

    delta = (9 * (m[4] - m[3]) - 3 * (m[5] - m[2]) + 8) >> 4
    weak_ok = delta.abs() < thr_cut[..., None]
    delta_c = _clip3(-tcv, tcv, delta)
    w_m3 = (m[3] + delta_c).clamp(0, max_val)
    w_m4 = (m[4] - delta_c).clamp(0, max_val)
    tc2 = (tc >> 1)[..., None]
    delta1 = _clip3(-tc2, tc2,
                    (((m[1] + m[3] + 1) >> 1) - m[2] + delta_c) >> 1)
    w_m2 = (m[2] + delta1).clamp(0, max_val)
    delta2 = _clip3(-tc2, tc2,
                    (((m[6] + m[4] + 1) >> 1) - m[5] - delta_c) >> 1)
    w_m5 = (m[5] + delta2).clamp(0, max_val)

    swv = (do_filter & sw)[..., None]
    wsel = (do_filter & ~sw)[..., None] & weak_ok
    fpv = filter_p[..., None]
    fqv = filter_q[..., None]
    npv = no_pv[..., None]
    nqv = no_qv[..., None]

    out = list(m)
    out[3] = torch.where(swv, s_m3, torch.where(wsel, w_m3, m[3]))
    out[4] = torch.where(swv, s_m4, torch.where(wsel, w_m4, m[4]))
    out[2] = torch.where(swv, s_m2, torch.where(wsel & fpv, w_m2, m[2]))
    out[5] = torch.where(swv, s_m5, torch.where(wsel & fqv, w_m5, m[5]))
    out[1] = torch.where(swv, s_m1, m[1])
    out[6] = torch.where(swv, s_m6, m[6])
    for k in (1, 2, 3):
        out[k] = torch.where(npv, m[k], out[k])
    for k in (4, 5, 6):
        out[k] = torch.where(nqv, m[k], out[k])

    new_mid = torch.stack(out, dim=-1)           # [B, n_rows, nE, 4, 8]
    new_mid = new_mid.transpose(2, 3).reshape(nb, h, w - 8)
    return torch.cat([plane[:, :, :4], new_mid, plane[:, :, w - 4:]], dim=2)


def _chroma_dir(cb, cr, flags, bs, qp_p, qp_q, no_p, no_q,
                tc_offset, bit_depth):
    """One direction of chroma deblocking (vertical edges, BS > 1 only,
    every 16 luma samples = every 8 chroma samples).  cb/cr: [B, h, w]
    int32; the unit maps are the luma ones.  Returns new planes."""
    nb, h, w = cb.shape
    n_rows = h // 2                                # 2 chroma lines per unit
    n_edges = (w - 2) // 8                         # edges at xc = 8, 16, ...
    if n_edges <= 0:
        return cb, cr
    dev = cb.device
    tab = from_reference(dev)
    scale = 1 << (bit_depth - 8)
    max_val = (1 << bit_depth) - 1

    ucols = 4 + 4 * torch.arange(n_edges, device=dev)

    def sel(a):
        return a[:, :n_rows][:, :, ucols]

    active = (sel(flags) & (sel(bs) > 1)) != 0
    qp_avg = (sel(qp_p).to(torch.int32) + sel(qp_q).to(torch.int32)
              + 1) >> 1
    qp = tab.chroma_scale[qp_avg.clamp(0, 51).long()]
    b = sel(bs).to(torch.int32)
    idx_tc = (qp + DEFAULT_INTRA_TC_OFFSET * (b - 1)
              + (tc_offset << 1)).clamp(0, 53)
    tc = (tab.tc[idx_tc.long()] * scale)[..., None]
    npv = (sel(no_p) != 0)[..., None]
    nqv = (sel(no_q) != 0)[..., None]
    activev = active[..., None]

    # stripes: cols 8(j+1)-2 .. 8(j+1)+2
    cols = (8 * (torch.arange(n_edges, device=dev) + 1))[:, None] \
        + torch.arange(-2, 2, device=dev)[None]

    def one(plane):
        stripes = plane[:, :, cols]                # [B, h, nE, 4]
        stripes = stripes.reshape(nb, n_rows, 2, n_edges, 4)
        m2, m3, m4, m5 = (stripes[..., k].transpose(-1, -2)
                          for k in range(4))       # [B, n_rows, nE, 2]
        delta = _clip3(-tc, tc, ((((m4 - m3) << 2) + m2 - m5 + 4) >> 3))
        o3 = (m3 + delta).clamp(0, max_val)
        o4 = (m4 - delta).clamp(0, max_val)
        o3 = torch.where(activev & ~npv, o3, m3)
        o4 = torch.where(activev & ~nqv, o4, m4)
        new = torch.stack([m2, o3, o4, m5], dim=-1)  # [B, n_rows, nE, 2, 4]
        new = new.transpose(2, 3).reshape(nb, h, n_edges, 4)
        # the reference's functional .at[].set: indexed assignment on a
        # clone, so the input plane is left as it was
        res = plane.clone()
        res[:, :, cols] = new
        return res

    return one(cb), one(cr)


# m_iOffsetEo: edge class et 0..4 -> offset slot (et 2 takes no offset)
_EO_SLOT = (0, 1, -1, 2, 3)
# EO neighbour pairs (dy, dx) per class: horizontal, vertical, 135, 45 deg
_EO_NEIGH = {0: ((0, -1), (0, 1)), 1: ((-1, 0), (1, 0)),
             2: ((-1, -1), (1, 1)), 3: ((1, -1), (-1, 1))}


def _sao_plane(src, sao_type, band_pos, offsets,
               ctu_size, ctus_w, ctus_h, bit_depth):
    """SAO for one plane of each picture.

    src: [B, H, W] int32 (deblocked); sao_type: [B, nctu] (-1 off, 0-3 EO
    class, 4 BO); band_pos: [B, nctu]; offsets: [B, nctu, 4] (already
    << saoBitIncrease).  Each sample finds its CTU's parameters by a
    gather on its CTU index."""
    nb, h, w = src.shape
    dev = src.device
    max_val = (1 << bit_depth) - 1
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    ctu = ((yy // ctu_size) * ctus_w + xx // ctu_size).reshape(1, -1)
    ctu = ctu.expand(nb, -1)                       # [B, H*W]

    def per_sample(v):                             # [B, nctu] -> [B, H, W]
        return torch.gather(v.to(torch.int32), 1, ctu).reshape(nb, h, w)

    t_px = per_sample(sao_type)
    bp_px = per_sample(band_pos)
    off_flat = offsets.to(torch.int32).reshape(nb, -1)   # [B, nctu*4]

    def offset_at(slot):                           # slot [B, H, W] in 0..3
        idx = ctu * 4 + slot.reshape(nb, -1).long()
        return torch.gather(off_flat, 1, idx).reshape(nb, h, w)

    pad = torch.nn.functional.pad(src, (1, 1, 1, 1))   # pads masked out

    def shifted(dy, dx):
        return pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    slot_of = torch.tensor(_EO_SLOT, dtype=torch.int64, device=dev)
    x_in = (xx > 0) & (xx < w - 1)
    y_in = (yy > 0) & (yy < h - 1)
    out = src
    for c, ((d1y, d1x), (d2y, d2x)) in _EO_NEIGH.items():
        et = (torch.sign(src - shifted(d1y, d1x))
              + torch.sign(src - shifted(d2y, d2x)) + 2).long()
        slot = slot_of[et]
        off = torch.where(slot >= 0, offset_at(slot.clamp(min=0)),
                          torch.zeros_like(src))
        # picture-boundary exclusions (processSaoCuOrg)
        mask = t_px == c
        if c in (0, 2, 3):
            mask = mask & x_in
        if c in (1, 2, 3):
            mask = mask & y_in
        out = torch.where(mask, (src + off).clamp(0, max_val), out)
    # BO: band 1 + (v >> (bd - 5)) takes offsets[i] iff
    # (band - 1 - band_pos) mod 32 == i for some i < 4
    idx = ((src >> (bit_depth - 5)) - bp_px) & 31
    off_bo = torch.where(idx < 4, offset_at(idx.clamp(max=3)),
                         torch.zeros_like(src))
    return torch.where(t_px == 4, (src + off_bo).clamp(0, max_val), out)


def _filter_core(rec_y, rec_cb, rec_cr, dbk_ver, dbk_hor,
                 sao_types, sao_band_pos, sao_offsets,
                 beta_offset, tc_offset, bit_depth,
                 ctu_size, ctus_w, ctus_h,
                 do_deblock, do_sao, do_sao_chroma):
    """Deblock VER + HOR + SAO, all planes, int32 math, for [B] pictures."""
    y = rec_y.to(torch.int32)
    cb = rec_cb.to(torch.int32)
    cr = rec_cr.to(torch.int32)
    if do_deblock:
        fl, bs, qpp, qpq, nop, noq = dbk_ver
        y = _luma_dir(y, fl, bs, qpp, qpq, nop, noq,
                      beta_offset, tc_offset, bit_depth)
        cb, cr = _chroma_dir(cb, cr, fl, bs, qpp, qpq, nop, noq,
                             tc_offset, bit_depth)
        fl, bs, qpp, qpq, nop, noq = (a.transpose(1, 2) for a in dbk_hor)
        y = _luma_dir(y.transpose(1, 2), fl, bs, qpp, qpq, nop, noq,
                      beta_offset, tc_offset, bit_depth).transpose(1, 2)
        cbt, crt = _chroma_dir(cb.transpose(1, 2), cr.transpose(1, 2),
                               fl, bs, qpp, qpq, nop, noq,
                               tc_offset, bit_depth)
        cb, cr = cbt.transpose(1, 2), crt.transpose(1, 2)
    if do_sao:
        y = _sao_plane(y, sao_types[:, 0], sao_band_pos[:, 0],
                       sao_offsets[:, 0], ctu_size, ctus_w, ctus_h,
                       bit_depth)
        if do_sao_chroma:
            cb = _sao_plane(cb, sao_types[:, 1], sao_band_pos[:, 1],
                            sao_offsets[:, 1], ctu_size // 2, ctus_w,
                            ctus_h, bit_depth)
            cr = _sao_plane(cr, sao_types[:, 2], sao_band_pos[:, 2],
                            sao_offsets[:, 2], ctu_size // 2, ctus_w,
                            ctus_h, bit_depth)
    return y, cb, cr


def filter_pictures_plain(rec_y, rec_cb, rec_cr, dbk_ver, dbk_hor,
                          sao_types, sao_band_pos, sao_offsets,
                          beta_offset=0, tc_offset=0, bit_depth=8,
                          ctu_size=64, ctus_w=1, ctus_h=1,
                          do_deblock=True, do_sao=False, do_sao_chroma=False,
                          out_u8=False):
    """The in-loop filter stage for a batch of pictures, in plain torch
    ops on any device (the kernel's yardstick).

    Every array has a leading [B] picture axis.  dbk_ver/dbk_hor: tuples
    (flags u8, bs u8, qp_p, qp_q, no_p u8, no_q u8) per 4x4 unit, one per
    direction; sao_types/sao_band_pos: [B, 3, nctu]; sao_offsets:
    [B, 3, nctu, 4] (pre-shifted).  Returns the filtered (y, cb, cr) as
    int16, or uint8 with ``out_u8`` (lossless for 8-bit streams)."""
    y, cb, cr = _filter_core(rec_y, rec_cb, rec_cr, dbk_ver, dbk_hor,
                             sao_types, sao_band_pos, sao_offsets,
                             beta_offset, tc_offset, bit_depth,
                             ctu_size, ctus_w, ctus_h,
                             do_deblock, do_sao, do_sao_chroma)
    dt = torch.uint8 if out_u8 else torch.int16
    return y.to(dt), cb.to(dt), cr.to(dt)


def filter_pictures(rec_y, rec_cb, rec_cr, dbk_ver, dbk_hor,
                    sao_types, sao_band_pos, sao_offsets, **statics):
    """The in-loop filter stage for a batch of pictures
    (``filter_pictures_plain``'s arguments and result).  On a CUDA device
    this is the hand-written kernel, one launch, and raises if it cannot
    build or launch; on the CPU the plain form."""
    kind = rec_y.device.type
    if kind == "cpu":
        return filter_pictures_plain(rec_y, rec_cb, rec_cr, dbk_ver,
                                     dbk_hor, sao_types, sao_band_pos,
                                     sao_offsets, **statics)
    if kind != "cuda":
        raise ValueError(f"unsupported device {rec_y.device}")
    return filters_kernel.filter_pictures(rec_y, rec_cb, rec_cr, dbk_ver,
                                          dbk_hor, sao_types, sao_band_pos,
                                          sao_offsets, **statics)


def filter_picture(rec_y, rec_cb, rec_cr, dbk_ver, dbk_hor,
                   sao_types, sao_band_pos, sao_offsets, **statics):
    """``filter_pictures`` for one picture (no picture axis); int16 out."""
    y, cb, cr = filter_pictures(
        rec_y[None], rec_cb[None], rec_cr[None],
        tuple(a[None] for a in dbk_ver), tuple(a[None] for a in dbk_hor),
        sao_types[None], sao_band_pos[None], sao_offsets[None], **statics)
    return y[0], cb[0], cr[0]
