"""In-loop filter driver for the port: host-built edge maps and SAO
tables, pixel math on the device.

The device half of ``thevc_tpu/decoder/filters.py``:
``filter_picture_device`` (:283) and ``filter_pictures_device`` (:310).
The one-picture form also hands back the filtered planes on the device,
where inter pictures read them as references.
The host inputs come from ``_picture_filter_inputs`` (:230), which
builds them with numpy and the native core.  It and the rest of that
module's host half (the edge maps, ``deblock_frame`` and ``sao_frame``,
which the encoder runs) are copied here unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import deblock as dbk
from ..ops import filters as ops_filters
from ..ops import sao as sao_ops
from ..ops.device import stage, stat_d2h, stat_h2d, stat_launch
from ..params import Pps, SliceHeader, Sps
from .frame import (MODE_INTRA, SIZE_2NxN, SIZE_2NxnD, SIZE_2NxnU, SIZE_NxN,
                    SIZE_Nx2N, SIZE_nLx2N, SIZE_nRx2N, FrameModel)

# -- the host half of thevc_tpu/decoder/filters.py (:20-280, :366-383),
# unchanged


def _edge_maps(f: FrameModel, sh: SliceHeader, direction: int,
               ref_poc=None):
    """Edge flags / BS / per-side QP and no-filter maps for one direction.

    direction 0 = VER (edge left of unit), 1 = HOR (edge above unit).
    """
    uh, uw = f.depth.shape
    # clip to units covering the picture
    pic_uw = (f.width + 3) // 4
    pic_uh = (f.height + 3) // 4

    depth = f.depth.astype(np.int32)
    cu_units = f.units_per_row >> depth
    tr = f.tr_idx.astype(np.int32)
    tu_units = np.maximum(cu_units >> tr, 1)

    uy, ux = np.mgrid[0:uh, 0:uw]
    coord = ux if direction == 0 else uy

    tu_edge = (coord % tu_units) == 0
    cu_edge = (coord % cu_units) == 0
    # PU internal edges (xSetEdgefilterPU): offsets per partition type
    ps = f.part_size_arr
    lc = coord % cu_units
    half, quarter = cu_units >> 1, cu_units >> 2
    threeq = half + quarter
    if direction == 0:
        pu_edge = ((((ps == SIZE_Nx2N) | (ps == SIZE_NxN)) & (lc == half)) |
                   ((ps == SIZE_nLx2N) & (lc == quarter)) |
                   ((ps == SIZE_nRx2N) & (lc == threeq)))
    else:
        pu_edge = ((((ps == SIZE_2NxN) | (ps == SIZE_NxN)) & (lc == half)) |
                   ((ps == SIZE_2NxnU) & (lc == quarter)) |
                   ((ps == SIZE_2NxnD) & (lc == threeq)))

    flags = tu_edge | cu_edge | pu_edge
    # picture boundary
    flags &= coord > 0
    # outside-picture units never filtered
    flags &= (ux < pic_uw) & (uy < pic_uh)

    # CU-boundary edges: slice/tile restriction on the P side
    if direction == 0:
        p_ux, p_uy = np.maximum(ux - 1, 0), uy
    else:
        p_ux, p_uy = ux, np.maximum(uy - 1, 0)

    if not sh.lf_cross_slice_boundary_flag:
        diff_slice = f.slice_idx[p_uy, p_ux] != f.slice_idx[uy, ux]
        flags &= ~(cu_edge & diff_slice)
    if not f.pps.lf_cross_tile_boundary_flag:
        diff_tile = f.tile_idx[p_uy, p_ux] != f.tile_idx[uy, ux]
        flags &= ~(cu_edge & diff_tile)

    # boundary strength (xGetBoundaryStrengthSingle)
    p_intra = f.pred_mode[p_uy, p_ux] == MODE_INTRA
    q_intra = f.pred_mode == MODE_INTRA
    bs = np.where(flags & (p_intra | q_intra), 2, 0).astype(np.uint8)

    inter_edge = flags & ~p_intra & ~q_intra
    if inter_edge.any() and ref_poc is not None:
        # BS=1 from luma cbf applies only on TU/CU boundaries: m_aapucBS is
        # pre-seeded in xSetEdgefilterMultiple only at edge offset 0 — PU
        # internal edges (e.g. the Nx2N half edge) get the motion compare
        # only.
        cbf_q = ((f.cbf[0].astype(np.int32) >> tr) & 1).astype(bool)
        cbf_p = cbf_q[p_uy, p_ux]
        bs_cbf = inter_edge & tu_edge & (cbf_p | cbf_q)
        bs[bs_cbf] = 1

        # motion compare on the rest.  For HOR edges crossing the CTU top
        # boundary the P-side motion is read through the motion-compression
        # map (getPUAbove with MotionDataCompresssion=true: g_motionRefer
        # keeps the above CTU's last part row decimated 2:1 in x — x1 reads
        # x0, x2 reads x3).
        mv_p_ux, mv_p_uy = p_ux, p_uy
        if direction == 1 and (f.ctu_size >> (f.max_depth - 1)) == 8:
            upr = f.units_per_row
            cross = (uy % upr) == 0
            xm = p_ux & 3
            mv_p_ux = np.where(cross & (xm == 1), p_ux - 1,
                               np.where(cross & (xm == 2), p_ux + 1, p_ux))

        # per-unit reference POCs (resolved per slice by the caller, since
        # reference lists are per-slice in the reference)
        rq = [ref_poc[l] for l in range(2)]
        rp = [r[mv_p_uy, mv_p_ux] for r in rq]
        mq = [f.mv[l].astype(np.int64) for l in range(2)]
        mp = [m[mv_p_uy, mv_p_ux] for m in mq]

        def mvdiff_ge4(a, b):
            d = np.abs(a - b)
            return (d[..., 0] >= 4) | (d[..., 1] >= 4)

        rest = inter_edge & ~bs_cbf
        if sh.slice_type == 0:  # B slice
            same = (rp[0] == rq[0]) & (rp[1] == rq[1])
            cross_r = (rp[0] == rq[1]) & (rp[1] == rq[0])
            bs_mv = np.ones_like(bs, bool)       # "all different" => 1
            p_two = rp[0] != rp[1]
            straight = mvdiff_ge4(mp[0], mq[0]) | mvdiff_ge4(mp[1], mq[1])
            crossed = mvdiff_ge4(mp[0], mq[1]) | mvdiff_ge4(mp[1], mq[0])
            # different L0/L1 refs: pick ordering matching the refs
            diff_two = np.where(rp[0] == rq[0], straight, crossed)
            same_two = crossed & straight       # same L0 & L1 ref picture
            matched = same | cross_r
            bs_mv = np.where(matched,
                             np.where(p_two, diff_two, same_two), True)
        else:  # P slice
            bs_mv = (rp[0] != rq[0]) | mvdiff_ge4(mp[0], mq[0])
        bs[rest & bs_mv] = 1

    qp_q = f.qp.astype(np.int32)
    qp_p = f.qp[p_uy, p_ux].astype(np.int32)

    pcm_nofilter = f.sps_pcm_nofilter if hasattr(f, "sps_pcm_nofilter") else False
    no_q = f.tq_bypass.copy()
    no_p = f.tq_bypass[p_uy, p_ux].copy()
    if pcm_nofilter:
        no_q |= f.ipcm
        no_p |= f.ipcm[p_uy, p_ux]
    return flags, bs, qp_p, qp_q, no_p, no_q


def ref_poc_from_lists(f: FrameModel, ref_pocs) -> np.ndarray:
    """Per-unit [2, uh, uw] reference-POC map from single-slice ref lists."""
    NULLP = -(2 ** 30)
    ref_poc = np.full(f.ref_idx.shape, NULLP, np.int64)
    for lst in range(2):
        for idx, poc in enumerate(ref_pocs[lst]):
            ref_poc[lst][f.ref_idx[lst] == idx] = poc
    return ref_poc


def deblock_frame(f: FrameModel, sh: SliceHeader, sps: Sps, pps: Pps,
                  rec_y: np.ndarray, rec_cb: np.ndarray, rec_cr: np.ndarray,
                  ref_poc=None) -> None:
    if sh.loop_filter_disable:
        return
    f.sps_pcm_nofilter = sps.use_pcm and sps.pcm_filter_disable_flag
    bd = sps.internal_bit_depth
    from .. import native
    lib = native.get_lib()
    for direction in (0, 1):
        flags, bs, qp_p, qp_q, no_p, no_q = _build_edge_maps(
            f, sh, direction, ref_poc)
        if lib is not None:
            from ..common.rom import CHROMA_SCALE
            uh, uw = flags.shape
            fl = np.ascontiguousarray(flags, np.uint8)
            bsa = np.ascontiguousarray(bs, np.uint8)
            qpp = np.ascontiguousarray(qp_p, np.int32)
            qpq = np.ascontiguousarray(qp_q, np.int32)
            npp = np.ascontiguousarray(no_p, np.uint8)
            nqq = np.ascontiguousarray(no_q, np.uint8)
            cs = np.ascontiguousarray(CHROMA_SCALE, np.uint8)
            lib.deblock_luma(
                rec_y.ctypes.data, rec_y.shape[0], rec_y.shape[1],
                fl.ctypes.data, bsa.ctypes.data, qpp.ctypes.data,
                qpq.ctypes.data, npp.ctypes.data, nqq.ctypes.data,
                uh, uw, direction, sh.loop_filter_beta_offset,
                sh.loop_filter_tc_offset, bd)
            lib.deblock_chroma(
                rec_cb.ctypes.data, rec_cr.ctypes.data,
                rec_cb.shape[0], rec_cb.shape[1],
                fl.ctypes.data, bsa.ctypes.data, qpp.ctypes.data,
                qpq.ctypes.data, npp.ctypes.data, nqq.ctypes.data,
                cs.ctypes.data, uh, uw, direction,
                sh.loop_filter_tc_offset, bd)
        else:
            dbk.filter_luma_edges(rec_y, flags, bs, qp_p, qp_q, no_p, no_q,
                                  direction, sh.loop_filter_beta_offset,
                                  sh.loop_filter_tc_offset, bd)
            dbk.filter_chroma_edges(rec_cb, rec_cr, flags, bs, qp_p, qp_q,
                                    no_p, no_q, direction,
                                    sh.loop_filter_tc_offset, bd)


def _build_edge_maps(f: FrameModel, sh: SliceHeader, direction: int,
                     ref_poc=None):
    """Edge maps for one direction via the native core when available
    (bit-exact either way)."""
    from .. import native
    lib = native.get_lib()
    if lib is None:
        return _edge_maps(f, sh, direction, ref_poc)
    from .native_parse import fill_frame_arrays
    import ctypes
    fa = fill_frame_arrays(f)
    uh, uw = f.depth.shape
    flags = np.empty((uh, uw), np.uint8)
    bs = np.empty((uh, uw), np.uint8)
    qp_p = np.empty((uh, uw), np.int32)
    qp_q = np.empty((uh, uw), np.int32)
    no_p = np.empty((uh, uw), np.uint8)
    no_q = np.empty((uh, uw), np.uint8)
    rp = None
    if ref_poc is not None:
        rp = np.ascontiguousarray(ref_poc, np.int64)
    lib.build_edge_maps(
        ctypes.byref(fa), direction, sh.slice_type,
        int(bool(sh.lf_cross_slice_boundary_flag)),
        int(bool(f.pps.lf_cross_tile_boundary_flag)),
        int(bool(f.sps_pcm_nofilter)),
        rp.ctypes.data if rp is not None else None,
        flags.ctypes.data, bs.ctypes.data, qp_p.ctypes.data,
        qp_q.ctypes.data, no_p.ctypes.data, no_q.ctypes.data)
    return flags, bs, qp_p, qp_q, no_p, no_q


def _picture_filter_inputs(f: FrameModel, sh: SliceHeader, sps: Sps,
                           pps: Pps, ref_poc=None):
    """Host-built device-filter inputs for one picture: edge maps + SAO
    parameter tables (a few KB) and the static launch key.  Returns
    (statics, dbk_ver, dbk_hor, types, band_pos, offsets) or None when
    both filters are off for this picture."""
    bd = sps.internal_bit_depth
    do_deblock = not sh.loop_filter_disable
    do_sao = bool(sps.use_sao and sh.sao_enabled)
    do_sao_chroma = do_sao and bool(sh.sao_enabled_chroma)
    if not do_deblock and not do_sao:
        return None
    f.sps_pcm_nofilter = sps.use_pcm and sps.pcm_filter_disable_flag

    def _shrink(maps):
        # QP fits int8 (0..63): halves the per-frame H2D parameter bytes
        fl, bs, qpp, qpq, nop, noq = maps
        return (fl, bs, qpp.astype(np.int8), qpq.astype(np.int8), nop, noq)

    if do_deblock:
        dbk_ver = _shrink(_build_edge_maps(f, sh, 0, ref_poc))
        dbk_hor = _shrink(_build_edge_maps(f, sh, 1, ref_poc))
    else:
        uh, uw = f.depth.shape
        z8 = np.zeros((uh, uw), np.uint8)
        zi8 = np.zeros((uh, uw), np.int8)
        dbk_ver = dbk_hor = (z8, z8, zi8, zi8, z8, z8)

    nctu = f.ctus_w * f.ctus_h
    sao_shift = bd - min(bd, 10)
    if do_sao:
        types = np.stack([np.asarray(f.sao_type[c], np.int8)
                          for c in range(3)])
        if not do_sao_chroma:
            types[1:] = -1
        band_pos = np.stack([np.asarray(f.sao_sub_type[c], np.int32)
                             for c in range(3)])
        offsets = np.stack(
            [np.asarray(f.sao_offsets[c], np.int32) << sao_shift
             for c in range(3)])
    else:
        types = np.full((3, nctu), -1, np.int8)
        band_pos = np.zeros((3, nctu), np.int32)
        offsets = np.zeros((3, nctu, 4), np.int32)

    statics = dict(beta_offset=sh.loop_filter_beta_offset,
                   tc_offset=sh.loop_filter_tc_offset, bit_depth=bd,
                   ctu_size=f.ctu_size, ctus_w=f.ctus_w, ctus_h=f.ctus_h,
                   do_deblock=do_deblock, do_sao=do_sao,
                   do_sao_chroma=do_sao_chroma)
    return statics, dbk_ver, dbk_hor, types, band_pos, offsets


def sao_frame(f: FrameModel, sh: SliceHeader, sps: Sps,
              rec_y: np.ndarray, rec_cb: np.ndarray, rec_cr: np.ndarray):
    if not (sps.use_sao and sh.sao_enabled):
        return rec_y, rec_cb, rec_cr
    bd = sps.internal_bit_depth
    out_y = sao_ops.apply_sao_plane(rec_y, f.ctu_size, f.sao_type[0],
                                    f.sao_sub_type[0], f.sao_offsets[0],
                                    f.ctus_w, f.ctus_h, bd)
    if sh.sao_enabled_chroma:
        out_cb = sao_ops.apply_sao_plane(rec_cb, f.ctu_size // 2, f.sao_type[1],
                                         f.sao_sub_type[1], f.sao_offsets[1],
                                         f.ctus_w, f.ctus_h, bd)
        out_cr = sao_ops.apply_sao_plane(rec_cr, f.ctu_size // 2, f.sao_type[2],
                                         f.sao_sub_type[2], f.sao_offsets[2],
                                         f.ctus_w, f.ctus_h, bd)
    else:
        out_cb, out_cr = rec_cb, rec_cr
    return out_y, out_cb, out_cr


# -- the port's device route


def _staging(parts, pin: bool) -> tuple:
    """One host buffer (pinned with ``pin``) that holds every part
    stacked, each at a 16-byte-aligned offset: parts [(arrays, dtype)],
    the arrays of one part alike in shape, converted as ``astype`` would.
    Returns (buffer, [(offset, numpy view)]).  PyTorch's caching host
    allocator keeps a pinned buffer until the copy that reads it has
    run."""
    shapes, size = [], 0
    for arrays, dtype in parts:
        shape = (len(arrays), *arrays[0].shape)
        shapes.append((size, shape, np.dtype(dtype)))
        size += -(-int(np.prod(shape)) * np.dtype(dtype).itemsize // 16) * 16
    buf = torch.empty(size, dtype=torch.uint8, pin_memory=pin)
    flat = buf.numpy()
    views = []
    for (arrays, _d), (o, shape, dtype) in zip(parts, shapes):
        view = flat[o:o + int(np.prod(shape)) * dtype.itemsize] \
            .view(dtype).reshape(shape)
        for j, a in enumerate(arrays):
            np.copyto(view[j], a, casting="unsafe")
        views.append((o, view))
    return buf, views


def _filter_pictures(entries, device: torch.device) -> list:
    """Deblocking + SAO for many pictures, one filter call per setting.

    entries: [(f, sh, sps, pps, rec_y, rec_cb, rec_cr, ref_poc)].
    Pictures that share the filter setting (offsets, bit depth, CTU
    grid, which filters are on) run as one batch; 8-bit pictures travel
    as uint8 both ways (lossless: values are clipped to [0, 255]).
    Returns [(host planes, device planes)]: the host planes in the
    dtypes of the inputs, the device planes as the filter left them on
    ``device`` (None for a picture with both filters off).  With stage
    timing on, the stage's parts are timed apart: ``filters.inputs``
    (the host's edge maps and SAO tables), ``filters.stack`` (the batch's
    host arrays, written into one pinned buffer), ``filters.h2d`` (its one
    copy), ``filters.device`` (the filter call),
    ``filters.d2h`` and ``filters.astype`` (the host planes a picture)."""
    with stage("filters.inputs", device):
        inputs = [_picture_filter_inputs(f, sh, sps, pps, rp)
                  for (f, sh, sps, pps, _ry, _rcb, _rcr, rp) in entries]
    out: list = [None] * len(entries)
    groups: dict = {}
    for i, inp in enumerate(inputs):
        if inp is None:                 # both filters off
            out[i] = (tuple(entries[i][4:7]), None)
        else:
            groups.setdefault(tuple(sorted(inp[0].items())), []).append(i)

    for idxs in groups.values():
        statics = inputs[idxs[0]][0]
        u8 = statics["bit_depth"] == 8
        dt = np.uint8 if u8 else np.int16
        with stage("filters.stack", device):
            # the planes, the 12 maps and the 3 SAO tables, a list of the
            # batch's pictures each
            parts = [([entries[i][4 + p] for i in idxs], dt)
                     for p in range(3)]
            for d in (1, 2):
                parts += [([inputs[i][d][k] for i in idxs],
                           inputs[idxs[0]][d][k].dtype) for k in range(6)]
            parts += [([inputs[i][k] for i in idxs], inputs[idxs[0]][k].dtype)
                      for k in (3, 4, 5)]
            buf, views = _staging(parts, device.type == "cuda")
        stat_launch(sum(v.nbytes for _o, v in views))
        with stage("filters.h2d", device):
            dev = buf.to(device, non_blocking=True)
            t = [dev[o:o + v.nbytes].view(torch.from_numpy(v).dtype)
                 .view(v.shape) for o, v in views]
        with stage("filters.device", device):
            planes = ops_filters.filter_pictures(
                t[0], t[1], t[2], tuple(t[3:9]), tuple(t[9:15]),
                t[15], t[16], t[17], out_u8=u8, **statics)
        with stage("filters.d2h", device):
            y, cb, cr = (p.cpu().numpy() for p in planes)
        stat_d2h(y.nbytes + cb.nbytes + cr.nbytes)
        with stage("filters.astype", device):
            for j, i in enumerate(idxs):
                ry, rcb, rcr = entries[i][4:7]
                out[i] = ((y[j].astype(ry.dtype), cb[j].astype(rcb.dtype),
                           cr[j].astype(rcr.dtype)),
                          tuple(p[j] for p in planes))
    return out


def filter_pictures_device(entries, device: torch.device) -> list:
    """Deblocking + SAO for many pictures (``_filter_pictures``); returns
    [(y, cb, cr)] on the host in the dtypes of the inputs."""
    return [h for h, _d in _filter_pictures(entries, device)]


def filter_picture_device(f, sh, sps, pps, rec_y, rec_cb, rec_cr,
                          device: torch.device, ref_poc=None):
    """Deblocking + SAO of one picture on ``device``.  Returns (host
    planes, device planes); the device planes are a copy of the host
    ones when both filters are off."""
    host, dev = _filter_pictures(
        [(f, sh, sps, pps, rec_y, rec_cb, rec_cr, ref_poc)], device)[0]
    if dev is None:
        stat_h2d(sum(a.nbytes for a in host))
        dev = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in host)
    return host, dev
