"""Picture reconstruction for the port: stage-1 residuals on the device,
then the native intra walk.

The device half of ``thevc_tpu/decoder/recon.py``:
``batched_residual_stores`` (:829), ``_device_residual_store`` (:775),
``_launch_residuals`` (:287), and twins of ``_native_picture`` (:641) and
``reconstruct_picture`` (:937) for intra pictures.  The residual store is
passed in as an argument; nothing here consults an environment policy
or falls back to the JAX package.

Stage 1 gathers every coded TU of a batch of pictures into one batch per
(component, size, DST, bit increment) class and runs each class through
``ops.tq`` in one launch.  The residuals come back to the host as the
flat int32 buffer and per-component offset maps that the native core's
``intra_recon_tus`` reads (``IntraParams.resi_buf`` / ``resi_map``).
Transform-skip, bypass and PCM TUs are not in the store; the native walk
reconstructs those itself.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from thevc_tpu import native
from thevc_tpu.common.rom import CHROMA_SCALE
from thevc_tpu.decoder.frame import MODE_INTRA
from thevc_tpu.decoder.native_parse import fill_frame_arrays
from thevc_tpu.decoder.recon import (_AvailCtx, _collect_residuals_vec,
                                     _native_bases, _pack_cgs)

from ..ops import tq
from ..ops.device import stat_d2h, stat_launch


def native_lib():
    """The native core, which the port requires (it raises without it)."""
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("the native core (thevc_tpu.native) did not "
                           "load; the port's decode requires it")
    return lib


def _collect(f, sps, pps, runs) -> dict:
    groups: dict = {}
    if not _collect_residuals_vec(f, sps, pps, runs, groups):
        raise NotImplementedError(
            "picture whose CU TU ranges are not contiguous: the port "
            "batches stage-1 residuals only through the vector collector")
    return groups


def _launch_residuals(classes: dict, device: torch.device) -> dict:
    """Run each TU class through dequant + inverse transform on
    ``device``.  classes: {(comp, size, use_dst, bit_inc): (blocks int16
    [n, s, s], qps int32 [n])}.  Every class is launched before any
    result is copied back; returns {class: int16 [n, s, s] on the host}.
    Classes of 8x8 and up ship only their coded 4x4 groups and unpack on
    the device; 4x4 TUs are one group each and ship dense."""
    pending = []
    for key, (blocks, qps) in classes.items():
        _comp, size, use_dst, bit_inc = key
        qp_dev = torch.from_numpy(qps).to(device)
        if size >= 8:
            vals, idx = _pack_cgs(blocks, size, len(blocks))
            stat_launch(vals.nbytes + idx.nbytes + qps.nbytes)
            res = tq.residual_pipeline_packed(
                torch.from_numpy(vals).to(device),
                torch.from_numpy(idx).to(device), qp_dev, size, use_dst,
                bit_inc)
        else:
            stat_launch(blocks.nbytes + qps.nbytes)
            res = tq.residual_pipeline(torch.from_numpy(blocks).to(device),
                                       qp_dev, use_dst, bit_inc)
        pending.append((key, res))
    out = {}
    for key, res in pending:
        out[key] = res.cpu().numpy()
        stat_d2h(out[key].nbytes)
    return out


def batched_residual_stores(items, device: torch.device) -> list:
    """Stage-1 residuals for many pictures, one launch per TU class.

    All-intra pictures are mutually independent, so their TU batches
    concatenate.  items: [(f, sps, pps, runs)].  Returns one store per
    picture: (resi_buf int32, per-component offset maps [uh, uw] keyed by
    the TU's top-left luma 4x4 unit, -1 where a TU is not in the store)."""
    merged: dict = {}   # class -> [(pic_i, bxs, bys, blocks, qps)]
    for pi, (f, sps, pps, runs) in enumerate(items):
        if sps.scaling_list_enabled_flag:
            raise NotImplementedError("scaling lists: the port's residual "
                                      "path has flat dequantisation only")
        for (comp, size, use_dst), chunks in _collect(f, sps, pps,
                                                      runs).items():
            merged.setdefault((comp, size, use_dst, sps.bit_increment),
                              []).append(
                (pi, np.concatenate([c[0] for c in chunks]),
                 np.concatenate([c[1] for c in chunks]),
                 np.concatenate([c[2] for c in chunks]),
                 np.concatenate([c[3] for c in chunks])))
    classes = {
        key: (np.clip(np.concatenate([e[3] for e in lst]),
                      -32768, 32767).astype(np.int16),
              np.concatenate([e[4] for e in lst]).astype(np.int32))
        for key, lst in merged.items()}
    results = _launch_residuals(classes, device)

    pic_parts: list = [[] for _ in items]
    for key, lst in merged.items():
        off = 0
        for (pi, bxs, bys, _blocks, _qps) in lst:
            k = len(bxs)
            pic_parts[pi].append((key[0], key[1],
                                  results[key][off:off + k], bxs, bys))
            off += k

    stores = []
    for (f, _sps, _pps, _runs), parts in zip(items, pic_parts):
        uh, uw = f.depth.shape
        comp_maps = [np.full((uh, uw), -1, np.int32) for _ in range(3)]
        buf = np.empty(max(sum(r.size for _c, _s, r, _x, _y in parts), 1),
                       np.int32)
        off = 0
        for comp, size, resi, bxs, bys in parts:
            sz = size * size
            k = len(bxs)
            buf[off:off + k * sz] = resi.reshape(-1)
            div = 4 if comp == 0 else 2
            comp_maps[comp][bys // div, bxs // div] = \
                off + np.arange(k, dtype=np.int64) * sz
            off += k * sz
        stores.append((buf, comp_maps))
    return stores


def _device_residual_store(f, sps, pps, runs, device: torch.device):
    """Stage-1 residuals of one picture (the batch of one)."""
    return batched_residual_stores([(f, sps, pps, runs)], device)[0]


def _native_picture(f, sps, pps, runs, rec_y, rec_cb, rec_cr,
                    resi_store) -> None:
    """Reconstruct an intra picture through the native core's in-order
    intra walk (``intra_recon_tus``), reading stage-1 residuals from
    ``resi_store``."""
    lib = native_lib()
    nat = getattr(f, "_native_out", None)
    if nat is not None:
        cu_arr = nat["cu_list"]
        lt_arr, ct_arr = nat["luma_tus"], nat["chroma_tus"]
    else:
        cu_arr = (np.asarray(f.cu_list, np.int32).reshape(-1, 8)
                  if f.cu_list else np.zeros((0, 8), np.int32))
        lt_arr = (np.asarray(f.luma_tus, np.int32).reshape(-1, 6)
                  if f.luma_tus else np.zeros((0, 6), np.int32))
        ct_arr = (np.asarray(f.chroma_tus, np.int32).reshape(-1, 6)
                  if f.chroma_tus else np.zeros((0, 6), np.int32))
    if any((cu_arr[lo:hi, 3] != MODE_INTRA).any()
           for (_sh, _ip, lo, hi) in runs):
        raise NotImplementedError("inter CUs: the port decodes intra "
                                  "pictures only")

    avail = _AvailCtx(f)
    sstart = np.ascontiguousarray(f.slice_start)   # alive across the calls
    maps = native.AvailMaps(
        avail.order.ctypes.data, avail.in_pic.ctypes.data,
        avail.ctu.ctypes.data, avail.tile.ctypes.data, sstart.ctypes.data,
        avail._PAD, avail.order.shape[1], sstart.shape[1])

    bases = _native_bases()
    # per-TU recon rows built natively; per-run chroma QP offsets come
    # from the slice header
    cscale = np.ascontiguousarray(CHROMA_SCALE, np.uint8)
    fa = fill_frame_arrays(f)
    n_lt, n_ct = len(lt_arr), len(ct_arr)
    rows_y = np.empty((max(n_lt, 1), 10), np.int32)
    rows_cb = np.empty((max(n_ct, 1), 10), np.int32)
    rows_cr = np.empty((max(n_ct, 1), 10), np.int32)
    n_y = np.zeros(1, np.int32)
    n_cb = np.zeros(1, np.int32)
    n_cr = np.zeros(1, np.int32)
    for (sh, _inter_pred, lo, hi) in runs:
        lib.build_intra_rows(
            ctypes.byref(fa), cu_arr.ctypes.data, lo, hi,
            lt_arr.ctypes.data, ct_arr.ctypes.data,
            sps.qp_bd_offset_y, sps.qp_bd_offset_c,
            pps.chroma_cb_qp_offset + sh.slice_qp_delta_cb,
            pps.chroma_cr_qp_offset + sh.slice_qp_delta_cr,
            cscale.ctypes.data,
            rows_y.ctypes.data, n_y.ctypes.data,
            rows_cb.ctypes.data, n_cb.ctypes.data,
            rows_cr.ctypes.data, n_cr.ctypes.data)

    buf, comp_maps = resi_store
    max_val = (1 << sps.internal_bit_depth) - 1
    dc_val = 1 << (sps.internal_bit_depth - 1)
    plane_cfg = (
        (rows_y, int(n_y[0]), rec_y, f.coeff_y, 4, 4, 1,
         getattr(f, "pcm_y", None), 0),
        (rows_cb, int(n_cb[0]), rec_cb, f.coeff_cb, 2, 2, 0,
         getattr(f, "pcm_cb", None), 1),
        (rows_cr, int(n_cr[0]), rec_cr, f.coeff_cr, 2, 2, 0,
         getattr(f, "pcm_cr", None), 2),
    )
    for tu_arr, n_rows, rec, coeff, unit, adiv, is_luma, pcm, comp \
            in plane_cfg:
        if not n_rows:
            continue
        params = native.IntraParams(
            rec.shape[1], coeff.shape[1], unit, adiv, is_luma, dc_val,
            max_val, sps.bit_increment,
            bases[4].ctypes.data, bases[8].ctypes.data,
            bases[16].ctypes.data, bases[32].ctypes.data,
            bases["dst"].ctypes.data,
            pcm.ctypes.data if pcm is not None else None,
            pcm.shape[1] if pcm is not None else 0)
        params.resi_buf = buf.ctypes.data
        params.resi_map = comp_maps[comp].ctypes.data
        params.map_w = comp_maps[comp].shape[1]
        lib.intra_recon_tus(
            rec.ctypes.data, coeff.ctypes.data,
            tu_arr.ctypes.data, n_rows,
            ctypes.byref(maps), ctypes.byref(params))


def reconstruct_picture(f, sps, pps, runs, rec_y, rec_cb, rec_cr,
                        device: torch.device, resi_store=None) -> None:
    """Whole-picture reconstruction of an intra picture: stage-1
    residuals on ``device`` (unless a batched store is passed in), then
    the native intra walk.  runs: [(sh, inter_pred, cu_lo, cu_hi)], one
    entry per slice segment."""
    if resi_store is None:
        resi_store = _device_residual_store(f, sps, pps, runs, device)
    _native_picture(f, sps, pps, runs, rec_y, rec_cb, rec_cr, resi_store)
