"""Whole-picture motion compensation on a torch device.

The device half of ``thevc_tpu/decoder/inter.py``: ``precompute_device``
(:121-221) becomes ``predict_picture``, which returns the picture's
prediction on the device instead of filling ``InterPredictor._dev_store``.
The host half, ``InterPredictor`` (the per-PU host MC that the encoder's
inter search runs, and ``_enumerate_pus``, which applies
``xCheckIdenticalMotion``), is copied below without the device batch
path.  The host enumerates PUs and computes ``clip_mv``'s clamp and each
job's window over numpy arrays; the window gather, one
``ops.mc.mc_batch`` per (component, filter case, size, bi) class, one
``bi_avg_batch`` per block size and the scatter into the prediction run
on the device.  A slice with explicit weighted prediction runs every MC
job of its PUs at 14 bits, and ``ops.mc.weight_uni_batch`` /
``weight_bi_batch`` apply each PU's weights (gathered by list, reference
index and component from the slice header) over whole classes.

A picture's three planes live on the device as one flat buffer
(``Layout``): luma, then Cb, then Cr, each row-major.  ``RefPlanes``
keeps each reference picture's planes on the device from the filter
stage that made them until the DPB stops referencing the picture, so a
reference crosses PCIe at most once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import mc
from ..ops.device import stage, stat_h2d, stat_launch
from ..ops.interp import bi_avg, mc_chroma, mc_luma
from .frame import MODE_INTRA
from .mv import clip_mv, num_pus, pu_geometry

# TComDataCU::clipMv's slack past the picture, in samples
_CLIP_OFF = 8
# columns of the PU table (_pu_table)
_RUN, _XP, _YP, _PW, _PH, _CUX, _CUY, _REF0, _MV0, _REF1, _MV1 = \
    0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11
# reference indices a slice can address per list
_MAX_REFS = 16


# -- thevc_tpu/decoder/inter.py:20-120, 224-283, without the device batch
# path (``_dev_store``, ``precompute_device``)


class InterPredictor:
    """Motion compensation for one slice: holds ref lists + geometry."""

    def __init__(self, frame, sh, sps, pps, list0, list1):
        self.f = frame
        self.sh = sh
        self.sps = sps
        self.pps = pps
        self.lists = [list0, list1]
        self.bd = sps.internal_bit_depth
        self.pic_w = sps.pic_width_in_luma_samples
        self.pic_h = sps.pic_height_in_luma_samples
        self.ctu = sps.max_cu_width
        # explicit weighted prediction (TComWeightPrediction.cpp)
        self.wp_active = (pps.use_wp and sh.slice_type == 1) or \
                         (pps.wp_bipred and sh.slice_type == 0)
        self.wp = getattr(sh, "wp_scaling", None) if self.wp_active else None

    # -- weighted prediction helpers (TComWeightPrediction.cpp:61-366) ----
    def _wp_params(self, lst: int, ref: int, comp: int):
        """(weight, iOffset, log2denom) for one list/ref/component."""
        w = self.wp["wp"][lst][ref][comp]
        denom = self.wp["luma_log2_denom"] if comp == 0 \
            else self.wp["chroma_log2_denom"]
        return w[1], w[2], denom

    def _weight_uni(self, blk, lst, ref, comp):
        """addWeightUni: src is in the 14-bit internal domain (bi=True)."""
        w, ioff, denom = self._wp_params(lst, ref, comp)
        bd = self.bd
        offset = ioff * (1 << (bd - 8))
        shift = denom + (14 - bd)
        round_ = (1 << (shift - 1)) if shift else 0
        v = ((w * (blk.astype(np.int64) + 8192) + round_) >> shift) + offset
        return np.clip(v, 0, (1 << bd) - 1).astype(np.int16)

    def _weight_bi(self, b0, b1, ref0, ref1, comp):
        """addWeightBi with the bi-dir derivation (getWpScaling)."""
        w0, io0, denom = self._wp_params(0, ref0, comp)
        w1, io1, _ = self._wp_params(1, ref1, comp)
        bd = self.bd
        o0 = io0 * (1 << (bd - 8))
        o1 = io1 * (1 << (bd - 8))
        offset = o0 + o1
        shift = denom + 1 + (14 - bd)
        round_ = (1 << (shift - 1)) if shift else 0
        v = (w0 * (b0.astype(np.int64) + 8192)
             + w1 * (b1.astype(np.int64) + 8192)
             + round_ + (offset << (shift - 1))) >> shift
        return np.clip(v, 0, (1 << bd) - 1).astype(np.int16)

    def predict_cu(self, px: int, py: int, size: int):
        """motionCompensation over all PUs of the CU at (px, py).

        Returns (pred_y, pred_cb, pred_cr) int16 blocks in pixel domain.
        """
        f = self.f
        pred_y = np.zeros((size, size), np.int16)
        cs = size // 2
        pred_cb = np.zeros((cs, cs), np.int16)
        pred_cr = np.zeros((cs, cs), np.int16)
        part_sz = int(f.part_size_arr[py // 4, px // 4])
        for pu in range(num_pus(part_sz)):
            xp, yp, pw, ph = pu_geometry(part_sz, px, py, size, pu)
            self._predict_pu(px, py, xp, yp, pw, ph,
                             pred_y, pred_cb, pred_cr, px, py)
        return pred_y, pred_cb, pred_cr

    def _enumerate_pus(self, cu_entries):
        """(xp, yp, pw, ph, cu_x, cu_y, ref0, mv0, ref1, mv1) per PU of
        the given inter CUs (mirrors predict_cu + xCheckIdenticalMotion)."""
        f = self.f
        pus = []
        for (px, py, size, mode, l0, l1, c0, c1) in cu_entries:
            part_sz = int(f.part_size_arr[py // 4, px // 4])
            for pu in range(num_pus(part_sz)):
                xp, yp, pw, ph = pu_geometry(part_sz, px, py, size, pu)
                ref0, mv0 = self._pu_motion(xp, yp, 0)
                ref1, mv1 = self._pu_motion(xp, yp, 1)
                if (self.sh.slice_type == 0 and not self.pps.wp_bipred and
                        ref0 >= 0 and ref1 >= 0 and
                        self.lists[0][ref0].poc == self.lists[1][ref1].poc
                        and mv0 == mv1):
                    ref1 = -1
                pus.append((xp, yp, pw, ph, px, py, ref0, mv0, ref1, mv1))
        return pus

    # ------------------------------------------------------------------
    def _pu_motion(self, xp, yp, lst):
        f = self.f
        ux, uy = xp // 4, yp // 4
        ref = int(f.ref_idx[lst, uy, ux])
        mv = (int(f.mv[lst, uy, ux, 0]), int(f.mv[lst, uy, ux, 1]))
        return ref, mv

    def _predict_pu(self, cu_x, cu_y, xp, yp, pw, ph,
                    pred_y, pred_cb, pred_cr, px0, py0):
        ref0, mv0 = self._pu_motion(xp, yp, 0)
        ref1, mv1 = self._pu_motion(xp, yp, 1)
        lx, ly = xp - px0, yp - py0

        # xCheckIdenticalMotion: B slice, no weighted bipred, both lists on
        # the same picture with the same MV -> uni L0
        if (self.sh.slice_type == 0 and not self.pps.wp_bipred and
                ref0 >= 0 and ref1 >= 0 and
                self.lists[0][ref0].poc == self.lists[1][ref1].poc and
                mv0 == mv1):
            ref1 = -1

        if ref0 >= 0 and ref1 >= 0:
            y0, cb0, cr0 = self._mc_one(0, ref0, mv0, cu_x, cu_y,
                                        xp, yp, pw, ph, bi=True)
            y1, cb1, cr1 = self._mc_one(1, ref1, mv1, cu_x, cu_y,
                                        xp, yp, pw, ph, bi=True)
            if self.wp_active:
                blk_y = self._weight_bi(y0, y1, ref0, ref1, 0)
                blk_cb = self._weight_bi(cb0, cb1, ref0, ref1, 1)
                blk_cr = self._weight_bi(cr0, cr1, ref0, ref1, 2)
            else:
                blk_y = bi_avg(y0, y1, self.bd)
                blk_cb = bi_avg(cb0, cb1, self.bd)
                blk_cr = bi_avg(cr0, cr1, self.bd)
        else:
            lst = 0 if ref0 >= 0 else 1
            ref = ref0 if ref0 >= 0 else ref1
            mv = mv0 if ref0 >= 0 else mv1
            blk_y, blk_cb, blk_cr = self._mc_one(
                lst, ref, mv, cu_x, cu_y, xp, yp, pw, ph,
                bi=self.wp_active)
            if self.wp_active:
                blk_y = self._weight_uni(blk_y, lst, ref, 0)
                blk_cb = self._weight_uni(blk_cb, lst, ref, 1)
                blk_cr = self._weight_uni(blk_cr, lst, ref, 2)
        pred_y[ly:ly + ph, lx:lx + pw] = blk_y
        pred_cb[ly // 2:(ly + ph) // 2, lx // 2:(lx + pw) // 2] = blk_cb
        pred_cr[ly // 2:(ly + ph) // 2, lx // 2:(lx + pw) // 2] = blk_cr

    def _mc_one(self, lst, ref_idx, mv, cu_x, cu_y, xp, yp, pw, ph, bi):
        pic = self.lists[lst][ref_idx]
        mv = clip_mv(mv, cu_x, cu_y, self.pic_w, self.pic_h, self.ctu)
        pad_y, pad_cb, pad_cr = pic.padded()
        m = pic.margin
        y = mc_luma(pad_y, m, xp, yp, mv[0], mv[1], pw, ph, self.bd, bi)
        cb = mc_chroma(pad_cb, m // 2, xp // 2, yp // 2, mv[0], mv[1],
                       pw // 2, ph // 2, self.bd, bi)
        cr = mc_chroma(pad_cr, m // 2, xp // 2, yp // 2, mv[0], mv[1],
                       pw // 2, ph // 2, self.bd, bi)
        return y, cb, cr


# -- the port's device route


@dataclass(frozen=True)
class Layout:
    """Where the planes of one picture lie in a flat device buffer."""
    width: int
    height: int

    @property
    def size(self) -> int:
        return self.width * self.height * 3 // 2

    def base(self, comp: int) -> int:
        """Offset of component ``comp``'s plane (0 Y, 1 Cb, 2 Cr)."""
        luma = self.width * self.height
        return 0 if comp == 0 else luma + (comp - 1) * (luma // 4)

    def stride(self, comp: int) -> int:
        return self.width if comp == 0 else self.width // 2

    def origin(self, comp: int, x, y):
        """Offset of sample (x, y) of component ``comp`` (arrays too)."""
        return self.base(comp) + y * self.stride(comp) + x

    def split(self, flat):
        """The three planes of a flat buffer (views) as [h, w] arrays."""
        w, h = self.width, self.height
        y = flat[:w * h].reshape(h, w)
        cb = flat[self.base(1):self.base(2)].reshape(h // 2, w // 2)
        cr = flat[self.base(2):].reshape(h // 2, w // 2)
        return y, cb, cr


def scatter_blocks(flat: torch.Tensor, blocks: torch.Tensor,
                   origin: torch.Tensor, stride: torch.Tensor) -> None:
    """Write blocks [N, h, w] into the flat buffer: block k's sample (i,
    j) goes to ``origin[k] + i * stride[k] + j``."""
    n, h, w = blocks.shape
    dev = flat.device
    idx = (origin.long()[:, None, None]
           + torch.arange(h, device=dev)[None, :, None]
           * stride.long()[:, None, None]
           + torch.arange(w, device=dev)[None, None, :])
    flat[idx.reshape(-1)] = blocks.reshape(-1).to(flat.dtype)


class RefPlanes:
    """Device planes (int16 [h, w] each) of the DPB's reference pictures,
    keyed by POC."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._by_poc: dict = {}      # poc -> (Picture, (y, cb, cr))

    def put(self, pic, planes) -> None:
        self._by_poc[pic.poc] = (pic, tuple(p.to(torch.int16)
                                            for p in planes))

    def get(self, pic) -> tuple:
        """The planes of ``pic``.  A picture that no filter stage of this
        decoder made (a concealed lost reference) is copied up once."""
        entry = self._by_poc.get(pic.poc)
        if entry is None or entry[0] is not pic:
            host = [np.ascontiguousarray(p, np.int16)
                    for p in (pic.rec_y, pic.rec_cb, pic.rec_cr)]
            stat_h2d(sum(a.nbytes for a in host))
            self.put(pic, [torch.from_numpy(a).to(self.device)
                           for a in host])
            entry = self._by_poc[pic.poc]
        return entry[1]

    def drop_unreferenced(self) -> None:
        """Free the planes of pictures the DPB no longer references."""
        for poc in [k for k, (p, _) in self._by_poc.items()
                    if not p.referenced]:
            del self._by_poc[poc]

    def __len__(self) -> int:
        return len(self._by_poc)


def _pu_table(runs) -> np.ndarray:
    """Every PU of the inter CUs of the picture's slices, as int64 rows
    (run, xp, yp, pw, ph, cu_x, cu_y, ref0, mv0 x, y, ref1, mv1 x, y)."""
    rows = []
    for r, (_sh, ip, lo, hi) in enumerate(runs):
        if ip is None:
            continue
        entries = [e for e in ip.f.cu_list[lo:hi] if e[3] != MODE_INTRA]
        for (xp, yp, pw, ph, cux, cuy, ref0, mv0, ref1, mv1) in \
                ip._enumerate_pus(entries):
            rows.append((r, xp, yp, pw, ph, cux, cuy, ref0, *mv0, ref1,
                         *mv1))
    return np.asarray(rows, np.int64).reshape(-1, 13)


def _wp_table(runs, bd: int) -> np.ndarray:
    """Per slice, list, reference index and component the explicit
    weighted-prediction parameters (weight, offset at the bit depth, log2
    denominator), int64 [runs, 2, _MAX_REFS, 3, 3]; (1, 0, 0), which
    ``weight_bi_batch`` turns into the plain average, for slices without
    weighted prediction (``InterPredictor._wp_params``)."""
    tab = np.zeros((len(runs), 2, _MAX_REFS, 3, 3), np.int64)
    tab[..., 0] = 1
    for r, (_sh, ip, _lo, _hi) in enumerate(runs):
        if ip is None or not ip.wp_active:
            continue
        for lst in (0, 1):
            for ref in range(len(ip.lists[lst])):
                for comp in range(3):
                    w, ioff, denom = ip._wp_params(lst, ref, comp)
                    tab[r, lst, ref, comp] = (w, ioff * (1 << (bd - 8)),
                                              denom)
    return tab


def clip_mvs(mv: np.ndarray, cu_x: np.ndarray, cu_y: np.ndarray, pic_w: int,
             pic_h: int, ctu: int) -> np.ndarray:
    """``decoder.mv.clip_mv`` over arrays: mv [N, 2] -> [N, 2]."""
    lo_x = (-ctu - _CLIP_OFF - cu_x + 1) << 2
    hi_x = (pic_w + _CLIP_OFF - cu_x - 1) << 2
    lo_y = (-ctu - _CLIP_OFF - cu_y + 1) << 2
    hi_y = (pic_h + _CLIP_OFF - cu_y - 1) << 2
    return np.stack([np.minimum(hi_x, np.maximum(lo_x, mv[:, 0])),
                     np.minimum(hi_y, np.maximum(lo_y, mv[:, 1]))], axis=1)


def _ref_slots(runs):
    """The distinct reference pictures of the picture's slices, and per
    slice and list the slot of each reference index."""
    pics, slot_of, luts = [], {}, []
    for (_sh, ip, _lo, _hi) in runs:
        lut = []
        for lst in (0, 1):
            ids = []
            for p in (ip.lists[lst] if ip is not None else []):
                if id(p) not in slot_of:
                    slot_of[id(p)] = len(pics)
                    pics.append(p)
                ids.append(slot_of[id(p)])
            lut.append(np.asarray(ids, np.int64))
        luts.append(lut)
    return pics, luts


# job columns: source plane, window x, y, frac x, y, destination origin
# and stride, list, bi pair index, weighted-prediction weight, offset and
# log2 denominator; then the class key (luma, case, h, w, kind) kept on
# the host, kind: 0 a uni PU in pixels, 1 one half of a bi pair, 2 a
# weighted uni PU (both at 14 bits)
_J_PLANE, _J_WX, _J_WY, _J_FX, _J_FY, _J_ORG, _J_STR, _J_LST, _J_PAIR, \
    _J_W, _J_O, _J_DEN = range(12)
_UNI, _PAIR, _WEIGHTED = 0, 1, 2


def _jobs(pus: np.ndarray, luts, sps, layout: Layout, wp: np.ndarray,
          wp_runs: np.ndarray):
    """One uni-directional MC job per (PU, active list, component).

    wp: ``_wp_table``; wp_runs: bool per slice, its weighted prediction
    on.  Returns (table int64 [J, 12], keys int64 [J, 5] of (luma, case,
    h, w, kind), pairs int64 [Q, 8] of (h, w, origin, stride, w0, w1,
    offset, log2 denominator), one row per (bi PU, component), ordered by
    block size)."""
    n = len(pus)
    bi = (pus[:, _REF0] >= 0) & (pus[:, _REF1] >= 0)
    ctu = sps.max_cu_width
    # bi pairs, one per (bi PU, component), numbered within their size
    pair_idx = np.full((n, 3), -1, np.int64)
    pair_rows = []
    bi_pus = np.nonzero(bi)[0]
    for comp in range(3):
        d = 1 if comp == 0 else 2
        p = pus[bi_pus]
        w0 = wp[p[:, _RUN], 0, p[:, _REF0], comp]
        w1 = wp[p[:, _RUN], 1, p[:, _REF1], comp]
        pair_rows.append(np.stack([
            p[:, _PH] // d, p[:, _PW] // d,
            layout.origin(comp, p[:, _XP] // d, p[:, _YP] // d),
            np.full(len(p), layout.stride(comp)), bi_pus,
            np.full(len(p), comp), w0[:, 0], w1[:, 0], w0[:, 1] + w1[:, 1],
            w0[:, 2]], axis=1))
    pairs = np.concatenate(pair_rows)
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    size_key = pairs[:, 0] * 128 + pairs[:, 1]
    starts = np.r_[0, np.nonzero(np.diff(size_key))[0] + 1]
    rank = np.arange(len(pairs)) - np.repeat(starts, np.diff(
        np.r_[starts, len(pairs)]))
    pair_idx[pairs[:, 4], pairs[:, 5]] = rank
    kind = np.where(bi, _PAIR, np.where(wp_runs[pus[:, _RUN]], _WEIGHTED,
                                        _UNI))

    tables, keys = [], []
    for lst, ref_col, mv_col in ((0, _REF0, _MV0), (1, _REF1, _MV1)):
        sel = pus[:, ref_col] >= 0
        p = pus[sel]
        idx = np.nonzero(sel)[0]
        slot = np.zeros(len(p), np.int64)
        for r in np.unique(p[:, _RUN]):
            m = p[:, _RUN] == r
            slot[m] = luts[r][lst][p[m, ref_col]]
        mv = clip_mvs(p[:, mv_col:mv_col + 2], p[:, _CUX], p[:, _CUY],
                      layout.width, layout.height, ctu)
        for comp in range(3):
            d, frac_bits, half = (1, 2, 4) if comp == 0 else (2, 3, 2)
            fx = mv[:, 0] & ((1 << frac_bits) - 1)
            fy = mv[:, 1] & ((1 << frac_bits) - 1)
            x0 = p[:, _XP] // d + (mv[:, 0] >> frac_bits)
            y0 = p[:, _YP] // d + (mv[:, 1] >> frac_bits)
            case = (fx != 0) + 2 * (fy != 0)
            plane = slot if comp == 0 else 2 * slot + comp - 1
            w = wp[p[:, _RUN], lst, p[:, ref_col], comp]
            tables.append(np.stack([
                plane, x0 - (half - 1) * (fx != 0),
                y0 - (half - 1) * (fy != 0), fx, fy,
                layout.origin(comp, p[:, _XP] // d, p[:, _YP] // d),
                np.full(len(p), layout.stride(comp)), np.full(len(p), lst),
                pair_idx[idx, comp], w[:, 0], w[:, 1], w[:, 2]], axis=1))
            keys.append(np.stack([
                np.full(len(p), int(comp == 0)), case, p[:, _PH] // d,
                p[:, _PW] // d, kind[idx]], axis=1))
    return (np.concatenate(tables), np.concatenate(keys),
            np.concatenate([pairs[:, :4], pairs[:, 6:]], axis=1))


def predict_picture(runs, sps, refs: RefPlanes,
                    device: torch.device) -> torch.Tensor:
    """The motion-compensated prediction of every inter PU of a picture.

    runs: [(sh, inter_pred, cu_lo, cu_hi)], the reference's slice runs
    with their ``InterPredictor``.  Returns a flat int16 buffer on
    ``device`` in the picture's ``Layout``, zero outside inter PUs."""
    layout = Layout(sps.pic_width_in_luma_samples,
                    sps.pic_height_in_luma_samples)
    bd = sps.internal_bit_depth
    with stage("pu_grouping", device):
        pus = _pu_table(runs)
        pics, luts = _ref_slots(runs)
        wp_runs = np.asarray([ip is not None and ip.wp_active
                              for _sh, ip, _lo, _hi in runs])
        if len(pus):
            table, keys, pairs = _jobs(pus, luts, sps, layout,
                                       _wp_table(runs, bd), wp_runs)
            order = np.lexsort(keys.T[::-1])
            table, keys = table[order], keys[order]
            bounds = np.r_[0, np.nonzero(np.any(np.diff(keys, axis=0),
                                                axis=1))[0] + 1, len(keys)]
    pred = torch.zeros(layout.size, dtype=torch.int16, device=device)
    if not len(pus):
        return pred
    with stage("mc", device):
        planes = [refs.get(p) for p in pics]
        luma = torch.stack([pl[0] for pl in planes])
        chroma = torch.stack([c for pl in planes for c in pl[1:]])
        host = np.concatenate([table.reshape(-1), pairs.reshape(-1)])
        stat_h2d(host.size * 4)
        dev = torch.from_numpy(host.astype(np.int32)).to(device)
        tab = dev[:table.size].reshape(table.shape)
        pair_tab = dev[table.size:].reshape(pairs.shape)

        sizes, size_at = np.unique(pairs[:, 0] * 128 + pairs[:, 1],
                                   return_index=True)
        counts = np.diff(np.r_[size_at, len(pairs)])
        bufs = {int(k): torch.empty((2, int(c), int(k) // 128, int(k) % 128),
                                    dtype=torch.int16, device=device)
                for k, c in zip(sizes, counts)}
        for a, b in zip(bounds[:-1], bounds[1:]):
            is_luma, case_id, h, w, kind = (int(v) for v in keys[a])
            case = mc.CASES[case_id]
            t = tab[a:b]
            rows, cols = mc.window_shape(case, bool(is_luma), h, w)
            win = mc.gather_windows(luma if is_luma else chroma,
                                    t[:, _J_PLANE], t[:, _J_WX],
                                    t[:, _J_WY], rows, cols)
            stat_launch()
            out = mc.mc_batch(win, t[:, _J_FX], t[:, _J_FY], case,
                              bool(is_luma), bd, kind != _UNI, h, w)
            if kind == _PAIR:
                bufs[h * 128 + w][t[:, _J_LST].long(),
                                  t[:, _J_PAIR].long()] = out
                continue
            if kind == _WEIGHTED:
                out = mc.weight_uni_batch(out, t[:, _J_W], t[:, _J_O],
                                          t[:, _J_DEN], bd)
            scatter_blocks(pred, out, t[:, _J_ORG], t[:, _J_STR])
        weighted = bool(wp_runs.any())
        for (k, buf), a, c in zip(bufs.items(), size_at, counts):
            stat_launch()
            pt = pair_tab[a:a + c]
            if weighted:
                avg = mc.weight_bi_batch(buf[0], buf[1], pt[:, 4], pt[:, 5],
                                         pt[:, 6], pt[:, 7], bd)
            else:
                avg = mc.bi_avg_batch(buf[0], buf[1], bd)
            scatter_blocks(pred, avg, pt[:, 2], pt[:, 3])
    return pred
