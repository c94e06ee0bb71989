"""Whole-picture motion compensation on a torch device.

The device half of ``thevc_tpu/decoder/inter.py``: ``precompute_device``
(:121-221) becomes ``predict_picture``, which returns the picture's
prediction on the device instead of filling ``InterPredictor._dev_store``.
The host half, ``InterPredictor`` (the per-PU host MC that the encoder's
inter search runs, and ``_enumerate_pus``, which applies
``xCheckIdenticalMotion``), is copied below without the device batch
path.  The host enumerates PUs and computes ``clip_mv``'s clamp, each
list's window and phases and each PU's weights over numpy arrays, one
job a (PU, component) with both lists of a bi PU (``_jobs``);
``ops.mc.mc_picture`` predicts them all: on ``cuda`` one launch of the
hand-written kernel (``csrc/mc.cu``), which reads the reference planes
through a table of their device pointers and writes each PU's pixels
into the prediction; on the CPU its plain version.  A slice with
explicit weighted prediction makes weighted jobs (each list at 14
bits, then the PU's weights, gathered by list, reference index and
component from the slice header).

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
from ..ops.mc import scatter_blocks  # noqa: F401  (decoder.recon uses it)
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
_KIND = {k: i for i, k in enumerate(mc.KINDS)}


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


class RefPlanes:
    """Device planes (int16 [h, w] each) of the DPB's reference pictures,
    keyed by POC."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._by_poc: dict = {}      # poc -> (Picture, (y, cb, cr))

    def put(self, pic, planes) -> None:
        self._by_poc[pic.poc] = (pic, tuple(p.to(torch.int16).contiguous()
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
    denominator), int64 [runs, 2, _MAX_REFS, 3, 3]; (1, 0, 0), the
    weights of the plain average, for slices without weighted prediction
    (``InterPredictor._wp_params``)."""
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


def _jobs(pus: np.ndarray, luts, sps, layout: Layout, wp: np.ndarray,
          wp_runs: np.ndarray) -> np.ndarray:
    """The picture's MC jobs (``ops.mc_kernel``): one per (PU, component),
    int32 [3 * len(pus), JOB_COLS], components in order.  A uni PU's job
    carries its active list, a bi PU's both (list 0 first); a PU of a
    slice with weighted prediction (wp_runs, bool per slice) is a
    weighted job with its weights from ``_wp_table`` (wp).  The planes
    the jobs index are each slot's (y, cb, cr) of ``_ref_slots``, in
    order."""
    n = len(pus)
    bi = (pus[:, _REF0] >= 0) & (pus[:, _REF1] >= 0)
    weighted = wp_runs[pus[:, _RUN]]
    kind = np.where(bi, np.where(weighted, _KIND["wbi"], _KIND["bi"]),
                    np.where(weighted, _KIND["wuni"], _KIND["uni"]))
    l1_only = (pus[:, _REF0] < 0)[:, None]
    ctu = sps.max_cu_width
    per_list = []
    for lst, ref_col, mv_col in ((0, _REF0, _MV0), (1, _REF1, _MV1)):
        ref = pus[:, ref_col]
        slot = np.zeros(n, np.int64)
        for r in np.unique(pus[ref >= 0, _RUN]):
            m = (ref >= 0) & (pus[:, _RUN] == r)
            slot[m] = luts[r][lst][ref[m]]
        mv = clip_mvs(pus[:, mv_col:mv_col + 2], pus[:, _CUX], pus[:, _CUY],
                      layout.width, layout.height, ctu)
        per_list.append((np.maximum(ref, 0), slot, mv))
    jobs = np.zeros((3, n, mc.JOB_COLS), np.int64)
    for comp in range(3):
        d, frac_bits, half = (1, 2, 4) if comp == 0 else (2, 3, 2)
        job = jobs[comp]
        job[:, mc.J_H] = pus[:, _PH] // d
        job[:, mc.J_W] = pus[:, _PW] // d
        job[:, mc.J_LUMA] = comp == 0
        job[:, mc.J_KIND] = kind
        job[:, mc.J_DST] = layout.origin(comp, pus[:, _XP] // d,
                                         pus[:, _YP] // d)
        job[:, mc.J_STRIDE] = layout.stride(comp)
        fields, weights = [], []
        for lst, (ref, slot, mv) in enumerate(per_list):
            fx = mv[:, 0] & ((1 << frac_bits) - 1)
            fy = mv[:, 1] & ((1 << frac_bits) - 1)
            fields.append(np.stack([
                3 * slot + comp,
                pus[:, _XP] // d + (mv[:, 0] >> frac_bits)
                - (half - 1) * (fx != 0),
                pus[:, _YP] // d + (mv[:, 1] >> frac_bits)
                - (half - 1) * (fy != 0),
                fx, fy, (fx != 0) + 2 * (fy != 0)], axis=1))
            # (weight, offset at the bit depth, log2 denominator)
            weights.append(wp[pus[:, _RUN], lst, ref, comp])
        first = np.where(l1_only, fields[1], fields[0])
        w_first = np.where(l1_only, weights[1], weights[0])
        job[:, mc.J_LIST:mc.J_LIST + 6] = first
        job[bi, mc.J_LIST + 6:] = fields[1][bi]
        job[:, mc.J_W0] = w_first[:, 0]
        job[:, mc.J_W1] = weights[1][:, 0]
        job[:, mc.J_OFF] = np.where(bi, weights[0][:, 1] + weights[1][:, 1],
                                    w_first[:, 1])
        job[:, mc.J_DEN] = w_first[:, 2]
    return jobs.reshape(-1, mc.JOB_COLS).astype(np.int32)


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
        if not len(pus):
            return torch.zeros(layout.size, dtype=torch.int16,
                               device=device)
        jobs = _jobs(pus, luts, sps, layout, _wp_table(runs, bd), wp_runs)
    with stage("mc", device):
        planes = [pl for p in pics for pl in refs.get(p)]
        stat_launch()
        return mc.mc_picture(jobs, planes, layout.size, bd)
