"""Reference picture management: DPB, RPS application, reference lists.

Behavioral reference: TComSlice.cpp (setRefPicList :402, applyReferencePictureSet
:~1430, xGetRefPic), TDecTop.cpp (xActivateParameterSets, low-delay check
:540-561), TComPic::compressMotion :120 + TComCUMvField::compress :330
(motion field decimated to one entry per 16x16 block), TComMv::scaleMv.
"""

from __future__ import annotations

import numpy as np

from ..ops.interp import pad_plane

NOT_VALID = -1


class Picture:
    """A decoded picture in the DPB with its colocated-motion snapshot."""

    def __init__(self, poc: int, planes, frame, sh, ref_pocs, margin: int,
                 ref_poc: np.ndarray | None = None,
                 ref_is_lt: np.ndarray | None = None):
        self.poc = poc
        self.rec_y, self.rec_cb, self.rec_cr = planes
        self.referenced = True
        self.is_long_term = False
        self.is_used_as_long_term = False
        self.check_lt_msb = False
        self.needed_for_output = True
        self.margin = margin
        self._pad = None

        # colocated motion snapshot (compressMotion: one value per 16 parts,
        # i.e. the z-order-first 4x4 of each 16x16 block; we realize the
        # decimation by reading through _col_unit)
        self.pred_mode = frame.pred_mode.copy()
        self.mv = frame.mv.copy()                 # [list, uy, ux, 2]
        self.ref_idx = frame.ref_idx.copy()       # [list, uy, ux]
        # resolved reference POC per unit/list (slice ref lists die with the
        # slice; TMVP needs getRefPOC of the *colocated* slice)
        if ref_poc is not None:
            self.ref_poc = ref_poc.copy()
        else:
            shape = frame.ref_idx.shape
            self.ref_poc = np.full(shape, -(10 ** 9), np.int64)
            for lst in range(2):
                for idx, poc_ref in enumerate(ref_pocs[lst]):
                    self.ref_poc[lst][frame.ref_idx[lst] == idx] = poc_ref
        # per-unit "reference picture was long-term" snapshot; TMVP reads
        # getIsUsedAsLongTerm of the colocated slice's ref (TComDataCU.cpp:3836)
        if ref_is_lt is not None:
            self.ref_is_lt = ref_is_lt.copy()
        else:
            self.ref_is_lt = np.zeros(frame.ref_idx.shape, bool)

    def compress_motion(self) -> None:
        """TComCUMvField::compress with scale 4: each 16-part group (4x4
        units in z-order) takes the first part's motion.  The z-order-first
        part of a 16-part group is the group's top-left unit."""
        for arr in (self.mv[0], self.mv[1]):
            h, w = arr.shape[:2]
            arr[:, :] = arr[(np.arange(h) & ~3)[:, None],
                            (np.arange(w) & ~3)[None, :]]
        for arr in (self.ref_idx[0], self.ref_idx[1], self.pred_mode):
            h, w = arr.shape[:2]
            arr[:, :] = arr[(np.arange(h) & ~3)[:, None],
                            (np.arange(w) & ~3)[None, :]]
        for lst in range(2):
            h, w = self.ref_poc[lst].shape
            self.ref_poc[lst][:, :] = self.ref_poc[lst][
                (np.arange(h) & ~3)[:, None], (np.arange(w) & ~3)[None, :]]
            self.ref_is_lt[lst][:, :] = self.ref_is_lt[lst][
                (np.arange(h) & ~3)[:, None], (np.arange(w) & ~3)[None, :]]

    def padded(self):
        """Edge-extended planes for MC (extendPicBorder)."""
        if self._pad is None:
            self._pad = (pad_plane(self.rec_y, self.margin),
                         pad_plane(self.rec_cb, self.margin // 2),
                         pad_plane(self.rec_cr, self.margin // 2))
        return self._pad


class Dpb:
    def __init__(self):
        self.pics: list[Picture] = []

    def add(self, pic: Picture) -> None:
        self.pics.append(pic)

    def get(self, poc: int) -> Picture:
        for p in self.pics:
            if p.poc == poc and p.referenced:
                return p
        # xGetRefPic falls back to any pic with the POC
        for p in self.pics:
            if p.poc == poc:
                return p
        raise KeyError(f"reference POC {poc} not in DPB")

    def get_long_term(self, poc: int, bits_for_poc: int) -> Picture:
        """xGetLongTermRefPic (TComSlice.cpp:300): first picture whose POC
        LSB matches; prefer it if long-term, otherwise it still wins (HM
        falls back to the matching short-term picture, or the first DPB
        picture when nothing matches)."""
        mask = (1 << bits_for_poc) - 1
        st_pic = self.pics[0] if self.pics else None
        for p in self.pics:
            if (p.poc & mask) == (poc & mask):
                return p   # HM breaks at the first LSB match either way
        if st_pic is None:
            raise KeyError(f"long-term reference POC {poc} not in DPB")
        return st_pic

    def apply_rps(self, rps, cur_poc: int, bits_for_poc: int = 16) -> None:
        """applyReferencePictureSet (TComSlice.cpp:859): mark pictures not
        in the RPS unused; long-term entries match by full POC when
        check_lt_msb else by POC LSB."""
        mask = (1 << bits_for_poc) - 1
        for p in self.pics:
            in_rps = False
            if rps is not None:
                n_st = rps.num_negative_pics + rps.num_positive_pics
                for i in range(n_st):
                    if not p.is_long_term and \
                            p.poc == cur_poc + rps.delta_poc[i]:
                        in_rps = True
                        p.is_long_term = False
                        p.is_used_as_long_term = False
                for i in range(n_st, n_st + rps.num_longterm_pics):
                    if p.is_long_term and (
                            p.poc == rps.poc[i] if rps.check_lt_msb[i]
                            else (p.poc & mask) == (rps.poc[i] & mask)):
                        in_rps = True
            if p.poc != cur_poc and not in_rps:
                p.referenced = False
                p.is_long_term = False

    def idr_flush(self) -> None:
        for p in self.pics:
            p.referenced = False


def check_all_ref_pics_available(sh, dpb: Dpb, poc_random_access: int,
                                 bits_for_poc: int) -> int:
    """checkThatAllRefPicsAreAvailable (TComSlice.cpp:917).

    Returns lostPoc+1 when a used reference is missing, -2 when only
    unused references were removed, 0 when all are present.  Also performs
    HM's side effect of long-term-marking a short-term picture that
    matches a long-term entry by POC LSB."""
    rps = sh.rps
    if rps is None:
        return 0
    mask = (1 << bits_for_poc) - 1
    lost = removed = 0
    poc_lost = 0
    n_st = rps.num_negative_pics + rps.num_positive_pics
    for i in range(n_st, n_st + rps.num_longterm_pics):
        avail = False
        for p in dpb.pics:
            if p.is_long_term and p.referenced and (
                    p.poc == rps.poc[i] if rps.check_lt_msb[i]
                    else (p.poc & mask) == (rps.poc[i] & mask)):
                avail = True
        if not avail:   # fall back to the short terms (and mark them LT)
            for p in dpb.pics:
                if p.referenced and (p.poc & mask) == \
                        ((sh.poc + rps.delta_poc[i]) & mask):
                    avail = True
                    p.is_long_term = True
                    p.is_used_as_long_term = True
                    break
        if not avail and sh.poc + rps.delta_poc[i] >= poc_random_access:
            if not rps.used[i]:
                removed = 1
            else:
                lost = 1
                poc_lost = sh.poc + rps.delta_poc[i]
    for i in range(n_st):
        avail = any(not p.is_long_term and p.referenced
                    and p.poc == sh.poc + rps.delta_poc[i]
                    for p in dpb.pics)
        if not avail and sh.poc + rps.delta_poc[i] >= poc_random_access:
            if not rps.used[i]:
                removed = 1
            else:
                lost = 1
                poc_lost = sh.poc + rps.delta_poc[i]
    if lost:
        return poc_lost + 1
    return -2 if removed else 0


def build_ref_lists(sh, dpb: Dpb, bits_for_poc: int = 16):
    """setRefPicList (TComSlice.cpp:402) incl. long-term pictures."""
    if sh.is_intra:
        return [], []
    rps = sh.rps
    st_curr0, st_curr1, lt_curr = [], [], []
    n_neg = rps.num_negative_pics
    for i in range(n_neg):
        if rps.used[i]:
            p = dpb.get(sh.poc + rps.delta_poc[i])
            p.is_long_term = False
            p.is_used_as_long_term = False
            p.check_lt_msb = False
            st_curr0.append(p)
    for i in range(n_neg, n_neg + rps.num_positive_pics):
        if rps.used[i]:
            p = dpb.get(sh.poc + rps.delta_poc[i])
            p.is_long_term = False
            p.is_used_as_long_term = False
            p.check_lt_msb = False
            st_curr1.append(p)
    n_st = n_neg + rps.num_positive_pics
    for i in range(n_st + rps.num_longterm_pics - 1, n_st - 1, -1):
        p = dpb.get_long_term(rps.poc[i], bits_for_poc)
        if rps.used[i]:
            p.is_long_term = True
            p.is_used_as_long_term = True
            lt_curr.append(p)
        p.check_lt_msb = bool(rps.check_lt_msb[i])
    num_temp = len(st_curr0) + len(st_curr1) + len(lt_curr)
    n0 = max(num_temp, sh.num_ref_idx[0])
    temp0 = []
    while len(temp0) < n0:
        for p in st_curr0 + st_curr1 + lt_curr:
            if len(temp0) >= n0:
                break
            temp0.append(p)
        if not (st_curr0 or st_curr1 or lt_curr):
            break
    list0 = []
    for idx in range(sh.num_ref_idx[0]):
        if sh.ref_pic_list_modification_flag[0]:
            list0.append(temp0[sh.ref_pic_set_idx[0][idx]])
        else:
            list0.append(temp0[idx])

    list1 = []
    if sh.slice_type == 0:  # B_SLICE
        n1 = max(num_temp, sh.num_ref_idx[1])
        temp1 = []
        while len(temp1) < n1:
            for p in st_curr1 + st_curr0 + lt_curr:
                if len(temp1) >= n1:
                    break
                temp1.append(p)
            if not (st_curr0 or st_curr1 or lt_curr):
                break
        for idx in range(sh.num_ref_idx[1]):
            if sh.ref_pic_list_modification_flag[1]:
                list1.append(temp1[sh.ref_pic_set_idx[1][idx]])
            else:
                list1.append(temp1[idx])
    return list0, list1


def check_ldc(sh, list0, list1) -> bool:
    """TDecTop low-delay check (TDecTop.cpp:540)."""
    if sh.slice_type != 0:
        return False
    for p in list0:
        if p.poc > sh.poc:
            return False
    for p in list1:
        if p.poc > sh.poc:
            return False
    return True


def scale_mv(mv, scale: int):
    """TComMv::scaleMv."""
    x = scale * int(mv[0])
    y = scale * int(mv[1])
    mx = max(-32768, min(32767, (x + 127 + (1 if x < 0 else 0)) >> 8))
    my = max(-32768, min(32767, (y + 127 + (1 if y < 0 else 0)) >> 8))
    return (mx, my)


def dist_scale_factor(cur_poc, cur_ref_poc, col_poc, col_ref_poc) -> int:
    """xGetDistScaleFactor (TComDataCU.cpp:3878)."""
    diff_d = col_poc - col_ref_poc
    diff_b = cur_poc - cur_ref_poc
    if diff_d == diff_b:
        return 4096
    tdb = max(-128, min(127, diff_b))
    tdd = max(-128, min(127, diff_d))
    # iX = (0x4000 + abs(iTDD/2)) / iTDD with C truncating division
    num = 0x4000 + abs(_trunc_div(tdd, 2))
    x = _trunc_div(num, tdd)
    scale = (tdb * x + 32) >> 6
    return max(-4096, min(4095, scale))


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q
