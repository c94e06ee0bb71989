"""Merge and AMVP motion-vector candidate derivation over the frame model.

Behavioral reference: TComDataCU.cpp (getInterMergeCandidates :2758,
fillMvpCand :3324, xAddMVPCand :3582, xAddMVPCandOrder :3668, xGetColMVP
:3792, xGetDistScaleFactor :3878, xDeriveCenterIdx :3903, getPartPosition
:3251, isDiffMER :3231, isBipredRestriction :3491, clipMv :3505) and
TDecEntropy::decodePUWise/decodeMVPIdxPU.

The reference's per-corner getPULeft/Above/AboveRight/BelowLeft/AboveLeft
neighbor walk reduces to the frame model's single decode-order availability
rule (FrameModel.available) evaluated at PU-corner units.
"""

from __future__ import annotations

from .refpic import dist_scale_factor, scale_mv

MRG_MAX_NUM_CANDS = 5
AMVP_MAX_NUM_CANDS = 2

# g_auiPUOffset (TComRom.cpp:180), indexed by PartSize
PU_OFFSET = [0, 8, 4, 4, 2, 10, 1, 5]


def pu_geometry(part_size: int, x: int, y: int, size: int, part_idx: int):
    """getPartPosition / getPartIndexAndSize: PU rect in pels."""
    w = h = size
    if part_size == 1:    # 2NxN
        h = size >> 1
        y += 0 if part_idx == 0 else h
    elif part_size == 2:  # Nx2N
        w = size >> 1
        x += 0 if part_idx == 0 else w
    elif part_size == 3:  # NxN
        w = h = size >> 1
        x += (part_idx & 1) * w
        y += (part_idx >> 1) * h
    elif part_size == 4:  # 2NxnU
        h = (size >> 2) if part_idx == 0 else (size >> 2) + (size >> 1)
        y += 0 if part_idx == 0 else size - h
    elif part_size == 5:  # 2NxnD
        h = (size >> 2) + (size >> 1) if part_idx == 0 else (size >> 2)
        y += 0 if part_idx == 0 else size - h
    elif part_size == 6:  # nLx2N
        w = (size >> 2) if part_idx == 0 else (size >> 2) + (size >> 1)
        x += 0 if part_idx == 0 else size - w
    elif part_size == 7:  # nRx2N
        w = (size >> 2) + (size >> 1) if part_idx == 0 else (size >> 2)
        x += 0 if part_idx == 0 else size - w
    return x, y, w, h


def num_pus(part_size: int) -> int:
    return 1 if part_size == 0 else (4 if part_size == 3 else 2)


class MvCtx:
    """Per-slice context for MV derivation."""

    def __init__(self, frame, sh, sps, pps, list0, list1, col_pic,
                 check_ldc: bool):
        self.f = frame
        self.sh = sh
        self.sps = sps
        self.pps = pps
        self.lists = [list0, list1]
        self.ref_pocs = [[p.poc for p in list0], [p.poc for p in list1]]
        # long-term flags at list-construction time (TComDataCU.cpp:3725,3835)
        self.ref_is_lt = [[p.is_long_term for p in list0],
                          [p.is_long_term for p in list1]]
        self.col_pic = col_pic
        self.check_ldc = check_ldc
        self.is_b = sh.slice_type == 0

    # -- neighbor access ---------------------------------------------------
    def _neighbor(self, nux, nuy, cux, cuy):
        """Returns (nux, nuy) if the 4x4 at (nux,nuy) is available from the
        corner unit (cux,cuy) and holds inter data, else None.  Mirrors
        getPULeft/getPUAbove/... with bEnforceSliceRestriction=true."""
        f = self.f
        if not f.available(nux, nuy, cux, cuy):
            return None
        return (nux, nuy)

    def _is_intra(self, n):
        return self.f.pred_mode[n[1], n[0]] != 0  # MODE_INTER == 0

    def _motion(self, n, lst):
        f = self.f
        return (int(f.ref_idx[lst, n[1], n[0]]),
                (int(f.mv[lst, n[1], n[0], 0]), int(f.mv[lst, n[1], n[0], 1])))

    def _inter_dir(self, n):
        return int(self.f.inter_dir[n[1], n[0]])

    def _equal_motion(self, a, b) -> bool:
        """hasEqualMotion."""
        if self._inter_dir(a) != self._inter_dir(b):
            return False
        for lst in range(2):
            ra, mva = self._motion(a, lst)
            rb, mvb = self._motion(b, lst)
            if ra != rb or mva != mvb:
                return False
        return True

    def _remap_above(self, n, corner_uy):
        """getPUAbove/AboveRight/AboveLeft with MotionDataCompresssion=true:
        a neighbor fetched from the CTU row above is addressed through
        g_motionRefer (TComRom::initMotionReferIdx): the above CTU's last
        part row is kept but horizontally decimated 2:1 within each group
        of four units — x1 reads x0, x2 reads x3 — simulating the
        compressed motion line buffer.  Active only when the min CU is 8
        with 4x4 parts (the standard configuration)."""
        if n is None:
            return None
        f = self.f
        if (f.ctu_size >> (f.max_depth - 1)) != 8:
            return n
        nux, nuy = n
        upr = f.units_per_row
        if nuy // upr != corner_uy // upr:
            m = nux & 3
            if m == 1:
                return (nux - 1, nuy)
            if m == 2:
                return (nux + 1, nuy)
        return n

    def _diff_mer(self, xn, yn, xp, yp) -> bool:
        plevel = self.pps.log2_parallel_merge_level_minus2 + 2
        return (xn >> plevel) != (xp >> plevel) or \
            (yn >> plevel) != (yp >> plevel)

    # ==================================================================
    # merge candidates (getInterMergeCandidates)
    # ==================================================================
    def merge_candidates(self, cu_x, cu_y, cu_size, part_size, pu_idx,
                         mrg_cand_idx=-1):
        """Returns (cands, num_valid); cands[i] = (inter_dir,
        (ref0, mv0), (ref1, mv1))."""
        f = self.f
        xp, yp, pw, ph = pu_geometry(part_size, cu_x, cu_y, cu_size, pu_idx)
        # corner units
        u_lb = (xp // 4, (yp + ph - 4) // 4)          # LB corner of PU
        u_rt = ((xp + pw - 4) // 4, yp // 4)          # RT corner
        u_origin = (xp // 4, yp // 4)

        cand_dir = [0] * MRG_MAX_NUM_CANDS
        cand_mv = [[(NOT_VALID_MV), (NOT_VALID_MV)]
                   for _ in range(MRG_MAX_NUM_CANDS)]
        cand_is_inter = [False] * MRG_MAX_NUM_CANDS
        count = 0

        def take(n):
            nonlocal count
            cand_is_inter[count] = True
            cand_dir[count] = self._inter_dir(n)
            cand_mv[count][0] = self._motion(n, 0)
            if self.is_b:
                cand_mv[count][1] = self._motion(n, 1)
            count += 1

        # left (from LB corner); isDiffMER==false nulls the neighbor
        left = self._neighbor(u_lb[0] - 1, u_lb[1], u_lb[0], u_lb[1])
        if left is not None and not self._diff_mer(xp - 1, yp + ph - 1,
                                                   xp, yp):
            left = None
        use_left = not (pu_idx == 1 and part_size in (2, 6, 7))
        if use_left and left is not None and not self._is_intra(left):
            take(left)
            if mrg_cand_idx == count - 1:
                return self._finish(cand_dir, cand_mv, cand_is_inter, count,
                                    early=True)

        # above (from RT corner)
        above = self._neighbor(u_rt[0], u_rt[1] - 1, u_rt[0], u_rt[1])
        above = self._remap_above(above, u_rt[1])
        if above is not None and not self._diff_mer(xp + pw - 1, yp - 1,
                                                    xp, yp):
            above = None
        if above is not None and not self._is_intra(above) \
                and not (pu_idx == 1 and part_size in (1, 4, 5)) \
                and (left is None or self._is_intra(left)
                     or not self._equal_motion(left, above)):
            take(above)
            if mrg_cand_idx == count - 1:
                return self._finish(cand_dir, cand_mv, cand_is_inter, count,
                                    early=True)

        # above right
        ar = self._neighbor(u_rt[0] + 1, u_rt[1] - 1, u_rt[0], u_rt[1])
        ar = self._remap_above(ar, u_rt[1])
        if ar is not None and not self._diff_mer(xp + pw, yp - 1, xp, yp):
            ar = None
        if ar is not None and not self._is_intra(ar) \
                and (above is None or self._is_intra(above)
                     or not self._equal_motion(above, ar)):
            take(ar)
            if mrg_cand_idx == count - 1:
                return self._finish(cand_dir, cand_mv, cand_is_inter, count,
                                    early=True)

        # below left
        bl = self._neighbor(u_lb[0] - 1, u_lb[1] + 1, u_lb[0], u_lb[1])
        if bl is not None and not self._diff_mer(xp - 1, yp + ph, xp, yp):
            bl = None
        if bl is not None and not self._is_intra(bl) \
                and (left is None or self._is_intra(left)
                     or not self._equal_motion(left, bl)):
            take(bl)
            if mrg_cand_idx == count - 1:
                return self._finish(cand_dir, cand_mv, cand_is_inter, count,
                                    early=True)

        # above left (from PU origin)
        if count < 4:
            al = self._neighbor(u_origin[0] - 1, u_origin[1] - 1,
                                u_origin[0], u_origin[1])
            al = self._remap_above(al, u_origin[1])
            if al is not None and not self._diff_mer(xp - 1, yp - 1, xp, yp):
                al = None
            if al is not None and not self._is_intra(al) \
                    and (left is None or self._is_intra(left)
                         or not self._equal_motion(left, al)) \
                    and (above is None or self._is_intra(above)
                         or not self._equal_motion(above, al)):
                take(al)
                if mrg_cand_idx == count - 1:
                    return self._finish(cand_dir, cand_mv, cand_is_inter,
                                        count, early=True)

        # temporal (TMVP)
        if self.sh.tmvp_enabled and self.col_pic is not None:
            got = self._tmvp_merge(xp, yp, pw, ph)
            if got is not None:
                cand_is_inter[count] = True
                cand_dir[count] = got[0]
                cand_mv[count][0] = got[1]
                cand_mv[count][1] = got[2]
                count += 1
                if mrg_cand_idx == count - 1:
                    return self._finish(cand_dir, cand_mv, cand_is_inter,
                                        count, early=True)

        return self._finish(cand_dir, cand_mv, cand_is_inter, count)

    def _finish(self, cand_dir, cand_mv, cand_is_inter, count, early=False):
        if early:
            return cand_dir, cand_mv, count
        array_addr = count
        cutoff = array_addr
        # combined bi-predictive candidates
        if self.is_b:
            pl0 = [0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3]
            pl1 = [1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2]
            for idx in range(cutoff * (cutoff - 1)):
                if array_addr == MRG_MAX_NUM_CANDS:
                    break
                i, j = pl0[idx], pl1[idx]
                if cand_is_inter[i] and cand_is_inter[j] and \
                        (cand_dir[i] & 1) and (cand_dir[j] & 2):
                    cand_is_inter[array_addr] = True
                    cand_dir[array_addr] = 3
                    cand_mv[array_addr][0] = cand_mv[i][0]
                    cand_mv[array_addr][1] = cand_mv[j][1]
                    ref0, mv0 = cand_mv[array_addr][0]
                    ref1, mv1 = cand_mv[array_addr][1]
                    poc0 = self.ref_pocs[0][ref0]
                    poc1 = self.ref_pocs[1][ref1]
                    if poc0 == poc1 and mv0 == mv1:
                        cand_is_inter[array_addr] = False
                    else:
                        array_addr += 1

        num_ref = min(len(self.lists[0]), len(self.lists[1])) if self.is_b \
            else len(self.lists[0])
        r = 0
        refcnt = 0
        while array_addr < MRG_MAX_NUM_CANDS:
            cand_is_inter[array_addr] = True
            cand_dir[array_addr] = 1
            cand_mv[array_addr][0] = (r, (0, 0))
            if self.is_b:
                cand_dir[array_addr] = 3
                cand_mv[array_addr][1] = (r, (0, 0))
            array_addr += 1
            if refcnt == num_ref - 1:
                r = 0
            else:
                r += 1
                refcnt += 1
        num_valid = min(array_addr, self.sh.max_num_merge_cand)
        return cand_dir, cand_mv, num_valid

    # -- colocated MV ------------------------------------------------------
    def _col_units(self, xp, yp, pw, ph):
        """Right-bottom and center colocated unit positions (global units);
        RB is None when invalid (picture edge or CTU-row crossing)."""
        f = self.f
        rb = None
        if xp + pw < f.width and yp + ph < f.height:
            uby = (yp + ph - 4) // 4
            if (uby % f.units_per_row) != f.units_per_row - 1:
                rb = ((xp + pw) // 4, (yp + ph) // 4)
        center = ((xp + (pw >> 1)) // 4, (yp + (ph >> 1)) // 4)
        return rb, center

    def _get_col_mvp(self, ref_list, unit, target_ref_idx):
        """xGetColMVP; returns scaled mv or None."""
        col = self.col_pic
        ux, uy = unit
        if col.pred_mode[uy, ux] != 0:  # intra or not coded
            return None
        col_list = ref_list if self.check_ldc else (1 - self.sh.col_dir)
        col_ref_idx = int(col.ref_idx[col_list, uy, ux])
        if col_ref_idx < 0:
            col_list = 1 - col_list
            col_ref_idx = int(col.ref_idx[col_list, uy, ux])
            if col_ref_idx < 0:
                return None
        col_ref_poc = int(col.ref_poc[col_list, uy, ux])
        col_mv = (int(col.mv[col_list, uy, ux, 0]),
                  int(col.mv[col_list, uy, ux, 1]))
        # either ref long-term => use the colocated MV unscaled
        # (TComDataCU.cpp:3835-3841)
        if self.ref_is_lt[ref_list][target_ref_idx] or \
                bool(col.ref_is_lt[col_list, uy, ux]):
            return col_mv
        cur_poc = self.sh.poc
        cur_ref_poc = self.ref_pocs[ref_list][target_ref_idx]
        scale = dist_scale_factor(cur_poc, cur_ref_poc, col.poc, col_ref_poc)
        if scale == 4096:
            return col_mv
        return scale_mv(col_mv, scale)

    def _tmvp_merge(self, xp, yp, pw, ph):
        rb, center = self._col_units(xp, yp, pw, ph)
        mv0 = None
        if rb is not None:
            mv0 = self._get_col_mvp(0, self._col_addr(rb), 0)
        if mv0 is None:
            mv0 = self._get_col_mvp(0, self._col_addr(center, center=True), 0)
        if mv0 is None:
            return None
        if self.is_b:
            mv1 = None
            if rb is not None:
                mv1 = self._get_col_mvp(1, self._col_addr(rb), 0)
            if mv1 is None:
                mv1 = self._get_col_mvp(1, self._col_addr(center,
                                                          center=True), 0)
            if mv1 is not None:
                return (3, (0, mv0), (0, mv1))
            return (1, (0, mv0), (NOT_VALID_MV))
        return (1, (0, mv0), (NOT_VALID_MV))

    @staticmethod
    def _col_addr(unit, center=False):
        return unit

    # ==================================================================
    # AMVP (fillMvpCand)
    # ==================================================================
    def amvp_candidates(self, cu_x, cu_y, cu_size, part_size, pu_idx,
                        ref_list, ref_idx):
        cands = []
        if ref_idx < 0:
            return cands
        f = self.f
        xp, yp, pw, ph = pu_geometry(part_size, cu_x, cu_y, cu_size, pu_idx)
        u_lb = (xp // 4, (yp + ph - 4) // 4)
        u_rt = ((xp + pw - 4) // 4, yp // 4)
        u_lt = (xp // 4, yp // 4)

        bl = self._neighbor(u_lb[0] - 1, u_lb[1] + 1, u_lb[0], u_lb[1])
        left = self._neighbor(u_lb[0] - 1, u_lb[1], u_lb[0], u_lb[1])
        added_smvp = (bl is not None and not self._is_intra(bl)) or \
            (left is not None and not self._is_intra(left))

        # left predictor
        added = self._add_mvp_cand(cands, bl, ref_list, ref_idx, 3)
        if not added:
            added = self._add_mvp_cand(cands, left, ref_list, ref_idx, 0)
        if not added:
            added = self._add_mvp_cand_order(cands, bl, ref_list, ref_idx, 3)
            if not added:
                self._add_mvp_cand_order(cands, left, ref_list, ref_idx, 0)

        # above predictor
        ar = self._remap_above(
            self._neighbor(u_rt[0] + 1, u_rt[1] - 1, u_rt[0], u_rt[1]),
            u_rt[1])
        above = self._remap_above(
            self._neighbor(u_rt[0], u_rt[1] - 1, u_rt[0], u_rt[1]), u_rt[1])
        al = self._remap_above(
            self._neighbor(u_lt[0] - 1, u_lt[1] - 1, u_lt[0], u_lt[1]),
            u_lt[1])
        added = self._add_mvp_cand(cands, ar, ref_list, ref_idx, 2)
        if not added:
            added = self._add_mvp_cand(cands, above, ref_list, ref_idx, 1)
        if not added:
            added = self._add_mvp_cand(cands, al, ref_list, ref_idx, 4)
        if TMVPDBG:
            c0 = cands[0] if len(cands) > 0 else (0, 0)
            c1 = cands[1] if len(cands) > 1 else (0, 0)
            TMVPDBG.write("SP1 n=%d smvp=%d x=%d y=%d c0=%d,%d c1=%d,%d\n"
                          % (len(cands), int(added_smvp), xp, yp,
                             c0[0], c0[1], c1[0], c1[1]))
        added = added_smvp
        if len(cands) == 2:
            added = True
        if not added:
            added = self._add_mvp_cand_order(cands, ar, ref_list, ref_idx,
                                             2)
            if not added:
                added = self._add_mvp_cand_order(cands, above, ref_list,
                                                 ref_idx, 1)
            if not added:
                self._add_mvp_cand_order(cands, al, ref_list, ref_idx, 4)
        if TMVPDBG:
            TMVPDBG.write("SP2 n=%d\n" % len(cands))

        if len(cands) == 2 and cands[0] == cands[1]:
            cands.pop()

        if self.sh.tmvp_enabled and self.col_pic is not None:
            rb, center = self._col_units(xp, yp, pw, ph)
            got = None
            used_rb = False
            if rb is not None:
                got = self._get_col_mvp(ref_list, rb, ref_idx)
                used_rb = got is not None
            if got is None:
                got = self._get_col_mvp(ref_list, center, ref_idx)
            if TMVPDBG:
                TMVPDBG.write("ATMVP lcu=%d addr=%d rb=%d c=%d mv=%d,%d\n" %
                              (-1 if rb is None else 0, 0,
                               1 if used_rb else 0,
                               1 if (got is not None and not used_rb) else 0,
                               got[0] if got else 0, got[1] if got else 0))
            if got is not None:
                cands.append(got)

        del cands[AMVP_MAX_NUM_CANDS:]
        while len(cands) < AMVP_MAX_NUM_CANDS:
            cands.append((0, 0))
        return cands

    def _add_mvp_cand(self, cands, n, ref_list, ref_idx, dbgdir=-1) -> bool:
        """xAddMVPCand: same ref (this list), else same POC in other list."""
        if TMVPDBG:
            TMVPDBG.write("SCAN c dir=%d null=%d ref=%d\n" % (
                dbgdir, 1 if n is None else 0,
                -9 if n is None else self._motion(n, ref_list)[0]))
        if n is None:
            return False
        nref, nmv = self._motion(n, ref_list)
        if nref >= 0 and ref_idx >= 0 and \
                self.ref_pocs[ref_list][nref] == self.ref_pocs[ref_list][ref_idx]:
            cands.append(nmv)
            return True
        other = 1 - ref_list
        cur_ref_poc = self.ref_pocs[ref_list][ref_idx]
        oref, omv = self._motion(n, other)
        if oref >= 0 and self.ref_pocs[other][oref] == cur_ref_poc:
            cands.append(omv)
            return True
        return False

    def _add_mvp_cand_order(self, cands, n, ref_list, ref_idx,
                            dbgdir=-1) -> bool:
        """xAddMVPCandOrder: same-list then cross-list with POC scaling."""
        if n is None:
            return False
        if TMVPDBG:
            TMVPDBG.write("SCAN o dir=%d ref=%d\n" % (
                dbgdir, self._motion(n, ref_list)[0]))
        cur_poc = self.sh.poc
        cur_ref_poc = self.ref_pocs[ref_list][ref_idx]
        for lst in (ref_list, 1 - ref_list):
            nref, nmv = self._motion(n, lst)
            if nref >= 0:
                # either ref long-term => candidate used unscaled
                # (TComDataCU.cpp:3725-3738)
                if self.ref_is_lt[ref_list][ref_idx] or \
                        self.ref_is_lt[lst][nref]:
                    cands.append(nmv)
                    return True
                neib_ref_poc = self.ref_pocs[lst][nref]
                scale = dist_scale_factor(cur_poc, cur_ref_poc,
                                          cur_poc, neib_ref_poc)
                cands.append(nmv if scale == 4096 else scale_mv(nmv, scale))
                return True
        return False


NOT_VALID_MV = (-1, (0, 0))
TMVPDBG = None


def clip_mv(mv, cu_x, cu_y, pic_w, pic_h, ctu_size):
    """TComDataCU::clipMv."""
    shift, off = 2, 8
    hor_max = (pic_w + off - cu_x - 1) << shift
    hor_min = (-ctu_size - off - cu_x + 1) << shift
    ver_max = (pic_h + off - cu_y - 1) << shift
    ver_min = (-ctu_size - off - cu_y + 1) << shift
    return (min(hor_max, max(hor_min, mv[0])),
            min(ver_max, max(ver_min, mv[1])))
