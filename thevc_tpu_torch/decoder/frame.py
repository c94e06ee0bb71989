"""Frame-level CU data model: flat struct-of-arrays over 4x4 units.

Re-designs TComDataCU (TComDataCU.{h,cpp}) as frame-wide numpy arrays indexed
by *unit raster* coordinates (uy, ux) over the whole picture, rather than
per-CTU pointer-linked objects.  Neighbor derivation (getPULeft/getPUAbove/
getPUAboveLeft/getPUAboveRightAdi/getPUBelowLeftAdi, TComDataCU.cpp:1221+)
reduces to a single rule on the global decode order of 4x4 units:

    unit N is available from current part C iff
      - N is inside the picture, and
      - order(N) < order(C)  where order = ctu_order*parts_per_ctu + z_in_ctu,
      - order(N) >= slice_start(C)  (slice restriction), and
      - tile(N) == tile(C) when crossing CTUs (tile restriction).

This formulation is branch-free and batches trivially on device.
"""

from __future__ import annotations

import numpy as np

from ..common import rom
from ..params import Pps, SliceHeader, Sps

# Prediction modes (TypeDef.h)
MODE_INTER = 0
MODE_INTRA = 1
MODE_NONE = 15

# Partition sizes (TypeDef.h)
SIZE_2Nx2N = 0
SIZE_2NxN = 1
SIZE_Nx2N = 2
SIZE_NxN = 3
SIZE_2NxnU = 4
SIZE_2NxnD = 5
SIZE_nLx2N = 6
SIZE_nRx2N = 7

TEXT_LUMA = 0
TEXT_CHROMA = 1
TEXT_CHROMA_U = 2
TEXT_CHROMA_V = 3

DC_IDX = 1
DM_CHROMA_IDX = 36


class FrameModel:
    """Per-frame decode state: unit-granular syntax arrays + coeff planes."""

    def __init__(self, sps: Sps, pps: Pps):
        self.sps = sps
        self.pps = pps
        self.ctu_size = sps.max_cu_width
        self.max_depth = sps.max_cu_depth           # total depth incl. add
        self.parts_per_ctu = sps.num_partitions     # e.g. 256
        self.part_size = self.ctu_size >> (self.max_depth)  # hmm: see below
        # 4x4 unit geometry: unit side = maxCU >> maxCUDepth ... HM uses
        # MinCUWidth = maxCUWidth >> maxCUDepth; with maxCUDepth=4, 64>>4=4.
        self.unit = self.ctu_size >> self.max_depth
        assert self.unit == 4, "4x4 part granularity expected"
        self.ctus_w = sps.pic_width_in_ctus
        self.ctus_h = sps.pic_height_in_ctus
        self.num_ctus = self.ctus_w * self.ctus_h
        self.units_per_row = self.ctu_size // self.unit   # units per CTU side
        self.frame_units_w = self.ctus_w * self.units_per_row
        self.frame_units_h = self.ctus_h * self.units_per_row
        self.width = sps.pic_width_in_luma_samples
        self.height = sps.pic_height_in_luma_samples

        shape = (self.frame_units_h, self.frame_units_w)
        self.depth = np.zeros(shape, np.int8)
        self.pred_mode = np.full(shape, MODE_NONE, np.int8)
        self.part_size_arr = np.full(shape, SIZE_2Nx2N, np.int8)
        self.skip = np.zeros(shape, bool)
        self.merge_flag = np.zeros(shape, bool)
        self.merge_idx = np.zeros(shape, np.int8)
        self.inter_dir = np.zeros(shape, np.int8)
        self.luma_dir = np.full(shape, DC_IDX, np.int8)
        self.chroma_dir = np.zeros(shape, np.int8)
        self.tr_idx = np.zeros(shape, np.int8)
        self.cbf = np.zeros((3,) + shape, np.uint8)
        self.qp = np.zeros(shape, np.int8)
        self.tq_bypass = np.zeros(shape, bool)
        self.ipcm = np.zeros(shape, bool)
        self.ts_flag = np.zeros((3,) + shape, bool)
        # MVs: [list, uy, ux, (x,y)] and refidx [list, uy, ux]
        self.mv = np.zeros((2,) + shape + (2,), np.int16)
        self.mvd = np.zeros((2,) + shape + (2,), np.int16)
        self.ref_idx = np.full((2,) + shape, -1, np.int8)
        self.mvp_idx = np.zeros((2,) + shape, np.int8)
        # slice bookkeeping: per-unit global-order slice start address
        self.slice_start = np.zeros(shape, np.int64)
        self.dep_slice_start = np.zeros(shape, np.int64)
        self.slice_idx = np.zeros(shape, np.int32)
        self.tile_idx = np.zeros(shape, np.int32)

        # coefficient storage: frame-size planes in TU-raster layout; we
        # store coeffs addressed by (plane, pixel position) like raster
        self.coeff_y = np.zeros((self.frame_units_h * 4, self.frame_units_w * 4), np.int32)
        self.coeff_cb = np.zeros((self.frame_units_h * 2, self.frame_units_w * 2), np.int32)
        self.coeff_cr = np.zeros((self.frame_units_h * 2, self.frame_units_w * 2), np.int32)

        # per-CTU SAO parameters: [comp][ctu] dict-like arrays
        self.sao_type = np.full((3, self.num_ctus), -1, np.int8)
        self.sao_sub_type = np.zeros((3, self.num_ctus), np.int8)
        self.sao_offsets = np.zeros((3, self.num_ctus, 4), np.int32)
        self.sao_merge_left = np.zeros((3, self.num_ctus), bool)
        self.sao_merge_up = np.zeros((3, self.num_ctus), bool)

        # decode-order TU lists built during parse (recon traversal order;
        # includes cbf==0 TUs since prediction always runs):
        # entries: (x, y, size, abs_part, ctu_addr, tr_depth)
        self.luma_tus = []
        self.chroma_tus = []   # x, y, size in chroma samples
        # CU decode order: (px, py, size, pred_mode, luma TU range [l0,l1),
        # chroma TU range [c0,c1)) — drives mixed intra/inter reconstruction
        self.cu_list = []

        # z-order maps for one CTU
        self.z2r = rom.zscan_to_raster(self.max_depth + 1)
        self.r2z = rom.raster_to_zscan(self.max_depth + 1)

        # CTU decode order: raster without tiles; init_tiles installs the
        # tile-scan order (TComPicSym CUOrderMap / InverseCUOrderMap)
        self.ctu_order = np.arange(self.num_ctus, dtype=np.int64)
        self.ctu_inv_order = self.ctu_order.copy()
        self.tiles = None

    def init_tiles(self, tiles) -> None:
        """Install tile geometry (common.tiles.TileInfo) for this picture."""
        self.tiles = tiles
        self.ctu_order = tiles.ctu_order
        self.ctu_inv_order = tiles.inv_order
        upr = self.units_per_row
        tile_per_ctu = tiles.tile_idx_map.reshape(self.ctus_h, self.ctus_w)
        self.tile_idx[:, :] = np.repeat(np.repeat(tile_per_ctu, upr, axis=0),
                                        upr, axis=1)

    # -- coordinate helpers -------------------------------------------------
    def unit_order(self, ux: int, uy: int) -> int:
        """Global decode order of a 4x4 unit ("SCU address")."""
        cx, cy = ux // self.units_per_row, uy // self.units_per_row
        ctu = cy * self.ctus_w + cx
        lx, ly = ux % self.units_per_row, uy % self.units_per_row
        z = int(self.r2z[ly * self.units_per_row + lx])
        return int(self.ctu_inv_order[ctu]) * self.parts_per_ctu + z

    def unit_in_pic(self, ux: int, uy: int) -> bool:
        # units cover the padded CTU grid; picture bound check is in pixels
        return (0 <= ux * self.unit < self.width and
                0 <= uy * self.unit < self.height)

    def available(self, nux: int, nuy: int, cur_ux: int, cur_uy: int) -> bool:
        """Availability of neighbor unit (nux,nuy) from current unit."""
        if not self.unit_in_pic(nux, nuy):
            return False
        n_order = self.unit_order(nux, nuy)
        c_order = self.unit_order(cur_ux, cur_uy)
        if n_order >= c_order:
            return False
        if n_order < int(self.slice_start[cur_uy, cur_ux]):
            return False
        n_ctu = (nuy // self.units_per_row) * self.ctus_w + nux // self.units_per_row
        c_ctu = (cur_uy // self.units_per_row) * self.ctus_w + cur_ux // self.units_per_row
        if n_ctu != c_ctu and self.tile_idx[nuy, nux] != self.tile_idx[cur_uy, cur_ux]:
            return False
        return True

    # -- neighbor attribute access (for context derivation) -----------------
    def left_unit(self, ux: int, uy: int):
        if self.available(ux - 1, uy, ux, uy):
            return ux - 1, uy
        return None

    def above_unit(self, ux: int, uy: int, planar_at_ctu_boundary: bool = False):
        if planar_at_ctu_boundary and (uy % self.units_per_row) == 0:
            return None  # above neighbor in another CTU treated unavailable
        if self.available(ux, uy - 1, ux, uy):
            return ux, uy - 1
        return None

    def ctx_split_flag(self, ux: int, uy: int, depth: int) -> int:
        """getCtxSplitFlag (TComDataCU.cpp:1993)."""
        ctx = 0
        n = self.left_unit(ux, uy)
        if n is not None and self.depth[n[1], n[0]] > depth:
            ctx += 1
        n = self.above_unit(ux, uy)
        if n is not None and self.depth[n[1], n[0]] > depth:
            ctx += 1
        return ctx

    def ctx_skip_flag(self, ux: int, uy: int) -> int:
        """getCtxSkipFlag (TComDataCU.cpp:2064)."""
        ctx = 0
        n = self.left_unit(ux, uy)
        if n is not None and self.skip[n[1], n[0]]:
            ctx += 1
        n = self.above_unit(ux, uy)
        if n is not None and self.skip[n[1], n[0]]:
            ctx += 1
        return ctx

    def intra_mpm(self, ux: int, uy: int) -> list:
        """getIntraDirLumaPredictor (TComDataCU.cpp:1928).

        NB the above neighbor is unavailable across the CTU boundary
        (planarAtLCUBoundary=true in the reference call), and the LEFT
        neighbor — unlike every other derivation in this cut — enforces
        the dependent-slice restriction (getPULeft default arguments at
        TComDataCU.cpp:1936 vs the bDepSliceRestriction carve-outs).
        """
        n = self.left_unit(ux, uy)
        if n is not None and self.unit_order(n[0], n[1]) < \
                int(self.dep_slice_start[uy, ux]):
            n = None
        left_dir = int(self.luma_dir[n[1], n[0]]) if (
            n is not None and self.pred_mode[n[1], n[0]] == MODE_INTRA) else DC_IDX
        n = self.above_unit(ux, uy, planar_at_ctu_boundary=True)
        above_dir = int(self.luma_dir[n[1], n[0]]) if (
            n is not None and self.pred_mode[n[1], n[0]] == MODE_INTRA) else DC_IDX
        if left_dir == above_dir:
            if left_dir > 1:
                return [left_dir, ((left_dir + 29) % 32) + 2,
                        ((left_dir - 1) % 32) + 2]
            return [rom.PLANAR_IDX, DC_IDX, rom.VER_IDX]
        preds = [left_dir, above_dir]
        if left_dir and above_dir:
            preds.append(rom.PLANAR_IDX)
        else:
            preds.append(rom.VER_IDX if (left_dir + above_dir) < 2 else DC_IDX)
        return preds

    def allowed_chroma_dirs(self, ux: int, uy: int) -> list:
        """getAllowedChromaDir (TComDataCU.cpp:1893)."""
        modes = [rom.PLANAR_IDX, rom.VER_IDX, rom.HOR_IDX, DC_IDX, DM_CHROMA_IDX]
        luma = int(self.luma_dir[uy, ux])
        for i in range(4):
            if luma == modes[i]:
                modes[i] = 34
                break
        return modes

    # -- bulk setters over a CU/part region ---------------------------------
    def set_region(self, arr: np.ndarray, ux: int, uy: int, units: int, value) -> None:
        arr[uy:uy + units, ux:ux + units] = value
