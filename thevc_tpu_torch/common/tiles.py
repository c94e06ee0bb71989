"""Tile geometry: CTU->tile map and the tile-scan CTU coding order.

Behavioral reference: TComPicSym::xInitTiles / xCalculateNxtCUAddr
(TComPicSym.cpp), tile width/height derivation from the PPS
(TDecTop.cpp:420-500 uniform/explicit spacing), CU order map generation
(TDecTop.cpp "generate the Coding Order Map").
"""

from __future__ import annotations

import numpy as np


class TileInfo:
    """Per-picture tile structure.

    Attributes:
      n_cols, n_rows: tile grid dimensions.
      col_width, row_height: per-column/row sizes in CTUs.
      tile_idx_map: [num_ctus] raster CTU -> tile index.
      ctu_order: [num_ctus] encode order -> raster CTU address.
      inv_order: [num_ctus] raster CTU address -> encode order.
      first_cu, right_edge, bottom_edge, widths, heights: per-tile, in CTUs
      (raster columns/rows for the edges, mirroring TComTile).
    """

    def __init__(self, ctus_w: int, ctus_h: int, pps=None):
        num_ctus = ctus_w * ctus_h
        self.ctus_w, self.ctus_h = ctus_w, ctus_h
        if pps is not None and pps.tiles_or_entropy_coding_sync_idc == 1:
            n_cols = pps.num_tile_columns_minus1 + 1
            n_rows = pps.num_tile_rows_minus1 + 1
            uniform = pps.uniform_spacing_flag
            explicit_w = getattr(pps, "column_widths", []) or []
            explicit_h = getattr(pps, "row_heights", []) or []
        else:
            n_cols = n_rows = 1
            uniform = True
            explicit_w = explicit_h = []
        self.n_cols, self.n_rows = n_cols, n_rows

        if uniform:
            col_width = [(p + 1) * ctus_w // n_cols - p * ctus_w // n_cols
                         for p in range(n_cols)]
            row_height = [(p + 1) * ctus_h // n_rows - p * ctus_h // n_rows
                          for p in range(n_rows)]
        else:
            col_width = list(explicit_w) + [ctus_w - sum(explicit_w)]
            row_height = list(explicit_h) + [ctus_h - sum(explicit_h)]
        self.col_width, self.row_height = col_width, row_height

        n_tiles = n_cols * n_rows
        self.right_edge = np.zeros(n_tiles, np.int32)
        self.bottom_edge = np.zeros(n_tiles, np.int32)
        self.first_cu = np.zeros(n_tiles, np.int32)
        self.widths = np.zeros(n_tiles, np.int32)
        self.heights = np.zeros(n_tiles, np.int32)
        for r in range(n_rows):
            for c in range(n_cols):
                t = r * n_cols + c
                self.widths[t] = col_width[c]
                self.heights[t] = row_height[r]
                self.right_edge[t] = sum(col_width[:c + 1]) - 1
                self.bottom_edge[t] = sum(row_height[:r + 1]) - 1
                self.first_cu[t] = ((self.bottom_edge[t] - row_height[r] + 1)
                                    * ctus_w
                                    + self.right_edge[t] - col_width[c] + 1)

        # tile index per raster CTU
        self.tile_idx_map = np.zeros(num_ctus, np.int32)
        col_of_x = np.zeros(ctus_w, np.int32)
        x = 0
        for c, w in enumerate(col_width):
            col_of_x[x:x + w] = c
            x += w
        row_of_y = np.zeros(ctus_h, np.int32)
        y = 0
        for r, h in enumerate(row_height):
            row_of_y[y:y + h] = r
            y += h
        for i in range(num_ctus):
            self.tile_idx_map[i] = (row_of_y[i // ctus_w] * n_cols
                                    + col_of_x[i % ctus_w])

        # encode-order maps (xCalculateNxtCUAddr walk)
        self.ctu_order = np.zeros(num_ctus, np.int64)
        self.inv_order = np.zeros(num_ctus, np.int64)
        addr = 0
        for enc in range(num_ctus):
            self.ctu_order[enc] = addr
            self.inv_order[addr] = enc
            addr = self._next_addr(addr)
        assert addr == num_ctus

    def _next_addr(self, addr: int) -> int:
        """xCalculateNxtCUAddr (TComPicSym.cpp)."""
        t = int(self.tile_idx_map[addr])
        w = self.ctus_w
        at_right = addr % w == self.right_edge[t]
        at_bottom = addr // w == self.bottom_edge[t]
        if at_right and at_bottom:
            if t == self.n_cols * self.n_rows - 1:
                return self.ctus_w * self.ctus_h
            return int(self.first_cu[t + 1])
        if at_right:
            return addr + w - int(self.widths[t]) + 1
        return addr + 1
