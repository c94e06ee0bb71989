"""Adaptive-QP source preanalysis (TEncPreanalyzer/TEncPic).

Behavioral reference: TEncPreanalyzer.cpp:64 (xPreanalyze: per-AQ-part
activity = 1 + min of the four quadrant variances, layer average) and
TEncCu::xComputeQP (TEncCu.cpp:1113-1137: psycho-visual QP offset from the
normalized activity).  AQ layer d has part size maxCU>>d; the encoder
allocates MaxCuDQPDepth+1 layers (TEncTop.cpp:437-441).
"""

from __future__ import annotations

import math

import numpy as np


class AqLayer:
    def __init__(self, luma: np.ndarray, part: int):
        h, w = luma.shape
        self.part = part
        self.nw = (w + part - 1) // part
        self.nh = (h + part - 1) // part
        self.activity = np.empty((self.nh, self.nw), np.float64)
        for py in range(self.nh):
            for px in range(self.nw):
                blk = luma[py * part:min((py + 1) * part, h),
                           px * part:min((px + 1) * part, w)]
                bh, bw = blk.shape
                hy, hx = bh >> 1, bw >> 1
                # NB the reference divides every quadrant's sums by the
                # TOTAL pixel count of the part (uiNumPixInAQPart is
                # accumulated across all four loops before use,
                # TEncPreanalyzer.cpp:88-93) — reproduce that exactly
                n_total = blk.size
                min_var = float("inf")
                for quad in (blk[:hy, :hx], blk[:hy, hx:],
                             blk[hy:, :hx], blk[hy:, hx:]):
                    q = quad.astype(np.float64)
                    avg = float(q.sum()) / n_total
                    var = float((q * q).sum()) / n_total - avg * avg
                    min_var = min(min_var, var)
                self.activity[py, px] = 1.0 + min_var
        self.avg_activity = float(self.activity.sum()) / (self.nw * self.nh)


def preanalyze(luma: np.ndarray, max_cu: int, max_aq_depth: int):
    """xPreanalyze: one AqLayer per depth 0..max_aq_depth-1."""
    return [AqLayer(luma, max_cu >> d) for d in range(max_aq_depth)]


def compute_qp_offset(layers, depth: int, cu_x: int, cu_y: int,
                      qp_adaptation_range: int) -> int:
    """xComputeQP's offset term (TEncCu.cpp:1117-1136)."""
    d = min(depth, len(layers) - 1)
    lay = layers[d]
    act = float(lay.activity[cu_y // lay.part, cu_x // lay.part])
    avg = lay.avg_activity
    max_q_scale = math.pow(2.0, qp_adaptation_range / 6.0)
    norm = (max_q_scale * act + avg) / (act + max_q_scale * avg)
    return int(math.floor(math.log(norm) / math.log(2.0) * 6.0 + 0.49999))
