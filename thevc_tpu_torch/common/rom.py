"""ROM lookup tables: Z-order maps, coefficient scan orders, QP tables,
transform matrices.

Behavioral reference: TComRom.cpp — initZscanToRaster (:185), initRasterToZscan
(:200), initRasterToPelXY (:262), initSigLastScan (:564), g_quantScales /
g_invQuantScales (:293+), g_aiT4/8/16/32 DCT matrices (:305+),
g_as_DST_MAT_4 (:391), g_aucChromaScale (:371), g_uiMinInGroup/g_uiGroupIdx
(:503-504), Go-Rice tables (:507+).

In the TPU build these become precomputed index tensors: gather/scatter maps
used by batched device kernels, so all of them are numpy int32 arrays.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

# Scan orders (TypeDef.h:564): with REMOVE_ZIGZAG_SCAN, zigzag requests are
# remapped to diag at use sites.
SCAN_ZIGZAG = 0
SCAN_HOR = 1
SCAN_VER = 2
SCAN_DIAG = 3

# Intra mode indices (TypeDef.h:199+)
PLANAR_IDX = 0
DC_IDX = 1
HOR_IDX = 10
VER_IDX = 26
DM_CHROMA_IDX = 36
NUM_INTRA_MODE = 36

# quantization scales (TComRom.cpp:293)
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564], np.int32)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], np.int32)

# chroma QP mapping with CHROMA_QP_EXTENSION (TComRom.cpp:371)
CHROMA_SCALE = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
     17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30, 31, 32,
     33, 33, 34, 34, 35, 35, 36, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44,
     45, 46, 47, 48, 49, 50, 51], np.int32)

# integer DCT basis matrices (partial-butterfly equivalents)
T4 = np.array([
    [64, 64, 64, 64],
    [83, 36, -36, -83],
    [64, -64, -64, 64],
    [36, -83, 83, -36]], np.int64)

T8 = np.array([
    [64, 64, 64, 64, 64, 64, 64, 64],
    [89, 75, 50, 18, -18, -50, -75, -89],
    [83, 36, -36, -83, -83, -36, 36, 83],
    [75, -18, -89, -50, 50, 89, 18, -75],
    [64, -64, -64, 64, 64, -64, -64, 64],
    [50, -89, 18, 75, -75, -18, 89, -50],
    [36, -83, 83, -36, -36, 83, -83, 36],
    [18, -50, 75, -89, 89, -75, 50, -18]], np.int64)


T16 = np.array([
    [64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64],
    [90, 87, 80, 70, 57, 43, 25, 9, -9, -25, -43, -57, -70, -80, -87, -90],
    [89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89],
    [87, 57, 9, -43, -80, -90, -70, -25, 25, 70, 90, 80, 43, -9, -57, -87],
    [83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83],
    [80, 9, -70, -87, -25, 57, 90, 43, -43, -90, -57, 25, 87, 70, -9, -80],
    [75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75],
    [70, -43, -87, 9, 90, 25, -80, -57, 57, 80, -25, -90, -9, 87, 43, -70],
    [64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64],
    [57, -80, -25, 90, -9, -87, 43, 70, -70, -43, 87, 9, -90, 25, 80, -57],
    [50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50],
    [43, -90, 57, 25, -87, 70, 9, -80, 80, -9, -70, 87, -25, -57, 90, -43],
    [36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36],
    [25, -70, 90, -80, 43, 9, -57, 87, -87, 57, -9, -43, 80, -90, 70, -25],
    [18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18],
    [9, -25, 43, -57, 70, -80, 87, -90, 90, -87, 80, -70, 57, -43, 25, -9],
], np.int64)

T32 = np.array([
    [64]*32,
    [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4,
     -4, -13, -22, -31, -38, -46, -54, -61, -67, -73, -78, -82, -85, -88, -90, -90],
    [90, 87, 80, 70, 57, 43, 25, 9, -9, -25, -43, -57, -70, -80, -87, -90,
     -90, -87, -80, -70, -57, -43, -25, -9, 9, 25, 43, 57, 70, 80, 87, 90],
    [90, 82, 67, 46, 22, -4, -31, -54, -73, -85, -90, -88, -78, -61, -38, -13,
     13, 38, 61, 78, 88, 90, 85, 73, 54, 31, 4, -22, -46, -67, -82, -90],
    [89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89,
     89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89],
    [88, 67, 31, -13, -54, -82, -90, -78, -46, -4, 38, 73, 90, 85, 61, 22,
     -22, -61, -85, -90, -73, -38, 4, 46, 78, 90, 82, 54, 13, -31, -67, -88],
    [87, 57, 9, -43, -80, -90, -70, -25, 25, 70, 90, 80, 43, -9, -57, -87,
     -87, -57, -9, 43, 80, 90, 70, 25, -25, -70, -90, -80, -43, 9, 57, 87],
    [85, 46, -13, -67, -90, -73, -22, 38, 82, 88, 54, -4, -61, -90, -78, -31,
     31, 78, 90, 61, 4, -54, -88, -82, -38, 22, 73, 90, 67, 13, -46, -85],
    [83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83,
     83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83],
    [82, 22, -54, -90, -61, 13, 78, 85, 31, -46, -90, -67, 4, 73, 88, 38,
     -38, -88, -73, -4, 67, 90, 46, -31, -85, -78, -13, 61, 90, 54, -22, -82],
    [80, 9, -70, -87, -25, 57, 90, 43, -43, -90, -57, 25, 87, 70, -9, -80,
     -80, -9, 70, 87, 25, -57, -90, -43, 43, 90, 57, -25, -87, -70, 9, 80],
    [78, -4, -82, -73, 13, 85, 67, -22, -88, -61, 31, 90, 54, -38, -90, -46,
     46, 90, 38, -54, -90, -31, 61, 88, 22, -67, -85, -13, 73, 82, 4, -78],
    [75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75,
     75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75],
    [73, -31, -90, -22, 78, 67, -38, -90, -13, 82, 61, -46, -88, -4, 85, 54,
     -54, -85, 4, 88, 46, -61, -82, 13, 90, 38, -67, -78, 22, 90, 31, -73],
    [70, -43, -87, 9, 90, 25, -80, -57, 57, 80, -25, -90, -9, 87, 43, -70,
     -70, 43, 87, -9, -90, -25, 80, 57, -57, -80, 25, 90, 9, -87, -43, 70],
    [67, -54, -78, 38, 85, -22, -90, 4, 90, 13, -88, -31, 82, 46, -73, -61,
     61, 73, -46, -82, 31, 88, -13, -90, -4, 90, 22, -85, -38, 78, 54, -67],
    [64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64,
     64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64],
    [61, -73, -46, 82, 31, -88, -13, 90, -4, -90, 22, 85, -38, -78, 54, 67,
     -67, -54, 78, 38, -85, -22, 90, 4, -90, 13, 88, -31, -82, 46, 73, -61],
    [57, -80, -25, 90, -9, -87, 43, 70, -70, -43, 87, 9, -90, 25, 80, -57,
     -57, 80, 25, -90, 9, 87, -43, -70, 70, 43, -87, -9, 90, -25, -80, 57],
    [54, -85, -4, 88, -46, -61, 82, 13, -90, 38, 67, -78, -22, 90, -31, -73,
     73, 31, -90, 22, 78, -67, -38, 90, -13, -82, 61, 46, -88, 4, 85, -54],
    [50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50,
     50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50],
    [46, -90, 38, 54, -90, 31, 61, -88, 22, 67, -85, 13, 73, -82, 4, 78,
     -78, -4, 82, -73, -13, 85, -67, -22, 88, -61, -31, 90, -54, -38, 90, -46],
    [43, -90, 57, 25, -87, 70, 9, -80, 80, -9, -70, 87, -25, -57, 90, -43,
     -43, 90, -57, -25, 87, -70, -9, 80, -80, 9, 70, -87, 25, 57, -90, 43],
    [38, -88, 73, -4, -67, 90, -46, -31, 85, -78, 13, 61, -90, 54, 22, -82,
     82, -22, -54, 90, -61, -13, 78, -85, 31, 46, -90, 67, 4, -73, 88, -38],
    [36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36,
     36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36],
    [31, -78, 90, -61, 4, 54, -88, 82, -38, -22, 73, -90, 67, -13, -46, 85,
     -85, 46, 13, -67, 90, -73, 22, 38, -82, 88, -54, -4, 61, -90, 78, -31],
    [25, -70, 90, -80, 43, 9, -57, 87, -87, 57, -9, -43, 80, -90, 70, -25,
     -25, 70, -90, 80, -43, -9, 57, -87, 87, -57, 9, 43, -80, 90, -70, 25],
    [22, -61, 85, -90, 73, -38, -4, 46, -78, 90, -82, 54, -13, -31, 67, -88,
     88, -67, 31, 13, -54, 82, -90, 78, -46, 4, 38, -73, 90, -85, 61, -22],
    [18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18,
     18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18],
    [13, -38, 61, -78, 88, -90, 85, -73, 54, -31, 4, 22, -46, 67, -82, 90,
     -90, 82, -67, 46, -22, -4, 31, -54, 73, -85, 90, -88, 78, -61, 38, -13],
    [9, -25, 43, -57, 70, -80, 87, -90, 90, -87, 80, -70, 57, -43, 25, -9,
     -9, 25, -43, 57, -70, 80, -87, 90, -90, 87, -80, 70, -57, 43, -25, 9],
    [4, -13, 22, -31, 38, -46, 54, -61, 67, -73, 78, -82, 85, -88, 90, -90,
     90, -90, 88, -85, 82, -78, 73, -67, 61, -54, 46, -38, 31, -22, 13, -4],
], np.int64)

DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29]], np.int64)

DCT_MATRICES = {4: T4, 8: T8, 16: T16, 32: T32}

# last-significant-coefficient position coding tables (TComRom.cpp:503)
MIN_IN_GROUP = np.array([0, 1, 2, 3, 4, 6, 8, 12, 16, 24], np.int32)
GROUP_IDX = np.array([0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
                      8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9], np.int32)

# Go-Rice adaptation tables (TComRom.cpp:507)
GO_RICE_RANGE = np.array([7, 14, 26, 46, 78], np.int32)
GO_RICE_PREFIX_LEN = np.array([8, 7, 6, 5, 4], np.int32)

# fast intra mode counts (FAST_UDI_USE_MPM, TComRom.cpp:413)
INTRA_MODE_NUM_FAST = np.array([3, 8, 8, 3, 3, 3, 3], np.int32)

# CG scan for 8x8 blocks under hor/ver scans (g_sigLastScan8x8)
SIG_LAST_SCAN_8X8 = np.array([[0, 1, 2, 3], [0, 1, 2, 3],
                              [0, 2, 1, 3], [0, 2, 1, 3]], np.int32)


def convert_to_bit(size: int) -> int:
    """g_aucConvertToBit: log2(size) - 2."""
    return int(size).bit_length() - 3


# ---------------------------------------------------------------------------
# Z-order scan maps
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def zscan_to_raster(max_depth: int) -> np.ndarray:
    """Map z-order part index -> raster part index, for a (2^(d-1))^2 grid."""
    n = 1 << (max_depth - 1)
    out = np.empty(n * n, np.int32)
    idx = [0]

    def rec(depth, start):
        if depth == max_depth:
            out[idx[0]] = start
            idx[0] += 1
        else:
            step = n >> depth
            rec(depth + 1, start)
            rec(depth + 1, start + step)
            rec(depth + 1, start + step * n)
            rec(depth + 1, start + step * n + step)

    rec(1, 0)
    return out


@lru_cache(maxsize=None)
def raster_to_zscan(max_depth: int) -> np.ndarray:
    z2r = zscan_to_raster(max_depth)
    out = np.empty_like(z2r)
    out[z2r] = np.arange(len(z2r), dtype=np.int32)
    return out


@lru_cache(maxsize=None)
def raster_to_pel_xy(max_cu_size: int, max_depth: int):
    min_cu = max_cu_size >> (max_depth - 1)
    n = max_cu_size // min_cu
    xs = np.tile(np.arange(n, dtype=np.int32) * min_cu, n)
    ys = np.repeat(np.arange(n, dtype=np.int32) * min_cu, n)
    return xs, ys


# ---------------------------------------------------------------------------
# Coefficient scan orders (initSigLastScan, TComRom.cpp:564)
# ---------------------------------------------------------------------------

def _diag_scan(width: int) -> np.ndarray:
    """Up-right diagonal scan of a width x width block (row-major indices)."""
    out = np.empty(width * width, np.int32)
    pos = 0
    scan_line = 0
    while pos < width * width:
        prim = scan_line
        scnd = 0
        while prim >= width:
            scnd += 1
            prim -= 1
        while prim >= 0 and scnd < width:
            out[pos] = prim * width + scnd
            pos += 1
            scnd += 1
            prim -= 1
        scan_line += 1
    return out


@lru_cache(maxsize=None)
def sig_last_scan(scan_idx: int, width: int) -> np.ndarray:
    """Coefficient scan order for a width x width TU.

    scan_idx: SCAN_HOR / SCAN_VER / SCAN_DIAG (zigzag is remapped to diag).
    Matches g_auiSigLastScan[scan][log2w-1].
    """
    if scan_idx in (SCAN_ZIGZAG,):
        scan_idx = SCAN_DIAG
    if scan_idx == SCAN_DIAG:
        # NB: only 2x2/4x4 use the plain diagonal scan; 8x8 and larger are
        # built from 4x4 CGs in CG-diagonal order (initSigLastScan: the
        # iWidth==8 "plain" scan is routed into g_sigLastScanCG32x32 and the
        # iWidth>4 branch overwrites the coefficient scan CG-based).
        if width <= 4:
            return _diag_scan(width)
        # built from 4x4 CGs ordered by the diag scan of the CG grid
        nblk = width >> 2
        cg_order = _diag_scan(nblk)
        out = np.empty(width * width, np.int32)
        sub = _diag_scan(4)
        for b, blkpos in enumerate(cg_order):
            oy, ox = divmod(int(blkpos), nblk)
            off = 4 * (ox + oy * width)
            for i, p in enumerate(sub):
                py, px = divmod(int(p), 4)
                out[16 * b + i] = (py * width + px) + off
        return out
    if width <= 2:
        base = np.arange(width * width, np.int32).reshape(width, width)
        return (base if scan_idx == SCAN_HOR else base.T).ravel().astype(np.int32)
    nblk = width >> 2
    out = np.empty(width * width, np.int32)
    cnt = 0
    if scan_idx == SCAN_HOR:
        for by in range(nblk):
            for bx in range(nblk):
                off = by * 4 * width + bx * 4
                for y in range(4):
                    for x in range(4):
                        out[cnt] = y * width + x + off
                        cnt += 1
    else:  # SCAN_VER
        for bx in range(nblk):
            for by in range(nblk):
                off = by * 4 * width + bx * 4
                for x in range(4):
                    for y in range(4):
                        out[cnt] = y * width + x + off
                        cnt += 1
    return out


@lru_cache(maxsize=None)
def cg_scan(scan_idx: int, width: int) -> np.ndarray:
    """Scan order over 4x4 coefficient groups for a width x width TU."""
    nblk = width >> 2
    if scan_idx in (SCAN_ZIGZAG, SCAN_DIAG) or width > 8:
        return _diag_scan(nblk)
    if width == 8:
        return SIG_LAST_SCAN_8X8[scan_idx].copy()
    return np.arange(max(nblk * nblk, 1), dtype=np.int32)


def scan_xy(scan: np.ndarray, width: int):
    """Split a row-major scan table into (x, y) coordinate arrays."""
    return (scan % width).astype(np.int32), (scan // width).astype(np.int32)


def chroma_qp(qp_luma: int) -> int:
    """Luma QP -> chroma QP via g_aucChromaScale (after offset+clip)."""
    return int(CHROMA_SCALE[max(0, min(57, qp_luma))])
