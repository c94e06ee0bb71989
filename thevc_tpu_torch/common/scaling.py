"""Scaling lists (quantization matrices).

Behavioral reference: TComScalingList (TComSlice.cpp:1660-1900 — defaults,
copy/DPCM modes), TDecCavlc::parseScalingList/xDecodeScalingList
(TDecCAVLC.cpp:1866), TEncCavlc::codeScalingList, and the dequant table
construction TComTrQuant::xSetScalingListDec/processScalingListDec
(TComTrQuant.cpp:2852/2979).  TS_FLAT_QUANTIZATION_MATRIX is active: the
4x4 default is flat when the PPS enables transform skip.
"""

from __future__ import annotations

import numpy as np

from . import rom

SCALING_LIST_NUM = (6, 6, 6, 2)        # lists per size
SCALING_LIST_SIZE = (16, 64, 256, 1024)
SCALING_LIST_SIZE_X = (4, 8, 16, 32)
MAX_MATRIX_COEF_NUM = 64
SCALING_LIST_DC = 16
SCALING_LIST_START_VALUE = 8

QUANT_INTRA_DEFAULT_8x8 = np.array([
    16, 16, 16, 16, 17, 18, 21, 24,
    16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29,
    16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47,
    18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88,
    24, 25, 29, 36, 47, 65, 88, 115], np.int32)

QUANT_INTER_DEFAULT_8x8 = np.array([
    16, 16, 16, 16, 17, 18, 20, 24,
    16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28,
    16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41,
    18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71,
    24, 25, 28, 33, 41, 54, 71, 91], np.int32)

QUANT_TS_DEFAULT_4x4 = np.full(16, 16, np.int32)

# scalingListType = (intra ? 0 : 3) + g_eTTable[ttype]; luma=0, cb=1, cr=2
ET_TABLE = (0, 3, 1, 2)


class ScalingList:
    """Raster-order matrices + DC values per (sizeId, listId)."""

    def __init__(self, use_transform_skip: bool = False):
        self.use_ts = use_transform_skip
        self.lists = [[np.zeros(min(MAX_MATRIX_COEF_NUM,
                                    SCALING_LIST_SIZE[s]), np.int32)
                       for _ in range(SCALING_LIST_NUM[s])] for s in range(4)]
        self.dc = [[SCALING_LIST_DC] * SCALING_LIST_NUM[s] for s in range(4)]

    def default_address(self, size_id: int, list_id: int) -> np.ndarray:
        if size_id == 0:
            return QUANT_TS_DEFAULT_4x4 if self.use_ts else \
                _default_4x4(list_id)
        if size_id == 3:
            return QUANT_INTRA_DEFAULT_8x8 if list_id < 1 \
                else QUANT_INTER_DEFAULT_8x8
        return QUANT_INTRA_DEFAULT_8x8 if list_id < 3 \
            else QUANT_INTER_DEFAULT_8x8

    def set_default(self) -> None:
        """setDefaultScalingList: every matrix from the default tables."""
        for s in range(4):
            for l in range(SCALING_LIST_NUM[s]):
                self.lists[s][l][:] = self.default_address(s, l)
                self.dc[s][l] = SCALING_LIST_DC


def _default_4x4(list_id: int) -> np.ndarray:
    # non-TS 4x4 defaults (g_quantIntraDefault4x4/g_quantInterDefault4x4)
    intra = np.array([16, 16, 17, 21, 16, 17, 20, 25, 17, 20, 30, 41,
                      21, 25, 41, 70], np.int32)
    inter = np.array([16, 16, 17, 21, 16, 17, 21, 24, 17, 21, 24, 36,
                      21, 24, 36, 57], np.int32)
    return intra if list_id < 3 else inter


def _scan_for_size(size_id: int) -> np.ndarray:
    if size_id == 0:
        return rom.sig_last_scan(rom.SCAN_DIAG, 4)
    return rom.cg_scan(rom.SCAN_DIAG, 32)


def parse_scaling_list(bs, use_transform_skip: bool) -> ScalingList:
    """TDecCavlc::parseScalingList."""
    sl = ScalingList(use_transform_skip)
    for size_id in range(4):
        for list_id in range(SCALING_LIST_NUM[size_id]):
            if not bs.read_flag():  # copy mode
                delta = bs.read_ue()
                ref_id = list_id - delta
                if size_id > 1:
                    sl.dc[size_id][list_id] = 16 if ref_id == list_id \
                        else sl.dc[size_id][ref_id]
                if ref_id == list_id:
                    sl.lists[size_id][list_id][:] = \
                        sl.default_address(size_id, ref_id)
                else:
                    sl.lists[size_id][list_id][:] = sl.lists[size_id][ref_id]
            else:                   # DPCM mode
                coef_num = min(MAX_MATRIX_COEF_NUM,
                               SCALING_LIST_SIZE[size_id])
                next_coef = SCALING_LIST_START_VALUE
                scan = _scan_for_size(size_id)
                dst = sl.lists[size_id][list_id]
                if size_id > 1:
                    dc = bs.read_se() + 8
                    sl.dc[size_id][list_id] = dc
                    next_coef = dc
                for i in range(coef_num):
                    next_coef = (next_coef + bs.read_se() + 256) % 256
                    dst[int(scan[i])] = next_coef
    return sl


def write_scaling_list(bs, sl: ScalingList) -> None:
    """TEncCavlc::codeScalingList — checkPredMode per list (copy vs DPCM)."""
    for size_id in range(4):
        for list_id in range(SCALING_LIST_NUM[size_id]):
            ref_id = _check_pred_mode(sl, size_id, list_id)
            if ref_id is not None:
                bs.write_flag(False)
                bs.write_ue(list_id - ref_id)
            else:
                bs.write_flag(True)
                coef_num = min(MAX_MATRIX_COEF_NUM,
                               SCALING_LIST_SIZE[size_id])
                scan = _scan_for_size(size_id)
                src = sl.lists[size_id][list_id]
                next_coef = SCALING_LIST_START_VALUE
                if size_id > 1:
                    bs.write_se(sl.dc[size_id][list_id] - 8)
                    next_coef = sl.dc[size_id][list_id]
                for i in range(coef_num):
                    data = int(src[int(scan[i])]) - next_coef
                    next_coef = int(src[int(scan[i])])
                    if data > 127:
                        data -= 256
                    if data < -128:
                        data += 256
                    bs.write_se(data)


def _check_pred_mode(sl: ScalingList, size_id: int, list_id: int):
    """TComScalingList::checkPredMode: earliest usable reference list id
    (the default matrix counts as listId==refId)."""
    for pred_id in range(list_id, -1, -1):
        ref = sl.default_address(size_id, list_id) if pred_id == list_id \
            else sl.lists[size_id][pred_id]
        dc_ok = size_id < 2 or (sl.dc[size_id][list_id]
                                == sl.dc[size_id][pred_id])
        if np.array_equal(sl.lists[size_id][list_id], ref) and dc_ok:
            return pred_id
    return None


SCALE_BITS = 15


def _upsample(coeff: np.ndarray, size_id: int) -> np.ndarray:
    """Replicate the stored (<=8x8) matrix up to the full TU size."""
    width = SCALING_LIST_SIZE_X[size_id]
    ratio = width // min(8, width)
    pat_w = min(8, width)
    j, i = np.mgrid[0:width, 0:width]
    return coeff[(pat_w * (j // ratio) + i // ratio).astype(np.int64)]


class ActiveScaling:
    """Per-(scalingListType, qp rem, sizeId) dequant/quant/err-scale tables.

    Mirrors TComTrQuant::setScalingListDec / setScalingList
    (TComTrQuant.cpp:2740/2773) including the 32x32 aliasing of list
    type 3 (inter luma) onto stored list 1 (TComTrQuant.cpp:3038).
    """

    def __init__(self, sl: ScalingList, bit_increment: int = 0,
                 for_encoder: bool = False):
        self.deq = {}
        self.quant = {}
        self.err = {}
        for size_id in range(4):
            width = SCALING_LIST_SIZE_X[size_id]
            ratio = width // min(8, width)
            log2 = width.bit_length() - 1
            tshift = 15 - (8 + bit_increment) - log2
            types = (0, 3) if size_id == 3 else range(6)
            for lt in types:
                list_id = (0 if lt == 0 else 1) if size_id == 3 else lt
                up = _upsample(sl.lists[size_id][list_id], size_id)
                dc = sl.dc[size_id][list_id]
                for rem in range(6):
                    inv = int(rom.INV_QUANT_SCALES[rem])
                    deq = (inv * up).astype(np.int64)
                    if ratio > 1:
                        deq[0, 0] = inv * dc
                    self.deq[(lt, rem, size_id)] = deq
                    if not for_encoder:
                        continue
                    # encoder tables carry the <<4 (xSetScalingListEnc
                    # passes g_quantScales[qp]<<4); iQBits is unchanged
                    qs = int(rom.QUANT_SCALES[rem]) << 4
                    q = (qs // up).astype(np.int64)
                    if ratio > 1:
                        q[0, 0] = qs // dc
                    self.quant[(lt, rem, size_id)] = q
                    es = (float(1 << SCALE_BITS)
                          * (2.0 ** (-2.0 * tshift))
                          / (1 << (2 * bit_increment)))
                    self.err[(lt, rem, size_id)] = \
                        es / q.astype(np.float64) ** 2

    def tables_for(self, size: int, qp: int, is_intra: bool, comp: int):
        """(deq, quant, err) for a TU.  comp: 0 luma / 1 cb / 2 cr."""
        size_id = size.bit_length() - 3
        lt = (0 if is_intra else 3) + comp if size_id < 3 else \
            (0 if is_intra else 3)
        key = (lt, qp % 6, size_id)
        return (self.deq[key], self.quant.get(key), self.err.get(key))


def list_type(is_intra: bool, comp: int) -> int:
    return (0 if is_intra else 3) + comp


def quant_with_list(coeff: np.ndarray, qmat: np.ndarray, qp_per: int,
                    log2_size: int, is_islice: bool, bit_increment: int):
    """xQuant non-RDOQ scaling-list path (TComTrQuant.cpp:1236-1258).

    Returns (levels int32, delta_u int64) — both (w,w).
    """
    tshift = 15 - (8 + bit_increment) - log2_size
    qbits = 14 + qp_per + tshift
    add = (171 if is_islice else 85) << (qbits - 9)
    c = coeff.astype(np.int64)
    tmp = np.abs(c) * qmat
    level = (tmp + add) >> qbits
    delta_u = (tmp - (level << qbits)) >> (qbits - 8)
    level = np.where(c < 0, -level, level)
    return (np.clip(level, -32768, 32767).astype(np.int32), delta_u)


_MATRIX_TYPE = [
    ["INTRA4X4_LUMA", "INTRA4X4_CHROMAU", "INTRA4X4_CHROMAV",
     "INTER4X4_LUMA", "INTER4X4_CHROMAU", "INTER4X4_CHROMAV"],
    ["INTRA8X8_LUMA", "INTRA8X8_CHROMAU", "INTRA8X8_CHROMAV",
     "INTER8X8_LUMA", "INTER8X8_CHROMAU", "INTER8X8_CHROMAV"],
    ["INTRA16X16_LUMA", "INTRA16X16_CHROMAU", "INTRA16X16_CHROMAV",
     "INTER16X16_LUMA", "INTER16X16_CHROMAU", "INTER16X16_CHROMAV"],
    ["INTRA32X32_LUMA", "INTER32X32_LUMA"],
]
_MATRIX_TYPE_DC = [
    None, None,
    ["INTRA16X16_LUMA_DC", "INTRA16X16_CHROMAU_DC", "INTRA16X16_CHROMAV_DC",
     "INTER16X16_LUMA_DC", "INTER16X16_CHROMAU_DC", "INTER16X16_CHROMAV_DC"],
    ["INTRA32X32_LUMA_DC", "INTER32X32_LUMA_DC"],
]


def parse_scaling_list_file(sl: ScalingList, path: str) -> bool:
    """TComScalingList::xParseScalingList — True means "fall back to
    defaults" (file missing/short), matching the HM return convention."""
    try:
        with open(path, "r") as fp:
            text = fp.read()
    except OSError:
        return True
    lines = text.splitlines()
    for size_id in range(4):
        n = min(MAX_MATRIX_COEF_NUM, SCALING_LIST_SIZE[size_id])
        for list_id in range(SCALING_LIST_NUM[size_id]):
            vals = _scan_file_section(lines, _MATRIX_TYPE[size_id][list_id], n)
            if vals is None:
                return True
            sl.lists[size_id][list_id][:] = vals
            sl.dc[size_id][list_id] = int(vals[0])
            if size_id > 1:
                dc = _scan_file_section(
                    lines, _MATRIX_TYPE_DC[size_id][list_id], 1)
                if dc is None:
                    return True
                sl.dc[size_id][list_id] = int(dc[0])
    return False


def _scan_file_section(lines, tag, count):
    import re
    for idx, line in enumerate(lines):
        if tag in line:
            nums = []
            for fol in lines[idx + 1:]:
                if re.search(r"[A-Za-z]", fol):
                    break           # next section tag: stop (fscanf %d fails)
                nums += [int(x) for x in re.findall(r"-?\d+", fol)]
                if len(nums) >= count:
                    return np.array(nums[:count], np.int64)
            return None
    return None


def check_dc_of_matrix(sl: ScalingList) -> None:
    """TComScalingList::checkDcOfMatrix: a zero DC forces the default."""
    for size_id in range(4):
        for list_id in range(SCALING_LIST_NUM[size_id]):
            if sl.dc[size_id][list_id] == 0:
                sl.lists[size_id][list_id][:] = sl.default_address(
                    size_id, list_id)
                sl.dc[size_id][list_id] = SCALING_LIST_DC


def check_default_scaling_list(sl: ScalingList) -> bool:
    """TComSlice::checkDefaultScalingList: True when any matrix differs
    from the defaults (then the SPS must carry the list data)."""
    count = 0
    for size_id in range(4):
        for list_id in range(SCALING_LIST_NUM[size_id]):
            if (np.array_equal(sl.lists[size_id][list_id],
                               sl.default_address(size_id, list_id))
                    and (size_id < 2 or sl.dc[size_id][list_id] == 16)):
                count += 1
    return count != (6 + 6 + 6 + 2)


def dequant_with_list(qcoeff: np.ndarray, deq: np.ndarray, qp: int,
                      log2_size: int, bit_increment: int) -> np.ndarray:
    """xDeQuant scaling-list branch (TComTrQuant.cpp:1313-1345)."""
    per = qp // 6
    bit_depth = 8 + bit_increment
    tshift = 15 - bit_depth - log2_size
    shift = 20 - 14 - tshift + 4
    if shift > per:
        add = 1 << (shift - per - 1)
        q = np.clip(qcoeff.astype(np.int64), -32768, 32767)
        out = (q * deq + add) >> (shift - per)
    else:
        bit_range = min(15, 12 + log2_size + bit_depth - per)
        limit = 1 << bit_range
        q = np.clip(qcoeff.astype(np.int64), -limit, limit - 1)
        out = (q * deq) << (per - shift)
    return np.clip(out, -32768, 32767).astype(np.int32)
