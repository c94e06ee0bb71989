"""RD cost model: lambda derivation, cost combination, distortion metrics.

Behavioral reference: TComRdCost.cpp (setLambda :167, calcRdCost :59,
getDistPart :450 with WEIGHTED_CHROMA_DISTORTION, xGetSSE :1314,
xCalcHADs4x4 :1684, xCalcHADs8x8 :1778, xGetHADs :2186) and
TEncSlice::initEncSlice lambda formula (TEncSlice.cpp:256-340).

SSE and SATD are expressed batched (ops.jx mirrors them for device).
"""

from __future__ import annotations

import math

import numpy as np

from ..common.rom import CHROMA_SCALE


class RdCost:
    def __init__(self, bit_increment: int = 0) -> None:
        self.lambda_ = 0.0
        self.sqrt_lambda = 0.0
        self.lambda_motion_sad = 0
        self.lambda_motion_sse = 0
        self.chroma_distortion_weight = 1.0
        self.frame_lambda = 0.0
        self.bit_increment = bit_increment  # g_uiBitIncrement (IBDI)

    def set_lambda(self, lam: float) -> None:
        self.lambda_ = lam
        self.sqrt_lambda = math.sqrt(lam)
        self.lambda_motion_sad = int(math.floor(65536.0 * self.sqrt_lambda))
        self.lambda_motion_sse = int(math.floor(65536.0 * lam))

    def calc_rd_cost(self, bits: int, distortion: int, flag: bool = False) -> float:
        """calcRdCost with DF_DEFAULT."""
        if flag:
            return float(distortion) + float(bits) * self.lambda_
        cost = float(distortion) + float(int(bits * self.lambda_ + 0.5))
        return float(math.floor(cost))

    def dist_part(self, cur: np.ndarray, org: np.ndarray,
                  weighted: bool = False) -> int:
        """getDistPart with DF_SSE (IBDI_DISTORTION=0 build): per-sample
        (d*d) >> (2*bitIncrement), then sum (TComRdCost.cpp:1314)."""
        d = org.astype(np.int64) - cur.astype(np.int64)
        sq = d * d
        if self.bit_increment:
            sq >>= self.bit_increment << 1
        sse = int(np.sum(sq))
        if weighted:
            return int(self.chroma_distortion_weight * sse)
        return sse


def slice_lambda_and_qp(qp_cfg: float, slice_type_is_intra: bool,
                        gop_size: int, qp_factor: float, depth: int,
                        use_had_me: bool, qp_bd_offset_y: int):
    """initEncSlice lambda computation (I/all-intra path)."""
    num_b_frames = gop_size - 1
    shift_qp = 12
    lambda_scale = 1.0 - max(0.0, min(0.5, 0.05 * num_b_frames))
    qp_temp = float(qp_cfg) - shift_qp
    factor = 0.57 * lambda_scale if slice_type_is_intra else qp_factor
    lam = factor * math.pow(2.0, qp_temp / 3.0)
    if depth > 0:
        lam *= max(2.0, min(4.0, qp_temp / 6.0))
    if not use_had_me:
        lam *= 0.95
    iqp = max(-qp_bd_offset_y, min(51, int(math.floor(qp_cfg + 0.5))))
    return lam, iqp


def chroma_weight(iqp: int) -> float:
    """WEIGHTED_CHROMA_DISTORTION weight = 2^((QP - chromaQP)/3)."""
    if iqp >= 0:
        return math.pow(2.0, (iqp - int(CHROMA_SCALE[iqp])) / 3.0)
    return 1.0


# ---------------------------------------------------------------------------
# Hadamard SATD (batched)
# ---------------------------------------------------------------------------

_H4 = np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1], [1, -1, -1, 1]],
               np.int64)


def _h8():
    h4 = _H4
    top = np.concatenate([np.concatenate([h4, h4], 1),
                          np.concatenate([h4, -h4], 1)], 0)
    return top


_H8 = _h8()


def _had_matrix_equiv_4(d: np.ndarray) -> np.ndarray:
    """|H4 D H4| absolute sum per block, [N,4,4] -> [N]."""
    m = np.einsum("ij,bjk,kl->bil", _H4, d, _H4)
    return np.sum(np.abs(m), axis=(1, 2))


def _had_matrix_equiv_8(d: np.ndarray) -> np.ndarray:
    m = np.einsum("ij,bjk,kl->bil", _H8, d, _H8)
    return np.sum(np.abs(m), axis=(1, 2))


def calc_had(org: np.ndarray, cur: np.ndarray, bit_increment: int = 0) -> int:
    """xGetHADs over one block (width==height in {4,8,16,32,64}).

    The reference's butterfly is a sequency-ordered Hadamard; row ordering
    is a permutation of the matrix-product form, so the absolute-value sums
    are identical (verified in tests against a literal butterfly port).
    """
    h, w = org.shape
    d = org.astype(np.int64) - cur.astype(np.int64)
    if h % 8 == 0 and w % 8 == 0:
        blocks = (d.reshape(h // 8, 8, w // 8, 8)
                   .transpose(0, 2, 1, 3).reshape(-1, 8, 8))
        sads = (_had_matrix_equiv_8(blocks) + 2) >> 2
        return int(sads.sum()) >> bit_increment
    if h % 4 == 0 and w % 4 == 0:
        blocks = (d.reshape(h // 4, 4, w // 4, 4)
                   .transpose(0, 2, 1, 3).reshape(-1, 4, 4))
        sads = (_had_matrix_equiv_4(blocks) + 1) >> 1
        return int(sads.sum()) >> bit_increment
    raise ValueError("unsupported HAD size")


def calc_had_batched(org: np.ndarray, cur: np.ndarray,
                     bit_increment: int = 0) -> np.ndarray:
    """Batched SATD for the 35-mode sweep: [M, s, s] preds vs one org."""
    m, h, w = cur.shape
    d = org[None].astype(np.int64) - cur.astype(np.int64)
    if h % 8 == 0:
        blocks = (d.reshape(m, h // 8, 8, w // 8, 8)
                   .transpose(0, 1, 3, 2, 4).reshape(m, -1, 8, 8))
        hm = np.einsum("ij,mbjk,kl->mbil", _H8, blocks, _H8)
        sads = (np.sum(np.abs(hm), axis=(2, 3)) + 2) >> 2
        return sads.sum(axis=1) >> bit_increment
    blocks = (d.reshape(m, h // 4, 4, w // 4, 4)
               .transpose(0, 1, 3, 2, 4).reshape(m, -1, 4, 4))
    hm = np.einsum("ij,mbjk,kl->mbil", _H4, blocks, _H4)
    sads = (np.sum(np.abs(hm), axis=(2, 3)) + 1) >> 1
    return sads.sum(axis=1) >> bit_increment
