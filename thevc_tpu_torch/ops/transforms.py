"""Integer DCT/DST transforms, quantization, dequantization — batched.

Behavioral reference: TComTrQuant.cpp — partialButterfly4/8/16/32 (:417+),
fastForwardDst/fastInverseDst (:443,:462), xTrMxN (:803), xITrMxN (:892),
xQuant (:1102), xDeQuant (:1272), xTransformSkip/xITransformSkip (:1622,:1667),
shift constants from TComRom.h:100-106 (QUANT_SHIFT=14, QUANT_IQUANT_SHIFT=20,
SHIFT_INV_1ST=7, SHIFT_INV_2ND=12, MAX_TR_DYNAMIC_RANGE=15).

All functions are batched over a leading axis [N, size, size] — this is the
shape that maps onto the TPU MXU (transforms are matmuls against constant
basis matrices).  The numpy path is the bit-exact reference; ops/jx mirrors
it in JAX for device execution.
"""

from __future__ import annotations

import numpy as np

from ..common.rom import DCT_MATRICES, DST4, INV_QUANT_SCALES, QUANT_SCALES

MAX_TR_DYNAMIC_RANGE = 15
QUANT_SHIFT = 14
QUANT_IQUANT_SHIFT = 20
SHIFT_INV_1ST = 7
SHIFT_INV_2ND = 12


def _fwd_pass(x: np.ndarray, t: np.ndarray, shift: int) -> np.ndarray:
    """One forward butterfly pass: [N, line, size] -> [N, size, line].

    out[k, j] = (sum_n T[k, n] * x[j, n] + add) >> shift
    (partialButterflyN semantics: transforms each row, stores transposed.)

    Computed in float64 BLAS: |sum| <= 32 * 2^16 * 90 << 2^53, so the
    matmul is exact; floor((v + add) / 2^shift) equals the arithmetic
    shift for integer-valued v.
    """
    add = 1 << (shift - 1)
    y = (np.einsum("kn,bjn->bkj", t, x.astype(np.int64)) + add) >> shift
    return y


def _inv_pass(s: np.ndarray, t: np.ndarray, shift: int) -> np.ndarray:
    """One inverse butterfly pass: [N, size, line] -> [N, line, size].

    out[j, k] = clip((sum_n T[n, k] * s[n, j] + add) >> shift)

    float64 BLAS; exactness as in _fwd_pass (inputs are int16-clipped).
    """
    add = 1 << (shift - 1)
    y = (np.einsum("nk,bnj->bjk", t, s.astype(np.int64)) + add) >> shift
    return np.clip(y, -32768, 32767)


def forward_transform(block: np.ndarray, use_dst: bool, bit_increment: int = 0) -> np.ndarray:
    """Forward 2D transform of [N, size, size] int residual blocks.

    use_dst selects the 4x4 DST (luma intra TUs, INTRA_TRANS_SIMP).
    Matches xTrMxN: shift1 = log2(size) - 1 + bitInc, shift2 = log2(size) + 6.
    """
    size = block.shape[-1]
    log2 = size.bit_length() - 1
    shift1 = log2 - 1 + bit_increment
    shift2 = log2 + 6
    t = DST4 if (use_dst and size == 4) else DCT_MATRICES[size]
    tmp = _fwd_pass(block, t, shift1)
    # intermediate is stored in int16 in the reference; value range fits
    return _fwd_pass(tmp, t, shift2).astype(np.int32)


def inverse_transform(coeff: np.ndarray, use_dst: bool, bit_increment: int = 0) -> np.ndarray:
    """Inverse 2D transform of [N, size, size] coeff blocks -> residual int16.

    Matches xITrMxN: shift1 = 7, shift2 = 12 - bitInc; int16 clipping after
    each pass.
    """
    size = coeff.shape[-1]
    shift1 = SHIFT_INV_1ST
    shift2 = SHIFT_INV_2ND - bit_increment
    t = DST4 if (use_dst and size == 4) else DCT_MATRICES[size]
    tmp = _inv_pass(coeff, t, shift1)
    return _inv_pass(tmp, t, shift2).astype(np.int16)


def transform_skip_fwd(block: np.ndarray, bit_increment: int = 0) -> np.ndarray:
    """xTransformSkip (4x4 only in practice)."""
    size = block.shape[-1]
    log2 = size.bit_length() - 1
    shift = MAX_TR_DYNAMIC_RANGE - (8 + bit_increment) - log2
    x = block.astype(np.int32)
    if shift >= 0:
        return x << shift
    off = 1 << (-shift - 1)
    return (x + off) >> (-shift)


def transform_skip_inv(coeff: np.ndarray, bit_increment: int = 0) -> np.ndarray:
    """xITransformSkip."""
    size = coeff.shape[-1]
    log2 = size.bit_length() - 1
    shift = MAX_TR_DYNAMIC_RANGE - (8 + bit_increment) - log2
    x = coeff.astype(np.int32)
    if shift > 0:
        off = 1 << (shift - 1)
        return ((x + off) >> shift).astype(np.int16)
    return (x << (-shift)).astype(np.int16)


def qp_scaled(qp: int, is_luma: bool, qp_bd_offset: int, chroma_qp_offset: int = 0) -> int:
    """TComTrQuant::setQPforQuant — scaled QP incl. chroma mapping."""
    from ..common.rom import CHROMA_SCALE
    if is_luma:
        return qp + qp_bd_offset
    q = min(57, max(-qp_bd_offset, qp + chroma_qp_offset))
    if q < 0:
        return q + qp_bd_offset
    return int(CHROMA_SCALE[q]) + qp_bd_offset


def dequant(qcoeff: np.ndarray, qp, bit_increment: int = 0) -> np.ndarray:
    """xDeQuant without scaling lists: [N, size, size] -> int32 coeffs.

    qp is the *scaled* QP (after qp_scaled); a scalar or an [N] vector
    (per-TU QPs in the batched decode path).  shift = 6 - transformShift.
    """
    size = qcoeff.shape[-1]
    log2 = size.bit_length() - 1
    transform_shift = MAX_TR_DYNAMIC_RANGE - (8 + bit_increment) - log2
    shift = QUANT_IQUANT_SHIFT - QUANT_SHIFT - transform_shift
    add = 1 << (shift - 1)
    if np.isscalar(qp) or getattr(qp, "ndim", 0) == 0:
        scale = int(INV_QUANT_SCALES[int(qp) % 6]) << (int(qp) // 6)
    else:
        qp = np.asarray(qp, np.int64)
        scale = (INV_QUANT_SCALES[qp % 6].astype(np.int64)
                 << (qp // 6))[:, None, None]
    q = np.clip(qcoeff, -32768, 32767).astype(np.int64)
    out = (q * scale + add) >> shift
    return np.clip(out, -32768, 32767).astype(np.int32)


def quant(coeff: np.ndarray, qp: int, is_intra_slice: bool,
          bit_increment: int = 0, qp_base: int | None = None):
    """Non-RDOQ quantization (xQuant scalar path, flat matrix).

    Returns (levels int32 [N,s,s], delta_u int32 [N,s,s]) — delta_u feeds
    sign-bit hiding.  qp is the scaled QP.  qp_base: scaled slice base QP —
    under ADAPTIVE_QP_SELECTION (compiled into the reference) the shift
    uses the slice base QP's per while the scale table uses the CU QP's
    rem (TComTrQuant.cpp:1162-1232); they only differ when per-CU QPs are
    active (AdaptiveQP / LCU rate control).
    """
    size = coeff.shape[-1]
    log2 = size.bit_length() - 1
    per, rem = qp // 6, qp % 6
    if qp_base is not None:
        per = qp_base // 6
    transform_shift = MAX_TR_DYNAMIC_RANGE - (8 + bit_increment) - log2
    qbits = QUANT_SHIFT + per + transform_shift
    add = (171 if is_intra_slice else 85) << (qbits - 9)
    qscale = int(QUANT_SCALES[rem])
    c = coeff.astype(np.int64)
    tmp = np.abs(c) * qscale
    level = (tmp + add) >> qbits
    # ADAPTIVE_QP_SELECTION path (active in the reference build):
    # deltaU = (|orig|*Q - (level<<qbits)) >> (qbits-8)
    delta_u = (tmp - (level << qbits)) >> (qbits - 8)
    level = np.clip(np.sign(c) * level, -32768, 32767).astype(np.int32)
    return level, delta_u.astype(np.int32)
