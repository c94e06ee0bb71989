"""Decoder stage 1 in PyTorch: dequant + inverse DCT/DST over TU batches.

Counterpart of the decoder half of ``thevc_tpu/ops/jx.py``: ``dequant``
(:95), ``inverse_transform`` (:78), ``residual_pipeline`` (:147),
``_unpack_cgs`` (:167) and ``residual_pipeline_packed`` (:184).

``residual_pipeline`` dispatches on the device of its input: a CUDA
tensor goes through the hand-written kernel (``ops.residual_kernel``), a
CPU tensor through the plain version below.  The plain version does the
two transform passes as float64 products, which are exact here: every
product and partial sum is below 32 * 90 * 2^15 < 2^53.  It runs on the
card too (torch has no int32 matrix product on CUDA), and the tests and
``chip_smoke.py`` hold the kernel against it there.
"""

from __future__ import annotations

import torch

from thevc_tpu.ops.transforms import (MAX_TR_DYNAMIC_RANGE, QUANT_IQUANT_SHIFT,
                                      QUANT_SHIFT, SHIFT_INV_1ST,
                                      SHIFT_INV_2ND)

from ..common.tables import from_reference
from . import residual_kernel


def dequant_shift(size: int, bit_increment: int) -> int:
    """xDeQuant's right shift for one TU size class (flat scaling)."""
    log2 = size.bit_length() - 1
    transform_shift = MAX_TR_DYNAMIC_RANGE - (8 + bit_increment) - log2
    return QUANT_IQUANT_SHIFT - QUANT_SHIFT - transform_shift


def dequant_scale(qp: torch.Tensor) -> torch.Tensor:
    """Per-TU dequant scale ``INV_QUANT_SCALES[qp % 6] << (qp // 6)``
    (int32 [N]) for scaled QPs [N]."""
    qp = qp.to(torch.int32)
    scales = from_reference(qp.device).inv_quant_scales
    return (scales[(qp % 6).long()] << (qp // 6)).to(torch.int32)


def dequant(qcoeff: torch.Tensor, qp: torch.Tensor,
            bit_increment: int = 0) -> torch.Tensor:
    """Batched dequant [N, s, s] with per-TU scaled QP [N] -> int32.

    The product fits int32: |q| <= 2^15 and the scale is at most
    57 << 10 for QP <= 63."""
    shift = dequant_shift(qcoeff.shape[-1], bit_increment)
    scale = dequant_scale(qp)[:, None, None]
    q = qcoeff.to(torch.int32).clamp(-32768, 32767)
    return ((q * scale + (1 << (shift - 1))) >> shift).clamp(-32768, 32767)


def _inv_pass(s: torch.Tensor, t: torch.Tensor, shift: int) -> torch.Tensor:
    """One inverse pass: out[j, k] = clip((sum_n T[n, k] * s[n, j] + add)
    >> shift), as float64 products (exact, see the module note)."""
    y = torch.einsum("nk,bnj->bjk", t.to(torch.float64),
                     s.to(torch.float64)).to(torch.int64)
    return ((y + (1 << (shift - 1))) >> shift).clamp(-32768, 32767)


def inverse_transform(coeff: torch.Tensor, use_dst: bool = False,
                      bit_increment: int = 0) -> torch.Tensor:
    """Batched inverse 2-D transform [N, s, s] -> int32 residual."""
    size = coeff.shape[-1]
    t = from_reference(coeff.device).basis(size, use_dst)
    tmp = _inv_pass(coeff, t, SHIFT_INV_1ST)
    return _inv_pass(tmp, t, SHIFT_INV_2ND - bit_increment).to(torch.int32)


def residual_pipeline_plain(qcoeff: torch.Tensor, qp: torch.Tensor,
                            use_dst: bool = False,
                            bit_increment: int = 0) -> torch.Tensor:
    """The plain version of the residual kernel: [N, s, s] coefficients
    and scaled QPs [N] -> [N, s, s] int16 residual, on any device."""
    return inverse_transform(dequant(qcoeff, qp, bit_increment), use_dst,
                             bit_increment).to(torch.int16)


def residual_pipeline(qcoeff: torch.Tensor, qp: torch.Tensor,
                      use_dst: bool = False,
                      bit_increment: int = 0) -> torch.Tensor:
    """Batched dequant + inverse transform [N, s, s] -> int16 residual.

    On a CUDA tensor this launches the hand-written kernel, which takes
    int16 coefficients (and raises if it cannot launch); on a CPU tensor
    it runs the plain version."""
    if qcoeff.device.type == "cpu":
        return residual_pipeline_plain(qcoeff, qp, use_dst, bit_increment)
    if qcoeff.device.type != "cuda":
        raise ValueError(f"unsupported device {qcoeff.device}")
    size = qcoeff.shape[-1]
    return residual_kernel.residual(
        qcoeff.contiguous(), dequant_scale(qp).contiguous(),
        from_reference(qcoeff.device).basis(size, use_dst),
        dequant_shift(size, bit_increment), SHIFT_INV_2ND - bit_increment)


def _unpack_cgs(cg_vals: torch.Tensor, cg_idx: torch.Tensor, n: int,
                size: int) -> torch.Tensor:
    """Scatter CG-packed coefficients into dense [n, size, size] TUs.

    cg_vals [M, 16] int16, one coded 4x4 coefficient group per row;
    cg_idx [M] = tu_index * ncg + cg_position (row-major CG grid), with
    padded rows pointing at the dummy slot n * ncg."""
    ncg1 = size // 4
    flat = torch.zeros((n * ncg1 * ncg1 + 1, 16), dtype=torch.int16,
                       device=cg_vals.device)
    flat[cg_idx.long()] = cg_vals.to(torch.int16)
    return (flat[:-1].reshape(n, ncg1, ncg1, 4, 4)
            .permute(0, 1, 3, 2, 4).reshape(n, size, size))


def residual_pipeline_packed(cg_vals: torch.Tensor, cg_idx: torch.Tensor,
                             qp: torch.Tensor, size: int,
                             use_dst: bool = False,
                             bit_increment: int = 0) -> torch.Tensor:
    """CG-packed variant of ``residual_pipeline``: the unpack scatter on
    the device, then the same dequant + inverse transform."""
    qcoeff = _unpack_cgs(cg_vals, cg_idx, int(qp.shape[0]), size)
    return residual_pipeline(qcoeff, qp, use_dst, bit_increment)
