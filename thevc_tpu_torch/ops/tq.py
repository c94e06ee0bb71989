"""Transform and quantiser ops in PyTorch over TU batches.

Counterpart of ``thevc_tpu/ops/jx.py``.  The decoder's stage 1:
``dequant`` (:95), ``inverse_transform`` (:78), ``residual_pipeline``
(:147), ``_unpack_cgs`` (:167) and ``residual_pipeline_packed`` (:184),
``transform_skip_inv`` of ``thevc_tpu/ops/transforms.py`` (:97) for
transform-skip TUs, and ``dequant_scaled``, the per-coefficient
dequant of pictures with scaling lists.
The encoder's RD estimate: ``forward_transform`` (:61), ``quant``
(:112), ``recon_add_clip`` (:135) and ``tu_recon_pipeline`` (:194).

``residual_pipeline`` and ``residual_pipeline_packed`` dispatch on the
device of their input: a CUDA tensor goes through the hand-written
kernel (``ops.residual_kernel``; the packed form unpacks the coefficient
groups inside it), a CPU tensor through the plain versions below.  The
plain version does the two transform passes as float64 products, which
are exact here: every product and partial sum is below 32 * 90 * 2^15 <
2^53.  It runs on the card too (torch has no int32 matrix product on
CUDA), and the tests and ``chip_smoke.py`` hold the kernel against it
there.  The forward
transform is float64 too, and exact for every input (so it follows
``thevc_tpu/ops/transforms.py`` where the JAX version's single-precision
bound does not hold, at large bit increments).
"""

from __future__ import annotations

import torch

from ..common.tables import from_reference
from . import residual_kernel
from .transforms import (MAX_TR_DYNAMIC_RANGE, QUANT_IQUANT_SHIFT, QUANT_SHIFT,
                         SHIFT_INV_1ST, SHIFT_INV_2ND)


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


def dequant_scaled(qcoeff: torch.Tensor, deq: torch.Tensor, qp: torch.Tensor,
                   bit_increment: int = 0) -> torch.Tensor:
    """xDeQuant's scaling-list branch (TComTrQuant.cpp:1313-1345,
    ``common/scaling.py:dequant_with_list``) over a TU batch: levels
    [N, s, s], each TU's per-coefficient scale table [N, s, s] and scaled
    QPs [N] -> int32, clipped to int16.  In int64."""
    log2 = qcoeff.shape[-1].bit_length() - 1
    bit_depth = 8 + bit_increment
    shift = 20 - 14 - (MAX_TR_DYNAMIC_RANGE - bit_depth - log2) + 4
    per = (qp.to(torch.int64) // 6)[:, None, None]
    q = qcoeff.to(torch.int64)
    deq = deq.to(torch.int64)
    # shift > per: a rounding right shift of the clipped levels
    sr = (shift - per).clamp(min=1)
    right = (q.clamp(-32768, 32767) * deq + ((1 << sr) >> 1)) >> sr
    # else: levels clipped to the dynamic range, then a left shift
    limit = 1 << (12 + log2 + bit_depth - per).clamp(max=15)
    left = (torch.maximum(torch.minimum(q, limit - 1), -limit) * deq) \
        << (per - shift).clamp(min=0)
    out = torch.where(shift > per, right, left)
    return out.clamp(-32768, 32767).to(torch.int32)


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


def transform_skip_inv(coeff: torch.Tensor,
                       bit_increment: int = 0) -> torch.Tensor:
    """xITransformSkip over a TU batch [N, s, s] of dequantised
    coefficients -> int16 residual (``ops/transforms.py:97``)."""
    log2 = coeff.shape[-1].bit_length() - 1
    shift = MAX_TR_DYNAMIC_RANGE - (8 + bit_increment) - log2
    x = coeff.to(torch.int32)
    if shift > 0:
        return ((x + (1 << (shift - 1))) >> shift).to(torch.int16)
    return (x << (-shift)).to(torch.int16)


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
        qcoeff.contiguous(), qp.to(torch.int32).contiguous(),
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


def residual_pipeline_packed_plain(cg_vals: torch.Tensor,
                                   cg_idx: torch.Tensor, qp: torch.Tensor,
                                   size: int, use_dst: bool = False,
                                   bit_increment: int = 0) -> torch.Tensor:
    """The plain version of the packed kernel: the unpack scatter, then
    ``residual_pipeline_plain``, on any device."""
    qcoeff = _unpack_cgs(cg_vals, cg_idx, int(qp.shape[0]), size)
    return residual_pipeline_plain(qcoeff, qp, use_dst, bit_increment)


def residual_pipeline_packed(cg_vals: torch.Tensor, cg_idx: torch.Tensor,
                             qp: torch.Tensor, size: int,
                             use_dst: bool = False,
                             bit_increment: int = 0) -> torch.Tensor:
    """CG-packed variant of ``residual_pipeline`` (sizes 8-32): coded 4x4
    groups int16 [M, 16] at ascending indices [M] (``tu * ncg + cg``,
    padding rows at ``n * ncg``) and scaled QPs [N] -> int16 [N, s, s].

    On CUDA tensors the kernel unpacks the groups in shared memory, so
    the dense coefficients never reach device memory (and raises if it
    cannot launch); on CPU tensors it runs the plain version."""
    if cg_vals.device.type == "cpu":
        return residual_pipeline_packed_plain(cg_vals, cg_idx, qp, size,
                                              use_dst, bit_increment)
    if cg_vals.device.type != "cuda":
        raise ValueError(f"unsupported device {cg_vals.device}")
    return residual_kernel.residual_packed(
        cg_vals.to(torch.int16).contiguous(),
        cg_idx.to(torch.int32).contiguous(), qp.to(torch.int32).contiguous(),
        from_reference(cg_vals.device).basis(size, use_dst), size,
        dequant_shift(size, bit_increment), SHIFT_INV_2ND - bit_increment)


def _fwd_pass(x: torch.Tensor, t: torch.Tensor, shift: int) -> torch.Tensor:
    """One forward pass: out[k, j] = (sum_n T[k, n] * x[j, n] + add) >>
    shift, as float64 products (exact: |sum| <= 32 * 90 * 2^22)."""
    y = torch.einsum("kn,bjn->bkj", t.to(torch.float64),
                     x.to(torch.float64)).to(torch.int64)
    return (y + (1 << (shift - 1))) >> shift


def forward_transform(block: torch.Tensor, use_dst: bool = False,
                      bit_increment: int = 0) -> torch.Tensor:
    """Batched forward 2-D transform [N, s, s] residual -> int32
    coefficients (xTrMxN: shifts log2(s) - 1 + bit increment, then
    log2(s) + 6)."""
    size = block.shape[-1]
    log2 = size.bit_length() - 1
    t = from_reference(block.device).basis(size, use_dst)
    tmp = _fwd_pass(block, t, log2 - 1 + bit_increment)
    return _fwd_pass(tmp, t, log2 + 6).to(torch.int32)


def quant(coeff: torch.Tensor, qp: torch.Tensor, is_intra_slice: bool = True,
          bit_increment: int = 0):
    """Batched non-RDOQ quantisation [N, s, s] with per-TU scaled QP [N]
    -> (levels, delta_u), both int32.

    int32 is enough: |coeff| <= 2^15 and the largest scale is 26214, so
    |coeff| * scale < 2^30, and the rounding add is below 2^29."""
    size = coeff.shape[-1]
    log2 = size.bit_length() - 1
    qp = qp.to(torch.int32)
    transform_shift = MAX_TR_DYNAMIC_RANGE - (8 + bit_increment) - log2
    qb = (QUANT_SHIFT + qp // 6 + transform_shift)[:, None, None]
    add = torch.bitwise_left_shift(
        torch.full_like(qb, 171 if is_intra_slice else 85), qb - 9)
    qscale = from_reference(coeff.device).quant_scales[
        (qp % 6).long()][:, None, None]
    c = coeff.to(torch.int32)
    tmp = c.abs() * qscale
    level = (tmp + add) >> qb
    delta_u = (tmp - (level << qb)) >> (qb - 8)
    level = (torch.sign(c) * level).clamp(-32768, 32767)
    return level.to(torch.int32), delta_u.to(torch.int32)


def recon_add_clip(pred: torch.Tensor, resi: torch.Tensor,
                   max_val: int) -> torch.Tensor:
    """clip(pred + resi, 0, max_val) as int32."""
    return (pred.to(torch.int32) + resi.to(torch.int32)).clamp(0, max_val)


def tu_recon_pipeline_plain(pred: torch.Tensor, qcoeff: torch.Tensor,
                            qp: torch.Tensor, use_dst: bool = False,
                            bit_increment: int = 0,
                            max_val: int = 255) -> torch.Tensor:
    """Dequant -> inverse transform -> add -> clip over a TU batch, plain
    version on any device -> int32 [N, s, s]."""
    resi = residual_pipeline_plain(qcoeff, qp, use_dst, bit_increment)
    return recon_add_clip(pred, resi, max_val)


def tu_recon_pipeline(pred: torch.Tensor, qcoeff: torch.Tensor,
                      qp: torch.Tensor, use_dst: bool = False,
                      bit_increment: int = 0,
                      max_val: int = 255) -> torch.Tensor:
    """Dequant -> inverse transform -> add -> clip over a TU batch
    -> int32 [N, s, s].

    On a CUDA tensor the dequant and inverse transform run in the
    residual kernel (``residual_pipeline``); dequant clips the levels to
    int16 first, so clamping them to int16 for the kernel changes
    nothing.  On a CPU tensor it runs the plain version."""
    if qcoeff.device.type == "cpu":
        return tu_recon_pipeline_plain(pred, qcoeff, qp, use_dst,
                                       bit_increment, max_val)
    q16 = qcoeff.clamp(-32768, 32767).to(torch.int16)
    resi = residual_pipeline(q16, qp, use_dst, bit_increment)
    return recon_add_clip(pred, resi, max_val)
