"""The encoder's Hadamard SATD in PyTorch.

Counterpart of ``thevc_tpu/encoder/fast_intra.py:_satd`` / ``_satd_d``
(:268-296), of ``thevc_tpu/ops/jx.py:intra_sweep_satd`` (:234) and of
the Pallas kernel behind it (``jx_pallas.satd_sweep_planar``, :93-133);
all mirror ``thevc_tpu/encoder/rdcost.py:calc_had_batched``.  Per PU,
the difference org - candidate is cut into 8x8 blocks when the PU size
is a multiple of 8 and into 4x4 blocks otherwise; each block's
``sum |H D H|`` is normalised as HM does (``(s + 2) >> 2`` for 8x8,
``(s + 1) >> 1`` for 4x4), the PU's blocks are summed, and the sum is
shifted right by the bit increment.

``satd_blocks`` dispatches on the device of its input: a CUDA tensor
goes through the hand-written kernel (``ops.satd_kernel``), a CPU tensor
through the plain version, ``satd_plain``.  The plain version does the
Hadamard products in float64, exact here (every product and partial sum
is below 64 * 2^16 < 2^53); it runs on the card too, and the tests and
``chip_smoke.py`` hold the kernel against it there.
"""

from __future__ import annotations

import torch

from ..common.tables import from_reference
from . import satd_kernel


def satd_plain(org: torch.Tensor, preds: torch.Tensor,
               bit_increment: int = 0) -> torch.Tensor:
    """The plain version of the SATD kernel: originals [N, s, s] and
    candidates [N, M, s, s] -> int32 SATDs [N, M], on any device."""
    n, m, s = (int(v) for v in preds.shape[:3])
    b = 8 if s % 8 == 0 else 4
    d = org[:, None].to(torch.int32) - preds.to(torch.int32)
    blocks = (d.reshape(n, m, s // b, b, s // b, b)
              .permute(0, 1, 2, 4, 3, 5).to(torch.float64))
    h = from_reference(org.device).hadamard[b].to(torch.float64)
    hm = torch.einsum("ij,nmyxjk,kl->nmyxil", h, blocks, h)
    sad = hm.abs().sum(dim=(-2, -1)).to(torch.int64)
    norm = (sad + 2) >> 2 if b == 8 else (sad + 1) >> 1
    return (norm.sum(dim=(2, 3)) >> bit_increment).to(torch.int32)


def satd_blocks(org: torch.Tensor, preds: torch.Tensor,
                bit_increment: int = 0) -> torch.Tensor:
    """SATD of each PU's original [N, s, s] against its candidates
    [N, M, s, s] -> int32 [N, M].  Samples must fit int16.

    On a CUDA tensor this launches the hand-written kernel (and raises
    if it cannot launch); on a CPU tensor it runs the plain version."""
    if org.device.type == "cpu":
        return satd_plain(org, preds, bit_increment)
    if org.device.type != "cuda":
        raise ValueError(f"unsupported device {org.device}")
    return satd_kernel.satd(org.to(torch.int16).contiguous(),
                            preds.to(torch.int16).contiguous(),
                            bit_increment)


def intra_sweep_satd(org: torch.Tensor, preds: torch.Tensor,
                     bit_increment: int = 0) -> torch.Tensor:
    """The 35-mode intra sweep of one PU: original [s, s] against
    candidates [M, s, s] -> int32 [M] (``jx.intra_sweep_satd``)."""
    return satd_blocks(org[None], preds[None], bit_increment)[0]
