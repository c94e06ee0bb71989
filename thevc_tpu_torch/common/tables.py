"""The codec's constant tables as tensors on one device.

The numbers come from the host modules (``common/rom.py``,
``ops/deblock.py``, copies of the JAX package's), so the port computes
from the tables the reference does:
``DCT_MATRICES``, ``DST4``, ``INV_QUANT_SCALES`` and ``QUANT_SCALES``
(the transform and quantiser paths, as ``ops/jx.py`` and
``ops/jx_pallas.py`` use them), ``TC_TABLE``, ``BETA_TABLE`` and
``CHROMA_SCALE`` (the in-loop filters, as ``ops/jx_filters.py`` uses
them), the Hadamard matrices of the SATD (``encoder/rdcost.py``), and
the luma 8-tap and chroma 4-tap interpolation filters (``ops/interp.py``,
as ``ops/jx_mc.py`` uses them).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..encoder import rdcost
from ..ops import deblock, interp
from . import rom


@dataclass(frozen=True)
class Tables:
    dct: dict            # size -> int32 [s, s], rows are basis functions
    dst4: torch.Tensor   # int32 [4, 4]
    inv_quant_scales: torch.Tensor   # int32 [6]
    quant_scales: torch.Tensor       # int32 [6]
    hadamard: dict       # 4 / 8 -> int32 [b, b] (Sylvester order)
    tc: torch.Tensor     # int32 [54]
    beta: torch.Tensor   # int32 [52]
    chroma_scale: torch.Tensor       # int32 [58]
    luma_filter: torch.Tensor        # int32 [4, 8], one row per phase
    chroma_filter: torch.Tensor      # int32 [8, 4]

    def basis(self, size: int, use_dst: bool) -> torch.Tensor:
        """The inverse-transform basis of one TU size class."""
        return self.dst4 if (use_dst and size == 4) else self.dct[size]


@functools.lru_cache(maxsize=None)
def from_reference(device) -> Tables:
    """The reference tables as int32 tensors on ``device`` (cached per
    device: the tables are constants)."""
    device = torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return Tables(
        dct={s: t(rom.DCT_MATRICES[s]) for s in (4, 8, 16, 32)},
        dst4=t(rom.DST4),
        inv_quant_scales=t(rom.INV_QUANT_SCALES),
        quant_scales=t(rom.QUANT_SCALES),
        hadamard={4: t(rdcost._H4), 8: t(rdcost._H8)},
        tc=t(deblock.TC_TABLE),
        beta=t(deblock.BETA_TABLE),
        chroma_scale=t(rom.CHROMA_SCALE),
        luma_filter=t(interp.LUMA_FILTER),
        chroma_filter=t(interp.CHROMA_FILTER),
    )
