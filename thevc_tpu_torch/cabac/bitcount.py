"""Fractional-bit counting CABAC engine for RD estimation (FAST_BIT_EST).

Behavioral reference: TEncBinCoderCABACCounter.cpp — encodeBin adds
ENTROPY_BITS[state ^ bin] (1/32768-bit units) and updates the context;
EP bins add exactly 32768 per bin; terminate uses state 126.

This is the mathematically batchable form of CABAC rate estimation: RD cost
= f(context states), which is what makes HM's two-pass design (estimate with
counters, re-encode exactly) the template for the TPU encoder's
device-estimate / host-serialize split (SURVEY.md section 7).
"""

from __future__ import annotations

import numpy as np

from .tables import ENTROPY_BITS, NEXT_STATE


class CounterEncoder:
    """Drop-in for engine.BinEncoder that counts fractional bits."""

    __slots__ = ("ctx", "frac_bits", "bit_count", "bins_coded")

    def __init__(self, ctx: np.ndarray | None = None):
        self.ctx = ctx
        self.frac_bits = 0
        self.bit_count = 0        # whole bits written via write() (unused in RD)
        self.bins_coded = 0       # getBinsCoded (dependent-slice mode 2)

    def encode_bin(self, bin_val: int, ctx_idx: int) -> None:
        state = self.ctx[ctx_idx]
        self.frac_bits += int(ENTROPY_BITS[state ^ bin_val])
        self.ctx[ctx_idx] = NEXT_STATE[state, bin_val]
        self.bins_coded += 1

    def encode_bin_ep(self, bin_val: int) -> None:
        self.frac_bits += 32768
        self.bins_coded += 1

    def encode_bins_ep(self, bin_vals: int, num_bins: int) -> None:
        self.frac_bits += 32768 * num_bins
        self.bins_coded += num_bins

    def encode_bin_trm(self, bin_val: int) -> None:
        self.frac_bits += int(ENTROPY_BITS[126 ^ bin_val])
        self.bins_coded += 1

    def write(self, bits: int, n: int) -> None:
        """PCM passthrough / finish()-style whole-bit writes."""
        self.bit_count += n

    def write_align_zero(self) -> None:
        self.bit_count += 0  # TComBitCounter::writeAlignZero is a no-op

    # PCM (counter semantics of TEncBinCABAC.cpp:129-168: finish() moves
    # whole fractional bits to the bit counter, alignment costs nothing)
    def encode_num_subseq_ipcm(self, n: int) -> None:
        self.bit_count += self.frac_bits >> 15   # finish()
        self.frac_bits &= 32767
        self.write(0, 1)   # stop bit
        self.write(0, 1)   # numSubseqIPCM flag
        if n > 0:
            code_last = n < 3
            while n > 1:
                self.write(0, 1)
                n -= 1
            if code_last:
                self.write(0, 1)

    def encode_pcm_align_bits(self) -> None:
        pass

    def write_pcm_code(self, code: int, length: int) -> None:
        self.write(code, length)

    def reset_bac(self) -> None:
        pass

    def reset_bits(self) -> None:
        self.bit_count = 0
        self.frac_bits &= 32767

    @property
    def num_written_bits(self) -> int:
        return self.bit_count + (self.frac_bits >> 15)

    # snapshot/restore (TEncSbac::store/load + TEncBinCABAC::copyState)
    def snapshot(self):
        return (self.ctx.copy(), self.frac_bits)

    def restore(self, snap) -> None:
        ctx, frac = snap
        np.copyto(self.ctx, ctx)
        self.frac_bits = frac

    def load_from(self, other: "CounterEncoder") -> None:
        np.copyto(self.ctx, other.ctx)
        self.frac_bits = other.frac_bits
