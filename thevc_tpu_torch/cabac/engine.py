"""CABAC binary arithmetic coding engine (host-side, sequential by nature).

Behavioral reference: TEncBinCoderCABAC.cpp (encodeBin :208, EP :254/:279,
terminate :315, writeOut carry propagation :351, finish/flush) and
TDecBinCoderCABAC.cpp (decodeBin :106, EP :152/:171, terminate :218).

Contexts are a flat numpy uint8 array of 7-bit states ((prob<<1)|mps); the
syntax layer addresses them by offset.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import InputBitstream, OutputBitstream
from .tables import (LPS_TABLE, NEXT_STATE_LPS, NEXT_STATE_MPS, RENORM_TABLE)


class BinEncoder:
    """Arithmetic bin encoder writing into an OutputBitstream."""

    __slots__ = ("bs", "low", "range", "bits_left", "num_buffered_bytes",
                 "buffered_byte", "ctx", "used")

    def __init__(self, bs: OutputBitstream, ctx: np.ndarray | None = None):
        self.bs = bs
        self.ctx = ctx
        # per-context "coded at least one bin" marks (ContextModel
        # m_binsCoded), consumed by determineCabacInitIdx
        self.used = np.zeros_like(ctx) if ctx is not None else None
        self.start()

    def start(self) -> None:
        self.low = 0
        self.range = 510
        self.bits_left = 23
        self.num_buffered_bytes = 0
        self.buffered_byte = 0xFF

    # -- context-coded bins -------------------------------------------------
    def encode_bin(self, bin_val: int, ctx_idx: int) -> None:
        state = self.ctx[ctx_idx]
        self.used[ctx_idx] = 1
        lps = int(LPS_TABLE[state >> 1, (self.range >> 6) & 3])
        self.range -= lps
        if bin_val != (state & 1):
            num_bits = int(RENORM_TABLE[lps >> 3])
            self.low = (self.low + self.range) << num_bits
            self.range = lps << num_bits
            self.ctx[ctx_idx] = NEXT_STATE_LPS[state]
            self.bits_left -= num_bits
        else:
            self.ctx[ctx_idx] = NEXT_STATE_MPS[state]
            if self.range >= 256:
                return
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    # -- bypass bins --------------------------------------------------------
    def encode_bin_ep(self, bin_val: int) -> None:
        self.low <<= 1
        if bin_val:
            self.low += self.range
        self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def encode_bins_ep(self, bin_vals: int, num_bins: int) -> None:
        while num_bins > 8:
            num_bins -= 8
            pattern = bin_vals >> num_bins
            self.low = (self.low << 8) + self.range * pattern
            bin_vals -= pattern << num_bins
            self.bits_left -= 8
            if self.bits_left < 12:
                self._write_out()
        self.low = (self.low << num_bins) + self.range * bin_vals
        self.bits_left -= num_bins
        if self.bits_left < 12:
            self._write_out()

    def encode_bin_trm(self, bin_val: int) -> None:
        self.range -= 2
        if bin_val:
            self.low = (self.low + self.range) << 7
            self.range = 2 << 7
            self.bits_left -= 7
        elif self.range >= 256:
            return
        else:
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    # -- termination --------------------------------------------------------
    def finish(self) -> None:
        """TEncBinCABAC::finish — drain registers into the bitstream."""
        if self.low >> (32 - self.bits_left):
            self.bs.write(self.buffered_byte + 1, 8)
            while self.num_buffered_bytes > 1:
                self.bs.write(0x00, 8)
                self.num_buffered_bytes -= 1
            self.low -= 1 << (32 - self.bits_left)
        else:
            if self.num_buffered_bytes > 0:
                self.bs.write(self.buffered_byte, 8)
            while self.num_buffered_bytes > 1:
                self.bs.write(0xFF, 8)
                self.num_buffered_bytes -= 1
        self.bs.write((self.low >> 8) & 0xFFFFFF, 24 - self.bits_left)

    def flush(self) -> None:
        """encodeBinTrm(1) + finish + stop bit + align (TEncBinCABAC::flush)."""
        self.encode_bin_trm(1)
        self.finish()
        self.bs.write(1, 1)
        self.bs.write_align_zero()
        self.start()

    # -- PCM (TEncBinCABAC.cpp:129-168) --------------------------------------
    def encode_num_subseq_ipcm(self, n: int) -> None:
        """finish + stop bit + unary burst count (encodeNumSubseqIPCM)."""
        self.finish()
        self.bs.write(1, 1)   # stop bit
        self.bs.write(1 if n else 0, 1)
        if n > 0:
            code_last = n < 3
            while n > 1:
                self.bs.write(1, 1)
                n -= 1
            if code_last:
                self.bs.write(0, 1)

    def encode_pcm_align_bits(self) -> None:
        self.bs.write_align_zero()

    def write_pcm_code(self, code: int, length: int) -> None:
        self.bs.write(code, length)

    def reset_bac(self) -> None:
        """TEncBinCABAC::resetBac — restart arithmetic coding after PCM."""
        self.start()

    @property
    def num_written_bits(self) -> int:
        return (self.bs.num_bits + 8 * self.num_buffered_bytes
                + 23 - self.bits_left)

    def _write_out(self) -> None:
        lead_byte = self.low >> (24 - self.bits_left)
        self.bits_left += 8
        self.low &= 0xFFFFFFFF >> self.bits_left
        if lead_byte == 0xFF:
            self.num_buffered_bytes += 1
        elif self.num_buffered_bytes > 0:
            carry = lead_byte >> 8
            self.bs.write((self.buffered_byte + carry) & 0xFF, 8)
            self.buffered_byte = lead_byte & 0xFF
            byte = (0xFF + carry) & 0xFF
            while self.num_buffered_bytes > 1:
                self.bs.write(byte, 8)
                self.num_buffered_bytes -= 1
        else:
            self.num_buffered_bytes = 1
            self.buffered_byte = lead_byte & 0xFF


class BinDecoder:
    """Arithmetic bin decoder reading from an InputBitstream."""

    __slots__ = ("bs", "range", "value", "bits_needed", "ctx")

    def __init__(self, bs: InputBitstream, ctx: np.ndarray | None = None):
        self.bs = bs
        self.ctx = ctx
        self.start()

    def start(self) -> None:
        assert self.bs.bits_until_byte_aligned == 0
        self.range = 510
        self.bits_needed = -8
        self.value = (self.bs.read_byte() << 8) | self.bs.read_byte()

    def decode_bin(self, ctx_idx: int) -> int:
        state = self.ctx[ctx_idx]
        lps = int(LPS_TABLE[state >> 1, (self.range >> 6) - 4])
        self.range -= lps
        scaled = self.range << 7
        if self.value < scaled:
            bin_val = state & 1
            self.ctx[ctx_idx] = NEXT_STATE_MPS[state]
            if scaled >= (256 << 7):
                return bin_val
            self.range = scaled >> 6
            self.value += self.value
            self.bits_needed += 1
            if self.bits_needed == 0:
                self.bits_needed = -8
                self.value += self.bs.read_byte()
            return bin_val
        num_bits = int(RENORM_TABLE[lps >> 3])
        self.value = (self.value - scaled) << num_bits
        self.range = lps << num_bits
        bin_val = 1 - (state & 1)
        self.ctx[ctx_idx] = NEXT_STATE_LPS[state]
        self.bits_needed += num_bits
        if self.bits_needed >= 0:
            self.value += self.bs.read_byte() << self.bits_needed
            self.bits_needed -= 8
        return bin_val

    def decode_bin_ep(self) -> int:
        self.value += self.value
        self.bits_needed += 1
        if self.bits_needed >= 0:
            self.bits_needed = -8
            self.value += self.bs.read_byte()
        scaled = self.range << 7
        if self.value >= scaled:
            self.value -= scaled
            return 1
        return 0

    def decode_bins_ep(self, num_bins: int) -> int:
        bins = 0
        while num_bins > 8:
            self.value = ((self.value << 8)
                          + (self.bs.read_byte() << (8 + self.bits_needed)))
            scaled = self.range << 15
            for _ in range(8):
                bins += bins
                scaled >>= 1
                if self.value >= scaled:
                    bins += 1
                    self.value -= scaled
            num_bins -= 8
        self.bits_needed += num_bins
        self.value <<= num_bins
        if self.bits_needed >= 0:
            self.value += self.bs.read_byte() << self.bits_needed
            self.bits_needed -= 8
        scaled = self.range << (num_bins + 7)
        for _ in range(num_bins):
            bins += bins
            scaled >>= 1
            if self.value >= scaled:
                bins += 1
                self.value -= scaled
        return bins

    def decode_bin_trm(self) -> int:
        self.range -= 2
        scaled = self.range << 7
        if self.value >= scaled:
            return 1
        if scaled < (256 << 7):
            self.range = scaled >> 6
            self.value += self.value
            self.bits_needed += 1
            if self.bits_needed == 0:
                self.bits_needed = -8
                self.value += self.bs.read_byte()
        return 0

    def decode_pcm_align_bits(self) -> None:
        n = self.bs.bits_until_byte_aligned
        if n:
            self.bs.read(n)

    def read_pcm_code(self, length: int) -> int:
        return self.bs.read(length)

    def flush_and_restart(self) -> None:
        """TDecBinCABAC::flush — byte-align then restart (tiles)."""
        while self.bs.num_bits_left > 0 and self.bs.bits_until_byte_aligned != 0:
            self.bs.read(1)
        self.start()
