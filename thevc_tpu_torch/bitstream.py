"""Bitstream read/write with HEVC RBSP semantics.

Behavioral reference: TComBitStream.{h,cpp} in HM (TComOutputBitstream::write,
TComInputBitstream::read — MSB-first bit packing, held-bits flush rules) and
the ue(v)/se(v) Exp-Golomb helpers used by the header coders
(TEncCavlc/TDecCAVLC: xWriteUvlc/xReadUvlc, xWriteSvlc/xReadSvlc).

Host-side: bitstreams are inherently sequential byte FIFOs.  The hot path for
the encoder is CABAC (see thevc_tpu.cabac) which maintains its own byte FIFO;
this class handles headers, NAL assembly, and substream concatenation.
"""

from __future__ import annotations


class OutputBitstream:
    """MSB-first bit writer over a growable byte FIFO."""

    __slots__ = ("_fifo", "_held", "_num_held")

    def __init__(self) -> None:
        self._fifo = bytearray()
        self._held = 0          # current partial byte, aligned to MSB
        self._num_held = 0      # number of valid bits in _held (0..7)

    def clear(self) -> None:
        self._fifo = bytearray()
        self._held = 0
        self._num_held = 0

    # -- core ---------------------------------------------------------------
    def write(self, bits: int, n: int) -> None:
        """Append the low `n` bits of `bits`, MSB first."""
        assert 0 <= n <= 32
        if n == 0:
            return
        bits &= (1 << n) - 1
        total = self._num_held + n
        acc = (self._held >> (8 - self._num_held) if self._num_held else 0)
        acc = (acc << n) | bits
        nbytes, rem = divmod(total, 8)
        if nbytes:
            out = acc >> rem
            self._fifo += out.to_bytes(nbytes, "big")
        self._num_held = rem
        self._held = ((acc & ((1 << rem) - 1)) << (8 - rem)) & 0xFF if rem else 0

    def write_align_one(self) -> None:
        n = self.bits_until_byte_aligned
        if n:
            self.write((1 << n) - 1, n)

    def write_align_zero(self) -> None:
        if self._num_held:
            self._fifo.append(self._held)
            self._held = 0
            self._num_held = 0

    def write_rbsp_trailing_bits(self) -> None:
        self.write(1, 1)
        self.write_align_zero()

    # -- Exp-Golomb ---------------------------------------------------------
    def write_ue(self, value: int) -> None:
        assert value >= 0
        code = value + 1
        length = code.bit_length()
        # (length-1) zeros, then the code itself (length bits)
        self.write(0, length - 1)
        self.write(code, length)

    def write_se(self, value: int) -> None:
        self.write_ue(2 * value - 1 if value > 0 else -2 * value)

    def write_flag(self, value) -> None:
        self.write(1 if value else 0, 1)

    # -- substreams / assembly ---------------------------------------------
    def write_bytes(self, data: bytes) -> None:
        """Append whole bytes (stream must be byte-aligned)."""
        assert self._num_held == 0
        self._fifo.extend(data)

    def add_substream(self, sub: "OutputBitstream") -> None:
        """Append another bitstream bit-by-bit (TComOutputBitstream::addSubstream)."""
        if self._num_held == 0:
            # byte-aligned destination (slice data always starts aligned):
            # whole-buffer append instead of the per-byte bit loop
            self._fifo.extend(sub._fifo)
        else:
            # _held keeps its k bits MSB-aligned (see write())
            k = self._num_held
            held = self._held
            fifo = self._fifo
            for byte in sub._fifo:
                fifo.append(held | (byte >> k))
                held = (byte << (8 - k)) & 0xFF
            self._held = held
        if sub._num_held:
            self.write(sub._held >> (8 - sub._num_held), sub._num_held)

    def insert_at(self, src: "OutputBitstream", pos: int) -> None:
        assert src._num_held == 0
        self._fifo[pos:pos] = src._fifo

    # -- accessors ----------------------------------------------------------
    @property
    def bits_until_byte_aligned(self) -> int:
        return (8 - self._num_held) & 7

    @property
    def num_bits(self) -> int:
        return len(self._fifo) * 8 + self._num_held

    @property
    def byte_aligned(self) -> bool:
        return self._num_held == 0

    def get_bytes(self) -> bytes:
        assert self._num_held == 0, "flush before extracting bytes"
        return bytes(self._fifo)

    @property
    def fifo(self) -> bytearray:
        return self._fifo

    def append_byte(self, b: int) -> None:
        assert self._num_held == 0
        self._fifo.append(b)


class InputBitstream:
    """MSB-first bit reader over an RBSP byte buffer."""

    __slots__ = ("_buf", "_idx", "_held", "_num_held", "_num_bits_read")

    def __init__(self, buf: bytes) -> None:
        self._buf = buf
        self._idx = 0
        self._held = 0
        self._num_held = 0
        self._num_bits_read = 0

    def read(self, n: int) -> int:
        assert 0 <= n <= 32
        if n == 0:
            return 0
        self._num_bits_read += n
        if n <= self._num_held:
            ret = (self._held >> (self._num_held - n)) & ((1 << n) - 1)
            self._num_held -= n
            return ret
        need = n - self._num_held
        ret = self._held & ((1 << self._num_held) - 1) if self._num_held else 0
        nbytes = (need + 7) >> 3
        if self._idx + nbytes > len(self._buf):
            raise EOFError("bitstream exhausted")
        word = int.from_bytes(self._buf[self._idx:self._idx + nbytes], "big")
        self._idx += nbytes
        rem = nbytes * 8 - need
        ret = (ret << need) | (word >> rem)
        self._num_held = rem
        self._held = word & ((1 << rem) - 1) if rem else 0
        return ret

    def pseudo_read(self, n: int) -> int:
        """Peek `n` bits without consuming; zero-pads past the end."""
        idx, held, num_held, nbr = self._idx, self._held, self._num_held, self._num_bits_read
        left = self.num_bits_left
        take = min(n, left)
        val = self.read(take) << (n - take) if take else 0
        self._idx, self._held, self._num_held, self._num_bits_read = idx, held, num_held, nbr
        return val

    def read_ue(self) -> int:
        leading_zeros = 0
        while self.read(1) == 0:
            leading_zeros += 1
            if leading_zeros > 32:
                raise ValueError("invalid Exp-Golomb code")
        return (1 << leading_zeros) - 1 + (self.read(leading_zeros) if leading_zeros else 0)

    def read_se(self) -> int:
        val = self.read_ue()
        return (val + 1) >> 1 if val & 1 else -(val >> 1)

    def read_flag(self) -> int:
        return self.read(1)

    def read_out_trailing_bits(self) -> None:
        while self.num_bits_left > 0 and self.bits_until_byte_aligned != 0:
            self.read(1)

    def read_byte(self) -> int:
        return self.read(8)

    @property
    def bits_until_byte_aligned(self) -> int:
        return self._num_held & 7

    @property
    def num_bits_left(self) -> int:
        return 8 * (len(self._buf) - self._idx) + self._num_held

    @property
    def num_bits_read(self) -> int:
        return self._num_bits_read

    def extract_substream(self, num_bits: int) -> "InputBitstream":
        """Pull `num_bits` out into a fresh byte-aligned stream (WPP/tiles)."""
        out = bytearray()
        for _ in range(num_bits // 8):
            out.append(self.read(8))
        rem = num_bits & 7
        if rem:
            out.append(self.read(rem) << (8 - rem))
        return InputBitstream(bytes(out))
