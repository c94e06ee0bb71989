"""Annex-B byte-stream statistics (annexBbytecount).

Behavioral reference: source/App/utils/annexBbytecount.cpp:120-233 and the
byteStreamNALUnit stats accounting in AnnexBread.cpp:60-140.  Prints per-NAL
and aggregate byte counts split by syntax element class plus the Type-1 /
Type-2 HRD totals.

Usage: python -m thevc_tpu_torch.apps.annexb_bytecount stream.bin
"""

from __future__ import annotations

import sys
from dataclasses import dataclass


@dataclass
class AnnexBStats:
    leading_zero: int = 0
    zero_byte: int = 0
    start_code: int = 0
    nal_bytes: int = 0
    trailing_zero: int = 0

    def __iadd__(self, o: "AnnexBStats"):
        self.leading_zero += o.leading_zero
        self.zero_byte += o.zero_byte
        self.start_code += o.start_code
        self.nal_bytes += o.nal_bytes
        self.trailing_zero += o.trailing_zero
        return self


def scan_nal_units(data: bytes):
    """Yield (nal_bytes, AnnexBStats) per NAL unit, mirroring
    byteStreamNALUnit (AnnexBread.cpp:150)."""
    pos = 0
    n = len(data)

    def peek3_is(val):
        return pos + 3 <= n and data[pos:pos + 3] == val

    while pos < n:
        st = AnnexBStats()
        # leading_zero_8bits until a 3- or 4-byte start code is next
        while pos < n and not (
                data[pos:pos + 3] == b"\x00\x00\x01"
                or data[pos:pos + 4] == b"\x00\x00\x00\x01"):
            pos += 1
            st.leading_zero += 1
        if pos >= n:
            yield b"", st
            return
        # zero_byte for 4-byte start codes
        if data[pos:pos + 3] != b"\x00\x00\x01":
            pos += 1
            st.zero_byte += 1
        pos += 3
        st.start_code += 3
        # NAL payload up to the next 0x000000/0x000001 or EOF
        start = pos
        while pos < n:
            nxt = data[pos:pos + 3]
            if len(nxt) == 3 and nxt in (b"\x00\x00\x00", b"\x00\x00\x01"):
                break
            pos += 1
        payload = data[start:pos]
        st.nal_bytes = len(payload)
        # trailing_zero_8bits until the next start code or EOF
        while pos < n and not (
                data[pos:pos + 3] == b"\x00\x00\x01"
                or data[pos:pos + 4] == b"\x00\x00\x00\x01"):
            pos += 1
            st.trailing_zero += 1
        yield payload, st


def _print_stats(title: str, st: AnnexBStats, indent: str = "  ") -> None:
    if title:
        print(title)
    print(f"{indent}num_bytes(leading_zero_8bits): {st.leading_zero}")
    print(f"{indent}num_bytes(zero_byte): {st.zero_byte}")
    print(f"{indent}num_bytes(start_code_prefix_one_3bytes): "
          f"{st.start_code}")
    print(f"{indent}NumBytesInNALunit: {st.nal_bytes}")
    print(f"{indent}num_bytes(trailing_zero_8bits): {st.trailing_zero}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: annexb_bytecount <bitstream>", file=sys.stderr)
        return 1
    data = open(argv[0], "rb").read()

    total = AnnexBStats()
    total_vcl = AnnexBStats()
    total_filler = AnnexBStats()
    total_other = AnnexBStats()
    num = 0
    print("NALUnits:")
    for payload, st in scan_nal_units(data):
        nal_type = (payload[0] & 0x3F) >> 1 if payload else -1
        # the reference (an AVC-era tool) prints `nalUnit[0] & 0x1f`; for
        # HEVC NAL headers the type lives in bits 1..6 of the first byte
        print(f" - NALU: #{num} nal_unit_type:{nal_type}")
        _print_stats("", st, indent="   ")
        total += st
        num += 1
        if not st.nal_bytes:
            continue
        from .. import nal as nal_mod
        if nal_mod.is_slice_nal(nal_type):
            total_vcl += st
        elif nal_type == nal_mod.NAL_UNIT_FILLER_DATA:
            total_filler += st
        else:
            total_other += st

    _print_stats("Summary: ", total)
    _print_stats("Summary(VCL): ", total_vcl)
    _print_stats("Summary(Filler): ", total_filler)
    _print_stats("Summary(Other): ", total_other)

    t1 = total_vcl.nal_bytes + total_filler.nal_bytes
    t2a = total.nal_bytes
    t2ab = (total.leading_zero + total.zero_byte + total.start_code
            + total.nal_bytes + total.trailing_zero)
    print("Totals (bytes):")
    print(f"  Type1 HRD: {t1}")
    print(f"  Type2 HRD: {t2a}")
    print(f"  Type2b HRD: {t2ab}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
