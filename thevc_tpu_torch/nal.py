"""NAL unit framing: header, EBSP emulation prevention, Annex-B byte streams.

Behavioral reference: HM NALwrite.cpp / NALread.cpp (nal_unit_header with the
J0550 layout: forbidden_zero_bit, nal_unit_type(6), nuh_reserved_zero_6bits,
nuh_temporal_id_plus1(3)), AnnexBwrite.h:50 (start-code + zero_byte rules)
and AnnexBread.cpp (start-code scanning).

This is the HM-8.x draft-era (JCTVC-J) NAL type numbering from
CommonDef.h:193-224 — NOT the final H.265 numbering.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple


# NAL unit types (HM-8.x draft numbering, CommonDef.h:193+)
NAL_UNIT_CODED_SLICE = 1
NAL_UNIT_CODED_SLICE_TFD = 2
NAL_UNIT_CODED_SLICE_TLA = 3
NAL_UNIT_CODED_SLICE_CRA = 4
NAL_UNIT_CODED_SLICE_CRANT = 5
NAL_UNIT_CODED_SLICE_BLA = 6
NAL_UNIT_CODED_SLICE_BLANT = 7
NAL_UNIT_CODED_SLICE_IDR = 8
NAL_UNIT_VPS = 25
NAL_UNIT_SPS = 26
NAL_UNIT_PPS = 27
NAL_UNIT_ACCESS_UNIT_DELIMITER = 29
NAL_UNIT_FILLER_DATA = 30
NAL_UNIT_SEI = 31

SLICE_NAL_TYPES = frozenset({
    NAL_UNIT_CODED_SLICE, NAL_UNIT_CODED_SLICE_TFD, NAL_UNIT_CODED_SLICE_TLA,
    NAL_UNIT_CODED_SLICE_CRA, NAL_UNIT_CODED_SLICE_CRANT,
    NAL_UNIT_CODED_SLICE_BLA, NAL_UNIT_CODED_SLICE_BLANT,
    NAL_UNIT_CODED_SLICE_IDR,
})


def is_slice_nal(nal_type: int) -> bool:
    return nal_type in SLICE_NAL_TYPES


@dataclass
class NalUnit:
    nal_type: int
    temporal_id: int
    rbsp: bytes  # RBSP payload (header stripped, emulation bytes removed)


def ebsp_to_rbsp(payload: bytes) -> bytes:
    """Strip emulation_prevention_three_byte (00 00 03 -> 00 00)."""
    if b"\x00\x00\x03" not in payload:
        return payload
    out = bytearray()
    zeros = 0
    i = 0
    n = len(payload)
    while i < n:
        b = payload[i]
        if zeros == 2 and b == 0x03:
            i += 1
            zeros = 0
            if i >= n:
                break
            b = payload[i]
        zeros = zeros + 1 if b == 0 else 0
        out.append(b)
        i += 1
    return bytes(out)


def rbsp_to_ebsp(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte so no byte-aligned
    00 00 {00,01,02,03} sequence remains; append a trailing 03 if the
    payload ends in 00 (cabac_zero_word rule).  NALwrite.cpp:110+.

    Vectorized: a raw scan finds candidate 00 00 0X positions (a
    superset of the true insertion points — an earlier insertion resets
    the zero run), then a short sequential pass over just the candidates
    applies the run-reset rule.  CABAC payloads have few candidates, so
    this replaces a per-byte Python loop with one numpy pass.
    """
    import numpy as np

    if len(rbsp) < 3:
        if rbsp and rbsp[-1] == 0:
            return bytes(rbsp) + b"\x03"
        return bytes(rbsp)
    a = np.frombuffer(rbsp, np.uint8)
    cand = np.nonzero((a[:-2] == 0) & (a[1:-1] == 0) & (a[2:] <= 3))[0] + 2
    out = bytearray()
    prev = 0          # start of the unprocessed tail
    guard = -10       # position just after the last insertion's reset
    for i in cand:
        i = int(i)
        # valid only if the two zeros before i were not consumed by an
        # earlier insertion (insertion at j protects positions j, j+1)
        if i - 2 < guard:
            continue
        out += rbsp[prev:i]
        out.append(3)
        prev = i
        guard = i
    out += rbsp[prev:]
    if out and out[-1] == 0:
        out.append(3)
    return bytes(out)


def write_nal_header(nal_type: int, temporal_id: int) -> bytes:
    """2-byte nal_unit_header(): forbidden(1)=0, type(6), reserved(6)=0,
    temporal_id_plus1(3)."""
    return bytes(((nal_type << 1) & 0x7E, (temporal_id + 1) & 0x7))


def parse_nal_header(data: bytes) -> Tuple[int, int]:
    """Return (nal_type, temporal_id) from the first two bytes."""
    assert (data[0] & 0x80) == 0, "forbidden_zero_bit set"
    nal_type = (data[0] >> 1) & 0x3F
    temporal_id = (data[1] & 0x7) - 1
    return nal_type, temporal_id


def write_nal(nal_type: int, temporal_id: int, rbsp: bytes) -> bytes:
    return write_nal_header(nal_type, temporal_id) + rbsp_to_ebsp(rbsp)


def write_annexb(nal_units: List[Tuple[int, int, bytes]]) -> Tuple[bytes, List[int]]:
    """Frame an access unit: list of (nal_type, temporal_id, rbsp).

    Returns (bytestream, per-NAL sizes).  zero_byte (4-byte start code) is
    used for the first NAL of the AU and for SPS/PPS (AnnexBwrite.h:60-77).
    """
    out = bytearray()
    sizes = []
    for i, (nal_type, tid, rbsp) in enumerate(nal_units):
        sc = b"\x00\x00\x00\x01" if (i == 0 or nal_type in (NAL_UNIT_SPS, NAL_UNIT_PPS)) \
            else b"\x00\x00\x01"
        data = write_nal(nal_type, tid, rbsp)
        out += sc + data
        sizes.append(len(sc) + len(data))
    return bytes(out), sizes


def iter_annexb_nals(stream: bytes) -> Iterator[NalUnit]:
    """Scan an Annex-B byte stream, yielding NAL units (AnnexBread.cpp)."""
    n = len(stream)
    i = 0
    # find first start code
    starts: List[int] = []
    while i + 2 < n:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else n
        # trailing zero_bytes before the next start code belong to no NAL
        while e > s and stream[e - 1] == 0 and k + 1 < len(starts):
            e -= 1
        payload = stream[s:e]
        if len(payload) < 2:
            continue
        nal_type, tid = parse_nal_header(payload)
        rbsp = ebsp_to_rbsp(payload[2:])
        yield NalUnit(nal_type, tid, rbsp)
