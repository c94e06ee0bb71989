"""Reconstructed-picture digests (MD5 / CRC / checksum) for digest SEI.

Behavioral reference: TComPicYuvMD5.cpp — calcMD5 (:181, per-plane MD5 over
little-endian samples), compCRC (:87, CRC-16/CCITT bit loop over all sample
bits), compChecksum (:133, xor-masked byte sum).  These are the conformance
mechanism: encoder embeds, decoder recomputes and compares.
"""

from __future__ import annotations

import hashlib
from typing import List

import numpy as np


def _plane_bytes(plane: np.ndarray, bit_depth: int) -> bytes:
    if bit_depth <= 8:
        return plane.astype(np.uint8).tobytes()
    return plane.astype("<u2").tobytes()


def calc_md5(planes, bit_depth: int) -> List[bytes]:
    """Per-plane MD5 digests (Y, Cb, Cr), little-endian sample packing."""
    return [hashlib.md5(_plane_bytes(p, bit_depth)).digest() for p in planes]


def calc_crc(planes, bit_depth: int) -> List[bytes]:
    """CRC-16/CCITT over each sample's bits, MSB-first (compCRC)."""
    out = []
    for plane in planes:
        crc = 0xFFFF
        # vectorize: process bit-planes via numpy over the whole plane in
        # raster order.  The reference's bit loop is equivalent to feeding
        # each sample's bit_depth bits MSB-first into CRC-16/CCITT (poly
        # 0x1021, init 0xffff) then 16 zero bits.
        flat = plane.astype(np.int64).ravel()
        # build the bit string lazily in chunks to keep memory bounded
        table = _crc_table()
        # compCRC feeds data at the REGISTER BOTTOM (crc = ((crc<<1)+bit)
        # ^ (msb*0x1021)), which is long division of init<<n + M(x); the
        # byte-wise equivalent is crc = (((crc&0xff)<<8) ^ T[crc>>8]) ^ b
        # with T[t] = (t*x^16) mod G — NOT the usual top-fed table step.
        if bit_depth == 8:
            data = flat.astype(np.uint8).tobytes()
            for b in data:
                crc = (((crc & 0xFF) << 8) ^ table[crc >> 8]) ^ b
        elif bit_depth == 16:
            data = flat.astype(">u2").tobytes()
            for b in data:
                crc = (((crc & 0xFF) << 8) ^ table[crc >> 8]) ^ b
        else:
            # bit-at-a-time for non-power-of-two depths (10-bit).  NB the
            # reference's bit selection is `dataMsbIdx - (bitIdx & dataMsbIdx)`
            # — a bitwise AND, which for 10-bit yields the quirky shift order
            # 9,8,9,8,9,8,9,8,1,0.  Replicated exactly for conformance.
            msb_idx = bit_depth - 1
            shifts = [msb_idx - (bit_idx & msb_idx) for bit_idx in range(bit_depth)]
            for v in flat:
                v = int(v)
                for sh in shifts:
                    bit = (v >> sh) & 1
                    msb = (crc >> 15) & 1
                    crc = (((crc << 1) + bit) & 0xFFFF) ^ (msb * 0x1021)
        if bit_depth in (8, 16):
            # flush 16 zero bits via table
            crc = ((crc & 0xFF) << 8) ^ table[crc >> 8]
            crc = ((crc & 0xFF) << 8) ^ table[crc >> 8]
        else:
            for _ in range(16):
                msb = (crc >> 15) & 1
                crc = ((crc << 1) & 0xFFFF) ^ (msb * 0x1021)
        out.append(bytes(((crc >> 8) & 0xFF, crc & 0xFF)))
    return out


_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        tbl = []
        for byte in range(256):
            crc = byte << 8
            for _ in range(8):
                crc = ((crc << 1) ^ 0x1021) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
            tbl.append(crc)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def calc_checksum(planes, bit_depth: int) -> List[bytes]:
    """Xor-masked byte sum (compChecksum)."""
    out = []
    for plane in planes:
        h, w = plane.shape
        yy, xx = np.mgrid[0:h, 0:w]
        mask = ((xx & 0xFF) ^ (yy & 0xFF) ^ (xx >> 8) ^ (yy >> 8)).astype(np.int64)
        p = plane.astype(np.int64)
        s = int(np.sum((p & 0xFF) ^ mask))
        if bit_depth > 8:
            s += int(np.sum((p >> 8) ^ mask))
        s &= 0xFFFFFFFF
        out.append(bytes(((s >> 24) & 0xFF, (s >> 16) & 0xFF,
                          (s >> 8) & 0xFF, s & 0xFF)))
    return out


def calc_digest(method: int, planes, bit_depth: int) -> List[bytes]:
    from .headers import (DIGEST_METHOD_CHECKSUM, DIGEST_METHOD_CRC,
                          DIGEST_METHOD_MD5)
    if method == DIGEST_METHOD_MD5:
        return calc_md5(planes, bit_depth)
    if method == DIGEST_METHOD_CRC:
        return calc_crc(planes, bit_depth)
    if method == DIGEST_METHOD_CHECKSUM:
        return calc_checksum(planes, bit_depth)
    raise ValueError(f"unknown digest method {method}")
