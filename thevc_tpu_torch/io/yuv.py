"""Planar YUV 4:2:0 file I/O with bit-depth scaling.

Behavioral reference: HM TLibVideoIO/TVideoIOYuv.cpp — readPlane/writePlane
(8-bit bytes or 16-bit little-endian words), scalePlane/invScalePlane
(shift up on read when internal depth > file depth; round+clip on write),
and skipFrames.

Frames are held as numpy int16 arrays (the HM `Pel` type); the encoder /
decoder move whole frames to device once per frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class YuvFrame:
    """One 4:2:0 frame: y is (H, W), cb/cr are (H/2, W/2), int16."""
    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray

    @property
    def width(self) -> int:
        return self.y.shape[1]

    @property
    def height(self) -> int:
        return self.y.shape[0]

    def planes(self):
        return (self.y, self.cb, self.cr)


class YuvReader:
    def __init__(self, path: str, width: int, height: int,
                 file_bit_depth: int = 8, internal_bit_depth: int = 8,
                 pad_x: int = 0, pad_y: int = 0) -> None:
        """width/height are the CODED (padded) dimensions; the file holds
        (width-pad_x) x (height-pad_y) frames that are edge-extended on
        read (TVideoIOYuv::read aiPad, readPlane pad_x/pad_y)."""
        self.width = width
        self.height = height
        self.pad_x = pad_x
        self.pad_y = pad_y
        self.file_bit_depth = file_bit_depth
        self.internal_bit_depth = internal_bit_depth
        self._shift = internal_bit_depth - file_bit_depth
        self._fd = open(path, "rb")
        self._wordsize = 2 if file_bit_depth > 8 else 1
        self._frame_bytes = (self._wordsize * (width - pad_x)
                             * (height - pad_y) * 3 // 2)

    def skip_frames(self, n: int) -> None:
        if n:
            self._fd.seek(self._frame_bytes * n, 1)

    def num_frames_remaining(self) -> int:
        """Frames available from the current position (by file size)."""
        import os
        pos = self._fd.tell()
        end = os.fstat(self._fd.fileno()).st_size
        return max(0, (end - pos) // self._frame_bytes)

    def read_frame_at(self, idx: int, base: int = 0) -> Optional[YuvFrame]:
        """Random-access read of frame base+idx (seek; position-independent,
        used by the GOP-windowed frame source)."""
        self._fd.seek(self._frame_bytes * (base + idx), 0)
        return self.read_frame()

    def read_frame(self) -> Optional[YuvFrame]:
        data = self._fd.read(self._frame_bytes)
        if len(data) < self._frame_bytes:
            return None
        dtype = "<u2" if self._wordsize == 2 else np.uint8
        raw = np.frombuffer(data, dtype=dtype)
        w, h = self.width - self.pad_x, self.height - self.pad_y
        y = raw[: w * h].reshape(h, w).astype(np.int16)
        cb = raw[w * h: w * h + w * h // 4].reshape(h // 2, w // 2).astype(np.int16)
        cr = raw[w * h + w * h // 4:].reshape(h // 2, w // 2).astype(np.int16)
        if self.pad_x or self.pad_y:
            # edge-extension padding (readPlane, TVideoIOYuv.cpp:273-284)
            y = np.pad(y, ((0, self.pad_y), (0, self.pad_x)), mode="edge")
            cb = np.pad(cb, ((0, self.pad_y // 2), (0, self.pad_x // 2)),
                        mode="edge")
            cr = np.pad(cr, ((0, self.pad_y // 2), (0, self.pad_x // 2)),
                        mode="edge")
        if self._shift > 0:
            y, cb, cr = (p << self._shift for p in (y, cb, cr))
        elif self._shift < 0:
            s = -self._shift
            off = 1 << (s - 1)
            maxv = (1 << self.internal_bit_depth) - 1
            y, cb, cr = (np.clip((p + off) >> s, 0, maxv).astype(np.int16)
                         for p in (y, cb, cr))
        return YuvFrame(y, cb, cr)

    def close(self) -> None:
        self._fd.close()


class YuvWriter:
    def __init__(self, path: str, file_bit_depth: int = 8,
                 internal_bit_depth: int = 8, append: bool = False,
                 crop: Tuple[int, int, int, int] = (0, 0, 0, 0)) -> None:
        """crop = (left, right, top, bottom) in luma samples, removed on
        write (TVideoIOYuv::write cropLeft..cropBottom; chroma halved).

        NB the reference writes the TOP-LEFT (w-l-r)x(h-t-b) window — its
        planeOffset for left/top cropping is commented out
        (TVideoIOYuv.cpp:446 `Int planeOffset = 0; //cropLeft + ...`)."""
        self.file_bit_depth = file_bit_depth
        self.internal_bit_depth = internal_bit_depth
        self._shift = internal_bit_depth - file_bit_depth
        self.crop = crop
        self._fd = open(path, "ab" if append else "wb")

    def write_frame(self, frame: YuvFrame) -> None:
        is16 = self.file_bit_depth > 8
        cl, cr_, ct, cb = self.crop
        for i, plane in enumerate(frame.planes()):
            if cl or cr_ or ct or cb:
                d = 1 if i == 0 else 2
                h, w = plane.shape
                plane = plane[: h - (ct + cb) // d, : w - (cl + cr_) // d]
            p = plane.astype(np.int32)
            if self._shift > 0:
                off = 1 << (self._shift - 1)
                maxv = (1 << self.file_bit_depth) - 1
                p = np.clip((p + off) >> self._shift, 0, maxv)
            elif self._shift < 0:
                p = p << (-self._shift)
            if is16:
                self._fd.write(p.astype("<u2").tobytes())
            else:
                self._fd.write(p.astype(np.uint8).tobytes())

    def close(self) -> None:
        self._fd.close()
