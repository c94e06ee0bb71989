"""YUV bit-depth converter (convert_NtoMbit_YCbCr).

Behavioral reference: source/App/utils/convert_NtoMbit_YCbCr.cpp — reads a
planar 4:2:0 file at one bit depth and writes it at another using the same
scale/round rules as TVideoIOYuv (scalePlane/invScalePlane,
TVideoIOYuv.cpp:62-128), which our io.yuv module mirrors.

Usage: python -m thevc_tpu_torch.apps.convert_bitdepth -i in.yuv -o out.yuv \
           --SourceWidth W --SourceHeight H --InputBitDepth 8 \
           --OutputBitDepth 10 [--NumFrames N] [-fs SKIP]
"""

from __future__ import annotations

import argparse
import sys

from ..io.yuv import YuvReader, YuvWriter


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="convert_bitdepth")
    ap.add_argument("-i", "--InputFile", required=True)
    ap.add_argument("-o", "--OutputFile", required=True)
    ap.add_argument("--SourceWidth", type=int, required=True)
    ap.add_argument("--SourceHeight", type=int, required=True)
    ap.add_argument("--InputBitDepth", type=int, default=8)
    ap.add_argument("--OutputBitDepth", type=int, default=8)
    ap.add_argument("--NumFrames", type=int, default=-1)
    ap.add_argument("-fs", "--FrameSkip", type=int, default=0)
    args = ap.parse_args(argv)

    # TVideoIOYuv semantics: the file is read at InputBitDepth and scaled to
    # the internal depth (= OutputBitDepth here), then written unscaled.
    reader = YuvReader(args.InputFile, args.SourceWidth, args.SourceHeight,
                       file_bit_depth=args.InputBitDepth,
                       internal_bit_depth=args.OutputBitDepth)
    writer = YuvWriter(args.OutputFile, args.OutputBitDepth,
                       args.OutputBitDepth)
    reader.skip_frames(args.FrameSkip)
    done = 0
    while args.NumFrames < 0 or done < args.NumFrames:
        frame = reader.read_frame()
        if frame is None:
            break
        writer.write_frame(frame)
        done += 1
    writer.close()
    print(f"processed {done} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
