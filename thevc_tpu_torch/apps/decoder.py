"""Decoder CLI of the port, with the output lines and exit code of
``thevc_tpu/apps/decoder.py`` (TAppDecoder).

Usage: python -m thevc_tpu_torch.apps.decoder -b str.bin -o rec.yuv
       [--device cuda]

It decodes Main streams with I, P and B pictures (all-intra, low-delay,
random access; 8- and 10-bit; weighted prediction and scaling lists;
slices, dependent slices, tiles and WPP): stage-1 residuals, motion
compensation and the in-loop filters run on the device, the CABAC parse
and the intra walk on the host.

``--device`` defaults to ``cuda`` and fails when CUDA is absent; the CPU
is used only when ``--device cpu`` asks for it.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..io.yuv import YuvWriter

from ..decoder.top import Decoder


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="thevc-torch-dec")
    ap.add_argument("-b", "--BitstreamFile", required=True, dest="bitstream")
    ap.add_argument("-o", "--ReconFile", dest="recon", default=None)
    ap.add_argument("-s", "--SkipFrames", type=int, default=0)
    ap.add_argument("-t", "--MaxTemporalLayer", type=int, default=-1)
    ap.add_argument("--OutputBitDepth", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the decode's device path "
                         "(cuda or cpu; default cuda)")
    args = ap.parse_args(argv)

    with open(args.bitstream, "rb") as fh:
        data = fh.read()
    dec = Decoder(args.device, max_temporal_layer=args.MaxTemporalLayer,
                  skip_frames=args.SkipFrames)
    t0 = time.time()
    pics = dec.decode_stream(data)
    if dec.device.type == "cuda":
        torch.cuda.synchronize(dec.device)
    dt = time.time() - t0

    writer = None
    # TAppDecTop.cpp:182: output bit depth defaults to the internal depth
    internal_bd = 8
    crop = (0, 0, 0, 0)
    for sps in dec.sps_map.values():
        internal_bd = sps.internal_bit_depth
        if sps.pic_cropping_flag:
            # SPS cropping window applied on output (TAppDecTop.cpp:195)
            crop = (sps.pic_crop_left_offset, sps.pic_crop_right_offset,
                    sps.pic_crop_top_offset, sps.pic_crop_bottom_offset)
    for pic in pics:
        digest_msg = ""
        if pic.digest_ok is not None:
            digest_msg = " [MD5:(OK)]" if pic.digest_ok \
                else " [MD5:(***ERROR***)]"
        print(f"POC {pic.poc:4d} ( ?-SLICE ) {digest_msg}")
        if pic.digest_ok is False:
            print("ERROR: digest mismatch", file=sys.stderr)
        if args.recon:
            if writer is None:
                out_bd = args.OutputBitDepth or internal_bd
                writer = YuvWriter(args.recon, out_bd, internal_bd,
                                   crop=crop)
            writer.write_frame(pic.frame)
    if writer:
        writer.close()
    print(f" Total Time: {dt:8.3f} sec.")
    return 0 if all(p.digest_ok is not False for p in pics) else 1


if __name__ == "__main__":
    sys.exit(main())
