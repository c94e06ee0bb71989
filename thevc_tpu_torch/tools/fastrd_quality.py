"""Fast-RD quality against the exact path: bits and luma PSNR at equal QP
over a QP sweep, all-intra (``tests/cfg/encoder_intra_main.cfg``).

    python -m thevc_tpu_torch.tools.fastrd_quality [--clip C.yuv]
        [--width 416] [--height 240] [--frames 2] [--qps 22,27,32,37]
        [--device cuda]

The twin of the JAX package's ``tools/fastrd_quality.py``, whose
reference is HM's ``TAppEncoder``.  Here the reference is the port's own
exact path (``--FastRD=0``, the host search that HM runs), which is held
byte-identical to the JAX package's exact encoder
(``tests/test_torch_standalone.py``); HM is not needed.  The fast-RD
encode's decision passes run on ``--device``.  Without ``--clip`` the
clip is ``tools/make_test_clip.py``'s at the given size.  Prints one row
a QP: its exact and fast-RD bits and mean luma PSNRs, then the bit
difference in percent and the PSNR difference in dB, as
``QP22: exact <b>b Y<dB>dB | fast <b>b Y<dB>dB | bits <%>% dPSNR <dB>dB``.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

from ..streams import CFG, make_clip
from . import frame_stats, run_encoder


def encode(clip, width: int, height: int, frames: int, qp: int,
           fast: bool, device: str, out: Path) -> tuple:
    """(bits, mean luma PSNR) of one all-intra encode of ``clip``."""
    log = run_encoder([
        "-c", CFG / "encoder_intra_main.cfg", "-i", clip,
        "-wdt", width, "-hgt", height, "-f", frames, "-fr", 30,
        "-q", qp, "-b", out, "--SEIpictureDigest=1",
        f"--FastRD={int(fast)}", "--device", device])
    return frame_stats(log)


def sweep(clip, width: int, height: int, frames: int, qps,
          device: str) -> list:
    """One row a QP: the exact and fast-RD bits and PSNRs and their
    differences."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for qp in qps:
            eb, ep = encode(clip, width, height, frames, qp, False, device,
                            Path(tmp) / f"exact_{qp}.bin")
            fb, fp = encode(clip, width, height, frames, qp, True, device,
                            Path(tmp) / f"fast_{qp}.bin")
            rows.append(dict(qp=qp, exact_bits=eb, exact_psnr_y=ep,
                             fast_bits=fb, fast_psnr_y=fp,
                             bits_pct=100.0 * (fb - eb) / eb,
                             dpsnr_y=fp - ep))
    return rows


def format_row(r: dict) -> str:
    return (f"QP{r['qp']}: exact {r['exact_bits']}b Y{r['exact_psnr_y']:.3f}dB"
            f" | fast {r['fast_bits']}b Y{r['fast_psnr_y']:.3f}dB | "
            f"bits {r['bits_pct']:+.2f}% dPSNR {r['dpsnr_y']:+.3f}dB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fastrd_quality",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--clip", help="8-bit 4:2:0 clip (default: a "
                    "tools/make_test_clip.py clip of the given size)")
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fast-RD decision passes")
    args = ap.parse_args(argv)
    qps = [int(q) for q in args.qps.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        clip = args.clip or make_clip(Path(tmp) / "clip.yuv", args.width,
                                      args.height, args.frames)
        for row in sweep(clip, args.width, args.height, args.frames, qps,
                         args.device):
            print(format_row(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
