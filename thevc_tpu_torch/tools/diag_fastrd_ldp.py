"""Diagnose the fast-RD overhead of a low-delay P encode: encode a clip on
the exact path and with ``--FastRD=1``, decode both streams keeping each
picture's decision maps, and compare their statistics: bytes and encode
wall, every NAL's size, and per picture the CU depth histogram and the
shares of intra, skip and merge 4x4 units.

    python -m thevc_tpu_torch.tools.diag_fastrd_ldp [--clip C.yuv]
        [--width 416] [--height 240] [--frames 5] [--qp 32] [--device cuda]

The twin of the JAX package's ``tools/diag_fastrd_ldp.py``, with the
port's encoder and decoder and ``tests/cfg/encoder_lowdelay_P_main.cfg``.
The fast-RD decision passes and the decodes run on ``--device``.  The
streams are made anew each run (the JAX tool caches them).  Without
``--clip`` the clip is ``tools/make_test_clip.py``'s at the given size.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from .. import nal
from ..decoder.frame import MODE_INTRA
from ..decoder.top import Decoder
from ..encoder.top import DecisionStats, Encoder
from ..streams import CFG, make_clip
from ..utils.cfg import parse_args


def encode(clip, width: int, height: int, frames: int, qp: int, fast: bool,
           device: str) -> tuple:
    """(stream bytes, wall seconds) of one low-delay P encode."""
    cfg = parse_args(["-c", str(CFG / "encoder_lowdelay_P_main.cfg"),
                      "-i", str(clip), "-wdt", str(width), "-hgt",
                      str(height), "-f", str(frames), "-fr", "30",
                      "-q", str(qp), "--SEIpictureDigest=1",
                      f"--FastRD={int(fast)}"])
    enc = Encoder(cfg, device=device if fast else None,
                  stats=DecisionStats())
    enc.verbose = False
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        stream = enc.encode(None)
    return stream, time.perf_counter() - t0


def stats(stream: bytes, width: int, height: int, device: str) -> list:
    """Per picture (POC order): the depth histogram and the intra, skip
    and merge shares of its 4x4 units inside the picture."""
    dec = Decoder(device)
    dec.keep_models = True
    with contextlib.redirect_stdout(io.StringIO()):
        for unit in nal.iter_annexb_nals(stream):
            dec.decode_nal(unit)
        dec.flush()
    pics = sorted(dec.pictures, key=lambda p: p.poc)
    if not all(p.digest_ok for p in pics):
        raise RuntimeError("a picture's digest does not verify")
    rows = []
    for p in pics:
        f = p.model
        inside = (slice(0, height // 4), slice(0, width // 4))
        depth = np.asarray(f.depth)[inside].ravel()
        rows.append(dict(
            poc=p.poc,
            depth_hist=np.bincount(np.maximum(depth, 0), minlength=4)[:4],
            intra_pct=100.0 * (np.asarray(f.pred_mode)[inside]
                               == MODE_INTRA).mean(),
            skip_pct=100.0 * (np.asarray(f.skip)[inside] != 0).mean(),
            merge_pct=100.0 * (np.asarray(f.merge_flag)[inside]
                               != 0).mean()))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="diag_fastrd_ldp",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--clip", help="8-bit 4:2:0 clip (default: a "
                    "tools/make_test_clip.py clip of the given size)")
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--qp", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fast-RD decision passes and "
                         "the decodes")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        clip = args.clip or make_clip(Path(tmp) / "clip.yuv", args.width,
                                      args.height, args.frames)
        s_exact, dt_e = encode(clip, args.width, args.height, args.frames,
                               args.qp, False, args.device)
        s_fast, dt_f = encode(clip, args.width, args.height, args.frames,
                              args.qp, True, args.device)
    print(f"exact: {len(s_exact)} bytes  {dt_e:.1f}s")
    print(f"fast : {len(s_fast)} bytes  {dt_f:.1f}s  "
          f"overhead {100.0 * (len(s_fast) / len(s_exact) - 1):.1f}%")
    for name, s in (("exact", s_exact), ("fast", s_fast)):
        sizes = [(u.nal_type, len(u.rbsp)) for u in nal.iter_annexb_nals(s)]
        print(name, "NAL sizes:", sizes)
    for name, s in (("exact", s_exact), ("fast", s_fast)):
        print(f"--- {name} ---")
        for r in stats(s, args.width, args.height, args.device):
            print(f"  poc {r['poc']}: depth {r['depth_hist']} "
                  f"intra {r['intra_pct']:.1f}% skip {r['skip_pct']:.1f}% "
                  f"merge {r['merge_pct']:.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
