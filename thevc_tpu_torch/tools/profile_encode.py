"""Profile the port's native encoder core: per-section cycle totals from
its ``g_prof`` counters (``get_prof``, ``native/codec_core.cpp``) over an
all-intra encode, with the encode's wall and process CPU time.

    python -m thevc_tpu_torch.tools.profile_encode [--frames 2]
        [--width 1920] [--height 1080] [--fastrd] [--device cuda]

The twin of the JAX package's ``tools/profile_encode.py``.  The encode is
the exact path unless ``--fastrd`` asks for ``--FastRD=1``, whose
decision passes run on ``--device``.  The clip is
``tools/make_test_clip.py``'s at the given size.  Counters are time-stamp
counter ticks; a row's share is of the wall time's ticks at the assumed
TSC rate ``TSC_HZ``.  Counter map (the ``PROF_BEGIN`` sites):

   1 sweep: angular prediction     2 sweep: SATD (calc_had)
   3 sweep: mode-bits classes      4 luma RQT RD
   5 RDOQ                          6 chroma search total
   7 es_encode_cu_final           10 bits_qt
  12 final transform tree         13 ADI fill
  15 final intra luma pass        18 inter 2Nx2N   19 merge   20 rect
  21 es_check_intra total         8, 9, 11, 14, 16, 22-27: see the source
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import tempfile
import time
from pathlib import Path

from .. import native
from ..streams import CFG, make_clip
from . import run_encoder

# the time-stamp counter rate assumed for the shares (the JAX tool's)
TSC_HZ = 2.1e9

NAMES = {1: "sweep:pred", 2: "sweep:SATD", 3: "sweep:modebits",
         4: "luma RQT RD", 5: "RDOQ", 6: "chroma total", 7: "cu_final",
         8: "p8", 9: "p9", 10: "bits_qt", 11: "p11", 12: "final_tt",
         13: "ADI", 14: "p14", 15: "final_luma", 16: "p16",
         18: "inter2Nx2N", 19: "merge", 20: "rect", 21: "check_intra",
         22: "p22", 23: "p23"}


def read_counters() -> list:
    """The 32 counters since the last read (reading clears them)."""
    buf = (ctypes.c_uint64 * 32)()
    native.get_lib().get_prof(ctypes.cast(buf, ctypes.c_void_p))
    return list(buf)


def profile(clip, width: int, height: int, frames: int, fastrd: bool,
            device: str) -> dict:
    """Encode ``clip`` and return the wall and CPU seconds and the
    counters of the encode."""
    read_counters()                       # drain
    with tempfile.TemporaryDirectory() as tmp:
        t0, c0 = time.perf_counter(), time.process_time()
        run_encoder(["-c", CFG / "encoder_intra_main.cfg", "-i", clip,
                     "-wdt", width, "-hgt", height, "-f", frames, "-fr", 30,
                     "-b", Path(tmp) / "prof.bin", "--SEIpictureDigest=1",
                     f"--FastRD={int(fastrd)}", "--device", device])
        wall, cpu = time.perf_counter() - t0, time.process_time() - c0
    return {"wall_s": wall, "cpu_s": cpu, "counters": read_counters()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_encode",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--fastrd", action="store_true",
                    help="encode with --FastRD=1")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fast-RD decision passes")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        clip = make_clip(Path(tmp) / "clip.yuv", args.width, args.height,
                         args.frames)
        res = profile(clip, args.width, args.height, args.frames,
                      args.fastrd, args.device)
    dt, dc = res["wall_s"], res["cpu_s"]
    print(f"\nwall {dt:.2f}s cpu {dc:.2f}s for {args.frames} frames "
          f"({dc / args.frames:.2f} cpu-s/frame)")
    total_cyc = TSC_HZ * dt
    rows = sorted(((i, v) for i, v in enumerate(res["counters"]) if v),
                  key=lambda r: -r[1])
    for i, v in rows:
        print(f"prof{i:2d} {NAMES.get(i, '?'):14s} {v / 1e9:8.2f} Gcyc  "
              f"{100.0 * v / total_cyc:5.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
