"""Interleaved A/B timing of two builds of the port's native core.

    python -m thevc_tpu_torch.tools.ab_bench A.so B.so [--rounds 3]
        [--frames 2] [--width 1920] [--height 1080]

A host's CPU frequency drifts from minute to minute, so single timings
say little.  Each run is a child process that loads one library through
``thevc_tpu_torch.native.use_library`` and encodes the clip twice on the
exact all-intra path (``tests/cfg/encoder_intra_main.cfg``; the first
encode warms up, the second is timed by its process CPU time).  The
rounds alternate A and B in ABBA order, then BAAB, to cancel a linear
drift, and the tool prints each run's time, each build's median and
minimum, and the ratios B/A.

The twin of the JAX package's ``tools/ab_bench.py``, which copies each
library over the package's own.  The port names its library by a hash of
its sources (``build/thevc_tpu_torch/codec_core-<hash>.so``), so a child
loads the named file instead; a variant is built with the flags of
``native/__init__.py`` from another version of ``codec_core.cpp`` (a
library that lacks an entry point the port binds does not load).  The
clip is ``tools/make_test_clip.py``'s at the given size.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

from ..streams import ROOT, make_clip

CHILD = r"""
import sys, time
from thevc_tpu_torch import native
native.use_library(sys.argv[1])
from thevc_tpu_torch.streams import CFG
from thevc_tpu_torch.tools import run_encoder
so, clip, w, h, frames, out = sys.argv[1:]
argv = ["-c", CFG / "encoder_intra_main.cfg", "-i", clip, "-wdt", w,
        "-hgt", h, "-f", frames, "-fr", 30, "-b", out,
        "--SEIpictureDigest=1"]
run_encoder(argv)
c0, t0 = time.process_time(), time.perf_counter()
run_encoder(argv)
print("LIB", native.get_lib()._name)
print("CPUS %.3f WALL %.3f" % (time.process_time() - c0,
                               time.perf_counter() - t0))
"""


def run_one(so: Path, clip: Path, width: int, height: int, frames: int,
            out: Path) -> float:
    """Process CPU seconds of one timed encode with library ``so``."""
    r = subprocess.run([sys.executable, "-c", CHILD, str(so), str(clip),
                        str(width), str(height), str(frames), str(out)],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    lines = dict(ln.split(" ", 1) for ln in r.stdout.splitlines()
                 if ln.startswith(("LIB ", "CPUS ")))
    if r.returncode != 0 or "CPUS" not in lines:
        raise RuntimeError(f"the run with {so} failed ({r.returncode}):\n"
                           f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
    if Path(lines["LIB"]).resolve() != so.resolve():
        raise RuntimeError(f"the run loaded {lines['LIB']}, not {so}")
    return float(lines["CPUS"].split()[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ab_bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("a_so", type=Path)
    ap.add_argument("b_so", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args(argv)
    res = {"A": [], "B": []}
    with tempfile.TemporaryDirectory() as tmp:
        clip = make_clip(Path(tmp) / "clip.yuv", args.width, args.height,
                         args.frames)
        out = Path(tmp) / "ab.bin"
        for r in range(args.rounds):
            order = "ABBA" if r % 2 == 0 else "BAAB"
            for tag in order:
                so = args.a_so if tag == "A" else args.b_so
                t = run_one(so, clip, args.width, args.height, args.frames,
                            out)
                res[tag].append(t)
                print(f"round {r} {tag}: {t:.3f} cpu-s", flush=True)
    ma, mb = statistics.median(res["A"]), statistics.median(res["B"])
    print(f"A median {ma:.3f}  B median {mb:.3f}  B/A {mb / ma:.4f}")
    print(f"A min {min(res['A']):.3f}  B min {min(res['B']):.3f}  "
          f"minB/minA {min(res['B']) / min(res['A']):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
