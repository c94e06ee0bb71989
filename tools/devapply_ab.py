"""The device apply of one 1080p frame, checkout against checkout, on
one card.

Runs the ``devapply_frame_phase`` of each given checkout's
``chip_smoke.py`` (the recorded first frame of its 1080p all-intra clip,
QP 32 with RDOQ: the apply in the kernel form and in the plain form, its
walls, spans, device time and checks) in a child process of its own, in
that checkout, one after another in the order given; the card's name
and power limit (``gpu`` lines) before each.  Give the parent and the
change in turns (``A B B A``) to compare them on one card:

    python tools/devapply_ab.py PARENT CHANGE CHANGE PARENT

Each child builds its checkout's kernels and native core at first use
(in the checkout's ``build/``) and writes its clip there.  Prints the
children's ``fastrd_devapply_stages`` and ``fastrd_devapply_frame``
lines, each after ``devapply_ab <turn> <checkout>``, and with ``--log
PATH`` appends them to that JSON-lines file.  Exits nonzero when a child
fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

CHILD = """
import sys
from pathlib import Path
import torch
import chip_smoke as c
if not torch.cuda.is_available():
    sys.exit("no CUDA card")
work = Path("build") / "chip_smoke"
work.mkdir(parents=True, exist_ok=True)
clip = work / f"intra_{c.WIDTH}x{c.HEIGHT}_{c.FRAMES}f.yuv"
c.make_clip(clip, c.WIDTH, c.HEIGHT, c.FRAMES)
print("gpu " + c.gpu_line(), flush=True)
c.devapply_frame_phase(torch, clip, work)
"""
KEEP = ("gpu ", "fastrd_devapply_stages ", "fastrd_devapply_frame ",
        "fastrd_devapply_frame_kernel ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+", type=Path)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a child may take")
    ap.add_argument("--log", type=Path,
                    help="append the kept lines to this JSON-lines file")
    args = ap.parse_args(argv)
    failed = 0
    log = None
    if args.log:
        args.log.parent.mkdir(parents=True, exist_ok=True)
        log = open(args.log, "a")
    with contextlib.ExitStack() as stack:
        if log is not None:
            stack.enter_context(log)
        for turn, checkout in enumerate(args.checkouts):
            t = time.perf_counter()
            r = subprocess.run([sys.executable, "-c", CHILD],
                               cwd=checkout.resolve(), capture_output=True,
                               text=True, timeout=args.timeout)
            head = f"devapply_ab {turn} {checkout}"
            print(f"{head} rc={r.returncode} "
                  f"wall_s={time.perf_counter() - t:.1f}", flush=True)
            for line in r.stdout.splitlines():
                if line.startswith(KEEP):
                    print(f"{head} {line}", flush=True)
                    if log is not None:
                        log.write(json.dumps({"turn": turn,
                                              "checkout": str(checkout),
                                              "line": line}) + "\n")
            if r.returncode:
                failed += 1
                print(r.stdout[-3000:] + r.stderr[-3000:], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
