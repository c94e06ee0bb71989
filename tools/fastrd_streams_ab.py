"""The 1080p fast-RD streams of ``chip_smoke.py``, checkout against
checkout, on one card.

Encodes, in each given checkout with that checkout's ``chip_smoke.py``
helpers (its clips, ``port_encode`` and encoder CLI on ``cuda``), the
three 1080p 8-frame fast-RD streams the smoke run checks: the all-intra
clip with the host apply and with ``--device-apply``, and the motion
clip with the low-delay B cfg, QP 32 with SAO.  Each checkout runs in a
child process of its own, one after another in the order given:

    python tools/fastrd_streams_ab.py PARENT CHANGE

Each child builds its checkout's kernels and native core at first use
(in the checkout's ``build/``, where it also writes its clips and
streams).  Prints one ``fastrd_streams_ab <turn> <checkout> {...}`` line
a checkout: per stream its bytes, SHA-256, encode wall, decision wall
and the encoder's kernel launches; then whether every checkout wrote the
same streams.  Exits nonzero when a child fails or the streams differ.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import hashlib, json, sys, time
from pathlib import Path
import torch
import chip_smoke as c
if not torch.cuda.is_available():
    sys.exit("no CUDA card")
work = Path("build") / "fastrd_streams_ab"
work.mkdir(parents=True, exist_ok=True)
intra, motion = work / "intra.yuv", work / "motion.yuv"
c.make_clip(intra, c.WIDTH, c.HEIGHT, c.FRAMES, "default")
c.make_clip(motion, c.WIDTH, c.HEIGHT, c.FRAMES, "motion")
out = {"gpu": c.gpu_line()}
for name, clip, cfg, extra in (
        ("intra", intra, c.CFG / "encoder_intra_main.cfg", ()),
        ("devapply", intra, c.CFG / "encoder_intra_main.cfg",
         ("--device-apply",)),
        ("ldb", motion, c.LDB_CFG, ())):
    stream = work / f"{name}.bin"
    t = time.perf_counter()
    rep = c.port_encode(clip, stream, work / f"{name}_rec.yuv", c.WIDTH,
                        c.HEIGHT, c.FRAMES, c.QP, "cuda", cfg=cfg,
                        extra=extra)
    data = stream.read_bytes()
    out[name] = {"bytes": len(data),
                 "sha256": hashlib.sha256(data).hexdigest(),
                 "wall_s": time.perf_counter() - t,
                 "decision_wall_s": rep["decision_wall_s"],
                 "launches": {k: v for k, v in rep.items()
                              if k.endswith("_launches")}}
print("streams " + json.dumps(out), flush=True)
"""
STREAMS = ("intra", "devapply", "ldb")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+", type=Path)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a child may take")
    args = ap.parse_args(argv)
    failed, digests = 0, set()
    for turn, checkout in enumerate(args.checkouts):
        r = subprocess.run([sys.executable, "-c", CHILD],
                           cwd=checkout.resolve(), capture_output=True,
                           text=True, timeout=args.timeout)
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("streams ")]
        if r.returncode or not lines:
            failed += 1
            print(f"fastrd_streams_ab {turn} {checkout} rc={r.returncode}\n"
                  + r.stdout[-3000:] + r.stderr[-3000:], flush=True)
            continue
        got = json.loads(lines[-1][len("streams "):])
        print(f"fastrd_streams_ab {turn} {checkout} " + json.dumps(got),
              flush=True)
        digests.add(tuple((got[k]["bytes"], got[k]["sha256"])
                          for k in STREAMS))
    same = len(digests) == 1 and not failed
    print(f"fastrd_streams_ab identical={same}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
