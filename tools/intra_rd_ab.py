"""The intra decision kernels (``csrc/intra_rd.cu`` and the select and pick
of ``csrc/intra_select.cu``) on the recorded 1080p calls, checkout against
checkout, on one card.

In each given checkout, with that checkout's ``chip_smoke.py`` helpers and
kernels, records the kernel calls of three decision passes: the 1080p
all-intra clip's first I frame (the sweep, the intra TU-RD entry, the
select and the pick), the same frame as 10 bits (samples << 2, QPs + 12),
and the last B frame of the motion clip's 4-frame low-delay B encode (the
TU-RD given entry, the select and the pick of its intra leaves), QP 32
with SAO, as ``chip_smoke.py`` replays them.  Each recorded call is held
against its plain form (``held_intra_calls``: SATD and dist tolerance 0,
bits bit for bit) and timed, 20 eager calls and a CUDA graph of 20; an
entry's calls of a pass are summed (a checkout that launches the select
once a luma class, against one that launches it once a pass, compares
the pass's sum), and each call's graph time is kept in the order of the
calls (``graph_ms_calls``).  Each pass is also run whole 15 times,
synchronised, after a warm-up (``pass_wall_ms``: the 8-bit I frame's and
the B frame's walls, host included, sorted).  Each checkout runs in a
child process of its own, one after another in the order given; give the parent and the
change in turns to compare them on one card:

    python tools/intra_rd_ab.py PARENT CHANGE CHANGE PARENT

Each child builds its checkout's kernels and native core at first use
(in the checkout's ``build/``, where it also writes its clips).  Prints
the card's name and power limit and one ``intra_rd_ab <turn> <checkout>
{...}`` line a turn (per pass and entry: calls, summed eager and graph
ms, each call's graph ms), at each checkout's first turn one
``intra_rd_ab_build <checkout> {...}`` line (``chip_smoke.build_report``
of its ``csrc/intra_select.cu`` library: registers, stack frame, spills,
SASS counts), then ``intra_rd_ab_summary``: per checkout the least of
its turns, and each checkout's times over the first checkout's.  With
``--log PATH`` it appends the lines to that JSON-lines file.  Exits
nonzero when a child fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

CHILD = """
import json, sys, time
from pathlib import Path
import numpy as np
import torch
import chip_smoke as c
from thevc_tpu_torch.encoder import fast_inter, fast_intra
if not torch.cuda.is_available():
    sys.exit("no CUDA card")
work = Path("build") / "intra_rd_ab"
work.mkdir(parents=True, exist_ok=True)
intra = work / f"intra_{c.WIDTH}x{c.HEIGHT}_{c.FRAMES}f.yuv"
motion = work / f"motion_{c.WIDTH}x{c.HEIGHT}_{c.FRAMES}f.yuv"
c.make_clip(intra, c.WIDTH, c.HEIGHT, c.FRAMES, "default")
c.make_clip(motion, c.WIDTH, c.HEIGHT, c.FRAMES, "motion")
print("gpu " + c.gpu_line(), flush=True)
out = {}

def held(tag, run, entries):
    calls = {}
    with c.recorded_intra_kernel_calls(calls):
        run()
    calls = {k: v for k, v in calls.items() if k in entries}
    _, rows = c.held_intra_calls(torch, calls, entries, tag)
    out[tag] = {k: {"calls": len(v), "ms": sum(r["ms"] for r in v),
                    "graph_ms": sum(r["graph_ms"] for r in v),
                    "graph_ms_calls": [r["graph_ms"] for r in v]}
                for k, v in rows.items() if v}

def walls(run, n=15):
    run()
    out_w = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out_w.append(1000 * (time.perf_counter() - t))
    return sorted(out_w)

args = c.recorded_i_call(intra, work)
(y, cb, cr, w, h, qp, qp_cb, qp_cr, *rest) = args
args10 = (*(p.astype(np.int16) << 2 for p in (y, cb, cr)), w, h,
          qp + 12, qp_cb + 12, qp_cr + 12, *rest[:-2], 2, 1023)
for tag, a in (("i_frame", args), ("i_frame_10bit", args10)):
    fast_intra.decide_frame(*a, device="cuda")
    held(tag, lambda a=a: fast_intra.decide_frame(*a, device="cuda"),
         ("sweep", "tu_rd_intra", "select", "pick"))
b_args, refs1 = c.recorded_b_call(motion, work)
cache = fast_inter.RefCache()

def b_frame():
    return fast_inter.decide_frame_p(*b_args, ref_pics_l1=refs1,
                                     device="cuda", ref_cache=cache)
b_frame()
held("b_frame", b_frame, ("tu_rd_given", "select", "pick"))
out["pass_wall_ms"] = {
    "i_frame": walls(lambda: fast_intra.decide_frame(*args, device="cuda")),
    "b_frame": walls(b_frame)}
from thevc_tpu_torch.ops import build
out["intra_select_library"] = str(build.library_path("intra_select"))
print("intra_rd_ab " + json.dumps(out), flush=True)
"""
KEEP = ("gpu ", "intra_rd_ab ")


def summary(results: list) -> dict:
    """Per checkout the least eager and graph ms of its turns, per pass
    and entry, and its times over the first checkout's; each pass's
    median wall a turn."""
    best: dict = {}
    for checkout, res in results:
        mine = best.setdefault(checkout, {})
        for tag, entries in res.items():
            if tag == "pass_wall_ms":
                for name, w in entries.items():
                    mine.setdefault(f"{name}/median_wall_ms_turns",
                                    []).append(w[len(w) // 2])
                continue
            if not isinstance(entries, dict):
                continue
            for entry, row in entries.items():
                cur = mine.setdefault(f"{tag}/{entry}",
                                      dict(calls=row["calls"]))
                for k in ("ms", "graph_ms"):
                    cur[k] = min(cur.get(k, row[k]), row[k])
    first = next(iter(best.values()), {})
    for mine in best.values():
        for key, row in mine.items():
            if key in first and isinstance(row, dict):
                for k in ("ms", "graph_ms"):
                    row[f"{k}_over_first"] = row[k] / first[key][k]
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+", type=Path)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a child may take")
    ap.add_argument("--log", type=Path,
                    help="append the kept lines to this JSON-lines file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import build_report
    failed = 0
    results = []
    lines = []
    built: set = set()
    for turn, checkout in enumerate(args.checkouts):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", CHILD],
                           cwd=checkout.resolve(), capture_output=True,
                           text=True, timeout=args.timeout)
        head = f"intra_rd_ab {turn} {checkout}"
        print(f"{head} rc={r.returncode} "
              f"wall_s={time.perf_counter() - t:.1f}", flush=True)
        for line in r.stdout.splitlines():
            if line.startswith(KEEP):
                print(f"{head} {line}", flush=True)
                lines.append({"turn": turn, "checkout": str(checkout),
                              "line": line})
            if line.startswith("intra_rd_ab "):
                res = json.loads(line.split(" ", 1)[1])
                results.append((str(checkout), res))
                if str(checkout) not in built:
                    built.add(str(checkout))
                    bline = f"intra_rd_ab_build {checkout} " + json.dumps(
                        build_report(Path(res["intra_select_library"])))
                    print(bline, flush=True)
                    lines.append({"line": bline})
        if r.returncode:
            failed += 1
            print(r.stdout[-3000:] + r.stderr[-3000:], flush=True)
    line = "intra_rd_ab_summary " + json.dumps(summary(results))
    print(line, flush=True)
    lines.append({"line": line})
    if args.log:
        args.log.parent.mkdir(parents=True, exist_ok=True)
        with open(args.log, "a") as log:
            for entry in lines:
                log.write(json.dumps(entry) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
