"""The P/B decision pass of one 1080p B frame and its motion-search and
pick kernels (``csrc/inter_me.cu``), checkout against checkout, on one
card:
walls, per stage its wall, device time and device activities, and each
kernel's calls held against their plain forms and timed.

In each given checkout, with that checkout's ``chip_smoke.py`` helpers
and port, encodes the first 4 frames of the 1080p motion clip with the
low-delay B cfg at QP 32 (``recorded_b_call``, as ``chip_smoke.py``
replays it) and runs the last B frame's recorded
``fast_inter.decide_frame_p`` call again on ``cuda``: a warm-up, three
synchronised walls, then one call with stage timing on under
``torch.profiler`` (``stage_profile`` of this tool's own
``chip_smoke.py``, which charges each device activity to the
``fast_inter.*`` stage that launched it).  A checkout whose stages open
no profiler range gets them here.  Then the frame's kernel calls of
``csrc/inter_me.cu`` (2 coarse searches, 8 refinements, 8 merge models,
and where the checkout has them 8 quarter-pel picks and one bi pick),
and the same frame's as 10 bits (``ten_bit_b_call``), are recorded and held
against their plain forms with this tool's own ``held_inter_me_calls``,
so that every checkout is timed by the same code (tolerance 0, floats
bit for bit): each call eager (CUDA events around 20 calls) and as a
CUDA graph of 20, with its size class, summed per kernel and per class,
beside the bound.  Each checkout runs in a child process of its own, one
after another in the order given; give the parent and the change in
turns to compare them on one card:

    python tools/inter_me_ab.py PARENT CHANGE CHANGE PARENT

Each child builds its checkout's kernels and native core at first use
(in the checkout's ``build/``, where it also writes its clip).  Prints
the card's name and power limit, one ``inter_me_ab <turn> <checkout>
{...}`` line a turn and, for each checkout's first turn, one
``inter_me_ab_build <checkout> {...}`` line (``chip_smoke.build_report``
of this tool's checkout on that checkout's motion-search library:
registers, spills, SASS counts and loops), then
``inter_me_ab_summary``: per checkout the least of its turns (walls,
device time, each stage's wall, device time, activities and largest
device items, and per bit depth and kernel its calls' eager and graph
ms, the graph ms by size class and the share of the bound) and each
kernel's times, and each class's, over the first checkout's.  With ``--log
PATH`` it appends the lines to that JSON-lines file.  Exits nonzero when
a child fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
CHILD = """
import contextlib, importlib.util, json, sys
from pathlib import Path
import torch
import chip_smoke as c
from thevc_tpu_torch.encoder import fast_inter, fast_intra
if not torch.cuda.is_available():
    sys.exit("no CUDA card")
spec = importlib.util.spec_from_file_location("inter_me_ab_smoke", SMOKE)
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)


def ranged(stage):
    @contextlib.contextmanager
    def ranged_stage(name, device):
        with torch.profiler.record_function(name), stage(name, device):
            yield
    return ranged_stage


for mod in (fast_inter, fast_intra):
    if hasattr(mod, "stage"):
        mod.stage = ranged(mod.stage)
work = Path("build") / "inter_me_ab"
work.mkdir(parents=True, exist_ok=True)
motion = work / f"motion_{c.WIDTH}x{c.HEIGHT}_{c.FRAMES}f.yuv"
c.make_clip(motion, c.WIDTH, c.HEIGHT, c.FRAMES, "motion")
print("gpu " + c.gpu_line(), flush=True)
args, refs1 = c.recorded_b_call(motion, work)
cache = fast_inter.RefCache()


def run():
    return fast_inter.decide_frame_p(*args, ref_pics_l1=refs1,
                                     device="cuda", ref_cache=cache)


run()
walls = []
for _ in range(3):
    torch.cuda.synchronize()
    t = tool.time.perf_counter()
    run()
    walls.append(1000 * (tool.time.perf_counter() - t))
out = tool.stage_profile(torch, run)
out.update(profiled_wall_ms=out.pop("wall_ms"), wall_ms=walls)
kernels = {}
for tag, (a, r1) in (("8bit", (args, refs1)),
                     ("10bit", c.ten_bit_b_call(args, refs1))):
    kcache = fast_inter.RefCache()

    def run_k(a=a, r1=r1, kcache=kcache):
        return fast_inter.decide_frame_p(*a, ref_pics_l1=r1, device="cuda",
                                         ref_cache=kcache)
    run_k()
    mcalls = {}
    tool.zero_inter_me_counts()
    with tool.recorded_inter_me_calls(mcalls):
        run_k()
    launches = tool.inter_me_counts()
    err, sums = tool.held_inter_me_calls(torch, mcalls, tag, launches)
    kernels[tag] = {name: {k: row[k] for k in (
        "calls", "launches", "ms", "graph_ms", "bound_ms", "max_abs_err",
        "per_call_graph_ms", "per_call_ms", "per_call_class", "by_class")}
        for name, row in sums.items()}
    del mcalls, kcache
out["kernels"] = kernels
from thevc_tpu_torch.ops import build
out["inter_me_library"] = str(build.library_path("inter_me"))
print("inter_me_ab " + json.dumps(out), flush=True)
"""
KEEP = ("gpu ", "inter_me_ab ")


def summary(results: list) -> dict:
    """Per checkout the least of its turns: the median wall, the
    profiled call's device time and activities, each stage's wall,
    device time and activities (its largest device items as in its first
    turn), and per bit depth and kernel its calls' summed eager and graph
    ms and graph ms by size class, with each kernel's times (and each
    class's) over the first checkout's."""
    best: dict = {}
    for checkout, res in results:
        mine = best.setdefault(checkout, {})
        cur = dict(median_wall_ms=sorted(res["wall_ms"])[1],
                   device_ms=res["device_ms"],
                   activities=res["activities"])
        for k, v in cur.items():
            mine[k] = min(mine.get(k, v), v)
        stages = mine.setdefault("stages", {})
        for name, row in res["stages"].items():
            s = stages.setdefault(name, dict(row))
            for k, v in row.items():
                if isinstance(v, (int, float)):
                    s[k] = min(s[k], v)
        kernels = mine.setdefault("kernels", {})
        for tag, rows in res.get("kernels", {}).items():
            for name, row in rows.items():
                k = kernels.setdefault(f"{tag}/{name}", dict(
                    calls=row["calls"], launches=row["launches"],
                    bound_ms=row["bound_ms"]))
                for key in ("ms", "graph_ms"):
                    k[key] = min(k.get(key, row[key]), row[key])
                by_class = k.setdefault("graph_ms_by_class", {})
                for cls, ms in row.get("by_class", {}).items():
                    by_class[cls] = min(by_class.get(cls, ms), ms)
    first = next(iter(best.values()), {}).get("kernels", {})
    for mine in best.values():
        for key, row in mine.get("kernels", {}).items():
            row["graph_share_of_bound"] = row["bound_ms"] / row["graph_ms"]
            if key in first:
                for k in ("ms", "graph_ms"):
                    row[f"{k}_over_first"] = row[k] / first[key][k]
                mine_c = row.get("graph_ms_by_class", {})
                first_c = first[key].get("graph_ms_by_class", {})
                row["graph_ms_by_class_over_first"] = {
                    cls: ms / first_c[cls] for cls, ms in mine_c.items()
                    if first_c.get(cls)}
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+", type=Path)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a child may take")
    ap.add_argument("--log", type=Path,
                    help="append the kept lines to this JSON-lines file")
    args = ap.parse_args(argv)
    child = f"SMOKE = {str(SMOKE)!r}\n" + CHILD
    sys.path.insert(0, str(SMOKE.parent))
    from chip_smoke import build_report
    failed = 0
    results = []
    lines = []
    built: set = set()
    for turn, checkout in enumerate(args.checkouts):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", child],
                           cwd=checkout.resolve(), capture_output=True,
                           text=True, timeout=args.timeout)
        head = f"inter_me_ab {turn} {checkout}"
        print(f"{head} rc={r.returncode} "
              f"wall_s={time.perf_counter() - t:.1f}", flush=True)
        for line in r.stdout.splitlines():
            if line.startswith(KEEP):
                print(f"{head} {line}", flush=True)
                lines.append({"turn": turn, "checkout": str(checkout),
                              "line": line})
            if line.startswith("inter_me_ab "):
                res = json.loads(line.split(" ", 1)[1])
                results.append((str(checkout), res))
                if str(checkout) not in built:
                    built.add(str(checkout))
                    report = build_report(Path(res["inter_me_library"]))
                    bline = f"inter_me_ab_build {checkout} " + json.dumps(
                        report)
                    print(bline, flush=True)
                    lines.append({"line": bline})
        if r.returncode:
            failed += 1
            print(r.stdout[-3000:] + r.stderr[-3000:], flush=True)
    line = "inter_me_ab_summary " + json.dumps(summary(results))
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
