"""Whether ``torch.profiler`` sees every device kernel of the 1080p I
decision pass, on one card.

Records the all-intra clip's first frame's ``fast_intra.decide_frame``
call as ``chip_smoke.py`` does (``recorded_i_call``: a 1-frame 1080p
clip, QP 32, SAO, ``--FastRD=1``), runs it once to warm up, then profiles
it in several windows, each twice, in this order:

- ``1run``: one pass, then a synchronise;
- ``3runs``: three passes, then a synchronise;
- ``1run_pad``, ``3runs_pad``: the same with 0.2 s of host sleep before
  the first pass and after the synchronise, inside the window.

For each window it counts, from the profiler's raw records, the device
activities, the hand-written kernels (by name) against the launches that
the wrappers counted, the host launch calls (runtime or driver API
records whose name holds ``Launch``) and how many of them have no device
activity with their correlation id, and where the device activities and
the missing launches lie in the window (ms from the window's first host
record).  Prints the card's name and power limit, one ``profile_window
<name> {...}`` line a window and ``profile_window_summary {...}``.  Run
from the repository's root:

    python tools/profile_window.py

Builds the kernels and the native core at first use, in ``build/``,
where it also writes its clip.  Exits nonzero without a card.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

HAND = ("sweep_kernel", "tu_rd_kernel", "select_kernel", "pick_kernel",
        "dp_kernel")


def window(torch, run, passes: int, pad: float) -> dict:
    """One profiled window of ``passes`` passes with ``pad`` seconds of
    sleep on each side -> its counts."""
    import chip_smoke as c
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    c.zero_intra_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(passes):
            run()
        torch.cuda.synchronize()
        time.sleep(pad)
    launched = c.intra_counts()
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    dev = [e for e in events if e.device_type() == DeviceType.CUDA]
    t0 = min(e.start_ns() for e in host)
    seen = {e.linked_correlation_id() for e in dev}
    launches = [e for e in host if "Launch" in e.name()]
    missing = [e for e in launches if e.correlation_id() not in seen]
    hand = [e for e in dev if any(n in e.name() for n in HAND)]
    want = sum(launched[k] for k in ("intra_sweep", "tu_rd_intra",
                                     "intra_select", "intra_pick",
                                     "intra_dp"))

    def ms(ns):
        return (ns - t0) / 1e6
    return dict(
        passes=passes, pad_s=pad, device_activities=len(dev),
        hand_written=len(hand), hand_written_launched=want,
        host_launch_calls=len(launches),
        launch_names=sorted({e.name() for e in launches}),
        launches_without_device=len(missing),
        missing_at_ms=[round(ms(e.start_ns()), 3) for e in missing][:40],
        missing_names=sorted({e.name() for e in missing}),
        device_first_ms=ms(min(e.start_ns() for e in dev)) if dev else None,
        device_last_ms=ms(max(e.start_ns() for e in dev)) if dev else None,
        host_last_ms=ms(max(e.start_ns() for e in host)),
        device_ms=sum(e.duration_ns() if hasattr(e, "duration_ns")
                      else 1000 * e.duration_us() for e in dev)
        / 1e6 / passes)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_window: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as c
    from thevc_tpu_torch.encoder import fast_intra
    print(c.gpu_line(), flush=True)
    work = ROOT / "build" / "profile_window"
    work.mkdir(parents=True, exist_ok=True)
    clip = work / f"clip_{c.WIDTH}x{c.HEIGHT}_1f.yuv"
    c.make_clip(clip, c.WIDTH, c.HEIGHT, 1)
    args = c.recorded_i_call(clip, work)

    def run():
        return fast_intra.decide_frame(*args, device="cuda")
    run()
    rows = []
    for rep in range(2):
        for name, passes, pad in (("1run", 1, 0.0), ("3runs", 3, 0.0),
                                  ("1run_pad", 1, 0.2),
                                  ("3runs_pad", 3, 0.2)):
            row = dict(name=name, rep=rep, **window(torch, run, passes, pad))
            rows.append(row)
            print(f"profile_window {name} " + json.dumps(row), flush=True)
    print("profile_window_summary " + json.dumps({
        f"{r['name']}#{r['rep']}": [r["hand_written"],
                                    r["hand_written_launched"],
                                    r["launches_without_device"]]
        for r in rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
