"""Encoder CLI: python -m thevc_tpu_torch.apps.encoder -c cfg \
   -i in.yuv -b str.bin -o rec.yuv -wdt W -hgt H -f N -fr FPS [--device cuda]

Behavioral reference: TAppEncoder/encmain.cpp + TAppEncTop.cpp.  A copy of
``thevc_tpu/apps/encoder.py`` with the port's ``--device`` option and
report line.

Without ``--FastRD=1`` this is the exact path, the host search that
HM runs, and the device is not used.  With ``--FastRD=1`` the fast-RD
decision passes (``encoder.fast_intra`` for I slices,
``encoder.fast_inter`` for P and B slices) run on the torch device
``--device`` (default ``cuda``, which fails when CUDA is absent; the CPU
is used only when ``--device cpu`` asks for it).  ``--device-apply``
runs the apply of the intra slices on that device as well
(``encoder.fast_apply``; the host apply otherwise).  The last line of
the output is ``thevc_tpu_torch.encoder {...}``: the launches of the
residual and SATD kernels (on ``cuda`` the decision passes launch the
SATD kernel for the P/B pass's quarter-pel candidates only, and no
residual kernel), of the intra decision kernels (``intra_sweep_launches``,
one a luma size class of a decision pass; ``tu_rd_launches``, the
transform-RD estimates of both passes; ``intra_select_launches`` and
``intra_pick_launches``, one a decision pass over every luma class;
``intra_dp_launches``, one a decision pass), of the MC kernel's two entries
that the P/B pass calls (blocks and quarter-pel), of the P/B pass's
motion-search kernels (``coarse_search_launches``, one a list of a
decision pass; ``int_refine_launches`` and ``merge_model_launches``, one
a size class and list) and of the device apply's kernel
(``apply_launches``, one a frame), the plain MC's calls (none on
``cuda``),
the frames decided (all, and the P/B ones),
the summed decision-pass wall time in seconds (synchronised with the
device), the device apply's frames, waves, class steps and summed wall,
and the frames it left to the host apply (a schedule it rejected), and
whether ``jax`` was imported.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..encoder.top import DecisionStats, Encoder
from ..ops import apply_kernel, inter_me_kernel, intra_rd_kernel, \
    intra_select_kernel, mc, mc_kernel, residual_kernel, satd_kernel
from ..ops.device import resolve
from ..utils.cfg import parse_args

REPORT_PREFIX = "thevc_tpu_torch.encoder "


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(prog="thevc-torch-enc", add_help=False)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fast-RD decision pass (cuda "
                         "or cpu; default cuda)")
    ap.add_argument("--device-apply", action="store_true",
                    help="with --FastRD=1, run the intra apply on --device "
                         "as well")
    args, argv = ap.parse_known_args(argv)
    cfg = parse_args(argv)
    if not cfg.input_file or not cfg.bitstream_file:
        print("usage: encoder -c cfg [-i in.yuv -b out.bin -o rec.yuv "
              "-wdt W -hgt H -f N -fr FPS]", file=sys.stderr)
        return 1
    before = {"residual": residual_kernel.launches,
              "satd": satd_kernel.launches, "apply": apply_kernel.launches,
              "intra_sweep": intra_rd_kernel.sweep_launches,
              "tu_rd": intra_rd_kernel.tu_rd_launches(),
              "intra_select": intra_select_kernel.select_launches,
              "intra_pick": intra_select_kernel.pick_launches,
              "intra_dp": intra_select_kernel.dp_launches,
              "mc_blocks": mc_kernel.blocks_launches,
              "mc_qpel": mc_kernel.qpel_launches, "plain_mc": mc.launches,
              "coarse": inter_me_kernel.coarse_launches,
              "refine": inter_me_kernel.refine_launches,
              "merge": inter_me_kernel.merge_launches,
              "qpel_pick": inter_me_kernel.pick_launches,
              "bi_pick": inter_me_kernel.bi_launches,
              "mc_blocks_field": mc_kernel.blocks_field_launches,
              "mc_qpel_field": mc_kernel.qpel_field_launches}
    device = resolve(args.device) if cfg.fast_rd else None
    stats = DecisionStats()
    enc = Encoder(cfg, device=device, stats=stats,
                  device_apply=args.device_apply)
    enc.encode(cfg.bitstream_file)
    enc.print_summary()
    # TAppEncTop::printRateSummary (TAppEncTop.cpp:486-493)
    n = max(enc.frames_encoded, 1)
    fr = cfg.frame_rate or 30
    total_bytes = enc.total_bits // 8
    print("Bytes written to file: %u (%.3f kbps)"
          % (total_bytes, 0.008 * total_bytes / (n / fr)))
    print(REPORT_PREFIX + json.dumps({
        "device": args.device,
        "residual_launches": residual_kernel.launches - before["residual"],
        "satd_launches": satd_kernel.launches - before["satd"],
        "intra_sweep_launches": intra_rd_kernel.sweep_launches
        - before["intra_sweep"],
        "tu_rd_launches": intra_rd_kernel.tu_rd_launches() - before["tu_rd"],
        "intra_select_launches": intra_select_kernel.select_launches
        - before["intra_select"],
        "intra_pick_launches": intra_select_kernel.pick_launches
        - before["intra_pick"],
        "intra_dp_launches": intra_select_kernel.dp_launches
        - before["intra_dp"],
        "apply_launches": apply_kernel.launches - before["apply"],
        "mc_blocks_launches": mc_kernel.blocks_launches
        - before["mc_blocks"],
        "mc_qpel_launches": mc_kernel.qpel_launches - before["mc_qpel"],
        "mc_blocks_field_launches": mc_kernel.blocks_field_launches
        - before["mc_blocks_field"],
        "mc_qpel_field_launches": mc_kernel.qpel_field_launches
        - before["mc_qpel_field"],
        "plain_mc_calls": mc.launches - before["plain_mc"],
        "coarse_search_launches": inter_me_kernel.coarse_launches
        - before["coarse"],
        "int_refine_launches": inter_me_kernel.refine_launches
        - before["refine"],
        "merge_model_launches": inter_me_kernel.merge_launches
        - before["merge"],
        "qpel_pick_launches": inter_me_kernel.pick_launches
        - before["qpel_pick"],
        "bi_pick_launches": inter_me_kernel.bi_launches - before["bi_pick"],
        "decision_frames": stats.frames,
        "decision_frames_inter": stats.inter_frames,
        "decision_wall_s": stats.wall_s,
        "device_apply_frames": stats.device_apply_frames,
        "device_apply_waves": stats.device_apply_waves,
        "device_apply_class_steps": stats.device_apply_class_steps,
        "device_apply_wall_s": stats.device_apply_wall_s,
        "device_apply_fallback_frames": stats.device_apply_fallback_frames,
        "jax_imported": "jax" in sys.modules}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
