"""Encoder CLI of the port: the reference encoder (TAppEncoder's
arguments and output, ``thevc_tpu/apps/encoder.py``) with its fast-RD
intra decision pass on a torch device.

Usage: python -m thevc_tpu_torch.apps.encoder -c cfg -i in.yuv -b str.bin
       [-o rec.yuv] -wdt W -hgt H -f N -fr FPS --FastRD=1 [--device cuda]

``--device`` defaults to ``cuda`` and fails when CUDA is absent; the CPU
is used only when ``--device cpu`` asks for it.  Only ``--FastRD=1``
intra slices reach the port; P/B slices with ``--FastRD=1`` raise
``NotImplementedError``, and ``--FastRD=0`` (the exact path) runs the
reference's host search.  The last line of the output is
``thevc_tpu_torch.encoder {...}``: the launches of the residual and SATD
kernels, the frames decided, the summed decision-pass wall time in
seconds (synchronised with the device) and whether ``jax`` was imported.
"""

from __future__ import annotations

import argparse
import json
import sys

from thevc_tpu.apps import encoder as ref_encoder

from ..encoder.top import device_decisions
from ..ops import residual_kernel, satd_kernel

REPORT_PREFIX = "thevc_tpu_torch.encoder "


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(prog="thevc-torch-enc", add_help=False)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the decision pass (cuda or cpu; "
                         "default cuda)")
    args, rest = ap.parse_known_args(argv)
    residual_before, satd_before = residual_kernel.launches, \
        satd_kernel.launches
    with device_decisions(args.device) as stats:
        rc = ref_encoder.main(rest)
    print(REPORT_PREFIX + json.dumps({
        "device": args.device,
        "residual_launches": residual_kernel.launches - residual_before,
        "satd_launches": satd_kernel.launches - satd_before,
        "decision_frames": stats.frames,
        "decision_wall_s": stats.wall_s,
        "jax_imported": "jax" in sys.modules}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
