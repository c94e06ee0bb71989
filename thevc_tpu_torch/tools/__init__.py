"""Developer tools of the port, the twins of the JAX package's
``tools/*.py``: ``python -m thevc_tpu_torch.tools.<name> --help``.

- ``fastrd_quality``: bits and luma PSNR of the fast-RD encode against the
  exact path over a QP sweep;
- ``diag_fastrd_ldp``: decision statistics of an exact and a fast-RD
  low-delay P encode;
- ``profile_encode``: the native core's section cycle counters over an
  encode;
- ``ab_bench``: an interleaved ABBA timing of two builds of the native
  core.

Their cfgs are ``tests/cfg``'s, their clips ``tools/make_test_clip.py``'s
(``thevc_tpu_torch.streams``); the helpers below are shared.
"""

from __future__ import annotations

import contextlib
import io
import re


def run_encoder(argv) -> str:
    """Run the port's encoder CLI in this process; returns its output."""
    from ..apps.encoder import main
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = main([str(a) for a in argv])
    if rc != 0:
        raise RuntimeError(f"the encoder exited {rc}:\n{log.getvalue()}")
    return log.getvalue()


def frame_stats(log: str) -> tuple:
    """(summed bits, mean luma PSNR in dB) of the encoder's per-POC lines."""
    bits, psnr = 0, []
    for m in re.finditer(r"(\d+) bits \[Y ([\d.]+) dB", log):
        bits += int(m.group(1))
        psnr.append(float(m.group(2)))
    return bits, sum(psnr) / len(psnr)
