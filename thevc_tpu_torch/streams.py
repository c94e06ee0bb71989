"""Streams for checking the port, made by an encoder in a child process.

``encode`` runs ``python -m thevc_tpu.apps.encoder`` (the reference
encoder), or another module with the same arguments such as the port's
``thevc_tpu_torch.apps.encoder``, in a child process.  Two settings keep
that encode from crashing at random:

- ``THEVC_THREADS=1``: the encoder's serial path (same stream as its
  frame-parallel one);
- a glibc malloc tunable that serves large arrays from the main heap
  instead of ``mmap``.  The reference's native encoder reads up to a CTU
  row past the end of the reconstructed luma plane when the picture
  height is not a multiple of the CTU size (``es_save_region_impl``,
  the ``rec_y`` copy); an ``mmap``-ed plane can end at an unmapped page,
  and the read then faults.  On the heap the bytes past the plane are
  mapped; they lie outside the picture and change nothing it writes.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
INTRA_CFG = ROOT / "tests" / "cfg" / "encoder_intra_main.cfg"
# 32 MiB: glibc's largest mmap threshold; top_pad keeps 1 MiB mapped past
# the heap's last chunk
MALLOC_TUNABLES = ("glibc.malloc.mmap_threshold=33554432:"
                   "glibc.malloc.top_pad=1048576")


def encode(clip, stream, recon, width: int, height: int, frames: int,
           cfg=INTRA_CFG, extra=(), module="thevc_tpu.apps.encoder") -> str:
    """Encode ``frames`` frames of the 4:2:0 ``clip`` into ``stream`` with
    the encoder CLI ``module``, writing the encoder's reconstruction to
    ``recon``.  Returns the encoder's standard output.  Raises
    ``RuntimeError``, with the encoder's error output, if it fails."""
    env = dict(os.environ, THEVC_THREADS="1",
               GLIBC_TUNABLES=MALLOC_TUNABLES)
    r = subprocess.run(
        [sys.executable, "-m", module, "-c", str(cfg),
         "-i", str(clip), "-b", str(stream), "-o", str(recon),
         "-wdt", str(width), "-hgt", str(height), "-f", str(frames),
         "-fr", "30", "--SEIpictureDigest=1", *extra],
        cwd=ROOT, env=env, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"encoder exited {r.returncode}:\n"
                           f"{r.stderr[-4000:]}")
    return r.stdout
