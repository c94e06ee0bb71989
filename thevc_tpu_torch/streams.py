"""Streams for checking the port, made by an encoder in a child process.

``encode`` runs ``python -m thevc_tpu_torch.apps.encoder`` (the port's
encoder: the exact path unless ``--FastRD=1`` is passed), or another
module with the same arguments, in a child process, with two settings:

- ``THEVC_THREADS=1``: the encoder's serial path (same stream as its
  frame-parallel one), unless the caller's ``env`` sets it otherwise;
- a glibc malloc tunable that serves large arrays from the main heap
  instead of ``mmap``.  The port's native core copies the reconstructed
  planes only inside the picture, but another encoder module (the JAX
  package's, whose native core reads and writes up to a CTU row past the
  end of those planes when the picture height is not a multiple of the
  CTU size) can fault when a plane ends at an unmapped page.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
INTRA_CFG = ROOT / "tests" / "cfg" / "encoder_intra_main.cfg"
ENCODER = "thevc_tpu_torch.apps.encoder"
# 32 MiB: glibc's largest mmap threshold; top_pad keeps 1 MiB mapped past
# the heap's last chunk
MALLOC_TUNABLES = ("glibc.malloc.mmap_threshold=33554432:"
                   "glibc.malloc.top_pad=1048576")


def encode(clip, stream, recon, width: int, height: int, frames: int,
           cfg=INTRA_CFG, extra=(), module=ENCODER, env=None) -> str:
    """Encode ``frames`` frames of the 4:2:0 ``clip`` into ``stream`` with
    the encoder CLI ``module``, writing the encoder's reconstruction to
    ``recon``; ``env`` adds to (or overrides) the child's environment.
    Returns the encoder's standard output.  Raises ``RuntimeError``, with
    the encoder's error output, if it fails."""
    env = {**os.environ, "THEVC_THREADS": "1",
           "GLIBC_TUNABLES": MALLOC_TUNABLES, **(env or {})}
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
