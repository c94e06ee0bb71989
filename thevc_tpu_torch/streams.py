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

``tool_streams`` makes the decode-tool streams (QP 22 and 51, PCM,
CU-level delta QP, in-loop filters off) that ``tests/test_decoder.py``
makes with HM, with this encoder at 64x64.
"""

from __future__ import annotations

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
INTRA_CFG = ROOT / "tests" / "cfg" / "encoder_intra_main.cfg"
ENCODER = "thevc_tpu_torch.apps.encoder"
# 32 MiB: glibc's largest mmap threshold; top_pad keeps 1 MiB mapped past
# the heap's last chunk
MALLOC_TUNABLES = ("glibc.malloc.mmap_threshold=33554432:"
                   "glibc.malloc.top_pad=1048576")

# the decode-tool streams of tests/test_decoder.py:47-76, all-intra with
# INTRA_CFG (QP 32): name -> (clip, encoder arguments).  The encoder
# picks PCM only where intra coding costs more bits than the raw samples
# (cu_encoder.py, TEncCu.cpp:725), which the smooth clip never does, nor
# noise at QP 22: the PCM clip has noise in the left half of every plane,
# coded at QP 16, so that half is PCM and the rest is not.  The encoder
# sets a CU QP other than the slice QP only with adaptive QP (the delta
# QP of --MaxDeltaQP is a syntax bound here, not a search), so the dQP
# stream adds --AdaptiveQP=1.
TOOL_W = TOOL_H = 64
TOOL_FRAMES = 2
TOOL_WORKERS = 3                 # encoder processes at a time
TOOL_STREAMS = {
    "qp22": ("clip", ("-q", "22")),
    "qp51": ("clip", ("-q", "51")),
    "pcm": ("half_noise", ("--PCMEnabledFlag=1", "-q", "16")),
    "dqp": ("clip", ("--MaxCuDQPDepth=1", "--MaxDeltaQP=1",
                     "--AdaptiveQP=1")),
    "nofilt": ("clip", ("--DeblockingFilterControlPresent=1",
                        "--LoopFilterDisable=1", "--SAO=0")),
}


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


def tool_clips(root: Path) -> dict:
    """Write the tool streams' 64x64 2-frame clips under ``root``: the
    test clip of ``tools/make_test_clip.py`` and the same clip with the
    left half of every plane seeded noise.  Returns {name: path}."""
    root = Path(root)
    clip = root / "tool_clip.yuv"
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_test_clip.py"),
                    str(clip), "--width", str(TOOL_W), "--height",
                    str(TOOL_H), "--frames", str(TOOL_FRAMES)],
                   check=True, capture_output=True)
    frames = np.frombuffer(clip.read_bytes(), np.uint8) \
        .reshape(TOOL_FRAMES, -1).copy()
    rng = np.random.RandomState(5)
    luma = TOOL_W * TOOL_H
    for k in range(TOOL_FRAMES):
        for off, w, h in ((0, TOOL_W, TOOL_H),
                          (luma, TOOL_W // 2, TOOL_H // 2),
                          (luma * 5 // 4, TOOL_W // 2, TOOL_H // 2)):
            plane = frames[k, off:off + w * h].reshape(h, w)
            plane[:, :w // 2] = rng.randint(0, 256, (h, w // 2))
    noisy = root / "tool_half_noise.yuv"
    noisy.write_bytes(frames.tobytes())
    return {"clip": clip, "half_noise": noisy}


def tool_streams(root: Path) -> dict:
    """Encode every ``TOOL_STREAMS`` stream under ``root`` with the port's
    exact encoder, ``TOOL_WORKERS`` at a time.  Returns {name: (stream,
    encoder recon, frames)}."""
    root = Path(root)
    clips = tool_clips(root)

    def one(name):
        clip, extra = TOOL_STREAMS[name]
        stream, recon = root / f"{name}.bin", root / f"{name}_rec.yuv"
        encode(clips[clip], stream, recon, TOOL_W, TOOL_H, TOOL_FRAMES,
               extra=extra)
        return name, (stream, recon, TOOL_FRAMES)
    with ThreadPoolExecutor(TOOL_WORKERS) as ex:
        return dict(ex.map(one, TOOL_STREAMS))
