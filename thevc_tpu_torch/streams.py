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

``robust_streams`` makes the 176x144 streams of the error-resilience and
random-access checks (``tests/test_robustness.py`` makes them with HM):
low-delay P, random access with a mid-stream CRA, random access, a short
all-intra stream and low-delay B with two temporal layers.
``drop_slice``, ``cra_to_bla`` and ``fuzz_variants`` derive the damaged
streams from them; ``ROBUST_CASES`` and ``robust_case`` name each decode
of the checks, ``ROBUST_CLI`` the decoder CLI's switch for each decoder
option, and ``decode_outcome`` and ``same_outcome`` give and compare a
decode's result.

``nxn_frame`` makes a seeded small frame and fast-RD decision maps with
every CU size down to NxN, the input on which the device apply runs every
one of its transform classes (no decision pass sets NxN).
"""

from __future__ import annotations

import contextlib
import io
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from . import nal

ROOT = Path(__file__).resolve().parent.parent
CFG = ROOT / "tests" / "cfg"
INTRA_CFG = CFG / "encoder_intra_main.cfg"
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


# the robustness streams of tests/test_robustness.py, 176x144, from the
# clip of make_test_clip.py (its default seed and style): name ->
# (frames, cfg, encoder arguments).  ra17's --IntraPeriod=16 puts a CRA
# at POC 16 whose leading pictures 9-15 are TFD; ldb's GOP of 2 puts the
# odd POCs in temporal layer 1.
ROBUST_W, ROBUST_H = 176, 144
ROBUST_STREAMS = {
    "ldp": (9, CFG / "encoder_lowdelay_P_main.cfg", ()),
    "ra17": (17, CFG / "encoder_randomaccess_main.cfg",
             ("--IntraPeriod=16",)),
    "ra": (9, CFG / "encoder_randomaccess_main.cfg", ()),
    "intra": (2, INTRA_CFG, ()),
    "ldb": (5, CFG / "encoder_lowdelay_tlayers.cfg", ()),
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


def make_clip(path, width: int, height: int, frames: int,
              style: str = "default", seed: int = 1234) -> Path:
    """Write a seeded 8-bit 4:2:0 clip with ``tools/make_test_clip.py``."""
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_test_clip.py"),
                    str(path), "--width", str(width), "--height",
                    str(height), "--frames", str(frames), "--seed",
                    str(seed), "--style", style],
                   check=True, capture_output=True, timeout=600)
    return Path(path)


def tool_clips(root: Path) -> dict:
    """Write the tool streams' 64x64 2-frame clips under ``root``: the
    test clip of ``tools/make_test_clip.py`` and the same clip with the
    left half of every plane seeded noise.  Returns {name: path}."""
    root = Path(root)
    clip = make_clip(root / "tool_clip.yuv", TOOL_W, TOOL_H, TOOL_FRAMES)
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


def robust_streams(root: Path) -> dict:
    """Encode every ``ROBUST_STREAMS`` stream under ``root`` with the
    port's exact encoder, all at once.  Returns {name: (stream, encoder
    recon, frames)}."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    clip = make_clip(root / f"robust_{ROBUST_W}x{ROBUST_H}.yuv", ROBUST_W,
                     ROBUST_H, max(f for f, _c, _e in ROBUST_STREAMS.values()))

    def one(name):
        n, cfg, extra = ROBUST_STREAMS[name]
        stream, recon = root / f"{name}.bin", root / f"{name}_rec.yuv"
        encode(clip, stream, recon, ROBUST_W, ROBUST_H, n, cfg=cfg,
               extra=extra)
        return name, (stream, recon, n)
    with ThreadPoolExecutor(len(ROBUST_STREAMS)) as ex:
        return dict(ex.map(one, ROBUST_STREAMS))


def _rebuild(units) -> bytes:
    return nal.write_annexb([(u.nal_type, u.temporal_id, u.rbsp)
                             for u in units])[0]


def drop_slice(data: bytes, k: int) -> bytes:
    """``data`` without its ``k``-th slice NAL (from 1, decoding order):
    a lost picture when each picture is one slice."""
    units, n = [], 0
    for u in nal.iter_annexb_nals(data):
        if nal.is_slice_nal(u.nal_type):
            n += 1
            if n == k:
                continue
        units.append(u)
    return _rebuild(units)


def cra_to_bla(data: bytes) -> bytes:
    """``data`` with every CRA slice NAL retyped as BLA (a broken link)."""
    return _rebuild(
        nal.NalUnit(nal.NAL_UNIT_CODED_SLICE_BLA, u.temporal_id, u.rbsp)
        if u.nal_type == nal.NAL_UNIT_CODED_SLICE_CRA else u
        for u in nal.iter_annexb_nals(data))


def fuzz_variants(data: bytes, trials: int, seed: int = 1234):
    """Yield ``trials`` corrupted copies of ``data``, as
    ``tests/test_robustness.py`` makes them: in turn a few single-bit
    flips, a truncation, and a byte inverted then a truncation after
    it."""
    rng = np.random.RandomState(seed)
    for trial in range(trials):
        buf = bytearray(data)
        kind = trial % 3
        if kind == 0:
            for _ in range(rng.randint(1, 6)):
                i = rng.randint(0, len(buf))
                buf[i] ^= 1 << rng.randint(0, 8)
        elif kind == 1:
            buf = buf[: rng.randint(1, len(buf))]
        else:
            i = rng.randint(0, len(buf))
            buf[i] ^= 0xFF
            buf = buf[: rng.randint(max(1, i), len(buf) + 1)]
        yield bytes(buf)


# the decodes of the robustness checks: name -> (stream, damage, decoder
# options, the POCs it must give).  conceal: POC 2, a reference of POCs 3
# and 4 under the GOP of 2, is lost and concealed; skip_to_cra: -s 9
# lands on the CRA at POC 16 and drops its TFD pictures; bla: the CRA
# retyped BLA drops them too; skip_non_rap: -s 1 on the all-intra
# stream, whose second picture is no random-access point, gives nothing;
# tlayer0: -t 0 keeps temporal layer 0
ROBUST_CASES = {
    # decoding order is POC order: the 3rd slice is POC 2's
    "conceal": ("ldp", lambda d: drop_slice(d, 3), {}, list(range(9))),
    "skip_to_cra": ("ra17", None, {"skip_frames": 9}, [16]),
    "bla": ("ra17", cra_to_bla, {}, [0, 1, 2, 3, 4, 5, 6, 7, 8, 16]),
    "skip_non_rap": ("intra", None, {"skip_frames": 1}, []),
    "tlayer0": ("ldb", None, {"max_temporal_layer": 0}, [0, 2, 4]),
}


def robust_case(made: dict, case: str) -> tuple:
    """(stream bytes, decoder options, expected POCs) of ``case`` from the
    streams of ``robust_streams``."""
    name, damage, options, pocs = ROBUST_CASES[case]
    data = Path(made[name][0]).read_bytes()
    if damage is not None:
        data = damage(data)
    return data, dict(options), list(pocs)


# the decoder CLI's switch for each decoder option of ROBUST_CASES
ROBUST_CLI = {"skip_frames": "-s", "max_temporal_layer": "-t"}


def decode_outcome(data: bytes, device: str = "cpu", options=None) -> tuple:
    """Decode ``data`` with the port on ``device`` (``options`` for the
    decoder: ``skip_frames``, ``max_temporal_layer``).  Returns ([(POC,
    digest flag, planes)], the decoder's output) or, when the decode
    raised a Python exception, (its type's name, its message).  A
    ``cuda`` decode ends in ``torch.cuda.synchronize()``, outside the
    ``try``: an error the card reports late is raised."""
    import torch

    from .decoder.top import Decoder
    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            pics = Decoder(device, **(options or {})).decode_stream(data)
        got = [(p.poc, p.digest_ok, [pl.copy() for pl in p.frame.planes()])
               for p in pics]
        text = log.getvalue()
    except Exception as exc:
        got, text = type(exc).__name__, str(exc)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return got, text


def same_outcome(a, b) -> bool:
    """Two outcomes of ``decode_outcome``: the same exception type, or the
    same POCs, digest flags and planes."""
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    return len(a) == len(b) and all(
        pa == pb and da == db and all(np.array_equal(x, y)
                                      for x, y in zip(la, lb))
        for (pa, da, la), (pb, db, lb) in zip(a, b))


def nxn_frame(rng, w: int, h: int, ctu: int = 64, max_sig: int = 3):
    """A seeded w x h 4:2:0 frame and its fast-RD decision maps, drawn in
    that order from ``rng`` (a ``numpy.random.RandomState``): the three
    planes (int16: a smooth ramp with noise of varying strength) and the
    maps (int8 [h/4, w/4] each: depth, mode, NxN, chroma) of a random
    quadtree with every CU size from ``ctu`` to NxN 8x8 (half of the
    8x8 CUs NxN, with a luma mode per 4x4), random luma and chroma
    modes (36: DM)."""
    planes = []
    for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        ramp = np.add.outer(np.arange(hh) * 3, np.arange(ww) * 2) % 256
        noise = rng.randint(-40, 41, (hh, ww)) * (rng.rand(hh, ww) < 0.5)
        planes.append(np.clip(ramp + noise, 0, 255).astype(np.int16))
    shape = (h // 4, w // 4)
    depth, mode = np.zeros(shape, np.int8), np.zeros(shape, np.int8)
    nxn, chroma = np.zeros(shape, np.uint8), np.zeros(shape, np.int8)
    chroma_values = (0, 1, 10, 26, 34, 36)

    def cu(x, y, size, d):
        if d < max_sig and rng.rand() < (0.5, 0.8, 0.6)[d]:
            half = size // 2
            for dy in (0, half):
                for dx in (0, half):
                    cu(x + dx, y + dy, half, d + 1)
            return
        u = (slice(y // 4, (y + size) // 4), slice(x // 4, (x + size) // 4))
        depth[u] = d
        mode[u] = rng.randint(0, 35)
        chroma[u] = chroma_values[rng.randint(len(chroma_values))]
        if d == max_sig and rng.rand() < 0.5:
            nxn[u] = 1
            mode[u] = rng.randint(0, 35, (2, 2))
    for cy in range(0, h, ctu):
        for cx in range(0, w, ctu):
            cu(cx, cy, ctu, 0)
    return planes, (depth, mode, nxn, chroma)
