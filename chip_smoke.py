#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``thevc_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the hand-written CUDA kernel of the decode path from
   ``thevc_tpu_torch/csrc/`` with nvcc.
3. Kernel phase: the residual kernel against its plain PyTorch version
   on the card, for every TU class of the decode (4x4 DST and DCT,
   8x8, 16x16, 32x32 at bit increment 0; 4x4 DST, 8x8 and 32x32 at
   bit increment 2), on seeded random int16 coefficients and QPs 0..63.
   The tolerance is 0 (integer codec math): outputs must be equal.
   Times both at the size of a class that covers 8 luma planes of
   1920x1080 (CUDA events, after a warm-up).
4. Decode phase: writes a 1920x1080 8-frame clip
   (``tools/make_test_clip.py``), encodes it all-intra at QP 32 with SAO
   and MD5 digest SEI (``thevc_tpu.apps.encoder``,
   ``tests/cfg/encoder_intra_main.cfg``, through ``thevc_tpu_torch.streams``
   in a child process), then decodes it through the
   port's CLI on ``cuda``: one warm-up, then three timed runs (host clock
   ending in ``torch.cuda.synchronize()``; fps from the median).  In every
   run each digest must verify, the recon must be byte-identical to the
   encoder's and the kernel must have been launched by the decode (its
   count is zeroed just before the run and read just after); ``jax`` must
   never have been imported.
5. Prints the kernels' JSON line, then the device JSON line last.

Exits non-zero, before printing any result, when CUDA is not available
or when the port is not beside this script; any failed check raises.
Writes its clip and streams under ``build/chip_smoke/``.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 1234
WIDTH, HEIGHT, FRAMES, QP = 1920, 1080, 8, 32
# TU classes of the decode: (size, use_dst, bit_increment)
CLASSES = [(4, True, 0), (4, False, 0), (8, False, 0), (16, False, 0),
           (32, False, 0), (4, True, 2), (8, False, 2), (32, False, 2)]


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def gpu_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, 2 warm-ups)."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(torch, tq, rng_seed: int) -> dict:
    """Kernel vs plain version for every class; returns the timings."""
    import numpy as np
    dev = torch.device("cuda")
    rng = np.random.RandomState(rng_seed)
    max_err = 0
    rows = []
    for size, use_dst, bit_inc in CLASSES:
        # a ragged small batch, then the timing size: one class covering
        # 8 luma planes of 1920x1080
        for n in (4099, FRAMES * WIDTH * HEIGHT // (size * size)):
            q = torch.from_numpy(rng.randint(
                -32768, 32768, (n, size, size)).astype(np.int16)).to(dev)
            qp = torch.from_numpy(rng.randint(0, 64, n).astype(
                np.int32)).to(dev)
            got = tq.residual_pipeline(q, qp, use_dst, bit_inc)
            plain = tq.residual_pipeline_plain(q, qp, use_dst, bit_inc)
            torch.cuda.synchronize()
            err = int((got.to(torch.int32) - plain.to(torch.int32))
                      .abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got, plain),
                  f"kernel != plain at {size}x{size} dst={use_dst} "
                  f"bit_inc={bit_inc} n={n} (max abs err {err})")
        ms = time_ms(torch, lambda: tq.residual_pipeline(
            q, qp, use_dst, bit_inc), 20)
        plain_ms = time_ms(torch, lambda: tq.residual_pipeline_plain(
            q, qp, use_dst, bit_inc), 5)
        nbytes = q.numel() * 2 * 2 + qp.numel() * 4
        row = dict(size=size, dst=use_dst, bit_inc=bit_inc, n=n, ms=ms,
                   plain_ms=plain_ms, gb_s=nbytes / ms / 1e6)
        rows.append(row)
        print("kernel residual " + json.dumps(row))
    return {"max_abs_err": max_err, "rows": rows}


def decode_phase(torch, work: Path) -> dict:
    from thevc_tpu_torch import streams
    from thevc_tpu_torch.apps import decoder as dec_app
    from thevc_tpu_torch.ops import device as dev_stats
    from thevc_tpu_torch.ops import residual_kernel

    clip = work / f"clip_{WIDTH}x{HEIGHT}_{FRAMES}f.yuv"
    stream = work / "intra_main.bin"
    enc_rec = work / "intra_main_enc_rec.yuv"
    dec_rec = work / "intra_main_dec_rec.yuv"
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_test_clip.py"),
                    str(clip), "--width", str(WIDTH), "--height",
                    str(HEIGHT), "--frames", str(FRAMES), "--seed",
                    str(SEED)], check=True, capture_output=True, timeout=600)
    t0 = time.perf_counter()
    streams.encode(clip, stream, enc_rec, WIDTH, HEIGHT, FRAMES,
                   extra=(f"--QP={QP}", "--SAO=1"))
    print(f"encode: {FRAMES} frames {WIDTH}x{HEIGHT} QP {QP} in "
          f"{time.perf_counter() - t0:.3f} s (host), "
          f"{stream.stat().st_size} bytes")

    def decode():
        log = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = dec_app.main(["-b", str(stream), "-o", str(dec_rec),
                               "--device", "cuda"])
        torch.cuda.synchronize()
        return rc, log.getvalue(), time.perf_counter() - t

    decode()                        # warm-up: first-touch costs
    walls = []
    for _ in range(3):
        residual_kernel.launches = 0
        dev_stats.stats_reset()
        rc, log, wall = decode()
        launches = residual_kernel.launches
        stats = dev_stats.stats_reset()
        check(rc == 0, f"port decoder exited {rc}:\n{log}")
        check(log.count("[MD5:(OK)]") == FRAMES and "ERROR" not in log,
              f"digests not all OK:\n{log}")
        check(dec_rec.read_bytes() == enc_rec.read_bytes(),
              "decoded recon differs from the encoder's recon")
        check(launches > 0, "the decode launched no residual kernel")
        walls.append(wall)
    check("jax" not in sys.modules, "jax was imported")
    wall = sorted(walls)[1]
    out = dict(frames=FRAMES, wall_s=walls, fps=FRAMES / wall,
               residual_kernel_launches=launches,
               device_launches_per_frame=stats["launches"] / FRAMES,
               h2d_bytes_per_frame=stats["h2d_bytes"] / FRAMES,
               d2h_bytes_per_frame=stats["d2h_bytes"] / FRAMES)
    print("decode " + json.dumps(out))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from thevc_tpu_torch.ops import residual_kernel, tq

    print(gpu_line())
    t0 = time.perf_counter()
    residual_kernel.build()
    print(f"build: residual kernel in {time.perf_counter() - t0:.3f} s")
    print(residual_kernel.library_path().with_suffix(".log").read_text()
          .strip())

    kern = kernel_phase(torch, tq, SEED)
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    dec = decode_phase(torch, work)

    top = next(r for r in kern["rows"] if r["size"] == 32
               and r["bit_inc"] == 0)
    print(json.dumps({"kernels": [{
        "name": "residual", "route": "cuda",
        "source": "thevc_tpu_torch/csrc/residual.cu",
        "replaces": "thevc_tpu/ops/jx_pallas.py:141",
        "launches": dec["residual_kernel_launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": top["ms"], "plain_ms": top["plain_ms"]}]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
