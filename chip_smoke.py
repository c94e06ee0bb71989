#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``thevc_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the hand-written CUDA kernels (``thevc_tpu_torch/csrc/``), one
   nvcc for each source, all started together.
3. Residual kernel (K1) against its plain PyTorch version on the card,
   for every TU class of the decode (4x4 DST and DCT, 8x8, 16x16, 32x32
   at bit increment 0; 4x4 DST, 8x8 and 32x32 at bit increment 2), on
   seeded random int16 coefficients and QPs 0..63.  Tolerance 0
   (integer codec math).  Times both at the size of a class that covers
   8 luma planes of 1920x1080 (CUDA events, after a warm-up).
4. SATD kernel (K2) against its plain version on the card, at the
   shapes of the 1080p fast-RD sweep: N = (1088/s) * (1920/s) PUs of
   size s against M = 35 candidates, for s = 4, 8, 16, 32, 64 at bit
   increment 0 and s = 8, 64 at bit increment 2, and a ragged N = 4099.
   Tolerance 0; times both.
5. Decode phase: writes a 1920x1080 8-frame clip
   (``tools/make_test_clip.py``), encodes it all-intra at QP 32 with SAO
   and MD5 digest SEI on the exact path (``thevc_tpu.apps.encoder``,
   ``tests/cfg/encoder_intra_main.cfg``, through ``thevc_tpu_torch.streams``
   in a child process), then decodes it through the
   port's CLI on ``cuda``: one warm-up, then three timed runs (host clock
   ending in ``torch.cuda.synchronize()``; fps from the median).  In every
   run each digest must verify, the recon must be byte-identical to the
   encoder's and the kernel must have been launched by the decode (its
   count is zeroed just before the run and read just after).
6. Fast-RD encode phase: encodes the same clip with ``--FastRD=1`` at
   QP 32 through the port's encoder CLI (``thevc_tpu_torch.apps.encoder
   --device cuda``) in a child process, whose counts start at 0 and
   which reports the launches of both kernels: each must be above 0, and
   ``jax`` must not have been imported.  The stream is decoded by the
   port on ``cuda``: 8/8 digests OK and recon byte-identical to the
   encoder's.  Against the exact stream: at most 1.15x its bytes and a
   luma PSNR against the clip at most 0.5 dB below it.
7. CPU against CUDA: a 416x240 2-frame clip encoded with ``--FastRD=1``
   at QP 27 and 37 with ``--device cuda`` and ``--device cpu`` gives
   byte-identical streams.
8. Prints the kernels' JSON line, then the device JSON line last.
   ``jax`` must never have been imported.

Exits non-zero, before printing any result, when CUDA is not available
or when the port is not beside this script; any failed check raises.
Writes its clip and streams under ``build/chip_smoke/``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 1234
WIDTH, HEIGHT, FRAMES, QP = 1920, 1080, 8, 32
# TU classes of the decode: (size, use_dst, bit_increment)
CLASSES = [(4, True, 0), (4, False, 0), (8, False, 0), (16, False, 0),
           (32, False, 0), (4, True, 2), (8, False, 2), (32, False, 2)]
# PU classes of the fast-RD sweep: (size, bit_increment)
SATD_CLASSES = [(4, 0), (8, 0), (16, 0), (32, 0), (64, 0), (8, 2), (64, 2)]
SATD_MODES = 35
# the CPU-against-CUDA identity clip
SMALL_W, SMALL_H, SMALL_FRAMES, SMALL_QPS = 416, 240, 2, (27, 37)
PORT_ENCODER = "thevc_tpu_torch.apps.encoder"


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
    from thevc_tpu_torch.ops import device as dev_stats
    from thevc_tpu_torch.ops import residual_kernel

    clip = work / f"clip_{WIDTH}x{HEIGHT}_{FRAMES}f.yuv"
    stream = work / "intra_main.bin"
    enc_rec = work / "intra_main_enc_rec.yuv"
    dec_rec = work / "intra_main_dec_rec.yuv"
    make_clip(clip, WIDTH, HEIGHT, FRAMES)
    t0 = time.perf_counter()
    streams.encode(clip, stream, enc_rec, WIDTH, HEIGHT, FRAMES,
                   extra=(f"--QP={QP}", "--SAO=1"))
    print(f"encode: {FRAMES} frames {WIDTH}x{HEIGHT} QP {QP} in "
          f"{time.perf_counter() - t0:.3f} s (host), "
          f"{stream.stat().st_size} bytes")

    def decode():
        t = time.perf_counter()
        rc, log = decode_cuda(torch, stream, dec_rec)
        return rc, log, time.perf_counter() - t

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
    wall = sorted(walls)[1]
    out = dict(frames=FRAMES, wall_s=walls, fps=FRAMES / wall,
               residual_kernel_launches=launches,
               device_launches_per_frame=stats["launches"] / FRAMES,
               h2d_bytes_per_frame=stats["h2d_bytes"] / FRAMES,
               d2h_bytes_per_frame=stats["d2h_bytes"] / FRAMES)
    print("decode " + json.dumps(out))
    out.update(clip=str(clip), stream=str(stream), enc_rec=str(enc_rec))
    return out


def satd_phase(torch, satd, rng_seed: int) -> dict:
    """SATD kernel vs plain version for every PU class; returns timings."""
    import numpy as np
    dev = torch.device("cuda")
    rng = np.random.RandomState(rng_seed)
    max_err = 0
    rows = []
    for size, bit_inc in SATD_CLASSES:
        hi = 256 << bit_inc
        # a ragged small batch, then the timing size: every PU of the
        # class in a 1920x1088 (CTU-padded 1080p) luma plane
        for n in (4099, (1088 // size) * (1920 // size)):
            org = torch.from_numpy(rng.randint(
                0, hi, (n, size, size)).astype(np.int16)).to(dev)
            preds = torch.from_numpy(rng.randint(
                0, hi, (n, SATD_MODES, size, size)).astype(np.int16)).to(dev)
            got = satd.satd_blocks(org, preds, bit_inc)
            plain = satd.satd_plain(org, preds, bit_inc)
            torch.cuda.synchronize()
            err = int((got - plain).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got, plain),
                  f"SATD kernel != plain at {size}x{size} bit_inc={bit_inc}"
                  f" n={n} (max abs err {err})")
        ms = time_ms(torch, lambda: satd.satd_blocks(org, preds, bit_inc),
                     20)
        plain_ms = time_ms(torch, lambda: satd.satd_plain(org, preds,
                                                          bit_inc), 5)
        nbytes = preds.numel() * 2 + org.numel() * 2 + n * SATD_MODES * 4
        row = dict(size=size, bit_inc=bit_inc, n=n, m=SATD_MODES, ms=ms,
                   plain_ms=plain_ms, gb_s=nbytes / ms / 1e6)
        rows.append(row)
        print("kernel satd " + json.dumps(row))
    return {"max_abs_err": max_err, "rows": rows}


def luma_psnr(a: Path, b: Path, width: int, height: int,
              frames: int) -> float:
    """Luma PSNR (dB) of 8-bit 4:2:0 file ``b`` against ``a``."""
    import numpy as np
    fsize = width * height * 3 // 2

    def luma(p):
        raw = np.fromfile(p, np.uint8)[:fsize * frames]
        return raw.reshape(frames, fsize)[:, :width * height].astype(
            np.float64)
    d = luma(a) - luma(b)
    mse = float((d * d).mean())
    return 99.0 if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def port_encode(clip: Path, stream: Path, recon: Path, width: int,
                height: int, frames: int, qp: int, device: str) -> dict:
    """Fast-RD encode through the port's CLI in a child process; returns
    the CLI's report (kernel launches, decision-pass wall) with the
    encode's wall time."""
    from thevc_tpu_torch import streams
    from thevc_tpu_torch.apps.encoder import REPORT_PREFIX
    t0 = time.perf_counter()
    out = streams.encode(clip, stream, recon, width, height, frames,
                         extra=(f"--QP={qp}", "--SAO=1", "--FastRD=1",
                                f"--device={device}"),
                         module=PORT_ENCODER)
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.splitlines() if ln.startswith(REPORT_PREFIX)]
    check(len(lines) == 1, f"no report line from the port's encoder:\n"
          f"{out[-2000:]}")
    report = json.loads(lines[0][len(REPORT_PREFIX):])
    report["wall_s"] = wall
    return report


def decode_cuda(torch, stream: Path, out: Path) -> tuple:
    """Decode ``stream`` with the port's CLI on ``cuda``."""
    from thevc_tpu_torch.apps import decoder as dec_app
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = dec_app.main(["-b", str(stream), "-o", str(out), "--device",
                           "cuda"])
    torch.cuda.synchronize()
    return rc, log.getvalue()


def fastrd_phase(torch, work: Path, dec: dict) -> dict:
    """The 1080p fast-RD encode on ``cuda``, its decode, and the
    comparison with the exact-path stream of the decode phase."""
    clip, exact = Path(dec["clip"]), Path(dec["stream"])
    stream = work / "fastrd.bin"
    enc_rec = work / "fastrd_enc_rec.yuv"
    dec_rec = work / "fastrd_dec_rec.yuv"
    rep = port_encode(clip, stream, enc_rec, WIDTH, HEIGHT, FRAMES, QP,
                      "cuda")
    check(rep["satd_launches"] > 0, "the fast-RD encode launched no SATD "
          "kernel")
    check(rep["residual_launches"] > 0, "the fast-RD encode launched no "
          "residual kernel")
    check(not rep["jax_imported"], "the port's encoder imported jax")
    check(rep["decision_frames"] == FRAMES,
          f"{rep['decision_frames']} decision passes for {FRAMES} frames")
    rc, log = decode_cuda(torch, stream, dec_rec)
    check(rc == 0, f"port decoder exited {rc} on the fast-RD stream:\n{log}")
    check(log.count("[MD5:(OK)]") == FRAMES and "ERROR" not in log,
          f"fast-RD digests not all OK:\n{log}")
    check(dec_rec.read_bytes() == enc_rec.read_bytes(),
          "decoded fast-RD recon differs from the encoder's recon")
    fast_bytes, exact_bytes = stream.stat().st_size, exact.stat().st_size
    psnr_fast = luma_psnr(clip, enc_rec, WIDTH, HEIGHT, FRAMES)
    psnr_exact = luma_psnr(clip, Path(dec["enc_rec"]), WIDTH, HEIGHT,
                           FRAMES)
    check(fast_bytes <= 1.15 * exact_bytes,
          f"fast-RD stream {fast_bytes} B > 1.15 x exact {exact_bytes} B")
    check(psnr_fast >= psnr_exact - 0.5,
          f"fast-RD luma PSNR {psnr_fast:.3f} dB < exact "
          f"{psnr_exact:.3f} dB - 0.5")
    out = dict(frames=FRAMES, qp=QP, encode_wall_s=rep["wall_s"],
               encode_fps=FRAMES / rep["wall_s"],
               decision_wall_s=rep["decision_wall_s"],
               decision_ms_per_frame=1000 * rep["decision_wall_s"] / FRAMES,
               satd_launches=rep["satd_launches"],
               residual_launches=rep["residual_launches"],
               fast_bytes=fast_bytes, exact_bytes=exact_bytes,
               psnr_y_fast=psnr_fast, psnr_y_exact=psnr_exact)
    print("fastrd " + json.dumps(out))
    return out


def identity_phase(work: Path) -> dict:
    """Fast-RD streams of a small clip from ``--device cuda`` and
    ``--device cpu`` must be byte-identical."""
    clip = work / f"clip_{SMALL_W}x{SMALL_H}_{SMALL_FRAMES}f.yuv"
    make_clip(clip, SMALL_W, SMALL_H, SMALL_FRAMES)
    out = {}
    for qp in SMALL_QPS:
        data = {}
        for device in ("cuda", "cpu"):
            stream = work / f"small_q{qp}_{device}.bin"
            port_encode(clip, stream, work / f"small_q{qp}_{device}.yuv",
                        SMALL_W, SMALL_H, SMALL_FRAMES, qp, device)
            data[device] = stream.read_bytes()
        check(data["cuda"] == data["cpu"],
              f"fast-RD stream at QP {qp}: --device cuda and --device cpu "
              "differ")
        out[qp] = len(data["cuda"])
    print("identity " + json.dumps({"qp_bytes": out, "identical": True}))
    return out


def make_clip(path: Path, width: int, height: int, frames: int) -> None:
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_test_clip.py"),
                    str(path), "--width", str(width), "--height",
                    str(height), "--frames", str(frames), "--seed",
                    str(SEED)], check=True, capture_output=True, timeout=600)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from thevc_tpu_torch.ops import build, residual_kernel, satd, \
        satd_kernel, tq

    print(gpu_line())
    t0 = time.perf_counter()
    kernels = (residual_kernel, satd_kernel)
    with ThreadPoolExecutor(len(kernels)) as ex:
        list(ex.map(build.compile_source, [k.NAME for k in kernels]))
    for k in kernels:
        k.build()
    print(f"build: {len(kernels)} kernels in "
          f"{time.perf_counter() - t0:.3f} s")
    for k in kernels:
        print(build.library_path(k.NAME).with_suffix(".log").read_text()
              .strip())

    kern = kernel_phase(torch, tq, SEED)
    k2 = satd_phase(torch, satd, SEED)
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    dec = decode_phase(torch, work)
    fast = fastrd_phase(torch, work, dec)
    identity_phase(work)
    check("jax" not in sys.modules, "jax was imported")

    top = next(r for r in kern["rows"] if r["size"] == 32
               and r["bit_inc"] == 0)
    # K2's time: one 1080p frame's 35-mode sweep, the five bit_inc 0
    # classes summed
    frame = [r for r in k2["rows"] if r["bit_inc"] == 0]
    print("launches by path " + json.dumps({
        "decode": {"residual": dec["residual_kernel_launches"]},
        "fastrd_encode": {"residual": fast["residual_launches"],
                          "satd": fast["satd_launches"]}}))
    print(json.dumps({"kernels": [{
        "name": "residual", "route": "cuda",
        "source": "thevc_tpu_torch/csrc/residual.cu",
        "replaces": "thevc_tpu/ops/jx_pallas.py:141",
        "launches": fast["residual_launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": top["ms"], "plain_ms": top["plain_ms"]}, {
        "name": "satd", "route": "cuda",
        "source": "thevc_tpu_torch/csrc/satd.cu",
        "replaces": "thevc_tpu/ops/jx_pallas.py:63",
        "launches": fast["satd_launches"],
        "max_abs_err": k2["max_abs_err"],
        "ms": sum(r["ms"] for r in frame),
        "plain_ms": sum(r["plain_ms"] for r in frame)}]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
