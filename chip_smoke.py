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
5. Streams: writes a 1920x1080 8-frame clip and a 1920x1080 8-frame
   motion clip (``tools/make_test_clip.py``, seed 1234, the second with
   ``--style motion``) and a 416x240 9-frame motion clip, then encodes,
   all at once in child processes (``thevc_tpu_torch.streams``), on the
   exact path (``thevc_tpu.apps.encoder``) at QP 32 with MD5 digest SEI:
   the first clip all-intra with SAO
   (``tests/cfg/encoder_intra_main.cfg``), the second low-delay B with
   SAO (``tests/cfg/encoder_lowdelay_tlayers.cfg``),
   the third low-delay P (5 frames) and random access with a GOP of 8
   (9 frames; ``encoder_lowdelay_P_main.cfg``,
   ``encoder_randomaccess_main.cfg``).
   Intra decode phase: decodes the all-intra stream through the
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
8. Inter decode phase: decodes the 1080p low-delay B stream through the
   port's CLI on ``cuda``, one warm-up and three timed runs checked as in
   5, where the residual kernel (K1) and motion compensation
   (``ops.mc.mc_batch``) must both have run.  Then one run with stage
   timing on (a device sync around each stage) for the stage walls per
   picture, and one that records every ``mc_batch`` call to time the
   plain-torch MC per class on the card (CUDA events, eager and as one
   CUDA graph per class).  The 416x240 low-delay P and random-access
   streams decode on ``cuda`` with every digest OK and recon
   byte-identical to their encoders'.
9. Prints the kernels' JSON line, then the device JSON line last.
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
CFG = ROOT / "tests" / "cfg"
# the small inter streams: name -> (frames, cfg)
SMALL_INTER = {"ldp": (5, CFG / "encoder_lowdelay_P_main.cfg"),
               "ra": (9, CFG / "encoder_randomaccess_main.cfg")}


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


def prepare_streams(work: Path) -> dict:
    """Write the clips, then encode every exact-path stream at once, each
    in its own child process.  Returns {name: (clip, stream, enc_rec,
    width, height, frames)}."""
    from thevc_tpu_torch import streams
    clips = {"intra": (WIDTH, HEIGHT, FRAMES, "default"),
             "motion": (WIDTH, HEIGHT, FRAMES, "motion"),
             "small_motion": (SMALL_W, SMALL_H, 9, "motion")}
    paths = {}
    for name, (w, h, frames, style) in clips.items():
        paths[name] = work / f"{name}_{w}x{h}_{frames}f.yuv"
        make_clip(paths[name], w, h, frames, style)
    jobs = {"intra_main": ("intra", FRAMES, CFG / "encoder_intra_main.cfg",
                           ("--SAO=1",)),
            "inter_ldb": ("motion", FRAMES,
                          CFG / "encoder_lowdelay_tlayers.cfg", ("--SAO=1",))}
    for name, (frames, cfg) in SMALL_INTER.items():
        jobs[name] = ("small_motion", frames, cfg, ())

    def encode(item):
        name, (clip, frames, cfg, extra) = item
        w, h = clips[clip][:2]
        stream = work / f"{name}.bin"
        enc_rec = work / f"{name}_enc_rec.yuv"
        t0 = time.perf_counter()
        streams.encode(paths[clip], stream, enc_rec, w, h, frames, cfg=cfg,
                       extra=(f"--QP={QP}", *extra))
        return name, (paths[clip], stream, enc_rec, w, h, frames,
                      time.perf_counter() - t0)

    with ThreadPoolExecutor(len(jobs)) as ex:
        made = dict(ex.map(encode, jobs.items()))
    for name, (_c, stream, _r, w, h, frames, wall) in made.items():
        print(f"encode {name}: {frames} frames {w}x{h} QP {QP} in "
              f"{wall:.3f} s (host, {len(jobs)} encodes at once), "
              f"{stream.stat().st_size} bytes")
    return {k: v[:6] for k, v in made.items()}


def timed_decodes(torch, stream: Path, enc_rec: Path, dec_rec: Path,
                  frames: int, counters: dict) -> dict:
    """One warm-up decode on ``cuda``, then three timed ones, each checked
    (digests, recon, every counter of ``counters`` above 0: name ->
    module whose ``launches`` the run zeroes before and reads after)."""
    from thevc_tpu_torch.ops import device as dev_stats

    def decode():
        t = time.perf_counter()
        rc, log = decode_cuda(torch, stream, dec_rec)
        return rc, log, time.perf_counter() - t

    decode()                        # warm-up: first-touch costs
    walls = []
    for _ in range(3):
        for mod in counters.values():
            mod.launches = 0
        dev_stats.stats_reset()
        rc, log, wall = decode()
        launches = {k: mod.launches for k, mod in counters.items()}
        stats = dev_stats.stats_reset()
        check_decode(rc, log, frames, dec_rec, enc_rec, stream.name)
        for k, n in launches.items():
            check(n > 0, f"the decode of {stream.name} made no {k} launch")
        walls.append(wall)
    wall = sorted(walls)[1]
    return dict(frames=frames, wall_s=walls, fps=frames / wall,
                launches=launches,
                device_launches_per_frame=stats["launches"] / frames,
                h2d_bytes_per_frame=stats["h2d_bytes"] / frames,
                d2h_bytes_per_frame=stats["d2h_bytes"] / frames)


def check_decode(rc: int, log: str, frames: int, dec_rec: Path,
                 enc_rec: Path, what: str) -> None:
    check(rc == 0, f"port decoder exited {rc} on {what}:\n{log}")
    check(log.count("[MD5:(OK)]") == frames and "ERROR" not in log,
          f"{what}: digests not all OK:\n{log}")
    check(dec_rec.read_bytes() == enc_rec.read_bytes(),
          f"{what}: decoded recon differs from the encoder's recon")


def decode_phase(torch, work: Path, made: dict) -> dict:
    from thevc_tpu_torch.ops import residual_kernel
    clip, stream, enc_rec = made["intra_main"][:3]
    res = timed_decodes(torch, stream, enc_rec,
                        work / "intra_main_dec_rec.yuv", FRAMES,
                        {"residual": residual_kernel})
    launches = res.pop("launches")
    out = dict(res, residual_kernel_launches=launches["residual"])
    print("decode " + json.dumps(out))
    out.update(clip=str(clip), stream=str(stream), enc_rec=str(enc_rec))
    return out


def inter_decode_phase(torch, work: Path, made: dict) -> dict:
    """The 1080p low-delay B decode on ``cuda``: timed runs, the stage
    walls per picture, and the plain-torch MC per class."""
    from thevc_tpu_torch.ops import device as dev_stats
    from thevc_tpu_torch.ops import mc, residual_kernel
    _clip, stream, enc_rec = made["inter_ldb"][:3]
    dec_rec = work / "inter_ldb_dec_rec.yuv"
    res = timed_decodes(torch, stream, enc_rec, dec_rec, FRAMES,
                        {"residual": residual_kernel, "mc": mc})
    print("inter_decode " + json.dumps(res))

    dev_stats.stage_timing(True)
    try:
        t = time.perf_counter()
        rc, log = decode_cuda(torch, stream, dec_rec)
        staged_wall = time.perf_counter() - t
    finally:
        stages = dev_stats.stage_timing(False)
    check_decode(rc, log, FRAMES, dec_rec, enc_rec, "the staged decode")
    print("inter_decode_stages " + json.dumps({
        "wall_s": staged_wall, "stage_ms_per_picture": {
            k: 1000 * v / FRAMES for k, v in sorted(stages.items())}}))
    res["mc_classes"] = mc_class_times(torch, stream)
    return res


def mc_class_times(torch, stream: Path) -> list:
    """Decode ``stream`` on ``cuda`` recording every ``mc_batch`` call,
    then time the calls of each (component, case, bi) class on the card:
    CUDA events around the class's calls replayed eagerly (host launch
    gaps included) and as one CUDA graph (device time)."""
    from thevc_tpu_torch.decoder.top import Decoder
    from thevc_tpu_torch.ops import mc
    calls: dict = {}
    real = mc.mc_batch

    def record(windows, fx, fy, case, luma, bd, bi, out_h, out_w):
        calls.setdefault((luma, case, bi), []).append(
            (windows, fx, fy, case, luma, bd, bi, out_h, out_w))
        return real(windows, fx, fy, case, luma, bd, bi, out_h, out_w)
    mc.mc_batch = record
    try:
        pics = Decoder("cuda").decode_stream(stream.read_bytes())
    finally:
        mc.mc_batch = real
    check(all(p.digest_ok for p in pics), "the recording decode failed")
    n_pics = len(pics)
    rows = []
    for (luma, case, bi), cl in sorted(calls.items()):
        def replay(cl=cl):
            for c in cl:
                real(*c)
        eager = time_ms(torch, replay, 5)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            replay()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replay()
        graph_ms = time_ms(torch, graph.replay, 10)
        del graph
        rows.append(dict(
            comp="luma" if luma else "chroma", case=case, bi=bool(bi),
            calls=len(cl), pus=sum(int(c[0].shape[0]) for c in cl),
            eager_ms_per_picture=eager / n_pics,
            graph_ms_per_picture=graph_ms / n_pics))
        print("mc_class " + json.dumps(rows[-1]))
    print("mc_total " + json.dumps({
        "pictures": n_pics,
        "eager_ms_per_picture": sum(r["eager_ms_per_picture"] for r in rows),
        "graph_ms_per_picture": sum(r["graph_ms_per_picture"]
                                    for r in rows)}))
    return rows


def small_inter_phase(torch, work: Path, made: dict) -> dict:
    """The 416x240 low-delay P and random-access streams on ``cuda``."""
    from thevc_tpu_torch.ops import mc, residual_kernel
    out = {}
    for name in SMALL_INTER:
        _clip, stream, enc_rec, _w, _h, frames = made[name]
        dec_rec = work / f"{name}_dec_rec.yuv"
        residual_kernel.launches = mc.launches = 0
        rc, log = decode_cuda(torch, stream, dec_rec)
        out[name] = {"frames": frames, "residual": residual_kernel.launches,
                     "mc": mc.launches}
        check_decode(rc, log, frames, dec_rec, enc_rec, stream.name)
        check(out[name]["residual"] > 0 and out[name]["mc"] > 0,
              f"{name}: the decode skipped K1 or MC")
    print("small_inter " + json.dumps(out))
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


def make_clip(path: Path, width: int, height: int, frames: int,
              style: str = "default") -> None:
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_test_clip.py"),
                    str(path), "--width", str(width), "--height",
                    str(height), "--frames", str(frames), "--seed",
                    str(SEED), "--style", style], check=True,
                   capture_output=True, timeout=600)


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

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    made = prepare_streams(work)
    kern = kernel_phase(torch, tq, SEED)
    k2 = satd_phase(torch, satd, SEED)
    dec = decode_phase(torch, work, made)
    fast = fastrd_phase(torch, work, dec)
    identity_phase(work)
    inter = inter_decode_phase(torch, work, made)
    small = small_inter_phase(torch, work, made)
    check("jax" not in sys.modules, "jax was imported")

    top = next(r for r in kern["rows"] if r["size"] == 32
               and r["bit_inc"] == 0)
    # K2's time: one 1080p frame's 35-mode sweep, the five bit_inc 0
    # classes summed
    frame = [r for r in k2["rows"] if r["bit_inc"] == 0]
    by_path = {
        "intra_decode": {"residual": dec["residual_kernel_launches"]},
        "fastrd_encode": {"residual": fast["residual_launches"],
                          "satd": fast["satd_launches"]},
        "inter_decode": inter["launches"],
        **{f"inter_decode_{k}": v for k, v in small.items()}}
    print("launches by path " + json.dumps(by_path))
    print(json.dumps({"kernels": [{
        "name": "residual", "route": "cuda",
        "source": "thevc_tpu_torch/csrc/residual.cu",
        "replaces": "thevc_tpu/ops/jx_pallas.py:141",
        "launches": sum(p.get("residual", 0) for p in by_path.values()),
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
