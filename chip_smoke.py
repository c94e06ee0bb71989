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
   seeded full-range int16 coefficients and the scaled QPs of slice QPs
   0..51: 8x8 to 32x32 CG-packed through the fused entry, as the decode
   ships them, with every 4x4 group coded and again (bit increment 0)
   with a quarter of them and, at 32x32, none; 4x4 dense.  Tolerance 0
   (integer codec math).  At the size of a class that covers 8 luma
   planes of 1920x1080 it prints per class the kernel's time (CUDA
   events around 20 eager calls, host launch costs included) and its
   device time (20 launches as one CUDA graph, median of 5 replays; the
   run fails unless the graph holds a kernel node a call, counted on the
   captured graph through the driver API), the
   plain version's time (eager), the bytes the kernel must move, its
   bound (those bytes over 3.35 TB/s, or its multiply-adds over the peak
   of their type, whichever is larger) and its share of that bound by
   either time.
4. SATD kernel (K2) against its plain version on the card, at the
   shapes of the 1080p fast-RD sweep: N = (1088/s) * (1920/s) PUs of
   size s against M = 35 candidates, for s = 4, 8, 16, 32, 64 at bit
   increment 0 and s = 8, 64 at bit increment 2, and a ragged N = 4099.
   Tolerance 0; times both, with the bound and shares as for K1.
5. Streams: writes a 1920x1080 8-frame clip and a 1920x1080 8-frame
   motion clip (``tools/make_test_clip.py``, seed 1234, the second with
   ``--style motion``) and a 416x240 9-frame motion clip, then encodes,
   all at once in child processes (``thevc_tpu_torch.streams``), with the
   port's own encoder on its exact path at QP 32 with MD5 digest SEI:
   the first clip all-intra with SAO
   (``tests/cfg/encoder_intra_main.cfg``), the second low-delay B with
   SAO (``tests/cfg/encoder_lowdelay_tlayers.cfg``),
   the third low-delay P (5 frames) and random access with a GOP of 8
   (9 frames; ``encoder_lowdelay_P_main.cfg``,
   ``encoder_randomaccess_main.cfg``); the 64x64 and 128x64 streams of 9,
   11 and 12.
   Intra decode phase: decodes the all-intra stream through the
   port's CLI on ``cuda``: one warm-up, then three timed runs (host clock
   ending in ``torch.cuda.synchronize()``; fps from the median).  In every
   run each digest must verify, the recon must be byte-identical to the
   encoder's and the kernel must have been launched by the decode (its
   count is zeroed just before the run and read just after).  Then one
   more decode records the residual kernel's inputs, and on each of those
   classes, the decode's own data, the kernel is held against its plain
   version (tolerance 0) and both are timed, with its bound and shares as
   in 3.
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
   CUDA graph per class; a class whose graph holds no kernel fails the
   run, except the uni-predicted copies, which return a view of their
   windows and have no graph time).  The 416x240 low-delay P and random-access
   streams decode on ``cuda`` with every digest OK and recon
   byte-identical to their encoders'.
9. P/B fast-RD phase (``fastrd_inter``): encodes the 1080p motion clip
   with ``--FastRD=1 --device cuda`` and the low-delay B cfg at QP 32
   (SAO on, as the exact stream) in a child process whose report gives
   the launches of both kernels (each above 0), the decision frames (8,
   7 of them B) and the decision wall; decodes it on ``cuda`` (8/8
   digests OK, recon byte-identical to the encoder's) and reports its
   bytes and luma PSNR beside the exact low-delay B stream's (no gate).
   Then, in this process, one B frame's decision pass replayed from
   the encoder's own call: the clip's first 4 frames are encoded in
   this process (same cfg, ``Encoder(cfg, device="cuda")``) with the
   arguments of the last ``fast_inter.decide_frame_p`` call recorded,
   and that call runs again on ``cuda``: a warm-up, three timed runs
   (synchronised wall, K1/K2 launches counted from 0), one with stage
   timing on (stage walls), one under ``torch.profiler`` (device time,
   busy share), and one that records every K1 and K2 call of the pass,
   the intra leaves' SATD calls included (as many as the launches):
   each is held against its plain version on the pass's own data
   (tolerance 0) and the 49-candidate SATD classes are timed with their
   bytes, bound and share (``kernel satd`` rows, as in 4).  Then 416x240 low-delay P (3 frames)
   and random-access (5 frames) fast-RD streams of the small motion
   clip: ``--device cuda`` and ``--device cpu`` byte-identical.  Last,
   the 64x64 weighted-prediction (``--wpP=1`` low-delay P, ``--wpB=1``
   low-delay B, a fading clip) and scaling-list (``--ScalingList=1``
   all-intra and low-delay B) streams decode on ``cuda`` with every
   digest OK and recon byte-identical to their encoders'.
10. Device-apply phase (``fastrd_devapply``), the fast-RD slice's main
   path: encodes the 1080p all-intra clip with ``--FastRD=1 --device
   cuda --device-apply`` at QP 32 (SAO, RDOQ on) in a child process whose
   report gives the kernels' launches, the device-apply frames (8, none
   left to the host apply), waves, class steps and wall; decodes it on
   ``cuda`` and on the CPU (8/8 digests OK, recon byte-identical to the
   encoder's); reports its wall beside the fast-RD phase's host-apply
   encode of the same clip and ``fastrd_devapply_bits_overhead_pct``
   (100 x (device-apply bytes / host-apply bytes - 1)) with the luma
   PSNR difference.  Then one frame's apply in this process, from the
   call an in-process 1-frame encode made (its stage walls printed): a
   warm-up and three synchronised graph-replayed runs (host setup and
   issue time, the loop's span in CUDA events, K1 counted once per
   replayed launch and warm-up), one under ``torch.profiler`` (kernels
   only: device time, kernels a class step), and one eager run in which
   every K1 call is held against ``tq.residual_pipeline_plain``
   (tolerance 0); the replayed apply equals the eager one (recon and
   every level stack, tolerance 0); the bytes a class step must move and
   the frame's HBM bound.  Last, the 416x240 identity encodes, all at
   once: RDOQ and the top-2 re-rank off, ``cuda`` (frames in threads),
   ``cpu`` and the host apply byte-identical; RDOQ on, ``cuda`` ==
   ``cpu`` at QP 27 and 37.
11. A 128x64 tiles stream and WPP stream (32x32 CTUs; the encoder
   refuses both in one stream) decode on ``cuda`` with every digest OK
   and recon byte-identical to their encoders'.
12. Multi-stream phase (``multistream``, ``thevc_tpu_torch.graft_entry``):
   the graft entry's step (256 8x8 TUs through K1's dense entry) on
   ``cuda``, equal to ``tq.tu_recon_pipeline_plain`` (tolerance 0) with
   one K1 launch; the step, its plain version and K1 alone timed (CUDA
   events, 20 calls; K1 also as a CUDA graph); the 8-slot dry run
   (8 spawned processes, each slot's device work on ``cuda:0``, its
   collective gloo between the processes, since NCCL takes no two ranks
   on one card): each slot's 2-frame 48x48 fast-RD encode with the QPs
   of the shared rate pool, the steering check, 16 pictures digest OK
   and the frame-sharded decode of slot 0's stream, printing the QP and
   spend histories, the local-only QPs, the all-reduce latencies and
   each slot's walls (process start, CUDA context, group, encode, pool
   wait, decode); the same dry run with every slot on the host, whose
   QP and spend histories and streams (SHA-256 a slot) must equal the
   card's; the same dry run over NCCL on 8 cards where the
   machine has them, else one line that says it did not run; a
   one-rank NCCL group on ``cuda:0`` (its all-reduce returns the slot's
   own spend; latencies printed, beside the median wall of one int64
   copied to the card and read back, the least a one-card all-reduce
   can cost); the 64x64 decode-tool streams (QP 22,
   QP 51, PCM, CU delta QP, filters off; ``streams.TOOL_STREAMS``)
   decoded on ``cuda`` with every digest OK and recon byte-identical to
   their encoders'.
13. Robustness phase (``robust_decode``): the 176x144 streams of
   ``streams.robust_streams`` (the port's exact encoder) decode on
   ``cuda`` and on the CPU, equal in POCs, digest flags and every
   picture's planes (``streams.ROBUST_CASES``): lost-picture concealment
   (the low-delay P stream without POC 2's slice, POC 1 copied in),
   random-access entry at the CRA of a 17-frame random-access stream
   (``skip_frames=9``), the CRA retyped as a BLA (its TFD pictures
   dropped), ``skip_frames=1`` on an all-intra stream (nothing decoded),
   and the temporal-layer cap ``max_temporal_layer=0`` on a low-delay B
   stream (the three with decoder options also through the decoder CLI's
   ``-s`` and ``-t`` on ``cuda``, its output the decode's planes); K1
   and the MC must have run, and the concealed picture must
   reach the card once (``RefPlanes.get``, when POC 3 first refers to
   it) and stay while POC 4 does.  Then 24 seeded corrupted copies
   of the 9-frame random-access stream (bit flips and truncations,
   ``streams.fuzz_variants``) decode on ``cuda``, each followed by
   ``torch.cuda.synchronize()``: each decodes or raises a Python
   exception (a CUDA error fails the run), with the same outcome as on
   the CPU; then the clean stream decodes on ``cuda`` with every digest
   OK in the same process.  Prints the outcomes by exception type, the
   fuzz decodes' wall and the phase's K1 and MC launches.
14. Resume and rate-control phase (``resume_rc``), in this process
   through the port's encoder CLI: a 96x80 9-frame low-delay P
   ``--FastRD=1`` encode on ``cuda``, uninterrupted, and checkpointed at
   frame 5 (``--CheckpointEvery=1``) then resumed: the streams and recons
   of the resumed and uninterrupted ``cuda`` runs and the ``cpu`` run are
   byte-identical, and the resumed stream decodes on ``cuda`` digest-OK;
   a 416x240 4-frame all-intra ``--FastRD=1 --RateCtrl=1
   --TargetBitrate=1000000 --device-apply`` encode on ``cuda`` and on the
   CPU, byte-identical, every frame decided and applied on the device,
   digest-OK and recon-exact through the port's decoder on ``cuda``
   (per-frame QP and bits printed), and the same for a 3-frame low-delay
   B encode (``encoder_lowdelay_tlayers.cfg``, no device apply) whose
   frame QPs must move (the tests hold them against the JAX package's
   rate controller fed the same bits); one
   ``thevc_tpu_torch.tools.fastrd_quality`` sweep on ``cuda`` (2 frames
   of that clip, QP 22-37), its rows printed.  The phase's K1 and K2
   launches (``cuda`` runs only) must be above 0.
15. Prints the kernels' JSON line (per kernel: launches on the main
   paths, largest error against the plain version, eager time, plain
   time, bound and what bounds it; K1 at the intra decode's largest
   class, printed beside the 32x32 class with every group coded, K2
   summed over a frame's five classes; no single PyTorch call computes
   either, so ``library_ms`` is null), then the card's name and
   power limit, then the device JSON line last.  Neither ``jax`` nor any
   module of the JAX package may have been imported.

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
# TU classes of the decode: (size, use_dst, bit_increment, share of the
# 4x4 groups coded); every group coded is the most input a class can
# carry, a quarter of them nearer a decode's classes, none the kernel's
# cost without input
RESIDUAL_TIMING = [(4, True, 0, 1.0), (4, False, 0, 1.0), (8, False, 0, 1.0),
                   (16, False, 0, 1.0), (32, False, 0, 1.0),
                   (4, True, 2, 1.0), (8, False, 2, 1.0), (32, False, 2, 1.0),
                   (8, False, 0, 0.25), (16, False, 0, 0.25),
                   (32, False, 0, 0.25), (32, False, 0, 0.0)]
# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM
# bytes/s, dense int8 tensor-core ops/s, float32 ops/s outside the tensor
# cores (the rate int32 work is held to here)
HBM_BYTES_S = 3.35e12
INT8_TENSOR_OPS = 1.979e15
FP32_OPS = 67e12
# PU classes of the fast-RD sweep: (size, bit_increment)
SATD_CLASSES = [(4, 0), (8, 0), (16, 0), (32, 0), (64, 0), (8, 2), (64, 2)]
SATD_MODES = 35
# the CPU-against-CUDA identity clip
SMALL_W, SMALL_H, SMALL_FRAMES, SMALL_QPS = 416, 240, 2, (27, 37)
CFG = ROOT / "tests" / "cfg"
LDB_CFG = CFG / "encoder_lowdelay_tlayers.cfg"
# the small inter streams: name -> (frames, cfg)
SMALL_INTER = {"ldp": (5, CFG / "encoder_lowdelay_P_main.cfg"),
               "ra": (9, CFG / "encoder_randomaccess_main.cfg")}
# the P/B fast-RD CPU-against-CUDA streams of the small motion clip
SMALL_FASTRD = {"ldp": (3, CFG / "encoder_lowdelay_P_main.cfg"),
                "ra": (5, CFG / "encoder_randomaccess_main.cfg")}
# the 64x64 weighted-prediction and scaling-list streams: name -> (clip,
# frames, cfg, switch)
WP_SL = {"wp_p": ("fade", 3, CFG / "encoder_lowdelay_P_main.cfg",
                  "--wpP=1"),
         "wp_b": ("fade", 3, LDB_CFG, "--wpB=1"),
         "sl_intra": ("tiny_motion", 2, CFG / "encoder_intra_main.cfg",
                      "--ScalingList=1"),
         "sl_ldb": ("tiny_motion", 3, LDB_CFG, "--ScalingList=1")}

# the partitioned streams of a 128x64 clip, 32x32 CTUs (4x2 a picture):
# 2x2 uniform tiles, and WPP (one substream per CTU row); the encoder
# refuses tiles and WPP in one stream, as HM does
CTU32 = ("--MaxCUWidth=32", "--MaxCUHeight=32", "--MaxPartitionDepth=3")
PARTITIONED = {"tiles": (*CTU32, "--UniformSpacingIdc=1",
                         "--NumTileColumnsMinus1=1", "--NumTileRowsMinus1=1"),
               "wpp": (*CTU32, "--WaveFrontSynchro=1")}


# the robustness phase: corrupted variants of the 9-frame RA stream
FUZZ_TRIALS = 24
# the resume and rate-control phase: checkpoint/resume clip (w, h,
# frames), rate-controlled clip (w, h, frames, target bit/s), the frames
# of its low-delay B encode, and the fastrd_quality sweep (frames of that
# clip, QPs)
RESUME = (96, 80, 9)
RC = (416, 240, 4, 1000000)
RC_LDB_FRAMES = 3
QUALITY_FRAMES, QUALITY_QPS = 2, (22, 27, 32, 37)


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


def time_ms(torch, fn, iters: int, reps: int = 1) -> float:
    """Milliseconds per call on the card: the mean over ``iters`` calls
    between two CUDA events, after 2 warm-ups; with ``reps`` > 1 the
    median of that many such means."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return sorted(means)[len(means) // 2]


def residual_bound(n: int, size: int, m_rows: int, packed: bool) -> tuple:
    """(bytes, operations, bound_ms, bound_by) of one residual launch:
    the bytes it must move (the coded groups, their indices and the QPs
    in, or the dense coefficients; the int16 residual out) over HBM's
    rate, and its multiply-adds (two passes of ``size`` per coefficient,
    twice over for the hi/lo split on the int8 tensor cores; on the
    int32 CUDA cores for 4x4) over the peak rate of their type."""
    coeffs = n * size * size
    nbytes = (m_rows * (32 + 4) if packed else coeffs * 2) + n * 4 \
        + coeffs * 2
    if size >= 8:
        ops, peak = coeffs * 2 * size * 2 * 2, INT8_TENSOR_OPS
    else:
        ops, peak = coeffs * 2 * size * 2, FP32_OPS
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return nbytes, ops, 1000 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def packed_class(rng, n: int, size: int, bit_inc: int, density: float):
    """Full-range int16 coefficients with each 4x4 group coded with
    probability ``density``, CG-packed as the decode ships them; QPs of
    slice QPs 0..51.  Returns (dense q, qp, vals, idx, coded rows)."""
    import numpy as np
    from thevc_tpu_torch.decoder.recon import _pack_cgs
    q = rng.randint(-32768, 32768, (n, size, size)).astype(np.int16)
    if density < 1.0:
        g = size // 4
        keep = rng.rand(n, g, 1, g, 1) < density
        q *= np.broadcast_to(keep, (n, g, 4, g, 4)).reshape(q.shape)
    qp = rng.randint(0, 52 + 6 * bit_inc, n).astype(np.int32)
    if size == 4:
        return q, qp, None, None, 0
    vals, idx = _pack_cgs(q, size, n)
    coded = int((idx < n * (size // 4) ** 2).sum())
    return q, qp, vals, idx, coded


def kernel_nodes(graph) -> int:
    """Kernel nodes of a captured CUDA graph (``keep_graph=True``), read
    from its ``cudaGraph_t`` through the driver API."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    handle = graph.raw_cuda_graph()
    n = ctypes.c_size_t(0)
    rc = cu.cuGraphGetNodes(handle, None, ctypes.byref(n))
    check(rc == 0, f"cuGraphGetNodes returned {rc}")
    if not n.value:
        return 0
    nodes = (ctypes.c_void_p * n.value)()
    rc = cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n))
    check(rc == 0, f"cuGraphGetNodes returned {rc}")
    kind, count = ctypes.c_int(), 0
    for node in nodes:
        rc = cu.cuGraphNodeGetType(node, ctypes.byref(kind))
        check(rc == 0, f"cuGraphNodeGetType returned {rc}")
        count += kind.value == 0              # CU_GRAPH_NODE_TYPE_KERNEL
    return count


def capture(torch, fn, iters: int):
    """``iters`` calls of ``fn`` captured in one CUDA graph, after a
    warm-up on a side stream.  Returns the graph and its kernel nodes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return graph, kernel_nodes(graph)


def graph_ms(torch, fn, iters: int, reps: int = 5) -> float:
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph and replayed between two CUDA events, so host launch costs are
    not counted; the median of ``reps`` replays.  Each call must have put
    at least one kernel into the graph: a replay of nothing is no time."""
    graph, nodes = capture(torch, fn, iters)
    check(nodes >= iters, f"a graph of {iters} calls holds {nodes} kernels")
    ms = time_ms(torch, graph.replay, 1, reps) / iters
    del graph
    return ms


def kernel_phase(torch, tq, rng_seed: int) -> dict:
    """The residual kernel (K1) vs its plain version in every class, at a
    ragged size and at the size of a class that covers 8 luma planes of
    1920x1080; 8x8 to 32x32 through the fused CG-packed entry (as the
    decode ships them), 4x4 dense.  Returns the timings."""
    import numpy as np
    dev = torch.device("cuda")
    rng = np.random.RandomState(rng_seed)
    max_err = 0
    rows = []
    for size, use_dst, bit_inc, density in RESIDUAL_TIMING:
        for n in (4099, FRAMES * WIDTH * HEIGHT // (size * size)):
            q, qp, vals, idx, coded = packed_class(rng, n, size, bit_inc,
                                                   density)
            qp_d = torch.from_numpy(qp).to(dev)
            if size == 4:
                q_d = torch.from_numpy(q).to(dev)
                def run(q_d=q_d, qp_d=qp_d):
                    return tq.residual_pipeline(q_d, qp_d, use_dst, bit_inc)
                def plain(q_d=q_d, qp_d=qp_d):
                    return tq.residual_pipeline_plain(q_d, qp_d, use_dst,
                                                      bit_inc)
            else:
                v_d = torch.from_numpy(vals).to(dev)
                i_d = torch.from_numpy(idx).to(dev)
                def run(v_d=v_d, i_d=i_d, qp_d=qp_d):
                    return tq.residual_pipeline_packed(v_d, i_d, qp_d, size,
                                                       use_dst, bit_inc)
                def plain(v_d=v_d, i_d=i_d, qp_d=qp_d):
                    return tq.residual_pipeline_packed_plain(
                        v_d, i_d, qp_d, size, use_dst, bit_inc)
            got, want = run(), plain()
            torch.cuda.synchronize()
            err = int((got.to(torch.int32) - want.to(torch.int32))
                      .abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got, want),
                  f"kernel != plain at {size}x{size} dst={use_dst} "
                  f"bit_inc={bit_inc} density={density} n={n} "
                  f"(max abs err {err})")
        ms = time_ms(torch, run, 20)
        g_ms = graph_ms(torch, run, 20)
        plain_ms = time_ms(torch, plain, 5)
        nbytes, ops, bound_ms, bound_by = residual_bound(
            n, size, coded, size >= 8)
        row = dict(size=size, dst=use_dst, bit_inc=bit_inc, density=density,
                   n=n, coded_groups=coded, ms=ms, graph_ms=g_ms,
                   plain_ms=plain_ms, bytes=nbytes, ops=ops,
                   bound_ms=bound_ms, bound_by=bound_by,
                   share_of_bound=bound_ms / ms,
                   graph_share_of_bound=bound_ms / g_ms,
                   gb_s=nbytes / ms / 1e6)
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
             "small_motion": (SMALL_W, SMALL_H, 9, "motion"),
             "fade": (64, 64, 3, "fade"),
             "tiny_motion": (64, 64, 3, "motion"),
             "part": (128, 64, 1, "default")}
    paths = {}
    for name, (w, h, frames, style) in clips.items():
        paths[name] = work / f"{name}_{w}x{h}_{frames}f.yuv"
        make_clip(paths[name], w, h, frames, style)
    qp = f"--QP={QP}"
    jobs = {"intra_main": ("intra", FRAMES, CFG / "encoder_intra_main.cfg",
                           (qp, "--SAO=1")),
            "inter_ldb": ("motion", FRAMES, LDB_CFG, (qp, "--SAO=1"))}
    for name, (frames, cfg) in SMALL_INTER.items():
        jobs[name] = ("small_motion", frames, cfg, (qp,))
    for name, (clip, frames, cfg, switch) in WP_SL.items():
        jobs[name] = (clip, frames, cfg, (qp, switch))
    for name, switches in PARTITIONED.items():
        jobs[name] = ("part", 1, CFG / "encoder_intra_main.cfg",
                      (qp, *switches))
    # the decode-tool streams, as the port's tests make them (the cfg's
    # QP 32 unless their arguments set one)
    for name, path in streams.tool_clips(work).items():
        clips[f"tool_{name}"] = (streams.TOOL_W, streams.TOOL_H,
                                 streams.TOOL_FRAMES, name)
        paths[f"tool_{name}"] = path
    for name, (clip, extra) in streams.TOOL_STREAMS.items():
        jobs[f"tool_{name}"] = (f"tool_{clip}", streams.TOOL_FRAMES,
                                streams.INTRA_CFG, extra)

    def encode(item):
        name, (clip, frames, cfg, extra) = item
        w, h = clips[clip][:2]
        stream = work / f"{name}.bin"
        enc_rec = work / f"{name}_enc_rec.yuv"
        t0 = time.perf_counter()
        streams.encode(paths[clip], stream, enc_rec, w, h, frames, cfg=cfg,
                       extra=extra)
        return name, (paths[clip], stream, enc_rec, w, h, frames,
                      time.perf_counter() - t0)

    with ThreadPoolExecutor(len(jobs)) as ex:
        made = dict(ex.map(encode, jobs.items()))
    for name, (_c, stream, _r, w, h, frames, wall) in made.items():
        print(f"encode {name}: {frames} frames {w}x{h} "
              f"{' '.join(jobs[name][3])} in {wall:.3f} s (host, "
              f"{len(jobs)} encodes at once), {stream.stat().st_size} bytes")
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
    out["residual_classes"] = decode_class_times(torch, stream)
    out.update(clip=str(clip), stream=str(stream), enc_rec=str(enc_rec))
    return out


def decode_class_times(torch, stream: Path) -> dict:
    """Decode ``stream`` on ``cuda`` recording the residual kernel's
    inputs, then hold the kernel against its plain version on each of
    those classes (the decode's own data), time both and print the
    kernel's bound and share, as in the K1 phase."""
    from thevc_tpu_torch.decoder.top import Decoder
    from thevc_tpu_torch.ops import tq
    calls = []
    packed, dense = tq.residual_pipeline_packed, tq.residual_pipeline
    plain_of = {packed: tq.residual_pipeline_packed_plain,
                dense: tq.residual_pipeline_plain}

    def record_packed(vals, idx, qp, size, use_dst, bit_inc):
        calls.append((packed, (vals, idx, qp, size, use_dst, bit_inc)))
        return packed(vals, idx, qp, size, use_dst, bit_inc)

    def record_dense(q, qp, use_dst, bit_inc):
        calls.append((dense, (q, qp, use_dst, bit_inc)))
        return dense(q, qp, use_dst, bit_inc)
    tq.residual_pipeline_packed, tq.residual_pipeline = record_packed, \
        record_dense
    try:
        pics = Decoder("cuda").decode_stream(stream.read_bytes())
    finally:
        tq.residual_pipeline_packed, tq.residual_pipeline = packed, dense
    check(all(p.digest_ok for p in pics), "the recording decode failed")
    rows = []
    max_err = 0
    for fn, args in calls:
        if fn is packed:
            vals, idx, qp, size = args[:4]
            n = int(qp.shape[0])
            coded = int((idx < n * (size // 4) ** 2).sum())
        else:
            n, size, coded = int(args[0].shape[0]), int(args[0].shape[1]), 0
        got, want = fn(*args), plain_of[fn](*args)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"kernel != plain on the decode's "
              f"{size}x{size} class of {n} TUs (max abs err {err})")

        def run(fn=fn, args=args):
            return fn(*args)

        def plain(fn=plain_of[fn], args=args):
            return fn(*args)
        ms = time_ms(torch, run, 20)
        g_ms = graph_ms(torch, run, 20)
        plain_ms = time_ms(torch, plain, 5)
        nbytes, ops, bound_ms, bound_by = residual_bound(n, size, coded,
                                                         fn is packed)
        rows.append(dict(size=size, dst=bool(args[-2]), n=n,
                         coded_groups=coded, ms=ms, graph_ms=g_ms,
                         plain_ms=plain_ms, bytes=nbytes, bound_ms=bound_ms,
                         bound_by=bound_by, share_of_bound=bound_ms / ms,
                         graph_share_of_bound=bound_ms / g_ms))
        print("decode_class residual " + json.dumps(rows[-1]))
    return {"max_abs_err": max_err, "rows": rows}


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
    gaps included) and as one CUDA graph (device time).  Each class's
    bound: the int16 windows read and predictions written, over HBM's
    rate."""
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
        graph, nodes = capture(torch, replay, 1)
        if nodes:
            graph_ms = time_ms(torch, graph.replay, 10) / n_pics
        else:
            # a uni-predicted copy returns a view of its windows: no
            # device work, so no graph time
            check(case == "copy" and not bi, f"the MC class "
                  f"{(luma, case, bi)} put no kernel into its graph")
            graph_ms = None
        del graph
        nbytes = sum(2 * (c[0].numel() + c[0].shape[0] * c[7] * c[8])
                     for c in cl)
        rows.append(dict(
            comp="luma" if luma else "chroma", case=case, bi=bool(bi),
            calls=len(cl), pus=sum(int(c[0].shape[0]) for c in cl),
            eager_ms_per_picture=eager / n_pics, kernel_nodes=nodes,
            graph_ms_per_picture=graph_ms,
            bytes_per_picture=nbytes / n_pics,
            bound_ms_per_picture=1000 * nbytes / HBM_BYTES_S / n_pics))
        print("mc_class " + json.dumps(rows[-1]))
    print("mc_total " + json.dumps({
        "pictures": n_pics,
        "eager_ms_per_picture": sum(r["eager_ms_per_picture"] for r in rows),
        "graph_ms_per_picture": sum(r["graph_ms_per_picture"] or 0
                                    for r in rows),
        "bytes_per_picture": sum(r["bytes_per_picture"] for r in rows),
        "bound_ms_per_picture": sum(r["bound_ms_per_picture"]
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


def satd_bound(n: int, size: int, m: int = SATD_MODES) -> tuple:
    """(bytes, operations, bound_ms, bound_by) of one SATD sweep: org and
    the m candidates in (int16), the int32 sums out; per candidate sample
    a difference, the 4x4 (PU 4) or 8x8 Hadamard's butterflies and an
    absolute value and a sum, int32 on the CUDA cores."""
    samples = n * m * size * size
    nbytes = (n * size * size + samples) * 2 + n * m * 4
    ops = samples * (2 * (2 if size == 4 else 3) + 3)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / FP32_OPS
    return nbytes, ops, 1000 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


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
        g_ms = graph_ms(torch, lambda: satd.satd_blocks(org, preds,
                                                        bit_inc), 20)
        plain_ms = time_ms(torch, lambda: satd.satd_plain(org, preds,
                                                          bit_inc), 5)
        nbytes, ops, bound_ms, bound_by = satd_bound(n, size)
        row = dict(size=size, bit_inc=bit_inc, n=n, m=SATD_MODES, ms=ms,
                   graph_ms=g_ms, plain_ms=plain_ms, bytes=nbytes,
                   ops=ops, bound_ms=bound_ms, bound_by=bound_by,
                   share_of_bound=bound_ms / ms,
                   graph_share_of_bound=bound_ms / g_ms,
                   gb_s=nbytes / ms / 1e6)
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
                height: int, frames: int, qp: int, device: str,
                cfg: Path = CFG / "encoder_intra_main.cfg", extra=(),
                env=None) -> dict:
    """Fast-RD encode through the port's CLI in a child process (``extra``
    arguments, ``env`` added to its environment); returns the CLI's
    report (kernel launches, decision-pass and device-apply counts and
    walls) with the encode's wall time."""
    from thevc_tpu_torch import streams
    from thevc_tpu_torch.apps.encoder import REPORT_PREFIX
    t0 = time.perf_counter()
    out = streams.encode(clip, stream, recon, width, height, frames,
                         cfg=cfg,
                         extra=(f"--QP={qp}", "--SAO=1", "--FastRD=1",
                                f"--device={device}", *extra), env=env)
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.splitlines() if ln.startswith(REPORT_PREFIX)]
    check(len(lines) == 1, f"no report line from the port's encoder:\n"
          f"{out[-2000:]}")
    report = json.loads(lines[0][len(REPORT_PREFIX):])
    report["wall_s"] = wall
    return report


def decode_cuda(torch, stream: Path, out: Path,
                device: str = "cuda", extra=()) -> tuple:
    """Decode ``stream`` with the port's CLI on ``cuda`` (or ``device``),
    ``extra`` arguments added."""
    from thevc_tpu_torch.apps import decoder as dec_app
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = dec_app.main(["-b", str(stream), "-o", str(out), "--device",
                           device, *extra])
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


def fastrd_inter_phase(torch, work: Path, made: dict) -> dict:
    """The 1080p low-delay B fast-RD encode on ``cuda``, its decode, and
    the comparison with the exact-path low-delay B stream."""
    clip, exact, exact_rec = made["inter_ldb"][:3]
    stream = work / "fastrd_ldb.bin"
    enc_rec = work / "fastrd_ldb_enc_rec.yuv"
    dec_rec = work / "fastrd_ldb_dec_rec.yuv"
    rep = port_encode(clip, stream, enc_rec, WIDTH, HEIGHT, FRAMES, QP,
                      "cuda", cfg=LDB_CFG)
    check(rep["satd_launches"] > 0, "the P/B fast-RD encode launched no "
          "SATD kernel")
    check(rep["residual_launches"] > 0, "the P/B fast-RD encode launched "
          "no residual kernel")
    check(not rep["jax_imported"], "the port's encoder imported jax")
    check(rep["decision_frames"] == FRAMES
          and rep["decision_frames_inter"] == FRAMES - 1,
          f"decision passes {rep['decision_frames']} "
          f"({rep['decision_frames_inter']} P/B) for {FRAMES} frames")
    rc, log = decode_cuda(torch, stream, dec_rec)
    check_decode(rc, log, FRAMES, dec_rec, enc_rec, "the P/B fast-RD stream")
    out = dict(frames=FRAMES, qp=QP, encode_wall_s=rep["wall_s"],
               encode_fps=FRAMES / rep["wall_s"],
               decision_wall_s=rep["decision_wall_s"],
               decision_ms_per_frame=1000 * rep["decision_wall_s"] / FRAMES,
               satd_launches=rep["satd_launches"],
               residual_launches=rep["residual_launches"],
               fast_bytes=stream.stat().st_size,
               exact_bytes=exact.stat().st_size,
               psnr_y_fast=luma_psnr(clip, enc_rec, WIDTH, HEIGHT, FRAMES),
               psnr_y_exact=luma_psnr(clip, exact_rec, WIDTH, HEIGHT,
                                      FRAMES))
    print("fastrd_inter " + json.dumps(out))
    out["pass"] = inter_pass_phase(torch, clip, work)
    return out


def recorded_b_call(clip: Path, work: Path) -> tuple:
    """The positional arguments and L1 list of the last B frame's
    ``fast_inter.decide_frame_p`` call in an in-process fast-RD encode of
    the clip's first 4 frames on ``cuda`` (low-delay B cfg, QP 32, SAO
    on, as the CLI encode; that frame has two references in each list),
    copied so that they outlive the encode."""
    import numpy as np
    from thevc_tpu_torch.encoder import fast_inter
    from thevc_tpu_torch.encoder.top import DecisionStats, Encoder
    from thevc_tpu_torch.utils.cfg import parse_args

    def copy(v):
        if isinstance(v, np.ndarray):
            return v.copy()
        if isinstance(v, (list, tuple)):
            return type(v)(copy(x) for x in v)
        return v
    calls = []
    real = fast_inter.decide_frame_p

    def spy(*args, **kwargs):
        calls.append((copy(args), copy(kwargs["ref_pics_l1"])))
        return real(*args, **kwargs)
    cfg = parse_args(["-c", str(LDB_CFG), "-i", str(clip), "-b",
                      str(work / "pass_ldb.bin"), "-wdt", str(WIDTH),
                      "-hgt", str(HEIGHT), "-f", "4", "-fr", "30",
                      f"--QP={QP}", "--SAO=1", "--FastRD=1",
                      "--SEIpictureDigest=1"])
    fast_inter.decide_frame_p = spy
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            Encoder(cfg, device="cuda", stats=DecisionStats()).encode(
                cfg.bitstream_file)
    finally:
        fast_inter.decide_frame_p = real
    check(len(calls) == 3 and len(calls[-1][0][3]) == 2
          and calls[-1][1] is not None and len(calls[-1][1]) == 2,
          f"the 4-frame low-delay B encode made {len(calls)} P/B decision "
          "passes, the last not with two references in each list")
    return calls[-1]


def inter_pass_phase(torch, clip: Path, work: Path) -> dict:
    """One 1080p B frame's decision pass in this process, replayed from
    the encoder's own call: synchronised walls, stage walls, profiler
    device time, and every K1 and K2 call of the pass held against its
    plain version."""
    from thevc_tpu_torch.encoder import fast_inter, fast_intra
    from thevc_tpu_torch.ops import device as dev_stats
    from thevc_tpu_torch.ops import residual_kernel, satd, satd_kernel, tq
    args, refs1 = recorded_b_call(clip, work)
    cache = fast_inter.RefCache()

    def run():
        return fast_inter.decide_frame_p(*args, ref_pics_l1=refs1,
                                         device="cuda", ref_cache=cache)
    run()                               # warm-up; the references go up
    walls, launches = [], None
    for _ in range(3):
        satd_kernel.launches = residual_kernel.launches = 0
        t = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t)
        launches = {"residual": residual_kernel.launches,
                    "satd": satd_kernel.launches}
        check(launches["residual"] > 0 and launches["satd"] > 0,
              f"the B decision pass skipped a kernel: {launches}")
    dev_stats.stage_timing(True)
    try:
        run()
    finally:
        stages = dev_stats.stage_timing(False)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        prof_wall = time.perf_counter() - t
    device_us, n_kernels, top = profiled_device(prof)
    wall = sorted(walls)[1]
    out = dict(wall_ms=[1000 * w for w in walls], median_wall_ms=1000 * wall,
               launches=launches, stage_ms={k: 1000 * v for k, v in
                                            sorted(stages.items())},
               profiled_wall_ms=1000 * prof_wall,
               device_ms=device_us / 1000, device_kernels=n_kernels,
               top_kernels_ms=top,
               device_busy_share=device_us / 1e6 / prof_wall)
    print("fastrd_inter_pass " + json.dumps(out))

    # record the pass's kernel calls (the inter leaves' and the intra
    # leaves'), then hold each against its plain version and time the
    # 49-candidate SATD classes
    calls = {"satd": [], "residual": []}
    real_satd, real_tq = satd.satd_blocks, tq.tu_recon_pipeline

    def rec_satd(org, preds, bit_inc=0):
        calls["satd"].append((org, preds, bit_inc))
        return real_satd(org, preds, bit_inc)

    def rec_tq(*a):
        calls["residual"].append(a)
        return real_tq(*a)
    fast_inter.satd_blocks = fast_intra.satd_blocks = rec_satd
    tq.tu_recon_pipeline = rec_tq
    try:
        run()
    finally:
        fast_inter.satd_blocks = fast_intra.satd_blocks = real_satd
        tq.tu_recon_pipeline = real_tq
    check({k: len(v) for k, v in calls.items()} == launches,
          f"recorded {[len(v) for v in calls.values()]} K2/K1 calls of the "
          f"B pass for launches {launches}")
    max_err = {"satd": 0, "residual": 0}
    rows = []
    for org, preds, bit_inc in calls["satd"]:
        got, plain = satd.satd_blocks(org, preds, bit_inc), \
            satd.satd_plain(org, preds, bit_inc)
        torch.cuda.synchronize()
        err = int((got - plain).abs().max())
        max_err["satd"] = max(max_err["satd"], err)
        check(torch.equal(got, plain), "SATD kernel != plain on the B "
              f"pass's {tuple(preds.shape)} call (max abs err {err})")
        n, m, size = (int(v) for v in preds.shape[:3])
        ms = time_ms(torch, lambda: satd.satd_blocks(org, preds, bit_inc),
                     20)
        g_ms = graph_ms(torch, lambda: satd.satd_blocks(org, preds,
                                                        bit_inc), 20)
        plain_ms = time_ms(torch, lambda: satd.satd_plain(org, preds,
                                                          bit_inc), 3)
        nbytes, ops, bound_ms, bound_by = satd_bound(n, size, m)
        rows.append(dict(size=size, bit_inc=bit_inc, n=n, m=m, ms=ms,
                         graph_ms=g_ms, plain_ms=plain_ms, bytes=nbytes,
                         ops=ops, bound_ms=bound_ms, bound_by=bound_by,
                         share_of_bound=bound_ms / ms,
                         graph_share_of_bound=bound_ms / g_ms,
                         gb_s=nbytes / ms / 1e6))
        if m == 49:
            print("kernel satd " + json.dumps(rows[-1]))
    for a in calls["residual"]:
        got, plain = tq.tu_recon_pipeline(*a), tq.tu_recon_pipeline_plain(*a)
        torch.cuda.synchronize()
        err = int((got - plain).abs().max())
        max_err["residual"] = max(max_err["residual"], err)
        check(torch.equal(got, plain), "residual kernel != plain on the B "
              f"pass's {tuple(a[1].shape)} call (max abs err {err})")
    out.update(max_abs_err=max_err, satd_rows=rows,
               residual_calls=len(calls["residual"]),
               residual_shapes=sorted({tuple(int(v) for v in a[1].shape)
                                       for a in calls["residual"]}))
    print("fastrd_inter_kernels " + json.dumps(
        {"max_abs_err": max_err, "residual_calls": out["residual_calls"],
         "satd_calls": len(rows), "replayed_pocs": {
             "l0": [r[0] for r in args[3]], "l1": [r[0] for r in refs1]}}))
    del calls
    torch.cuda.empty_cache()
    return out


def inter_identity_phase(work: Path, made: dict) -> dict:
    """P/B fast-RD streams of the small motion clip from ``--device cuda``
    and ``--device cpu`` must be byte-identical."""
    clip = made["ldp"][0]
    jobs = [(name, device) for name in SMALL_FASTRD
            for device in ("cuda", "cpu")]

    def encode(job):
        name, device = job
        frames, cfg = SMALL_FASTRD[name]
        stream = work / f"fastrd_{name}_{device}.bin"
        rep = port_encode(clip, stream, work / f"fastrd_{name}_{device}.yuv",
                          SMALL_W, SMALL_H, frames, QP, device, cfg=cfg)
        return job, (stream.read_bytes(), rep)
    with ThreadPoolExecutor(len(jobs)) as ex:
        got = dict(ex.map(encode, jobs))
    out = {}
    for name in SMALL_FASTRD:
        (cuda, rep), (cpu, _) = got[name, "cuda"], got[name, "cpu"]
        check(cuda == cpu, f"{name} P/B fast-RD stream: --device cuda and "
              "--device cpu differ")
        check(rep["satd_launches"] > 0 and rep["residual_launches"] > 0,
              f"{name} fast-RD on cuda skipped a kernel")
        out[name] = {"bytes": len(cuda), "identical": True,
                     "decision_frames_inter": rep["decision_frames_inter"],
                     "residual_launches": rep["residual_launches"],
                     "satd_launches": rep["satd_launches"]}
    print("inter_identity " + json.dumps(out))
    return out


def wp_scaling_phase(torch, work: Path, made: dict) -> dict:
    """The weighted-prediction and scaling-list streams on ``cuda``."""
    from thevc_tpu_torch.ops import mc, residual_kernel
    out = {}
    for name in WP_SL:
        _clip, stream, enc_rec, _w, _h, frames = made[name]
        dec_rec = work / f"{name}_dec_rec.yuv"
        residual_kernel.launches = mc.launches = 0
        rc, log = decode_cuda(torch, stream, dec_rec)
        check_decode(rc, log, frames, dec_rec, enc_rec, stream.name)
        out[name] = {"frames": frames, "residual": residual_kernel.launches,
                     "mc": mc.launches}
    print("wp_scaling " + json.dumps(out))
    return out

# the device-apply identity encodes of the small clip: (case, how) ->
# (device, extra arguments, environment); every "rdoq0" stream (RDOQ and
# the top-2 re-rank off) must equal the host apply's, and with RDOQ on
# the cuda stream the cpu one at each QP; the first runs its frames in
# threads (the CLI's frame-parallel all-intra path)
_TOP2_OFF = {"THEVC_FASTRD_TOP2": "0"}
DEVAPPLY_JOBS = {
    ("rdoq0", "cuda"): ("cuda", ("--RDOQ=0", "--device-apply"),
                        {**_TOP2_OFF, "THEVC_THREADS": "0"}),
    ("rdoq0", "cpu"): ("cpu", ("--RDOQ=0", "--device-apply"), _TOP2_OFF),
    ("rdoq0", "host"): ("cuda", ("--RDOQ=0",), _TOP2_OFF),
    **{(f"q{qp}", dev): (dev, ("--device-apply",), None)
       for qp in SMALL_QPS for dev in ("cuda", "cpu")}}


def fastrd_devapply_phase(torch, work: Path, dec: dict, fast: dict) -> dict:
    """The slice's main path: the 1080p all-intra fast-RD encode with the
    device apply on ``cuda``, its decodes on ``cuda`` and on the CPU, and
    its bytes and luma PSNR against the host-apply stream of the fast-RD
    phase (same clip, cfg and QP); then one frame's apply in this process
    and the small clip's identity encodes."""
    clip = Path(dec["clip"])
    stream = work / "devapply.bin"
    enc_rec = work / "devapply_enc_rec.yuv"
    dec_rec = work / "devapply_dec_rec.yuv"
    rep = port_encode(clip, stream, enc_rec, WIDTH, HEIGHT, FRAMES, QP,
                      "cuda", extra=("--device-apply",))
    check(rep["residual_launches"] > 0 and rep["satd_launches"] > 0,
          f"the device-apply encode skipped a kernel: {rep}")
    check(not rep["jax_imported"], "the port's encoder imported jax")
    check(rep["decision_frames"] == FRAMES
          and rep["device_apply_frames"] == FRAMES
          and rep["device_apply_fallback_frames"] == 0,
          f"device apply ran on {rep['device_apply_frames']} of {FRAMES} "
          f"frames ({rep['device_apply_fallback_frames']} host fallbacks)")
    rc, log = decode_cuda(torch, stream, dec_rec)
    check_decode(rc, log, FRAMES, dec_rec, enc_rec, "the device-apply stream")
    t = time.perf_counter()
    rc, log = decode_cuda(torch, stream, dec_rec, "cpu")
    cpu_decode_s = time.perf_counter() - t
    check_decode(rc, log, FRAMES, dec_rec, enc_rec,
                 "the device-apply stream (CPU decode)")
    dev_bytes, host_bytes = stream.stat().st_size, fast["fast_bytes"]
    psnr_dev = luma_psnr(clip, enc_rec, WIDTH, HEIGHT, FRAMES)
    out = dict(
        frames=FRAMES, qp=QP, encode_wall_s=rep["wall_s"],
        host_apply_encode_wall_s=fast["encode_wall_s"],
        decision_wall_s=rep["decision_wall_s"],
        apply_wall_s=rep["device_apply_wall_s"],
        apply_ms_per_frame=1000 * rep["device_apply_wall_s"] / FRAMES,
        waves_per_frame=rep["device_apply_waves"] / FRAMES,
        class_steps_per_frame=rep["device_apply_class_steps"] / FRAMES,
        residual_launches=rep["residual_launches"],
        satd_launches=rep["satd_launches"], devapply_bytes=dev_bytes,
        host_apply_bytes=host_bytes,
        fastrd_devapply_bits_overhead_pct=100 * (dev_bytes / host_bytes - 1),
        psnr_y_devapply=psnr_dev, psnr_y_host_apply=fast["psnr_y_fast"],
        psnr_y_diff_db=psnr_dev - fast["psnr_y_fast"],
        cpu_decode_wall_s=cpu_decode_s)
    print("fastrd_devapply " + json.dumps(out))
    out["frame"] = devapply_frame_phase(torch, clip, work)
    out["identity"] = devapply_identity_phase(work)
    return out


def recorded_apply_call(clip: Path, work: Path) -> tuple:
    """The arguments of the device apply of the clip's first frame,
    recorded from an in-process encode of that frame on ``cuda`` (the
    all-intra cfg at QP 32 with SAO, as the CLI encode), copied so that
    they outlive the encode; prints that encode's device-apply stage
    walls (ms: schedule, launch, fetch, fill, counter pass, CABAC)."""
    import numpy as np
    from thevc_tpu_torch.encoder import fast_apply
    from thevc_tpu_torch.encoder.top import DecisionStats, Encoder
    from thevc_tpu_torch.utils.cfg import parse_args

    def copy(v):
        return v.copy() if isinstance(v, np.ndarray) else v
    calls = []
    real = fast_apply.run_device_apply

    def spy(*args, **kwargs):
        calls.append(([copy(a) for a in args],
                      {k: copy(v) for k, v in kwargs.items()}))
        return real(*args, **kwargs)
    cfg = parse_args(["-c", str(CFG / "encoder_intra_main.cfg"), "-i",
                      str(clip), "-b", str(work / "apply_frame.bin"),
                      "-wdt", str(WIDTH), "-hgt", str(HEIGHT), "-f", "1",
                      "-fr", "30", f"--QP={QP}", "--SAO=1", "--FastRD=1",
                      "--SEIpictureDigest=1"])
    fast_apply.run_device_apply = spy
    fast_apply.stats_reset()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            Encoder(cfg, device="cuda", stats=DecisionStats(),
                    device_apply=True).encode(cfg.bitstream_file)
    finally:
        fast_apply.run_device_apply = real
    stages = fast_apply.stats_reset()
    check(len(calls) == 1 and stages["frames"] == 1,
          f"{len(calls)} device applies for one frame")
    print("fastrd_devapply_stages " + json.dumps(
        {k: v if k == "frames" else 1000 * v for k, v in stages.items()}))
    return calls[0]


def profiled_device(prof) -> tuple:
    """(device microseconds, kernel count, the six longest kernels by name
    in ms) of a ``torch.profiler`` run: the device activities' own time
    (the op rows' self device time would count each kernel twice), read
    from the profiler's raw records (building its Python events for a
    million kernels takes minutes)."""
    from torch.autograd import DeviceType
    by_name: dict = {}
    n = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n += 1
            us = e.duration_ns() / 1000 if hasattr(e, "duration_ns") \
                else e.duration_us()
            by_name[e.name()] = by_name.get(e.name(), 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return sum(by_name.values()), n, {k[:60]: v / 1000 for k, v in top}


def devapply_frame_phase(torch, clip: Path, work: Path) -> dict:
    """One 1080p frame's apply in this process, from the encoder's own
    call: graph-replayed walls (synchronised), the host's setup and issue
    time, the device time under ``torch.profiler``; the replayed apply
    against the eager one (recon and every level stack, tolerance 0) and
    every K1 call of the eager apply against its plain version (tolerance
    0; the eager wall includes those checks); the bytes each class step
    must move and the HBM bound of the frame's steps."""
    import numpy as np
    from thevc_tpu_torch.encoder import fast_apply
    from thevc_tpu_torch.ops import residual_kernel, tq
    args, kwargs = recorded_apply_call(clip, work)
    sched = args[3]
    steps = {ci: int((np.diff(o) > 0).sum()) for ci, o in enumerate(
        sched.offs)}
    # K1 launches of a class step: one per plane; a replayed apply also
    # launches each captured step once eagerly (its warm-up)
    per_step = {ci: 1 if fast_apply.CLS[ci][1] else 2 for ci in steps}
    k1_per_frame = sum(n * per_step[ci] for ci, n in steps.items())
    k1_warm_up = sum(per_step[ci] for ci, n in steps.items() if n)

    def run(replay):
        r = fast_apply.run_device_apply(*args, **dict(kwargs, replay=replay))
        return r, fast_apply.collect_device_apply(r)
    run(True)                               # warm-up
    walls, setup, issue, loop = [], [], [], []
    for _ in range(3):
        residual_kernel.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        r, graph_out = run(True)
        walls.append(time.perf_counter() - t)
        setup.append(r.setup_s)
        issue.append(r.issue_s)
        loop.append(r.loop_events[0].elapsed_time(r.loop_events[1]))
        check(residual_kernel.launches == k1_per_frame + k1_warm_up,
              f"{residual_kernel.launches} K1 launches counted for the "
              f"replayed apply, {k1_per_frame} replayed and {k1_warm_up} "
              "warm-ups")
    # the device's own time, device activities only
    from torch.profiler import ProfilerActivity, profile
    t_read = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run(True)
        prof_wall = time.perf_counter() - t
    device_us, n_kernels, top = profiled_device(prof)
    del prof
    profile_s = time.perf_counter() - t_read

    # the eager apply, every K1 call held against its plain version
    calls = []
    max_err = torch.zeros((), dtype=torch.int32, device="cuda")
    real = tq.residual_pipeline

    def record(q, qp, use_dst=False, bit_inc=0):
        nonlocal max_err
        got = real(q, qp, use_dst, bit_inc)
        plain = tq.residual_pipeline_plain(q, qp, use_dst, bit_inc)
        max_err = torch.maximum(max_err, (got.to(torch.int32)
                                          - plain.to(torch.int32))
                                .abs().max())
        calls.append(tuple(q.shape))
        return got
    tq.residual_pipeline = record
    residual_kernel.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        _r, eager_out = run(False)
    finally:
        tq.residual_pipeline = real
    eager_wall = time.perf_counter() - t
    k1_err = int(max_err)
    check(len(calls) == residual_kernel.launches == k1_per_frame,
          f"{len(calls)} K1 calls recorded, {residual_kernel.launches} "
          f"launches, {k1_per_frame} expected")
    check(k1_err == 0, f"K1 != plain inside the apply (max abs err "
          f"{k1_err})")
    graph_err = 0
    for g, e in zip(graph_out[:3] + graph_out[3] + graph_out[4],
                    eager_out[:3] + eager_out[3] + eager_out[4]):
        if g is not None:
            graph_err = max(graph_err, int(np.abs(
                g.astype(np.int32) - e.astype(np.int32)).max()))
    check(graph_err == 0, f"graph-replayed apply != eager apply (max abs "
          f"err {graph_err})")

    # the bytes a class step must move: its window's records (6 int64
    # fields), and per record and plane the reference line read (4s+1
    # int16), the source window read, the recon and the levels written
    # (s*s int16 each)
    def step_bytes(ci):
        size, luma, _ = fast_apply.CLS[ci]
        per_plane = 2 * (4 * size + 1) + 3 * 2 * size * size
        return sched.caps[ci] * (6 * 8 + (1 if luma else 2) * per_plane)
    total = sum(n * step_bytes(ci) for ci, n in steps.items())
    n_steps = sum(steps.values())
    wall = sorted(walls)[1]
    out = dict(
        waves=sched.n_waves, class_steps=n_steps,
        class_steps_by_class={str(fast_apply.CLS[ci][:2]): n
                              for ci, n in steps.items()},
        caps=list(sched.caps), records=list(sched.counts),
        wall_ms=[1000 * w for w in walls], median_wall_ms=1000 * wall,
        setup_ms=[1000 * v for v in setup],
        issue_ms=[1000 * v for v in issue],
        issue_us_per_wave=1e6 * sorted(issue)[1] / sched.n_waves,
        loop_span_ms=loop, profile_read_s=profile_s,
        profiled_wall_ms=1000 * prof_wall,
        device_ms=device_us / 1000, device_kernels=n_kernels,
        kernels_per_class_step=n_kernels / n_steps,
        top_kernels_ms=top, device_busy_share=device_us / 1e6 / prof_wall,
        eager_checked_wall_ms=1000 * eager_wall, k1_launches=k1_per_frame,
        k1_warm_up_launches=k1_warm_up,
        k1_max_abs_err=k1_err, graph_vs_eager_max_abs_err=graph_err,
        bytes_per_frame=total, bytes_per_class_step=total / n_steps,
        hbm_bound_ms=1000 * total / HBM_BYTES_S,
        device_share_of_bound=1000 * total / HBM_BYTES_S
        / max(device_us / 1000, 1e-9))
    print("fastrd_devapply_frame " + json.dumps(out))
    return out


def devapply_identity_phase(work: Path) -> dict:
    """The small clip's device-apply encodes (``DEVAPPLY_JOBS``), all at
    once: with RDOQ and the top-2 re-rank off, ``cuda`` (frames in
    threads), ``cpu`` and the host apply byte-identical; with RDOQ on,
    ``cuda`` == ``cpu`` at QP 27 and 37."""
    clip = work / f"clip_{SMALL_W}x{SMALL_H}_{SMALL_FRAMES}f.yuv"

    def encode(item):
        (case, how), (device, extra, env) = item
        qp = int(case[1:]) if case.startswith("q") else QP
        stream = work / f"devapply_{case}_{how}.bin"
        rep = port_encode(clip, stream, stream.with_suffix(".yuv"), SMALL_W,
                          SMALL_H, SMALL_FRAMES, qp, device, extra=extra,
                          env=env)
        return (case, how), (stream.read_bytes(), rep)
    with ThreadPoolExecutor(len(DEVAPPLY_JOBS)) as ex:
        got = dict(ex.map(encode, DEVAPPLY_JOBS.items()))
    for (case, how), (_data, rep) in got.items():
        want = 0 if how == "host" else SMALL_FRAMES
        check(rep["device_apply_frames"] == want,
              f"{case}/{how}: {rep['device_apply_frames']} device-apply "
              f"frames, expected {want}")
    out = {}
    for case in sorted({c for c, _ in DEVAPPLY_JOBS}):
        hows = [h for c, h in DEVAPPLY_JOBS if c == case]
        data = {h: got[case, h][0] for h in hows}
        check(len(set(data.values())) == 1,
              f"device-apply streams {case}: {hows} differ "
              f"({ {h: len(d) for h, d in data.items()} } bytes)")
        out[case] = {"identical": hows, "bytes": len(data[hows[0]])}
    print("devapply_identity " + json.dumps(out))
    return out


def partitioned_phase(torch, work: Path, made: dict) -> dict:
    """The tiles and the WPP stream on ``cuda``."""
    from thevc_tpu_torch.ops import residual_kernel
    out = {}
    for name in PARTITIONED:
        _clip, stream, enc_rec, _w, _h, frames = made[name]
        dec_rec = work / f"{name}_dec_rec.yuv"
        residual_kernel.launches = 0
        rc, log = decode_cuda(torch, stream, dec_rec)
        check_decode(rc, log, frames, dec_rec, enc_rec, stream.name)
        out[name] = {"frames": frames, "residual": residual_kernel.launches,
                     "bytes": stream.stat().st_size}
        check(out[name]["residual"] > 0, f"the {name} decode skipped K1")
    print("partitioned " + json.dumps(out))
    return out


def multistream_phase(torch, work: Path, made: dict) -> dict:
    """The multi-stream slice: the graft entry's step on ``cuda`` against
    its plain version, the 8-slot dry run over gloo with every slot on
    ``cuda:0``, the NCCL dry run where 8 cards exist, a one-rank NCCL
    rate pool, and the decode-tool streams on ``cuda``."""
    from thevc_tpu_torch import graft_entry
    from thevc_tpu_torch.ops import residual_kernel, tq
    out = {}

    # (a) the entry's step: one K1 launch (dense entry), equal to plain
    step, args = graft_entry.entry("cuda")
    residual_kernel.launches = 0
    got = step(*args)
    torch.cuda.synchronize()
    launches = residual_kernel.launches
    check(launches == 1, f"the entry step made {launches} K1 launches")

    def plain():
        return tq.tu_recon_pipeline_plain(*args, use_dst=False,
                                          bit_increment=0, max_val=255)
    err = int((got - plain()).abs().max().item())
    check(err == 0, f"the entry step differs from plain by {err}")
    # K1 alone on the step's batch (int16 levels, as the step gives it)
    q16, qp = args[1].to(torch.int16), args[2]

    def k1():
        return tq.residual_pipeline(q16, qp)
    nbytes, _ops, bound_ms, bound_by = residual_bound(
        graft_entry.N_TUS, graft_entry.TU_SIZE, 0, packed=False)
    out["entry"] = {"shape": list(got.shape), "residual": launches,
                    "max_abs_err": err,
                    "ms": time_ms(torch, lambda: step(*args), 20),
                    "plain_ms": time_ms(torch, plain, 20),
                    "k1_ms": time_ms(torch, k1, 20),
                    "k1_graph_ms": graph_ms(torch, k1, 20),
                    "k1_bytes": nbytes, "k1_bound_ms": bound_ms,
                    "k1_bound_by": bound_by}
    print("multistream_entry " + json.dumps(out["entry"]))

    # (b) 8 slots, 8 processes, one card: gloo between the processes
    rep = graft_entry.dryrun_multichip(8, "gloo", ["cuda:0"] * 8)
    slots = rep.pop("slot_reports")
    check(rep["pictures"] == rep["digests_ok"] == 16,
          f"dry run: {rep['digests_ok']} of {rep['pictures']} digests OK")
    check(rep["sharded_decoded"] == 2, "the frame-sharded decode missed a "
          "frame")
    check(rep["qp_history"][1] != rep["local_qps"], "the rate pool did not "
          "steer the QPs")
    for s in slots:
        check(s["device"] == "cuda:0", f"slot {s['rank']} on {s['device']}")
        for path, k in (("encode", "residual"), ("encode", "satd"),
                        ("decode", "residual")):
            check(s["launches"][path][k] > 0,
                  f"slot {s['rank']}: its {path} made no {k} launch")
    rep["collective"] = ("gloo between 8 processes sharing cuda:0 (NCCL "
                         "takes no two ranks on one card)")
    rep["slot_walls"] = [{k: s[k] for k in (
        "start_s", "context_s", "group_s", "encode_s", "pool_wait_s",
        "decode_s", "sharded_decode_s")} for s in slots]
    rep["launches"] = {
        "residual": sum(s["launches"]["encode"]["residual"]
                        + s["launches"]["decode"]["residual"]
                        for s in slots),
        "satd": sum(s["launches"]["encode"]["satd"] for s in slots)}
    print("multistream_dryrun " + json.dumps(rep))
    out["dryrun"] = rep
    # the same dry run with every slot on the host: the card's slots
    # (their K1 and K2 calls in the decision pass and the transform RD
    # estimate included) must make the host's streams, byte for byte
    host = graft_entry.dryrun_multichip(8, "gloo", ["cpu"] * 8)
    host.pop("slot_reports")
    for key in ("qp_history", "spent_history", "stream_sha256"):
        check(rep[key] == host[key], f"dry run {key}: cuda:0 {rep[key]} != "
              f"cpu {host[key]}")
    print("multistream_dryrun_cpu " + json.dumps(
        {"identical": ["qp_history", "spent_history", "stream_sha256"],
         "wall_s": host["wall_s"]}))

    # 8 cards: the same dry run over NCCL, one card a slot
    cards = torch.cuda.device_count()
    if cards >= 8:
        nccl = graft_entry.dryrun_multichip(
            8, "nccl", [f"cuda:{i}" for i in range(8)])
        nccl.pop("slot_reports")
        check(nccl["digests_ok"] == 16 and nccl["sharded_decoded"] == 2,
              "the NCCL dry run failed its decode checks")
        print("multistream_dryrun_nccl " + json.dumps(nccl))
    else:
        print(f"multistream_dryrun_nccl: not run: {cards} CUDA card(s), "
              "the NCCL dry run needs 8 (one a slot)")

    # (c) a one-rank NCCL group on cuda:0
    one = graft_entry.one_rank_pool("cuda:0")
    lat = sorted(one["allreduce_ms"])
    one["allreduce_ms_median"] = lat[len(lat) // 2]
    # K10's bound: the least a one-card device all-reduce of one int64
    # can cost is its 8 bytes to the card and back, with the wait
    one["bound_h2d_d2h_8b_ms"] = h2d_d2h_ms(torch)
    print("multistream_nccl_one_rank " + json.dumps(one))
    out["nccl_one_rank"] = one

    # (d) the decode-tool streams on cuda
    tools = {}
    for name in [n for n in made if n.startswith("tool_")]:
        _clip, stream, enc_rec, _w, _h, frames = made[name]
        dec_rec = work / f"{name}_dec_rec.yuv"
        residual_kernel.launches = 0
        rc, log = decode_cuda(torch, stream, dec_rec)
        check_decode(rc, log, frames, dec_rec, enc_rec, stream.name)
        tools[name] = {"frames": frames, "residual": residual_kernel.launches,
                       "bytes": stream.stat().st_size}
        check(tools[name]["residual"] > 0, f"the {name} decode skipped K1")
    print("multistream_tools " + json.dumps(tools))
    out["tools"] = tools
    return out


def h2d_d2h_ms(torch, reps: int = 20) -> float:
    """Median host wall (ms) of one int64 copied to ``cuda`` and read back
    (``.item()`` waits for the copy), after 3 warm-up copies."""
    host = torch.zeros(1, dtype=torch.int64)
    times = []
    for _ in range(reps + 3):
        t = time.perf_counter()
        host.to("cuda").item()
        times.append(1000 * (time.perf_counter() - t))
    return sorted(times[3:])[reps // 2]


def checked_decode(device: str, data: bytes, options=None) -> tuple:
    """``streams.decode_outcome`` of ``data`` on ``device``; fails the run
    when the decode raised a CUDA error."""
    from thevc_tpu_torch import streams
    got, text = streams.decode_outcome(data, device, options)
    check(not (isinstance(got, str) and "CUDA" in text),
          f"a decode on {device} raised a CUDA error: {got}: {text}")
    return got, text


def robust_decode_phase(torch, work: Path) -> dict:
    """Error-resilient and random-access decodes (``streams.ROBUST_CASES``)
    on ``cuda`` against the CPU, ``FUZZ_TRIALS`` corrupted streams on both,
    then the clean stream on ``cuda``.  The K1 and MC launches are those
    of the ``cuda`` decodes only (MC counts its CPU calls too)."""
    from thevc_tpu_torch import streams
    from thevc_tpu_torch.decoder import inter
    from thevc_tpu_torch.ops import mc, residual_kernel
    t0 = time.perf_counter()
    made = streams.robust_streams(work / "robust")
    out = {"streams_wall_s": time.perf_counter() - t0, "cases": {}}
    launched = {"residual": 0, "mc": 0}

    def on_card(decode, *args, **kw):
        """``decode(*args, **kw)``, its K1 and MC launches added to
        ``launched``."""
        r0, m0 = residual_kernel.launches, mc.launches
        res = decode(*args, **kw)
        launched["residual"] += residual_kernel.launches - r0
        launched["mc"] += mc.launches - m0
        return res

    put = inter.RefPlanes.put
    for case in streams.ROBUST_CASES:
        data, options, pocs = streams.robust_case(made, case)
        puts = []

        def spy(refs, pic, planes):
            puts.append(pic.poc)
            return put(refs, pic, planes)
        inter.RefPlanes.put = spy
        try:
            t = time.perf_counter()
            got, log = on_card(checked_decode, "cuda", data, options)
            wall = time.perf_counter() - t
        finally:
            inter.RefPlanes.put = put
        check(not isinstance(got, str),
              f"robust {case}: the cuda decode raised {got}: {log}")
        check([p[0] for p in got] == pocs,
              f"robust {case}: POCs {[p[0] for p in got]}, not {pocs}")
        ref, _ = checked_decode("cpu", data, options)
        check(streams.same_outcome(got, ref), f"robust {case}: the cuda "
              "decode differs from the cpu decode")
        flags = [d for _p, d, _l in got]
        if case == "conceal":
            check("inserting lost poc : 2" in log and flags[:3] == [
                True, True, None], f"robust {case}: POC 2 not concealed "
                  f"({flags}):\n{log}")
            # the concealed picture reaches the card once, when POC 3
            # first refers to it, and stays while POC 4 does
            check(sorted(puts) == pocs and puts.index(2) == puts.index(1)
                  + 1, f"robust {case}: device planes put {puts}")
        else:
            check(all(d is True for d in flags),
                  f"robust {case}: digests {flags}")
        if options:
            # -s and -t through the decoder CLI on cuda
            stream = work / "robust" / f"{case}.bin"
            stream.write_bytes(data)
            rec = work / "robust" / f"{case}_dec.yuv"
            rec.unlink(missing_ok=True)   # no picture: no file
            rc, cli_log = on_card(decode_cuda, torch, stream, rec, extra=[
                a for k, v in options.items()
                for a in (streams.ROBUST_CLI[k], str(v))])
            cli_yuv = rec.read_bytes() if rec.exists() else b""
            check(rc == 0 and cli_log.count("[MD5:(OK)]") == len(pocs)
                  and cli_yuv == b"".join(
                      pl.astype("uint8").tobytes() for _p, _d, pls in got
                      for pl in pls),
                  f"robust {case}: the CLI on cuda: {cli_log[-500:]}")
        out["cases"][case] = {"pocs": pocs, "digest_ok": flags,
                              "wall_s": wall}
    out["launches"] = dict(launched)
    check(out["launches"]["residual"] > 0 and out["launches"]["mc"] > 0,
          f"the robust decodes on cuda launched {out['launches']}")

    ra = made["ra"][0].read_bytes()
    outcomes, fuzz_wall = {}, 0.0
    for k, buf in enumerate(streams.fuzz_variants(ra, FUZZ_TRIALS)):
        t = time.perf_counter()
        got, text = on_card(checked_decode, "cuda", buf)
        fuzz_wall += time.perf_counter() - t
        ref, ref_text = checked_decode("cpu", buf)
        kind = got if isinstance(got, str) else "decoded"
        check(streams.same_outcome(got, ref), f"fuzz trial {k}: cuda gave "
              f"{kind} ({text[:200]}), cpu "
              f"{ref if isinstance(ref, str) else ''} ({ref_text[:200]})")
        outcomes[kind] = outcomes.get(kind, 0) + 1
    check(outcomes.get("decoded", 0) > 0, f"no fuzz trial decoded: "
          f"{outcomes}")
    # no CUDA error stuck: the clean stream still decodes exactly
    clean, log = on_card(checked_decode, "cuda", ra)
    check(not isinstance(clean, str) and len(clean) == made["ra"][2]
          and all(d is True for _p, d, _l in clean),
          f"the clean stream after the fuzz trials: {clean}: {log[-500:]}")
    out["fuzz"] = {"trials": FUZZ_TRIALS, "outcomes": outcomes,
                   "cuda_wall_s": fuzz_wall}
    out["launches_with_fuzz"] = dict(launched)
    print("robust_decode " + json.dumps(out))
    return out


def frame_lines(log: str) -> list:
    """(POC, QP, bits) of each of the encoder's per-picture lines."""
    import re
    return [(int(a), int(b), int(c)) for a, b, c in re.findall(
        r"^POC +(\d+) .*? QP (\d+) \) +(\d+) bits", log, re.M)]


def resume_rc_phase(torch, work: Path) -> dict:
    """Checkpoint/resume of a fast-RD encode on ``cuda``, the fast-RD
    device-apply encode under rate control on ``cuda`` against the CPU,
    and one ``fastrd_quality`` sweep on ``cuda``."""
    from thevc_tpu_torch.apps.encoder import REPORT_PREFIX
    from thevc_tpu_torch.ops import residual_kernel, satd_kernel
    from thevc_tpu_torch.tools import fastrd_quality, run_encoder
    out = {}
    residual_kernel.launches = satd_kernel.launches = 0

    def encode(name, device, clip, w, h, cfg, extra):
        t = time.perf_counter()
        log = run_encoder(["-c", cfg, "-i", clip, "-wdt", w, "-hgt", h,
                           "-fr", 30, "--SEIpictureDigest=1", "--FastRD=1",
                           "--device", device, "-b", work / f"{name}.bin",
                           "-o", work / f"{name}.yuv", *extra])
        wall = time.perf_counter() - t
        check("Unknown option" not in log, f"{name}: {log[:500]}")
        rep = json.loads([ln for ln in log.splitlines()
                          if ln.startswith(REPORT_PREFIX)][-1]
                         [len(REPORT_PREFIX):])
        return ([(work / f"{name}.{x}").read_bytes() for x in ("bin", "yuv")],
                wall, rep, log)

    # (a) checkpoint/resume, 96x80 low-delay P
    w, h, n = RESUME
    clip = work / f"resume_{w}x{h}_{n}f.yuv"
    make_clip(clip, w, h, n, "default")
    ldp = CFG / "encoder_lowdelay_P_main.cfg"
    ck = work / "resume_state.pkl"
    ck.unlink(missing_ok=True)
    for p in (work / "resume_joined.bin", work / "resume_joined.yuv"):
        p.unlink(missing_ok=True)
    full, full_wall, _, _ = encode("resume_full", "cuda", clip, w, h, ldp,
                                   ("-f", n))
    _, first_wall, _, _ = encode(
        "resume_joined", "cuda", clip, w, h, ldp,
        ("-f", 5, f"--CheckpointFile={ck}", "--CheckpointEvery=1"))
    joined, resume_wall, rep, _ = encode(
        "resume_joined", "cuda", clip, w, h, ldp, ("-f", n,
                                                   f"--ResumeFile={ck}"))
    cpu, cpu_wall, _, _ = encode("resume_cpu", "cpu", clip, w, h, ldp,
                                 ("-f", n))
    check(joined == full, "the resumed cuda encode differs from the "
          "uninterrupted one")
    check(cpu == full, "the cuda fast-RD encode differs from the cpu one")
    check(rep["decision_frames"] == n - 5,
          f"the resumed run decided {rep['decision_frames']} frames")
    got, log = checked_decode("cuda", joined[0])
    check(not isinstance(got, str) and [p[0] for p in got] == list(range(n))
          and all(d is True for _p, d, _l in got),
          f"the resumed stream's cuda decode: {got}: {log[-500:]}")
    out["resume"] = {"frames": n, "bytes": len(full[0]),
                     "identical": ["cuda uninterrupted", "cuda resumed",
                                   "cpu"],
                     "wall_s": {"cuda_full": full_wall,
                                "cuda_to_checkpoint": first_wall,
                                "cuda_resumed": resume_wall,
                                "cpu_full": cpu_wall}}
    print("resume_rc_resume " + json.dumps(out["resume"]))

    # (b) fast-RD under rate control: all-intra with the device apply,
    # then low-delay B, whose frame QPs the controller moves (all-intra
    # frames stay at the cfg's QP at this target)
    w, h, n, bps = RC
    clip = work / f"rc_{w}x{h}_{n}f.yuv"
    make_clip(clip, w, h, n, "default")
    out["rc"] = {}
    for name, cfg, frames, extra in (
            ("intra_device_apply", "encoder_intra_main.cfg", n,
             ("--device-apply",)),
            ("ldb", "encoder_lowdelay_tlayers.cfg", RC_LDB_FRAMES, ())):
        args = ("-f", frames, "--RateCtrl=1", f"--TargetBitrate={bps}",
                *extra)
        rc_cuda, rc_wall, rep, log = encode(f"rc_{name}_cuda", "cuda", clip,
                                            w, h, CFG / cfg, args)
        rc_cpu, rc_cpu_wall, _, _ = encode(f"rc_{name}_cpu", "cpu", clip, w,
                                           h, CFG / cfg, args)
        check(rc_cuda == rc_cpu, f"the rate-controlled {name} cuda encode "
              "differs from the cpu one")
        check(rep["decision_frames"] == frames,
              f"the rate-controlled {name} encode: {rep}")
        if extra:
            check(rep["device_apply_frames"] == frames
                  and rep["device_apply_fallback_frames"] == 0,
                  f"the rate-controlled {name} encode: {rep}")
        got, dlog = checked_decode("cuda", rc_cuda[0])
        check(not isinstance(got, str) and len(got) == frames
              and all(d is True for _p, d, _l in got)
              and b"".join(pl.astype("uint8").tobytes()
                           for _p, _d, pls in sorted(got, key=lambda g: g[0])
                           for pl in pls) == rc_cuda[1],
              f"the rate-controlled {name} stream's cuda decode: "
              f"{dlog[-500:]}")
        lines = frame_lines(log)
        qps = [q for _p, q, _b in lines]
        check(len(lines) == frames, f"rate control {name}: {lines}")
        if not extra:
            check(len(set(qps)) > 1, f"rate control {name}: the frame QPs "
                  f"{qps} never moved")
        # a bound on the rate (as tests/test_fast_apply.py), not evidence
        # that the controller steers: the moving QPs and the tests' replay
        # are
        rate = len(rc_cuda[0]) * 8 * 30 / frames
        check(rate < 2.5 * bps, f"rate control {name}: {rate:.0f} bit/s "
              f"against {bps}")
        row = {"frames": frames, "target_bps": bps, "bps": rate,
               "bytes": len(rc_cuda[0]),
               "poc_qp_bits": [list(x) for x in lines],
               "decision_wall_s": rep["decision_wall_s"],
               "wall_s": {"cuda": rc_wall, "cpu": rc_cpu_wall},
               "identical": ["cuda", "cpu"]}
        if extra:
            row.update({k: rep[k] for k in (
                "device_apply_waves", "device_apply_class_steps",
                "device_apply_wall_s")})
        out["rc"][name] = row
        print(f"resume_rc_rc_{name} " + json.dumps(row))

    # (c) fast-RD quality against the exact path on cuda
    t = time.perf_counter()
    rows = fastrd_quality.sweep(clip, w, h, QUALITY_FRAMES, QUALITY_QPS,
                                "cuda")
    out["quality"] = {"rows": rows, "wall_s": time.perf_counter() - t}
    for row in rows:
        print("resume_rc_quality " + fastrd_quality.format_row(row))
    out["launches"] = {"residual": residual_kernel.launches,
                       "satd": satd_kernel.launches}
    check(all(out["launches"].values()),
          f"the phase launched {out['launches']}")
    print("resume_rc " + json.dumps({"launches": out["launches"],
                                     "quality_wall_s":
                                     out["quality"]["wall_s"]}))
    return out


def make_clip(path: Path, width: int, height: int, frames: int,
              style: str = "default") -> None:
    """A seeded clip from ``tools/make_test_clip.py``, or (``fade``) a
    smooth picture that darkens and brightens frame by frame, so that the
    encoder's weighted-prediction analysis sends weights."""
    if style == "fade":
        import numpy as np
        rng = np.random.RandomState(7)
        planes = []
        for h, w, lo, hi in ((height, width, 0, 200),
                             (height // 2, width // 2, 80, 180),
                             (height // 2, width // 2, 80, 180)):
            out = rng.randint(lo, hi, (h, w)).astype(np.float32)
            for _ in range(2):
                p = np.pad(out, 2, mode="edge")
                out = sum(p[i:i + h, j:j + w]
                          for i in range(5) for j in range(5)) / 25
            planes.append(out)
        with open(path, "wb") as fh:
            for i in range(frames):
                g, off = 1.0 - 0.08 * i, 5 * i
                for k, plane in enumerate(planes):
                    fh.write(np.clip(plane * g + (off if k == 0 else off / 2),
                                     0, 255).astype(np.uint8).tobytes())
        return
    from thevc_tpu_torch import streams
    streams.make_clip(path, width, height, frames, style, SEED)


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
    devapply = fastrd_devapply_phase(torch, work, dec, fast)
    inter = inter_decode_phase(torch, work, made)
    small = small_inter_phase(torch, work, made)
    fast_inter = fastrd_inter_phase(torch, work, made)
    inter_identity_phase(work, made)
    wp_scaling_phase(torch, work, made)
    parts = partitioned_phase(torch, work, made)
    multi = multistream_phase(torch, work, made)
    robust = robust_decode_phase(torch, work)
    resume = resume_rc_phase(torch, work)
    check(not [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "thevc_tpu" or m.startswith("thevc_tpu.")],
          "jax or a module of the JAX package was imported")

    # K1's time: the intra decode's largest class (by bytes), the main
    # path's own data; beside it the 32x32 class with every group coded
    classes = dec["residual_classes"]
    top = max(classes["rows"], key=lambda r: r["bytes"])
    print("residual kernels line " + json.dumps({
        "decode_class": top, "all_coded_32x32": next(
            r for r in kern["rows"] if r["size"] == 32
            and r["bit_inc"] == 0 and r["density"] == 1.0)}))
    # K2's time: one 1080p frame's 35-mode sweep, the five bit_inc 0
    # classes summed
    frame = [r for r in k2["rows"] if r["bit_inc"] == 0]
    by_path = {
        "intra_decode": {"residual": dec["residual_kernel_launches"]},
        "fastrd_encode": {"residual": fast["residual_launches"],
                          "satd": fast["satd_launches"]},
        "fastrd_inter_encode": {"residual": fast_inter["residual_launches"],
                                "satd": fast_inter["satd_launches"]},
        "fastrd_devapply_encode": {"residual": devapply["residual_launches"],
                                   "satd": devapply["satd_launches"]},
        **{f"{k}_decode": {"residual": v["residual"]}
           for k, v in parts.items()},
        "graft_entry": {"residual": multi["entry"]["residual"]},
        "multistream_dryrun": multi["dryrun"]["launches"],
        **{f"{k}_decode": {"residual": v["residual"]}
           for k, v in multi["tools"].items()},
        "robust_decode": robust["launches_with_fuzz"],
        "resume_rc": resume["launches"],
        "inter_decode": inter["launches"],
        **{f"inter_decode_{k}": v for k, v in small.items()}}
    print("launches by path " + json.dumps(by_path))
    print(json.dumps({"kernels": [{
        "name": "residual", "route": "cuda",
        "source": "thevc_tpu_torch/csrc/residual.cu",
        "replaces": "thevc_tpu/ops/jx_pallas.py:141",
        "launches": sum(p.get("residual", 0) for p in by_path.values()),
        "max_abs_err": max(kern["max_abs_err"], classes["max_abs_err"],
                           fast_inter["pass"]["max_abs_err"]["residual"],
                           devapply["frame"]["k1_max_abs_err"]),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None}, {
        "name": "satd", "route": "cuda",
        "source": "thevc_tpu_torch/csrc/satd.cu",
        "replaces": "thevc_tpu/ops/jx_pallas.py:63",
        "launches": sum(p.get("satd", 0) for p in by_path.values()),
        "max_abs_err": max(k2["max_abs_err"],
                           fast_inter["pass"]["max_abs_err"]["satd"]),
        "ms": sum(r["ms"] for r in frame),
        "plain_ms": sum(r["plain_ms"] for r in frame),
        "bound_ms": sum(r["bound_ms"] for r in frame),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in frame)
        else "operations",
        "library_ms": None}]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
