#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``thevc_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the hand-written CUDA kernels (``thevc_tpu_torch/csrc/``:
   residual, SATD, MC, in-loop filters, the device apply's frame kernel,
   the intra decision pass's sweep and TU-RD kernels and its select,
   pick and DP kernels, the P/B pass's motion search), one nvcc for each
   source, all started together; prints each build log and, for the intra
   decision kernels, each template instance's registers, spills and
   shared memory (ptxas) and its SASS instruction count (``cuobjdump
   -sass``, where the toolkit has it: in all, the tensor-core, shuffle,
   shared-memory and float instructions, and the count over the samples
   or coefficients a thread takes in one pass of the code) as one
   ``intra_rd_build`` line; the same for the motion-search kernels
   (``csrc/inter_me.cu``) as one ``inter_me_build`` line, with each
   instance's three longest loops in SASS instructions, and for the
   select, pick and DP kernels (``csrc/intra_select.cu``) as one
   ``intra_select_build`` line, with each kernel's stack frame and its
   local-memory instructions.
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
   Every bound with an int32 term holds it to 33.5e12 op/s, half the
   float32 rate, and prints the float32-rate bound beside it as
   ``fp32_bound_ms``.
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
   encoder's and K1 and the filter kernel (K4) must have been launched by
   the decode (their counts are zeroed just before the run and read just
   after; every later ``cuda`` decode counts K4's launches the same way,
   and each must be above 0 but the filters-off tool stream's).  Then one
   more decode records the residual kernel's inputs, and on each of those
   classes, the decode's own data, the kernel is held against its plain
   version (tolerance 0) and both are timed, with its bound and shares as
   in 3.
6. Fast-RD encode phase: encodes the same clip with ``--FastRD=1`` at
   QP 32 through the port's encoder CLI (``thevc_tpu_torch.apps.encoder
   --device cuda``) in a child process, whose counts start at 0 and
   which reports the kernels' launches: the intra sweep and TU-RD
   kernels' (``csrc/intra_rd.cu``) must be above 0 and K1's and K2's 0
   (the decision passes run neither), and ``jax`` must not have been
   imported.  The stream must be the one the port wrote before the intra
   decision kernels (``PARENT_STREAMS``: bytes and SHA-256).  It is
   decoded by the port on ``cuda``: 8/8 digests OK and recon
   byte-identical to the encoder's.  Against the exact stream: at most
   1.15x its bytes and a luma PSNR against the clip at most 0.5 dB below
   it.
7. CPU against CUDA: a 416x240 2-frame clip encoded with ``--FastRD=1``
   at QP 27 and 37 with ``--device cuda`` and ``--device cpu`` gives
   byte-identical streams.
8. Inter decode phase: decodes the 1080p low-delay B stream through the
   port's CLI on ``cuda``, one warm-up and three timed runs checked as in
   5, where the residual kernel (K1) and the MC kernel
   (``csrc/mc.cu``, one launch a B picture) must have run and the plain
   MC (``ops.mc.mc_batch``) never.  Then one run with stage timing on (a
   device sync around each stage) for the stage walls per picture, and
   one that records every ``mc.mc_picture`` call (each B picture's job
   table and reference planes): on each picture the MC kernel is held
   against its plain version (tolerance 0) and timed (CUDA events around
   20 calls as the decode makes them, host table and upload included;
   its launch alone as a CUDA graph of 20 launches, which must hold 20
   kernel nodes; the plain version eager), beside its bound (the
   distinct reference samples its windows read, the job table and the
   prediction, over HBM's rate; its multiply-adds over the int32
   peak), with its host table's bytes, items and build time.  The
   416x240 low-delay P and random-access
   streams decode on ``cuda`` with every digest OK and recon
   byte-identical to their encoders', through the MC kernel and not the
   plain MC.
9. Filter phase (``kernel filters``): decodes the 1080p all-intra and
   low-delay B streams once more on ``cuda``, recording every call of the
   in-loop filter stage (``decoder.filters._filter_pictures``: the
   all-intra decode's one call of 8 pictures, the low-delay B decode's
   one call a picture, of which its 7 B pictures are taken).  On each
   call the filter kernel (``csrc/filters.cu``, K4: one launch a call,
   a CTA a 64x64 luma or 32x32 chroma tile whose window, with a 4-sample
   halo, stays in shared memory through both edge directions and SAO) is
   held against the plain form (``ops.filters.filter_pictures_plain`` on
   the card, tolerance 0, equal dtypes) and timed: eager (CUDA events
   around 20 calls, host launch included), as a CUDA graph of 20 calls
   (median of 5 replays; the graph must hold exactly 20 kernel nodes, one
   a call), the plain form eager, with its device activities of
   one call under ``torch.profiler`` (its kernels, copies and memsets);
   beside its bound (the planes read and
   written once, the 12 maps and the SAO tables over HBM's rate; the
   decisions of the active edges and the SAO'd samples at the int32
   rate, ``FILTER_OPS``).  Then the stage's split for both forms on the
   same pictures, each part synchronised (the median of 3 runs after a
   warm-up): ``inputs_ms`` (the host's edge maps and SAO tables),
   ``stack_ms`` (the host's batch arrays, written into one pinned
   buffer), ``h2d_ms`` (its one copy), ``device_ms``
   (the filter call), ``d2h_ms`` and ``astype_ms`` (the host planes a
   picture).  Last, both 1080p streams decode through the CLI on ``cuda``
   with the stage's filter call in each form, in turns (plain, kernel,
   kernel, plain), each checked as in 5: the walls and fps of each.
10. P/B fast-RD phase (``fastrd_inter``): encodes the 1080p motion clip
   with ``--FastRD=1 --device cuda`` and the low-delay B cfg at QP 32
   (SAO on, as the exact stream) in a child process whose report gives
   the launches of K2, the MC kernel, the intra decision kernels and
   the motion-search kernels (``csrc/inter_me.cu``; each above 0, one
   refinement and one merge model a size class for each coarse search),
   of K1 (none) and the plain MC's calls (none), the stream
   (``PARENT_STREAMS``, as in 6), the decision frames (8,
   7 of them B) and the decision wall; decodes it on ``cuda`` (8/8
   digests OK, recon byte-identical to the encoder's) and reports its
   bytes and luma PSNR beside the exact low-delay B stream's (no gate).
   Then, in this process, one B frame's decision pass replayed from
   the encoder's own call: the clip's first 4 frames are encoded in
   this process (same cfg, ``Encoder(cfg, device="cuda")``) with the
   arguments of the last ``fast_inter.decide_frame_p`` call recorded,
   and that call runs again on ``cuda``: a warm-up, three timed runs
   (synchronised wall, K2, MC, intra decision and motion-search kernel
   launches counted from 0, each above 0, 2 coarse searches, 8
   refinements and 8 merge models, no K1, no plain MC), one with stage
   timing on (stage walls), one under ``torch.profiler`` (device time,
   busy share), one with both (``stage_profile``: each
   ``fast_inter.*`` stage's wall, device time and device activities,
   an activity charged to the stage whose range launched it), the same
   on the plain route as in 16 (walls, stage walls, device time, the
   stage split; identical maps; the plain route also runs the
   motion-search stages' plain forms), and one that records every K2,
   MC, intra decision and motion-search kernel call of the pass (as
   many as the launches):
   each is held against its plain version on the pass's own data
   (tolerance 0, bits bit for bit), the given-prediction TU-RD calls
   timed as in 16, and the
   49-candidate SATD classes and quarter-pel MC calls (one a size class
   and list) are timed with their bytes, bound and share (``kernel
   satd`` and ``kernel mc_qpel`` rows, as in 4; each quarter-pel call is
   the MC kernel's quarter-pel entry, ``mc_qpel`` in ``csrc/mc.cu``, also
   held against and timed beside the generic ``mc_blocks`` entry on its
   49-job table, as a CUDA graph in the same run; its bound counts the
   distinct reference samples, the origins and the 49 predictions a
   block, and the 7 first passes over s + 8 rows and 49 second passes at
   each phase's nonzero taps, at the int32 rate; ``generic_fp32_bound_ms``
   is the generic entry's bound on that table at the float32 rate), and
   the generic MC calls (the winners' predictions: per size class and
   list the luma and the Cb/Cr pair of the transform estimate, then one
   bi luma and one bi Cb/Cr call with both lists averaged in the kernel;
   24 a B frame, checked, and no ``bi_avg_batch`` call) timed and summed
   (``kernel mc_blocks_generic``, the kernels line's ``mc_blocks``; each
   call's bound counts the distinct samples of every plane and list it
   reads, its jobs and its predictions written once).  Each
   motion-search kernel call (the coarse search of each list, the
   refinement and the merge model of each size class and list) is held
   against its plain form (integers tolerance 0, floats bit for bit) and
   timed: eager, a CUDA graph of 20, the plain form, beside its bound
   (``inter_me_bound``: the inputs read once, the outputs written once,
   the distinct reference samples the windows read; the differences
   (two instructions each: the absolute value is an operand modifier of
   the float add), filter taps and costs at the int32 rate), one ``kernel
   coarse_search`` / ``int_refine`` / ``merge_model`` line of each
   entry's calls summed, with its launches in the pass; then the same frame as 10 bits (samples << 2,
   QPs + 12): the kernel and plain routes' maps equal and each
   motion-search call held and timed the same way.  Then 416x240 low-delay
   P (3 frames) and random-access (5 frames) fast-RD streams of the small
   motion clip: ``--device cuda`` and ``--device cpu`` byte-identical, the
   ``cuda`` ones through the MC kernel and not the plain MC.  Last,
   the 64x64 weighted-prediction (``--wpP=1`` low-delay P, ``--wpB=1``
   low-delay B, a fading clip) and scaling-list (``--ScalingList=1``
   all-intra and low-delay B) streams decode on ``cuda`` with every
   digest OK and recon byte-identical to their encoders'.
11. Device-apply phase (``fastrd_devapply``), the fast-RD slice's main
   path: encodes the 1080p all-intra clip with ``--FastRD=1 --device
   cuda --device-apply`` at QP 32 (SAO, RDOQ on) in a child process whose
   report gives the kernels' launches (the apply kernel's, one a frame;
   the intra decision kernels', above 0; K1's and K2's, none), the
   stream (``PARENT_STREAMS``, as in 6), the device-apply frames (8, none
   left to the host apply), waves, class steps and wall; decodes it on
   ``cuda`` and on the CPU (8/8 digests OK, recon byte-identical to the
   encoder's); reports its wall beside the fast-RD phase's host-apply
   encode of the same clip and ``fastrd_devapply_bits_overhead_pct``
   (100 x (device-apply bytes / host-apply bytes - 1)) with the luma
   PSNR difference.  Then one frame's apply in this process, from the
   call an in-process 1-frame encode made (its stage walls printed),
   with the frame kernel (``csrc/apply.cu``: one persistent launch a
   frame, CTAs taking the frame's items by ticket, each item waiting
   only for the units under its reference range) and with the plain
   form (``fast_apply.run_device_apply_plain``, a CUDA graph a class
   step replayed per wave) on ``cuda``: for the kernel a warm-up and
   three synchronised runs (wall, host setup and issue time, the
   launch's span in CUDA events, one apply launch and no K1 each, the
   error word 0 and the items that waited), one under ``torch.profiler``
   (device time, the frame kernel's own time, one ``apply_frame`` kernel
   a frame); each class's body latency (a one-item list of the frame,
   the ready maps set, 50 launches in a CUDA graph, less the same of an
   empty list) and the frame's critical path modelled from the schedule
   at those latencies (a TU starts when the writers of the units under
   its range are done) beside the wave-barrier and class-step models;
   for the plain form one graph-replayed run and one under the profiler,
   the same figures; then the plain form on the CPU.  The kernel apply
   equals the plain form on ``cuda`` and the CPU's (recon and every
   level stack, tolerance 0); the frame's bound (each record once: its
   fields, reference lines, source windows, recon and levels over HBM's
   rate; the four transform passes' multiply-adds at the int32 rate).
   Last, the 416x240 identity encodes, all at once: RDOQ and the top-2
   re-rank off, ``cuda`` (frames in threads), ``cpu`` and the host apply
   byte-identical; RDOQ on, ``cuda`` == ``cpu`` at QP 27 and 37.  Then
   ``fastrd_devapply_nxn``: the device apply on a seeded 128x64 frame
   with NxN CUs (``streams.nxn_frame``), where every class of
   ``fast_apply.CLS`` must run through the kernel, the 4x4 luma class
   included (one launch for the frame, no K1), equal to the plain form
   on ``cuda`` (graph-replayed) and to the CPU.
12. A 128x64 tiles stream and WPP stream (32x32 CTUs; the encoder
   refuses both in one stream) decode on ``cuda`` with every digest OK
   and recon byte-identical to their encoders'.
13. Multi-stream phase (``multistream``, ``thevc_tpu_torch.graft_entry``):
   the graft entry's step (256 8x8 TUs through K1's dense entry) on
   ``cuda``, equal to ``tq.tu_recon_pipeline_plain`` (tolerance 0) with
   one K1 launch; the step, its plain version and K1 alone timed (CUDA
   events, 20 calls; K1 also as a CUDA graph); the 8-slot dry run
   (8 spawned processes, each slot's device work on ``cuda:0``, its
   collective gloo between the processes, since NCCL takes no two ranks
   on one card): each slot's 2-frame 48x48 fast-RD encode (the intra
   decision kernels launched, the decode K1 and K4) with the QPs
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
14. Robustness phase (``robust_decode``): the 176x144 streams of
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
   and the MC kernel must have run, the plain MC never on ``cuda``, and
   the concealed picture must
   reach the card once (``RefPlanes.get``, when POC 3 first refers to
   it) and stay while POC 4 does.  Then 24 seeded corrupted copies
   of the 9-frame random-access stream (bit flips and truncations,
   ``streams.fuzz_variants``) decode on ``cuda``, each followed by
   ``torch.cuda.synchronize()``: each decodes or raises a Python
   exception (a CUDA error fails the run), with the same outcome as on
   the CPU; then the clean stream decodes on ``cuda`` with every digest
   OK in the same process.  Prints the outcomes by exception type, the
   fuzz decodes' wall and the phase's K1 and MC kernel launches.
15. Resume and rate-control phase (``resume_rc``), in this process
   through the port's encoder CLI: a 96x80 9-frame low-delay P
   ``--FastRD=1`` encode on ``cuda``, uninterrupted, and checkpointed at
   frame 5 (``--CheckpointEvery=1``) then resumed: the streams and recons
   of the resumed and uninterrupted ``cuda`` runs and the ``cpu`` run are
   byte-identical, and the resumed stream decodes on ``cuda`` digest-OK;
   a 416x240 4-frame all-intra ``--FastRD=1 --RateCtrl=1
   --TargetBitrate=1000000 --device-apply`` encode on ``cuda`` and on the
   CPU, byte-identical, every frame decided and applied on the device
   (the apply kernel launched once a frame),
   digest-OK and recon-exact through the port's decoder on ``cuda``
   (per-frame QP and bits printed), and the same for a 3-frame low-delay
   B encode (``encoder_lowdelay_tlayers.cfg``, no device apply) whose
   frame QPs must move (the tests hold them against the JAX package's
   rate controller fed the same bits); one
   ``thevc_tpu_torch.tools.fastrd_quality`` sweep on ``cuda`` (2 frames
   of that clip, QP 22-37), its rows printed.  The phase's K1, K2, MC,
   filter, apply and intra decision kernel launches (``cuda`` runs only)
   must be above 0.
16. I pass phase (``fastrd_intra_pass``), last (run before the
   device-apply phase, it left that phase's profiler session without its
   apply kernel): the 1080p all-intra clip's first frame's decision pass
   (``fast_intra.decide_frame``, the arguments recorded from an
   in-process 1-frame encode) replayed in this process with the intra
   decision kernels and with the plain route (the entries' plain forms on
   the card: the 35-mode stacks with K2, the listed modes' predictions
   and ``_tq_rd`` with K1), in turns (plain, kernel, kernel, plain):
   synchronised walls, each route's launches counted from 0 (the kernel
   route 5 sweeps, one select over the 5 luma classes, 10 TU-RD
   launches, one pick and one DP launch, no K1, no K2), identical maps,
   and, in a child process of this script that runs nothing else (``--profile-i-pass``), three runs
   of each in one ``torch.profiler`` window, reported a run (device
   time, activities, the hand-written kernels among them, busy share;
   on the kernel route every one of the 18 launches a run in the window
   and no sort kernel, or the phase fails).  Every kernel call of the pass is held against its
   plain form
   (SATD and dist tolerance 0, bits bit for bit) and timed (``kernel
   intra_sweep`` and ``kernel tu_rd`` rows: eager, a CUDA graph of 20,
   the plain form, bytes, bound and shares; the bound counts each block's
   samples and reference line once, the transform and Hadamard products
   at the int8 tensor rate (two s8 products an int16 operand) and the
   rest at the int32 rate, the largest of the three, with the bound that
   counts every operation at the int32 rate beside it as
   ``int32_bound_ms``, ``sweep_bound`` and ``tu_rd_bound``; an
   ``intra_kernel_sums`` line sums each entry's calls; ``tools/
   intra_rd_ab.py`` times the same calls checkout against checkout), and
   the same frame as 10
   bits (samples << 2) gives identical maps on both routes with every
   kernel call equal to its plain form, timed the same way.  The select,
   pick and DP calls (``csrc/intra_select.cu``) are held bit for bit and
   timed the same way (``kernel intra_select``, ``intra_pick`` and
   ``intra_dp`` rows; their bound the bytes each call reads and writes
   once; the select's ``library_ms`` one ``torch.topk(cost, 3,
   largest=False)`` on the pass's [nb, 35] costs of every class in one
   tensor, which the port never calls: it does not promise the tie
   order).  The B frame's replay
   (phase 11) times its TU-RD given calls the same way and holds its
   select, pick and DP calls.
17. Prints the kernels' JSON line (per kernel: launches on the main
   paths, largest error against the plain version, eager time, plain
   time, bound and what bounds it; K1 at the intra decode's largest
   class, printed beside the 32x32 class with every group coded, K2
   summed over a frame's five classes, MC a picture of the low-delay B
   decode (the mean over its B pictures), its quarter-pel entry
   (``mc_qpel``, launches apart from the other MC entries) the replayed
   B frame's 8 calls summed, the filter kernel (K4) the all-intra
   decode's call of 8 pictures, with its graph time, the apply kernel
   the recorded 1080p frame's wave loop (eager, graph-replayed, and the
   plain form's graph-replayed loop beside it), the intra sweep and
   TU-RD kernels the replayed 1080p I frame's calls summed (5 and 10,
   with their graph times), its select, pick and DP kernels the same
   frame's calls (1, 1 and 1), the motion-search kernels the replayed B
   frame's calls summed (2, 8 and 8, with their graph times); no single
   PyTorch
   call computes any of them (the MC: per-PU-phase 8-tap interpolation
   with the int16 wrap; the filters: deblocking and SAO; the apply: HM's
   intra TU prediction, transform, RDOQ and recon; the intra decision
   kernels: HM's intra prediction modes, its transforms and quantiser;
   the motion search: a full search under an MV prior, a first-minimum
   refinement, HM's interpolation inside an SSE), so ``library_ms`` is
   null), then the card's name and
   power limit, then the device JSON line last.  Before them a
   ``phase_walls`` line gives each phase's wall in seconds (the build
   and its reports first, then the phases above, and the total).  Neither ``jax`` nor any
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
# cores (an FMA two).  INT32_OPS, the rate the integer work is held to, is
# the float pipe's instruction rate, 132 SMs x 128 lanes x 1.98 GHz: a
# valid lower bound for work that can run on the float pipe; the 64
# INT32 lanes an SM issue half of it.  The float32 rate gives the bounds
# counted before (``fp32_bound_ms``), so that the older shares stay
# comparable
HBM_BYTES_S = 3.35e12
INT8_TENSOR_OPS = 1.979e15
FP32_OPS = 67e12
INT32_OPS = 33.5e12
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


# the in-loop filter kernel's int32 operations, counted from
# csrc/filters.cu: an active luma edge segment's decision (the four
# second differences, the thresholds, the table lookups and both strong
# checks), a line of an active chroma edge, a sample of edge or band
# offset SAO
FILTER_OPS = {"luma_decision": 64, "chroma_line": 12, "sao_eo": 14,
              "sao_bo": 8}
# the parts of the filter stage that ``decoder.filters._filter_pictures``
# times apart (stage ``filters.<part>``)
FILTER_STAGES = ("inputs", "stack", "h2d", "device", "d2h", "astype")

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
# (bytes, SHA-256) of the 1080p fast-RD streams as the port wrote them
# before its intra decision kernels (commit af7c951, on an H100): the
# all-intra encode with the host apply and with the device apply, and
# the low-delay B encode; the kernels must not move a decision
PARENT_STREAMS = {
    "intra": (223851, "6389fce834befbf04b1281d68e3067902d1d86b2ec98bbf5075660"
                      "a24fa8b0ea"),
    "devapply": (236367, "ea37974b4938a47fbbaf9031e2d65dd7172b2359326cca57c0"
                         "9a0db14bb04075"),
    "ldb": (64064, "39ece725bcd853b609e61ec4ea0e93bfcc3c5b843bfd1c86aa7a5650b"
                   "880b5d4")}


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


def roofline(nbytes: int, ops: int, peak: float) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over HBM's rate and
    the operations over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return 1000 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def residual_bound(n: int, size: int, m_rows: int, packed: bool,
                   int32_peak: float = INT32_OPS) -> tuple:
    """(bytes, operations, bound_ms, bound_by) of one residual launch:
    the bytes it must move (the coded groups, their indices and the QPs
    in, or the dense coefficients; the int16 residual out) over HBM's
    rate, and its multiply-adds (two passes of ``size`` per coefficient,
    twice over for the hi/lo split on the int8 tensor cores; on the
    int32 CUDA cores for 4x4, at ``int32_peak``) over the peak rate of
    their type."""
    coeffs = n * size * size
    nbytes = (m_rows * (32 + 4) if packed else coeffs * 2) + n * 4 \
        + coeffs * 2
    if size >= 8:
        ops, peak = coeffs * 2 * size * 2 * 2, INT8_TENSOR_OPS
    else:
        ops, peak = coeffs * 2 * size * 2, int32_peak
    return (nbytes, ops, *roofline(nbytes, ops, peak))


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
                   fp32_bound_ms=residual_bound(n, size, coded, size >= 8,
                                               FP32_OPS)[2],
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
                  frames: int, counters: dict, absent=()) -> dict:
    """One warm-up decode on ``cuda``, then three timed ones, each checked
    (digests, recon, every counter of ``counters`` above 0: name ->
    module whose ``launches`` the run zeroes before and reads after; the
    ``launches`` of each module of ``absent`` stay 0)."""
    from thevc_tpu_torch.ops import device as dev_stats

    def decode():
        t = time.perf_counter()
        rc, log = decode_cuda(torch, stream, dec_rec)
        return rc, log, time.perf_counter() - t

    decode()                        # warm-up: first-touch costs
    walls = []
    for _ in range(3):
        for mod in (*counters.values(), *absent):
            mod.launches = 0
        dev_stats.stats_reset()
        rc, log, wall = decode()
        launches = {k: mod.launches for k, mod in counters.items()}
        stats = dev_stats.stats_reset()
        check_decode(rc, log, frames, dec_rec, enc_rec, stream.name)
        for k, n in launches.items():
            check(n > 0, f"the decode of {stream.name} made no {k} launch")
        for mod in absent:
            check(mod.launches == 0, f"the decode of {stream.name} ran "
                  f"{mod.__name__} {mod.launches} times")
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
    from thevc_tpu_torch.ops import filters_kernel, residual_kernel
    clip, stream, enc_rec = made["intra_main"][:3]
    res = timed_decodes(torch, stream, enc_rec,
                        work / "intra_main_dec_rec.yuv", FRAMES,
                        {"residual": residual_kernel,
                         "filters": filters_kernel})
    launches = res.pop("launches")
    out = dict(res, residual_kernel_launches=launches["residual"],
               filters_kernel_launches=launches["filters"])
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
                         bound_by=bound_by, fp32_bound_ms=residual_bound(
                             n, size, coded, fn is packed, FP32_OPS)[2],
                         share_of_bound=bound_ms / ms,
                         graph_share_of_bound=bound_ms / g_ms))
        print("decode_class residual " + json.dumps(rows[-1]))
    return {"max_abs_err": max_err, "rows": rows}


def inter_decode_phase(torch, work: Path, made: dict) -> dict:
    """The 1080p low-delay B decode on ``cuda``: timed runs (one MC kernel
    launch a P/B picture, no plain MC), the stage walls per picture, and
    the MC kernel against its plain version on every picture's job
    table."""
    from thevc_tpu_torch.ops import device as dev_stats
    from thevc_tpu_torch.ops import filters_kernel, mc, mc_kernel, \
        residual_kernel
    _clip, stream, enc_rec = made["inter_ldb"][:3]
    dec_rec = work / "inter_ldb_dec_rec.yuv"
    res = timed_decodes(torch, stream, enc_rec, dec_rec, FRAMES,
                        {"residual": residual_kernel, "mc": mc_kernel,
                         "filters": filters_kernel}, absent=(mc,))
    check(res["launches"]["mc"] == FRAMES - 1, f"{res['launches']['mc']} "
          f"MC kernel launches for {FRAMES - 1} B pictures")
    print("inter_decode " + json.dumps(res))

    dev_stats.stage_timing(True)
    try:
        t = time.perf_counter()
        rc, log = decode_cuda(torch, stream, dec_rec)
        staged_wall = time.perf_counter() - t
    finally:
        stages = dev_stats.stage_timing(False)
    check_decode(rc, log, FRAMES, dec_rec, enc_rec, "the staged decode")
    # ``filters`` is the whole filter stage, as before its parts were
    # timed apart: the sum of ``filters.*``
    stages["filters"] = sum(v for k, v in stages.items()
                            if k.startswith("filters."))
    print("inter_decode_stages " + json.dumps({
        "wall_s": staged_wall, "stage_ms_per_picture": {
            k: 1000 * v / FRAMES for k, v in sorted(stages.items())}}))
    res["mc_pictures"] = mc_picture_times(torch, stream)
    return res


def touched(torch, rows: int, cols: int, plane, y0, x0, h, w) -> int:
    """Distinct samples of planes [P, rows, cols] that windows (plane,
    top row y0, left column x0, h x w; integer tensors [N], h and w also
    integers) read at clamped coordinates: each window touches its
    clamped rectangle, marked through a 2-D difference array."""
    ya, xa = y0.clamp(0, rows - 1), x0.clamp(0, cols - 1)
    yb, xb = (y0 + h).clamp(1, rows), (x0 + w).clamp(1, cols)
    n_planes = int(plane.max()) + 1
    diff = torch.zeros((n_planes, rows + 1, cols + 1), dtype=torch.int32,
                       device=plane.device)
    flat = diff.view(-1)
    for y, x, v in ((ya, xa, 1), (ya, xb, -1), (yb, xa, -1), (yb, xb, 1)):
        flat.index_add_(0, (plane.long() * (rows + 1) + y) * (cols + 1) + x,
                        torch.full(y.shape, v, dtype=torch.int32,
                                   device=y.device))
    cover = diff.cumsum(1).cumsum(2)[:, :rows, :cols]
    return int((cover > 0).sum())


def mc_blocks_bound(torch, planes, jobs, case: str, luma: bool, bd: int,
                    bi: bool, out_h: int, out_w: int, *, pair: bool = False,
                    planes1=None, jobs1=None,
                    peak: float = INT32_OPS) -> tuple:
    """(bytes, operations, bound_ms, bound_by) of one ``mc_blocks`` call
    (its arguments): per list, the distinct reference samples its windows
    read on each plane a job predicts (two with ``pair``: p and p + P / 2)
    and its int32 jobs; the int16 predictions, written once (a bi call
    writes the average and reads no 14-bit halves); its multiply-adds on
    the CUDA cores (at ``peak``), each output of a pass at the nonzero
    taps of its job's phase (fx for the first or only horizontal pass, fy
    for the vertical; the identity row's one tap a shift), and a bi
    call's average (add, shift, clip: 3 operations an output)."""
    from thevc_tpu_torch.common.tables import from_reference
    from thevc_tpu_torch.ops import mc
    rows, cols = mc.window_shape(case, luma, out_h, out_w)
    filt = from_reference("cpu")
    nz = ((filt.luma_filter if luma else filt.chroma_filter) != 0).sum(1)
    lists = [(planes, jobs)] + ([(planes1, jobs1)] if jobs1 is not None
                                else [])
    n_out = 2 if pair else 1
    nbytes = ops = 0
    for p, jl in lists:
        j = jl.long()
        for q in range(n_out):
            nbytes += 2 * touched(torch, int(p.shape[1]), int(p.shape[2]),
                                  j[:, 0] + q * (int(p.shape[0]) // 2),
                                  j[:, 2], j[:, 1], rows, cols)
        nbytes += 4 * j.numel()
        tx, ty = (int(nz[j[:, k].cpu()].sum()) for k in (3, 4))
        macs = {"copy": 0, "hor": out_h * out_w * tx,
                "ver": out_h * out_w * ty,
                "2d": rows * out_w * tx + out_h * out_w * ty}[case]
        ops += 2 * n_out * macs
    n = int(jobs.shape[0])
    nbytes += 2 * n_out * n * out_h * out_w
    if jobs1 is not None:
        ops += 3 * n_out * n * out_h * out_w
    return (nbytes, ops, *roofline(nbytes, ops, peak))


def qpel_bound(torch, planes, origins, s: int) -> tuple:
    """(bytes, operations, bound_ms, bound_by) of one ``mc_qpel`` call:
    the distinct reference samples of the blocks' (s + 8)-square windows
    (integer offsets -1 and 0 plus the taps), the int32 origins and the
    int16 [nb, 49, s, s] predictions; the multiply-adds the 49 candidates
    need, on the int32 CUDA cores: the first pass of the 7 horizontal
    positions over s + 8 rows and the 49 second passes, each output at its
    phase's nonzero taps (45 over the 7 positions of a pass, the identity
    row's one tap a shift)."""
    from thevc_tpu_torch.common.tables import from_reference
    from thevc_tpu_torch.ops import mc
    filt = from_reference("cpu").luma_filter
    taps = sum(int((filt[fx] != 0).sum()) for _, _, _, fx in mc.QPEL_CAND[:7])
    o = origins.long()
    nb = int(o.shape[0])
    nbytes = 2 * touched(torch, int(planes.shape[1]), int(planes.shape[2]),
                         o[:, 0], o[:, 2] - 1, o[:, 1] - 1, s + 8, s + 8) \
        + 12 * nb + 2 * nb * 49 * s * s
    ops = 2 * nb * taps * ((s + 8) * s + 7 * s * s)
    return (nbytes, ops, *roofline(nbytes, ops, INT32_OPS))


def qpel_row(torch, planes, fields, s: int, nbx: int, pad: int,
             bd: int) -> dict:
    """One quarter-pel call of the P/B pass (``mc.mc_qpel_fields``): the
    field entry against its plain version, the origin-table entry on the
    same origins (``mc.qpel_origins``) and the generic ``mc_blocks``
    entry on the 49-job table (tolerance 0), then timed: the field entry
    eager (CUDA events around 20 calls) and as a CUDA graph of 20
    launches, the table entry and the generic entry as such graphs in the
    same run, and the plain version; beside the call's bound (the
    fields' int64 reads instead of the int32 origins) and the generic
    entry's bound on the 49-job table at the float32 rate
    (``generic_fp32_bound_ms``: 49 first passes)."""
    from thevc_tpu_torch.ops import mc
    origins = mc.qpel_origins(fields, s, nbx, pad).to(torch.int32)

    def qpel():
        return mc.mc_qpel_fields(planes, fields, s, nbx, pad, bd)

    def table():
        return mc.mc_qpel(planes, origins, s, bd)
    jobs = mc.qpel_jobs(origins).to(torch.int32)

    def blocks():
        return mc.mc_blocks(planes, jobs, "2d", True, bd, False, s, s)
    got = qpel()
    plain = mc.mc_qpel_fields_plain(planes, fields, s, nbx, pad, bd)
    torch.cuda.synchronize()
    err = int((got.to(torch.int32) - plain.to(torch.int32)).abs().max())
    check(torch.equal(got, plain), f"MC quarter-pel field entry != plain at "
          f"s = {s}, {origins.shape[0]} blocks (max abs err {err})")
    del plain
    check(torch.equal(table(), got), "the quarter-pel origin-table entry "
          f"!= the field entry at s = {s}")
    check(torch.equal(blocks().view(got.shape), got), "the generic MC entry "
          f"on the 49-job table != the quarter-pel kernel at s = {s}")
    del got
    ms = time_ms(torch, qpel, 20)
    g_ms = graph_ms(torch, qpel, 20)
    table_g_ms = graph_ms(torch, table, 20)
    blocks_g_ms = graph_ms(torch, blocks, 20)
    plain_ms = time_ms(torch, lambda: mc.mc_qpel_fields_plain(
        planes, fields, s, nbx, pad, bd), 3)
    nb = int(origins.shape[0])
    nbytes, ops, bound_ms, bound_by = qpel_bound(torch, planes, origins, s)
    nbytes += 12 * nb
    bound_ms, bound_by = roofline(nbytes, ops, INT32_OPS)
    generic = mc_blocks_bound(torch, planes, jobs, "2d", True, bd, False, s,
                              s, peak=FP32_OPS)
    return dict(size=s, blocks=nb, ms=ms, graph_ms=g_ms,
                table_graph_ms=table_g_ms, generic_graph_ms=blocks_g_ms,
                speedup_over_generic=blocks_g_ms / g_ms, plain_ms=plain_ms,
                bytes=nbytes, ops=ops, bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms,
                graph_share_of_bound=bound_ms / g_ms,
                gb_s=nbytes / g_ms / 1e6,
                generic_fp32_bound_ms=generic[2],
                max_abs_err=err)


def mc_fields_table(a: tuple, kw: dict) -> tuple:
    """The job-table call (``mc.mc_blocks``'s arguments) of a recorded
    ``mc.mc_blocks_fields`` call: each list's ``mc.field_jobs``."""
    from thevc_tpu_torch.ops import mc
    planes, fields, size, nbx, pad, luma, bd, bi = a
    tkw = {"pair": bool(kw.get("pair"))}
    if kw.get("fields1") is not None:
        tkw.update(planes1=kw["planes1"], jobs1=mc.field_jobs(
            kw["fields1"], size, nbx, pad, luma))
    return ((planes, mc.field_jobs(fields, size, nbx, pad, luma), "2d", luma,
             bd, bi, size, size), tkw)


def mc_fields_bound(torch, a: tuple, kw: dict,
                    peak: float = INT32_OPS) -> tuple:
    """``mc_blocks_bound`` of a field call: its job table's, with each
    list's fields (3 int32 a block) read in place of the jobs (5)."""
    ta, tkw = mc_fields_table(a, kw)
    nbytes, ops, _, _ = mc_blocks_bound(torch, *ta, **tkw, peak=peak)
    lists = 1 + (kw.get("fields1") is not None)
    nbytes -= 8 * lists * int(a[1][0].shape[0])
    return (nbytes, ops, *roofline(nbytes, ops, peak))


def held_mc_fields(torch, a: tuple, kw: dict) -> int:
    """A recorded ``mc.mc_blocks_fields`` call: the field entry against
    its plain version and against the job-table entry on the same jobs
    (tolerance 0) -> the largest error against the plain version."""
    from thevc_tpu_torch.ops import mc
    got = mc.mc_blocks_fields(*a, **kw)
    plain = mc.mc_blocks_fields_plain(*a, **kw)
    ta, tkw = mc_fields_table(a, kw)
    table = mc.mc_blocks(*ta, **tkw)
    torch.cuda.synchronize()
    err = int((got.to(torch.int32) - plain.to(torch.int32)).abs().max())
    check(torch.equal(got, plain), "MC field entry != plain on the B pass's "
          f"{tuple(got.shape)} call (max abs err {err})")
    check(torch.equal(got, table), "MC field entry != the job-table entry "
          f"on the B pass's {tuple(got.shape)} call")
    return err


def mc_bound(torch, jobs, planes, size: int, table_bytes: int,
             peak: float = INT32_OPS) -> tuple:
    """(bytes, operations, bound_ms, bound_by, window bytes) of one
    picture's MC: the distinct reference samples its windows read
    (``touched``), the job table, and the int16 prediction written; its
    multiply-adds (the first pass over the window rows of a 2-D case,
    then one pass a sample), each output at the nonzero taps of its
    phase (the identity row's one tap a shift), on the CUDA cores (at
    ``peak``).  The window bytes sum every window as the class-by-class
    MC read them."""
    import numpy as np
    from thevc_tpu_torch.common.tables import from_reference
    from thevc_tpu_torch.ops import mc
    filt = from_reference("cpu")
    nz = np.zeros((2, 8), np.int64)     # [luma, phase]: nonzero taps
    nz[0] = (filt.chroma_filter != 0).sum(1).numpy()
    nz[1, :4] = (filt.luma_filter != 0).sum(1).numpy()
    r = mc._list_rows(np.asarray(jobs, np.int64))
    j = np.asarray(jobs, np.int64)[r[:, 0]]
    h, w, luma, case = j[:, mc.J_H], j[:, mc.J_W], j[:, mc.J_LUMA], r[:, 7]
    tx, ty = nz[luma, r[:, 5]], nz[luma, r[:, 6]]
    taps = np.where(luma == 1, 8, 4)
    rows = h + (taps - 1) * np.isin(case, (2, 3))
    cols = w + (taps - 1) * np.isin(case, (1, 3))
    macs = int((rows * w * tx * (case == 3)
                + h * w * (tx * (case == 1) + ty * (case >= 2))).sum())
    samples = 0
    for k, p in enumerate(planes):
        sel = r[:, 2] == k
        if sel.any():
            t = [torch.from_numpy(v[sel]) for v in (r[:, 4], r[:, 3], rows,
                                                    cols)]
            samples += touched(torch, int(p.shape[0]), int(p.shape[1]),
                               torch.zeros_like(t[0]), *t)
    nbytes = 2 * samples + table_bytes + 2 * size
    ops = 2 * macs
    return (nbytes, ops, *roofline(nbytes, ops, peak),
            2 * int((rows * cols).sum()))


def mc_picture_times(torch, stream: Path) -> dict:
    """Decode ``stream`` on ``cuda`` recording every ``mc.mc_picture`` call
    (each P/B picture's job table and reference planes), then on each
    picture hold the MC kernel against its plain version (tolerance 0)
    and time on the card: the kernel as the decode calls it (CUDA events
    around 20 eager calls: the host's checks, table, upload and launch),
    its launch alone as a CUDA graph of 20 launches over the uploaded
    table (device time), and the plain version (eager), beside the
    picture's bound (``mc_bound``), with the host table's bytes, items
    (a warp's band of a job), runs and build time."""
    import numpy as np
    from thevc_tpu_torch.decoder.top import Decoder
    from thevc_tpu_torch.ops import mc, mc_kernel
    calls = []
    real = mc.mc_picture

    def record(jobs, planes, size, bd):
        calls.append((np.array(jobs), list(planes), size, bd))
        return real(jobs, planes, size, bd)
    mc.mc_picture = record
    try:
        pics = Decoder("cuda").decode_stream(stream.read_bytes())
    finally:
        mc.mc_picture = real
    check(all(p.digest_ok for p in pics), "the recording decode failed")
    check(len(calls) == FRAMES - 1, f"{len(calls)} MC pictures recorded")
    rows, max_err = [], 0
    for k, (jobs, planes, size, bd) in enumerate(calls):
        got = mc.mc_picture(jobs, planes, size, bd)
        want = mc.mc_picture_plain(jobs, planes, size, bd)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"MC kernel != plain on picture {k} "
              f"of the decode (max abs err {err})")
        t = time.perf_counter()
        table, *counts = mc_kernel.picture_table(jobs, planes, size, bd)
        table_host_ms = 1000 * (time.perf_counter() - t)
        n_runs, n_items = counts[2:]
        table_d = torch.from_numpy(table).to("cuda")
        pred = torch.zeros(size, dtype=torch.int16, device="cuda")

        def launch(table_d=table_d, n=counts, pred=pred, bd=bd):
            mc_kernel.launch_picture(table_d, *n, pred, bd)
        launch()
        check(torch.equal(pred, want), f"MC kernel launch != plain on "
              f"picture {k}")
        ms = time_ms(torch, lambda: mc.mc_picture(jobs, planes, size, bd),
                     20)
        g_ms = graph_ms(torch, launch, 20)
        plain_ms = time_ms(torch, lambda: mc.mc_picture_plain(
            jobs, planes, size, bd), 3)
        nbytes, ops, bound_ms, bound_by, win_bytes = mc_bound(
            torch, jobs, planes, size, table.nbytes)
        kinds = {kd: int((jobs[:, mc.J_KIND] == i).sum())
                 for i, kd in enumerate(mc.KINDS)}
        rows.append(dict(picture=k, jobs=len(jobs), items=n_items,
                         runs=n_runs, table_bytes=table.nbytes,
                         table_host_ms=table_host_ms, kinds=kinds,
                         ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                         bytes=nbytes, window_bytes=win_bytes, ops=ops,
                         bound_ms=bound_ms, bound_by=bound_by,
                         fp32_bound_ms=roofline(nbytes, ops, FP32_OPS)[0],
                         share_of_bound=bound_ms / ms,
                         graph_share_of_bound=bound_ms / g_ms))
        print("kernel mc_picture " + json.dumps(rows[-1]))
    n = len(rows)
    total = {key: sum(r[key] for r in rows) / n
             for key in ("ms", "graph_ms", "plain_ms", "bound_ms",
                         "fp32_bound_ms", "bytes")}
    total["bound_by"] = "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations"
    print("mc_picture_mean " + json.dumps(dict(total, pictures=n,
                                                max_abs_err=max_err)))
    del calls
    return {"max_abs_err": max_err, "rows": rows, "mean": total}


def recorded_filter_calls(torch, stream: Path) -> list:
    """Decode ``stream`` on ``cuda`` recording every call of the in-loop
    filter stage (``decoder.filters._filter_pictures``): its entries,
    deep-copied when the call is made (the DPB later compresses the frame
    models' motion in place)."""
    import copy
    from thevc_tpu_torch.decoder import filters as dec_filters
    from thevc_tpu_torch.decoder.top import Decoder
    calls = []
    real = dec_filters._filter_pictures

    def record(entries, device):
        calls.append(copy.deepcopy(entries))
        return real(entries, device)
    dec_filters._filter_pictures = record
    try:
        pics = Decoder("cuda").decode_stream(stream.read_bytes())
    finally:
        dec_filters._filter_pictures = real
    check(all(p.digest_ok for p in pics), "the recording decode failed")
    return calls


def filters_bound(torch, args, kw) -> tuple:
    """(bytes, operations, bound_ms, bound_by) of one filter call (the
    arguments of ``ops.filters.filter_pictures``): the planes read and
    written once, the 12 maps and the SAO tables read once; its int32
    operations on the CUDA cores, counted from the kernel's source for
    the work every input needs whatever the samples: each active luma
    edge segment's decision (FILTER_OPS["luma_decision"]), each line of an
    active chroma edge, each sample SAO'd by edge or band offset.  The
    luma lines' filters, which the sample-dependent decisions choose, are
    not counted, so the operations term is a lower bound."""
    y, cb, cr, dv, dh, types = args[:6]
    nbytes = sum(p.numel() * (p.element_size() + (1 if kw["out_u8"] else 2))
                 for p in (y, cb, cr))
    nbytes += sum(t.numel() * t.element_size() for t in (*dv, *dh, *args[5:]))
    _nb, h, w = y.shape
    hc, wc = h // 2, w // 2
    ops = 0
    if kw["do_deblock"]:
        def active(maps, rows, cols, chroma):
            fl, bs = maps[0][:, rows, cols], maps[1][:, rows, cols]
            return int(((fl & (bs > (1 if chroma else 0))) != 0).sum())
        edges = slice(2, 2 * (w // 8), 2), slice(2, 2 * (h // 8), 2)
        luma = active(dv, slice(0, h // 4), edges[0], False) \
            + active(dh, edges[1], slice(0, w // 4), False)
        chroma = active(dv, slice(0, h // 4),
                        slice(4, 4 * ((wc - 2) // 8) + 1, 4), True) \
            + active(dh, slice(4, 4 * ((hc - 2) // 8) + 1, 4),
                     slice(0, w // 4), True)
        # a chroma unit edge: 2 lines in each of 2 planes
        ops += FILTER_OPS["luma_decision"] * luma \
            + FILTER_OPS["chroma_line"] * 4 * chroma
    if kw["do_sao"]:
        ctu = kw["ctu_size"]
        for p, (ph, pw, cs) in enumerate(((h, w, ctu), (hc, wc, ctu // 2),
                                          (hc, wc, ctu // 2))):
            if p and not kw["do_sao_chroma"]:
                continue
            rows = (ph - cs * torch.arange(kw["ctus_h"])).clamp(0, cs)
            cols = (pw - cs * torch.arange(kw["ctus_w"])).clamp(0, cs)
            area = (rows[:, None] * cols[None]).reshape(-1).to(types.device)
            t = types[:, p].long()
            ops += FILTER_OPS["sao_eo"] * int(((t >= 0) & (t <= 3)).long()
                                              .mul(area).sum()) \
                + FILTER_OPS["sao_bo"] * int((t == 4).long().mul(area).sum())
    return (nbytes, ops, *roofline(nbytes, ops, INT32_OPS))


def device_activity(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (device activities
    only): its kernels, copies and memsets, and their device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"kernels": 0, "copies": 0, "memsets": 0, "device_ms": 0.0}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        kind = "copies" if name.startswith("Memcpy") else \
            "memsets" if name.startswith("Memset") else "kernels"
        out[kind] += 1
        us = e.duration_ns() / 1000 if hasattr(e, "duration_ns") \
            else e.duration_us()
        out["device_ms"] += us / 1000
    return out


def filter_split(torch, entries, plain: bool, reps: int = 3) -> dict:
    """The in-loop filter stage of ``entries`` (``_filter_pictures`` on
    ``cuda``) with stage timing on, each part synchronised: after a
    warm-up, the median over ``reps`` runs of each part's ms
    (``FILTER_STAGES``) and of their sum; ``plain``: the filter call is
    the plain form on the card."""
    from thevc_tpu_torch.decoder import filters as dec_filters
    from thevc_tpu_torch.ops import device as dev_stats
    from thevc_tpu_torch.ops import filters as ops_filters
    real = ops_filters.filter_pictures
    if plain:
        ops_filters.filter_pictures = ops_filters.filter_pictures_plain
    runs = []
    try:
        for k in range(reps + 1):
            dev_stats.stage_timing(True)
            try:
                dec_filters._filter_pictures(entries, torch.device("cuda"))
            finally:
                stages = dev_stats.stage_timing(False)
            if k:
                runs.append({s: 1000 * stages.get(f"filters.{s}", 0.0)
                             for s in FILTER_STAGES})
    finally:
        ops_filters.filter_pictures = real
    for r in runs:
        r["total"] = sum(r.values())
    return {f"{s}_ms": sorted(r[s] for r in runs)[reps // 2]
            for s in runs[0]}


def filter_call_row(torch, path: str, k: int, entries) -> dict:
    """One recorded filter call: the kernel against the plain form on
    the card (tolerance 0, equal dtypes); the kernel's time eager (CUDA
    events around 20 calls, host launch included) and as a CUDA graph of
    20 calls (which must hold exactly 20 kernel nodes); the plain
    form's time eager and its kernels a call (profiler); the bound; the
    stage split of both forms."""
    from thevc_tpu_torch.decoder import filters as dec_filters
    from thevc_tpu_torch.ops import filters as ops_filters
    from thevc_tpu_torch.ops import filters_kernel
    calls = []
    real = ops_filters.filter_pictures

    def capture_args(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)
    ops_filters.filter_pictures = capture_args
    try:
        dec_filters._filter_pictures(entries, torch.device("cuda"))
    finally:
        ops_filters.filter_pictures = real
    check(len(calls) == 1, f"{path} call {k}: {len(calls)} filter settings")
    args, kw = calls[0]

    def run():
        return ops_filters.filter_pictures(*args, **kw)

    def plain():
        return ops_filters.filter_pictures_plain(*args, **kw)
    before = filters_kernel.launches
    got = run()
    per_call = filters_kernel.launches - before
    want = plain()
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int32) - p.to(torch.int32)).abs().max())
              for g, p in zip(got, want))
    check(all(g.dtype == p.dtype for g, p in zip(got, want))
          and all(torch.equal(g, p) for g, p in zip(got, want)),
          f"filter kernel != plain on {path} call {k} (max abs err {err})")
    check(per_call == 1, f"{per_call} filter launches a call, not 1")
    del got, want
    ms = time_ms(torch, run, 20)
    graph, nodes = capture(torch, run, 20)
    check(nodes == 20, f"a graph of 20 filter calls holds {nodes} "
          "kernels, not 20")
    g_ms = time_ms(torch, graph.replay, 1, 5) / 20
    del graph
    plain_ms = time_ms(torch, plain, 3)
    # the profiler does not see the hand-written kernels (launched from
    # their own library); the graph's nodes count them above
    plain_act = device_activity(torch, plain)
    check(plain_act["kernels"] > 0, f"the profiler saw {plain_act}")
    nbytes, ops, bound_ms, bound_by = filters_bound(torch, args, kw)
    row = dict(path=path, call=k, pictures=len(entries),
               shape=list(args[0].shape), dtype=str(args[0].dtype),
               statics={key: kw[key] for key in sorted(kw)},
               launches_per_call=per_call, max_abs_err=err, ms=ms,
               graph_ms=g_ms, plain_ms=plain_ms,
               plain_kernels=plain_act["kernels"],
               plain_copies=plain_act["copies"],
               plain_memsets=plain_act["memsets"],
               plain_device_ms=plain_act["device_ms"], bytes=nbytes,
               ops=ops, bound_ms=bound_ms, bound_by=bound_by,
               share_of_bound=bound_ms / ms,
               graph_share_of_bound=bound_ms / g_ms,
               split_kernel=filter_split(torch, entries, False),
               split_plain=filter_split(torch, entries, True))
    print("kernel filters " + json.dumps(row))
    return row


def form_decodes(torch, work: Path, item: tuple) -> dict:
    """The stream of ``item`` (a ``prepare_streams`` entry) decoded through
    the port's CLI on ``cuda`` with the filter stage's call in each form,
    in turns (plain, kernel, kernel, plain; each checked as in
    ``check_decode``, the kernel form launching the kernel and the plain
    form never): each run's wall (host clock, synchronised) and fps."""
    from thevc_tpu_torch.ops import filters as ops_filters
    _clip, stream, enc_rec, _w, _h, frames = item
    dec_rec = work / f"{stream.stem}_forms_dec_rec.yuv"
    real = ops_filters.filter_pictures
    walls = {"plain": [], "kernel": []}
    for form in ("plain", "kernel", "kernel", "plain"):
        if form == "plain":
            ops_filters.filter_pictures = ops_filters.filter_pictures_plain
        try:
            t = time.perf_counter()
            rc, log, launched = decode_filtered(torch, stream, dec_rec)
            walls[form].append(time.perf_counter() - t)
        finally:
            ops_filters.filter_pictures = real
        check_decode(rc, log, frames, dec_rec, enc_rec, stream.name)
        check((launched > 0) == (form == "kernel"), f"{stream.name}: the "
              f"{form} form's decode made {launched} filter launches")
    out = {form: {"wall_s": w, "fps": [frames / x for x in w]}
           for form, w in walls.items()}
    print(f"filters_decodes {stream.stem} " + json.dumps(out))
    return out


def filters_phase(torch, work: Path, made: dict) -> dict:
    """The in-loop filter kernel (K4) on the recorded filter calls of the
    1080p all-intra decode (one call of its 8 pictures) and of the 1080p
    low-delay B decode's 7 B pictures (one call a picture): each held
    against the plain form, timed, bounded and split into its host and
    device parts for both forms (``filter_call_row``)."""
    t0 = time.perf_counter()
    intra = recorded_filter_calls(torch, made["intra_main"][1])
    check(len(intra) == 1 and len(intra[0]) == FRAMES,
          f"the intra decode made filter calls of {[len(c) for c in intra]}"
          " pictures")
    ldb = [c for c in recorded_filter_calls(torch, made["inter_ldb"][1])
           if c[0][1].slice_type != 2]                 # not I
    check(len(ldb) == FRAMES - 1 and all(len(c) == 1 for c in ldb),
          f"the LDB decode made {len(ldb)} B-picture filter calls")
    decodes = {name: form_decodes(torch, work, made[name])
               for name in ("intra_main", "inter_ldb")}
    rows = [filter_call_row(torch, "intra_decode", 0, intra[0])]
    rows += [filter_call_row(torch, "inter_decode", k, c)
             for k, c in enumerate(ldb)]
    b_rows = rows[1:]
    mean = {key: sum(r[key] for r in b_rows) / len(b_rows)
            for key in ("ms", "graph_ms", "plain_ms", "plain_kernels",
                        "bound_ms", "bytes")}
    for form in ("split_kernel", "split_plain"):
        mean[form] = {key: sum(r[form][key] for r in b_rows) / len(b_rows)
                      for key in b_rows[0][form]}
    out = {"max_abs_err": max(r["max_abs_err"] for r in rows),
           "intra": rows[0], "ldb_rows": b_rows, "ldb_mean": mean,
           "decodes": decodes, "wall_s": time.perf_counter() - t0}
    print("filters_ldb_mean " + json.dumps(dict(mean, pictures=len(b_rows))))
    print(f"filters_phase_wall_s {out['wall_s']}")
    return out


def small_inter_phase(torch, work: Path, made: dict) -> dict:
    """The 416x240 low-delay P and random-access streams on ``cuda``."""
    from thevc_tpu_torch.ops import filters_kernel, mc, mc_kernel, \
        residual_kernel
    out = {}
    for name in SMALL_INTER:
        _clip, stream, enc_rec, _w, _h, frames = made[name]
        dec_rec = work / f"{name}_dec_rec.yuv"
        residual_kernel.launches = mc_kernel.launches = mc.launches = 0
        filters_kernel.launches = 0
        rc, log = decode_cuda(torch, stream, dec_rec)
        out[name] = {"frames": frames, "residual": residual_kernel.launches,
                     "mc": mc_kernel.launches,
                     "filters": filters_kernel.launches}
        check_decode(rc, log, frames, dec_rec, enc_rec, stream.name)
        check(out[name]["residual"] > 0 and out[name]["mc"] > 0
              and out[name]["filters"] > 0 and mc.launches == 0,
              f"{name}: the decode skipped K1, the MC kernel or the filter "
              f"kernel, or ran the plain MC {mc.launches} times")
    print("small_inter " + json.dumps(out))
    return out


def satd_bound(n: int, size: int, m: int = SATD_MODES,
               peak: float = INT32_OPS) -> tuple:
    """(bytes, operations, bound_ms, bound_by) of one SATD sweep: org and
    the m candidates in (int16), the int32 sums out; per candidate sample
    a difference, the 4x4 (PU 4) or 8x8 Hadamard's butterflies and an
    absolute value and a sum, int32 on the CUDA cores (at ``peak``)."""
    samples = n * m * size * size
    nbytes = (n * size * size + samples) * 2 + n * m * 4
    ops = samples * (2 * (2 if size == 4 else 3) + 3)
    return (nbytes, ops, *roofline(nbytes, ops, peak))


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
                   fp32_bound_ms=satd_bound(n, size, SATD_MODES,
                                           FP32_OPS)[2],
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


def decode_filtered(torch, stream: Path, out: Path) -> tuple:
    """``decode_cuda`` with the filter kernel's launches counted from 0:
    (rc, log, launches)."""
    from thevc_tpu_torch.ops import filters_kernel
    filters_kernel.launches = 0
    rc, log = decode_cuda(torch, stream, out)
    return rc, log, filters_kernel.launches


def fastrd_phase(torch, work: Path, dec: dict) -> dict:
    """The 1080p fast-RD encode on ``cuda``, its decode, and the
    comparison with the exact-path stream of the decode phase."""
    clip, exact = Path(dec["clip"]), Path(dec["stream"])
    stream = work / "fastrd.bin"
    enc_rec = work / "fastrd_enc_rec.yuv"
    dec_rec = work / "fastrd_dec_rec.yuv"
    rep = port_encode(clip, stream, enc_rec, WIDTH, HEIGHT, FRAMES, QP,
                      "cuda")
    check(rep["intra_sweep_launches"] > 0 and rep["tu_rd_launches"] > 0,
          "the fast-RD encode launched no intra sweep or TU-RD kernel")
    check(rep["satd_launches"] == 0 and rep["residual_launches"] == 0,
          f"the all-intra fast-RD encode's decision passes launched K2 "
          f"{rep['satd_launches']} and K1 {rep['residual_launches']} times")
    check_parent_stream("intra", stream)
    selects = check_select_launches(rep, "the all-intra fast-RD encode")
    check(not rep["jax_imported"], "the port's encoder imported jax")
    check(rep["decision_frames"] == FRAMES,
          f"{rep['decision_frames']} decision passes for {FRAMES} frames")
    rc, log, filters_launches = decode_filtered(torch, stream, dec_rec)
    check(rc == 0, f"port decoder exited {rc} on the fast-RD stream:\n{log}")
    check(log.count("[MD5:(OK)]") == FRAMES and "ERROR" not in log,
          f"fast-RD digests not all OK:\n{log}")
    check(dec_rec.read_bytes() == enc_rec.read_bytes(),
          "decoded fast-RD recon differs from the encoder's recon")
    check(filters_launches > 0, "the fast-RD stream's decode launched no "
          "filter kernel")
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
               intra_sweep_launches=rep["intra_sweep_launches"],
               tu_rd_launches=rep["tu_rd_launches"], **selects,
               decode_filters_launches=filters_launches,
               fast_bytes=fast_bytes, exact_bytes=exact_bytes,
               psnr_y_fast=psnr_fast, psnr_y_exact=psnr_exact)
    print("fastrd " + json.dumps(out))
    return out


def check_select_launches(rep: dict, what: str) -> dict:
    """An encode's select, pick and DP launches (``csrc/intra_select.cu``):
    one select, one pick (each over every luma class) and one DP launch a
    decision pass.  Returns them."""
    got = {k: rep[f"{k}_launches"] for k in ("intra_select", "intra_pick",
                                            "intra_dp")}
    check(got["intra_select"] == got["intra_pick"] == got["intra_dp"]
          == rep["decision_frames"] > 0
          and rep["intra_sweep_launches"] > rep["decision_frames"],
          f"{what}: select/pick/DP launches {got} for "
          f"{rep['intra_sweep_launches']} sweeps and "
          f"{rep['decision_frames']} decision passes")
    return got


def roofline3(nbytes: int, tensor_ops: int, int_ops: int) -> tuple:
    """(bound_ms, bound_by): the largest of the bytes over HBM's rate, the
    tensor-core products over the int8 rate and the other operations over
    the int32 rate."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(tensor_ops / INT8_TENSOR_OPS, int_ops / INT32_OPS)
    return 1000 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def sweep_bound(nb: int, size: int) -> dict:
    """The least time of one intra sweep launch, counted from the work
    whatever implements it: each block's samples and its 4s + 1 reference
    samples read once (int16), the SATDs and the best mode written
    (int32); per predicted sample the Hadamard's two passes of 8 (4)
    multiply-adds, an int16 operand each (two s8 products), at the int8
    tensor rate, and the lerp (two multiplies, three adds, a shift), the
    difference and the absolute sum at the int32 rate.  ``int32_bound_ms``
    counts every operation at the int32 rate (the Hadamard as
    butterflies), the count of the kernel's scalar first design, so that
    shares compare with its."""
    samples = nb * SATD_MODES * size * size
    nbytes = nb * (size * size + 4 * size + 1) * 2 + nb * (SATD_MODES + 1) * 4
    tile = 8 if size % 8 == 0 else 4
    tensor = samples * 2 * tile * 2 * 2
    rest = samples * (6 + 1 + 2)
    bound_ms, bound_by = roofline3(nbytes, tensor, rest)
    int32_ops = samples * (6 + 2 * (2 if size == 4 else 3) + 3)
    return dict(bytes=nbytes, tensor_ops=tensor, int_ops=rest,
                bound_ms=bound_ms, bound_by=bound_by,
                int32_bound_ms=roofline(nbytes, int32_ops, INT32_OPS)[0])


def tu_rd_bound(n: int, size: int, intra: bool, blocks: int = 0,
                planes: int = 1, k: int = 1) -> dict:
    """The least time of one TU-RD launch of ``n`` items of block size
    |size| (TU size 32 for 64, 16 for -32), counted from the work: the
    given form reads each item's org and pred (int16), the intra form
    each block's samples and 4s + 1 reference samples on each plane once
    and its k mode ids; both read a QP and write dist and bits an item.
    Per sample the four transform passes' t multiply-adds, an int16
    operand each (two s8 products), at the int8 tensor rate; the
    quantiser, dequantiser, recon and SSE (13) and for the intra form the
    prediction's lerp (6) at the int32 rate.  ``int32_bound_ms`` counts
    the passes as int32 operations too (the kernel's scalar first
    design)."""
    s = abs(size)
    t = 32 if size == 64 else 16 if size == -32 else size
    if intra:
        nbytes = planes * blocks * (s * s + 4 * s + 1) * 2 + blocks * k * 4
    else:
        nbytes = n * s * s * 2 * 2
    nbytes += n * (4 + 8)
    samples = n * s * s
    tensor = samples * 4 * t * 2 * 2
    rest = samples * (13 + (6 if intra else 0))
    bound_ms, bound_by = roofline3(nbytes, tensor, rest)
    int32_ops = samples * (8 * t + 13 + (6 if intra else 0))
    return dict(bytes=nbytes, tensor_ops=tensor, int_ops=rest,
                bound_ms=bound_ms, bound_by=bound_by,
                int32_bound_ms=roofline(nbytes, int32_ops, INT32_OPS)[0])


def intra_counts() -> dict:
    """The launches of the kernels an intra decision pass can reach."""
    from thevc_tpu_torch.ops import intra_rd_kernel, intra_select_kernel, \
        residual_kernel, satd_kernel
    return {"intra_sweep": intra_rd_kernel.sweep_launches,
            "tu_rd_intra": intra_rd_kernel.tu_rd_intra_launches,
            "tu_rd_given": intra_rd_kernel.tu_rd_given_launches,
            "intra_select": intra_select_kernel.select_launches,
            "intra_pick": intra_select_kernel.pick_launches,
            "intra_dp": intra_select_kernel.dp_launches,
            "satd": satd_kernel.launches,
            "residual": residual_kernel.launches}


def zero_intra_counts() -> None:
    from thevc_tpu_torch.ops import intra_rd_kernel, intra_select_kernel, \
        residual_kernel, satd_kernel
    intra_rd_kernel.sweep_launches = 0
    intra_rd_kernel.tu_rd_intra_launches = 0
    intra_rd_kernel.tu_rd_given_launches = 0
    intra_select_kernel.select_launches = 0
    intra_select_kernel.pick_launches = 0
    intra_select_kernel.dp_launches = 0
    satd_kernel.launches = residual_kernel.launches = 0


@contextlib.contextmanager
def plain_route():
    """The decision passes with the intra entries' plain forms on the
    card: the 35-mode stacks and K2 for the sweep, the listed modes'
    predictions and ``_tq_rd`` with K1 for the transform-RD estimates.
    That is the route before the intra decision kernels, but for the
    size pass's top-3 and the chroma pass's 5 candidates, which it
    gathered from 35-mode stacks; the select, pick and DP run the torch
    glue they replaced (``intra_select_pass_plain``,
    ``intra_pick_pass_plain``, ``intra_dp_plain``).  The P/B pass's
    motion-search stages and picks run their plain forms too
    (``coarse_fields_plain``, ``int_refine_plain``, ``merge_model_plain``,
    ``qpel_pick_plain``, ``bi_pick_plain``: the route before
    ``csrc/inter_me.cu``)."""
    from thevc_tpu_torch.encoder import fast_inter, fast_intra
    names = ("intra_sweep", "tu_rd_modes", "tu_rd", "intra_select",
             "intra_pick", "_dp_expand")
    saved = {n: getattr(fast_intra, n) for n in names}
    fast_intra.intra_sweep = fast_intra.intra_sweep_plain
    fast_intra.tu_rd_modes = fast_intra.tu_rd_modes_plain
    fast_intra.tu_rd = fast_intra._tq_rd
    fast_intra.intra_select = fast_intra.intra_select_pass_plain
    fast_intra.intra_pick = fast_intra.intra_pick_pass_plain
    fast_intra._dp_expand = fast_intra.intra_dp_plain
    inter_names = ("_coarse_fields", "int_refine", "merge_model",
                   "qpel_pick", "bi_pick")
    inter_saved = {n: getattr(fast_inter, n) for n in inter_names}
    fast_inter._coarse_fields = fast_inter.coarse_fields_plain
    fast_inter.int_refine = fast_inter.int_refine_plain
    fast_inter.merge_model = fast_inter.merge_model_plain
    fast_inter.qpel_pick = fast_inter.qpel_pick_plain
    fast_inter.bi_pick = fast_inter.bi_pick_plain
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(fast_intra, n, f)
        for n, f in inter_saved.items():
            setattr(fast_inter, n, f)


@contextlib.contextmanager
def recorded_intra_kernel_calls(calls: dict):
    """Record every launch of the intra decision kernels' six entries
    (their arguments) into ``calls``: the sweep and the TU-RD entries
    (``ops.intra_rd_kernel``), the select, pick and DP
    (``ops.intra_select_kernel``)."""
    from thevc_tpu_torch.ops import intra_rd_kernel, intra_select_kernel
    entries = {"sweep": (intra_rd_kernel, "sweep"),
               "tu_rd_intra": (intra_rd_kernel, "tu_rd_intra"),
               "tu_rd_given": (intra_rd_kernel, "tu_rd_given"),
               "select": (intra_select_kernel, "select"),
               "pick": (intra_select_kernel, "pick"),
               "dp": (intra_select_kernel, "dp")}
    saved = {k: getattr(m, n) for k, (m, n) in entries.items()}

    def spy(name):
        def call(*a):
            calls.setdefault(name, []).append(a)
            return saved[name](*a)
        return call
    for k, (m, n) in entries.items():
        setattr(m, n, spy(k))
    try:
        yield
    finally:
        for k, (m, n) in entries.items():
            setattr(m, n, saved[k])


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def select_bound(name: str, a, out) -> dict:
    """The least time of one select, pick or DP launch, counted from the
    work: the bytes the kernel must read, each once, and its outputs
    written once (at HBM's rate), against its float operations at the
    fp32 rate.  The select reads every class's SATD rows and SATD-best
    modes and its 4 scalars and writes the top 3 and their bits (a
    product and a sum a block and mode); the pick reads every class's
    top 3, their bits, the TU-RD dist and bits, and lambda, and writes
    its five fields and the chroma ids (a sum, a product and a sum a
    candidate).  The DP reads
    each luma block's five fields, each chroma class's candidates' dist
    and bits and one id a block (the chosen one), the inter leaves and 5
    scalars (the distinct ones), and writes the maps; per luma block its
    leaf (4) and split (5), per chroma candidate 4, per inter leaf 3.
    Bytes bound them all."""
    if name == "select":
        classes, bits3, sqrt_lam = a[0], a[2], a[3]
        nbytes = _nbytes(*(t for v in classes.values() for t in v[:2]),
                         *bits3, sqrt_lam,
                         *(t for v in out.values() for t in v))
        ops = sum(int(v[0].numel()) for v in classes.values()) * 2
    elif name == "pick":
        classes, lam = a[0], a[2]
        nbytes = _nbytes(*(t for v in classes.values() for t in v[:4]), lam,
                         *(t for v in out.values() for t in v))
        ops = sum(int(v[0].numel()) for v in classes.values()) * 3
    else:
        res, cres, cres8, lam, (bits2, clam, cw) = a[0], a[1], a[2], a[5], \
            a[6]
        inter = a[12]
        chroma = [*cres.values(), cres8]
        leaves = [] if inter is None else list(inter.values())
        scalars = {t.data_ptr(): t for t in (lam, *bits2, clam, cw)}
        nbytes = (_nbytes(*(t for v in res.values() for t in v[:5]))
                  + sum(_nbytes(c.dist, c.bits) + c.ids.numel() // 5 * 4
                        for c in chroma)
                  + _nbytes(*(t for v in leaves for t in v))
                  + _nbytes(*scalars.values(), out))
        ops = (sum(int(v[1].numel()) for v in res.values()) * (4 + 5)
               + sum(int(c.dist.numel()) // 2 for c in chroma) * 4
               + sum(int(v[0].numel()) for v in leaves) * 3)
    bound_ms, bound_by = roofline(nbytes, ops, FP32_OPS)
    return dict(bytes=nbytes, ops=ops, bound_ms=bound_ms, bound_by=bound_by)


def _held_diff(torch, got, want) -> tuple:
    """(largest absolute difference, equal: ints equal and floats equal
    as bits) of two results, tensors or tuples or dicts of them."""
    if isinstance(got, dict):
        if sorted(got) != sorted(want):
            return math.inf, False
        return _held_diff(torch, [got[k] for k in sorted(got)],
                          [want[k] for k in sorted(got)])
    if not isinstance(got, torch.Tensor):
        pairs = [_held_diff(torch, g, w) for g, w in zip(got, want)]
        return max(p[0] for p in pairs), all(p[1] for p in pairs) \
            and len(got) == len(want)
    if got.dtype != want.dtype or got.shape != want.shape:
        return math.inf, False
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    if got.dtype == torch.float32:
        return err, torch.equal(got.view(torch.int32),
                                want.view(torch.int32))
    return err, torch.equal(got, want)


def held_intra_calls(torch, calls: dict, timed: tuple, tag: str) -> tuple:
    """Each recorded intra decision kernel call against its plain form on
    the card (every output: ints tolerance 0, floats bit for bit); the
    calls of the entries named in ``timed`` are timed beside their bound
    and printed as ``kernel`` rows: 20 eager calls, a CUDA graph of 20
    and the plain form (and for the select ``library_ms``: one
    ``torch.topk(cost, 3, largest=False)`` on the same costs, every
    class's in one tensor).  Returns (largest error, rows by entry)."""
    from thevc_tpu_torch.encoder import fast_intra
    from thevc_tpu_torch.ops import intra_rd_kernel, intra_select_kernel
    max_err = 0
    rows = {k: [] for k in ("sweep", "tu_rd_intra", "tu_rd_given", "select",
                            "pick", "dp")}
    row_names = {"sweep": "intra_sweep", "tu_rd_intra": "tu_rd",
                 "tu_rd_given": "tu_rd", "select": "intra_select",
                 "pick": "intra_pick", "dp": "intra_dp"}
    select_plain = {"select": fast_intra.intra_select_pass_plain,
                    "pick": fast_intra.intra_pick_pass_plain,
                    "dp": fast_intra.intra_dp_plain}

    def plain_of(name, a):
        if name in select_plain:
            return lambda: select_plain[name](*a)
        if name == "sweep":
            plane, size, nby, nbx, bit_inc, max_val = a
            return lambda: fast_intra.intra_sweep_plain(
                plane, size, nby, nbx, bit_inc, max_val)
        if name == "tu_rd_intra":
            (planes, modes, qp, _b, _lb, size, nby, nbx, luma, bit_inc,
             max_val) = a
            per = int(modes.shape[0]) * int(modes.shape[1])
            qps = tuple(qp[i * per] for i in range(len(planes)))
            return lambda: fast_intra.tu_rd_modes_plain(
                planes, size, nby, nbx, modes, qps, bit_inc, max_val, luma)
        org, pred, qp, _b, _lb, size, is_intra, bit_inc, max_val = a
        return lambda: fast_intra._tq_rd(org, pred, size, qp, bit_inc,
                                         max_val, is_intra)

    for name, entry_calls in calls.items():
        kernel = getattr(intra_select_kernel if name in select_plain
                         else intra_rd_kernel, name)
        for a in entry_calls:
            plain = plain_of(name, a)
            got, want = kernel(*a), plain()
            torch.cuda.synchronize()
            err, same = _held_diff(torch, got, want)
            max_err = max(max_err, err)
            check(same, f"{tag}: intra kernel {name} != plain form "
                  f"(max abs err {err})")
            if name not in timed:
                continue
            library_ms = None
            if name == "sweep":
                plane, size, nby, nbx = a[:4]
                shape = dict(size=size, blocks=nby * nbx, bit_inc=a[4])
                bound = sweep_bound(nby * nbx, size)
            elif name == "tu_rd_intra":
                planes, modes = a[:2]
                size, nby, nbx, luma = a[5:9]
                n = len(planes) * int(modes.numel())
                shape = dict(size=size, items=n, planes=len(planes),
                             luma=bool(luma), bit_inc=a[9])
                bound = tu_rd_bound(n, size, True, nby * nbx, len(planes),
                                    int(modes.shape[1]))
            elif name == "tu_rd_given":
                size = a[5]
                n = int(a[0].shape[0])
                shape = dict(size=size, items=n, is_intra=bool(a[6]),
                             bit_inc=a[7])
                bound = tu_rd_bound(n, size, False)
            else:
                bound = select_bound(name, a, got)
                if name == "dp":
                    shape = dict(ctu=a[9], frame=[a[3], a[4]],
                                 inter=0 if a[12] is None
                                 else len(next(iter(a[12].values()))),
                                 maps=list(got.shape))
                else:
                    shape = dict(sizes=sorted(a[0]), blocks=sum(
                        int(v[0].shape[0]) for v in a[0].values()))
                if name == "select":
                    classes, ctu, bits3, sqrt_lam = a
                    cost = torch.cat([fast_intra._mode_cost(
                        satd, best, s, nby, nbx, ctu, bits3, sqrt_lam)[0]
                        for s, (satd, best, nby, nbx) in classes.items()])
                    library_ms = time_ms(torch, lambda: torch.topk(
                        cost, 3, dim=1, largest=False), 20)
            ms = time_ms(torch, lambda: kernel(*a), 20)
            g_ms = graph_ms(torch, lambda: kernel(*a), 20)
            plain_ms = time_ms(torch, plain, 3)
            row = dict(entry=name, **shape, ms=ms, graph_ms=g_ms,
                       plain_ms=plain_ms, library_ms=library_ms, **bound,
                       max_abs_err=err)
            row["share_of_bound"] = bound["bound_ms"] / row["ms"]
            row["graph_share_of_bound"] = bound["bound_ms"] / row["graph_ms"]
            if "int32_bound_ms" in bound:
                row["graph_share_of_int32_bound"] = \
                    bound["int32_bound_ms"] / row["graph_ms"]
            rows[name].append(row)
            print(f"kernel {row_names[name]} {tag} " + json.dumps(row))
    summary = {k: sum_rows(v) for k, v in rows.items() if v}
    if summary:
        print(f"intra_kernel_sums {tag} " + json.dumps(summary))
    return max_err, rows


def recorded_i_call(clip: Path, work: Path) -> tuple:
    """The positional arguments of the clip's first frame's
    ``fast_intra.decide_frame`` call in an in-process fast-RD encode of
    that frame on ``cuda`` (all-intra cfg, QP 32, SAO, the host apply, as
    the CLI encode), copied so that they outlive the encode."""
    import numpy as np
    from thevc_tpu_torch.encoder import fast_intra
    from thevc_tpu_torch.encoder.top import DecisionStats, Encoder
    from thevc_tpu_torch.utils.cfg import parse_args
    calls = []
    real = fast_intra.decide_frame

    def spy(*args, **kwargs):
        calls.append(tuple(a.copy() if isinstance(a, np.ndarray) else a
                           for a in args))
        return real(*args, **kwargs)
    cfg = parse_args(["-c", str(CFG / "encoder_intra_main.cfg"), "-i",
                      str(clip), "-b", str(work / "intra_pass.bin"),
                      "-wdt", str(WIDTH), "-hgt", str(HEIGHT), "-f", "1",
                      "-fr", "30", f"--QP={QP}", "--SAO=1", "--FastRD=1",
                      "--SEIpictureDigest=1"])
    fast_intra.decide_frame = spy
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            Encoder(cfg, device="cuda", stats=DecisionStats()).encode(
                cfg.bitstream_file)
    finally:
        fast_intra.decide_frame = real
    check(len(calls) == 1, f"{len(calls)} I decision passes for one frame")
    return calls[0]


# the hand-written kernels of the I pass, by the names of their templates
I_PASS_KERNELS = ("sweep_kernel", "tu_rd_kernel", "select_kernel",
                  "pick_kernel", "dp_kernel")


def profile_i_pass(args_path: str) -> dict:
    """The profile of the recorded I pass (its arguments pickled at
    ``args_path``), run in a process of its own: both routes warmed up,
    then three runs of each in one ``torch.profiler`` window, reported a
    run (device time and activities, the hand-written kernels among them
    and the launches their wrappers counted, busy share, sort kernels,
    the largest items).  In this script's own process, after its other
    phases and their profiler sessions, such a window came back without
    up to a sixth of its activities; a process that runs nothing else
    has held every launch in every window tried (``tools/
    profile_window.py``)."""
    import pickle
    import torch
    from torch.profiler import ProfilerActivity, profile
    from thevc_tpu_torch.encoder import fast_intra
    args = pickle.loads(Path(args_path).read_bytes())

    def run():
        return fast_intra.decide_frame(*args, device="cuda")

    def in_route(route):
        return plain_route() if route == "plain" else contextlib.nullcontext()
    for route in ("kernel", "plain"):            # warm-ups
        with in_route(route):
            run()
    out, runs = {}, 3
    for route in ("kernel", "plain"):
        with in_route(route):
            torch.cuda.synchronize()
            zero_intra_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                for _ in range(runs):
                    run()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) / runs
            counts = intra_counts()
        device_us, n_kernels, top = profiled_device(prof)
        device_us /= runs
        out[route] = dict(
            runs=runs, profiled_wall_ms=1000 * wall,
            device_ms=device_us / 1000, device_kernels=n_kernels / runs,
            hand_written_kernels=profiled_count(prof, *I_PASS_KERNELS)
            / runs,
            hand_written_launches=sum(counts[k] for k in (
                "intra_sweep", "tu_rd_intra", "tu_rd_given", "intra_select",
                "intra_pick", "intra_dp")) / runs,
            device_busy_share=device_us / 1e6 / wall,
            sort_kernels=profiled_count(prof, "Sort", "sort"),
            top_kernels_ms={k: v / runs for k, v in top.items()})
    return out


def profiled_i_pass(args: tuple, work: Path, launches: int) -> dict:
    """``profile_i_pass`` of the recorded I pass in a child process of
    this script; fails unless the kernel route's window holds each of
    its ``launches`` hand-written kernel launches a run, and no sort."""
    import pickle
    path = work / "i_pass_args.pkl"
    path.write_bytes(pickle.dumps(args))
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--profile-i-pass", str(path)], capture_output=True,
                       text=True, timeout=600)
    check(r.returncode == 0, f"the I pass's profile exited {r.returncode}:"
          f"\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    k = out["kernel"]
    check(k["hand_written_launches"] == launches
          and k["hand_written_kernels"] == launches,
          f"the I pass's profile holds {k['hand_written_kernels']} "
          f"hand-written kernels a run of {k['hand_written_launches']} "
          f"launched, expected {launches}: an incomplete window")
    check(k["sort_kernels"] == 0,
          f"the kernel route's I pass ran {k['sort_kernels']} sort kernels")
    return out


def intra_pass_phase(torch, clip: Path, work: Path) -> dict:
    """One 1080p I frame's decision pass (``fast_intra.decide_frame``)
    replayed in this process from the encoder's own call, with the intra
    decision kernels and with the plain route (``plain_route``), in turns
    (plain, kernel, kernel, plain): synchronised walls, the launches of
    each route counted from 0, identical maps; three runs of each under
    ``torch.profiler`` in a child process (``profiled_i_pass``: device
    time, kernel count, busy share, every hand-written launch in the
    window).  Then
    every kernel call of the pass held against its plain form and timed
    (``kernel intra_sweep`` and ``kernel tu_rd`` rows), and the same
    frame as 10 bits (samples << 2, QPs + 12): maps of both routes
    identical, every kernel call equal to its plain form."""
    import numpy as np
    from thevc_tpu_torch.encoder import fast_intra
    args = recorded_i_call(clip, work)
    ctu = args[14]
    classes = sum(1 for s in fast_intra.SIZES if s <= ctu)
    chroma_classes = sum(1 for s in fast_intra.SIZES if 8 <= s <= ctu) + 1

    def run(a=args):
        return fast_intra.decide_frame(*a, device="cuda")

    def in_route(route):
        return plain_route() if route == "plain" else contextlib.nullcontext()
    for route in ("kernel", "plain"):            # warm-ups
        with in_route(route):
            run()
    walls = {"kernel": [], "plain": []}
    launches, maps = {}, {}
    for route in ("plain", "kernel", "kernel", "plain"):
        with in_route(route):
            zero_intra_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            maps[route] = run()
            walls[route].append(time.perf_counter() - t)
            launches[route] = intra_counts()
    check(all(np.array_equal(a, b) and a.dtype == b.dtype
              for a, b in zip(maps["kernel"], maps["plain"])),
          "the 1080p I pass's maps differ between the kernel route and "
          "the plain route")
    want = {"intra_sweep": classes, "tu_rd_intra": classes + chroma_classes,
            "tu_rd_given": 0, "intra_select": 1, "intra_pick": 1,
            "intra_dp": 1, "satd": 0, "residual": 0}
    check(launches["kernel"] == want,
          f"the 1080p I pass launched {launches['kernel']}, expected {want} "
          "(no K1, no K2)")
    check(launches["plain"]["satd"] == classes
          and launches["plain"]["residual"] > 0
          and not any(launches["plain"][k] for k in (
              "intra_sweep", "tu_rd_intra", "intra_select", "intra_pick",
              "intra_dp")),
          f"the plain route launched {launches['plain']}")
    prof_out = profiled_i_pass(args, work, sum(want.values()))
    out = dict(wall_ms={k: [1000 * w for w in v] for k, v in walls.items()},
               launches=launches, profiled=prof_out, maps_identical=True)
    print("fastrd_intra_pass " + json.dumps(out))

    calls: dict = {}
    with recorded_intra_kernel_calls(calls):
        run()
    timed = ("sweep", "tu_rd_intra", "select", "pick", "dp")
    err, rows = held_intra_calls(torch, calls, timed, "intra_pass")
    check([len(rows[k]) for k in timed]
          == [classes, classes + chroma_classes, 1, 1, 1],
          f"recorded {[len(v) for v in rows.values()]} intra kernel calls")
    # the same frame as 10 bits
    (y, cb, cr, w, h, qp, qp_cb, qp_cr, *rest) = args
    args10 = (*(p.astype(np.int16) << 2 for p in (y, cb, cr)), w, h,
              qp + 12, qp_cb + 12, qp_cr + 12, *rest[:-2], 2, 1023)
    with in_route("plain"):
        maps10_plain = run(args10)
    calls10: dict = {}
    with recorded_intra_kernel_calls(calls10):
        maps10 = run(args10)
    check(all(np.array_equal(a, b) for a, b in zip(maps10, maps10_plain)),
          "the 10-bit I pass's maps differ between the routes")
    err10, rows10 = held_intra_calls(torch, calls10, timed,
                                     "intra_pass_10bit")
    out.update(max_abs_err=max(err, err10), rows=rows, rows_10bit=rows10)
    print("fastrd_intra_pass_kernels " + json.dumps(
        {"max_abs_err": out["max_abs_err"],
         "calls": {k: len(v) for k, v in calls.items()},
         "calls_10bit": {k: len(v) for k, v in calls10.items()},
         "maps_identical_10bit": True}))
    torch.cuda.empty_cache()
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
    check(rep["intra_sweep_launches"] > 0 and rep["tu_rd_launches"] > 0,
          "the P/B fast-RD encode launched no intra sweep or TU-RD kernel")
    check(rep["residual_launches"] == 0, "the P/B fast-RD encode's "
          f"decision passes launched K1 {rep['residual_launches']} times")
    check_parent_stream("ldb", stream)
    selects = check_select_launches(rep, "the P/B fast-RD encode")
    check(rep["mc_blocks_launches"] > 0 and rep["mc_qpel_launches"] > 0
          and rep["plain_mc_calls"] == 0,
          f"the P/B fast-RD encode launched the MC kernel's blocks "
          f"entry {rep['mc_blocks_launches']} times, its quarter-pel entry "
          f"{rep['mc_qpel_launches']} times and the plain MC "
          f"{rep['plain_mc_calls']} times")
    check(not rep["jax_imported"], "the port's encoder imported jax")
    # each P/B pass: one coarse search a list, one refinement and one
    # merge model a size class (8-64 at the cfg's 64x64 CTUs) and list
    check(rep["coarse_search_launches"] > 0
          and rep["int_refine_launches"]
          == rep["merge_model_launches"]
          == 4 * rep["coarse_search_launches"],
          "the P/B fast-RD encode launched the motion-search kernels "
          f"{rep['coarse_search_launches']}, {rep['int_refine_launches']}, "
          f"{rep['merge_model_launches']} times")
    # one quarter-pel pick a refinement, one bi pick a B frame (two lists
    # a frame), every MC launch through a field entry
    check(rep["qpel_pick_launches"] == rep["int_refine_launches"]
          and 2 * rep["bi_pick_launches"] == rep["coarse_search_launches"]
          and rep["mc_blocks_field_launches"] == rep["mc_blocks_launches"]
          and rep["mc_qpel_field_launches"] == rep["mc_qpel_launches"],
          "the P/B fast-RD encode launched the picks "
          f"{rep['qpel_pick_launches']}, {rep['bi_pick_launches']} times "
          f"and the MC field entries {rep['mc_blocks_field_launches']}, "
          f"{rep['mc_qpel_field_launches']} times")
    check(rep["decision_frames"] == FRAMES
          and rep["decision_frames_inter"] == FRAMES - 1,
          f"decision passes {rep['decision_frames']} "
          f"({rep['decision_frames_inter']} P/B) for {FRAMES} frames")
    rc, log, filters_launches = decode_filtered(torch, stream, dec_rec)
    check_decode(rc, log, FRAMES, dec_rec, enc_rec, "the P/B fast-RD stream")
    check(filters_launches > 0, "the P/B fast-RD stream's decode launched "
          "no filter kernel")
    out = dict(frames=FRAMES, qp=QP, encode_wall_s=rep["wall_s"],
               encode_fps=FRAMES / rep["wall_s"],
               decision_wall_s=rep["decision_wall_s"],
               decision_ms_per_frame=1000 * rep["decision_wall_s"] / FRAMES,
               satd_launches=rep["satd_launches"],
               residual_launches=rep["residual_launches"],
               intra_sweep_launches=rep["intra_sweep_launches"],
               tu_rd_launches=rep["tu_rd_launches"], **selects,
               mc_blocks_launches=rep["mc_blocks_launches"],
               mc_qpel_launches=rep["mc_qpel_launches"],
               mc_blocks_field_launches=rep["mc_blocks_field_launches"],
               mc_qpel_field_launches=rep["mc_qpel_field_launches"],
               **{f"{k}_launches": rep[f"{k}_launches"] for k in INTER_ME},
               decode_filters_launches=filters_launches,
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


INTER_ME = ("coarse_search", "int_refine", "merge_model", "qpel_pick",
            "bi_pick")
# the select, pick and DP kernels (csrc/intra_select.cu), by launch count
SELECT_KERNELS = ("intra_select", "intra_pick", "intra_dp")
SELECT_REPLACES = {
    "intra_select": "thevc_tpu/encoder/fast_intra.py:467-492 (in "
                    "_size_pass_impl :404)",
    "intra_pick": "thevc_tpu/encoder/fast_intra.py:500-516, 580-583, "
                  "832-835",
    "intra_dp": "thevc_tpu/encoder/fast_intra.py:588-600 and _dp_expand "
                ":613-775 (thevc_tpu/encoder/fast_inter.py:624, 654)"}
# where each motion-search kernel's TPU counterpart is
INTER_ME_REPLACES = {
    "coarse_search": "thevc_tpu/encoder/fast_inter.py:98",
    "int_refine": "thevc_tpu/encoder/fast_inter.py:234",
    "merge_model": "thevc_tpu/encoder/fast_inter.py:367",
    "qpel_pick": "thevc_tpu/encoder/fast_inter.py:280-314 (the predictor "
                 ":226)",
    "bi_pick": "thevc_tpu/encoder/fast_inter.py:507-526, 649-651"}
# each kernel's launch count in ops.inter_me_kernel
INTER_ME_COUNTS = {"coarse_search": "coarse_launches",
                   "int_refine": "refine_launches",
                   "merge_model": "merge_launches",
                   "qpel_pick": "pick_launches", "bi_pick": "bi_launches"}


def inter_me_counts() -> dict:
    """The launches of the P/B pass's kernels of ``csrc/inter_me.cu``
    (those the checkout has: ``tools/inter_me_ab.py`` runs these helpers
    on older checkouts too)."""
    from thevc_tpu_torch.ops import inter_me_kernel as k
    return {n: getattr(k, c) for n, c in INTER_ME_COUNTS.items()
            if hasattr(k, c)}


def zero_inter_me_counts() -> None:
    from thevc_tpu_torch.ops import inter_me_kernel as k
    for c in INTER_ME_COUNTS.values():
        if hasattr(k, c):
            setattr(k, c, 0)


@contextlib.contextmanager
def recorded_inter_me_calls(calls: dict):
    """Record every launch of the ``csrc/inter_me.cu`` kernels' entries
    (their arguments) into ``calls``."""
    from thevc_tpu_torch.ops import inter_me_kernel
    saved = {n: getattr(inter_me_kernel, n) for n in INTER_ME
             if hasattr(inter_me_kernel, n)}

    def spy(name):
        def call(*a):
            calls.setdefault(name, []).append(a)
            return saved[name](*a)
        return call
    for n in saved:
        setattr(inter_me_kernel, n, spy(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(inter_me_kernel, n, f)


def inter_me_flat(name: str, out) -> tuple:
    """An entry's outputs as one tuple (the coarse search's by size)."""
    if name in ("coarse_search", "bi_pick"):
        return tuple(t for s in sorted(out) for t in out[s])
    return tuple(out)


def inter_me_plain(name: str, a):
    """The plain form of a recorded motion-search kernel call."""
    from thevc_tpu_torch.encoder import fast_inter
    if name == "coarse_search":
        org_q, refs_q, rng_q, sqrt_lam, sizes = a
        return lambda: fast_inter.coarse_fields_plain(
            org_q, refs_q, rng_q, *org_q.shape, sqrt_lam, sizes[-1])
    if name == "int_refine":
        org, refs_y, coarse, s, nby, nbx, sqrt_lam, bit_inc, _pad = a
        return lambda: fast_inter.int_refine_plain(
            org, refs_y, coarse, s, nby, nbx, sqrt_lam, bit_inc)
    if name == "qpel_pick":
        return lambda: fast_inter.qpel_pick_plain(*a)
    if name == "bi_pick":
        return lambda: fast_inter.bi_pick_plain(*a)
    (orgs, refs_y, refs_c, s, nby, nbx, rd_terms, winner, lam, cw, bit_inc,
     _pad_y, _pad_c) = a
    return lambda: fast_inter.merge_model_plain(
        *orgs, refs_y, refs_c, s, nby, nbx, rd_terms, winner, lam, cw,
        bit_inc)


def _nonzero_taps(luma: bool):
    from thevc_tpu_torch.common.tables import from_reference
    filt = from_reference("cpu")
    return ((filt.luma_filter if luma else filt.chroma_filter) != 0).sum(1)


def inter_me_bound(torch, name: str, a) -> tuple:
    """(bytes, operations, bound_ms, bound_by) of one motion-search
    kernel call, its inputs read once and its outputs written once, its
    operations at the int32 rate.
    A difference of two samples and its sum is two instructions, a
    subtraction and an add of the absolute value (an operand modifier of
    the float add; float sums of samples are exact below 2^24): the
    least the card can issue for it.
    coarse_search: the pooled source and bands, the int64 (dy, dx, ref)
    of every block; per reference and offset a difference a pooled
    sample, and per block a cost (conversion, product, sum, comparison).
    int_refine: the source blocks, the distinct reference samples of the
    blocks' (s + 6)-square windows, the int64 coarse field in and the
    int64 MV out; ``refine_ops``.
    qpel_pick: the SATD, the coarse field (three int64 reads a block,
    its neighbours' from cache), the int64 integer MVs and the int32
    outputs; per block 14 exp-Golomb lengths (about 6 instructions each)
    and per candidate a conversion, product, sum and comparison.
    bi_pick: per block both leaves (16 bytes each), the six transform-RD
    terms and the two outputs; four exp-Golomb lengths and about 16
    operations for the sums, the minimum and the direction.
    merge_model: the source blocks (luma, Cb, Cr), the distinct
    reference samples of the three luma candidates' (s + 7)-square
    windows and of the Cb and Cr windows of the candidate the luma SSE
    picks (found here with the plain form's own steps), the transform-RD
    estimates and winners in, the four outputs; each candidate's two
    filter passes at the nonzero taps of its phases (the identity row's
    one), 3 operations a sample for the SSE, and about 60 a block for the
    bits and costs."""
    if name == "coarse_search":
        org_q, refs_q, rng_q, _sl, sizes = a
        hq, wq = (int(v) for v in org_q.shape)
        n_off = 2 * rng_q + 1
        blocks = sum((hq * 4 // s) * (wq * 4 // s) for s in sizes)
        nbytes = 2 * hq * wq + sum(2 * r.numel() for r in refs_q) \
            + 24 * blocks + 4
        ops = len(refs_q) * n_off * n_off * (2 * hq * wq + 4 * blocks)
        return (nbytes, ops, *roofline(nbytes, ops, INT32_OPS))
    if name == "qpel_pick":
        satd, coarse, int_mx, int_my, _sl = a
        nb = int(satd.shape[0])
        nbytes = _nbytes(satd, *coarse, int_mx, int_my) + 12 * nb + 4
        ops = nb * (14 * 6 + 49 * 4)
        return (nbytes, ops, *roofline(nbytes, ops, INT32_OPS))
    if name == "bi_pick":
        classes = a[0]
        nb = sum(v[0][0].numel() for v in classes.values())
        nbytes = sum(_nbytes(*l0, *l1, *terms)
                     for l0, l1, terms in classes.values()) + 8 * nb + 8
        ops = nb * (4 * 6 + 16)
        return (nbytes, ops, *roofline(nbytes, ops, INT32_OPS))
    from thevc_tpu_torch.encoder import fast_inter
    if name == "int_refine":
        org, refs_y, (c_dy, c_dx, c_ref), s, nby, nbx, _sl, _bi, pad = a
        nb = nby * nbx
        by, bx = fast_inter._block_grid(s, nby, nbx, org.device)
        nbytes = 2 * touched(torch, int(refs_y.shape[1]),
                             int(refs_y.shape[2]), c_ref.reshape(-1),
                             by + c_dy.reshape(-1) + pad - 3,
                             bx + c_dx.reshape(-1) + pad - 3, s + 6, s + 6) \
            + 2 * nb * s * s + 24 * nb + 16 * nb + 4
        ops = refine_ops(s, nb)
        return (nbytes, ops, *roofline(nbytes, ops, INT32_OPS))
    (orgs, refs_y, refs_c, s, nby, nbx, rd_terms, winner, lam, _cw, bit_inc,
     pad_y, pad_c) = a
    nb, cs, bd = nby * nbx, s // 2, 8 + bit_inc
    mvx, mvy, ref = (t.reshape(nby, nbx).long() for t in winner)
    cands = []
    for dy, dx in ((0, 1), (1, 0)):
        cands.append(tuple(fast_inter._shift_grid(t, dy, dx).reshape(-1)
                           for t in (mvx, mvy, ref)))
    zero = torch.zeros(nb, dtype=torch.long, device=mvx.device)
    cands.append((zero, zero, zero))
    by, bx = (t.long() for t in fast_inter._block_grid(s, nby, nbx,
                                                       mvx.device))
    org_b = fast_inter._blocks(orgs[0], s, nby, nbx)
    costs = []
    from thevc_tpu_torch.ops import mc
    for cx, cy, cr in cands:
        pred = mc.mc_blocks(refs_y, fast_inter._luma_jobs(
            cr.int(), cx.int(), cy.int(), by.int(), bx.int()), "2d", True,
            bd, False, s, s)
        costs.append(fast_inter._sse(org_b, pred, bit_inc).float())
    pick = torch.stack([c + lam * (2.0 + i) for i, c in
                        enumerate(costs)]).argmin(0)
    sx, sy, sr = (torch.stack(c).gather(0, pick[None])[0]
                  for c in zip(*cands))
    cat = torch.cat
    nbytes = 2 * touched(torch, int(refs_y.shape[1]), int(refs_y.shape[2]),
                         cat([c[2] for c in cands]),
                         cat([by + (c[1] >> 2) + pad_y - 3 for c in cands]),
                         cat([bx + (c[0] >> 2) + pad_y - 3 for c in cands]),
                         s + 7, s + 7)
    n_refs = int(refs_y.shape[0])
    nbytes += 2 * touched(torch, int(refs_c.shape[1]), int(refs_c.shape[2]),
                          cat([sr, sr + n_refs]),
                          cat([by // 2 + (sy >> 3) + pad_c - 1] * 2),
                          cat([bx // 2 + (sx >> 3) + pad_c - 1] * 2),
                          cs + 3, cs + 3)
    nbytes += 2 * nb * (s * s + 2 * cs * cs) + 4 * 12 * nb + 4 * 4 * nb + 8
    lt, ct = _nonzero_taps(True), _nonzero_taps(False)
    macs = sum(int(lt[(c[0] & 3).cpu()].sum()) * (s + 7) * s
               + int(lt[(c[1] & 3).cpu()].sum()) * s * s for c in cands)
    macs += 2 * (int(ct[(sx & 7).cpu()].sum()) * (cs + 3) * cs
                 + int(ct[(sy & 7).cpu()].sum()) * cs * cs)
    ops = 2 * macs + 3 * nb * (3 * s * s + 2 * cs * cs) + 60 * nb
    return (nbytes, ops, *roofline(nbytes, ops, INT32_OPS))


def refine_ops(s: int, nb: int) -> int:
    """The operations of one integer-refinement call of nb blocks of s x
    s: per block, candidate and source sample a difference at two
    instructions (``inter_me_bound``), per candidate about 6 for its
    cost."""
    return nb * 49 * (2 * s * s + 6)


def held_inter_me_calls(torch, calls: dict, tag: str,
                        launches: dict) -> tuple:
    """Each recorded motion-search kernel call against its plain form on
    the card (integers and MVs tolerance 0, floats bit for bit) and timed
    (20 eager calls, a CUDA graph of 20, the plain form) beside its
    bound; per entry one ``kernel <entry>`` line of the calls summed,
    with the entry's launches in the pass (``launches``), each call's
    eager and graph ms and size class (``per_call_*``; the coarse
    search's and the bi pick's 0, all classes at once) and the graph ms
    summed by class
    (``by_class``; the quarter-pel pick's class from its block count).
    Returns (largest error, {entry: summed row})."""
    from thevc_tpu_torch.ops import inter_me_kernel
    max_err = 0.0
    sums = {}
    for name in INTER_ME:
        if not calls.get(name):
            continue
        kernel = getattr(inter_me_kernel, name)
        rows = []
        # the quarter-pel pick's size class from its block count: the
        # largest count is the 8x8 class's
        nb_max = max(int(a[0].shape[0]) for a in calls[name]) \
            if name == "qpel_pick" else 0
        for a in calls.get(name, []):
            plain = inter_me_plain(name, a)
            got = inter_me_flat(name, kernel(*a))
            want = inter_me_flat(name, plain())
            torch.cuda.synchronize()
            err, same = 0.0, len(got) == len(want)
            for x, y in zip(got, want):
                same = same and x.dtype == y.dtype and x.shape == y.shape
                if not same:
                    break
                err = max(err, float((x.double() - y.double()).abs().max()))
                if x.dtype == torch.float32:
                    x, y = x.view(torch.int32), y.view(torch.int32)
                same = same and torch.equal(x, y)
            max_err = max(max_err, err)
            check(same, f"{tag}: motion-search kernel {name} != plain form "
                  f"(max abs err {err})")
            nbytes, ops, bound_ms, bound_by = inter_me_bound(torch, name, a)
            rows.append(dict(
                ms=time_ms(torch, lambda: kernel(*a), 20),
                graph_ms=graph_ms(torch, lambda: kernel(*a), 20),
                plain_ms=time_ms(torch, plain, 3), bytes=nbytes, ops=ops,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                s=0 if name in ("coarse_search", "bi_pick")
                else 8 * round((nb_max / int(a[0].shape[0])) ** 0.5)
                if name == "qpel_pick" else a[3]))
        if not rows:
            continue
        row = {k: sum(r[k] for r in rows) for k in (
            "ms", "graph_ms", "plain_ms", "bytes", "ops", "bound_ms")}
        row.update(
            tag=tag, calls=len(rows), launches=launches.get(name, 0),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in rows)
            else "operations", library_ms=None,
            share_of_bound=row["bound_ms"] / row["ms"],
            graph_share_of_bound=row["bound_ms"] / row["graph_ms"],
            per_call_graph_ms=[r["graph_ms"] for r in rows],
            per_call_ms=[r["ms"] for r in rows],
            per_call_class=[r["s"] for r in rows], by_class={})
        for r in rows:
            row["by_class"][r["s"]] = row["by_class"].get(r["s"], 0.0) \
                + r["graph_ms"]
        sums[name] = row
        print(f"kernel {name} " + json.dumps(row))
    return max_err, sums


def ten_bit_b_call(args: tuple, refs1: list) -> tuple:
    """The recorded B call as 10 bits: every source and reference sample
    << 2, the scaled QPs + 12, bit increment 2, samples up to 1023."""
    (y, cb, cr, refs, w, h, qp, qp_cb, qp_cr, *rest) = args

    def up(pics):
        return [(poc, *(p.astype("int16") << 2 for p in planes))
                for poc, *planes in pics]
    return ((*(p.astype("int16") << 2 for p in (y, cb, cr)), up(refs), w, h,
             qp + 12, qp_cb + 12, qp_cr + 12, *rest[:-2], 2, 1023),
            up(refs1))


def inter_pass_phase(torch, clip: Path, work: Path) -> dict:
    """One 1080p B frame's decision pass in this process, replayed from
    the encoder's own call: synchronised walls, stage walls, profiler
    device time (no K1 launch), the same on the plain route
    (``plain_route``: the intra leaves and transform-RD estimates through
    the entries' plain forms, K2 and K1 inside) with identical maps, and
    every K2, MC and intra decision kernel call of the pass held against
    its plain version; the quarter-pel MC calls (49 candidates a block,
    one a size class and list) timed with their bound beside the generic
    MC entry on the same job table (``qpel_row``), the generic MC calls
    (the winners' predictions) timed and summed, each intra decision
    kernel call timed (``kernel intra_sweep`` / ``kernel tu_rd`` rows),
    and each motion-search kernel call (``csrc/inter_me.cu``) held
    against its plain form and timed (``kernel coarse_search`` /
    ``int_refine`` / ``merge_model`` lines), for the frame and for the
    same frame as 10 bits (``ten_bit_b_call``), whose maps must also be
    equal on both routes."""
    import numpy as np
    from thevc_tpu_torch.encoder import fast_inter, fast_intra
    from thevc_tpu_torch.ops import device as dev_stats
    from thevc_tpu_torch.ops import mc, mc_kernel, satd
    args, refs1 = recorded_b_call(clip, work)
    cache = fast_inter.RefCache()

    def run():
        return fast_inter.decide_frame_p(*args, ref_pics_l1=refs1,
                                         device="cuda", ref_cache=cache)
    run()                               # warm-up; the references go up
    # the bi stage averages in the MC kernel: no bi_avg_batch on cuda
    real_avg, avg_calls = mc.bi_avg_batch, []

    def rec_avg(*a):
        avg_calls.append(1)
        return real_avg(*a)
    mc.bi_avg_batch = rec_avg
    walls, launches, maps = [], None, None
    for _ in range(3):
        zero_intra_counts()
        zero_inter_me_counts()
        mc_kernel.blocks_launches = mc_kernel.qpel_launches = 0
        mc_kernel.blocks_field_launches = mc_kernel.qpel_field_launches = 0
        mc.launches = 0
        t = time.perf_counter()
        maps = run()
        walls.append(time.perf_counter() - t)
        counts = intra_counts()
        launches = {"satd": counts["satd"],
                    "mc": mc_kernel.blocks_launches,
                    "mc_fields": mc_kernel.blocks_field_launches,
                    "mc_qpel": mc_kernel.qpel_launches,
                    "mc_qpel_fields": mc_kernel.qpel_field_launches,
                    "intra_sweep": counts["intra_sweep"],
                    "tu_rd_intra": counts["tu_rd_intra"],
                    "tu_rd_given": counts["tu_rd_given"],
                    "intra_select": counts["intra_select"],
                    "intra_pick": counts["intra_pick"],
                    "intra_dp": counts["intra_dp"],
                    **inter_me_counts()}
        # K2 for the quarter-pel candidates only; the intra leaves and
        # every transform-RD estimate on the intra decision kernels
        check(all(launches.values()) and counts["residual"] == 0
              and mc.launches == 0,
              f"the B decision pass skipped a kernel: {launches}, ran K1 "
              f"{counts['residual']} times or the plain MC {mc.launches} "
              "times")
    mc.bi_avg_batch = real_avg
    classes = len(fast_inter.INTER_SIZES)
    # a size class: per list luma and the Cb/Cr pair for the transform
    # estimate, then one bi luma and one bi pair (the merge model
    # predicts in its own kernel)
    check(launches["mc"] == 6 * classes and not avg_calls,
          f"the B pass made {launches['mc']} MC blocks launches (expected "
          f"{6 * classes}) and {len(avg_calls)} bi_avg_batch calls")
    # every MC launch through a field entry: the pass builds no job table
    # (one quarter-pel launch a size class and list)
    check(launches["mc_fields"] == launches["mc"]
          and launches["mc_qpel_fields"] == launches["mc_qpel"]
          == 2 * classes,
          f"the B pass made {launches['mc']} MC blocks launches, "
          f"{launches['mc_fields']} through the field entry, and "
          f"{launches['mc_qpel']} quarter-pel launches, "
          f"{launches['mc_qpel_fields']} through the field entry")
    # one coarse search a list, one refinement, one quarter-pel pick and
    # one merge model a size class and list, one bi pick a frame
    expected = {"coarse_search": 2, "int_refine": 2 * classes,
                "merge_model": 2 * classes, "qpel_pick": 2 * classes,
                "bi_pick": 1}
    check({k: launches[k] for k in INTER_ME} == expected,
          f"the B pass launched the motion-search kernels "
          f"{ {k: launches[k] for k in INTER_ME} }, expected {expected}")
    # one select and one pick over every luma class (4-64), one DP launch
    # a frame
    expected = {"intra_select": 1, "intra_pick": 1, "intra_dp": 1}
    check({k: launches[k] for k in expected} == expected,
          f"the B pass launched the select, pick and DP kernels "
          f"{ {k: launches[k] for k in expected} }, expected {expected}")
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
    # the same frame on the plain route (the intra entries' plain forms,
    # K2 and K1 inside): walls, stage walls, device time, the maps
    with plain_route():
        plain_walls = []
        for _ in range(2):
            t = time.perf_counter()
            plain_maps = run()
            plain_walls.append(time.perf_counter() - t)
        dev_stats.stage_timing(True)
        try:
            run()
        finally:
            plain_stages = dev_stats.stage_timing(False)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as pprof:
            t = time.perf_counter()
            run()
            plain_prof_wall = time.perf_counter() - t
        plain_stage_device = stage_profile(torch, run)
    p_us, p_kernels, _ = profiled_device(pprof)
    stage_device = stage_profile(torch, run)
    check(all(np.array_equal(a, b) and a.dtype == b.dtype
              for a, b in zip(maps, plain_maps)),
          "the B pass's maps differ between the kernel and plain routes")
    wall = sorted(walls)[1]
    out = dict(wall_ms=[1000 * w for w in walls], median_wall_ms=1000 * wall,
               launches=launches, mc_blocks_calls=launches["mc"],
               bi_avg_calls=len(avg_calls),
               stage_ms={k: 1000 * v for k, v in
                                            sorted(stages.items())},
               profiled_wall_ms=1000 * prof_wall,
               device_ms=device_us / 1000, device_kernels=n_kernels,
               top_kernels_ms=top,
               device_busy_share=device_us / 1e6 / prof_wall,
               stage_device=stage_device,
               plain_route=dict(
                   wall_ms=[1000 * w for w in plain_walls],
                   stage_ms={k: 1000 * v for k, v in
                             sorted(plain_stages.items())},
                   profiled_wall_ms=1000 * plain_prof_wall,
                   device_ms=p_us / 1000, device_kernels=p_kernels,
                   device_busy_share=p_us / 1e6 / plain_prof_wall,
                   stage_device=plain_stage_device),
               maps_identical=True)
    print("fastrd_inter_pass " + json.dumps(out))
    # the B frame's device activities by stage, both routes; the stages
    # this PR's kernels took over beside their sum
    glue = ("fast_inter.qpel_mc_satd", "fast_inter.tq_rd", "fast_inter.bi")
    acts = {k: v["activities"] for k, v in stage_device["stages"].items()}
    print("fastrd_inter_stage_activities " + json.dumps({
        "kernel_route": acts,
        "plain_route": {k: v["activities"] for k, v in
                        plain_stage_device["stages"].items()},
        "qpel_mc_satd_tq_rd_bi": sum(acts.get(k, 0) for k in glue),
        "qpel_mc_satd_tq_rd_bi_device_ms": sum(
            stage_device["stages"].get(k, {}).get("device_ms", 0.0)
            for k in glue),
        "activities": stage_device["activities"],
        "device_ms": stage_device["device_ms"]}))

    # record the pass's kernel calls (the inter leaves' and the intra
    # leaves'), then hold each against its plain version and time the
    # 49-candidate SATD and MC calls, the generic MC calls and the intra
    # decision kernels' calls
    calls = {"satd": [], "mc": [], "mc_qpel": []}
    icalls: dict = {}
    mcalls: dict = {}
    real_satd = satd.satd_blocks
    real_mc, real_qpel = mc.mc_blocks_fields, mc.mc_qpel_fields

    def rec_satd(org, preds, bit_inc=0):
        calls["satd"].append((org, preds, bit_inc))
        return real_satd(org, preds, bit_inc)

    def rec_mc(*a, **kw):
        calls["mc"].append((a, kw))
        return real_mc(*a, **kw)

    def rec_qpel(*a):
        calls["mc_qpel"].append(a)
        return real_qpel(*a)
    fast_inter.satd_blocks = fast_intra.satd_blocks = rec_satd
    mc.mc_blocks_fields, mc.mc_qpel_fields = rec_mc, rec_qpel
    try:
        with recorded_intra_kernel_calls(icalls), \
                recorded_inter_me_calls(mcalls):
            run()
    finally:
        fast_inter.satd_blocks = fast_intra.satd_blocks = real_satd
        mc.mc_blocks_fields, mc.mc_qpel_fields = real_mc, real_qpel
    recorded = {**{k: len(v) for k, v in calls.items()},
                "mc_fields": len(calls["mc"]),
                "mc_qpel_fields": len(calls["mc_qpel"]),
                "intra_sweep": len(icalls.get("sweep", [])),
                "tu_rd_intra": len(icalls.get("tu_rd_intra", [])),
                "tu_rd_given": len(icalls.get("tu_rd_given", [])),
                "intra_select": len(icalls.get("select", [])),
                "intra_pick": len(icalls.get("pick", [])),
                "intra_dp": len(icalls.get("dp", [])),
                **{k: len(mcalls.get(k, [])) for k in INTER_ME}}
    check(recorded == launches,
          f"recorded {recorded} kernel calls of the B pass for launches "
          f"{launches}")
    max_err = {"satd": 0, "mc": 0, "mc_qpel": 0}
    # the intra leaves' calls are the I pass's kind (timed there); the
    # given-prediction calls and the DP with its inter leaves are timed
    # here
    max_err["intra_rd"], intra_rows = held_intra_calls(
        torch, icalls, ("tu_rd_given", "dp"), "inter_pass")
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
                         fp32_bound_ms=satd_bound(n, size, m, FP32_OPS)[2],
                         share_of_bound=bound_ms / ms,
                         graph_share_of_bound=bound_ms / g_ms,
                         gb_s=nbytes / ms / 1e6))
        if m == 49:
            print("kernel satd " + json.dumps(rows[-1]))
    blocks_rows = []
    for a, kw in calls["mc"]:
        err = held_mc_fields(torch, a, kw)
        max_err["mc"] = max(max_err["mc"], err)
        ta, tkw = mc_fields_table(a, kw)
        nbytes, ops, bound_ms, bound_by = mc_fields_bound(torch, a, kw)
        size = a[2]
        blocks_rows.append(dict(
            shape=[2] * bool(kw.get("pair")) + [int(a[1][0].shape[0]), size,
                                                size],
            luma=bool(a[5]), bi=bool(a[7]), pair=bool(kw.get("pair")),
            lists=1 + (kw.get("fields1") is not None),
            ms=time_ms(torch, lambda: mc.mc_blocks_fields(*a, **kw), 20),
            graph_ms=graph_ms(torch, lambda: mc.mc_blocks_fields(*a, **kw),
                              20),
            table_graph_ms=graph_ms(torch, lambda: mc.mc_blocks(*ta, **tkw),
                                    20),
            plain_ms=time_ms(torch, lambda: mc.mc_blocks_fields_plain(
                *a, **kw), 3),
            bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
            fp32_bound_ms=mc_fields_bound(torch, a, kw, FP32_OPS)[2]))
    blocks_sum = {k: sum(r[k] for r in blocks_rows) for k in (
        "ms", "graph_ms", "table_graph_ms", "plain_ms", "bytes", "bound_ms",
        "fp32_bound_ms")}
    blocks_sum.update(
        calls=len(blocks_rows), bound_by="bytes" if all(
            r["bound_by"] == "bytes" for r in blocks_rows) else "operations",
        graph_share_of_bound=blocks_sum["bound_ms"] / blocks_sum["graph_ms"],
        largest=max(blocks_rows, key=lambda r: (
            r["shape"][-3] * r["shape"][-2] * r["shape"][-1],
            r["shape"][-1])))
    blocks_sum.update(graph_share_of_bound_largest=blocks_sum["largest"][
        "bound_ms"] / blocks_sum["largest"]["graph_ms"],
        max_abs_err=max_err["mc"])
    print("kernel mc_blocks_generic " + json.dumps(blocks_sum))
    mc_rows = []
    for a in calls["mc_qpel"]:
        mc_rows.append(qpel_row(torch, *a))
        max_err["mc_qpel"] = max(max_err["mc_qpel"],
                                 mc_rows[-1]["max_abs_err"])
        print("kernel mc_qpel " + json.dumps(mc_rows[-1]))
    check(len(mc_rows) == 2 * len(fast_inter.INTER_SIZES),
          f"{len(mc_rows)} quarter-pel MC calls in the B pass")
    inter_me = {}
    max_err["inter_me"], inter_me["8bit"] = held_inter_me_calls(
        torch, mcalls, "8bit", launches)
    del mcalls
    # the same frame as 10 bits: the maps of both routes, and every
    # motion-search kernel call held and timed
    args10, refs1_10 = ten_bit_b_call(args, refs1)
    cache10 = fast_inter.RefCache()

    def run10():
        return fast_inter.decide_frame_p(*args10, ref_pics_l1=refs1_10,
                                         device="cuda", ref_cache=cache10)
    run10()
    mcalls10: dict = {}
    icalls10: dict = {}
    fcalls10: dict = {"mc": [], "mc_qpel": []}

    def rec_mc10(*a, **kw):
        fcalls10["mc"].append((a, kw))
        return real_mc(*a, **kw)

    def rec_qpel10(*a):
        fcalls10["mc_qpel"].append(a)
        return real_qpel(*a)
    zero_inter_me_counts()
    mc.mc_blocks_fields, mc.mc_qpel_fields = rec_mc10, rec_qpel10
    try:
        with recorded_inter_me_calls(mcalls10), \
                recorded_intra_kernel_calls(icalls10):
            maps10 = run10()
    finally:
        mc.mc_blocks_fields, mc.mc_qpel_fields = real_mc, real_qpel
    launches10 = inter_me_counts()
    # the 10-bit frame's MC field calls, held untimed: against their plain
    # forms and the table entries
    check(len(fcalls10["mc"]) == 6 * classes
          and len(fcalls10["mc_qpel"]) == 2 * classes,
          f"the 10-bit B pass made {len(fcalls10['mc'])} MC field calls and "
          f"{len(fcalls10['mc_qpel'])} quarter-pel ones")
    for a, kw in fcalls10["mc"]:
        max_err["mc"] = max(max_err["mc"], held_mc_fields(torch, a, kw))
    for planes, fields, size, nbx, pad, bd in fcalls10["mc_qpel"]:
        got = mc.mc_qpel_fields(planes, fields, size, nbx, pad, bd)
        want = mc.mc_qpel_fields_plain(planes, fields, size, nbx, pad, bd)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        max_err["mc_qpel"] = max(max_err["mc_qpel"], err)
        check(torch.equal(got, want), "the 10-bit quarter-pel field call "
              f"at s = {size} != plain (max abs err {err})")
        del got, want
    del fcalls10
    with plain_route():
        plain10 = run10()
    check(all(np.array_equal(a, b) and a.dtype == b.dtype
              for a, b in zip(maps10, plain10)),
          "the 10-bit B pass's maps differ between the kernel and plain "
          "routes")
    err10, inter_me["10bit"] = held_inter_me_calls(torch, mcalls10, "10bit",
                                                   launches10)
    max_err["inter_me"] = max(max_err["inter_me"], err10)
    # the 10-bit frame's intra decision kernel calls, held untimed
    err10, _ = held_intra_calls(torch, icalls10, (), "inter_pass_10bit")
    max_err["intra_rd"] = max(max_err["intra_rd"], err10)
    del icalls10
    del mcalls10, cache10
    out.update(max_abs_err=max_err, satd_rows=rows, mc_rows=mc_rows,
               mc_blocks=blocks_sum, mc_calls=len(calls["mc"]),
               intra_rows=intra_rows, inter_me=inter_me)
    print("fastrd_inter_kernels " + json.dumps(
        {"max_abs_err": max_err, "intra_calls": {
            k: len(v) for k, v in icalls.items()},
         "satd_calls": len(rows), "mc_calls": out["mc_calls"],
         "mc_qpel_calls": len(mc_rows),
         "replayed_pocs": {
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
        check(rep["satd_launches"] > 0 and rep["residual_launches"] == 0
              and rep["intra_sweep_launches"] > 0
              and rep["tu_rd_launches"] > 0
              and rep["mc_blocks_launches"] > 0
              and rep["mc_qpel_launches"] > 0
              and rep["mc_blocks_field_launches"] == rep["mc_blocks_launches"]
              and rep["mc_qpel_field_launches"] == rep["mc_qpel_launches"]
              and all(rep[f"{k}_launches"] > 0 for k in INTER_ME
                      if k != "bi_pick")
              # the bi pick runs on B slices only: none in low-delay P
              and (rep["bi_pick_launches"] > 0) == (name != "ldp")
              and rep["plain_mc_calls"] == 0,
              f"{name} fast-RD on cuda skipped a kernel, ran K1 or ran the "
              f"plain MC: {rep}")
        out[name] = {"bytes": len(cuda), "identical": True,
                     "decision_frames_inter": rep["decision_frames_inter"],
                     "residual_launches": rep["residual_launches"],
                     "satd_launches": rep["satd_launches"],
                     "intra_sweep_launches": rep["intra_sweep_launches"],
                     "tu_rd_launches": rep["tu_rd_launches"],
                     "mc_blocks_launches": rep["mc_blocks_launches"],
                     "mc_qpel_launches": rep["mc_qpel_launches"],
                     **{f"{k}_launches": rep[f"{k}_launches"]
                        for k in INTER_ME}}
    print("inter_identity " + json.dumps(out))
    return out


def wp_scaling_phase(torch, work: Path, made: dict) -> dict:
    """The weighted-prediction and scaling-list streams on ``cuda``."""
    from thevc_tpu_torch.ops import mc, mc_kernel, residual_kernel
    out = {}
    for name in WP_SL:
        _clip, stream, enc_rec, _w, _h, frames = made[name]
        dec_rec = work / f"{name}_dec_rec.yuv"
        residual_kernel.launches = mc_kernel.launches = mc.launches = 0
        rc, log, filters_launches = decode_filtered(torch, stream, dec_rec)
        check_decode(rc, log, frames, dec_rec, enc_rec, stream.name)
        out[name] = {"frames": frames, "residual": residual_kernel.launches,
                     "mc": mc_kernel.launches, "filters": filters_launches}
        check(filters_launches > 0, f"{name}: the decode launched no filter "
              "kernel")
        # P/B pictures through the MC kernel, none through plain MC
        check(mc.launches == 0 and (out[name]["mc"] > 0) == (
            name != "sl_intra"), f"{name}: MC kernel {out[name]['mc']} "
              f"launches, plain MC {mc.launches} calls")
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


def nxn_apply_phase(torch) -> dict:
    """The device apply on seeded maps with NxN CUs (no decision pass sets
    NxN, so the 1080p clip never runs the 4x4 luma class): every class of
    ``fast_apply.CLS`` must run through the frame kernel, (4, True, True)
    included, one launch for the frame and no K1; equal to the plain form
    on ``cuda`` (graph-replayed) and to the CPU (tolerance 0)."""
    import numpy as np
    from thevc_tpu_torch.cabac import contexts as cc
    from thevc_tpu_torch.encoder import fast_apply
    from thevc_tpu_torch.ops import apply_kernel, residual_kernel
    from thevc_tpu_torch.streams import nxn_frame
    w, h, qp = 128, 64, 32
    planes, maps = nxn_frame(np.random.RandomState(24), w, h)
    sched = fast_apply.build_schedule(*maps, w, h, 64, 3, 2)
    steps = [int((np.diff(o) > 0).sum()) for o in sched.offs]
    check(all(steps), f"a device-apply class did not run: steps {steps}")
    lam = 0.57 * 2 ** ((qp - 12) / 3)
    args = (*planes, sched, w, h, qp, qp - 1, qp - 2, 64, 0, 255, True, True,
            lam, lam / 1.2, cc.make_context_states_idx(0, qp))
    before = (apply_kernel.launches, residual_kernel.launches)
    run = fast_apply.run_device_apply(*args, device="cuda")
    got = fast_apply.collect_device_apply(run)
    launches = (apply_kernel.launches - before[0],
                residual_kernel.launches - before[1])
    check(launches == (1, 0),
          f"the NxN apply launched {launches} (apply, K1) for one frame")
    ticket, error, waited = run.state.tolist()
    check(error == 0, f"the NxN apply's error word is {error}")
    classes = set((fast_apply.frame_items(
        sched, fast_apply.level_layout(sched)[0])[:, 6] & 15).tolist())
    check(classes == set(range(len(fast_apply.CLS))),
          f"the NxN frame's items hold the classes {sorted(classes)}")
    plain = fast_apply.collect_device_apply(
        fast_apply.run_device_apply_plain(*args, device="cuda"))
    want = fast_apply.collect_device_apply(fast_apply.run_device_apply(
        *args, device="cpu"))
    for g, pl, e in zip(got[:3] + got[3] + got[4],
                        plain[:3] + plain[3] + plain[4],
                        want[:3] + want[3] + want[4]):
        check((g is None and e is None and pl is None)
              or (np.array_equal(g, e) and np.array_equal(pl, e)),
              "the NxN device apply on cuda differs from the CPU")
    out = {"classes": [list(c) for c in fast_apply.CLS],
           "tus_a_class": [int(c) for c in sched.counts],
           "steps_a_class": steps, "waves": sched.n_waves,
           "items": run.n_items, "items_that_waited": waited,
           "apply_launches": launches[0], "residual_launches": launches[1],
           "equal_to_plain_and_cpu": True}
    print("fastrd_devapply_nxn " + json.dumps(out))
    return out


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
    check(rep["intra_sweep_launches"] > 0 and rep["tu_rd_launches"] > 0
          and rep["residual_launches"] == 0 and rep["satd_launches"] == 0
          and rep["apply_launches"] == FRAMES,
          f"the device-apply encode skipped a kernel, ran K1 or K2, or "
          f"launched the apply more than once a frame: {rep}")
    check_parent_stream("devapply", stream)
    selects = check_select_launches(rep, "the device-apply encode")
    check(not rep["jax_imported"], "the port's encoder imported jax")
    check(rep["decision_frames"] == FRAMES
          and rep["device_apply_frames"] == FRAMES
          and rep["device_apply_fallback_frames"] == 0,
          f"device apply ran on {rep['device_apply_frames']} of {FRAMES} "
          f"frames ({rep['device_apply_fallback_frames']} host fallbacks)")
    rc, log, filters_launches = decode_filtered(torch, stream, dec_rec)
    check_decode(rc, log, FRAMES, dec_rec, enc_rec, "the device-apply stream")
    check(filters_launches > 0, "the device-apply stream's decode launched "
          "no filter kernel")
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
        satd_launches=rep["satd_launches"],
        intra_sweep_launches=rep["intra_sweep_launches"],
        tu_rd_launches=rep["tu_rd_launches"], **selects,
        apply_launches=rep["apply_launches"],
        decode_filters_launches=filters_launches, devapply_bytes=dev_bytes,
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


def stage_profile(torch, run, prefix: str = "fast_inter.") -> dict:
    """One call of ``run`` with stage timing on (``ops.device.stage``:
    each stage synchronised, and a profiler range of its name) under
    ``torch.profiler``: the call's wall, device time and device
    activities (kernels, copies, memsets), and per stage whose name
    starts with ``prefix`` its synchronised wall, device time, activities
    and its three largest device items by name.  An activity is charged to the innermost stage range
    that holds the host op which launched it (the profiler's correlation
    ids; its own start where it has none), ``(other)`` outside them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from thevc_tpu_torch.ops import device as dev_stats
    dev_stats.stage_timing(True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run()
            wall = time.perf_counter() - t
    finally:
        walls = dev_stats.stage_timing(False)
    events = list(prof.profiler.kineto_results.events())
    ranges, launched_at = [], {}
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        launched_at[e.correlation_id()] = e.start_ns()
        if e.name().startswith(prefix):
            ranges.append((e.start_ns(), e.end_ns(), e.name()))
    stages = {k: {"wall_ms": 1000 * v, "device_ms": 0.0, "activities": 0}
              for k, v in walls.items() if k.startswith(prefix)}
    device_ns = n = 0
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.name().startswith(prefix):
            continue
        ns = e.duration_ns() if hasattr(e, "duration_ns") \
            else 1000 * e.duration_us()
        at = launched_at.get(e.linked_correlation_id(), e.start_ns())
        inside = [r for r in ranges if r[0] <= at <= r[1]]
        name = min(inside, key=lambda r: r[1] - r[0])[2] if inside \
            else "(other)"
        row = stages.setdefault(name, {"device_ms": 0.0, "activities": 0})
        row["device_ms"] += ns / 1e6
        row["activities"] += 1
        top = row.setdefault("by_name", {})
        top[e.name()[:60]] = top.get(e.name()[:60], 0.0) + ns / 1e6
        device_ns += ns
        n += 1
    for row in stages.values():
        row["top_ms"] = dict(sorted(row.pop("by_name", {}).items(),
                                    key=lambda kv: -kv[1])[:3])
    return dict(wall_ms=1000 * wall, device_ms=device_ns / 1e6,
                activities=n, stages=dict(sorted(stages.items())))


def apply_bound(sched) -> tuple:
    """(bytes, operations, bound_ms, bound_by) of a frame's apply: each
    real record once, at its own wave (the windows' other records are
    recomputed, not needed): its six int64 fields and, per plane, the
    reference line read (4s + unit int16), the source window read, the
    recon and the levels written (s*s int16 each); the four transform
    passes' multiply-adds (s a coefficient, two operations each) at the
    int32 rate."""
    from thevc_tpu_torch.encoder import fast_apply
    nbytes = ops = 0
    for (size, luma, _), n in zip(fast_apply.CLS, sched.counts):
        planes = 1 if luma else 2
        unit = 4 if luma else 2
        nbytes += n * (6 * 8 + planes * (2 * (4 * size + unit)
                                         + 3 * 2 * size * size))
        ops += n * planes * 4 * size * 2 * size * size
    return (nbytes, ops, *roofline(nbytes, ops, INT32_OPS))


def profiled_count(prof, *names) -> int:
    """The device activities of a ``torch.profiler`` run whose names start
    with or contain one of ``names``."""
    from torch.autograd import DeviceType
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and any(e.name().startswith(n) or n in e.name()
                       for n in names))


def apply_models(sched, latency_ms: dict) -> dict:
    """The recorded frame's apply time (ms) modelled from its schedule at
    each class's body latency (``latency_ms`` {class: ms}): ``chain``, a
    TU starting when the writers of the units under its range are done
    (``fast_apply.wait_units``, ``own_units``; luma and chroma apart, Cb
    and Cr alike), the frame kernel's rule; ``waves``, a frame-wide
    barrier a wave, its classes at once; ``class_steps``, each class step
    of each wave in turn (the class-step kernel's order)."""
    import numpy as np
    from thevc_tpu_torch.encoder import fast_apply
    # the unit grid: past the last unit any record writes
    uh = uw = 0
    for (size, luma, _), f, n in zip(fast_apply.CLS, sched.flat,
                                     sched.counts):
        if n:
            ox, oy = fast_apply.own_units(f[0][:n], f[1][:n], size, luma)
            uh, uw = max(uh, int(oy.max()) + 1), max(uw, int(ox.max()) + 1)
    finish = {True: np.zeros((uh, uw)), False: np.zeros((uh, uw))}
    waves_ms = steps_ms = 0.0
    for w in range(sched.n_waves):
        in_wave = []
        for ci, (size, luma, _) in enumerate(fast_apply.CLS):
            a, b = int(sched.offs[ci][w]), int(sched.offs[ci][w + 1])
            if a == b:
                continue
            in_wave.append(latency_ms[ci])
            xs, ys, lo, hi = (np.asarray(f[a:b]) for f in sched.flat[ci][:4])
            ux, uy, under = fast_apply.wait_units(xs, ys, lo, hi, size, luma)
            fin = finish[luma]
            dep = np.where(under, fin[uy.clip(0, uh - 1), ux.clip(0, uw - 1)],
                           0.0).max(axis=1)
            ox, oy = fast_apply.own_units(xs, ys, size, luma)
            fin[oy, ox] = (dep + latency_ms[ci])[:, None]
        waves_ms += max(in_wave)
        steps_ms += sum(in_wave)
    return {"chain_ms": max(float(f.max()) for f in finish.values()),
            "chain_luma_ms": float(finish[True].max()),
            "chain_chroma_ms": float(finish[False].max()),
            "waves_ms": waves_ms, "class_steps_ms": steps_ms}


def body_latencies(torch, args, kwargs) -> dict:
    """Each class's body latency on the card (ms): the frame kernel on a
    one-item list (the class's first record on its first plane, every
    ready flag set, the frame's tables), 50 launches in a CUDA graph,
    less the same of an empty list; the median of 5 replays each."""
    import numpy as np
    from thevc_tpu_torch.encoder import fast_apply
    from thevc_tpu_torch.ops import apply_kernel
    (org_y, org_cb, org_cr, sched, width, height, qp_y, qp_cb, qp_cr, ctu,
     bit_inc, max_val, sign_hide) = args
    use_rdoq = kwargs.get("use_rdoq", False)
    lam_y, lam_c = kwargs.get("lam_y", 1.0), kwargs.get("lam_c", 1.0)
    init = kwargs.get("init_ctx")
    dev = torch.device("cuda")
    wp = -(-width // ctu) * ctu
    hp = -(-height // ctu) * ctu
    g = fast_apply.GUARD
    recs = [torch.zeros((hp + 1 + g, wp + 1 + g), dtype=torch.int16,
                        device=dev)] + [
        torch.zeros((hp // 2 + 1 + g, wp // 2 + 1 + g), dtype=torch.int16,
                    device=dev) for _ in range(2)]
    orgs = [torch.from_numpy(np.ascontiguousarray(o, np.int16)).to(dev)
            for o in (org_y, org_cb, org_cr)]
    layout, n_lv = fast_apply.level_layout(sched)
    items = fast_apply.frame_items(sched, layout)
    lv = torch.zeros(n_lv, dtype=torch.int16, device=dev)
    ready = torch.ones((3, hp // 4, wp // 4), dtype=torch.int32, device=dev)
    state = torch.zeros(apply_kernel.STATE_WORDS, dtype=torch.int32,
                        device=dev)
    classes = sorted(set((items[:, 6] & 15).tolist()))
    tables = {ci: fast_apply.kernel_tables(ci, dev) for ci in classes}
    ebts = ({ci: fast_apply.est_bits_tensors(init, *fast_apply.CLS[ci][:2],
                                             dev) for ci in classes}
            if use_rdoq else None)
    qps, lams = (qp_y, qp_cb, qp_cr), (lam_y, lam_c, lam_c)

    def launcher(rows):
        it = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
        return lambda: apply_kernel.apply_frame(
            it, recs, orgs, lv, ready, state, tables, ebts, qps, lams,
            bit_inc, max_val, sign_hide)
    empty = graph_ms(torch, launcher(items[:0]), 50)
    out = {"empty_launch_ms": empty}
    for ci in classes:
        first = np.nonzero(items[:, 6] & 15 == ci)[0][0]
        out[ci] = graph_ms(torch, launcher(items[first:first + 1]), 50) \
            - empty
    return out


def devapply_frame_phase(torch, clip: Path, work: Path) -> dict:
    """One 1080p frame's apply in this process, from the encoder's own
    call, in both forms on ``cuda``: the frame kernel (one launch) and the
    plain form (``run_device_apply_plain``, graph-replayed class steps);
    for each, synchronised walls, the host's setup and issue time, the
    span in CUDA events and the device time under ``torch.profiler``;
    each class's body latency and the modelled critical path.  The
    kernel apply equals the plain form on ``cuda`` and on the CPU (recon
    and every level stack, tolerance 0); the frame's bound."""
    import numpy as np
    from thevc_tpu_torch.encoder import fast_apply
    from thevc_tpu_torch.ops import apply_kernel, residual_kernel
    args, kwargs = recorded_apply_call(clip, work)
    sched = args[3]
    steps = {ci: int((np.diff(o) > 0).sum()) for ci, o in enumerate(
        sched.offs)}
    n_steps = sum(steps.values())
    check(kwargs.get("use_rdoq"), "the recorded apply runs without RDOQ")

    def run(plain=False, device="cuda"):
        fn = fast_apply.run_device_apply_plain if plain \
            else fast_apply.run_device_apply
        r = fn(*args, **dict(kwargs, device=device))
        return r, fast_apply.collect_device_apply(r)

    def timed(plain, reps):
        walls, setup, issue, loop, waited, out = [], [], [], [], [], None
        for _ in range(reps):
            counts = (apply_kernel.launches, residual_kernel.launches)
            torch.cuda.synchronize()
            t = time.perf_counter()
            r, out = run(plain)
            walls.append(time.perf_counter() - t)
            setup.append(r.setup_s)
            issue.append(r.issue_s)
            loop.append(r.loop_events[0].elapsed_time(r.loop_events[1]))
            got = (apply_kernel.launches - counts[0],
                   residual_kernel.launches - counts[1])
            want = (0, None) if plain else (1, 0)
            check(got[0] == want[0] and (want[1] is None
                                         or got[1] == want[1]),
                  f"{got} apply and K1 launches counted for the "
                  f"{'plain' if plain else 'kernel'} apply, {want} "
                  "expected")
            if not plain:
                _ticket, error, n_waited = r.state.tolist()
                check(error == 0, f"the frame kernel's error word is {error}")
                waited.append(n_waited)
        return dict(wall_ms=[1000 * w for w in walls],
                    median_wall_ms=1000 * sorted(walls)[len(walls) // 2],
                    setup_ms=[1000 * v for v in setup],
                    issue_ms=[1000 * v for v in issue],
                    loop_span_ms=loop, items_that_waited=waited), out

    def profiled(plain):
        # the device's own time, device activities only
        from torch.profiler import ProfilerActivity, profile
        t_read = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            r, _out = run(plain)
            wall = time.perf_counter() - t
        device_us, n_kernels, top = profiled_device(prof)
        copies = profiled_count(prof, "Memcpy", "Memset")
        frames = profiled_count(prof, "apply_frame")
        frame_us = sum(e.duration_ns() / 1000 if hasattr(e, "duration_ns")
                       else e.duration_us()
                       for e in prof.profiler.kineto_results.events()
                       if "apply_frame" in e.name())
        del prof
        return dict(profiled_wall_ms=1000 * wall,
                    profile_read_s=time.perf_counter() - t_read,
                    device_ms=device_us / 1000, device_kernels=n_kernels,
                    device_copies=copies, apply_frame_kernels=frames,
                    apply_frame_ms=frame_us / 1000,
                    profiled_span_ms=r.loop_events[0].elapsed_time(
                        r.loop_events[1]),
                    kernels_per_class_step=(n_kernels - copies) / n_steps,
                    top_kernels_ms=top,
                    device_busy_share=device_us / 1e6 / wall)

    def max_err(a, b):
        err = 0
        for g, e in zip(a[:3] + a[3] + a[4], b[:3] + b[3] + b[4]):
            if g is not None:
                err = max(err, int(np.abs(g.astype(np.int32)
                                          - e.astype(np.int32)).max()))
        return err

    run()                                   # warm-up
    kernel, kernel_out = timed(False, 3)
    kernel.update(profiled(False))
    check(kernel["apply_frame_kernels"] == 1,
          f"{kernel['apply_frame_kernels']} apply kernels on the device for "
          f"one frame (the profiler saw {kernel['device_kernels']} device "
          f"activities: {kernel['top_kernels_ms']})")
    latency = body_latencies(torch, args, kwargs)
    models = apply_models(sched, latency)
    # the kernel's numbers before the plain form's runs
    print("fastrd_devapply_frame_kernel " + json.dumps(dict(
        kernel=kernel, body_latency_ms={
            str(k): v for k, v in latency.items()}, modelled_ms=models)))
    plain, plain_out = timed(True, 1)
    plain.update(profiled(True))
    t = time.perf_counter()
    _r, cpu_out = run(True, "cpu")
    cpu_wall = time.perf_counter() - t
    errs = dict(kernel_vs_plain=max_err(kernel_out, plain_out),
                kernel_vs_cpu=max_err(kernel_out, cpu_out),
                plain_vs_cpu=max_err(plain_out, cpu_out))
    check(not any(errs.values()), f"the kernel apply differs: {errs}")
    nbytes, ops, bound_ms, bound_by = apply_bound(sched)
    items = fast_apply.frame_items(sched, fast_apply.level_layout(sched)[0])
    out = dict(
        waves=sched.n_waves, class_steps=n_steps,
        class_steps_by_class={str(fast_apply.CLS[ci][:2]): n
                              for ci, n in steps.items()},
        caps=list(sched.caps), records=list(sched.counts),
        items=len(items), real_items=int(((items[:, 6] >> 6) & 1).sum()),
        grid=apply_kernel.grid(), kernel=kernel,
        body_latency_ms={str(fast_apply.CLS[ci][:2]) if ci in steps
                         else ci: v for ci, v in latency.items()},
        modelled_ms=models, plain=plain, cpu_plain_wall_s=cpu_wall,
        apply_launches=1, max_abs_err=errs,
        bytes=nbytes, ops=ops, bound_ms=bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / max(
            sorted(kernel["loop_span_ms"])[1], 1e-9))
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
        rc, log, filters_launches = decode_filtered(torch, stream, dec_rec)
        check_decode(rc, log, frames, dec_rec, enc_rec, stream.name)
        out[name] = {"frames": frames, "residual": residual_kernel.launches,
                     "filters": filters_launches,
                     "bytes": stream.stat().st_size}
        check(out[name]["residual"] > 0 and filters_launches > 0,
              f"the {name} decode skipped K1 or the filter kernel")
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
        for path, k in (("encode", "intra_sweep"), ("encode", "tu_rd"),
                        ("decode", "residual"), ("decode", "filters")):
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
        "satd": sum(s["launches"]["encode"]["satd"] for s in slots),
        "intra_sweep": sum(s["launches"]["encode"]["intra_sweep"]
                           for s in slots),
        "tu_rd": sum(s["launches"]["encode"]["tu_rd"] for s in slots),
        "filters": sum(s["launches"]["decode"]["filters"] for s in slots)}
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
        rc, log, filters_launches = decode_filtered(torch, stream, dec_rec)
        check_decode(rc, log, frames, dec_rec, enc_rec, stream.name)
        tools[name] = {"frames": frames, "residual": residual_kernel.launches,
                       "filters": filters_launches,
                       "bytes": stream.stat().st_size}
        check(tools[name]["residual"] > 0, f"the {name} decode skipped K1")
        # the filters-off stream turns deblocking and SAO off: no launch
        check((filters_launches > 0) == (name != "tool_nofilt"),
              f"the {name} decode made {filters_launches} filter launches")
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
    then the clean stream on ``cuda``.  The K1 and MC kernel launches are
    those of the ``cuda`` decodes, which call the plain MC never."""
    from thevc_tpu_torch import streams
    from thevc_tpu_torch.decoder import inter
    from thevc_tpu_torch.ops import filters_kernel, mc, mc_kernel, \
        residual_kernel
    t0 = time.perf_counter()
    made = streams.robust_streams(work / "robust")
    out = {"streams_wall_s": time.perf_counter() - t0, "cases": {}}
    launched = {"residual": 0, "mc": 0, "filters": 0}

    def on_card(decode, *args, **kw):
        """``decode(*args, **kw)``, its K1, MC and filter kernel launches
        added to ``launched``; it must call the plain MC never."""
        r0, m0, p0 = residual_kernel.launches, mc_kernel.launches, \
            mc.launches
        f0 = filters_kernel.launches
        res = decode(*args, **kw)
        launched["residual"] += residual_kernel.launches - r0
        launched["mc"] += mc_kernel.launches - m0
        launched["filters"] += filters_kernel.launches - f0
        check(mc.launches == p0, f"a cuda decode ran the plain MC "
              f"{mc.launches - p0} times")
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
    check(all(out["launches"].values()),
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
    from thevc_tpu_torch.ops import apply_kernel, filters_kernel, \
        intra_rd_kernel, mc_kernel
    from thevc_tpu_torch.tools import fastrd_quality, run_encoder
    out = {}
    mc_kernel.launches = 0
    mc_kernel.blocks_launches = mc_kernel.qpel_launches = 0
    filters_kernel.launches = apply_kernel.launches = 0
    zero_intra_counts()
    zero_inter_me_counts()

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
                  and rep["device_apply_fallback_frames"] == 0
                  and rep["apply_launches"] == frames,
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
                "device_apply_wall_s", "apply_launches")})
        out["rc"][name] = row
        print(f"resume_rc_rc_{name} " + json.dumps(row))

    # (c) fast-RD quality against the exact path on cuda
    t = time.perf_counter()
    rows = fastrd_quality.sweep(clip, w, h, QUALITY_FRAMES, QUALITY_QPS,
                                "cuda")
    out["quality"] = {"rows": rows, "wall_s": time.perf_counter() - t}
    for row in rows:
        print("resume_rc_quality " + fastrd_quality.format_row(row))
    counts = intra_counts()
    out["launches"] = {"residual": counts["residual"],
                       "satd": counts["satd"],
                       "mc": mc_kernel.launches,
                       "mc_blocks": mc_kernel.blocks_launches,
                       "mc_qpel": mc_kernel.qpel_launches,
                       "filters": filters_kernel.launches,
                       "apply": apply_kernel.launches,
                       "intra_sweep": counts["intra_sweep"],
                       "tu_rd": intra_rd_kernel.tu_rd_launches(),
                       **{k: counts[k] for k in SELECT_KERNELS},
                       **inter_me_counts()}
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


def sum_rows(rows: list) -> dict:
    """A kernel's calls summed for the kernels line: eager, graph and
    plain ms, bound, and what bounds them all; the int32-only bound
    where the rows have it, and ``library_ms`` where every row has one
    (else null)."""
    keys = ("ms", "graph_ms", "plain_ms", "bound_ms", "int32_bound_ms")
    out = {k: sum(r[k] for r in rows) for k in keys
           if all(k in r for r in rows)}
    out["calls"] = len(rows)
    out["bound_by"] = "bytes" if all(r["bound_by"] == "bytes"
                                     for r in rows) else "operations"
    out["library_ms"] = sum(r["library_ms"] for r in rows) if rows and all(
        r.get("library_ms") is not None for r in rows) else None
    return out


def build_report(lib: Path) -> dict:
    """Per kernel instance of a built library of the intra decision
    kernels (``intra_rd``, ``intra_select``) or of the motion-search
    kernels: registers, stack frame, spill stores and loads and shared
    memory (its ptxas log) and, where ``cuobjdump`` is in the toolkit,
    its SASS instructions in all and by kind (``sass_local``:
    local-memory loads and stores), and its loops' lengths
    (``sass_loops``: the instructions between each backward branch and
    its target, the three longest); per sample: a sweep's main loop (its
    longest backward branch) over the samples a thread predicts in one
    turn of it (16, two modes a step), a TU-RD kernel's instructions
    over the coefficients a thread takes (8, 32 at 32x32; a quadrant
    loop counted once)."""
    import re
    import shutil
    names = {"sweep_kernel": "sweep", "tu_rd_kernel": "tu_rd",
             "coarse_kernel": "coarse", "int_refine_kernel": "int_refine",
             "merge_model_kernel": "merge_model",
             "qpel_pick_kernel": "qpel_pick", "bi_pick_kernel": "bi_pick",
             "select_kernel": "select", "pick_kernel": "pick",
             "dp_kernel": "dp"}

    def short(mangled):
        for key, label in names.items():
            m = re.search(key + r"(?:I((?:Li-?\d+E)+)E)?", mangled)
            if m:
                if not m.group(1):
                    return label
                args = re.findall(r"Li(-?\d+)E", m.group(1))
                return label + "<" + ",".join(args) + ">"
        return None
    out: dict = {}
    cur = None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = short(m.group(1))
            if cur:
                out[cur] = {}
            continue
        if not cur:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack_frame=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[cur]["smem_bytes"] = int(sm.group(1)) if sm else 0
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return out
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    kinds = {"mma": ("IMMA", "HMMA"), "movmatrix": ("MOVM",),
             "shfl": ("SHFL",), "redux": ("REDUX",),
             "shared": ("LDS", "STS", "ATOMS"), "global": ("LDG", "STG"),
             "float": ("FFMA", "FADD", "FMUL", "FMNMX"),
             "prmt": ("PRMT",), "barrier": ("BAR",),
             "local": ("LDL", "STL")}
    line_re = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z0-9_]+)[^;]*?(?:0x([0-9a-f]+))?\s*;")
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        label = short(part.split()[0])
        if not label or label not in out:
            continue
        ins = [(int(m.group(1), 16), m.group(2), m.group(3))
               for m in line_re.finditer(part) if m.group(2) != "NOP"]
        info = out[label]
        info["sass"] = len(ins)
        for kind, prefixes in kinds.items():
            info[f"sass_{kind}"] = sum(o.startswith(prefixes)
                                       for _, o, _ in ins)
        spans = sorted((sum(1 for a, _, _ in ins if int(t, 16) <= a <= addr)
                        for addr, o, t in ins
                        if o == "BRA" and t and int(t, 16) < addr),
                       reverse=True)
        info["sass_loops"] = spans[:3]
        if label.startswith("sweep"):
            info["sass_loop"] = spans[0] if spans else len(ins)
            info["sass_per_sample"] = info["sass_loop"] / 16
        elif label.startswith("tu_rd"):
            size = int(label.split("<")[1].split(",")[0].rstrip(">"))
            info["sass_per_sample"] = len(ins) / (32 if size == 32 else 8)
    return out


def check_parent_stream(name: str, stream: Path) -> None:
    """The 1080p fast-RD stream ``name`` must be the one the port wrote
    before its intra decision kernels (``PARENT_STREAMS``): the kernels
    move no decision."""
    import hashlib
    data = stream.read_bytes()
    got = (len(data), hashlib.sha256(data).hexdigest())
    check(got == PARENT_STREAMS[name],
          f"the {name} fast-RD stream is {got}, the parent's "
          f"{PARENT_STREAMS[name]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--profile-i-pass"]:
        print(json.dumps(profile_i_pass(sys.argv[2])))
        return 0
    from thevc_tpu_torch.ops import apply_kernel, build, filters_kernel, \
        inter_me_kernel, intra_rd_kernel, intra_select_kernel, mc_kernel, \
        residual_kernel, satd, satd_kernel, tq

    print(gpu_line())
    t0 = time.perf_counter()
    kernels = (residual_kernel, satd_kernel, mc_kernel, filters_kernel,
               apply_kernel, intra_rd_kernel, inter_me_kernel,
               intra_select_kernel)
    with ThreadPoolExecutor(len(kernels)) as ex:
        list(ex.map(build.compile_source, [k.NAME for k in kernels]))
    for k in kernels:
        k.build()
    print(f"build: {len(kernels)} kernels in "
          f"{time.perf_counter() - t0:.3f} s")
    for k in kernels:
        print(build.library_path(k.NAME).with_suffix(".log").read_text()
              .strip())
    print("intra_rd_build " + json.dumps(
        build_report(build.library_path(intra_rd_kernel.NAME))))
    inter_me_build = build_report(build.library_path(inter_me_kernel.NAME))
    print("inter_me_build " + json.dumps(inter_me_build))
    # the picks keep their costs and counts in registers
    for name in ("qpel_pick", "bi_pick"):
        info = inter_me_build.get(name, {})
        check(info.get("stack_frame") == 0 and info.get("spill_stores") == 0
              and info.get("spill_loads") == 0,
              f"the {name} kernel has a stack frame or spills: {info}")
    select_build = build_report(build.library_path(intra_select_kernel.NAME))
    print("intra_select_build " + json.dumps(select_build))
    # the select's top 3 and the pick's order live in registers
    for name in ("select", "pick"):
        info = select_build.get(name, {})
        check(info.get("stack_frame") == 0 and info.get("spill_stores") == 0
              and info.get("spill_loads") == 0,
              f"the {name} kernel has a stack frame or spills: {info}")

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    walls = {"build": time.perf_counter() - t0}

    def phase(fn, *a):
        """``fn(*a)``, its wall kept under its name for ``phase_walls``."""
        t = time.perf_counter()
        out = fn(*a)
        walls[fn.__name__] = time.perf_counter() - t
        return out
    made = phase(prepare_streams, work)
    kern = phase(kernel_phase, torch, tq, SEED)
    k2 = phase(satd_phase, torch, satd, SEED)
    dec = phase(decode_phase, torch, work, made)
    fast = phase(fastrd_phase, torch, work, dec)
    phase(identity_phase, work)
    devapply = phase(fastrd_devapply_phase, torch, work, dec, fast)
    nxn = phase(nxn_apply_phase, torch)
    inter = phase(inter_decode_phase, torch, work, made)
    filt = phase(filters_phase, torch, work, made)
    small = phase(small_inter_phase, torch, work, made)
    fast_inter = phase(fastrd_inter_phase, torch, work, made)
    phase(inter_identity_phase, work, made)
    wp_sl = phase(wp_scaling_phase, torch, work, made)
    parts = phase(partitioned_phase, torch, work, made)
    multi = phase(multistream_phase, torch, work, made)
    robust = phase(robust_decode_phase, torch, work)
    resume = phase(resume_rc_phase, torch, work)
    # last: run before the device-apply phase (on an H100), this phase
    # left that phase's profiler session without its apply kernel
    i_pass = phase(intra_pass_phase, torch, Path(dec["clip"]), work)
    walls["total"] = time.perf_counter() - t0
    # each phase's wall in s, the kernels' build first: where the time
    # limit goes
    print("phase_walls " + json.dumps(walls))
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
    # the MC kernel's time: a picture of the 1080p low-delay B decode (the
    # mean over its B pictures; no single PyTorch call takes per-PU-phase
    # 8-tap interpolation with the int16 wrap, so library_ms is null); its
    # quarter-pel entry's: the replayed B frame's 8 calls summed
    pics = inter["mc_pictures"]
    qpel_calls = fast_inter["pass"]["mc_rows"]
    # the blocks entry's: the replayed B frame's calls summed
    blocks = fast_inter["pass"]["mc_blocks"]
    by_path = {
        "intra_decode": {"residual": dec["residual_kernel_launches"],
                         "filters": dec["filters_kernel_launches"]},
        "fastrd_encode": {"residual": fast["residual_launches"],
                          "satd": fast["satd_launches"],
                          "intra_sweep": fast["intra_sweep_launches"],
                          "tu_rd": fast["tu_rd_launches"],
                          **{k: fast[k] for k in SELECT_KERNELS}},
        "fastrd_intra_pass": {
            "intra_sweep": i_pass["launches"]["kernel"]["intra_sweep"],
            "tu_rd": i_pass["launches"]["kernel"]["tu_rd_intra"],
            **{k: i_pass["launches"]["kernel"][k] for k in SELECT_KERNELS}},
        "fastrd_decode": {"filters": fast["decode_filters_launches"]},
        "fastrd_inter_encode": {"residual": fast_inter["residual_launches"],
                                "satd": fast_inter["satd_launches"],
                                "intra_sweep":
                                fast_inter["intra_sweep_launches"],
                                "tu_rd": fast_inter["tu_rd_launches"],
                                **{k: fast_inter[k]
                                   for k in SELECT_KERNELS}},
        "fastrd_inter_decode": {
            "filters": fast_inter["decode_filters_launches"]},
        "fastrd_devapply_encode": {"residual": devapply["residual_launches"],
                                   "satd": devapply["satd_launches"],
                                   "intra_sweep":
                                   devapply["intra_sweep_launches"],
                                   "tu_rd": devapply["tu_rd_launches"],
                                   **{k: devapply[k]
                                      for k in SELECT_KERNELS},
                                   "apply": devapply["apply_launches"]},
        "fastrd_devapply_decode": {
            "filters": devapply["decode_filters_launches"]},
        "fastrd_devapply_nxn": {"apply": nxn["apply_launches"]},
        **{f"{k}_decode": {"residual": v["residual"],
                           "filters": v["filters"]}
           for k, v in parts.items()},
        "graft_entry": {"residual": multi["entry"]["residual"]},
        "multistream_dryrun": multi["dryrun"]["launches"],
        **{f"{k}_decode": {"residual": v["residual"],
                           "filters": v["filters"]}
           for k, v in multi["tools"].items()},
        "robust_decode": robust["launches_with_fuzz"],
        "resume_rc": resume["launches"],
        "inter_decode": inter["launches"],
        **{f"inter_decode_{k}": v for k, v in small.items()},
        **{f"{k}_decode": {"residual": v["residual"], "mc": v["mc"],
                           "filters": v["filters"]}
           for k, v in wp_sl.items()}}
    # the filter kernel, one launch a call (deblocking V + H and SAO of a
    # tile in shared memory), so its launches are the decodes' filter
    # calls; its time: the all-intra decode's call of its 8 pictures (the
    # main path's own data; no PyTorch call deblocks or applies SAO, so
    # library_ms is null)
    by_path["fastrd_inter_encode"].update(
        mc_blocks=fast_inter["mc_blocks_launches"],
        mc_qpel=fast_inter["mc_qpel_launches"],
        **{k: fast_inter[f"{k}_launches"] for k in INTER_ME})
    # the replayed B frame's timed runs (the same counts each)
    by_path["fastrd_inter_pass"] = {
        k: fast_inter["pass"]["launches"][k]
        for k in INTER_ME + SELECT_KERNELS}
    print("launches by path " + json.dumps(by_path))
    # the apply kernel, one launch a frame; its times: the recorded 1080p
    # frame's launch span in CUDA events (``ms``, the median of three; the
    # item list and source planes go up before it), the kernel's own
    # device time, and the plain form's graph-replayed span of the same
    # frame (no PyTorch call does HM's intra TU apply, so library_ms is
    # null)
    frame_apply = devapply["frame"]
    # the motion-search and pick kernels' times: the replayed 1080p B
    # frame's calls summed (2 coarse searches, 8 refinements, 8
    # quarter-pel picks, 8 merge models, one bi pick; no single PyTorch
    # call runs a full search with an MV prior, a first-minimum refinement
    # or pick, HM's interpolation inside an SSE or the direction select on
    # the minimum as computed, so library_ms is null)
    inter_me8 = fast_inter["pass"]["inter_me"]["8bit"]
    # the intra decision kernels' times: the replayed 1080p I frame's
    # calls summed (5 sweeps; 10 TU-RD launches, the luma top-3 of each
    # class and the Cb/Cr candidates of each chroma class; no single
    # PyTorch call predicts HM's intra modes or runs its transform,
    # quantiser and recon, so library_ms is null); the select, pick and
    # DP kernels' the same frame's calls (one each): the select's
    # library_ms is one torch.topk(cost, 3, largest=False) on every
    # class's costs in one tensor (the port never calls it: it does not
    # promise the tie order); no single PyTorch call makes the pick (a
    # first-minimum RD pick with its runners-up and the chroma ids) or
    # the DP (the chroma picks, a quadtree DP and its expansion), so
    # theirs is null
    print(json.dumps({"kernels": [{
        "name": "residual", "route": "cuda",
        "source": "thevc_tpu_torch/csrc/residual.cu",
        "replaces": "thevc_tpu/ops/jx_pallas.py:141",
        "launches": sum(p.get("residual", 0) for p in by_path.values()),
        "max_abs_err": max(kern["max_abs_err"], classes["max_abs_err"]),
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
        "library_ms": None}, {
        "name": "mc", "route": "cuda",
        "source": "thevc_tpu_torch/csrc/mc.cu",
        "replaces": "thevc_tpu/ops/jx_mc.py:77",
        "launches": sum(p.get("mc", 0) for p in by_path.values()),
        "max_abs_err": pics["max_abs_err"],
        "ms": pics["mean"]["ms"], "plain_ms": pics["mean"]["plain_ms"],
        "bound_ms": pics["mean"]["bound_ms"],
        "bound_by": pics["mean"]["bound_by"],
        "library_ms": None}, {
        "name": "mc_blocks", "route": "cuda",
        "source": "thevc_tpu_torch/csrc/mc.cu",
        "replaces": "thevc_tpu/ops/jx_mc.py:77 and :107 "
                    "(thevc_tpu/encoder/fast_inter.py:326, 352, 448-461, "
                    "511-513)",
        "launches": sum(p.get("mc_blocks", 0) for p in by_path.values()),
        "max_abs_err": blocks["max_abs_err"],
        "ms": blocks["ms"], "graph_ms": blocks["graph_ms"],
        "plain_ms": blocks["plain_ms"], "bound_ms": blocks["bound_ms"],
        "bound_by": blocks["bound_by"], "library_ms": None}, {
        "name": "mc_qpel", "route": "cuda",
        "source": "thevc_tpu_torch/csrc/mc.cu",
        "replaces": "thevc_tpu/ops/jx_mc.py:77 "
                    "(thevc_tpu/encoder/fast_inter.py:270-300)",
        "launches": sum(p.get("mc_qpel", 0) for p in by_path.values()),
        "max_abs_err": fast_inter["pass"]["max_abs_err"]["mc_qpel"],
        "ms": sum(r["ms"] for r in qpel_calls),
        "plain_ms": sum(r["plain_ms"] for r in qpel_calls),
        "bound_ms": sum(r["bound_ms"] for r in qpel_calls),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                   for r in qpel_calls) else "operations",
        "library_ms": None}, {
        "name": "filters", "route": "cuda",
        "source": "thevc_tpu_torch/csrc/filters.cu",
        "replaces": "thevc_tpu/ops/jx_filters.py:273",
        "launches": sum(p.get("filters", 0) for p in by_path.values()),
        "max_abs_err": filt["max_abs_err"],
        "ms": filt["intra"]["ms"], "graph_ms": filt["intra"]["graph_ms"],
        "plain_ms": filt["intra"]["plain_ms"],
        "bound_ms": filt["intra"]["bound_ms"],
        "bound_by": filt["intra"]["bound_by"], "library_ms": None}, {
        "name": "apply_frame", "route": "cuda",
        "source": "thevc_tpu_torch/csrc/apply.cu",
        "replaces": "thevc_tpu/encoder/fast_apply.py:729",
        "launches": sum(p.get("apply", 0) for p in by_path.values()),
        "max_abs_err": max(frame_apply["max_abs_err"].values()),
        "ms": sorted(frame_apply["kernel"]["loop_span_ms"])[1],
        "device_ms": frame_apply["kernel"]["apply_frame_ms"],
        "plain_ms": frame_apply["plain"]["loop_span_ms"][0],
        "bound_ms": frame_apply["bound_ms"],
        "bound_by": frame_apply["bound_by"], "library_ms": None}, {
        "name": "intra_sweep", "route": "cuda",
        "source": "thevc_tpu_torch/csrc/intra_rd.cu",
        "replaces": "thevc_tpu/encoder/fast_intra.py:404 (the SATD: "
                    "thevc_tpu/ops/jx_pallas.py:63)",
        "launches": sum(p.get("intra_sweep", 0) for p in by_path.values()),
        "max_abs_err": max(i_pass["max_abs_err"],
                           fast_inter["pass"]["max_abs_err"]["intra_rd"]),
        **sum_rows(i_pass["rows"]["sweep"])}, {
        "name": "tu_rd", "route": "cuda",
        "source": "thevc_tpu_torch/csrc/intra_rd.cu",
        "replaces": "thevc_tpu/encoder/fast_intra.py:338 (with "
                    "thevc_tpu/ops/jx.py:62, :113 and "
                    "thevc_tpu/ops/jx_pallas.py:141)",
        "launches": sum(p.get("tu_rd", 0) for p in by_path.values()),
        "max_abs_err": max(i_pass["max_abs_err"],
                           fast_inter["pass"]["max_abs_err"]["intra_rd"]),
        **sum_rows(i_pass["rows"]["tu_rd_intra"])}, *({
        "name": name, "route": "cuda",
        "source": "thevc_tpu_torch/csrc/intra_select.cu",
        "replaces": SELECT_REPLACES[name],
        "launches": sum(p.get(name, 0) for p in by_path.values()),
        "max_abs_err": max(i_pass["max_abs_err"],
                           fast_inter["pass"]["max_abs_err"]["intra_rd"]),
        **sum_rows(i_pass["rows"][entry])}
        for name, entry in zip(SELECT_KERNELS, ("select", "pick", "dp"))),
        *({
        "name": name, "route": "cuda",
        "source": "thevc_tpu_torch/csrc/inter_me.cu",
        "replaces": INTER_ME_REPLACES[name],
        "launches": sum(p.get(name, 0) for p in by_path.values()),
        "max_abs_err": fast_inter["pass"]["max_abs_err"]["inter_me"],
        **{k: inter_me8[name][k] for k in (
            "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}} for name in INTER_ME)]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
