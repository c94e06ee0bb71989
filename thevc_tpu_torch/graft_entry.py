"""Entry points of the port: a one-card step and a multi-stream
dry run.

Counterpart of ``__graft_entry__.py``.  ``entry`` returns the codec's
device hot path as a step over a TU batch: dequant, inverse DCT, add and
clip of 256 8x8 TUs (``ops.tq.tu_recon_pipeline``; on a CUDA device the
residual kernel's dense entry).

``dryrun_multichip`` is the data-parallel codec over a process group, one
process a slot (``torch.multiprocessing`` with the ``spawn`` method and a
``file://`` rendezvous, so no port is opened).  Each slot, on its own
``torch.device``:

1. encodes its own 48x48 clip frame by frame with the port's fast-RD
   encoder, every frame's QP drawn from the SHARED bit pool
   (``parallel.shared_rc.MeshRatePool``: one all-reduce of the spent
   bits a frame), and checks that the collective steers rate control:
   the frame-1 QPs of the group must differ from those of pools that see
   only their own slot's spend;
2. decodes its own stream with every picture digest OK;
3. takes part in a frame-sharded decode of slot 0's stream: slot i
   decodes access units i, i + n, ... with the parameter sets, and the
   decoded counts, all-reduced, must cover every frame.

Backends: ``nccl`` needs one distinct CUDA card a slot; ``gloo`` takes
any devices, several slots on one card included (its collective then
runs between processes on the host).  Nothing switches backend or
device on its own: a layout a backend cannot take raises.

Run: ``python -m thevc_tpu_torch.graft_entry --slots 8 --backend gloo
--device cuda`` (``--device cpu`` runs on the host; ``--backend nccl``,
the default, gives slot i ``cuda:i``).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .ops import tq
from .ops.device import resolve
from .streams import INTRA_CFG

N_TUS, TU_SIZE, ENTRY_QP = 256, 8, 32     # one 1080p frame row of 8x8 TUs
# the dry run's clips: 2 frames of 48x48 a slot, 12000 bits a slot-frame
CLIP_W = CLIP_H = 48
N_FRAMES = 2
BITS_PER_SLOT_FRAME = 12000
ALLREDUCE_ITERS = 20
GROUP_TIMEOUT = timedelta(seconds=600)


def entry(device="cuda"):
    """Return (step, example_args): a forward step on the codec's device
    hot path, a fused dequant + inverse transform + reconstruction over
    a TU batch, with its inputs on ``device``."""
    dev = resolve(device)

    def step(pred, qcoeff, qp):
        return tq.tu_recon_pipeline(pred, qcoeff, qp, use_dst=False,
                                    bit_increment=0, max_val=255)

    rng = np.random.RandomState(0)
    shape = (N_TUS, TU_SIZE, TU_SIZE)
    pred = torch.from_numpy(rng.randint(0, 255, shape).astype(np.int32))
    qcoeff = torch.from_numpy(rng.randint(-50, 50, shape).astype(np.int32))
    qp = torch.full((N_TUS,), ENTRY_QP, dtype=torch.int32)
    return step, (pred.to(dev), qcoeff.to(dev), qp.to(dev))


def check_layout(n_slots: int, backend: str, devices) -> list:
    """The slots' devices as ``torch.device``s, chosen before any tensor
    is made.  Raises when the backend cannot take this layout."""
    if n_slots < 2:
        raise ValueError(f"{n_slots} slot(s): the steering check needs at "
                         "least 2 slots")
    if len(devices) != n_slots:
        raise ValueError(f"{len(devices)} devices for {n_slots} slots")
    if backend == "nccl":
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if found < n_slots:
            raise RuntimeError(
                f"backend nccl needs {n_slots} CUDA cards, one a slot; found "
                f"{found} (NCCL takes no two ranks on one card: use "
                "--backend gloo to share a card)")
        devs = [resolve(d) for d in devices]
        if any(d.type != "cuda" for d in devs) or \
                len({d.index for d in devs}) != n_slots or \
                any(d.index is None or d.index >= found for d in devs):
            raise ValueError(f"backend nccl needs {n_slots} distinct CUDA "
                             f"devices cuda:0..cuda:{found - 1}; got "
                             f"{[str(d) for d in devs]}")
        return devs
    if backend == "gloo":
        return [resolve(d) for d in devices]
    raise ValueError(f"unsupported backend {backend}: expected nccl or gloo")


def make_clips(n_slots: int) -> list:
    """The dry run's n 4:2:0 clips (``__graft_entry__.py:133-147``): one
    seeded sequence drawn in slot order."""
    w, h = CLIP_W, CLIP_H
    rng = np.random.RandomState(7)
    clips = []
    for i in range(n_slots):
        yy, xx = np.mgrid[0:h, 0:w]
        planes = []
        for k in range(N_FRAMES):
            y = ((xx * (3 + i) + yy * (2 + k)
                  + rng.randint(0, 25 + 60 * i, (h, w)))
                 % 220 + 16).astype(np.uint8)
            cb = np.full((h // 2, w // 2), 120 + i, np.uint8)
            cr = np.full((h // 2, w // 2), 124 - i, np.uint8)
            planes.append(y.tobytes() + cb.tobytes() + cr.tobytes())
        clips.append(b"".join(planes))
    return clips


def base_qp(slot: int) -> int:
    return 26 + slot % 4


def local_qps(spent_f0) -> list:
    """Frame-1 QPs of pools that each see only their own slot's frame-0
    spend: the per-slot budget split evenly, the same QP-delta rule
    (``__graft_entry__.py:190-198``)."""
    per_slot_budget = N_FRAMES * BITS_PER_SLOT_FRAME
    out = []
    for i, s in enumerate(np.asarray(spent_f0, np.float64)):
        target = max(0.0, per_slot_budget - s) / (N_FRAMES - 1)
        ratio = s / max(1.0, target)
        d = 2 if ratio > 1.25 else 1 if ratio > 1.05 else \
            -2 if ratio < 0.8 else -1 if ratio < 0.95 else 0
        out.append(min(51, max(0, base_qp(i) + d)))
    return out


def _foreign_modules() -> list:
    return sorted(m for m in sys.modules
                  if m in ("jax", "thevc_tpu") or m.startswith("jax.")
                  or m.startswith("thevc_tpu."))


def _launches() -> dict:
    from .ops import filters_kernel, intra_rd_kernel, residual_kernel, \
        satd_kernel
    return {"residual": residual_kernel.launches,
            "satd": satd_kernel.launches,
            "intra_sweep": intra_rd_kernel.sweep_launches,
            "tu_rd": intra_rd_kernel.tu_rd_launches(),
            "filters": filters_kernel.launches}


def _split_access_units(stream: bytes) -> tuple:
    """(parameter-set and SEI NALs, access units of slice NALs) of an
    all-intra stream, as ``__graft_entry__.py:215-226`` splits it."""
    from .nal import iter_annexb_nals
    nals = list(iter_annexb_nals(stream))
    hdr = [(u.nal_type, u.temporal_id, u.rbsp) for u in nals
           if u.nal_type >= 25 and u.nal_type != 31]
    aus, cur = [], []
    for u in nals:
        if u.nal_type >= 25 and u.nal_type != 31:
            continue
        cur.append((u.nal_type, u.temporal_id, u.rbsp))
        if u.nal_type < 25:        # the slice NAL closes the AU
            aus.append(cur)
            cur = []
    return hdr, aus


def _decode(dev: torch.device, data: bytes, what: str) -> list:
    from .decoder.top import Decoder
    pics = Decoder(dev).decode_stream(data)
    if any(p.digest_ok is not True for p in pics):
        raise AssertionError(f"{what}: decode not digest-exact")
    return pics


def _slot(rank: int, n: int, dev: torch.device, clip: str,
          work: Path) -> dict:
    """One slot's share of the dry run, inside an initialised group."""
    from .apps.encoder import main as encoder_main
    from .nal import write_annexb
    from .parallel.shared_rc import MeshRatePool

    pool = MeshRatePool(total_bits=n * N_FRAMES * BITS_PER_SLOT_FRAME,
                        n_frames=N_FRAMES)
    qp, spent, stream = base_qp(rank), 0, b""
    qps, spents, encode_s, pool_s = [], [], [], []
    for k in range(N_FRAMES):
        qps.append(qp)
        out = work / f"s{rank}_{k}.bin"
        t0 = time.perf_counter()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            rc = encoder_main([
                "-c", str(INTRA_CFG), "-i", clip,
                "-wdt", str(CLIP_W), "-hgt", str(CLIP_H),
                "-f", "1", "-fr", "30", f"--FrameSkip={k}", "-q", str(qp),
                "-b", str(out), "-o", os.devnull,
                "--FastRD=1", "--SEIpictureDigest=1", "--device", str(dev)])
        if rc != 0:
            raise RuntimeError(f"slot {rank} frame {k}: encoder exited "
                               f"{rc}:\n{log.getvalue()[-2000:]}")
        encode_s.append(time.perf_counter() - t0)
        data = out.read_bytes()
        stream += data              # IDR AUs concatenate legally
        spent += 8 * len(data)
        spents.append(spent)
        if k + 1 < N_FRAMES:
            # the one collective: every slot's next QP is a function of
            # the group-wide spend (this wait includes the slowest slot)
            t0 = time.perf_counter()
            qp = pool.frame_qp(qp, spent, k + 1)
            pool_s.append(time.perf_counter() - t0)
    encode_launches = _launches()

    # the collective must steer: gather frame 0's spends and frame 1's
    # QPs (and the final spends), and compare with pools that see only
    # their own slot
    mine = torch.tensor([spents[0], qps[1], spent], dtype=torch.int64,
                        device=pool.device)
    every = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(every, mine)
    every = torch.stack(every).cpu().tolist()
    mesh_qps = [int(r[1]) for r in every]
    isolated = local_qps([int(r[0]) for r in every])
    if mesh_qps == isolated:
        raise AssertionError(
            f"the rate pool chose the same frame-1 QPs as isolated per-slot "
            f"pools ({mesh_qps}): the collective does not steer rate "
            "control")

    # the collective's latency alone: all slots lined up, then one
    # all-reduce after another
    dist.barrier()
    latency_ms = []
    for _ in range(ALLREDUCE_ITERS):
        t0 = time.perf_counter()
        total = pool.global_spent(spent)
        latency_ms.append(1000 * (time.perf_counter() - t0))
    if total != sum(int(r[2]) for r in every):
        raise AssertionError(f"all-reduce gave {total} bits; the slots "
                             f"spent {[int(r[2]) for r in every]}")

    # decode this slot's own stream on its device
    before = _launches()
    t0 = time.perf_counter()
    pics = _decode(dev, stream, f"slot {rank}")
    decode_s = time.perf_counter() - t0
    if len(pics) != N_FRAMES:
        raise AssertionError(f"slot {rank}: {len(pics)} pictures of "
                             f"{N_FRAMES}")
    decode_launches = {k: v - before[k] for k, v in _launches().items()}

    # frame-sharded decode of slot 0's stream: slot i takes access units
    # i, i + n, ... and re-reads the parameter sets
    shared = [stream if rank == 0 else None]
    dist.broadcast_object_list(shared, src=0)
    hdr, aus = _split_access_units(shared[0])
    part = [x for au in aus[rank::n] for x in au]
    decoded = 0
    t0 = time.perf_counter()
    if part:
        data, _ = write_annexb(hdr + part)
        decoded = len(_decode(dev, data, f"slot {rank} frame-sharded"))
    sharded_s = time.perf_counter() - t0
    count = torch.tensor([decoded], dtype=torch.int64, device=pool.device)
    dist.all_reduce(count)
    if int(count.item()) != N_FRAMES:
        raise AssertionError(f"frame-sharded decode covered "
                             f"{int(count.item())} of {N_FRAMES} frames")

    return {"rank": rank, "qps": qps, "spent": spents,
            "stream_sha256": hashlib.sha256(stream).hexdigest(),
            "mesh_qps": mesh_qps, "local_qps": isolated,
            "encode_s": encode_s, "pool_wait_s": pool_s,
            "allreduce_ms": latency_ms, "allreduce_total": total,
            "decode_s": decode_s, "pictures": len(pics),
            "digests_ok": sum(p.digest_ok is True for p in pics),
            "sharded_decoded": decoded, "sharded_decode_s": sharded_s,
            "sharded_total": int(count.item()),
            "launches": {"encode": encode_launches,
                         "decode": decode_launches}}


def _rank_main(rank: int, n: int, backend: str, devices: list, work: str,
               clips: list, spawned_at: float) -> None:
    """A spawned slot: its device, then the group, then its share; its
    report goes to ``work/rank<r>.json``."""
    start_s = time.time() - spawned_at
    work = Path(work)
    t0 = time.perf_counter()
    dev = resolve(devices[rank])       # before any tensor is made
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    context_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dist.init_process_group(backend, init_method=f"file://{work}/rendezvous",
                            world_size=n, rank=rank, timeout=GROUP_TIMEOUT)
    group_s = time.perf_counter() - t0
    try:
        report = _slot(rank, n, dev, clips[rank], work)
    finally:
        dist.destroy_process_group()
    report.update(device=str(dev), start_s=start_s, context_s=context_s,
                  group_s=group_s, foreign_modules=_foreign_modules())
    (work / f"rank{rank}.json").write_text(json.dumps(report))


def one_rank_pool(device) -> dict:
    """The rate pool on a one-rank NCCL group in this process, on the
    CUDA ``device``: ``global_spent`` of a slot alone must return its own
    spend.  Returns the total and each call's latency in ms.  The group
    is destroyed before returning."""
    from .parallel.shared_rc import MeshRatePool
    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError(f"backend nccl needs a CUDA device; got {dev}")
    torch.cuda.set_device(dev)
    spent = 12345                      # one slot's spend, in bits
    with tempfile.TemporaryDirectory(prefix="thevc_pool_") as td:
        dist.init_process_group("nccl", init_method=f"file://{td}/rv",
                                world_size=1, rank=0, timeout=GROUP_TIMEOUT)
        try:
            pool = MeshRatePool(total_bits=N_FRAMES * BITS_PER_SLOT_FRAME,
                                n_frames=N_FRAMES)
            totals, latency_ms = [], []
            for _ in range(ALLREDUCE_ITERS):
                t0 = time.perf_counter()
                totals.append(pool.global_spent(spent))
                latency_ms.append(1000 * (time.perf_counter() - t0))
            qp = pool.frame_qp(base_qp(0), spent, 1)
        finally:
            dist.destroy_process_group()
    if totals != [spent] * ALLREDUCE_ITERS:
        raise AssertionError(f"one-rank all-reduce of {spent} gave {totals}")
    return {"backend": "nccl", "device": str(pool.device), "spent": spent,
            "total": totals[0], "frame_qp": qp, "allreduce_ms": latency_ms}


def dryrun_multichip(n_slots: int, backend: str, devices) -> dict:
    """Run the multi-stream dry run on ``n_slots`` processes, slot i on
    ``devices[i]``, over a ``backend`` process group; returns the slots'
    reports gathered.  Raises if any slot fails."""
    return _dryrun(backend, check_layout(n_slots, backend, devices))


def _dryrun(backend: str, devs: list) -> dict:
    """``dryrun_multichip`` on the devices ``check_layout`` chose."""
    from . import native
    from .ops import residual_kernel, satd_kernel

    n_slots = len(devs)
    # build the native core and, for a card, the kernels here, once:
    # the slots only load them
    native.get_lib()
    if any(d.type == "cuda" for d in devs):
        residual_kernel.build()
        satd_kernel.build()
    clips = make_clips(n_slots)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="thevc_dryrun_") as td:
        work = Path(td)
        paths = []
        for i, clip in enumerate(clips):
            paths.append(str(work / f"clip{i}.yuv"))
            Path(paths[-1]).write_bytes(clip)
        torch.multiprocessing.start_processes(
            _rank_main, nprocs=n_slots, join=True, start_method="spawn",
            args=(n_slots, backend, [str(d) for d in devs], td, paths,
                  time.time()))
        slots = [json.loads((work / f"rank{i}.json").read_text())
                 for i in range(n_slots)]
    wall_s = time.perf_counter() - t0
    foreign = {s["rank"]: s["foreign_modules"] for s in slots
               if s["foreign_modules"]}
    if foreign:
        raise AssertionError(f"slots loaded jax or the JAX package: "
                             f"{foreign}")
    latency = sorted(ms for s in slots for ms in s["allreduce_ms"])
    return {
        "slots": n_slots, "backend": backend, "processes": n_slots,
        "devices": [s["device"] for s in slots],
        "cards": len({s["device"] for s in slots
                      if s["device"].startswith("cuda")}),
        "base_qps": [base_qp(i) for i in range(n_slots)],
        "qp_history": [[s["qps"][k] for s in slots]
                       for k in range(N_FRAMES)],
        "spent_history": [[s["spent"][k] for s in slots]
                          for k in range(N_FRAMES)],
        "local_qps": slots[0]["local_qps"],
        "stream_sha256": [s["stream_sha256"] for s in slots],
        "allreduce_ms_median": latency[len(latency) // 2],
        "pictures": sum(s["pictures"] for s in slots),
        "digests_ok": sum(s["digests_ok"] for s in slots),
        "sharded_decoded": slots[0]["sharded_total"],
        "wall_s": wall_s, "slot_reports": slots}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m thevc_tpu_torch.graft_entry",
        description="The port's entry step and its multi-stream dry run.")
    ap.add_argument("--slots", type=int, required=True,
                    help="slots (processes) of the dry run, at least 2")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="process-group backend (nccl: one card a slot; "
                         "gloo: any devices, slots may share a card)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: slot i on cuda:i under nccl, every slot on "
                         "cuda:0 under gloo; cpu: every slot on the host")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        devices = ["cpu"] * args.slots
    elif args.backend == "nccl":
        devices = [f"cuda:{i}" for i in range(args.slots)]
    else:
        devices = ["cuda:0"] * args.slots
    devs = check_layout(args.slots, args.backend, devices)
    step, example = entry(devs[0])
    out = step(*example)
    print("entry ok:", tuple(out.shape), out.dtype)
    report = _dryrun(args.backend, devs)
    print("dryrun_multichip report " + json.dumps(report))
    print(f"dryrun_multichip({args.slots}) ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
