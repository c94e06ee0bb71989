"""The port's developer tools (``thevc_tpu_torch/tools/``, the twins of the
JAX package's ``tools/*.py``) run from the port on the CPU at a tiny
size, each in a child process as ``python -m`` runs it, with neither
``jax`` nor a module of the JAX package loaded at its end.  The tests
parse each tool's output; they assert its form, never a timing.  The
numbers of the two tools that compute them are held against the JAX
package at tolerance 0: ``diag_fastrd_ldp``'s per-picture statistics
against the same statistics of the JAX ``Decoder`` (its
``tools/diag_fastrd_ldp.py``'s), and ``fastrd_quality``'s exact row
against the JAX exact encoder's stream and log.
"""

import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from thevc_tpu_torch import streams

REPO = Path(__file__).resolve().parents[1]
TINY = ["--width", "64", "--height", "64"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test workers share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

# run the tool as __main__, then name any module of JAX or the JAX
# package left loaded
RUN = r"""
import runpy, sys
sys.argv = sys.argv[1:]
try:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
except SystemExit as exc:
    if exc.code:
        raise
bad = sorted(m for m in sys.modules if m in ("jax", "thevc_tpu")
             or m.startswith(("jax.", "thevc_tpu.")))
print("LOADED", bad)
"""


def _tool(name, *args):
    # one intra-op thread (in the tool and its children): the test
    # workers share the host's cores
    r = subprocess.run([sys.executable, "-c", RUN,
                        f"thevc_tpu_torch.tools.{name}", *args],
                       cwd=REPO, capture_output=True, text=True, timeout=600,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.splitlines()[-1] == "LOADED []", r.stdout[-500:]
    return r.stdout


def test_fastrd_quality_rows():
    out = _tool("fastrd_quality", "--device", "cpu", *TINY, "--frames", "1",
                "--qps", "22,37")
    rows = re.findall(
        r"^QP(\d+): exact (\d+)b Y([\d.]+)dB \| fast (\d+)b Y([\d.]+)dB \| "
        r"bits ([+-][\d.]+)% dPSNR ([+-][\d.]+)dB$", out, re.M)
    assert [int(r[0]) for r in rows] == [22, 37], out
    for _qp, eb, _ep, fb, _fp, pct, _d in rows:
        assert int(eb) > 0 and int(fb) > 0
        assert abs(float(pct) - 100.0 * (int(fb) - int(eb)) / int(eb)) < 0.01


def test_diag_fastrd_ldp_histograms():
    frames = 3
    out = _tool("diag_fastrd_ldp", "--device", "cpu", *TINY, "--frames",
                str(frames))
    assert re.search(r"^exact: \d+ bytes", out, re.M)
    assert re.search(r"^fast : \d+ bytes .* overhead [+-]?[\d.]+%", out,
                     re.M)
    for name in ("exact", "fast"):
        assert re.search(rf"^{name} NAL sizes: \[\(", out, re.M)
        block = out.split(f"--- {name} ---")[1].split("---")[0]
        hists = re.findall(r"poc (\d+): depth \[\s*(\d+)\s+(\d+)\s+(\d+)"
                           r"\s+(\d+)\s*\] intra [\d.]+% skip [\d.]+% "
                           r"merge [\d.]+%", block)
        assert [int(h[0]) for h in hists] == list(range(frames)), block
        # every 4x4 unit of the 64x64 picture has a depth
        assert all(sum(map(int, h[1:])) == 16 * 16 for h in hists)


def _jax_diag_stats(stream, width, height):
    """``stats`` of the JAX package's ``tools/diag_fastrd_ldp.py``, with
    its ``Decoder`` keeping the models."""
    from thevc_tpu.decoder.top import Decoder
    from thevc_tpu.native import get_lib
    get_lib()              # R8 (ROADMAP): load it before any thread does
    dec = Decoder()
    dec.keep_models = True
    with contextlib.redirect_stdout(io.StringIO()):
        pics = dec.decode_stream(stream)
    assert all(p.digest_ok for p in pics)
    rows = []
    for p in sorted(pics, key=lambda q: q.poc):
        f = p.model
        uw, uh = (width + 63) // 64 * 16, (height + 63) // 64 * 16
        val = np.zeros((uh, uw), bool)
        val[:height // 4, :width // 4] = True
        depth = np.asarray(f.depth)[val]
        pred = np.asarray(f.pred_mode)[val]   # 1 = MODE_INTRA
        rows.append(dict(
            poc=p.poc,
            depth_hist=np.bincount(np.maximum(depth.ravel(), 0),
                                   minlength=4)[:4],
            intra_pct=100.0 * (pred.ravel() == 1).mean(),
            skip_pct=100.0 * (np.asarray(f.skip)[val].ravel() != 0).mean(),
            merge_pct=100.0 * (np.asarray(f.merge_flag)[val].ravel()
                               != 0).mean()))
    return rows


@pytest.mark.parametrize("fast", [False, True])
def test_diag_fastrd_ldp_stats_equal_jax(fast, tmp_path):
    from thevc_tpu_torch.tools import diag_fastrd_ldp as diag
    w, h, frames = 64, 64, 3
    clip = streams.make_clip(tmp_path / "clip.yuv", w, h, frames)
    stream, _ = diag.encode(clip, w, h, frames, 32, fast, "cpu")
    got = diag.stats(stream, w, h, "cpu")
    ref = _jax_diag_stats(stream, w, h)
    assert [r["poc"] for r in got] == list(range(frames))
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        assert a["depth_hist"].tolist() == b["depth_hist"].tolist(), a
        assert [a[k] for k in ("poc", "intra_pct", "skip_pct", "merge_pct")] \
            == [b[k] for k in ("poc", "intra_pct", "skip_pct", "merge_pct")]
    if fast:
        # the P pictures' maps are inter decisions: some skip or merge
        assert any(r["skip_pct"] + r["merge_pct"] > 0 for r in got[1:])


def test_fastrd_quality_exact_row_equals_jax(tmp_path):
    """The exact row's bits are the JAX exact encoder's stream without its
    SEI and start codes (the encoder's per-picture count), and its PSNR
    the JAX encoder's."""
    from thevc_tpu import nal as jnal
    from thevc_tpu.apps.encoder import main as ref_encoder
    from thevc_tpu_torch.tools import fastrd_quality, frame_stats
    w, h, frames, qp = 64, 64, 2, 27
    clip = streams.make_clip(tmp_path / "clip.yuv", w, h, frames)
    row, = fastrd_quality.sweep(clip, w, h, frames, [qp], "cpu")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        ref_encoder(["-c", str(streams.INTRA_CFG), "-i", str(clip),
                     "-wdt", str(w), "-hgt", str(h), "-f", str(frames),
                     "-fr", "30", "-q", str(qp), "-b", str(tmp_path / "r.bin"),
                     "--SEIpictureDigest=1", "--FastRD=0"])
    data = (tmp_path / "r.bin").read_bytes()
    bits = sum(8 * len(jnal.write_nal(u.nal_type, u.temporal_id, u.rbsp))
               for u in jnal.iter_annexb_nals(data)
               if u.nal_type != jnal.NAL_UNIT_SEI)
    assert row["exact_bits"] == bits
    assert (row["exact_bits"], row["exact_psnr_y"]) == \
        frame_stats(log.getvalue())
    assert row["fast_bits"] > 0


def test_profile_encode_counters():
    out = _tool("profile_encode", "--device", "cpu", *TINY, "--frames", "1")
    assert re.search(r"^wall [\d.]+s cpu [\d.]+s for 1 frames", out, re.M)
    rows = re.findall(r"^prof\s*(\d+) .{14} +([\d.]+) Gcyc +[\d.]+%$", out,
                      re.M)
    # only counters that ticked are printed
    assert rows, out


def test_ab_bench_same_library():
    from thevc_tpu_torch import native
    so = native.library_path()
    out = _tool("ab_bench", str(so), str(so), "--rounds", "1", "--frames",
                "1", *TINY)
    runs = re.findall(r"^round 0 ([AB]): [\d.]+ cpu-s$", out, re.M)
    assert runs == list("ABBA"), out
    assert re.search(r"^A median [\d.]+  B median [\d.]+  B/A [\d.]+$", out,
                     re.M)
    assert re.search(r"^A min [\d.]+  B min [\d.]+  minB/minA [\d.]+$", out,
                     re.M)


def test_ab_bench_refuses_a_second_library():
    from thevc_tpu_torch import native
    so = native.library_path()
    native.get_lib()
    with pytest.raises(RuntimeError, match="already loaded"):
        native.use_library(so)
