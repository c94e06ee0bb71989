"""The port's fast-RD device apply (``thevc_tpu_torch/encoder/fast_apply.py``)
on the CPU, against the port's own scalar code; no JAX.

- ``_predict_batch`` equals ``ops.intra.predict`` for all 35 modes at
  4/8/16/32 luma and 4/8/16 chroma (seed 7, tolerance 0: integer math).
- ``_sbh_batch`` equals the scalar signBitHidingHDQ of the exact encoder
  (``CuEncoder._sign_bit_hiding``) on seeded quantised batches of every
  size and scan (seed 11, tolerance 0).
- The float32 reductions of ``_rdoq_batch`` are fixed trees and scans:
  ``_tree_sum`` and ``_suffix_sum`` equal numpy's sums on integer-valued
  data, and ``_bitlen`` the exact bit length (tolerance 0).
- End to end, 96x80, 3 frames of the all-intra cfg, ``--FastRD=1
  --device cpu``: with ``--RDOQ=0`` and ``THEVC_FASTRD_TOP2=0`` the
  ``--device-apply`` stream is byte-identical to the host apply's; with
  RDOQ on it decodes digest-OK in the port's decoder with recon equal to
  the encoder's, at most 1.60x the host apply's bytes (the reference's
  bound, ``tests/test_fast_apply.py``), and the CLI reports the frames,
  waves and class steps.  The apply refuses ``THEVC_FASTRD_DEVCHROMA=0``
  (nonconformant in the reference) and an encode without fast-RD, and a
  CPU device with CUDA graph replay.
"""

import contextlib
import io
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import REPO
from thevc_tpu_torch.apps.decoder import main as decoder_main
from thevc_tpu_torch.apps.encoder import REPORT_PREFIX
from thevc_tpu_torch.apps.encoder import main as encoder_main
from thevc_tpu_torch.common import rom
from thevc_tpu_torch.encoder import fast_apply
from thevc_tpu_torch.encoder.cu_encoder import CuEncoder
from thevc_tpu_torch.ops import intra as iops
from thevc_tpu_torch.ops import tq

W, H, FRAMES, QP = 96, 80, 3, 30
INTRA_CFG = REPO / "tests" / "cfg" / "encoder_intra_main.cfg"


def _refs_of(line, size, unit):
    corner = line[2 * size]
    ra = np.concatenate([[corner], line[2 * size + unit:]])
    rl = np.concatenate([[corner], line[2 * size - 1::-1][:2 * size]])
    return ra, rl


@pytest.mark.parametrize("size,luma", [(4, True), (8, True), (16, True),
                                       (32, True), (4, False), (8, False),
                                       (16, False)])
def test_predict_batch_matches_intra_predict(size, luma):
    rng = np.random.RandomState(7)
    unit = 4 if luma else 2
    line = rng.randint(0, 256, 4 * size + unit).astype(np.int32)
    sm = iops.smooth_reference_line(line, size, unit)
    ra, rl = _refs_of(line, size, unit)
    out = fast_apply._predict_batch(
        torch.from_numpy(np.tile(ra, (35, 1))).to(torch.int32),
        torch.from_numpy(np.tile(rl, (35, 1))).to(torch.int32), size, luma,
        torch.arange(35, dtype=torch.int32), 255).numpy()
    for mode in range(35):
        use_f = iops.use_filtered(mode, size.bit_length() - 1, luma)
        ref = iops.predict(sm if use_f else line, size, unit, mode, luma,
                           255)
        assert np.array_equal(out[mode], ref), f"mode {mode}"


def quantised_batch(rng, n, size, qp):
    """Seeded coefficients (heavy-tailed, as a transform gives) and their
    plain quantisation: (coeff, levels, delta_u) int32 [n, s, s]."""
    mag = np.floor(rng.exponential(60.0, (n, size, size))
                   * rng.rand(n, 1, 1) * 4).astype(np.int32)
    co = np.where(rng.rand(n, size, size) < 0.5, -mag, mag).astype(np.int32)
    co_t = torch.from_numpy(co)
    levels, du = tq.quant(co_t, torch.full((n,), qp, dtype=torch.int32),
                          True, 0)
    return co_t, levels, du


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_sbh_batch_matches_scalar(size):
    rng = np.random.RandomState(11)
    n = 96
    hidden = 0
    for scan_sel in range(3):
        co, levels, du = quantised_batch(rng, n, size, 27 + 4 * scan_sel)
        sel = torch.full((n,), scan_sel, dtype=torch.int64)
        got = fast_apply._sbh_batch(levels, co, du, sel, size).numpy()
        for i in range(n):
            want = CuEncoder._sign_bit_hiding(
                None, levels[i].numpy().copy(), co[i].numpy(),
                du[i].numpy(), scan_sel + 1, size)
            assert np.array_equal(got[i], want), (scan_sel, i)
            hidden += int((want != levels[i].numpy()).any())
    assert hidden >= n // 4       # the batches do exercise the hiding


def test_exact_reductions():
    rng = np.random.RandomState(5)
    x = rng.randint(-2 ** 12, 2 ** 12, (7, 3, 64)).astype(np.float32)
    t = torch.from_numpy(x)
    assert np.array_equal(fast_apply._tree_sum(t).numpy(), x.sum(axis=-1))
    assert np.array_equal(fast_apply._suffix_sum(t).numpy(),
                          np.cumsum(x[..., ::-1], axis=-1)[..., ::-1])
    v = np.arange(1, 2 ** 18, 37, dtype=np.int32)
    assert np.array_equal(fast_apply._bitlen(torch.from_numpy(v)).numpy(),
                          np.floor(np.log2(v)).astype(np.int32) + 1)
    tabs = fast_apply._scan_tensors(8, True, torch.device("cpu"))
    scan, inv = tabs[0].numpy(), tabs[1].numpy()
    for si in range(3):
        assert np.array_equal(scan[si].reshape(-1),
                              np.asarray(rom.sig_last_scan(si + 1, 8)))
        assert np.array_equal(scan[si][inv[si]], np.arange(64))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_fast_apply") / "clip_96x80.yuv"
    subprocess.run([sys.executable, str(REPO / "tools" / "make_test_clip.py"),
                    str(path), "--width", str(W), "--height", str(H),
                    "--frames", str(FRAMES)], check=True,
                   capture_output=True)
    return path


def _encode(clip, out, *extra):
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = encoder_main(["-c", str(INTRA_CFG), "-i", str(clip), "-b",
                           str(out), "-o", str(out.with_suffix(".yuv")),
                           "-wdt", str(W), "-hgt", str(H), "-f", str(FRAMES),
                           "-fr", "30", f"--QP={QP}", "--FastRD=1",
                           "--SEIpictureDigest=1", "--device", "cpu",
                           *extra])
    assert rc == 0
    lines = [ln for ln in log.getvalue().splitlines()
             if ln.startswith(REPORT_PREFIX)]
    assert len(lines) == 1
    return out.read_bytes(), json.loads(lines[0][len(REPORT_PREFIX):])


def _decode_ok(stream, tmp_path):
    log = io.StringIO()
    dec = tmp_path / "dec.yuv"
    with contextlib.redirect_stdout(log):
        rc = decoder_main(["-b", str(stream), "-o", str(dec), "--device",
                           "cpu"])
    assert rc == 0 and log.getvalue().count("[MD5:(OK)]") == FRAMES, \
        log.getvalue()
    assert dec.read_bytes() == stream.with_suffix(".yuv").read_bytes()


def test_device_apply_byte_identical_to_host_apply_rdoq0(clip, tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("THEVC_FASTRD_TOP2", "0")
    host, rep_host = _encode(clip, tmp_path / "host.bin", "--RDOQ=0")
    dev, rep = _encode(clip, tmp_path / "dev.bin", "--RDOQ=0",
                       "--device-apply")
    assert rep_host["device_apply_frames"] == 0
    assert rep["device_apply_frames"] == FRAMES
    assert rep["device_apply_fallback_frames"] == 0
    assert rep["device_apply_waves"] >= FRAMES
    assert rep["device_apply_class_steps"] >= rep["device_apply_waves"]
    assert dev == host


def test_device_apply_rdoq_decodes_within_bound(clip, tmp_path):
    host, _ = _encode(clip, tmp_path / "host.bin")
    dev, rep = _encode(clip, tmp_path / "dev.bin", "--device-apply")
    assert rep["device_apply_frames"] == FRAMES
    assert rep["device_apply_wall_s"] > 0
    _decode_ok(tmp_path / "dev.bin", tmp_path)
    assert len(dev) <= 1.60 * len(host), (len(dev), len(host))


def test_device_apply_refusals(clip, tmp_path, monkeypatch):
    from thevc_tpu_torch.encoder.top import Encoder
    from thevc_tpu_torch.utils.cfg import parse_args
    argv = ["-c", str(INTRA_CFG), "-i", str(clip), "-b",
            str(tmp_path / "x.bin"), "-wdt", str(W), "-hgt", str(H), "-f",
            "1", "-fr", "30"]
    with pytest.raises(ValueError, match="FastRD"):
        Encoder(parse_args(argv), device="cpu", device_apply=True)
    monkeypatch.setenv("THEVC_FASTRD_DEVCHROMA", "0")
    with pytest.raises(ValueError, match="THEVC_FASTRD_DEVCHROMA"):
        Encoder(parse_args(argv + ["--FastRD=1"]), device="cpu",
                device_apply=True)
    with pytest.raises(ValueError, match="CUDA graph"):
        fast_apply.run_device_apply(
            None, None, None, None, W, H, 30, 30, 30, 64, 0, 255, True,
            device="cpu", replay=True)
    assert not (tmp_path / "x.bin").exists()
