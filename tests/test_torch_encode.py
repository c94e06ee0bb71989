"""The port's fast-RD encoder CLI, end to end, on the CPU.

``python -m thevc_tpu_torch.apps.encoder --device cpu --FastRD=1`` on a
96x80 2-frame clip: the stream must decode digest-OK through the port's
decoder and the JAX package's host decoder, and stay within 3% of the
size of the JAX package's own fast-RD stream of the same input.  The
port's decision device (``encoder.top.device_decisions``) must leave the
reference's functions alone and restore the previous device on exit; the
JAX package's switches must take no JAX path in the port, and the encoder
must refuse P/B fast-RD.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from tests.conftest import REPO
from thevc_tpu import native
from thevc_tpu.encoder import fast_inter
from thevc_tpu.encoder import fast_intra as ref_fast_intra
from thevc_tpu_torch.apps.encoder import REPORT_PREFIX
from thevc_tpu_torch.encoder import fast_intra as port_fast_intra
from thevc_tpu_torch.encoder.top import device_decisions

W, H, FRAMES, QP = 96, 80, 2, 32
INTRA_CFG = REPO / "tests" / "cfg" / "encoder_intra_main.cfg"
LDP_CFG = REPO / "tests" / "cfg" / "encoder_lowdelay_tlayers.cfg"


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_encode") / "clip_96x80.yuv"
    subprocess.run([sys.executable, str(REPO / "tools" / "make_test_clip.py"),
                    str(path), "--width", str(W), "--height", str(H),
                    "--frames", "3"], check=True, capture_output=True)
    assert native.get_lib() is not None
    return path


def _args(clip, out, cfg=INTRA_CFG, frames=FRAMES):
    return ["-c", str(cfg), "-i", str(clip), "-b", str(out),
            "-wdt", str(W), "-hgt", str(H), "-f", str(frames), "-fr", "30",
            f"--QP={QP}", "--FastRD=1", "--SEIpictureDigest=1"]


def _run(main, argv):
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = main(argv)
    return rc, log.getvalue()


def _report(log):
    lines = [ln for ln in log.splitlines() if ln.startswith(REPORT_PREFIX)]
    assert len(lines) == 1, log
    return json.loads(lines[0][len(REPORT_PREFIX):])


@pytest.fixture(scope="module")
def port_stream(clip, tmp_path_factory):
    from thevc_tpu_torch.apps.encoder import main
    out = tmp_path_factory.mktemp("port_stream") / "port.bin"
    rc, log = _run(main, _args(clip, out) + ["--device", "cpu"])
    assert rc == 0, log
    return out, _report(log)


def test_port_encode_reports_its_decision_passes(port_stream):
    _, report = port_stream
    assert report["device"] == "cpu"
    assert report["decision_frames"] == FRAMES
    assert report["decision_wall_s"] > 0
    # on the CPU the kernels' plain versions run
    assert report["satd_launches"] == 0 and report["residual_launches"] == 0


def test_port_stream_decodes_with_both_decoders(port_stream, tmp_path,
                                                monkeypatch):
    from thevc_tpu.apps.decoder import main as ref_decode
    from thevc_tpu_torch.apps.decoder import main as port_decode
    stream, _ = port_stream
    rc, log = _run(port_decode, ["-b", str(stream), "-o",
                                 str(tmp_path / "port.yuv"), "--device",
                                 "cpu"])
    assert rc == 0 and log.count("[MD5:(OK)]") == FRAMES, log
    monkeypatch.setenv("THEVC_DEVICE", "0")
    rc, log = _run(ref_decode, ["-b", str(stream), "-o",
                                str(tmp_path / "ref.yuv")])
    assert rc == 0 and log.count("[MD5:(OK)]") == FRAMES, log
    assert (tmp_path / "port.yuv").read_bytes() == \
        (tmp_path / "ref.yuv").read_bytes()


def test_port_stream_size_near_jax_fast_rd(port_stream, clip, tmp_path,
                                           monkeypatch):
    from thevc_tpu.apps.encoder import main as ref_encode
    monkeypatch.setenv("THEVC_DEVICE", "0")          # JAX on the CPU
    monkeypatch.setenv("THEVC_FASTRD_UNIFIED", "1")  # its quick-compile form
    ref_fast_intra._frame_pass_cache.clear()
    out = tmp_path / "jax.bin"
    try:
        rc, log = _run(ref_encode, _args(clip, out))
    finally:
        ref_fast_intra._frame_pass_cache.clear()
    assert rc == 0, log
    port_bytes = port_stream[0].stat().st_size
    jax_bytes = out.stat().st_size
    print(f"fast-RD stream: port {port_bytes} B, JAX {jax_bytes} B")
    assert abs(port_bytes - jax_bytes) <= 0.03 * jax_bytes


def test_port_encode_never_imports_jax(clip, tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "thevc_tpu_torch.apps.encoder",
         *_args(clip, tmp_path / "sub.bin"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    report = _report(r.stdout)
    assert report["jax_imported"] is False
    assert report["decision_frames"] == FRAMES


def test_device_decisions_restores_reference_on_exit():
    original = (ref_fast_intra.decide_frame, fast_inter.dispatch_frame_p)
    assert port_fast_intra.active_decisions is None
    with device_decisions("cpu") as stats:
        # the port's own decision pass takes the device; the reference's
        # functions are left alone
        assert port_fast_intra.active_decisions == (torch.device("cpu"), stats)
        assert (ref_fast_intra.decide_frame,
                fast_inter.dispatch_frame_p) == original
    assert stats.frames == 0
    assert port_fast_intra.active_decisions is None
    with pytest.raises(RuntimeError, match="inside"):
        with device_decisions("cpu"):
            raise RuntimeError("inside")
    assert port_fast_intra.active_decisions is None
    assert (ref_fast_intra.decide_frame, fast_inter.dispatch_frame_p) == \
        original
    with pytest.raises(RuntimeError, match="device_decisions"):
        port_fast_intra.decide_frame(*[None] * 14)


def test_p_slice_fast_rd_raises(clip, tmp_path):
    from thevc_tpu_torch.apps.encoder import main
    original = ref_fast_intra.decide_frame
    with pytest.raises(NotImplementedError, match="P/B"):
        _run(main, _args(clip, tmp_path / "ldp.bin", cfg=LDP_CFG, frames=3)
             + ["--device", "cpu"])
    assert ref_fast_intra.decide_frame is original


@pytest.mark.parametrize("name,value", [("THEVC_DEVICE", "1"),
                                        ("THEVC_FASTRD_DEVAPPLY", "1"),
                                        ("THEVC_FASTRD_DEVAPPLY", "force")])
def test_device_decisions_refuses_jax_paths(name, value, clip, tmp_path):
    """The JAX package's device switch is not read by the port (its encode
    runs and imports no ``jax``); its device apply is not ported and
    raises."""
    r = subprocess.run(
        [sys.executable, "-m", "thevc_tpu_torch.apps.encoder",
         *_args(clip, tmp_path / "sub.bin"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, name: value})
    if name == "THEVC_DEVICE":
        assert r.returncode == 0, r.stderr[-4000:]
        assert _report(r.stdout)["jax_imported"] is False
    else:
        assert r.returncode != 0
        assert "NotImplementedError" in r.stderr and name in r.stderr, \
            r.stderr[-4000:]


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with device_decisions("cuda"):
            pass
