"""The port's fast-RD encoder CLI, end to end, on the CPU.

``python -m thevc_tpu_torch.apps.encoder --device cpu --FastRD=1`` on a
96x80 2-frame clip (all-intra) and on a 96x80 motion clip with the
low-delay P, low-delay B and random-access cfgs of tests/cfg: every
stream must decode digest-OK through the port's decoder and the JAX
package's host decoder with identical recon, and the all-intra and
low-delay P streams stay within 3% of the size of the JAX package's own
fast-RD streams of the same input.  The decision device is explicit: the
CLI hands it to ``encoder.top.Encoder``, which hands it to both
decision passes, and no module global carries it; the JAX package's
switches must take no JAX path in the port.
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
from thevc_tpu.encoder import fast_inter as ref_fast_inter
from thevc_tpu.encoder import fast_intra as ref_fast_intra
from thevc_tpu_torch.apps.encoder import REPORT_PREFIX
from thevc_tpu_torch.encoder import fast_inter as port_fast_inter
from thevc_tpu_torch.encoder import fast_intra as port_fast_intra
from thevc_tpu_torch.encoder import top as port_top
from thevc_tpu_torch.utils.cfg import parse_args

W, H, FRAMES, QP = 96, 80, 2, 32
CFG = REPO / "tests" / "cfg"
INTRA_CFG = CFG / "encoder_intra_main.cfg"
# inter cfgs: name -> (cfg, frames of the motion clip)
INTER = {"ldp": (CFG / "encoder_lowdelay_P_main.cfg", 3),
         "ldb": (CFG / "encoder_lowdelay_tlayers.cfg", 3),
         "ra": (CFG / "encoder_randomaccess_main.cfg", 9)}


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_encode") / "clip_96x80.yuv"
    subprocess.run([sys.executable, str(REPO / "tools" / "make_test_clip.py"),
                    str(path), "--width", str(W), "--height", str(H),
                    "--frames", "3"], check=True, capture_output=True)
    assert native.get_lib() is not None
    return path


@pytest.fixture(scope="module")
def motion_clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_encode") / "motion_96x80.yuv"
    subprocess.run([sys.executable, str(REPO / "tools" / "make_test_clip.py"),
                    str(path), "--width", str(W), "--height", str(H),
                    "--frames", "9", "--seed", "1234", "--style", "motion"],
                   check=True, capture_output=True)
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
    assert report["decision_frames_inter"] == 0
    assert report["decision_wall_s"] > 0
    # on the CPU the kernels' plain versions run
    assert report["satd_launches"] == 0 and report["residual_launches"] == 0


def _decode_both(stream, frames, tmp_path, monkeypatch):
    """Decode with the port's decoder and the JAX package's host decoder:
    every digest OK, the recons identical."""
    from thevc_tpu.apps.decoder import main as ref_decode
    from thevc_tpu_torch.apps.decoder import main as port_decode
    rc, log = _run(port_decode, ["-b", str(stream), "-o",
                                 str(tmp_path / "port.yuv"), "--device",
                                 "cpu"])
    assert rc == 0 and log.count("[MD5:(OK)]") == frames, log
    with monkeypatch.context() as m:
        m.setenv("THEVC_DEVICE", "0")
        rc, log = _run(ref_decode, ["-b", str(stream), "-o",
                                    str(tmp_path / "ref.yuv")])
    assert rc == 0 and log.count("[MD5:(OK)]") == frames, log
    assert (tmp_path / "port.yuv").read_bytes() == \
        (tmp_path / "ref.yuv").read_bytes()


def test_port_stream_decodes_with_both_decoders(port_stream, tmp_path,
                                                monkeypatch):
    _decode_both(port_stream[0], FRAMES, tmp_path, monkeypatch)


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


@pytest.fixture(scope="module")
def inter_streams(motion_clip, tmp_path_factory):
    """The port's fast-RD stream and report of each inter cfg."""
    from thevc_tpu_torch.apps.encoder import main
    out = tmp_path_factory.mktemp("port_inter")
    made = {}
    for name, (cfg, frames) in INTER.items():
        stream = out / f"{name}.bin"
        rc, log = _run(main, _args(motion_clip, stream, cfg=cfg,
                                   frames=frames) + ["--device", "cpu"])
        assert rc == 0, log
        made[name] = (stream, frames, _report(log))
    return made


@pytest.mark.parametrize("name", list(INTER))
def test_inter_fast_rd_stream_decodes_with_both_decoders(
        name, inter_streams, tmp_path, monkeypatch):
    stream, frames, report = inter_streams[name]
    assert report["decision_frames"] == frames
    # every picture after the first is a P or B picture
    assert report["decision_frames_inter"] == frames - 1
    _decode_both(stream, frames, tmp_path, monkeypatch)


def test_inter_encode_never_imports_jax(motion_clip, tmp_path):
    cfg, frames = INTER["ldb"]
    r = subprocess.run(
        [sys.executable, "-m", "thevc_tpu_torch.apps.encoder",
         *_args(motion_clip, tmp_path / "sub.bin", cfg=cfg, frames=frames),
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    report = _report(r.stdout)
    assert report["jax_imported"] is False
    assert report["decision_frames_inter"] == frames - 1


def test_ldp_stream_size_near_jax_fast_rd(inter_streams, motion_clip,
                                          tmp_path, monkeypatch):
    from thevc_tpu.apps.encoder import main as ref_encode
    monkeypatch.setenv("THEVC_DEVICE", "0")          # JAX on the CPU
    monkeypatch.setenv("THEVC_FASTRD_UNIFIED", "1")  # its quick-compile form
    cfg, frames = INTER["ldp"]
    caches = (ref_fast_intra._frame_pass_cache,
              ref_fast_inter._frame_pass_cache_p,
              ref_fast_inter._ref_dev_cache)
    for c in caches:
        c.clear()
    out = tmp_path / "jax.bin"
    try:
        rc, log = _run(ref_encode, _args(motion_clip, out, cfg=cfg,
                                         frames=frames))
    finally:
        for c in caches:
            c.clear()
    assert rc == 0, log
    port_bytes = inter_streams["ldp"][0].stat().st_size
    jax_bytes = out.stat().st_size
    print(f"LDP fast-RD stream: port {port_bytes} B, JAX {jax_bytes} B")
    assert abs(port_bytes - jax_bytes) <= 0.03 * jax_bytes


def _encode_with_spies(clip, out, name, frames, monkeypatch):
    """Encode ``frames`` of ``clip`` with the ``name`` cfg on the CPU,
    recording each decision pass's (tag, device, stats), each P/B frame's
    reference pictures and every reference upload."""
    seen, ref_lists, uploads = [], [], []

    def spy(real, tag):
        def call(*args, **kwargs):
            seen.append((tag, kwargs["device"], kwargs["stats"]))
            if tag == "PB":
                ref_lists.append(args[3] + (kwargs["ref_pics_l1"] or []))
            return real(*args, **kwargs)
        return call
    cfg = parse_args(_args(clip, out, cfg=INTER[name][0], frames=frames))
    stats = port_top.DecisionStats()
    real_upload = port_fast_inter.RefCache._upload

    def upload(host, *args):
        uploads.append(host[0])
        return real_upload(host, *args)
    with monkeypatch.context() as m:
        m.setattr(port_fast_intra, "decide_frame",
                  spy(port_fast_intra.decide_frame, "I"))
        m.setattr(port_fast_inter, "decide_frame_p",
                  spy(port_fast_inter.decide_frame_p, "PB"))
        m.setattr(port_fast_inter.RefCache, "_upload",
                  staticmethod(upload))
        enc = port_top.Encoder(cfg, device="cpu", stats=stats)
        enc.encode(cfg.bitstream_file)
    return enc, stats, seen, ref_lists, uploads


def test_device_decisions_restores_reference_on_exit(motion_clip, tmp_path,
                                                     monkeypatch):
    """The decision device is an argument: the encoder hands it and its
    stats to both decision passes; ``decide_frame`` without a device
    raises; no module global carries a device, and the reference's
    functions are left alone."""
    original = (ref_fast_intra.decide_frame, ref_fast_inter.dispatch_frame_p)
    enc, stats, seen, ref_lists, uploads = _encode_with_spies(
        motion_clip, tmp_path / "ldb.bin", "ldb", 3, monkeypatch)
    assert [t for t, _d, _s in seen] == ["I", "PB", "PB"]
    # each reference picture crosses to the device once, and the cache
    # holds only the last frame's references
    pictures = {id(r[1]) for refs in ref_lists for r in refs}
    assert len(uploads) == len(pictures)
    assert {id(a) for a in uploads} == pictures
    assert len(enc.decision_refs) == len({id(r[1]) for r in ref_lists[-1]})
    assert all(d == torch.device("cpu") and s is stats for _t, d, s in seen)
    assert (stats.frames, stats.inter_frames) == (3, 2)
    assert (ref_fast_intra.decide_frame,
            ref_fast_inter.dispatch_frame_p) == original

    with pytest.raises(TypeError):
        port_fast_intra.decide_frame(*[None] * 14)
    with pytest.raises(TypeError, match="device"):
        port_fast_intra.decide_frame(*[None] * 14, device=None)
    assert not hasattr(port_fast_intra, "active_decisions")
    assert not hasattr(port_top, "device_decisions")
    for mod in (port_fast_intra, port_fast_inter, port_top):
        for name, value in vars(mod).items():
            assert not isinstance(value, (torch.device,
                                          port_top.DecisionStats)), name


def test_random_access_reference_uploaded_once_while_held(
        motion_clip, tmp_path, monkeypatch):
    """In the random-access GOP a reference leaves a frame's lists and
    comes back in a later one: it stays on the device while the DPB holds
    it, so every reference picture crosses once; the cache holds nothing
    the DPB has let go."""
    _cfg, frames = INTER["ra"]
    enc, stats, _seen, ref_lists, uploads = _encode_with_spies(
        motion_clip, tmp_path / "ra.bin", "ra", frames, monkeypatch)
    assert stats.inter_frames == frames - 1
    per_frame = [{id(r[1]) for r in refs} for refs in ref_lists]
    returns = [p for i, a in enumerate(per_frame)
               for j in range(i + 1, len(per_frame))
               for k in range(j + 1, len(per_frame))
               for p in a if p not in per_frame[j] and p in per_frame[k]]
    assert returns, "no reference left the lists and came back"
    pictures = set().union(*per_frame)
    assert len(uploads) == len(pictures)
    assert {id(a) for a in uploads} == pictures
    held = {id(p.rec_y) for p in enc.dpb.pics if p.referenced}
    assert {id(e.host[0]) for e in enc.decision_refs._by_key.values()} \
        <= held


@pytest.fixture(scope="module")
def plain_stream(clip, tmp_path_factory):
    """The CLI's ``--device cpu`` fast-RD stream of the clip, with no
    JAX package switch set."""
    from thevc_tpu_torch.apps.encoder import main
    out = tmp_path_factory.mktemp("plain") / "plain.bin"
    rc, _ = _run(main, _args(clip, out) + ["--device", "cpu"])
    assert rc == 0
    return out.read_bytes()


@pytest.mark.parametrize("name,value", [("THEVC_DEVICE", "1"),
                                        ("THEVC_FASTRD_DEVAPPLY", "1"),
                                        ("THEVC_FASTRD_DEVAPPLY", "force")])
def test_device_decisions_refuses_jax_paths(name, value, clip, tmp_path,
                                            plain_stream):
    """The JAX package's switches are not read by the port: with the
    device switch or the device-apply switch set, its encode runs, imports
    no ``jax`` and writes the same stream as without them (the device
    apply is ``--device-apply``)."""
    out = tmp_path / "sub.bin"
    r = subprocess.run(
        [sys.executable, "-m", "thevc_tpu_torch.apps.encoder",
         *_args(clip, out), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, name: value})
    assert r.returncode == 0, r.stderr[-4000:]
    rep = _report(r.stdout)
    assert rep["jax_imported"] is False
    assert rep["device_apply_frames"] == 0
    assert out.read_bytes() == plain_stream


def test_cuda_device_without_cuda_raises(clip, tmp_path, monkeypatch):
    from thevc_tpu_torch.apps.encoder import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(_args(clip, tmp_path / "cuda.bin") + ["--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(_args(clip, tmp_path / "cuda.bin") + ["--device", "cuda",
                                                   "--device-apply"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_top.Encoder(parse_args(_args(clip, tmp_path / "cuda.bin")),
                         device="cuda")
    assert not (tmp_path / "cuda.bin").exists()
