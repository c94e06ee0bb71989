"""The port's encoder: checkpoint/resume, fast-RD under rate control and
the threaded WPP compress, on the CPU.

- Checkpoint/resume (``--CheckpointFile``/``--ResumeFile``, 96x80
  low-delay P, 9 frames, a checkpoint every GOP): an encode stopped at
  frame 5 and resumed in a new encoder gives the uninterrupted run's
  stream and recon byte for byte, on the exact path (as
  ``tests/test_encoder.py:712``; its stream also equals the JAX
  package's) and with ``--FastRD=1``, whose resumed run uploads its
  reference pictures to the decision pass's cache again.
- Fast-RD under rate control (``--RateCtrl=1``, the cfg option of HM's
  URQ rate control): all-intra 416x240, 4 frames, with the host apply
  and with ``--device-apply``, and low-delay B, 3 frames.  Rate control
  turns delta QP on, and the fast-RD encode keeps every CU at the frame
  QP and codes a zero delta, so these streams differ from the JAX
  package's (whose fast-RD encode falls back to its exact path under
  rate control).  They are held to:
  - the JAX package's ``RateCtrl``: fed the same calls (every CTU's
    bits, every frame's status), it returns the port's frame QPs, which
    move on low-delay B;
  - what the controller is fed: each CTU's source is the clip's, its
    reconstruction the encoder's before the loop filters, its bits add
    up to the frame's slice data, and each frame's status bits are the
    frame's bits the encoder prints;
  - the JAX package's ``Decoder``: the same pictures and digest flags as
    the port's decoder, every digest OK, the encoder's recon;
  - one frame with the delta-QP PPS against the same frame without it
    (no rate control, at the same QP): the JAX decoder reads the same
    decision maps, coefficients and pictures from both.
- ``THEVC_ENC_THREADS=4`` equals 1 on a WPP stream, exact and fast-RD
  (as ``tests/test_fast_rd.py:158``).

The same checkpoint/resume and rate-controlled encodes run on ``cuda``
against ``cpu`` in ``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""

import contextlib
import io
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from thevc_tpu_torch import nal, streams
from thevc_tpu_torch.apps.encoder import REPORT_PREFIX
from thevc_tpu_torch.apps.encoder import main as port_encoder
from thevc_tpu_torch.decoder.top import Decoder
from thevc_tpu_torch.encoder import fast_inter, rate_ctrl

REPO = Path(__file__).resolve().parents[1]
CFG = REPO / "tests" / "cfg"
TARGET_BPS = 1000000
# name -> (cfg, frames, extra arguments)
RC_CASES = {
    "intra": ("encoder_intra_main.cfg", 4, ()),
    "intra_device_apply": ("encoder_intra_main.cfg", 4, ("--device-apply",)),
    "ldb": ("encoder_lowdelay_tlayers.cfg", 3, ()),
}


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    return {"small": streams.make_clip(root / "clip_96x80_9f.yuv", 96, 80, 9),
            "cif": streams.make_clip(root / "clip_416x240_4f.yuv", 416, 240,
                                     4)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's waiting threads slow the other workers' tests when they
    outnumber the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _encode(main, argv):
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        main(argv)
    return log.getvalue()


def _report(log):
    line = [ln for ln in log.splitlines() if ln.startswith(REPORT_PREFIX)]
    return json.loads(line[-1][len(REPORT_PREFIX):])


def _resume_run(main, clip, root, extra, on_resume=lambda: None):
    """The uninterrupted 9-frame encode, then one checkpointed at frame 5
    and resumed to frame 9 (``on_resume`` called just before the resumed
    run); returns ((stream, recon), (stream, recon), the resumed run's
    log)."""
    base = ["-c", str(CFG / "encoder_lowdelay_P_main.cfg"), "-i", str(clip),
            "-wdt", "96", "-hgt", "80", "-fr", "30", "--SEIpictureDigest=1",
            *extra]
    full = (root / "full.bin", root / "full.yuv")
    _encode(main, base + ["-f", "9", "-b", str(full[0]), "-o", str(full[1])])
    ck = root / "state.pkl"
    joined = (root / "joined.bin", root / "joined.yuv")
    out = ["-b", str(joined[0]), "-o", str(joined[1])]
    _encode(main, base + ["-f", "5", *out, f"--CheckpointFile={ck}",
                          "--CheckpointEvery=1"])
    assert ck.exists()
    on_resume()
    log = _encode(main, base + ["-f", "9", *out, f"--ResumeFile={ck}"])
    return ([p.read_bytes() for p in full], [p.read_bytes() for p in joined],
            log)


def test_checkpoint_resume_exact(clips, tmp_path):
    full, joined, _ = _resume_run(port_encoder, clips["small"], tmp_path, ())
    assert joined == full
    from thevc_tpu.apps.encoder import main as ref_encoder
    ref = tmp_path / "ref"
    ref.mkdir()
    _encode(ref_encoder, [
        "-c", str(CFG / "encoder_lowdelay_P_main.cfg"),
        "-i", str(clips["small"]), "-wdt", "96", "-hgt", "80", "-fr", "30",
        "--SEIpictureDigest=1", "-f", "9", "-b", str(ref / "full.bin"),
        "-o", str(ref / "full.yuv")])
    assert (ref / "full.bin").read_bytes() == full[0]


def test_checkpoint_resume_fastrd(clips, tmp_path, monkeypatch):
    uploads = []
    real = fast_inter.RefCache._upload

    def spy(host, hp, wp, device):
        uploads.append(len(host))
        return real(host, hp, wp, device)
    monkeypatch.setattr(fast_inter.RefCache, "_upload", staticmethod(spy))
    full, joined, log = _resume_run(
        port_encoder, clips["small"], tmp_path,
        ("--FastRD=1", "--device", "cpu"), on_resume=uploads.clear)
    assert joined == full
    rep = _report(log)
    assert rep["decision_frames"] == rep["decision_frames_inter"] == 4
    # the resumed encoder's cache starts empty: it uploads its references
    assert uploads
    pics = Decoder("cpu").decode_stream(full[0])
    assert [p.poc for p in pics] == list(range(9))
    assert all(p.digest_ok is True for p in pics)


# the methods of RateCtrl that the encoder calls
RC_METHODS = ("get_frame_qp", "calculate_unit_qp", "get_unit_qp",
              "update_lcu_data", "update_unit_status", "update_frame_data",
              "update_frame_status", "update_gop_status")
# the largest mean absolute change the loop filters make to a 64x64 CTU
# of these clips' reconstruction (0.4 at most here): the controller's
# reconstruction must be the encoder's, not a stale buffer
LOOP_FILTER_MEAN_ABS = 1.0
# a slice's bits beyond its CTUs' coded bits: its slice and NAL headers
SLICE_HEADER_BITS = 256


def _record_rate_ctrl(monkeypatch) -> list:
    """Record every call of the port's ``RateCtrl``, in order, as (method,
    arguments, result); the constructor's as ("__init__", (args, kw),
    None).  Array arguments are copied."""
    calls = []
    init = rate_ctrl.RateCtrl.__init__

    def spy_init(self, *args, **kw):
        calls.append(("__init__", (args, kw), None))
        init(self, *args, **kw)
    monkeypatch.setattr(rate_ctrl.RateCtrl, "__init__", spy_init)
    for name in RC_METHODS:
        def spy(self, *args, _real=getattr(rate_ctrl.RateCtrl, name),
                _name=name):
            kept = tuple(a.copy() if isinstance(a, np.ndarray) else a
                         for a in args)
            out = _real(self, *args)
            calls.append((_name, kept, out))
            return out
        monkeypatch.setattr(rate_ctrl.RateCtrl, name, spy)
    return calls


def _replay_on_jax(calls) -> None:
    """Make the same calls on the JAX package's ``RateCtrl`` and require
    the same results."""
    from thevc_tpu.encoder.rate_ctrl import RateCtrl as JaxRateCtrl
    (name, (args, kw), _), *rest = calls
    assert name == "__init__"
    ref = JaxRateCtrl(*args, **kw)
    for k, (name, args, out) in enumerate(rest):
        assert name != "__init__", "a second rate controller"
        assert getattr(ref, name)(*args) == out, (k, name, args[-2:])


def _frames_fed(calls) -> list:
    """Per frame, in coding order: (POC, frame QP, [update_lcu_data
    arguments], update_frame_data's bits, update_frame_status's bits)."""
    frames = []
    for name, args, out in calls:
        if name == "get_frame_qp":
            frames.append([args[1], out, [], None, None])
        elif name == "update_lcu_data":
            frames[-1][2].append(args)
        elif name == "update_frame_data":
            frames[-1][3] = args[0]
        elif name == "update_frame_status":
            frames[-1][4] = args[0]
    return frames


def _planes(path, w, h, frames):
    """The luma planes of a 4:2:0 8-bit file."""
    yuv = np.fromfile(path, np.uint8).reshape(frames, -1)
    return yuv[:, :w * h].reshape(frames, h, w)


def _jax_decode(data):
    """The JAX package's decode of ``data``, keeping the models.  Its
    native core is loaded first: its batched all-intra decode loads it
    from several threads, and with R8 (ROADMAP) a thread that loses the
    race decodes pictures that fail their digests."""
    from thevc_tpu.decoder.top import Decoder as JaxDecoder
    from thevc_tpu.native import get_lib
    get_lib()
    dec = JaxDecoder()
    dec.keep_models = True
    with contextlib.redirect_stdout(io.StringIO()):
        return dec.decode_stream(data)


@pytest.mark.parametrize("case", list(RC_CASES))
def test_fastrd_rate_control(case, clips, tmp_path, monkeypatch):
    cfg, frames, extra = RC_CASES[case]
    w, h = 416, 240
    calls = _record_rate_ctrl(monkeypatch)
    stream, rec = tmp_path / "rc.bin", tmp_path / "rc.yuv"
    log = _encode(port_encoder, [
        "-c", str(CFG / cfg), "-i", str(clips["cif"]), "-wdt", str(w),
        "-hgt", str(h), "-f", str(frames), "-fr", "30", "-b", str(stream),
        "-o", str(rec), "--SEIpictureDigest=1", "--FastRD=1",
        "--RateCtrl=1", f"--TargetBitrate={TARGET_BPS}", "--device", "cpu",
        *extra])
    assert "Unknown option" not in log, log
    rep = _report(log)
    assert rep["decision_frames"] == frames
    if "--device-apply" in extra:
        assert rep["device_apply_frames"] == frames
        assert rep["device_apply_fallback_frames"] == 0
    printed = [tuple(map(int, m)) for m in re.findall(
        r"^POC +(\d+) .*? QP (\d+) \) +(\d+) bits", log, re.M)]
    assert len(printed) == frames

    # the controller decides as the JAX package's does on the same calls,
    # and on low-delay B its frame QPs move
    _replay_on_jax(calls)
    fed = _frames_fed(calls)
    assert [(poc, qp) for poc, qp, *_ in fed] == \
        [(poc, qp) for poc, qp, _b in printed]
    if case == "ldb":
        assert len({qp for _p, qp, *_ in fed}) > 1, fed

    # what it was fed: every CTU (7x4 of 64x64) in raster order at the
    # frame QP, its source the clip's and its reconstruction the
    # encoder's (before the loop filters); the CTUs' bits are the slice's
    # data, the status bits the frame's printed bits
    org = _planes(clips["cif"], w, h, 4)
    out = _planes(rec, w, h, frames)
    slices = [8 * len(nal.write_nal(u.nal_type, u.temporal_id, u.rbsp))
              for u in nal.iter_annexb_nals(stream.read_bytes())
              if nal.is_slice_nal(u.nal_type)]
    assert len(slices) == frames
    for (poc, qp, lcus, data_bits, status_bits), (_p, _q, bits), sl in zip(
            fed, printed, slices):
        assert [(x, y) for _o, _r, x, y, _b, _q in lcus] == \
            [(x, y) for y in range(0, h, 64) for x in range(0, w, 64)]
        for o, r, x, y, b, q in lcus:
            assert q == qp and b >= 0
            assert np.array_equal(o, org[poc])
            ctu = (slice(y, y + 64), slice(x, x + 64))
            diff = np.abs(r[ctu].astype(int) - out[poc][ctu]).mean()
            assert diff < LOOP_FILTER_MEAN_ABS, (poc, x, y, diff)
        ctu_bits = sum(b for *_a, b, _q in lcus)
        assert data_bits == ctu_bits
        assert ctu_bits < sl < ctu_bits + SLICE_HEADER_BITS, (poc, sl)
        assert status_bits == bits

    # the stream: the JAX decoder reads what the port's decoder reads,
    # every digest OK, the encoder's recon
    pics = Decoder("cpu").decode_stream(stream.read_bytes())
    ref = _jax_decode(stream.read_bytes())
    assert [p.poc for p in pics] == [p.poc for p in ref] == \
        sorted(p for p, *_ in fed)
    assert all(p.digest_ok is True for p in pics)
    assert [p.digest_ok for p in ref] == [p.digest_ok for p in pics]
    for a, b in zip(pics, ref):
        for x, y in zip(a.frame.planes(), b.frame.planes()):
            assert np.array_equal(x, y), a.poc
    got = b"".join(pl.astype(np.uint8).tobytes() for p in pics
                   for pl in p.frame.planes())
    assert got == rec.read_bytes()
    # a bound on the rate (as tests/test_fast_apply.py:154), not evidence
    # that the controller steers: the replay above is
    bps = stream.stat().st_size * 8 * 30 / frames
    assert bps < 2.5 * TARGET_BPS, bps


# the decision maps and coefficients the decoder reads from a stream
MAPS = ("depth", "pred_mode", "part_size_arr", "skip", "merge_flag",
        "luma_dir", "chroma_dir", "tr_idx", "cbf", "qp", "tq_bypass", "ipcm",
        "ts_flag", "coeff_y", "coeff_cb", "coeff_cr")


@pytest.mark.parametrize("apply", ["host", "device"])
def test_fastrd_zero_dqp_keeps_decisions(apply, clips, tmp_path):
    """One fast-RD all-intra frame with the delta-QP PPS of rate control
    (the first frame's rate-controlled QP is the cfg's 32: every CU at the
    slice QP, a zero delta coded) against the same frame without rate
    control: the JAX decoder reads the same decision maps, coefficients
    and pictures from both streams, and the delta-QP flag from the first
    PPS only."""
    from thevc_tpu import headers as jheaders
    from thevc_tpu import nal as jnal
    from thevc_tpu.bitstream import InputBitstream
    extra = ("--device-apply",) if apply == "device" else ()
    out = {}
    for name, rc in (("plain", ()), ("dqp", (
            "--RateCtrl=1", f"--TargetBitrate={TARGET_BPS}"))):
        stream, rec = tmp_path / f"{name}.bin", tmp_path / f"{name}.yuv"
        log = _encode(port_encoder, [
            "-c", str(CFG / "encoder_intra_main.cfg"),
            "-i", str(clips["cif"]), "-wdt", "416", "-hgt", "240", "-f", "1",
            "-fr", "30", "-b", str(stream), "-o", str(rec),
            "--SEIpictureDigest=1", "--FastRD=1", "--device", "cpu", *rc,
            *extra])
        assert re.search(r"^POC +0 .*? QP 32 \)", log, re.M), log
        data = stream.read_bytes()
        pps, = [jheaders.parse_pps(InputBitstream(u.rbsp))
                for u in jnal.iter_annexb_nals(data)
                if u.nal_type == jnal.NAL_UNIT_PPS]
        pic, = _jax_decode(data)
        assert pic.digest_ok is True
        out[name] = (data, rec.read_bytes(), pps.use_dqp, pic)
    (plain, plain_rec, plain_dqp, a), (dqp, dqp_rec, dqp_flag, b) = \
        out["plain"], out["dqp"]
    assert (plain_dqp, dqp_flag) == (False, True)
    assert dqp != plain and dqp_rec == plain_rec
    # every CU inside the picture at the slice QP (4x4 units)
    assert (b.model.qp[:240 // 4, :416 // 4] == 32).all()
    for m in MAPS:
        assert np.array_equal(getattr(a.model, m), getattr(b.model, m)), m
    for x, y in zip(a.frame.planes(), b.frame.planes()):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("fast", [0, 1])
def test_wpp_threaded_compress_byte_identical(fast, clips, tmp_path,
                                              monkeypatch):
    outs = {}
    for threads in (1, 4):
        monkeypatch.setenv("THEVC_ENC_THREADS", str(threads))
        out = tmp_path / f"wpp_t{threads}.bin"
        _encode(port_encoder, [
            "-c", str(CFG / "encoder_intra_main.cfg"),
            "-i", str(clips["cif"]), "-wdt", "416", "-hgt", "240", "-f", "2",
            "-fr", "30", "-q", "32", "-b", str(out), "-o", "/dev/null",
            "--SEIpictureDigest=1", "--WaveFrontSynchro=1",
            f"--FastRD={fast}", "--device", "cpu"])
        outs[threads] = out.read_bytes()
    assert outs[4] == outs[1]
