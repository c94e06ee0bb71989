"""The port's all-intra decode, end to end, on the CPU.

Streams come from the repo's own encoder with tests/cfg/encoder_intra_main.cfg
at 416x240.  The port's decode (``device="cpu"``) must give recon
byte-identical to the encoder's, to the JAX package's device decode
(THEVC_DEVICE=1) and to every digest SEI.  Scaling lists
(``--ScalingList=1``, the default matrices): an all-intra and a low-delay
B stream of a 64x64 clip must decode byte-identical to the encoder's
recon and to the JAX package's decode.
"""

import contextlib
import io
import subprocess
import sys
import pytest
import torch

from tests.conftest import REPO
from thevc_tpu import native
from thevc_tpu_torch import streams
from thevc_tpu_torch.decoder import recon as port_recon
from thevc_tpu_torch.decoder import top as port_top
from thevc_tpu_torch.ops import tq
from thevc_tpu_torch.ops import device as port_device

# name -> (frames, extra encoder arguments)
STREAMS = {
    "intra_3f": (3, ()),                                # batched route
    "intra_1f": (1, ()),                                # serial route
    "intra_3f_10bit": (3, ("--InternalBitDepth=10",)),  # bit_increment 2
}


@pytest.fixture(scope="module")
def intra_streams(test_clip, tmp_path_factory):
    # load the native core on this thread before any decoder's pool
    # starts: concurrent first calls to native.get_lib() can see None
    assert native.get_lib() is not None
    out = tmp_path_factory.mktemp("torch_streams")
    made = {}
    for name, (frames, extra) in STREAMS.items():
        bin_path, rec_path = out / f"{name}.bin", out / f"{name}_rec.yuv"
        streams.encode(test_clip, bin_path, rec_path, 416, 240, frames,
                       extra=extra)
        made[name] = (bin_path, rec_path, frames)
    return made


def _run(main, argv):
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = main(argv)
    return rc, log.getvalue()


def _jax_device_decode(bin_path, out_path, monkeypatch):
    from thevc_tpu.apps.decoder import main
    from thevc_tpu.ops import device
    monkeypatch.setenv("THEVC_DEVICE", "1")
    device.reset_cache()
    device.stats_reset()
    try:
        rc, log = _run(main, ["-b", str(bin_path), "-o", str(out_path)])
        assert device.STATS["launches"] > 0     # the device path ran
    finally:
        device.reset_cache()
    return rc, log


@pytest.mark.parametrize("name", list(STREAMS))
def test_port_decode_matches_encoder_jax_and_digests(
        name, intra_streams, tmp_path, monkeypatch):
    from thevc_tpu_torch.apps.decoder import main
    bin_path, rec_path, frames = intra_streams[name]
    batches = []
    real = port_top.Decoder._finish_ctx_batch

    def spy(self, ctxs, ex):
        batches.append(len(ctxs))
        return real(self, ctxs, ex)
    monkeypatch.setattr(port_top.Decoder, "_finish_ctx_batch", spy)
    port_device.stats_reset()
    port_out = tmp_path / "port.yuv"
    rc, log = _run(main, ["-b", str(bin_path), "-o", str(port_out),
                          "--device", "cpu"])
    assert rc == 0, log
    assert log.count("[MD5:(OK)]") == frames, log
    assert batches == ([frames] if frames > 1 else [])
    assert port_device.STATS["launches"] > 0
    assert port_out.read_bytes() == rec_path.read_bytes()

    jax_out = tmp_path / "jax.yuv"
    rc, log = _jax_device_decode(bin_path, jax_out, monkeypatch)
    assert rc == 0 and log.count("[MD5:(OK)]") == frames, log
    assert port_out.read_bytes() == jax_out.read_bytes()


_NO_JAX = """
import sys
import thevc_tpu.ops.device as ref_device

def forbidden(*args, **kwargs):
    raise AssertionError("the reference device policy was called")

ref_device.backend_probe = forbidden
ref_device.device_enabled = forbidden
import thevc_tpu_torch
from thevc_tpu_torch.apps.decoder import main
assert main(["-b", sys.argv[1], "--device", "cpu"]) == 0
assert "jax" not in sys.modules, sorted(m for m in sys.modules
                                        if m.startswith("jax"))
print("NO_JAX_OK")
"""


def test_port_never_imports_jax(intra_streams):
    bin_path = intra_streams["intra_3f"][0]
    r = subprocess.run([sys.executable, "-c", _NO_JAX, str(bin_path)],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_OK" in r.stdout


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_top.Decoder("cuda")


# name -> (cfg, frames)
SCALING_STREAMS = {
    "scaling_intra": (REPO / "tests" / "cfg" / "encoder_intra_main.cfg", 2),
    "scaling_ldb": (REPO / "tests" / "cfg" / "encoder_lowdelay_tlayers.cfg",
                    3)}


@pytest.fixture(scope="module")
def scaling_streams(tmp_path_factory):
    assert native.get_lib() is not None
    out = tmp_path_factory.mktemp("torch_scaling")
    clip = out / "motion_64x64.yuv"
    subprocess.run([sys.executable, str(REPO / "tools" / "make_test_clip.py"),
                    str(clip), "--width", "64", "--height", "64", "--frames",
                    "3", "--seed", "1234", "--style", "motion"], check=True,
                   capture_output=True)
    made = {}
    for name, (cfg, frames) in SCALING_STREAMS.items():
        bin_path, rec_path = out / f"{name}.bin", out / f"{name}_rec.yuv"
        streams.encode(clip, bin_path, rec_path, 64, 64, frames, cfg=cfg,
                       extra=("--ScalingList=1", "--QP=32"))
        made[name] = (bin_path, rec_path, frames)
    return made


@pytest.mark.parametrize("name", list(SCALING_STREAMS))
def test_scaling_list_stream_decodes(name, scaling_streams, tmp_path,
                                     monkeypatch):
    """Every TU of these pictures goes through the scaling-list dequant
    (the residual kernel's flat dequant is not used for them)."""
    from thevc_tpu.apps.decoder import main as ref_main
    from thevc_tpu_torch.apps.decoder import main
    bin_path, rec_path, frames = scaling_streams[name]
    scaled, flat = [], []
    real_scaled, real_flat = tq.dequant_scaled, tq.residual_pipeline

    def spy(calls, real):
        def call(*args, **kwargs):
            calls.append(1)
            return real(*args, **kwargs)
        return call
    monkeypatch.setattr(tq, "dequant_scaled", spy(scaled, real_scaled))
    monkeypatch.setattr(tq, "residual_pipeline", spy(flat, real_flat))
    port_out = tmp_path / "port.yuv"
    rc, log = _run(main, ["-b", str(bin_path), "-o", str(port_out),
                          "--device", "cpu"])
    assert rc == 0 and log.count("[MD5:(OK)]") == frames, log
    assert scaled and not flat
    assert port_out.read_bytes() == rec_path.read_bytes()
    monkeypatch.setenv("THEVC_DEVICE", "0")
    jax_out = tmp_path / "jax.yuv"
    rc, log = _run(ref_main, ["-b", str(bin_path), "-o", str(jax_out)])
    assert rc == 0 and log.count("[MD5:(OK)]") == frames, log
    assert port_out.read_bytes() == jax_out.read_bytes()


def test_active_scaling_follows_the_parameter_sets(scaling_streams):
    """The activation reads the SPS flag; without list data in either
    parameter set the default matrices apply (with transform skip on, a
    flat 4x4 one)."""
    from thevc_tpu_torch.common import scaling
    dec = port_top.Decoder("cpu")
    dec.decode_stream(scaling_streams["scaling_intra"][0].read_bytes())
    sps, pps = dec.sps_map[0], dec.pps_map[0]
    assert not (sps.scaling_list_present_flag
                or pps.scaling_list_present_flag)
    active = port_recon.active_scaling(sps, pps)
    sl = scaling.ScalingList(pps.use_transform_skip)
    sl.set_default()
    want = scaling.ActiveScaling(sl, sps.bit_increment)
    assert active.deq.keys() == want.deq.keys()
    assert all((active.deq[k] == want.deq[k]).all() for k in want.deq)
    sps.scaling_list_enabled_flag = 0
    assert port_recon.active_scaling(sps, pps) is None
