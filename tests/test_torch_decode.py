"""The port's all-intra decode, end to end, on the CPU.

Streams come from the repo's own encoder with tests/cfg/encoder_intra_main.cfg
at 416x240.  The port's decode (``device="cpu"``) must give recon
byte-identical to the encoder's, to the JAX package's device decode
(THEVC_DEVICE=1) and to every digest SEI.
"""

import contextlib
import io
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from tests.conftest import REPO
from thevc_tpu import native
from thevc_tpu_torch import streams
from thevc_tpu_torch.decoder import recon as port_recon
from thevc_tpu_torch.decoder import top as port_top
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


def test_scaling_list_stream_raises():
    sps = SimpleNamespace(scaling_list_enabled_flag=1, bit_increment=0)
    with pytest.raises(NotImplementedError, match="scaling lists"):
        port_recon.batched_residual_stores([(None, sps, None, [])],
                                           torch.device("cpu"))
