"""The port decodes the coding-tool streams of ``tests/test_decoder.py``
(QP 22 and 51, PCM, CU-level delta QP, in-loop filters off) on the CPU.

The streams come from the port's own exact encoder
(``thevc_tpu_torch.streams.tool_streams``: 64x64, 2 frames,
``tests/cfg/encoder_intra_main.cfg``; why the PCM and dQP streams differ
from HM's arguments is said there).  Each must decode through the port
with every digest OK and recon byte-identical to the encoder's, and the
tool must occur: PCM CUs in the PCM stream, more than one CU QP in the
dQP stream, the slice QP everywhere in the QP streams.  The PCM and dQP
streams are also held against the JAX package's device decode.  The
same streams decode on ``cuda`` in ``tests/test_torch_kernels.py`` and
in ``chip_smoke.py``.
"""

import contextlib
import io

import numpy as np
import pytest

from thevc_tpu_torch import nal, streams
from thevc_tpu_torch.apps.decoder import main as port_main
from thevc_tpu_torch.decoder import filters as port_filters
from thevc_tpu_torch.decoder.top import Decoder

AGAINST_JAX = ("pcm", "dqp")


@pytest.fixture(scope="module")
def tool_streams(tmp_path_factory):
    return streams.tool_streams(tmp_path_factory.mktemp("tools"))


def _run(main, argv):
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = main(argv)
    return rc, log.getvalue()


def _decode_serial(stream, monkeypatch):
    """The pictures of a decode on the serial route, which keeps each
    picture's FrameModel, and the in-loop filter switches of each
    picture's slice header (deblocking off, SAO on)."""
    switches = []
    real = port_filters.filter_picture_device

    def spy(f, sh, *args):
        switches.append((sh.loop_filter_disable,
                         sh.sao_enabled or sh.sao_enabled_chroma))
        return real(f, sh, *args)
    monkeypatch.setattr(port_filters, "filter_picture_device", spy)
    dec = Decoder("cpu")
    dec.keep_models = True
    for unit in nal.iter_annexb_nals(stream.read_bytes()):
        dec.decode_nal(unit)
    dec.flush()
    return sorted(dec.pictures, key=lambda p: p.poc), switches


@pytest.mark.parametrize("name", list(streams.TOOL_STREAMS))
def test_tool_stream_decodes(name, tool_streams, tmp_path, monkeypatch):
    stream, rec, frames = tool_streams[name]
    out = tmp_path / "port.yuv"
    rc, log = _run(port_main, ["-b", str(stream), "-o", str(out),
                               "--device", "cpu"])
    assert rc == 0, log
    assert log.count("[MD5:(OK)]") == frames and "ERROR" not in log, log
    assert out.read_bytes() == rec.read_bytes()
    if name in AGAINST_JAX:
        from thevc_tpu import native
        from tests.test_torch_decode import _jax_device_decode
        # load the JAX package's native core on this thread before its
        # decoder's pool starts
        assert native.get_lib() is not None
        jax_out = tmp_path / "jax.yuv"
        rc, log = _jax_device_decode(stream, jax_out, monkeypatch)
        assert rc == 0 and log.count("[MD5:(OK)]") == frames, log
        assert jax_out.read_bytes() == out.read_bytes()


@pytest.mark.parametrize("name", list(streams.TOOL_STREAMS))
def test_tool_occurs(name, tool_streams, monkeypatch):
    stream, _rec, frames = tool_streams[name]
    pics, switches = _decode_serial(stream, monkeypatch)
    assert len(pics) == frames and all(p.digest_ok is True for p in pics)
    pcm_units = sum(int(p.model.ipcm.sum()) for p in pics)
    cu_qps = sorted({int(q) for p in pics for q in np.unique(p.model.qp)})
    if name == "pcm":
        units = pics[0].model.ipcm.size
        # the noisy left half is PCM, the smooth right half is not
        assert 0 < pcm_units < frames * units, pcm_units
    else:
        assert pcm_units == 0
    if name == "dqp":
        assert len(cu_qps) > 1, cu_qps
    elif name in ("qp22", "qp51"):
        assert cu_qps == [int(name[2:])]
    assert len(switches) == frames
    if name == "nofilt":
        assert switches == [(True, False)] * frames
    else:
        assert not any(off for off, _sao in switches)
