"""The port decodes partitioned pictures: slices, tiles, WPP, dependent
slices and their mixes, intra and low-delay P, on the CPU.

The streams of ``tests/test_decoder.py``'s partitioned cases, made by the
port's own exact encoder (``thevc_tpu_torch.streams.encode``) from the
``tests/cfg`` cfgs with the same switches, on a 96x64 2-frame clip with
32x32 CTUs (3x2 CTUs a picture), the slice and tile arguments scaled so
that each picture has at least two partitions.  Each stream must decode
through the port with every digest OK and recon byte-identical to the
encoder's; the tiles + slices intra stream and the slices low-delay P
stream also byte-identical to the JAX package's device decode.  Every
picture goes through the port's batched residual collector
(``decoder/recon.py:_collect``).
"""

import contextlib
import io
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from tests.conftest import REPO
from thevc_tpu_torch import streams
from thevc_tpu_torch.apps.decoder import main as port_main
from thevc_tpu_torch.decoder import recon as port_recon

W, H = 96, 64
CFG = REPO / "tests" / "cfg"
CTU = ("--MaxCUWidth=32", "--MaxCUHeight=32", "--MaxPartitionDepth=3")
# name -> (intra, switches); 3x2 CTUs a picture
PARTS = {
    # 2 slices of 3 CTUs
    "slices": (True, ("--SliceMode=1", "--SliceArgument=3")),
    # 2x2 uniform tiles
    "tiles": (True, ("--UniformSpacingIdc=1", "--NumTileColumnsMinus1=1",
                     "--NumTileRowsMinus1=1")),
    # one substream per CTU row
    "wpp": (True, ("--WaveFrontSynchro=1",)),
    # dependent slices of 3 CTUs (CABAC state carried over)
    "dep": (True, ("--DependentSliceMode=1", "--DependentSliceArgument=3")),
    # WPP, low-delay P
    "wppP": (False, ("--WaveFrontSynchro=1",)),
    # 3 explicit-width tile columns, low-delay P
    "tilesP": (False, ("--UniformSpacingIdc=0", "--NumTileColumnsMinus1=2",
                       "--ColumnWidthArray=1 1")),
    # 3 slices, low-delay P
    "slicesP": (False, ("--SliceMode=1", "--SliceArgument=2")),
    # 2 tile columns and slices of 2 CTUs across them
    "ts": (True, ("--UniformSpacingIdc=1", "--NumTileColumnsMinus1=1",
                  "--SliceMode=1", "--SliceArgument=2")),
    # dependent slices of 2 CTUs (a row) with WPP
    "depw": (True, ("--DependentSliceMode=1", "--DependentSliceArgument=2",
                    "--WaveFrontSynchro=1")),
}
# also held against the JAX package's device decode
AGAINST_JAX = ("ts", "slicesP")


@pytest.fixture(scope="module")
def part_streams(tmp_path_factory):
    root = tmp_path_factory.mktemp("partitioned")
    clip = root / "clip.yuv"
    subprocess.run([sys.executable, str(REPO / "tools" / "make_test_clip.py"),
                    str(clip), "--width", str(W), "--height", str(H),
                    "--frames", "2"], check=True, capture_output=True)

    def encode(name):
        intra, switches = PARTS[name]
        cfg = CFG / ("encoder_intra_main.cfg" if intra
                     else "encoder_lowdelay_P_main.cfg")
        frames = 1 if intra else 2
        stream, rec = root / f"{name}.bin", root / f"{name}_rec.yuv"
        streams.encode(clip, stream, rec, W, H, frames, cfg=cfg,
                       extra=("--QP=32", *CTU, *switches))
        return name, (stream, rec, frames)
    # the encoders are child processes: three at a time
    with ThreadPoolExecutor(3) as ex:
        return dict(ex.map(encode, PARTS))


def _run(main, argv):
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = main(argv)
    return rc, log.getvalue()


@pytest.mark.parametrize("name", list(PARTS))
def test_partitioned_stream_decodes(name, part_streams, tmp_path,
                                    monkeypatch):
    stream, rec, frames = part_streams[name]
    collected = []
    real = port_recon._collect

    def spy(*args):
        out = real(*args)
        collected.append(len(out))
        return out
    monkeypatch.setattr(port_recon, "_collect", spy)
    out = tmp_path / "port.yuv"
    rc, log = _run(port_main, ["-b", str(stream), "-o", str(out),
                               "--device", "cpu"])
    assert rc == 0, log
    assert log.count("[MD5:(OK)]") == frames and "ERROR" not in log, log
    assert out.read_bytes() == rec.read_bytes()
    assert len(collected) >= frames
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
