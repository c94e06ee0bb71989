"""The port's copies of the host apps (annexBbytecount, the bit-depth
converter, bitrate targeting) give the JAX package's outputs exactly.

The vectors of ``tests/test_utils.py`` that need no HM oracle run
through both packages: the annex-B self-test of annexBbytecount.cpp,
the byte totals and per-NAL statistics of a stream (here made by the
port's own exact encoder, low-delay B with two temporal layers, whose
log also feeds ExtractBitrates), the ``convert_bitdepth`` round trip,
the lambda-modifier math and the metalog round trip.
"""

import contextlib
import io
import math

import numpy as np
import pytest

from thevc_tpu.apps import annexb_bytecount as ref_annexb
from thevc_tpu.apps import bitrate_targeting as ref_rate
from thevc_tpu.apps import convert_bitdepth as ref_conv
from thevc_tpu_torch import streams
from thevc_tpu_torch.apps import annexb_bytecount as port_annexb
from thevc_tpu_torch.apps import bitrate_targeting as port_rate
from thevc_tpu_torch.apps import convert_bitdepth as port_conv

PACKAGES = {"ref": (ref_annexb, ref_rate, ref_conv),
            "port": (port_annexb, port_rate, port_conv)}

# annexBbytecount.cpp:14-37: ({leading, zero_byte, startcode, payload,
# trailing}, data)
_SELFTEST = [
    ((0, 0, 3, 0, 0), bytes([0, 0, 1])),
    ((0, 1, 3, 0, 0), bytes([0, 0, 0, 1])),
    ((2, 1, 3, 0, 0), bytes([0, 0, 0, 0, 0, 1])),
    ((0, 0, 3, 1, 0), bytes([0, 0, 1, 2])),
    ((0, 0, 3, 2, 0), bytes([0, 0, 1, 2, 0])),
    ((0, 0, 3, 3, 0), bytes([0, 0, 1, 2, 0, 0])),
    ((0, 0, 3, 1, 3), bytes([0, 0, 1, 2, 0, 0, 0])),
    ((0, 0, 3, 1, 0), bytes([0, 0, 1, 2, 0, 0, 1, 3])),
    ((0, 0, 3, 1, 0), bytes([0, 0, 1, 2, 0, 0, 0, 1, 3])),
    ((0, 0, 3, 1, 1), bytes([0, 0, 1, 2, 0, 0, 0, 0, 1, 3])),
]


def _stats(st):
    return (st.leading_zero, st.zero_byte, st.start_code, st.nal_bytes,
            st.trailing_zero)


def _run(main, argv):
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = main(argv)
    return rc, log.getvalue()


@pytest.mark.parametrize("expected,data", _SELFTEST)
def test_annexb_selftest_both_packages(expected, data):
    got = {k: [(p, _stats(st)) for p, st in m[0].scan_nal_units(data)]
           for k, m in PACKAGES.items()}
    assert got["port"] == got["ref"]
    assert got["port"][0][1] == expected


@pytest.fixture(scope="module")
def ldb_stream(tmp_path_factory):
    """A 64x64 2-frame low-delay B stream (two temporal layers) from the
    port's exact encoder, and the encoder's log."""
    root = tmp_path_factory.mktemp("apps")
    clip = streams.tool_clips(root)["clip"]
    stream = root / "ldb.bin"
    log = streams.encode(clip, stream, root / "ldb_rec.yuv", 64, 64, 2,
                         cfg=streams.ROOT / "tests" / "cfg"
                         / "encoder_lowdelay_tlayers.cfg")
    return stream, log


def test_annexb_totals_and_report_both_packages(ldb_stream, tmp_path):
    stream, _log = ldb_stream
    data = stream.read_bytes()
    per_nal = {}
    for k, (annexb, _, _) in PACKAGES.items():
        per_nal[k] = [(p, _stats(st))
                      for p, st in annexb.scan_nal_units(data)]
    assert per_nal["port"] == per_nal["ref"]
    assert len(per_nal["port"]) >= 4    # VPS/SPS/PPS + slices (+SEI)
    assert sum(sum(st) for _, st in per_nal["port"]) == len(data)
    reports = {k: _run(m[0].main, [str(stream)])
               for k, m in PACKAGES.items()}
    assert reports["port"] == reports["ref"] and reports["port"][0] == 0
    assert f"Type2b HRD: {len(data)}" in reports["port"][1]


def test_extract_bitrates_both_packages(ldb_stream):
    _stream, log = ldb_stream
    lines = log.splitlines()
    got = {k: (m[1].extract_bitrates_for_temporal_layers(lines),
               m[1].extract_bitrates_for_qps(lines))
           for k, m in PACKAGES.items()}
    assert got["port"] == got["ref"]
    assert got["port"][0] and all(r > 0 for r in got["port"][0])


@pytest.mark.parametrize("w,h", [(16, 8), (48, 32)])
def test_convert_bitdepth_roundtrip_both_packages(w, h, tmp_path):
    rng = np.random.RandomState(3 + w)
    src = tmp_path / "in8.yuv"
    src.write_bytes(rng.randint(0, 256, 2 * h * w * 3 // 2,
                                np.uint8).tobytes())
    out = {}
    for k, (_, _, conv) in PACKAGES.items():
        up, down = tmp_path / f"{k}10.yuv", tmp_path / f"{k}8.yuv"
        size = ["--SourceWidth", str(w), "--SourceHeight", str(h)]
        conv.main(["-i", str(src), "-o", str(up), *size,
                   "--InputBitDepth", "8", "--OutputBitDepth", "10"])
        conv.main(["-i", str(up), "-o", str(down), *size,
                   "--InputBitDepth", "10", "--OutputBitDepth", "8"])
        out[k] = (up.read_bytes(), down.read_bytes())
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) == 2 * src.stat().st_size
    assert out["port"][1] == src.read_bytes()


# (adjustment, target, [(lm, rate), ...], initial lm, expected): the
# cases of test_utils.py:test_guess_lambda_modifier_math
_LM_CASES = [
    (0.5, 200.0, [(1.0, 100.0)], 1.0, 1.0 + math.log(1.5)),
    (0.5, 140.0, [(2.0, 180.0), (1.0, 100.0)], 1.0, 1.0 + math.log(1.5)),
    (0.5, 50.0, [(1.0, 100.0)], 1.0, 1.0 - math.log(1.25)),
]


@pytest.mark.parametrize("adj,target,points,lm0,expected", _LM_CASES)
def test_guess_lambda_modifier_both_packages(adj, target, points, lm0,
                                             expected):
    got = {k: m[1].guess_lambda_modifier(adj, target, points, lm0)
           for k, m in PACKAGES.items()}
    assert got["port"] == got["ref"]
    assert got["port"] == pytest.approx(expected)


def test_metalog_roundtrip_both_packages():
    text = "-LM0 1.0 -LM1 1.0;100 300\n-LM0 1.2 -LM1 0.9;120 280\n"
    got = {}
    for k, (_, rate, _) in PACKAGES.items():
        metalog = rate.parse_metalog(io.StringIO(text))
        got[k] = (metalog, rate.guess_lambda_modifiers(0.5, [150.0, 250.0],
                                                       metalog))
    assert got["port"] == got["ref"]
    metalog, result = got["port"]
    assert metalog == [([1.0, 1.0], [100.0, 300.0]),
                       ([1.2, 0.9], [120.0, 280.0])]
    assert result[0] > 1.2 and result[1] < 0.9
