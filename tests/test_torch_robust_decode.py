"""The port's error-resilient and random-access decode on the CPU, held
against the JAX package's ``Decoder()`` as ``tests/test_robustness.py``
runs it (tolerance 0: POC lists, digest flags, every picture's planes).

The streams come from the port's own exact encoder
(``thevc_tpu_torch.streams.robust_streams``, 176x144, the ``tests/cfg``
cfgs; ``test_robustness.py`` makes them with HM):

- lost-picture concealment: the low-delay P stream without its 3rd slice
  NAL (POC 2, a reference of POC 3 and 4 under the cfg's GOP of 2);
- random-access entry: ``skip_frames=9`` on the 17-frame random-access
  stream lands on its CRA at POC 16; the CRA rewritten as a BLA drops
  its TFD leading pictures 9-15; ``skip_frames=1`` on the all-intra
  stream, whose second picture is no random-access point, gives nothing;
- the temporal-layer cap: ``max_temporal_layer=0`` on the low-delay B
  stream keeps the even POCs; ``-s`` and ``-t`` through the decoder CLI
  give the JAX package's CLI output;
- the concealed picture reaches the device planes once, when POC 3
  first refers to it, and stays while POC 4 does;
- the batched all-intra decode equals the serial one (and the JAX
  package's, with ``os.cpu_count`` patched to 4 and then to 1);
- the long-term reference lists of ``test_robustness.py:147-233``
  against the port's ``refpic``, ``headers`` and
  ``arrange_longterm_pictures_in_rps``;
- 12 seeded corrupted variants of the random-access stream (bit flips
  and truncations): each decodes or raises a Python exception, and the
  clean stream decodes digest-OK afterwards.

The same decodes run on ``cuda`` against ``cpu`` in
``tests/test_torch_kernels.py`` and in ``chip_smoke.py``.
"""

import contextlib
import importlib
import io
import os

import numpy as np
import pytest
import torch

from thevc_tpu_torch import nal, streams
from thevc_tpu_torch.decoder.top import Decoder

FUZZ_TRIALS = 12


@pytest.fixture(scope="module")
def robust(tmp_path_factory):
    return streams.robust_streams(tmp_path_factory.mktemp("robust"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's waiting threads slow the other workers' tests when they
    outnumber the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _decode(make, data):
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        pics = make().decode_stream(data)
    return pics, log.getvalue()


def _jax_decoder(**kw):
    """The JAX package's decoder, its native core loaded first (R8 in
    ROADMAP: the batched all-intra decode's threads race to load it)."""
    from thevc_tpu.decoder.top import Decoder as JaxDecoder
    from thevc_tpu.native import get_lib
    get_lib()
    return JaxDecoder(**kw)


def _assert_same(a, b):
    assert [p.poc for p in a] == [p.poc for p in b]
    assert [p.digest_ok for p in a] == [p.digest_ok for p in b]
    for pa, pb in zip(a, b):
        for x, y in zip(pa.frame.planes(), pb.frame.planes()):
            assert np.array_equal(x, y), pa.poc


@pytest.mark.parametrize("case", list(streams.ROBUST_CASES))
def test_robust_decode_equals_jax(case, robust):
    data, kw, pocs = streams.robust_case(robust, case)
    port, port_log = _decode(lambda: Decoder("cpu", **kw), data)
    ref, ref_log = _decode(lambda: _jax_decoder(**kw), data)
    assert [p.poc for p in port] == pocs
    _assert_same(port, ref)
    if case == "conceal":
        for log in (port_log, ref_log):
            assert "inserting lost poc : 2" in log
            assert "copying picture 1 to 2" in log
        # POC 2 is POC 1's copy (no digest to check); 0 and 1 decoded
        # before the loss are exact, the rest predict from the copy
        assert [p.digest_ok for p in port] == [True, True, None] + \
            [False] * 6
        assert np.array_equal(port[2].frame.y, port[1].frame.y)
    else:
        assert "inserting lost poc" not in port_log + ref_log
        assert all(p.digest_ok is True for p in port)


@pytest.mark.parametrize("case", ["skip_to_cra", "tlayer0"])
def test_cli_skip_and_temporal_layer_equal_jax(case, robust, tmp_path):
    """``-s`` and ``-t`` through the port's decoder CLI give the JAX
    package's CLI output, byte for byte."""
    from thevc_tpu.apps.decoder import main as ref_main
    from thevc_tpu_torch.apps.decoder import main as port_main
    data, kw, pocs = streams.robust_case(robust, case)
    stream = tmp_path / "in.bin"
    stream.write_bytes(data)
    flags = [a for k, v in kw.items()
             for a in (streams.ROBUST_CLI[k], str(v))]
    out = {}
    for name, main, extra in (("port", port_main, ["--device", "cpu"]),
                              ("ref", ref_main, [])):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            rc = main(["-b", str(stream), "-o", str(tmp_path / f"{name}.yuv"),
                       *flags, *extra])
        lines = [ln for ln in log.getvalue().splitlines()
                 if ln.startswith("POC")]
        out[name] = (rc, lines, (tmp_path / f"{name}.yuv").read_bytes())
    assert out["port"] == out["ref"]
    rc, lines, yuv = out["port"]
    assert rc == 0 and len(lines) == len(pocs)
    assert all(ln.endswith("[MD5:(OK)]") for ln in lines)
    pics, _ = _decode(lambda: Decoder("cpu", **kw), data)
    assert yuv == b"".join(pl.astype(np.uint8).tobytes() for p in pics
                           for pl in p.frame.planes())


def test_concealed_reference_uploaded_once(robust, monkeypatch):
    """The concealed POC 2 reaches the decoder's device planes when POC 3
    first asks for it, once: it stays there while POC 4 still refers to
    it, and every decoded picture is put there once."""
    from thevc_tpu_torch.decoder import inter
    puts = []
    real = inter.RefPlanes.put

    def spy(self, pic, planes):
        puts.append(pic.poc)
        return real(self, pic, planes)
    monkeypatch.setattr(inter.RefPlanes, "put", spy)
    data, kw, pocs = streams.robust_case(robust, "conceal")
    pics, _ = _decode(lambda: Decoder("cpu", **kw), data)
    assert [p.poc for p in pics] == pocs
    assert sorted(puts) == pocs
    # POC 2 was put by RefPlanes.get (after POC 1's filter stage, before
    # POC 3's)
    assert puts.index(2) == puts.index(1) + 1


@pytest.mark.parametrize("cpus", [4, 1])
def test_batched_all_intra_equals_serial(cpus, robust, monkeypatch):
    stream, rec, frames = robust["intra"]
    data = stream.read_bytes()
    monkeypatch.setattr(os, "cpu_count", lambda: cpus)
    batched, _ = _decode(lambda: Decoder("cpu"), data)
    serial = Decoder("cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        for unit in nal.iter_annexb_nals(data):
            serial.decode_nal(unit)
        serial.flush()
    serial = sorted(serial.pictures, key=lambda p: p.poc)
    ref, _ = _decode(_jax_decoder, data)
    assert len(batched) == frames
    assert all(p.digest_ok is True for p in batched)
    _assert_same(batched, serial)
    _assert_same(batched, ref)
    got = b"".join(pl.astype(np.uint8).tobytes() for p in batched
                   for pl in p.frame.planes())
    assert got == rec.read_bytes()


class _FakePic:
    def __init__(self, poc):
        self.poc = poc
        self.referenced = True
        self.is_long_term = False
        self.is_used_as_long_term = False
        self.check_lt_msb = False


def _lt_rps(params, cur_poc, st_deltas, lt_pocs):
    rps = params.ReferencePictureSet()
    rps.num_negative_pics = len(st_deltas)
    rps.delta_poc = list(st_deltas) + [p - cur_poc for p in lt_pocs]
    rps.used = [True] * (len(st_deltas) + len(lt_pocs))
    rps.num_longterm_pics = len(lt_pocs)
    rps.poc = [0] * len(st_deltas) + list(lt_pocs)
    rps.check_lt_msb = [False] * (len(st_deltas) + len(lt_pocs))
    return rps


def _lt_lists(pkg):
    """setRefPicList with one long-term entry, and
    checkThatAllRefPicsAreAvailable with and without it, through
    ``pkg``'s ``refpic`` (TComSlice.cpp:402-470, :917)."""
    params = importlib.import_module(f"{pkg}.params")
    refpic = importlib.import_module(f"{pkg}.decoder.refpic")
    dpb = refpic.Dpb()
    for poc in (0, 7):
        dpb.add(_FakePic(poc))
    sh = params.SliceHeader()
    sh.poc = 8
    sh.slice_type = 1  # P
    sh.num_ref_idx = [2, 0]
    sh.ref_pic_list_modification_flag = [False, False]
    sh.rps = _lt_rps(params, 8, [-1], [0])
    l0, l1 = refpic.build_ref_lists(sh, dpb, bits_for_poc=8)
    out = {"l0": [(p.poc, p.is_long_term, p.is_used_as_long_term)
                  for p in l0], "l1": [p.poc for p in l1],
           "all_present": refpic.check_all_ref_pics_available(
               sh, dpb, -1, 8)}
    dpb.pics = [p for p in dpb.pics if p.poc != 0]
    sh2 = params.SliceHeader()
    sh2.poc = 8
    sh2.rps = _lt_rps(params, 8, [-1], [0])
    out["lt_lost"] = refpic.check_all_ref_pics_available(sh2, dpb, -1, 8)
    return out


def test_longterm_ref_list_construction():
    port = _lt_lists("thevc_tpu_torch")
    assert port == _lt_lists("thevc_tpu")
    # the long-term picture after the short-term one, flagged long-term;
    # with it gone, lostPoc + 1
    assert port["l0"] == [(7, False, False), (0, True, True)]
    assert port["all_present"] == 0 and port["lt_lost"] == 1


def _lt_roundtrip(pkg, data):
    """Two long-term entries grafted onto a parsed P-slice header,
    arranged, written and parsed again through ``pkg``."""
    headers = importlib.import_module(f"{pkg}.headers")
    bitstream = importlib.import_module(f"{pkg}.bitstream")
    nal_mod = importlib.import_module(f"{pkg}.nal")
    refpic = importlib.import_module(f"{pkg}.decoder.refpic")
    arrange = importlib.import_module(
        f"{pkg}.encoder.top").arrange_longterm_pictures_in_rps
    sps_map, pps_map = {}, {}
    sh = sps = pps = None
    prev_poc = 0
    for u in nal_mod.iter_annexb_nals(data):
        bs = bitstream.InputBitstream(u.rbsp)
        if u.nal_type == nal_mod.NAL_UNIT_SPS:
            s = headers.parse_sps(bs)
            sps_map[s.sps_id] = s
        elif u.nal_type == nal_mod.NAL_UNIT_PPS:
            p = headers.parse_pps(bs)
            pps_map[p.pps_id] = p
        elif nal_mod.is_slice_nal(u.nal_type) and u.nal_type != \
                nal_mod.NAL_UNIT_CODED_SLICE_IDR:
            sh, sps, pps = headers.parse_slice_header(
                bs, u.nal_type, u.temporal_id, sps_map, pps_map, prev_poc)
            if sh.poc >= 4:
                break
            prev_poc = sh.poc
    assert sh is not None and sh.poc >= 4
    sps.long_term_refs_present = True
    rps = sh.rps
    n_st = rps.num_negative_pics + rps.num_positive_pics
    rps.delta_poc = rps.delta_poc[:n_st] + [0 - sh.poc, 1 - sh.poc]
    rps.used = rps.used[:n_st] + [True, False]
    rps.poc = [0] * n_st + [0, 1]
    rps.num_longterm_pics = 2
    rps.check_lt_msb = [False] * (n_st + 2)
    # the inter-RPS index is relative to the slice header's position
    # (TDecCAVLC.cpp:938)
    if rps.inter_rps_prediction:
        ref_idx = sh.rps_idx - 1 - rps.delta_ridx_minus1
        rps.delta_ridx_minus1 = len(sps.rps_list) - 1 - ref_idx
    sh.rps_idx = -1
    dpb = refpic.Dpb()
    for poc in range(sh.poc):
        dpb.add(_FakePic(poc))
    arrange(sh, sps, dpb)
    out = headers.write_slice_header(sh, sps, pps)
    out.write_align_one()
    written = out.get_bytes()
    sh2, _, _ = headers.parse_slice_header(
        bitstream.InputBitstream(written), sh.nal_unit_type,
        sh.temporal_id, sps_map, pps_map, prev_poc)
    rps2 = sh2.rps
    n_st2 = rps2.num_negative_pics + rps2.num_positive_pics
    return {"bytes": written, "n_st": (n_st, n_st2),
            "lt": rps2.num_longterm_pics,
            "got": sorted((rps2.poc[i], rps2.used[i])
                          for i in range(n_st2, n_st2 + 2))}


def test_longterm_slice_header_roundtrip(robust):
    data = robust["ldp"][0].read_bytes()
    port = _lt_roundtrip("thevc_tpu_torch", data)
    assert port == _lt_roundtrip("thevc_tpu", data)
    assert port["lt"] == 2 and port["n_st"][0] == port["n_st"][1]
    assert port["got"] == [(0, True), (1, False)]


def test_corrupted_stream_fuzz(robust):
    """Corrupted streams never crash the port's decoder (its native parse
    included): each decodes or raises a Python exception, and a clean
    decode after them is exact."""
    stream, rec, frames = robust["ra"]
    data = stream.read_bytes()
    outcomes = {}
    for buf in streams.fuzz_variants(data, FUZZ_TRIALS):
        got, _ = streams.decode_outcome(buf)
        kind = got if isinstance(got, str) else "decoded"
        outcomes[kind] = outcomes.get(kind, 0) + 1
    assert sum(outcomes.values()) == FUZZ_TRIALS
    assert outcomes.get("decoded", 0) > 0, outcomes
    pics, _ = _decode(lambda: Decoder("cpu"), data)
    assert len(pics) == frames and all(p.digest_ok is True for p in pics)
