"""The port's P/B decode, end to end, on the CPU.

Streams come from the repo's own encoder on a 416x240 motion clip
(``tools/make_test_clip.py --style motion --seed 1234``): low-delay B
(``tests/cfg/encoder_lowdelay_tlayers.cfg``), low-delay P
(``encoder_lowdelay_P_main.cfg``), random access with a GOP of 8
(``encoder_randomaccess_main.cfg``) and low-delay B at 10 bits, all at
QP 32, plus a lossless (transquant-bypass) low-delay B stream of a 64x64
clip.  The port's decode (``device="cpu"``) must verify every digest SEI
and give recon byte-identical to the encoder's and to the JAX package's
device decode (THEVC_DEVICE=1), without reaching the reference's host
inter code.  Weighted prediction: low-delay P (``--wpP=1``) and low-delay
B (``--wpB=1``) streams of a 64x64 fading clip, whose slices carry
weights that are not the defaults, must decode byte-identical to the
encoder's recon and to the JAX package's decode.
"""

import contextlib
import io
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import REPO
from thevc_tpu import native
from thevc_tpu.decoder import inter as ref_inter
from thevc_tpu.decoder import recon as ref_recon
from thevc_tpu_torch import headers, nal, streams
from thevc_tpu_torch.bitstream import InputBitstream
from thevc_tpu_torch.decoder import top as port_top
from thevc_tpu_torch.ops import device as port_device
from thevc_tpu_torch.ops import mc

CFG = REPO / "tests" / "cfg"
LDB = CFG / "encoder_lowdelay_tlayers.cfg"
# name -> (clip, frames, cfg, extra encoder arguments)
STREAMS = {
    "ldb": ("motion", 5, LDB, ("--QP=32",)),
    "ldp": ("motion", 5, CFG / "encoder_lowdelay_P_main.cfg", ("--QP=32",)),
    "ra": ("motion", 9, CFG / "encoder_randomaccess_main.cfg", ("--QP=32",)),
    "ldb_10bit": ("motion", 3, LDB, ("--QP=32", "--InternalBitDepth=10")),
    "lossless_64": ("small", 2, LDB, ("--TransquantBypassEnableFlag=1",
                                      "--CUTransquantBypassFlagValue=1")),
}
CLIPS = {"motion": (416, 240, 9), "small": (64, 64, 2)}


def _clip(out, name):
    w, h, frames = CLIPS[name]
    path = out / f"{name}_{w}x{h}.yuv"
    subprocess.run([sys.executable, str(REPO / "tools" / "make_test_clip.py"),
                    str(path), "--width", str(w), "--height", str(h),
                    "--frames", str(frames), "--seed", "1234", "--style",
                    "motion"], check=True, capture_output=True)
    return path, w, h


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    # load the native core on this thread before any decoder's pool
    # starts: concurrent first calls to native.get_lib() can see None
    assert native.get_lib() is not None
    out = tmp_path_factory.mktemp("torch_inter")
    return out, {name: _clip(out, name) for name in CLIPS}


@pytest.fixture(scope="module")
def inter_streams(work):
    out, clips = work
    made = {}
    for name, (clip, frames, cfg, extra) in STREAMS.items():
        path, w, h = clips[clip]
        bin_path, rec_path = out / f"{name}.bin", out / f"{name}_rec.yuv"
        streams.encode(path, bin_path, rec_path, w, h, frames, cfg=cfg,
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


def _forbidden(*args, **kwargs):
    raise AssertionError("the port reached the reference's host inter code")


@pytest.mark.parametrize("name", list(STREAMS))
def test_port_inter_decode_matches_encoder_jax_and_digests(
        name, inter_streams, tmp_path, monkeypatch):
    from thevc_tpu_torch.apps.decoder import main
    bin_path, rec_path, frames = inter_streams[name]
    port_device.stats_reset()
    mc.launches = 0
    port_out = tmp_path / "port.yuv"
    with monkeypatch.context() as m:
        m.setattr(ref_recon, "_native_inter_prepass", _forbidden)
        for meth in ("predict_cu", "precompute_device", "_predict_pu",
                     "_mc_one"):
            m.setattr(ref_inter.InterPredictor, meth, _forbidden)
        rc, log = _run(main, ["-b", str(bin_path), "-o", str(port_out),
                              "--device", "cpu"])
    assert rc == 0, log
    assert log.count("[MD5:(OK)]") == frames, log
    assert port_device.STATS["launches"] > 0
    assert mc.launches > 0
    assert port_out.read_bytes() == rec_path.read_bytes()

    jax_out = tmp_path / "jax.yuv"
    rc, log = _jax_device_decode(bin_path, jax_out, monkeypatch)
    assert rc == 0 and log.count("[MD5:(OK)]") == frames, log
    assert port_out.read_bytes() == jax_out.read_bytes()


def test_reference_planes_stay_on_the_device(inter_streams):
    """Each reference crosses to the device once (from the filter stage),
    and the planes of pictures the DPB drops are freed."""
    bin_path, _rec, frames = inter_streams["ra"]
    dec = port_top.Decoder("cpu")
    uploads = []
    real = dec.refs.put

    def spy(pic, planes):
        uploads.append(pic.poc)
        return real(pic, planes)
    dec.refs.put = spy
    pics = dec.decode_stream(bin_path.read_bytes())
    assert len(pics) == frames and all(p.digest_ok for p in pics)
    assert sorted(uploads) == list(range(frames))
    assert 0 < len(dec.refs) <= len(dec.dpb.pics)
    assert all(p.referenced for p in (e[0] for e in
                                      dec.refs._by_poc.values()))


_NO_JAX = """
import sys
import thevc_tpu.ops.device as ref_device

def forbidden(*args, **kwargs):
    raise AssertionError("the reference device policy was called")

ref_device.backend_probe = forbidden
ref_device.device_enabled = forbidden
from thevc_tpu_torch.apps.decoder import main
from thevc_tpu_torch.ops import mc
assert main(["-b", sys.argv[1], "--device", "cpu"]) == 0
assert mc.launches > 0
assert "jax" not in sys.modules, sorted(m for m in sys.modules
                                        if m.startswith("jax"))
print("NO_JAX_OK")
"""


def test_port_inter_decode_never_imports_jax(inter_streams):
    bin_path = inter_streams["ldb"][0]
    r = subprocess.run([sys.executable, "-c", _NO_JAX, str(bin_path)],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_OK" in r.stdout


def _make_fade_clip(path, w=64, h=64, n=3):
    """A smooth picture that darkens and brightens frame by frame
    (``tests/test_decoder.py``'s fade clip at 64x64), so that the encoder's
    weighted-prediction analysis sends weights."""
    rng = np.random.RandomState(7)

    def smooth(a):
        out = a.astype(np.float32)
        hh, ww = out.shape
        for _ in range(2):
            p = np.pad(out, 2, mode="edge")
            out = sum(p[i:i + hh, j:j + ww]
                      for i in range(5) for j in range(5)) / 25
        return out
    y0 = smooth(rng.randint(0, 200, (h, w)))
    cb0 = smooth(rng.randint(80, 180, (h // 2, w // 2)))
    cr0 = smooth(rng.randint(80, 180, (h // 2, w // 2)))
    with open(path, "wb") as fh:
        for i in range(n):
            g, off = 1.0 - 0.08 * i, 5 * i
            for plane, o in ((y0, off), (cb0, off / 2), (cr0, off / 2)):
                fh.write(np.clip(plane * g + o, 0, 255).astype(np.uint8)
                         .tobytes())


# name -> (cfg, encoder switch)
WP_STREAMS = {"wpP": (CFG / "encoder_lowdelay_P_main.cfg", "--wpP=1"),
              "wpB": (LDB, "--wpB=1")}


@pytest.fixture(scope="module")
def wp_streams(work):
    out, _clips = work
    clip = out / "fade_64x64.yuv"
    _make_fade_clip(clip)
    made = {}
    for name, (cfg, switch) in WP_STREAMS.items():
        bin_path, rec_path = out / f"{name}.bin", out / f"{name}_rec.yuv"
        streams.encode(clip, bin_path, rec_path, 64, 64, 3, cfg=cfg,
                       extra=(switch, "--QP=32"))
        made[name] = (bin_path, rec_path, 3)
    return made


def _explicit_weights(data: bytes) -> list:
    """(weight, offset, log2 denominator) of every weight a slice header
    of the stream sends that is not the default."""
    dec = port_top.Decoder("cpu")
    found, prev_poc = [], 0
    for u in nal.iter_annexb_nals(data):
        if not nal.is_slice_nal(u.nal_type):
            dec.decode_nal(u)
            continue
        sh, _sps, _pps = headers.parse_slice_header(
            InputBitstream(u.rbsp), u.nal_type, u.temporal_id, dec.sps_map,
            dec.pps_map, prev_poc)
        prev_poc = sh.poc
        wp = getattr(sh, "wp_scaling", None)
        if not wp:
            continue
        for lst in wp["wp"]:
            for ref in lst:
                for comp, entry in enumerate(ref):
                    if entry is None:           # beyond the list's size
                        continue
                    present, weight, offset = entry
                    denom = wp["luma_log2_denom"] if comp == 0 \
                        else wp["chroma_log2_denom"]
                    if present and (weight, offset) != (1 << denom, 0):
                        found.append((weight, offset, denom))
    return found


@pytest.mark.parametrize("name", list(WP_STREAMS))
def test_weighted_prediction_decodes(name, wp_streams, tmp_path,
                                     monkeypatch):
    from thevc_tpu.apps.decoder import main as ref_main
    from thevc_tpu_torch.apps.decoder import main
    bin_path, rec_path, frames = wp_streams[name]
    assert _explicit_weights(bin_path.read_bytes())
    mc.launches = 0
    port_out = tmp_path / "port.yuv"
    rc, log = _run(main, ["-b", str(bin_path), "-o", str(port_out),
                          "--device", "cpu"])
    assert rc == 0 and log.count("[MD5:(OK)]") == frames, log
    assert mc.launches > 0
    assert port_out.read_bytes() == rec_path.read_bytes()
    monkeypatch.setenv("THEVC_DEVICE", "0")
    jax_out = tmp_path / "jax.yuv"
    rc, log = _run(ref_main, ["-b", str(bin_path), "-o", str(jax_out)])
    assert rc == 0 and log.count("[MD5:(OK)]") == frames, log
    assert port_out.read_bytes() == jax_out.read_bytes()
