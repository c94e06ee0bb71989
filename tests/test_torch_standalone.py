"""The port stands alone: it imports nothing of the JAX package.

- No module of ``thevc_tpu_torch`` and not ``chip_smoke.py`` imports
  ``jax``, ``thevc_tpu`` or a ``thevc_tpu.*`` module, or names one of the
  JAX package's apps as a module to run (an AST scan).
- The port's decode of an all-intra and a low-delay B stream and its
  exact-path, ``--FastRD=1`` and ``--FastRD=1 --device-apply`` encodes run
  in a child process that ends with neither ``jax`` nor any
  ``thevc_tpu``/``thevc_tpu.*`` module loaded (64x64, CPU).
- The port's exact-path encoder (its copy of the host codec) writes the
  same bytes as ``python -m thevc_tpu.apps.encoder`` for the intra,
  low-delay B, low-delay P and random-access cfgs of ``tests/cfg`` at
  64x64, and for the intra and low-delay B cfgs at 72x40, whose width and
  height are not multiples of the CTU size.
- The multi-stream modules (``graft_entry``, ``parallel.shared_rc``)
  and the host apps run in a child process that ends with neither
  loaded either.
- The port's native core loads once under a lock: eight threads that call
  ``native.get_lib()`` first, together, all get the library.
"""

import ast
import subprocess
import sys
import textwrap

import pytest

from tests.conftest import REPO
from thevc_tpu_torch import streams

W, H = 64, 64
CFG = REPO / "tests" / "cfg"
# name -> (cfg, frames, width, height)
CFGS = {"intra": ("encoder_intra_main.cfg", 2, W, H),
        "ldb": ("encoder_lowdelay_tlayers.cfg", 3, W, H),
        "ldp": ("encoder_lowdelay_P_main.cfg", 3, W, H),
        "ra": ("encoder_randomaccess_main.cfg", 5, W, H),
        "intra_72x40": ("encoder_intra_main.cfg", 2, 72, 40),
        "ldb_72x40": ("encoder_lowdelay_tlayers.cfg", 3, 72, 40)}


def _port_sources():
    files = sorted((REPO / "thevc_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _is_reference(name: str) -> bool:
    return name == "thevc_tpu" or name.startswith("thevc_tpu.")


def _absolute_imports():
    """(where, module) of every absolute import in the port's sources."""
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                yield f"{path.relative_to(REPO)}:{node.lineno}", n


def test_port_sources_import_nothing_of_the_reference():
    found = [f"{where} {n}" for where, n in _absolute_imports()
             if _is_reference(n)]
    assert not found, found


def test_port_sources_import_no_jax():
    found = [f"{where} {n}" for where, n in _absolute_imports()
             if n == "jax" or n.startswith("jax.")]
    assert not found, found


def test_port_sources_run_no_reference_app():
    found = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and "thevc_tpu.apps" in node.value:
                found.append(f"{path.relative_to(REPO)}:{node.lineno}")
    assert not found, found


def _make_clip(path, width, height):
    subprocess.run([sys.executable, str(REPO / "tools" / "make_test_clip.py"),
                    str(path), "--width", str(width), "--height",
                    str(height), "--frames", "5", "--style", "motion"],
                   check=True, capture_output=True)
    return path


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """5-frame motion clips by (width, height), made at first use."""
    root = tmp_path_factory.mktemp("standalone")
    made = {}

    def get(width, height):
        if (width, height) not in made:
            made[width, height] = _make_clip(
                root / f"clip_{width}x{height}.yuv", width, height)
        return made[width, height]
    return get


@pytest.fixture(scope="module")
def clip(clips):
    return clips(W, H)


_CHILD = textwrap.dedent("""
    import contextlib, io, sys
    from thevc_tpu_torch.apps import decoder, encoder
    clip, out, cfg_dir = sys.argv[1:4]

    def run(main, argv):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            rc = main(argv)
        assert rc == 0, log.getvalue()
        return log.getvalue()

    def enc(name, cfg, frames, *extra):
        run(encoder.main, ["-c", f"{cfg_dir}/{cfg}", "-i", clip,
                           "-b", f"{out}/{name}.bin", "-o",
                           f"{out}/{name}_rec.yuv", "-wdt", "64", "-hgt",
                           "64", "-f", str(frames), "-fr", "30",
                           "--QP=32", "--SEIpictureDigest=1", *extra])
        log = run(decoder.main, ["-b", f"{out}/{name}.bin", "-o",
                                 f"{out}/{name}_dec.yuv", "--device",
                                 "cpu"])
        assert log.count("[MD5:(OK)]") == frames, log
        assert open(f"{out}/{name}_dec.yuv", "rb").read() == \\
            open(f"{out}/{name}_rec.yuv", "rb").read()

    enc("intra", "encoder_intra_main.cfg", 2)
    enc("ldb", "encoder_lowdelay_tlayers.cfg", 3)
    enc("fastrd", "encoder_intra_main.cfg", 2, "--FastRD=1",
        "--device", "cpu")
    enc("devapply", "encoder_intra_main.cfg", 2, "--FastRD=1",
        "--device", "cpu", "--device-apply")
    print("LOADED", sorted(m for m in sys.modules if m == "jax"
                           or m.startswith("jax.") or m == "thevc_tpu"
                           or m.startswith("thevc_tpu.")))
""")


def test_port_decode_and_encode_load_no_jax_and_no_reference(clip,
                                                             tmp_path):
    r = subprocess.run([sys.executable, "-c", _CHILD, str(clip),
                        str(tmp_path), str(CFG)], cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    loaded = [ln for ln in r.stdout.splitlines() if ln.startswith("LOADED")]
    assert loaded == ["LOADED []"], r.stdout[-2000:]


@pytest.mark.parametrize("name", list(CFGS))
def test_exact_encoder_bytes_equal_reference(name, clips, tmp_path):
    cfg, frames, width, height = CFGS[name]
    out = {}
    for module in (streams.ENCODER, "thevc_tpu.apps.encoder"):
        stream = tmp_path / f"{module}.bin"
        recon = tmp_path / f"{module}.yuv"
        streams.encode(clips(width, height), stream, recon, width, height,
                       frames, cfg=CFG / cfg, extra=("--QP=32",),
                       module=module)
        out[module] = (stream.read_bytes(), recon.read_bytes())
    port, ref = out[streams.ENCODER], out["thevc_tpu.apps.encoder"]
    assert len(port[0]) > 0
    assert port[0] == ref[0], f"{name}: the streams differ"
    assert port[1] == ref[1], f"{name}: the encoders' recons differ"


_MULTISTREAM = textwrap.dedent("""
    import contextlib, io, sys
    import torch.distributed as dist
    from thevc_tpu_torch import graft_entry
    from thevc_tpu_torch.apps import (annexb_bytecount, bitrate_targeting,
                                      convert_bitdepth)
    from thevc_tpu_torch.parallel.shared_rc import MeshRatePool
    step, args = graft_entry.entry("cpu")
    assert step(*args).shape == (256, 8, 8)
    dist.init_process_group("gloo", init_method=f"file://{sys.argv[1]}/rv",
                            world_size=1, rank=0)
    assert MeshRatePool(24000, 2).frame_qp(30, 20000, 1) == 32
    dist.destroy_process_group()
    with contextlib.redirect_stdout(io.StringIO()):
        annexb_bytecount.main([sys.argv[2]])
    print("LOADED", sorted(m for m in sys.modules if m == "jax"
                           or m.startswith("jax.") or m == "thevc_tpu"
                           or m.startswith("thevc_tpu.")))
""")


def test_multistream_modules_load_no_jax_and_no_reference(tmp_path):
    stream = tmp_path / "s.bin"
    stream.write_bytes(bytes([0, 0, 0, 1, 0x40, 0x01, 0x0c]))
    r = subprocess.run([sys.executable, "-c", _MULTISTREAM, str(tmp_path),
                        str(stream)], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.splitlines()[-1] == "LOADED []", r.stdout[-2000:]


_THREADS = textwrap.dedent("""
    import threading
    from thevc_tpu_torch import native
    assert native._lib is None
    start = threading.Barrier(8)
    got = []

    def first_call():
        start.wait()
        got.append(native.get_lib())

    threads = [threading.Thread(target=first_call) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 8 and got[0] is not None, got
    assert all(lib is got[0] for lib in got), got
    print("OK")
""")


def test_native_first_calls_from_eight_threads_all_get_the_library():
    r = subprocess.run([sys.executable, "-c", _THREADS], cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0 and r.stdout.strip() == "OK", \
        r.stdout + r.stderr[-4000:]
