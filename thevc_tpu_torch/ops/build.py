"""Build and load of the port's hand-written CUDA kernels.

Each kernel is one source under ``csrc/`` with a plain C interface.  It
is compiled with ``nvcc`` for ``sm_90a`` on first use, into
``build/thevc_tpu_torch/`` at the root of the checkout, named by a hash
of the source, the headers of ``csrc/`` it includes and the flags (so
an edited source or header is rebuilt), and loaded with ``ctypes``.  The
compiler's output, with ptxas's register and shared-memory report, is
kept beside the library as ``.log``.  Nothing here runs when the module
is imported.

Every C entry returns a ``cudaError_t`` (0 on success), and every
library exports ``thevc_error_string``; ``check`` raises on a nonzero
code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "thevc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source only: the apply kernel ranks float32 costs, the
# intra RD kernel sums float32 bit estimates, the motion-search kernels
# price candidates and the intra select kernels rank mode, RD and split
# costs in the plain form's order, so no multiply-add may be contracted
SOURCE_FLAGS = {"apply": ("-fmad=false",), "intra_rd": ("-fmad=false",),
                "inter_me": ("-fmad=false",),
                "intra_select": ("-fmad=false",)}

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from source with the CUDA toolkit")
    return str(path)


def flags(name: str) -> tuple:
    """The nvcc flags of ``csrc/<name>.cu``."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and the headers of ``csrc/`` it includes
    (``#include "..."``, followed into the headers), in include order."""
    out = [CSRC / f"{name}.cu"]
    for path in out:
        for line in path.read_text().splitlines():
            m = re.match(r'\s*#\s*include\s+"([^"]+)"', line)
            if m and CSRC / m.group(1) not in out:
                out.append(CSRC / m.group(1))
    return out


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: named by a
    hash of the source, the headers it includes and the flags."""
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources(name))
                            + " ".join(flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def compile_source(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path.  Safe to call from several processes at once: each
    writes a temporary file and renames it into place."""
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = CSRC / f"{name}.cu"
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        r = subprocess.run([_nvcc(), *flags(name), "-o", str(tmp), str(src)],
                           capture_output=True, text=True)
        so.with_suffix(".log").write_text(r.stdout + r.stderr)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, so)
    return so


def load(name: str, entries: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``.  ``entries`` maps
    each C entry point to its ``argtypes``; every entry returns ``int``."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(compile_source(name)))
        for fn, argtypes in entries.items():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = argtypes
        lib.thevc_error_string.restype = ctypes.c_char_p
        lib.thevc_error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.thevc_error_string(rc).decode()} ({rc})")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this dtype and shape
    on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def stream_of(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream
