"""Binding of the hand-written CUDA residual kernel (``csrc/residual.cu``).

Replaces the Pallas TPU kernel ``thevc_tpu/ops/jx_pallas.py:_kernel``
(:141-187): fused dequant + 2-D inverse DCT/DST over a TU batch of one
size class, int32-exact.  The design notes and what bounds the kernel on
the card are in the source's header comment.  Its plain PyTorch version
is ``ops.tq.residual_pipeline_plain``.

The kernel is compiled with ``nvcc`` for ``sm_90a`` on first use, into
``build/thevc_tpu_torch/`` at the root of the checkout, named by a hash
of the source so an edited source is rebuilt; it is bound with
``ctypes`` through a plain C interface.  Nothing here runs when the
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "residual.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "thevc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches made by residual(); a plain integer that a run resets
# and reads to show that its main path went through the kernel
launches = 0

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the residual kernel is built "
                           "from source with the CUDA toolkit")
    return str(path)


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"residual-{digest[:16]}.so"


def build() -> ctypes.CDLL:
    """Compile (if not built yet) and load the kernel library.  The
    compiler's output, with ptxas's register and shared-memory report,
    is kept beside the library as ``.log``."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                str(_SRC)], capture_output=True, text=True)
            so.with_suffix(".log").write_text(r.stdout + r.stderr)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed on {_SRC.name}:\n"
                                   f"{r.stdout}{r.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.thevc_residual.restype = ctypes.c_int
        lib.thevc_residual.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.thevc_error_string.restype = ctypes.c_char_p
        lib.thevc_error_string.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def residual(x: torch.Tensor, scale: torch.Tensor, basis: torch.Tensor,
             dq_shift: int, sh2: int) -> torch.Tensor:
    """Launch the kernel: int16 coefficients [N, s, s] on a CUDA device,
    per-TU int32 dequant scales [N] and the int32 basis [s, s] -> int16
    residual [N, s, s].  Launches on the current stream without
    synchronising; raises on any input the kernel does not take and on
    a launch error."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"the residual kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dim() != 3 or x.shape[1] != x.shape[2] \
            or x.shape[1] not in (4, 8, 16, 32) or x.shape[0] >= 2 ** 31:
        raise ValueError(f"coefficients must be [N, s, s] with s in "
                         f"4/8/16/32 and N < 2^31, got {tuple(x.shape)}")
    n, s = int(x.shape[0]), int(x.shape[1])
    _check(x, "coefficients", torch.int16, (n, s, s), x.device)
    _check(scale, "scale", torch.int32, (n,), x.device)
    _check(basis, "basis", torch.int32, (s, s), x.device)
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.thevc_residual(x.data_ptr(), scale.data_ptr(),
                                basis.data_ptr(), out.data_ptr(), n, s,
                                dq_shift, sh2, stream)
    if rc != 0:
        raise RuntimeError("residual kernel launch failed: "
                           f"{lib.thevc_error_string(rc).decode()} ({rc})")
    launches += 1
    return out
