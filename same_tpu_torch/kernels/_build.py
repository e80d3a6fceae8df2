"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first use
into ``build/same_tpu_torch/lib<name>.so`` under the repository root (listed
in ``.gitignore``), for Hopper only::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
         -shared -Xcompiler -fPIC -o build/same_tpu_torch/lib<name>.so <name>.cu

``--fmad=false`` keeps nvcc from contracting a multiply and an add into an
FMA: the kernels must round like XLA and PyTorch. A library is rebuilt when
its source is newer. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "same_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

_LIBS: dict = {}
_LOCK = threading.Lock()
# nvcc's diagnostics of each build (with -Xptxas -v: registers, spills).
BUILD_LOG: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        out = os.path.join(BUILD_DIR, f"lib{name}.so")
        if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
            BUILD_LOG[name] = proc.stdout + proc.stderr
        lib = ctypes.CDLL(out)
        lib.same_cuda_error_string.restype = ctypes.c_char_p
        lib.same_cuda_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
        return lib


def check_tensors(what: str, device, spec) -> None:
    """Raise unless each ``(name, tensor, dtype, shape)`` of ``spec`` lies on
    ``device`` with that dtype and shape, contiguous."""
    for name, t, dtype, shape in spec:
        if t.device != device:
            raise ValueError(f"{what}: {name} on {t.device}, expected {device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{what}: {name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.same_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
