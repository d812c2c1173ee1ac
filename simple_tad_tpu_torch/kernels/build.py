"""Build the port's CUDA kernels into one shared library, at first use.

Every ``simple_tad_tpu_torch/csrc/*.cu`` goes through ONE ``nvcc`` call
(plain C entry points, no PyTorch headers, so the build takes seconds)
into ``build/simple_tad_tpu_torch/<hash of the sources>/libstt_torch_kernels.so``
beside the package, then loads with ``ctypes``.  Nothing here runs when a
module is imported: the CPU tests import every module without ``nvcc``.

A missing ``nvcc`` or a failed build raises with the compiler's output.
The compiler's ``-Xptxas -v`` report (registers, shared memory, spills per
kernel) is kept as ``build.log`` beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "simple_tad_tpu_torch"
LIB_NAME = "libstt_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh
DTYPE_FLOAT32 = 0
DTYPE_BFLOAT16 = 1

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    """Digest of every kernel source and the compiler flags."""
    h = hashlib.sha256()
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from "
            f"{CSRC_DIR} at first use and need the CUDA toolkit")
    return nvcc


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> Path:
    """Compile the library unless this source hash is already built."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(CSRC_DIR.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    (out.parent / "build.log").write_text(log)
    os.replace(tmp, out)          # atomic: a concurrent loader sees all or none
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load once, and declare the C entry points."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.stt_layernorm.argtypes = [p, p, p, p, i, i, ctypes.c_float,
                                          i, i, p]
            lib.stt_layernorm.restype = i
            lib.stt_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                              i, i, ctypes.c_float, i, p]
            lib.stt_attention_fwd.restype = i
            lib.stt_error_string.argtypes = [i]
            lib.stt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = load().stt_error_string(code).decode()
        raise RuntimeError(f"{what} kernel failed: CUDA error {code} ({msg})")


def dtype_code(dtype) -> int:
    if dtype == torch.float32:
        return DTYPE_FLOAT32
    if dtype == torch.bfloat16:
        return DTYPE_BFLOAT16
    raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")
