"""Build the port's CUDA kernels into one shared library, at first use.

Every ``simple_tad_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc -c``,
all started together (plain C entry points, no PyTorch headers, so the
build takes seconds), and one link makes
``build/simple_tad_tpu_torch/<hash of the sources>/libstt_torch_kernels.so``
beside the package, which loads with ``ctypes``.  Nothing here runs when a
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh
DTYPE_FLOAT32 = 0
DTYPE_BFLOAT16 = 1
DTYPE_INT8 = 2

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
    """Compile the library unless this source hash is already built: one
    ``nvcc -c`` per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC_DIR), "-o", obj,
                   str(src)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for cmd, _, proc in procs:
            text = proc.communicate()[0]
            log.append(text)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = os.path.join(tmp, LIB_NAME)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", so,
                *(obj for _, obj, _ in procs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}"
                               f"{proc.stderr}")
        (out.parent / "build.log").write_text("".join(log))
        os.replace(so, out)       # atomic: a concurrent loader sees all or none
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
            lib.stt_layernorm_quant.argtypes = [p, p, p, p, p, i, i,
                                                ctypes.c_float, i, p]
            lib.stt_layernorm_quant.restype = i
            lib.stt_add_layernorm_quant.argtypes = [p] * 7 + [
                i, i, ctypes.c_float, i, p]
            lib.stt_add_layernorm_quant.restype = i
            lib.stt_rmsnorm_quant.argtypes = [p, p, p, p, i, i,
                                              ctypes.c_float, i, p]
            lib.stt_rmsnorm_quant.restype = i
            lib.stt_attention_fwd.argtypes = [p, p, p, p, *[i] * 12,
                                              ctypes.c_float, i, p]
            lib.stt_attention_fwd.restype = i
            lib.stt_attention_fwd_lse.argtypes = [p, p, p, p, p, i, i, i, i,
                                                  i, i, i, i, ctypes.c_float,
                                                  i, p]
            lib.stt_attention_fwd_lse.restype = i
            lib.stt_attention_fwd_lse_sep.argtypes = [p, p, p, p, p,
                                                      *[i] * 12,
                                                      ctypes.c_float, i, p]
            lib.stt_attention_fwd_lse_sep.restype = i
            lib.stt_attention_fwd_route.argtypes = [i, i]
            lib.stt_attention_fwd_route.restype = i
            lib.stt_attention_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i,
                                              i, i, i, i, i, i, i, i, i,
                                              ctypes.c_float, ctypes.c_float,
                                              i, p]
            lib.stt_attention_bwd.restype = i
            lib.stt_attention_bwd_sep.argtypes = [p] * 9 + [i] * 14 + [
                ctypes.c_float, ctypes.c_float, i, p]
            lib.stt_attention_bwd_sep.restype = i
            lib.stt_attention_bwd_route.argtypes = [i, i]
            lib.stt_attention_bwd_route.restype = i
            lib.stt_attention_bwd_occupancy.argtypes = [
                i, i, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.stt_attention_bwd_occupancy.restype = i
            lib.stt_attention_delta.argtypes = [p, p, p, i, i, i, i, i, p]
            lib.stt_attention_delta.restype = i
            # the keep source of the dropout kernels: mask, its (batch,
            # head) strides, seed, threshold, 1 / keep, the Philox
            # counter's first head and head count
            keep = [p, ctypes.c_int64, ctypes.c_int64, p, ctypes.c_uint32,
                    ctypes.c_float, i, i]
            lib.stt_attention_fwd_lse_drop.argtypes = [
                p] * 5 + [i] * 12 + [ctypes.c_float] + keep + [i, p]
            lib.stt_attention_fwd_lse_drop.restype = i
            lib.stt_attention_bwd_drop.argtypes = [p] * 9 + [i] * 14 + [
                ctypes.c_float, ctypes.c_float] + keep + [i, p]
            lib.stt_attention_bwd_drop.restype = i
            # ..., out, the wgmma route's bf16 V scratch (or None), sizes
            lib.stt_attention_i8.argtypes = [p] * 7 + [i] * 13 + [
                ctypes.c_float, p]
            lib.stt_attention_i8.restype = i
            lib.stt_attention_i8_route.argtypes = [i]
            lib.stt_attention_i8_route.restype = i
            # the tile width, the blocks an SM (out)
            lib.stt_attention_i8_occupancy.argtypes = [
                i, ctypes.POINTER(ctypes.c_int)]
            lib.stt_attention_i8_occupancy.restype = i
            # qkv, amax, out, the wgmma route's v^T scratch, sizes
            lib.stt_attention_int8.argtypes = [p, p, p, p, i, i, i, i,
                                               ctypes.c_float, p]
            lib.stt_attention_int8.restype = i
            lib.stt_attention_int8_route.argtypes = [i]
            lib.stt_attention_int8_route.restype = i
            lib.stt_attention_q8.argtypes = [p] * 5 + [i] * 13 + [
                ctypes.c_float, i, p]
            lib.stt_attention_q8.restype = i
            lib.stt_w8a8_gemm.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i,
                                          p]
            lib.stt_w8a8_gemm.restype = i
            # ..., the hidden codes' scratch, the stream
            lib.stt_w8a8_mlp.argtypes = [p, i] + [p] * 9 + [i] * 5 + [p] * 2
            lib.stt_w8a8_mlp.restype = i
            lib.stt_error_string.argtypes = [i]
            lib.stt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = load().stt_error_string(code).decode()
        raise RuntimeError(f"{what} kernel failed: CUDA error {code} ({msg})")


def dtype_code(dtype, int8: bool = False) -> int:
    """The csrc/common.cuh code of ``dtype``; int8 only where the caller
    allows it (the int8 GEMMs' input)."""
    if dtype == torch.float32:
        return DTYPE_FLOAT32
    if dtype == torch.bfloat16:
        return DTYPE_BFLOAT16
    if int8 and dtype == torch.int8:
        return DTYPE_INT8
    raise TypeError(f"kernels take float32 or bfloat16"
                    f"{' or int8' if int8 else ''}, not {dtype}")
