"""ctypes binding for the native clip decoder (native/decoder.cpp in this
package): ZIP central-directory caching + threaded inflate / JPEG decode
straight into one contiguous (N, H, W, 3) uint8 RGB buffer.

Port of simple_tad_tpu/data/native.py with three changes:

* the library is built from the package's own copy of the source, at first
  use, by one ``g++`` call into the git-ignored ``build/`` directory beside
  the package (``build/simple_tad_tpu_torch/native/<source hash>/``); the
  JAX package's ``make -C native`` is never run;
* the decoder is an explicit choice (``decode_zip_frames(..., native=True)``,
  the CLIs' ``--native_decoder``), never an environment variable or a core
  count, and a library that cannot be built or loaded raises
  ``NativeDecoderUnavailable`` naming what is missing (``g++``,
  ``jpeglib.h``, ``zlib.h``, the libraries): nothing turns back to cv2
  without saying so;
* the per-zip fallback to python zipfile + cv2 is kept only for what it
  guards, entries that are not JPEG and frames of different sizes within one
  zip, and each such fallback adds one to ``NATIVE_FALLBACKS``.  A member
  the zip lacks raises ``KeyError`` (as ``zipfile`` does); any other decode
  failure raises ``IOError``.
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
from typing import List, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "decoder.cpp"
LIB_NAME = "libstt_decoder.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
LIBS = ("-ljpeg", "-lz", "-lpthread")
JPEG_SUFFIXES = (".jpg", ".jpeg")

# per-zip fallbacks to zipfile + cv2 (non-JPEG entries, mixed frame sizes)
NATIVE_FALLBACKS = 0

_lock = threading.Lock()
_cache_lock = threading.Lock()
_lib = None


class NativeDecoderUnavailable(RuntimeError):
    """The native decoder was asked for and cannot be built or loaded."""


def library_path() -> Path:
    from simple_tad_tpu_torch.kernels.build import BUILD_ROOT
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        CXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD_ROOT / "native" / digest / LIB_NAME


def _missing(text: str) -> str:
    """What a failed compile or link lacks, from its output."""
    for needle, what in (("jpeglib.h", "jpeglib.h (the libjpeg development "
                                       "headers)"),
                         ("zlib.h", "zlib.h (the zlib development headers)"),
                         ("-ljpeg", "the libjpeg library (-ljpeg)"),
                         ("-lz", "the zlib library (-lz)")):
        if needle in text:
            return what
    return "a working C++ toolchain"


def build_native() -> Path:
    """Compile the decoder unless this source is already built -> the
    library's path.  Raises NativeDecoderUnavailable naming what is
    missing."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeDecoderUnavailable(
            "--native_decoder needs g++ to build "
            f"{SOURCE} (g++ not found on PATH)")
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        so = os.path.join(tmp, LIB_NAME)
        cmd = [cxx, *CXX_FLAGS, "-o", so, str(SOURCE), *LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            text = proc.stdout + proc.stderr
            raise NativeDecoderUnavailable(
                f"--native_decoder: building {SOURCE} failed, missing "
                f"{_missing(text)}:\n{' '.join(cmd)}\n{text}")
        os.replace(so, out)       # atomic: a concurrent loader sees all or none
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load once, and declare the C entry points."""
    global _lib
    with _lock:
        if _lib is None:
            path = build_native()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise NativeDecoderUnavailable(
                    f"--native_decoder: cannot load {path}: {e}") from e
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.stt_open_zip.restype = p
            lib.stt_open_zip.argtypes = [ctypes.c_char_p]
            lib.stt_close_zip.argtypes = [p]
            lib.stt_zip_num_entries.argtypes = [p]
            lib.stt_zip_num_entries.restype = i
            lib.stt_zip_entry_name.argtypes = [p, i]
            lib.stt_zip_entry_name.restype = ctypes.c_char_p
            lib.stt_probe.argtypes = [p, ctypes.c_char_p,
                                      ctypes.POINTER(i), ctypes.POINTER(i)]
            lib.stt_probe.restype = i
            lib.stt_decode_frames.argtypes = [
                p, ctypes.POINTER(ctypes.c_char_p), i,
                ctypes.POINTER(ctypes.c_uint8), i, i]
            lib.stt_decode_frames.restype = i
            _lib = lib
        return _lib


class NativeZipDecoder:
    """Per-zip handle with cached central directory; thread-pool decode."""

    def __init__(self, zip_path: str):
        self._lib = load()
        self._handle = self._lib.stt_open_zip(zip_path.encode())
        if not self._handle:
            raise IOError(f"cannot open zip {zip_path}")
        self._dims: Optional[tuple] = None
        self._names: Optional[frozenset] = None
        self.zip_path = zip_path

    def close(self):
        if self._handle:
            self._lib.stt_close_zip(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def entry_names(self) -> List[str]:
        n = self._lib.stt_zip_num_entries(self._handle)
        return [self._lib.stt_zip_entry_name(self._handle, i).decode()
                for i in range(n)]

    def has(self, name: str) -> bool:
        if self._names is None:
            self._names = frozenset(self.entry_names())
        return name in self._names

    def probe(self, name: str) -> Optional[tuple]:
        """-> (H, W) of a JPEG member, or None where it is not a JPEG."""
        h, w = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.stt_probe(self._handle, name.encode(),
                                 ctypes.byref(h), ctypes.byref(w))
        if rc == -1:
            raise IOError(f"cannot read {name} from {self.zip_path}")
        return None if rc != 0 else (h.value, w.value)

    def decode(self, names: Sequence[str],
               hw: Optional[tuple] = None) -> np.ndarray:
        """-> (len(names), H, W, 3) uint8 RGB; every member a JPEG of one
        size (``hw``, else the first member's)."""
        if hw is None:
            if self._dims is None:
                self._dims = self.probe(names[0])
                if self._dims is None:
                    raise IOError(f"{names[0]} in {self.zip_path} is not a "
                                  f"JPEG")
            hw = self._dims
        h, w = hw
        out = np.empty((len(names), h, w, 3), np.uint8)
        arr = (ctypes.c_char_p * len(names))(*[n.encode() for n in names])
        rc = self._lib.stt_decode_frames(
            self._handle, arr, len(names),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w)
        if rc != 0:
            raise IOError(
                f"{rc} frames failed to decode from {self.zip_path}")
        return out


_DECODER_CACHE: dict = {}
_CACHE_LIMIT = 64


def _decoder(zip_path: str) -> NativeZipDecoder:
    with _cache_lock:
        dec = _DECODER_CACHE.get(zip_path)
        if dec is None:
            if len(_DECODER_CACHE) >= _CACHE_LIMIT:
                # dropped, not closed: a loader thread may still be decoding
                # from it; the handle closes with its last reference
                _DECODER_CACHE.pop(next(iter(_DECODER_CACHE)))
            dec = _DECODER_CACHE[zip_path] = NativeZipDecoder(zip_path)
        return dec


def _fallback() -> None:
    global NATIVE_FALLBACKS
    with _cache_lock:
        NATIVE_FALLBACKS += 1


def decode_zip_frames_native(zip_path: str, names: Sequence[str]
                             ) -> Optional[np.ndarray]:
    """The native path of data/zipreader.py:decode_zip_frames -> the frames
    (len(names), H, W, 3) uint8 RGB, or None (counted in NATIVE_FALLBACKS)
    where the members are not all JPEGs of one size, for the caller's
    zipfile + cv2 path.  A missing member raises KeyError; a library that
    cannot be built or loaded, NativeDecoderUnavailable."""
    load()
    dec = _decoder(zip_path)
    for n in names:
        if not dec.has(n):
            raise KeyError(f"There is no item named {n!r} in the archive")
    if not all(n.lower().endswith(JPEG_SUFFIXES) for n in names):
        _fallback()
        return None
    hw = dec.probe(names[0])
    if hw is None:
        _fallback()
        return None
    try:
        return dec.decode(names, hw)
    except IOError:
        # mixed sizes (or a member that is not a JPEG after all) take the
        # cv2 path; any other failure raises
        if any(dec.probe(n) != hw for n in names):
            _fallback()
            return None
        raise
