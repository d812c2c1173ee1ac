"""Threaded zip -> JPEG/PNG frame decoding (host side).

Copy of simple_tad_tpu/data/zipreader.py with two changes: cv2 is imported
inside the functions that decode (the port's main path imports no cv2 at
module level), and the native C++ decoder (data/native.py) is an explicit
choice, ``native=True`` (the CLIs' ``--native_decoder``), where the JAX
package takes it by an environment variable and the core count.  Without
it decoding is python zipfile + cv2 in a thread pool.  The native branch
serves ``decode_scaled`` (the train path) too, which the JAX package
decodes with cv2 only.  For sliding-window eval this pairs with
device-side windowing (simple_tad_tpu_torch.ops.image.make_windows) so
every source frame is decoded exactly once instead of up to 16 times.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import zipfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

_POOL: Optional[cf.ThreadPoolExecutor] = None


def _pool() -> cf.ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = cf.ThreadPoolExecutor(
            max_workers=int(os.environ.get("SIMPLE_TAD_DECODE_THREADS",
                                           os.cpu_count() or 8)))
    return _POOL


def _decode_one(buf: bytes, resize: Optional[Tuple[int, int]],
                interpolation: int) -> np.ndarray:
    import cv2
    img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise IOError("failed to decode frame")
    if resize is not None:
        img = cv2.resize(img, dsize=resize, interpolation=interpolation)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _native_frames(zip_path: str, names: Sequence[str]
                   ) -> Optional[np.ndarray]:
    from simple_tad_tpu_torch.data import native
    return native.decode_zip_frames_native(zip_path, names)


def decode_zip_frames(zip_path: str, names: Sequence[str],
                      resize: Optional[Tuple[int, int]] = None,
                      interpolation: Optional[int] = None,
                      native: bool = False) -> List[np.ndarray]:
    """Read ``names`` members from ``zip_path`` and decode to RGB uint8
    (H, W, 3) arrays, optionally cv2-resizing to ``resize`` (w, h) with
    ``interpolation`` (default cv2.INTER_CUBIC).  ``native``: decode with
    the C++ decoder (data/native.py), which raises where it cannot be
    built; members that are not JPEGs of one size take the cv2 path."""
    import cv2
    if interpolation is None:
        interpolation = cv2.INTER_CUBIC
    frames = _native_frames(zip_path, names) if native else None
    if frames is not None:
        if resize is None:
            return list(frames)
        futs = [_pool().submit(cv2.resize, f, resize, None, 0, 0,
                               interpolation) for f in frames]
        return [f.result() for f in futs]
    with zipfile.ZipFile(zip_path, "r") as zf:
        raw = [zf.read(n) for n in names]
    futs = [_pool().submit(_decode_one, b, resize, interpolation) for b in raw]
    return [f.result() for f in futs]


class FrameLRU:
    """Byte-bounded, thread-safe LRU of decoded train frames.

    Training windows at stride ``sampling_rate`` share most of their frames
    with neighbours; a shuffled epoch still revisits every frame ~view_len
    times.  The reference re-decodes every JPEG per window
    (reference/dota.py:333-360); caching the decoded frames cuts the
    host decode rate needed to keep the device fed by up to view_len x
    (bounded by cache size; hits/misses are exposed for the efficiency CLI).
    """

    def __init__(self, max_bytes: int):
        from collections import OrderedDict
        import threading
        self.max_bytes = max_bytes
        self._d = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            arr = self._d.get(key)
            if arr is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return arr

    def put(self, key, arr: np.ndarray):
        nb = arr.nbytes
        if nb > self.max_bytes:
            return
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._d[key] = arr
            self._bytes += nb
            while self._bytes > self.max_bytes and self._d:
                _, ev = self._d.popitem(last=False)
                self._bytes -= ev.nbytes

    def clear(self):
        with self._lock:
            self._d.clear()
            self._bytes = 0
            self.hits = self.misses = 0


_FRAME_CACHE: Optional[FrameLRU] = None


def frame_cache() -> Optional[FrameLRU]:
    """Process-wide decoded-frame LRU; size via SIMPLE_TAD_DECODE_CACHE_MB
    (default 1024, 0 disables)."""
    global _FRAME_CACHE
    if _FRAME_CACHE is None:
        mb = int(os.environ.get("SIMPLE_TAD_DECODE_CACHE_MB", "1024"))
        _FRAME_CACHE = FrameLRU(mb * 2 ** 20) if mb > 0 else None
    return _FRAME_CACHE


def decode_scaled(zip_path: str, names: Sequence[str], crop_size: int,
                  resize_scale: float = 1.0, short_side_cap: int = 320,
                  native: bool = False) -> List[np.ndarray]:
    """Train-path decode: scale so the short side hits
    crop_size*resize_scale, mirroring reference/dota.py:349-355
    (short side capped at ``short_side_cap`` before computing the factor).

    Decoded frames land in the process-wide ``frame_cache`` keyed by
    (zip, member, crop, scale, cap); only cache misses touch the zip.
    ``native``: the misses are decoded by the C++ decoder, as in
    ``decode_zip_frames``."""
    import cv2
    cache = frame_cache()
    keys = [(zip_path, n, crop_size, resize_scale, short_side_cap)
            for n in names]
    out: List[Optional[np.ndarray]] = [None] * len(names)
    missing = list(range(len(names)))
    if cache is not None:
        for i, key in enumerate(keys):
            out[i] = cache.get(key)
        missing = [i for i, f in enumerate(out) if f is None]
        if not missing:
            return out  # type: ignore[return-value]

    def scale(img):
        short = min(min(img.shape[:2]), short_side_cap)
        k = crop_size * resize_scale / short
        return cv2.resize(img, dsize=(0, 0), fx=k, fy=k,
                          interpolation=cv2.INTER_CUBIC)

    def work(buf):
        img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise IOError("failed to decode frame")
        return cv2.cvtColor(scale(img), cv2.COLOR_BGR2RGB)

    decoded = (_native_frames(zip_path, [names[i] for i in missing])
               if native else None)
    if decoded is not None:
        futs = [_pool().submit(scale, f) for f in decoded]
    else:
        with zipfile.ZipFile(zip_path, "r") as zf:
            raw = [zf.read(names[i]) for i in missing]
        futs = [_pool().submit(work, b) for b in raw]
    for i, fut in zip(missing, futs):
        frame = fut.result()
        out[i] = frame
        if cache is not None:
            cache.put(keys[i], frame)
    return out  # type: ignore[return-value]
