"""Threaded zip -> JPEG/PNG frame decoding (host side).

Copy of simple_tad_tpu/data/zipreader.py with two changes: cv2 is imported
inside the functions that decode (the port's main path imports no cv2 at
module level), and the native C++ decoder branch is left out, so decoding
is python zipfile + cv2 in a thread pool.  For sliding-window eval this
pairs with device-side windowing (simple_tad_tpu_torch.ops.image.
make_windows) so every source frame is decoded exactly once instead of up
to 16 times.
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


def decode_zip_frames(zip_path: str, names: Sequence[str],
                      resize: Optional[Tuple[int, int]] = None,
                      interpolation: Optional[int] = None
                      ) -> List[np.ndarray]:
    """Read ``names`` members from ``zip_path`` and decode to RGB uint8
    (H, W, 3) arrays, optionally cv2-resizing to ``resize`` (w, h) with
    ``interpolation`` (default cv2.INTER_CUBIC)."""
    import cv2
    if interpolation is None:
        interpolation = cv2.INTER_CUBIC
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
                  resize_scale: float = 1.0, short_side_cap: int = 320
                  ) -> List[np.ndarray]:
    """Train-path decode: scale so the short side hits
    crop_size*resize_scale, mirroring reference/dota.py:349-355
    (short side capped at ``short_side_cap`` before computing the factor).

    Decoded frames land in the process-wide ``frame_cache`` keyed by
    (zip, member, crop, scale, cap); only cache misses touch the zip."""
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

    with zipfile.ZipFile(zip_path, "r") as zf:
        raw = [zf.read(names[i]) for i in missing]

    def work(buf):
        img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise IOError("failed to decode frame")
        short = min(min(img.shape[:2]), short_side_cap)
        k = crop_size * resize_scale / short
        img = cv2.resize(img, dsize=(0, 0), fx=k, fy=k,
                         interpolation=cv2.INTER_CUBIC)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    futs = [_pool().submit(work, b) for b in raw]
    for i, fut in zip(missing, futs):
        frame = fut.result()
        out[i] = frame
        if cache is not None:
            cache.put(keys[i], frame)
    return out  # type: ignore[return-value]
