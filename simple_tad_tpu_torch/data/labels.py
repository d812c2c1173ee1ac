"""Time-to-collision vectors and sigmoid-smoothed soft labels (numpy).

Behavioral reference: reference/dataset/data_utils.py:6-75.  Vectorized
numpy instead of per-frame python loops; exact semantics preserved:

compute_time_vector(labels, fps, TT, TA) per frame i:
  * label==1                                  -> 0
  * next anomaly within TT seconds ahead      -> -(dist)/fps   (negative)
  * last anomaly within TA seconds behind     -> +(dist)/fps   (positive)
  * otherwise                                 -> -100
(TT has priority over TA.)

smooth_labels: before-ramp 1/(1+exp(-kb*(x+xb))), after-ramp
1/(1+exp(-ka*(-x+xa))) with kb=12/TT, xb=TT/2, ka=12/TA, xa=TA/2 producing a
2-channel (safe, anomaly) soft target for the '2bce' loss.
"""

from __future__ import annotations

import numpy as np


def compute_time_vector(labels, fps: int, TT: float = 2.0, TA: float = 1.0
                        ) -> np.ndarray:
    labels = np.asarray(labels)
    n = len(labels)
    tv = np.zeros(n, dtype=np.float64)
    anom = np.flatnonzero(labels == 1)
    if anom.size == 0:
        return tv

    TT_frames = int(TT * fps)
    TA_frames = int(TA * fps)
    idx = np.arange(n)

    # distance to next anomaly at-or-after each frame (inf if none)
    pos = np.searchsorted(anom, idx, side="left")
    dist_next = np.where(pos < anom.size,
                         anom[np.minimum(pos, anom.size - 1)] - idx, np.inf)
    # distance since previous anomaly at-or-before each frame (inf if none)
    pos_b = np.searchsorted(anom, idx, side="right") - 1
    dist_prev = np.where(pos_b >= 0, idx - anom[np.maximum(pos_b, 0)], np.inf)

    is_anom = labels == 1
    before = (~is_anom) & (dist_next > 0) & (dist_next <= TT_frames)
    after = (~is_anom) & ~before & (dist_prev > 0) & (dist_prev <= TA_frames)

    tv[before] = -dist_next[before] / fps
    tv[after] = dist_prev[after] / fps
    tv[~is_anom & ~before & ~after] = -100.0
    return tv


def smooth_labels(labels, time_vector, before_limit: float = 2.0,
                  after_limit: float = 1.0) -> np.ndarray:
    """Returns (N, 2) float32 [safe, anomaly] soft targets."""
    labels = np.asarray(labels, dtype=np.float64)
    tv = np.asarray(time_vector, dtype=np.float64)
    xb, xa = before_limit / 2.0, after_limit / 2.0
    kb, ka = 12.0 / before_limit, 12.0 / after_limit

    target = (labels == 1).astype(np.float64)
    before = (tv >= -before_limit) & (tv < 0)
    after = (tv > 0) & (tv <= after_limit)
    target[before] = 1.0 / (1.0 + np.exp(-kb * (tv[before] + xb)))
    target[after] = 1.0 / (1.0 + np.exp(-ka * (-tv[after] + xa)))
    return np.stack([1.0 - target, target], axis=-1).astype(np.float32)
