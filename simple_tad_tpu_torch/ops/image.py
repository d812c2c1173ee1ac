"""Device-side image preprocessing for the eval path.

Port of simple_tad_tpu/ops/image.py.  The resize differs on purpose: the
JAX package resizes with ``jax.image.resize`` cubic (Keys a = -0.5), while
the reference's pixel path is cv2 ``INTER_CUBIC`` (a = -0.75).  The port's
device resize is ``F.interpolate(mode="bicubic", align_corners=False)``,
which is a = -0.75 with cv2's half-pixel mapping, clamped to [0, 255], so
it follows the reference.  Frames stay channels-last (..., H, W, C) at the
public functions, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def resize_bicubic(frames: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W, C) frames -> (..., size[0], size[1], C) fp32, clamped to
    [0, 255]."""
    lead = frames.shape[:-3]
    H, W, C = frames.shape[-3:]
    x = frames.reshape(-1, H, W, C).permute(0, 3, 1, 2).float()
    y = F.interpolate(x, size=tuple(size), mode="bicubic",
                      align_corners=False).clamp_(0.0, 255.0)
    return y.permute(0, 2, 3, 1).reshape(*lead, size[0], size[1], C)


def normalize(frames: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD,
              dtype=torch.float32) -> torch.Tensor:
    """[0, 255] frames -> (x / 255 - mean) / std in ``dtype``."""
    m = torch.as_tensor(np.asarray(mean, np.float32), device=frames.device)
    s = torch.as_tensor(np.asarray(std, np.float32), device=frames.device)
    return ((frames.float() / 255.0 - m) / s).to(dtype)


def make_windows(frames: torch.Tensor, window_idx: torch.Tensor) -> torch.Tensor:
    """Gather sliding windows: frames (F, H, W, C), window_idx (W, T) ->
    (W, T, H, W, C).  Each source frame is decoded and moved once even
    though stride-1 windows reuse it up to T times."""
    return frames[window_idx]


def pad_to_square(frames: torch.Tensor, mode: str = "black",
                  fill=None) -> torch.Tensor:
    """Pad (..., H, W, C) frames to square along the shorter side, evenly
    split (the extra row or column after): 'black' pads zeros, 'color'
    pads ``fill`` (one value per channel; without it, black),
    'replicate' repeats the edge rows or columns.  Port of the JAX
    package's pad_to_square (reference: pad_wide_clips'
    deterministic modes, video_transforms.py:1301-1337)."""
    h, w = frames.shape[-3], frames.shape[-2]
    if h == w:
        return frames
    diff = abs(h - w)
    lo = diff // 2
    axis = frames.ndim - (3 if h < w else 2)
    n = frames.shape[axis]
    if mode == "replicate":
        idx = torch.arange(-lo, n + diff - lo, device=frames.device)
        return frames.index_select(axis, idx.clamp_(0, n - 1))
    shape = list(frames.shape)
    shape[axis] = n + diff
    if mode == "color" and fill is not None:
        value = torch.as_tensor(np.asarray(fill), device=frames.device
                                ).to(frames.dtype)
        out = value.expand(shape).clone()
    else:
        out = frames.new_zeros(shape)
    out.narrow(axis, lo, n).copy_(frames)
    return out
