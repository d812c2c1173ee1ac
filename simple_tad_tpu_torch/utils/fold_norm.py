"""Fold input normalization into the patch-embed projection.

Port of simple_tad_tpu/utils/fold_norm.py.  The eval pixel path is linear
until the patch-embed matmul:
  x_norm = (u / 255 - mean) / std;   tokens = W^T x_norm + b
so an equivalent projection over RAW [0, 255] pixels is
  W'[.., c, ..] = W[.., c, ..] / (255 * std[c])
  b'            = b - sum over rows of W * mean[c] / std[c]
computed here in float64.  The model is then fed raw pixel values cast to
the compute dtype instead of normalized video.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from simple_tad_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD


def fold_normalization(weight: torch.Tensor, bias: torch.Tensor,
                       mean=IMAGENET_MEAN, std=IMAGENET_STD
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conv3d-shaped patch weight (D, C, t, p, p) and bias (D,) -> folded
    copies in the same dtypes and on the same device."""
    w = weight.detach().to("cpu", torch.float64)
    b = bias.detach().to("cpu", torch.float64)
    mean = torch.as_tensor(np.asarray(mean, np.float64))
    std = torch.as_tensor(np.asarray(std, np.float64))
    shape = (1, -1, 1, 1, 1)
    new_w = w / (255.0 * std).reshape(shape)
    new_b = b - (w * (mean / std).reshape(shape)).sum(dim=(1, 2, 3, 4))
    # through fp32 first, as the JAX package stores the folded fp32 kernel
    # and casts it to the compute dtype at use
    return (new_w.float().to(weight.device, weight.dtype),
            new_b.float().to(bias.device, bias.dtype))
