"""Tube / random masking for masked-video-modeling pre-training.

Copy of simple_tad_tpu/data/masking.py (numpy only; the port cannot import
the JAX package), held to the original by tests/test_torch_host_copies.py.
References: masking_generator.py (tube: one random mask over the H*W patch
grid per sample, tiled identically across all temporal slots) and the IV2
reference's datasets/masking_generator.py:28-49 (random: one mask over all
T*H*W patches, the IV2 pre-training scripts' ``--mask_type random``).
Vectorized to emit whole batches at once. The reference's third mask type,
``attention``, is drawn from a teacher on the device and is not a
generator (train/distill.py:attention_mask_from_importance).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class TubeMaskingGenerator:
    """np.random-based per-sample generator (reference-compatible API)."""

    def __init__(self, input_size: Tuple[int, int, int], mask_ratio: float):
        self.frames, self.height, self.width = input_size
        self.num_patches_per_frame = self.height * self.width
        self.total_patches = self.frames * self.num_patches_per_frame
        self.num_masks_per_frame = int(mask_ratio * self.num_patches_per_frame)
        self.total_masks = self.frames * self.num_masks_per_frame

    def __call__(self, rng: np.random.Generator = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        per_frame = np.zeros(self.num_patches_per_frame, bool)
        per_frame[rng.choice(self.num_patches_per_frame,
                             self.num_masks_per_frame, replace=False)] = True
        return np.tile(per_frame, self.frames)

    def batch(self, batch_size: int,
              rng: np.random.Generator = None) -> np.ndarray:
        """(B, total_patches) bool, True = masked; equal count per sample."""
        rng = rng or np.random.default_rng()
        n = self.num_patches_per_frame
        k = self.num_masks_per_frame
        # vectorized shuffle: argsort of uniform noise per row
        order = np.argsort(rng.random((batch_size, n)), axis=1)
        per_frame = np.zeros((batch_size, n), bool)
        np.put_along_axis(per_frame, order[:, :k], True, axis=1)
        return np.tile(per_frame, (1, self.frames))


class RandomMaskingGenerator:
    """Per-token random masking over the full T*H*W grid (no temporal
    tiling) — IV2's ``--mask_type random``
    (datasets/masking_generator.py:28-49)."""

    def __init__(self, input_size: Tuple[int, int, int], mask_ratio: float):
        if not isinstance(input_size, tuple):
            input_size = (input_size,) * 3
        self.frames, self.height, self.width = input_size
        self.num_patches = self.frames * self.height * self.width
        self.num_mask = int(mask_ratio * self.num_patches)
        self.total_masks = self.num_mask   # loader-facing alias

    def __call__(self, rng: np.random.Generator = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        mask = np.zeros(self.num_patches, bool)
        mask[rng.choice(self.num_patches, self.num_mask, replace=False)] = True
        return mask

    def batch(self, batch_size: int,
              rng: np.random.Generator = None) -> np.ndarray:
        """(B, total_patches) bool, True = masked; equal count per sample."""
        rng = rng or np.random.default_rng()
        order = np.argsort(rng.random((batch_size, self.num_patches)), axis=1)
        mask = np.zeros((batch_size, self.num_patches), bool)
        np.put_along_axis(mask, order[:, :self.num_mask], True, axis=1)
        return mask


def make_mask_generator(mask_type: str, input_size, mask_ratio: float):
    """``--mask_type`` dispatch (run_distill.py:44 choices minus
    ``attention``, which is teacher-derived, not pre-generated)."""
    if mask_type == "tube":
        return TubeMaskingGenerator(input_size, mask_ratio)
    if mask_type == "random":
        return RandomMaskingGenerator(input_size, mask_ratio)
    raise ValueError(f"unknown mask_type {mask_type!r} "
                     "(expected 'tube' or 'random')")
