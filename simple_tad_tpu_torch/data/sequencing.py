"""Sliding-window index generators over per-clip frame sequences.

Behavioral reference: reference/dataset/sequencing.py.  These are pure
index computations (numpy/python, host-side); the semantics that matter for
AUC parity (SURVEY.md §7 'hard parts' #2):

  * fps decimation: ``fps_step = input_fps // seq_frequency``; a window is
    ``seq_length`` indices spaced ``fps_step`` apart,
  * alignment: windows are placed so the LAST window ends exactly at the
    last frame; the first window starts at
    ``(timesteps - actual_len) % step``,
  * a clip shorter than one window yields None.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


class _SequencerBase:
    def __init__(self, seq_frequency: int, seq_length: Union[int, float],
                 step: int = 1):
        assert seq_frequency > 0, "sequence frequency must be positive"
        assert step > 0, "step must be >= 1"
        if isinstance(seq_length, float):
            seq_length = round(seq_length * seq_frequency)
        self.seq_frequency = int(seq_frequency)
        self.seq_length = int(seq_length)
        self.seq_step = int(step)

    def _layout(self, timesteps_nb: int, input_frequency: int):
        """Return (fps_step, span, actual_len, start, stop) or None."""
        assert input_frequency > 0
        assert input_frequency % self.seq_frequency == 0, (
            f"input fps {input_frequency} not divisible by target "
            f"{self.seq_frequency}")
        fps_step = input_frequency // self.seq_frequency
        span = fps_step * self.seq_length
        actual_len = span - (fps_step - 1)   # frames actually covered
        if actual_len > timesteps_nb:
            return None
        start = (timesteps_nb - actual_len) % self.seq_step
        stop = timesteps_nb - actual_len + 1
        return fps_step, span, actual_len, start, stop


class RegularSequencer(_SequencerBase):
    """Evenly-strided windows ending at the clip's final frame."""

    def get_sequences(self, timesteps_nb, input_frequency: int
                      ) -> Optional[List[List[int]]]:
        if not isinstance(timesteps_nb, (int, np.integer)):
            timesteps_nb = len(timesteps_nb)
        layout = self._layout(timesteps_nb, input_frequency)
        if layout is None:
            return None
        fps_step, span, actual_len, start, stop = layout
        seqs = [list(range(s, s + span, fps_step))
                for s in range(start, stop, self.seq_step)]
        assert seqs[-1][-1] == timesteps_nb - 1
        return seqs


class RegularSequencerWithStart(RegularSequencer):
    """RegularSequencer plus an extra window at t=0 when the first regular
    window starts late (> min(0.3*input_fps, 5) frames in)."""

    def get_sequences(self, timesteps_nb, input_frequency: int
                      ) -> Optional[List[List[int]]]:
        if not isinstance(timesteps_nb, (int, np.integer)):
            timesteps_nb = len(timesteps_nb)
        seqs = super().get_sequences(timesteps_nb, input_frequency)
        if seqs is None:
            return None
        layout = self._layout(timesteps_nb, input_frequency)
        fps_step, span, _, start, _ = layout
        if start > min(0.3 * input_frequency, 5):
            seqs.append(list(range(0, span, fps_step)))
        return seqs


class UnsafeOverlapSequencer(_SequencerBase):
    """Regular windows + densified windows ending at/around unsafe labels.

    ``step`` here is in target-frequency units (full_seq_step =
    fps_step * step), matching the reference (sequencing.py:105).
    """

    def __init__(self, seq_frequency: int, seq_length: Union[int, float],
                 step: int = 1,
                 surrounding_timesteps: Union[None, int,
                                              Tuple[int, int]] = None):
        super().__init__(seq_frequency, seq_length, step)
        if not surrounding_timesteps:
            self.surrounding = (0, 0)
        elif isinstance(surrounding_timesteps, int):
            self.surrounding = (surrounding_timesteps, surrounding_timesteps)
        else:
            before, after = surrounding_timesteps
            self.surrounding = (int(before), int(after))

    def get_sequences(self, is_unsafe: Sequence[bool], input_frequency: int
                      ) -> Optional[List[List[int]]]:
        timesteps_nb = len(is_unsafe)
        assert input_frequency % self.seq_frequency == 0
        fps_step = input_frequency // self.seq_frequency
        full_step = fps_step * self.seq_step
        span = fps_step * self.seq_length
        actual_len = span - (fps_step - 1)
        if actual_len > timesteps_nb:
            return None
        start = (timesteps_nb - actual_len) % full_step
        stop = timesteps_nb - actual_len + 1
        ends = [s + actual_len - 1 for s in range(start, stop, full_step)]
        first_end = start + actual_len - 1
        for idx in range(first_end, timesteps_nb):
            if is_unsafe[idx]:
                lo = max(first_end, idx - self.surrounding[0])
                hi = min(timesteps_nb - 1, idx + self.surrounding[1])
                ends.extend(range(lo, hi + 1))
        ends = sorted(set(ends))
        seqs = [list(range(e - actual_len + 1, e + 1, fps_step))
                for e in ends]
        assert seqs[-1][-1] == timesteps_nb - 1
        return seqs
