"""Metric smoothing / epoch logging / JSON-lines log sink.

Behavioral reference: MetricLogger + SmoothedValue + TensorboardLogger
(utils.py:53-222 of the reference) and the per-epoch log.txt JSON-lines
dump (run_frame_finetuning.py:748-752).  Tensorboard is optional
(tensorboardX if importable, silently disabled otherwise); stdout +
log.txt always work.

Copy of simple_tad_tpu/utils/logging.py (pure Python), so the port does
not import the JAX package (tests/test_torch_host_copies.py holds it to
the original).
"""

from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional


class SmoothedValue:
    """Windowed median/avg meter (utils.py:53-112)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", print_freq: int = 10):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_freq = print_freq

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def __str__(self):
        return self.delimiter.join(f"{n}: {m}"
                                   for n, m in self.meters.items())

    def log_every(self, iterable, header: str = ""):
        """Wrap an iterable, printing smoothed meters + ETA every
        print_freq steps (utils.py:152-198)."""
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % self.print_freq == 0 or (total and i == total - 1):
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    print(f"{header} [{i}/{total}] eta: {eta_str} "
                          f"{self} iter_t: {iter_time} data_t: {data_time}",
                          flush=True)
                else:
                    print(f"{header} [{i}] {self} iter_t: {iter_time}",
                          flush=True)
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: "
              f"{str(datetime.timedelta(seconds=int(elapsed)))} "
              f"({elapsed / max(i, 1):.4f} s / it)", flush=True)

    def epoch_stats(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}


class JsonlLogger:
    """Per-epoch JSON-lines sink: <output_dir>/log.txt
    (run_frame_finetuning.py:748-752)."""

    def __init__(self, output_dir: Optional[str]):
        self.path = (os.path.join(output_dir, "log.txt")
                     if output_dir else None)

    def write(self, record: Dict):
        if self.path is None:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")


class TensorboardLogger:
    """Optional tensorboardX sink with the reference's step semantics
    (utils.py:201-222).  No-op when tensorboardX is unavailable."""

    def __init__(self, log_dir: Optional[str]):
        self.writer = None
        self.step = 0
        if log_dir:
            try:
                from tensorboardX import SummaryWriter
                self.writer = SummaryWriter(logdir=log_dir)
            except ImportError:
                pass

    def set_step(self, step: Optional[int] = None):
        self.step = step if step is not None else self.step + 1

    def update(self, head: str = "scalar", step: Optional[int] = None,
               **kwargs):
        if self.writer is None:
            return
        for k, v in kwargs.items():
            if v is not None:
                self.writer.add_scalar(
                    f"{head}/{k}", float(v),
                    self.step if step is None else step)

    def flush(self):
        if self.writer is not None:
            self.writer.flush()
