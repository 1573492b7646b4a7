"""Profiling and observability helpers.

Counterpart of ``lina_speech_tpu/utils/profiling.py``:

- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (open it in Perfetto or ``chrome://tracing``);
- :func:`annotate`: a named range on that timeline
  (``torch.profiler.record_function``);
- :class:`StepTimer`: step wall time with warmup skipping;
- :class:`MetricsLogger`: a JSONL metrics log and a console line, the same
  records as the JAX package's.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, Optional


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[Any]:
    """Profile the block on the CPU and, where there is one, the CUDA
    device; writes ``<logdir>/trace.json`` and yields the profiler (its
    ``key_averages()`` sums device time by kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    import torch

    return torch.profiler.record_function(name)


class StepTimer:
    """Track step wall time with warmup skipping."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.n = 0
        self.total = 0.0
        self.last = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.record(time.perf_counter() - self._t0)

    def record(self, dt: float):
        """Record one step's wall time directly (loops that only wait for
        the device at log points)."""
        self.n += 1
        if self.n > self.warmup:
            self.total += dt
        self.last = dt

    @property
    def mean(self) -> float:
        return self.total / max(self.n - self.warmup, 1)


class MetricsLogger:
    """JSONL metrics log (one ``{"step": n, <metric>: value, ...}`` record a
    line) and a console line every ``print_every`` steps."""

    def __init__(self, path: Optional[str] = None, print_every: int = 1):
        self.path = path
        self.print_every = print_every
        self._fh = open(path, "a") if path else None

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if step % self.print_every == 0:
            parts = " ".join(f"{k}={float(v):.4g}" for k, v in metrics.items())
            print(f"[step {step}] {parts}", flush=True)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
