"""Tracing and step timing (counterpart of ``mlx_vae_tpu/utils/profiler.py``).

* ``trace(logdir)``: a context manager around ``torch.profiler`` that
  records the host and the card and writes a Chrome trace
  (``trace.json``, open it in ``chrome://tracing`` or Perfetto) into
  ``logdir``; the JAX version writes a TensorBoard trace.
* ``StepTimer``: steady-state tokens-per-second counter with warm-up
  skipping, copied from the JAX module.

The JAX module's ``debug_nans`` toggles a JAX option and has no counterpart.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Record a ``torch.profiler`` trace into ``logdir/trace.json`` (no-op
    when ``logdir`` is None)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / "trace.json"))
    print(f"    Saved trace: {path / 'trace.json'}")


class StepTimer:
    """Tokens/sec counter. ``tick(tokens)`` per step; warmup steps ignored."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.steps = 0
        self.tokens = 0
        self._t0 = None

    def tick(self, tokens: int) -> None:
        self.steps += 1
        if self.steps == self.warmup:
            self._t0 = time.perf_counter()
            self.tokens = 0
        elif self.steps > self.warmup:
            self.tokens += tokens

    @property
    def tokens_per_sec(self) -> float:
        if self._t0 is None or self.tokens == 0:
            return 0.0
        return self.tokens / (time.perf_counter() - self._t0)
