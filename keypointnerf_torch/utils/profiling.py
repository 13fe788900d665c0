"""Tracing, step timing and numerics checks.

Port of `keypointnerf_tpu/utils/profiling.py`, one to one:

  * `trace(logdir)` — `torch.profiler` over the block (CPU and, on a card,
    CUDA activity), exported as a Chrome trace to
    `{logdir}/trace.json` (Perfetto or chrome://tracing read it);
  * `annotate(name)` — a named range in that trace
    (`torch.profiler.record_function`);
  * `enable_nan_checks()` — autograd's anomaly mode, which names the
    forward operation whose backward produced a NaN;
  * `check_finite(tree)` — whether every tensor of a nested structure is
    finite (a 0-d bool tensor, on the tensors' device);
  * `StepTimer` — a sliding window of step times, with rays / points a
    second.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block and write `{logdir}/trace.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named range that shows in `trace`'s output."""
    return torch.profiler.record_function(name)


def enable_nan_checks(enable: bool = True) -> None:
    """Autograd anomaly mode: a backward that produces a NaN raises and
    names the forward operation behind it (slow; for debugging)."""
    torch.autograd.set_detect_anomaly(enable)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def check_finite(tree) -> torch.Tensor:
    """Whether every tensor in a nested dict / list / tuple is finite, as a
    0-d bool tensor (no host sync until the caller reads it)."""
    ok = torch.tensor(True)
    for t in _tensors(tree):
        ok = ok.to(t.device) & torch.isfinite(t).all()
    return ok


class StepTimer:
    """Sliding-window step timing with derived throughput counters."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def mean_step_s(self) -> float:
        return sum(self._times) / len(self._times) if self._times else float("nan")

    def throughput(self, items_per_step: int) -> float:
        s = self.mean_step_s
        return items_per_step / s if s == s and s > 0 else float("nan")

    def metrics(self, rays_per_step: Optional[int] = None,
                points_per_step: Optional[int] = None) -> Dict[str, float]:
        out = {"step_time_s": self.mean_step_s}
        if rays_per_step:
            out["rays_per_sec"] = self.throughput(rays_per_step)
        if points_per_step:
            out["points_per_sec"] = self.throughput(points_per_step)
        return out
