"""Tracing, step timing and numerics checks.

Port of `keypointnerf_tpu/utils/profiling.py`, one to one:

  * `trace(logdir)` — `torch.profiler` over the block (CPU and, on a card,
    CUDA activity), exported as a Chrome trace to
    `{logdir}/trace.json` (Perfetto or chrome://tracing read it);
  * `span(name)` — the range `kpnerf::<name>` in that trace while a
    profiler records, and a shared no-op context otherwise;
  * `enable_nan_checks()` — autograd's anomaly mode, which names the
    forward operation whose backward produced a NaN;
  * `check_finite(tree)` — whether every tensor of a nested structure is
    finite (a 0-d bool tensor, on the tensors' device);
  * `StepTimer` — a sliding window of step times, with rays / points a
    second.

The layered trace: profile a render or a training step with `trace`,

    from keypointnerf_torch.utils import trace
    with trace("kpn_trace"):
        out = render_image(model, vb, height=512, width=512, chunk=8192)
        torch.cuda.synchronize()

and open `kpn_trace/trace.json` in Perfetto (ui.perfetto.dev): the
program's `kpnerf::` spans lie over the CUDA kernels they launched on one
clock. The spans (a `torch.profiler.profile` of the caller's own, or the
benchmark's traced slice, records the same ones):

  render   `kpnerf::encode` (KeypointNeRF.encode), `render.cull` (the
           empty-ray scores and the top-k of the rays marched),
           `render.chunk` (one chunk's `render_rays`), `render.writeback`
           (the chunks' outputs joined; again for the culled write-back)
  a chunk  `query.lookup` (projection and every map lookup), `query.geo`
           (validity, border weights, spatial encoding, geometry MLP),
           `query.ibr` (the IBR color head), each once a query, two
           queries a chunk; `march.composite` (the coarse composite and
           the fine depths; then the fine composite and its write)
  a step   `step.forward` (the model's forward and the losses),
           `step.backward` (the gradients), `step.optimizer` (the norm
           and the update); `onehot_dmap` (K1, the map gradient, on
           autograd's thread)
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch
from torch.autograd import profiler as autograd_profiler

from ..device import tracing


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


_OFF = contextlib.nullcontext()


def span(name: str):
    """The range `kpnerf::<name>` of the program's layer `name`: a
    `record_function` while a profiler records (`trace`, or any
    `torch.profiler.profile`), else one shared no-op context, so a span
    costs one check when nothing records. Inside a torch.compile /
    torch.export trace it is the no-op, and no profiler op enters the
    traced graph."""
    if not autograd_profiler._is_profiler_enabled or tracing():
        return _OFF
    return torch.profiler.record_function("kpnerf::" + name)


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
