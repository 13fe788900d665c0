"""Checkpoints with the reference's retention policy, in torch's own format.

Port of `keypointnerf_tpu/utils/checkpoints.py` (orbax there): every save
is kept, training auto-resumes from the latest step, and the best step is
the one of least `val_total_loss` among the saves that carry it (the
reference's ModelCheckpoint, train.py:34-50). A checkpoint is one
directory a step, `{directory}/{step}/`:

  state.pt      `TrainState.state_dict()`: the model's and the optimizer's
                state_dicts and the step counters (`torch.save`)
  metrics.json  the metrics given to `save` ({} when none)
  extra.json    the schedule metadata given to `save`, e.g. the epoch

written under a temporary name and renamed into place, so a reader never
sees half a checkpoint. Saves are synchronous: `wait` and `close` have
nothing to wait for. JAX checkpoints are not read here; weights cross
between the packages through `utils/convert.py`.

With a process `group` (data-parallel training: the state is the same in
every rank) only rank 0 writes, and every rank then passes a barrier, so
no rank reads or resumes a save that is not complete.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import torch

from ..parallel.process_group import barrier, rank


# the metric whose least value marks the best step
MONITOR = "val_total_loss"


class CheckpointManager:
    def __init__(self, directory: str, group=None):
        """`group`: the torch.distributed group whose rank 0 writes (None:
        this process writes)."""
        self._dir = os.path.abspath(directory)
        self._group = group
        self._writes = group is None or rank(group) == 0
        if self._writes:
            os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, str(step))

    def steps(self) -> list:
        """The saved steps, ascending."""
        if not os.path.isdir(self._dir):
            return []
        return sorted(int(n) for n in os.listdir(self._dir) if n.isdigit())

    def save(self, step: int, state: Any, metrics: Optional[dict] = None,
             extra: Optional[dict] = None) -> None:
        """Save `state` (anything with `state_dict()`, a `TrainState`) at
        `step`, with JSON `metrics` (best-step tracking) and `extra`
        (schedule metadata that must survive a restart). A second save of
        the same step replaces the first. With a group, rank 0 writes and
        every rank waits for it."""
        if self._writes:
            self._write(step, state, metrics, extra)
        if self._group is not None:
            barrier("checkpoint", self._group)

    def _write(self, step: int, state: Any, metrics: Optional[dict],
               extra: Optional[dict]) -> None:
        final = self._path(step)
        tmp = os.path.join(self._dir, f".{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state.state_dict(), os.path.join(tmp, "state.pt"))
        for name, d in (("metrics", {k: float(v) for k, v in (metrics or {}).items()}),
                        ("extra", extra or {})):
            with open(os.path.join(tmp, f"{name}.json"), "w") as f:
                json.dump(d, f)
        old = None
        if os.path.exists(final):
            old = os.path.join(self._dir, f".{step}.old-{os.getpid()}")
            os.replace(final, old)
        os.replace(tmp, final)
        if old is not None:
            shutil.rmtree(old)

    def restore(self, step: Optional[int] = None, best: bool = False,
                map_location=None):
        """(the saved state dict, step): the given step, else the best
        monitored step when `best` (the latest when no save has the
        metric), else the latest; (None, None) when there is none. Load it
        with `TrainState.load_state_dict`."""
        if step is None:
            # explicit None checks: step 0 is a valid best / latest step
            step = self.best_step() if best else self.latest_step()
        if step is None:
            return None, None
        state = torch.load(os.path.join(self._path(step), "state.pt"),
                           map_location=map_location, weights_only=True)
        return state, step

    def _json(self, step: int, name: str) -> dict:
        try:
            with open(os.path.join(self._path(step), f"{name}.json")) as f:
                return dict(json.load(f))
        except FileNotFoundError:
            return {}

    def load_extra(self, step: Optional[int] = None) -> dict:
        """The `extra` metadata saved with a step (the latest when None);
        {} when there is none."""
        step = self.latest_step() if step is None else step
        return {} if step is None else self._json(step, "extra")

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The step of least `val_total_loss` (the earliest among equals),
        or the latest step when no save carries it."""
        metrics = {s: self._json(s, "metrics") for s in self.steps()}
        scored = [(m[MONITOR], s) for s, m in metrics.items() if MONITOR in m]
        if not scored:
            return self.latest_step()
        return min(scored)[1]

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing is held open between calls."""
