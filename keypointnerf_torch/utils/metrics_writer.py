"""Scalar and image logging.

Port of `keypointnerf_tpu/utils/metrics_writer.py`: an always-on JSON-lines
stream, `{out_dir}/metrics.jsonl` (one object a call: step, wall time and
the values under their prefixed names), plus TensorBoard event files under
`{out_dir}/tb/` when `torch.utils.tensorboard` imports. One process writes:
in a data-parallel run rank 0 (`main`), the other ranks' writers do
nothing.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


def _tb_writer(logdir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:           # tensorboard is not installed
        return None
    return SummaryWriter(logdir)


class MetricsWriter:
    def __init__(self, out_dir: str, main: bool = True, tensorboard: bool = True):
        """`main`: whether this process writes (rank 0 of its group);
        `tensorboard`: whether to try the TensorBoard stream (its import
        takes seconds where it pulls in TensorFlow)."""
        self.main = main
        self._f = self._tb = None
        if main:
            os.makedirs(out_dir, exist_ok=True)
            self._f = open(os.path.join(out_dir, "metrics.jsonl"), "a", buffering=1)
            if tensorboard:
                self._tb = _tb_writer(os.path.join(out_dir, "tb"))

    def scalars(self, step: int, values: Dict[str, float], prefix: str = "") -> None:
        if not self.main:
            return
        rec = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            key = f"{prefix}{k}"
            rec[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, rec[key], step)
        self._f.write(json.dumps(rec) + "\n")

    def image(self, step: int, tag: str, image: np.ndarray) -> None:
        """image: (H, W, 3) float in [0, 1]; TensorBoard only."""
        if self.main and self._tb is not None:
            self._tb.add_image(tag, np.asarray(image), step, dataformats="HWC")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
