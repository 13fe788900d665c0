"""The training loop: data feeding, validation, checkpoints, metrics.

Port of `keypointnerf_tpu/training/loop.py` (the reference's Lightning
Trainer role, reference train.py:59-80), the single-process branch of each
method: one process on one device. Per step the host makes the next batch
(numpy samples copied to the device), the device runs
`train_batch_step_fn` with that step's draws, and the loss terms stay on
the device until a log point. Validation runs every `val_every_steps`:
the weighted-mean patch losses of the val set under fixed draws and a
strided full-image render logged as an image strip (reference
validation_step, src/model.py:509-526). A new Trainer resumes from the
newest checkpoint, its epoch and its place in that epoch's data order.

More than one process or device, and loader workers, are later slices and
raise NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

import os
import time
from typing import Iterable, List, Optional

import numpy as np
import torch

from ..models.keypoint_nerf import KeypointNeRF, ViewBatch
from ..render import render_image
from ..utils.checkpoints import CheckpointManager
from ..utils.config import ExperimentConfig, save_config
from ..utils.metrics_writer import MetricsWriter
from ..utils.profiling import StepTimer
from .draws import TrainDraws
from .train import create_train_state, eval_batch_step_fn, step_generator, train_batch_step_fn


class Trainer:
    # fraction of an epoch's samples that may fail to load before the run
    # warns that it trains on a visibly different data distribution
    BAD_SAMPLE_WARN_FRACTION = 0.02

    def __init__(self, cfg: ExperimentConfig, model: KeypointNeRF, train_data, val_data=None,
                 vgg=None):
        """`model` is (re)seeded with `cfg.seed`; `vgg` is the frozen
        `VGG19Features` of the loss (None without the VGG term)."""
        if cfg.data.num_workers > 0:
            raise NotImplementedError(
                "data.num_workers > 0 (loader workers) is not ported yet: ROADMAP Queue 1 "
                "item 7 (the native prefetcher); set data.num_workers=0")
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise NotImplementedError(
                "training in more than one process is not ported yet: ROADMAP Queue 1 "
                "item 6 (parallel/)")
        self.cfg = cfg
        self.model = model
        self.train_data = train_data
        self.val_data = val_data
        self.device = model.device
        self.global_batch = cfg.data.batch_per_device

        # the first LOADABLE sample (None marks a sample whose files are
        # missing); it fills a validation batch at weight 0
        first = next((s for s in (train_data[i] for i in range(len(train_data)))
                      if s is not None), None)
        if first is None:
            raise ValueError("train_data yielded no loadable samples")
        self._fallback_sample = first
        model.init_weights(cfg.seed)
        self.state = create_train_state(model, cfg.optim, vgg)

        self._last_val_loss = None   # newest val/total_loss, for best-ckpt tracking
        self._last_val_step = None   # the step it was measured at
        self._epoch_dropped = 0      # this epoch's unloadable samples
        self._epoch_loaded = 0       # this epoch's load attempts
        self._epoch_pos = 0          # entries of this epoch's order consumed
        self._data_seconds = 0.0     # host time making samples since the last log
        self.out_dir = os.path.join(cfg.out_dir, cfg.name)
        self.metrics = MetricsWriter(self.out_dir)
        self.ckpt = CheckpointManager(os.path.join(self.out_dir, "ckpts"))
        save_config(cfg, self.out_dir)

        # auto-resume (reference train.py:44-50): the epoch and the place in
        # its data order ride in the checkpoint's extra metadata
        self._resume_epoch = self._resume_pos = 0
        restored, step = self.ckpt.restore(map_location=self.device)
        if restored is not None:
            self.state.load_state_dict(restored)
            extra = self.ckpt.load_extra(step)
            self._resume_epoch = int(extra.get("epoch", 0))
            self._resume_pos = int(extra.get("epoch_pos", 0))
            print(f"resumed from checkpoint step {step}")

    def epoch_order(self, epoch: int) -> np.ndarray:
        """The epoch's sample order, the JAX Trainer's formula."""
        return np.random.default_rng(self.cfg.seed + epoch).permutation(len(self.train_data))

    def _batch_iterator(self, epoch: int, start: int = 0) -> Iterable[List[ViewBatch]]:
        """Batches of one epoch from entry `start` of its order on: the
        reference's None-dropping collate (unloadable samples are skipped,
        a trailing partial batch is dropped)."""
        if hasattr(self.train_data, "set_epoch"):
            self.train_data.set_epoch(epoch)  # per-epoch view-sampling seed
        order = self.epoch_order(epoch)
        self._epoch_dropped = self._epoch_loaded = 0
        self._epoch_pos = start
        batch = []
        for idx in order[start:]:
            t0 = time.perf_counter()
            sample = self.train_data[int(idx)]
            self._epoch_loaded += 1
            self._epoch_pos += 1
            if sample is None:
                self._epoch_dropped += 1
            else:
                batch.append(ViewBatch.from_numpy(sample, self.device))
            self._data_seconds += time.perf_counter() - t0
            if len(batch) == self.global_batch:
                yield batch
                batch = []
        self._warn_bad_samples(epoch)

    def _warn_bad_samples(self, epoch: int) -> None:
        if self._epoch_loaded and (self._epoch_dropped
                                   > self.BAD_SAMPLE_WARN_FRACTION * self._epoch_loaded):
            print(f"WARNING: epoch {epoch}: {self._epoch_dropped}/{self._epoch_loaded} samples "
                  "failed to load (dropped) — check the dataset's storage")

    def _val_metrics(self, step: int) -> Optional[dict]:
        """The metrics attached to a save: the validation loss only at the
        step it was measured (a stale loss would let best-checkpoint
        selection credit parameters that never produced it)."""
        if self._last_val_loss is None or step != self._last_val_step:
            return None
        return {"val_total_loss": float(self._last_val_loss)}

    @torch.no_grad()
    def validate(self, step: int) -> None:
        """The val set's weighted-mean patch losses under fixed draws (every
        sample's from a generator seeded 0, as JAX uses key(0)), and an
        image strip (source views, target, prediction) of val sample 0
        rendered at stride max(1, H // 128)."""
        if self.val_data is None:
            return
        cfg, mc = self.cfg, self.model.cfg
        max_len = cfg.data.max_len_val
        # max_len_val < 0 means no limit (the ZJUDataset convention)
        n_val = len(self.val_data) if max_len < 0 else min(len(self.val_data), max_len)
        err_sums, w_total = None, 0.0
        for b0 in range(0, n_val, self.global_batch):
            batch, weights = [], []
            for gi in range(b0, b0 + self.global_batch):
                sample = self.val_data[gi] if gi < n_val else None
                weights.append(0.0 if sample is None else 1.0)
                if sample is None:
                    sample = self._fallback_sample           # a filler at weight 0
                batch.append(ViewBatch.from_numpy(sample, self.device))
            draws = [TrainDraws.sample(mc, vb, torch.Generator(self.device).manual_seed(0))
                     for vb in batch]
            sums, wsum = eval_batch_step_fn(self.model, cfg.loss, self.state, batch, weights,
                                            draws)
            sums = {k: float(v) for k, v in sums.items()}
            err_sums = sums if err_sums is None else {k: err_sums[k] + sums[k] for k in sums}
            w_total += wsum
        if err_sums is not None and w_total > 0:
            mean = {k: v / w_total for k, v in err_sums.items()}
            self.metrics.scalars(step, {"total_loss": mean["e_all"], **mean}, prefix="val/")
            self._last_val_loss = mean["e_all"]
            self._last_val_step = step
        sample = self.val_data[0]
        if sample is not None:
            vb = ViewBatch.from_numpy(sample, self.device)
            H, W = vb.tar_image.shape[:2]
            stride = max(1, H // 128)
            out = render_image(self.model, vb, height=H, width=W, stride=stride, chunk=4096)
            pred = np.clip(out["rgb_fine"].float().cpu().numpy(), 0.0, 1.0)
            gt = np.asarray(sample["tar_image"])[::stride, ::stride]
            srcs = [np.asarray(im)[::stride, ::stride] for im in sample["src_images"]]
            self.metrics.image(step, "val/src_gt_pred", np.concatenate(srcs + [gt, pred], axis=1))

    def _save(self, step: int, epoch: int, pos: int) -> None:
        """Save at `step`, with the place where training goes on: entry `pos`
        of `epoch`'s order (also where a later `fit` call starts)."""
        self._resume_epoch, self._resume_pos = epoch, pos
        self.ckpt.save(step, self.state, metrics=self._val_metrics(step),
                       extra={"epoch": epoch, "epoch_pos": pos})

    def fit(self, max_steps: Optional[int] = None):
        """Train to `cfg.max_epochs` or `max_steps` optimizer steps; returns
        the TrainState."""
        cfg, mc = self.cfg, self.model.cfg
        step = self.state.step
        rays_per_step = mc.patch_h * mc.patch_w * self.global_batch
        points_per_step = rays_per_step * (2 * mc.n_coarse + mc.n_fine)
        timer = StepTimer(window=cfg.log_every_steps)
        window = []
        self._data_seconds = 0.0
        # resume the epoch schedule too: a restarted finished run must not
        # train max_epochs more epochs, nor replay an epoch's first batches
        start_epoch = min(self._resume_epoch, cfg.max_epochs)
        for epoch in range(start_epoch, cfg.max_epochs):
            start = self._resume_pos if epoch == self._resume_epoch else 0
            for batch in self._batch_iterator(epoch, start):
                gen = step_generator(cfg.seed, step, self.device)
                draws = [TrainDraws.sample(mc, vb, gen) for vb in batch]
                err = train_batch_step_fn(self.model, cfg.loss, self.state, batch, draws)
                timer.tick()
                step += 1
                window.append(err)       # on the device until the log point
                if step % cfg.log_every_steps == 0:
                    mean = {k: torch.stack([e[k] for e in window]).mean().item()
                            for k in window[0]}
                    mean.update(timer.metrics(rays_per_step, points_per_step))
                    mean["data_time_s"] = self._data_seconds / len(window)
                    mean["data_dropped"] = float(self._epoch_dropped)
                    mean["data_substituted"] = 0.0   # only a multi-process feed substitutes
                    self.metrics.scalars(step, mean, prefix="train/")
                    window, self._data_seconds = [], 0.0
                if step % cfg.val_every_steps == 0:
                    self.validate(step)
                done = max_steps is not None and step >= max_steps
                if done or step % cfg.ckpt_every_steps == 0:
                    self._save(step, epoch, self._epoch_pos)
                if done:
                    self.ckpt.wait()
                    return self.state
            # checkpoint at epoch end (reference save_on_train_epoch_end);
            # epoch + 1: this epoch's data is fully consumed
            self._save(step, epoch + 1, 0)
        self.ckpt.wait()
        return self.state
