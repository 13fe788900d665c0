"""The training loop: data feeding, validation, checkpoints, metrics.

Port of `keypointnerf_tpu/training/loop.py` (the reference's Lightning
Trainer role, reference train.py:59-80). Per step the host makes the next
batch (numpy samples copied to the device), the device runs
`train_batch_step_fn` with that step's draws, and the loss terms stay on
the device until a log point. Validation runs every `val_every_steps`:
the weighted-mean patch losses of the val set under fixed draws and a
strided full-image render logged as an image strip (reference
validation_step, src/model.py:509-526). A new Trainer resumes from the
newest checkpoint, its epoch and its place in that epoch's data order.

In a torch.distributed group (one process a device, `parallel/`) the
Trainer is data-parallel, as the JAX Trainer is over a multi-process
mesh: the global batch is world x `batch_per_device`; every rank takes
the same seeded epoch order, wrap-padded to a multiple of the global
batch, and loads only its own slots (an unloadable sample is substituted
by the first loadable one, never dropped, so every rank takes the same
number of steps; counted as train/data_substituted over all ranks); every
rank draws the whole global batch's draws and keeps its slots'; one
gradient all-reduce a step; validation batched over the ranks with
weight-0 fillers and the image strip rendered sharded; rank 0 alone
writes the config, metrics.jsonl and checkpoints, and every rank waits
for each save; on resume every rank restores rank 0's newest step with
its place in the epoch.

With `data.num_workers` N > 0 the samples of a rank's order are loaded
by N threads of the native prefetcher (`data/native_loader.py`, the
reference's DataLoader workers), a bounded window ahead of the step, and
handed over in the order's sequence through a reorder buffer: the
batches are the inline loader's, bit for bit. A sample whose load raised
is raised again at its place. The native library is built at first use;
a failed build raises.
"""
from __future__ import annotations

import os
import time
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from ..models.keypoint_nerf import KeypointNeRF, ViewBatch
from ..parallel import (
    all_reduce_,
    broadcast_,
    default_group,
    local_slots,
    make_batch_step_fn,
    make_sharded_eval_step,
    make_sharded_render,
    rank,
    slot_draws,
    world_size,
)
from ..render import render_image
from ..utils.checkpoints import CheckpointManager
from ..utils.config import ExperimentConfig, save_config
from ..utils.metrics_writer import MetricsWriter
from ..utils.profiling import StepTimer
from .draws import TrainDraws
from .train import create_train_state, step_generator


class Trainer:
    # fraction of an epoch's samples that may fail to load before the run
    # warns that it trains on a visibly different data distribution
    BAD_SAMPLE_WARN_FRACTION = 0.02

    def __init__(self, cfg: ExperimentConfig, model: KeypointNeRF, train_data, val_data=None,
                 vgg=None, group=None, tensorboard: bool = True):
        """`model` is (re)seeded with `cfg.seed`; `vgg` is the frozen
        `VGG19Features` of the loss (None without the VGG term); `group`
        the torch.distributed group of the data-parallel ranks (default:
        the default group once one is initialized, else none);
        `tensorboard` whether rank 0 also writes TensorBoard events."""
        if cfg.data.num_workers < 0:
            raise ValueError(f"data.num_workers must be >= 0, got {cfg.data.num_workers}")
        group = default_group() if group is None else group
        self.world = 1 if group is None else world_size(group)
        self.group = group if self.world > 1 else None
        self.rank = 0 if self.group is None else rank(self.group)
        self.cfg = cfg
        self.model = model
        self.train_data = train_data
        self.val_data = val_data
        self.device = model.device
        self.local_batch = cfg.data.batch_per_device
        self.global_batch = self.world * self.local_batch
        # this rank's slots of each global batch (JAX's process-major order)
        self.slots = local_slots(self.global_batch, self.rank, self.world)

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
        self._epoch_dropped = 0      # this epoch's unloadable samples (one process)
        self._epoch_substituted = 0  # this epoch's substituted samples (this rank)
        self._epoch_loaded = 0       # this epoch's load attempts
        self._epoch_pos = 0          # entries of this epoch's order consumed
        self._data_seconds = 0.0     # host time making samples since the last log
        self.out_dir = os.path.join(cfg.out_dir, cfg.name)
        self.metrics = MetricsWriter(self.out_dir, main=self.rank == 0,
                                     tensorboard=tensorboard)
        self.ckpt = CheckpointManager(os.path.join(self.out_dir, "ckpts"), group=self.group)
        if self.rank == 0:
            save_config(cfg, self.out_dir)
        self._train_step = make_batch_step_fn(model, cfg.loss, self.group)
        self._val_step = make_sharded_eval_step(model, cfg.loss, self.group)

        # auto-resume (reference train.py:44-50): the epoch and the place in
        # its data order ride in the checkpoint's extra metadata; every rank
        # restores the step rank 0 found
        self._resume_epoch = self._resume_pos = 0
        step = self.ckpt.latest_step()
        if self.group is not None:
            found = torch.tensor([-1 if step is None else step], device=self.device)
            step = int(broadcast_(found, "resume_step", 0, self.group)[0])
            step = None if step < 0 else step
        restored, step = self.ckpt.restore(step, map_location=self.device)
        if restored is not None:
            self.state.load_state_dict(restored)
            extra = self.ckpt.load_extra(step)
            self._resume_epoch = int(extra.get("epoch", 0))
            self._resume_pos = int(extra.get("epoch_pos", 0))
            print(f"resumed from checkpoint step {step}")

    def epoch_order(self, epoch: int) -> np.ndarray:
        """The epoch's sample order, the JAX Trainer's formula."""
        return np.random.default_rng(self.cfg.seed + epoch).permutation(len(self.train_data))

    def local_order(self, epoch: int) -> np.ndarray:
        """This rank's entries of the epoch's order: with more than one
        rank the order wrap-padded to a multiple of the global batch, and
        of each global batch this rank's slots (the JAX Trainer's
        multi-process order, loop.py:205-216)."""
        order = self.epoch_order(epoch)
        if self.world == 1:
            return order
        B = self.global_batch
        pad = (-len(order)) % B
        if pad:
            order = np.concatenate([order, order[:pad]])
        return order.reshape(-1, B)[:, self.slots.start:self.slots.stop].reshape(-1)

    def _sample_stream(self, order) -> Iterator:
        """The samples of `order`, in its sequence: loaded inline, or by
        `data.num_workers` prefetcher threads."""
        n_workers = self.cfg.data.num_workers
        if n_workers == 0:
            return (self.train_data[int(i)] for i in order)
        from ..data import native_loader

        return native_loader.ordered(self.train_data.__getitem__, order, n_workers)

    def _batch_iterator(self, epoch: int, start: int = 0) -> Iterable[List[ViewBatch]]:
        """This rank's batches of one epoch from entry `start` of its order
        on. One process: the reference's None-dropping collate (unloadable
        samples are skipped, a trailing partial batch is dropped). More
        ranks: an unloadable sample is substituted by the first loadable
        one (dropping it would leave the ranks with different step counts
        and hang the gradient all-reduce)."""
        if hasattr(self.train_data, "set_epoch"):
            self.train_data.set_epoch(epoch)  # per-epoch view-sampling seed
        order = self.local_order(epoch)
        self._epoch_dropped = self._epoch_substituted = self._epoch_loaded = 0
        self._epoch_pos = start
        batch = []
        t0 = time.perf_counter()      # host time making samples: waits on the loader too
        for sample in self._sample_stream(order[start:]):
            self._epoch_loaded += 1
            self._epoch_pos += 1
            if sample is None and self.world > 1:
                sample = self._fallback_sample
                self._epoch_substituted += 1
                if self._epoch_substituted == 1:
                    print(f"WARNING: rank {self.rank} substituted an unloadable sample in epoch "
                          f"{epoch} (tracked as train/data_substituted)")
            if sample is None:
                self._epoch_dropped += 1
            else:
                batch.append(ViewBatch.from_numpy(sample, self.device))
            self._data_seconds += time.perf_counter() - t0
            if len(batch) == self.local_batch:
                yield batch
                batch = []
            t0 = time.perf_counter()
        self._warn_bad_samples(epoch)

    def _warn_bad_samples(self, epoch: int) -> None:
        bad = self._epoch_dropped + self._epoch_substituted
        if self._epoch_loaded and bad > self.BAD_SAMPLE_WARN_FRACTION * self._epoch_loaded:
            print(f"WARNING: rank {self.rank} epoch {epoch}: {bad}/{self._epoch_loaded} samples "
                  f"failed to load ({self._epoch_dropped} dropped, {self._epoch_substituted} "
                  "substituted) — check the dataset's storage")

    def _data_counters(self):
        """(dropped, substituted) of this epoch so far, summed over the
        ranks (an all-reduce at log points only)."""
        bad = torch.tensor([self._epoch_dropped, self._epoch_substituted],
                           dtype=torch.float32, device=self.device)
        if self.group is not None:
            all_reduce_(bad, "data_counters", self.group)
        return float(bad[0]), float(bad[1])

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
        sample's from a generator seeded 0, as JAX uses key(0)), batched
        over the ranks (rank r takes slots [r * local, (r + 1) * local) of
        each global batch; slots past the set, and unloadable samples, are
        fillers at weight 0), and an image strip (source views, target,
        prediction) of val sample 0 rendered at stride max(1, H // 128),
        sharded over the ranks."""
        if self.val_data is None:
            return
        cfg, mc = self.cfg, self.model.cfg
        max_len = cfg.data.max_len_val
        # max_len_val < 0 means no limit (the ZJUDataset convention)
        n_val = len(self.val_data) if max_len < 0 else min(len(self.val_data), max_len)
        err_sums, w_total = None, 0.0
        for b0 in range(0, n_val, self.global_batch):
            batch, weights = [], []
            for gi in range(b0 + self.slots.start, b0 + self.slots.stop):
                sample = self.val_data[gi] if gi < n_val else None
                weights.append(0.0 if sample is None else 1.0)
                if sample is None:
                    sample = self._fallback_sample           # a filler at weight 0
                batch.append(ViewBatch.from_numpy(sample, self.device))
            draws = [TrainDraws.sample(mc, vb, torch.Generator(self.device).manual_seed(0))
                     for vb in batch]
            sums, wsum = self._val_step(self.state, batch, weights, draws)
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
            if self.group is None:
                out = render_image(self.model, vb, height=H, width=W, stride=stride, chunk=4096)
            else:       # a collective: every rank takes this branch
                out = make_sharded_render(self.model, self.group, chunk=4096)(
                    vb, height=H, width=W, stride=stride)
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
                draws = slot_draws(mc, batch, gen, self.global_batch, self.slots.start)
                err = self._train_step(self.state, batch, draws)
                timer.tick()
                step += 1
                window.append(err)       # on the device until the log point
                if step % cfg.log_every_steps == 0:
                    mean = {k: torch.stack([e[k] for e in window]).mean().item()
                            for k in window[0]}
                    mean.update(timer.metrics(rays_per_step, points_per_step))
                    mean["data_time_s"] = self._data_seconds / len(window)
                    mean["data_dropped"], mean["data_substituted"] = self._data_counters()
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
