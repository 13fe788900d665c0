"""Train-state construction and the train / eval steps.

Port of `keypointnerf_tpu/training/train.py`. The JAX step is a pure
function of a Flax `TrainState` with an optax chain
[clip_by_global_norm] -> adam / adamw, wrapped in `optax.MultiSteps` when
gradients are accumulated. The port keeps the same arithmetic in a
mutable `TrainState` around a torch optimizer:

  * the learning rate is optax's schedule evaluated at the count of
    updates *before* this one (so a warmup's first update has lr 0);
  * Adam / AdamW take optax's b1, b2 and eps = 1e-8 (optax's adamw decays
    every parameter, as torch's AdamW does);
  * clipping is optax's formula, g * max_norm / norm when norm >= max_norm
    (not `clip_grad_norm_`, whose +1e-6 differs);
  * accumulation keeps optax.MultiSteps' running mean
    acc + (g - acc) / (n + 1) and applies clip + Adam to it on the last
    mini-step; the other mini-steps leave the parameters as they are.

The step takes its random draws explicitly (`training.draws.TrainDraws`).
`train_batch_step_fn` / `eval_batch_step_fn` are the counterparts of the
JAX package's batched steps (`parallel/train_parallel.py:
make_batch_step_fn`, `make_sharded_eval_step`): B samples, the mean of
their totals and loss terms, one update; and the weighted sums of
validation loss terms. Given a process group, the train step is its
data-parallel form (the port's `parallel/train_parallel.py`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..device import deterministic_training
from ..models.keypoint_nerf import KeypointNeRF, ViewBatch
from ..models.vgg import VGG19Features
from .draws import TrainDraws
from .losses import LossConfig, compute_losses


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 5e-4
    beta1: float = 0.9
    beta2: float = 0.999
    grad_clip: Optional[float] = None
    accumulate_steps: int = 1
    weight_decay: float = 0.0
    lr_schedule: str = "constant"      # "constant" | "cosine" | "exponential"
    warmup_steps: int = 0
    decay_steps: int = 100_000         # horizon for cosine / exponential
    lr_final_scale: float = 0.01       # end lr = learning_rate * this


def make_lr(cfg: OptimConfig) -> Callable[[int], float]:
    """The learning rate at update count `step`, with optax's formulas
    (constant, cosine_decay_schedule, exponential_decay, and a
    linear_schedule warmup joined in front)."""
    lr0 = cfg.learning_rate
    if cfg.lr_schedule == "constant":
        def main(step):
            return lr0
    elif cfg.lr_schedule == "cosine":
        def main(step):
            t = min(step, cfg.decay_steps)
            cos = 0.5 * (1.0 + math.cos(math.pi * t / cfg.decay_steps))
            return lr0 * ((1.0 - cfg.lr_final_scale) * cos + cfg.lr_final_scale)
    elif cfg.lr_schedule == "exponential":
        def main(step):
            return lr0 * cfg.lr_final_scale ** (step / cfg.decay_steps)
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if cfg.warmup_steps <= 0:
        return main
    warm = cfg.warmup_steps

    def schedule(step):
        if step >= warm:
            return main(step - warm)
        return -lr0 * (1.0 - step / warm) + lr0          # linear_schedule(0, lr0, warm)
    return schedule


def make_optimizer(cfg: OptimConfig, params) -> torch.optim.Optimizer:
    """Adam, or AdamW when weight_decay > 0, with optax's constants. The
    lr is set per update by `train_step_fn` from `make_lr`."""
    kw = dict(lr=cfg.learning_rate, betas=(cfg.beta1, cfg.beta2), eps=1e-8)
    if cfg.weight_decay > 0.0:
        return torch.optim.AdamW(params, weight_decay=cfg.weight_decay, **kw)
    return torch.optim.Adam(params, **kw)


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares over all leaves."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm: g unchanged when norm < max_norm, else
    (g / norm) * max_norm (chosen on the device: no host sync)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and schedule, the step count (one per
    `train_step_fn` call, as Flax's TrainState counts), the frozen VGG of
    the loss and the accumulation buffers."""

    model: KeypointNeRF
    optimizer: torch.optim.Optimizer
    optim_cfg: OptimConfig
    lr_fn: Callable[[int], float]
    vgg: Optional[VGG19Features] = None
    step: int = 0
    updates: int = 0                       # optimizer updates applied
    acc_grads: Optional[list] = None       # MultiSteps running mean
    mini_step: int = 0

    def state_dict(self) -> dict:
        """What a checkpoint keeps: the model's and the optimizer's
        state_dicts and the counters (the VGG is frozen and not saved)."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step, "updates": self.updates, "mini_step": self.mini_step,
                "acc_grads": self.acc_grads}

    def load_state_dict(self, d: dict) -> None:
        """Restore what `state_dict` gave, onto the model's device."""
        self.model.load_state_dict(d["model"])
        self.optimizer.load_state_dict(d["optimizer"])
        self.step, self.updates, self.mini_step = d["step"], d["updates"], d["mini_step"]
        self.acc_grads = (None if d["acc_grads"] is None
                          else [g.to(p.device) for g, p in zip(d["acc_grads"],
                                                               self.model.parameters())])


def create_train_state(model: KeypointNeRF, optim_cfg: OptimConfig = OptimConfig(),
                       vgg: Optional[VGG19Features] = None) -> TrainState:
    """The train state around an already-built (seeded) model."""
    params = [p for p in model.parameters()]
    return TrainState(model=model, optimizer=make_optimizer(optim_cfg, params),
                      optim_cfg=optim_cfg, lr_fn=make_lr(optim_cfg), vgg=vgg)


def _update(state: TrainState, params, grads) -> None:
    """clip -> Adam(W) at the schedule's lr for the current update count."""
    cfg = state.optim_cfg
    if cfg.grad_clip:
        grads = clip_by_global_norm(grads, cfg.grad_clip)
    for p, g in zip(params, grads):
        p.grad = g
    lr = state.lr_fn(state.updates)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    for p in params:
        p.grad = None
    state.updates += 1


def apply_gradients(state: TrainState, params, grads) -> None:
    """The optimizer's share of a step: with accumulation, fold `grads`
    into MultiSteps' running mean and update on the last mini-step;
    without, update now."""
    k = state.optim_cfg.accumulate_steps
    if k <= 1:
        _update(state, params, grads)
        return
    n = state.mini_step
    if state.acc_grads is None:
        state.acc_grads = [torch.zeros_like(g) for g in grads]
    state.acc_grads = [a + (g - a) / (n + 1) for a, g in zip(state.acc_grads, grads)]
    if n == k - 1:
        _update(state, params, state.acc_grads)
        state.acc_grads = None
    state.mini_step = (n + 1) % k


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's draws on `device`, seeded by (seed,
    step), as the JAX step folds its step count into the run's key: a
    resumed run draws what an unbroken run draws."""
    state = np.random.SeedSequence((seed, step)).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def train_batch_step_fn(model: KeypointNeRF, loss_cfg: LossConfig, state: TrainState,
                        batch: Sequence[ViewBatch], draws: Sequence[TrainDraws],
                        group=None) -> Dict[str, torch.Tensor]:
    """One optimizer step (or accumulation mini-step) on B samples, with one
    `TrainDraws` each: the mean of the per-sample totals is differentiated,
    the loss terms are the per-sample means, and grad_norm is the global
    norm of the raw gradients. With a process `group` (torch.distributed;
    None is no group) `batch` is this rank's slice of the global batch,
    and the gradients and terms are the means over the ranks
    (`parallel.train_parallel.reduce_step`) before grad_norm and the
    update. Updates `state` in place and returns the detached terms. Runs
    in deterministic mode (`device.deterministic_training`): the same
    state, batch and draws give the same bits."""
    with deterministic_training():
        return step_without_mode(model, loss_cfg, state, batch, draws, group)


def step_without_mode(model: KeypointNeRF, loss_cfg: LossConfig, state: TrainState,
                      batch: Sequence[ViewBatch], draws: Sequence[TrainDraws],
                      group=None) -> Dict[str, torch.Tensor]:
    """`train_batch_step_fn`'s work in whatever mode the process is in: with
    torch's defaults, the step a run without deterministic mode would take
    (chip_smoke.py times the mode's cost against it)."""
    params = list(model.parameters())
    totals, errs = [], []
    for vb, d in zip(batch, draws, strict=True):
        total, err = compute_losses(model(vb, train=True, draws=d), loss_cfg, state.vgg)
        totals.append(total)
        errs.append(err)
    total = torch.stack(totals).mean()
    grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    err = {k: torch.stack([e[k] for e in errs]).mean().detach() for k in errs[0]}
    if group is not None:
        from ..parallel import train_parallel

        grads, err = train_parallel.reduce_step(grads, err, group)
    err["grad_norm"] = global_norm(grads).detach()
    apply_gradients(state, params, grads)
    state.step += 1
    return err


def train_step_fn(model: KeypointNeRF, loss_cfg: LossConfig, state: TrainState,
                  vb: ViewBatch, draws: TrainDraws) -> Dict[str, torch.Tensor]:
    """`train_batch_step_fn` on one sample."""
    return train_batch_step_fn(model, loss_cfg, state, [vb], [draws])


@torch.no_grad()
def eval_step_fn(model: KeypointNeRF, loss_cfg: LossConfig, state: TrainState,
                 vb: ViewBatch, draws: TrainDraws) -> Dict[str, torch.Tensor]:
    """Validation losses on a training-mode patch with fixed draws; no
    update."""
    out = model(vb, train=True, draws=draws)
    _, err = compute_losses(out, loss_cfg, state.vgg)
    return err


@torch.no_grad()
def eval_batch_step_fn(model: KeypointNeRF, loss_cfg: LossConfig, state: TrainState,
                       batch: Sequence[ViewBatch], weights: Sequence[float],
                       draws: Sequence[TrainDraws]):
    """Validation on B samples: ({k: sum_i w_i * err_i[k]}, sum_i w_i), the
    caller dividing the sums of all its batches by the summed weights
    (weight 0 marks a filler sample)."""
    sums = None
    for vb, w, d in zip(batch, weights, draws, strict=True):
        err = eval_step_fn(model, loss_cfg, state, vb, d)
        sums = ({k: w * v for k, v in err.items()} if sums is None
                else {k: sums[k] + w * v for k, v in err.items()})
    return sums, float(sum(weights))
