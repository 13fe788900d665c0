"""Data-parallel training, sharded validation and the sharded render.

Counterpart of `keypointnerf_tpu/parallel/train_parallel.py`, in PyTorch's
idiom: one process a device, the model and optimizer state replicated in
every process (built from one seed), the global batch split over the ranks
in JAX's process-major order (rank r holds slots [r * local, (r + 1) *
local)), and the collectives issued by hand through `process_group.py`:

  * the train step: each rank differentiates the mean of its local
    samples, and the gradients go as ONE flat f32 buffer through ONE
    all-reduce, divided by the world size (JAX's one fused gradient psum,
    `keypointnerf_tpu/parallel/audit.py:7-10`); grad_norm, clipping and
    Adam then run on the same reduced gradients in every rank, so the
    parameters stay bit-equal across ranks. The model has no batch
    statistics (GroupNorm), so the only other crossing is the step's loss
    terms for the log, all-reduced as means in one more call;
  * validation: each rank's weighted sums and weight, one all-reduce;
  * the render: ray i goes to rank i mod n (wrap-padded with real rays),
    each rank marches its share in the chunks JAX's shard would, and the
    image is gathered and un-permuted (JAX `make_sharded_render`).

`group` is a torch.distributed group (`torch.distributed.group.WORLD` for
the default one); None means no group: one process holding everything.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..geometry.cameras import camera_rays, pixel_grid
from ..models.keypoint_nerf import KeypointNeRF, ViewBatch
from ..training.draws import TrainDraws
from ..training.train import eval_batch_step_fn, train_batch_step_fn
from .process_group import all_reduce_, rank, world_size


def _place(group):
    """(world size, rank) of `group`; (1, 0) for no group."""
    return (1, 0) if group is None else (world_size(group), rank(group))


def local_slots(global_batch: int, rank_: int, world: int) -> range:
    """The global batch slots of rank `rank_`: [r * local, (r + 1) * local)."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} does not split over {world} ranks")
    local = global_batch // world
    return range(rank_ * local, (rank_ + 1) * local)


def make_global_batch(local_samples: Sequence[dict], device) -> List[ViewBatch]:
    """This rank's slice of the global batch: its own samples (numpy dicts,
    in slot order) on its device. The other ranks hold the other slots."""
    return [ViewBatch.from_numpy(s, device) for s in local_samples]


def slot_draws(cfg, local_batch: Sequence[ViewBatch], generator: torch.Generator,
               global_batch: int, first_slot: int) -> List[TrainDraws]:
    """The TrainDraws of this rank's slots: every slot's draws are made in
    slot order from the step's one generator, as one process holding the
    whole global batch makes them, and this rank keeps its own. A slot of
    another rank draws with this rank's first sample standing in for its
    own: what the generator consumes depends on the shapes alone (the
    patch pick is one `randint` whatever the size of the foreground), so
    the draws kept do not depend on how the batch is split."""
    kept = []
    for slot in range(global_batch):
        j = slot - first_slot
        mine = 0 <= j < len(local_batch)
        d = TrainDraws.sample(cfg, local_batch[j if mine else 0], generator)
        if mine:
            kept.append(d)
    return kept


def reduce_step(grads: List[torch.Tensor], err: Dict[str, torch.Tensor], group=None):
    """The step's reduction over the ranks of `group`: the mean of the
    gradients (one all-reduce of one flat buffer) and of the loss terms
    (one all-reduce). Returns (grads, err), the same values in every
    rank."""
    world = world_size(group)
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, "grads", group).div_(world)
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    keys = sorted(err)
    terms = torch.stack([err[k].float() for k in keys])
    all_reduce_(terms, "loss_terms", group).div_(world)
    return out, dict(zip(keys, terms.unbind()))


def make_batch_step_fn(model: KeypointNeRF, loss_cfg, group=None):
    """The data-parallel train step: (state, local batch, its draws) ->
    the step's loss terms and grad_norm, the same in every rank. Without a
    group (or with one rank) it is the one-process step."""
    def step(state, batch, draws):
        return train_batch_step_fn(model, loss_cfg, state, batch, draws, group=group)
    return step


def make_sharded_eval_step(model: KeypointNeRF, loss_cfg, group=None):
    """Validation batched over the ranks: (state, local batch, its weights,
    its draws) -> ({k: sum of w_i * err_i[k] over the GLOBAL batch}, sum
    of the weights), the same in every rank (weight 0 marks a filler)."""
    def step(state, batch, weights, draws):
        sums, wsum = eval_batch_step_fn(model, loss_cfg, state, batch, weights, draws)
        if _place(group)[0] == 1:
            return sums, wsum
        keys = sorted(sums)
        buf = torch.stack([sums[k].float() for k in keys]
                          + [torch.tensor(float(wsum), device=sums[keys[0]].device)])
        all_reduce_(buf, "eval_sums", group)
        return dict(zip(keys, buf[:-1].unbind())), float(buf[-1])
    return step


def make_sharded_render(model: KeypointNeRF, group=None, chunk: int = 4096):
    """Full-image render with the rays split over the ranks of `group`.

    Ray i goes to rank i mod n at local position i // n (JAX's interleaved
    assignment: every rank holds a uniform subsample of the image, so a
    global cull budget holds in each share), the last positions wrap to
    real rays; each rank encodes the source views itself and marches its
    share with `render_rays_chunked` in chunks of min(chunk, share), the
    empty-ray cull and the top-k cuts acting within the share, as in a JAX
    shard. The outputs are gathered by ONE all-reduce of an (n, share, C)
    f32 buffer in which each rank fills its own slot and leaves the others
    zero (exact: x + 0 is x; gloo takes CUDA tensors for all-reduce but
    not for all-gather), then un-permuted. Every rank returns the whole
    image; `cull_overflow` at pixel i is rank (i mod n)'s.
    """
    from ..render.renderer import render_rays_chunked

    @torch.no_grad()
    def render(vb: ViewBatch, *, height: int, width: int, stride: int = 1, fine: bool = True,
               feats=None) -> Dict[str, torch.Tensor]:
        cfg = model.cfg
        n_dev, r = _place(group)
        if feats is None:
            feats = model.encode(vb.src_images, vb.src_masks)
        dev = vb.tar_K.device
        pix = pixel_grid(height, width, y_stride=stride, x_stride=stride, device=dev)
        origin, dirs, near, far = camera_rays(pix.float(), vb.tar_K, vb.tar_R, vb.tar_t,
                                              cfg.znear, cfg.zfar)
        n = dirs.shape[0]
        share = -(-n // n_dev)
        idx = (torch.arange(share, device=dev) * n_dev + r) % n
        out = render_rays_chunked(model, feats, vb, origin, dirs[idx], near[idx], far[idx],
                                  chunk=min(chunk, share), fine=fine)
        keys = sorted(out)
        cols = [out[k].reshape(share, -1) for k in keys]
        packed = torch.cat([c.float() for c in cols], dim=-1)
        full = packed.new_zeros((n_dev,) + packed.shape)
        full[r] = packed
        if n_dev > 1:
            all_reduce_(full, "image", group)
        image = full.transpose(0, 1).reshape(n_dev * share, -1)[:n]
        h, w = -(-height // stride), -(-width // stride)
        res, off = {}, 0
        for k, c in zip(keys, cols):
            res[k] = (image[:, off:off + c.shape[1]].to(out[k].dtype)
                      .reshape((h, w) + out[k].shape[1:]))
            off += c.shape[1]
        return res

    return render
