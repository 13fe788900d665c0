"""The explicit random draws of one training forward.

The JAX model draws its training randomness inside the module from Flax's
`make_rng("render")` key (keypoint_nerf.py:1015); Flax folds the module
path into that key, so no other program can replay it. The port takes
every draw as a tensor instead, and `TrainDraws.sample` makes them by the
same laws with a `torch.Generator`:

  * patch_index — the flat pixel index of the patch center, uniform over
    the target pixels with mask > 0.5, or over all pixels when there are
    none (keypoint_nerf.py:992-995);
  * strat_u (R, n_coarse) — the stratified bin jitter, U[0, 1);
  * per query, coarse then fine: view_keep (V,) — [1, u > view_dropout
    for V - 1 uniforms], randomly permuted (:606-615) — and noise (N, 1),
    standard normal times rand_noise_std (:745-746), with N = R * n_coarse
    for the coarse query and R * (n_coarse + n_fine) for the fine one;
  * importance_u (R, n_fine) — the inverse-CDF samples, U[0, 1).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class QueryDraws:
    """The draws of one `query_points` call in training."""

    view_keep: torch.Tensor   # (V,) 0/1, at least one 1
    noise: torch.Tensor       # (N, 1) radiance noise, already scaled

    def to(self, device) -> "QueryDraws":
        return QueryDraws(self.view_keep.to(device), self.noise.to(device))


@dataclasses.dataclass
class TrainDraws:
    """Every random draw of one training forward, in the JAX call order."""

    patch_index: torch.Tensor   # () int64 flat pixel index of the patch center
    strat_u: torch.Tensor       # (R, n_coarse)
    coarse: QueryDraws
    importance_u: torch.Tensor  # (R, n_fine)
    fine: QueryDraws

    def to(self, device) -> "TrainDraws":
        return TrainDraws(self.patch_index.to(device), self.strat_u.to(device),
                          self.coarse.to(device), self.importance_u.to(device),
                          self.fine.to(device))

    @classmethod
    def sample(cls, cfg, vb, generator: torch.Generator) -> "TrainDraws":
        """Draw one forward's randomness for model config `cfg` and batch
        `vb` with `generator`, on the generator's device (the batch's)."""
        dev = generator.device
        V = vb.src_images.shape[0]
        R = cfg.patch_h * cfg.patch_w

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        flat = vb.tar_mask.reshape(-1).to(dev)
        fg = torch.nonzero(flat > 0.5).reshape(-1)
        pool = fg if fg.numel() else torch.arange(flat.numel(), device=dev)
        pick = torch.randint(pool.numel(), (), generator=generator, device=dev)
        patch_index = pool[pick]

        def query(n_points):
            keep = torch.cat([torch.ones(1, device=dev),
                              (rand(V - 1) > cfg.view_dropout).float()])
            keep = keep[torch.randperm(V, generator=generator, device=dev)]
            noise = torch.randn((n_points, 1), generator=generator, device=dev)
            return QueryDraws(keep, noise * cfg.rand_noise_std)

        strat_u = rand(R, cfg.n_coarse)
        coarse = query(R * cfg.n_coarse)
        importance_u = rand(R, cfg.n_fine)
        fine = query(R * (cfg.n_coarse + cfg.n_fine))
        return cls(patch_index, strat_u, coarse, importance_u, fine)
