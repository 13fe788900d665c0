"""The one generator of every traffic mix: a mix is a JSON file of
parameters (traffic/<name>.json) that this module reads.

* "subjects": how many seeded subjects the pool holds, the source image
  size and the views (1 target + sources);
* "kind": which closed loop drives the program — "train" (one optimizer
  step a request, a new subject and new draws each step), "frames" (a
  request is a new subject: encode, then one frame of its own target
  camera) or "orbit" (a subject is encoded once and `frames_per_subject`
  orbit cameras `degrees_per_frame` apart are rendered one at a time);
* "frame_size": the frames' side; the orbit's "radius" and "elevation".

Everything drawn comes from --seed: the subjects, the order they are
served in, the orbit's start angles and the training draws.
"""
from __future__ import annotations

import numpy as np
import torch

from . import scene
from .spec import derive_seed


def subjects(mix: dict, seed: int, device) -> list:
    rs = np.random.default_rng(derive_seed(seed, "subjects"))
    return [scene.make_subject(rs, mix["image_size"], mix["views"], device)
            for _ in range(mix["subjects"])]


def order(mix: dict, seed: int, n: int) -> np.ndarray:
    """The subject of each of the first n requests: the pool in a seeded
    permutation, again and again, so every run serves every subject alike."""
    rs = np.random.default_rng(derive_seed(seed, "order"))
    p = mix["subjects"]
    return np.concatenate([rs.permutation(p) for _ in range(-(-n // p))])[:n]


def orbit_starts(mix: dict, seed: int) -> np.ndarray:
    rs = np.random.default_rng(derive_seed(seed, "orbit"))
    return rs.uniform(0.0, 2.0 * np.pi, mix["subjects"])


def fg_pixels(subject: dict) -> torch.Tensor:
    """The target's foreground pixels (flat indices), or all pixels when it
    has none: where a training patch may be centred."""
    flat = subject["tar_mask"].reshape(-1)
    fg = torch.nonzero(flat > 0.5).reshape(-1)
    return fg if fg.numel() else torch.arange(flat.numel(), device=flat.device)


def train_draws(m: dict, n_views: int, pool: torch.Tensor, seed: int, step: int) -> dict:
    """Every random draw of one training forward (the model's laws): the
    patch centre, the stratified jitter, per query the view keep (one view
    kept, the others with p = 1 - view_dropout) and the radiance noise, the
    importance uniforms. Made on the pool's device, with no host sync."""
    dev = pool.device
    gen = torch.Generator(device=dev).manual_seed(derive_seed(seed, "draws", step))
    R, nc, nf, V = m["patch_h"] * m["patch_w"], m["n_coarse"], m["n_fine"], n_views - 1
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)  # noqa: E731
    pick = torch.randint(pool.numel(), (1,), generator=gen, device=dev)
    patch_index = pool.index_select(0, pick)[0]

    def query(n):
        keep = torch.cat([torch.ones(1, device=dev), (rand(V - 1) > m["view_dropout"]).float()])
        keep = keep[torch.randperm(V, generator=gen, device=dev)]
        noise = torch.randn((n, 1), generator=gen, device=dev) * m["rand_noise_std"]
        return {"view_keep": keep, "noise": noise}

    strat_u = rand(R, nc)
    coarse = query(R * nc)
    importance_u = rand(R, nf)
    fine = query(R * (nc + nf))
    return {"patch_index": patch_index, "strat_u": strat_u, "coarse": coarse,
            "importance_u": importance_u, "fine": fine}


def sampled(seed: int, tag: str, count: int, below: int) -> list:
    """`count` distinct request positions in [0, below) drawn from the seed,
    the first always 0 (a subject's first frame, with its encode)."""
    rs = np.random.default_rng(derive_seed(seed, "sample", tag))
    rest = rs.choice(np.arange(1, below), size=count - 1, replace=False) if count > 1 else []
    return [0] + sorted(int(i) for i in rest)
