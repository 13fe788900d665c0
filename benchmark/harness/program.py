"""The system under test, `keypointnerf_torch`, as the benchmark drives it:
the model built from a configuration file and given the seeded weights,
the training step `train_batch_step_fn` in its Trainer form, the encoder
and `render_image`, and the kernels' launch counters. Nothing else of the
program is used; nothing of the program is used elsewhere in the harness."""
from __future__ import annotations

import dataclasses

import torch

from reference.params import model_spec, with_aliases

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def model_config(m: dict):
    from keypointnerf_torch.models import KeypointNeRFConfig

    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in m.items()}
    kw["compute_dtype"] = DTYPES[kw["compute_dtype"]]
    return KeypointNeRFConfig(**kw)


def build_model(m: dict, prm: dict, device):
    """The program's model for model keys `m`, holding `prm` (strict load:
    every name and shape the benchmark made must be the program's)."""
    from keypointnerf_torch.models import KeypointNeRF

    model = KeypointNeRF(model_config(m), device=device)
    _, aliases = model_spec(m)
    model.load_state_dict(with_aliases(prm, aliases), strict=True)
    return model


def build_vgg(vgg_prm: dict, device):
    from keypointnerf_torch.models import VGG19Features

    vgg = VGG19Features(device=device)
    sd = dict(vgg_prm, mean=vgg.mean, std=vgg.std)
    vgg.load_state_dict(sd, strict=True)
    return vgg


def view_batch(subject: dict):
    from keypointnerf_torch.models import ViewBatch

    return ViewBatch(**subject)


def with_camera(vb, K, R, t):
    return dataclasses.replace(vb, tar_K=K, tar_R=R, tar_t=t)


class Trainer:
    """The zju recipe's training state around the model, stepped by the
    program's `train_batch_step_fn` (deterministic mode inside)."""

    def __init__(self, cfg: dict, model, vgg):
        from keypointnerf_torch.training import LossConfig, OptimConfig, create_train_state

        self.model = model
        self.loss_cfg = LossConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                                      for k, v in cfg["loss"].items()})
        self.state = create_train_state(model, OptimConfig(**cfg["optim"]), vgg)

    def step(self, vb, d: dict):
        from keypointnerf_torch.training import train_batch_step_fn
        from keypointnerf_torch.training.draws import QueryDraws, TrainDraws

        q = lambda x: QueryDraws(x["view_keep"], x["noise"])  # noqa: E731
        draws = TrainDraws(d["patch_index"], d["strat_u"], q(d["coarse"]), d["importance_u"],
                           q(d["fine"]))
        return train_batch_step_fn(self.model, self.loss_cfg, self.state, [vb], [draws])

    def step_capturing_maps(self, vb, d: dict):
        """`step`, and the encoder's maps as that step's query read them."""
        seen = []
        real = self.model.encode

        def encode(*args, **kwargs):
            feats = real(*args, **kwargs)
            seen.append({k: v.detach().clone() for k, v in feature_maps(feats).items()})
            return feats

        self.model.encode = encode
        try:
            err = self.step(vb, d)
        finally:
            del self.model.encode
        return err, seen[0]

    def first_moments(self) -> dict:
        """Adam's first moment of each parameter, by name."""
        st = self.state.optimizer.state
        return {n: st[p]["exp_avg"] if "exp_avg" in st.get(p, {}) else torch.zeros_like(p)
                for n, p in self.model.named_parameters()}


def encode(model, vb):
    return model.encode(vb.src_images, vb.src_masks)


def render(model, vb, feats, size: int, chunk: int):
    from keypointnerf_torch.render import render_image

    return render_image(model, vb, height=size, width=size, chunk=chunk, feats=feats)


def counters() -> dict:
    """The kernels' launch counters: K1 (map gradient), K2 (tex lookup), K5
    (encoding + geometry MLP)."""
    from keypointnerf_torch import ops

    return {"k1": ops.multiview_dmap_onehot.launches,
            "k2": ops.multiview_onehot_bilinear_sample.launches,
            "k5": ops.sp_geo_mlp_apply.launches}


def feature_maps(feats: dict) -> dict:
    """The encoder's maps as the query reads them, by the reference's names."""
    out = {"coarse": feats["geo"][0], "tex": feats["tex"]}
    for k in ("full", "fused"):
        if k in feats:
            out[k] = feats[k]
    return out
