"""VGG19 perceptual features and the VGG loss of the training step.

Port of `keypointnerf_tpu/models/vgg.py`: the first four VGG19 slices
(relu1_1, relu2_1, relu3_1, relu4_1) on ImageNet-normalized input, 3x3
convs with padding 1 and ReLU, a 2x2 max-pool wherever the width changes,
and the weighted L1 feature loss (1/16, 1/8, 1/4, 1) against a detached
target. Inputs are NHWC in [0, 1] at the module's edge, as in JAX.

No pretrained weights ship with the repository, so `VGG19Features` is
built with seeded random weights and frozen (`requires_grad_(False)`);
`load_torch_vgg19` loads a torchvision vgg19 state_dict file into it and
`utils.convert.vgg_params_from_jax` the JAX package's parameters.
The layers compute in f32.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .mlp import abs_sel

# conv widths per slice of VGG19 features[:21]
SLICES: Sequence[Sequence[int]] = (
    (64,),
    (64, 128),
    (128, 256),
    (256, 256, 256, 512),
)
LOSS_WEIGHTS = (1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
# torchvision's vgg19 `features.{i}` index of each of those convs
TORCH_CONV_INDEX = (0, 2, 5, 7, 10, 12, 14, 16, 19)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG19Features(nn.Module):
    """The VGG19 slices as frozen convs named `conv_{slice}_{index}`, the
    JAX parameter names. `slices` defaults to the real layout; the tests
    use narrower ones."""

    def __init__(self, slices=SLICES, device: DeviceLike = None, seed: int = 42):
        super().__init__()
        self.slices = tuple(tuple(w) for w in slices)
        self.convs = nn.ModuleDict()
        prev = 3
        for si, widths in enumerate(self.slices):
            for wi, w in enumerate(widths):
                self.convs[f"conv_{si}_{wi}"] = nn.Conv2d(prev, w, 3, padding=1)
                prev = w
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN).reshape(1, 3, 1, 1))
        self.register_buffer("std", torch.tensor(_IMAGENET_STD).reshape(1, 3, 1, 1))
        self.init_weights(seed)
        self.requires_grad_(False)
        self.to(resolve_device(device))

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """He-normal kernels and zero biases from one numpy generator."""
        rs = np.random.default_rng(seed)
        for conv in self.convs.values():
            fan_in = conv.in_channels * 9
            w = rs.normal(0.0, math.sqrt(2.0 / fan_in), tuple(conv.weight.shape))
            conv.weight.copy_(torch.as_tensor(w, dtype=torch.float32))
            conv.bias.zero_()

    def forward(self, x):
        """x (B, H, W, 3) in [0, 1] -> the four slices' (B, C, H', W')
        features."""
        x = (x.float().permute(0, 3, 1, 2) - self.mean) / self.std
        outs, prev = [], None
        for si, widths in enumerate(self.slices):
            for wi, w in enumerate(widths):
                if prev is not None and w != prev:
                    x = F.max_pool2d(x, 2)
                x = F.relu(self.convs[f"conv_{si}_{wi}"](x))
                prev = w
            outs.append(x)
        return outs


def load_torch_vgg19(path: str, device: DeviceLike = None) -> VGG19Features:
    """A frozen `VGG19Features` (the real widths) with the weights of a
    torchvision vgg19 state_dict file (`features.{i}.weight / bias`, or a
    saved module)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    vgg = VGG19Features(device=device)
    names = [f"conv_{si}_{wi}" for si, widths in enumerate(SLICES) for wi in range(len(widths))]
    with torch.no_grad():
        for name, idx in zip(names, TORCH_CONV_INDEX, strict=True):
            vgg.convs[name].weight.copy_(sd[f"features.{idx}.weight"])
            vgg.convs[name].bias.copy_(sd[f"features.{idx}.bias"])
    return vgg


def vgg_loss(vgg: VGG19Features, pred, target):
    """Weighted L1 over the four feature slices; pred/target (H, W, 3) or
    (B, H, W, 3) in [0, 1]; the target side carries no gradient."""
    if pred.dim() == 3:
        pred, target = pred[None], target[None]
    fp = vgg(pred)
    ft = vgg(target.detach())
    loss = 0.0
    for w, a, b in zip(LOSS_WEIGHTS, fp, ft):
        loss = loss + w * abs_sel(a - b.detach()).mean()
    return loss
