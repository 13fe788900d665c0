"""Weights made from the seed on the device: one normal draw for all the
kernels of a network, cut into its leaves and scaled by He's rule, the
rest set to constants (reference/params.py says which). Both the program
and the reference are given these tensors."""
from __future__ import annotations

import math

import torch

from reference.params import fan_in, model_spec, vgg_spec

from .spec import derive_seed

# the last geometry layer's [sdf, radiance] bias: radiance raised so that
# random weights give a nonzero image
RADIANCE_BIAS = ("mlp_geo.layers2.layers.{last}.linear.bias", 1, 2.0)
CONST = {"zero": 0.0, "one": 1.0, "g": math.sqrt(2.0), "ani": 0.2}


def draw(spec, seed: int, stream: str, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "weights", stream))
    n = sum(math.prod(s) for _, s, k in spec if k.startswith("he"))
    flat = torch.randn(n, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, kind in spec:
        size = math.prod(shape)
        if kind.startswith("he"):
            t = flat[off:off + size].view(shape) * math.sqrt(2.0 / fan_in(shape, kind))
            off += size
        else:
            t = torch.full(shape, CONST[kind], device=device)
        out[name] = t
    return out


def model_weights(m: dict, seed: int, device) -> dict:
    """The model's parameters (by state_dict name, aliases left out)."""
    spec, _ = model_spec(m)
    prm = draw(spec, seed, "model", device)
    name, idx, add = RADIANCE_BIAS
    prm[name.format(last=len(m["mlp_dims2"]) - 2)][idx] += add
    return prm


def vgg_weights(seed: int, device) -> dict:
    return draw(vgg_spec(), seed, "vgg", device)


def clone(prm: dict) -> dict:
    return {k: v.clone() for k, v in prm.items()}
