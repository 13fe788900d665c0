"""Weight carry from the JAX model's parameter tree to the port.

`state_dict_from_jax(params, cfg)` takes the JAX `KeypointNeRF` params as
nested dicts of numpy arrays (`{"params": {...}}` or the inner dict) and
returns the port's `state_dict` in the original KeypointNeRF key layout.
It is the exact inverse of `convert_reference_state_dict` in the JAX
package's `utils/import_torch.py`:

  * Flax Conv kernel (kh, kw, I, O)            -> Conv2d weight (O, I, kh, kw)
  * Flax ConvTranspose kernel (kh, kw, O, I)   -> ConvTranspose2d weight (I, O, kh, kw)
  * Dense kernel (I, O)                        -> Linear weight (O, I)
  * WNDense kernel (I, O) + gain (O,)          -> weight_v (O, I) + weight_g (O, 1)
  * GroupNorm scale / bias                     -> weight / bias

Flax names its submodules in call (construction) order; the key
arithmetic below mirrors the importer's (ResBlk `layers.{idx}` indices,
the IBR head's interleaved `Dense_i`).

Every step is a rename, a transpose or a reshape of one leaf, so the same
functions carry a JAX *gradient* tree (same structure as the params) onto
the port's parameter names. `vgg_params_from_jax` does the same for the
loss's VGG19 features (`{"params": {"conv_{s}_{i}": {kernel, bias}}}`).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _conv(sd: StateDict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _norm(sd: StateDict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _dense(sd: StateDict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{key}.bias"] = _t(p["bias"])


def _wn_dense(sd: StateDict, key: str, p: Mapping) -> None:
    kernel = np.asarray(p["kernel"])
    sd[f"{key}.weight_v"] = _t(kernel.T)
    sd[f"{key}.weight_g"] = _t(np.asarray(p["gain"]).reshape(-1, 1))
    sd[f"{key}.bias"] = _t(p["bias"])


def _convblock(sd: StateDict, key: str, p: Mapping) -> None:
    for i in range(3):
        _norm(sd, f"{key}.bn{i + 1}", p[f"GroupNorm_{i}"])
        _conv(sd, f"{key}.conv{i + 1}", p[f"Conv_{i}"])
    if "Conv_3" in p:
        # bn4 is registered twice in the reference (also downsample.0)
        _norm(sd, f"{key}.bn4", p["GroupNorm_3"])
        _norm(sd, f"{key}.downsample.0", p["GroupNorm_3"])
        _conv(sd, f"{key}.downsample.2", p["Conv_3"])


def _hourglass(sd: StateDict, key: str, level: int, p: Mapping) -> None:
    _convblock(sd, f"{key}.b1_{level}", p["ConvBlock_0"])
    _convblock(sd, f"{key}.b2_{level}", p["ConvBlock_1"])
    if level > 1:
        _hourglass(sd, key, level - 1, p["HourGlass_0"])
        _convblock(sd, f"{key}.b3_{level}", p["ConvBlock_2"])
    else:
        _convblock(sd, f"{key}.b2_plus_{level}", p["ConvBlock_2"])
        _convblock(sd, f"{key}.b3_{level}", p["ConvBlock_3"])


def _hgfilter(sd: StateDict, key: str, n_stack: int, n_downsample: int, p: Mapping) -> None:
    _conv(sd, f"{key}.conv1", p["Conv_0"])
    _norm(sd, f"{key}.bn1", p["GroupNorm_0"])
    _convblock(sd, f"{key}.conv2", p["ConvBlock_0"])
    _conv(sd, f"{key}.unpack1.conv", p["ConvTranspose_0"])
    _norm(sd, f"{key}.unpack1.norm", p["GroupNorm_1"])
    _conv(sd, f"{key}.conv_out", p["Conv_1"])
    _convblock(sd, f"{key}.conv3", p["ConvBlock_1"])
    _convblock(sd, f"{key}.conv4", p["ConvBlock_2"])
    conv_i, block_i = 2, 3
    for i in range(n_stack):
        _hourglass(sd, f"{key}.m{i}", n_downsample, p[f"HourGlass_{i}"])
        _convblock(sd, f"{key}.top_m_{i}", p[f"ConvBlock_{block_i}"])
        block_i += 1
        _conv(sd, f"{key}.conv_last{i}", p[f"Conv_{conv_i}"])
        _norm(sd, f"{key}.bn_end{i}", p[f"GroupNorm_{2 + i}"])
        conv_i += 1
        _conv(sd, f"{key}.l{i}", p[f"Conv_{conv_i}"])
        conv_i += 1
        if i < n_stack - 1:
            _conv(sd, f"{key}.bl{i}", p[f"Conv_{conv_i}"])
            conv_i += 1
            _conv(sd, f"{key}.al{i}", p[f"Conv_{conv_i}"])
            conv_i += 1


def _resblk_encoder(sd: StateDict, key: str, n_downsample: int, n_blocks: int,
                    n_upsample: int, p: Mapping) -> None:
    idx = 1  # layers.0 is the ReplicationPad
    _conv(sd, f"{key}.layers.{idx}", p["Conv_0"])
    idx += 3  # conv, (paramless) instance norm, relu
    for i in range(n_downsample):
        _conv(sd, f"{key}.layers.{idx}", p[f"Conv_{i + 1}"])
        idx += 3
    for b in range(n_blocks):
        # ResBlk: 0 pad, 1 conv, 2 norm, 3 relu, 4 pad, 5 conv, 6 norm
        _conv(sd, f"{key}.layers.{idx}.layers.1", p[f"ResBlk_{b}"]["Conv_0"])
        _conv(sd, f"{key}.layers.{idx}.layers.5", p[f"ResBlk_{b}"]["Conv_1"])
        idx += 1
    for u in range(n_upsample):
        _conv(sd, f"{key}.layers.{idx}", p[f"ConvTranspose_{u}"])
        idx += 3
    if n_upsample > 0:
        idx += 1  # trailing ReplicationPad
        _conv(sd, f"{key}.layers.{idx}", p[f"Conv_{n_downsample + 1}"])


def _mlp_layers(sd: StateDict, key: str, n_layers: int, p: Mapping) -> None:
    for i in range(n_layers):
        lk = f"{key}.layers.{i}.linear"
        (_wn_dense if i < n_layers - 1 else _dense)(sd, lk, p[f"WNDense_{i}"])


# reference module -> Flax Dense name (Flax numbers the head's denses in
# construction order: callee before argument)
_IBR_DENSE = {
    "ray_encoder.0": "Dense_0", "ray_encoder.2": "Dense_1",
    "base_layer.0": "Dense_2", "base_layer.2": "Dense_3",
    "vis_layer1.2": "Dense_4", "vis_layer1.0": "Dense_5",
    "vis_layer2.2": "Dense_6", "vis_layer2.0": "Dense_7",
    "out_layer.4": "Dense_8", "out_layer.2": "Dense_9", "out_layer.0": "Dense_10",
}


def state_dict_from_jax(params: Mapping, cfg) -> StateDict:
    """The port's state_dict for the JAX model's params.

    params: `{"params": tree}` or the tree, leaves array-like; cfg: a
    KeypointNeRFConfig of either package (only architecture fields are
    read).
    """
    p = params.get("params", params)
    sd: StateDict = {}
    _hgfilter(sd, "geo_encoder", cfg.geo_n_stack, cfg.geo_n_downsample, p["geo_encoder"])
    _resblk_encoder(sd, "tex_encoder", cfg.tex_n_downsample, cfg.tex_n_blocks,
                    cfg.tex_n_upsample, p["tex_encoder"])
    _mlp_layers(sd, "mlp_geo.layers1", len(cfg.mlp_dims1) - 1, p["mlp_geo"]["MLPUNet_0"])
    _mlp_layers(sd, "mlp_geo.layers2", len(cfg.mlp_dims2) - 1, p["mlp_geo"]["MLP_0"])
    head = p["ibr_head"]
    sd["mlp_tex.ani_al"] = _t(head["ani_al"])
    for ref, flax_name in _IBR_DENSE.items():
        _dense(sd, f"mlp_tex.{ref}", head[flax_name])
    _dense(sd, "ibr_compress_gfeat", p["gcompress"])
    return sd


def vgg_params_from_jax(params: Mapping) -> StateDict:
    """The `models.vgg.VGG19Features` state_dict (convs only) for the JAX
    package's VGG params: HWIO kernels -> OIHW weights."""
    p = params.get("params", params)
    sd: StateDict = {}
    for name, leaf in p.items():
        _conv(sd, f"convs.{name}", leaf)
    return sd
