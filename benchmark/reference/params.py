"""The parameters of the KeypointNeRF architecture and of the VGG19 loss
network: names, shapes and how each is initialised.

The names are the original KeypointNeRF state_dict layout
(github.com/facebookresearch/KeypointNeRF: `geo_encoder.*` HGFilterV2,
`tex_encoder.layers.*` ResBlkEncoder, `mlp_geo.layers{1,2}.layers.*.linear`
weight-normed, `mlp_tex.*` the IBRNet head, `ibr_compress_gfeat`), which
the program under test also keeps, so one set of tensors made from the
seed loads into both sides by name.

Initialisation (`kind`): "he" normal with std sqrt(2 / fan_in), fan_in the
input channels times the taps ("he_t" for a transposed convolution, whose
weight is (in, out, kh, kw)); "zero" biases; "one" norm scales; "g" the
weight-norm gains, sqrt(2); "ani" the IBR head's anisotropy, 0.2.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Spec = List[Tuple[str, Tuple[int, ...], str]]

# VGG19 features[:21] in four slices (relu1_1 .. relu4_1)
VGG_SLICES: Sequence[Sequence[int]] = ((64,), (64, 128), (128, 256), (256, 256, 256, 512))


def sp_dim(m: dict) -> int:
    """Width of the rel_z_decay encoding: (1 + 2 levels) per keypoint."""
    if m["sp_type"] != "rel_z_decay":
        raise ValueError(f"the reference implements sp_type rel_z_decay, not {m['sp_type']!r}")
    return (1 + 2 * m["sp_level"]) * m["n_kpt"]


def _conv(spec, name, cout, cin, k, bias=True):
    spec.append((f"{name}.weight", (cout, cin, k, k), "he"))
    if bias:
        spec.append((f"{name}.bias", (cout,), "zero"))


def _norm(spec, name, c):
    spec.append((f"{name}.weight", (c,), "one"))
    spec.append((f"{name}.bias", (c,), "zero"))


def _conv_block(spec, aliases, p, cin, cout):
    _norm(spec, f"{p}.bn1", cin)
    _conv(spec, f"{p}.conv1", cout // 2, cin, 3, bias=False)
    _norm(spec, f"{p}.bn2", cout // 2)
    _conv(spec, f"{p}.conv2", cout // 4, cout // 2, 3, bias=False)
    _norm(spec, f"{p}.bn3", cout // 4)
    _conv(spec, f"{p}.conv3", cout // 4, cout // 4, 3, bias=False)
    if cin != cout:
        _norm(spec, f"{p}.bn4", cin)
        # the reference registers bn4 a second time as downsample.0
        aliases += [(f"{p}.downsample.0.weight", f"{p}.bn4.weight"),
                    (f"{p}.downsample.0.bias", f"{p}.bn4.bias")]
        _conv(spec, f"{p}.downsample.2", cout, cin, 1, bias=False)


def _linear(spec, name, cout, cin, wn=False):
    if wn:
        spec += [(f"{name}.weight_v", (cout, cin), "he"), (f"{name}.weight_g", (cout, 1), "g")]
    else:
        spec.append((f"{name}.weight", (cout, cin), "he"))
    spec.append((f"{name}.bias", (cout,), "zero"))


def mlp_geo_dims(m: dict):
    """(layers1 (in, out) per layer, layers2 (in, out) per layer): the
    per-view MLP takes the coarse features at the first skip layer and
    the hires features at the second, beside its activations."""
    dims1 = (sp_dim(m),) + tuple(m["mlp_dims1"][1:])
    skips = dict(zip(m["mlp_skip_layers"], (m["geo_out_ch"], m["geo_out_ch_hd"])))
    l1 = [(dims1[i] + skips.get(i, 0), dims1[i + 1]) for i in range(len(dims1) - 1)]
    dims2 = tuple(m["mlp_dims2"])
    l2 = [(dims2[i], dims2[i + 1]) for i in range(len(dims2) - 1)]
    return l1, l2


IBR_LAYERS = {  # name: (out, in) with width = ibr_in_feat_ch + 3
    "ray_encoder.0": lambda w: (16, 4), "ray_encoder.2": lambda w: (w, 16),
    "base_layer.0": lambda w: (64, 3 * w), "base_layer.2": lambda w: (32, 64),
    "vis_layer1.0": lambda w: (32, 32), "vis_layer1.2": lambda w: (33, 32),
    "vis_layer2.0": lambda w: (32, 32), "vis_layer2.2": lambda w: (1, 32),
    "out_layer.0": lambda w: (16, 37), "out_layer.2": lambda w: (8, 16),
    "out_layer.4": lambda w: (1, 8),
}


def model_spec(m: dict) -> Tuple[Spec, List[Tuple[str, str]]]:
    """The model's parameters for model keys `m` (the configuration file's
    "model" object), and the state_dict names that alias one of them."""
    if m["geo_n_stack"] != 1:
        raise ValueError("the reference implements one hourglass stack")
    spec: Spec = []
    aliases: List[Tuple[str, str]] = []
    g = "geo_encoder"
    _conv(spec, f"{g}.conv1", 64, 3, 7)
    _norm(spec, f"{g}.bn1", 64)
    _conv_block(spec, aliases, f"{g}.conv2", 64, 128)
    spec.append((f"{g}.unpack1.conv.weight", (128, 32, 3, 3), "he_t"))
    _norm(spec, f"{g}.unpack1.norm", 32)
    _conv(spec, f"{g}.conv_out", m["geo_out_ch_hd"], 32, 5)
    _conv_block(spec, aliases, f"{g}.conv3", 128, 128)
    _conv_block(spec, aliases, f"{g}.conv4", 128, 256)
    for lvl in range(m["geo_n_downsample"], 0, -1):
        for b in ("b1", "b2", "b3"):
            _conv_block(spec, aliases, f"{g}.m0.{b}_{lvl}", 256, 256)
    _conv_block(spec, aliases, f"{g}.m0.b2_plus_1", 256, 256)
    _conv_block(spec, aliases, f"{g}.top_m_0", 256, 256)
    _conv(spec, f"{g}.conv_last0", 256, 256, 1)
    _norm(spec, f"{g}.bn_end0", 256)
    _conv(spec, f"{g}.l0", m["geo_out_ch"], 256, 1)

    t, ngf = "tex_encoder.layers", m["tex_ngf"]
    nd, nb, nu = m["tex_n_downsample"], m["tex_n_blocks"], m["tex_n_upsample"]
    _conv(spec, f"{t}.1", ngf, 3, 7)
    idx = 4
    for i in range(nd):
        _conv(spec, f"{t}.{idx}", ngf * 2 ** (i + 1), ngf * 2 ** i, 3)
        idx += 3
    for _ in range(nb):
        c = ngf * 2 ** nd
        _conv(spec, f"{t}.{idx}.layers.1", c, c, 3)
        _conv(spec, f"{t}.{idx}.layers.5", c, c, 3)
        idx += 1
    for i in range(nu):
        c = ngf * 2 ** (nd - i)
        spec.append((f"{t}.{idx}.weight", (c, c // 2, 3, 3), "he_t"))
        spec.append((f"{t}.{idx}.bias", (c // 2,), "zero"))
        idx += 3
    if nu:
        _conv(spec, f"{t}.{idx + 1}", m["tex_out_ch"], ngf * 2 ** (nd - nu + 1) // 2, 7)

    l1, l2 = mlp_geo_dims(m)
    for i, (cin, cout) in enumerate(l1):
        _linear(spec, f"mlp_geo.layers1.layers.{i}.linear", cout, cin, wn=i < len(l1) - 1)
    for i, (cin, cout) in enumerate(l2):
        _linear(spec, f"mlp_geo.layers2.layers.{i}.linear", cout, cin, wn=i < len(l2) - 1)

    w = m["ibr_in_feat_ch"] + 3
    spec.append(("mlp_tex.ani_al", (), "ani"))
    for name, shape in IBR_LAYERS.items():
        out, inp = shape(w)
        _linear(spec, f"mlp_tex.{name}", out, inp)
    _linear(spec, "ibr_compress_gfeat", m["gcompress_out"], m["mlp_dims2"][0])
    return spec, aliases


def vgg_spec() -> Spec:
    spec: Spec = []
    prev = 3
    for si, widths in enumerate(VGG_SLICES):
        for wi, w in enumerate(widths):
            _conv(spec, f"convs.conv_{si}_{wi}", w, prev, 3)
            prev = w
    return spec


def n_params(spec: Spec) -> int:
    total = 0
    for _, shape, _ in spec:
        n = 1
        for s in shape:
            n *= s
        total += n
    return total


def fan_in(shape, kind) -> int:
    cin = shape[0] if kind == "he_t" else shape[1]
    taps = 1
    for s in shape[2:]:
        taps *= s
    return cin * taps


def with_aliases(params: Dict[str, object], aliases) -> Dict[str, object]:
    """The state_dict view: every alias name beside the tensor it names."""
    out = dict(params)
    for alias, name in aliases:
        out[alias] = params[name]
    return out
