"""The matrix-product and convolution FLOPs a KeypointNeRF step or frame
requires, from the architecture and the shapes (2 FLOPs a multiply-add),
for `mfu`: elementwise work, lookups, pooling and the upsamples are not
products and are not counted; nor is any recomputation.

A frame: one encode of the V source views, then for every query point
(work.frame_queries) the per-view geometry MLP and IBR head and the
per-point fusion MLP and latent compression. A training step: the
encode and the patch's two queries forward, their backward at twice the
forward (weight and input gradients) less the input gradient of the two
first convolutions (their input is the image), and the frozen VGG19 on
the prediction and the target forward plus the prediction's input
gradient (one more forward's worth).
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from harness import work  # noqa: E402
from reference.params import IBR_LAYERS, VGG_SLICES, mlp_geo_dims  # noqa: E402


def conv(cin, cout, k, h, w):
    """A convolution (or a transposed one, counted at its input grid)."""
    return 2 * cin * cout * k * k * h * w


def conv_block(cin, cout, h, w):
    f = conv(cin, cout // 2, 3, h, w) + conv(cout // 2, cout // 4, 3, h, w)
    f += conv(cout // 4, cout // 4, 3, h, w)
    return f + (conv(cin, cout, 1, h, w) if cin != cout else 0)


def hourglass(depth, c, h, w):
    f = conv_block(c, c, h, w) + 2 * conv_block(c, c, h // 2, w // 2)
    return f + (hourglass(depth - 1, c, h // 2, w // 2) if depth > 1
                else conv_block(c, c, h // 2, w // 2))


def encoder(m, size, views):
    """Both encoders over `views` size x size images; and the FLOPs of
    their first convolutions (whose input gradient a step does not need)."""
    h = size
    hg = conv(3, 64, 7, h // 2, h // 2) + conv_block(64, 128, h // 2, h // 2)
    hg += conv(128, 32, 3, h // 2, h // 2) + conv(32, m["geo_out_ch_hd"], 5, h, h)
    q = h // 4
    hg += conv_block(128, 128, q, q) + conv_block(128, 256, q, q)
    hg += hourglass(m["geo_n_downsample"], 256, q, q) + conv_block(256, 256, q, q)
    hg += conv(256, 256, 1, q, q) + conv(256, m["geo_out_ch"], 1, q, q)
    ngf, nd, nb, nu = m["tex_ngf"], m["tex_n_downsample"], m["tex_n_blocks"], m["tex_n_upsample"]
    tex = conv(3, ngf, 7, h, h)
    r = h
    for i in range(nd):
        r //= 2
        tex += conv(ngf * 2 ** i, ngf * 2 ** (i + 1), 3, r, r)
    c = ngf * 2 ** nd
    tex += nb * 2 * conv(c, c, 3, r, r)
    for i in range(nu):
        c = ngf * 2 ** (nd - i)
        tex += conv(c, c // 2, 3, r, r)
        r *= 2
    if nu:
        tex += conv(ngf * 2 ** (nd - nu + 1) // 2, m["tex_out_ch"], 7, r, r)
    first = conv(3, 64, 7, h // 2, h // 2) + conv(3, ngf, 7, h, h)
    return views * (hg + tex), views * first


def query_point(m, views):
    """Per query point: the V views' MLP and IBR head, the fusion MLP."""
    l1, l2 = mlp_geo_dims(m)
    w = m["ibr_in_feat_ch"] + 3
    per_view = sum(2 * a * b for a, b in l1)
    per_view += sum(2 * o * i for o, i in (f(w) for f in IBR_LAYERS.values()))
    per_point = sum(2 * a * b for a, b in l2) + 2 * m["mlp_dims2"][0] * m["gcompress_out"]
    return views * per_view + per_point


def vgg(size):
    f, prev, h = 0, 3, size
    for widths in VGG_SLICES:
        for wdt in widths:
            if wdt != prev and prev != 3:
                h //= 2
            f += conv(prev, wdt, 3, h, h)
            prev = wdt
    return f


def frame(m, views, image_size, frame_size, chunk, encodes=1.0):
    """FLOPs of one frame with `encodes` encodes (an orbit frame: 1/60)."""
    enc, _ = encoder(m, image_size, views)
    pts = sum(work.frame_queries(m, frame_size, chunk))
    return encodes * enc + pts * query_point(m, views)


def train_step(m, views, image_size):
    enc, first = encoder(m, image_size, views)
    fwd = enc + sum(work.train_queries(m)) * query_point(m, views)
    return 3 * fwd - first + 3 * vgg(m["patch_h"])
