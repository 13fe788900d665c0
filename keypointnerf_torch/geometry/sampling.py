"""Per-ray depth sampling: stratified coarse + inverse-CDF importance.

Port of `keypointnerf_tpu/geometry/sampling.py`. Random draws are explicit
arguments (the JAX package's `jax.random` keys cannot be replayed in
torch); the eval paths take none and are deterministic.
"""
from __future__ import annotations

import torch

from ..device import constant


def linspace01(n, dtype=torch.float32, device=None):
    """`jnp.linspace(0, 1, n)` as the JAX package's compiled program yields
    it, bit for bit: XLA folds the division i / (n - 1) into a multiply by
    the reciprocal rounded to `dtype`; the last entry is exactly 1."""
    if n == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    inv = constant(1.0 / (n - 1), dtype, device)
    head = torch.arange(n - 1, dtype=dtype, device=device) * inv
    return torch.cat([head, torch.ones(1, dtype=dtype, device=device)])


def stratified_z(near, far, n_samples, u=None):
    """Stratified depths along each ray.

    near, far: (..., 1). `u` (..., n_samples) in [0, 1) is the train-time
    bin jitter (each sample uniform inside its midpoint-delimited bin); None
    at eval gives the plain linspace. Returns (..., n_samples) sorted.
    """
    z = linspace01(n_samples, near.dtype, near.device)
    z = z.expand(near.shape[:-1] + (n_samples,))
    if u is not None:
        mid = 0.5 * (z[..., 1:] + z[..., :-1])
        lower = torch.cat([z[..., :1], mid], dim=-1)
        upper = torch.cat([mid, z[..., -1:]], dim=-1)
        z = lower + u * (upper - lower)
    return near + (far - near) * z


def inverse_cdf(contrib, n_samples, u=None):
    """`importance_z`'s inverse CDF, apart from the depths.

    contrib: (..., M) per-bin weights; `u` as for `importance_z`. Returns,
    per sample, the edge index `j` (..., n) at or below u (j + 1 the edge
    above it, M + 1 meaning edge M again), `hit` (some edge lies at or below
    u) and the fraction (u - cdf_prev) / den of the bin at which the sample
    lies, with the last edge's cdf where not `hit`.
    """
    contrib = contrib + 1e-5
    pdf = contrib / contrib.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (..., M+1)

    shape = cdf.shape[:-1] + (n_samples,)
    if u is None:
        u = linspace01(n_samples, cdf.dtype, cdf.device).expand(shape)

    count = (cdf[..., :, None] <= u[..., None, :]).sum(dim=-2)  # (..., n)
    hit = count > 0
    j = (count - 1).clamp(min=0)
    pad_cdf = torch.cat([cdf, cdf[..., -1:]], dim=-1)
    cdf_prev = torch.gather(cdf, -1, j)
    cdf_next = torch.gather(pad_cdf, -1, j + 1)

    # no edge <= u (u < 0 or NaN): fall back to the last bin, as JAX does
    last_cdf = cdf[..., -1:].expand(shape)
    cdf_prev = torch.where(hit, cdf_prev, last_cdf)
    cdf_next = torch.where(hit, cdf_next, last_cdf)

    den = cdf_next - cdf_prev
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return j, hit, (u - cdf_prev) / den


def importance_z(contrib, z_bins, n_samples, u=None):
    """Inverse-CDF importance resampling of ray depths.

    `searchsorted(right=True)` by counting comparisons, idx = #{cdf_j <= u},
    with the JAX package's floor (+1e-5), its top-edge clamp (u >= cdf_M,
    e.g. the uniform u = 1, selects the last edge) and its den < 1e-5 guard
    (`inverse_cdf`). The bins are picked with gathers; the JAX package
    contracts a one-hot with one nonzero, which moves the same values
    exactly.

    contrib: (..., M) per-bin weights; z_bins: (..., M + 1) edge depths;
    `u` (..., n_samples) explicit CDF samples, None for the evenly spaced
    eval samples. Returns (..., n_samples) depths (sorted when u is).
    """
    j, hit, frac = inverse_cdf(contrib.to(z_bins.dtype), n_samples, u)
    pad_z = torch.cat([z_bins, z_bins[..., -1:]], dim=-1)
    z_prev = torch.gather(z_bins, -1, j)
    z_next = torch.gather(pad_z, -1, j + 1)
    last_z = z_bins[..., -1:].expand(j.shape)
    z_prev = torch.where(hit, z_prev, last_z)
    z_next = torch.where(hit, z_next, last_z)
    return z_prev + frac * (z_next - z_prev)


def union_sorted_z(z_coarse, z_fine):
    """Sorted union of coarse and fine depths per ray."""
    return torch.sort(torch.cat([z_coarse, z_fine], dim=-1), dim=-1).values


def merge_sorted_payloads(z_a, z_b, v_a, v_b):
    """Stable merge of two per-ray SORTED depth arrays with payload channels.

    Each element's final position is one comparison count:

      pos_a[i] = i + #{ z_b < z_a[i] }   (strict: ties keep a-before-b,
      pos_b[j] = j + #{ z_a <= z_b[j] }   matching stable-sort concat order)

    and the payload rows are scattered to it, so every value moves exactly.

    z_a: (..., Sa); z_b: (..., Sb); v_a: (..., Sa, C); v_b: (..., Sb, C).
    Returns (z (..., Sa+Sb), v (..., Sa+Sb, C)) in ascending z.
    """
    Sa, Sb = z_a.shape[-1], z_b.shape[-1]
    dev = z_a.device
    pos_a = torch.arange(Sa, device=dev) + (
        z_b[..., None, :] < z_a[..., :, None]
    ).sum(dim=-1)
    pos_b = torch.arange(Sb, device=dev) + (
        z_a[..., None, :] <= z_b[..., :, None]
    ).sum(dim=-1)
    pos = torch.cat([pos_a, pos_b], dim=-1)                    # (..., S)
    z = torch.cat([z_a, z_b], dim=-1)
    v = torch.cat([v_a, v_b], dim=-2)                          # (..., S, C)
    z_m = torch.empty_like(z).scatter_(-1, pos, z)
    v_m = torch.empty_like(v).scatter_(
        -2, pos[..., None].expand(v.shape), v
    )
    return z_m, v_m
