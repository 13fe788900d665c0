"""Port parity: keypointnerf_torch.geometry and .data against the JAX package.

Inputs come from numpy seeds and go through both implementations on the
CPU. Tolerances: 1e-5 in f32 (the two frameworks sum and invert in other
orders); the merge and the importance resampling are held bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keypointnerf_tpu.data import synthetic as jsyn  # noqa: E402
from keypointnerf_tpu.geometry import aabb as jaabb  # noqa: E402
from keypointnerf_tpu.geometry import cameras as jcam  # noqa: E402
from keypointnerf_tpu.geometry import compositing as jcomp  # noqa: E402
from keypointnerf_tpu.geometry import sampling as jsamp  # noqa: E402
from keypointnerf_torch.data import synthetic as tsyn  # noqa: E402
from keypointnerf_torch.geometry import aabb as taabb  # noqa: E402
from keypointnerf_torch.geometry import cameras as tcam  # noqa: E402
from keypointnerf_torch.geometry import compositing as tcomp  # noqa: E402
from keypointnerf_torch.geometry import sampling as tsamp  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _scene(seed=0, size=32):
    return jsyn.make_sample(jsyn.SyntheticConfig(image_size=size), seed=seed)


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_copy_matches(seed):
    cfg = dict(image_size=24, n_views=3)
    a = jsyn.make_sample(jsyn.SyntheticConfig(**cfg), seed=seed)
    b = tsyn.make_sample(tsyn.SyntheticConfig(**cfg), seed=seed)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(
        jsyn.look_at((1.0, 0.2, 3.0), (0, 0, 0))[0],
        tsyn.look_at((1.0, 0.2, 3.0), (0, 0, 0))[0])


def test_cameras_match():
    s = _scene()
    rs = np.random.default_rng(1)
    pts = rs.normal(size=(3, 50, 3)).astype(np.float32) * 0.5

    krt_j = jcam.compose_krt(jnp.asarray(s["src_K"]), jnp.asarray(s["src_R"]), jnp.asarray(s["src_t"]))
    krt_t = tcam.compose_krt(_t(s["src_K"]), _t(s["src_R"]), _t(s["src_t"]))
    np.testing.assert_allclose(krt_t.numpy(), np.asarray(krt_j), **TOL)

    xy_j, z_j = jcam.project_points(jnp.asarray(pts), krt_j)
    xy_t, z_t = tcam.project_points(_t(pts), krt_t)
    np.testing.assert_allclose(xy_t.numpy(), np.asarray(xy_j), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **TOL)
    np.testing.assert_allclose(
        tcam.ndc_xy(xy_t, 32, 32).numpy(), np.asarray(jcam.ndc_xy(xy_j, 32, 32)), **TOL)
    np.testing.assert_allclose(
        tcam.ndc_z(z_t, 2.0, 5.0).numpy(), np.asarray(jcam.ndc_z(z_j, 2.0, 5.0)), **TOL)

    wc_j = jcam.world_to_cam(jnp.asarray(pts), jnp.asarray(s["src_R"]), jnp.asarray(s["src_t"]))
    wc_t = tcam.world_to_cam(_t(pts), _t(s["src_R"]), _t(s["src_t"]))
    np.testing.assert_allclose(wc_t.numpy(), np.asarray(wc_j), **TOL)
    np.testing.assert_allclose(
        tcam.camera_center(_t(s["src_R"]), _t(s["src_t"])).numpy(),
        np.asarray(jcam.camera_center(jnp.asarray(s["src_R"]), jnp.asarray(s["src_t"]))), **TOL)

    np.testing.assert_array_equal(
        tcam.pixel_grid(5, 7, 2, 3).numpy(), np.asarray(jcam.pixel_grid(5, 7, 2, 3)))
    pix = np.asarray(jcam.pixel_grid(32, 32)).astype(np.float32)
    for a, b in zip(
        tcam.camera_rays(_t(pix), _t(s["tar_K"]), _t(s["tar_R"]), _t(s["tar_t"]), 2.0, 5.0),
        jcam.camera_rays(jnp.asarray(pix), jnp.asarray(s["tar_K"]), jnp.asarray(s["tar_R"]),
                         jnp.asarray(s["tar_t"]), 2.0, 5.0),
    ):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_aabb_matches():
    s = _scene()
    pix = np.asarray(jcam.pixel_grid(32, 32)).astype(np.float32)
    o, d, _, _ = jcam.camera_rays(jnp.asarray(pix), jnp.asarray(s["tar_K"]),
                                  jnp.asarray(s["tar_R"]), jnp.asarray(s["tar_t"]), 2.0, 5.0)
    nj, fj, hj = jaabb.ray_aabb_intersection(jnp.asarray(s["bounds"]), o, d)
    nt, ft, ht = taabb.ray_aabb_intersection(_t(s["bounds"]), _t(o), _t(d))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert 0 < ht.float().mean() < 1  # the scene has hits and misses
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), **TOL)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **TOL)


@pytest.mark.parametrize("n", [2, 4, 7, 63, 64, 128])
def test_linspace_bitwise(n):
    np.testing.assert_array_equal(
        tsamp.linspace01(n).numpy(), np.asarray(jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)))


def test_stratified_z_matches():
    rs = np.random.default_rng(2)
    near = rs.uniform(2, 3, (40, 1)).astype(np.float32)
    far = near + rs.uniform(0.5, 2, (40, 1)).astype(np.float32)
    # eval: bit-equal (same linspace, same expression)
    np.testing.assert_array_equal(
        tsamp.stratified_z(_t(near), _t(far), 16).numpy(),
        np.asarray(jsamp.stratified_z(None, jnp.asarray(near), jnp.asarray(far), 16, jitter=False)))
    # train jitter, with the draws handed to the port: lower + u (upper - lower)
    u = rs.uniform(0, 1, (40, 16)).astype(np.float32)
    z = tsamp.stratified_z(_t(near), _t(far), 16, u=_t(u)).numpy()
    zs = np.linspace(0, 1, 16, dtype=np.float32)
    mid = 0.5 * (zs[1:] + zs[:-1])
    lower = np.concatenate([zs[:1], mid])
    upper = np.concatenate([mid, zs[-1:]])
    np.testing.assert_allclose(z, near + (far - near) * (lower + u * (upper - lower)), **TOL)


def _importance_inputs(R, S, seed):
    rs = np.random.default_rng(seed)
    z = np.sort(rs.uniform(2, 5, (R, S)).astype(np.float32), axis=-1)
    contrib = rs.uniform(0.05, 1.0, (R, S - 2)).astype(np.float32)
    contrib[: R // 4] = 0.0          # all-zero rays: the +1e-5 floor alone
    return contrib, 0.5 * (z[:, 1:] + z[:, :-1])


def test_importance_z_bitwise_uniform():
    """M = 2 interior bins (the toy config's n_coarse = 4): every sum in
    the CDF is a single add, so both frameworks build the same CDF and the
    comparison-count bin select must agree bit for bit, u = 1 included."""
    contrib, zm = _importance_inputs(300, 4, 0)
    a = jsamp.importance_z(None, jnp.asarray(contrib), jnp.asarray(zm), 64, uniform=True)
    b = tsamp.importance_z(_t(contrib), _t(zm), 64)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # u = 1 (the last uniform sample) lands on the top edge, up to the
    # rounding of cdf_M about 1
    np.testing.assert_allclose(b[:, -1].numpy(), zm[:, -1], rtol=1e-6)


def test_importance_z_bitwise_explicit_u():
    """searchsorted(right) semantics on ties: u exactly on a CDF edge, u = 0
    and u = 1, fed to the port as explicit draws and to the JAX function
    through its key (the same uniform draws)."""
    import jax

    contrib, zm = _importance_inputs(64, 4, 1)
    key = jax.random.key(3)
    u = np.asarray(jax.random.uniform(key, (64, 16), dtype=jnp.float32))
    a = jsamp.importance_z(key, jnp.asarray(contrib), jnp.asarray(zm), 16, uniform=False)
    b = tsamp.importance_z(_t(contrib), _t(zm), 16, u=_t(u))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))

    # ties: u on the interior edge cdf_1, and u = 0, 1
    c = contrib.astype(np.float32) + np.float32(1e-5)
    pdf = c / c.sum(-1, keepdims=True)
    edge = pdf[:, :1]
    u2 = np.concatenate([edge, np.zeros_like(edge), np.ones_like(edge)], -1).astype(np.float32)
    got = tsamp.importance_z(_t(contrib), _t(zm), 3, u=_t(u2)).numpy()
    # right-searchsorted: u == cdf_1 selects bin [1, 2] at t = 0 -> its lower edge
    np.testing.assert_array_equal(got[:, 0], zm[:, 1])
    np.testing.assert_array_equal(got[:, 1], zm[:, 0])
    np.testing.assert_array_equal(got[:, 2], zm[:, -1])


def test_importance_z_close_full_depth():
    """62 interior bins (the zju n_coarse = 64): the CDF sums differ in
    order between the frameworks, so hold it at 1e-5."""
    contrib, zm = _importance_inputs(200, 64, 2)
    a = jsamp.importance_z(None, jnp.asarray(contrib), jnp.asarray(zm), 64, uniform=True)
    b = tsamp.importance_z(_t(contrib), _t(zm), 64)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_merge_sorted_payloads_bitwise():
    rs = np.random.default_rng(4)
    R = 50
    za = np.sort(rs.integers(0, 12, (R, 8)).astype(np.float32), -1)   # many ties
    zb = np.sort(rs.integers(0, 12, (R, 6)).astype(np.float32), -1)
    va = rs.normal(size=(R, 8, 5)).astype(np.float32)
    vb = rs.normal(size=(R, 6, 5)).astype(np.float32)
    zj, vj = jsamp.merge_sorted_payloads(*(jnp.asarray(x) for x in (za, zb, va, vb)))
    zt, vt = tsamp.merge_sorted_payloads(_t(za), _t(zb), _t(va), _t(vb))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    # ties keep a-before-b: equal to a stable sort of the concatenation
    order = np.argsort(np.concatenate([za, zb], -1), axis=-1, kind="stable")
    np.testing.assert_array_equal(
        vt.numpy(), np.take_along_axis(np.concatenate([va, vb], 1), order[..., None], 1))


def test_union_sorted_and_composite_match():
    rs = np.random.default_rng(5)
    R, D = 30, 12
    z = np.sort(rs.uniform(2, 5, (R, D)).astype(np.float32), -1)
    zf = np.sort(rs.uniform(2, 5, (R, 5)).astype(np.float32), -1)
    np.testing.assert_array_equal(
        tsamp.union_sorted_z(_t(z), _t(zf)).numpy(),
        np.asarray(jsamp.union_sorted_z(jnp.asarray(z), jnp.asarray(zf))))
    alpha = np.maximum(rs.normal(size=(R, D)), 0).astype(np.float32) * 3
    alpha[:5] = 0.0
    sdf = rs.normal(size=(R, D)).astype(np.float32)
    rgb = rs.uniform(0, 1, (R, D, 3)).astype(np.float32)
    out_j = jcomp.composite(*(jnp.asarray(x) for x in (alpha, sdf, rgb, z)))
    out_t = tcomp.composite(_t(alpha), _t(sdf), _t(rgb), _t(z))
    for name, a, b in zip(out_j._fields, out_j, out_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name, **TOL)
