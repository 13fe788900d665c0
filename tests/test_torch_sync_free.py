"""The training step's host-sync-free forms against the forms they replace
(CPU; on the card each replaced form waited on the device, read by
chip_smoke.py's gate phase under torch.cuda's sync debug mode):

  * `geometry.compositing._Cumprod`'s backward against torch.cumprod's
    autograd: bit-equal without zeros in the input, within 2 f32 ulps of
    the product with zeros (torch's own branch for them);
  * `device.constant` against torch.tensor, and the same tensor on reuse;
  * `torch.linalg.inv_ex(K).inverse` (camera_rays) against
    `torch.linalg.inv(K)`, bit-equal;
  * `TrainDraws.sample` with a kept `patch_pool` against the draws that
    find the pool themselves, bit-equal;
  * `clip_by_global_norm` (a device-side choice) against optax's formula
    taken by a host branch, on both sides of the threshold.
"""
import pytest

torch = pytest.importorskip("torch")

from keypointnerf_torch.data import SyntheticConfig, make_sample  # noqa: E402
from keypointnerf_torch.device import constant  # noqa: E402
from keypointnerf_torch.geometry.compositing import _Cumprod  # noqa: E402
from keypointnerf_torch.models import KeypointNeRFConfig, ViewBatch  # noqa: E402
from keypointnerf_torch.training import (  # noqa: E402
    TrainDraws,
    clip_by_global_norm,
    global_norm,
    patch_pool,
)


@pytest.mark.parametrize("zeros", [False, True])
def test_cumprod_backward_equals_torch(zeros):
    gen = torch.Generator().manual_seed(3)
    x = torch.rand(64, 40, generator=gen) * 0.9 + 0.05
    if zeros:
        for r, c in ((3, 5), (3, 9), (7, 0), (8, 39), (9, 20)):
            x[r, c] = 0.0
    g = torch.randn(64, 40, generator=gen)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya, yb = torch.cumprod(a, -1), _Cumprod.apply(b)
    assert torch.equal(ya, yb)
    ya.backward(g)
    yb.backward(g)
    assert torch.isfinite(b.grad).all()
    if zeros:
        torch.testing.assert_close(b.grad, a.grad, rtol=0, atol=2 * 1.2e-7 * a.grad.abs().max())
    else:
        assert torch.equal(a.grad, b.grad)


def test_constant_and_inv_ex():
    for values, dtype in ((1.0 / 63, torch.float32), ((-0.01, 0.01), torch.float32),
                          ((31, 17), torch.int64)):
        c = constant(values, dtype, torch.device("cpu"))
        assert torch.equal(c, torch.tensor(values, dtype=dtype))
        assert constant(values, dtype, torch.device("cpu")) is c
    K = torch.tensor([[[81.3, 0.0, 31.7], [0.0, 79.9, 33.1], [0.0, 0.0, 1.0]],
                      [[40.0, 0.0, 16.0], [0.0, 40.0, 16.0], [0.0, 0.0, 1.0]]])
    assert torch.equal(torch.linalg.inv_ex(K).inverse, torch.linalg.inv(K))


def test_draws_with_a_kept_pool_equal_the_draws_without():
    cfg = KeypointNeRFConfig(patch_h=4, patch_w=4, n_coarse=4, n_fine=4)
    vb = ViewBatch.from_numpy(make_sample(SyntheticConfig(image_size=32), seed=1), "cpu")
    pool = patch_pool(vb)
    assert 0 < pool.numel() < 32 * 32
    for seed in range(4):
        a = TrainDraws.sample(cfg, vb, torch.Generator().manual_seed(seed))
        b = TrainDraws.sample(cfg, vb, torch.Generator().manual_seed(seed), pool=pool)
        for x, y in ((a.patch_index, b.patch_index), (a.strat_u, b.strat_u),
                     (a.importance_u, b.importance_u), (a.coarse.view_keep, b.coarse.view_keep),
                     (a.fine.noise, b.fine.noise)):
            assert torch.equal(x, y)
        assert a.patch_index.dim() == 0 and int(a.patch_index) in set(pool.tolist())


def test_clip_by_global_norm_device_choice():
    gen = torch.Generator().manual_seed(0)
    grads = [torch.randn(7, 5, generator=gen), torch.randn(3, generator=gen)]
    norm = float(global_norm(grads))
    for max_norm in (0.5 * norm, 2.0 * norm):
        want = list(grads) if norm < max_norm else [(g / global_norm(grads)) * max_norm
                                                     for g in grads]
        for got, w in zip(clip_by_global_norm(grads, max_norm), want):
            assert torch.equal(got, w)
