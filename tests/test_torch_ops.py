"""Port parity: keypointnerf_torch.ops against the JAX package.

* `multiview_bilinear_sample` (plain PyTorch indexing) against the JAX
  gather sampler: f32 at atol 2e-5 / rtol 1e-5, bf16 bit for bit (the port
  rounds each weighted corner to bf16 and sums in f32, as the JAX program
  does on the CPU).
* K2's plain version against the Pallas kernel run with interpret=True:
  f32 at atol 2e-5 / rtol 1e-5 (the tolerance of tests/test_pallas.py for
  the same kernel), bf16 bit for bit (every product of bf16 values is exact
  in f32 and each rounding step is reproduced).
* K2's CUDA kernel against its plain version needs a card (marker `cuda`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keypointnerf_tpu.ops.feat_sample import multiview_bilinear_sample as jax_sample  # noqa: E402
from keypointnerf_tpu.ops.pallas.onehot_bilinear import (  # noqa: E402
    multiview_onehot_bilinear_sample as jax_onehot,
)
from keypointnerf_torch.ops import feat_sample, onehot_bilinear  # noqa: E402

F32_TOL = dict(atol=2e-5, rtol=1e-5)
SHAPES = [(2, 48, 48, 8), (2, 33, 17, 8), (3, 16, 16, 64), (2, 32, 32, 12)]


def _inputs(shape, n=1500, seed=0):
    rs = np.random.default_rng(seed)
    maps = rs.normal(size=shape).astype(np.float32)
    xy = rs.uniform(-1.3, 1.3, (shape[0], n, 2)).astype(np.float32)  # incl. outside
    # exact border and interior grid hits
    xy[:, :4] = np.array([[-1.0, -1.0], [1.0, 1.0], [1.0, -1.0], [0.0, 0.0]], np.float32)
    return maps, xy


@pytest.mark.parametrize("shape", SHAPES)
def test_bilinear_sample_f32(shape):
    maps, xy = _inputs(shape)
    ref = jax_sample(jnp.asarray(maps), jnp.asarray(xy))
    got = feat_sample.multiview_bilinear_sample(torch.from_numpy(maps), torch.from_numpy(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_bilinear_sample_bf16_bitwise(shape):
    maps, xy = _inputs(shape, seed=1)
    ref = jax_sample(jnp.asarray(maps).astype(jnp.bfloat16), jnp.asarray(xy))
    got = feat_sample.multiview_bilinear_sample(
        torch.from_numpy(maps).bfloat16(), torch.from_numpy(xy))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_bilinear_sample_single_map():
    maps, xy = _inputs((1, 20, 30, 4), n=200, seed=2)
    one = feat_sample.bilinear_sample(torch.from_numpy(maps[0]), torch.from_numpy(xy[0]))
    many = feat_sample.multiview_bilinear_sample(torch.from_numpy(maps), torch.from_numpy(xy))
    np.testing.assert_array_equal(one.numpy(), many[0].numpy())


@pytest.mark.parametrize("hw", [(48, 48), (33, 17)])
def test_onehot_plain_matches_pallas_f32(hw):
    maps, xy = _inputs((2,) + hw + (8,), seed=3)
    ref = jax_onehot(jnp.asarray(maps), jnp.asarray(xy), interpret=True)
    got = onehot_bilinear.multiview_onehot_bilinear_sample(
        torch.from_numpy(maps), torch.from_numpy(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)
    # and the exact bilinear function of the gather sampler
    np.testing.assert_allclose(
        got.numpy(),
        feat_sample.multiview_bilinear_sample(torch.from_numpy(maps), torch.from_numpy(xy)).numpy(),
        **F32_TOL)


@pytest.mark.parametrize("hw", [(48, 48), (33, 17)])
def test_onehot_plain_matches_pallas_bf16_bitwise(hw):
    maps, xy = _inputs((2,) + hw + (8,), seed=4)
    ref = jax_onehot(jnp.asarray(maps).astype(jnp.bfloat16), jnp.asarray(xy), interpret=True)
    got = onehot_bilinear.onehot_bilinear_plain(torch.from_numpy(maps).bfloat16(),
                                                torch.from_numpy(xy))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_onehot_wrapper_checks_inputs():
    maps, xy = _inputs((2, 8, 8, 8), n=10)
    m, p = torch.from_numpy(maps), torch.from_numpy(xy)
    fn = onehot_bilinear.multiview_onehot_bilinear_sample
    before = fn.launches
    with pytest.raises(TypeError):
        fn(m.half(), p)
    with pytest.raises(TypeError):
        fn(m, p.double())
    with pytest.raises(ValueError):
        fn(m, p[:1])                      # views differ
    with pytest.raises(ValueError):
        fn(m[0], p)                       # not (V, H, W, C)
    with pytest.raises(ValueError):
        fn(m[:, :1], p)                   # a 1-row map has no 2x2 patch
    # a CPU tensor runs the plain version and launches nothing
    np.testing.assert_array_equal(
        fn(m, p).numpy(), onehot_bilinear.onehot_bilinear_plain(m, p).numpy())
    assert fn.launches == before


@pytest.mark.parametrize("channels,esize,offset,want", [
    (8, 2, 0, 16),      # the strict tex map in bf16: one 16-byte piece a row
    (84, 2, 0, 8),      # the fused map in bf16: 168 bytes, 21 pieces of 8
    (37, 2, 0, 2),      # odd rows: single channels
    (5, 2, 0, 2),
    (8, 4, 0, 16),
    (84, 4, 0, 16),
    (6, 4, 0, 8),
    (37, 4, 0, 4),
    (84, 2, 2, 2),      # a map one bf16 element past an aligned address
    (8, 4, 8, 8),       # one that is only 8-byte aligned
])
def test_piece_bytes(channels, esize, offset, want):
    """The lookup kernels' piece width: the widest of 16 and 8 bytes that
    divides the row and every pointer, else one element."""
    assert feat_sample.piece_bytes(channels * esize, esize, 1 << 20, (1 << 21) + offset) == want
