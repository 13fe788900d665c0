"""Port parity for the half-size fused map in training, with remat: one
f32 toy step of the configs/zju.json recipe with `fused_feature_map`,
`fused_map_half` (the 32² toy inputs pass `fused_map_half_min_side` = 32,
so the hd / RGB / mask channels are resampled onto the 16² grid by a
matmul-VJP lookup of their own) and `remat` on both sides (JAX's
`nn.remat` of the query, the port's `torch.utils.checkpoint`) against the
JAX package's jitted `train_step_fn`, at the bars of
tests/test_torch_fused_train.py (its own file: each JAX compile costs
~20 s on the CPU).
"""
import pytest

pytest.importorskip("torch")

from test_torch_fused_train import (  # noqa: E402
    FUSED,
    check_grads,
    check_losses,
    check_params,
    run_parity,
)

HALF = dict(FUSED, fused_map_half=True, fused_map_half_min_side=32, remat=True)


def test_half_map_remat_train_step_matches_jax():
    step = run_parity(**HALF)
    check_losses(step)
    check_grads(step)
    check_params(step)
