"""Port parity for the fused map in training without the matmul VJP
(`train_matmul_gather_vjp` off: every lookup, the upsampling ones and the
query's 84-channel one, takes autograd's gather backward in the port and
XLA's in JAX): one f32 toy step against the JAX package's jitted
`train_step_fn`, at the bars of tests/test_torch_fused_train.py (its own
file: each JAX compile costs ~20 s on the CPU).
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


def test_fused_train_step_without_matmul_vjp_matches_jax():
    step = run_parity(**dict(FUSED, train_matmul_gather_vjp=False))
    check_losses(step)
    check_grads(step)
    check_params(step)
