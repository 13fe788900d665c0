"""The module path's dense layers at inference (`ops.dense_act`): on the
CPU the op runs its plain version, so the geometry MLP under no_grad gives
every bit the layer-by-layer composition gives (written out here), in
bf16 and f32 compute dtype, through stacks with and without skip blocks;
where autograd records, the op is not called. The kernel itself is held
against the plain version on the card (tests/test_torch_cuda_kernels.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import keypointnerf_torch.models.mlp as mlp_mod  # noqa: E402
from keypointnerf_torch.models.mlp import MLP, GeoFusionMLP, masked_pool, softplus100  # noqa: E402

V, N = 3, 37


def _seeded(module, seed=0):
    rs = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.as_tensor(rs.normal(0.0, 0.3, p.shape), dtype=p.dtype))
    return module


def _composed(stack, x, skips):
    """Each layer's LinearSlot, then softplus100 but after the last."""
    n = len(stack.layers)
    for i, slot in enumerate(stack.layers):
        if i in skips:
            x = (x, skips[i])
        x = slot(x)
        x = x if i == n - 1 else softplus100(x)
    return x


@pytest.fixture
def counted(monkeypatch):
    calls = []
    real = mlp_mod.fused_dense_act

    def spy(*args, **kwargs):
        calls.append(args[4])
        return real(*args, **kwargs)

    monkeypatch.setattr(mlp_mod, "fused_dense_act", spy)
    return calls


def _geo_inputs(dt, seed=1):
    rs = np.random.default_rng(seed)
    t = lambda *shape: torch.as_tensor(rs.normal(size=shape), dtype=torch.float32)  # noqa: E731
    mask = torch.as_tensor((rs.uniform(size=(V, N, 1)) > 0.3).astype(np.float32))
    weight = mask / (mask.sum(0, keepdim=True) + 1e-6)
    return (t(V, N, 48).to(dt), [t(V, N, 16).to(dt), t(V, N, 8).to(dt)], mask.to(dt),
            weight.to(dt))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("stack", ["geo_fusion", "mlp_input_skip"])
def test_module_path_bit_equal_to_composition(stack, dtype, counted):
    dt = getattr(torch, dtype)
    if stack == "geo_fusion":
        # layers1 with two skip blocks (at 0 and 2), layers2 without
        model = _seeded(GeoFusionMLP((48, 32, 32, 24, 16), (32, 16, 16, 2), (16, 8), (0, 2),
                                    dtype=dt))
        sp, feats, mask, weight = _geo_inputs(dt)
        with torch.no_grad():
            got = model(sp, feats, mask, weight)
            lv = _composed(model.layers1, sp, {0: feats[0], 2: feats[1]})
            lf, valid = masked_pool(lv, mask, weight, model.pool_types)
            want = (_composed(model.layers2, lf, {}), valid, lv, lf)
    else:
        # an MLP whose layer 2 takes the stack's input again beside x
        model = _seeded(MLP((24, 32, 16, 16, 3), skip_layers=(2,), dtype=dt))
        x = _geo_inputs(dt)[0][..., :24]
        with torch.no_grad():
            got = (model(x),)
            want = (_composed(model, x, {2: x}),)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # in bf16 the op, each stack's hidden layers stored in bf16 and its last
    # in f32; in f32 the composition as it was
    bf, f32 = torch.bfloat16, torch.float32
    stacks = [[bf, bf, bf, f32], [bf, bf, f32]] if stack == "geo_fusion" else [[bf, bf, bf, f32]]
    assert counted == ([d for s in stacks for d in s] if dt == bf else [])


def test_grad_path_does_not_call_the_op(counted):
    model = _seeded(GeoFusionMLP((48, 32, 32, 24, 16), (32, 16, 16, 2), (16, 8), (0, 2),
                                 dtype=torch.bfloat16))
    sp, feats, mask, weight = _geo_inputs(torch.bfloat16)
    out = model(sp, feats, mask, weight)[0]
    assert out.requires_grad and counted == []
    with torch.no_grad():
        model(sp, feats, mask, weight)
    assert len(counted) == 7
