"""Port parity for the fused feature map in training: one f32 toy step of
the configs/zju.json recipe with `fused_feature_map` (the 84-channel map
looked up once a query by the matmul-VJP lookup, its map gradient through
K1's plain version; the upsampling lookups' map gradients through the
plain one-hot sum, JAX's XLA scan) against the JAX package's jitted
`train_step_fn`, and the port's `remat` / `remat_save_gathers` against the
port without them.

Weights, draws and bars are those of tests/test_torch_train_step.py, whose
draw fakes and checks this file imports: loss terms within 1e-5 relative,
every gradient leaf within 1e-4 of its largest entry, the parameters after
one Adam step within its pinned bound. The JAX VGG parameters are the
port's seeded VGG carried over (HWIO kernels), which skips Flax's init.
tests/test_torch_fused_train_{half,gather}.py hold the half map and the
lookup without the matmul VJP the same way, one JAX compile a file (each
costs ~20 s on the CPU).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from test_torch_train_step import (  # noqa: E402
    LR,
    PARAM_BOUND,
    TINY,
    VGG_SLICES,
    ZJU,
    _InjectedDraws,
    _numpy_draws,
    _sample,
)
from test_torch_train_step import test_train_step_grads as check_grads  # noqa: E402
from test_torch_train_step import test_train_step_losses as check_losses  # noqa: E402

from keypointnerf_tpu.models import KeypointNeRF as JaxModel  # noqa: E402
from keypointnerf_tpu.models import KeypointNeRFConfig as JaxConfig  # noqa: E402
from keypointnerf_tpu.models import ViewBatch as JaxViewBatch  # noqa: E402
from keypointnerf_tpu.training import LossConfig as JaxLossConfig  # noqa: E402
from keypointnerf_tpu.training import TrainState as JaxTrainState  # noqa: E402
from keypointnerf_tpu.training import train_step_fn as jax_train_step  # noqa: E402
from keypointnerf_tpu.utils.import_torch import convert_reference_state_dict  # noqa: E402
from keypointnerf_torch import models as tm  # noqa: E402
from keypointnerf_torch.training import (  # noqa: E402
    LossConfig,
    OptimConfig,
    compute_losses,
    create_train_state,
    train_step_fn,
)
from keypointnerf_torch.training import train as port_train  # noqa: E402
from keypointnerf_torch.utils import state_dict_from_jax  # noqa: E402

FUSED = dict(ZJU, fused_feature_map=True)


def jax_vgg_params(vgg):
    """The JAX VGG parameter tree of a port `VGG19Features` (OIHW ->
    HWIO), the inverse of `utils.convert.vgg_params_from_jax`."""
    return {"params": {name: {"kernel": jnp.asarray(conv.weight.numpy().transpose(2, 3, 1, 0)),
                              "bias": jnp.asarray(conv.bias.numpy())}
                       for name, conv in vgg.convs.items()}}


def port_step(tc, state_dict, vgg, sample, draws):
    """The port's train_step_fn from `state_dict`, with the gradients it
    hands to the optimizer captured; returns (terms, grads by name, the
    model after the update)."""
    model = tm.KeypointNeRF(tc, device="cpu", seed=1)
    model.load_state_dict(state_dict)
    vb = tm.ViewBatch.from_numpy(sample, device="cpu")
    state = create_train_state(model, OptimConfig(), vgg)
    captured = []
    apply = port_train.apply_gradients
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_train, "apply_gradients",
                   lambda s, p, g: (captured.append([x.clone() for x in g]), apply(s, p, g)))
        err = train_step_fn(model, LossConfig(), state, vb, draws)
    names = [n for n, _ in model.named_parameters()]
    return ({k: float(v) for k, v in err.items()}, dict(zip(names, captured[0])), model)


def run_parity(**flags):
    """One toy f32 step of the port and of the JAX package with `flags`, in
    the dict the checks of tests/test_torch_train_step.py read."""
    jc = JaxConfig(**TINY, **flags, pallas_interpret=True)
    tc = tm.KeypointNeRFConfig(**TINY, **flags)
    sample = _sample()
    seeded = tm.KeypointNeRF(tc, device="cpu", seed=0)
    params = jax.tree.map(np.asarray,
                          convert_reference_state_dict(seeded.state_dict(), jc, strict=True))
    vgg = tm.VGG19Features(VGG_SLICES, device="cpu")
    queue, draws = _numpy_draws(tc, sample)

    # JAX: an identity transformation in front of Adam keeps the gradient
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    jmodel = JaxModel(jc)
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=params, vgg_params=jax_vgg_params(vgg),
        tx=optax.chain(capture, optax.adam(OptimConfig().learning_rate)))
    jvb = JaxViewBatch(**jax.tree.map(jnp.asarray, sample))
    step = jax.jit(lambda s, b, k: jax_train_step(jmodel, JaxLossConfig(), s, b, k))
    with _InjectedDraws(queue):
        jstate, jerr = step(jstate, jvb, jax.random.key(0))

    sd = state_dict_from_jax(params, tc)
    terr, tgrads, model = port_step(tc, sd, vgg, sample, draws)
    with torch.no_grad():
        out = seeded(tm.ViewBatch.from_numpy(sample, device="cpu"), train=True, draws=draws)
    eerr = compute_losses(out, LossConfig(), vgg)[1]
    return dict(
        tc=tc, sd=sd, vgg=vgg, sample=sample, draws=draws,
        jerr={k: float(v) for k, v in jerr.items()}, terr=terr,
        eerr={k: float(v) for k, v in eerr.items()},
        jgrads=state_dict_from_jax(jax.tree.map(np.asarray, jstate.opt_state[0]), tc),
        tgrads=tgrads,
        jparams=state_dict_from_jax(jax.tree.map(np.asarray, jstate.params), tc),
        tparams=dict(model.named_parameters()),
        acc=float(out["acc_fine"].max()),
    )


def check_params(step):
    """The updated parameters at the bars of tests/test_torch_train_step.py
    (PARAM_BOUND where |g| >= 100 eps, 2 lr elsewhere, at most 3% of the
    entries elsewhere), with "|g| >= 100 eps" asked of both programs'
    gradients: an entry whose |g| lies on the threshold on one side and
    below it on the other is rounding noise of the gradient (measured with
    the fused map: |g| 1.01e-6 in JAX, 9.1e-7 in the port, 3e-6 of its
    leaf's max, moved 5.4e-7 apart by Adam)."""
    jg, tg, jp, tp = step["jgrads"], step["tgrads"], step["jparams"], step["tparams"]
    worst = worst_small = n_small = 0
    for n in tp:
        diff = np.abs(tp[n].detach().numpy() - jp[n].numpy())
        big = np.minimum(np.abs(jg[n].numpy()), np.abs(tg[n].numpy())) >= 100 * 1e-8
        worst = max(worst, diff[big].max(initial=0.0))
        worst_small = max(worst_small, diff[~big].max(initial=0.0))
        n_small += int((~big).sum())
    assert worst <= PARAM_BOUND, worst
    assert worst_small <= 2 * LR, worst_small
    assert n_small <= 0.03 * sum(p.numel() for p in tp.values()), n_small


@pytest.fixture(scope="module")
def fused():
    return run_parity(**FUSED)


def test_fused_train_step_matches_jax(fused):
    """The zju recipe with the fused map: loss terms, every gradient leaf
    and the updated parameters at the bars of the unfused step; the map
    gradient reaches both encoders through the upsampling lookups."""
    check_losses(fused)
    check_grads(fused)
    check_params(fused)
    top = max(float(g.abs().max()) for g in fused["tgrads"].values())
    for leaf in ("geo_encoder.conv1.weight", "tex_encoder.layers.1.weight"):
        assert float(fused["tgrads"][leaf].abs().max()) > 1e-3 * top, leaf


def test_fused_map_is_looked_up_once_a_query(fused, monkeypatch):
    """In training the query looks up only the fused map, through the
    matmul-VJP lookup over all 84 channels (no channel prefix); encode's
    three upsampling lookups take it too (K1's wrapper computes every map
    gradient)."""
    from keypointnerf_torch.models import keypoint_nerf as knerf

    calls = []
    real = knerf.multiview_bilinear_sample_mm

    def spy(feats, xy, grad_channels=None):
        calls.append((tuple(feats.shape), grad_channels))
        return real(feats, xy, grad_channels)

    monkeypatch.setattr(knerf, "multiview_bilinear_sample_mm", spy)
    port_step(fused["tc"], fused["sd"], fused["vgg"], fused["sample"], fused["draws"])
    size = fused["sample"]["src_images"].shape[1]
    assert calls == [((3, size // 4, size // 4, 64), None),
                     ((3, size // 2, size // 2, 8), None),
                     ((3, size, size, 84), None),
                     ((3, size, size, 84), None)]


@pytest.mark.parametrize("flag", ["remat", "remat_save_gathers"])
def test_remat_matches_no_remat(fused, flag):
    """`remat` (the query recomputed in the backward) and with it
    `remat_save_gathers` (the lookups kept, the rest recomputed) give the
    step without remat bit for bit on the CPU: the same operations run on
    the same values, and the draws are tensors."""
    import dataclasses

    flags = dict(remat=True, remat_save_gathers=flag == "remat_save_gathers")
    tc = dataclasses.replace(fused["tc"], **flags)
    terr, tgrads, model = port_step(tc, fused["sd"], fused["vgg"], fused["sample"],
                                    fused["draws"])
    assert terr == fused["terr"]
    for name, g in tgrads.items():
        assert torch.equal(g, fused["tgrads"][name]), name
    for name, p in model.named_parameters():
        assert torch.equal(p, fused["tparams"][name]), name
