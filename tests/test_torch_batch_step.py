"""Port parity for the batched training step: the port's
`train_batch_step_fn` on B = 2 samples against the JAX package's
`make_batch_step_fn` (vmap of the per-sample forward, the mean of the
totals and of the loss terms, one Adam update, grad_norm of the raw
gradients), jitted on one CPU device, f32 toy zju recipe.

The JAX step vmaps its draws over per-sample keys; the fakes of
tests/test_torch_train_step.py ignore the key, so inside the vmap both
samples get the same numpy draws, and the port is given that one
`TrainDraws` twice. Bars as in tests/test_torch_fused_train.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from test_torch_fused_train import (  # noqa: E402
    check_grads,
    check_losses,
    check_params,
    jax_vgg_params,
)
from test_torch_train_step import (  # noqa: E402
    TINY,
    VGG_SLICES,
    ZJU,
    _InjectedDraws,
    _numpy_draws,
    _sample,
)

from keypointnerf_tpu.models import KeypointNeRF as JaxModel  # noqa: E402
from keypointnerf_tpu.models import KeypointNeRFConfig as JaxConfig  # noqa: E402
from keypointnerf_tpu.models import ViewBatch as JaxViewBatch  # noqa: E402
from keypointnerf_tpu.parallel.train_parallel import make_batch_step_fn, stack_batch  # noqa: E402
from keypointnerf_tpu.training import LossConfig as JaxLossConfig  # noqa: E402
from keypointnerf_tpu.training import TrainState as JaxTrainState  # noqa: E402
from keypointnerf_tpu.utils.import_torch import convert_reference_state_dict  # noqa: E402
from keypointnerf_torch import models as tm  # noqa: E402
from keypointnerf_torch.data import SyntheticConfig, make_sample  # noqa: E402
from keypointnerf_torch.training import (  # noqa: E402
    LossConfig,
    OptimConfig,
    compute_losses,
    create_train_state,
    train_batch_step_fn,
)
from keypointnerf_torch.training import train as port_train  # noqa: E402
from keypointnerf_torch.utils import state_dict_from_jax  # noqa: E402


def _second_sample():
    sample = make_sample(SyntheticConfig(image_size=32), seed=4)
    sample["src_images"] = np.random.default_rng(8).uniform(
        0, 1, sample["src_images"].shape).astype(np.float32)
    return sample


def test_batch_step_matches_jax_batch_step():
    jc = JaxConfig(**TINY, **ZJU, pallas_interpret=True)
    tc = tm.KeypointNeRFConfig(**TINY, **ZJU)
    samples = [_sample(), _second_sample()]
    seeded = tm.KeypointNeRF(tc, device="cpu", seed=0)
    params = jax.tree.map(np.asarray,
                          convert_reference_state_dict(seeded.state_dict(), jc, strict=True))
    vgg = tm.VGG19Features(VGG_SLICES, device="cpu")
    queue, draws = _numpy_draws(tc, samples[0])

    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    jmodel = JaxModel(jc)
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=params, vgg_params=jax_vgg_params(vgg),
        tx=optax.chain(capture, optax.adam(OptimConfig().learning_rate)))
    batch = stack_batch([JaxViewBatch(**jax.tree.map(jnp.asarray, s)) for s in samples])
    step = jax.jit(make_batch_step_fn(jmodel, JaxLossConfig()))
    with _InjectedDraws(queue):
        jstate, jerr = step(jstate, batch, jax.random.key(0))

    model = tm.KeypointNeRF(tc, device="cpu", seed=1)
    model.load_state_dict(state_dict_from_jax(params, tc))
    vbs = [tm.ViewBatch.from_numpy(s, device="cpu") for s in samples]
    state = create_train_state(model, OptimConfig(), vgg)
    captured = []
    apply = port_train.apply_gradients
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_train, "apply_gradients",
                   lambda s, p, g: (captured.append([x.clone() for x in g]), apply(s, p, g)))
        terr = train_batch_step_fn(model, LossConfig(), state, vbs, [draws, draws])
    assert state.step == 1 and state.updates == 1
    with torch.no_grad():
        outs = [seeded(vb, train=True, draws=draws) for vb in vbs]
    errs = [compute_losses(out, LossConfig(), vgg)[1] for out in outs]
    names = [n for n, _ in model.named_parameters()]
    result = dict(
        jerr={k: float(v) for k, v in jerr.items()},
        terr={k: float(v) for k, v in terr.items()},
        eerr={k: float(torch.stack([e[k] for e in errs]).mean()) for k in errs[0]},
        jgrads=state_dict_from_jax(jax.tree.map(np.asarray, jstate.opt_state[0]), tc),
        tgrads=dict(zip(names, captured[0])),
        jparams=state_dict_from_jax(jax.tree.map(np.asarray, jstate.params), tc),
        tparams=dict(model.named_parameters()),
        acc=min(float(out["acc_fine"].max()) for out in outs),
    )
    check_losses(result)
    check_grads(result)
    check_params(result)
    # the two samples differ: the mean is not either one's
    assert errs[0]["e_all"] != errs[1]["e_all"]
