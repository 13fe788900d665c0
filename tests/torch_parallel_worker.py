"""One rank of tests/test_torch_parallel.py's two-process gloo group.

    python tests/torch_parallel_worker.py RANK WORLD PORT OUT_DIR

Runs, as rank RANK of a WORLD-process gloo group on the CPU (f32, toy
sizes), the port's data-parallel paths and writes what the test compares
to OUT_DIR/rank{RANK}.pt: two data-parallel train steps (loss terms,
the reduced gradient and parameters of the first, a digest of the
parameters after each, the collective inventory of each), the sharded
render at the strict and the fast preset, `run_eval(sharded=True)`, the
Trainer's data order with an unloadable sample, and the Trainer run 4
steps straight and 2 + 2 with a resume. Imports no JAX: the test holds
these against the JAX package and against one process. The functions
with `group=None` are the one-process runs the test makes itself.
"""
import dataclasses
import hashlib
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from keypointnerf_torch import models as tm  # noqa: E402
from keypointnerf_torch.data import SyntheticConfig, SyntheticDataset, make_sample  # noqa: E402
from keypointnerf_torch.evaluation import run_eval  # noqa: E402
from keypointnerf_torch.parallel import (  # noqa: E402
    AUDIT,
    destroy,
    initialize_distributed,
    local_slots,
    make_global_batch,
    make_sharded_render,
    rank,
    slot_draws,
    world_size,
)
from keypointnerf_torch.training import (  # noqa: E402
    LossConfig,
    OptimConfig,
    create_train_state,
    step_generator,
    train_batch_step_fn,
)
from keypointnerf_torch.training import train as port_train  # noqa: E402
from keypointnerf_torch.training.loop import Trainer  # noqa: E402
from keypointnerf_torch.utils import get_model, load_config  # noqa: E402

TINY = dict(n_coarse=4, n_fine=4, patch_h=4, patch_w=4, geo_n_downsample=2)
ZJU = dict(train_matmul_gather_vjp=True, train_pallas_dmap=True)
VGG_SLICES = ((4,), (4, 8), (8, 8), (8, 8, 8, 16))
SIZE, CHUNK, BUDGET = 32, 256, 0.6
# the fast preset's top-k cuts, as tests/test_torch_fast.py sets them
TOPK = dict(coarse_topk_ratio=0.5, fine_topk_ratio=0.75)
TOY = {
    "model.n_coarse": 4, "model.n_fine": 4, "model.patch_h": 4, "model.patch_w": 4,
    "model.geo_n_downsample": 2, "model.tex_ngf": 16, "model.compute_dtype": "float32",
    "loss.lambda_vgg": 0.0, "data.num_workers": 0, "data.image_size": SIZE,
}
BAD_INDEX = 3        # the sample of the ordered dataset that cannot be loaded
N_ORDERED = 7


def textured(seed, tex_seed):
    """A toy sample with numpy-seeded source textures (tests/test_torch_render.py)."""
    sample = make_sample(SyntheticConfig(image_size=SIZE), seed=seed)
    sample["src_images"] = np.random.default_rng(tex_seed).uniform(
        0, 1, sample["src_images"].shape).astype(np.float32)
    return sample


def digest(model) -> str:
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def brighten(model):
    """Radiance > 0 somewhere on the synthetic scene (random weights give
    a black image there), as chip_smoke.py does."""
    with torch.no_grad():
        model.mlp_geo.layers2.layers[-1].linear.bias[1] += 2.0
    return model


# ------------------------------------------------------------------ the step
def step_config():
    return tm.KeypointNeRFConfig(**TINY, **ZJU, tex_ngf=16)


def dp_steps(group, steps=2):
    """`steps` data-parallel steps of the toy zju recipe on the global
    batch of two samples, this rank's slots of it (all of it without a
    group), draws from the step's generator by slot."""
    r, w = (0, 1) if group is None else (rank(group), world_size(group))
    tc = step_config()
    samples = [textured(3, 7), textured(4, 8)]
    slots = local_slots(len(samples), r, w)
    model = tm.KeypointNeRF(tc, device="cpu", seed=0)
    state = create_train_state(model, OptimConfig(), tm.VGG19Features(VGG_SLICES, device="cpu"))
    batch = make_global_batch([samples[i] for i in slots], "cpu")
    names = [n for n, _ in model.named_parameters()]
    res = {"terms": [], "digests": [], "inventory": []}
    apply = port_train.apply_gradients

    def keeping(st, params, grads):
        res.setdefault("grads", {n: g.clone() for n, g in zip(names, grads)})
        apply(st, params, grads)

    port_train.apply_gradients = keeping
    try:
        for step in range(steps):
            draws = slot_draws(tc, batch, step_generator(0, step, "cpu"), len(samples),
                               slots.start)
            AUDIT.reset()
            err = train_batch_step_fn(model, LossConfig(), state, batch, draws, group=group)
            res["inventory"].append(AUDIT.inventory())
            res["terms"].append({k: float(v) for k, v in err.items()})
            res["digests"].append(digest(model))
            if step == 0:
                res["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    finally:
        port_train.apply_gradients = apply
    res["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    return res


# ---------------------------------------------------------------- the render
def render_configs():
    """The port's toy strict and fast presets (f32)."""
    base = tm.KeypointNeRFConfig(**TINY)
    strict = dataclasses.replace(tm.strict_preset(base, cull_budget=BUDGET),
                                 compute_dtype=torch.float32)
    fast = dataclasses.replace(tm.fast_preset(base, cull_budget=BUDGET),
                               compute_dtype=torch.float32, **TOPK)
    return {"strict": strict, "fast": fast}


def sharded_renders(group):
    vb = tm.ViewBatch.from_numpy(textured(3, 7), device="cpu")
    res = {}
    for name, cfg in render_configs().items():
        model = tm.KeypointNeRF(cfg, device="cpu", seed=0)
        AUDIT.reset()
        out = make_sharded_render(model, group, chunk=CHUNK)(vb, height=SIZE, width=SIZE)
        res[name] = ({k: v.numpy() for k, v in out.items()}, AUDIT.inventory())
    return res


# ------------------------------------------------------------------ the eval
def eval_config(out_dir):
    return load_config(None, {**TOY, "out_dir": str(out_dir), "name": "eval"})


def eval_run(group, out_dir, sharded=True):
    cfg = eval_config(out_dir)
    model = brighten(get_model(cfg, device="cpu"))
    data = SyntheticDataset(SyntheticConfig(image_size=SIZE), length=2)
    AUDIT.reset()
    mean = run_eval(cfg, model, data, sharded=sharded, group=group)
    return mean, AUDIT.inventory()


# --------------------------------------------------------------- the Trainer
class OrderedData:
    """N_ORDERED copies of one toy sample, sample i carrying i in tar_t[0];
    sample BAD_INDEX cannot be loaded (None)."""

    def __init__(self):
        self.base = make_sample(SyntheticConfig(image_size=SIZE), seed=0)

    def __len__(self):
        return N_ORDERED

    def __getitem__(self, i):
        if i == BAD_INDEX:
            return None
        s = dict(self.base)
        s["tar_t"] = np.array([i, 0.0, 0.0], np.float32)
        return s


def trainer_config(out_dir, **over):
    return load_config(None, {**TOY, "out_dir": str(out_dir), "max_epochs": 2,
                              "val_every_steps": 10**9, "ckpt_every_steps": 10**9,
                              "log_every_steps": 10**9, **over})


def data_order(group, out_dir):
    """The ids this rank's batches carry in epochs 0 and 1, and its
    substitution count of epoch 0."""
    cfg = trainer_config(os.path.join(out_dir, "order"))
    t = Trainer(cfg, get_model(cfg, device="cpu"), OrderedData(), group=group,
                tensorboard=False)
    ids, substituted = [], None
    for epoch in (0, 1):
        ids.append([[int(vb.tar_t[0]) for vb in b] for b in t._batch_iterator(epoch)])
        if epoch == 0:
            substituted = t._epoch_substituted
    return ids, substituted


def trainer_runs(group, out_dir):
    """4 steps straight, and 2 steps (a val and a checkpoint at 2) then a
    new Trainer that resumes to 4: parameter digests, the resume's step
    and place, and which writers this rank has."""
    res = {}

    def trainer(name):
        cfg = trainer_config(os.path.join(out_dir, name), val_every_steps=2,
                             ckpt_every_steps=2, log_every_steps=1, max_epochs=1)
        data = SyntheticDataset(SyntheticConfig(image_size=SIZE), length=8)
        val = SyntheticDataset(SyntheticConfig(image_size=SIZE), length=3)
        return Trainer(cfg, brighten(get_model(cfg, device="cpu")), data, val, group=group,
                       tensorboard=False)

    straight = trainer("straight")
    straight.fit(max_steps=4)
    res["straight"] = digest(straight.model)
    first = trainer("resumed")
    first.fit(max_steps=2)
    res["writers"] = (first.metrics.main, first.ckpt._writes)
    second = trainer("resumed")
    res["resume"] = (second.state.step, second._resume_epoch, second._resume_pos)
    second.fit(max_steps=4)
    res["resumed"] = digest(second.model)
    res["step"] = second.state.step
    return res


def main():
    r, w, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    initialize_distributed(f"localhost:{port}", w, r, "gloo", "cpu")
    group = torch.distributed.group.WORLD
    res = {"rank": r, "world": w}
    try:
        res["step"] = dp_steps(group)
        res["render"] = sharded_renders(group)
        res["eval"] = eval_run(group, os.path.join(out_dir, "sharded"))
        res["order"] = data_order(group, out_dir)
        res["trainer"] = trainer_runs(group, out_dir)
    finally:
        torch.save(res, os.path.join(out_dir, f"rank{r}.pt"))
        destroy()


if __name__ == "__main__":
    main()
