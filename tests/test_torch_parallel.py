"""The port on more than one device: `keypointnerf_torch/parallel/`, the
data-parallel Trainer and the multi-process CLI, on the CPU over gloo.

Two rank processes (tests/torch_parallel_worker.py) are started ONCE for
the file and write what they computed to a temporary directory; the
tests hold it against one process and against the JAX package:

  * the two-rank step (local batch 1 each) against the port's one-process
    step on the global batch of 2 (itself held against the JAX package's
    `make_batch_step_fn` by tests/test_torch_batch_step.py): loss terms,
    the reduced gradient and the updated parameters within 1e-6 relative;
    the parameters bit-equal across the ranks after every step; the
    collective inventory of a step: one gradient all-reduce of the
    parameter bytes and one of the loss terms, nothing else;
  * the sharded render at the toy strict and fast presets against JAX's
    `make_sharded_render` on a 2-device mesh (the conftest's virtual CPU
    devices) at the render parity tests' bar, `cull_overflow` 0 in each
    rank's rays, one gather a render;
  * `run_eval(sharded=True)` against the one-process run_eval;
  * the Trainer's data order with an unloadable sample substituted,
    against the JAX Trainer's multi-process `_batch_iterator`
    (loop.py:205-230) run on the same dataset;
  * the Trainer on two ranks: 2 steps with a val and a checkpoint, then a
    resume to 4 bit-equal to 4 straight steps; only rank 0 writes;
  * the CLI: `--device cpu --devices 2` for 2 steps and a resume to 4.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_parallel_worker as W  # noqa: E402
import torch_threads  # noqa: E402,F401  (one share of the cores a process)

from keypointnerf_tpu.models import KeypointNeRF as JaxModel  # noqa: E402
from keypointnerf_tpu.models import KeypointNeRFConfig as JaxConfig  # noqa: E402
from keypointnerf_tpu.models import ViewBatch as JaxViewBatch  # noqa: E402
from keypointnerf_tpu.models.presets import fast_preset as jax_fast  # noqa: E402
from keypointnerf_tpu.models.presets import strict_preset as jax_strict  # noqa: E402
from keypointnerf_tpu.parallel import make_mesh  # noqa: E402
from keypointnerf_tpu.parallel import make_sharded_render as jax_sharded_render  # noqa: E402
from keypointnerf_tpu.training import loop as jax_loop  # noqa: E402
from keypointnerf_tpu.utils.import_torch import convert_reference_state_dict  # noqa: E402
from keypointnerf_torch import models as tm  # noqa: E402
from keypointnerf_torch import parallel  # noqa: E402
from keypointnerf_torch import train as cli  # noqa: E402
from keypointnerf_torch.render import render_image  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
KEYS = ("rgb_coarse", "depth_coarse", "acc_coarse", "rgb_fine", "depth_fine", "acc_fine",
        "sdf_fine")


def _max_rel(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / max(
        np.abs(np.asarray(a)).max(), 1e-12)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    port = parallel.free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
                               str(r), "2", str(port), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    res = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return dict(res=res, out=out, logs=logs)


# ----------------------------------------------------------------- the step
@pytest.fixture(scope="module")
def one_process():
    """The port's one-process step on the global batch of two samples, on
    as many torch threads as the ranks, which take the test process's
    OMP_NUM_THREADS (the CPU convs' weight-gradient sums are split by
    thread)."""
    return W.dp_steps(None)


def test_two_rank_step_matches_one_process(ranks, one_process):
    """The first step: loss terms and grad_norm, every leaf of the reduced
    gradient and the parameters after the update within 1e-6 relative of
    the one-process global-batch step (of each leaf's largest entry)."""
    got, ref = ranks["res"][0]["step"], one_process
    a, b = got["terms"][0], ref["terms"][0]
    assert a.keys() == b.keys() == {"e_all", "e_pix_c", "e_pix_l1", "e_vgg", "grad_norm"}
    for k in a:
        assert abs(a[k] - b[k]) <= 1e-6 * abs(b[k]), (k, a[k], b[k])
    assert got["grads"].keys() == ref["grads"].keys()
    for kind in ("grads", "params"):
        for name, g in got[kind].items():
            r = ref[kind][name]
            scale = max(float(r.abs().max()), 1e-30)
            assert float((g - r).abs().max()) <= 1e-6 * scale, (kind, name)


def test_parameters_bit_equal_across_ranks(ranks):
    a, b = (r["step"] for r in ranks["res"])
    assert len(a["digests"]) == 2 and a["digests"] == b["digests"]
    assert a["terms"] == b["terms"]


def test_step_collective_inventory(ranks, one_process):
    """Each step: ONE all-reduce of the gradients (the parameter bytes, as
    f32) and one of the four loss terms; nothing else. The one-process
    step issues none."""
    for r in ranks["res"]:
        step = r["step"]
        for inv in step["inventory"]:
            assert inv == {
                "grads": {"op": "all_reduce", "calls": 1, "bytes": step["param_bytes"]},
                "loss_terms": {"op": "all_reduce", "calls": 1, "bytes": 16},
            }
    assert one_process["inventory"] == [{}, {}]


# --------------------------------------------------------------- the render
@pytest.fixture(scope="module")
def jax_renders():
    """JAX's make_sharded_render on a 2-device mesh, from the weights the
    ranks seeded (port seed 0, carried by convert_reference_state_dict)."""
    sample = W.textured(3, 7)
    jvb = JaxViewBatch(**jax.tree.map(jnp.asarray, sample))
    base = JaxConfig(**W.TINY)
    jcs = {"strict": jax_strict(base, cull_budget=W.BUDGET),
           "fast": dataclasses.replace(jax_fast(base, cull_budget=W.BUDGET), **W.TOPK)}
    mesh = make_mesh(n_data=2)
    outs = {}
    for name, tc in W.render_configs().items():
        jc = dataclasses.replace(jcs[name], compute_dtype=jnp.float32, pallas_interpret=True)
        params = convert_reference_state_dict(
            tm.KeypointNeRF(tc, device="cpu", seed=0).state_dict(), jc, strict=True)
        render = jax_sharded_render(JaxModel(jc), mesh, chunk=W.CHUNK)
        outs[name] = jax.tree.map(np.asarray, render(params, jvb, height=W.SIZE, width=W.SIZE))
    return outs


@pytest.mark.parametrize("preset", ["strict", "fast"])
def test_sharded_render_matches_jax(ranks, jax_renders, preset):
    """Every output within 1e-4 of its scale of JAX's sharded image; both
    ranks return the same image; cull_overflow 0 in every rank's rays; ONE
    gather (an all-reduce of disjoint slots) a render."""
    jout = jax_renders[preset]
    (a, inv_a), (b, inv_b) = (r["render"][preset] for r in ranks["res"])
    assert float(jout["acc_fine"].max()) > 0.5
    for k in KEYS:
        assert a[k].shape == jout[k].shape, k
        assert _max_rel(jout[k], a[k]) <= 1e-4, k
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert float(a["cull_overflow"].max()) == 0.0
    n = W.SIZE * W.SIZE
    bytes_ = 2 * (n // 2) * sum(int(np.prod(v.shape[2:])) for v in a.values()) * 4
    assert inv_a == inv_b == {"image": {"op": "all_reduce", "calls": 1, "bytes": bytes_}}


def test_sharded_strict_render_equals_unsharded(ranks):
    """Under the strict preset each ray's march is pointwise: the sharded
    image is the one-process image, the culled rays' exact zeros included."""
    cfg = W.render_configs()["strict"]
    model = tm.KeypointNeRF(cfg, device="cpu", seed=0)
    vb = tm.ViewBatch.from_numpy(W.textured(3, 7), device="cpu")
    ref = render_image(model, vb, height=W.SIZE, width=W.SIZE, chunk=W.CHUNK)
    got = ranks["res"][0]["render"]["strict"][0]
    for k in KEYS:
        assert _max_rel(ref[k].numpy(), got[k]) <= 1e-5, k
        np.testing.assert_array_equal(ref[k].numpy() == 0, got[k] == 0, err_msg=k)


def test_sharded_eval_matches_unsharded(ranks, tmp_path):
    """run_eval(sharded=True) on two ranks: rank 0 scores what one process
    scores (the renders agree to f32 rounding), rank 1 returns {}; each
    image is one gather."""
    (mean0, inv0), (mean1, inv1) = (r["eval"] for r in ranks["res"])
    ref, inv = W.eval_run(None, tmp_path, sharded=True)
    assert inv == {} and mean1 == {}
    assert inv0["image"]["calls"] == inv1["image"]["calls"] == 2
    assert mean0.keys() == ref.keys() == {"mse", "psnr", "ssim"}
    for k in ref:
        assert abs(mean0[k] - ref[k]) <= 1e-5 * abs(ref[k]), (k, mean0[k], ref[k])
    assert np.isfinite(ref["psnr"]) and ref["psnr"] > 10.0
    preds = list((ranks["out"] / "sharded" / "eval" / "images_v3").glob("*/pred/*.png"))
    assert len(preds) == 2


# ------------------------------------------------------------------ Trainer
def _jax_ids(rank, epoch):
    """The JAX Trainer's multi-process batches of W.OrderedData for
    `rank` of 2 (global batch 2), as the ids the samples carry."""
    t = jax_loop.Trainer.__new__(jax_loop.Trainer)
    cfg = W.trainer_config("unused")
    t.cfg, t.train_data = cfg, W.OrderedData()
    t.n_proc, t.rank, t.global_batch, t.local_batch, t.mesh = 2, rank, 2, 1, None
    t._fallback_sample = t.train_data[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "to_np_viewbatch", lambda s: s)
        mp.setattr(jax_loop, "make_global_batch",
                   lambda mesh, b: [int(s["tar_t"][0]) for s in b])
        ids = list(t._batch_iterator(epoch))
    return ids, t._epoch_substituted


def test_data_order_matches_jax(ranks):
    """Each rank's slots of the seeded, wrap-padded order, the unloadable
    sample substituted by the first loadable one, equal to the JAX
    Trainer's; every rank takes the same number of steps."""
    for r, res in enumerate(ranks["res"]):
        ids, substituted = res["order"]
        for epoch in (0, 1):
            ref, ref_sub = _jax_ids(r, epoch)
            assert ids[epoch] == ref, (r, epoch)
            if epoch == 0:
                assert substituted == ref_sub
    counts = [len(res["order"][0][0]) for res in ranks["res"]]
    assert counts == [(W.N_ORDERED + 1) // 2] * 2
    assert sum(res["order"][1] for res in ranks["res"]) >= 1


def test_trainer_two_ranks_resume_bit_equal(ranks):
    """2 steps (val and checkpoint at 2) and a resume to 4 give the 4
    straight steps' parameters bit for bit, on both ranks; the resume takes
    step 2 at its place in the epoch; only rank 0 writes."""
    a, b = (r["trainer"] for r in ranks["res"])
    assert a["straight"] == a["resumed"] == b["straight"] == b["resumed"]
    assert a["resume"] == b["resume"] == (2, 0, 2) and a["step"] == b["step"] == 4
    assert a["writers"] == (True, True) and b["writers"] == (False, False)
    run = ranks["out"] / "resumed" / W.trainer_config("").name
    assert sorted(os.listdir(run / "ckpts")) == ["2", "4"]
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    train = [r["step"] for r in rows if "train/e_all" in r]
    val = [r["step"] for r in rows if "val/total_loss" in r]
    assert train == [1, 2, 3, 4] and val == [2, 4]
    assert all(r["train/data_substituted"] == 0.0 for r in rows if "train/e_all" in r)


# ---------------------------------------------------------------------- CLI
def test_cli_two_ranks_and_resume(tmp_path, monkeypatch):
    """`--device cpu --devices 2`: two gloo ranks train 2 steps and save;
    the same command with --max_steps 4 resumes them at 2 and ends at 4;
    rank 0 alone writes the metrics rows."""
    toy = [f"{k}={v}" for k, v in W.TOY.items()]
    base = ["--config", os.path.join(ROOT, "configs", "zju.json"), "--device", "cpu",
            "--devices", "2", "--no_tensorboard", "--out_dir", str(tmp_path), "--set",
            "data.dataset=synthetic", *toy, "log_every_steps=1", "val_every_steps=2",
            "data.max_len_val=1"]
    assert cli.main(base + ["--fast_dev_run"]) is None
    run = tmp_path / "zju"
    assert sorted(os.listdir(run / "ckpts")) == ["2"]
    cli.main(base + ["--max_steps", "4"])
    assert sorted(os.listdir(run / "ckpts")) == ["2", "4"]
    state = torch.load(run / "ckpts" / "4" / "state.pt", weights_only=True)
    assert state["step"] == 4
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert [r["step"] for r in rows if "train/e_all" in r] == [1, 2, 3, 4]
    assert [r["step"] for r in rows if "val/total_loss" in r] == [2, 4]


def test_process_group_without_a_group():
    """One process: joining is a no-op, rank 0 of 1, no default group; the
    backends and the device of a rank; the refusals of a group without a
    coordinator and of NCCL on the CPU."""
    assert parallel.initialize_distributed(None, 1, 0) is False
    assert (parallel.rank(), parallel.world_size(), parallel.default_group()) == (0, 1, None)
    assert parallel.default_backend("cpu") == "gloo"
    assert parallel.default_backend("cuda:0") == "nccl"
    assert parallel.rank_device(1, "cpu") == torch.device("cpu")
    n = max(torch.cuda.device_count(), 1)
    assert parallel.rank_device(n + 1) == torch.device("cuda", 1 % n)
    with pytest.raises(ValueError, match="coordinator"):
        parallel.initialize_distributed(None, 2, 0)
    with pytest.raises(ValueError, match="nccl backend needs a CUDA device"):
        parallel.initialize_distributed("localhost:1", 2, 0, "nccl", "cpu")
