"""The port's training harness: checkpoints, the Trainer and the CLIs.

All CPU, f32, at the toy sizes of the JAX package's
tests/test_training.py::test_fit_resumes_epoch_schedule (32² images, 4 + 4
samples a ray, a 4x4 patch, geo_n_downsample 2, no VGG term) and a
narrower texture encoder:

  * the checkpoint contract, the cases of tests/test_checkpoints.py as one
    parametrised test, plus the port's own: a second save of a step
    replaces the first, and no temporary directory is left behind;
  * the Trainer: the JAX formula of the epoch order, None-dropping and the
    trailing partial batch, `_val_metrics` only at the measured step, the
    weighted-mean validation losses, the metrics.jsonl rows, and resume:
    4 steps straight equal 2 steps, a new Trainer and 2 more, bit for bit,
    and a finished epoch budget survives a resume;
  * the CLIs (`keypointnerf_torch.train`, `keypointnerf_torch.eval_zju`),
    run in-process: --fast_dev_run, --run_val and the re-scoring of its
    PNG tree, each refusal (the multi-process flags that do not fit
    together, a missing ZJU-MoCap root, negative loader workers), the lambda_vgg
    gate;
  * StepTimer, check_finite, trace and the torchvision VGG19 loader.

TensorBoard stays off (its import pulls in TensorFlow here: 10+ s); the
JSON-lines stream is what the tests read. The B = 2 step against the JAX
package's batched step is in tests/test_torch_batch_step.py.
"""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one share of the cores a process)

from keypointnerf_torch import eval_zju  # noqa: E402
from keypointnerf_torch import train as cli  # noqa: E402
from keypointnerf_torch.data import SyntheticConfig, SyntheticDataset  # noqa: E402
from keypointnerf_torch.models import (  # noqa: E402
    KeypointNeRF,
    VGG19Features,
    ViewBatch,
    load_torch_vgg19,
)
from keypointnerf_torch.training import (  # noqa: E402
    LossConfig,
    OptimConfig,
    TrainDraws,
    create_train_state,
    eval_batch_step_fn,
    eval_step_fn,
)
from keypointnerf_torch.training.loop import Trainer  # noqa: E402
from keypointnerf_torch.utils import load_config  # noqa: E402
from keypointnerf_torch.utils import metrics_writer  # noqa: E402
from keypointnerf_torch.utils import CheckpointManager  # noqa: E402
from keypointnerf_torch.utils import StepTimer, check_finite, trace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZJU = os.path.join(ROOT, "configs", "zju.json")
# the harness needs no full width: a narrower texture encoder (tex_ngf 16)
# cuts the model from 26M to 5.3M parameters, and each checkpoint with it
TOY = {
    "model.n_coarse": 4, "model.n_fine": 4, "model.patch_h": 4, "model.patch_w": 4,
    "model.geo_n_downsample": 2, "model.tex_ngf": 16, "model.compute_dtype": "float32",
    "loss.lambda_vgg": 0.0, "data.num_workers": 0,
}
TOY_SET = ["data.dataset=synthetic", "data.image_size=32"] + [
    f"{k}={v}" for k, v in TOY.items()]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setattr(metrics_writer, "_tb_writer", lambda logdir: None)


def toy_cfg(tmp, **over):
    return load_config(None, {**TOY, "out_dir": str(tmp), "max_epochs": 1,
                              "val_every_steps": 10**9, "ckpt_every_steps": 10**9,
                              "log_every_steps": 10**9, **over})


def toy_data(n, size=32):
    return SyntheticDataset(SyntheticConfig(image_size=size), length=n)


# ---------------------------------------------------------------- checkpoints
def small_state(value: float):
    model = torch.nn.Linear(4, 4)
    with torch.no_grad():
        model.weight.fill_(value)
        model.bias.zero_()
    state = create_train_state(model, OptimConfig())
    state.step = int(value)
    return state


def w00(ckpt):
    return float(ckpt["model"]["weight"][0, 0])


def _round_trip(mgr):
    mgr.save(10, small_state(1.5), metrics={"loss": 0.5})
    mgr.wait()
    ckpt, step = mgr.restore()
    assert step == 10 and w00(ckpt) == 1.5 and ckpt["step"] == 1
    target = small_state(0.0)
    target.load_state_dict(ckpt)
    assert torch.equal(target.model.weight, torch.full((4, 4), 1.5)) and target.step == 1


def _empty(mgr):
    assert mgr.restore() == (None, None) and mgr.restore(best=True) == (None, None)
    assert mgr.latest_step() is None and mgr.load_extra() == {}


def _latest_and_keep_all(mgr):
    for s in (1, 5, 9):
        mgr.save(s, small_state(float(s)))
    assert mgr.latest_step() == 9
    ckpt, step = mgr.restore(step=5)
    assert step == 5 and w00(ckpt) == 5.0
    assert mgr.restore(step=1)[0] is not None          # keep-all (save_top_k=-1)


def _best_selection(mgr):
    for s, loss in ((1, 0.5), (2, 0.2), (3, 0.4)):
        mgr.save(s, small_state(float(s)), metrics={"val_total_loss": loss})
    assert mgr.best_step() == 2 and mgr.latest_step() == 3
    ckpt, step = mgr.restore(best=True)
    assert step == 2 and w00(ckpt) == 2.0


def _best_falls_back_to_latest(mgr):
    mgr.save(7, small_state(7.0))
    ckpt, step = mgr.restore(best=True)
    assert step == 7 and ckpt is not None


def _best_step_zero(mgr):
    mgr.save(0, small_state(0.0), metrics={"val_total_loss": 0.1})
    mgr.save(3, small_state(3.0), metrics={"val_total_loss": 0.9})
    ckpt, step = mgr.restore(best=True)
    assert step == 0 and w00(ckpt) == 0.0


def _resave_replaces(mgr):
    mgr.save(4, small_state(4.0), extra={"epoch": 0})
    mgr.save(4, small_state(5.0), extra={"epoch": 1})
    assert mgr.load_extra(4) == {"epoch": 1} and w00(mgr.restore(4)[0]) == 5.0
    assert sorted(os.listdir(mgr._dir)) == ["4"]         # no temporary left
    assert sorted(os.listdir(os.path.join(mgr._dir, "4"))) == [
        "extra.json", "metrics.json", "state.pt"]


@pytest.mark.parametrize("case", [
    _round_trip, _empty, _latest_and_keep_all, _best_selection,
    _best_falls_back_to_latest, _best_step_zero, _resave_replaces,
], ids=lambda f: f.__name__.strip("_"))
def test_checkpoint_contract(tmp_path, case):
    mgr = CheckpointManager(str(tmp_path / "ckpts"))
    case(mgr)
    mgr.close()


# ------------------------------------------------------------------ Trainer
class _Holes:
    """A dataset whose samples 1 and 4 fail to load (None), with set_epoch."""

    def __init__(self, n):
        self.data, self.epochs = toy_data(n), []

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return None if i in (1, 4) else self.data[i]

    def set_epoch(self, epoch):
        self.epochs.append(epoch)


def test_data_order_and_none_dropping(tmp_path, capsys):
    """The epoch order is JAX's default_rng(seed + epoch).permutation(n);
    unloadable samples are dropped and counted (with a warning past 2%), a
    trailing partial batch is dropped, set_epoch is called."""
    data = _Holes(7)
    cfg = toy_cfg(tmp_path, seed=3, **{"data.batch_per_device": 2})
    trainer = Trainer(cfg, KeypointNeRF(cfg.model, device="cpu"), data)
    images = [ViewBatch.from_numpy(data.data[j], "cpu").tar_image for j in range(7)]
    for epoch in (0, 1):
        order = np.random.default_rng(3 + epoch).permutation(7)
        assert np.array_equal(trainer.epoch_order(epoch), order)
        kept = [int(i) for i in order if i not in (1, 4)]
        want = [kept[0:2], kept[2:4]]                     # kept[4] is a partial batch
        got = [[next(j for j, im in enumerate(images) if torch.equal(vb.tar_image, im))
                for vb in b] for b in trainer._batch_iterator(epoch)]
        assert got == want
        assert trainer._epoch_dropped == 2 and trainer._epoch_loaded == 7
    assert data.epochs == [0, 1]
    assert "2/7 samples failed to load" in capsys.readouterr().out


def test_val_metrics_only_at_measured_step(tmp_path):
    cfg = toy_cfg(tmp_path)
    trainer = Trainer(cfg, KeypointNeRF(cfg.model, device="cpu"), toy_data(2))
    assert trainer._val_metrics(4) is None
    trainer._last_val_loss, trainer._last_val_step = 0.25, 4
    assert trainer._val_metrics(4) == {"val_total_loss": 0.25}
    assert trainer._val_metrics(5) is None


def test_weighted_val_mean(tmp_path):
    """eval_batch_step_fn gives sum_i w_i err_i and sum_i w_i; validate
    logs the mean over the val set's samples, each under draws from a
    generator seeded 0, a batch's filler at weight 0 (3 samples, batch 2)."""
    cfg = toy_cfg(tmp_path, **{"data.batch_per_device": 2, "data.max_len_val": 3})
    model = KeypointNeRF(cfg.model, device="cpu")
    val = toy_data(3, 16)
    trainer = Trainer(cfg, model, toy_data(2), val)
    vbs = [ViewBatch.from_numpy(val[i], "cpu") for i in range(3)]
    draws = [TrainDraws.sample(cfg.model, vb, torch.Generator().manual_seed(0)) for vb in vbs]
    errs = [eval_step_fn(model, LossConfig(), trainer.state, vb, d) for vb, d in zip(vbs, draws)]
    sums, wsum = eval_batch_step_fn(model, LossConfig(), trainer.state, vbs[:2], [0.5, 2.0],
                                    draws[:2])
    assert wsum == 2.5
    for k in errs[0]:
        assert torch.equal(sums[k], 0.5 * errs[0][k] + 2.0 * errs[1][k]), k
    trainer.validate(7)
    rows = [json.loads(line) for line in open(os.path.join(trainer.out_dir, "metrics.jsonl"))]
    assert rows[-1]["step"] == 7 and trainer._last_val_step == 7
    for k in errs[0]:
        want = sum(float(e[k]) for e in errs) / 3
        assert abs(rows[-1][f"val/{k}"] - want) <= 1e-6 * abs(want), k
    assert rows[-1]["val/total_loss"] == rows[-1]["val/e_all"]


def _snapshot(trainer):
    s = trainer.state
    return ({k: v.clone() for k, v in s.model.state_dict().items()},
            s.optimizer.state_dict(), (s.step, s.updates))


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """4 steps of one epoch straight (logs and checkpoints every 2 steps, a
    val at 4), and the same run cut after 2 steps and resumed by a new
    Trainer; then a third Trainer on the finished run. (The renderer pads
    each chunk to 4,096 rays, so a val's image strip costs the same on a
    toy image as on a 64² one: one val a run.)"""
    runs = {}
    for name, cuts in (("straight", [None]), ("resumed", [2, None])):
        tmp = tmp_path_factory.mktemp(name)
        cfg = toy_cfg(tmp, log_every_steps=2, val_every_steps=4, ckpt_every_steps=2,
                      **{"data.max_len_val": 1})
        for max_steps in cuts:
            trainer = Trainer(cfg, KeypointNeRF(cfg.model, device="cpu"), toy_data(4),
                              toy_data(1, 16))
            trainer.fit(max_steps=max_steps)
        runs[name] = trainer
    after = Trainer(cfg, KeypointNeRF(cfg.model, device="cpu"), toy_data(4), toy_data(1, 16))
    return runs, after


def test_resume_is_bit_exact(resumed):
    runs, _ = resumed
    (ma, oa, ca), (mb, ob, cb) = _snapshot(runs["straight"]), _snapshot(runs["resumed"])
    assert ca == cb == (4, 4)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert runs["resumed"].ckpt.load_extra(4) == {"epoch": 1, "epoch_pos": 0}


def test_epoch_schedule_survives_resume(resumed):
    """A restarted run that consumed its epoch budget trains no further
    (port of the JAX package's test_fit_resumes_epoch_schedule)."""
    _, after = resumed
    assert after.state.step == 4
    assert after.fit().step == 4


def test_metrics_rows_and_best_step(resumed):
    """metrics.jsonl: finite train/ rows at the log points with the
    throughput and data counters, a val/ row at the val point, in both
    runs alike; the best checkpoint is the one that carries the val loss
    (step 2's carries none)."""
    runs, _ = resumed
    rows = {name: [json.loads(line) for line in open(os.path.join(t.out_dir, "metrics.jsonl"))]
            for name, t in runs.items()}
    train = [r for r in rows["straight"] if "train/e_all" in r]
    val = [r for r in rows["straight"] if "val/total_loss" in r]
    assert [r["step"] for r in train] == [2, 4] and [r["step"] for r in val] == [4]
    assert runs["straight"].ckpt.steps() == [2, 4]
    for r in train:
        assert {"train/e_pix_c", "train/e_pix_l1", "train/grad_norm", "train/step_time_s",
                "train/rays_per_sec", "train/points_per_sec", "train/data_time_s",
                "train/data_dropped", "train/data_substituted"} <= set(r)
        assert all(np.isfinite(v) for v in r.values())
        assert r["train/points_per_sec"] == pytest.approx(12 * r["train/rays_per_sec"])
    strip = lambda rs: [{k: v for k, v in r.items()                  # noqa: E731
                         if k not in ("time", "train/step_time_s", "train/rays_per_sec",
                                      "train/points_per_sec", "train/data_time_s")}
                        for r in rs]
    assert strip(rows["resumed"]) == strip(rows["straight"])
    best = min(val, key=lambda r: r["val/total_loss"])["step"]
    assert runs["straight"].ckpt.best_step() == best


# ---------------------------------------------------------------------- CLI
def run_cli(*argv):
    return cli.main(["--config", ZJU, *argv])


def test_cli_fast_dev_run_run_val_and_rescore(tmp_path):
    """--fast_dev_run writes config.json, metrics.jsonl and ckpts/2;
    --run_val restores that step, scores the val sample and writes its PNG
    tree, which eval_zju re-scores within PNG rounding."""
    out = ["--device", "cpu", "--out_dir", str(tmp_path), "--set", *TOY_SET,
           "data.max_len_val=1"]
    trainer = run_cli("--fast_dev_run", *out, "log_every_steps=1")
    run = tmp_path / "zju"
    assert trainer.state.step == 2
    assert {"config.json", "metrics.jsonl", "ckpts"} <= set(os.listdir(run))
    assert os.listdir(run / "ckpts") == ["2"]
    assert json.load(open(run / "config.json"))["model"]["n_coarse"] == 4
    run_cli("--run_val", *out)
    yml = dict(line.split(": ") for line in open(run / "test_v3_2.yml").read().splitlines())
    pngs = sorted(os.listdir(run / "images_v3"))
    assert len(pngs) == 1 and len(os.listdir(run / "images_v3" / pngs[0] / "pred")) == 1
    scores = eval_zju.main(["--src_dir", str(run / "images_v3")])
    assert np.isfinite(float(yml["psnr"])) and np.isfinite(float(yml["ssim"]))
    assert abs(scores["psnr"] - float(yml["psnr"])) <= 0.1
    assert abs(scores["ssim"] - float(yml["ssim"])) <= 2e-3


@pytest.mark.parametrize("argv,exc,match", [
    (["--device", "cuda", "--devices", str(torch.cuda.device_count() + 2)], ValueError,
     f"--devices {torch.cuda.device_count() + 2} asks for .* there are "
     f"{torch.cuda.device_count()} CUDA device"),
    (["--process_id", "1"], ValueError, "--process_id needs --num_processes"),
    (["--num_processes", "2", "--process_id", "1"], ValueError,
     "--num_processes 2 needs --coordinator"),
    (["--data_root", "/nonexistent/zju", "--set", *TOY_SET, "data.dataset=zju"],
     FileNotFoundError, "annots.npy"),
    (["--set", *TOY_SET, "data.num_workers=-1"], ValueError, "num_workers must be >= 0"),
])
def test_cli_refusals_name_their_item(tmp_path, argv, exc, match):
    """What the CLI refuses: more NCCL ranks than cards (both numbers
    named), --process_id without --num_processes, a group of P > 1 without
    a coordinator (each before any process starts), a ZJU-MoCap root
    without its annots.npy and a negative data.num_workers (the data paths
    themselves are held by tests/test_torch_zju_data.py and
    tests/test_torch_loader_workers.py)."""
    base = ["--device", "cpu", "--out_dir", str(tmp_path), "--allow_random_vgg"]
    with pytest.raises(exc, match=match):
        run_cli(*base, *argv)


def test_cli_vgg_gate_and_default_device(tmp_path):
    """lambda_vgg > 0 without vgg_weights needs --allow_random_vgg; without
    --device the CLI runs on the card, and raises where there is none."""
    with pytest.raises(SystemExit, match="allow_random_vgg"):
        run_cli("--device", "cpu", "--out_dir", str(tmp_path), "--set", "data.dataset=synthetic")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            run_cli("--out_dir", str(tmp_path), "--set", *TOY_SET)


# ---------------------------------------------------------------- utilities
def test_step_timer_and_check_finite(tmp_path):
    t = StepTimer(window=10)
    for _ in range(4):
        t.tick()
        time.sleep(0.01)
    m = t.metrics(rays_per_step=100, points_per_step=1000)
    assert 0.005 < m["step_time_s"] < 0.5 and m["rays_per_sec"] > 0
    assert np.isclose(m["points_per_sec"], 10 * m["rays_per_sec"])
    assert bool(check_finite({"a": torch.ones(3), "b": [torch.zeros(2, 2)]}))
    assert not bool(check_finite({"a": torch.tensor([1.0, float("nan")]), "b": torch.ones(2)}))
    assert not bool(check_finite((torch.tensor([float("inf")]),)))
    with trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def test_load_torch_vgg19(tmp_path):
    """A torchvision vgg19 state_dict (features.{i}) loads conv by conv."""
    ref = VGG19Features(device="cpu", seed=5)
    idx = (0, 2, 5, 7, 10, 12, 14, 16, 19)
    sd = {}
    for i, conv in zip(idx, ref.convs.values()):
        sd[f"features.{i}.weight"], sd[f"features.{i}.bias"] = conv.weight, conv.bias + 0.5
    torch.save(sd, tmp_path / "vgg19.pth")
    vgg = load_torch_vgg19(str(tmp_path / "vgg19.pth"), device="cpu")
    for a, b in zip(vgg.convs.values(), ref.convs.values()):
        assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias + 0.5)
    assert not any(p.requires_grad for p in vgg.parameters())

