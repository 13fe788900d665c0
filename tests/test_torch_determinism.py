"""The port's training runs deterministically (keypointnerf_torch/device.py
`deterministic_training`, a context around each step), on the CPU at toy
size, with no JAX program:

  * every training entry point runs its step in the mode: torch's
    deterministic algorithms in strict mode, cuDNN deterministic without
    autotuning, and CUBLAS_WORKSPACE_CONFIG at ":4096:8" or at the caller's
    own value (the step builders, make_batch_step_fn, the Trainer, the
    train CLI's main(), the quality gate's main(), KeypointICON's step and
    CLI; each is stopped in its first step's forward), and leaves the
    process's mode as it found it;
  * importing the port puts CUBLAS_WORKSPACE_CONFIG in place, before any
    work on a device;
  * torch's pool in a test process, and a child process's, is the share of
    the cores that tests/torch_threads.py sets;
  * a render, alone or after a training step, runs with torch's defaults;
  * the toy zju step, run twice from one state with one TrainDraws, gives
    the same loss terms, gradients and parameters, bit for bit;
  * the encoders' replication padding (models/cnn.py, whose backward adds
    each border strip in index order) matches torch's padding, and its
    gradient that of torch's own formulation in deterministic mode, bit
    for bit;
  * the K1 wrapper's scratch size (`onehot_dmap.scratch_bytes`) equals the
    kernel's own layout (`layout_of` in csrc/onehot_dmap.cu), computed
    here from the constants read out of that source: the library is built
    only on a card.

The kernel's two launches on the same inputs are held bit-equal on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""
import copy
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402
from torch_threads import THREADS  # noqa: E402

import keypointnerf_torch.device as device_mod  # noqa: E402
from keypointnerf_torch import quality_gate, train_icon  # noqa: E402
from keypointnerf_torch import train as cli  # noqa: E402
from keypointnerf_torch.data import SyntheticConfig, SyntheticDataset, make_sample  # noqa: E402
from keypointnerf_torch.models import KeypointNeRF, VGG19Features, ViewBatch  # noqa: E402
from keypointnerf_torch.models.cnn import ReplicationPad2d  # noqa: E402
from keypointnerf_torch.models.keypoint_icon import (  # noqa: E402
    KeypointICON,
    KeypointICONConfig,
    make_icon_train_step,
)
from keypointnerf_torch.ops import onehot_dmap as k1  # noqa: E402
from keypointnerf_torch.parallel import make_batch_step_fn  # noqa: E402
from keypointnerf_torch.render import render_image  # noqa: E402
from keypointnerf_torch.training import (  # noqa: E402
    TrainDraws,
    create_train_state,
    train_batch_step_fn,
    train_step_fn,
)
from keypointnerf_torch.training import train as train_module  # noqa: E402
from keypointnerf_torch.training.loop import Trainer  # noqa: E402
from keypointnerf_torch.utils import load_config, metrics_writer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZJU = os.path.join(ROOT, "configs", "zju.json")
# configs/zju.json's recipe (bf16, matmul VJP with the K1 route, VGG) at toy
# geometry; the full-width VGG needs a patch of 8 (its three max-pools)
TOY = {"model.n_coarse": 4, "model.n_fine": 4, "model.patch_h": 8, "model.patch_w": 8,
       "model.geo_n_downsample": 2, "model.tex_ngf": 16, "data.num_workers": 0}
CALLER = ":16:8"       # cuBLAS's other deterministic workspace


def _mode():
    return dict(deterministic=torch.are_deterministic_algorithms_enabled(),
                warn_only=torch.is_deterministic_algorithms_warn_only_enabled(),
                cudnn_deterministic=torch.backends.cudnn.deterministic,
                cudnn_benchmark=torch.backends.cudnn.benchmark,
                cublas=os.environ.get("CUBLAS_WORKSPACE_CONFIG"))


ON = dict(deterministic=True, warn_only=False, cudnn_deterministic=True, cudnn_benchmark=False)
OFF = dict(deterministic=False, warn_only=False, cudnn_deterministic=False, cudnn_benchmark=False)


@pytest.fixture
def mode_off(monkeypatch):
    """torch's defaults and no CUBLAS_WORKSPACE_CONFIG before the test; the
    process's own mode and variable after it."""
    before = _mode()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    yield
    torch.use_deterministic_algorithms(before["deterministic"], warn_only=before["warn_only"])
    torch.backends.cudnn.deterministic = before["cudnn_deterministic"]
    torch.backends.cudnn.benchmark = before["cudnn_benchmark"]
    torch.utils.deterministic.fill_uninitialized_memory = fill


@pytest.fixture(scope="module")
def toy():
    cfg = load_config(ZJU, {**TOY, "data.dataset": "synthetic", "data.image_size": 32})
    vb = ViewBatch.from_numpy(make_sample(SyntheticConfig(image_size=32), seed=0), device="cpu")
    return cfg, vb


class _Stop(Exception):
    """Raised in a training step's forward: the mode is read there."""


def _stop_in_step(monkeypatch):
    """The mode as the first training forward (KeypointNeRF's with
    train=True, KeypointICON's with a gradient) sees it; the forward then
    raises _Stop."""
    seen = {}

    def spy(real, training):
        def forward(self, *args, **kwargs):
            if not training(kwargs):
                return real(self, *args, **kwargs)
            seen.update(_mode(), fill=torch.utils.deterministic.fill_uninitialized_memory)
            raise _Stop
        return forward

    monkeypatch.setattr(KeypointNeRF, "forward",
                        spy(KeypointNeRF.forward, lambda kw: kw.get("train", False)))
    monkeypatch.setattr(KeypointICON, "forward",
                        spy(KeypointICON.forward, lambda kw: torch.is_grad_enabled()))
    return seen


def _step_parts(cfg, vb):
    model = KeypointNeRF(cfg.model, device="cpu", seed=0)
    state = create_train_state(model, cfg.optim)
    draws = TrainDraws.sample(cfg.model, vb, torch.Generator().manual_seed(0))
    return model, state, draws


def _train_step_fn(cfg, vb, tmp_path):
    model, state, draws = _step_parts(cfg, vb)
    train_step_fn(model, cfg.loss, state, vb, draws)


def _train_batch_step_fn(cfg, vb, tmp_path):
    model, state, draws = _step_parts(cfg, vb)
    train_batch_step_fn(model, cfg.loss, state, [vb], [draws])


def _make_batch_step_fn(cfg, vb, tmp_path):
    model, state, draws = _step_parts(cfg, vb)
    make_batch_step_fn(model, cfg.loss)(state, [vb], [draws])


def _trainer(cfg, vb, tmp_path):
    exp = dataclasses.replace(cfg, out_dir=str(tmp_path), max_epochs=1)
    data = SyntheticDataset(SyntheticConfig(image_size=32), length=1)
    Trainer(exp, KeypointNeRF(cfg.model, device="cpu"), data, tensorboard=False).fit(1)


def _icon_step(cfg, vb, tmp_path):
    model = KeypointICON(KeypointICONConfig(geo_n_downsample=2), device="cpu")
    scene = train_icon.make_blob_scene(0, size=32, n_kpt=model.cfg.n_kpt)
    pts, labels = train_icon.sample_training_points(scene, 8, 8, np.random.default_rng(0))
    as_t = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
    _, step = make_icon_train_step(model)
    step(as_t(scene["image"]), as_t(pts), as_t(labels),
         *(as_t(scene[k]) for k in ("K", "R", "t", "kpt3d")))


def _train_cli(cfg, vb, tmp_path):
    cli.main(["--config", ZJU, "--device", "cpu", "--fast_dev_run", "--allow_random_vgg",
              "--no_tensorboard", "--out_dir", str(tmp_path), "--set", "data.dataset=synthetic",
              "data.image_size=32", *(f"{k}={v}" for k, v in TOY.items())])


def _gate_cli(cfg, vb, tmp_path):
    quality_gate.main(["--device", "cpu", "--steps", "1", "--steps-chunk", "1",
                       "--thresholds", str(tmp_path / "gate.json")])


def _icon_cli(cfg, vb, tmp_path):
    train_icon.main(["--out_dir", str(tmp_path), "--device", "cpu", "--steps", "1",
                     "--n_scenes", "1", "--eval_scenes", "1", "--image_size", "32"])


@pytest.mark.parametrize("caller", [None, CALLER], ids=["default", "caller-value"])
@pytest.mark.parametrize("entry", [_train_step_fn, _train_batch_step_fn, _make_batch_step_fn,
                                   _trainer, _icon_step],
                         ids=["train_step_fn", "train_batch_step_fn", "make_batch_step_fn",
                              "Trainer", "make_icon_train_step"])
def test_training_entry_steps_in_mode(mode_off, monkeypatch, toy, tmp_path, entry, caller):
    if caller:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", caller)
    if entry is _trainer:
        monkeypatch.setattr(metrics_writer, "_tb_writer", lambda logdir: None)
    seen = _stop_in_step(monkeypatch)
    with pytest.raises(_Stop):
        entry(*toy, tmp_path)
    assert seen == dict(ON, cublas=caller or ":4096:8", fill=False)
    assert _mode() == dict(OFF, cublas=caller or ":4096:8")


@pytest.mark.parametrize("caller", [None, CALLER], ids=["default", "caller-value"])
@pytest.mark.parametrize("main", [_train_cli, _gate_cli, _icon_cli],
                         ids=["train", "quality_gate", "train_icon"])
def test_cli_steps_in_mode(mode_off, monkeypatch, toy, tmp_path, main, caller):
    if caller:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", caller)
    seen = _stop_in_step(monkeypatch)
    with pytest.raises(_Stop):
        main(*toy, tmp_path)
    assert seen == dict(ON, cublas=caller or ":4096:8", fill=False)
    assert _mode() == dict(OFF, cublas=caller or ":4096:8")


def test_import_sets_cublas_workspace(monkeypatch):
    """Importing the port sets CUBLAS_WORKSPACE_CONFIG (cuBLAS reads it at
    the process's first cuBLAS call); a caller's own value stays."""
    import importlib

    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    importlib.reload(device_mod)
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", CALLER)
    importlib.reload(device_mod)
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == CALLER


def test_thread_budget_reaches_torch_and_children():
    """tests/torch_threads.py gives each test process one share of the cores:
    no file has reset torch's pool, and a child process takes the share
    from OMP_NUM_THREADS."""
    assert torch.get_num_threads() == THREADS
    child = subprocess.run(
        [sys.executable, "-c",
         "import os, torch; print(os.environ['OMP_NUM_THREADS'], torch.get_num_threads())"],
        capture_output=True, text=True, check=True, timeout=120)
    assert child.stdout.split() == [str(THREADS)] * 2


def _toy_render_model(cfg):
    model_cfg = dataclasses.replace(cfg.model, compute_dtype=torch.float32)
    return KeypointNeRF(model_cfg, device="cpu", seed=0)


def test_render_leaves_mode_off(mode_off, toy):
    cfg, vb = toy
    out = render_image(_toy_render_model(cfg), vb, height=8, width=8, chunk=64)
    assert bool(torch.isfinite(out["rgb_fine"]).all())
    assert not torch.are_deterministic_algorithms_enabled()
    assert not torch.backends.cudnn.deterministic


def test_render_in_training_runs_outside_mode(mode_off, toy, monkeypatch):
    """After a training step, in the same process, the renderer (its
    encoders and its queries) runs with torch's defaults and gives the
    image it gave before the process trained."""
    cfg, vb = toy
    model = _toy_render_model(cfg)
    before = render_image(model, vb, height=8, width=8, chunk=64)
    state = create_train_state(copy.deepcopy(model), cfg.optim)
    draws = TrainDraws.sample(cfg.model, vb, torch.Generator().manual_seed(0))
    train_step_fn(state.model, cfg.loss, state, vb, draws)
    seen, query, encode = [], model.query_points, model.encode

    def spying(real):
        def call(*args, **kwargs):
            seen.append(torch.are_deterministic_algorithms_enabled())
            return real(*args, **kwargs)
        return call

    monkeypatch.setattr(model, "query_points", spying(query))
    monkeypatch.setattr(model, "encode", spying(encode))
    during = render_image(model, vb, height=8, width=8, chunk=64)
    assert len(seen) >= 2 and not any(seen)
    assert all(torch.equal(before[k], during[k]) for k in before)
    assert _mode() == dict(OFF, cublas=":4096:8")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,pad", [((2, 3, 7, 5), 1), ((1, 4, 1, 6), 3), ((2, 2, 4, 4), 3)],
                         ids=["resblk", "one-row", "encoder-edge"])
def test_replication_pad_matches_torch(dtype, shape, pad):
    """models/cnn.ReplicationPad2d: torch's padding, and the gradient of
    the formulation torch takes in deterministic mode on a card
    (`_replication_pad`, whose backward index_put_ adds in index order),
    bit for bit."""
    from torch._decomp.decompositions import _replication_pad

    rs = np.random.default_rng(7)
    x = torch.as_tensor(rs.normal(size=shape).astype(np.float32)).to(dtype)
    ours, theirs = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    y = ReplicationPad2d(pad)(ours)
    assert torch.equal(y, F.pad(x, (pad,) * 4, mode="replicate"))
    scale = np.exp(3.0 * rs.normal(size=tuple(y.shape)))      # magnitudes apart: order shows
    g = torch.as_tensor((rs.normal(size=tuple(y.shape)) * scale).astype(np.float32)).to(dtype)
    y.backward(g)
    _replication_pad(theirs, (pad,) * 4).backward(g)
    assert ours.grad.dtype == dtype and torch.equal(ours.grad, theirs.grad)


def test_toy_zju_step_twice_bit_equal(toy, monkeypatch):
    """The toy zju step (bf16, K1's route, VGG) from one state with one
    TrainDraws, twice: loss terms, every gradient, every parameter after
    the update and Adam's moments bit-equal."""
    cfg, vb = toy
    model = KeypointNeRF(cfg.model, device="cpu", seed=0)
    model.mlp_geo.layers2.layers[-1].linear.bias.data[1:] += 2.0     # radiance > 0
    vgg = VGG19Features(device="cpu", seed=42)
    state = create_train_state(model, cfg.optim, vgg)
    twin = copy.deepcopy(model)
    twin_state = create_train_state(twin, cfg.optim, vgg)
    draws = TrainDraws.sample(cfg.model, vb, torch.Generator().manual_seed(0))
    grads = []
    apply = train_module.apply_gradients

    def keeping(st, params, gs):
        grads.append([g.clone() for g in gs])
        apply(st, params, gs)

    monkeypatch.setattr(train_module, "apply_gradients", keeping)
    errs = [train_step_fn(m, cfg.loss, st, vb, draws)
            for m, st in ((model, state), (twin, twin_state))]
    assert errs[0].keys() == errs[1].keys() and all(
        torch.equal(errs[0][k], errs[1][k]) for k in errs[0])
    assert float(errs[0]["e_vgg"]) > 0.0 and float(errs[0]["grad_norm"]) > 0.0
    assert len(grads[0]) == len(grads[1]) and all(
        torch.equal(a, b) for a, b in zip(*grads))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), twin.parameters()))
    moments = [(state.optimizer.state[a], twin_state.optimizer.state[b])
               for a, b in zip(model.parameters(), twin.parameters())]
    assert all(torch.equal(sa["exp_avg"], sb["exp_avg"])
               and torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"]) for sa, sb in moments)


# --------------------------------------------------------- K1's scratch
SOURCE = os.path.join(ROOT, "keypointnerf_torch", "csrc", "onehot_dmap.cu")


def _constants():
    text = open(SOURCE).read()
    got = {m.group(1): m.group(2)
           for m in re.finditer(r"constexpr (?:int|unsigned) (k\w+) = ([^;]+);", text)}
    c = {k: int(got[k]) for k in ("kThreads", "kSortItems", "kRadixBits", "kMaxPasses",
                                  "kSegment")}
    c["kTile"] = c["kThreads"] * c["kSortItems"]
    c["kBins"] = 1 << c["kRadixBits"]
    return c


def _layout_bytes(V, N, H, W, C, c):
    """csrc/onehot_dmap.cu's layout_of(V, N, H, W, C).bytes, line by line."""
    total, cells = V * N, V * H * W
    tiles = (total + c["kTile"] - 1) // c["kTile"]
    segments = (total + c["kSegment"] - 1) // c["kSegment"]
    key_bits = 1
    while (1 << key_bits) < cells:
        key_bits += 1
    passes = (key_bits + c["kRadixBits"] - 1) // c["kRadixBits"]
    at = 4 * total * 4                                   # keys_a, vals_a, keys_b, vals_b
    at += 4 * cells * 2                                  # first, end
    at += 4 * c["kMaxPasses"] * c["kBins"]               # hist
    at += 4 * passes * c["kBins"] * tiles                # counts
    at = (at + 15) // 16 * 16
    at += 4 * 3 * cells * C                              # planes
    return at + 4 * (2 * segments) * 4 * C               # pieces


@pytest.mark.parametrize("V,N,H,W,C", [
    (3, 4096 * 64, 128, 128, 64),       # the zju step's coarse query
    (3, 4096 * 128, 512, 512, 84),      # the fused map's fine query
    (3, 5000, 33, 17, 40),              # odd sides
    (2, 3000, 16, 16, 5),
    (1, 1, 2, 2, 1),
    (3, 0, 8, 8, 8),
])
def test_k1_scratch_bytes_match_the_kernel(V, N, H, W, C):
    c = _constants()
    assert (k1._TILE, k1._RADIX_BITS, k1._BINS, k1._MAX_PASSES, k1._SEGMENT) == (
        c["kTile"], c["kRadixBits"], c["kBins"], c["kMaxPasses"], c["kSegment"])
    assert k1.scratch_bytes(V, N, H, W, C) == _layout_bytes(V, N, H, W, C, c)
    assert k1.scratch_bytes(V, N, H, W, C) % 4 == 0
