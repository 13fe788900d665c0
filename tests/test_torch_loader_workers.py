"""Loader workers of the port's Trainer (`data.num_workers` > 0: the native
prefetcher's threads, `data/native_loader.py:ordered`) on a fake ZJU-MoCap
tree (`data/fake_zju.py`, 32² PNGs, one subject, 21 cameras, 2 frames).

  * the batches of an epoch with 3 workers equal the inline batches bit
    for bit, on one rank and on each of two simulated ranks' slots of the
    wrap-padded order (`local_order`), with a window smaller than the
    epoch and an unloadable (None) sample in it;
  * a sample whose load raises is raised again at its place, after the
    batches before it;
  * the CLI builds the ZJU datasets from `data.dataset=zju` and trains a
    step with workers.

JAX-free: the Trainer and the loader are the port's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one share of the cores a process)

from keypointnerf_torch import train as cli  # noqa: E402
from keypointnerf_torch.data import ZJUDataset, zju  # noqa: E402
from keypointnerf_torch.data.fake_zju import write_fake_tree  # noqa: E402
from keypointnerf_torch.models import KeypointNeRF  # noqa: E402
from keypointnerf_torch.parallel import local_slots  # noqa: E402
from keypointnerf_torch.training.loop import Trainer  # noqa: E402
from keypointnerf_torch.utils import load_config, metrics_writer  # noqa: E402

HUMAN = "CoreView_377"
TOY = {"model.n_coarse": 4, "model.n_fine": 4, "model.patch_h": 4, "model.patch_w": 4,
       "model.geo_n_downsample": 2, "model.tex_ngf": 16, "model.compute_dtype": "float32",
       "loss.lambda_vgg": 0.0}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zju_workers"))
    write_fake_tree(root, [HUMAN], size=32, n_ims=4)
    return root


@pytest.fixture(autouse=True)
def small_world(monkeypatch):
    split = {HUMAN: {"begin_i": 0, "i_intv": 1, "ni": 2}}
    monkeypatch.setattr(zju, "get_human_split", lambda s: dict(split))
    monkeypatch.setattr(metrics_writer, "_tb_writer", lambda logdir: None)


class Faulty:
    """A dataset whose `bad` entries load as None and whose `boom` entry
    raises."""

    def __init__(self, base, bad=(), boom=None):
        self.base, self.bad, self.boom = base, set(bad), boom

    def __len__(self):
        return len(self.base)

    def set_epoch(self, epoch):
        self.base.set_epoch(epoch)

    def __getitem__(self, i):
        if i == self.boom:
            raise OSError(f"sample {i}: unreadable")
        return None if i in self.bad else self.base[i]


def _trainer(tmp_path, data, workers, batch=1):
    cfg = load_config(None, overrides={**TOY, "out_dir": str(tmp_path), "max_epochs": 1,
                                       "data.num_workers": workers,
                                       "data.batch_per_device": batch})
    return Trainer(cfg, KeypointNeRF(cfg.model, device="cpu"), data, tensorboard=False)


def _as_rank(t, r, world):
    """Make `t` take rank r's slots of a `world`-rank global batch (the
    order and substitution logic only: no process group)."""
    t.world, t.rank = world, r
    t.global_batch = world * t.local_batch
    t.slots = local_slots(t.global_batch, r, world)


def _batches(t, epoch):
    return [[{k: v.clone() for k, v in vars(vb).items()} for vb in b]
            for b in t._batch_iterator(epoch)]


def _same(a, b):
    return len(a) == len(b) and all(
        len(x) == len(y) and all(xa.keys() == ya.keys() and all(torch.equal(xa[k], ya[k])
                                                                for k in xa)
                                 for xa, ya in zip(x, y))
        for x, y in zip(a, b))


@pytest.mark.parametrize("world", [1, 2])
def test_worker_batches_equal_inline(tmp_path, tree, world):
    data = Faulty(ZJUDataset(tree, "train"), bad={5})
    inline = _trainer(tmp_path / "inline", data, 0, batch=2)
    workers = _trainer(tmp_path / "workers", data, 3, batch=2)
    for r in range(world):
        for t in (inline, workers):
            _as_rank(t, r, world)
        for epoch in (0, 1):
            got, want = _batches(workers, epoch), _batches(inline, epoch)
            assert len(want) == {1: 20, 2: 11}[world]    # 41 loaded / 44 padded
            assert _same(got, want), (world, r, epoch)
            assert workers._epoch_pos == inline._epoch_pos == len(inline.local_order(epoch))
            assert (workers._epoch_dropped, workers._epoch_substituted) == \
                   (inline._epoch_dropped, inline._epoch_substituted)


def test_raising_sample_is_raised_again(tmp_path, tree):
    base = ZJUDataset(tree, "train")
    t0 = _trainer(tmp_path / "probe", base, 0)
    order = t0.epoch_order(0)
    boom = int(order[4])
    for workers in (0, 3):
        t = _trainer(tmp_path / f"w{workers}", Faulty(base, boom=boom), workers)
        seen = 0
        with pytest.raises(OSError, match=f"sample {boom}: unreadable"):
            for _ in t._batch_iterator(0):
                seen += 1
        assert seen == 4


def test_cli_trains_from_a_zju_tree_with_workers(tmp_path, tree):
    argv = ["--device", "cpu", "--out_dir", str(tmp_path), "--data_root", tree,
            "--no_tensorboard", "--max_steps", "1", "--set", "data.dataset=zju",
            "data.num_workers=2", "data.max_len_val=1", "val_every_steps=1000"]
    argv += [f"{k}={v}" for k, v in TOY.items()]
    trainer = cli.main(argv)
    assert trainer.state.step == 1
    assert isinstance(trainer.train_data, ZJUDataset) and len(trainer.train_data) == 42
    assert trainer.val_data[0]["meta"]["human"] == HUMAN
    assert np.isfinite([p.detach().sum().item() for p in trainer.model.parameters()]).all()


def test_prefetcher_order_under_thread_stress():
    """More prefetcher threads than cores, a short switch interval, loads
    that finish out of order: `ordered` yields every result once, in the
    order's sequence (a lost update or a misplaced one breaks the list)."""
    import os
    import sys
    import threading
    import time

    from keypointnerf_torch.data import native_loader

    order = [int(i) for i in np.random.default_rng(5).permutation(600)] * 2   # repeats
    threads = 2 * (os.cpu_count() or 4) + 1
    got, interval = [], sys.getswitchinterval()

    def load(i):
        if i % 7 == 0:
            time.sleep(0.001)
        return (i, i * i)

    def run():
        got.extend(native_loader.ordered(load, order, threads, ahead=3 * threads))

    sys.setswitchinterval(1e-6)
    try:
        worker = threading.Thread(target=run, daemon=True)
        worker.start()
        worker.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not worker.is_alive()
    assert got == [(i, i * i) for i in order]
