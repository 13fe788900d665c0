"""The output check catches the faults a cell can have, planted under the
timed path of a toy run on the CPU: a training step that returns its state
unchanged, a gradient altered where it is produced, and a frame altered
where it is produced. (A batch of one has no half to leave out; one chip
has no exchange to leave out.)"""
import copy
import time

import torch

import run as runmod
from bench_toy import shrink
from harness import cell, spec


def frozen(trainer):
    real = trainer.step

    def step(vb, d):
        params = [p.detach().clone() for p in trainer.model.parameters()]
        opt = copy.deepcopy(trainer.state.optimizer.state_dict())
        err = real(vb, d)
        with torch.no_grad():
            for p, q in zip(trainer.model.parameters(), params):
                p.copy_(q)
        trainer.state.optimizer.load_state_dict(opt)
        return err

    trainer.step = step


def altered(out):
    out["rgb_fine"] += 0.05 * (out["acc_fine"][..., None] > 0)


def run_with(name, fault):
    rec = cell.run(name, 21, 0.5, False, time.perf_counter(), device="cpu", shrink=shrink,
                   fault=fault)
    return runmod.result(rec, spec.manifest(), name, False)[0]


def test_a_step_that_leaves_the_state_unchanged_is_caught():
    out = run_with("zju.train", frozen)
    assert out["correct"] is False
    assert out["checks"]["grad_gap"]["value"] > 0.99
    assert out["checks"]["change_gap"]["value"] > 0.99


def test_an_altered_gradient_is_caught(monkeypatch):
    from keypointnerf_torch.training import train as train_module

    real = train_module.apply_gradients
    monkeypatch.setattr(train_module, "apply_gradients",
                        lambda st, params, grads: real(st, params, [0.5 * g for g in grads]))
    out = run_with("zju.train", None)
    assert out["correct"] is False
    assert out["checks"]["grad_med"]["value"] > 0.4


def test_an_altered_frame_is_caught():
    for name in ("zju_strict.frame512", "zju_fast.orbit256"):
        out = run_with(name, altered)
        assert out["correct"] is False, name
        assert out["checks"]["frame_ratio"]["value"] > out["checks"]["frame_ratio"]["limit"]
