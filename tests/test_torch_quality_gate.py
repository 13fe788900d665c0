"""The port's training-quality gate (`keypointnerf_torch/quality_gate.py`)
plumbing at toy size on the CPU: 32² scenes, a 4x4 patch, 4 + 4 samples,
2 training scenes, 1 eval scene a split, f32, a narrow texture encoder.

  * a run with `--eval-at 1,2` evaluates at both points, records the run
    with `--write-thresholds` (floors = the pinned runs' least value less
    the larger of the JAX margins and twice their spread) and saves the
    trained run with `--out_dir` (its config loads back, its checkpoint
    restores);
  * assert mode then passes against those floors (f32 on the CPU is
    deterministic) and fails, exit 1, when a floor is raised above it;
  * a fast render whose cull overflows exits 1.

The gate itself (3000 steps at gate geometry) runs on the card.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one share of the cores a process)

from keypointnerf_torch import quality_gate as qg  # noqa: E402
from keypointnerf_torch.utils import CheckpointManager, get_model, load_config  # noqa: E402


@pytest.fixture(autouse=True)
def toy_gate(monkeypatch):
    for name, value in dict(IMAGE=32, PATCH=4, SAMPLES=4, N_TRAIN=2, N_EVAL=1,
                            EVAL_CHUNK=1024).items():
        monkeypatch.setattr(qg, name, value)
    monkeypatch.setattr(qg, "ARCH", dict(geo_n_downsample=2, tex_ngf=16,
                                         compute_dtype=torch.float32))


def test_gate_records_asserts_and_saves(tmp_path, capsys):
    th = str(tmp_path / "gate.json")
    base = ["--device", "cpu", "--steps-chunk", "1", "--thresholds", th]
    res = qg.main(base + ["--eval-at", "1,2", "--write-thresholds",
                          "--out_dir", str(tmp_path / "run")])
    out = capsys.readouterr().out
    evals = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert [(e["step"], e["split"]) for e in evals if "psnr" in e] == [
        (1, "seen"), (1, "unseen"), (2, "seen"), (2, "unseen")]
    rec = json.load(open(th))
    assert rec["protocol"]["steps"] == 2 and len(rec["runs"]) == 1
    run = rec["runs"][0]
    assert run["seed"] == qg.GATE_SEED and len(run["loss"]) == 2
    assert run["seen"] == res["seen"] and run["unseen"] == res["unseen"]
    for split in ("seen", "unseen"):
        assert rec["floors"][split]["psnr"] == pytest.approx(res[split]["psnr"] - 1.0)
        assert rec["floors"][split]["ssim"] == pytest.approx(res[split]["ssim"] - 0.02)
        assert rec["same_seed_spread"][split]["psnr"] == 0.0

    run_dir = tmp_path / "run" / "quality_gate"
    cfg = load_config(str(run_dir / "config.json"))
    assert (cfg.model.patch_h, cfg.model.n_coarse, cfg.data.image_size) == (4, 4, 32)
    state, step = CheckpointManager(str(run_dir / "ckpts")).restore(map_location="cpu")
    assert step == 2
    get_model(cfg, device="cpu").load_state_dict(state["model"])

    assert qg.main(base + ["--steps", "2"]) == res
    assert "quality gate passed" in capsys.readouterr().out
    rec["floors"]["unseen"]["psnr"] = res["unseen"]["psnr"] + 0.5
    json.dump(rec, open(th, "w"))
    with pytest.raises(SystemExit) as e:
        qg.main(base + ["--steps", "2"])
    assert e.value.code == 1 and "unseen  psnr" in capsys.readouterr().out


def test_cull_overflow_exits_1(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(qg, "FAST_CULL_BUDGET", 1 / 64)
    with pytest.raises(SystemExit) as e:
        qg.main(["--device", "cpu", "--steps", "1", "--steps-chunk", "1",
                 "--thresholds", str(tmp_path / "none.json")])
    assert e.value.code == 1
    assert "empty-ray cull budget exceeded" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "none.json")
