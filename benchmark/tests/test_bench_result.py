"""The result line: its keys and their forms, the checks last; without a
card the benchmark exits non-zero and prints no result."""
import json
import subprocess
import sys
import time

import run as runmod
from bench_toy import shrink
from harness import cell, spec


def line(name, traced):
    rec = cell.run(name, 2**31 + 5, 0.5, traced, time.perf_counter(), device="cpu",
                   shrink=shrink)
    return runmod.result(rec, spec.manifest(), name, traced)


def test_result_line_fields():
    out, checks = line("zju_fast.orbit256", False)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["metrics"]) == {"render_rays_per_s", "frame_ms_p90", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["checks"]) == {"frame_ratio", "enc_gap"}
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    assert out["attempted"] >= 1 and out["failed"] == 0
    json.dumps(out)


def test_traced_line_has_per_layer_metrics_and_breakdown():
    out, _ = line("zju_fast.orbit256", True)
    assert set(out["metrics"]) <= {"launches_per_frame.render", "encode_ms.render",
                                   "mfu.render", "device_idle_pct.render"}
    assert "launches_per_frame.render" in out["metrics"]
    assert "window_s" in out["device"] and "busy_s" in out["device"]
    assert len(out["breakdown"]["device_ops"]) <= 10
    assert len(out["breakdown"]["idle_gaps"]) <= 10


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "zju.train", "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=spec.ROOT,
                       capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                                            "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_only_the_benchmarks_files_is_no_run(tmp_path):
    import shutil

    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "zju.train", "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""
