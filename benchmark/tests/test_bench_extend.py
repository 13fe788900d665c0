"""A later change adds a cell and a metric as new files and entries alone:
in a copy of the benchmark, a toy cell (a workload and a traffic file) and
a toy per-layer metric run without any existing file edited."""
import json
import shutil
import time

import run as runmod
from bench_toy import shrink
from harness import cell, spec


def test_new_cell_and_metric_are_files_alone(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    mix = json.loads((bench / "traffic" / "frame512.json").read_text())
    (bench / "traffic" / "frame384.json").write_text(json.dumps(dict(mix, frame_size=384)))
    wl = json.loads((bench / "workloads" / "zju_strict.frame512.json").read_text())
    wl.update(name="zju_strict.frame384", traffic="frame384")
    (bench / "workloads" / "zju_strict.frame384.json").write_text(json.dumps(wl))
    (bench / "metrics" / "frames_in_slice.render.py").write_text(
        "def read(ctx):\n    return ctx['slice']['items'] or None\n")
    manifest["workloads"].append({"name": "zju_strict.frame384", "config": "zju_strict",
                                  "traffic": "frame384", "chips": 1, "why": "a toy cell"})
    for m in manifest["end_to_end"]:
        if m["name"] == "render_rays_per_s":
            m["workloads"].append("zju_strict.frame384")
    manifest["per_layer"].append({"name": "frames_in_slice.render", "unit": "frames",
                                  "better": "higher", "source": "device_trace",
                                  "layer": "render entry plus query and march",
                                  "moves": "render_rays_per_s",
                                  "workloads": ["zju_strict.frame384"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    rec = cell.run("zju_strict.frame384", 3, 0.5, True, time.perf_counter(), device="cpu",
                   bench_dir=bench, shrink=shrink)
    out, _ = runmod.result(rec, spec.manifest(tmp_path), "zju_strict.frame384", True)
    assert out["metrics"]["frames_in_slice.render"]["value"] == 1
    assert all(p.read_bytes() == b for p, b in before.items())
