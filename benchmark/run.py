"""Run one cell of the benchmark of `keypointnerf_torch` once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result as one JSON object; the numbers the output check compared, each
beside its limit, are the last lines of standard error and the result's
last key. With --trace 0 the metrics are the cell's end-to-end metrics,
with --trace 1 its per-layer metrics (BENCHMARK.json says which cell
reports which). Exits with a code other than 0, and prints no result,
without a CUDA card, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process with few threads: the host work of a run is the Python
# thread that launches the kernels; CPU thread pools only compete with it
os.environ["OMP_NUM_THREADS"] = "1"

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(BENCH_DIR.parent))
# the program builds its kernels into build/ inside the checkout; nothing
# of a run is written elsewhere


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def end_to_end(rec: dict, names) -> dict:
    import numpy as np

    cell = rec["cell"]
    out = {"setup_s": (rec["setup_s"], "s")}
    if rec["kind"] == "train":
        out["train_samples_per_s"] = (rec["samples"] / rec["window_s"], "samples/s")
        out["train_peak_mem_gib"] = (rec["window_peak"] / 2**30, "GiB")
    else:
        rays = rec["items"] * cell.mix["frame_size"] ** 2
        out["render_rays_per_s"] = (rays / rec["window_s"], "rays/s")
        out["frame_ms_p90"] = (float(np.percentile(np.asarray(rec["latencies"]) * 1e3, 90)), "ms")
    return {n: out[n] for n in names}


def per_layer(rec: dict, entries) -> dict:
    from harness import spec

    cell, sl = rec["cell"], rec["slice"]
    ctx = {"summary": rec["summary"], "slice": sl, "cfg": cell.cfg, "mix": cell.mix,
           "model": cell.m, "views": cell.mix["views"] - 1,
           "window": {"items": rec["items"] - sl["items"],
                      "encodes": rec["encodes"] - sl["encodes"],
                      "seconds": rec["window_s"] - sl["seconds"]},
           "roofline": lambda k: spec.module("rooflines", k, cell.bench_dir),
           "flops": lambda k: spec.module("flops", k, cell.bench_dir)}
    out = {}
    for e in entries:
        v = spec.module("metrics", e["name"], cell.bench_dir).read(ctx)
        if v is not None:
            out[e["name"]] = (float(v), e["unit"])
    return out


def result(rec: dict, bench: dict, workload: str, traced: bool):
    """(result object, checks) of a run's record."""
    import torch

    from harness import check, peaks, spec

    e2e, layers = spec.cell_metrics(bench, workload)
    metrics = (per_layer(rec, layers) if traced
               else end_to_end(rec, [e["name"] for e in e2e]))
    limits = rec["cell"].wl["limits"]
    checks = check.judged(rec["numbers"], limits)
    correct = all(ok for *_, ok in checks) and rec["failed"] == 0
    dev = rec["device"]
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(rec["memory_peak"])}
    out = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
           "device": device}
    if traced and rec["summary"]:
        s = rec["summary"]
        device["busy_s"], device["window_s"] = s["busy_s"], s["window_s"]
        out["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    out["card"] = peaks.card() if dev.type == "cuda" else "cpu"
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim, _ in checks}
    return out, checks


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    torch.set_num_threads(1)

    from harness import cell, spec

    bench = spec.manifest()
    wl = spec.data("workloads", args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    rec = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    out, checks = result(rec, bench, args.workload, bool(args.trace))
    banned = cell.sys_modules_banned()
    if banned:
        print(f"loaded in this process: {banned}; the benchmark runs without JAX",
              file=sys.stderr)
        return 3
    limits = rec["cell"].wl["limits"]
    note = {k: v for k, v in rec["numbers"].items() if k not in limits}
    print(f"{args.workload} seed {args.seed}: {rec['items']} requests in "
          f"{rec['window_s']:.4f} s, set-up {rec['setup_s']:.4f} s, failed {rec['failed']}; "
          f"card {out['card']}; {note}", file=sys.stderr)
    if "latencies" in rec:
        lat = sorted(1e3 * x for x in rec["latencies"])
        print(f"frame ms: first {[round(1e3 * x, 1) for x in rec['latencies'][:8]]}, min "
              f"{lat[0]:.1f}, median {lat[len(lat) // 2]:.1f}, max {lat[-1]:.1f}", file=sys.stderr)
    if rec["summary"]:
        s = rec["summary"]
        print(f"traced slice: {rec['slice']['items']} requests, {s['kernels']} kernels "
              f"({s['resolved']} with their launch), busy {s['busy_s']:.6f} of "
              f"{s['window_s']:.6f} s; ranges {s['ranges']}; counters {rec['slice']['counters']}",
              file=sys.stderr)
    for k, v, lim, ok in checks:
        print(f"check {k} {v:.6e} limit {lim:.6e} {'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
