"""Run cells of the benchmark several times, each run its own process, as
the check of a change does, and summarise them.

    python benchmark/tools/series.py --out chiprun_out/series.jsonl \
        --runs zju.train:20:0:101,102 zju_strict.frame512:20:1:7

Each argument is cell:seconds:trace:seed[,seed...]. Every run's result
line (or, when it printed none, the end of its standard error) goes to
--out as one JSON line with its cell, seed, exit code and wall time; the
end prints each metric's median and quartile spread by cell.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def one(cell, seconds, trace, seed, timeout):
    cmd = [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out, err = (out.decode() if isinstance(out, bytes) else out,
                    err.decode() if isinstance(err, bytes) else err)
    rec = {"cell": cell, "seed": seed, "trace": trace, "seconds": seconds, "rc": rc,
           "wall_s": time.perf_counter() - t0, "stderr_tail": err[-1500:]}
    lines = [ln for ln in out.splitlines() if ln.strip()]
    if rc == 0 and lines:
        rec["result"] = json.loads(lines[-1])
    return rec


def spread(values):
    if len(values) < 2:
        return float("nan")
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--runs", nargs="+", required=True)
    ap.add_argument("--timeout", type=float, default=1200)
    args = ap.parse_args()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    by = defaultdict(lambda: defaultdict(list))
    with open(args.out, "a") as f:
        for spec in args.runs:
            cell, seconds, trace, seeds = spec.split(":")
            for seed in seeds.split(","):
                rec = one(cell, seconds, int(trace), int(seed), args.timeout)
                f.write(json.dumps(rec) + "\n")
                f.flush()
                res = rec.get("result")
                brief = ({k: round(v["value"], 6) for k, v in res["metrics"].items()}
                         if res else rec["stderr_tail"][-600:])
                checks = ({k: f"{v['value']:.3e}/{v['limit']:.1e}" for k, v in
                           res["checks"].items()} if res else {})
                print(f"{cell} seed {seed} trace {trace} rc {rec['rc']} wall "
                      f"{rec['wall_s']:.1f} s correct {res and res['correct']} "
                      f"attempted {res and res['attempted']} failed {res and res['failed']} "
                      f"{brief} {checks}", flush=True)
                if res:
                    for k, v in res["metrics"].items():
                        by[(cell, trace)][k].append(v["value"])
    for (cell, trace), ms in by.items():
        for k, vals in ms.items():
            print(f"SUMMARY {cell} trace {trace} {k}: n {len(vals)} median "
                  f"{statistics.median(vals):.6g} spread {spread(vals):.4%} values "
                  f"{[round(v, 6) for v in vals]}", flush=True)


if __name__ == "__main__":
    main()
