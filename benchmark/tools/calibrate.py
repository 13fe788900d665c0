"""The readings the output check's limits are set from, for one cell, in
one process: the program's numbers on each of --seeds (a run of the cell
with a short window: set-up, the window's first requests, the check),
and the control's (harness/control.py) on each of --control-seeds.

    python benchmark/tools/calibrate.py --workload zju.train --seconds 2 \
        --seeds 1 2 3 --control-seeds 1 2 3 --out chiprun_out/cal.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(1, str(Path(__file__).resolve().parents[2]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", required=True)
    ap.add_argument("--program-f32", action="store_true",
                    help="a witness: the program in float32, as the reference")
    args = ap.parse_args()
    from harness import cell, control
    from reference.precision import FP8

    def f32(c):
        c.cfg["model"]["compute_dtype"] = "f32"

    out = {"workload": args.workload, "program": {}, "control": {}}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        rec = cell.run(args.workload, seed, args.seconds, False, t0, shrink=f32 if
                       args.program_f32 else None)
        out["program"][seed] = dict(rec["numbers"], failed=rec["failed"], items=rec["items"],
                                    setup_s=rec["setup_s"])
        brief = {k: v for k, v in out["program"][seed].items() if k not in ("_detail", "_outputs")}
        print(f"program seed {seed}: {brief} ({time.perf_counter() - t0:.1f} s)", flush=True)
        del rec
        Path(args.out).write_text(json.dumps(out, indent=1))
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        out["control"][seed] = control.numbers(args.workload, seed, FP8)
        brief = {k: v for k, v in out["control"][seed].items() if k not in ("_detail", "_outputs")}
        print(f"control seed {seed}: {brief} ({time.perf_counter() - t0:.1f} s)", flush=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    for side in ("program", "control"):
        keys = sorted({k for v in out[side].values() for k in v if not k.startswith("_")
                       and isinstance(v[k], float)})
        for k in keys:
            vals = [v[k] for v in out[side].values() if k in v]
            if vals:
                print(f"{side} {k}: min {min(vals):.4e} max {max(vals):.4e} n {len(vals)}",
                      flush=True)


if __name__ == "__main__":
    main()
