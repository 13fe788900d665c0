"""Finding the benchmark's data by name: BENCHMARK.json at the root of the
checkout, and under benchmark/ one file per configuration
(configs/<name>.json), traffic mix (traffic/<name>.json), cell
(workloads/<name>.json), per-layer metric (metrics/<name>.py), kernel
work count (rooflines/<kernel>.py) and model family's FLOP count
(flops/<family>.py). A new cell or metric is a new file and a new entry;
no existing file changes."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def data(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """configs / traffic / workloads entry `name`."""
    return read_json(bench_dir / kind / f"{check_name(name)}.json")


def module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """The Python file metrics/<name>.py (rooflines/, flops/) as a module."""
    path = bench_dir / kind / f"{check_name(name)}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str):
    """(end-to-end metric entries, per-layer metric entries) that `workload`
    reports: those listing it under "workloads", and those with no list."""
    pick = lambda ms: [m for m in ms if workload in m.get("workloads", [workload])]  # noqa
    return pick(bench["end_to_end"]), pick(bench["per_layer"])


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of the run, from --seed and tags."""
    words = [int(seed) & (2**64 - 1)] + [int.from_bytes(str(t).encode(), "little") for t in tags]
    s = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(s[0]) << 31) ^ int(s[1])
