"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its full
700 W limit), and the card's own name and power limit, printed beside
every share of them."""
from __future__ import annotations

import subprocess

BF16_FLOPS = 989e12     # tensor cores, dense
F32_FLOPS = 67e12       # outside the tensor cores (an FMA counted as 2)
HBM_BYTES = 3.35e12


def card() -> str:
    """`name, power.limit` as nvidia-smi reads them ('unknown' without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def least_time(ops_tensor=0.0, ops_f32=0.0, n_bytes=0.0):
    """(seconds, what bounds it): the least time the card could take for
    this work, the largest of its three rates' times."""
    times = {"tensor": ops_tensor / BF16_FLOPS, "f32": ops_f32 / F32_FLOPS,
             "bytes": n_bytes / HBM_BYTES}
    by = max(times, key=times.get)
    return times[by], by
