"""The numbers that decide `correct`: what the timed path produced against
the plain reference (reference/), each beside its limit (the cell's
workloads/<name>.json "limits"; PERF.md gives the readings they were set
from).

Training (the first three steps of the window's own object, fed by the
window's own call): the encoder's maps as the first step's query read
them (relative L2); by the worst leaf and by the median leaf, the gap
between the program's and the reference's norm of the first gradient (the
program's worked out from Adam's first moment after one step); by the
worst leaf, that of the parameters' change after three steps. Each leaf's
gap is taken against the reference leaf's norm or the median leaf's,
whichever is larger; leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out
of the change. The loss terms' gaps are read and printed, not compared.

Rendering (a seeded sample of the window's frames): the encoder's maps as
the query read them, and the frame's mean deviation from the float32
reference (each output as a share of its largest entry; depth and sdf as
their numerators, times acc + 1e-8) in units of the deviation that the
same reference computed in bfloat16 shows on that frame. How far a frame
amplifies rounding varies about tenfold from subject to subject; the
ratio takes that out, so the configuration's precision reads about 1 and
one below it (float8) ten and more.
"""
from __future__ import annotations

import statistics

import torch

FRAME_OUTPUTS = ("rgb_coarse", "depth_coarse", "acc_coarse", "rgb_fine", "depth_fine", "acc_fine",
                 "sdf_fine")


def term_gaps(prog_terms, ref_terms) -> list:
    """Per step, each loss term's relative gap."""
    return [{k: abs(p[k] - rv) / max(abs(rv), 1e-12) for k, rv in r.items()}
            for p, r in zip(prog_terms, ref_terms, strict=True)]


def loss_gap(prog_terms, ref_terms) -> float:
    return max(max(g.values()) for g in term_gaps(prog_terms, ref_terms))


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's gap between the program's norm and the reference's,
    against the reference leaf's norm or the median leaf's, whichever is
    larger."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}


def leaf_gap(prog: dict, ref: dict, keep=None):
    """(worst gap, its leaf) of per-leaf norms against the reference's."""
    gaps = leaf_gaps(prog, ref, keep)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def moving_leaves(ref_grad_norms: dict) -> set:
    med = statistics.median(ref_grad_norms.values())
    return {n for n, g in ref_grad_norms.items() if g >= 1e-3 * med}


def train_numbers(prog: dict, ref: dict) -> dict:
    g, g_leaf = leaf_gap(prog["grad_norms"], ref["grad_norms"])
    keep = moving_leaves(ref["grad_norms"])
    c, c_leaf = leaf_gap(prog["change_norms"], ref["change_norms"], keep)
    gaps = term_gaps(prog["terms"], ref["terms"])
    return {"enc_gap": map_gap(prog["maps"], ref["maps"]), "grad_gap": g,
            "grad_med": statistics.median(leaf_gaps(prog["grad_norms"], ref["grad_norms"])
                                          .values()),
            "change_gap": c, "loss_gap": loss_gap(prog["terms"], ref["terms"]),
            "loss1_gap": gaps[0]["e_all"], "_leaves": f"grad {g_leaf}, change {c_leaf}"}


def frame_deviation(prog: dict, ref: dict):
    """(worst mean deviation, worst share off by > 1%) over the outputs."""
    mean = share = 0.0
    for k in FRAME_OUTPUTS:
        a, b = ref[k].float(), prog[k].float().to(ref[k].device)
        if k.startswith(("depth_", "sdf_")):
            acc = "acc_" + k.split("_")[1]
            a = a * (ref[acc].float() + 1e-8)
            b = b * (prog[acc].float().to(a.device) + 1e-8)
        dev = (a - b).abs() / a.abs().max().clamp(min=1e-12)
        mean = max(mean, dev.mean().item())
        share = max(share, (dev > 0.01).float().mean().item())
    return mean, share


def map_gap(prog: dict, ref: dict) -> float:
    worst = 0.0
    for k, b in ref.items():
        if k not in prog:
            continue
        a = prog[k].float().to(b.device)
        worst = max(worst, (torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp(min=1e-30))
                    .item())
    return worst


def judged(numbers: dict, limits: dict):
    """[(name, value, limit, within)] for every number with a limit."""
    return [(k, numbers[k], limits[k], bool(numbers[k] <= limits[k])) for k in limits]
