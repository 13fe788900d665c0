"""Inventory of the collectives a process issued, by kind.

Counterpart of `keypointnerf_tpu/parallel/audit.py`, which reads the
collectives XLA compiled into the sharded programs' HLO. PyTorch compiles
no such program: the port issues each collective itself, through the
wrappers of `process_group.py`, and each call adds one record here (its
kind, the torch.distributed op that carried it, its payload bytes). The
intended schedule, which tests/test_torch_parallel.py and chip_smoke.py
assert:

  * a data-parallel train step: ONE all-reduce of the gradients, as one
    flat f32 buffer of the parameter bytes (kind "grads"), and one of the
    step's scalar loss terms ("loss_terms"); nothing else;
  * a sharded render: ONE gather of the image ("image"), an all-reduce of
    zero-filled disjoint slots (see train_parallel.make_sharded_render);
  * a sharded validation batch: one all-reduce of the weighted sums and
    the weight ("eval_sums").

Around them, at log points and saves only: the data-health counters
("data_counters"), the resume step ("resume_step") and barriers.
"""
from __future__ import annotations

import collections
from typing import Dict


class CollectiveAudit:
    def __init__(self):
        self.records = []        # (kind, op, bytes), in issue order

    def record(self, kind: str, op: str, nbytes: int) -> None:
        self.records.append((kind, op, int(nbytes)))

    def reset(self) -> None:
        self.records = []

    def inventory(self) -> Dict[str, dict]:
        """{kind: {"op": op, "calls": n, "bytes": total}}."""
        inv = collections.OrderedDict()
        for kind, op, nbytes in self.records:
            e = inv.setdefault(kind, {"op": op, "calls": 0, "bytes": 0})
            e["calls"] += 1
            e["bytes"] += nbytes
        return dict(inv)


# the process's audit: every collective of the port records here
AUDIT = CollectiveAudit()


def format_inventory(inv: Dict[str, dict]) -> str:
    lines = [f"{kind}: {e['calls']} {e['op']} call(s), {e['bytes']} B"
             for kind, e in inv.items()]
    return "\n".join(lines) or "(no collectives)"
