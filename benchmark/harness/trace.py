"""The traced slice of a --trace 1 run, reduced to what the per-layer
metrics read.

`torch.profiler` (CPU and CUDA activity) runs over a few steps or frames
in the steady part of the window, inside the benchmark's own range
`bench::slice`, which ends after a synchronize. From its events:

* the device's activities (kernels, copies, fills) as intervals; their
  union inside the slice is the busy time, the rest the idle time;
* each kernel's launch on the host (the CUDA runtime call with its
  correlation id), so a kernel is attributed to every benchmark range
  (`bench::*`) and every registered op of the program (`kpnerf::*`) whose
  host interval holds its launch, and each range's calls are counted;
* each idle gap named by the host op that launched the kernel ending it.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
          "cudaLaunchCooperativeKernel")


def _is_cuda(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _kind(e) -> str:
    try:
        act = str(e.activity_type()).lower()
    except (AttributeError, RuntimeError):
        act = ""
    name = e.name()
    if "annotation" in act or e.is_user_annotation() or "#" in name or name.startswith(
            ("bench::", "kpnerf::", "ProfilerStep", "Optimizer.")):
        return "annotation"
    if "memcpy" in act or name.startswith("Memcpy"):
        return "memcpy"
    if "memset" in act or name.startswith("Memset"):
        return "memset"
    return "kernel"


def reduce(prof, top: int = 10) -> dict:
    events = list(prof.profiler.kineto_results.events())
    cpu = [e for e in events if not _is_cuda(e)]
    dev = [e for e in events if _is_cuda(e) and e.duration_ns() > 0]
    slices = [e for e in cpu if e.name() == "bench::slice"]
    if not slices:
        raise RuntimeError("the traced slice has no bench::slice range")
    s0 = min(e.start_ns() for e in slices)
    s1 = max(e.start_ns() + e.duration_ns() for e in slices)

    launch_at = {e.correlation_id(): e.start_ns() for e in cpu if e.name() in LAUNCH}
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in cpu
              if e.name().startswith(("bench::", "kpnerf::")) and e.name() != "bench::slice"
              and s0 <= e.start_ns() <= s1]
    ranges.sort()
    calls = defaultdict(int)
    for r in ranges:
        calls[r[2]] += 1
    starts = [r[0] for r in ranges]
    longest = max((r[1] - r[0] for r in ranges), default=0)
    # the host op around each launch: the innermost aten / kpnerf op
    host_ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in cpu
                      if e.name().startswith(("aten::", "kpnerf::")))
    op_starts = [h[0] for h in host_ops]

    def host_op(t):
        i0 = bisect.bisect_right(op_starts, t) - 1
        best = None
        for i in range(i0, max(i0 - 64, -1), -1):
            a, b, n = host_ops[i]
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, n)
        return best[2] if best else "python"

    by_name = defaultdict(lambda: [0, 0.0])
    in_range = defaultdict(lambda: [0, 0.0])
    intervals, kernels, resolved = [], [], 0
    for e in dev:
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        kind = _kind(e)
        if b < s0 or a > s1 or kind == "annotation":
            continue
        intervals.append((max(a, s0), min(b, s1)))
        if kind != "kernel":
            continue
        t = launch_at.get(e.correlation_id())
        kernels.append((a, e.name(), t))
        rec = by_name[e.name()]
        rec[0] += 1
        rec[1] += (b - a) / 1e9
        if t is None:
            continue
        resolved += 1
        j = bisect.bisect_right(starts, t) - 1
        seen = set()
        while j >= 0:
            ra, rb, rn = ranges[j]
            if ra <= t <= rb and rn not in seen:
                seen.add(rn)
                in_range[rn][1] += (b - a) / 1e9
                in_range[rn][0] += 1
            if t - ra > longest:
                break
            j -= 1
    # busy time: the union of the device's intervals
    intervals.sort()
    busy, gaps, cur_a, cur_b = 0, [], None, None
    for a, b in intervals:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
                gaps.append((cur_b, a))
            else:
                gaps.append((s0, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
        gaps.append((cur_b, s1))
    kernels.sort()
    k_starts = [k[0] for k in kernels]
    idle = defaultdict(float)
    for a, b in gaps:
        if b <= a:
            continue
        i = bisect.bisect_left(k_starts, b)
        if i < len(kernels) and kernels[i][2] is not None:
            name = host_op(kernels[i][2])
        elif i >= len(kernels):
            name = "end of slice (synchronize)"
        else:
            name = "unresolved launch"
        idle[name] += (b - a) / 1e9
    ops = sorted(((n, v[1]) for n, v in by_name.items()), key=lambda x: -x[1])[:top]
    gaps_top = sorted(idle.items(), key=lambda x: -x[1])[:top]
    return {
        "window_s": (s1 - s0) / 1e9, "busy_s": busy / 1e9,
        "kernels": sum(v[0] for v in by_name.values()), "resolved": resolved,
        "by_name": {n: tuple(v) for n, v in by_name.items()},
        "ranges": {n: tuple(v) for n, v in in_range.items()},
        "calls": dict(calls),
        "device_ops": [[n[:160], s] for n, s in ops],
        "idle_gaps": [[n[:160], s] for n, s in gaps_top],
    }


def function_name(kernel: str) -> str:
    """The bare function name of a demangled kernel name: 'void
    (anonymous namespace)::geo_mlp_wgmma<true>(Params)' -> 'geo_mlp_wgmma'."""
    k = kernel.replace("(anonymous namespace)::", "")
    if k.startswith("void "):
        k = k[5:]
    for stop in ("<", "("):
        k = k.split(stop, 1)[0]
    return k.rsplit("::", 1)[-1].strip()


def kernel_time(summary: dict, names) -> tuple:
    """(launches, device seconds) of the kernels whose function is one of
    `names` (the names a source file's `__global__` functions declare)."""
    n, s = 0, 0.0
    for full, (count, secs) in summary["by_name"].items():
        if function_name(full) in names:
            n += count
            s += secs
    return n, s
