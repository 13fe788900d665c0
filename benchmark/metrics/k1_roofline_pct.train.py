"""K1's share of its roofline over a training step: the least time of its
launches (rooflines/k1.py) over their device time, by the kernel names
its source declares; nothing when the trace's K1 launches are not the
program's count of them."""
from harness import trace


def read(ctx):
    k1, s = ctx["roofline"]("k1"), ctx["summary"]
    launches = ctx["slice"]["counters"]["k1"]
    if not s or not launches or trace.kernel_time(s, k1.ONCE_A_LAUNCH)[0] != launches:
        return None
    per_step = k1.step_launches(ctx["model"], ctx["views"], ctx["mix"]["image_size"])
    if launches % len(per_step):
        return None
    least = sum(k1.bound(*shape)[0] for shape in per_step) * (launches // len(per_step))
    return 100.0 * least / trace.kernel_time(s, k1.KERNELS)[1]
