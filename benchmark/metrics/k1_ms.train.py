"""K1's device time a training step, in ms: the kernels launched inside
the program's span `kpnerf::onehot_dmap` (every map gradient); nothing when
the span's calls are not the program's count of K1 launches."""
from harness import spans


def read(ctx):
    if spans.calls(ctx, "onehot_dmap") != ctx["slice"]["counters"].get("k1"):
        return None
    return spans.ms(ctx, "onehot_dmap")
