"""Device time of a training step's backward, in ms: the kernels launched
inside the program's span `kpnerf::step.backward` (every parameter's
gradient, K1 among them, launched on autograd's thread)."""
from harness import spans


def read(ctx):
    return spans.ms(ctx, "step.backward")
