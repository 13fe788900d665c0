"""Device time of a training step's optimizer, in ms: the kernels launched
inside the program's span `kpnerf::step.optimizer` (the gradients' global
norm and Adam's update)."""
from harness import spans


def read(ctx):
    return spans.ms(ctx, "step.optimizer")
