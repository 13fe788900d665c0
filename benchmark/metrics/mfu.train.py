"""The training step's share of the card's bf16 dense peak: the products
a step requires (flops/keypointnerf.py) times the steps of the window,
over the window's time, the traced slice left out of both."""
from harness import peaks


def read(ctx):
    w = ctx["window"]
    if w["items"] <= 0 or w["seconds"] <= 0:
        return None
    f = ctx["flops"]("keypointnerf").train_step(ctx["model"], ctx["views"],
                                                ctx["mix"]["image_size"])
    return 100.0 * f * w["items"] / (w["seconds"] * peaks.BF16_FLOPS)
