"""The render's share of the card's bf16 dense peak: the products its
frames and encodes require (flops/keypointnerf.py) over the window's
time, the traced slice left out of both."""
from harness import peaks


def read(ctx):
    w, mix = ctx["window"], ctx["mix"]
    if w["items"] <= 0 or w["seconds"] <= 0:
        return None
    fl = ctx["flops"]("keypointnerf")
    per_frame = fl.frame(ctx["model"], ctx["views"], mix["image_size"], mix["frame_size"],
                         ctx["cfg"]["render"]["chunk"], encodes=0.0)
    enc = fl.encoder(ctx["model"], mix["image_size"], ctx["views"])[0]
    total = per_frame * w["items"] + enc * w["encodes"]
    return 100.0 * total / (w["seconds"] * peaks.BF16_FLOPS)
