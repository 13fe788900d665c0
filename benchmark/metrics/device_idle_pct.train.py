"""Share of the window in which no operation ran on the card: one minus
the device's busy time a request in the traced slice (the union of its
kernels, copies and fills, from the trace) over the wall time a request
in the window outside the slice. The slice's own wall time is not used:
the profiler's host work at every launch stretches it, and would read as
idle."""


def read(ctx):
    s, sl, w = ctx["summary"], ctx["slice"], ctx["window"]
    if not s or s["busy_s"] <= 0 or sl["items"] <= 0 or w["items"] <= 0 or w["seconds"] <= 0:
        return None
    return 100.0 * (1.0 - (s["busy_s"] / sl["items"]) / (w["seconds"] / w["items"]))
