"""K5's share of its roofline over a frame: the least time of its launches
(rooflines/k5.py) over the device time of the kernels launched inside the
program's registered op `kpnerf::sp_geo_mlp`, whatever kernels implement it; nothing
when the slice's calls of the op are not the program's count of K5's
launches."""
OP = "kpnerf::sp_geo_mlp"


def read(ctx):
    kern, s = ctx["roofline"]("k5"), ctx["summary"]
    launches = ctx["slice"]["counters"]["k5"]
    if not s or not launches or s["calls"].get(OP) != launches or OP not in s["ranges"]:
        return None
    per_frame = kern.frame_launches(ctx["model"], ctx["views"], ctx["mix"]["image_size"],
                                    ctx["mix"]["frame_size"], ctx["cfg"]["render"]["chunk"])
    if launches % len(per_frame):
        return None
    least = sum(kern.bound(ctx["model"], *shape)[0] for shape in per_frame)
    return 100.0 * least * (launches // len(per_frame)) / s["ranges"][OP][1]
