"""One run of one cell: set-up, the measured window, the traced slice, the
output check against the reference, and the result.

The window is a closed loop with one client. It starts once every shape
the cell uses has run (set-up), and it ends when the first request issued
after `seconds` have passed is finished: a training step when the
window's closing synchronize has passed it, a frame when its image is on
the host. So every request counted lies inside the window, and the window
holds all of them.
"""
from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from reference import render as ref_render
from reference import train as ref_train
from reference.model import encode as ref_encode
from reference.precision import BF16, F32, no_tf32

from . import check, program, spec, trace, traffic, weights


class Cell:
    """The data of a cell: workload, configuration and traffic files."""

    def __init__(self, name: str, bench_dir=spec.BENCH_DIR, shrink=None):
        self.name = name
        self.wl = spec.data("workloads", name, bench_dir)
        self.cfg = spec.data("configs", self.wl["config"], bench_dir)
        self.mix = spec.data("traffic", self.wl["traffic"], bench_dir)
        if shrink is not None:
            shrink(self)
        self.m = self.cfg["model"]
        self.bench_dir = bench_dir


class Profiled:
    """The traced slice: the profiler over items [at, at + n) of the window."""

    def __init__(self, at: int, n: int, device):
        self.at, self.n, self.device = at, n, device
        self.prof = self.rf = None
        self.items = self.encodes = 0
        self.seconds = 0.0
        self.counters = {}

    def before(self, i):
        if i != self.at:
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.c0 = program.counters()
        self.t0 = time.perf_counter()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.rf = record_function("bench::slice")
        self.rf.__enter__()

    def after(self, i, encodes=0):
        if self.prof is None or self.items >= self.n or i < self.at:
            return
        self.items += 1
        self.encodes += encodes
        if self.items == self.n:
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.rf.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.seconds = time.perf_counter() - self.t0
            c1 = program.counters()
            self.counters = {k: c1[k] - self.c0[k] for k in c1}

    def close(self):
        """End a slice the window closed before it was complete."""
        if self.prof is not None and self.items < self.n:
            self.rf.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.items = -1

    def summary(self):
        return trace.reduce(self.prof) if self.prof is not None and self.items == self.n else None


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(name: str, seed: int, seconds: float, traced: bool, t_start: float, device="cuda",
        bench_dir=spec.BENCH_DIR, shrink=None, fault=None) -> dict:
    """The run's record: timings, counts, the readings of the output check
    and, traced, the slice's summary. `shrink` (a toy size) and `fault` (a
    fault planted under the timed path) are for the harness's own tests."""
    cell = Cell(name, bench_dir, shrink)
    dev = torch.device(device)
    kind = cell.mix["kind"]
    prm = weights.model_weights(cell.m, seed, dev)
    model = program.build_model(cell.m, prm, dev)
    del prm
    subjects = traffic.subjects(cell.mix, seed, dev)
    vbs = [program.view_batch(s) for s in subjects]
    tr = cell.wl["trace"]
    prof = Profiled(tr["at"], tr["items"], dev) if traced else None
    loop = {"train": train_loop, "frames": frame_loop, "orbit": orbit_loop}[kind]
    rec = loop(cell, seed, seconds, model, subjects, vbs, dev, prof, t_start, fault)
    if prof:
        prof.close()
    rec["cell"] = cell
    rec["device"] = dev
    rec["summary"] = prof.summary() if prof else None
    rec["slice"] = ({"items": prof.items, "encodes": prof.encodes, "counters": prof.counters,
                     "seconds": prof.seconds} if prof else None)
    return rec


# ---------------------------------------------------------------- training
def train_loop(cell, seed, seconds, model, subjects, vbs, dev, prof, t_start, fault):
    vgg_prm = weights.vgg_weights(seed, dev)
    trainer = program.Trainer(cell.cfg, model, program.build_vgg(vgg_prm, dev))
    del vgg_prm
    if fault is not None:
        fault(trainer)
    views = cell.mix["views"]
    pools = [traffic.fg_pixels(s) for s in subjects]
    order = traffic.order(cell.mix, seed, 1 << 16)
    n_check = cell.wl["check"]["steps"]
    draws = lambda i: traffic.train_draws(cell.m, views, pools[order[i]], seed, i)  # noqa: E731
    # set-up: the first steps, through the window's own call and feed, on
    # the window's own object; their readings are checked after the window
    names = [n for n, _ in model.named_parameters()]
    p0 = [p.detach().clone() for p in model.parameters()]
    terms, failed_setup = [], 0
    b1 = cell.cfg["optim"]["beta1"]
    for i in range(n_check):
        if i == 0:
            err, maps = trainer.step_capturing_maps(vbs[order[i]], draws(i))
            maps = {k: v.cpu() for k, v in maps.items()}
        else:
            err = trainer.step(vbs[order[i]], draws(i))
        terms.append({k: float(v) for k, v in err.items() if k != "grad_norm"})
        failed_setup += int(not all(math.isfinite(float(v)) for v in err.values()))
        if i == 0:
            mom = trainer.first_moments()
            g = torch.stack([torch.linalg.norm(mom[n].float() / (1.0 - b1)) for n in names])
            grad_norms = dict(zip(names, g.cpu().tolist()))
    change = torch.stack([torch.linalg.norm(p.detach() - q) for p, q in zip(model.parameters(), p0)])
    change_norms = dict(zip(names, change.cpu().tolist()))
    del p0
    sync(dev)
    setup_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    i, errs = n_check, []
    while time.perf_counter() - t0 < seconds:
        if prof:
            prof.before(i - n_check)
        err = trainer.step(vbs[order[i]], draws(i))
        errs.append(torch.stack([err["e_all"], err["grad_norm"]]))
        if prof:
            prof.after(i - n_check)
        i += 1
    sync(dev)
    t1 = time.perf_counter()
    window_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    steps = i - n_check
    finite = (torch.isfinite(torch.stack(errs)).all(dim=1).cpu().numpy() if errs
              else np.ones(0, bool))
    batch = cell.cfg["train"]["batch_per_device"]
    rec = {"kind": "train", "setup_s": t0 - t_start, "window_s": t1 - t0, "items": steps,
           "encodes": steps, "failed": int((~finite).sum()) + failed_setup,
           "attempted": steps, "samples": steps * batch, "window_peak": window_peak,
           "memory_peak": max(setup_peak, window_peak),
           "prog": {"terms": terms, "grad_norms": grad_norms, "change_norms": change_norms,
                    "maps": maps}}
    del trainer, model, vbs, errs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["numbers"] = train_reference(cell, seed, subjects, pools, order, n_check, rec["prog"], dev)
    return rec


def train_reference(cell, seed, subjects, pools, order, n, prog, dev):
    """The reference's first n steps from the same seed, weights, subjects
    and draws, and the numbers compared."""
    views = cell.mix["views"]
    prm = weights.model_weights(cell.m, seed, dev)
    p0 = weights.clone(prm)
    vgg = weights.vgg_weights(seed, dev)
    batches = [subjects[order[i]] for i in range(n)]
    draws = [traffic.train_draws(cell.m, views, pools[order[i]], seed, i) for i in range(n)]
    with no_tf32():
        with torch.no_grad():
            maps = ref_encode(F32, prm, cell.m, batches[0]["src_images"], batches[0]["src_masks"],
                              train=True)
            maps = {k: v.cpu() for k, v in maps.items()}
        terms, first = ref_train.run_steps(F32, prm, vgg, cell.m, cell.cfg["loss"],
                                           cell.cfg["optim"], batches, draws)
    ref = {"terms": terms, "maps": maps,
           "grad_norms": {k: torch.linalg.norm(g).item() for k, g in first.items()},
           "change_norms": {k: torch.linalg.norm(prm[k] - p0[k]).item() for k in prm}}
    return check.train_numbers(prog, ref)


# ---------------------------------------------------------------- frames
def _frame(model, vb, size, chunk):
    from torch.profiler import record_function

    with record_function("bench::encode"):
        feats = program.encode(model, vb)
    return feats, program.render(model, vb, feats, size, chunk)


def frame_loop(cell, seed, seconds, model, subjects, vbs, dev, prof, t_start, fault):
    size, chunk = cell.mix["frame_size"], cell.cfg["render"]["chunk"]
    order = traffic.order(cell.mix, seed, 1 << 16)
    chk = cell.wl["check"]
    keep = set(traffic.sampled(seed, "frames", chk["frames"], chk["within"]))
    for j in range(cell.wl["warmup"]):                         # every shape of the cell
        _frame(model, vbs[order[-1 - j]], size, chunk)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    lat, overflow, kept, images = [], [], {}, []
    i = 0
    t0 = time.perf_counter()
    while True:
        t_req = time.perf_counter()
        if t_req - t0 >= seconds:
            break
        if prof:
            prof.before(i)
        vb = vbs[order[i]]
        feats, out = _frame(model, vb, size, chunk)
        if fault is not None:
            fault(out)
        img = out["rgb_fine"].to("cpu")
        lat.append(time.perf_counter() - t_req)
        if prof:
            prof.after(i, encodes=1)
        images.append(img)
        overflow.append(out["cull_overflow"].reshape(-1)[0] if "cull_overflow" in out else None)
        if i in keep:
            kept[i] = (order[i], None, out, program.feature_maps(feats))
        i += 1
    t1 = time.perf_counter()
    return frames_record(cell, seed, dev, t_start, t0, t1, lat, overflow, images, kept, i, i,
                         subjects, model)


def orbit_loop(cell, seed, seconds, model, subjects, vbs, dev, prof, t_start, fault):
    mix = cell.mix
    size, chunk, F = mix["frame_size"], cell.cfg["render"]["chunk"], mix["frames_per_subject"]
    order = traffic.order(mix, seed, 1 << 12)
    starts = traffic.orbit_starts(mix, seed)
    cams = [scene_cams(mix, starts[s], dev) for s in range(mix["subjects"])]
    chk = cell.wl["check"]
    keep = set(traffic.sampled(seed, "orbit", chk["frames"], min(chk["within"], F)))
    for j in range(cell.wl["warmup"]):                         # every shape of the cell
        s = order[-1 - j]
        feats = program.encode(model, vbs[s])
        K, R, t = cams[s]
        program.render(model, program.with_camera(vbs[s], K, R[0], t[0]), feats, size, chunk)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    lat, overflow, kept, images = [], [], {}, []
    i = encodes = n_subj = 0
    t0 = time.perf_counter()
    done = False
    while not done:
        s = order[n_subj]
        K, R, t = cams[s]
        for j in range(F):
            t_req = time.perf_counter()
            if t_req - t0 >= seconds:
                done = True
                break
            if prof:
                prof.before(i)
            if j == 0:
                from torch.profiler import record_function

                with record_function("bench::encode"):
                    feats = program.encode(model, vbs[s])
                encodes += 1
            out = program.render(model, program.with_camera(vbs[s], K, R[j], t[j]), feats, size,
                                 chunk)
            if fault is not None:
                fault(out)
            img = out["rgb_fine"].to("cpu")
            lat.append(time.perf_counter() - t_req)
            if prof:
                prof.after(i, encodes=int(j == 0))
            images.append(img)
            overflow.append(out["cull_overflow"].reshape(-1)[0] if "cull_overflow" in out
                            else None)
            if n_subj == 0 and j in keep:
                kept[i] = (s, (K, R[j], t[j]), out, program.feature_maps(feats))
            i += 1
        n_subj += 1
    t1 = time.perf_counter()
    return frames_record(cell, seed, dev, t_start, t0, t1, lat, overflow, images, kept, i,
                         encodes, subjects, model)


def scene_cams(mix, start, dev):
    from .scene import orbit_cameras

    return orbit_cameras(start, mix["frames_per_subject"], mix["degrees_per_frame"],
                         mix["frame_size"], mix["radius"], mix["elevation"], dev)


def frames_record(cell, seed, dev, t_start, t0, t1, lat, overflow, images, kept, frames, encodes,
                  subjects, model):
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    ov = [float(o) for o in overflow if o is not None]
    bad = sum(int(not np.isfinite(img.numpy()).all()) for img in images)
    bad_ov = sum(int(o != 0.0) for o in ov)
    rec = {"kind": "render", "setup_s": t0 - t_start, "window_s": t1 - t0, "items": frames,
           "encodes": encodes, "failed": bad + bad_ov, "attempted": frames,
           "latencies": lat, "memory_peak": peak, "overflow_max": max(ov, default=0.0)}
    kept = {i: (s, cam, {k: v.cpu() for k, v in out.items()},
                {k: v.cpu() for k, v in maps.items()}) for i, (s, cam, out, maps) in kept.items()}
    del model, images
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["numbers"] = frame_reference(cell, seed, subjects, kept, dev)
    return rec


def frame_reference(cell, seed, subjects, kept, dev):
    """The reference's frames for the kept ones, and the numbers compared:
    the encoder's maps against the reference's (relative L2), and each
    frame's mean deviation from the float32 reference in units of the
    deviation a bfloat16 computation of the same reference shows there."""
    prm = weights.model_weights(cell.m, seed, dev)
    mean = share = enc = ratio = 0.0
    ref_overflow = 0
    with no_tf32():
        for i, (s, cam, out, maps) in sorted(kept.items()):
            sub = subjects[s]
            K, R, t = cam if cam is not None else (sub["tar_K"], sub["tar_R"], sub["tar_t"])
            ref, feats, ov = ref_frame(F32, prm, cell, sub, K, R, t)
            enc = max(enc, check.map_gap(maps, feats))
            ref_overflow = max(ref_overflow, ov)
            yard, _, _ = ref_frame(BF16, prm, cell, sub, K, R, t)
            a, b = check.frame_deviation(out, ref)
            mean, share = max(mean, a), max(share, b)
            ratio = max(ratio, a / max(check.frame_deviation(yard, ref)[0], 1e-12))
            del ref, feats, yard
    return {"enc_gap": enc, "frame_ratio": ratio, "mean_dev": mean, "share_off": share,
            "_frames": f"{len(kept)} frames {sorted(kept)}; reference overflow {ref_overflow}"}


def ref_frame(P, prm, cell, sub, K, R, t):
    """The reference's frame in precision P from the inputs, its maps and
    its cull's overflow, on the host."""
    size, chunk = cell.mix["frame_size"], cell.cfg["render"]["chunk"]
    feats = ref_encode(P, prm, cell.m, sub["src_images"], sub["src_masks"])
    out, ov = ref_render.render_frame(P, prm, cell.m, sub, K, R, t, size, size,
                                      cell.wl["check"].get("reference_chunk", chunk), feats)
    return ({k: v.cpu() for k, v in out.items()}, {k: v.cpu() for k, v in feats.items()}, ov)


def sys_modules_banned(banned=("jax", "jaxlib", "flax", "keypointnerf_tpu")):
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(banned))
