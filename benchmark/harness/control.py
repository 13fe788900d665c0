"""The control of the output check: the reference put in the program's
place, computed in float8 (reference/precision.py FP8), on the same
subjects, cameras and draws a run of the cell checks; and the numbers
the check compares, read against the float32 reference. A limit has to
fail it."""
from __future__ import annotations

import torch

from reference import train as ref_train
from reference.model import encode as ref_encode
from reference.precision import BF16, F32, no_tf32

from . import check, traffic, weights
from .cell import Cell, ref_frame, scene_cams


def numbers(name: str, seed: int, precision, device="cuda", shrink=None) -> dict:
    cell = Cell(name, shrink=shrink)
    dev = torch.device(device)
    m, mix = cell.m, cell.mix
    subjects = traffic.subjects(mix, seed, dev)
    with no_tf32():
        if mix["kind"] == "train":
            n = cell.wl["check"]["steps"]
            order = traffic.order(mix, seed, n)
            pools = [traffic.fg_pixels(s) for s in subjects]
            runs = {}
            for P in (F32, precision):
                prm = weights.model_weights(m, seed, dev)
                p0 = weights.clone(prm)
                with torch.no_grad():
                    maps = ref_encode(P, prm, m, subjects[order[0]]["src_images"],
                                      subjects[order[0]]["src_masks"], train=True)
                draws = [traffic.train_draws(m, mix["views"], pools[order[i]], seed, i)
                         for i in range(n)]
                terms, first = ref_train.run_steps(P, prm, weights.vgg_weights(seed, dev), m,
                                                   cell.cfg["loss"], cell.cfg["optim"],
                                                   [subjects[order[i]] for i in range(n)], draws)
                runs[P.name] = {"terms": terms, "maps": maps,
                                "grad_norms": {k: torch.linalg.norm(g).item()
                                               for k, g in first.items()},
                                "change_norms": {k: torch.linalg.norm(prm[k] - p0[k]).item()
                                                 for k in prm}}
                del prm, p0, first
            return check.train_numbers(runs[precision.name], runs["f32"])
        chk = cell.wl["check"]
        prm = weights.model_weights(m, seed, dev)
        if mix["kind"] == "orbit":
            order = traffic.order(mix, seed, 1)
            s = int(order[0])
            K, R, t = scene_cams(mix, traffic.orbit_starts(mix, seed)[s], dev)
            frames = [(s, (K, R[j], t[j])) for j in
                      traffic.sampled(seed, "orbit", chk["frames"], min(chk["within"],
                                                                        mix["frames_per_subject"]))]
        else:
            order = traffic.order(mix, seed, chk["within"])
            frames = [(int(order[i]), None)
                      for i in traffic.sampled(seed, "frames", chk["frames"], chk["within"])]
        mean = share = enc = ratio = 0.0
        for s, cam in frames:
            sub = subjects[s]
            K, R, t = cam if cam is not None else (sub["tar_K"], sub["tar_R"], sub["tar_t"])
            ref, maps, _ = ref_frame(F32, prm, cell, sub, K, R, t)
            out, out_maps, _ = ref_frame(precision, prm, cell, sub, K, R, t)
            yard, _, _ = ref_frame(BF16, prm, cell, sub, K, R, t)
            a, b = check.frame_deviation(out, ref)
            mean, share = max(mean, a), max(share, b)
            ratio = max(ratio, a / max(check.frame_deviation(yard, ref)[0], 1e-12))
            enc = max(enc, check.map_gap(out_maps, maps))
        return {"enc_gap": enc, "frame_ratio": ratio, "mean_dev": mean, "share_off": share}
