"""The frozen reference against the program at a toy size on the CPU,
both in float32: the same weights, inputs and draws give the same loss
terms, gradients, frames and maps, to the reference's stated departures
(two-pass norms, another summation order)."""
import torch

from bench_toy import cpu, shrink_f32
from harness import cell, check, program, traffic, weights
from reference import render as rr
from reference import train as rt
from reference.model import encode
from reference.precision import F32


def test_training_step_matches_the_program():
    c = cell.Cell("zju.train", shrink=shrink_f32)
    dev, seed = cpu(), 11
    model = program.build_model(c.m, weights.model_weights(c.m, seed, dev), dev)
    tr = program.Trainer(c.cfg, model, program.build_vgg(weights.vgg_weights(seed, dev), dev))
    sub = traffic.subjects(c.mix, seed, dev)[0]
    pool = traffic.fg_pixels(sub)
    err = tr.step(program.view_batch(sub), traffic.train_draws(c.m, 4, pool, seed, 0))
    mom = tr.first_moments()
    prog_g = {n: torch.linalg.norm(v / 0.1).item() for n, v in mom.items()}
    terms, first = rt.run_steps(F32, weights.model_weights(c.m, seed, dev),
                                weights.vgg_weights(seed, dev), c.m, c.cfg["loss"],
                                c.cfg["optim"], [sub], [traffic.train_draws(c.m, 4, pool, seed, 0)])
    assert check.loss_gap([{k: float(v) for k, v in err.items() if k != "grad_norm"}],
                          terms) < 1e-5
    ref_g = {k: torch.linalg.norm(v).item() for k, v in first.items()}
    assert check.leaf_gap(prog_g, ref_g)[0] < 5e-3


def test_frames_match_the_program():
    dev, seed = cpu(), 12
    for name in ("zju_strict.frame512", "zju_fast.frame512"):
        c = cell.Cell(name, shrink=shrink_f32)
        prm = weights.model_weights(c.m, seed, dev)
        model = program.build_model(c.m, prm, dev)
        sub = traffic.subjects(c.mix, seed, dev)[0]
        vb = program.view_batch(sub)
        size, chunk = c.mix["frame_size"], c.cfg["render"]["chunk"]
        with torch.no_grad():
            feats = program.encode(model, vb)
            out = program.render(model, vb, feats, size, chunk)
            rf = encode(F32, prm, c.m, sub["src_images"], sub["src_masks"])
            ref, overflow = rr.render_frame(F32, prm, c.m, sub, sub["tar_K"], sub["tar_R"],
                                            sub["tar_t"], size, size, chunk, rf)
        assert overflow == float(out["cull_overflow"].max()) == 0
        mean, share = check.frame_deviation(out, ref)
        assert mean < 1e-5 and share == 0.0, name
        assert check.map_gap(program.feature_maps(feats), rf) < 1e-3, name
        assert float(ref["acc_fine"].sum()) > 1.0
